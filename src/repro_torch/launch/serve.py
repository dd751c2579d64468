"""Serving launcher, ported from `repro/launch/serve.py`: the paper's
BN-LSTM and the transformer pool's dense (llama3, qwen3, gemma3), MoE
(mixtral, qwen3-moe), RWKV6, hybrid (zamba2), audio (whisper) and vlm
(llama-3.2-vision) families.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rnn-paper --full
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --reduced --device cpu [--traffic [--spec-k 2]]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --reduced --device cpu [--traffic]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --reduced --device cpu [--traffic]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama-3.2-vision-90b --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --traffic \\
      --requests 8 --slots 3 [--spec-k 4]
  PYTHONPATH=src python -m repro_torch.launch.serve --listen --port 8700

Without --traffic or --listen it prefills a prompt batch and decodes with
sampling, in lockstep (`drive_session`).  With --quant binary|ternary the
master tree is exported once into packed QTensors and every decode tick is
one launch of the fused CUDA kernel; prefill streams the packed codes
through the GEMV (batch <= 8) or GEMM kernel per timestep.  The weights
are random, drawn from --seed.  It runs on the card unless --device cpu is
given.  A transformer arch builds random weights from --seed too
(`models/transformer.model_init`), exported packed with
--quant binary|ternary: every projection then runs the packed GEMV (at
most 8 rows: decode) or GEMM (prefill), an MoE layer's per expert;
--reduced shrinks it to the family's smoke size, --full keeps the
published widths.  A packed tree is drawn a layer at a time, each layer
exported as it is drawn (`model_init(packed=True)`), so a full-width MoE
arch serves from one card; with --quant none its fp32 expert masters
(qwen3-moe-30b-a3b 116 GB, mixtral-8x7b 180 GB) are checked against the
device's memory before anything is allocated.  The audio family's
encoder frames (the frontend is a stub, as in JAX) are a normal draw of
shape (batch, prompt length, d) from the run's generator, and the vlm
family's image tokens (the vision tower is a stub) one of shape (batch,
n_img_tokens, d), passed to every prefill as the runtime's `extras`.

--traffic replays a synthetic Poisson workload with mixed prompt and
generation lengths through the continuous-batching engine
(serve/engine.py) and reports aggregate tok/s, slot occupancy and p50/p95
latency and time to first token.  MoE, rwkv and mamba archs prefill each
prompt as one chunk (their runtime's `chunk_granularity` is "whole").
The engine refuses the audio and vlm families (a runtime with `extras`),
as JAX's does: whisper and the VLM serve in lockstep.

--spec-k N adds speculative decoding to --traffic or --listen: the fp
masters are the target and their own packed --quant export the draft,
which proposes N tokens a round; the report adds the accept rate.

--listen serves the warmed engine over HTTP/SSE (serve/frontdoor.py:
POST /v1/generate, GET /v1/stats), with hangups cancelling and a
prefix-state cache of --prefix-cache-mb where the runtime supports one
(token-granularity chunks, non-ring caches; otherwise it serves without).

--mesh data=D,model=M shards the engine of --traffic or --listen over a
mesh of D * M ranks (`launch.mesh.make_serve_mesh`), one process a device
under torchrun: the slot pool D-way along 'data' (D must divide --slots),
the weights tensor-parallel along 'model'.  Every rank builds the same
weights from --seed and runs the same scheduler; rank 0 prints.  With
--listen rank 0 runs the front door and sends each iteration's arrivals
and cancellations to the other ranks, and rank 0 streams the tokens; the
prefix cache of --prefix-cache-mb serves the mesh too.

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --reduced --device cpu --traffic --slots 4 --mesh data=2,model=2
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --reduced --device cpu --quant none --listen --port 8700 \\
      --slots 4 --mesh data=2

Refused: speculation on MoE, rwkv, mamba and ring-cache archs (the
engine's refusal); a packed tree on a mesh where the CUDA kernels are
the route (the engine's refusal, as JAX's).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import (ARCH_IDS, RNN_ARCH_IDS, get_config,
                                  get_rnn_config, rnn_paper)
from repro_torch.core import bnlstm as BL
from repro_torch.core.quantize import QuantSpec
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as T
from repro_torch.launch import mesh as M
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.recurrent import (RNNRuntime, TransformerRuntime,
                                         drive_session, speculative_draft)


def say(*a, **kw) -> None:
    """Print on rank 0 (every rank of a mesh runs the same loop)."""
    if M.rank() == 0:
        print(*a, **kw)


def serve_mesh(args):
    """Resolve --mesh into a DeviceMesh (None when unset) and announce it
    with JAX's banner."""
    if not args.mesh:
        return None
    mesh = M.make_serve_mesh(args.mesh, args.device)
    shape = ",".join(f"{a}={n}" for a, n in
                     zip(mesh.mesh_dim_names, mesh.mesh.shape))
    say(f"mesh: {shape} over {mesh.size()} device(s) — slot pool sharded "
        f"along 'data', weights tensor-parallel along 'model'", flush=True)
    return mesh


def _report_bytes(rt, quant: str) -> None:
    fp, packed = rt.param_nbytes()
    say(f"model bytes: fp32 {fp/1e6:.1f} MB -> packed({quant}) "
          f"{packed/1e6:.1f} MB ({fp/packed:.1f}x smaller)")


def build_rnn(args):
    """The paper's BN-LSTM, exported and behind the serving runtime."""
    cfg = get_rnn_config(args.arch)
    if args.reduced:
        cfg = rnn_paper.reduced(cfg)
    spec = (QuantSpec(mode=args.quant, norm="batch")
            if args.quant != "none" else QuantSpec(mode="none"))
    cfg = dataclasses.replace(cfg, quant=spec)
    gen = torch.Generator().manual_seed(args.seed)
    var = BL.rnn_lm_init(gen, cfg, device=args.device)
    params = var["params"]
    if args.quant != "none":
        params = BL.export_packed_rnn(params, cfg)
    rt = RNNRuntime(cfg, {"params": params, "state": var["state"]},
                    device=args.device)
    if args.quant != "none":
        _report_bytes(rt, args.quant)
    return cfg, rt


def expert_master_bytes(cfg) -> int:
    """Bytes of an MoE config's fp32 expert masters (3 matrices of d x d_ff
    an expert a layer); 0 without experts."""
    return 4 * 3 * cfg.n_layers * cfg.n_experts * cfg.d_model * cfg.d_ff


def device_memory(device: torch.device) -> int:
    """The card's memory, or the host's for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def build_transformer(args):
    """A transformer-pool arch with random weights from --seed, drawn and
    exported packed a layer at a time unless --quant none, behind the
    serving runtime.  Unpacked, an MoE arch whose fp32 expert masters
    exceed the device's memory is refused first.  The audio family's
    encoder frames and the vlm family's image tokens are drawn from the
    same generator after the weights."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    packed = args.quant != "none"
    cfg = cfg.with_quant(QuantSpec(mode=args.quant, norm="channel")
                         if packed else QuantSpec(mode="none"))
    device = dispatch.resolve_device(args.device)
    need, have = expert_master_bytes(cfg), device_memory(device)
    if not packed and need > have:
        raise SystemExit(
            f"--arch {args.arch} --quant none: its fp32 expert masters "
            f"alone take {need / 1e9:.0f} GB, more than the {have / 1e9:.0f}"
            f" GB of {device}; serve it packed (--quant ternary|binary) or "
            f"--reduced")
    gen = torch.Generator(device).manual_seed(args.seed)
    params = T.model_init(gen, cfg, packed=packed)
    extras = {}
    if cfg.family == "audio":
        extras["enc_frames"] = torch.randn(
            (args.batch, args.prompt_len, cfg.d_model), generator=gen,
            device=device)
    if cfg.family == "vlm":
        extras["img"] = torch.randn(
            (args.batch, cfg.n_img_tokens, cfg.d_model), generator=gen,
            device=device)
    rt = TransformerRuntime(cfg, params, extras=extras, device=device)
    if packed:
        _report_bytes(rt, args.quant)
    return cfg, rt


def synth_traffic(vocab: int, *, requests: int, rate: float, prompt_len: int,
                  gen: int, temperature: float, top_k: int,
                  seed: int = 0) -> list:
    """A synthetic mixed-length workload: Poisson arrivals at `rate` req/s,
    prompt lengths U[1, prompt_len], generation lengths U[1, gen].  The
    same numpy draws as the JAX launcher's, so a seed gives both packages
    the same workload."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), size=requests)
    arrivals = np.cumsum(gaps)
    reqs = []
    for i in range(requests):
        S = int(rng.integers(1, prompt_len + 1))
        n = int(rng.integers(1, gen + 1))
        reqs.append(Request(
            prompt=rng.integers(0, vocab, size=S),
            max_tokens=n, temperature=temperature, top_k=top_k,
            seed=seed + 1000 + i, arrival_s=float(arrivals[i]), rid=i))
    return reqs


def run_traffic(cfg, rt, args, draft=None) -> dict:
    """Replay a Poisson workload through the continuous-batching engine."""
    ctx = args.prompt_len + args.gen
    eng = ServeEngine(rt, cfg.vocab, slots=args.slots, max_context=ctx,
                      prefill_chunk=args.prefill_chunk,
                      draft=draft, spec_k=args.spec_k if draft else 0,
                      mesh=serve_mesh(args))
    reqs = synth_traffic(cfg.vocab, requests=args.requests, rate=args.rate,
                         prompt_len=args.prompt_len, gen=args.gen,
                         temperature=args.temperature, top_k=args.top_k,
                         seed=args.seed)
    # a chunk and a tick run once before the clock starts
    eng.warm()
    comps, m = eng.run(reqs, realtime=True)
    say(f"traffic: {m['requests']} requests over {m['wall_s']:.2f}s "
          f"({args.rate:.1f} req/s offered, {args.slots} slots, "
          f"prefill chunk {args.prefill_chunk}, {rt.device})")
    say(f"aggregate decode: {m['agg_tok_s']:.1f} tok/s  "
          f"occupancy: {100 * m['occupancy']:.0f}%  "
          f"ticks: {m['ticks']} (kernel calls a tick: "
          f"{m['tick_launches']})")
    say(f"latency: p50 {m['p50_latency_s']*1e3:.0f} ms  "
          f"p95 {m['p95_latency_s']*1e3:.0f} ms  |  "
          f"ttft: p50 {m['ttft_p50_s']*1e3:.0f} ms  "
          f"p95 {m['ttft_p95_s']*1e3:.0f} ms  "
          f"(max decode stall: {m['max_decode_stall_ticks']} chunk)")
    if draft is not None:
        say(f"speculative: k={m['spec_k']}  "
              f"accept rate {100 * m['accept_rate']:.0f}%  "
              f"({m['accepted_drafts']}/{m['drafted_tokens']} drafts over "
              f"{m['spec_rounds']} rounds)  "
              f"draft {m['draft_tok_s']:.1f} tok/s proposed")
    for c in sorted(comps, key=lambda c: c.rid)[:4]:
        say(f"  req {c.rid}: prompt {c.prompt_len} -> {len(c.tokens)} toks "
              f"({c.finished}), ttft {c.ttft_s*1e3:.0f} ms, "
              f"latency {c.latency_s*1e3:.0f} ms")
    return m


def run_listen(cfg, rt, args, draft=None) -> None:
    """Serve over HTTP/SSE: the engine built and warmed as --traffic builds
    it, behind the asyncio front door, until interrupted.  On a mesh rank
    0 runs the front door and the other ranks follow its scheduler
    (`frontdoor.follow`)."""
    import asyncio

    from repro_torch.serve.frontdoor import FrontDoor, follow
    from repro_torch.serve.prefixcache import PrefixCache

    ctx = args.prompt_len + args.gen
    cache = None
    if args.prefix_cache_mb > 0:
        if (getattr(rt, "chunk_granularity", "token") == "token"
                and not getattr(rt, "ring_caches", False)):
            cache = PrefixCache(args.prefix_cache_mb << 20)
        else:
            say("prefix cache: unsupported for this runtime (needs "
                "token-granularity chunking; non-ring caches): serving "
                "without it")
    mesh = serve_mesh(args)
    if mesh is not None and mesh.size() != M.world_size():
        raise SystemExit(f"--listen --mesh {args.mesh}: run one process a "
                         f"device of the mesh ({mesh.size()}), not "
                         f"{M.world_size()}")
    eng = ServeEngine(rt, cfg.vocab, slots=args.slots, max_context=ctx,
                      prefill_chunk=args.prefill_chunk,
                      draft=draft, spec_k=args.spec_k if draft else 0,
                      prefix_cache=cache, mesh=mesh)
    eng.warm()
    if M.rank() != 0:
        try:
            follow(eng)
        except KeyboardInterrupt:
            pass
        return

    async def _serve():
        fd = FrontDoor(eng, host=args.host, port=args.port)
        await fd.start()
        print(f"front door listening on http://{fd.host}:{fd.port}  "
              f"({args.slots} slots, ctx {ctx}, chunk {args.prefill_chunk}"
              + (f", prefix cache {args.prefix_cache_mb} MB" if cache
                 else "") + f", {rt.device})", flush=True)
        print(f"  curl -N -X POST http://{fd.host}:{fd.port}/v1/generate "
              "-d '{\"prompt\": [1,2,3], \"max_tokens\": 16}'", flush=True)
        try:
            await fd.serve_forever()
        finally:
            await fd.close()

    try:
        asyncio.run(_serve())
    except KeyboardInterrupt:
        pass


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rnn-paper",
                    choices=RNN_ARCH_IDS + ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--quant", default="ternary",
                    choices=("none", "binary", "ternary"))
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu' for the plain "
                         "PyTorch versions of the kernels")
    ap.add_argument("--traffic", action="store_true",
                    help="replay a mixed-length Poisson workload through "
                         "the continuous-batching ServeEngine")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="offered arrival rate, requests/s (--traffic)")
    ap.add_argument("--requests", type=int, default=16,
                    help="workload size (--traffic)")
    ap.add_argument("--slots", type=int, default=4,
                    help="engine slot-pool size (--traffic, --listen)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="in-slot prefill chunk size: at most one chunk "
                         "runs between decode ticks")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: the packed --quant export "
                         "of the model drafts K tokens a round for the fp "
                         "target to verify (--traffic or --listen; 0 = off)")
    ap.add_argument("--listen", action="store_true",
                    help="serve the engine over HTTP/SSE "
                         "(serve/frontdoor.py)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--prefix-cache-mb", type=int, default=64,
                    help="prefix-state cache byte budget for --listen "
                         "(0 = off)")
    ap.add_argument("--mesh", default="",
                    help="serve --traffic on a device mesh, e.g. "
                         "'data=4,model=2': the slot pool sharded D-way "
                         "along 'data' (slots must divide D), the weights "
                         "tensor-parallel along 'model'; one process a "
                         "device (torchrun --nproc-per-node D*M)")
    args = ap.parse_args(argv)

    if args.mesh and not (args.traffic or args.listen):
        raise SystemExit("--mesh shards the continuous-batching engine; "
                         "run it with --traffic or --listen")
    if args.mesh:  # join the ranks first: each builds on its own device
        M.init_group(M.local_device(args.device))
    build = build_rnn if args.arch in RNN_ARCH_IDS else build_transformer
    if args.spec_k and not (args.traffic or args.listen):
        raise SystemExit("--spec-k is a continuous-batching engine mode; "
                         "run it with --traffic or --listen")
    draft = None
    if args.spec_k:
        # self-speculation: the fp masters are the target; --quant names
        # the draft's packing (ternary when it says none)
        draft_mode = args.quant if args.quant != "none" else "ternary"
        args.quant = "none"
        cfg, rt = build(args)
        draft = speculative_draft(rt, mode=draft_mode)
        _report_bytes(draft, draft_mode)
    else:
        cfg, rt = build(args)

    if args.listen:
        return run_listen(cfg, rt, args, draft=draft)
    if args.traffic:
        return run_traffic(cfg, rt, args, draft=draft)

    B, S = args.batch, args.prompt_len
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    out, m = drive_session(rt, prompt, cfg.vocab, gen=args.gen,
                           temperature=args.temperature, top_k=args.top_k,
                           seed=args.seed + 1, warmup=True)
    print(f"session state: {m['state_nbytes']/1e6:.2f} MB "
          f"({rt.family} family, {rt.device})")
    print(f"prefill: {m['prefill_tok_s']:.0f} tok/s  "
          f"decode: {m['decode_tok_s']:.1f} tok/s")
    print(f"generated ids[0,:16]: {out[0, :16].tolist()}")
    return out


if __name__ == "__main__":
    main()
