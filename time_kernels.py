#!/usr/bin/env python3
"""Time the port's fused decode tick (`csrc/fused_tick.cu`) and its
multiply-free GEMV (`csrc/packed_gemv.cu`) at the widths of the paper's
configurations, its tensor-core GEMM (`csrc/packed_matmul.cu`) at the
pool's projection shapes, and `csrc/ordered_bmm.cu` at the norms',
attention's and the SSD readout's shapes, on one NVIDIA card.

    python3 time_kernels.py [--src DIR]
                            [--only tick|gemv|gemm|bmm|phases|session|chunks]
                            [--rows 4] [--out FILE]

The tick: for char-PTB (H = 1000, V = 50), word-PTB medium (H = 650,
V = 10,000) and word-PTB large (H = 1500, two layers, V = 10,000), all LSTM
and ternary with random weights from a seed, and B = 4 and 16 with every
row live: one tick's device time (torch.profiler) and wall time (CUDA
events), its plain version's, the kernel's max abs error against it on h,
c and logits, and the bound that `chip_smoke.tick_bound` counts.  `--rows
4` makes the wrapper take row passes of 4 at every batch (the kernel's
other instantiation at B = 16).
The GEMV: the h-side weight wh (H, 4H) of a random one-layer LSTM,
exported packed, against x (bp, K) with zeros past the true K: the main
path's ternary bp = 4 and bp = 1 and binary bp = 8 at H = 1000, and
ternary bp = 4 at word-PTB medium (H = 650), large (H = 1500) and
char-text8 (H = 2000), all with the codes warm in the L2 as the prefill
loop finds them, plus the main path's shape with a cold L2.  Each: device
and wall time, the plain version's, `torch.matmul` on the dequantized fp32
weight, the bound `chip_smoke.packed_bound` counts, and the max abs error
against the plain version (rtol 1e-5, atol 1e-4, or the run fails).
The GEMM: x (M, K) against random codes (K/G, N) at each shape of
`GEMM_SHAPES` (the projections PERF.md section 6 lists), ternary and
binary: device and wall time at the shape's M, the bound
`chip_smoke.gemm_bound` counts, and from CUDA events `torch.matmul` on the
decoded fp32 weight and the kernel at M = 1 and 4 (a prompt's last short
chunk).
`--only phases` (not run by default) times the GEMV's phases instead, at
the main path's ternary bp = 4 and binary bp = 8: a copy of
`csrc/packed_gemv.cuh` built with clock probes (`PHASE_PROBES`) records,
for each block, its start and end on the global timer, its SM, and the
SM cycles from its start to the end of x staging, of its adds, of its
pushes to the cluster and of the cluster barrier.
`--only session` (not run by default) times the lockstep serving session
instead: `drive_session` at rnn-paper's full width (ternary, off init),
prompt 32, gen 32, temperature 0.8, top-k 40, B = 4 and 16, seven
sessions each after one untimed: the decode tok/s of each and their
median, so the host-bound sampler of two checkouts compares in turns.
`--only chunks` (not run by default) times prompt chunks instead, the
work whose route a product's role picks: qwen3-0.6B at full width (28
layers, ternary, seed 0, as `chip_smoke.py` phase 9 builds it) prefills
one request's chunk of each length in `CHUNK_LENGTHS` into fresh caches
through the engine's hook (`prefill_chunk`), and one repeat of
llama-3.2-vision-90b at full width (4 self layers and a cross layer, 1600
image tokens, as phase 13 draws it) prefills a prompt of each length at
B = 1 (its cross K/V over the image tokens included; the engine refuses
that family): each call's device time (torch.profiler), wall time (CUDA
events) and packed launches by kernel.  Then the qwen3 engine (8 slots,
chunk 32) serves 16 requests of `synth_traffic(seed=0)` (prompts U[1,
128], so most prompts end in a short chunk; gen U[1, 8]) all at once:
TTFT p50/p95 and wall unprofiled, then the same run's device busy time
and its packed launches under the profiler.
`--only bmm` times `ordered_bmm` at every row of `chip_smoke.BMM_ROWS`
(the norms', attention's and the SSD readout's shapes) on contiguous
operands, beside `torch.bmm` on the same ones: device time from CUDA
events (`chip_smoke.event_ms`, one call's span after a spin kernel), wall
(the median of CUDA events around one call), the bound, the route the
wrapper picks and every other route the kernel takes for the shape
(`ordered_bmm.plan`, forced), and for the products the main path's
layouts (the keys' and the values' permuted views, against
`torch.matmul` on the same views).
`--src` times the `repro_torch` package of another checkout's `src` (an
earlier commit's kernels, built into that checkout's own `build/`), so two
versions of a kernel can be compared within one run on one card.  Prints
one JSON line per row and writes them all to `--out`.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke as CS

CONFIGS = (("char_ptb", 1000, 50, 1), ("word_ptb_medium", 650, 10000, 1),
           ("word_ptb_large", 1500, 10000, 2))
# (name, mode, bp, H, cold L2): x (bp, H padded to G) . wh codes (H/G, 4H)
GEMV_SHAPES = (("char_ptb", "ternary", 4, 1000, False),
               ("char_ptb", "binary", 8, 1000, False),
               ("char_ptb", "ternary", 1, 1000, False),
               ("word_ptb_medium", "ternary", 4, 650, False),
               ("word_ptb_large", "ternary", 4, 1500, False),
               ("char_text8", "ternary", 4, 2000, False),
               ("char_ptb", "ternary", 4, 1000, True))

# (label, M, K, N): the GEMM's shapes, x (M, K) . codes (K/G, N)
GEMM_SHAPES = (("rnn-paper h-side", 16, 1008, 4000),
               ("qwen3 Wq", 512, 1024, 2048), ("qwen3 Wdown", 512, 3072, 1024),
               ("qwen3-moe expert Wgate", 40, 2048, 768),
               ("qwen3-moe expert Wdown", 40, 768, 2048),
               ("qwen3-moe Wq", 512, 2048, 4096), ("qwen3-moe Wk", 512, 2048, 512),
               ("mixtral expert Wgate", 40, 4096, 14336),
               ("mixtral expert Wdown", 40, 14336, 4096),
               ("rwkv6 Wr", 512, 4096, 4096), ("rwkv6 Wck", 512, 4096, 14336),
               ("rwkv6 Wcv", 512, 14336, 4096),
               ("zamba2 Win", 512, 2048, 8384), ("zamba2 Wout", 512, 4096, 2048),
               ("zamba2 shared Wq", 512, 2048, 2048),
               ("zamba2 shared Wgate", 512, 2048, 8192),
               ("zamba2 shared Wdown", 512, 8192, 2048),
               ("whisper decoder Wq", 128, 512, 512),
               ("whisper decoder Wfc1", 128, 512, 2048),
               ("whisper decoder Wfc2", 128, 2048, 512),
               ("whisper encoder Wq", 6000, 512, 512),
               ("whisper encoder Wfc1", 6000, 512, 2048),
               ("whisper encoder Wfc2", 6000, 2048, 512),
               ("vlm Wq", 512, 8192, 8192), ("vlm Wk", 512, 8192, 1024),
               ("vlm Wgate", 512, 8192, 28672), ("vlm Wdown", 512, 28672, 8192),
               ("vlm cross Wk", 6400, 8192, 1024))

# prompt-chunk lengths of `--only chunks`: the engine's short last chunks
# (a prompt of U[1, 128] tokens in chunks of 32), a whole chunk, a prompt
CHUNK_LENGTHS = (1, 2, 4, 8, 16, 32, 128)


def time_ticks(args, card: str) -> list:
    import torch
    from repro_torch.core import bnlstm as BL
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.kernels import decode_step as DK
    from repro_torch.kernels import ops as OPS
    if args.rows is not None:
        DK.tick_rows = lambda bp: args.rows
    dev = torch.device("cuda")
    out = []
    for name, hidden, vocab, layers in CONFIGS:
        cfg = BL.RNNConfig(vocab=vocab, d_hidden=hidden, n_layers=layers,
                           cell="lstm",
                           quant=QuantSpec(mode="ternary", norm="batch"))
        g = torch.Generator().manual_seed(0)
        v = CS.off_init(BL.rnn_lm_init(g, cfg, device=dev), g)
        qv = {"params": BL.export_packed_rnn(v["params"], cfg),
              "state": v["state"]}
        tick = BL.rnn_decode_tables(qv, cfg)[0]["tick"]
        for B in (4, 16):
            h = torch.tanh(torch.randn(layers, B, hidden, generator=g)).to(dev)
            c = torch.randn(layers, B, hidden, generator=g).to(dev)
            tok = torch.randint(0, vocab, (B,), generator=g).to(dev)
            targs = OPS.tick_operands(tok, h, c, tick, None)
            got = DK.fused_tick(*targs, cell="lstm", mode="ternary")
            want = DK.fused_tick_plain(*targs, cell="lstm", mode="ternary")
            err = [(got[i] - want[i]).abs().max().item() for i in range(3)]
            k = CS.time_call(
                lambda: DK.fused_tick(*targs, cell="lstm", mode="ternary"), 100)
            p = CS.time_call(lambda: DK.fused_tick_plain(
                *targs, cell="lstm", mode="ternary"), 10)
            b_ms, b_by = CS.tick_bound(cfg, qv, B)
            row = dict(card=card, src=args.src, kernel="fused_tick",
                       config=name, B=B, bp=targs[0].shape[0],
                       hp=targs[4].shape[-1], vp=targs[12].shape[1],
                       rows=args.rows, err_h_c_logits=err, ms=k["ms"],
                       wall_ms=k["wall_ms"], plain_ms=p["ms"],
                       plain_wall_ms=p["wall_ms"], bound_ms=b_ms, bound_by=b_by)
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


def time_gemvs(args, card: str) -> list:
    import torch
    from repro_torch.core import bnlstm as BL
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.kernels import packed_matmul as PK
    dev = torch.device("cuda")
    flush = CS.L2Flush()
    out = []
    for name, mode, bp, hidden, cold in GEMV_SHAPES:
        cfg = BL.RNNConfig(vocab=50, d_hidden=hidden, n_layers=1, cell="lstm",
                           quant=QuantSpec(mode=mode, norm="batch"))
        g = torch.Generator().manual_seed(hidden)
        qt = BL.export_packed_rnn(BL.rnn_lm_init(g, cfg, device=dev)["params"],
                                  cfg)["layers"][0]["wh"]
        K, N = qt.codes.shape[0] * qt.group, qt.codes.shape[1]
        x = torch.tanh(torch.randn(bp, K, generator=g)).to(dev)
        x[:, qt.k:] = 0.0
        got = PK.packed_gemv(x, qt.codes, mode=mode)
        want = PK.packed_gemv_plain(x, qt.codes, mode=mode)
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
            CS.fail(f"packed_gemv {name} {mode} bp={bp}: max abs err {err}")
        w = torch.nn.functional.pad(qt.dequantize() / qt.alpha,
                                    (0, 0, 0, K - qt.k))
        b_ms, b_by = CS.packed_bound(qt, bp)
        plan = getattr(PK, "gemv_plan", None)
        r = CS.timed_row("packed_gemv", f"{mode} x({bp},{K}) codes({K // qt.group},"
                         f"{N})", err,
                         lambda: PK.packed_gemv(x, qt.codes, mode=mode),
                         lambda: PK.packed_gemv_plain(x, qt.codes, mode=mode),
                         lambda: torch.matmul(x, w), b_ms, b_by,
                         flush=flush if cold else None)
        row = dict(card=card, src=args.src, kernel="packed_gemv", config=name,
                   mode=mode, bp=bp, K=K, N=N, cold_l2=cold,
                   plan=None if plan is None else plan(bp, K, N, mode=mode),
                   **{k: v for k, v in r.items() if k != "name"})
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def time_gemms(args, card: str) -> list:
    import torch
    from repro_torch.core.qtensor import QTensor
    from repro_torch.core.quantize import pack_group
    from repro_torch.kernels import packed_matmul as PK
    g = torch.Generator().manual_seed(0)
    out = []
    for label, M, K, N in GEMM_SHAPES:
        for mode in ("ternary", "binary"):
            # K padded to the pack group, x zero past the true K (the
            # rnn-paper binary export's 1000 -> 1024)
            G = pack_group(mode)
            Kp = -(-K // G) * G
            codes = torch.randint(-2**31, 2**31, (Kp // G, N), generator=g,
                                  dtype=torch.int64).to(torch.int32).cuda()
            qt = QTensor(codes=codes, k=Kp, mode=mode)
            w = qt.dequantize()
            plan = PK.matmul_plan(Kp, N, mode=mode)
            x = torch.nn.functional.pad(torch.tanh(torch.randn(
                M, K, generator=g)), (0, Kp - K)).cuda()
            k = CS.time_call(lambda: PK.packed_matmul(x, codes, mode=mode), 50)
            b_ms, b_by = CS.gemm_bound(qt, M)
            row = dict(card=card, src=args.src, kernel="packed_matmul",
                       shape=label, mode=mode, M=M, K=Kp, N=N, plan=plan,
                       blocks=CS.gemm_blocks(plan, M), ms=k["ms"],
                       wall_ms=k["wall_ms"], ms_by=k["ms_by"], bound_ms=b_ms,
                       bound_by=b_by,
                       library_ms=CS.event_ms(lambda: torch.matmul(x, w), 20))
            # a prompt's last short chunk (CUDA events: a profiler session
            # costs about a second)
            for m in (1, 4):
                xm = x[:m].contiguous()
                row[f"m{m}_ms"] = CS.event_ms(
                    lambda: PK.packed_matmul(xm, codes, mode=mode), 20)
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


def time_bmms(args, card: str) -> list:
    import torch
    from repro_torch.kernels import ordered_bmm as OB
    g = torch.Generator().manual_seed(0)
    out = []
    for label, N, M, K, P in CS.BMM_ROWS:
        a, b = CS.bmm_operands(g, N, M, K, P)
        b_ms, b_by = CS.bound(4 * (N * M * K + N * K * P + N * M * P),
                              2 * N * M * K * P / CS.FP32_FLOP_S)
        kernel = lambda: OB.ordered_bmm(a, b)
        library = lambda: torch.bmm(a, b)
        row = dict(card=card, src=args.src, kernel="ordered_bmm", shape=label,
                   N=N, M=M, K=K, P=P, ms=CS.event_ms(kernel, 50),
                   wall_ms=CS.wall_ms(kernel, 50), bound_ms=b_ms,
                   bound_by=b_by, library_ms=CS.event_ms(library, 50),
                   library_wall_ms=CS.wall_ms(library, 50))
        if hasattr(OB, "plan"):  # a checkout from before the routes has none
            p = OB.plan(a, b)
            row["route"] = p.route
            for r in OB.ROUTES:
                if (r == "row") == (P == 1) and (r != "small"
                                                  or M <= OB.SMALL_M):
                    row[f"{r}_ms"] = CS.event_ms(
                        lambda: OB.launch(p._replace(route=r)), 50)
        if P > 1:
            # the main path's layouts: the keys (B, S, H, hd) and the
            # values (B, S, H, hd) permuted, B = 4
            b4 = b.reshape(4, N // 4, K, P)
            a4 = a.reshape(4, N // 4, M, K)
            for name, view in (
                    ("keys", b4.permute(0, 3, 1, 2).contiguous()
                     .permute(0, 2, 3, 1)),
                    ("values", b4.permute(0, 2, 1, 3).contiguous()
                     .permute(0, 2, 1, 3))):
                row[f"{name}_view_ms"] = CS.event_ms(
                    lambda: OB.ordered_bmm(a4, view), 50)
                row[f"{name}_view_library_ms"] = CS.event_ms(
                    lambda: torch.matmul(a4, view), 50)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


# (anchor in csrc/packed_gemv.cuh, probe inserted before it): block start,
# x staged (the last pass), adds done, partials pushed, cluster barrier
# passed, and at the end a record of the block in x, which the run owns
PHASE_PROBES = (
    ("  const int q = threadIdx.x % kQuads, slice",
     "  unsigned long long g0;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g0));\n"
     "  long long T[5] = {clock64()};\n"),
    ("    load_word(nxt, p0 + kSlices + slice);", "    T[1] = clock64();\n"),
    ("  // 4. the slices' partials summed", "  T[2] = clock64();\n"),
    ("  if (cs == 1) return;\n  cluster.sync();", "  T[3] = clock64();\n"),
    ("  for (int i = threadIdx.x; i < per && rank * per + i < outs;",
     "  T[4] = clock64();\n"),
    ("}\n\ntemplate <int MODE, int ROWS, bool VEC>\ncudaError_t launch(",
     """  unsigned long long g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  if (threadIdx.x == 0) {
    int* d = (int*)x + (blockIdx.y * gridDim.x + blockIdx.x) * 8;
    d[0] = (int)(g0 & 0x7fffffff);
    for (int p = 1; p < 5; ++p) d[p] = (int)(T[p] - T[0]);
    d[5] = (int)sm;
    d[6] = (int)(g1 - g0);
  }
"""),
)
PHASES = ("x staged", "adds done", "pushed", "cluster barrier")


def gemv_phases(args, card: str) -> list:
    """The GEMV's phases, block by block, from a probed copy of its source
    (`PHASE_PROBES`), launched through the wrapper at the main path's
    shapes."""
    import ctypes
    import subprocess

    import numpy as np
    import torch
    from repro_torch.core.quantize import pack_group
    from repro_torch.kernels import build
    from repro_torch.kernels import packed_matmul as PK
    src = (build.CSRC / "packed_gemv.cuh").read_text()
    for anchor, probe in PHASE_PROBES:
        if src.count(anchor) != 1:
            CS.fail(f"phase probe anchor {anchor!r} is not in "
                    f"packed_gemv.cuh once: update PHASE_PROBES")
        src = src.replace(anchor, probe + anchor)
    # the probed kernel header beside a copy of the entry point, which
    # includes it from its own directory before csrc/
    phases = build.BUILD_DIR / "packed_gemv_phases"
    phases.mkdir(parents=True, exist_ok=True)
    (phases / "packed_gemv.cuh").write_text(src)
    probed = phases / "packed_gemv.cu"
    probed.write_text((build.CSRC / "packed_gemv.cu").read_text())
    so = probed.with_suffix(".so")
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(so), str(probed)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    fn_name, argtypes = build.SIGNATURES["packed_gemv"]
    getattr(lib, fn_name).argtypes = argtypes
    getattr(lib, fn_name).restype = ctypes.c_int
    build._libs["packed_gemv"] = lib
    g = torch.Generator().manual_seed(0)
    out = []
    for mode, bp, K in (("ternary", 4, 1008), ("binary", 8, 1024)):
        N = 4000
        codes = torch.randint(-2**31, 2**31 - 1, (K // pack_group(mode), N),
                              generator=g, dtype=torch.int32).cuda()
        plan = PK.gemv_plan(bp, K, N, mode=mode)
        for _ in range(5):  # the last launch finds the L2 and code warm
            x = torch.tanh(torch.randn(bp, K, generator=g)).cuda()
            PK.packed_gemv(x, codes, mode=mode)
            torch.cuda.synchronize()
        d = x.view(torch.int32).cpu().numpy().reshape(-1)[
            :plan["blocks"] * 8].reshape(-1, 8).astype(np.int64)
        start = d[:, 0] - d[:, 0].min()
        per_sm = np.bincount(d[:, 5], minlength=torch.cuda.get_device_properties(
            0).multi_processor_count)
        row = dict(card=card, src=args.src, kernel="packed_gemv phases",
                   mode=mode, bp=bp, K=K, N=N, plan=plan,
                   span_ns=int((start + d[:, 6]).max()),
                   start_skew_ns=int(start.max()),
                   block_ns_median=float(np.median(d[:, 6])),
                   max_blocks_an_sm=int(per_sm.max()),
                   idle_sms=int((per_sm == 0).sum()),
                   cycles_median={p: float(np.median(d[:, i + 1]))
                                  for i, p in enumerate(PHASES)},
                   cycles_max={p: int(d[:, i + 1].max())
                               for i, p in enumerate(PHASES)})
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def time_sessions(args, card: str) -> list:
    import statistics

    import torch
    from repro_torch.configs import get_rnn_config
    from repro_torch.core import bnlstm as BL
    from repro_torch.serve.recurrent import RNNRuntime, drive_session
    cfg = get_rnn_config("rnn-paper")
    g = torch.Generator().manual_seed(0)
    v = CS.off_init(BL.rnn_lm_init(g, cfg, device="cuda"), g)
    rt = RNNRuntime(cfg, {"params": BL.export_packed_rnn(v["params"], cfg),
                          "state": v["state"]}, device="cuda")
    out = []
    for B in (4, 16):
        prompt = torch.randint(0, cfg.vocab, (B, 32), generator=g)
        run = lambda: drive_session(rt, prompt, cfg.vocab, gen=32,
                                    temperature=0.8, top_k=40, seed=0)[1]
        run()
        tok_s = [run()["decode_tok_s"] for _ in range(7)]
        row = dict(card=card, src=args.src, path="drive_session", B=B,
                   prompt=32, gen=32, decode_tok_s=tok_s,
                   median_decode_tok_s=statistics.median(tok_s))
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def chunk_rows(args, card: str, label: str, call, vocab: int,
               reps: int) -> list:
    """`call(tokens)` (one prompt chunk at B = 1 into fresh caches) at each
    length of CHUNK_LENGTHS: device time, wall time, packed launches."""
    import torch
    from repro_torch.kernels import dispatch
    g = torch.Generator().manual_seed(5)
    out = []
    for n in CHUNK_LENGTHS:
        tok = torch.randint(0, vocab, (1, n), generator=g).cuda()
        before = dict(dispatch.LAUNCHES)
        call(tok)
        torch.cuda.synchronize()
        d = {k: v - before.get(k, 0) for k, v in dispatch.LAUNCHES.items()}
        t = CS.time_call(lambda: call(tok), reps)
        row = dict(card=card, src=args.src, path=label, B=1, chunk=n,
                   ms=t["ms"], wall_ms=t["wall_ms"], ms_by=t["ms_by"],
                   packed_gemv=d.get("packed_gemv", 0),
                   packed_matmul=d.get("packed_matmul", 0))
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def time_chunks(args, card: str) -> list:
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import export_packed
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import synth_traffic
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.recurrent import TransformerRuntime
    out = []
    cfg = get_config("qwen3-0.6b")
    masters = T.model_init(torch.Generator("cuda").manual_seed(0), cfg)
    rt = TransformerRuntime(cfg, export_packed(masters, cfg.quant),
                            device="cuda")
    del masters
    P, G = 128, 8
    out += chunk_rows(args, card, "qwen3-0.6b prefill_chunk", lambda tok:
                      rt.prefill_chunk(tok, rt.init_state(1, P + G)),
                      cfg.vocab, 20)
    reqs = synth_traffic(cfg.vocab, requests=16, rate=1e3, prompt_len=P,
                         gen=G, temperature=0.8, top_k=40, seed=0)
    eng = ServeEngine(rt, cfg.vocab, slots=8, max_context=P + G,
                      prefill_chunk=32)
    eng.warm()
    run = lambda: eng.run([dataclasses.replace(r) for r in reqs],
                          realtime=False)[1]
    em = run()
    before = dict(dispatch.LAUNCHES)
    by_name, wall = CS.device_profile(run, 1)
    d = {k: v - before.get(k, 0) for k, v in dispatch.LAUNCHES.items()}
    busy, idle = CS.busy_idle(by_name, wall, 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    row = dict(card=card, src=args.src, path="qwen3-0.6b engine",
               requests=len(reqs), slots=8, chunk=32,
               prompt_tokens=sum(len(r.prompt) for r in reqs),
               short_last_chunks=sum(0 < len(r.prompt) % 32 <= 8
                                     for r in reqs),
               ttft_p50_ms=em["ttft_p50_s"] * 1e3,
               ttft_p95_ms=em["ttft_p95_s"] * 1e3, wall_ms=em["wall_s"] * 1e3,
               profiled_wall_ms=wall * 1e3,
               device_busy_ms=None if busy is None else busy / 1e3,
               idle_share=idle, packed_gemv=d.get("packed_gemv", 0),
               packed_matmul=d.get("packed_matmul", 0),
               top=[(k[:48], v / 1e3) for k, v in top])
    print(json.dumps(row), flush=True)
    out.append(row)
    del rt, eng
    torch.cuda.empty_cache()

    arch = "llama-3.2-vision-90b"
    vcfg = CS.pool_config(arch)
    cut = CS.pool_config(arch, n_layers=len(vcfg.block_pattern))
    img = torch.randn((1, vcfg.n_img_tokens, vcfg.d_model),
                      generator=torch.Generator("cuda").manual_seed(7),
                      device="cuda")
    vrt = TransformerRuntime(cut, CS.pool_build(cut, off=CS.VLM_OFF),
                             extras={"img": img}, device="cuda")
    out += chunk_rows(args, card, f"{arch} prefill, {cut.n_layers} layers",
                      lambda tok: vrt.prefill(tok, vrt.init_state(1, 160)),
                      cut.vocab, 10)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(CS.ROOT / "src"))
    ap.add_argument("--only", choices=("tick", "gemv", "gemm", "bmm", "phases",
                                       "session", "chunks"), default=None)
    ap.add_argument("--rows", type=int, choices=(4, 8), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import dispatch
    dispatch.strict_fp32()
    card = CS.card_line()
    out = []
    if args.only in (None, "tick"):
        out += time_ticks(args, card)
    if args.only in (None, "gemv"):
        out += time_gemvs(args, card)
    if args.only in (None, "gemm"):
        out += time_gemms(args, card)
    if args.only in (None, "bmm"):
        out += time_bmms(args, card)
    if args.only == "phases":
        out += gemv_phases(args, card)
    if args.only == "session":
        out += time_sessions(args, card)
    if args.only == "chunks":
        out += time_chunks(args, card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
