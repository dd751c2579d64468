#!/usr/bin/env python3
"""Bisect the serving path's batch invariance on an NVIDIA card, op by op.

The engine promises that a request's stream depends only on its prompt,
seed and sampling parameters, never on what shared its batch or how its
prompt was chunked (serve/engine.py).  This script runs one request alone
and the same request among others, and names the ops whose output rows
differ in bits:

  * qwen3-0.6B at full width (d 1024, 16/8 heads of 128, d_ff 3072, vocab
    151,936, tied, ternary, bf16) cut to `--layers` layers, random weights
    from a seed, served packed through `TransformerRuntime`:
      decode — one step of the request alone (B = 1) against the same step
               with the request in slot 3 of 8, its cache row the same
               bytes;
      prefill — the whole prompt (100 tokens, one call) against its first
               chunk of 32, and against a last chunk of 4 (after the first
               96 tokens in one call), whose projections take the GEMM at
               M = 4 (the sequence route, at any chunk length);
  * the RNN at L = 2, H = 256 (ternary, BN off init): the whole prompt
    (40 tokens) against chunks of 32 and 8, compared packed product by
    packed product (layer 0's recurrent GEMVs, layer 1's x-side product
    over the chunk, layer 1's recurrent GEMVs).

Every aten op and every packed-kernel call of the run is recorded (a
`TorchDispatchMode`; the kernels are ctypes launches, so their wrappers
are wrapped).  The other run then walks the same op sequence: each
output's rows of the request (a slot of the batch dim, or a span of the
token dim) are compared bit for bit with the lone run's, and then
overwritten with them, so each op is judged on equal inputs and every
op whose own arithmetic depends on the batch or the chunk is named, not
only the first.  An output whose rows cannot be mapped (more than one
dim differs, as in the attention logits of a prefill) is skipped and
not repaired; ops after it are marked as judged on unrepaired inputs.

    python3 bisect_invariance.py [--src OTHER/src] [--layers 2] [--out F]

`--src` runs another checkout's port (an earlier commit unpacked with
`git archive`), so two versions compare within one call on one card.  It
needs one card; the results go to `--out` (JSON) and the summary to
standard output.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


# ---------------------------------------------------------------------------
# recording and walking an op sequence
# ---------------------------------------------------------------------------

UNINIT = {"empty.memory_format", "empty_like.default", "empty_strided.default",
          "new_empty.default", "new_empty_strided.default"}


def _tensors(out) -> list:
    import torch
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


def _bits(t):
    import torch
    if t.dtype in (torch.float32, torch.int32):
        return t.contiguous().view(torch.int32)
    if t.dtype in (torch.bfloat16, torch.float16, torch.int16):
        return t.contiguous().view(torch.int16)
    if t.dtype in (torch.float64, torch.int64):
        return t.contiguous().view(torch.int64)
    return t.contiguous()


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        _bits(a), _bits(b))


class Walk:
    """Records an op sequence (`ref` None; `names_only` keeps no outputs)
    or walks a recorded one: op i of this run meets the lone run's op
    `align[i]` (the two name sequences aligned beforehand, so an op that
    only one run issues, as a loop over rows, does not shift the rest),
    its floating-point outputs compared through `mapper(ref_t, t) ->
    (ref_view, view)` (None when the rows cannot be mapped) and repaired.
    Integer outputs (indices, positions, slot numbers) and in-place ops
    (a cache written whole) are not compared."""

    def __init__(self, ref=None, mapper=None, align=None,
                 names_only=False):
        self.ops = []          # recorded: (name, [outputs])
        self.ref, self.mapper, self.align = ref, mapper, align
        self.names_only = names_only
        self.i = 0
        self.report = []       # walked: (index, name, status, detail)
        self.dirty = False     # an unmapped op has left inputs unrepaired
        self.busy = False      # the walk's own ops are not recorded

    def event(self, name: str, outs: list) -> None:
        if self.busy:
            return
        self.busy = True
        try:
            self._event(name, outs)
        finally:
            self.busy = False

    def _event(self, name: str, outs: list) -> None:
        if self.ref is None:
            self.ops.append((name, [] if self.names_only else
                             [o.detach().clone() for o in outs]))
            return
        i = self.i
        self.i += 1
        if i not in self.align:
            self.report.append((i, name, "unmatched", ""))
            self.dirty = True
            return
        rname, routs = self.ref[self.align[i]]
        if rname != name or len(routs) != len(outs):
            self.report.append((i, name, "unmatched",
                                f"lone run had {rname}"))
            self.dirty = True
            return
        if name.split(".")[0].endswith("_"):  # in place: a whole buffer
            return
        for r, o in zip(routs, outs):
            if not o.is_floating_point():
                continue
            m = self.mapper(r, o)
            if m is None:
                self.report.append((i, name, "skipped",
                                    f"{tuple(r.shape)} vs {tuple(o.shape)}"))
                self.dirty = True
                continue
            rv, ov = m
            if same_bits(rv, ov):
                self.report.append((i, name, "equal",
                                    "dirty" if self.dirty else ""))
                continue
            diff = (rv.double() - ov.double()).abs().max().item()
            state = "dirty" if self.dirty else "clean"
            self.report.append((i, name, "differ",
                                f"{tuple(r.shape)} vs {tuple(o.shape)} max "
                                f"{diff} {state}"))
            ov.copy_(rv)  # the repair: later ops see the lone run's rows


def recording(walk: Walk):
    """A context recording every aten op and packed-kernel call into
    `walk`; the kernel wrappers log under one name, "packed", with the
    route beside it in the op's place of the sequence."""
    import contextlib

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.kernels import decode_step as DK
    from repro_torch.kernels import packed_matmul as PK

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = f"{func.__name__}"
            if name not in UNINIT:
                walk.event(name, _tensors(out))
            return out

    originals = {n: getattr(PK, n) for n in ("packed_gemv", "packed_matmul")}
    originals["fused_tick"] = DK.fused_tick

    def wrap(n, f):
        def g(*a, **k):
            out = f(*a, **k)
            walk.event("packed" if n != "fused_tick" else n, _tensors(out))
            if not walk.busy:
                walk.routes.append((n, tuple(a[0].shape)))
            return out
        return g

    @contextlib.contextmanager
    def ctx():
        walk.routes = []
        PK.packed_gemv = wrap("packed_gemv", originals["packed_gemv"])
        PK.packed_matmul = wrap("packed_matmul", originals["packed_matmul"])
        DK.fused_tick = wrap("fused_tick", originals["fused_tick"])
        try:
            with torch.no_grad(), Mode():
                yield walk
        finally:
            PK.packed_gemv = originals["packed_gemv"]
            PK.packed_matmul = originals["packed_matmul"]
            DK.fused_tick = originals["fused_tick"]
    return ctx()


def compare(label: str, run_ref, run_other, mapper) -> dict:
    """Record `run_ref()` (the lone run), record `run_other()`'s op names,
    align the two name sequences, then walk `run_other()` again against
    the lone run's outputs.  Each callable builds its inputs afresh (the
    caches are written in place)."""
    import difflib
    ref = Walk()
    with recording(ref):
        run_ref()
    names = Walk(names_only=True)
    with recording(names):
        run_other()
    sm = difflib.SequenceMatcher(None, [n for n, _ in names.ops],
                                 [n for n, _ in ref.ops], autojunk=False)
    align = {}
    for a, b, n in sm.get_matching_blocks():
        align.update({a + k: b + k for k in range(n)})
    walk = Walk(ref.ops, mapper, align)
    with recording(walk):
        run_other()
    out = summarize(label, walk)
    out["ops"] = {"lone": len(ref.ops), "other": len(names.ops),
                  "aligned": len(align)}
    return out


def slot_mapper(B: int, slot: int):
    """The lone run's outputs (batch 1) against the batch of B: the one
    dim whose size is B times the lone run's, split as (B, n) and its
    `slot`; equal shapes compare whole."""
    def mapper(r, o):
        diff = [d for d in range(r.dim()) if r.dim() == o.dim()
                and r.shape[d] != o.shape[d]]
        if r.dim() != o.dim() or len(diff) > 1:
            return None
        if not diff:
            return r, o
        d = diff[0]
        if o.shape[d] != B * r.shape[d]:
            return None
        return r, o.unflatten(d, (B, r.shape[d])).select(d, slot)
    return mapper


def span_mapper(P: int, off: int, n: int):
    """The whole prompt's outputs (P tokens) against a chunk's (n tokens
    from `off`): the one dim of size P against n, the whole's span.  An
    output without a token dim is not compared: a cache read or written
    whole holds other positions in the two runs, and the last token's row
    is another token's."""
    def mapper(r, o):
        diff = [d for d in range(r.dim()) if r.dim() == o.dim()
                and r.shape[d] != o.shape[d]]
        if r.dim() != o.dim() or len(diff) != 1:
            return None
        d = diff[0]
        if r.shape[d] != P or o.shape[d] != n:
            return None
        return r.narrow(d, off, n), o
    return mapper


def summarize(label: str, walk: Walk) -> dict:
    from collections import Counter
    rep = walk.report
    status = Counter(s for _, _, s, _ in rep)
    differ = [(i, n, d) for i, n, s, d in rep if s == "differ"]
    first = differ[0] if differ else None
    by_op = Counter(n for _, n, _ in differ)
    clean = Counter(n for _, n, d in differ if "clean" in d)
    routes = Counter(r for r, _ in getattr(walk, "routes", []))
    print(f"  {label}: {dict(status)}; packed routes {dict(routes)}",
          flush=True)
    if first:
        print(f"    first op whose rows differ: #{first[0]} {first[1]} "
              f"({first[2]})", flush=True)
        print(f"    ops that differ on repaired inputs: {dict(clean)}; all "
              f"that differ: {dict(by_op)}", flush=True)
    else:
        print("    every compared op's rows are bit-equal", flush=True)
    return {"status": dict(status), "routes": dict(routes),
            "first": list(first) if first else None,
            "differ_clean": dict(clean), "differ_all": dict(by_op),
            "differ": [list(x) for x in differ[:60]]}


# ---------------------------------------------------------------------------
# the scenarios
# ---------------------------------------------------------------------------


def qwen_runtime(layers: int, dev: str, reduced: bool,
                 arch: str = "qwen3-0.6b"):
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import export_packed
    from repro_torch.models import transformer as T
    from repro_torch.serve.recurrent import TransformerRuntime
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg,
                              n_layers=layers)
    params = T.model_init(torch.Generator(dev).manual_seed(0), cfg)
    packed = export_packed(params, cfg.quant)
    del params
    return cfg, TransformerRuntime(cfg, packed, device=dev)


def _clone(state):
    from repro_torch.core.qtensor import tree_map
    from repro_torch.serve.kvcache import AttnCache
    return tree_map(lambda c: c._replace(k=c.k.clone(), v=c.v.clone(),
                                         pos=c.pos.clone())
                    if isinstance(c, AttnCache) else c.clone(), state)


def qwen_decode(rt, cfg, B: int = 8, slot: int = 3, P: int = 100) -> dict:
    import torch
    from repro_torch.serve.engine import tree_gather_slot, tree_write_slot
    dev = rt.device
    g = torch.Generator().manual_seed(2)
    ctx = 256
    prompt = torch.randint(0, cfg.vocab, (1, P), generator=g).to(dev)
    lone = rt.init_state(1, ctx, per_slot=True)
    _, lone = rt.prefill_chunk(prompt, lone)
    pool = rt.init_state(B, ctx, per_slot=True)
    for s in range(B):
        if s == slot:
            continue
        other = torch.randint(0, cfg.vocab, (1, 17 + 9 * s), generator=g)
        sub = tree_gather_slot(pool, s)
        _, sub = rt.prefill_chunk(other.to(dev), sub)
        tree_write_slot(pool, sub, s)
    tree_write_slot(pool, lone, slot)
    tok1 = torch.tensor([11], device=dev)
    toks = torch.randint(0, cfg.vocab, (B,), generator=g).to(dev)
    toks[slot] = 11
    live1 = torch.ones(1, dtype=torch.bool, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    got = {}
    out = compare(
        f"{cfg.name} decode, B = 1 against slot {slot} of {B}",
        lambda: got.__setitem__("lone", rt.decode_fn(tok1, _clone(lone),
                                                     live1)[0]),
        lambda: got.__setitem__("batch", rt.decode_fn(toks, _clone(pool),
                                                      live)[0]),
        slot_mapper(B, slot))
    out["logits_equal_after_repairs"] = same_bits(got["lone"][0],
                                                  got["batch"][slot])
    return out


def qwen_prefill(rt, cfg, P: int = 100) -> dict:
    import torch
    g = torch.Generator().manual_seed(3)
    ctx = 256
    prompt = torch.randint(0, cfg.vocab, (1, P), generator=g).to(rt.device)
    fresh = lambda: rt.init_state(1, ctx, per_slot=True)
    whole = lambda: rt.prefill_chunk(prompt, fresh())
    out = {"first_chunk": compare(
        f"qwen3 prefill, {P} tokens whole against the first chunk of 32",
        whole, lambda: rt.prefill_chunk(prompt[:, :32], fresh()),
        span_mapper(P, 0, 32))}
    # the last chunk of 4 after the first P - 4 tokens in one call: the
    # GEMM at M = 4 against the whole prompt's GEMM rows (a prompt chunk's
    # products take the sequence route at any length)
    _, st = rt.prefill_chunk(prompt[:, :P - 4], fresh())
    out["last_chunk"] = compare(
        f"qwen3 prefill, {P} tokens whole against a last chunk of 4 after "
        f"{P - 4}", whole,
        lambda: rt.prefill_chunk(prompt[:, P - 4:], _clone(st)),
        span_mapper(P, P - 4, 4))
    return out


def rnn_prefill(dev: str, P: int = 40, chunks=(32, 8)) -> dict:
    """The RNN's packed products, whole against chunked: per chunk,
    layer 0's recurrent GEMVs (one row a step), layer 1's x-side product
    over the chunk, layer 1's recurrent GEMVs, each against the whole
    prompt's at the same tokens."""
    import dataclasses

    import torch
    from repro_torch.configs import get_rnn_config
    from repro_torch.core import bnlstm as BL
    from repro_torch.kernels import ops as OPS
    from repro_torch.serve.recurrent import RNNRuntime
    sys.path.insert(0, str(ROOT))
    from chip_smoke import off_init
    cfg = dataclasses.replace(get_rnn_config("rnn-paper"), d_hidden=256,
                              n_layers=2)
    gen = torch.Generator().manual_seed(1)
    var = off_init(BL.rnn_lm_init(gen, cfg, device=dev), gen)
    rt = RNNRuntime(cfg, {"params": BL.export_packed_rnn(var["params"], cfg),
                          "state": var["state"]}, device=dev)
    toks = torch.randint(0, cfg.vocab, (1, P), generator=gen).to(dev)

    calls = []
    orig = OPS.packed_matmul

    def logged(x, codes, alpha=1.0, *, mode="ternary"):
        y = orig(x, codes, alpha, mode=mode)
        calls.append((x.reshape(-1, x.shape[-1]).shape[0],
                      y.reshape(-1, y.shape[-1]).clone()))
        return y

    def run(parts):
        calls.clear()
        OPS.packed_matmul = logged
        try:
            st = rt.init_state(1, per_slot=True)
            for lo, hi in parts:
                _, st = rt.prefill_chunk(toks[:, lo:hi], st)
        finally:
            OPS.packed_matmul = orig
        return list(calls), st

    def layout(seq, T):
        """Split a chunk's calls: layer 0's T steps, layer 1's x-side
        product, layer 1's T steps (layer 0's x side is a table; a packed
        head's one call may follow)."""
        if len(seq) != 2 * T + 1 + extra or seq[T][0] != T:
            raise RuntimeError(f"unexpected packed calls for a chunk of {T}: "
                               f"{[m for m, _ in seq]}")
        return seq[:T], seq[T], seq[T + 1:2 * T + 1]

    whole, st_whole = run([(0, P)])
    extra = len(whole) - (2 * P + 1)
    w0, wx, w1 = layout(whole, P)
    out = {}
    bounds, lo = [], 0
    for c in chunks:
        bounds.append((lo, min(lo + c, P)))
        lo += c
    got, st = run(bounds)
    i, first = 0, None
    rows = []
    for lo, hi in bounds:
        T = hi - lo
        c0, cx, c1 = layout(got[i:i + 2 * T + 1 + extra], T)
        i += 2 * T + 1 + extra
        eq0 = [same_bits(a[1], b[1]) for a, b in zip(c0, w0[lo:hi])]
        eqx = same_bits(cx[1], wx[1][lo:hi])
        eq1 = [same_bits(a[1], b[1]) for a, b in zip(c1, w1[lo:hi])]
        rows.append({"chunk": [lo, hi], "layer0_steps_equal": all(eq0),
                     "layer1_x_equal": eqx,
                     "layer1_x_route": f"M={T} against M={P}",
                     "layer1_steps_equal": sum(eq1), "steps": T})
        if first is None and not all(eq0):
            first = f"chunk {lo}..{hi}: layer 0 recurrent GEMV"
        if first is None and not eqx:
            first = (f"chunk {lo}..{hi}: layer 1's x-side product over the "
                     f"chunk (the GEMM at M = {T}) against the whole "
                     f"prompt's GEMM rows (M = {P})")
    out["chunks"] = rows
    out["first"] = first
    out["state_bits_equal"] = (same_bits(st.h, st_whole.h)
                               and same_bits(st.c, st_whole.c))
    out["state_max_abs"] = max((st.h - st_whole.h).abs().max().item(),
                               (st.c - st_whole.c).abs().max().item())
    print(f"  rnn L=2 H=256, {P} tokens whole against chunks {chunks}: "
          f"first differing op: {first}; chunked state bit-equal "
          f"{out['state_bits_equal']} (max abs {out['state_max_abs']:.3e})",
          flush=True)
    for r in rows:
        print(f"    {r}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch to run")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help="another pool arch to bisect a decode step of "
                         "(e.g. zamba2-1.2b with --layers 6: six mamba "
                         "layers and one shared attention block)")
    ap.add_argument("--device", default="cuda",
                    help="'cpu' rehearses the script on the plain versions "
                         "(with --reduced); no number of it is a card's")
    ap.add_argument("--reduced", action="store_true",
                    help="qwen3's reduced widths (a CPU rehearsal)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "bisect_invariance.json"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bisect_invariance: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, dispatch
    if args.device == "cuda":
        dispatch.strict_fp32()
        build.build_all(("packed_gemv", "packed_matmul", "fused_tick"))
    card = card_line() if args.device == "cuda" else "cpu rehearsal"
    print(f"card: {card}; src {args.src}", flush=True)
    report = {"card": card, "src": args.src, "layers": args.layers}
    cfg, rt = qwen_runtime(args.layers, args.device, args.reduced,
                           args.arch)
    report["qwen_decode"] = qwen_decode(rt, cfg)
    if args.arch == "qwen3-0.6b":
        report["qwen_prefill"] = qwen_prefill(rt, cfg)
        report["rnn_prefill"] = rnn_prefill(args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1, default=str))
    print(f"bisect_invariance: wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
