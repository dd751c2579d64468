#!/usr/bin/env python3
"""Time the port's fused decode tick (`csrc/fused_tick.cu`) and its
multiply-free GEMV (`csrc/packed_gemv.cu`) at the widths of the paper's
configurations, on one NVIDIA card.

    python3 time_kernels.py [--src DIR] [--only tick|gemv|phases]
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
`--only phases` (not run by default) times the GEMV's phases instead, at
the main path's ternary bp = 4 and binary bp = 8: a copy of
`csrc/packed_gemv.cu` built with clock probes (`PHASE_PROBES`) records,
for each block, its start and end on the global timer, its SM, and the
SM cycles from its start to the end of x staging, of its adds, of its
pushes to the cluster and of the cluster barrier.
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


# (anchor in csrc/packed_gemv.cu, probe inserted before it): block start,
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
    src = (build.CSRC / "packed_gemv.cu").read_text()
    for anchor, probe in PHASE_PROBES:
        if src.count(anchor) != 1:
            CS.fail(f"phase probe anchor {anchor!r} is not in packed_gemv.cu "
                    f"once: update PHASE_PROBES")
        src = src.replace(anchor, probe + anchor)
    probed = build.BUILD_DIR / "packed_gemv_phases.cu"
    probed.parent.mkdir(parents=True, exist_ok=True)
    probed.write_text(src)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(CS.ROOT / "src"))
    ap.add_argument("--only", choices=("tick", "gemv", "phases"), default=None)
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
    if args.only == "phases":
        out += gemv_phases(args, card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
