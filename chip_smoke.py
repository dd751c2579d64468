#!/usr/bin/env python3
"""Drive the PyTorch port's BN-LSTM serving and training paths on one
NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. card     — nvidia-smi name and power limit, torch and CUDA versions;
  2. build    — compile the four CUDA kernels from `src/repro_torch/csrc`
                (one nvcc each, all at once) and print the ptxas report:
                `packed_gemv`, `packed_matmul` and `fused_tick` must spill
                no register;
                then the SASS of `packed_gemv` must hold no float multiply,
                and that of `packed_matmul` bf16 tensor-core HMMAs;
  3. kernels  — the launch floor (the device time of a one-element
                in-place add on the same stream); then, at the main path's
                shapes, hold each kernel against its plain PyTorch version
                on the card and time both (device time from torch.profiler,
                wall time per call from CUDA events), beside the analytic
                bound and one PyTorch library call where one computes the
                same function: the GEMV at bp = 4 (B = 4 prefill, ternary)
                and 8 (binary), the GEMM at M = 16 (B = 16 prefill) and 32
                (packed eval), each launched twice and held bit-equal; the
                tick at B = 4 and 16, each held against the plain version on
                its own inputs;
  4. main path — rnn-paper at full width (char-PTB BN-LSTM, H = 1000,
                ternary, random weights from a seed, BN statistics, BN
                scales and biases moved off init): rnn_lm_init ->
                export_packed_rnn -> RNNRuntime -> drive_session at batch 4
                (GEMV prefill) and 16 (GEMM prefill), prompt 32, gen 32,
                greedy and sampled, plus the `repro_torch.launch.serve` CLI.
                Launch counters are zeroed just before and read just after;
                every kernel must have launched, one fused tick per decode
                step, and the fused decode's logits, h and c must match the
                unfused plain path on the card at B = 4 and 16 within 1e-5
                of their size;
  5. profile  — where a prefill's and a decode step's time goes at B = 4
                and 16 (torch.profiler: device busy time, idle share);
  6. training — rnn-paper at full width through `repro_torch.launch.train`
                (batch 32, seq 100, 20 steps, eval and checkpoint every 10,
                synthetic corpus), with the launch counters zeroed just
                before and read just after: the loss must be finite and
                fall; two 3-step runs from one seed and a resume from the
                step-10 checkpoint must end bit-equal to their twins; the
                quantize_pack kernel, fed layer 0's wh, noise and alpha of
                step 10, must give the packed form of that step's own
                dense sample; the packed export's eval loss must match the
                fp masters' deterministic eval within 1e-5 (the GEMM at
                M = 32 each timestep), and the export must serve through
                drive_session (fused tick, GEMV prefill); every kernel must
                have launched.  Then one train step under torch.profiler;
  7. result   — the kernels JSON line, the card line, and
                {"ok": true, "device": {...}} last.

It needs one card and no network; the build goes to `build/kernels/`.
Details land in `chiprun_out/chip_smoke.json`.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_S = 67e12        # H100 SXM fp32 on the CUDA cores (FMA = 2 flop)
FP32_ADD_S = FP32_FLOP_S / 2  # an FADD issues at the FMA instruction rate
BF16_FLOP_S = 989e12       # H100 SXM dense bf16 on the tensor cores
MULTIPLY_OPS = re.compile(r"\b(FMUL|FFMA|HMUL2|HFMA2|DMUL|DFMA|HMMA)\w*")
# ptxas materializes constants with `HFMA2.MMA Rd, -RZ, RZ, imm, imm`: both
# multiplicands are the zero register, so it moves an immediate and
# multiplies no data
CONSTANT_MOVE = re.compile(r"\bHFMA2(\.MMA)?\s+R\d+,\s*-?RZ,\s*-?RZ,")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_profile(fn, reps: int = 1, skip: str | None = None,
                   attempts: int = 3):
    """Run `fn` `reps` times under torch.profiler.  Returns (device us by
    kernel name, host wall seconds of the whole run, synchronized); kernels
    whose name holds `skip` are left out.  Now and then the profiler hands
    back no device event at all for a run; the run is then repeated, up to
    `attempts` times in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not (skip and skip in e.name):
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us())
        if by_name:
            break
    return by_name, wall


class L2Flush:
    """Evicts the 50 MB L2 before a call: rewrites a 256 MB buffer with a
    kernel (`bitwise_not`) that the timed functions never launch, so its
    time can be left out by name."""
    name = "bitwise_not"

    def __init__(self):
        import torch
        self.buf = torch.zeros(64 << 20, dtype=torch.int32, device="cuda")

    def __call__(self):
        self.buf.bitwise_not_()


def time_call(fn, reps: int, flush: L2Flush | None = None) -> dict:
    """Per call of `fn`: `ms`, the device time of the kernels it launches
    (torch.profiler over `reps` calls), and `wall_ms`, the median time
    between two CUDA events around one call, launch overhead included.
    With `flush`, every call finds the L2 cold."""
    import torch
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        walls.append(a.elapsed_time(b))
    walls.sort()
    if flush is not None:
        run = lambda: (flush(), fn())
        by_name, _ = device_profile(run, reps, skip=flush.name)
    else:
        by_name, _ = device_profile(fn, reps)
    dev_us = sum(by_name.values())
    if dev_us <= 0:
        fail("torch.profiler recorded no device time")
    return {"ms": dev_us / 1e3 / reps, "wall_ms": walls[reps // 2]}


def timed_row(name: str, shape: str, err: float, kernel, plain, library,
              bound_ms: float, bound_by: str, reps: int = 200,
              plain_reps: int = 10, flush: L2Flush | None = None) -> dict:
    """One kernels-table row: the kernel, its plain version and the
    library call (or None), each timed by `time_call`."""
    k = time_call(kernel, reps, flush)
    p = time_call(plain, plain_reps, flush)
    lib = time_call(library, reps, flush) if library is not None else None
    return dict(name=name, shape=shape, max_abs_err=err, ms=k["ms"],
                wall_ms=k["wall_ms"], plain_ms=p["ms"],
                plain_wall_ms=p["wall_ms"], bound_ms=bound_ms,
                bound_by=bound_by,
                library_ms=None if lib is None else lib["ms"],
                library_wall_ms=None if lib is None else lib["wall_ms"])


def bound(nbytes: int, seconds_of_ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S
    if t_bytes >= seconds_of_ops:
        return t_bytes * 1e3, "bytes"
    return seconds_of_ops * 1e3, "operations"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def nonzero_weights(qt) -> int:
    """Nonzero entries of a packed weight (k, N): a row of x needs one add
    for each of them, and none for a zero code."""
    import torch
    return int(torch.count_nonzero(qt.dequantize()))


def packed_bytes(qt, rows: int) -> int:
    """x (rows, k) and the code words read once, the output written once."""
    return rows * qt.k * 4 + nbytes(qt.codes) + rows * qt.codes.shape[1] * 4


def packed_bound(qt, rows: int) -> tuple[float, str]:
    """The bound of the multiply-free GEMV x (rows, k) @ unpack(codes): its
    bytes, or one fp32 add per row and nonzero weight on the CUDA cores
    (the weights are -1/0/+1, so a product is an add or nothing)."""
    return bound(packed_bytes(qt, rows),
                 rows * nonzero_weights(qt) / FP32_ADD_S)


def gemm_bound(qt, rows: int) -> tuple[float, str]:
    """The bound of the GEMM's route to x (rows, k) @ unpack(codes): its
    bytes, or the three bf16 products of the exact split (x = hi + mid +
    lo), 3 * 2 * rows * k * N flops at the bf16 tensor-core rate."""
    flops = 3 * 2 * rows * qt.k * qt.codes.shape[1]
    return bound(packed_bytes(qt, rows), flops / BF16_FLOP_S)


def tick_bound(cfg, qv: dict, B: int) -> tuple[float, str]:
    """The bound of one fused tick, counted on the unpadded function: B rows,
    H hidden, V vocab, the packed words as stored (ceil(H/G) per column)."""
    L, g, H, V = cfg.n_layers, cfg.n_gates, cfg.d_hidden, cfg.vocab
    layers = qv["params"]["layers"]
    packed = [lp["wh"] for lp in layers] + [lp["wx"] for lp in layers[1:]]
    read = (sum(nbytes(q.codes) for q in packed)
            + 4 * B * g * H                  # layer-0 input preacts
            + 4 * 2 * L * B * H              # h, c
            + 4 * 2 * (2 * L - 1) * g * H    # h- and x-side BN affines
            + 4 * 2 * L * H                  # cell-norm affines
            + 4 * (H * V + V))               # head
    written = 4 * 2 * L * B * H + 4 * B * V + 4 * B   # h', c', logits, greedy
    adds = B * sum(nonzero_weights(q) for q in packed)
    return bound(read + written,
                 adds / FP32_ADD_S + 2 * B * H * V / FP32_FLOP_S)


def off_init(var: dict, g) -> dict:
    """Move a fresh init toward what training leaves, in place: BN
    statistics walked off (0, 1), BN scales phi from [0.5, 1.5) instead of
    0.1, and random gate and head biases.  At init, h and the logits are
    about 1e-3: too small for an error limit to tell a wrong tick from a
    right one."""
    import torch
    from repro_torch.core.recurrent_bn import BNParams, BNState
    dev = var["params"]["head"]["bs"].device
    normal = lambda t: torch.randn(t.shape, generator=g).to(dev)
    uniform = lambda t: torch.rand(t.shape, generator=g).to(dev)
    for lp, st in zip(var["params"]["layers"], var["state"]["layers"]):
        for k, s in st.items():
            st[k] = BNState(s.mean + 0.1 * normal(s.mean),
                            s.var * (1 + 0.5 * uniform(s.var)), s.count)
            lp[k] = BNParams(phi=0.5 + uniform(lp[k].phi), gamma=lp[k].gamma)
        lp["b"] = 0.1 * normal(lp["b"])
    var["params"]["head"]["bs"] = 0.1 * normal(var["params"]["head"]["bs"])
    return var


def ptxas_usage(log: str) -> list:
    """(kernel, registers, bytes spilled: stores + loads) for each kernel
    function of an `nvcc -Xptxas -v` log, template arguments kept."""
    out, fn, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            n = re.search(r"([a-z][a-z_]*_kernel)I((?:L[ib]\d+E)+)E", m.group(1))
            fn = (f"{n.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', n.group(2)))}>"
                  if n else m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), spill))
            fn, spill = None, 0
    return out


def sass_functions(so_path: Path) -> dict:
    """{kernel function: its SASS lines} of a kernel library (cuobjdump)."""
    import os
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
        elif cur is not None and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            funcs[cur].append(line)
    return funcs


def sass_check(gemv_so: Path, matmul_so: Path) -> dict:
    """The packed_gemv kernels must hold no float multiply (integer IMAD for
    addresses is fine); the packed_matmul kernels must multiply on the
    tensor cores (HMMA, bf16 in, fp32 out).  Returns instruction counts."""
    gemv = {f: body for f, body in sass_functions(gemv_so).items()
            if "packed_gemv" in f}
    if not gemv:
        fail("no packed_gemv function found in the SASS")
    counts = {}
    for f, body in gemv.items():
        bad = [l.strip() for l in body
               if MULTIPLY_OPS.search(l) and not CONSTANT_MOVE.search(l)]
        if bad:
            fail(f"float multiply in {f}: {bad[:4]}")
        text = "\n".join(body)
        counts[f] = {op: len(re.findall(rf"\b{op}\b", text))
                     for op in ("FADD", "LOP3", "IMAD")}
    gemm = {f: body for f, body in sass_functions(matmul_so).items()
            if "packed_matmul" in f}
    if not gemm:
        fail("no packed_matmul function found in the SASS")
    for f, body in gemm.items():
        hmma = sum(1 for l in body if re.search(r"\bHMMA\.16816\.F32\.BF16\b", l))
        if not hmma:
            fail(f"no bf16 HMMA in {f}")
        counts[f] = {"HMMA.16816.F32.BF16": hmma}
    return counts


def launch_floor(report: dict) -> None:
    """The device time of the smallest kernel: a one-element in-place add
    on the current stream, as torch.profiler records it.  Any launch costs
    at least this much of a kernel's device time."""
    import torch
    t = torch.zeros(1, device="cuda")
    floor = time_call(lambda: t.add_(1.0), 200)
    report["launch_floor"] = floor
    print(f"launch floor: one-element add_ {floor['ms'] * 1e3:.2f} us device "
          f"({floor['wall_ms'] * 1e3:.2f} us wall)", flush=True)


def kernels_phase(report: dict) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    import dataclasses

    import torch
    from repro_torch.configs import get_rnn_config
    from repro_torch.core import bnlstm as BL
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.kernels import decode_step as DK
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import packed_matmul as PK

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    cfg = get_rnn_config("rnn-paper")
    var = BL.rnn_lm_init(g, cfg, device=dev)
    wh = {m: BL.export_packed_rnn(var["params"], dataclasses.replace(
        cfg, quant=QuantSpec(mode=m)))["layers"][0]["wh"]
        for m in ("ternary", "binary")}
    rows = []

    # -- packed_gemv: prefill h-side at batch 4, and 8 rows binary -------------
    for mode, bp in (("ternary", 4), ("binary", 8)):
        qt = wh[mode]
        K = qt.codes.shape[0] * qt.group
        x = torch.tanh(torch.randn(bp, K, generator=g)).to(dev)
        x[:, qt.k:] = 0.0
        got = PK.packed_gemv(x, qt.codes, mode=mode)
        again = PK.packed_gemv(x, qt.codes, mode=mode)
        want = PK.packed_gemv_plain(x, qt.codes, mode=mode)
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
            fail(f"packed_gemv {mode} bp={bp}: max abs err {err}")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            fail(f"packed_gemv {mode} bp={bp}: two launches differ")
        w = qt.dequantize() / qt.alpha
        w = torch.nn.functional.pad(w, (0, 0, 0, K - qt.k))
        b_ms, b_by = packed_bound(qt, bp)
        plan = PK.gemv_plan(bp, K, qt.codes.shape[1], mode=mode)
        rows.append(timed_row(
            "packed_gemv", f"{mode} x({bp},{K}) codes{tuple(qt.codes.shape)} "
            f"{plan['blocks']} blocks, cluster {plan['cluster']}",
            err, lambda: PK.packed_gemv(x, qt.codes, mode=mode),
            lambda: PK.packed_gemv_plain(x, qt.codes, mode=mode),
            lambda: torch.matmul(x, w), b_ms, b_by))
        print(f"  packed_gemv {mode}: bp={bp} matches plain; two launches "
              f"bit-equal", flush=True)

    # -- packed_matmul: prefill at batch 16, the packed eval at batch 32 -------
    for mode in ("ternary", "binary"):
        for M in (16, 32):
            qt = wh[mode]
            K = qt.codes.shape[0] * qt.group
            x = torch.tanh(torch.randn(M, K, generator=g)).to(dev)
            x[:, qt.k:] = 0.0
            got = PK.packed_matmul(x, qt.codes, mode=mode)
            again = PK.packed_matmul(x, qt.codes, mode=mode)
            want = PK.packed_matmul_plain(x, qt.codes, mode=mode)
            err = (got - want).abs().max().item()
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
                fail(f"packed_matmul {mode} M={M}: max abs err {err}")
            if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
                fail(f"packed_matmul {mode} M={M}: two launches differ")
            w = torch.nn.functional.pad(qt.dequantize() / qt.alpha,
                                        (0, 0, 0, K - qt.k))
            b_ms, b_by = gemm_bound(qt, M)
            plan = PK.matmul_plan(M, K, qt.codes.shape[1], mode=mode)
            rows.append(timed_row(
                "packed_matmul", f"{mode} x({M},{K}) codes"
                f"{tuple(qt.codes.shape)} {plan['blocks']} blocks, "
                f"cluster {plan['cluster']}", err,
                lambda: PK.packed_matmul(x, qt.codes, mode=mode),
                lambda: PK.packed_matmul_plain(x, qt.codes, mode=mode),
                lambda: torch.matmul(x, w), b_ms, b_by))
            rows[-1]["fp32_add_bound_ms"] = packed_bound(qt, M)[0]
        print(f"  packed_matmul {mode}: M=16,32 match plain; two launches "
              f"bit-equal", flush=True)

    # -- fused_tick: LSTM/GRU x ternary/binary x L in {1, 2}, dead rows --------
    for cell in ("lstm", "gru"):
        for mode in ("ternary", "binary"):
            for L in (1, 2):
                c = dataclasses.replace(
                    cfg, cell=cell, n_layers=L,
                    quant=QuantSpec(mode=mode, norm="batch"))
                v = off_init(BL.rnn_lm_init(g, c, device=dev), g)
                qv = {"params": BL.export_packed_rnn(v["params"], c),
                      "state": v["state"]}
                tick = BL.rnn_decode_tables(qv, c)[0]["tick"]
                B = 4
                h = torch.tanh(torch.randn(L, B, c.d_hidden, generator=g)).to(dev)
                cc = torch.randn(L, B, c.d_hidden, generator=g).to(dev)
                h[:, 1] = float("nan")   # dead-row garbage may be non-finite
                cc[:, 3] = float("inf")
                live = torch.tensor([True, False, True, False], device=dev)
                tok = torch.tensor([3, 7, 1, 49], device=dev)
                args = OPS.tick_operands(tok, h, cc, tick, live)
                got = DK.fused_tick(*args, cell=cell, mode=mode)
                want = DK.fused_tick_plain(*args, cell=cell, mode=mode)
                hn, cn, lg, gr = got
                alive = [0, 2]
                errs = [(got[i][:, alive] - want[i][:, alive]).abs().max().item()
                        for i in (0, 1)]
                errs.append((lg[alive] - want[2][alive]).abs().max().item())
                if errs[0] > 1e-5 or errs[1] > 1e-5 or errs[2] > 1e-4:
                    fail(f"fused_tick {cell}/{mode}/L={L}: errs h,c,logits {errs}")
                for dead in (1, 3):
                    for a, b in ((hn, args[1]), (cn, args[2])):
                        if not torch.equal(a[:, dead].view(torch.int32),
                                           b[:, dead].view(torch.int32)):
                            fail(f"fused_tick {cell}/{mode}/L={L}: dead row "
                                 f"{dead} not bit-exact")
                own = torch.argmax(lg[alive], dim=-1).to(torch.int32)
                if not torch.equal(gr[alive], own):
                    fail(f"fused_tick {cell}/{mode}/L={L}: greedy {gr[alive]} "
                         f"!= argmax of its logits {own}")
                if (cell, mode, L) != ("lstm", "ternary", 1):
                    continue
                # the main path's ticks: every row live, finite state, B = 4
                # (one pass of 4 rows) and B = 16 (two passes of 8), each
                # held against the plain version on its own inputs; the
                # bound counts the unpadded function
                for Bt in (4, 16):
                    h_run = torch.tanh(torch.randn(L, Bt, c.d_hidden,
                                                   generator=g)).to(dev)
                    c_run = torch.randn(L, Bt, c.d_hidden, generator=g).to(dev)
                    tok_run = torch.randint(0, c.vocab, (Bt,), generator=g).to(dev)
                    targs = OPS.tick_operands(tok_run, h_run, c_run, tick, None)
                    hp, vp, bp = targs[4].shape[-1], targs[12].shape[1], targs[0].shape[0]
                    got = DK.fused_tick(*targs, cell=cell, mode=mode)
                    want = DK.fused_tick_plain(*targs, cell=cell, mode=mode)
                    errs = [(got[i] - want[i]).abs().max().item()
                            for i in range(3)]
                    if errs[0] > 1e-5 or errs[1] > 1e-5 or errs[2] > 1e-4:
                        fail(f"fused_tick {cell}/{mode}/L={L} B={Bt}: errs "
                             f"h,c,logits {errs}")
                    own = torch.argmax(got[2], dim=-1).to(torch.int32)
                    if not torch.equal(got[3], own):
                        fail(f"fused_tick {cell}/{mode}/L={L} B={Bt}: greedy "
                             f"{got[3]} != argmax of its logits {own}")
                    b_ms, b_by = tick_bound(c, qv, Bt)
                    rows.append(timed_row(
                        "fused_tick", f"{cell} {mode} L={L} B={Bt} bp={bp} "
                        f"rows={DK.tick_rows(bp)} Hp={hp} Vp={vp}", max(errs),
                        lambda: DK.fused_tick(*targs, cell=cell, mode=mode),
                        lambda: DK.fused_tick_plain(*targs, cell=cell, mode=mode),
                        None, b_ms, b_by))
            print(f"  fused_tick {cell}/{mode}: L=1,2 match plain; dead rows "
                  f"bit-exact; greedy == argmax", flush=True)
    rows += quantize_pack_rows(g)
    report["kernel_rows"] = rows
    us = lambda v: "-" if v is None else f"{v * 1e3:.1f}"
    print("  kernel         shape                                        err       "
          "device us (wall)  plain us (wall)  library us (wall)  bound us",
          flush=True)
    for r in rows:
        print(f"  {r['name']:14s} {r['shape']:44s} {r['max_abs_err']:.2e}  "
              f"{us(r['ms'])} ({us(r['wall_ms'])})  {us(r['plain_ms'])} "
              f"({us(r['plain_wall_ms'])})  {us(r['library_ms'])} "
              f"({us(r['library_wall_ms'])})  {r['bound_ms'] * 1e3:.2f} "
              f"({r['bound_by']})", flush=True)
    return rows


def quantize_pack_rows(g) -> list:
    """quantize_pack at the training path's shapes, rnn-paper's wh (1000,
    4000) and wx (50, 4000) padded to the pack group with w = 0 and
    u = 1.0, ternary and binary: the codes must equal the plain version's
    word for word.  Timed with a cold L2 (the 33 MB of w and u would
    otherwise sit in the 50 MB L2 between launches)."""
    import torch
    from repro_torch.core.quantize import glorot_alpha, pack_group
    from repro_torch.kernels import packed_matmul as PK

    flush = L2Flush()
    rows = []
    for mode in ("ternary", "binary"):
        for k in (1000, 50):
            alpha = glorot_alpha(k, 4000)
            kp = -(-k // pack_group(mode)) * pack_group(mode)
            w = torch.zeros(kp, 4000)
            w[:k] = (torch.rand(k, 4000, generator=g) * 2 - 1) * alpha
            u = torch.ones(kp, 4000)
            u[:k] = torch.rand(k, 4000, generator=g)
            w, u = w.cuda(), u.cuda()
            got = PK.quantize_pack(w, u, alpha, mode=mode)
            want = PK.quantize_pack_plain(w, u, alpha, mode=mode)
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                fail(f"quantize_pack {mode} ({kp}, 4000): {bad} words differ "
                     f"from the plain version")
            b_ms, b_by = bound(nbytes(w, u, got), 6 * w.numel() / FP32_FLOP_S)
            rows.append(timed_row(
                "quantize_pack", f"{mode} w,u ({kp}, 4000) -> {tuple(got.shape)}",
                0.0, lambda: PK.quantize_pack(w, u, alpha, mode=mode),
                lambda: PK.quantize_pack_plain(w, u, alpha, mode=mode),
                None, b_ms, b_by, flush=flush))
    print("  quantize_pack: ternary/binary at (1008|1024, 4000) and (64, 4000) "
          "word-equal to plain", flush=True)
    return rows


def main_path_phase(report: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_rnn_config
    from repro_torch.core import bnlstm as BL
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.recurrent import RNNRuntime, drive_session

    cfg = get_rnn_config("rnn-paper")
    assert (cfg.d_hidden, cfg.vocab, cfg.quant.mode) == (1000, 50, "ternary")
    S, GEN = 32, 32
    sessions = []

    dispatch.reset_counts()   # ---- the counted main-path run starts here ----
    gen = torch.Generator().manual_seed(0)
    var = off_init(BL.rnn_lm_init(gen, cfg, device="cuda"), gen)
    params = BL.export_packed_rnn(var["params"], cfg)
    rt = RNNRuntime(cfg, {"params": params, "state": var["state"]},
                    device="cuda")
    for B in (4, 16):
        prompt = torch.randint(0, cfg.vocab, (B, S),
                               generator=torch.Generator().manual_seed(B))
        for temperature in (0.0, 0.8):
            before = dict(dispatch.LAUNCHES)
            out, m = drive_session(rt, prompt, cfg.vocab, gen=GEN,
                                   temperature=temperature, seed=B,
                                   warmup=True)
            delta = {k: v - before.get(k, 0) for k, v in dispatch.LAUNCHES.items()}
            delta = {k: v for k, v in delta.items() if v}
            lg = m.pop("last_logits")
            if not torch.isfinite(lg).all():
                fail(f"B={B} T={temperature}: non-finite logits")
            if out.shape != (B, GEN) or out.min() < 0 or out.max() >= cfg.vocab:
                fail(f"B={B}: bad tokens shape {out.shape} range "
                     f"[{out.min()}, {out.max()}]")
            # warmup runs one prefill and one decode step besides the timed ones
            prefill_kernel = "packed_gemv" if B <= 8 else "packed_matmul"
            want = {"fused_tick": GEN + 1, prefill_kernel: 2 * S}
            if delta != want:
                fail(f"B={B} T={temperature}: launches {delta}, want {want}")
            sessions.append(dict(batch=B, temperature=temperature,
                                 launches=delta, **m))
            print(f"  B={B:2d} T={temperature}: prefill {m['prefill_tok_s']:9.0f} "
                  f"tok/s  decode {m['decode_tok_s']:8.0f} tok/s  launches "
                  f"{delta}  ids[0,:8] {out[0, :8].tolist()}", flush=True)
    before = dict(dispatch.LAUNCHES)
    out = launch_serve.main(["--arch", "rnn-paper", "--full", "--batch", "4",
                             "--prompt-len", "16", "--gen", "16",
                             "--device", "cuda"])
    cli = {k: v - before.get(k, 0) for k, v in dispatch.LAUNCHES.items()}
    if cli.get("fused_tick") != 17 or cli.get("packed_gemv") != 32:
        fail(f"CLI launches {cli}")
    launches = dict(dispatch.LAUNCHES)
    plain = dict(dispatch.PLAIN_CALLS)
    # ---- the counted main-path run ends here ----
    if plain:
        fail(f"plain versions ran on the main path: {plain}")
    for k in ("packed_gemv", "packed_matmul", "fused_tick"):
        if not launches.get(k):
            fail(f"kernel {k} was never launched on the main path")

    # fused decode against the port's own unfused plain path (dense tables:
    # dequantized weights, torch ops only), step by step from one state, at
    # B = 4 (one row pass of 4) and 16 (two of 8).  Each of logits, h and c
    # is held within 1e-5 of its largest magnitude: fp32 summation over
    # H = 1000 leaves about 1e-7 of it, and a tick that skipped a gate's
    # GEMV would be off by far more than 1e-5.
    dense = BL.rnn_decode_tables(rt.variables, cfg, dense=True)
    fused_err, fused_size = {}, {}
    for B in (4, 16):
        prompt = torch.randint(0, cfg.vocab, (B, S),
                               generator=torch.Generator().manual_seed(9))
        _, st = rt.prefill(prompt.cuda(), rt.init_state(B))
        su = st
        toks = torch.randint(0, cfg.vocab, (8, B),
                             generator=torch.Generator().manual_seed(10)).cuda()
        err = {"logits": 0.0, "h": 0.0, "c": 0.0}
        size = dict(err)
        for i in range(8):
            lf, st = rt.decode_step(toks[i], st)
            lu, su = BL.rnn_decode_step(rt.variables, toks[i], cfg, su,
                                        tables=dense, fused=False)
            for k, got, want in (("logits", lf, lu), ("h", st.h, su.h),
                                 ("c", st.c, su.c)):
                err[k] = max(err[k], (got - want).abs().max().item())
                size[k] = max(size[k], want.abs().max().item())
        rel = {k: err[k] / size[k] for k in err}
        if not all(r <= 1e-5 for r in rel.values()):
            fail(f"fused decode vs unfused plain path at B={B}: max abs err "
                 f"{err} against max |value| {size}")
        print(f"  B={B:2d} fused decode == unfused plain path over 8 steps: "
              + ", ".join(f"{k} max abs err {err[k]:.2e} of max |{k}| "
                          f"{size[k]:.3g}" for k in err) + " (limit 1e-5 of it)",
              flush=True)
        fused_err[f"B={B}"], fused_size[f"B={B}"] = err, size
    report.update(sessions=sessions, main_path_launches=launches,
                  fused_vs_unfused_max_abs_err=fused_err,
                  fused_vs_unfused_max_abs_value=fused_size)
    return launches, rt


def profile_phase(report: dict, rt) -> None:
    """Where the main path's time goes, at B = 4 and 16: one 32-token
    prefill and 32 sampled decode steps under torch.profiler.  Per call:
    host wall (the profiler's overhead included), device busy time, the
    device's idle share, and the kernels that take the most device time."""
    import torch
    from repro_torch.serve.sampler import sample

    cfg = rt.cfg
    out = {}
    for B in (4, 16):
        prompt = torch.randint(0, cfg.vocab, (B, 32),
                               generator=torch.Generator().manual_seed(B)).cuda()
        logits, st = rt.prefill(prompt, rt.init_state(B))
        gen = torch.Generator(device="cuda").manual_seed(0)
        box = [logits, st]

        def step():
            nxt = sample(box[0], gen, temperature=0.8, vocab=cfg.vocab)
            box[0], box[1] = rt.decode_step(nxt, box[1])

        step()
        for phase, fn, n in (
                ("prefill", lambda: rt.prefill(prompt, rt.init_state(B)), 1),
                ("decode_step", step, 32)):
            by_name, wall = device_profile(fn, n)
            busy = sum(by_name.values()) / n
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            row = {"wall_us": wall / n * 1e6, "device_busy_us": busy,
                   "idle_share": 1.0 - busy / (wall / n * 1e6),
                   "top": [(k[:48], v / n) for k, v in top]}
            out[f"B={B} {phase}"] = row
            print(f"  B={B:2d} {phase:11s}: wall {row['wall_us']:9.1f} us  device "
                  f"busy {busy:8.1f} us  idle {row['idle_share']:.3f}  top "
                  + ", ".join(f"{k} {v:.1f}" for k, v in row["top"]), flush=True)
    report["profile"] = out


TRAIN_ARGS = ["--arch", "rnn-paper", "--batch", "32", "--seq", "100",
              "--eval-every", "10", "--ckpt-every", "10", "--log-every", "1",
              "--device", "cuda"]


def run_train(argv: list) -> tuple:
    """`repro_torch.launch.train.main(argv)`, its output echoed: (final
    TrainState, {step: (loss, host ms)} from its log lines)."""
    import contextlib
    import io
    from repro_torch.launch import train as launch_train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = launch_train.main(argv)
    out = buf.getvalue()
    print("".join(f"    | {l}\n" for l in out.splitlines()), end="", flush=True)
    steps = {int(m.group(1)): (float(m.group(2)), float(m.group(3)))
             for m in re.finditer(r"^step\s+(\d+) loss (\S+) .* (\d+) ms$",
                                  out, re.M)}
    return state, steps


def bit_equal(a, b) -> bool:
    """Every leaf of two trees equal bit for bit (NaNs included)."""
    import torch
    from repro_torch.core.qtensor import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8),
                        y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def training_phase(report: dict, argv: list = TRAIN_ARGS) -> dict:
    """The training slice, at full width with the default `argv`; returns
    the launch counts of its counted run."""
    import shutil
    import tempfile

    import torch
    import torch.nn.functional as F
    from repro_torch.core import bnlstm as BL
    from repro_torch.core.quantize import glorot_alpha, pack_ternary
    from repro_torch.data.loader import to_device
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import ops as OPS
    from repro_torch.launch import train as launch_train
    from repro_torch.serve.recurrent import RNNRuntime, drive_session
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import train_step as TS

    args = launch_train.build_argparser().parse_args(argv)
    dev = torch.device(args.device)
    corpus = launch_train.rnn_corpus(args)
    cfg = launch_train.rnn_cfg(args, corpus)
    if not args.reduced and (cfg.d_hidden, cfg.cell, cfg.quant.mode) != (
            1000, "lstm", "ternary"):
        fail(f"rnn-paper is not the full-width ternary BN-LSTM: {cfg}")
    out = {}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        dispatch.reset_counts()   # ---- the counted training run starts here
        t0 = time.perf_counter()
        state, steps = run_train(argv + [
            "--steps", "20", "--ckpt-dir", str(root / "a")])
        out["train_20_steps_s"] = time.perf_counter() - t0
        losses = {k: v[0] for k, v in steps.items()}
        step_ms = sorted(v[1] for k, v in steps.items() if k)  # step 0 warms up
        if sorted(losses) != list(range(20)):
            fail(f"training logged steps {sorted(losses)}")
        if not all(map(lambda v: v == v and abs(v) < 1e9, losses.values())):
            fail(f"non-finite training loss: {losses}")
        if not losses[19] < losses[0]:
            fail(f"training loss did not fall: step 0 {losses[0]}, "
                 f"step 19 {losses[19]}")
        out["loss_step0"], out["loss_step19"] = losses[0], losses[19]
        out["step_ms_median"] = step_ms[len(step_ms) // 2]
        out["step_ms_range"] = (step_ms[0], step_ms[-1])
        print(f"  20 steps: loss {losses[0]:.4f} -> {losses[19]:.4f} in "
              f"{out['train_20_steps_s']:.1f} s; host wall a step (steps "
              f"1-19, as the launcher logs it) median {out['step_ms_median']:.0f}"
              f" ms, range {step_ms[0]:.0f}-{step_ms[-1]:.0f} ms, "
              f"{args.batch * args.seq / out['step_ms_median'] * 1e3:.0f} tok/s",
              flush=True)

        # two runs of the first 3 steps from one seed: bit-equal
        three = [run_train(argv + ["--steps", "3", "--ckpt-dir",
                                         str(root / f"three{i}")])[0]
                 for i in range(2)]
        if not bit_equal(three[0].params, three[1].params):
            fail("two 3-step runs from one seed differ")
        # resume from the step-10 checkpoint: the same final state
        (root / "c").mkdir()
        shutil.copytree(root / "a" / "step_00000010",
                        root / "c" / "step_00000010")
        shutil.copy(root / "a" / "val_curve.jsonl", root / "c")
        resumed, _ = run_train(argv + [
            "--steps", "20", "--ckpt-dir", str(root / "c"), "--resume", "auto"])
        if not bit_equal(resumed, state):
            fail("the run resumed from step 10 differs from the "
                 "uninterrupted one")
        print("  3-step reruns bit-equal; resume from step 10 == "
              "uninterrupted run, bit for bit", flush=True)

        # quantize_pack on step 10's own wh, noise and alpha
        st10 = CK.restore(state, root / "a", 10)
        step_fn = TS.make_rnn_train_step(cfg, launch_train.opt_config(args))
        batch = to_device(corpus.batch("train", 10, args.batch, args.seq), dev)
        _, m10 = step_fn(st10, batch, 1.0)
        noise = TS.step_noise(st10)
        with torch.no_grad():
            again, _ = BL.lm_loss({"params": st10.params,
                                   "state": st10.bn_state},
                                  batch["tokens"], batch["targets"], cfg,
                                  training=True, noise=noise)
            q = BL._quantized_weights(st10.params, cfg, training=True,
                                      noise=noise)[0][1]
        if not torch.equal(again, m10["loss"]):
            fail(f"step 10's noise does not reproduce its loss: "
                 f"{again.item()} vs {m10['loss'].item()}")
        wh, uh = st10.params["layers"][0]["wh"], noise[0][1]
        alpha = glorot_alpha(*wh.shape)
        pad = 16 * -(-wh.shape[0] // 16) - wh.shape[0]
        codes = OPS.quantize_pack(F.pad(wh, (0, 0, 0, pad)),
                                  F.pad(uh, (0, 0, 0, pad), value=1.0), alpha,
                                  mode="ternary")
        dense = pack_ternary(F.pad(q / alpha, (0, 0, 0, pad)))
        if not torch.equal(codes, dense):
            fail(f"quantize_pack of step 10's wh: "
                 f"{int((codes != dense).sum())} words differ from the packed "
                 f"dense sample")
        nz = float((q != 0).float().mean())
        print(f"  quantize_pack(step 10 wh {tuple(wh.shape)} padded to "
              f"{tuple(codes.shape[:1])}x16): codes == pack(dense sample / "
              f"alpha), {nz:.3f} of the sample nonzero", flush=True)

        # the packed export: eval against the fp masters, then serve it
        served = BL.serving_variables(state.params, state.bn_state, cfg)
        vb = to_device(corpus.batch("valid", 0, args.batch, args.seq), dev)
        with torch.no_grad():
            fp_loss, _ = BL.lm_loss({"params": state.params,
                                     "state": state.bn_state},
                                    vb["tokens"], vb["targets"], cfg,
                                    training=False)
            pk_loss, _ = BL.lm_loss(served, vb["tokens"], vb["targets"], cfg,
                                    training=False)
        diff = abs(pk_loss.item() - fp_loss.item())
        if not diff <= 1e-5:
            fail(f"packed eval loss {pk_loss.item()} vs fp {fp_loss.item()}")
        out.update(fp_eval_loss=fp_loss.item(), packed_eval_loss=pk_loss.item(),
                   packed_vs_fp_loss=diff)
        print(f"  packed export eval loss {pk_loss.item():.6f} vs fp masters "
              f"{fp_loss.item():.6f} (diff {diff:.2e}, limit 1e-5)", flush=True)
        rt = RNNRuntime(cfg, served, device=dev)
        prompt = to_device(corpus.batch("valid", 1, 4, 16), dev)["tokens"]
        toks, m = drive_session(rt, prompt, cfg.vocab, gen=16, temperature=0.0)
        if not torch.isfinite(m["last_logits"]).all() or toks.shape != (4, 16):
            fail(f"serving the trained export: tokens {toks.shape}")
        print(f"  served the export at B = 4: decode "
              f"{m['decode_tok_s']:.0f} tok/s, ids[0,:8] "
              f"{toks[0, :8].tolist()}", flush=True)
        launches = dict(dispatch.LAUNCHES)
        plain = dict(dispatch.PLAIN_CALLS)
        # ---- the counted training run ends here
        if plain:
            fail(f"plain versions ran on the training path: {plain}")
        for k in ("packed_gemv", "packed_matmul", "fused_tick", "quantize_pack"):
            if not launches.get(k):
                fail(f"kernel {k} was never launched on the training path")
        print(f"  training-path launches {launches}", flush=True)
        out["launches"] = launches

        # one train step under the profiler
        box = [state]

        def one_step():
            box[0], _ = step_fn(box[0], batch, 1.0)

        one_step()
        by_name, wall = device_profile(one_step, 2)
        busy = sum(by_name.values()) / 2
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        prof = {"wall_us": wall / 2 * 1e6, "device_busy_us": busy,
                "idle_share": 1.0 - busy / (wall / 2 * 1e6),
                "tok_s": args.batch * args.seq / (wall / 2),
                "top": [(k[:60], v / 2) for k, v in top]}
        out["profile_step"] = prof
        print(f"  train step (B = {args.batch}, T = {args.seq}, profiled): wall "
              f"{prof['wall_us']:.0f} us  device busy {busy:.0f} us  idle "
              f"{prof['idle_share']:.3f}  {prof['tok_s']:.0f} tok/s  top "
              + ", ".join(f"{k} {v:.0f}" for k, v in prof["top"]), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["training"] = out
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    from repro_torch.kernels import build, dispatch

    # 1. card
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"python {sys.version.split()[0]}  devices {torch.cuda.device_count()}",
          flush=True)
    dispatch.strict_fp32()
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # 2. build, then the multiply-free proof
    t0 = time.perf_counter()
    built = build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.1f} s for {len(built)} kernels "
          f"(parallel nvcc)", flush=True)
    report["ptxas"] = {}
    for name, (path, secs, log) in built.items():
        usage = ptxas_usage(log)
        report["ptxas"][name] = usage
        print(f"  {name}: {path.name} {secs:.1f} s; " + " | ".join(
            f"{fn} {regs} regs, {spill} B spilled" for fn, regs, spill in usage),
              flush=True)
    for name in ("packed_gemv", "packed_matmul", "fused_tick"):
        spilled = [(fn, b) for fn, _, b in report["ptxas"][name] if b]
        if spilled:
            fail(f"{name} spills registers: {spilled}")
    report["sass"] = sass_check(built["packed_gemv"][0],
                                built["packed_matmul"][0])
    print(f"sass: packed_gemv holds no FMUL/FFMA/HMUL2/HFMA2/DMUL/DFMA/HMMA; "
          f"packed_matmul multiplies on bf16 HMMA {report['sass']}", flush=True)

    # 3. kernels against their plain versions
    launch_floor(report)
    rows = kernels_phase(report)

    # 4. the serving path, then where its time goes
    launches, rt = main_path_phase(report)
    profile_phase(report, rt)

    # 6. the training path
    print("training:", flush=True)
    launches["quantize_pack"] = training_phase(report)["quantize_pack"]

    # 7. result
    sources = {"packed_gemv": ("src/repro_torch/csrc/packed_gemv.cu",
                               "src/repro/kernels/packed_matmul.py:106"),
               "packed_matmul": ("src/repro_torch/csrc/packed_matmul.cu",
                                 "src/repro/kernels/packed_matmul.py:155"),
               "fused_tick": ("src/repro_torch/csrc/fused_tick.cu",
                              "src/repro/kernels/decode_step.py:114"),
               "quantize_pack": ("src/repro_torch/csrc/quantize_pack.cu",
                                 "src/repro/kernels/packed_matmul.py:213")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = next(r for r in rows if r["name"] == name)  # the main path's shape
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max(x["max_abs_err"] for x in rows
                                           if x["name"] == name),
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report["kernels"] = kernels
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
