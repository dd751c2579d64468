#!/usr/bin/env python3
"""Drive the PyTorch port's BN-LSTM serving and training paths, its
train -> restart -> export -> serve pipeline, the transformer pool's
dense, MoE, RWKV6, hybrid, audio and vlm serving paths (qwen3-0.6B,
qwen3-moe-30b-a3b, rwkv6-7b, zamba2-1.2b, whisper-base and
llama-3.2-vision-90b at full width, mixtral-8x7b at its widths) and the
pool's training path (qwen3-0.6b at full width, every other family at
its reduced size), with compressed data-parallel training of both
families, and the model axis (a tensor-parallel training step and the mesh
engine, at one rank), on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. card     — nvidia-smi name and power limit, torch and CUDA versions;
  2. build    — compile the five CUDA kernels from `src/repro_torch/csrc`
                (one nvcc each, all at once) and print the ptxas report:
                `packed_gemv`, `packed_matmul`, `fused_tick` and
                `ordered_bmm` must spill no register;
                then the SASS of `packed_gemv` (the step route, over any
                row count) must hold no float multiply, and that of
                `packed_matmul` (the sequence route, on the tensor cores)
                must hold GMMA (wgmma) instructions and no local-memory
                access;
  3. kernels  — the launch floor (the device time of a one-element
                in-place add on the same stream); then, at the main path's
                shapes, hold each kernel against its plain PyTorch version
                on the card and time both (device time from torch.profiler,
                wall time per call from CUDA events), beside the analytic
                bound and one PyTorch library call where one computes the
                same function: the GEMV at bp = 4 (B = 4 prefill, ternary),
                1 (the engine's prompt step, ternary) and 8 (binary) and
                over 8-row tiles at 16 (B = 16 prefill) and 32 (binary), the
                GEMM at M = 16 and 32 (packed eval), 1 and 4 (a prompt's
                last short chunk), each launched twice and held bit-equal,
                a row's bits the same within each route at other row
                counts (the GEMM's at 1, 9 and 17-row slices and single
                rows; the GEMV's over 8-row tiles against its single rows
                and one tile); the tick at B = 4 and 16, each held against the
                plain version on its own inputs; ordered_bmm at the
                norms', attention's (qwen3's decode and prefill, G = 8,
                whisper's encoder over 1500 frames) and the SSD readout's
                shapes (`BMM_ROWS`), beside `torch.bmm`, a row's and a
                column's bits the same on every route (row, small, the
                tiles), with K zero-padded and through the keys' and
                values' permuted views (`bmm_crossings`);
  4. main path — rnn-paper at full width (char-PTB BN-LSTM, H = 1000,
                ternary, random weights from a seed, BN statistics, BN
                scales and biases moved off init): rnn_lm_init ->
                export_packed_rnn -> RNNRuntime -> drive_session at batch 4
                and 16 (the h-side on the GEMV, a step product, at both),
                prompt 32, gen 32,
                greedy and sampled, plus the `repro_torch.launch.serve` CLI.
                Launch counters are zeroed just before and read just after;
                every kernel must have launched, one fused tick per decode
                step, and the fused decode's logits, h and c must match the
                unfused plain path on the card at B = 4 and 16 within 1e-5
                of their size;
  5. profile  — where a prefill's and a decode step's time goes at B = 4
                and 16 (torch.profiler: device busy time, idle share);
  6. engine   — the continuous-batching engine at rnn-paper's full width
                (packed ternary, off init), slots 16, prefill chunk 32:
                64 requests of `launch.serve.synth_traffic(seed=0)`
                (prompts U[1, 96], generation U[1, 64], temperature 0.8,
                top-k 40) drained with the launch counters zeroed just
                before and read just after: every stream must equal
                `drive_session(B=1)` on its request byte for byte, the
                fused tick must launch once a tick and the GEMV once a
                prompt token, no chunk may stall the
                decodes twice; then the same workload in real time at half
                the sustained request rate (tok/s, latency and TTFT
                percentiles, occupancy), a tick and a chunk under
                torch.profiler; speculative decoding (an fp target, its
                own ternary draft, spec_k 4, 16 greedy requests) whose
                streams must equal the plain engine's greedy, and again
                at temperature 0.8, where after every round each live
                slot's draft row must equal the draft run alone over its
                committed tokens, bit for bit; 16 requests
                behind one 64-token prefix with a 64 MB prefix cache (at
                least 15 hits, streams equal to a cache-off engine); and
                the front door's loopback smoke (a streamed request, a
                hangup that cancels, a prefix hit, over 127.0.0.1); and
                two layers at H = 256, where chunked and whole prefill
                meet the GEMM (layer 1's x-side) at other row counts: the chunked
                state bit-equal to the whole prompt's, every engine stream
                equal to drive_session(B=1);
  7. training — rnn-paper at full width through `repro_torch.launch.train`
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
  8. pipeline — `repro_torch.launch.train --pipeline --quick` at
                rnn-paper's full width (batch 32, seq 100, 20 steps a leg):
                a real SIGTERM at step 10, exit 43 and the resume, the two
                legs' final checkpoints bit-equal, the packed export served
                through the engine with every stream equal to
                drive_session(B=1), and the trained accept rate of the fp
                masters with their ternary draft (reported; JAX's 0.976 came
                from 300 reduced steps).  Launches counted across the
                children and this process: the fused tick and the GEMV
                (the engine's ticks and prompt steps) must launch;
  9. transformer — qwen3-0.6B at full width (28 layers, d 1024, 16 query
                and 8 KV heads of 128, d_ff 3072, vocab 151,936, tied,
                ternary, bf16), random weights from a seed: packed_gemv at
                1, 4 and 8 rows and packed_matmul at M = 512 on layer 0's
                seven projections, each launched twice and bit-equal and
                held with its plain version to the fp64 product within
                1e-5 of |x| @ |w|, timed beside the bound and torch.matmul;
                the packed tree's bytes; packed against fp-dequantized
                decode logits (relative L2 within 1e-4 in fp32 compute,
                within 1e-1 in bf16); then, counted:
                lockstep drive_session at B = 4, prompt 128, gen 32 (196
                packed GEMVs a decode step, 196 GEMMs a prefill), a decode
                step and a prefill under torch.profiler; the engine over 32
                requests of synth_traffic(seed=0) (prompts U[1, 128], gen
                U[1, 32], T 0.8, top-k 40) at 8 slots, chunk 32, every
                stream, sampled and run greedy, equal to
                drive_session(B=1); speculative k = 4 (bf16 masters, ternary draft, 8
                greedy requests: accept rate, streams equal to the plain
                engine's); 8 requests behind a 64-token prefix (at least 7
                prefix-cache hits); the engine, speculative and prefix runs
                on a cut of 4 of the 28 layers;
  10. pool    — the transformer pool's MoE and RWKV6 families, ternary with
                channel scales, bf16, random weights from a seed, each tree
                drawn a layer at a time on the card and exported as it is
                drawn (`model_init(packed=True)`: the fp32 expert masters of
                qwen3-moe alone are 116 GB): qwen3-moe-30b-a3b at full width
                (48 layers, d 2048, 32/4 heads of 128, 128 experts of d_ff
                768, top-8, vocab 151,936): packed_gemv at 1, 4 and 8 rows
                and packed_matmul at M = 40 (the prefill's capacity) on an
                expert's slice of layer 0's Wgate and Wdown, packed_matmul at
                M = 512 on Wq and Wk, held as in phase 9; the tree's bytes;
                packed against dequantized logits on a 2-layer cut (relative
                L2 within 1e-4 in fp32, reported in bf16); then, counted:
                lockstep B = 4, prompt 128, gen 32 with a decode step and a
                prefill profiled (host, device busy, idle share, GEMV and
                GEMM launches, experts run a layer), and the engine, on a
                cut of 2 of its 48 layers, at 8
                slots over 8 requests of synth_traffic(seed=0) (prompts
                U[1, 128], gen U[1, 16]: host-bound steps cut the count;
                the lockstep run on the same cut),
                one prefill chunk a prompt, every stream, sampled and
                greedy, equal to drive_session(B=1),
                speculation and a prefix cache refused with JAX's messages;
                mixtral-8x7b at its widths (d 4096, 8 experts of 14336,
                top-2, window 4096 on every layer) and 2 layers: the GEMV at
                4 rows and the GEMM at 40 on its two expert shapes, packed
                against dequantized logits, a short lockstep run; rwkv6-7b
                at full width (32 layers, d 4096, 64 heads of 64, d_ff
                14336, vocab 65,536): bytes, the GEMV at 1, 4 and 8 rows and
                the GEMM at 512 on Wr, the GEMM at 512 on Wck and Wcv,
                packed against dequantized logits on a 2-layer cut,
                wkv6_chunked over a 4,096-token prompt (peak memory within
                32 inputs, the first 256 outputs against the unrolled
                step), then lockstep and the engine (on a cut of 2 of its
                32 layers) as for qwen3-moe, over 16 requests of gen U[1,
                32].  Launches counted for the MoE runs and the rwkv runs
                apart;
  11. hybrid and audio — zamba2-1.2b at full width (38 mamba layers, d
                2048, d_inner 4096, 64 SSD heads of 64, state 64, conv 4,
                chunk 64, the shared attention block of 32 heads of 64 and
                d_ff 8192 applied after every 6, vocab 32,000) and
                whisper-base (6 encoder and 6 decoder layers, d 512, 8 heads
                of 64, GeLU d_ff 2048, vocab 51,865, 1500 encoder frames),
                ternary with channel scales, bf16, random weights from a
                seed moved off init (zamba2's dt bias, conv bias, D and
                norms; whisper's xgate, MLP biases and norms): the GEMV at 1,
                4 and 8 rows and the GEMM at M = 512 on zamba2's Win (N =
                8384, a ragged last GEMM tile of 64) and Wout, the GEMV on
                whisper's Wq, Wfc1, Wfc2 (K = 512, 32 code rows) and the
                GEMM at M = 6000 on its encoder's Wq and Wfc1, held as in
                phase 9; the trees' bytes; packed against dequantized logits
                (zamba2 on one repeat: 6 mamba layers and one shared
                application); ssd_chunked over one 4,096-token prompt (peak
                memory within 16 times its inputs, the first 256 outputs
                against the unrolled step); then, counted: zamba2's lockstep
                B = 4, prompt 128, gen 32 with a decode step and a prefill
                profiled, its engine (on a cut of 6 of its 38 mamba
                layers) over 16 requests (gen U[1, 32]) held as rwkv6's,
                and its CLI;
                whisper's lockstep B = 4, prompt 32, gen 32 over 1500
                frames with the encoder's share of a prefill, and its CLI;
                the engine refuses whisper (a runtime with extras), as
                JAX's does.  Launches counted for the hybrid runs and the
                audio runs apart;
  12. pool training — qwen3-0.6b at full width (28 layers, d 1024,
                d_ff 3072, vocab 151,936, ternary, bf16, remat on) through
                `repro_torch.launch.train` (B = 8, T = 512, 20 steps,
                AdamW): the mean loss of the last 5 steps below the first
                5's; the same run on an order-2 Markov byte file (--data),
                the mean of its last 5 steps more than 1 below ln V and
                within 0.25 of the file's unigram entropy; a run that
                takes SIGTERM at step 10, exits 43 and
                resumes (--resume auto), beside an uninterrupted one,
                their final checkpoints bit-equal leaf for leaf; in
                process, a rerun of two steps bit-equal, one step with
                remat off bit-equal to one with it on, a step's time,
                tokens/s, peak memory, device launches and idle share; the
                trained masters exported packed, their served logits
                within 1e-4 (relative L2, fp32) of the dequantized tree's;
                then gemma3, mixtral, qwen3-moe, rwkv6, zamba2, whisper
                and the VLM at their reduced size, 3 steps each on the
                card, the step-0 gradients (leaf by leaf, relative L2), loss
                and gradient norm within 1e-4 of the CPU's on the same
                state and injected noise.  The path
                launches no kernel (JAX's training forward multiplies by
                the sampled fp weights);
  13. vlm     — llama-3.2-vision-90b at full width (100 layers: 4 self
                and 1 cross layer a repeat, d 8192, 64/8 heads of 128,
                d_ff 28,672, vocab 128,256, 1600 image tokens), ternary
                with channel scales, bf16, xgate and norms moved off init:
                packed against dequantized logits on one repeat (4 + 1
                layers); the tree drawn a layer at a time, its bytes and
                peak memory; the GEMV at 1, 4 and 8 rows and the GEMM at
                M = 512 on layer 0's Wq, Wk (codes (512, 1024): a long K
                over 8 column blocks), Wgate and Wdown and the GEMM at
                M = 6400 on the cross layer's Wk, held as in phase 9;
                then, counted, lockstep B = 4, prompt 128, gen 32 with a
                decode step and a prefill profiled, the engine's refusal
                of a runtime with extras, and its CLI (B = 4, prompt 32,
                gen 8);
  14. compressed DP — `repro_torch.launch.train --pipeline --quick
                --compress-grads` at rnn-paper's full width (20 steps a
                leg, B = 32, T = 100, a data mesh of one rank over NCCL):
                SIGTERM, exit 43 and the resume, the legs' final
                checkpoints bit-equal with their residual, the residual
                non-zero and finite, the export served through the engine
                byte for byte like drive_session(B=1), the accept rate,
                launches counted (the engine's tick and GEMV must launch);
                one reduced compressed RNN step and one pool step with the
                model noise and the compression draws injected, the card's
                params, residual and BN state within 1e-5 (relative L2 a
                leaf) of the CPU's; the gradient compression's bytes (fp32
                against 2-bit codes), a compressed rnn-paper step against
                an uncompressed one (timed in turns) and the compression's
                device time a step and its share (torch.profiler); then
                qwen3-0.6b at full width, 3 compressed steps at B = 8, T =
                512 through `make_train_step(mesh=make_host_mesh(),
                compress_grads=True)`: finite losses, a non-zero residual,
                a step's ms, idle share and peak memory against phase
                12's.  The compressed step launches no kernel: its new work
                is elementwise passes over every gradient leaf and one
                all-reduce;
  15. mesh    — the model axis at one rank, a ("data", "model") mesh of
                (1, 1) over NCCL: a qwen3-0.6b bf16 training step (B = 4,
                T = 256) through the tensor-parallel DTensor step, its
                params and moments bit-equal to the plain step's; the mesh
                engine (make_serve_mesh("data=1")) over an fp qwen3-0.6b on
                8 of its 28 layers, every stream equal to the mesh=None
                engine's and tick_collectives() == 0; the packed tree
                refused on a mesh with JAX's reason;
  16. roofline — the dry-run CLI (`python -m repro_torch.launch.dryrun`,
                each cell a process of its own over a fake process group,
                started before the build: the meta device, no kernel)
                on qwen3-0.6b x train_4k, prefill_32k and decode_32k on the
                single mesh and qwen3-moe-30b-a3b x decode_32k on the multi
                mesh: each cell's dominant term and its terms, any error
                fails; then the dry-run's counter at one rank on the meta
                device over phase 9's decode step and prefill and phase 12's
                train step: counted FLOPs and bytes, the bound and its term,
                the bound over the phase's device busy and host wall.  It
                times nothing anew and launches no kernel;
  17. examples — `examples/torch_quickstart.py`, `torch_serve_lstm.py`
                and `torch_train_char_lm.py` (10 steps, a checkpoint),
                each a process on the card, their default device, all at
                once: any non-zero exit fails, and so do the quickstart's
                straight-through gradient or its packed product off the
                dequantized one by 1e-5 or more, the packed decode's
                self-check, or a missing checkpoint;
  18. result  — every phase's seconds, the kernels JSON line (each
                kernel's launches on every path), the card line, and
                {"ok": true, "device": {...}} last.

It needs one card and no network; the build goes to `build/kernels/`.
Details land in `chiprun_out/chip_smoke.json`.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's peaks: one set, in the port's roofline module
from repro_torch.launch import roofline as RF  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    FP32_ADD_S, FP32_FLOP_S, SM_CLOCK_HZ, HBM_BW as HBM_BYTES_S,
    PEAK_FLOPS as BF16_FLOP_S)
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


# calls of `device_profile` in which every attempt missed
PROFILER_MISSES = {"calls": 0}


def device_profile(fn, reps: int = 1, skip: str | None = None,
                   attempts: int = 5, counts: dict | None = None):
    """Run `fn` `reps` times under torch.profiler.  Returns (device us by
    kernel name, host wall seconds of the whole run); kernels whose name
    holds `skip` are left out.  `counts`, when given, receives the number
    of device events by name.  Now and then the profiler hands back no
    device event at all for a run, sometimes for several runs in a row; the
    run is then repeated after a pause, up to `attempts` times in all (once
    only after a call in which every attempt missed), and each miss is
    noted on stderr.  If every attempt misses, the dict is empty: the
    caller reports the time as not measured or takes it from CUDA events
    (`time_call`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if PROFILER_MISSES["calls"]:
        attempts = 1
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name: dict = {}
        if counts is not None:
            counts.clear()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not (skip and skip in e.name):
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us())
                if counts is not None:
                    counts[e.name] = counts.get(e.name, 0) + 1
        if by_name:
            break
        print(f"chip_smoke: torch.profiler recorded no device event (attempt "
              f"{attempt + 1} of {attempts})", file=sys.stderr, flush=True)
        time.sleep(0.2)
    else:
        PROFILER_MISSES["calls"] += 1
    return by_name, wall


def busy_idle(by_name: dict, wall_s: float, n: int) -> tuple:
    """Device busy us a call and the idle share, from `device_profile`'s
    result over `n` calls that took `wall_s`; (None, None), not measured,
    when the profiler recorded no device event."""
    if not by_name:
        return None, None
    busy = sum(by_name.values()) / n
    return busy, 1.0 - busy / (wall_s / n * 1e6)


def num(x, spec: str, scale: float = 1.0) -> str:
    """`x / scale` (`x` itself when `scale` is 1, so an int keeps its
    type) formatted by `spec`, or "not measured" for None."""
    if x is None:
        return "not measured"
    return format(x if scale == 1 else x / scale, spec)


def event_ms(fn, reps: int, flush: "L2Flush | None" = None) -> float:
    """Median device time of one call of `fn` between two CUDA events.
    Before each call a spin kernel (`torch.cuda._sleep`) holds the stream
    for twice the call's host time, so every launch of the call is queued
    before its first kernel starts: the span holds the call's kernels back
    to back, with the host's launch gaps left out."""
    import torch
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    cycles = int(2 * (time.perf_counter() - t0) * SM_CLOCK_HZ)
    spans = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        spans.append(a.elapsed_time(b))
    spans.sort()
    return spans[reps // 2]


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


def wall_ms(fn, reps: int, flush: L2Flush | None = None) -> float:
    """The median time between two CUDA events around one call of `fn`,
    launch overhead included; with `flush`, every call finds the L2
    cold."""
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
    return walls[reps // 2]


def time_call(fn, reps: int, flush: L2Flush | None = None) -> dict:
    """Per call of `fn`: `ms`, the device time of the kernels it launches
    (torch.profiler over `reps` calls, or `event_ms` when the profiler
    records no device event; `ms_by` says which), and `wall_ms`
    (`wall_ms`).  With `flush`, every call finds the L2 cold."""
    wall = wall_ms(fn, reps, flush)
    if flush is not None:
        run = lambda: (flush(), fn())
        by_name, _ = device_profile(run, reps, skip=flush.name)
    else:
        by_name, _ = device_profile(fn, reps)
    if by_name:
        return {"ms": sum(by_name.values()) / 1e3 / reps, "wall_ms": wall,
                "ms_by": "profiler"}
    print("chip_smoke: device time from CUDA events instead",
          file=sys.stderr, flush=True)
    return {"ms": event_ms(fn, reps, flush), "wall_ms": wall,
            "ms_by": "cuda_events"}


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
                library_wall_ms=None if lib is None else lib["wall_ms"],
                ms_by=[t["ms_by"] for t in (k, p, lib) if t is not None])


def bound(nbytes: int, seconds_of_ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S
    if t_bytes >= seconds_of_ops:
        return t_bytes * 1e3, "bytes"
    return seconds_of_ops * 1e3, "operations"


def gemm_blocks(plan: dict, rows: int) -> int:
    """The GEMM's blocks at `rows` rows of x: `matmul_plan`'s (one 64-row
    tile's) times the row tiles."""
    return plan["blocks"] * -(-rows // plan["rows"])


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
    """The bound of the GEMM x (rows, k) @ unpack(codes): its bytes, or the
    three bf16 products of the exact split (x = hi + mid + lo), 3 * 2 *
    rows * k * N flops at the bf16 tensor-core rate, the work the kernel
    does on the real rows (a wgmma computes 64, so below 64 rows the
    kernel does more than this counts)."""
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
    """The step route's kernel (`packed_gemv`, every instance) must hold no
    float multiply (integer IMAD for addresses is fine); the sequence
    route's (`packed_matmul`, every instance) must issue its products on
    the tensor cores, GMMA (wgmma) instructions, and touch no local memory
    (LDL/STL: a spill or a stack array).  Returns instruction counts."""
    counts = {}
    funcs = {f: body for f, body in sass_functions(gemv_so).items()
             if "packed_gemv" in f}
    if not funcs:
        fail("no packed_gemv kernel found in the SASS of packed_gemv")
    for f, body in funcs.items():
        bad = [l.strip() for l in body
               if MULTIPLY_OPS.search(l) and not CONSTANT_MOVE.search(l)]
        if bad:
            fail(f"float multiply in packed_gemv's {f}: {bad[:4]}")
        text = "\n".join(body)
        counts[f"packed_gemv:{f}"] = {op: len(re.findall(rf"\b{op}\b", text))
                                      for op in ("FADD", "LOP3", "IMAD")}
    funcs = {f: body for f, body in sass_functions(matmul_so).items()
             if "packed_matmul" in f}
    if not funcs:
        fail("no packed_matmul kernel found in the SASS of packed_matmul")
    for f, body in funcs.items():
        text = "\n".join(body)
        n = {op: len(re.findall(rf"\b{op}\b", text))
             for op in ("HGMMA", "LDL", "STL", "UTMALDG", "F2FP")}
        if not n["HGMMA"]:
            fail(f"packed_matmul's {f} issues no GMMA instruction")
        if n["LDL"] or n["STL"]:
            fail(f"packed_matmul's {f} touches local memory: {n}")
        counts[f"packed_matmul:{f}"] = n
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

    # -- packed_gemv: prefill h-side at batch 4, the engine's one-row prompt
    # step, 8 rows binary, and the step route over 8-row tiles: the main
    # path's h-side at batch 16 and 32 rows binary -------------------------
    for mode, bp in (("ternary", 4), ("ternary", 1), ("binary", 8),
                     ("ternary", 16), ("binary", 32)):
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
        if bp > 8:
            rows_invariant(f"packed_gemv {mode}", x, qt.codes, mode,
                           PK.packed_matmul(x, qt.codes, mode=mode))
        print(f"  packed_gemv {mode}: bp={bp} matches plain; two launches "
              f"bit-equal" + (", a row's bits the same at any row count"
                              if bp > 8 else ""), flush=True)

    # -- packed_matmul: a prompt's short last chunks (1, 4 rows), 16 rows,
    # the packed eval at batch 32 ------------------------------------------
    for mode in ("ternary", "binary"):
        for M in (1, 4, 16, 32):
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
            rows_invariant(f"packed_matmul {mode}", x, qt.codes, mode, got)
            w = torch.nn.functional.pad(qt.dequantize() / qt.alpha,
                                        (0, 0, 0, K - qt.k))
            b_ms, b_by = gemm_bound(qt, M)
            plan = PK.matmul_plan(K, qt.codes.shape[1], mode=mode)
            rows.append(timed_row(
                "packed_matmul", f"{mode} x({M},{K}) codes"
                f"{tuple(qt.codes.shape)} {gemm_blocks(plan, M)} blocks, "
                f"cluster {plan['cluster']}", err,
                lambda: PK.packed_matmul(x, qt.codes, mode=mode),
                lambda: PK.packed_matmul_plain(x, qt.codes, mode=mode),
                lambda: torch.matmul(x, w), b_ms, b_by))
        print(f"  packed_matmul {mode}: M=1,4,16,32 match plain; two "
              f"launches bit-equal; a row's bits the same at any row count "
              f"on each route", flush=True)

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
    rows += ordered_bmm_rows(g)
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


# ordered_bmm's rows (label, N, M, K, P): attention's products at
# qwen3-0.6B's decode (B = 4: 32 (row, kv head) pairs, G = 2, hd 128, 160
# cache columns) and 128-token prefill, qwen3-moe's and the VLM's decode
# scores (G = 8), whisper's encoder over 1500 frames (B = 4, 8 heads, hd
# 64), zamba2's SSD readout (B = 4, d_state 64, H * P = 4096); and the
# norms' row sums (P = 1, a column of ones): a decode step's at B = 4 over
# qwen3's 1024, rwkv6's and zamba2's 4096 and the VLM's 8192, a 128-token
# prefill's at B = 4, qwen3's q/k norms over hd 128
BMM_ROWS = (("scores, decode", 32, 2, 128, 160),
            ("scores, prefill", 32, 256, 128, 256),
            ("values, prefill", 32, 256, 256, 128),
            ("norm, decode", 1, 4, 1024, 1),
            ("norm, decode", 1, 4, 4096, 1),
            ("norm, prefill", 1, 512, 1024, 1),
            ("norm, vlm decode", 1, 4, 8192, 1),
            ("q/k norm, decode", 1, 64, 128, 1),
            ("ssd readout", 4, 1, 64, 4096),
            ("scores, decode G=8", 32, 8, 128, 160),
            ("whisper encoder scores", 32, 1500, 64, 1500),
            ("whisper encoder values", 32, 1500, 1500, 64))


def bmm_operands(g, N: int, M: int, K: int, P: int):
    """A row's operands on the card: a norm's squares against a column of
    ones (P = 1), else normal draws."""
    import torch
    if P == 1:
        x = torch.randn(N, M, K, generator=g).cuda()
        return x * x, torch.ones(N, K, 1, device="cuda")
    return (torch.randn(N, M, K, generator=g).cuda(),
            torch.randn(N, K, P, generator=g).cuda())


def bmm_crossings(a, b, got) -> list:
    """Holds `got` = ordered_bmm(a, b) (a (N, M, K), b (N, K, P) on the
    card) to the same product on every route and layout, bit for bit, and
    returns the routes crossed; raises AssertionError naming the first
    difference.  Rows of a alone (M = 1), eight of them (the small route)
    and those eight among 248 other rows (a 256-row tile), against b and,
    where P = 1, a second column beside it; column 0 of b
    alone (P = 1, the row route), with column 1 (P = 2) and among 159
    other columns (P = 160); K padded with 37 zero terms; b read as the
    keys' view (K contiguous), a with a padded row pitch, the batch as two
    dims; a second launch.  Plus the fp64 product within 1e-5 of
    |a| @ |b|."""
    import torch
    from repro_torch.kernels import ordered_bmm as OB
    N, M, K = a.shape
    P = b.shape[-1]
    bits = lambda t: t.contiguous().view(torch.int32)
    g = torch.Generator(device="cuda").manual_seed(M * 7 + P)
    fill = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    routes = {OB.route(N, M, K, P)}

    def same(label, sub, want):
        assert torch.equal(bits(sub), bits(want)), \
            f"{label}: bits differ from the whole product's"

    exact = a.double() @ b.double()
    err = (got.double() - exact).abs()
    tol = 1e-5 * (a.double().abs() @ b.double().abs())
    assert (err <= tol).all(), f"off the fp64 product by {err.max().item()}"
    del exact, err, tol
    same("a second launch", OB.ordered_bmm(a, b), got)
    lo = min(M // 2, max(0, M - 8))
    rows = a[:, lo:lo + 8]
    # a column of ones beside b where P = 1, so that these rows leave the
    # row route for the small one and the tiles
    wide = b if P > 1 else torch.cat([b, fill(N, K, 1)], -1)
    for label, sub, keep in (
            ("a row alone", a[:, M - 1:], slice(M - 1, M)),
            ("rows on the small route", rows, slice(lo, lo + 8)),
            ("rows in a 256-row tile",
             torch.cat([fill(N, 124, K), rows, fill(N, 256 - 124 - rows.shape[1],
                                                    K)], 1),
             slice(lo, lo + 8))):
        out = OB.ordered_bmm(sub, wide)[..., :P]
        if sub.shape[1] == 256:
            out = out[:, 124:124 + rows.shape[1]]
        routes.add(OB.route(N, sub.shape[1], K, wide.shape[-1]))
        same(label, out, got[:, keep])
    col = b[..., :1]
    for label, sub in (("column 0 alone (P = 1)", col),
                       ("columns 0 and 1 (P = 2)",
                        torch.cat([col, fill(N, K, 1)], -1)),
                       ("column 0 of P = 160",
                        torch.cat([col, fill(N, K, 159)], -1))):
        routes.add(OB.route(N, M, K, sub.shape[-1]))
        same(label, OB.ordered_bmm(a, sub)[..., :1], got[..., :1])
    zk = lambda t, d: torch.nn.functional.pad(t, d)
    same("K padded with zeros", OB.ordered_bmm(zk(a, (0, 37)),
                                                zk(b, (0, 0, 0, 37))), got)
    # attention's layouts: the keys (B, S, H, hd) permuted to (B, H, hd, S)
    # (K contiguous), the values (B, S, H, hd) to (B, H, S, hd) (rows
    # pitched by H * hd); a with a padded row pitch
    h = 2 if N % 2 == 0 else 1
    b4 = b.reshape(h, N // h, K, P)
    pitched = zk(a, (0, 4))[..., :K].reshape(h, N // h, M, K)
    for label, view in (
            ("b as the keys' view", b4.permute(0, 3, 1, 2).contiguous()
             .permute(0, 2, 3, 1)),
            ("b as the values' view", b4.permute(0, 2, 1, 3).contiguous()
             .permute(0, 2, 1, 3))):
        same(label, OB.ordered_bmm(pitched, view).reshape(N, M, P), got)
    return sorted(routes)


def ordered_bmm_rows(g) -> list:
    """ordered_bmm at `BMM_ROWS`: each held with the plain version to the
    fp64 product within 1e-5 of |a| @ |b| and to itself across every
    route and layout, bit for bit (`bmm_crossings`), then timed beside
    `torch.bmm` on the same operands."""
    import torch
    from repro_torch.kernels import ordered_bmm as OB
    rows = []
    for label, N, M, K, P in BMM_ROWS:
        a, b = bmm_operands(g, N, M, K, P)
        got = OB.ordered_bmm(a, b)
        want = OB.ordered_bmm_plain(a, b)
        tol = 1e-5 * (a.double().abs() @ b.double().abs())
        err = (want.double() - a.double() @ b.double()).abs()
        if not (err <= tol).all():
            fail(f"ordered_bmm {label}: the plain version is off the fp64 "
                 f"product by {err.max().item()}")
        del tol, err
        try:
            routes = bmm_crossings(a, b, got)
        except AssertionError as e:
            fail(f"ordered_bmm {label} a({N},{M},{K}) b({N},{K},{P}): {e}")
        b_ms, b_by = bound(4 * (N * M * K + N * K * P + N * M * P),
                           2 * N * M * K * P / FP32_FLOP_S)
        row = timed_row(
            "ordered_bmm", f"{label} a({N},{M},{K}) b({N},{K},{P})",
            (got - want).abs().max().item(),
            lambda: OB.ordered_bmm(a, b), lambda: OB.ordered_bmm_plain(a, b),
            lambda: torch.bmm(a, b), b_ms, b_by)
        row["route"] = OB.route(N, M, K, P)
        row["routes_crossed"] = routes
        rows.append(row)
        print(f"  ordered_bmm {label} a({N},{M},{K}) b({N},{K},{P}): "
              f"{row['route']}, bit-equal across {'/'.join(routes)}",
              flush=True)
    print("  ordered_bmm: every row within 1e-5 of |a| @ |b|, two launches "
          "bit-equal, a row's and a column's bits the same on every route, "
          "with K zero-padded and through strided views", flush=True)
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
            # warmup runs one prefill and one decode step besides the timed
            # ones; the one layer's h-side is a step product: the GEMV at
            # any batch
            want = {"fused_tick": GEN + 1, "packed_gemv": 2 * S}
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
    for k in ("packed_gemv", "fused_tick"):
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
        seeds = torch.arange(B, device="cuda")
        box = [logits, st, 0]

        def step():
            nxt = sample(box[0], seeds, box[2], temperature=0.8,
                         vocab=cfg.vocab)
            box[0], box[1] = rt.decode_step(nxt, box[1])
            box[2] += 1

        step()
        for phase, fn, n in (
                ("prefill", lambda: rt.prefill(prompt, rt.init_state(B)), 1),
                ("decode_step", step, 32)):
            by_name, wall = device_profile(fn, n)
            busy, idle = busy_idle(by_name, wall, n)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            row = {"wall_us": wall / n * 1e6, "device_busy_us": busy,
                   "idle_share": idle,
                   "top": [(k[:48], v / n) for k, v in top]}
            out[f"B={B} {phase}"] = row
            print(f"  B={B:2d} {phase:11s}: wall {row['wall_us']:9.1f} us  device "
                  f"busy {num(busy, '8.1f')} us  idle {num(idle, '.3f')}  top "
                  + ", ".join(f"{k} {v:.1f}" for k, v in row["top"]), flush=True)
    report["profile"] = out


def engine_streams_equal(rt, comps, reqs) -> int:
    """Every completion against its request alone through drive_session
    (B = 1); fails on the first stream that differs.  Returns the number
    of tokens compared."""
    import numpy as np
    import torch
    from repro_torch.serve.recurrent import drive_session
    by_rid = {c.rid: c for c in comps}
    n = 0
    for r in reqs:
        prompt = torch.as_tensor(np.asarray(r.prompt, np.int64))[None]
        out, _ = drive_session(rt, prompt, rt.cfg.vocab, gen=r.max_tokens,
                               temperature=r.temperature, top_k=r.top_k,
                               seed=r.seed)
        if by_rid[r.rid].tokens != out[0].tolist():
            fail(f"engine stream of request {r.rid} differs from "
                 f"drive_session(B=1): {by_rid[r.rid].tokens} vs "
                 f"{out[0].tolist()}")
        n += len(by_rid[r.rid].tokens)
    return n


def spec_rows_checked(eng, reqs) -> tuple:
    """Drive a speculative engine step by step.  After every round, each
    live slot's draft-pool row must be the state of the draft runtime run
    alone (B = 1) over that slot's prompt (in the engine's chunks) and the
    tokens it committed, bit for bit: a wrong rollback would only lower the
    acceptance, and the target keeps the streams right.  Returns (streams
    by rid, rows compared)."""
    import numpy as np
    import torch
    draft, C = eng.draft, eng.prefill_chunk
    for r in reqs:
        eng.submit(r)
    alone, fed, streams, compared = {}, {}, {}, 0
    bits = lambda a, b: torch.equal(a.reshape(-1).view(torch.int32),
                                    b.reshape(-1).view(torch.int32))
    while eng.has_work():
        events, _ = eng.step()
        for rid, toks in events:
            streams.setdefault(rid, []).extend(toks)
        for slot in np.flatnonzero(eng._live_host):
            act = eng._active[slot]
            if act.rid not in alone:
                st = draft.init_state(1, per_slot=True)
                prompt = torch.as_tensor(act.prompt.astype(np.int64),
                                         device=eng.device)[None]
                for lo in range(0, prompt.shape[1], C):
                    _, st = draft.prefill_chunk(prompt[:, lo:lo + C], st)
                alone[act.rid], fed[act.rid] = st, 0
            st = alone[act.rid]
            for tok in act.tokens[fed[act.rid]:-1]:  # the last is pending
                _, st = draft.decode_step(
                    torch.tensor([tok], device=eng.device), st)
            alone[act.rid], fed[act.rid] = st, len(act.tokens) - 1
            row = eng.draft_pool
            if not (bits(st.h, row.h[:, slot]) and bits(st.c, row.c[:, slot])
                    and bits(st.pos, row.pos[slot])):
                fail(f"spec: slot {slot}'s draft row after {fed[act.rid]} "
                     f"committed tokens of request {act.rid} is not the "
                     f"draft's state run alone")
            compared += 1
    return streams, compared


def tick_row_bits(rt) -> None:
    """One row's h, c, logits and greedy id from the fused tick at B = 1,
    4, 12 and 16 (one pass of 4, three of 4, two of 8), beside other rows
    and live patterns: the same bits, or the engine's streams would
    depend on the batch."""
    import torch
    from repro_torch.kernels import decode_step as DK
    from repro_torch.kernels import ops as OPS
    cfg, tick = rt.cfg, rt.tables[0]["tick"]
    g = torch.Generator().manual_seed(4)
    L, H, V = cfg.n_layers, cfg.d_hidden, cfg.vocab
    h0 = torch.tanh(torch.randn(L, H, generator=g)).cuda()
    c0 = torch.randn(L, H, generator=g).cuda()
    ref = None
    for B in (1, 4, 12, 16):
        at = B // 2
        h = torch.tanh(torch.randn(L, B, H, generator=g)).cuda()
        c = torch.randn(L, B, H, generator=g).cuda()
        h[:, at], c[:, at] = h0, c0
        tok = torch.randint(0, V, (B,), generator=g).cuda()
        tok[at] = 7
        live = (torch.rand(B, generator=g) > 0.4).cuda()
        live[at] = True
        hn, cn, lg, gr = DK.fused_tick(*OPS.tick_operands(tok, h, c, tick,
                                                         live),
                                       cell=cfg.cell, mode=cfg.quant.mode)
        row = [hn[:, at, :H], cn[:, at, :H], lg[at, :V], gr[at:at + 1]]
        if ref is None:
            ref = [t.clone() for t in row]
        elif not all(torch.equal(a.reshape(-1).view(torch.int32),
                                 b.reshape(-1).view(torch.int32))
                     for a, b in zip(row, ref)):
            fail(f"fused_tick: a row's bits at B={B} differ from B=1")
    print("  fused_tick: a row's h, c, logits and greedy id are the same "
          "bits at B = 1, 4, 12, 16", flush=True)


def two_layer_parity() -> dict:
    """Two layers at H = 256 (ternary, off init): layer 1's x-side
    projection takes a whole chunk in the engine and the whole prompt in
    drive_session, both on the GEMM (a sequence product) at other row
    counts.  For prompts of 5 to 40 tokens in chunks of 8 and 32 the
    chunked state must be bit-equal to the whole prompt's (the GEMM sums a
    row in one order whatever the row count), and an engine at 16 slots
    over 24 mixed requests must give every stream drive_session(B=1)
    gives it."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_rnn_config
    from repro_torch.core import bnlstm as BL
    from repro_torch.launch.serve import synth_traffic
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.recurrent import RNNRuntime, drive_session
    cfg = dataclasses.replace(get_rnn_config("rnn-paper"), d_hidden=256,
                              n_layers=2)
    gen = torch.Generator().manual_seed(1)
    var = off_init(BL.rnn_lm_init(gen, cfg, device="cuda"), gen)
    rt = RNNRuntime(cfg, {"params": BL.export_packed_rnn(var["params"], cfg),
                          "state": var["state"]}, device="cuda")
    out = {"prefill": {}, "streams_differ": {}}
    bits = lambda a, b: torch.equal(a.view(torch.int32), b.view(torch.int32))
    for S in (5, 8, 12, 20, 33, 40):
        toks = torch.randint(0, cfg.vocab, (1, S), generator=gen).cuda()
        _, whole = rt.prefill(toks, rt.init_state(1, per_slot=True))
        for chunk in (8, 32):
            st = rt.init_state(1, per_slot=True)
            for lo in range(0, S, chunk):
                _, st = rt.prefill_chunk(toks[:, lo:lo + chunk], st)
            err = max((st.h - whole.h).abs().max().item(),
                      (st.c - whole.c).abs().max().item())
            if not (bits(st.h, whole.h) and bits(st.c, whole.c)):
                fail(f"L=2 prompt {S} in chunks of {chunk}: state {err} from "
                     f"the whole prompt's, not bit-equal")
            out["prefill"][f"S={S} chunk={chunk}"] = {
                "bits_equal": bits(st.h, whole.h) and bits(st.c, whole.c),
                "max_abs": err}
    reqs = synth_traffic(cfg.vocab, requests=24, rate=100.0, prompt_len=40,
                         gen=16, temperature=0.8, top_k=5, seed=1)
    for chunk in (8, 32):
        eng = ServeEngine(rt, cfg.vocab, slots=16, max_context=56,
                          prefill_chunk=chunk)
        comps, _ = eng.run([dataclasses.replace(r) for r in reqs],
                           realtime=False)
        by_rid = {c.rid: c.tokens for c in comps}
        out["streams_differ"][f"chunk={chunk}"] = sum(
            by_rid[r.rid] != drive_session(
                rt, torch.as_tensor(np.asarray(r.prompt, np.int64))[None],
                cfg.vocab, gen=r.max_tokens, temperature=r.temperature,
                top_k=r.top_k, seed=r.seed)[0][0].tolist() for r in reqs)
    if any(out["streams_differ"].values()):
        fail(f"L=2 engine streams differ from drive_session(B=1): "
             f"{out['streams_differ']} of 24")
    print(f"  L=2, H=256: chunked prefill bit-equal to the whole prompt's "
          f"for prompts 5..40 in chunks of 8 and 32; every engine stream "
          f"== drive_session(B=1) (24 of 24, chunks 8 and 32)", flush=True)
    return out


def engine_profile(eng) -> dict:
    """Where an engine iteration's time goes at 15 live slots of 16: a step
    that only ticks, and one prefill chunk of 32 steps into the free slot,
    each timed on the host clock (the engine reads the sampled ids back
    every tick, so a step ends synchronized) and under torch.profiler
    (device busy, idle share)."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(5)
    for i in range(15):
        eng.submit(Request(prompt=rng.integers(0, eng.vocab, size=8),
                           max_tokens=120, temperature=0.8, top_k=40,
                           seed=900 + i))
    while eng._prefill_q or eng._heap:
        eng.step()
    chunk = rng.integers(0, eng.vocab, size=32).astype(np.int64)
    free = eng._free_slot()
    out = {}
    for name, fn, n in (("tick step", eng.step, 20),
                        ("prefill chunk (32 steps)",
                         lambda: eng._run_chunk(chunk, free), 5)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / n
        by_name, wall = device_profile(fn, n)
        busy, idle = busy_idle(by_name, wall, n)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        row = {"host_us": host * 1e6, "profiled_wall_us": wall / n * 1e6,
               "device_busy_us": busy, "idle_share": idle,
               "top": [(k[:48], v / n) for k, v in top]}
        out[name] = row
        print(f"    {name:24s}: host {row['host_us']:8.1f} us (profiled "
              f"{row['profiled_wall_us']:8.1f})  device busy "
              f"{num(busy, '7.1f')} us  idle {num(idle, '.3f')}  top "
              + ", ".join(f"{k} {v:.1f}" for k, v in row["top"]), flush=True)
    eng._scrub([free])
    for act in list(eng._active):
        if act is not None:
            eng.cancel(act.rid)
    return out


def engine_phase(report: dict) -> dict:
    """The continuous-batching engine at rnn-paper's full width: plain
    (byte parity with drive_session, one fused tick a tick, one GEMV a
    prompt step), realtime at half the sustained rate, speculative (fp
    target, ternary draft), the prefix cache, and the front door's smoke.
    Returns the plain run's launch counts."""
    import asyncio
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_rnn_config
    from repro_torch.core import bnlstm as BL
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import synth_traffic
    from repro_torch.serve import frontdoor
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.prefixcache import PrefixCache
    from repro_torch.serve.recurrent import RNNRuntime, speculative_draft

    cfg = get_rnn_config("rnn-paper")
    gen = torch.Generator().manual_seed(0)
    var = off_init(BL.rnn_lm_init(gen, cfg, device="cuda"), gen)
    rt = RNNRuntime(cfg, {"params": BL.export_packed_rnn(var["params"], cfg),
                          "state": var["state"]}, device="cuda")
    P, G, N = 96, 64, 64
    traffic = lambda rate: synth_traffic(
        cfg.vocab, requests=N, rate=rate, prompt_len=P, gen=G,
        temperature=0.8, top_k=40, seed=0)
    reqs = traffic(1000.0)
    eng = ServeEngine(rt, cfg.vocab, slots=16, max_context=P + G,
                      prefill_chunk=32)
    eng.warm()
    tick_row_bits(rt)
    out = {}

    # -- plain, as fast as it drains: the counted run --------------------
    steps0, ticks0 = eng.prefill_steps, eng.ticks
    dispatch.reset_counts()      # ---- the counted engine run starts here
    comps, m = eng.run([dataclasses.replace(r) for r in reqs],
                       realtime=False)
    launches = dict(dispatch.LAUNCHES)
    plain = dict(dispatch.PLAIN_CALLS)
    # ---- the counted engine run ends here
    steps = eng.prefill_steps - steps0
    if plain:
        fail(f"plain versions ran in the engine: {plain}")
    want = {"fused_tick": eng.ticks - ticks0, "packed_gemv": steps}
    if launches != want:
        fail(f"engine launches {launches}, want {want} (one fused tick a "
             f"tick, one GEMV a prompt step, pad steps included)")
    if m["max_decode_stall_ticks"] > 1 or m["tick_launches"] != 1:
        fail(f"engine: max decode stall {m['max_decode_stall_ticks']}, "
             f"tick launches {m['tick_launches']}")
    n_tok = engine_streams_equal(rt, comps, reqs)
    sustained = N / m["wall_s"]
    out["drain"] = dict(m, launches=launches, prefill_steps=steps,
                        sustained_req_s=sustained)
    print(f"  plain engine, slots 16, chunk 32, {N} requests (prompts "
          f"U[1,{P}], gen U[1,{G}], T 0.8, top-k 40), drained: "
          f"{m['agg_tok_s']:.0f} tok/s, {sustained:.1f} req/s, {m['ticks']} "
          f"ticks, occupancy {m['occupancy']:.2f}, launches {launches}; "
          f"all {n_tok} tokens == drive_session(B=1)", flush=True)

    # -- realtime at half the sustained rate ------------------------------
    rreqs = traffic(0.5 * sustained)
    rcomps, rm = eng.run([dataclasses.replace(r) for r in rreqs],
                         realtime=True)
    if len(rcomps) != N:
        fail(f"realtime run completed {len(rcomps)} of {N}")
    out["realtime"] = dict(rm, offered_req_s=0.5 * sustained)
    print(f"  realtime at {0.5 * sustained:.1f} req/s: {rm['agg_tok_s']:.0f} "
          f"tok/s, latency p50 {rm['p50_latency_s'] * 1e3:.1f} p95 "
          f"{rm['p95_latency_s'] * 1e3:.1f} ms, TTFT p50 "
          f"{rm['ttft_p50_s'] * 1e3:.1f} p95 {rm['ttft_p95_s'] * 1e3:.1f} ms, "
          f"occupancy {rm['occupancy']:.2f}, max stall "
          f"{rm['max_decode_stall_ticks']}", flush=True)
    out["profile"] = engine_profile(eng)

    # -- speculative: fp target, its ternary draft, greedy ----------------
    fcfg = dataclasses.replace(cfg, quant=QuantSpec(mode="none"))
    target = RNNRuntime(fcfg, {"params": var["params"],
                               "state": var["state"]}, device="cuda")
    draft = speculative_draft(target, mode="ternary")
    greedy = [dataclasses.replace(r, temperature=0.0, top_k=0)
              for r in reqs[:16]]
    plain_eng = ServeEngine(target, cfg.vocab, slots=16, max_context=P + G,
                            prefill_chunk=32)
    spec_eng = ServeEngine(target, cfg.vocab, slots=16, max_context=P + G,
                           prefill_chunk=32, draft=draft, spec_k=4)
    plain_eng.warm()
    spec_eng.warm()
    pc, pm = plain_eng.run([dataclasses.replace(r) for r in greedy],
                           realtime=False)
    dispatch.reset_counts()
    sc, sm = spec_eng.run([dataclasses.replace(r) for r in greedy],
                          realtime=False)
    spec_launches = dict(dispatch.LAUNCHES)
    pby = {c.rid: c.tokens for c in pc}
    for c in sc:
        if c.tokens != pby[c.rid]:
            fail(f"spec stream {c.rid} differs from the plain engine's "
                 f"greedy: {c.tokens} vs {pby[c.rid]}")
    if spec_launches.get("fused_tick") != 5 * sm["spec_rounds"]:
        fail(f"spec launches {spec_launches}, rounds {sm['spec_rounds']}")
    out["spec"] = dict(sm, launches=spec_launches, plain_greedy=pm)
    print(f"  speculative k=4, fp target + ternary draft, 16 greedy "
          f"requests: streams == plain engine's greedy; accept rate "
          f"{sm['accept_rate']:.3f}, {sm['agg_tok_s']:.0f} tok/s emitted "
          f"(plain fp engine {pm['agg_tok_s']:.0f}), launches {spec_launches}",
          flush=True)
    # the rollback, sampled (temperature 0.8, top-k 40), so that rounds
    # reject part way along the drafted span, not only at its first or
    # past its last proposal
    roll_eng = ServeEngine(target, cfg.vocab, slots=16, max_context=P + G,
                           prefill_chunk=32, draft=draft, spec_k=4)
    _, compared = spec_rows_checked(
        roll_eng, [dataclasses.replace(r) for r in reqs[:16]])
    rs = roll_eng.stats()
    rejected = rs["drafted_tokens"] - rs["accepted_drafts"]
    if not 0 < rejected < rs["drafted_tokens"]:
        fail(f"spec rollback check: {rejected} of {rs['drafted_tokens']} "
             f"drafts rejected; it needs rounds that reject part way")
    out["spec_rollback"] = dict(rs, rows_compared=compared)
    print(f"  speculative k=4, ternary draft, T 0.8: {rejected} of "
          f"{rs['drafted_tokens']} drafts rejected; {compared} draft rows "
          f"after a round == the draft run alone, bit for bit", flush=True)

    # -- the prefix cache: 16 requests behind one 64-token prefix ---------
    rng = np.random.default_rng(3)
    system = rng.integers(0, cfg.vocab, size=64)
    shared = [Request(prompt=np.concatenate(
        [system, rng.integers(0, cfg.vocab, size=int(rng.integers(1, 17)))]),
        max_tokens=16, temperature=0.8, top_k=40, seed=700 + i, rid=i)
        for i in range(16)]
    cached = ServeEngine(rt, cfg.vocab, slots=16, max_context=P + G,
                         prefill_chunk=32, prefix_cache=PrefixCache(64 << 20))
    cold = ServeEngine(rt, cfg.vocab, slots=16, max_context=P + G,
                       prefill_chunk=32)
    hc = cached.run([shared[0]], realtime=False)[0]
    hc += cached.run(shared[1:], realtime=False)[0]
    cc, _ = cold.run(shared, realtime=False)
    st = cached.prefix_cache.stats()
    cby = {c.rid: c.tokens for c in cc}
    if st["hits"] < 15 or any(c.tokens != cby[c.rid] for c in hc):
        fail(f"prefix cache: {st}; streams equal "
             f"{[c.tokens == cby[c.rid] for c in hc]}")
    out["prefix_cache"] = dict(st, cached_tokens=sum(c.cached_tokens
                                                     for c in hc))
    print(f"  prefix cache 64 MB: {st['hits']} hits of 16 requests, "
          f"{out['prefix_cache']['cached_tokens']} prompt tokens spliced, "
          f"streams == cache-off engine", flush=True)

    # -- the front door's loopback smoke ----------------------------------
    if asyncio.run(frontdoor._smoke(0, "cuda")) != 0:
        fail("front-door smoke")
    out["two_layers"] = two_layer_parity()
    report["engine"] = out
    return launches


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
        busy, idle = busy_idle(by_name, wall, 2)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        prof = {"wall_us": wall / 2 * 1e6, "device_busy_us": busy,
                "idle_share": idle,
                "tok_s": args.batch * args.seq / (wall / 2),
                "top": [(k[:60], v / 2) for k, v in top]}
        out["profile_step"] = prof
        print(f"  train step (B = {args.batch}, T = {args.seq}, profiled): wall "
              f"{prof['wall_us']:.0f} us  device busy {num(busy, '.0f')} us  "
              f"idle {num(idle, '.3f')}  {prof['tok_s']:.0f} tok/s  top "
              + ", ".join(f"{k} {v:.0f}" for k, v in prof["top"]), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["training"] = out
    return launches


# the RNN pipelines' steps a leg (phases 8 and 14): SIGTERM at step 10
PIPELINE_STEPS = 20


def pipeline_phase(report: dict) -> dict:
    """`repro_torch.launch.train --pipeline` at rnn-paper's full width
    (H = 1000, batch 32, seq 100, 20 steps a leg): a real SIGTERM, exit 43
    and the resume, bit-equal checkpoints of the two legs, the packed
    export served through the engine byte for byte like drive_session
    (B = 1), and the trained accept rate (reported, not held: JAX's 0.976
    came from 300 steps and other random streams).  Its results file goes
    to chiprun_out/.  Returns the launches of the run, the children's
    (their training launches none: the step samples its weights densely,
    and neither package's launcher calls quantize_pack) and this
    process's: the engine's and drive_session's fused ticks and prompt-step
    GEMVs, which must launch."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train as launch_train

    argv = ["--pipeline", "--quick", "--arch", "rnn-paper", "--steps",
            str(PIPELINE_STEPS), "--batch", "32", "--seq", "100", "--device",
            "cuda",
            "--results-dir", str(ROOT / "chiprun_out")]
    dispatch.reset_counts()   # ---- the counted pipeline run starts here
    t0 = time.perf_counter()
    train, serve, spec = launch_train.main(argv)
    launches = dict(dispatch.LAUNCHES)
    # ---- the counted pipeline run ends here
    for k, v in train["child_launches"].items():
        launches[k] = launches.get(k, 0) + v
    if dispatch.PLAIN_CALLS:
        fail(f"plain versions ran in the pipeline: {dict(dispatch.PLAIN_CALLS)}")
    if not (train["resume_bit_exact"] and train["restart_exit_code"] == 43
            and serve["engine_byte_parity"] and spec["greedy_equal_plain"]):
        fail(f"pipeline rows {train} {serve} {spec}")
    for k in ("packed_gemv", "fused_tick"):
        if not launches.get(k):
            fail(f"kernel {k} was never launched in the pipeline: {launches}")
    out = {"wall_s": time.perf_counter() - t0, "rows": [train, serve, spec],
           "launches": launches}
    report["pipeline"] = out
    print(f"  pipeline: SIGTERM at step {train['sigterm_at_step']}, exit 43, "
          f"resumed from {train['resumed_from_step']}; checkpoints bit-equal; "
          f"final val BPC {train['final_val_bpc']:.4f}; engine streams == "
          f"drive_session(B=1); trained accept rate {spec['accept_rate']:.3f} "
          f"(JAX: 0.976 at 300 steps, reduced, not held); "
          f"{out['wall_s']:.1f} s; launches {launches}", flush=True)
    return launches


QWEN_PROJECTIONS = (("attn", "Wq"), ("attn", "Wk"), ("attn", "Wv"),
                    ("attn", "Wo"), ("mlp", "Wgate"), ("mlp", "Wup"),
                    ("mlp", "Wdown"))


def summation_check(name: str, got, want, x, w) -> float:
    """Kernel and plain version against the fp64 product, within 1e-5 of
    the summed magnitudes |x| @ |w| (fp32 sums of K terms in other orders;
    tests/test_torch_cuda.py holds the same).  Returns max |got - want|."""
    exact = x.double() @ w.double()
    tol = 1e-5 * (x.double().abs() @ w.double().abs())
    for out in (got, want):
        if not ((out.double() - exact).abs() <= tol).all():
            fail(f"{name}: off the fp64 product by "
                 f"{(out.double() - exact).abs().max().item()}")
    return (got - want).abs().max().item()


def rows_invariant(name: str, x, codes, mode: str, got) -> None:
    """Batch invariance of the packed row sums within each route: the
    GEMM's output rows `got` of x must equal, bit for bit, its own over a
    9-row prefix, a 17-row tail and single rows (its plan is fixed by (K,
    N, mode), so only the number of 64-row tiles follows M); and the step
    route's, the GEMV over every row of x (8-row tiles past 8 rows), its
    own on its first 8 rows and on single rows.  A product's role, not its
    row count, keeps a row on one route, so the two routes' bits are not
    compared."""
    import torch
    from repro_torch.kernels import packed_matmul as PK
    M = x.shape[0]
    bits = lambda t: t.view(torch.int32)
    step = PK.packed_gemv(x, codes, mode=mode)
    for fn, full in ((PK.packed_matmul, got), (PK.packed_gemv, step)):
        checks = [slice(i, i + 1) for i in sorted({0, M // 2, M - 1})]
        checks += ([slice(0, 9), slice(max(0, M - 17), M)]
                   if fn is PK.packed_matmul else [slice(0, min(M, 8))])
        for sl in checks:
            part = fn(x[sl].contiguous(), codes, mode=mode)
            if not torch.equal(bits(part), bits(full[sl])):
                fail(f"{name}: rows {sl.start}..{sl.stop - 1} by "
                     f"{fn.__name__} differ from the same rows of its "
                     f"M = {M} launch")


def layer_kernel_rows(label: str, packed: dict, plan, stack=None) -> list:
    """packed_gemv (<= 8 rows, the step route) and packed_matmul (more, the
    sequence route) on layer 0's codes of each (block, weight, row counts)
    of `plan` (a stacked expert leaf: its last expert's slice, as the MoE
    layer serves it), each launched twice and bit-equal, held with its
    plain version to the fp64 product within 1e-5 of |x| @ |w|, a row's
    bits the same at other row counts within its route, timed beside its
    bound (on the unpadded function) and torch.matmul on the dequantized
    weight.  Each GEMM shape is also timed at M = 1 and 4 (a prompt's last
    short chunk: `m1_ms`, `m4_ms`) and run again in binary on random codes
    of the same (K, N), held as the ternary run is (`binary_ms`,
    `binary_max_abs_err`); these three times come from CUDA events
    (`event_ms`), since a profiler session costs about a second, and so
    does `events_ms`, the ternary run's own, beside the profiler's.  The
    layers are `packed["stack"][0]` unless `stack` names other blocks: a stacked group
    (the encoder's) or one unstacked block (zamba2's shared block), whose
    codes are taken whole."""
    import torch
    from repro_torch.core.qtensor import QTensor
    from repro_torch.kernels import packed_matmul as PK

    g = torch.Generator().manual_seed(1)
    rows = []
    stack = packed["stack"][0] if stack is None else stack

    def row(name, one, codes, w, M, expert, timed=True):
        gemm = M > 8
        fn = PK.packed_matmul if gemm else PK.packed_gemv
        plain = PK.packed_matmul_plain if gemm else PK.packed_gemv_plain
        K, N, mode = one.k, codes.shape[1], one.mode
        x = torch.tanh(torch.randn(M, K, generator=g)).cuda()
        got = fn(x, codes, mode=mode)
        again = fn(x, codes, mode=mode)
        want = plain(x, codes, mode=mode)
        err = summation_check(f"{fn.__name__} {label} {name} {mode} M={M}",
                              got, want, x, w)
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            fail(f"{fn.__name__} {label} {name} {mode} M={M}: two launches "
                 f"differ")
        if gemm:
            rows_invariant(f"{label} {name} {mode}", x, codes, mode, got)
            plan_ = PK.matmul_plan(K, N, mode=mode)
            blocks = gemm_blocks(plan_, M)
        else:
            plan_ = PK.gemv_plan(M, K, N, mode=mode)
            blocks = plan_["blocks"]
        if not timed:  # the binary repeat: its time beside the ternary row's
            rows[-1]["binary_ms"] = event_ms(lambda: fn(x, codes, mode=mode),
                                             30)
            rows[-1]["binary_max_abs_err"] = err
            return
        b_ms, b_by = (gemm_bound if gemm else packed_bound)(one, M)
        rows.append(timed_row(
            fn.__name__, f"{label} {name} {mode} x({M},{K}) "
            f"{'expert ' if expert else ''}codes{tuple(codes.shape)} "
            f"{blocks} blocks, cluster {plan_['cluster']}", err,
            lambda: fn(x, codes, mode=mode),
            lambda: plain(x, codes, mode=mode),
            lambda: torch.matmul(x, w), b_ms, b_by, reps=100,
            plain_reps=1 if M > 512 or mode == "binary" else 3))
        if gemm:
            r = rows[-1]
            # the profiler's device time beside one call's span between two
            # CUDA events, its launch queued first (a cross-check)
            r["events_ms"] = event_ms(lambda: fn(x, codes, mode=mode), 20)
            for m in (1, 4):  # the GEMM at a prompt's last short chunk
                xm = x[:m].contiguous()
                r[f"m{m}_ms"] = event_ms(lambda: fn(xm, codes, mode=mode), 30)
                r[f"m{m}_bound_ms"] = gemm_bound(one, m)[0]

    for blk, name, counts in plan:
        qt = stack[blk][name]
        expert = qt.codes.dim() == 4     # (layer, expert, K/G, N)
        codes = (qt.codes[0, -1] if expert else
                 qt.codes[0] if qt.codes.dim() == 3 else qt.codes)
        if not codes.is_contiguous() or codes.data_ptr() % 16:
            fail(f"{label} {name}: layer 0's codes are not a contiguous, "
                 f"16-byte aligned slice")
        one = QTensor(codes=codes, k=qt.k, mode=qt.mode, alpha=qt.alpha)
        w = one.dequantize() / qt.alpha
        for M in counts:
            row(name, one, codes, w, M, expert)
        gemm_counts = [M for M in counts if M > 8]
        if gemm_counts:  # the same shape in binary, on random codes
            cb = torch.randint(-2**31, 2**31, (qt.k // 32, codes.shape[1]),
                               generator=g, dtype=torch.int64
                               ).to(torch.int32).cuda()
            ob = QTensor(codes=cb, k=qt.k, mode="binary", alpha=1.0)
            row(name, ob, cb, ob.dequantize(), gemm_counts[0], expert,
                timed=False)
    us = lambda v: "-" if v is None else f"{v * 1e3:.1f}"
    where = "layer 0" if qt.codes.dim() > 2 else "block"
    print(f"  {label} {where}: kernel == plain within 1e-5 of |x| @ |w|, "
          f"two launches bit-equal, a row's bits the same at other row "
          f"counts on its route", flush=True)
    for r in rows:
        small = (f"  events {us(r['events_ms'])} us; M=1 {us(r['m1_ms'])} us, "
                 f"M=4 {us(r['m4_ms'])} us, binary {us(r['binary_ms'])} us "
                 f"(events)" if "m1_ms" in r else "")
        print(f"    {r['name']:14s} {r['shape']:74s} {r['max_abs_err']:.1e}  "
              f"{us(r['ms'])} us ({us(r['wall_ms'])})  plain {us(r['plain_ms'])}"
              f"  matmul {us(r['library_ms'])}  bound {r['bound_ms'] * 1e3:.2f}"
              f" ({r['bound_by']}){small}", flush=True)
    return rows


def qwen_kernel_rows(packed: dict) -> list:
    """packed_gemv at 1, 4 and 8 rows and packed_matmul at M = 512 (B = 4,
    prompt 128) on layer 0's seven projections of the exported model."""
    return layer_kernel_rows("qwen3", packed, [
        (blk, name, (1, 4, 8, 512)) for blk, name in QWEN_PROJECTIONS])


def first_divergence(rt, req, tokens: list, ctx: int):
    """Run `req` alone, greedy, feeding the engine's `tokens`; at the first
    step where the engine took another token than the alone argmax, return
    (step, top-2 logit gap of the alone logits); None when all agree."""
    import numpy as np
    import torch
    V = rt.cfg.vocab
    st = rt.init_state(1, ctx)
    lg, st = rt.prefill(torch.as_tensor(np.asarray(req.prompt, np.int64),
                                        device="cuda")[None], st)
    for i, tok in enumerate(tokens):
        top = torch.topk(lg[0, :V], 2).values
        if int(torch.argmax(lg[0, :V])) != tok:
            return i, (top[0] - top[1]).item()
        lg, st = rt.decode_step(torch.tensor([tok], device="cuda"), st)
    return None




def transformer_phase(report: dict) -> dict:
    """qwen3-0.6B at full width (28 layers, d 1024, 16/8 heads of 128,
    d_ff 3072, vocab 151,936, tied, qk_norm), random weights from a seed,
    ternary export, bf16 compute: the kernels at its projection shapes, the
    packed tree's bytes, packed against fp-dequantized logits, lockstep
    drive_session, then the engine, speculative decoding and the prefix
    cache on a cut of QWEN_ENGINE_LAYERS layers.  Returns the launches of
    the counted serving run."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import (QTensor, export_packed, tree_leaves,
                                          tree_map)
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import synth_traffic
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.prefixcache import PrefixCache
    from repro_torch.serve.recurrent import (TransformerRuntime, drive_session,
                                             speculative_draft)

    cfg = get_config("qwen3-0.6b")
    if (cfg.n_layers, cfg.d_model, cfg.hd, cfg.d_ff, cfg.vocab) != (
            28, 1024, 128, 3072, 151936):
        fail(f"qwen3-0.6b is not at its published width: {cfg}")
    out = {}
    t0 = time.perf_counter()
    masters = T.model_init(torch.Generator("cuda").manual_seed(0), cfg)
    packed = export_packed(masters, cfg.quant)
    torch.cuda.synchronize()
    out["init_export_s"] = time.perf_counter() - t0

    # 1. the kernels at the seven projection shapes
    out["kernel_rows"] = qwen_kernel_rows(packed)

    # 2. bytes
    rt = TransformerRuntime(cfg, packed, device="cuda")
    codes = [l for l in tree_leaves(packed) if isinstance(l, QTensor)]
    n_proj = sum(int(np.prod(q.shape)) for q in codes)
    out["bytes"] = {
        "projection_weights": n_proj,
        "codes_bytes": sum(q.nbytes for q in codes),
        "projection_fp32_bytes": 4 * n_proj,
        "embed_fp32_bytes": packed["embed"].numel() * 4,
        "packed_tree_bytes": rt.param_nbytes()[1],
        "fp32_tree_bytes": rt.param_nbytes()[0],
        "served_embed_bf16_bytes": rt.served["embed"].numel() * 2}
    b = out["bytes"]
    print(f"  qwen3-0.6B ternary: {n_proj / 1e6:.1f} M projection weights in "
          f"{b['codes_bytes'] / 1e6:.1f} MB of codes (fp32 "
          f"{b['projection_fp32_bytes'] / 1e6:.1f} MB), beside the fp32 "
          f"embedding {b['embed_fp32_bytes'] / 1e6:.1f} MB (served as bf16, "
          f"{b['served_embed_bf16_bytes'] / 1e6:.1f} MB); whole tree "
          f"{b['packed_tree_bytes'] / 1e6:.1f} MB vs fp32 "
          f"{b['fp32_tree_bytes'] / 1e6:.1f} MB", flush=True)

    # 3. packed against the same weights dequantized into an fp tree, the
    # first decode step's logits after a 16-token prompt at B = 4: in fp32
    # compute the two differ only by fp32 summation order (relative L2
    # within 1e-4); in bf16, the serving dtype, the fp tree also rounds
    # alpha and every product's output to bf16 (relative L2 reported, held
    # within 1e-1, which a lost alpha or channel scale would break)
    deq = tree_map(lambda l: l.dequantize() if isinstance(l, QTensor) else l,
                   packed)
    prompt = torch.randint(0, cfg.vocab, (4, 16),
                           generator=torch.Generator().manual_seed(2)).cuda()
    out["packed_vs_dequantized"] = {}
    for dtype, limit in (("float32", 1e-4), ("bfloat16", 1e-1)):
        c = dataclasses.replace(cfg, dtype=dtype)
        a = rt if dtype == "bfloat16" else TransformerRuntime(c, packed,
                                                              device="cuda")
        f = TransformerRuntime(c.with_quant(QuantSpec(mode="none")), deq,
                               device="cuda")
        lp, sp = a.prefill(prompt, a.init_state(4, 32))
        lf, sf = f.prefill(prompt, f.init_state(4, 32))
        nxt = torch.argmax(lf[:, :cfg.vocab], -1)
        lp, _ = a.decode_step(nxt, sp)
        lf, _ = f.decode_step(nxt, sf)
        lp, lf = lp[:, :cfg.vocab], lf[:, :cfg.vocab]
        rel = ((lp - lf).norm() / lf.norm()).item()
        agree = int((lp.argmax(-1) == lf.argmax(-1)).sum())
        out["packed_vs_dequantized"][dtype] = {
            "rel_l2": rel, "limit": limit, "greedy_agree_of_4": agree,
            "max_abs": (lp - lf).abs().max().item(),
            "max_logit": lf.abs().max().item()}
        if not rel <= limit:
            fail(f"packed vs dequantized {dtype} decode logits: relative L2 "
                 f"{rel} (limit {limit})")
        print(f"  packed vs fp-dequantized, {dtype}, first decode step: "
              f"relative L2 {rel:.2e} (limit {limit:.0e}), max abs "
              f"{(lp - lf).abs().max().item():.3g} of max |logit| "
              f"{lf.abs().max().item():.3g}, greedy agree {agree}/4",
              flush=True)
        del f
    del deq

    # ---- the counted transformer serving run starts here ----
    dispatch.reset_counts()
    # 4. lockstep B = 4, prompt 128, gen 32
    B, S, GEN = 4, 128, 32
    prompt = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(3))
    before = dict(dispatch.LAUNCHES)
    toks, m = drive_session(rt, prompt, cfg.vocab, gen=GEN, temperature=0.8,
                            top_k=40, seed=0, warmup=True)
    delta = {k: v - before.get(k, 0) for k, v in dispatch.LAUNCHES.items()}
    lg = m.pop("last_logits")
    # ordered_bmm a step: attention's two products and four norms (two
    # pre-norms, q and k) a layer, and the final norm; GEN + 1 decode steps
    # and two prefills
    want = {"packed_gemv": 196 * (GEN + 1), "packed_matmul": 196 * 2,
            "ordered_bmm": (6 * 28 + 1) * (GEN + 3)}
    if delta != want or not torch.isfinite(lg).all() or toks.shape != (B, GEN):
        fail(f"qwen3 lockstep: launches {delta} (want {want}), tokens "
             f"{toks.shape}")
    out["lockstep"] = dict(m, launches=delta, per_decode_step=196,
                           per_prefill=196)
    print(f"  lockstep B={B}, prompt {S}, gen {GEN}: prefill "
          f"{m['prefill_tok_s']:.0f} tok/s, decode {m['decode_tok_s']:.1f} "
          f"tok/s; packed launches a decode step 196 (7 x 28 GEMVs), a "
          f"prefill 196 GEMMs at M = {B * S}; state {m['state_nbytes'] / 1e6:.1f}"
          f" MB", flush=True)
    st0 = rt.init_state(B, S + GEN)
    lg, st0 = rt.prefill(prompt.cuda(), st0)
    box = [lg, st0]

    def step():
        box[0], box[1] = rt.decode_step(torch.argmax(box[0][:, :cfg.vocab],
                                                     -1), box[1])
    step()
    prof = {}
    for name, fn, n in (("decode_step", step, 8),
                        ("prefill", lambda: rt.prefill(
                            prompt.cuda(), rt.init_state(B, S + GEN)), 2)):
        t1 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t1) / n
        counts: dict = {}
        by_name, wall = device_profile(fn, n, counts=counts)
        busy, idle = busy_idle(by_name, wall, n)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        prof[name] = {"host_us": host * 1e6, "wall_us": wall / n * 1e6,
                      "device_busy_us": busy, "idle_share": idle,
                      "device_launches": (sum(counts.values()) / n
                                          if counts else None),
                      "top": [(k[:48], v / n) for k, v in top]}
        r = prof[name]
        print(f"    {name:11s}: host {r['host_us']:9.1f} us (profiled "
              f"{r['wall_us']:9.1f})  device busy {num(busy, '8.1f')} us  "
              f"idle {num(idle, '.3f')}  {num(r['device_launches'], '.0f')} "
              f"device launches  top "
              + ", ".join(f"{k} {v:.1f}" for k, v in r["top"]), flush=True)
    out["profile"] = prof

    # 5. the engine: 32 mixed requests at 8 slots, chunk 32, at full width
    # on a cut of QWEN_ENGINE_LAYERS layers (steps 5-7: the script's time)
    ecfg = dataclasses.replace(cfg, n_layers=QWEN_ENGINE_LAYERS)
    del masters
    masters = T.model_init(torch.Generator("cuda").manual_seed(0), ecfg)
    ert = TransformerRuntime(ecfg, export_packed(masters, ecfg.quant),
                             device="cuda")
    # a layer 7 packed GEMVs and 6 ordered_bmm (attention, norms); the
    # final norm
    per_tick = 13 * QWEN_ENGINE_LAYERS + 1
    P, G = 128, 32
    reqs = synth_traffic(cfg.vocab, requests=32, rate=1e3, prompt_len=P,
                         gen=G, temperature=0.8, top_k=40, seed=0)
    eng = ServeEngine(ert, cfg.vocab, slots=8, max_context=P + G,
                      prefill_chunk=32)
    eng.warm()
    comps, em = eng.run([dataclasses.replace(r) for r in reqs],
                        realtime=False)
    if em["tick_launches"] != per_tick or em["max_decode_stall_ticks"] > 1:
        fail(f"qwen3 engine: {em['tick_launches']} kernel calls a tick, "
             f"stall {em['max_decode_stall_ticks']}")
    alone = lambda r: drive_session(
        ert, torch.as_tensor(np.asarray(r.prompt, np.int64))[None], cfg.vocab,
        gen=r.max_tokens, temperature=r.temperature, top_k=r.top_k,
        seed=r.seed, context=P + G)[0][0].tolist()
    by = {c.rid: c.tokens for c in comps}
    equal = sum(by[r.rid] == alone(r) for r in reqs)
    greedy = [dataclasses.replace(r, temperature=0.0, top_k=0) for r in reqs]
    gcomps, _ = eng.run([dataclasses.replace(r) for r in greedy],
                        realtime=False)
    gby = {c.rid: c.tokens for c in gcomps}
    gaps = []
    for r in greedy:
        d = first_divergence(ert, r, gby[r.rid], P + G)
        if d is not None:
            gaps.append({"rid": r.rid, "step": d[0], "gap": d[1]})
    # batch invariance: each packed product takes the route of its role
    # (a prompt chunk's the GEMM, a decode step's the GEMV) and each route
    # sums a row in one order at any row count, and attention's products
    # do (ordered_bmm), so every stream, sampled and greedy, is the one the
    # request gets alone
    if equal != len(reqs) or gaps:
        fail(f"qwen3 engine: {equal}/{len(reqs)} sampled streams == "
             f"drive_session(B=1); greedy divergences {gaps}")
    out["engine"] = dict(em, sampled_streams_equal=equal, requests=len(reqs),
                         greedy_divergences=gaps, layers=QWEN_ENGINE_LAYERS)
    print(f"  engine on {QWEN_ENGINE_LAYERS} of the 28 layers, slots 8, chunk "
          f"32, 32 requests (prompts U[1,{P}], gen U[1,{G}], T 0.8, top-k "
          f"40): {em['agg_tok_s']:.0f} tok/s, {em['ticks']} ticks, occupancy "
          f"{em['occupancy']:.2f}, {per_tick} kernel calls a tick; "
          f"{equal}/{len(reqs)} sampled and {len(reqs) - len(gaps)}/"
          f"{len(reqs)} greedy streams == drive_session(B=1)", flush=True)

    # 6. speculative k = 4: bf16 fp masters the target, their ternary export
    # the draft, 8 greedy requests
    target = TransformerRuntime(ecfg.with_quant(QuantSpec(mode="none")),
                                masters, device="cuda")
    del masters
    draft = speculative_draft(target)
    plain_eng = ServeEngine(target, cfg.vocab, slots=8, max_context=P + G,
                            prefill_chunk=32)
    spec_eng = ServeEngine(target, cfg.vocab, slots=8, max_context=P + G,
                           prefill_chunk=32, draft=draft, spec_k=4)
    plain_eng.warm()
    spec_eng.warm()
    pc, pm = plain_eng.run([dataclasses.replace(r) for r in greedy[:8]],
                           realtime=False)
    sc, sm = spec_eng.run([dataclasses.replace(r) for r in greedy[:8]],
                          realtime=False)
    pby = {c.rid: c.tokens for c in pc}
    match = sum(c.tokens == pby[c.rid] for c in sc)
    out["spec"] = dict(sm, greedy_match_of_8=match, plain_tok_s=pm["agg_tok_s"])
    print(f"  speculative k=4, bf16 target + ternary draft, 8 greedy "
          f"requests: accept rate {sm['accept_rate']:.3f}, {match}/8 streams "
          f"== the plain engine's greedy, {sm['agg_tok_s']:.0f} tok/s "
          f"(plain {pm['agg_tok_s']:.0f})", flush=True)
    del target, draft, plain_eng, spec_eng

    # 7. 8 requests behind a 64-token shared prefix
    rng = np.random.default_rng(3)
    system = rng.integers(0, cfg.vocab, size=64)
    shared = [Request(prompt=np.concatenate(
        [system, rng.integers(0, cfg.vocab, size=int(rng.integers(1, 17)))]),
        max_tokens=16, temperature=0.8, top_k=40, seed=700 + i, rid=i)
        for i in range(8)]
    cached = ServeEngine(ert, cfg.vocab, slots=8, max_context=P + G,
                         prefill_chunk=32, prefix_cache=PrefixCache(256 << 20))
    hc = cached.run([shared[0]], realtime=False)[0]
    hc += cached.run(shared[1:], realtime=False)[0]
    cold = ServeEngine(ert, cfg.vocab, slots=8, max_context=P + G,
                       prefill_chunk=32)
    cc, _ = cold.run(shared, realtime=False)
    cby = {c.rid: c.tokens for c in cc}
    pst = cached.prefix_cache.stats()
    out["prefix_cache"] = dict(pst, streams_equal_cold=sum(
        c.tokens == cby[c.rid] for c in hc))
    launches = dict(dispatch.LAUNCHES)
    plain_calls = dict(dispatch.PLAIN_CALLS)
    # ---- the counted transformer serving run ends here ----
    if pst["hits"] < 7:
        fail(f"qwen3 prefix cache: {pst}")
    print(f"  prefix cache: {pst['hits']} hits of 8, {pst['hit_tokens']} "
          f"prompt tokens spliced, entries {pst['entries']} "
          f"({pst['bytes'] / 1e6:.1f} MB); "
          f"{out['prefix_cache']['streams_equal_cold']}/8 streams == the "
          f"cache-off engine", flush=True)
    if plain_calls:
        fail(f"plain versions ran on the transformer path: {plain_calls}")
    for k in ("packed_gemv", "packed_matmul", "ordered_bmm"):
        if not launches.get(k):
            fail(f"kernel {k} was never launched on the transformer path")
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    report["transformer"] = out
    print(f"  transformer phase: {out['wall_s']:.1f} s, launches {launches}",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 10: the pool's MoE and RWKV6 serving paths
# ---------------------------------------------------------------------------

# phase 10's engine runs, 8 slots over synth_traffic(seed=0) with prompts
# U[1, 128]: (requests, gen U[1, G]) by arch.  qwen3-moe's steps are
# host-bound (about 0.85 s a decode step at B = 4, PERF.md), so its run is
# cut to 8 requests of at most 16 tokens to keep the phase near 300 s
POOL_PROMPT = 128
ZAMBA2_ENGINE_LAYERS = 6
POOL_ENGINE = {"qwen3-moe": (8, 16), "rwkv6-7b": (16, 32),
               "zamba2": (16, 32)}
# Depth cuts, widths untouched, to keep the script inside its time limit
# as phases join it: qwen3-0.6B's engine, speculative and prefix-cache
# runs (phase 9) on 8 of its 28 layers (phase 9 took 252.4 s at 28, 173 s
# at 14 once the norms and attention ran ordered_bmm; 119.8 s at 8 with
# the tensor-core GEMM, the script 735.2 s; at 14 the script took 1137 s
# on a slow host once phase 16 joined; 4 since the script took 1150.4 s on
# a slow host with 8); qwen3-moe's
# lockstep run and engine run on 2 of its 48 layers (at 48 they took 117.9
# and 119 s of host-bound time, at 8 30.5 and 44.5 s on a slow host, at 4
# 14.7 and 21.1 s; 2 since the script grew by its examples phase),
# rwkv6's engine on 2 of its 32 layers (100.4 s at 32, 39.7 s at 8 on
# that slow host, 18.4 s at 4), zamba2's on 6 of its 38, one shared
# application (75 s at 38, 40.7 s at 12 on the slow host)
QWEN_ENGINE_LAYERS = 4
MOE_SERVE_LAYERS = 2
RWKV_ENGINE_LAYERS = 2


def pool_config(arch: str, **over):
    """A pool arch at its published widths (ternary, channel scales, bf16),
    checked against the widths phases 10-13 claim; `over` cuts depth."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    want = {"qwen3-moe-30b-a3b": (48, 2048, 32, 4, 128, 768, 151936, 128, 8),
            "mixtral-8x7b": (32, 4096, 32, 8, 128, 14336, 32000, 8, 2),
            "rwkv6-7b": (32, 4096, 64, 64, 64, 14336, 65536, 0, 0),
            # + (d_inner, SSD heads, head dim, state, conv, chunk, period)
            "zamba2-1.2b": (38, 2048, 32, 32, 64, 8192, 32000, 0, 0,
                            4096, 64, 64, 64, 4, 64, 6),
            # + encoder layers
            "whisper-base": (6, 512, 8, 8, 64, 2048, 51865, 0, 0, 6),
            "qwen3-0.6b": (28, 1024, 16, 8, 128, 3072, 151936, 0, 0),
            # + image tokens, the pattern
            "llama-3.2-vision-90b": (100, 8192, 64, 8, 128, 28672, 128256,
                                     0, 0, 1600,
                                     ("self",) * 4 + ("cross",))}[arch]
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
           cfg.d_ff, cfg.vocab, cfg.n_experts, cfg.topk)
    if cfg.family == "hybrid":
        got += (cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                cfg.ssm_conv, cfg.ssm_chunk, cfg.attn_every)
    if cfg.family == "audio":
        got += (cfg.n_enc_layers,)
    if cfg.family == "vlm":
        got += (cfg.n_img_tokens, cfg.block_pattern)
    if got != want or (cfg.quant.mode, cfg.quant.norm, cfg.dtype) != (
            "ternary", "channel", "bfloat16"):
        fail(f"{arch} is not at its published width: {cfg}")
    return dataclasses.replace(cfg, **over)


def pool_build(cfg, seed: int = 0, off: dict | None = None) -> dict:
    """The packed tree, drawn a layer at a time on the card and exported as
    it is drawn (`model_init(packed=True)`: one layer's fp32 masters alive
    at a time), with the channel scales moved off init, and each leaf
    named in `off` moved by its shift there plus N(0, 0.1^2) noise."""
    import torch
    from repro_torch.core.qtensor import tree_map_with_path
    from repro_torch.models import transformer as T
    packed = T.model_init(torch.Generator("cuda").manual_seed(seed), cfg,
                          packed=True)
    g = torch.Generator("cuda").manual_seed(seed + 1)
    noise = lambda l: 0.1 * torch.randn(l.shape, generator=g, device="cuda")
    off = off or {}

    def walk(path, l):
        if not isinstance(l, torch.Tensor):
            return l
        if path[-1] in off:
            return l + off[path[-1]] + noise(l)
        return l * (1.0 + noise(l)) if path[-1].startswith("s") else l
    return tree_map_with_path(walk, packed)


def pool_bytes(label: str, packed: dict, rt) -> dict:
    """The paper's memory claim on the tree: projection weights, their codes
    and their fp32 size, and the whole tree packed against fp32."""
    import numpy as np
    from repro_torch.core.qtensor import QTensor, tree_leaves
    codes = [l for l in tree_leaves(packed) if isinstance(l, QTensor)]
    n_proj = sum(int(np.prod(q.shape)) for q in codes)
    fp, real = rt.param_nbytes()
    b = {"projection_weights": n_proj,
         "codes_bytes": sum(q.nbytes for q in codes),
         "projection_fp32_bytes": 4 * n_proj,
         "packed_tree_bytes": real, "fp32_tree_bytes": fp}
    print(f"  {label} ternary: {n_proj / 1e9:.2f} B projection weights in "
          f"{b['codes_bytes'] / 1e9:.2f} GB of codes (fp32 "
          f"{b['projection_fp32_bytes'] / 1e9:.1f} GB); whole tree "
          f"{real / 1e9:.2f} GB vs fp32 {fp / 1e9:.1f} GB", flush=True)
    return b


def dequantized(tree):
    """An fp tree of the same function as a packed one: every packed leaf
    dequantized with its channel scale (the `s<W>` companion, which an fp
    tree does not apply) folded into its output columns."""
    from repro_torch.core.qtensor import QTensor
    if isinstance(tree, (list, tuple)):
        return type(tree)(dequantized(v) for v in tree)
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if isinstance(v, QTensor):
            w, sc = v.dequantize(), tree.get("s" + k[1:])
            if sc is not None:
                w = w * sc.reshape(sc.shape[:-1] + (1,) * (w.dim() - sc.dim())
                                   + sc.shape[-1:])
            out[k] = w
        else:
            out[k] = dequantized(v)
    return out


def packed_vs_dequantized(label: str, cfg, packed: dict,
                          extras: dict | None = None) -> dict:
    """The first decode step's logits after a 16-token prompt at B = 4,
    packed against the same weights dequantized into an fp tree: held
    within 1e-4 relative L2 in fp32 compute (the two differ by summation
    order, and the router sees the same logits to fp32 rounding), reported
    in bf16.  `extras` go to both runtimes (the audio family's frames)."""
    import dataclasses
    import torch
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.serve.recurrent import TransformerRuntime

    deq = dequantized(packed)
    prompt = torch.randint(0, cfg.vocab, (4, 16),
                           generator=torch.Generator().manual_seed(2)).cuda()
    out = {}
    for dtype, limit in (("float32", 1e-4), ("bfloat16", None)):
        c = dataclasses.replace(cfg, dtype=dtype)
        a = TransformerRuntime(c, packed, extras=extras, device="cuda")
        f = TransformerRuntime(c.with_quant(QuantSpec(mode="none")), deq,
                               extras=extras, device="cuda")
        lp, sp = a.prefill(prompt, a.init_state(4, 32))
        lf, sf = f.prefill(prompt, f.init_state(4, 32))
        nxt = torch.argmax(lf[:, :cfg.vocab], -1)
        lp, _ = a.decode_step(nxt, sp)
        lf, _ = f.decode_step(nxt, sf)
        lp, lf = lp[:, :cfg.vocab], lf[:, :cfg.vocab]
        rel = ((lp - lf).norm() / lf.norm()).item()
        agree = int((lp.argmax(-1) == lf.argmax(-1)).sum())
        out[dtype] = {"rel_l2": rel, "limit": limit, "greedy_agree_of_4": agree,
                      "max_abs": (lp - lf).abs().max().item()}
        if limit is not None and not rel <= limit:
            fail(f"{label} packed vs dequantized {dtype} decode logits: "
                 f"relative L2 {rel} (limit {limit})")
        print(f"  {label} packed vs fp-dequantized ({cfg.n_layers} layers), "
              f"{dtype}: relative L2 {rel:.2e} (limit "
              f"{'reported' if limit is None else f'{limit:.0e}'}), greedy "
              f"agree {agree}/4", flush=True)
        del a, f
    return out


def packed_launches(delta: dict) -> int:
    return delta.get("packed_gemv", 0) + delta.get("packed_matmul", 0)


def pool_lockstep(label: str, rt, B: int, S: int, GEN: int,
                  attn_proj: int) -> dict:
    """drive_session at B x S + GEN, then a decode step and a prefill alone,
    timed on the host and under torch.profiler: tok/s, a step's host time,
    device busy time, idle share, device launches, packed launches (and
    for an MoE arch, the experts run a layer, from the packed launches
    beyond the `attn_proj` projections a layer)."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.serve.recurrent import drive_session
    cfg = rt.cfg
    L = cfg.n_layers
    prompt = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(3))
    before = dict(dispatch.LAUNCHES)
    toks, m = drive_session(rt, prompt, cfg.vocab, gen=GEN, temperature=0.8,
                            top_k=40, seed=0, warmup=True)
    delta = {k: v - before.get(k, 0) for k, v in dispatch.LAUNCHES.items()}
    lg = m.pop("last_logits")
    if not torch.isfinite(lg).all() or toks.shape != (B, GEN) or not \
            packed_launches(delta):
        fail(f"{label} lockstep: launches {delta}, tokens {toks.shape}")
    out = dict(m, launches=delta)
    print(f"  {label} lockstep B={B}, prompt {S}, gen {GEN}: prefill "
          f"{m['prefill_tok_s']:.0f} tok/s, decode {m['decode_tok_s']:.2f} "
          f"tok/s, state {m['state_nbytes'] / 1e6:.1f} MB", flush=True)
    st = rt.init_state(B, S + GEN)
    lg, st = rt.prefill(prompt.cuda(), st)
    box = [lg, st]

    def step():
        box[0], box[1] = rt.decode_step(
            torch.argmax(box[0][:, :cfg.vocab], -1), box[1])
    step()
    prof = {}
    for name, fn in (("decode_step", step), ("prefill", lambda: rt.prefill(
            prompt.cuda(), rt.init_state(B, S + GEN)))):
        before = dict(dispatch.LAUNCHES)
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t1
        d = {k: v - before.get(k, 0) for k, v in dispatch.LAUNCHES.items()}
        counts: dict = {}
        by_name, wall = device_profile(fn, 1, counts=counts)
        busy, idle = busy_idle(by_name, wall, 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        r = prof[name] = {
            "host_us": host * 1e6, "wall_us": wall * 1e6,
            "device_busy_us": busy, "idle_share": idle,
            "device_launches": sum(counts.values()) if counts else None,
            "packed_gemv": d.get("packed_gemv", 0),
            "packed_matmul": d.get("packed_matmul", 0),
            "top": [(k[:48], v) for k, v in top]}
        if cfg.n_experts:
            r["experts_a_layer"] = (packed_launches(d) - attn_proj * L) / 3 / L
        if name == "decode_step" and (
                r["packed_matmul"] or cfg.n_experts and
                r["experts_a_layer"] > min(cfg.n_experts, B * cfg.topk)):
            fail(f"{label} decode step: {r['packed_gemv']} GEMVs, "
                 f"{r['packed_matmul']} GEMMs for {B} rows")
        print(f"    {name:11s}: host {host * 1e3:9.1f} ms (profiled "
              f"{wall * 1e3:9.1f})  device busy {num(busy, '8.2f', 1e3)} ms  "
              f"idle {num(idle, '.3f')}  {num(r['device_launches'], 'd')} "
              f"device launches,"
              f" {r['packed_gemv']} GEMVs, {r['packed_matmul']} GEMMs"
              + (f", {r['experts_a_layer']:.1f} experts a layer"
                 if cfg.n_experts else "") + "  top "
              + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in r["top"]),
              flush=True)
    out["profile"] = prof
    return out


def pool_engine(label: str, rt) -> dict:
    """The engine at 8 slots over POOL_ENGINE[label] requests of
    synth_traffic(seed=0) (prompts U[1, POOL_PROMPT], gen U[1, G], T 0.8,
    top-k 40), each prompt one prefill chunk: tok/s, ticks,
    occupancy; every stream equal to drive_session(B=1), sampled and then
    the same requests greedy (the rounding that followed the row count,
    the GEMM's K split and route, cuBLAS's attention products and the SSD
    step's readout, is gone); and JAX's refusals of speculation and a
    prefix cache."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch.serve import synth_traffic
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.prefixcache import PrefixCache
    from repro_torch.serve.recurrent import drive_session
    cfg = rt.cfg
    n_req, G = POOL_ENGINE[label]
    P = POOL_PROMPT
    for kw, what in ((dict(draft=rt, spec_k=4), "MoE and rwkv/mamba"),
                     (dict(prefix_cache=PrefixCache(1 << 20)),
                      "token-granularity")):
        try:
            ServeEngine(rt, cfg.vocab, slots=8, max_context=P + G, **kw)
            fail(f"{label}: the engine took {sorted(kw)}")
        except NotImplementedError as e:
            if what not in str(e):
                fail(f"{label}: refused {sorted(kw)} with {e}")
    reqs = synth_traffic(cfg.vocab, requests=n_req, rate=1e3,
                         prompt_len=P, gen=G, temperature=0.8, top_k=40,
                         seed=0)
    eng = ServeEngine(rt, cfg.vocab, slots=8, max_context=P + G,
                      prefill_chunk=32)
    comps, em = eng.run([dataclasses.replace(r) for r in reqs],
                        realtime=False)
    n_prompt = sum(np.asarray(r.prompt).size for r in reqs)
    chunks = eng.prefill_chunks
    if (chunks != len(reqs) or eng.prefill_steps != n_prompt
            or em["max_decode_stall_ticks"] > 1):
        fail(f"{label} engine: {eng.prefill_chunks} chunks for {len(reqs)} "
             f"prompts, stall {em['max_decode_stall_ticks']}")
    alone = lambda r: drive_session(
        rt, torch.as_tensor(np.asarray(r.prompt, np.int64))[None], cfg.vocab,
        gen=r.max_tokens, temperature=r.temperature, top_k=r.top_k,
        seed=r.seed, context=P + G)[0][0].tolist()
    by = {c.rid: c.tokens for c in comps}
    equal = sum(by[r.rid] == alone(r) for r in reqs)
    greedy = [dataclasses.replace(r, temperature=0.0, top_k=0) for r in reqs]
    gcomps, _ = eng.run([dataclasses.replace(r) for r in greedy],
                        realtime=False)
    gby = {c.rid: c.tokens for c in gcomps}
    gaps = []
    for r in greedy:
        d = first_divergence(rt, r, gby[r.rid], P + G)
        if d is not None:
            gaps.append({"rid": r.rid, "step": d[0], "gap": d[1]})
    if equal != len(reqs) or gaps:
        fail(f"{label} engine: {equal}/{len(reqs)} sampled streams == "
             f"drive_session(B=1); greedy divergences {gaps}")
    out = dict(em, sampled_streams_equal=equal, requests=len(reqs),
               prefill_chunks=chunks, greedy_divergences=gaps)
    print(f"  {label} engine, slots 8, whole-prompt chunks, {len(reqs)} "
          f"requests (prompts U[1,{P}], gen U[1,{G}], T 0.8, top-k 40): "
          f"{em['agg_tok_s']:.1f} tok/s, {em['ticks']} ticks, occupancy "
          f"{em['occupancy']:.2f}, {em['tick_launches']} kernel calls the "
          f"last tick, {chunks} chunks; {equal}/{len(reqs)} sampled and "
          f"{len(reqs) - len(gaps)}/{len(reqs)} greedy streams == "
          f"drive_session(B=1); speculation and the prefix cache refused",
          flush=True)
    return out


def wkv_long_prompt(cfg, T: int = 4096, held: int = 256) -> dict:
    """wkv6_chunked over one T-token prompt at the config's heads and
    chunk: its peak memory above its inputs, held to 32 times one input (a
    pairwise (Q, Q, N) decay takes Q = 64 times in one temporary), finite,
    and its first `held` outputs within 1e-5 of their largest magnitude of
    the one-token recurrence unrolled; timed."""
    import torch
    from repro_torch.models import rwkv6 as R
    g = torch.Generator("cuda").manual_seed(4)
    N = cfg.hd
    H = cfg.d_model // N
    rand = lambda *s: torch.randn(s, generator=g, device="cuda")
    r, k, v = (rand(1, T, H, N) * 0.5 for _ in range(3))
    logw = -torch.exp(rand(1, T, H, N) * 0.3 - 1.0)
    u = rand(H, N) * 0.3
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    y, S = R.wkv6_chunked(r, k, v, logw, u, cfg.ssm_chunk)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    one = r.nbytes
    St = torch.zeros((1, H, N, N), device="cuda")
    ys = []
    for t in range(held):
        yt, St = R.wkv6_step(r[:, t], k[:, t], v[:, t], logw[:, t], u, St)
        ys.append(yt)
    err = (y[:, :held] - torch.stack(ys, 1)).abs().max().item()
    lim = 1e-5 * y[:, :held].abs().max().item()
    out = {"tokens": T, "peak_bytes": peak, "input_bytes": one,
           "limit_bytes": 32 * one, "ms": ms, "step_err": err,
           "step_limit": lim}
    if not (torch.isfinite(y).all() and torch.isfinite(S).all()) \
            or peak > 32 * one or not err <= lim:
        fail(f"wkv6_chunked over {T} tokens: {out}")
    print(f"  wkv6_chunked, one {T}-token prompt, {H} heads of {N}, chunk "
          f"{cfg.ssm_chunk}: peak {peak / 1e6:.0f} MB above its inputs "
          f"({peak / one:.1f} x one input, limit 32), {ms:.1f} ms; first "
          f"{held} outputs off the unrolled step by {err:.1e} (limit "
          f"{lim:.1e})", flush=True)
    return out


def pool_phase(report: dict) -> tuple:
    """qwen3-moe-30b-a3b and rwkv6-7b at full width, mixtral-8x7b at its
    widths and 2 layers (ternary, bf16, random weights from a seed): the
    kernels at each arch's shapes and packed against dequantized logits
    first, then the counted serving runs (qwen3-moe's lockstep and engine
    on a cut of MOE_SERVE_LAYERS layers, rwkv6's engine on a cut of
    RWKV_ENGINE_LAYERS).  Returns the launches of the MoE
    runs (qwen3-moe's lockstep and engine, mixtral's lockstep) and of the
    rwkv runs, each counted from 0 just before and read just after."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.serve.recurrent import TransformerRuntime

    out = {"qwen3_moe": {}, "mixtral": {}, "rwkv6": {}}
    q, x, w = out["qwen3_moe"], out["mixtral"], out["rwkv6"]
    t_phase = time.perf_counter()
    def secs(t):
        torch.cuda.synchronize()
        return round(time.perf_counter() - t, 1)

    # qwen3-moe-30b-a3b at full width: build, kernels, bytes, logits
    t0 = time.perf_counter()
    qcfg = pool_config("qwen3-moe-30b-a3b")
    torch.cuda.reset_peak_memory_stats()
    qpacked = pool_build(qcfg)
    torch.cuda.synchronize()
    q["build_s"] = secs(t0)
    q["build_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  qwen3-moe-30b-a3b built a layer at a time in {q['build_s']} s "
          f"(peak {q['build_peak_gb']:.1f} GB allocated)", flush=True)
    q["kernel_rows"] = layer_kernel_rows("qwen3-moe", qpacked, [
        ("moe", "Wgate", (1, 4, 8, 40)), ("moe", "Wdown", (1, 4, 8, 40)),
        ("attn", "Wq", (512,)), ("attn", "Wk", (512,))])
    qrt = TransformerRuntime(qcfg, qpacked, device="cuda")
    q["bytes"] = pool_bytes("qwen3-moe-30b-a3b", qpacked, qrt)
    cut = pool_config("qwen3-moe-30b-a3b", n_layers=2)
    q["packed_vs_dequantized"] = packed_vs_dequantized(
        "qwen3-moe", cut, pool_build(cut))
    ecfg = pool_config("qwen3-moe-30b-a3b", n_layers=MOE_SERVE_LAYERS)
    ert = TransformerRuntime(ecfg, pool_build(ecfg), device="cuda")
    q["engine_layers"] = q["lockstep_layers"] = MOE_SERVE_LAYERS
    del qrt, qpacked
    torch.cuda.empty_cache()
    q["checks_s"] = secs(t0)

    # mixtral-8x7b at its widths, 2 layers: build, kernels, logits
    t0 = time.perf_counter()
    xcfg = pool_config("mixtral-8x7b", n_layers=2)
    xpacked = pool_build(xcfg)
    x["kernel_rows"] = layer_kernel_rows("mixtral", xpacked, [
        ("moe", "Wgate", (4, 40)), ("moe", "Wdown", (4, 40))])
    x["packed_vs_dequantized"] = packed_vs_dequantized("mixtral", xcfg,
                                                       xpacked)
    xrt = TransformerRuntime(xcfg, xpacked, device="cuda")
    x["checks_s"] = secs(t0)
    torch.cuda.empty_cache()

    # ---- the counted MoE run starts here ----
    dispatch.reset_counts()
    t0 = time.perf_counter()
    q["lockstep"] = pool_lockstep("qwen3-moe", ert, 4, 128, 32, attn_proj=4)
    q["lockstep_s"] = secs(t0)
    t0 = time.perf_counter()
    q["engine"] = pool_engine("qwen3-moe", ert)
    q["engine_s"] = secs(t0)
    t0 = time.perf_counter()
    x["lockstep"] = pool_lockstep("mixtral", xrt, 4, 32, 8, attn_proj=4)
    x["lockstep_s"] = secs(t0)
    moe, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN_CALLS)
    # ---- the counted MoE run ends here ----
    del ert, xrt, xpacked
    torch.cuda.empty_cache()

    # rwkv6-7b at full width
    t0 = time.perf_counter()
    wcfg = pool_config("rwkv6-7b")
    wpacked = pool_build(wcfg)
    wrt = TransformerRuntime(wcfg, wpacked, device="cuda")
    w["bytes"] = pool_bytes("rwkv6-7b", wpacked, wrt)
    w["build_s"] = secs(t0)
    t0 = time.perf_counter()
    w["kernel_rows"] = layer_kernel_rows("rwkv6-7b", wpacked, [
        ("mix", "Wr", (1, 4, 8, 512)), ("mix", "Wck", (512,)),
        ("mix", "Wcv", (512,))])
    cut = pool_config("rwkv6-7b", n_layers=2)
    w["packed_vs_dequantized"] = packed_vs_dequantized(
        "rwkv6-7b", cut, pool_build(cut))
    w["wkv_long_prompt"] = wkv_long_prompt(wcfg)
    ecfg = pool_config("rwkv6-7b", n_layers=RWKV_ENGINE_LAYERS)
    ert = TransformerRuntime(ecfg, pool_build(ecfg), device="cuda")
    w["engine_layers"] = RWKV_ENGINE_LAYERS
    w["checks_s"] = secs(t0)
    # ---- the counted rwkv run starts here ----
    dispatch.reset_counts()
    t0 = time.perf_counter()
    w["lockstep"] = pool_lockstep("rwkv6-7b", wrt, 4, 128, 32, attn_proj=8)
    w["lockstep_s"] = secs(t0)
    t0 = time.perf_counter()
    w["engine"] = pool_engine("rwkv6-7b", ert)
    w["engine_s"] = secs(t0)
    rwkv = dict(dispatch.LAUNCHES)
    plain.update(dispatch.PLAIN_CALLS)
    # ---- the counted rwkv run ends here ----
    del wrt, wpacked, ert
    torch.cuda.empty_cache()

    for label, launches in (("MoE", moe), ("rwkv", rwkv)):
        for k in ("packed_gemv", "packed_matmul"):
            if not launches.get(k):
                fail(f"kernel {k} was never launched on the {label} path")
    if plain:
        fail(f"plain versions ran on the pool path: {plain}")
    out["moe_launches"], out["rwkv_launches"] = moe, rwkv
    out["wall_s"] = secs(t_phase)
    report["pool"] = out
    print(f"  pool phase: {out['wall_s']} s (qwen3-moe checks "
          f"{q['checks_s']} s, lockstep {q['lockstep_s']} s and engine "
          f"{q['engine_s']} s at {MOE_SERVE_LAYERS} layers; mixtral checks "
          f"{x['checks_s']} s, lockstep {x['lockstep_s']} s; rwkv6 build "
          f"{w['build_s']} s, checks {w['checks_s']} s, lockstep "
          f"{w['lockstep_s']} s, engine {w['engine_s']} s at "
          f"{RWKV_ENGINE_LAYERS} layers); MoE launches {moe}, rwkv launches "
          f"{rwkv}", flush=True)
    return moe, rwkv


# ---------------------------------------------------------------------------
# phase 11: the pool's hybrid and audio serving paths
# ---------------------------------------------------------------------------

# Whisper's published audio context: 30 s, 3000 mel frames, 1500 after the
# stride-2 conv (the frontend is a stub: the frames are random embeddings)
WHISPER_FRAMES = 1500
# the leaves moved off init beside the channel scales, and their shifts
HYBRID_OFF = {k: 0.0 for k in ("dt_bias", "conv_b", "D", "norm", "norm1",
                                "norm2", "final_norm")}
AUDIO_OFF = dict({k: 0.0 for k in ("bfc1", "bfc2", "norm1", "norm2",
                                   "normc", "final_norm")}, xgate=0.5)


def ssd_long_prompt(cfg, T: int = 4096, held: int = 256) -> dict:
    """ssd_chunked over one T-token prompt at one mamba layer's shapes
    (heads, head dim, state, chunk) in fp32: finite, its peak memory above
    its inputs reported as a multiple of their bytes (held to 16), its
    first `held` outputs within 1e-5 of their largest magnitude of the
    one-token recurrence unrolled; timed."""
    import torch
    from repro_torch.models import mamba2 as M
    g = torch.Generator("cuda").manual_seed(5)
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    rand = lambda *s: torch.randn(s, generator=g, device="cuda")
    x = rand(1, T, H, P) * 0.5
    dt = torch.nn.functional.softplus(rand(1, T, H) - 3.0)
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    Bm, Cm = rand(1, T, N) * 0.5, rand(1, T, N) * 0.5
    inputs = nbytes(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    y, h = M.ssd_chunked(x, dt, A, Bm, Cm, cfg.ssm_chunk)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    hs = torch.zeros((1, H, N, P), device="cuda")
    ys = []
    for t in range(held):
        yt, hs = M.ssd_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], hs)
        ys.append(yt)
    err = (y[:, :held] - torch.stack(ys, 1)).abs().max().item()
    lim = 1e-5 * y[:, :held].abs().max().item()
    out = {"tokens": T, "peak_bytes": peak, "input_bytes": inputs,
           "peak_over_inputs": peak / inputs, "limit": 16, "ms": ms,
           "step_err": err, "step_limit": lim}
    if not (torch.isfinite(y).all() and torch.isfinite(h).all()) \
            or peak > 16 * inputs or not err <= lim:
        fail(f"ssd_chunked over {T} tokens: {out}")
    print(f"  ssd_chunked, one {T}-token prompt, {H} heads of {P}, state "
          f"{N}, chunk {cfg.ssm_chunk}: peak {peak / 1e6:.0f} MB above its "
          f"inputs ({peak / inputs:.1f} x their {inputs / 1e6:.0f} MB, limit "
          f"16), {ms:.1f} ms; first {held} outputs off the unrolled step by "
          f"{err:.1e} (limit {lim:.1e})", flush=True)
    return out


def cli_launches(argv: list) -> tuple:
    """`launch.serve.main(argv)` on the card: its tokens and the packed
    launches it made."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve as launch_serve
    before = dict(dispatch.LAUNCHES)
    out = launch_serve.main(argv + ["--full", "--device", "cuda"])
    return out, {k: v - before.get(k, 0) for k, v in dispatch.LAUNCHES.items()}


def hybrid_audio_phase(report: dict, card: str) -> tuple:
    """zamba2-1.2b and whisper-base at full width (ternary with channel
    scales, bf16, random weights from a seed, moved off init): the kernels
    at their new shapes, the trees' bytes, packed against dequantized
    logits, zamba2's SSD scan over a long prompt; then, counted apart,
    zamba2's lockstep run, engine and CLI, and whisper's lockstep run (with
    the encoder's share of a prefill), CLI and the engine's refusal.
    Returns the launches of the hybrid and of the audio runs."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.recurrent import TransformerRuntime

    out = {"card": card, "zamba2": {}, "whisper": {}}
    z, w = out["zamba2"], out["whisper"]
    t_phase = time.perf_counter()

    def secs(t):
        torch.cuda.synchronize()
        return round(time.perf_counter() - t, 1)

    # zamba2-1.2b: build, kernels (Win's N = 8384 is 65 full 128-column
    # GEMM tiles and one of 64), bytes, logits on one repeat, the SSD scan
    t0 = time.perf_counter()
    zcfg = pool_config("zamba2-1.2b")
    zpacked = pool_build(zcfg, off=HYBRID_OFF)
    zrt = TransformerRuntime(zcfg, zpacked, device="cuda")
    z["bytes"] = pool_bytes("zamba2-1.2b", zpacked, zrt)
    z["build_s"] = secs(t0)
    t0 = time.perf_counter()
    z["kernel_rows"] = layer_kernel_rows("zamba2", zpacked, [
        ("mixer", "Win", (1, 4, 8, 512)), ("mixer", "Wout", (1, 4, 8, 512))]
    ) + layer_kernel_rows("zamba2-shared", zpacked, [
        ("attn", "Wq", (1, 4, 8, 512)), ("mlp", "Wgate", (1, 4, 8, 512)),
        ("mlp", "Wdown", (1, 4, 8, 512))], stack=zpacked["shared"])
    cut = pool_config("zamba2-1.2b", n_layers=zcfg.attn_every)
    z["packed_vs_dequantized"] = packed_vs_dequantized(
        "zamba2", cut, pool_build(cut, off=HYBRID_OFF))
    z["ssd_long_prompt"] = ssd_long_prompt(zcfg)
    z["checks_s"] = secs(t0)

    # ---- the counted hybrid run starts here ----
    dispatch.reset_counts()
    t0 = time.perf_counter()
    z["lockstep"] = pool_lockstep("zamba2", zrt, 4, 128, 32, attn_proj=0)
    z["lockstep_s"] = secs(t0)
    # the engine on a cut of ZAMBA2_ENGINE_LAYERS mamba layers (one shared
    # application): a host-bound decode step at 38 layers is 100 ms
    t0 = time.perf_counter()
    ecut = pool_config("zamba2-1.2b", n_layers=ZAMBA2_ENGINE_LAYERS)
    z["engine"] = pool_engine("zamba2", TransformerRuntime(
        ecut, pool_build(ecut, off=HYBRID_OFF), device="cuda"))
    z["engine"]["layers"] = ZAMBA2_ENGINE_LAYERS
    z["engine_s"] = secs(t0)
    toks, z["cli_launches"] = cli_launches(
        ["--arch", "zamba2-1.2b", "--batch", "4", "--prompt-len", "32",
         "--gen", "8"])
    if toks.shape != (4, 8) or not packed_launches(z["cli_launches"]):
        fail(f"zamba2 CLI: tokens {toks.shape}, launches {z['cli_launches']}")
    hybrid, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN_CALLS)
    # ---- the counted hybrid run ends here ----
    del zrt, zpacked
    torch.cuda.empty_cache()

    # whisper-base: build, kernels (K = 512 is 32 code rows; the decoder's
    # prefill meets the GEMM at M = 4 x 32 rows, the encoder's projections
    # and the cross K/V at M = 4 x 1500), bytes, logits
    t0 = time.perf_counter()
    wcfg = pool_config("whisper-base")
    wpacked = pool_build(wcfg, off=AUDIO_OFF)
    frames = torch.randn((4, WHISPER_FRAMES, wcfg.d_model),
                         generator=torch.Generator("cuda").manual_seed(6),
                         device="cuda")
    wrt = TransformerRuntime(wcfg, wpacked, extras={"enc_frames": frames},
                             device="cuda")
    w["bytes"] = pool_bytes("whisper-base", wpacked, wrt)
    w["build_s"] = secs(t0)
    t0 = time.perf_counter()
    M_enc = 4 * WHISPER_FRAMES
    w["kernel_rows"] = layer_kernel_rows("whisper", wpacked, [
        ("attn", "Wq", (1, 4, 8, 128)), ("mlp", "Wfc1", (1, 4, 8, 128)),
        ("mlp", "Wfc2", (1, 4, 8, 128))]) + layer_kernel_rows(
        "whisper-enc", wpacked, [("attn", "Wq", (M_enc,)),
                                 ("mlp", "Wfc1", (M_enc,)),
                                 ("mlp", "Wfc2", (M_enc,))],
        stack=wpacked["enc"]["stack"])
    w["packed_vs_dequantized"] = packed_vs_dequantized(
        "whisper", wcfg, wpacked, extras={"enc_frames": frames})
    w["checks_s"] = secs(t0)

    # ---- the counted audio run starts here ----
    dispatch.reset_counts()
    t0 = time.perf_counter()
    w["lockstep"] = pool_lockstep("whisper", wrt, 4, 32, 32, attn_proj=0)
    w["lockstep_s"] = secs(t0)
    toks, w["cli_launches"] = cli_launches(
        ["--arch", "whisper-base", "--batch", "4", "--prompt-len", "32",
         "--gen", "8"])
    if toks.shape != (4, 8) or not packed_launches(w["cli_launches"]):
        fail(f"whisper CLI: tokens {toks.shape}, launches {w['cli_launches']}")
    audio = dict(dispatch.LAUNCHES)
    plain.update(dispatch.PLAIN_CALLS)
    # ---- the counted audio run ends here ----
    # the encoder's share of a prefill, timed outside the counted run: it
    # calls the encoder directly, not through the entry points
    enc = lambda: T._run_encoder(wrt.served, frames, wcfg)
    enc()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    enc()
    torch.cuda.synchronize()
    host = time.perf_counter() - t1
    by_name, wall = device_profile(enc)
    busy, _ = busy_idle(by_name, wall, 1)
    pre = w["lockstep"]["profile"]["prefill"]
    share = (None if busy is None or pre["device_busy_us"] is None
             else busy / pre["device_busy_us"])
    w["encoder"] = {"host_us": host * 1e6, "device_busy_us": busy,
                    "share_of_prefill_host": host * 1e6 / pre["host_us"],
                    "share_of_prefill_device": share}
    print(f"    encoder ({WHISPER_FRAMES} frames x 4): host {host * 1e3:.1f} "
          f"ms, device busy {num(busy, '.2f', 1e3)} ms: "
          f"{w['encoder']['share_of_prefill_host']:.2f} of the prefill's host"
          f" time, {num(share, '.2f')} of its device time", flush=True)
    try:
        ServeEngine(wrt, wcfg.vocab, slots=4, max_context=64)
        fail("whisper: the engine took a runtime with extras")
    except NotImplementedError as e:
        if "per-request source encodings" not in str(e):
            fail(f"whisper: the engine refused with {e}")
    print("  whisper engine refused, as JAX's: a runtime with a "
          "cross-attention source", flush=True)
    del wrt, wpacked
    torch.cuda.empty_cache()

    for label, launches in (("hybrid", hybrid), ("audio", audio)):
        for k in ("packed_gemv", "packed_matmul"):
            if not launches.get(k):
                fail(f"kernel {k} was never launched on the {label} path")
    if plain:
        fail(f"plain versions ran on the hybrid or audio path: {plain}")
    out["hybrid_launches"], out["audio_launches"] = hybrid, audio
    out["wall_s"] = secs(t_phase)
    report["hybrid_audio"] = out
    print(f"  hybrid/audio phase: {out['wall_s']} s on {card} (zamba2 build "
          f"{z['build_s']} s, checks {z['checks_s']} s, lockstep "
          f"{z['lockstep_s']} s, engine {z['engine_s']} s; whisper build "
          f"{w['build_s']} s, checks {w['checks_s']} s, lockstep "
          f"{w['lockstep_s']} s); hybrid launches {hybrid}, audio launches "
          f"{audio}", flush=True)
    return hybrid, audio


# ---------------------------------------------------------------------------
# phase 12: training the transformer pool
# ---------------------------------------------------------------------------

POOL_TRAIN_ARGS = ["--arch", "qwen3-0.6b", "--batch", "8", "--seq", "512",
                   "--steps", "20", "--log-every", "1", "--device", "cuda"]
POOL_TRAIN_KILL = 10
# the same run on data it can learn: an order-2 Markov chain over 64
# symbols (`markov_bytes`) written as a byte file and read by --data
POOL_MARKOV_ARGS = ["--arch", "qwen3-0.6b", "--batch", "8", "--seq", "512",
                    "--steps", "20", "--warmup", "2", "--log-every", "1",
                    "--device", "cuda"]
# the pool's other families, three steps each at their reduced size
REDUCED_TRAIN = ("gemma3-27b", "mixtral-8x7b", "qwen3-moe-30b-a3b",
                 "rwkv6-7b", "zamba2-1.2b", "whisper-base",
                 "llama-3.2-vision-90b")
# leaves whose init (0 or 1) would hide a gradient, moved off it
TRAIN_OFF = ("xgate", "bfc1", "bfc2", "lora_B", "wB", "u", "conv_b")


def pool_train_leg(tag: str, ckpt_dir: Path, kill_at: int | None = None
                   ) -> dict:
    """`python -m repro_torch.launch.train` on POOL_TRAIN_ARGS as a child
    process (`launch.train._run_leg`: a real SIGTERM at `kill_at`, exit
    43), resuming from `ckpt_dir`: {step: (loss, host ms)} from its log
    lines."""
    from repro_torch.launch import train as launch_train
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           *POOL_TRAIN_ARGS, "--ckpt-dir", str(ckpt_dir), "--ckpt-every",
           "1000", "--resume", "auto"]
    lines: list = []
    launch_train._run_leg(cmd, tag, kill_at_step=kill_at, lines=lines)
    return leg_log(lines)


def leg_log(lines: list) -> dict:
    """{step: (loss, host ms)} from a training leg's log lines."""
    pat = re.compile(r"^step\s+(\d+) loss (\S+) .* (\d+) ms$")
    return {int(m.group(1)): (float(m.group(2)), float(m.group(3)))
            for m in (pat.match(l.strip()) for l in lines) if m}


def pool_markov_leg(path: Path) -> dict:
    """`launch.train` on POOL_MARKOV_ARGS with `--data path` (no
    checkpoint): {step: (loss, host ms)}."""
    from repro_torch.launch import train as launch_train
    lines: list = []
    launch_train._run_leg([sys.executable, "-m", "repro_torch.launch.train",
                           *POOL_MARKOV_ARGS, "--data", str(path)],
                          "train-markov", lines=lines)
    return leg_log(lines)


def reduced_train_check(arch: str) -> dict:
    """One reduced arch (fp32), its leaves moved off init: the card's
    step-0 gradients, leaf by leaf, and its loss and gradient norm against
    the CPU's on the same state, batch and injected noise, within 1e-4
    relative (L2 for a leaf; a leaf the CPU gives no gradient gets none;
    fp32 sums in other orders; the MoE's gather backward is a scatter-add
    of its own order on the card); then two more steps on the card,
    drawing their own noise, their losses finite."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import qlinear as QL
    from repro_torch.core.qtensor import tree_leaves, tree_paths, tree_to
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    cfg = get_config(arch).reduced()
    g = torch.Generator().manual_seed(0)
    params = T.model_init(g, cfg)
    for path, leaf in tree_paths(params):
        name = path[-1]
        if (name in TRAIN_OFF or "norm" in name or name.startswith("s")
                or name.startswith("ln")):
            leaf.add_(0.2 * torch.randn(leaf.shape, generator=g))
    pol, draw = cfg.quant.policy(), QL.step_noise(1, 0)
    noise = {"/".join(p): draw("/".join(p), l) for p, l in tree_paths(params)
             if pol.matches_name(p[-1], "/".join(p), l.dim())}
    rng = np.random.default_rng(3)
    B, S = 2, 32
    n = S // 2 if cfg.family == "audio" else S
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, n)))
             for k in ("tokens", "targets")}
    if cfg.family == "audio":
        batch["enc_frames"] = torch.randn((B, S, cfg.d_model), generator=g)
    if cfg.family == "vlm":
        batch["img"] = torch.randn((B, cfg.n_img_tokens, cfg.d_model),
                                   generator=g)
    dev_params, dev_batch = tree_to(params, "cuda"), tree_to(batch, "cuda")
    grads = [TS.value_and_grad(lambda leaves: T.lm_loss(
        leaves, b, cfg, training=True, noise=noise), p)[2]
        for p, b in ((params, batch), (dev_params, dev_batch))]
    leaf_rel, bad = 0.0, []
    for (path, c), d in zip(tree_paths(grads[0]), tree_leaves(grads[1])):
        d = d.cpu()
        r = (float((d - c).norm() / c.norm()) if torch.any(c)
             else float(torch.any(d)))
        leaf_rel = max(leaf_rel, r)
        if not r <= 1e-4:
            bad.append(("/".join(path), r))
    del grads
    opt = OptConfig(lr=1e-3, warmup_steps=3, clip_norm=1.0)
    step = TS.make_train_step(cfg, opt)
    _, cpu = step(TS.train_state_init(params, opt, 1), batch, noise=noise)
    state = TS.train_state_init(dev_params, opt, 1)
    state, card = step(state, dev_batch, noise=noise)
    rel = {k: abs(float(card[k]) - float(cpu[k])) / abs(float(cpu[k]))
           for k in ("loss", "grad_norm")}
    losses = [float(card["loss"])]
    for _ in range(2):
        state, m = step(state, dev_batch)
        losses.append(float(m["loss"]))
    row = {"cpu_loss": float(cpu["loss"]), "card_loss": losses[0],
           "cpu_grad_norm": float(cpu["grad_norm"]),
           "card_grad_norm": float(card["grad_norm"]),
           "loss_rel": rel["loss"], "grad_norm_rel": rel["grad_norm"],
           "max_leaf_grad_rel": leaf_rel, "leaves_off": bad,
           "card_losses": losses}
    if not (rel["loss"] <= 1e-4 and rel["grad_norm"] <= 1e-4 and not bad
            and np.isfinite(losses).all()):
        fail(f"{arch} reduced train step, card against CPU: {row}")
    print(f"    {arch:22s} step 0 loss {losses[0]:.6f} (cpu rel "
          f"{rel['loss']:.1e}), gnorm {row['card_grad_norm']:.4f} (rel "
          f"{rel['grad_norm']:.1e}), leaf gradients within {leaf_rel:.1e}; "
          f"3 steps {[round(l, 4) for l in losses]}",
          flush=True)
    return row


def pool_training_phase(report: dict, card: str) -> None:
    """qwen3-0.6b at full width (28 layers, d 1024, d_ff 3072, vocab
    151,936, ternary, bf16 compute, remat on) trained through
    `repro_torch.launch.train` (B = 8, T = 512, 20 steps, AdamW): the loss
    falls (mean of the last 5 steps below the first 5); on the Markov
    byte file (--data), the mean of its last 5 steps more than 1 below
    ln V, where a run that only flattened its logits would stop, and
    within 0.25 of the file's unigram entropy; a SIGTERM at step 10,
    exit 43 and --resume auto end bit-equal, leaf for leaf, to the
    uninterrupted run's final checkpoint; in process, a rerun of two steps
    bit-equal, one step with remat off bit-equal to one with it on, a
    step's time, tokens/s, peak memory, device launches and idle share;
    the trained masters exported packed, their served logits against the
    dequantized tree's (relative L2 within 1e-4 in fp32); then the other
    families at their reduced size on the card against the CPU
    (`reduced_train_check`).  The path launches no kernel: JAX's training
    forward multiplies by the sampled fp weights."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from repro_torch.core.qtensor import export_packed
    from repro_torch.data.loader import to_device
    from repro_torch.data.synth import markov_bytes, token_stream
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    out = {"card": card}
    t_phase = time.perf_counter()

    def secs(t):
        torch.cuda.synchronize()
        return round(time.perf_counter() - t, 1)

    cfg = pool_config("qwen3-0.6b")
    if not cfg.remat or cfg.remat_policy != "full":
        fail(f"qwen3-0.6b trains without remat: {cfg}")
    B, S, steps = 8, 512, 20
    base = ROOT / "build" / "pool_train"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    chain = markov_bytes(200_000, vocab=64, seed=0).astype(np.uint8)
    (base / "markov.bin").write_bytes(chain.tobytes())
    freq = np.bincount(chain, minlength=64) / len(chain)
    out["markov_unigram_entropy"] = float(-(freq[freq > 0] * np.log(
        freq[freq > 0])).sum())
    try:
        # 1. the launcher: the uninterrupted run, then the Markov run,
        # beside the one that takes SIGTERM and resumes (two processes on
        # the card at once, at most: a third does not fit beside this
        # one's memory; their start-up and checkpoint writes overlap; the
        # step's own time is taken alone, in process, below)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(1) as pool:
            straight = pool.submit(lambda: (
                pool_train_leg("train-B", base / "straight"),
                pool_markov_leg(base / "markov.bin")))
            pool_train_leg("train-A", base / "interrupted",
                           kill_at=POOL_TRAIN_KILL)
            out["resumed_from"] = CK.latest_step(base / "interrupted")
            pool_train_leg("train-A-resume", base / "interrupted")
            log, mlog = straight.result()
        out["legs_s"] = secs(t0)
        if sorted(log) != list(range(steps)):
            fail(f"qwen3-0.6b training logged steps {sorted(log)}")
        losses = [log[i][0] for i in range(steps)]
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        out.update(losses=losses, host_ms=[log[i][1] for i in range(steps)],
                   first5_mean=first, last5_mean=last)
        if not (np.isfinite(losses).all() and last < first):
            fail(f"qwen3-0.6b loss did not fall: {losses}")
        if sorted(mlog) != list(range(steps)):
            fail(f"qwen3-0.6b on the Markov file logged steps {sorted(mlog)}")
        ml = [mlog[i][0] for i in range(steps)]
        floor = float(np.log(cfg.vocab))
        h1 = out["markov_unigram_entropy"]
        out["markov"] = {"losses": ml, "first5_mean": float(np.mean(ml[:5])),
                         "last5_mean": float(np.mean(ml[-5:])),
                         "ln_vocab": floor}
        if not (np.isfinite(ml).all()
                and np.mean(ml[-5:]) < min(floor - 1.0, h1 + 0.25)):
            fail(f"qwen3-0.6b on the Markov file: the last 5 steps' mean "
                 f"loss is not below ln V - 1 = {floor - 1.0:.4f} and "
                 f"within 0.25 of the unigram entropy {h1:.4f}: {ml}")
        final = f"step_{steps:08d}"
        out["resume_bit_equal"] = launch_train._ckpt_bit_equal(
            base / "interrupted" / final, base / "straight" / final)
        print(f"  qwen3-0.6b B={B}, T={S}: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} (first 5 {first:.4f}, last 5 {last:.4f}); "
              f"SIGTERM at step {POOL_TRAIN_KILL}, resumed from step "
              f"{out['resumed_from']}: final checkpoint bit-equal "
              f"{out['resume_bit_equal']}; on the Markov file (64 symbols, "
              f"unigram entropy {out['markov_unigram_entropy']:.4f}): "
              f"{ml[0]:.4f} -> {ml[-1]:.4f} (last 5 "
              f"{out['markov']['last5_mean']:.4f}, ln V {floor:.4f})",
              flush=True)
        if not out["resume_bit_equal"]:
            fail("qwen3-0.6b: the resumed run diverged from the "
                 "uninterrupted one")

        # 2. in process: the rerun, remat off, a step's cost
        t0 = time.perf_counter()
        opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, decay_steps=steps,
                            clip_norm=1.0)
        state0 = TS.train_state_init(
            T.model_init(torch.Generator("cuda").manual_seed(0), cfg),
            opt_cfg, 1)
        batch = to_device(token_stream(0, B, S, cfg.vocab, seed=0), "cuda")
        step = TS.make_train_step(cfg, opt_cfg)
        runs = []
        for _ in range(2):
            st = state0
            for _ in range(2):
                st, m = step(st, batch)
            runs.append(st)
        out["rerun_bit_equal"] = (bit_equal(runs[0].params, runs[1].params)
                                  and bit_equal(runs[0].opt, runs[1].opt))
        del runs, st
        on, m_on = step(state0, batch)
        off, m_off = TS.make_train_step(dataclasses.replace(cfg, remat=False),
                                        opt_cfg)(state0, batch)
        out["remat_off_bit_equal"] = (
            bit_equal(on.params, off.params) and bit_equal(on.opt, off.opt)
            and float(m_on["loss"]) == float(m_off["loss"]))
        del on, off
        print(f"  rerun of 2 steps bit-equal {out['rerun_bit_equal']}; "
              f"remat off == on {out['remat_off_bit_equal']} (loss "
              f"{float(m_on['loss']):.6f})", flush=True)
        if not (out["rerun_bit_equal"] and out["remat_off_bit_equal"]):
            fail("qwen3-0.6b training is not bit-reproducible")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            step(state0, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        peak = torch.cuda.max_memory_allocated()
        counts: dict = {}
        by_name, wall = device_profile(lambda: step(state0, batch), 1,
                                       counts=counts)
        busy, idle = busy_idle(by_name, wall, 1)
        step_s = sorted(walls)[1]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        out["step"] = {"host_ms": step_s * 1e3, "tok_s": B * S / step_s,
                       "peak_gb": peak / 1e9, "profiled_wall_ms": wall * 1e3,
                       "device_busy_ms": None if busy is None else busy / 1e3,
                       "idle_share": idle,
                       "device_launches": (sum(counts.values()) if counts
                                           else None),
                       "top": [(k[:48], v) for k, v in top]}
        print(f"  a step: {step_s * 1e3:.1f} ms ({B * S / step_s:.0f} tok/s), "
              f"peak {peak / 1e9:.2f} GB allocated; profiled "
              f"{wall * 1e3:.1f} ms, device busy {num(busy, '.1f', 1e3)} ms, "
              f"idle {num(idle, '.3f')}, "
              f"{num(out['step']['device_launches'], 'd')} device launches; "
              f"top " + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in top),
              flush=True)
        out["in_process_s"] = secs(t0)

        # 3. the trained masters, exported packed and served
        t0 = time.perf_counter()
        trained = CK.restore(state0, base / "straight", steps)
        del state0
        out["trained_packed_vs_dequantized"] = packed_vs_dequantized(
            "qwen3-0.6b trained", cfg, export_packed(trained.params,
                                                     cfg.quant))
        del trained
        torch.cuda.empty_cache()
        out["export_s"] = secs(t0)
    finally:
        shutil.rmtree(base, ignore_errors=True)

    # 4. the other families, reduced, card against CPU
    t0 = time.perf_counter()
    print("  reduced families, 3 steps each on the card:", flush=True)
    out["reduced"] = {arch: reduced_train_check(arch)
                      for arch in REDUCED_TRAIN}
    out["reduced_s"] = secs(t0)
    out["wall_s"] = secs(t_phase)
    report["pool_training"] = out
    print(f"  pool training phase: {out['wall_s']} s on {card} (the "
          f"launcher's legs {out['legs_s']} s, in process "
          f"{out['in_process_s']} s, export {out['export_s']} s, reduced "
          f"families {out['reduced_s']} s)", flush=True)


# ---------------------------------------------------------------------------
# phase 13: the VLM at full width
# ---------------------------------------------------------------------------

# the leaves moved off init beside the channel scales, and their shifts:
# at init tanh(xgate) = 0 and the cross layers would add nothing
VLM_OFF = {"xgate": 0.5, "norm1": 0.0, "norm2": 0.0, "final_norm": 0.0}


def vlm_phase(report: dict, card: str) -> dict:
    """llama-3.2-vision-90b at full width (100 layers: 4 self layers, then
    a cross layer over 1600 image tokens, in each repeat; d 8192, 64/8
    heads of 128, d_ff 28,672, vocab 128,256; ternary with channel scales,
    bf16, random weights from a seed, xgate and norms moved off init, the
    image tokens a normal draw): packed against dequantized logits on one
    repeat; the tree drawn a layer at a time (`model_init(packed=True)`),
    its bytes and peak memory; the GEMV at 1, 4 and 8 rows and the GEMM at
    M = 512 on layer 0's Wq, Wk, Wgate and Wdown, and the GEMM at M = 6400
    (4 x 1600 image tokens) on the cross layer's Wk; then, counted,
    lockstep B = 4, prompt 128, gen 32 with a decode step and a prefill
    profiled, and
    `launch.serve --arch llama-3.2-vision-90b` at the same B = 4 x 128 +
    32; the engine's refusal of a runtime with extras.  Returns the
    launches of the counted runs."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.recurrent import TransformerRuntime

    arch = "llama-3.2-vision-90b"
    out = {"card": card}
    t_phase = time.perf_counter()

    def secs(t):
        torch.cuda.synchronize()
        return round(time.perf_counter() - t, 1)

    cfg = pool_config(arch)
    img = torch.randn((4, cfg.n_img_tokens, cfg.d_model),
                      generator=torch.Generator("cuda").manual_seed(7),
                      device="cuda")
    t0 = time.perf_counter()
    cut = pool_config(arch, n_layers=len(cfg.block_pattern))
    out["packed_vs_dequantized"] = packed_vs_dequantized(
        "vlm", cut, pool_build(cut, off=VLM_OFF), extras={"img": img})
    torch.cuda.empty_cache()
    out["repeat_check_s"] = secs(t0)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    packed = pool_build(cfg, off=VLM_OFF)
    rt = TransformerRuntime(cfg, packed, extras={"img": img}, device="cuda")
    torch.cuda.synchronize()
    out["build_s"] = secs(t0)
    out["build_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  {arch} built a layer at a time in {out['build_s']} s (peak "
          f"{out['build_peak_gb']:.1f} GB allocated, the served tree "
          f"included)", flush=True)
    out["bytes"] = pool_bytes(arch, packed, rt)
    t0 = time.perf_counter()
    out["kernel_rows"] = layer_kernel_rows("vlm", packed, [
        ("attn", "Wq", (1, 4, 8, 512)), ("attn", "Wk", (1, 4, 8, 512)),
        ("mlp", "Wgate", (1, 4, 8, 512)),
        ("mlp", "Wdown", (1, 4, 8, 512))]) + layer_kernel_rows(
        "vlm-cross", packed, [("attn", "Wk", (4 * cfg.n_img_tokens,))],
        stack=packed["stack"][len(cfg.block_pattern) - 1])
    out["kernels_s"] = secs(t0)

    # ---- the counted vlm run starts here ----
    dispatch.reset_counts()
    t0 = time.perf_counter()
    out["lockstep"] = pool_lockstep("vlm", rt, 4, 128, 32, attn_proj=0)
    out["lockstep_s"] = secs(t0)
    try:
        ServeEngine(rt, cfg.vocab, slots=4, max_context=256)
        fail("vlm: the engine took a runtime with extras")
    except NotImplementedError as e:
        if "per-request source encodings" not in str(e):
            fail(f"vlm: the engine refused with {e}")
    print("  vlm engine refused, as JAX's: a runtime with a cross-attention "
          "source", flush=True)
    del rt, packed
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    toks, out["cli_launches"] = cli_launches(
        ["--arch", arch, "--batch", "4", "--prompt-len", "32", "--gen",
         "8"])
    if toks.shape != (4, 8) or not packed_launches(out["cli_launches"]):
        fail(f"vlm CLI: tokens {toks.shape}, launches {out['cli_launches']}")
    out["cli_s"] = secs(t0)
    vlm, plain = dict(dispatch.LAUNCHES), dict(dispatch.PLAIN_CALLS)
    # ---- the counted vlm run ends here ----
    torch.cuda.empty_cache()
    for k in ("packed_gemv", "packed_matmul"):
        if not vlm.get(k):
            fail(f"kernel {k} was never launched on the vlm path")
    if plain:
        fail(f"plain versions ran on the vlm path: {plain}")
    out["vlm_launches"] = vlm
    out["wall_s"] = secs(t_phase)
    report["vlm"] = out
    print(f"  vlm phase: {out['wall_s']} s on {card} (one repeat "
          f"{out['repeat_check_s']} s, build {out['build_s']} s, kernels "
          f"{out['kernels_s']} s, lockstep {out['lockstep_s']} s, CLI "
          f"{out['cli_s']} s); launches {vlm}", flush=True)
    return vlm


# ---------------------------------------------------------------------------
# phase 14: compressed data parallelism
# ---------------------------------------------------------------------------

COMPRESS_PIPELINE_ARGS = ["--pipeline", "--quick", "--compress-grads",
                          "--arch", "rnn-paper", "--steps",
                          str(PIPELINE_STEPS), "--batch", "32", "--seq",
                          "100", "--device", "cuda"]
CARD_CPU_REL = 1e-5  # card against CPU, a compressed step's state leaves


def rel_l2(got, want) -> float:
    """Relative L2 distance of `got` from `want` (both tensors), in fp64."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def compression_cost(mesh, grads, state, step_fn, batch) -> dict:
    """Device time of one compressed step (torch.profiler: busy, idle
    share) and of its compression alone (`compress_tree` with the step's
    own draw, then the mean over the data axes) on the same gradients, and
    the compression's share of the step's busy time."""
    from repro_torch.train import compress as C
    from repro_torch.train import train_step as TS

    def compress():
        TS.mean_trees(mesh, *C.compress_tree(
            grads, C.step_noise(grads, 1, 0, 0), state.residual))

    compress()
    step_fn(state, batch)
    by_step, wall_step = device_profile(lambda: step_fn(state, batch), 1)
    by_comp, wall_comp = device_profile(compress, 1)
    busy, idle = busy_idle(by_step, wall_step, 1)
    cbusy, _ = busy_idle(by_comp, wall_comp, 1)
    top = sorted(by_comp.items(), key=lambda kv: -kv[1])[:4]
    return {"step_profiled_wall_ms": wall_step * 1e3,
            "step_device_busy_ms": None if busy is None else busy / 1e3,
            "step_idle_share": idle,
            "compress_wall_ms": wall_comp * 1e3,
            "compress_device_ms": None if cbusy is None else cbusy / 1e3,
            "compress_share": (None if busy is None or cbusy is None
                               else cbusy / busy),
            "compress_top": [(k[:48], v) for k, v in top]}


def print_cost(label: str, c: dict) -> None:
    print(f"  {label}: a compressed step profiled "
          f"{c['step_profiled_wall_ms']:.1f} ms, device busy {num(c['step_device_busy_ms'], '.2f')} ms, idle "
          f"{num(c['step_idle_share'], '.3f')}; the compression and the mean "
          f"alone {num(c['compress_device_ms'], '.2f')} ms of device time "
          f"({c['compress_wall_ms']:.1f} ms wall), "
          f"{num(c['compress_share'], '.3f')} of the step's; top "
          + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in c["compress_top"]),
          flush=True)


def in_turns(fns: dict, reps: int = 5) -> dict:
    """Median host ms a call of each of `fns` (synchronized), timed in
    turns: a b b a, `reps` calls each time."""
    import torch
    order = list(fns) + list(fns)[::-1]
    got: dict = {k: [] for k in fns}
    for k in order:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            got[k].append((time.perf_counter() - t0) * 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in got.items()}


def card_against_cpu(kind: str) -> dict:
    """One reduced compressed step, the model noise and the compression
    draws injected, over a data mesh of one rank: on the CPU (gloo), then
    on the card (NCCL); params, residual and BN state held within
    CARD_CPU_REL relative L2 a leaf.  Each side makes its group and
    destroys it."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config, get_rnn_config, rnn_paper
    from repro_torch.core import bnlstm as BL
    from repro_torch.core import qlinear as QL
    from repro_torch.core.qtensor import tree_paths, tree_to
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.train import compress as C
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    opt = OptConfig(lr=1e-3, warmup_steps=20, clip_norm=1.0)
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(5)
    if kind == "rnn":
        cfg = rnn_paper.reduced(get_rnn_config("rnn-paper"))
        var = BL.rnn_lm_init(g, cfg, device="cpu")
        state = TS.train_state_init(var["params"], opt, 1,
                                    bn_state=var["state"], compress=True)
        noise = TS.step_noise(state)
        make, B, S = TS.make_rnn_train_step, 8, 32
    else:
        cfg = get_config("qwen3-0.6b").reduced()
        state = TS.train_state_init(T.model_init(g, cfg), opt, 1,
                                    compress=True)
        pol, draw = cfg.quant.policy(), QL.step_noise(1, 0)
        noise = {"/".join(p): draw("/".join(p), l)
                 for p, l in tree_paths(state.params)
                 if pol.matches_name(p[-1], "/".join(p), l.dim())}
        make, B, S = TS.make_train_step, 2, 32
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])}
    comp = list(C.step_noise(state.params, 1, 0, 0))
    out = {}
    for dev in ("cpu", "cuda"):
        mesh = M.make_host_mesh(device=dev)
        st, m = make(cfg, opt, mesh=mesh, compress_grads=True)(
            tree_to(state, dev), tree_to(batch, dev),
            noise=tree_to(noise, dev), comp_noise=tree_to(comp, dev))
        out[dev] = (st, float(m["loss"]))
        dist.destroy_process_group()
    (cpu, cpu_loss), (card, card_loss) = out["cpu"], out["cuda"]
    worst = {}
    for f in ("params", "residual", "bn_state"):
        for (path, a), (_, b) in zip(tree_paths(getattr(card, f)),
                                     tree_paths(getattr(cpu, f))):
            worst[f] = max(worst.get(f, 0.0), rel_l2(a, b))
    row = {"cpu_loss": cpu_loss, "card_loss": card_loss,
           "loss_rel": abs(card_loss - cpu_loss) / abs(cpu_loss),
           "worst_rel": worst,
           "residual_abs_sum": float(sum(
               x.abs().sum() for _, x in tree_paths(card.residual)))}
    if not (all(v <= CARD_CPU_REL for v in worst.values())
            and row["loss_rel"] <= CARD_CPU_REL
            and row["residual_abs_sum"] > 0):
        fail(f"compressed {kind} step, card against CPU: {row}")
    print(f"  card against CPU, one compressed {kind} step (reduced): loss "
          f"{card_loss:.6f} (rel {row['loss_rel']:.1e}); worst leaf "
          + ", ".join(f"{k} {v:.1e}" for k, v in worst.items())
          + f" (limit {CARD_CPU_REL:g})", flush=True)
    return row


def compressed_dp_phase(report: dict, card: str) -> dict:
    """Compressed data parallelism on one card (an NCCL group of one
    rank): `launch.train --pipeline --quick --compress-grads` at rnn-paper's
    full width (20 steps a leg, B = 32, T = 100): SIGTERM, exit 43 and the
    resume, both legs' final checkpoints bit-equal with their residual, the
    residual non-zero and finite, the export served through the engine byte
    for byte like drive_session(B=1), the accept rate; launches counted
    across it (the engine's fused tick and GEMV must launch).  Then, in
    process, the gradient compression's bytes, a compressed step against
    an uncompressed one (timed in turns) and the compression's device time
    a step; qwen3-0.6b at full width, 3 compressed steps at B = 8, T = 512
    through `make_train_step(mesh=make_host_mesh(), compress_grads=True)`
    (finite loss, non-zero residual, a step's ms, idle share, peak memory
    against phase 12's); and a reduced compressed RNN step and pool step,
    card against CPU.  Returns the counted launches."""
    import shutil

    import torch
    import torch.distributed as dist
    from repro_torch.core import bnlstm as BL
    from repro_torch.core import qlinear as QL
    from repro_torch.core.qtensor import tree_leaves
    from repro_torch.data.loader import to_device
    from repro_torch.data.synth import token_stream
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.train import compress as C
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    out = {"card": card}
    t_phase = time.perf_counter()

    def secs(t):
        torch.cuda.synchronize()
        return round(time.perf_counter() - t, 1)

    # 1. the rnn-paper pipeline with --compress-grads
    base = ROOT / "build" / "compress_pipeline"
    shutil.rmtree(base, ignore_errors=True)
    argv = COMPRESS_PIPELINE_ARGS + ["--ckpt-dir", str(base),
                                     "--results-dir", str(base / "results")]
    dispatch.reset_counts()   # ---- the counted compressed run starts here
    t0 = time.perf_counter()
    train, serve, spec = launch_train.main(argv)
    launches = dict(dispatch.LAUNCHES)
    # ---- the counted compressed run ends here
    for k, v in train["child_launches"].items():
        launches[k] = launches.get(k, 0) + v
    out["pipeline_s"] = secs(t0)
    if dispatch.PLAIN_CALLS:
        fail(f"plain versions ran in the compressed pipeline: "
             f"{dict(dispatch.PLAIN_CALLS)}")
    res = train.get("residual_abs_sum")
    if not (train["resume_bit_exact"] and train["restart_exit_code"] == 43
            and serve["engine_byte_parity"] and spec["greedy_equal_plain"]
            and res is not None and 0 < res < float("inf")):
        fail(f"compressed pipeline rows {train} {serve} {spec}")
    keys = json.loads((base / "straight" / f"step_{PIPELINE_STEPS:08d}" /
                       "manifest.json").read_text())["leaves"]
    if not any(k.startswith("residual.") for k in keys):
        fail("the compressed pipeline's checkpoint holds no residual")
    for k in ("packed_gemv", "fused_tick"):
        if not launches.get(k):
            fail(f"kernel {k} was never launched in the compressed "
                 f"pipeline: {launches}")
    out.update(rows=[train, serve, spec], launches=launches)
    print(f"  compressed pipeline: SIGTERM at step {train['sigterm_at_step']}"
          f", exit 43, resumed from {train['resumed_from_step']}; "
          f"checkpoints bit-equal, residual included (|r| summed "
          f"{res:.4f}); final val BPC {train['final_val_bpc']:.4f} "
          f"(phase 8, uncompressed: "
          f"{report['pipeline']['rows'][0]['final_val_bpc']:.4f}); engine "
          f"streams == drive_session(B=1); accept rate "
          f"{spec['accept_rate']:.3f}; {out['pipeline_s']} s; launches "
          f"{launches}", flush=True)
    shutil.rmtree(base, ignore_errors=True)

    # 2. card against CPU (each side in its own group)
    t0 = time.perf_counter()
    out["card_vs_cpu"] = {k: card_against_cpu(k) for k in ("rnn", "pool")}
    out["card_vs_cpu_s"] = secs(t0)

    # 3. rnn-paper at full width in process: bytes, cost, share
    t0 = time.perf_counter()
    mesh = M.make_host_mesh(device="cuda")
    args = launch_train.build_argparser().parse_args(TRAIN_ARGS)
    corpus = launch_train.rnn_corpus(args)
    cfg = launch_train.rnn_cfg(args, corpus)
    opt = launch_train.opt_config(args)
    var = BL.rnn_lm_init(torch.Generator().manual_seed(args.seed), cfg,
                         device="cuda")
    batch = to_device(corpus.batch("train", 0, args.batch, args.seq), "cuda")
    plain_fn = TS.make_rnn_train_step(cfg, opt)
    comp_fn = TS.make_rnn_train_step(cfg, opt, mesh=mesh,
                                     compress_grads=True)
    plain_st = TS.train_state_init(var["params"], opt, 1,
                                   bn_state=var["state"])
    comp_st = TS.train_state_init(var["params"], opt, 1,
                                  bn_state=var["state"], compress=True)
    full, packed = C.compressed_bytes(var["params"])
    ms = in_turns({"plain": lambda: plain_fn(plain_st, batch),
                   "compressed": lambda: comp_fn(comp_st, batch)})
    grads = TS.loss_and_grads(comp_st.params, comp_st.bn_state, batch, cfg,
                              TS.step_noise(comp_st))[2]
    cost = compression_cost(mesh, grads, comp_st, comp_fn, batch)
    out["rnn"] = {"fp32_bytes": full, "code_bytes": packed,
                  "ratio": full / packed, "step_ms": ms, **cost,
                  "phase7_profiled_step_us":
                      report["training"]["profile_step"]["wall_us"]}
    print(f"  rnn-paper (H = {cfg.d_hidden}, B = {args.batch}, T = "
          f"{args.seq}): the mean moves {full / 1e6:.3f} MB of fp32 a step, "
          f"{packed / 1e6:.3f} MB as 2-bit codes ({full / packed:.1f}x); a "
          f"step {ms['compressed']:.1f} ms compressed against "
          f"{ms['plain']:.1f} ms plain (in turns; phase 7's profiled step "
          f"{out['rnn']['phase7_profiled_step_us'] / 1e3:.1f} ms)",
          flush=True)
    print_cost("rnn-paper", cost)
    del grads, plain_st, comp_st
    out["rnn_s"] = secs(t0)

    # 4. qwen3-0.6b at full width: 3 compressed steps
    t0 = time.perf_counter()
    qcfg = pool_config("qwen3-0.6b")
    qopt = OptConfig(lr=1e-3, warmup_steps=20, decay_steps=20, clip_norm=1.0)
    state = TS.train_state_init(
        T.model_init(torch.Generator("cuda").manual_seed(0), qcfg), qopt, 1,
        compress=True)
    step = TS.make_train_step(qcfg, qopt, mesh=mesh, compress_grads=True)
    qbatch = to_device(token_stream(0, 8, 512, qcfg.vocab, seed=0), "cuda")
    full, packed = C.compressed_bytes(state.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(3):
        t1 = time.perf_counter()
        state, m = step(state, qbatch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    res = float(sum(x.abs().sum() for x in tree_leaves(state.residual)))
    if not (all(l == l and abs(l) < 1e9 for l in losses) and 0 < res
            < float("inf")):
        fail(f"qwen3-0.6b compressed steps: losses {losses}, |residual| {res}")
    plain_state = TS.train_state_init(state.params, qopt, 1)
    plain = TS.make_train_step(qcfg, qopt)
    ms = in_turns({"plain": lambda: plain(plain_state, qbatch),
                   "compressed": lambda: step(state, qbatch)}, reps=2)
    del plain_state
    loss_fn = lambda leaves: T.lm_loss(
        leaves, qbatch, qcfg, training=True,
        noise=QL.step_noise(1, int(state.opt.step)))
    grads = TS.value_and_grad(loss_fn, state.params)[2]
    cost = compression_cost(mesh, grads, state, step, qbatch)
    del grads
    phase12 = report["pool_training"]["step"]
    out["qwen3"] = {"losses": losses, "step_ms": walls, "in_turns_ms": ms,
                    "residual_abs_sum": res, "peak_gb": peak,
                    "phase12_peak_gb": phase12["peak_gb"],
                    "phase12_step_ms": phase12["host_ms"],
                    "fp32_bytes": full, "code_bytes": packed, **cost}
    print(f"  qwen3-0.6b (28 layers, B = 8, T = 512): 3 compressed steps, "
          f"loss {[round(l, 4) for l in losses]}, {walls[-1]:.1f} ms a "
          f"step (the first {walls[0]:.1f}); in turns {ms['compressed']:.1f}"
          f" ms compressed against {ms['plain']:.1f} ms plain (phase 12's "
          f"plain step {phase12['host_ms']:.1f} ms); peak {peak:.2f} GB "
          f"against "
          f"phase 12's {phase12['peak_gb']:.2f} GB; the mean moves "
          f"{full / 1e9:.3f} GB of fp32 a step, {packed / 1e9:.3f} GB as "
          f"2-bit codes ({full / packed:.1f}x); |residual| summed {res:.2f}",
          flush=True)
    print_cost("qwen3-0.6b", cost)
    del state, step
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["qwen3_s"] = secs(t0)
    out["wall_s"] = secs(t_phase)
    report["compressed_dp"] = out
    print(f"  compressed DP phase: {out['wall_s']} s on {card} (pipeline "
          f"{out['pipeline_s']} s, card against CPU {out['card_vs_cpu_s']} "
          f"s, rnn-paper {out['rnn_s']} s, qwen3-0.6b {out['qwen3_s']} s)",
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 15: the model axis and the mesh engine, at one rank
# ---------------------------------------------------------------------------

MESH_LAYERS = 8      # the mesh engine's cut of qwen3's 28 layers


def mesh_phase(report: dict, card: str) -> dict:
    """The model axis at full width over a ("data", "model") mesh of (1, 1)
    (one card: one rank, an NCCL group of one): a qwen3-0.6b bf16 training
    step through the tensor-parallel DTensor step, bit-equal to the plain
    step; the mesh engine (`make_serve_mesh("data=1")`) over an fp
    qwen3-0.6b tree on a cut of MESH_LAYERS layers, every stream equal to
    the mesh=None engine's and `tick_collectives() == 0`, then with a
    prefix cache over requests behind one shared prompt prefix (streams
    the mesh=None engine's without it, hits > 0); and the packed tree
    refused on a mesh with JAX's reason.  Launches counted."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import export_packed, tree_leaves, tree_map
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.kernels import dispatch
    from repro_torch.launch import mesh as M
    from repro_torch.launch.serve import synth_traffic
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.prefixcache import PrefixCache
    from repro_torch.serve.recurrent import TransformerRuntime
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    t0 = time.perf_counter()
    out = {}
    dispatch.reset_counts()          # ---- the counted mesh run starts here
    cfg = get_config("qwen3-0.6b")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    opt = OptConfig(lr=1e-3, warmup_steps=20, clip_norm=1.0)
    B, S = 4, 256
    rng = np.random.default_rng(15)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1))).cuda()
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    params = T.model_init(torch.Generator("cuda").manual_seed(0), cfg)
    clone = lambda t: tree_map(lambda x: x.clone(), t)
    plain_state = TS.train_state_init(clone(params), opt, 7)
    tp_state = TS.train_state_init(params, opt, 7)
    M.init_group(torch.device("cuda"))
    mesh = M.first_ranks_mesh("cuda", (1, 1), ("data", "model"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plain_state, pm = TS.make_train_step(cfg, opt)(plain_state, batch)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tp_state, tm = TS._tp_step(cfg, opt, mesh)(tp_state, batch)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    leaves = tree_leaves(tp_state.params)
    if not all(isinstance(x, DTensor) for x in leaves):
        fail("mesh: the tensor-parallel step's state is not DTensors")
    same = all(torch.equal(a.full_tensor(), b) for a, b in zip(
        leaves, tree_leaves(plain_state.params))) and all(
        torch.equal(a.full_tensor(), b) for a, b in zip(
            tree_leaves(tp_state.opt.m), tree_leaves(plain_state.opt.m)))
    if not same or float(tm["loss"]) != float(pm["loss"]):
        fail(f"mesh: the DTensor step at (1, 1) is not the plain step's bits "
             f"(loss {float(tm['loss'])} vs {float(pm['loss'])})")
    out["train"] = {"loss": float(tm["loss"]), "plain_s": t2 - t1,
                    "dtensor_s": t3 - t2, "batch": B, "seq": S}
    print(f"  qwen3-0.6b bf16 train step B={B} T={S} through the DTensor "
          f"step at (data, model) = (1, 1): params and moments bit-equal to "
          f"the plain step's, loss {float(tm['loss']):.4f}; {t2 - t1:.2f} s "
          f"plain, {t3 - t2:.2f} s DTensor (first calls; {card})",
          flush=True)
    del params, plain_state, tp_state, leaves

    # the mesh engine over an fp tree, on a cut of the layers
    ecfg = dataclasses.replace(cfg, n_layers=MESH_LAYERS).with_quant(
        QuantSpec(mode="none"))
    masters = T.model_init(torch.Generator("cuda").manual_seed(0), ecfg)
    rt = TransformerRuntime(ecfg, masters, device="cuda")
    smesh = M.make_serve_mesh("data=1", "cuda")
    P, G = 64, 16
    reqs = synth_traffic(cfg.vocab, requests=8, rate=1e3, prompt_len=P,
                         gen=G, temperature=0.8, top_k=40, seed=15)
    streams = {}
    for label, m in (("none", None), ("mesh", smesh)):
        eng = ServeEngine(rt, cfg.vocab, slots=4, max_context=P + G,
                          prefill_chunk=32, mesh=m)
        t1 = time.perf_counter()
        comps, em = eng.run([dataclasses.replace(r) for r in reqs],
                            realtime=False)
        streams[label] = {c.rid: c.tokens for c in comps}
        out[f"engine_{label}"] = dict(em, wall=time.perf_counter() - t1)
        if m is not None:
            out["tick_collectives"] = eng.tick_collectives()
            out["stats_mesh"] = eng.stats()["mesh"]
    if streams["mesh"] != streams["none"]:
        fail("mesh engine: a stream differs from the mesh=None engine's")
    if out["tick_collectives"] != 0:
        fail(f"mesh engine: a data-only tick issued "
             f"{out['tick_collectives']} collectives")
    print(f"  mesh engine, data=1 over fp qwen3 on {MESH_LAYERS} of 28 "
          f"layers, 4 slots, 8 requests: every stream == the mesh=None "
          f"engine's; tick collectives 0; {out['engine_mesh']['agg_tok_s']:.1f}"
          f" tok/s (mesh=None {out['engine_none']['agg_tok_s']:.1f})",
          flush=True)
    # the mesh engine with a prefix cache: 6 requests behind one 64-token
    # prefix (chunks of 32: its boundaries cached by the first)
    system = rng.integers(0, cfg.vocab, P)
    shared = [Request(prompt=np.concatenate([system, rng.integers(
        0, cfg.vocab, int(rng.integers(1, 9)))]), max_tokens=8,
        temperature=0.8 if i % 2 else 0.0, top_k=40, seed=150 + i, rid=i)
        for i in range(6)]
    cache = PrefixCache(1 << 30)
    for label, m, pc in (("none", None, None), ("mesh", smesh, cache)):
        eng = ServeEngine(rt, cfg.vocab, slots=4, max_context=P + G,
                          prefill_chunk=32, mesh=m, prefix_cache=pc)
        comps, _ = eng.run([dataclasses.replace(r) for r in shared[:1]],
                           realtime=False)
        more, _ = eng.run([dataclasses.replace(r) for r in shared[1:]],
                          realtime=False)
        streams[f"prefix_{label}"] = {c.rid: c.tokens for c in comps + more}
    out["prefix_cache"] = cache.stats()
    if streams["prefix_mesh"] != streams["prefix_none"]:
        fail("mesh engine with a prefix cache: a stream differs from the "
             "mesh=None engine's")
    if out["prefix_cache"]["hits"] < 1:
        fail(f"mesh engine: no prefix-cache hit ({out['prefix_cache']})")
    print(f"  mesh engine with a prefix cache, 6 requests behind a {P}-token "
          f"prefix: every stream == the mesh=None engine's (no cache); "
          f"{out['prefix_cache']['hits']} hits, "
          f"{out['prefix_cache']['hit_tokens']} tokens spliced", flush=True)
    del rt
    prt = TransformerRuntime(ecfg.with_quant(QuantSpec(mode="ternary",
                                                       norm="channel")),
                             export_packed(masters, QuantSpec(
                                 mode="ternary", norm="channel")),
                             device="cuda")
    try:
        ServeEngine(prt, cfg.vocab, slots=4, max_context=P + G, mesh=smesh)
        fail("mesh engine: a packed tree on the card was not refused")
    except NotImplementedError as e:
        if "packed CUDA kernels are single-device launches" not in str(e):
            fail(f"mesh engine: the packed refusal reads {e}")
        out["packed_refusal"] = str(e)
    launches = dict(dispatch.LAUNCHES)
    # ---- the counted mesh run ends here
    if not launches.get("ordered_bmm") or dispatch.PLAIN_CALLS:
        fail(f"mesh phase launches {launches}, plain calls "
             f"{dict(dispatch.PLAIN_CALLS)}")
    print(f"  packed tree on the mesh refused: {out['packed_refusal'][:60]}"
          f"...; launches {launches}", flush=True)
    dist.destroy_process_group()
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    report["mesh"] = out
    print(f"  mesh phase: {out['wall_s']:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 16: the dry-run's counts on the card's machine, and the one-rank
# roofline of calls phases 9 and 12 timed
# ---------------------------------------------------------------------------

# (arch, shape, mesh) of the dry-run CLI, one process each, all at once
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", "single"),
                ("qwen3-0.6b", "prefill_32k", "single"),
                ("qwen3-0.6b", "decode_32k", "single"),
                ("qwen3-moe-30b-a3b", "decode_32k", "multi"))
DRYRUN_TIMEOUT = 240
# JAX's `run_cell` on the 256-rank mesh, per rank (PERF.md section 7: its
# count on the CPU, jax 0.9): qwen3-0.6b's all-gather bytes; the port's
# may be at most GATHER_LIMIT times these
JAX_ALL_GATHER = {"train_4k": 2.9723e9, "decode_32k": 1.4312e8}
GATHER_LIMIT = 2.0


def dryrun_start() -> list:
    """Start `python -m repro_torch.launch.dryrun` on DRYRUN_CELLS, each
    in a process of its own (its fake process group must not meet phases
    14-15's NCCL group), all at once; their JSON goes to
    chiprun_out/torch_dryrun/."""
    import os
    out_dir = ROOT / "chiprun_out" / "torch_dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0],
         "--shape", cell[1], "--mesh", cell[2], "--out", str(out_dir)],
        cwd=ROOT, env=env, stdout=(out_dir / ("__".join(cell) + ".log")).open(
            "w"), stderr=subprocess.STDOUT)) for cell in DRYRUN_CELLS]


def dryrun_wait(procs: list) -> dict:
    """The started cells' JSON; a cell in error, or a process that fails
    or outlives DRYRUN_TIMEOUT, fails the run."""
    out_dir = ROOT / "chiprun_out" / "torch_dryrun"
    cells = {}
    for (arch, shape, mesh), p in procs:
        p.wait(timeout=DRYRUN_TIMEOUT)
        path = out_dir / f"{arch}__{shape}__{mesh}.json"
        cell = json.loads(path.read_text()) if path.exists() else {}
        if p.returncode != 0 or cell.get("status") != "ok":
            log = (out_dir / f"{arch}__{shape}__{mesh}.log").read_text()
            fail(f"dry-run {arch} {shape} {mesh}: exit {p.returncode}, "
                 f"{cell.get('error', '')} {log[-1500:]}")
        cells[f"{arch} {shape} {mesh}"] = cell
    return cells


def one_rank_counts(report: dict) -> dict:
    """The dry-run's counter on the meta device at one rank (no mesh), on
    the calls phases 9 and 12 timed: the qwen3-0.6B lockstep decode step at
    B = 4 (its `step`: the greedy pick and `decode_step`) and its 128-token
    prefill, on the packed ternary tree; the qwen3-0.6b train step at B =
    8, T = 512.  A packed product counts as its kernel's work (2·M·K·N
    FLOPs; x, the codes and y once each); nothing is timed anew.  The
    bound's memory term is the call's least traffic (`min_bytes`: each
    argument byte an op reads, read once, each byte written once), as a
    kernel's bound is; the fusion-blind count, every op's operands and
    results each time, is an upper estimate and printed beside it."""
    import torch
    from repro_torch.launch import dryrun as D
    from repro_torch.serve.recurrent import TransformerRuntime
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    cfg = pool_config("qwen3-0.6b")
    rt = TransformerRuntime(cfg, D.params_struct(cfg, packed=True),
                            device="meta")
    B, S, GEN = 4, 128, 32
    prompt = torch.empty((B, S), dtype=torch.int64, device="meta")
    prefill, (lg, st) = D.count_call(
        lambda: rt.prefill(prompt, rt.init_state(B, S + GEN)),
        (rt.served, prompt))
    decode, _ = D.count_call(
        lambda: rt.decode_step(torch.argmax(lg[:, :cfg.vocab], -1), st),
        (rt.served, lg, st))
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, decay_steps=20,
                        clip_norm=1.0)
    state = D.with_step_on_cpu(TS.train_state_init(D.params_struct(cfg),
                                                   opt_cfg, 1))
    TB, TT = 8, 512
    batch = {k: torch.empty((TB, TT), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    step = TS.make_train_step(cfg, opt_cfg)
    train, _ = D.count_call(lambda: step(state, batch, noise=D.meta_noise),
                            (state, batch))
    prof = report["transformer"]["profile"]
    tstep = report["pool_training"]["step"]
    ms = lambda us: None if us is None else us / 1e3
    measured = {
        "qwen3-0.6B decode step, B = 4 (phase 9)": (
            decode, ms(prof["decode_step"]["device_busy_us"]),
            ms(prof["decode_step"]["host_us"])),
        "qwen3-0.6B prefill, 4 x 128 (phase 9)": (
            prefill, ms(prof["prefill"]["device_busy_us"]),
            ms(prof["prefill"]["host_us"])),
        "qwen3-0.6b train step, B = 8, T = 512 (phase 12)": (
            train, tstep["device_busy_ms"], tstep["host_ms"])}
    out = {}
    for name, (c, busy, host) in measured.items():
        t = {"compute": c["flops"] / RF.PEAK_FLOPS,
             "memory": c["min_bytes"] / RF.HBM_BW}
        by = max(t, key=t.get)
        bound_ms = t[by] * 1e3
        out[name] = {"flops": c["flops"], "min_bytes": c["min_bytes"],
                     "fusion_blind_bytes": c["bytes_accessed"],
                     "elementwise_flops": c["elementwise_flops"],
                     "kernels": c["kernels"], "memory": c["memory"],
                     "bound_ms": bound_ms, "bound_by": by,
                     "device_busy_ms": busy, "host_ms": host,
                     "bound_over_busy": None if busy is None
                     else bound_ms / busy,
                     "bound_over_host": bound_ms / host}
    return out


def stop(procs: list) -> None:
    """Kill whichever of `procs` still runs."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def roofline_phase(report: dict, card: str, procs: list) -> dict:
    """Phase 16: the dry-run CLI on DRYRUN_CELLS (`procs`, started after
    the build: each cell's dominant term and its terms), and
    `one_rank_counts` beside phases 9 and 12's measured device busy and
    host wall.  Launches no kernel."""
    t0 = time.perf_counter()
    try:
        calls = one_rank_counts(report)
        cells = dryrun_wait(procs)
    finally:
        stop([p for _, p in procs])
    for shape, jax_bytes in JAX_ALL_GATHER.items():
        got = cells[f"qwen3-0.6b {shape} single"]["collectives"].get(
            "all-gather", 0.0)
        print(f"  dry-run qwen3-0.6b {shape}: all-gather {got:.4e} bytes a "
              f"rank, JAX's {jax_bytes:.4e} ({got / jax_bytes:.3f}x)",
              flush=True)
        if got > GATHER_LIMIT * jax_bytes:
            fail(f"dry-run qwen3-0.6b {shape}: all-gather {got:.4e} bytes "
                 f"a rank, above {GATHER_LIMIT} x JAX's {jax_bytes:.4e}")
    for name, c in cells.items():
        r = c["roofline"]
        print(f"  dry-run {name:38s}: {r['dominant']:10s} compute "
              f"{r['t_compute_s']:.3e} s, memory {r['t_memory_s']:.3e} s, "
              f"collective {r['t_collective_s']:.3e} s a rank; counted in "
              f"{c['count_s']} s", flush=True)
    for name, c in calls.items():
        print(f"  {name}: {c['flops']:.4e} FLOPs, least traffic "
              f"{c['min_bytes']:.4e} bytes (fusion-blind "
              f"{c['fusion_blind_bytes']:.4e}, an upper estimate); bound "
              f"{c['bound_ms']:.3f} ms ({c['bound_by']}); "
              f"bound / device busy {num(c['bound_over_busy'], '.4f')}, "
              f"bound / host wall {c['bound_over_host']:.4f} on {card}",
              flush=True)
    out = {"card": card, "dryrun": cells, "one_rank": calls,
           "wall_s": time.perf_counter() - t0}
    report["roofline"] = out
    print(f"  roofline phase: {out['wall_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 17: the examples a user starts from
# ---------------------------------------------------------------------------

EXAMPLES_TIMEOUT = 120
EXAMPLE_CKPT = ROOT / "build" / "example_ckpt"
# (name, script, arguments): run at once, each a process on the card (no
# --device: the examples' default); the character LM trains 10 steps and
# checkpoints (its resume, of a JAX checkpoint too, is held in
# tests/test_torch_examples.py)
EXAMPLES = (("quickstart", "torch_quickstart.py", []),
            ("serve_lstm", "torch_serve_lstm.py", []),
            ("train_char_lm", "torch_train_char_lm.py",
             ["--steps", "10", "--ckpt-dir", str(EXAMPLE_CKPT)]))


def run_examples(todo) -> dict:
    """Each example of `todo` in a process of its own, all at once: {name:
    its stdout}; a non-zero exit or a timeout fails the run, and every
    process is stopped."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / script), *args], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, script, args in todo}
    out = {}
    try:
        for name, p in procs.items():
            so, se = p.communicate(timeout=EXAMPLES_TIMEOUT)
            if p.returncode != 0:
                fail(f"example {name}: exit {p.returncode}: {se[-2000:]}")
            out[name] = so
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def examples_phase(report: dict) -> dict:
    """`examples/torch_quickstart.py`, `torch_serve_lstm.py` and
    `torch_train_char_lm.py` on the card (their default device), as the
    README starts a user: the quantizer's straight-through gradient, the
    packed product within 1e-5 of the dequantized one, the packed decode's
    self-check against the full-sequence forward, a checkpointed run.
    Their kernels launch in their own processes, outside this script's
    counts."""
    import shutil
    shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    t0 = time.perf_counter()
    out = run_examples(EXAMPLES)
    saved = (EXAMPLE_CKPT / "step_00000010" / "manifest.json").exists()
    shutil.rmtree(EXAMPLE_CKPT, ignore_errors=True)
    quick = out["quickstart"]
    err = re.search(r"max err vs reference: (\S+)", quick)
    if "STE gradient is identity: True" not in quick or not err or \
            not float(err.group(1)) < 1e-5:
        fail(f"example quickstart: {quick[-1500:]}")
    if "matches the full-sequence forward ✓" not in out["serve_lstm"]:
        fail(f"example serve_lstm: {out['serve_lstm'][-1500:]}")
    if "step    9  train bpc" not in out["train_char_lm"] or not saved:
        fail(f"example train_char_lm (checkpoint of step 10 written: "
             f"{saved}): {out['train_char_lm'][-1500:]}")
    res = {"packed_err": float(err.group(1)), "wall_s":
           time.perf_counter() - t0,
           "last_lines": {k: v.strip().splitlines()[-1] for k, v in
                          out.items()}}
    report["examples"] = res
    for k, v in res["last_lines"].items():
        print(f"  {k}: {v}", flush=True)
    print(f"  examples: packed product off the dequantized one by "
          f"{res['packed_err']:.3e}; the packed decode's self-check passed; "
          f"the character LM's step-10 checkpoint written; "
          f"{res['wall_s']:.1f} s", flush=True)
    return res


PHASE_S: dict = {}


@contextlib.contextmanager
def phase(name: str):
    """Time a phase of main (its seconds in PHASE_S, printed)."""
    print(f"{name}:", flush=True)
    t0 = time.perf_counter()
    yield
    PHASE_S[name] = round(time.perf_counter() - t0, 1)
    print(f"  [{name}: {PHASE_S[name]} s]", flush=True)


def main() -> int:
    t_start = time.perf_counter()
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

    # 16's dry-run cells (CPU only, on the meta device, each a process)
    # count while the kernels build
    dryrun_procs = dryrun_start()
    atexit.register(stop, [p for _, p in dryrun_procs])

    # 2. build, then the multiply-free proof
    t0 = time.perf_counter()
    built = build.build_all()
    report["build_s"] = PHASE_S["build"] = round(time.perf_counter() - t0, 1)
    print(f"build: {report['build_s']:.1f} s for {len(built)} kernels "
          f"(parallel nvcc)", flush=True)
    report["ptxas"] = {}
    for name, (path, secs, log) in built.items():
        usage = ptxas_usage(log)
        report["ptxas"][name] = usage
        print(f"  {name}: {path.name} {secs:.1f} s; " + " | ".join(
            f"{fn} {regs} regs, {spill} B spilled" for fn, regs, spill in usage),
              flush=True)
    for name in ("packed_gemv", "packed_matmul", "fused_tick", "ordered_bmm"):
        spilled = [(fn, b) for fn, _, b in report["ptxas"][name] if b]
        if spilled:
            fail(f"{name} spills registers: {spilled}")
    report["sass"] = sass_check(built["packed_gemv"][0],
                                built["packed_matmul"][0])
    print(f"sass: packed_gemv holds no FMUL/FFMA/HMUL2/HFMA2/DMUL/DFMA/HMMA, "
          f"packed_matmul issues HGMMA and no LDL/STL {report['sass']}",
          flush=True)

    # 3. kernels against their plain versions
    with phase("kernels"):
        launch_floor(report)
        rows = kernels_phase(report)

    # 4. the serving path, then where its time goes
    with phase("main path"):
        launches, rt = main_path_phase(report)
        profile_phase(report, rt)

    # 6. the continuous-batching engine
    with phase("engine"):
        engine_launches = engine_phase(report)

    # 7. the training path
    with phase("training"):
        launches["quantize_pack"] = training_phase(report)["quantize_pack"]

    # 8. the pipeline: train -> SIGTERM/restart -> export -> serve
    with phase("pipeline"):
        pipeline_launches = pipeline_phase(report)

    # 9. the transformer pool: qwen3-0.6B at full width
    with phase("transformer"):
        transformer_launches = transformer_phase(report)

    # 10. the pool's MoE and RWKV6 families
    with phase("pool"):
        moe_launches, rwkv_launches = pool_phase(report)

    # 11. the pool's hybrid and audio families
    with phase("hybrid and audio"):
        hybrid_launches, audio_launches = hybrid_audio_phase(report, card)

    # 12. training the transformer pool
    with phase("pool training"):
        pool_training_phase(report, card)

    # 13. the VLM at full width
    with phase("vlm"):
        vlm_launches = vlm_phase(report, card)

    # 14. compressed data parallelism
    with phase("compressed DP"):
        compress_launches = compressed_dp_phase(report, card)

    # 15. the model axis and the mesh engine at one rank
    with phase("mesh"):
        mesh_launches = mesh_phase(report, card)

    # 16. the dry-run's counts and the one-rank roofline (no kernel)
    with phase("roofline"):
        roofline_phase(report, card, dryrun_procs)

    # 17. the examples the README starts from, on the card
    with phase("examples"):
        examples_phase(report)
    pool, ha = report["pool"], report["hybrid_audio"]
    all_rows = (rows + report["transformer"]["kernel_rows"]
                + pool["qwen3_moe"]["kernel_rows"]
                + pool["mixtral"]["kernel_rows"]
                + pool["rwkv6"]["kernel_rows"]
                + ha["zamba2"]["kernel_rows"] + ha["whisper"]["kernel_rows"]
                + report["vlm"]["kernel_rows"])

    # 18. result
    sources = {"packed_gemv": ("src/repro_torch/csrc/packed_gemv.cu",
                               "src/repro/kernels/packed_matmul.py:106"),
               "packed_matmul": ("src/repro_torch/csrc/packed_matmul.cu",
                                 "src/repro/kernels/packed_matmul.py:155"),
               "fused_tick": ("src/repro_torch/csrc/fused_tick.cu",
                              "src/repro/kernels/decode_step.py:114"),
               "quantize_pack": ("src/repro_torch/csrc/quantize_pack.cu",
                                 "src/repro/kernels/packed_matmul.py:213"),
               "ordered_bmm": ("src/repro_torch/csrc/ordered_bmm.cu",
                               "none: src/repro/models/layers.py:84 and :98 "
                               "(attention's einsums, no TPU kernel)")}
    # the sequence route (packed_matmul: every prompt chunk's projections)
    # and ordered_bmm are the transformer pool's path: their launches are
    # the counted qwen3 run's (phase 9), packed_matmul's row qwen3's Wq at
    # M = 512 (a 128-token prefill at B = 4); the others', the rnn-paper
    # main path's
    for name in ("packed_matmul", "ordered_bmm"):
        launches[name] = transformer_launches.get(name, 0)
        if not launches[name]:
            fail(f"kernel {name} was never launched on the qwen3 path")
    main_row = {"packed_matmul": next(
        r for r in report["transformer"]["kernel_rows"]
        if r["name"] == "packed_matmul" and " Wq ternary x(512," in r["shape"])}
    kernels = []
    for name, (src, replaces) in sources.items():
        # the main path's shape
        r = main_row.get(name) or next(r for r in rows if r["name"] == name)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "engine_launches": engine_launches.get(name, 0),
                        "pipeline_launches": pipeline_launches.get(name, 0),
                        "transformer_launches":
                            transformer_launches.get(name, 0),
                        "moe_launches": moe_launches.get(name, 0),
                        "rwkv_launches": rwkv_launches.get(name, 0),
                        "hybrid_launches": hybrid_launches.get(name, 0),
                        "audio_launches": audio_launches.get(name, 0),
                        "vlm_launches": vlm_launches.get(name, 0),
                        "compress_launches":
                            compress_launches.get(name, 0),
                        "mesh_launches": mesh_launches.get(name, 0),
                        "max_abs_err": max(x["max_abs_err"] for x in all_rows
                                           if x["name"] == name),
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report["kernels"] = kernels
    report["wall_s"] = time.perf_counter() - t_start
    report["phase_s"] = PHASE_S
    print("phases: " + ", ".join(f"{k} {v} s" for k, v in PHASE_S.items()),
          flush=True)
    report["profiler_missed_calls"] = PROFILER_MISSES["calls"]
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"chip_smoke: {report['wall_s']:.1f} s in all, the build included, "
          f"on {card}; torch.profiler missed every attempt of "
          f"{PROFILER_MISSES['calls']} calls", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
