"""Build and load the CUDA kernels of `repro_torch/csrc/`.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`build/kernels/<name>-<hash>.so` at the repository root, keyed by a hash of
its source, the shared `csrc/*.cuh` headers and the compiler flags, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

plus `LIBS[name]`: `packed_matmul` links the driver API (`-lcuda`, for
`cuTensorMapEncodeTiled`, its TMA descriptors) against the toolkit's stub
in `lib64/stubs`; the driver's `libcuda.so.1` resolves it at load.  The
`.so` is loaded with `ctypes`.  `build_all()` starts one `nvcc` per
source at once; `library(name)` builds on first use.  Nothing here runs at
import time, so the CPU tests import every module without a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("packed_gemv", "packed_matmul", "fused_tick", "quantize_pack",
           "ordered_bmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# libraries a kernel links beyond the CUDA runtime
LIBS = {"packed_matmul": ("-lcuda",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of each kernel's C entry point: every pointer and the stream as
# c_void_p, so ctypes never truncates them to 32-bit ints
SIGNATURES = {
    "packed_gemv": ("packed_gemv_launch", [_P, _P, _P] + [_I] * 8 + [_P]),
    "packed_matmul": ("packed_matmul_launch", [_P, _P, _P] + [_I] * 6 + [_P]),
    "fused_tick": ("fused_tick_launch", [_P] * 23 + [_I] * 9 + [_P]),
    "quantize_pack": ("quantize_pack_launch", [_P, _P, _P, _F, _I, _I, _I, _P]),
    "ordered_bmm": ("ordered_bmm_launch",
                    [_P, _P, _P] + [_I] * 6 + [_L] * 8 + [_P]),
}

_libs: dict = {}


def cuda_home() -> str:
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


def nvcc() -> str:
    for cand in (os.path.join(cuda_home(), "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME/bin, PATH); the CUDA "
                       "kernels build only where the CUDA toolkit is installed")


def so_path(name: str) -> Path:
    """The library's path, keyed by its source, the shared headers and the
    flags, so an edit to any of them builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LIBS.get(name, ())).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = so_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    libs = LIBS.get(name, ())
    if libs:
        libs = ("-L" + os.path.join(cuda_home(), "lib64", "stubs"), *libs)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
           *libs]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def build_all(names=KERNELS) -> dict:
    """Compile every kernel whose `.so` is missing, one `nvcc` each, all
    started together.  Returns {name: (path, seconds, compiler log)}; a
    library built before gives the log of its build."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    done = {}
    for name, job in jobs.items():
        if job is None:  # built before: its compiler log lies beside it
            log = so_path(name).with_suffix(".log")
            done[name] = (so_path(name), 0.0,
                          log.read_text() if log.exists() else "cached")
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        done[name] = (out, time.perf_counter() - t0, log)
    return done


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all((name,))[name][0]
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel `name`'s C entry point on `device`, on its current
    stream (passed last), and raise on a non-zero cudaError_t (a refused
    launch never runs, and a later synchronize would not report it)."""
    fn_name, _ = SIGNATURES[name]
    fn = getattr(library(name), fn_name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
