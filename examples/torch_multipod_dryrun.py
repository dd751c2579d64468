"""Count one (arch x shape) cell on the 512-rank multi-pod mesh with the
PyTorch port's dry-run and print its counts and roofline — the smallest
demonstration of the production distribution config.

  PYTHONPATH=src python examples/torch_multipod_dryrun.py llama3-8b decode_32k
  PYTHONPATH=src python examples/torch_multipod_dryrun.py --device cpu

The cell runs on the meta device as rank 0 of a fake process group; its
mesh takes the card's device type where there is one (DTensor picks
NCCL's collectives), the CPU's otherwise.  The cell is written under
`results/torch_dryrun/` (`--out`), never JAX's `results/dryrun/`.  The
counterpart of `examples/multipod_dryrun.py`.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels.dispatch import resolve_device

REPO = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="qwen3-0.6b")
    ap.add_argument("shape", nargs="?", default="decode_32k")
    ap.add_argument("--out", default=str(REPO / "results" / "torch_dryrun"))
    ap.add_argument("--device", default=None,
                    help="the card unless given (cpu: a CPU mesh)")
    args = ap.parse_args()
    resolve_device(args.device)
    # the fake process group owns its process
    rc = subprocess.call(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         args.arch, "--shape", args.shape, "--mesh", "multi", "--out",
         args.out],
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        cwd=REPO)
    cell = Path(args.out) / f"{args.arch}__{args.shape}__multi.json"
    if rc == 0 and cell.exists():
        got = json.loads(cell.read_text())
        keep = ("status", "n_chips", "flops", "bytes_accessed",
                "collectives", "memory", "roofline", "reason")
        print(json.dumps({k: got[k] for k in keep if k in got}, indent=1))
    raise SystemExit(rc)
