"""Serve a small pool model with batched requests on the PyTorch port:
prefill + sampled decode through the KV-cache runtime, with ternary
(2-bit) weights at runtime.

  PYTHONPATH=src python examples/torch_serve_generate.py           # the card
  PYTHONPATH=src python examples/torch_serve_generate.py --device cpu
  PYTHONPATH=src python examples/torch_serve_generate.py --arch mixtral-8x7b --gen 16

This is a thin veneer over `repro_torch.launch.serve` — the same entry
point that serves on a mesh (`--mesh`).  Given arguments replace the
defaults below (`--device` alone keeps them).  The counterpart of
`examples/serve_generate.py`.
"""
import sys

from repro_torch.launch.serve import main

DEFAULTS = ["--arch", "qwen3-0.6b", "--reduced", "--quant", "ternary",
            "--prompt-len", "24", "--gen", "24", "--batch", "2"]

if __name__ == "__main__":
    args = sys.argv[1:]
    rest = [a for i, a in enumerate(args) if not a.startswith("--device")
            and not (i and args[i - 1] == "--device")]
    main(args if rest else DEFAULTS + args)
