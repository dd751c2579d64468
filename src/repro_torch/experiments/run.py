"""The paper's tables and figures on the port, one entry each, and the
roofline report of the port's dry-run cells; ported from the tables of
`benchmarks/run.py`.

  PYTHONPATH=src python -m repro_torch.experiments.run      # all, the card
  PYTHONPATH=src python -m repro_torch.experiments.run --quick --device cpu
  PYTHONPATH=src python -m repro_torch.experiments.run --only table4_mnist

Prints a compact CSV per table and writes `<out>/<name>.json`
(`results/torch_tables/` by default).  Runs on the card unless
`--device cpu` is given, and raises without one.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.experiments import common as C
from repro_torch.experiments import tables as T
from repro_torch.kernels.dispatch import resolve_device


def roofline_report(quick=False, *, device=None, out=None, seed=0):
    """Aggregate `results/torch_dryrun/*.json` (the dry-run's cells) into
    the roofline table, written to `out/roofline_report.json`."""
    outdir = C.REPO / "results" / "torch_dryrun"
    rows = []
    for p in sorted(outdir.glob("*.json")) if outdir.exists() else []:
        c = json.loads(p.read_text())
        if c.get("status") == "ok":
            r = c["roofline"]
            rows.append({
                "arch": c["arch"], "shape": c["shape"], "mesh": c["mesh"],
                "t_compute_s": f"{r['t_compute_s']:.3e}",
                "t_memory_s": f"{r['t_memory_s']:.3e}",
                "t_collective_s": f"{r['t_collective_s']:.3e}",
                "dominant": r["dominant"],
                "useful_flop_ratio": round(r["useful_flop_ratio"], 3),
                "roofline_fraction": round(r["roofline_fraction"], 4),
            })
        elif c.get("status") == "skipped":
            rows.append({"arch": c["arch"], "shape": c["shape"],
                         "mesh": c["mesh"], "dominant": "N/A",
                         "note": c["reason"][:60]})
    out = Path(out) if out is not None else C.RESULTS
    out.mkdir(parents=True, exist_ok=True)
    (out / "roofline_report.json").write_text(json.dumps(rows, indent=1))
    return rows


BENCHES = {
    "table1_char_lm": T.table1_char_lm,
    "table1b_convergence": T.table1b_convergence,
    "table2_text8": T.table2_text8,
    "table3_word_lm": T.table3_word_lm,
    "table4_mnist": T.table4_mnist,
    "table5_qa": T.table5_qa,
    "table6_gru": T.table6_gru,
    "table7_hardware": T.table7_hardware,
    "fig1b_variance": T.fig1b_stochastic_variance,
    "fig2_generalization": T.fig2_generalization,
    "fig3_batch_size": T.fig3_batch_size,
    "roofline": roofline_report,
}


def _print_rows(name, rows):
    print(f"\n=== {name} ===")
    for r in rows:
        if isinstance(r, dict):
            print(",".join(f"{k}={v}" for k, v in r.items()
                           if k not in ("train_curve_bpc",)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", nargs="*", default=None, choices=list(BENCHES))
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain versions")
    ap.add_argument("--out", type=Path, default=C.RESULTS,
                    help="where the JSONs go (default results/torch_tables)")
    ap.add_argument("--seed", type=int, default=0,
                    help="shift every seed by this much (0: JAX's seeds)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    names = args.only or list(BENCHES)
    t_all = time.time()
    failures = []
    for name in names:
        t0 = time.time()
        try:
            rows = BENCHES[name](quick=args.quick, device=device,
                                 out=args.out, seed=args.seed)
            _print_rows(name, rows)
            print(f"[{name}: {time.time() - t0:.1f}s]", flush=True)
        except Exception as e:  # keep the harness going; report at the end
            failures.append((name, repr(e)))
            traceback.print_exc()
            print(f"[{name}: FAILED {e!r}]", flush=True)
    print(f"\ntotal {time.time() - t_all:.1f}s; "
          f"{len(names) - len(failures)}/{len(names)} benches ok")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
