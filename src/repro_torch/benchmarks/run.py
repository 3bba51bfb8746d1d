"""Benchmark entry point of the paper experiments on the port:

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig1,table4
    PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig1 --device cpu
    PYTHONPATH=src python -m repro_torch.benchmarks.run --json-out out.json

Prints ``name,us_per_call,derived`` CSV rows with the reference's bench
names, row names and ``derived`` fields (``python -m benchmarks.run`` in
the JAX package):
  fig1   generalization gap A1..A5 (Figure 1)
  table1 scaling over K and H (Table 1, time simulated per App. B.2)
  fig2b  local vs mini-batch at same effective batch (Figure 2b)
  table2 post-local vs mini-batch selected rows (Table 2)
  table4 sign / EF-sign compression (Table 4)
  table8 local x global momentum (Table 8)
  table14 isotropic-noise baseline (Table 14)
  table16/17 hierarchical local SGD (Tables 16/17, Fig. 19)
  fig4   flatness via Hessian power iteration (Figure 4)
  fig10  local-step warmup strategies (App. B.4.2, Fig. 10/11)
  fig6   convex logistic regression (Figure 6; fig6b over K)
  sec5   K*Sigma noise-scale verification (Section 5, eq. 4)

Runs on the card unless ``--device cpu``; with no card and no device it
raises.  On the card the CUDA kernels are built before the first bench,
so no row's time includes the compiler.  The reference's kernel, bucket,
serving, roofline, elastic and noise_adaptive benches are not ported:
asking for one prints ``<name>,0.0,ERROR``, as an unknown name does, and
the exit code is 1.
"""
from __future__ import annotations

import argparse
import json
import platform
import sys
import traceback

import torch

from repro_torch.benchmarks import bench_convex, paper_tables
from repro_torch.benchmarks.common import RECORDS, bench_metrics
from repro_torch.utils import resolve_device

BENCHES = {
    "sec5": paper_tables.sec5_noise_scale,
    "table17": lambda device: paper_tables.table17_network_delay_tolerance(),
    "fig6": bench_convex.fig6_convex,
    "fig6b": bench_convex.fig6b_speedup_over_K,
    "fig1": paper_tables.fig1_generalization_gap,
    "table2": paper_tables.table2_postlocal_vs_minibatch,
    "table1": paper_tables.table1_scaling,
    "fig2b": paper_tables.fig2b_same_effective_batch,
    "table4": paper_tables.table4_sign_compression,
    "table8": paper_tables.table8_momentum,
    "table14": paper_tables.table14_noise_injection,
    "table16": paper_tables.table16_hierarchical,
    "fig4": paper_tables.fig4_flatness,
    "fig10": paper_tables.fig10_warmup,
}
# the reference's other benches (ROADMAP A.6)
NOT_PORTED = ("kernels", "bucket", "resident", "sharded", "syncplan",
              "noise_adaptive", "elastic", "serving", "roofline")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="comma-separated bench names")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--json-out", default="",
                    help="write the structured rows and the bench_seconds "
                         "exposition to this JSON file")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()

    selected = ([s for s in args.only.split(",") if s] if args.only
                else list(BENCHES))
    print("name,us_per_call,derived")
    failures = 0
    for name in selected:
        try:
            BENCHES[name](device=dev)
        except Exception:
            failures += 1
            print(f"{name},0.0,ERROR", flush=True)
            if name in NOT_PORTED:
                print(f"{name}: not ported to repro_torch yet", file=sys.stderr)
            else:
                traceback.print_exc()
    if args.json_out:
        artifact = {
            "bench": "paper_tables",
            "selected": selected,
            "failures": failures,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "python": platform.python_version(),
            "torch": torch.__version__,
            "records": RECORDS,
            # Prometheus exposition of every timing-helper measurement
            # (repro_bench_seconds histogram, label name=<bench case>)
            "metrics_exposition": bench_metrics().exposition(),
        }
        with open(args.json_out, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {args.json_out} ({len(RECORDS)} records)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
