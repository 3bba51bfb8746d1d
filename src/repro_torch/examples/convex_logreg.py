"""Paper Appendix B.2: local SGD on a convex problem (logistic regression)
(the twin of the reference's ``examples/convex_logreg.py``).

Reproduces Figure 6's protocol on the synthetic w8a stand-in: time to a
target suboptimality under a simulated communication cost of 25 gradient
steps, over a grid of H (the best step size of a grid search each).

    PYTHONPATH=src python -m repro_torch.examples.convex_logreg
    PYTHONPATH=src python -m repro_torch.examples.convex_logreg --device cpu

Runs on the card unless ``--device`` says otherwise (the weights start at
zero, as in the reference).  ``--hs`` / ``--k`` / ``--b-loc`` narrow the
grid (the reference's script fixes K=8, B_loc=16, H in 1..16).
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.bench_convex import _best_over_lrs
from repro_torch.utils import resolve_device

HS, K, B_LOC = (1, 2, 4, 8, 16), 8, 16


def main(argv=None, *, log=print) -> dict:
    """Run the grid; returns one row a H (simulated time, steps, comm
    rounds, whether the target was reached) and the device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hs", type=int, nargs="+", default=list(HS))
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--b-loc", type=int, default=B_LOC)
    ap.add_argument("--device", default=None,
                    help="the card by default (raises without one); cpu runs "
                         "the kernels' plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    log(f"{'config':14s} {'sim time':>9s} {'steps':>6s} {'comm':>5s} "
        f"{'hit':>5s}")
    rows, base = [], None
    for H in args.hs:
        sim, steps, comm, hit = _best_over_lrs(K=args.k, H=H, B_loc=args.b_loc,
                                               device=dev)
        base = base or sim
        rows.append({"H": H, "sim_time": sim, "steps": steps, "comm": comm,
                     "reached": hit})
        log(f"K={args.k} H={H:<3d}      {sim:9.0f} {steps:6d} {comm:5d} "
            f"{str(hit):>5s}   ({base/sim:.2f}x vs H={args.hs[0]})")
    log("\nLocal SGD reaches the target with far fewer synchronizations —")
    log("the paper's Figure 6 trade-off (comm 25x more expensive than a step).")
    return {"rows": rows, "device": str(dev)}


if __name__ == "__main__":
    main()
