"""Paper Figure 1 at miniature scale: the generalization gap of
large-batch SGD, and post-local SGD closing it (the twin of the
reference's ``examples/post_local_generalization.py``).

Trains A1 (small batch), A2 (large batch), A4 (local SGD), A5
(post-local SGD) on the synthetic classification task and prints
test accuracy and communication rounds.

    PYTHONPATH=src python -m repro_torch.examples.post_local_generalization
    PYTHONPATH=src python -m repro_torch.examples.post_local_generalization --device cpu

Runs on the card unless ``--device`` says otherwise; the weights come
from ``benchmarks.common.mlp_init`` on a CPU generator seeded with 0
(``params0`` replaces them, e.g. with the reference's).
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import dataset, test_acc, train_local_sgd
from repro_torch.utils import resolve_device

STEPS = 300


def rows_for(steps: int):
    """The four algorithms: (name, ``train_local_sgd`` keywords)."""
    return [
        ("A1 small mini-batch SGD  (K=1)", dict(K=1, B_loc=64, H=1)),
        ("A2 large mini-batch SGD  (K=8)", dict(K=8, B_loc=64, H=1)),
        ("A4 local SGD       (K=8, H=4)", dict(K=8, B_loc=64, H=4)),
        ("A5 post-local SGD  (K=8, H=4)", dict(K=8, B_loc=64, H=4,
                                               post_local_switch=steps // 2)),
    ]


def main(argv=None, *, params0=None, log=print) -> dict:
    """Train the four algorithms; returns each one's test accuracy and comm
    rounds, the large-batch gap and what post-local SGD closes.
    ``params0`` (a numpy tree of ``mlp_init``'s width-256 MLP) replaces the
    weights every run draws from seed 0."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None,
                    help="the card by default (raises without one); cpu runs "
                         "the kernels' plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    train, test = dataset()
    if params0 is None:
        log("weights: benchmarks.common.mlp_init from a CPU generator seeded "
            "with 0")
    rows = rows_for(args.steps)
    log(f"{'algorithm':36s} {'test acc':>9s} {'comm rounds':>12s}")
    results = []
    for name, kw in rows:
        state, comm, _ = train_local_sgd(steps=args.steps, train=train,
                                         params0=params0, device=dev, **kw)
        acc = test_acc(state, test)
        results.append({"name": name, "acc": acc, "comm": comm})
        log(f"{name:36s} {acc:9.4f} {comm:12d}")
    gap = results[1]["acc"] - results[0]["acc"]
    closed = results[3]["acc"] - results[1]["acc"]
    log(f"\nlarge-batch gap vs small batch: {gap:+.4f}")
    log(f"post-local SGD vs large batch:  {closed:+.4f}  (paper: gap closed)")
    return {"rows": results, "gap": gap, "closed": closed,
            "device": str(dev)}


if __name__ == "__main__":
    main()
