"""Hierarchical local SGD (paper Alg. 5 / Appendix D) on the SyncPlan
topology API (the twin of the reference's
``examples/hierarchical_local_sgd.py``).

    PYTHONPATH=src python -m repro_torch.examples.hierarchical_local_sgd
    PYTHONPATH=src python -m repro_torch.examples.hierarchical_local_sgd --device cpu

Two blocks of two workers: inner (block) syncs every H steps, outer
(global) syncs every H * H^b.  The topology is declared,
``make_sync_plan(..., topology=hierarchical(2))``: block-mean stages (the
fast intra-node links) and global stages (the slow inter-node ones), and
the comms ledger prices each stage, so the Alg. 5 trade-off prints
straight from ``summary["ledger"]``.
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.configs.base import (InputShape, LocalSGDConfig, OptimConfig,
                                      RunConfig)
from repro_torch.convert import params_from_reference
from repro_torch.core.local_sgd import needs_anchor, unpack_state
from repro_torch.core.syncplan import hierarchical, make_sync_plan
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.launch.steps import build_train
from repro_torch.launch.train import fit
from repro_torch.utils import tree_leaves

K, B_LOC, SEQ, STEPS = 4, 4, 64, 36
H, HB = 2, 3                       # inner steps, block steps
BLOCK = K // 2                     # workers per block (two blocks)


def make_run(steps: int = STEPS) -> RunConfig:
    cfg = configs.get_smoke("paper-lm")
    return RunConfig(model=cfg,
                     shape=InputShape("hier", SEQ, K * B_LOC, "train"),
                     local_sgd=LocalSGDConfig(local_steps=H, block_steps=HB),
                     optim=OptimConfig(base_lr=0.3, base_batch=K * B_LOC,
                                       lr_decay_steps=(steps // 2,)))


def main(argv=None, *, params0=None, log=print) -> dict:
    """Train and report; returns the per-step ``losses``, ``comm_rounds``,
    the plan's ``topology``, the ledger's per-topology rows and the
    largest param ``spread`` across workers after the last sync.
    ``params0`` (numpy tree) replaces the weights drawn from seed 0."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None,
                    help="the card by default (raises without one); cpu runs "
                         "the kernels' plain versions")
    args = ap.parse_args(argv)
    run = make_run(args.steps)
    cfg, ls = run.model, run.local_sgd
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=512,
                                 seq_len=SEQ))
    bundle = build_train(run, num_workers=K, device=args.device)
    # Declare the Alg. 5 topology explicitly: block-mean stages over blocks
    # of BLOCK consecutive workers, then the global stages (build_train's
    # 'auto' topology compiles the same plan from block_steps > 1; spelled
    # out here, it shows the API the controller's PlanDelta rewrites).
    bundle.sync_plan = make_sync_plan(
        bundle.layout, num_workers=K, topology=hierarchical(BLOCK),
        compression=ls.sync_compression, anchored=needs_anchor(ls),
        wire_pack=ls.wire_pack, coalesce=ls.sync_coalesce)
    log(bundle.sync_plan.describe())
    log("")
    p0 = (None if params0 is None
          else params_from_reference(params0, bundle.device))
    state, hist, summary = fit(run, ShardedBatches(data, K, B_LOC),
                               bundle=bundle, num_steps=args.steps, params0=p0,
                               log=log)

    rounds = summary["comm_rounds"]
    log(f"H={H}, H^b={HB}, steps={args.steps}, topology={summary['topology']}")
    log(f"block syncs (fast intra-node links):  {rounds['block']}")
    log(f"global syncs (slow inter-node links): {rounds['global']}")
    log(f"mini-batch SGD would do {args.steps} global syncs")
    log("\nper-stage ledger (Alg. 5 trade-off, bytes per device per round):")
    rows = summary["ledger"]["topologies"]
    for key, row in sorted(rows.items()):
        log(f"  {key:22s} rounds={row['rounds']:3d} "
            f"bytes/round={row['bytes_per_round']:10.0f} "
            f"collectives={row['collectives']}")
    w = tree_leaves(unpack_state(state).params)[0]
    spread = float((w[0].float() - w[-1].float()).abs().max())
    log(f"\nmax param spread across workers after final sync: {spread:.2e}")
    return {"losses": [h["loss"] for h in hist], "comm_rounds": rounds,
            "topology": summary["topology"], "ledger": rows,
            "spread": spread, "device": str(bundle.device)}


if __name__ == "__main__":
    main()
