"""Quickstart: post-local SGD on a tiny LM (the twin of the reference's
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Four workers on the smoke-size paper-lm, local batch 4, sequences of 64:
mini-batch SGD for the first half of the steps, then H=4 local steps
between syncs (paper Alg. 2).  Runs on the card unless ``--device`` says
otherwise; the loss falls from about 6.2 and the syncs are far fewer than
the steps.
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.configs.base import (InputShape, LocalSGDConfig, OptimConfig,
                                      RunConfig)
from repro_torch.convert import params_from_reference
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.launch.steps import build_train
from repro_torch.launch.train import eval_lm, fit

K, B_LOC, SEQ, STEPS = 4, 4, 64, 40


def make_run(steps: int = STEPS) -> RunConfig:
    """The quickstart's RunConfig for a run of ``steps`` steps."""
    cfg = configs.get_smoke("paper-lm")             # tiny decoder LM
    return RunConfig(
        model=cfg,
        shape=InputShape("quickstart", SEQ, K * B_LOC, "train"),
        # post-local SGD (paper Alg. 2): mini-batch SGD for the first half,
        # then H=4 local steps between synchronizations.
        local_sgd=LocalSGDConfig(local_steps=4, post_local_switch=steps // 2),
        optim=OptimConfig(base_lr=0.3, base_batch=K * B_LOC,
                          lr_warmup_steps=4, lr_decay_steps=(steps // 2,)))


def main(argv=None, *, params0=None, log=print) -> dict:
    """Train and report; returns the per-step ``losses``, the held-out
    ``eval_xent`` (every 10 steps), ``comm_rounds`` and the device.
    ``params0`` (a single-copy tree of numpy arrays, e.g. the reference's
    weights) replaces the weights drawn from seed 0."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None,
                    help="the card by default (raises without one); cpu runs "
                         "the kernels' plain versions")
    args = ap.parse_args(argv)
    run = make_run(args.steps)
    cfg = run.model
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=512,
                                 seq_len=SEQ))
    held = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=64,
                                 seq_len=SEQ, sample_seed=99))
    batches = ShardedBatches(data, K, B_LOC)        # disjoint shards per worker

    bundle = build_train(run, num_workers=K, device=args.device)
    p0 = (None if params0 is None
          else params_from_reference(params0, bundle.device))
    state, history, summary = fit(run, batches, bundle=bundle,
                                  num_steps=args.steps, eval_every=10,
                                  eval_fn=eval_lm(bundle, held), params0=p0,
                                  log=log)
    log(f"\nfinal train loss: {history[-1]['loss']:.3f}")
    log(f"communication rounds: {summary['comm_rounds']} "
        f"(mini-batch SGD would use {args.steps})")
    return {"losses": [h["loss"] for h in history],
            "eval_xent": [h["eval_xent"] for h in history if "eval_xent" in h],
            "comm_rounds": summary["comm_rounds"],
            "wall_s": summary["wall_s"], "device": str(bundle.device)}


if __name__ == "__main__":
    main()
