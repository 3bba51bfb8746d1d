"""End-to-end training driver (the twin of the reference's
``examples/train_lm.py``): paper-lm with post-local SGD on the synthetic
LM corpus, held-out evaluation and a checkpoint.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 60
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 24

The default preset is the tiny one; ``--preset 100m --steps 300`` trains
paper-lm at full width (12 layers, d_model 768), sized for the card.  The
checkpoint is the resident state's per-leaf npz (``checkpoint.save``),
written to ``--ckpt`` (a file under the temporary directory by default).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import configs
from repro_torch.checkpoint.checkpoint import save
from repro_torch.configs import paper_lm
from repro_torch.configs.base import (InputShape, LocalSGDConfig, OptimConfig,
                                      RunConfig)
from repro_torch.convert import params_from_reference
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.launch.steps import build_train
from repro_torch.launch.train import eval_lm, fit


def make_run(args) -> RunConfig:
    """The RunConfig for the parsed arguments."""
    cfg = paper_lm.tiny() if args.preset == "tiny" else configs.get("paper-lm")
    shape = InputShape("train", args.seq, args.workers * args.local_batch,
                       "train")
    return RunConfig(
        model=cfg, shape=shape,
        local_sgd=LocalSGDConfig(local_steps=args.local_steps,
                                 post_local_switch=args.steps // 2),
        optim=OptimConfig(base_lr=0.3, base_batch=shape.global_batch,
                          lr_warmup_steps=max(args.steps // 20, 1),
                          lr_decay_steps=(args.steps // 2,
                                          3 * args.steps // 4)))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=["tiny", "100m"], default="tiny")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--local-batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="the card by default (raises without one); cpu runs "
                         "the kernels' plain versions")
    return ap.parse_args(argv)


def main(argv=None, *, params0=None, log=print) -> dict:
    """Train, evaluate, checkpoint; returns the per-step ``losses``, the
    held-out ``eval_xent``, ``comm_rounds`` and the checkpoint's path.
    ``params0`` (numpy tree) replaces the weights drawn from seed 0."""
    args = parse(argv)
    run = make_run(args)
    cfg = run.model
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=1024,
                                 seq_len=args.seq))
    held = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=64,
                                 seq_len=args.seq, sample_seed=7))
    bundle = build_train(run, num_workers=args.workers, device=args.device)
    p0 = (None if params0 is None
          else params_from_reference(params0, bundle.device))
    state, hist, summary = fit(run, ShardedBatches(data, args.workers,
                                                   args.local_batch),
                               bundle=bundle, num_steps=args.steps,
                               eval_every=max(args.steps // 4, 1),
                               eval_fn=eval_lm(bundle, held), params0=p0,
                               log=log)
    save(args.ckpt, state, step=int(state.step),
         extra={"arch": cfg.name, "H": args.local_steps})
    log(f"\ntrained {cfg.name}: final loss {hist[-1]['loss']:.3f}, "
        f"comm rounds {summary['comm_rounds']}, checkpoint -> {args.ckpt}.npz")
    return {"losses": [h["loss"] for h in hist],
            "eval_xent": [h["eval_xent"] for h in hist if "eval_xent" in h],
            "comm_rounds": summary["comm_rounds"], "ckpt": args.ckpt,
            "device": str(bundle.device)}


if __name__ == "__main__":
    main()
