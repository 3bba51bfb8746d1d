"""Training driver: the paper's schedules on top of the step builder (the
core of ``repro.launch.train.fit``).

The communication pattern is decided on the host from the
``LocalSGDConfig`` exactly like the paper's Alg. 1/2/5 outer loops: every
step is a local step, and a sync follows whenever the static schedule
(``local_steps_at`` through ``DynamicSchedule``) says so — a block sync
(Alg. 5's inner mean, level 1) or a global one (level 2).  A
``CommsLedger`` prices every sync from the plan's collective stages.

CLI:
    PYTHONPATH=src python -m repro_torch.launch.train --steps 40
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --block-steps 2
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import InputShape, LocalSGDConfig, OptimConfig, RunConfig
from repro_torch.core.local_sgd import mean_params
from repro_torch.core.schedule import DynamicSchedule, local_steps_at
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.models import base as mbase
from repro_torch.models import lm
from repro_torch.telemetry.ledger import CommsLedger


def _sync_device(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def fit(run: RunConfig, data_iter, *, bundle=None, num_steps=None, seed=0,
        eval_every=0, eval_fn=None, log=print, params0=None, device=None):
    """Run the schedule; returns (state, history, summary).

    ``params0`` is the single-copy param tree to start from (e.g. weights
    carried over from the JAX package with ``repro_torch.convert``); by
    default it is drawn from the specs with a ``torch.Generator`` seeded
    with ``seed``.  ``summary`` has ``comm_rounds`` ({"block", "global"}),
    ``wall_s`` (host clock, ending after a device synchronize), the
    plan's ``topology`` and the ledger's ``summary()`` (analytic ring
    bytes per round; no sync seconds yet).
    """
    if bundle is None:
        from repro_torch.launch.steps import build_train
        bundle = build_train(run, num_workers=getattr(data_iter, "W", 1),
                             device=device)
    dev = bundle.device
    num_steps = num_steps or run.steps
    ls = run.local_sgd
    if params0 is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params0 = mbase.materialize(bundle.specs, gen, dev,
                                    dtype=getattr(torch, run.model.param_dtype))
    state = bundle.init(params0)
    plan = bundle.sync_plan
    sched = DynamicSchedule(ls, lambda t: local_steps_at(ls, t))

    ledger = CommsLedger()
    history = []
    comm_rounds = {"block": 0, "global": 0}
    t_start = time.perf_counter()
    for t in range(num_steps):
        h_now = max(local_steps_at(ls, t), 1)
        state, metrics = bundle.local_step(state, next(data_iter))
        level = sched.advance(t)
        synced = ""
        if level:
            scope = "block" if level == 1 else "global"
            state = bundle.sync(state, plan=plan, scope=scope)
            ledger.record_plan(step=t, level=level, h=h_now, plan=plan,
                               scope=scope, num_workers=bundle.num_workers)
            comm_rounds[scope] += 1
            synced = scope
        rec = {k: float(v) for k, v in metrics.items()}
        rec.update(step=t, synced=synced)
        history.append(rec)
        if eval_every and eval_fn and (t + 1) % eval_every == 0:
            ev = eval_fn(state)
            rec.update({f"eval_{k}": float(v) for k, v in ev.items()})
            log(f"step {t+1}: loss={rec['loss']:.4f} "
                + " ".join(f"eval_{k}={float(v):.4f}" for k, v in ev.items()))
    _sync_device(dev)
    wall = time.perf_counter() - t_start
    summary = {"wall_s": wall, "comm_rounds": comm_rounds, "steps": num_steps,
               "topology": plan.topology.describe(),
               "ledger": ledger.summary()}
    return state, history, summary


def eval_lm(bundle, data: dict, batch: int = 8):
    """Mean held-out xent of the worker-averaged model."""
    cfg = bundle.cfg

    def fn(state):
        params = mean_params(state)
        losses = []
        n = len(next(iter(data.values())))
        with torch.no_grad():
            for i in range(0, min(n, 4 * batch), batch):
                b = {k: torch.as_tensor(v[i:i + batch]).to(bundle.device, torch.int64)
                     for k, v in data.items()}
                losses.append(float(lm.loss_fn(cfg, params, b)[1]["xent"]))
        return {"xent": float(np.mean(losses))}
    return fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-lm")
    ap.add_argument("--smoke", action="store_true", help="use reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--local-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--local-steps", type=int, default=4, help="H")
    ap.add_argument("--block-steps", type=int, default=1,
                    help="H^b: a global sync every H^b rounds, block syncs "
                         "between (Alg. 5)")
    ap.add_argument("--sync-topology", default="auto",
                    choices=["auto", "flat", "hierarchical", "overlap"])
    ap.add_argument("--post-local-switch", type=int, default=-1)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--sync-compression", default="none",
                    choices=["none", "sign", "ef_sign"])
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    cfg = cfg.replace(max_seq_len=args.seq)
    shape = InputShape("cli", args.seq, args.workers * args.local_batch, "train")
    run = RunConfig(
        model=cfg, shape=shape,
        local_sgd=LocalSGDConfig(local_steps=args.local_steps,
                                 block_steps=args.block_steps,
                                 post_local_switch=args.post_local_switch,
                                 sync_compression=args.sync_compression,
                                 sync_topology=args.sync_topology),
        optim=OptimConfig(base_lr=args.lr, base_batch=shape.global_batch,
                          lr_warmup_steps=10,
                          lr_decay_steps=(args.steps // 2, 3 * args.steps // 4)),
        steps=args.steps)

    from repro_torch.launch.steps import build_train
    toks = markov_lm(vocab=cfg.vocab_size, num_seqs=1024, seq_len=args.seq)
    data = lm_examples(toks)
    held = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=64,
                                 seq_len=args.seq, sample_seed=123))
    it = ShardedBatches(data, args.workers, args.local_batch)
    bundle = build_train(run, num_workers=args.workers, device=args.device)
    state, hist, summary = fit(run, it, bundle=bundle, num_steps=args.steps,
                               eval_every=max(args.steps // 5, 1),
                               eval_fn=eval_lm(bundle, held))
    print(f"done: final loss={hist[-1]['loss']:.4f} wall={summary['wall_s']:.1f}s "
          f"comm={summary['comm_rounds']} topology={summary['topology']} "
          f"wire_bytes={summary['ledger']['wire_bytes']:.4g}")


if __name__ == "__main__":
    main()
