"""Adaptive local SGD: the paper's trade-off frontier as one run (the twin
of the reference's ``examples/adaptive_local_sgd.py``).

    PYTHONPATH=src python -m repro_torch.examples.adaptive_local_sgd
    PYTHONPATH=src python -m repro_torch.examples.adaptive_local_sgd --device cpu

The paper's Table 2 / Table 4 sweep static configurations (H,
compression); with telemetry and a controller one adaptive run walks the
frontier online: ``diversity_h`` grows H as the measured gradient
diversity collapses, ``auto_compress`` turns the sign / EF-sign
compressor on once its measured error fits the budget.

Workload: the synthetic cluster-classification MLP the paper harness uses
as its CIFAR / ResNet-20 stand-in (``repro_torch.benchmarks.common``).
Four configurations, same data and step budget: constant H=1 (mini-batch
SGD), constant H=8, ``diversity_h``, and ``auto_compress`` (H=4, 1-bit
wire).  Prints held-out accuracy against the ledger's wire bytes and the
adaptive trajectories from the telemetry JSONL (``--telemetry-dir``).
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.backend.base import WorkerSet
from repro_torch.benchmarks.common import CLASSES, DIM, dataset, mlp_loss, test_acc
from repro_torch.configs.base import (ControllerConfig, InputShape,
                                      LocalSGDConfig, ModelConfig, OptimConfig,
                                      RunConfig)
from repro_torch.convert import params_from_reference
from repro_torch.core.local_sgd import make_local_sgd
from repro_torch.data.partition import ShardedBatches
from repro_torch.launch.steps import TrainBundle
from repro_torch.launch.train import fit
from repro_torch.models.base import ParamSpec
from repro_torch.utils import resolve_device

K, B_LOC, STEPS, WIDTH = 8, 64, 160, 128


def mlp_specs(width=WIDTH):
    """The ParamSpec tree of ``benchmarks.common.mlp_init``'s MLP."""
    return {"w1": ParamSpec((DIM, width), (None, None)),
            "b1": ParamSpec((width,), (None,), init="zeros"),
            "w2": ParamSpec((width, width), (None, None)),
            "b2": ParamSpec((width,), (None,), init="zeros"),
            "w3": ParamSpec((width, CLASSES), (None, None)),
            "b3": ParamSpec((CLASSES,), (None,), init="zeros")}


def make_bundle(run: RunConfig, device) -> TrainBundle:
    """The MLP on the port's resident path (one f32 bucket: one compressor
    error slot)."""
    cc = run.controller
    init, local_step, sync = make_local_sgd(
        run, mlp_loss, num_workers=K, telemetry=cc.wants_telemetry,
        speculate_compression=cc.wants_speculation)
    return TrainBundle(cfg=run.model, run=run, num_workers=K,
                       specs=mlp_specs(), init=init, local_step=local_step,
                       sync=sync, device=device, telemetry=cc.wants_telemetry,
                       worker_set=WorkerSet.of(K))


def make_run(ls, controller, steps: int = STEPS) -> RunConfig:
    return RunConfig(
        model=ModelConfig(name="mlp", family="dense", citation=""),
        shape=InputShape("adapt", DIM, K * B_LOC, "train"),
        local_sgd=ls, controller=controller,
        optim=OptimConfig(base_lr=0.15, base_batch=K * B_LOC,
                          lr_warmup_steps=steps // 20,
                          lr_decay_steps=(steps // 2, 3 * steps // 4),
                          weight_decay=1e-4),
        steps=steps)


# (name, LocalSGDConfig, ControllerConfig, JSONL name) of the four runs
CONFIGS = (
    ("minibatch_h1", LocalSGDConfig(local_steps=1),
     ControllerConfig(kind="static", telemetry=True), "h1"),
    ("static_h8", LocalSGDConfig(local_steps=8),
     ControllerConfig(kind="static", telemetry=True), "h8"),
    ("diversity_h", LocalSGDConfig(local_steps=1),
     ControllerConfig(kind="diversity_h", h0=1, h_max=16, low=0.45, high=0.8),
     "diversity_h"),
    ("auto_compress",
     LocalSGDConfig(local_steps=4, sync_compression="ef_sign", wire_pack=True),
     ControllerConfig(kind="auto_compress", err_budget=0.9, patience=1),
     "auto_compress"),
)


def main(argv=None, *, params0=None, log=print) -> dict:
    """Run the four configurations; returns their ``rows`` (test acc, final
    loss, per-step ``losses``, sync rounds, wire MB, the controller's
    final state) and the adaptive ``trajectories``.  ``params0`` (numpy
    tree) replaces the weights every run draws from seed 0."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--telemetry-dir", default="telemetry")
    ap.add_argument("--device", default=None,
                    help="the card by default (raises without one); cpu runs "
                         "the kernels' plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    train, test = dataset()
    tdir = pathlib.Path(args.telemetry_dir)
    tdir.mkdir(parents=True, exist_ok=True)
    rows = []
    for name, ls, cc, jsonl in CONFIGS:
        run = make_run(ls, cc, args.steps)
        p0 = None if params0 is None else params_from_reference(params0, dev)
        state, hist, summary = fit(run, ShardedBatches(train, K, B_LOC),
                                   bundle=make_bundle(run, dev),
                                   num_steps=args.steps, params0=p0,
                                   telemetry_path=tdir / f"{jsonl}.jsonl",
                                   log=log)
        rows.append({"name": name, "acc": test_acc(state, test),
                     "loss": hist[-1]["loss"],
                     "losses": [h["loss"] for h in hist],
                     "rounds": summary["ledger"]["sync_rounds"],
                     "wire_mb": summary["ledger"]["wire_bytes"] / 1e6,
                     "controller": summary["controller"]})

    log(f"\n{'config':<16} {'test acc':>9} {'final loss':>11} "
        f"{'sync rounds':>12} {'wire MB':>10}")
    for r in rows:
        log(f"{r['name']:<16} {r['acc']:>9.3f} {r['loss']:>11.4f} "
            f"{r['rounds']:>12d} {r['wire_mb']:>10.3f}")
    log(f"\nadaptive trajectories ({tdir}/*.jsonl):")
    traj = {}
    for name in ("diversity_h", "auto_compress"):
        recs = [json.loads(l) for l in open(tdir / f"{name}.jsonl")]
        traj[name] = {"h": [r["h"] for r in recs]}
        log(f"  {name}: H per round = {traj[name]['h']}")
        if name == "auto_compress":
            traj[name]["next_compression"] = [r["next_compression"]
                                              for r in recs]
            log(f"  {name}: next mode per round = "
                f"{traj[name]['next_compression']}")
        else:
            traj[name]["diversity"] = [round(r.get("diversity", 0.0), 3)
                                       for r in recs]
            log(f"  {name}: diversity per round = {traj[name]['diversity']}")
    base = next(r for r in rows if r["name"] == "minibatch_h1")
    adapt = next(r for r in rows if r["name"] == "diversity_h")
    log(f"\ndiversity_h vs H=1: "
        f"{base['wire_mb'] / max(adapt['wire_mb'], 1e-9):.1f}x fewer wire "
        f"bytes at test acc {adapt['acc']:.3f} vs {base['acc']:.3f}")
    return {"rows": rows, "trajectories": traj, "device": str(dev)}


if __name__ == "__main__":
    main()
