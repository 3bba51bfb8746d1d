"""Noise-adaptive frontier: ONE run traverses the paper's trade-off (the
twin of the reference's ``examples/noise_adaptive_frontier.py``).

    PYTHONPATH=src python -m repro_torch.examples.noise_adaptive_frontier
    PYTHONPATH=src python -m repro_torch.examples.noise_adaptive_frontier --device cpu

The paper's Tables 2/4 sweep static (H, compression, batch) points; the
composite ``noise_adaptive`` controller walks that frontier online in a
single run from one telemetry stream: it starts mini-batch-like (H=1,
uncompressed, batch and LR scale 1), ramps H up as the gradient
diversity collapses, turns the 1-bit EF-sign wire on once the measured
compression error fits the budget, and grows the per-worker batch while
the total batch is noise-dominated, handing off to LR decay at the cap.

Workload: the synthetic cluster-classification MLP
(``repro_torch.benchmarks.common``).  Two runs, same data and step
budget: ``static_h1`` (H=1, dense sync) and ``noise_adaptive``.  Prints
the traversed frontier per round and the acceptance checks: ends H>=8
and compressed, >=5x fewer wire bytes than static H=1, test accuracy no
worse.  Runs on the card unless ``--device`` says otherwise; the weights
come from ``benchmarks.common.mlp_init``'s distributions on a CPU
generator seeded with 0 (``params0`` replaces them).
"""
from __future__ import annotations

import argparse
import json
import pathlib

import torch

from repro_torch.benchmarks.common import DIM, dataset, mlp_init, test_acc
from repro_torch.configs.base import (ControllerConfig, InputShape,
                                      LocalSGDConfig, ModelConfig, OptimConfig,
                                      RunConfig)
from repro_torch.convert import params_from_reference
from repro_torch.data.partition import ShardedBatches
from repro_torch.examples.adaptive_local_sgd import WIDTH, make_bundle
from repro_torch.launch.train import fit
from repro_torch.utils import resolve_device

K, B_LOC, STEPS = 8, 64, 160

NOISE_ADAPTIVE = ControllerConfig(kind="noise_adaptive", h0=1, h_max=16,
                                  low=0.55, high=1.8, err_budget=0.9,
                                  patience=1, max_batch_scale=8,
                                  noise_grow=0.25, lr_cap_decay=0.5,
                                  lr_scale_min=0.1)
RUNS = (("static_h1", LocalSGDConfig(local_steps=1),
         ControllerConfig(kind="static", telemetry=True), "frontier_h1"),
        ("noise_adaptive",
         LocalSGDConfig(local_steps=1, sync_compression="ef_sign",
                        wire_pack=True),
         NOISE_ADAPTIVE, "frontier_noise_adaptive"))


def make_run(ls, controller, steps: int = STEPS) -> RunConfig:
    return RunConfig(
        model=ModelConfig(name="mlp", family="dense", citation=""),
        shape=InputShape("frontier", DIM, K * B_LOC, "train"),
        local_sgd=ls, controller=controller,
        optim=OptimConfig(base_lr=0.15, base_batch=K * B_LOC,
                          lr_warmup_steps=steps // 20,
                          lr_decay_steps=(steps // 2, 3 * steps // 4),
                          weight_decay=1e-4),
        steps=steps)


def main(argv=None, *, params0=None, log=print) -> dict:
    """Run both; returns their rows (test acc, final loss, per-step
    ``losses``, sync rounds, wire MB, the controller's final state), the
    adaptive run's JSONL ``frontier`` and the acceptance ``checks``."""
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
    if params0 is None:
        log("weights: mlp_init from a CPU generator seeded with 0")
        p0 = mlp_init(torch.Generator().manual_seed(0), WIDTH)
    rows = []
    for name, ls, cc, jsonl in RUNS:
        run = make_run(ls, cc, args.steps)
        p = ({k: v.to(dev) for k, v in p0.items()} if params0 is None
             else params_from_reference(params0, dev))
        state, hist, summary = fit(run, ShardedBatches(train, K, B_LOC),
                                   bundle=make_bundle(run, dev),
                                   num_steps=args.steps, params0=p,
                                   telemetry_path=tdir / f"{jsonl}.jsonl",
                                   log=log)
        rows.append({"name": name, "acc": test_acc(state, test),
                     "loss": hist[-1]["loss"],
                     "losses": [h["loss"] for h in hist],
                     "rounds": summary["ledger"]["sync_rounds"],
                     "wire_mb": summary["ledger"]["wire_bytes"] / 1e6,
                     "controller": summary["controller"]})
    base, adapt = rows
    log(f"\n{'config':<16} {'test acc':>9} {'final loss':>11} "
        f"{'sync rounds':>12} {'wire MB':>10}")
    for r in rows:
        log(f"{r['name']:<16} {r['acc']:>9.3f} {r['loss']:>11.4f} "
            f"{r['rounds']:>12d} {r['wire_mb']:>10.3f}")
    recs = [json.loads(ln)
            for ln in open(tdir / "frontier_noise_adaptive.jsonl")]
    log(f"\ntraversed frontier ({tdir}/frontier_noise_adaptive.jsonl):")
    log(f"  {'round':>5} {'h':>3} {'batch':>6} {'lr_scale':>8} "
        f"{'modes':>18} {'B_noise/B':>10}")
    for r in recs:
        bn = r.get("noise_ratio", 0.0) * (B_LOC * r["next_batch_scale"])
        ratio = bn / (K * B_LOC * r["next_batch_scale"])
        # signal_sq ~ 0 rounds (pure noise) give unbounded ratios
        cell = f"{ratio:.2f}" if ratio < 1e3 else ">1e3"
        log(f"  {r['round']:>5} {r['h']:>3} {r['next_batch_scale']:>6} "
            f"{r['next_lr_scale']:>8.3f} {r['next_compression']:>18} "
            f"{cell:>10}")
    first, last = recs[0], recs[-1]
    reduction = base["wire_mb"] / max(adapt["wire_mb"], 1e-9)
    checks = [
        # round 1 syncs before any decision lands: H=1, uncompressed (its
        # wire bytes the dense f32 payload), batch and LR scale 1
        ("starts H=1 uncompressed batch x1",
         first["h"] == 1 and first["next_batch_scale"] == 1
         and first["wire_bytes"] > 5 * last["wire_bytes"]),
        ("ends H>=8", last["h"] >= 8),
        ("ends compressed", "sign" in last["next_compression"]),
        ("ends large-batch (scale>1)", last["next_batch_scale"] > 1),
        (">=5x wire reduction vs static H=1", reduction >= 5.0),
        ("test acc no worse than static H=1 (-1% tol)",
         adapt["acc"] >= base["acc"] - 0.01),
    ]
    log(f"\nnoise_adaptive vs static H=1: {reduction:.1f}x fewer wire bytes "
        f"at test acc {adapt['acc']:.3f} vs {base['acc']:.3f}")
    for name, passed in checks:
        log(f"  [{'ok' if passed else 'FAIL'}] {name}")
    return {"rows": rows, "frontier": recs, "reduction": reduction,
            "checks": [(n, bool(p)) for n, p in checks],
            "ok": all(p for _, p in checks), "device": str(dev)}


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
