"""Traced run: the bytes <-> seconds join on one local-SGD training run
(the twin of the reference's ``examples/traced_run.py``).

    PYTHONPATH=src python -m repro_torch.examples.traced_run [--fence]
    PYTHONPATH=src python -m repro_torch.examples.traced_run --device cpu

One local-SGD fit (sign compression, the 1-bit wire) on the synthetic
cluster-classification MLP with a ``Tracer`` and a ``MetricsRegistry``
threaded through ``fit``; then it writes the artifact set a
``--trace-dir`` run produces (``trace.json`` for ui.perfetto.dev,
``metrics.prom``, ``telemetry.jsonl`` with ``round_s`` / ``sync_s`` /
``stage_s``, ``manifest.json``), re-validates it with
``telemetry.export.check_trace_dir``, and prints the span census and the
per-stage join: each collective stage's ledger bytes next to the trace's
seconds, matched on the stage id.  Spans are unfenced by default
(dispatch time); ``--fence`` synchronizes the device at their ends.
Runs on the card unless ``--device`` says otherwise; the weights come from
``benchmarks.common.mlp_init``'s distributions on a CPU generator seeded
with 0 (``params0`` replaces them).
"""
from __future__ import annotations

import argparse
import json
import pathlib
from collections import Counter

import torch

from repro_torch.benchmarks.common import DIM, dataset, mlp_init, test_acc
from repro_torch.configs.base import (ControllerConfig, InputShape,
                                      LocalSGDConfig, ModelConfig, OptimConfig,
                                      RunConfig)
from repro_torch.convert import params_from_reference
from repro_torch.data.partition import ShardedBatches
from repro_torch.examples.adaptive_local_sgd import WIDTH, make_bundle
from repro_torch.launch.train import fit
from repro_torch.telemetry import export as texport
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.trace import Tracer
from repro_torch.utils import resolve_device

K, B_LOC, STEPS = 8, 32, 64


def make_run(steps: int = STEPS) -> RunConfig:
    return RunConfig(
        model=ModelConfig(name="mlp", family="dense", citation=""),
        shape=InputShape("traced", DIM, K * B_LOC, "train"),
        local_sgd=LocalSGDConfig(local_steps=4, local_momentum=0.9,
                                 sync_compression="sign", wire_pack=True),
        controller=ControllerConfig(kind="static", telemetry=True),
        optim=OptimConfig(base_lr=0.15, base_batch=K * B_LOC,
                          lr_warmup_steps=steps // 20,
                          lr_decay_steps=(steps // 2, 3 * steps // 4),
                          weight_decay=1e-4),
        steps=steps)


def main(argv=None, *, params0=None, log=print) -> dict:
    """Train traced; returns the per-step ``losses``, test accuracy, the
    span census, the stage join, the artifact check's errors (none) and
    the output directory."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fence", action="store_true",
                    help="synchronize the device at span boundaries (true "
                         "wall-clock; breaks dispatch pipelining)")
    ap.add_argument("--out", default="traced_run_example")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None,
                    help="the card by default (raises without one); cpu runs "
                         "the kernels' plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run = make_run(args.steps)
    train, test = dataset()
    if params0 is None:
        log("weights: mlp_init from a CPU generator seeded with 0")
        p0 = {k: v.to(dev) for k, v in
              mlp_init(torch.Generator().manual_seed(0), WIDTH).items()}
    else:
        p0 = params_from_reference(params0, dev)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tr = Tracer(fence=args.fence, annotate=True, metrics=MetricsRegistry())
    state, hist, summary = fit(
        run, ShardedBatches(train, K, B_LOC), bundle=make_bundle(run, dev),
        num_steps=args.steps, params0=p0, tracer=tr, log=log,
        telemetry_path=str(out / "telemetry.jsonl"),
        manifest_path=str(out / "manifest.json"))
    texport.write_perfetto(str(out / "trace.json"), tr,
                           extra={"wall_s": summary["wall_s"]})
    texport.write_prometheus(str(out / "metrics.prom"), tr.metrics)
    errs = texport.check_trace_dir(str(out))
    if errs:
        raise AssertionError(f"the artifacts fail their schema: {errs}")
    acc = test_acc(state, test)
    log(f"test acc {acc:.3f}, final loss {hist[-1]['loss']:.4f}, wall "
        f"{summary['wall_s']:.2f}s "
        f"({'fenced' if args.fence else 'unfenced: dispatch time'})")
    log(f"\nspan census ({summary['trace']['spans']} spans -> "
        f"{out}/trace.json, load in ui.perfetto.dev):")
    census = {}
    for name, n in sorted(Counter(s.name for s in tr.spans).items()):
        tot = sum(s.dur_s or 0.0 for s in tr.spans if s.name == name)
        census[name] = {"count": n, "seconds": tot}
        log(f"  {name:<12} x{n:<4} {tot * 1e3:8.1f} ms total")
    # the join: ledger stage rows (bytes) x trace stage spans (seconds),
    # matched on the shared stage id
    recs = [json.loads(ln) for ln in open(out / "telemetry.jsonl")]
    stage_bytes: dict = {}
    for sp in tr.spans:
        if sp.name == "collective":
            stage_bytes.setdefault(sp.attrs["stage"], sp.attrs["wire_bytes"])
    stage_secs: dict = {}
    for r in recs:
        for k, v in r["stage_s"].items():
            stage_secs[int(k)] = stage_secs.get(int(k), 0.0) + v
    log("\nper-stage bytes<->seconds join "
        f"(sync_seconds={summary['ledger']['sync_seconds']:.3f}s):")
    log(f"  {'stage':>5} {'wire bytes/round':>17} {'seconds total':>14}")
    join = {}
    for sid in sorted(stage_secs):
        join[sid] = (stage_bytes.get(sid, 0), stage_secs[sid])
        log(f"  {sid:>5} {join[sid][0]:>17.0f} {join[sid][1]:>14.4f}")
    log(f"\nartifacts validated under {out}/ "
        "(trace.json, metrics.prom, telemetry.jsonl, manifest.json)")
    return {"losses": [h["loss"] for h in hist], "acc": acc,
            "census": census, "join": join, "errors": errs,
            "rounds": summary["ledger"]["sync_rounds"],
            "wire_bytes": summary["ledger"]["wire_bytes"],
            "out": str(out), "device": str(dev)}


if __name__ == "__main__":
    main()
