"""Layer-period probe (the port of ``repro.roofline.probe``).

The reference compiles the same train step with 1 and 2 unrolled
layer-periods and extrapolates, because collectives inside its scan
bodies are printed once.  The port has no scan, but the same two probes
price a depth without tracing it: the step at 1 and 2 periods
(``len(cfg.blocks)`` layers), then

    value(L) = fixed + slope * (L / period)

for the FLOPs and the bytes saved for the backward (traced on the
``meta`` device, ``launch.dryrun.trace_train``), the local step's
within-worker collective bytes (the layout's ring model), and, on the
card, the step's seconds (host clock ending in a device synchronize,
``launch.train.fit`` as the trainer runs it).  Layers of one period are
identical, so the FLOPs and saved bytes extrapolate exactly.

    PYTHONPATH=src python -m repro_torch.roofline.probe --arch qwen3-32b \\
        --shape train_4k --layout fsdp --device meta
    PYTHONPATH=src python -m repro_torch.roofline.probe --arch paper-lm \\
        --workers 4 --local-batch 8 --seq 512 --steps 4      # on the card

Writes ``--out`` (default ``build/probes/``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.configs.base import (INPUT_SHAPES, InputShape, LocalSGDConfig,
                                      RunConfig)
from repro_torch.launch.dryrun import grid_step, trace_train
from repro_torch.launch.mesh import make_production_grid
from repro_torch.utils import resolve_device

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "probes"


def extrapolate(m1: dict, m2: dict, n_units: float, keys) -> dict:
    """``fixed + slope * n_units`` of each key, from its values at 1 and 2
    units."""
    out = {}
    for key in keys:
        slope = m2[key] - m1[key]
        fixed = m1[key] - slope
        out[f"{key}_per_period"] = slope
        out[f"{key}_fixed"] = fixed
        out[f"{key}_full"] = fixed + slope * n_units
    return out


def _grid_measure(cfg, shape, grid, layout_kind) -> dict:
    gs = grid_step(cfg, shape, grid, layout_kind)
    coll, t, share = gs["state"]["step_collectives"], gs["trace"], gs["share"]
    return {"coll_bytes": coll["moved_bytes"], "coll_by_op": coll["by_op"],
            "flops": t["flops"] * share, "saved_bytes": t["saved_bytes"] * share,
            "workers": gs["W"]}


def probe_train(arch: str, shape_name: str = "train_4k",
                layout_kind: str = "tp", *, multi_pod: bool = False) -> dict:
    """A card's counts on the production grid at 1 and 2 layer-periods of
    ``arch``, extrapolated to its depth."""
    grid = make_production_grid(multi_pod=multi_pod)
    cfg_full = configs.get(arch)
    shape = INPUT_SHAPES[shape_name]
    period = len(cfg_full.blocks)
    m1 = _grid_measure(cfg_full.replace(num_layers=period), shape, grid,
                       layout_kind)
    m2 = _grid_measure(cfg_full.replace(num_layers=2 * period), shape, grid,
                       layout_kind)
    out = {"arch": arch, "shape": shape_name, "layout": layout_kind,
           "mesh": grid.shape, "workers": m1["workers"], "period": period}
    out.update(extrapolate(m1, m2, cfg_full.num_layers / period,
                           ("coll_bytes", "flops", "saved_bytes")))
    out["probe1"] = m1
    out["probe2"] = m2
    return out


def step_seconds(run: RunConfig, *, workers: int, device, steps: int,
                 seed: int = 0) -> list:
    """Host seconds of each of ``steps`` local steps of ``fit`` (markov
    data, weights from ``seed``), each from one step's start to the
    next's with a device synchronize before each, the sync included on
    sync steps."""
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import build_train

    dev = torch.device(device)
    B = run.shape.global_batch // workers
    data = lm_examples(markov_lm(vocab=run.model.vocab_size,
                                 num_seqs=workers * B * 4,
                                 seq_len=run.shape.seq_len, seed=seed))
    bundle = build_train(run, num_workers=workers, device=dev)
    marks = []
    step = bundle.local_step

    def timed(*args):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks.append(time.perf_counter())
        return step(*args)

    bundle.local_step = timed
    _, _, summ = ttrain.fit(run, ShardedBatches(data, workers, B, seed=seed),
                            bundle=bundle, num_steps=steps, seed=seed,
                            log=lambda *a: None)
    marks.append(summ["wall_s"] + marks[0])
    return [b - a for a, b in zip(marks, marks[1:])]


def _card_measure(run: RunConfig, *, workers: int, device, steps: int) -> dict:
    cfg = run.model
    t = trace_train(cfg, run.shape.global_batch // workers, run.shape.seq_len,
                    device="meta")
    out = {"flops": workers * t["flops"], "saved_bytes": t["saved_bytes"],
           "coll_bytes": 0.0}
    if steps:
        s = step_seconds(run, workers=workers, device=device, steps=steps)
        out["step_s"] = s
        out["step_s_median"] = statistics.median(s[1:])
    return out


def probe_card(run: RunConfig, *, workers: int, device="meta",
               steps: int = 0) -> dict:
    """``run`` on one card (all ``workers`` on it) at 1 and 2 layer-periods
    of ``run.model``, extrapolated to its depth: FLOPs of a step (W
    workers), one worker's saved bytes and, with ``steps`` on a device
    that runs, the median step seconds (the first step left out)."""
    cfg_full = run.model
    period = len(cfg_full.blocks)
    ms = [_card_measure(dataclasses.replace(
                            run, model=cfg_full.replace(num_layers=n)),
                        workers=workers, device=device, steps=steps)
          for n in (period, 2 * period)]
    keys = ("flops", "saved_bytes", "coll_bytes") + (
        ("step_s_median",) if steps else ())
    out = {"arch": cfg_full.name, "layers": cfg_full.num_layers,
           "workers": workers, "period": period,
           "local_batch": run.shape.global_batch // workers,
           "seq": run.shape.seq_len}
    out.update(extrapolate(ms[0], ms[1], cfg_full.num_layers / period, keys))
    out["probe1"], out["probe2"] = ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--workers", type=int, help="one card: W workers on it")
    ap.add_argument("--local-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=0,
                    help="one card: time this many steps at each probe depth")
    ap.add_argument("--device", help="meta | cpu | cuda (default: the card)")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.workers:
        if args.steps and device.type == "meta":
            ap.error("--steps needs a device that runs (cuda or cpu)")
        run = RunConfig(
            model=configs.get(args.arch),
            shape=InputShape("probe", args.seq, args.workers * args.local_batch,
                             "train"),
            local_sgd=LocalSGDConfig(local_steps=4, post_local_switch=4))
        out = probe_card(run, workers=args.workers, device=device,
                         steps=args.steps)
        name = f"{args.arch}__card_{args.workers}x{args.local_batch}x{args.seq}"
    else:
        if device.type != "meta":
            ap.error("the grid probe traces on --device meta")
        out = probe_train(args.arch, args.shape, args.layout,
                          multi_pod=args.multi_pod)
        name = f"{args.arch}__{args.shape}__{args.layout}"
    print(json.dumps({k: v for k, v in out.items()
                      if not k.startswith("probe")}, indent=1))
    path = Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    (path / f"{name}.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
