"""Training driver: the paper's schedules on top of the step builder (the
port of ``repro.launch.train.fit``).

The communication pattern is decided on the host from the
``LocalSGDConfig`` exactly like the paper's Alg. 1/2/5 outer loops: every
step is a local step, and a sync follows whenever the schedule
(``DynamicSchedule`` over the controller's ``h_at``) says so — a block
sync (Alg. 5's inner mean, level 1) or a global one (level 2).  A
``CommsLedger`` prices every sync from the plan's collective stages.

The controller (``core/controller.py``, ``ControllerConfig.kind``)
closes the loop: at each global sync the telemetry round summary goes
into ``update``, and the :class:`~repro_torch.core.syncplan.PlanDelta` it
emits rewrites the plan (compressor modes, topology), the per-worker
batch (``_scaled_batch``), the LR scale and the block cadence for the
next round.  ``telemetry_path`` gets one JSON line per global round.

The backend (``repro_torch.backend``) owns the worker set: it feeds the
per-worker step times into the round statistics (``worker_step_skew``,
the straggler sensor) and actuates the elastic fields of the delta —
``demote`` / ``promote`` (the census), ``block_steps`` (the cadence) and
``workers`` (a resize: ``core/elastic.resize_state``, a bundle rebuilt
through the backend, a recompiled plan, the data re-partitioned and the
LR co-scaled with the global batch, Lau et al. 2024).

Across processes (``backend.DistributedBackend``, one process a rank)
every rank runs this loop on its own workers' rows of the same batches:
the syncs, metrics, round statistics and eval are reduced over the
ranks, so every rank takes the same decisions, and the ledger's rows
carry the bytes the ranks handed to each collective (``"measured"``).
Only rank 0 logs and writes files.  A resize folds each rank's own rows
(W' a multiple of the worker groups, else ``ValueError`` before anything
changes) and rebuilds the bundle on the same process group; demotion
switches the plan as in one process, its blocks spanning ranks through
sub-groups; ``checkpoint_fn`` gets the whole state in the one-process
layout on rank 0 (``core.local_sgd.gather_state``; the other ranks take
part in the gather and call nothing).  A worker split over shard ranks
(``DistributedBackend(within_worker_size=S, layout=)``) runs the same
loop; eval reads ``mean_params``, which gathers the shard regions.  The
tree path across ranks (``DistributedBackend(use_kernel=False)`` or
``resident=False``, whole workers a rank) runs it on tree states: the
sync layout comes from the stacked leaves, a resize folds each rank's
leaves, and the checkpoint gets the gathered one-process tree state.

With a ``telemetry.trace.Tracer`` the loop is span-instrumented —
``round`` / ``local_steps`` / ``sync`` (+ per-stage ``collective``
attribution) / ``controller`` / ``resize`` / ``eval`` / ``checkpoint`` —
and the sync spans give the ledger its seconds (``record_plan(seconds=)``),
the JSONL its ``round_s`` / ``sync_s`` / ``stage_s`` and the tracer's
metrics registry its step and round series.  Without a tracer every
hook is the null tracer's no-op: the trajectory is the same bit for bit.

CLI:
    PYTHONPATH=src python -m repro_torch.launch.train --steps 40
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --block-steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --controller noise_adaptive
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 4 --trace-dir traced_run   # trace/metrics/manifest/jsonl
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --backend simulated --straggler-s 0.05 --controller elastic
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
        --device cpu --steps 4      # any arch but paper-lm: its smoke config
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --backend distributed --device cpu \
        --smoke --steps 4 --seq 32 --local-batch 2   # 2 ranks x 2 workers
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.backend.local import LocalBackend
from repro_torch.configs.base import (ControllerConfig, InputShape,
                                      LocalSGDConfig, OptimConfig, RunConfig)
from repro_torch.core import elastic, flatbuf
from repro_torch.core import syncplan as splan
from repro_torch.core.controller import (RoundReport, make_controller,
                                         traced_decision)
from repro_torch.core.local_sgd import (gather_state, is_resident, mean_params,
                                        needs_anchor)
from repro_torch.core.schedule import DynamicSchedule
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.models import base as mbase
from repro_torch.models import lm
from repro_torch.telemetry import export as texport
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import trace as ttrace
from repro_torch.telemetry.ledger import CommsLedger
from repro_torch.telemetry.stats import round_summary


def _sync_device(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _scaled_batch(data_iter, scale: int):
    """Concatenate ``scale`` batches along the local-batch dim (axis 1 of
    the (W, B_loc, ...) arrays): the batch-growth actuator."""
    if scale <= 1:
        return next(data_iter)
    parts = [next(data_iter) for _ in range(scale)]
    cat = lambda xs: (torch.cat(xs, dim=1) if isinstance(xs[0], torch.Tensor)
                      else np.concatenate(xs, axis=1))
    return {k: cat([p[k] for p in parts]) for k in parts[0]}


def _mode_str(modes) -> str:
    if modes is None:
        return "config"
    if isinstance(modes, str):
        return modes
    return "|".join(modes)


def _sync_layout(state):
    """The per-worker flatbuf layout of the synced state: a resident
    state's own, a tree state's built from its stacked leaves."""
    if is_resident(state):
        return state.params.layout
    return flatbuf.build_layout(state.params, leading=1)


def _config_plan(run: RunConfig, bundle, state):
    """The config's plan for a bundle that carries none (a hand-made one),
    compiled from the state's own bucket layout."""
    ls = run.local_sgd
    return splan.make_sync_plan(
        _sync_layout(state), num_workers=bundle.num_workers,
        topology=splan.resolve_topology(ls, bundle.num_workers),
        compression=ls.sync_compression, anchored=needs_anchor(ls),
        wire_pack=ls.wire_pack, coalesce=ls.sync_coalesce)


def _worker_census(stats: dict, backend, h: int, measured_s):
    """Add the backend's step-time census to one round's stats; returns the
    per-active-worker seconds (None on a lockstep backend, where the skew
    cannot be observed)."""
    wtimes = backend.worker_step_times(h=h, measured_s=measured_s)
    if wtimes:
        ts = [float(x) for x in wtimes]
        mean_t = sum(ts) / len(ts)
        ws = backend.worker_set
        active = ws.active or ws.ids
        stats["worker_step_s"] = ts
        stats["worker_step_skew"] = ((max(ts) - min(ts)) / mean_t
                                     if mean_t > 0 else 0.0)
        stats["worker_slowest"] = int(
            active[max(range(len(ts)), key=ts.__getitem__)])
        stats.setdefault("num_workers", ws.num_workers)
    # the by-id census covers demoted workers too: the promotion sensor
    by_id = backend.worker_times_by_id(h=h, measured_s=measured_s)
    if by_id:
        stats["worker_step_s_by_id"] = {int(k): float(v)
                                        for k, v in by_id.items()}
    return wtimes


def _measured(bundle, plan, scope: str):
    """The bytes all ranks handed to each collective stage of the sync
    just run (None with every worker in this process)."""
    if bundle.dist is None:
        return None
    return bundle.dist.take_stage_bytes(
        scope, len(plan.collective_stages(scope)))


def fit(run: RunConfig, data_iter, *, bundle=None, num_steps=None, seed=0,
        eval_every=0, eval_fn=None, log=print, params0=None, device=None,
        controller=None, telemetry_path=None, tracer=None,
        checkpoint_every=0, checkpoint_fn=None, manifest_path=None,
        backend=None, layout=None):
    """Run the schedule; returns (state, history, summary).

    ``params0`` is the single-copy param tree to start from (e.g. weights
    carried over from the JAX package with ``repro_torch.convert``); by
    default it is drawn from the specs with a ``torch.Generator`` seeded
    with ``seed``, which also seeds the state's gradient-noise stream.
    ``controller`` overrides the policy built from ``run.controller``;
    ``telemetry_path`` writes one JSON line per global round.
    ``tracer`` (a ``telemetry.trace.Tracer``) span-instruments the loop
    and, when it carries a metrics registry, feeds it; a traced run's
    JSONL records carry ``round_s`` / ``sync_s`` / ``stage_s``, and its
    run manifest goes to ``manifest_path`` (default
    ``<telemetry_path>.manifest.json``).  ``checkpoint_fn(state, step)``
    runs every ``checkpoint_every`` steps inside a ``checkpoint`` span.
    ``backend`` (``repro_torch.backend``) owns the worker set and
    actuates the elastic delta fields (see the module docstring); a resize
    needs a ``data_iter`` with ``.resize(num_workers)``.  ``None`` is a
    ``LocalBackend`` that adopts ``bundle`` (a hand-made bundle without a
    ``worker_set`` warns) or, without one, builds it at
    ``data_iter.W`` workers on ``device``.
    ``layout`` (a ``sharding.layout.MeshLayout`` with its sizes) goes to
    the default ``LocalBackend``: the leaves ride its sharding classes'
    sub-buckets (a backend of the caller's carries its own; across
    processes ``DistributedBackend(within_worker_size=, layout=)``).
    ``summary`` has ``comm_rounds`` ({"block", "global"}), ``wall_s``
    (host clock, ending after a device synchronize), the plan's
    ``topology``, the ``backend``'s census, the number of ``resizes``,
    the ledger's ``summary()`` (ring-model bytes per round, per worker
    set, and ``sync_seconds`` when traced), the ``controller``'s final
    decisions and, when traced, ``trace``.
    """
    if backend is None:
        backend = LocalBackend(
            None if bundle is not None else getattr(data_iter, "W", 1),
            device=bundle.device if bundle is not None else device,
            layout=layout)
    if bundle is None:
        bundle = backend.build(run)
    elif hasattr(backend, "adopt"):
        backend.adopt(bundle)
    dev = bundle.device
    if bundle.dist is not None and checkpoint_every and checkpoint_fn \
            and run.optim.noise_eta > 0 and bundle.dist.layout.num_groups > 1:
        # the snapshot is the one-process format, with one noise stream:
        # worker groups 1.. would replay their draws after a resume
        raise ValueError(
            "fit(checkpoint_fn=) across ranks saves worker group 0's noise "
            f"stream only: with noise_eta={run.optim.noise_eta} and "
            f"{bundle.dist.layout.num_groups} worker groups a resumed run "
            "would replay the other groups' draws; checkpoint without "
            "gradient noise, or run one worker group")
    if bundle.rank != 0:
        # one rank logs and writes files; every rank computes the same
        log = lambda *a, **k: None
        telemetry_path = manifest_path = None
    num_steps = num_steps or run.steps
    ls = run.local_sgd
    if params0 is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params0 = mbase.materialize(bundle.specs, gen, dev,
                                    dtype=getattr(torch, run.model.param_dtype))
    state = bundle.init(params0, seed=seed)
    params0 = None      # the state holds its own copies: free a drawn tree

    controller = controller or make_controller(run, n_comp=bundle.n_comp)
    sched = DynamicSchedule(ls, controller.h_at)
    # round 1 runs under the controller's INITIAL decision: the
    # error-driven compressor policies start uncompressed whatever the
    # config allocated; an identity policy returns the same plan
    plan = bundle.sync_plan
    if plan is None:
        plan = _config_plan(run, bundle, state)
    plan = controller.plan_delta(0).apply(plan)

    tracer = tracer if tracer is not None else ttrace.NULL
    mreg = tracer.metrics
    if tracer.enabled and (manifest_path or telemetry_path):
        # written up front, so a run that fails still names itself
        texport.write_run_manifest(
            manifest_path or f"{telemetry_path}.manifest.json",
            run=run, plan=plan, device=dev)

    ledger = CommsLedger()
    history = []
    comm_rounds = {"block": 0, "global": 0}
    global_rounds = 0
    # the LR multiplier is the controller's lr_scale times the elastic
    # co-scaling (linear in the global batch across resizes, Lau et al.
    # 2024); at 1.0 the step is the two-argument call, so a static run
    # keeps its trajectory bit for bit
    lr_ctrl = 1.0
    lr_resize = 1.0
    lr_scale_now = 1.0
    resizes = 0
    # one "round" span per global round: opened at the round's first
    # local step, closed when its global sync (+ decision) completes
    round_span = None
    tlog = open(telemetry_path, "w") if telemetry_path else None
    t_start = time.perf_counter()
    try:
        for t in range(num_steps):
            h_now = max(int(controller.h_at(t)), 1)
            if round_span is None:
                round_span = tracer.start("round", round=global_rounds + 1,
                                          step=t, h=h_now)
            with tracer.span("local_steps", step=t) as stp:
                batch = _scaled_batch(data_iter, controller.batch_scale())
                if lr_scale_now == 1.0:
                    state, metrics = bundle.local_step(state, batch)
                else:
                    state, metrics = bundle.local_step(state, batch,
                                                       lr_scale_now)
                stp.fence(state)
            if mreg is not None:
                tmetrics.observe_step(mreg, stp.dur_s)
            level = sched.advance(t)
            synced = ""
            if level == 1:
                with tracer.span("sync", scope="block",
                                 topology=plan.topology.describe()) as ssp:
                    state = bundle.sync(state, plan=plan, scope="block")
                    ssp.fence(state)
                stage_s = ttrace.sync_stage_spans(tracer, plan, "block", ssp)
                entry = ledger.record_plan(
                    step=t, level=1, h=h_now, plan=plan, scope="block",
                    seconds=ssp.dur_s, num_workers=bundle.num_workers,
                    measured_bytes=_measured(bundle, plan, "block"))
                comm_rounds["block"] += 1
                synced = "block"
                if mreg is not None:
                    tmetrics.observe_round(
                        mreg, scope="block", h=h_now,
                        wire_bytes=entry["bytes_on_wire"],
                        sync_s=ssp.dur_s, stage_s=stage_s)
            elif level == 2:
                with tracer.span("sync", scope="global",
                                 topology=plan.topology.describe()) as ssp:
                    state = bundle.sync(state, plan=plan, scope="global")
                    ssp.fence(state)
                sync_s = ssp.dur_s
                stage_s = ttrace.sync_stage_spans(tracer, plan, "global", ssp)
                global_rounds += 1
                entry = ledger.record_plan(
                    step=t, level=2, h=h_now, plan=plan, scope="global",
                    batch_scale=controller.batch_scale(),
                    lr_scale=lr_scale_now, seconds=sync_s,
                    num_workers=bundle.num_workers,
                    measured_bytes=_measured(bundle, plan, "global"))
                comm_rounds["global"] += 1
                synced = "global"
                stats = (round_summary(state.stats, dist=bundle.dist)
                         if bundle.telemetry else {})
                wtimes = _worker_census(stats, backend, h_now, stp.dur_s)
                report = RoundReport(
                    round=global_rounds, step=t, h=h_now,
                    loss=float(metrics["loss"]), stats=stats,
                    wire_bytes=entry["bytes_on_wire"],
                    collectives=entry["collectives"])
                delta = traced_decision(tracer, controller, report, t + 1)
                plan = delta.apply(plan)
                if delta.lr_scale is not None:
                    lr_ctrl = float(delta.lr_scale)
                    lr_scale_now = lr_ctrl * lr_resize
                tracer.finish(round_span, loss=report.loss,
                              wire_bytes=report.wire_bytes)
                round_s = round_span.dur_s
                round_span = None
                if mreg is not None:
                    tmetrics.observe_round(
                        mreg, scope="global", h=h_now,
                        wire_bytes=report.wire_bytes, loss=report.loss,
                        batch_scale=controller.batch_scale(),
                        lr_scale=lr_scale_now, round_s=round_s,
                        sync_s=sync_s, stage_s=stage_s,
                        worker_step_s=wtimes)
                if tlog is not None:
                    # None delta fields mean "keep": log the effective
                    # next decision
                    rec = {"round": report.round, "step": t, "h": h_now,
                           "loss": report.loss, **report.stats,
                           "wire_bytes": report.wire_bytes,
                           "collectives": report.collectives,
                           "cum_wire_bytes": ledger.total_bytes(),
                           "next_h": int(delta.h if delta.h is not None
                                         else controller.h_at(t + 1)),
                           "next_compression": _mode_str(delta.compression),
                           "next_batch_scale": int(
                               delta.batch_scale
                               if delta.batch_scale is not None
                               else controller.batch_scale()),
                           "next_lr_scale": lr_scale_now,
                           "topology": plan.topology.describe()}
                    for k in ("workers", "demote", "promote"):
                        if getattr(delta, k) is not None:
                            key = "next_workers" if k == "workers" else k
                            rec[key] = int(getattr(delta, k))
                    if tracer.enabled:
                        # the seconds extension of the schema, keyed by
                        # the stage ids the ledger prices
                        rec["round_s"] = round_s
                        rec["sync_s"] = sync_s
                        rec["stage_s"] = {str(i): s for i, s in stage_s}
                    prov = getattr(controller, "decisions", None)
                    if prov:
                        rec["decisions"] = prov
                    tlog.write(json.dumps(rec) + "\n")
                    tlog.flush()
                # elastic actuation, after the round is recorded: the
                # JSONL and the trace show each decision at the round that
                # made it, and the next round runs under the new census
                if delta.workers is not None \
                        and int(delta.workers) != bundle.num_workers:
                    # a width the ranks cannot take is refused before the
                    # census, the state or the data change
                    backend.check_resize(int(delta.workers))
                if delta.demote is not None:
                    backend.demote(int(delta.demote))
                if delta.promote is not None:
                    backend.promote(int(delta.promote))
                if delta.block_steps is not None:
                    sched.block_steps = int(delta.block_steps)
                if delta.workers is not None \
                        and int(delta.workers) != bundle.num_workers:
                    new_w, old_w = int(delta.workers), bundle.num_workers
                    with tracer.span("resize", step=t, from_workers=old_w,
                                     to_workers=new_w) as rsp:
                        if not hasattr(data_iter, "resize"):
                            raise RuntimeError(
                                f"elastic resize {old_w} -> {new_w} needs a "
                                "resizable data iterator (ShardedBatches or "
                                "any object with .resize(num_workers)); got "
                                f"{type(data_iter).__name__}")
                        # departing workers' momentum / EF memory fold into
                        # the survivors (group mean), joiners are clones
                        state = elastic.resize_state(
                            state, new_w, num_groups=(
                                1 if bundle.dist is None
                                else bundle.dist.layout.num_groups))
                        bundle = backend.resize(run, new_w)
                        # the plan for the new W, with the controller's
                        # current modes; a block size that no longer
                        # divides W is re-derived
                        topo = plan.topology
                        if topo.block_size and new_w % topo.block_size:
                            topo = splan.Topology(
                                topo.kind, splan.default_block_size(new_w))
                        newplan = bundle.sync_plan
                        if newplan is None:
                            newplan = _config_plan(run, bundle, state)
                        plan = newplan.with_modes(plan.modes).with_topology(topo)
                        data_iter.resize(new_w)
                        lr_resize *= new_w / old_w
                        lr_scale_now = lr_ctrl * lr_resize
                        resizes += 1
                        rsp.fence(state)
                    log(f"resize: W {old_w} -> {new_w} at step {t} "
                        f"(lr x{lr_resize:g})")
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=t, synced=synced)
            history.append(rec)
            if eval_every and eval_fn and (t + 1) % eval_every == 0:
                with tracer.span("eval", step=t):
                    ev = eval_fn(state)
                rec.update({f"eval_{k}": float(v) for k, v in ev.items()})
                log(f"step {t+1}: loss={rec['loss']:.4f} "
                    + " ".join(f"eval_{k}={float(v):.4f}" for k, v in ev.items()))
            if checkpoint_every and checkpoint_fn \
                    and (t + 1) % checkpoint_every == 0:
                with tracer.span("checkpoint", step=t) as csp:
                    if bundle.dist is None:
                        csp.fence(checkpoint_fn(state, t))
                    else:
                        full = gather_state(
                            state, bundle.dist,
                            shard_classes=bundle.shard_classes)
                        if full is not None:
                            checkpoint_fn(full, t)
                        del full
                        csp.fence(state)
    finally:
        if round_span is not None:          # training ended mid-round
            tracer.finish(round_span, incomplete=True)
        if tlog is not None:
            tlog.close()
    _sync_device(dev)
    wall = time.perf_counter() - t_start
    summary = {"wall_s": wall, "comm_rounds": comm_rounds, "steps": num_steps,
               "topology": plan.topology.describe(),
               "backend": backend.describe(),
               "resizes": resizes,
               "ledger": ledger.summary(),
               "controller": {"kind": getattr(controller, "kind", "custom"),
                              "h_final": int(controller.h_at(num_steps)),
                              "compression": _mode_str(
                                  controller.compression()),
                              "batch_scale": controller.batch_scale(),
                              "lr_scale": lr_scale_now}}
    if tracer.enabled:
        summary["trace"] = {"spans": len(tracer.spans),
                            "fenced": tracer.fence}
    return state, history, summary


def eval_lm(bundle, data: dict, batch: int = 8):
    """Mean held-out xent of the worker-averaged model."""
    cfg = bundle.cfg

    def fn(state):
        params = mean_params(state, bundle.dist,
                             shard_classes=bundle.shard_classes)
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
    ap.add_argument("--arch", default="paper-lm",
                    help="a registered arch (repro_torch.configs.ARCHS or "
                         "paper-lm); every one but paper-lm at its smoke size")
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
    ap.add_argument("--backend", default="local",
                    choices=["local", "simulated", "distributed"],
                    help="execution backend (repro_torch.backend); simulated "
                         "injects per-worker latency so the straggler "
                         "telemetry has real values on one card")
    ap.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                    help="distributed backend's process group (default: "
                         "gloo with --device cpu, else nccl); gloo lets "
                         "several ranks share one card")
    ap.add_argument("--straggler-s", type=float, default=0.0,
                    help="simulated backend: extra per-step seconds injected "
                         "into the LAST worker (drives the worker_step_skew "
                         "gauge)")
    ap.add_argument("--controller", default="static",
                    choices=["static", "diversity_h", "adaptive_batch",
                             "auto_compress", "noise_adaptive", "elastic"],
                    help="sync controller policy (elastic demotes a "
                         "straggler on the skew gauge); auto_compress needs "
                         "--sync-compression ef_sign")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one)")
    ap.add_argument("--trace-dir", default="",
                    help="write trace.json / metrics.prom / manifest.json / "
                         "telemetry.jsonl for this run (Perfetto + "
                         "Prometheus exports; export.check_trace_dir "
                         "validates them)")
    ap.add_argument("--fence", action="store_true",
                    help="synchronize the card at span boundaries: the "
                         "spans time the work, not its launch (off by "
                         "default)")
    args = ap.parse_args(argv)

    # as the reference's CLI: every arch but paper-lm runs its smoke
    # config here; full-width runs of the others build their config in code
    cfg = (configs.get_smoke(args.arch) if args.smoke or args.arch != "paper-lm"
           else configs.get("paper-lm"))
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
        controller=ControllerConfig(kind=args.controller),
        steps=args.steps)

    from repro_torch.backend import make_backend
    toks = markov_lm(vocab=cfg.vocab_size, num_seqs=1024, seq_len=args.seq)
    data = lm_examples(toks)
    held = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=64,
                                 seq_len=args.seq, sample_seed=123))
    it = ShardedBatches(data, args.workers, args.local_batch)
    be_kw = {"device": args.device}
    if args.backend == "distributed":
        cpu = args.device is not None and torch.device(args.device).type == "cpu"
        be_kw["backend"] = args.dist_backend or ("gloo" if cpu else "nccl")
    if args.backend == "simulated" and args.straggler_s:
        be_kw["latency_s"] = {args.workers - 1: args.straggler_s}
    be = make_backend(args.backend, args.workers, **be_kw)
    try:
        _main_fit(args, run, be, it, held)
    finally:
        if args.backend == "distributed":
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()


def _main_fit(args, run, be, it, held):
    bundle = be.build(run)
    lead = bundle.rank == 0       # across processes only rank 0 prints
    tracer = None
    trace_kw = {}
    if args.trace_dir and lead:
        os.makedirs(args.trace_dir, exist_ok=True)
        tracer = ttrace.Tracer(fence=args.fence, annotate=True,
                               metrics=tmetrics.MetricsRegistry())
        trace_kw = {"tracer": tracer,
                    "telemetry_path": os.path.join(args.trace_dir,
                                                   "telemetry.jsonl"),
                    "manifest_path": os.path.join(args.trace_dir,
                                                  "manifest.json")}
    state, hist, summary = fit(run, it, bundle=bundle, backend=be,
                               num_steps=args.steps,
                               eval_every=max(args.steps // 5, 1),
                               eval_fn=eval_lm(bundle, held), **trace_kw)
    if not lead:
        return
    if tracer is not None:
        texport.write_perfetto(os.path.join(args.trace_dir, "trace.json"),
                               tracer, extra={"wall_s": summary["wall_s"]})
        texport.write_prometheus(os.path.join(args.trace_dir, "metrics.prom"),
                                 tracer.metrics)
        print(f"trace: {len(tracer.spans)} spans -> {args.trace_dir}/ "
              "(trace.json, metrics.prom, manifest.json, telemetry.jsonl)")
    print(f"done: final loss={hist[-1]['loss']:.4f} wall={summary['wall_s']:.1f}s "
          f"comm={summary['comm_rounds']} topology={summary['topology']} "
          f"wire_bytes={summary['ledger']['wire_bytes']:.4g} "
          f"controller={summary['controller']} "
          f"backend={summary['backend']} "
          f"cost_sources={summary['ledger']['cost_sources']}"
          + (f" measured_bytes={summary['ledger']['measured_bytes']:.6g}"
             if "measured_bytes" in summary["ledger"] else ""))


if __name__ == "__main__":
    main()
