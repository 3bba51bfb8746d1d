"""Local SGD / post-local SGD on resident flat-bus buckets — the paper's core
(the port of the resident path of ``repro.core.local_sgd``).

Representation: params, momentum and EF memory are ``flatbuf.BucketState``
s of stacked ``(W, rows, 128)`` buffers, one row block per worker on the
same card; the anchor (the last synced model) is a single-copy
``BucketState``.  The buckets are the single source of truth between
syncs — the tree view exists only at ``unpack_state`` / ``mean_params``.

* ``local_step`` differentiates each worker's loss with respect to its
  param BUCKET (the model reads views into it,
  ``flatbuf.unflatten_grad_into``), so each worker's gradient lands once
  in its row of the stacked grad bucket, with exact-zero padding;
  optional isotropic gradient noise (``noise_eta > 0``) is added there,
  masked off the padding; then ONE fused update launch per bucket
  updates all W workers in place: SGD (plus one ``sq_sum`` launch per
  bucket for the per-worker grad clip) or LARS (plus one
  ``lars_row_norms`` launch per bucket for the trust ratios; no clip).
  Workers run one after another in a Python loop where the reference
  uses ``vmap``.  ``lr_scale`` multiplies the scheduled lr (the
  controllers' LR actuator).
* ``sync`` executes one scope of a :class:`~repro_torch.core.syncplan.SyncPlan`
  (flat, hierarchical or overlap topology): the no-anchor mean sync
  averages the worker copies in place, over all W at global scope or over
  blocks of consecutive workers at the Alg. 5 block scope; the anchored
  sign / EF-sign sync (global scope only) forms the per-worker delta
  against the anchor, compresses it (two kernel launches per bucket),
  averages it and steps the anchor, then broadcasts the new anchor into
  every worker.  Stages run in the plan's order, and every order a
  topology emits is a topological order of the same per-bucket dataflow:
  overlap gives flat's bits.

With telemetry (``make_local_sgd(..., telemetry=True)``) ``state.stats``
carries a ``telemetry.stats.StatsAccumulator``: the per-worker grad and
update norms come from the update launch's ``stats=True`` form, and each
global sync (block syncs record nothing) records its pre-/post-mean norm
pair and per-bucket compression error.  With ``speculate_compression``
(the compression-escalating controllers) a global sync also measures,
for every bucket it sends uncompressed, the error the sign compressor
WOULD make: the controller's turn-on signal.

The update is in place: ``local_step`` and ``sync`` return a state that
shares (and has mutated) the buffers of the one they were given.

Not ported yet, and raising ``NotImplementedError``: the 1-bit wire pack
and coalesced collectives, the elastic controller (it needs workers
across GPUs) and the per-leaf tree path.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import LocalSGDConfig, RunConfig
from repro_torch.core import compression as comp
from repro_torch.core import flatbuf
from repro_torch.core import syncplan as splan
from repro_torch.core.controller import ELASTIC_NOT_PORTED
from repro_torch.core.schedule import lr_at
from repro_torch.optim.lars import apply_lars_buckets
from repro_torch.optim.sgd import apply_sgd_buckets
from repro_torch.telemetry import stats as tstats


@dataclass
class LocalSGDState:
    params: Any          # BucketState, stacked (W, rows, 128)
    momentum: Any        # BucketState, stacked
    anchor: Any          # BucketState, single copy (last synced model) or None
    global_u: Any        # BucketState, single copy, or None
    ef_memory: Any       # BucketState, stacked, or None
    step: int = 0
    stats: Any = None    # telemetry.stats.StatsAccumulator or None
    rng: Any = None      # torch.Generator on the training device (noise)


def needs_anchor(cfg: LocalSGDConfig) -> bool:
    return cfg.global_momentum > 0 or cfg.sync_compression != "none"


def unpack_state(state: LocalSGDState) -> LocalSGDState:
    """The tree view of a resident state (tensors are views of the buckets)."""
    up = lambda x: x.unpack() if flatbuf.is_bucket_state(x) else x
    return LocalSGDState(params=up(state.params), momentum=up(state.momentum),
                         anchor=up(state.anchor), global_u=up(state.global_u),
                         ef_memory=up(state.ef_memory), step=state.step,
                         stats=state.stats, rng=state.rng)


def mean_params(state: LocalSGDState):
    """Single-copy tree of the worker-averaged model (eval boundary)."""
    return flatbuf.unflatten(state.params.layout,
                             [b.mean(dim=0) for b in state.params.buckets])


def _sumsq(x, *, from_axis: int = 0):
    """f32 sum of squares over all dims from ``from_axis`` on (telemetry)."""
    xf = x.float()
    return (xf * xf).sum(dim=tuple(range(from_axis, x.dim())))


def group_mean(x, group: int):
    """Mean over blocks of ``group`` consecutive workers, broadcast back."""
    W = x.shape[0]
    assert W % group == 0, (W, group)
    if group == 1:
        return x
    xg = x.reshape(W // group, group, *x.shape[1:])
    m = xg.mean(dim=1, keepdim=True)
    return m.expand(xg.shape).reshape(x.shape)


def _bucket_noise(layout, gbs, gen, *, step: int, eta: float, gamma: float):
    """Isotropic gradient noise straight on one worker's grad buckets, in
    place: g += sigma_t * N(0, 1), sigma_t = sqrt(eta / (1+t)^gamma), the
    schedule of :func:`repro_torch.core.noise.isotropic_noise`.  The draw
    comes from the explicit generator ``gen`` (one stream per state, so
    one seed gives the same bits) and is masked, so padding stays exactly
    zero.  Keyed per bucket, not per leaf: the same N(0, sigma_t^2) per
    element as the reference's bucket noise, but another stream, so noisy
    runs compare with it statistically, never bitwise."""
    if eta <= 0:
        return gbs
    sigma = math.sqrt(eta / (1.0 + step) ** gamma)
    for b, g in enumerate(gbs):
        n = torch.randn(g.shape, generator=gen, dtype=torch.float32,
                        device=g.device)
        g.add_(flatbuf.mask_padding(layout, b, n).mul_(sigma).to(g.dtype))
    return gbs


def _to_device(v, dev):
    """One batch field on ``dev``: integers as int64 (token ids, labels),
    floating values as float32 (features, +-1 targets), values intact."""
    t = torch.as_tensor(v)
    return t.to(dev, torch.float32 if t.is_floating_point() else torch.int64)


def _worker_grad(layout, loss_fn, pbs_w, batch_w, gw):
    """One worker's loss on its param buckets ``pbs_w``; the gradient lands
    in ``gw`` (zeroed grad buckets) once, through
    ``flatbuf.unflatten_grad_into``.  Returns (loss, metrics)."""
    src = [b.detach().requires_grad_(True) for b in pbs_w]
    loss, metrics = loss_fn(flatbuf.unflatten_grad_into(layout, src, gw),
                            batch_w)
    torch.autograd.grad(loss, src)
    return loss, metrics


def _check_supported(run: RunConfig):
    ls, opt = run.local_sgd, run.optim
    if opt.optimizer not in ("sgd", "lars"):
        raise NotImplementedError(f"optimizer {opt.optimizer!r} is not ported yet")
    if ls.wire_pack or ls.sync_coalesce:
        raise NotImplementedError("the 1-bit wire pack and coalesced "
                                  "collectives are not ported yet")
    if run.controller.kind == "elastic":
        raise NotImplementedError(ELASTIC_NOT_PORTED)


def make_local_sgd(run: RunConfig, loss_fn: Callable, *, num_workers: int,
                   wd_mask=None, telemetry: bool = False,
                   speculate_compression: bool = False):
    """Build (init, local_step, sync) for a single-worker
    ``loss_fn(params, batch) -> (loss, metrics)`` on resident buckets.
    ``telemetry`` carries a ``StatsAccumulator`` in ``state.stats``; it
    observes only, the trajectory is the same with it on or off.
    ``speculate_compression`` (with telemetry) records the would-be sign
    error of every bucket a global sync sends uncompressed."""
    _check_supported(run)
    ls = run.local_sgd
    opt = run.optim
    W = num_workers
    global_batch = run.shape.global_batch

    def init(params_single, seed: int = 0) -> LocalSGDState:
        """Enter resident form from a single-copy param tree (tensors on
        the training device); ``seed`` seeds the state's generator (the
        gradient noise's stream)."""
        layout = flatbuf.build_layout(params_single, wd_mask=wd_mask)
        pb = flatbuf.flatten(layout, params_single)
        stacked = lambda: tuple(b[None].repeat(W, 1, 1) for b in pb)
        zeros = lambda: tuple(torch.zeros((W,) + b.shape, dtype=b.dtype,
                                          device=b.device) for b in pb)
        return LocalSGDState(
            params=flatbuf.BucketState(layout, stacked(), leading=1),
            momentum=flatbuf.BucketState(layout, zeros(), leading=1),
            anchor=(flatbuf.BucketState(layout, tuple(b.clone() for b in pb))
                    if needs_anchor(ls) else None),
            global_u=(flatbuf.BucketState(layout, tuple(torch.zeros_like(b)
                                                        for b in pb))
                      if ls.global_momentum > 0 else None),
            ef_memory=(flatbuf.BucketState(layout, zeros(), leading=1)
                       if ls.sync_compression == "ef_sign" else None),
            step=0,
            stats=(tstats.init_stats(W, layout.num_buckets, pb[0].device)
                   if telemetry else None),
            rng=torch.Generator(device=pb[0].device).manual_seed(seed))

    def local_step(state: LocalSGDState, batch, lr_scale=None):
        """One local step of every worker.  ``batch``: dict of (W, B_loc,
        ...) arrays (numpy or tensors); integer fields reach ``loss_fn``
        as int64, floating ones as float32.  ``lr_scale`` multiplies
        the scheduled lr (in float32, as the reference does); ``None``
        keeps the two-argument call's trajectory bit for bit."""
        layout = state.params.layout
        pbs = list(state.params.buckets)
        dev = pbs[0].device
        lr = lr_at(opt, state.step, global_batch=global_batch)
        if lr_scale is not None:
            lr = lr * np.float32(lr_scale)
        batch = {k: _to_device(v, dev) for k, v in batch.items()}
        # every worker's gradient lands in its row once; zeroed here once
        # for all W, so the padding is exact zero
        gbs = [torch.zeros_like(b) for b in pbs]
        losses, metrics_w = [], []
        for w in range(W):
            gw = [g[w] for g in gbs]
            loss, metrics = _worker_grad(layout, loss_fn, [b[w] for b in pbs],
                                         {k: v[w] for k, v in batch.items()},
                                         gw)
            if opt.noise_eta > 0:
                _bucket_noise(layout, gw, state.rng, step=state.step,
                              eta=opt.noise_eta, gamma=opt.noise_gamma)
            losses.append(loss.detach())
            metrics_w.append({k: v.detach() for k, v in metrics.items()})
        ubs = list(state.momentum.buckets)
        if opt.optimizer == "lars":
            # LARS takes no grad clip, as in the reference: no sq_sum launch
            out = apply_lars_buckets(
                layout, pbs, gbs, ubs, lr=lr, trust=opt.lars_trust,
                momentum_coef=ls.local_momentum, weight_decay=opt.weight_decay,
                nesterov=ls.nesterov, want_stats=telemetry)
        else:
            out = apply_sgd_buckets(
                layout, pbs, gbs, ubs, lr=lr, momentum_coef=ls.local_momentum,
                weight_decay=opt.weight_decay, nesterov=ls.nesterov,
                grad_clip=opt.grad_clip, want_stats=telemetry)
        stats = state.stats
        if telemetry:
            gsq_w, usq_w = out[2]
            stats = tstats.accumulate_step(stats, gsq_w, usq_w)
        metrics = {k: torch.stack([m[k].float() for m in metrics_w]).mean()
                   for k in metrics_w[0]}
        metrics["loss"] = torch.stack(losses).mean()
        metrics["lr"] = float(lr)
        new = LocalSGDState(params=state.params, momentum=state.momentum,
                            anchor=state.anchor, global_u=state.global_u,
                            ef_memory=state.ef_memory, step=state.step + 1,
                            stats=stats, rng=state.rng)
        return new, metrics

    def sync(state: LocalSGDState, *, plan=None,
             scope: str = "global") -> LocalSGDState:
        """Execute the ``scope`` stages of a ``SyncPlan`` (built from the
        config when none is given) on the resident buckets, in place:
        ``"global"`` averages over all W, ``"block"`` over the plan's
        blocks of consecutive workers (Alg. 5; mean sync only, as in the
        reference).  With telemetry a global sync returns a state whose
        ``stats`` has the round closed (``record_sync``)."""
        layout = state.params.layout
        if plan is None:
            plan = splan.make_sync_plan(layout, num_workers=W,
                                        topology=splan.resolve_topology(ls, W),
                                        compression=ls.sync_compression,
                                        anchored=needs_anchor(ls))
        stages = plan.schedule(scope)
        record = telemetry and scope == "global"
        modes = plan.modes if scope == "global" else ("none",) * len(plan.modes)
        pb = list(state.params.buckets)
        if not needs_anchor(ls):
            if any(m != "none" for m in modes):
                raise ValueError(
                    "compression needs an anchor: configure sync_compression/"
                    "global_momentum so the state allocates one (needs_anchor)")
            pre_w = 0
            for st in stages:
                if st.kind == "collective":
                    for b in st.buckets:
                        m = group_mean(pb[b], st.group)
                        if record:
                            # centred pair: x_k = p_k - pbar, taken before the
                            # in-place copy; pre IS the dispersion, post = 0
                            pre_w = pre_w + _sumsq(pb[b].float() - m.float(),
                                                   from_axis=1)
                        pb[b].copy_(m)
            if not record:
                return state
            stats = tstats.record_sync(state.stats, pre_sync_sq=pre_w.mean(),
                                       post_sync_sq=0.0)
            return dataclasses.replace(state, stats=stats)

        if scope != "global":
            raise ValueError("compression / global momentum require flat "
                             "local SGD: a block sync needs the mean sync")
        if "ef_sign" in modes and state.ef_memory is None:
            raise ValueError("ef_sign requires the config to allocate EF "
                             "memory (sync_compression='ef_sign')")
        ab = list(state.anchor.buckets)
        efb = (list(state.ef_memory.buckets) if state.ef_memory is not None
               else None)
        nb = layout.num_buckets
        x: list = [None] * nb
        dbar: list = [None] * nb
        # telemetry per bucket: ||x_k||^2 per worker, ||dbar||^2, and the
        # compressor's ||input - output||^2 and ||input||^2
        x_sq: list = [None] * nb
        dbar_sq: list = [None] * nb
        zero = lambda: torch.zeros((), dtype=torch.float32, device=pb[0].device)
        err = [zero() for _ in range(nb)] if telemetry else None
        ref = [zero() for _ in range(nb)] if telemetry else None
        for st in stages:
            if st.kind == "pack":
                b = st.buckets[0]
                delta = ab[b][None] - pb[b]
                if modes[b] != "none":
                    x[b], e_new, inp = comp.compress_stage(
                        layout, st, delta, efb[b] if efb is not None else None,
                        leading=1)
                    if modes[b] == "ef_sign":
                        efb[b].copy_(e_new)
                    if telemetry:
                        err[b] = _sumsq(inp.float() - x[b])
                        ref[b] = _sumsq(inp)
                else:
                    x[b] = delta
                    if telemetry and speculate_compression:
                        # the WOULD-BE sign error of this uncompressed
                        # bucket: the escalating controllers' turn-on
                        # signal
                        cs = comp.sign_compress_bucket(layout, b, delta,
                                                       leading=1)
                        err[b] = _sumsq(delta.float() - cs)
                        ref[b] = _sumsq(delta)
                if telemetry:
                    x_sq[b] = _sumsq(x[b], from_axis=1)
            elif st.kind == "collective":
                for b in st.buckets:
                    dbar[b] = x[b].mean(dim=0)
                    x[b] = None
                    if telemetry:
                        dbar_sq[b] = _sumsq(dbar[b])
            elif st.kind == "apply":
                for b in st.buckets:
                    step_b = dbar[b]
                    if ls.global_momentum > 0:
                        gu = state.global_u.buckets[b]
                        gu.copy_(ls.global_momentum * gu + dbar[b])
                        step_b = gu
                    ab[b].sub_(step_b)
                    pb[b].copy_(ab[b][None].expand_as(pb[b]))
                    dbar[b] = None
        if not telemetry:
            return state
        # summed in bucket order after the stage loop, as the reference does
        pre_w = torch.zeros((W,), dtype=torch.float32, device=pb[0].device)
        for b in range(nb):
            pre_w = pre_w + x_sq[b]
        kw = {}
        if any(m != "none" for m in modes) or speculate_compression:
            kw = dict(comp_err_sq=torch.stack(err), comp_ref_sq=torch.stack(ref))
        stats = tstats.record_sync(state.stats, pre_sync_sq=pre_w.mean(),
                                   post_sync_sq=sum(dbar_sq), **kw)
        return dataclasses.replace(state, stats=stats)

    return init, local_step, sync
