"""Local SGD / post-local SGD on resident flat-bus buckets — the paper's core
(the port of the resident path of ``repro.core.local_sgd``).

Representation: params, momentum and EF memory are ``flatbuf.BucketState``
s of stacked ``(W, rows, 128)`` buffers, one row block per worker on the
same card; the anchor (the last synced model) is a single-copy
``BucketState``.  The buckets are the single source of truth between
syncs — the tree view exists only at ``unpack_state`` / ``mean_params``.

* ``local_step`` differentiates each worker's loss with respect to its
  param BUCKET (the model reads views into it, ``flatbuf.unflatten``), so
  the gradient is a bucket with exact-zero padding; then ONE fused SGD
  launch per bucket updates all W workers in place (plus one ``sq_sum``
  launch per bucket for the per-worker grad clip).  Workers run one after
  another in a Python loop where the reference uses ``vmap``.
* ``sync`` executes a flat :class:`~repro_torch.core.syncplan.SyncPlan`:
  the no-anchor mean sync averages the worker copies in place; the
  anchored sign / EF-sign sync forms the per-worker delta against the
  anchor, compresses it (two kernel launches per bucket), averages it and
  steps the anchor, then broadcasts the new anchor into every worker.

The update is in place: ``local_step`` and ``sync`` return a state that
shares (and has mutated) the buffers of the one they were given.

Not ported yet, and raising ``NotImplementedError``: gradient noise
(``noise_eta > 0``), the 1-bit wire pack, telemetry, LARS, hierarchical
topologies and the per-leaf tree path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import LocalSGDConfig, RunConfig
from repro_torch.core import compression as comp
from repro_torch.core import flatbuf
from repro_torch.core import syncplan as splan
from repro_torch.core.schedule import lr_at
from repro_torch.optim.sgd import apply_sgd_buckets


@dataclass
class LocalSGDState:
    params: Any          # BucketState, stacked (W, rows, 128)
    momentum: Any        # BucketState, stacked
    anchor: Any          # BucketState, single copy (last synced model) or None
    global_u: Any        # BucketState, single copy, or None
    ef_memory: Any       # BucketState, stacked, or None
    step: int = 0


def needs_anchor(cfg: LocalSGDConfig) -> bool:
    return cfg.global_momentum > 0 or cfg.sync_compression != "none"


def unpack_state(state: LocalSGDState) -> LocalSGDState:
    """The tree view of a resident state (tensors are views of the buckets)."""
    up = lambda x: x.unpack() if flatbuf.is_bucket_state(x) else x
    return LocalSGDState(params=up(state.params), momentum=up(state.momentum),
                         anchor=up(state.anchor), global_u=up(state.global_u),
                         ef_memory=up(state.ef_memory), step=state.step)


def mean_params(state: LocalSGDState):
    """Single-copy tree of the worker-averaged model (eval boundary)."""
    return flatbuf.unflatten(state.params.layout,
                             [b.mean(dim=0) for b in state.params.buckets])


def group_mean(x, group: int):
    """Mean over blocks of ``group`` consecutive workers, broadcast back."""
    W = x.shape[0]
    assert W % group == 0, (W, group)
    if group == 1:
        return x
    xg = x.reshape(W // group, group, *x.shape[1:])
    m = xg.mean(dim=1, keepdim=True)
    return m.expand(xg.shape).reshape(x.shape)


def _check_supported(run: RunConfig):
    ls, opt = run.local_sgd, run.optim
    if opt.noise_eta > 0:
        raise NotImplementedError("gradient noise (noise_eta > 0) is not ported yet")
    if opt.optimizer != "sgd":
        raise NotImplementedError(f"optimizer {opt.optimizer!r} is not ported yet")
    if ls.wire_pack or ls.sync_coalesce:
        raise NotImplementedError("the 1-bit wire pack is not ported yet")
    if ls.block_steps > 1 or ls.sync_topology not in ("auto", "flat"):
        raise NotImplementedError("hierarchical / overlap sync topologies "
                                  "are not ported yet")
    if run.controller.kind != "static" or run.controller.wants_telemetry:
        raise NotImplementedError("telemetry and adaptive controllers are "
                                  "not ported yet")


def make_local_sgd(run: RunConfig, loss_fn: Callable, *, num_workers: int,
                   wd_mask=None):
    """Build (init, local_step, sync) for a single-worker
    ``loss_fn(params, batch) -> (loss, metrics)`` on resident buckets."""
    _check_supported(run)
    ls = run.local_sgd
    opt = run.optim
    W = num_workers
    global_batch = run.shape.global_batch

    def init(params_single) -> LocalSGDState:
        """Enter resident form from a single-copy param tree (tensors on
        the training device)."""
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
            step=0)

    def local_step(state: LocalSGDState, batch):
        """One local step of every worker.  ``batch``: dict of (W, B_loc,
        ...) integer arrays (numpy or tensors)."""
        layout = state.params.layout
        pbs = list(state.params.buckets)
        dev = pbs[0].device
        lr = lr_at(opt, state.step, global_batch=global_batch)
        batch = {k: torch.as_tensor(v).to(dev, torch.int64)
                 for k, v in batch.items()}
        gbs = [torch.empty_like(b) for b in pbs]
        losses, metrics_w = [], []
        for w in range(W):
            src = [b[w].detach().requires_grad_(True) for b in pbs]
            params = flatbuf.unflatten(layout, src)
            loss, metrics = loss_fn(params, {k: v[w] for k, v in batch.items()})
            grads = torch.autograd.grad(loss, src)
            for g_all, g in zip(gbs, grads):
                g_all[w].copy_(g)
            losses.append(loss.detach())
            metrics_w.append({k: v.detach() for k, v in metrics.items()})
        apply_sgd_buckets(layout, pbs, gbs, list(state.momentum.buckets),
                          lr=lr, momentum_coef=ls.local_momentum,
                          weight_decay=opt.weight_decay, nesterov=ls.nesterov,
                          grad_clip=opt.grad_clip)
        metrics = {k: torch.stack([m[k].float() for m in metrics_w]).mean()
                   for k in metrics_w[0]}
        metrics["loss"] = torch.stack(losses).mean()
        metrics["lr"] = float(lr)
        new = LocalSGDState(params=state.params, momentum=state.momentum,
                            anchor=state.anchor, global_u=state.global_u,
                            ef_memory=state.ef_memory, step=state.step + 1)
        return new, metrics

    def sync(state: LocalSGDState, *, plan=None,
             scope: str = "global") -> LocalSGDState:
        """Execute a flat ``SyncPlan`` (built from the config when none is
        given) on the resident buckets, in place."""
        layout = state.params.layout
        if plan is None:
            plan = splan.make_sync_plan(layout, num_workers=W,
                                        compression=ls.sync_compression,
                                        anchored=needs_anchor(ls))
        if scope != "global":
            raise NotImplementedError("only the global (flat) scope is ported")
        stages = plan.schedule(scope)
        modes = plan.modes
        pb = list(state.params.buckets)
        if not needs_anchor(ls):
            if any(m != "none" for m in modes):
                raise ValueError(
                    "compression needs an anchor: configure sync_compression/"
                    "global_momentum so the state allocates one (needs_anchor)")
            for st in stages:
                if st.kind == "collective":
                    for b in st.buckets:
                        pb[b].copy_(group_mean(pb[b], st.group))
            return state

        if "ef_sign" in modes and state.ef_memory is None:
            raise ValueError("ef_sign requires the config to allocate EF "
                             "memory (sync_compression='ef_sign')")
        ab = list(state.anchor.buckets)
        efb = (list(state.ef_memory.buckets) if state.ef_memory is not None
               else None)
        x: list = [None] * layout.num_buckets
        dbar: list = [None] * layout.num_buckets
        for st in stages:
            if st.kind == "pack":
                b = st.buckets[0]
                delta = ab[b][None] - pb[b]
                if modes[b] != "none":
                    x[b], e_new, _ = comp.compress_stage(
                        layout, st, delta, efb[b] if efb is not None else None,
                        leading=1)
                    if modes[b] == "ef_sign":
                        efb[b].copy_(e_new)
                else:
                    x[b] = delta
            elif st.kind == "collective":
                for b in st.buckets:
                    dbar[b] = x[b].mean(dim=0)
                    x[b] = None
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
        return state

    return init, local_step, sync
