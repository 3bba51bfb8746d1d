"""SGD with Nesterov momentum and a weight-decay mask (the port of
``repro.optim.sgd``).

This is the paper's *local* optimizer: every quantity is per worker, as
the reference computes it inside its ``vmap`` — the grad-clip norm
included.  Three entry points:

* :func:`apply_sgd_buckets` — the resident path: stacked ``(W, rows,
  128)`` buckets updated in place by one fused kernel launch per bucket.
* :func:`apply_sgd` with ``use_kernel=False`` — the reference's per-leaf
  update in plain PyTorch (its jnp oracle).
* :func:`apply_sgd` with ``use_kernel=True`` — the tree-in/tree-out
  kernel form: the trees are packed into buckets, run through
  :func:`apply_sgd_buckets` (the same kernels) and unpacked, every call.

The tree forms take ``leading`` = 1 for stacked ``(W, ...)`` trees (the
tree path's state, every worker at once, a clip norm per worker) or 0
for one worker's tree, as the reference's ``apply_sgd`` sees it inside
its ``vmap``.
"""
from __future__ import annotations

import torch

from repro_torch.core import flatbuf
from repro_torch.kernels import ops as kops
from repro_torch.utils import (tree_flatten, tree_leaves, tree_map,
                               tree_map_pairs, tree_unflatten)


def init_momentum(params):
    """Zero momentum in each leaf's own dtype (the reference's
    ``zeros_like``)."""
    return tree_map(torch.zeros_like, params)


def sum_from(x, leading: int):
    """Sum of ``x`` over its dims from ``leading`` on (``x`` itself when
    there are none: torch would read an empty ``dim`` as every dim).  With
    ``leading`` = 1 (a stacked tree's workers) one reduction a worker, so a
    worker's sum does not depend on how many workers lie beside it (the
    card reduces a (W, n) tensor over n in another order for another W:
    one process and a rank holding some of its workers differ)."""
    dims = tuple(range(leading, x.dim()))
    if not dims:
        return x
    if leading == 1:
        return torch.stack([r.sum() for r in x.unbind(0)])
    return x.sum(dim=dims)


def _per_worker(scale, x, leading: int):
    """A per-worker ``(*lead,)`` factor shaped to broadcast over ``x``."""
    return scale.reshape(tuple(scale.shape) + (1,) * (x.dim() - leading))


def clip_by_global_norm(grads, max_norm: float, *, leading: int = 0,
                        shards=None, across=None):
    """Scale ``grads`` so that its global L2 norm (f32, over every leaf) is
    at most ``max_norm``; with ``leading`` = 1 each worker's own norm.
    ``max_norm`` 0 returns ``grads`` itself.  ``shards`` (a
    ``core.flatbuf.LeafShards``): a sharded leaf's Σg² is its slices'
    partials added in shard order, over the shard group (``across``)
    where ``grads`` holds one slice; the leaves' sums are added in leaf
    order either way."""
    if not max_norm:
        return grads
    gn2 = 0.0
    for t in flatbuf.leaf_sums(tree_leaves(grads), lambda g: _sq(g.float()),
                               lambda v: sum_from(v, leading),
                               leading=leading, shards=shards, across=across):
        gn2 = gn2 + t
    gn = torch.sqrt(gn2)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * _per_worker(scale, g, leading))
                    .to(g.dtype), grads)


def _sq(x):
    return x * x


def _leaf_update(p, g, u, skip_wd, *, lr, momentum, wd, nesterov):
    gf = g.float()
    pf = p.float()
    if wd and not skip_wd:
        gf = gf + wd * pf
    u_new = momentum * u.float() + gf
    step = (momentum * u_new + gf) if nesterov else u_new
    p_new = pf - float(lr) * step
    return p_new.to(p.dtype), u_new.to(u.dtype)


def apply_sgd_buckets(layout, pb, gb, ub, *, lr, momentum_coef: float,
                      weight_decay: float, nesterov: bool,
                      grad_clip: float = 0.0, want_stats: bool = False,
                      across=None):
    """Bucket-in/bucket-out fused SGD, IN PLACE on ``pb``/``ub``.

    With ``grad_clip`` the per-worker global norm comes from one
    ``sq_sum`` launch per bucket (grad buckets have exact-zero padding,
    so the bucket norm is the per-leaf global norm), and the clip scale
    rides into the fused update as its per-worker grad multiplier — no
    separate scaling pass.  Returns (pb, ub), or with ``want_stats``
    (pb, ub, (grad_sq, update_sq)) with per-worker sums over all buckets
    (grad after the clip, before decay).

    Each launch sees the bucket's shard regions as extra leading rows
    (``flatbuf.shard_regions``), so every per-worker sum is a sum of
    per-region partials added in shard order (``flatbuf.shard_sum``):
    the same adds whether one process holds every region or the ranks of
    a shard group (``across``, a ``backend.collectives.Collectives``)
    hold one each.  A replicated bucket is one region, counted once.
    """
    views = [[flatbuf.shard_regions(layout, b, x[b]) for b in range(len(x))]
             for x in (pb, gb, ub)]
    pv, gv, uv = views
    gscale = None
    if grad_clip:
        gn2 = sum(flatbuf.shard_sum(layout, b, kops.bucket_sq_sum(g), across)
                  for b, g in enumerate(gv))
        gn = torch.sqrt(gn2)
        gscale = torch.clamp(grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
        gscale = gscale.to(torch.float32).contiguous()
    gsq = usq = 0.0
    for b in range(layout.num_buckets):
        wd_row = flatbuf.const("wd_rows_local", layout, b, pb[b].device)
        gs = None
        if gscale is not None:
            # one multiplier a (worker, region)
            gs = gscale[..., None].expand(pv[b].shape[:-2]).contiguous()
        out = kops.bucket_fused_sgd(pv[b], gv[b], uv[b], wd_row, lr=lr,
                                    momentum=momentum_coef,
                                    weight_decay=weight_decay,
                                    nesterov=nesterov, gscale=gs,
                                    stats=want_stats)
        if want_stats:
            gsq = gsq + flatbuf.shard_sum(layout, b, out[0], across)
            usq = usq + flatbuf.shard_sum(layout, b, out[1], across)
    if want_stats:
        return pb, ub, (gsq, usq)
    return pb, ub


def _bucketed(params, grads, momentum, wd_mask, leading: int, shards=None):
    """(layout, param, grad and momentum buckets) of the trees, each bucket
    with a worker dim (one worker's tree gets a dim of 1).  ``shards`` (a
    ``core.flatbuf.LeafShards``): the layout of the WHOLE leaves with their
    sharding classes, and a tree of slices packed into its shard's region
    rows (``flatbuf.flatten(region=True)``)."""
    if shards is None:
        layout = flatbuf.build_layout(params, wd_mask=wd_mask, leading=leading)
    else:
        leaves, treedef = tree_flatten(params)
        whole = [torch.empty(tuple(x.shape[:leading]) + shards.whole_shape(
                     i, x.shape[leading:]), dtype=x.dtype, device="meta")
                 for i, x in enumerate(leaves)]
        layout = flatbuf.build_layout(tree_unflatten(treedef, whole),
                                      wd_mask=wd_mask, leading=leading,
                                      shard_classes=list(shards.classes))
    region = shards is not None and shards.shard is not None
    lift = (lambda bs: bs) if leading else (lambda bs: [b[None] for b in bs])
    return layout, [lift(flatbuf.flatten(layout, t, leading=leading,
                                         region=region))
                    for t in (params, grads, momentum)]


def _unbucketed(layout, bufs, leading: int, shards=None):
    return flatbuf.unflatten(layout, bufs if leading else [b[0] for b in bufs],
                             leading=leading,
                             region=shards is not None and shards.shard is not None)


def _apply_sgd_bucketed(params, grads, momentum, wd_mask, *, lr,
                        momentum_coef, weight_decay, nesterov, grad_clip,
                        leading: int, shards=None, across=None):
    """Tree-in/tree-out wrapper around :func:`apply_sgd_buckets`: it packs
    the three trees into buckets and unpacks the results around every
    call, which the resident path avoids.  One launch per bucket updates
    every worker; the results are views into new buckets.  With
    ``shards`` the buckets are the sharding classes' sub-buckets, whole or
    this rank's region (``across`` totals its sums over the shard
    group)."""
    layout, (pb, gb, ub) = _bucketed(params, grads, momentum, wd_mask, leading,
                                     shards)
    apply_sgd_buckets(layout, pb, gb, ub, lr=lr, momentum_coef=momentum_coef,
                      weight_decay=weight_decay, nesterov=nesterov,
                      grad_clip=grad_clip, across=across)
    return (_unbucketed(layout, pb, leading, shards),
            _unbucketed(layout, ub, leading, shards))


def apply_sgd(params, grads, momentum, *, lr, momentum_coef: float,
              weight_decay: float, nesterov: bool, wd_mask=None,
              grad_clip: float = 0.0, use_kernel: bool = False,
              leading: int = 0, shards=None, across=None):
    """One SGD step on trees; returns NEW (params, momentum) trees, each
    leaf in its own dtype.  ``use_kernel`` picks the tree-in/tree-out
    kernel form, else the per-leaf plain form; ``leading`` as in the
    module docstring.  ``shards`` (a ``core.flatbuf.LeafShards``) and
    ``across`` (the shard group's ``backend.collectives.Collectives``):
    the trees may hold a slice of each sharded leaf, and the clip norm
    adds the slices' partials in shard order (see
    :func:`clip_by_global_norm`)."""
    if wd_mask is None:
        wd_mask = tree_map(lambda _: False, params)
    if use_kernel:
        return _apply_sgd_bucketed(params, grads, momentum, wd_mask, lr=lr,
                                   momentum_coef=momentum_coef,
                                   weight_decay=weight_decay,
                                   nesterov=nesterov, grad_clip=grad_clip,
                                   leading=leading, shards=shards,
                                   across=across)
    grads = clip_by_global_norm(grads, grad_clip, leading=leading,
                                shards=shards, across=across)

    def upd(p, g, u, skip):
        return _leaf_update(p, g, u, skip, lr=lr, momentum=momentum_coef,
                            wd=weight_decay, nesterov=nesterov)
    return tree_map_pairs(upd, params, grads, momentum, wd_mask)
