"""LARS — layer-wise adaptive rate scaling (You et al. 2017a) (the port
of ``repro.optim.lars``).

The paper's Table 5 combines SGD + momentum + LARS with post-local SGD;
LARS only rescales each layer's step, so it composes with local SGD
without extra synchronization.  Every quantity is per worker, the trust
ratios included: each worker's layer norms are its own.  LARS takes no
grad clip, as in the reference.  The three entry points mirror
``optim/sgd.py``: :func:`apply_lars_buckets` on resident ``(W, rows,
128)`` buckets, and :func:`apply_lars` on trees, per leaf in plain
PyTorch (``use_kernel=False``) or packed through the bucket kernels and
unpacked again (``use_kernel=True``), ``leading`` = 1 for stacked trees.
"""
from __future__ import annotations

import torch

from repro_torch.core import flatbuf
from repro_torch.kernels import ops as kops
from repro_torch.optim.sgd import _bucketed, _per_worker, _unbucketed, sum_from
from repro_torch.utils import tree_flatten, tree_leaves, tree_map, tree_unflatten


def _lars_leaf(p, g, u, skip, *, lr, trust, momentum, wd, nesterov,
               leading: int = 0, norms=None):
    """One leaf's LARS step; ``norms`` = (||p||, ||g + wd p||) per worker
    when the caller has them (a sharded leaf's, over the whole leaf)."""
    gf = g.float()
    pf = p.float()
    if wd and not skip:
        gf = gf + wd * pf
    if not skip:  # norm/bias params use the plain LR
        if norms is None:
            norm = lambda x: torch.sqrt(sum_from(x * x, leading))
            norms = (norm(pf), norm(gf))
        wn, gn = (_per_worker(n, pf, leading) for n in norms)
        ratio = torch.where((wn > 0) & (gn > 0), trust * wn / (gn + 1e-9), 1.0)
        gf = gf * ratio
    u_new = momentum * u.float() + gf
    step = (momentum * u_new + gf) if nesterov else u_new
    p_new = pf - float(lr) * step
    return p_new.to(p.dtype), u_new.to(u.dtype)


def _shard_norms(params, grads, wd_mask, *, wd, leading, shards, across):
    """Per sharded leaf (None elsewhere): (||p||, ||g + wd p||) per worker,
    each square sum its slices' partials added in shard order, every
    leaf's in one ``shard_total`` where the trees hold slices."""
    ps, gs, skips = (tree_leaves(t) for t in (params, grads, wd_mask))
    idx = [i for i in range(len(ps)) if shards.sharded(i) and not skips[i]]
    pf = [ps[i].float() for i in idx]
    gf = [gs[i].float() + wd * p if wd else gs[i].float()
          for i, p in zip(idx, pf)]
    tot = flatbuf.leaf_totals(
        [flatbuf.region_sums(shards.regions(i, x * x, leading))
         for i, x in zip(idx + idx, pf + gf)],
        [shards.sliced(i) for i in idx + idx], across)
    out: list = [None] * len(ps)
    for j, i in enumerate(idx):
        out[i] = (torch.sqrt(tot[j]), torch.sqrt(tot[len(idx) + j]))
    return out


def apply_lars_buckets(layout, pb, gb, ub, *, lr, trust: float,
                       momentum_coef: float, weight_decay: float,
                       nesterov: bool, want_stats: bool = False,
                       across=None):
    """Bucket-in/bucket-out fused LARS, IN PLACE on ``pb``/``ub``.

    Per bucket: one ``lars_row_norms`` launch gives the per-row sums of
    p^2 and (g + wd*mask*p)^2 of every worker; a segmented sum over the
    row -> leaf map (one ``segment_sum`` launch, fixed order) turns them
    into (W, n_seg) layer norms and trust
    ratios ``trust * ||p|| / (||g + wd p|| + 1e-9)`` (1.0 where either norm
    is 0, and on leaves that skip weight decay, which take the plain LR);
    one ``fused_lars_bucket`` launch applies them as a per-worker, per-row
    operand.  Padding is zero in p and g, so it adds nothing to a norm.

    A sharded sub-bucket's layer norms are global: each shard region's
    per-leaf sums are added in shard order (``flatbuf.shard_sum``), over
    the regions this process holds or across the shard group
    (``across``), and every region takes the leaf's ratio.  A replicated
    bucket's norms are summed in the same order on each of the worker's
    shard ranks from the same rows, so its copies stay one value.

    Returns (pb, ub), or with ``want_stats`` (pb, ub, (grad_sq,
    update_sq)) with per-worker sums over all buckets from the same
    update launches (raw grad, before decay and ratio).
    """
    gsq = usq = 0.0
    for b in range(layout.num_buckets):
        dev = pb[b].device
        p, g, u = (flatbuf.shard_regions(layout, b, x[b]) for x in (pb, gb, ub))
        wd_row = flatbuf.const("wd_rows_local", layout, b, dev)
        seg = flatbuf.const("row_segments_local", layout, b, dev).long()
        lead = p.shape[:-2]                           # (W, R)
        skip = flatbuf.const("segment_skip_wd", layout, b, dev)
        p_sq, g_sq = kops.bucket_lars_norms(p, g, wd_row,
                                            weight_decay=weight_decay)
        # one segment_sum launch over every (p / g, worker, region) row
        sums = kops.segment_totals(torch.stack([p_sq, g_sq]),
                                   flatbuf.segment_index(layout, b, dev))
        tot = [flatbuf.shard_sum(layout, b, x.movedim(-1, -2), across)
               for x in sums]                         # (W, n_seg) each
        wn, gn = torch.sqrt(tot[0]), torch.sqrt(tot[1])
        ratio = torch.where((wn > 0) & (gn > 0), trust * wn / (gn + 1e-9), 1.0)
        ratio = torch.where(skip, 1.0, ratio)
        ratio_row = ratio[..., seg][..., None, :].expand(
            lead + seg.shape).contiguous()
        out = kops.bucket_fused_lars(p, g, u, wd_row, ratio_row,
                                     lr=lr, momentum=momentum_coef,
                                     weight_decay=weight_decay,
                                     nesterov=nesterov, stats=want_stats)
        if want_stats:
            gsq = gsq + flatbuf.shard_sum(layout, b, out[0], across)
            usq = usq + flatbuf.shard_sum(layout, b, out[1], across)
    if want_stats:
        return pb, ub, (gsq, usq)
    return pb, ub


def _apply_lars_bucketed(params, grads, momentum, wd_mask, *, lr, trust,
                         momentum_coef, weight_decay, nesterov, leading: int,
                         shards=None, across=None):
    """Tree-in/tree-out wrapper around :func:`apply_lars_buckets` (packs
    and unpacks around every call; ``shards`` and ``across`` as in
    ``optim.sgd._apply_sgd_bucketed``)."""
    layout, (pb, gb, ub) = _bucketed(params, grads, momentum, wd_mask, leading,
                                     shards)
    apply_lars_buckets(layout, pb, gb, ub, lr=lr, trust=trust,
                       momentum_coef=momentum_coef,
                       weight_decay=weight_decay, nesterov=nesterov,
                       across=across)
    return (_unbucketed(layout, pb, leading, shards),
            _unbucketed(layout, ub, leading, shards))


def apply_lars(params, grads, momentum, *, lr, trust: float,
               momentum_coef: float, weight_decay: float, nesterov: bool,
               wd_mask=None, use_kernel: bool = False, leading: int = 0,
               shards=None, across=None):
    """One LARS step on trees; returns NEW (params, momentum) trees.
    Leaves flagged in ``wd_mask`` take neither decay nor a trust ratio.
    ``shards`` (a ``core.flatbuf.LeafShards``) and ``across``: a sharded
    leaf's layer norms are global, its slices' partials added in shard
    order (over the shard group where the trees hold one slice)."""
    if wd_mask is None:
        wd_mask = tree_map(lambda _: False, params)
    if use_kernel:
        return _apply_lars_bucketed(params, grads, momentum, wd_mask, lr=lr,
                                    trust=trust, momentum_coef=momentum_coef,
                                    weight_decay=weight_decay,
                                    nesterov=nesterov, leading=leading,
                                    shards=shards, across=across)
    leaves, treedef = tree_flatten(params)
    norms = (_shard_norms(params, grads, wd_mask, wd=weight_decay,
                          leading=leading, shards=shards, across=across)
             if shards is not None else [None] * len(leaves))
    outs = [_lars_leaf(p, g, u, s, lr=lr, trust=trust, momentum=momentum_coef,
                       wd=weight_decay, nesterov=nesterov, leading=leading,
                       norms=n)
            for p, g, u, s, n in zip(leaves, tree_leaves(grads),
                                     tree_leaves(momentum),
                                     tree_leaves(wd_mask), norms, strict=True)]
    return (tree_unflatten(treedef, [o[0] for o in outs]),
            tree_unflatten(treedef, [o[1] for o in outs]))
