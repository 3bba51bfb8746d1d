"""LARS — layer-wise adaptive rate scaling (You et al. 2017a) on flat-bus
buckets (the port of ``repro.optim.lars.apply_lars_buckets``).

The paper's Table 5 combines SGD + momentum + LARS with post-local SGD;
LARS only rescales each layer's step, so it composes with local SGD
without extra synchronization.  As in ``optim/sgd.py`` the buckets carry
a leading worker dim ``(W, rows, 128)`` and every quantity is per worker,
the trust ratios included: each worker's layer norms are its own.  LARS
takes no grad clip, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core import flatbuf
from repro_torch.kernels import ops as kops


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
