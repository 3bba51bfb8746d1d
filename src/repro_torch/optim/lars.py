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
                       nesterov: bool, want_stats: bool = False):
    """Bucket-in/bucket-out fused LARS, IN PLACE on ``pb``/``ub``.

    Per bucket: one ``lars_row_norms`` launch gives the per-row sums of
    p^2 and (g + wd*mask*p)^2 of every worker; a scatter-add over the
    row -> leaf map turns them into (W, n_seg) layer norms and trust
    ratios ``trust * ||p|| / (||g + wd p|| + 1e-9)`` (1.0 where either norm
    is 0, and on leaves that skip weight decay, which take the plain LR);
    one ``fused_lars_bucket`` launch applies them as a per-worker, per-row
    operand.  Padding is zero in p and g, so it adds nothing to a norm.

    Returns (pb, ub), or with ``want_stats`` (pb, ub, (grad_sq,
    update_sq)) with per-worker sums over all buckets from the same
    update launches (raw grad, before decay and ratio).
    """
    gsq = usq = 0.0
    for b in range(layout.num_buckets):
        dev = pb[b].device
        wd_row = flatbuf.const("wd_rows", layout, b, dev)
        seg = flatbuf.const("row_segments", layout, b, dev).long()
        skip = flatbuf.const("segment_skip_wd", layout, b, dev)
        n_seg = int(skip.shape[0])
        p_sq, g_sq = kops.bucket_lars_norms(pb[b], gb[b], wd_row,
                                            weight_decay=weight_decay)
        lead = p_sq.shape[:-1]
        W = p_sq.numel() // seg.numel()
        # one scatter-add over all workers' rows: worker w's segments are
        # slots w * n_seg ... w * n_seg + n_seg - 1
        seg_w = (seg[None, :] + n_seg * torch.arange(W, device=dev)[:, None]).reshape(-1)
        wn = torch.sqrt(kops.segment_sum(p_sq.reshape(-1), seg_w, W * n_seg))
        gn = torch.sqrt(kops.segment_sum(g_sq.reshape(-1), seg_w, W * n_seg))
        ratio = torch.where((wn > 0) & (gn > 0), trust * wn / (gn + 1e-9), 1.0)
        ratio = torch.where(skip.repeat(W), 1.0, ratio).reshape(W, n_seg)
        ratio_row = ratio[:, seg].reshape(lead + seg.shape).contiguous()
        out = kops.bucket_fused_lars(pb[b], gb[b], ub[b], wd_row, ratio_row,
                                     lr=lr, momentum=momentum_coef,
                                     weight_decay=weight_decay,
                                     nesterov=nesterov, stats=want_stats)
        if want_stats:
            gsq = gsq + out[0]
            usq = usq + out[1]
    if want_stats:
        return pb, ub, (gsq, usq)
    return pb, ub
