"""SGD with Nesterov momentum and a per-row weight-decay mask on flat-bus
buckets (the port of ``repro.optim.sgd.apply_sgd_buckets``).

This is the paper's *local* optimizer: the buckets carry a leading
worker dim ``(W, rows, 128)`` and every quantity is per worker, as the
reference computes it inside its ``vmap`` — the grad-clip norm included.
"""
from __future__ import annotations

import torch

from repro_torch.core import flatbuf
from repro_torch.kernels import ops as kops


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
