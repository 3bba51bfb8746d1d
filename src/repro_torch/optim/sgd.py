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
                      grad_clip: float = 0.0, want_stats: bool = False):
    """Bucket-in/bucket-out fused SGD, IN PLACE on ``pb``/``ub``.

    With ``grad_clip`` the per-worker global norm comes from one
    ``sq_sum`` launch per bucket (grad buckets have exact-zero padding,
    so the bucket norm is the per-leaf global norm), and the clip scale
    rides into the fused update as its per-worker grad multiplier — no
    separate scaling pass.  Returns (pb, ub), or with ``want_stats``
    (pb, ub, (grad_sq, update_sq)) with per-worker sums over all buckets
    (grad after the clip, before decay).
    """
    gscale = None
    if grad_clip:
        gn2 = sum(kops.bucket_sq_sum(g) for g in gb)
        gn = torch.sqrt(gn2)
        gscale = torch.clamp(grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
        gscale = gscale.to(torch.float32).contiguous()
    gsq = usq = 0.0
    for b in range(layout.num_buckets):
        wd_row = flatbuf.const("wd_rows", layout, b, pb[b].device)
        out = kops.bucket_fused_sgd(pb[b], gb[b], ub[b], wd_row, lr=lr,
                                    momentum=momentum_coef,
                                    weight_decay=weight_decay,
                                    nesterov=nesterov, gscale=gscale,
                                    stats=want_stats)
        if want_stats:
            gsq = gsq + out[0]
            usq = usq + out[1]
    if want_stats:
        return pb, ub, (gsq, usq)
    return pb, ub
