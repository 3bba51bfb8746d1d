"""Bucket-level entry points over the flat-bus kernels (the port of the
bucket half of ``repro.kernels.ops``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_bucket as _fb


def bucket_fused_sgd(p2, g2, u2, wd_row, *, lr, momentum: float,
                     weight_decay: float, nesterov: bool = True,
                     gscale=None, stats: bool = False):
    """One fused SGD launch over a whole ``(*lead, rows, 128)`` bucket,
    in place on ``p2``/``u2``.  Returns None, or with ``stats`` the pair
    (sum g^2, sum ||update||^2) per worker."""
    return _fb.fused_sgd_bucket(p2, g2, u2, lr, wd_row, momentum=momentum,
                                weight_decay=weight_decay, nesterov=nesterov,
                                gscale=gscale, stats=stats)


def bucket_sq_sum(x2):
    """sum(x^2) per worker over a bucket (f32) — one pass."""
    return _fb.sq_sum(x2)


def segment_sum(vals, seg_ids, num_segments: int):
    """Scatter-add of ``vals`` into ``num_segments`` slots by ``seg_ids``
    (the counterpart of ``jax.ops.segment_sum``).  On the CPU the adds
    run in index order, as XLA's scatter does, so the float32 totals
    agree with the reference's to about one rounding; on the card they
    are atomic adds, whose order varies from run to run."""
    out = torch.zeros((num_segments,), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg_ids.long(), vals)


def bucket_sign_compress(x2, seg_ids, seg_sizes):
    """Segment-aware sign compressor over a ``(*lead, rows, 128)`` bucket.

    ``seg_ids`` (rows,) maps each row to its leaf segment and
    ``seg_sizes`` (num_segments,) holds the element counts each segment's
    L1 scale divides by — pass the true counts times ``prod(lead)`` to
    share one scale across the leading (worker) dim, as the reference
    does.  Returns (y f32 like x2, scales (num_segments,) f32).
    """
    row_sums = _fb.row_abs_sum(x2)                         # (*lead, rows)
    lead = row_sums.numel() // seg_ids.numel()
    # worker-major over all (*lead, rows) rows, like the reference's
    # segment_sum over the row map tiled W times
    totals = segment_sum(row_sums.reshape(-1), seg_ids.repeat(lead),
                         int(seg_sizes.shape[0]))
    scales = totals / seg_sizes
    y = _fb.scale_sign_rows(x2, scales[seg_ids.long()])
    return y, scales
