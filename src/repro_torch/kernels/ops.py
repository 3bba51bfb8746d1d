"""Public entry points over the port's kernels (the port of
``repro.kernels.ops``): the per-tensor API (``fused_sgd``,
``sign_compress``, ``flash_attention``) and the bucket-level API over the
flat-bus kernels.

Each takes CPU or CUDA tensors: on the CPU the kernels' plain versions
run, on the card the kernels launch (or raise).  The reference's
``interpret`` switch has no counterpart, and the per-tensor API needs no
128-lane padding: a tensor of any shape goes to its kernel as it is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_bucket as _fb
from repro_torch.kernels import fused_sgd as _fs
from repro_torch.kernels import sign_compress as _sc


def fused_sgd(p, g, u, *, lr, momentum: float, weight_decay: float = 0.0,
              nesterov: bool = True):
    """Fused SGD update of one tensor of any shape; returns NEW (p', u') in
    p's and u's dtype.  ``lr`` is a float or a one-element f32 tensor on
    p's device (read there: a schedule on the device costs no sync)."""
    return _fs.fused_sgd_2d(p.contiguous(), g.contiguous(), u.contiguous(), lr,
                            momentum=momentum, weight_decay=weight_decay,
                            nesterov=nesterov)


def sign_compress(x):
    """sign(x) * mean|x| (the Alg. 3/4 compressor) of one tensor, as f32.

    The scale divides by the TRUE element count ``x.numel()``; the sum
    stays on the device between the two launches."""
    x = x.contiguous()
    scale = _sc.abs_sum(x) / x.numel()
    return _sc.scale_sign(x, scale)


# GQA flash attention, q (B, Sq, H, D), k / v (B, Sk, KH, D): the kernel
# reads that layout through its strides, so there is nothing to adapt here
flash_attention = _fa.flash_attention


# ---------------------------------------------------------------------------
# Bucket-level entry points (flat parameter bus; see core/flatbuf.py)
# ---------------------------------------------------------------------------


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


def bucket_lars_norms(p2, g2, wd_row, *, weight_decay: float):
    """Per-row sum of squares of p and of g + wd*mask*p — one pass.
    Returns two (*lead, rows) f32; the per-layer LARS norms finish as a
    segmented reduction over ``flatbuf.row_segments``."""
    return _fb.lars_row_norms(p2, g2, wd_row, weight_decay=weight_decay)


def bucket_fused_lars(p2, g2, u2, wd_row, ratio_row, *, lr, momentum: float,
                      weight_decay: float, nesterov: bool = True,
                      stats: bool = False):
    """One fused LARS launch over a whole ``(*lead, rows, 128)`` bucket, in
    place on ``p2``/``u2``; ``ratio_row`` is the (*lead, rows) per-row
    trust ratio (1.0 on rows that take the plain LR).  Returns None, or
    with ``stats`` the pair (sum g^2, sum ||update||^2) per worker."""
    return _fb.fused_lars_bucket(p2, g2, u2, lr, wd_row, ratio_row,
                                 momentum=momentum, weight_decay=weight_decay,
                                 nesterov=nesterov, stats=stats)


def segment_sum(vals, seg_ids, num_segments: int):
    """Scatter-add of ``vals`` into ``num_segments`` slots by ``seg_ids``
    (the counterpart of ``jax.ops.segment_sum``).  On the CPU the adds
    run in index order, as XLA's scatter does, so the float32 totals
    agree with the reference's to about one rounding; on the card they
    are atomic adds, whose order varies from run to run."""
    out = torch.zeros((num_segments,), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg_ids.long(), vals)


def bucket_row_abs_sums(x2):
    """Sum |x| per row of a ``(*lead, rows, 128)`` bucket: one
    ``row_abs_sum`` launch -> (*lead, rows) f32."""
    return _fb.row_abs_sum(x2)


def bucket_abs_totals(x2, seg_ids, num_segments: int, *,
                      per_lead: bool = False):
    """Sum |x| per leaf segment of a ``(*lead, rows, 128)`` bucket: the
    kernel's row sums scatter-added by ``seg_ids`` (rows,).  Over every
    leading index together -> (num_segments,), or with ``per_lead`` each
    leading index (worker) on its own -> (*lead, num_segments)."""
    row_sums = bucket_row_abs_sums(x2)                     # (*lead, rows)
    lead = row_sums.numel() // seg_ids.numel()
    if per_lead:
        # leading index w's segments land in slots [w * n, (w + 1) * n)
        off = num_segments * torch.arange(lead, device=x2.device)[:, None]
        ids, n = (seg_ids.long()[None] + off).reshape(-1), lead * num_segments
    else:
        # worker-major over all (*lead, rows) rows, like the reference's
        # segment_sum over the row map tiled W times
        ids, n = seg_ids.repeat(lead), num_segments
    totals = segment_sum(row_sums.reshape(-1), ids, n)
    return totals.reshape(*x2.shape[:-2], num_segments) if per_lead else totals


def bucket_sign_compress(x2, seg_ids, seg_sizes):
    """Segment-aware sign compressor over a ``(*lead, rows, 128)`` bucket.

    ``seg_ids`` (rows,) maps each row to its leaf segment and
    ``seg_sizes`` (num_segments,) holds the element counts each segment's
    L1 scale divides by — pass the true counts times ``prod(lead)`` to
    share one scale across the leading (worker) dim, as the reference
    does.  Returns (y f32 like x2, scales (num_segments,) f32).
    """
    scales = bucket_abs_totals(x2, seg_ids, int(seg_sizes.shape[0])) / seg_sizes
    return bucket_scale_sign(x2, seg_ids, scales), scales


def bucket_scale_sign(x2, seg_ids, scales):
    """sign(x) * scales[leaf of the row] over a ``(*lead, rows, 128)``
    bucket: one ``scale_sign_rows`` launch."""
    return _fb.scale_sign_rows(x2, scales[seg_ids.long()])
