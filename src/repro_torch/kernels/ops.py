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


# the SegmentIndex of a row -> segment map
segment_index = _fb.segment_index


def segment_sum(vals, seg_ids, num_segments: int, *, chain: bool = False,
                init=None):
    """Sum of ``vals`` (*lead, rows) per segment of ``seg_ids`` (rows,),
    each leading index on its own -> (*lead, num_segments) f32 (the
    counterpart of ``jax.ops.segment_sum`` over one leading index); with
    ``chain`` the leading indices' rows run one after another into one
    (num_segments,) total, from ``init`` or 0 (``segment_sum`` over the row
    map tiled over the leading indices).  :func:`segment_totals` on the
    map's index, built here."""
    return segment_totals(vals, _fb.segment_index(seg_ids, num_segments),
                          chain=chain, init=init)


def segment_totals(vals, index, *, chain: bool = False, init=None):
    """:func:`segment_sum` over ``index``, ``fused_bucket.segment_index``'s
    ``SegmentIndex`` (cached per bucket by ``flatbuf.segment_index``).

    Each total is added one value after another in index order, on the CPU
    (``index_add_``, as XLA's scatter adds) and on the card
    (``fused_bucket.segment_sum``, no atomics): the same bits on either
    device and in every run."""
    lead = tuple(vals.shape[:-1])
    out = _fb.segment_sum(vals.reshape(-1, vals.shape[-1]).contiguous(),
                          index, chain=chain, init=init)
    return out if chain else out.reshape(lead + (index.offsets.numel() - 1,))


def lead_total(per):
    """``per`` (L, ...) added over its leading rows one after another, in
    row (worker) order: a total over workers whose adds are the same in one
    process and across ranks (each rank's per-worker values gathered
    first)."""
    acc = per[0]
    for i in range(1, per.shape[0]):
        acc = acc + per[i]
    return acc


def bucket_row_abs_sums(x2):
    """Sum |x| per row of a ``(*lead, rows, 128)`` bucket: one
    ``row_abs_sum`` launch -> (*lead, rows) f32."""
    return _fb.row_abs_sum(x2)


def bucket_abs_totals(x2, index, *, per_lead: bool = False):
    """Sum |x| per leaf segment of a ``(*lead, rows, 128)`` bucket: the
    kernel's row sums, then a segmented sum over ``index`` (the rows'
    ``flatbuf.segment_index``).  Over every leading index together, worker
    after worker (the reference's segment_sum over the row map tiled W
    times) -> (num_segments,), or with ``per_lead`` each leading index
    (worker) on its own -> (*lead, num_segments)."""
    return segment_totals(bucket_row_abs_sums(x2), index, chain=not per_lead)


def bucket_sign_compress(x2, seg_ids, seg_sizes, *, index=None):
    """Segment-aware sign compressor over a ``(*lead, rows, 128)`` bucket.

    ``seg_ids`` (rows,) maps each row to its leaf segment and
    ``seg_sizes`` (num_segments,) holds the element counts each segment's
    L1 scale divides by — pass the true counts times ``prod(lead)`` to
    share one scale across the leading (worker) dim, as the reference
    does.  ``index`` is the map's cached ``flatbuf.segment_index``, built
    here when None.  Returns (y f32 like x2, scales (num_segments,) f32).
    """
    if index is None:
        index = _fb.segment_index(seg_ids, int(seg_sizes.shape[0]))
    scales = bucket_abs_totals(x2, index) / seg_sizes
    return bucket_scale_sign(x2, seg_ids, scales), scales


def bucket_scale_sign(x2, seg_ids, scales):
    """sign(x) * scales[leaf of the row] over a ``(*lead, rows, 128)``
    bucket: one ``scale_sign_rows`` launch."""
    return _fb.scale_sign_rows(x2, scales[seg_ids.long()])
