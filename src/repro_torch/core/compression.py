"""Sync-payload compression (paper Alg. 3 / Alg. 4): the port of
``repro.core.compression`` — the bucket compressors of the resident path,
the tree compressors of the tree path and the 1-bit wire format.

The compressed quantity is the model difference accumulated over H
local steps; workers exchange sign(Delta) with one L1 scale per leaf
(signSGD), optionally with an error-feedback memory (EF-signSGD).  On a
stacked ``(W, ...)`` leaf the scale is mean|x| over the whole leaf, all
workers together, as the reference's per-leaf compressor computes it:
the port sums each worker's |x| on its own and adds the sums in worker
order, so that a leaf split over ranks (``across=``) gets the same
scale.
:func:`sign_compress` / :func:`ef_compress` take trees, per leaf in
plain PyTorch (``use_kernel=False``) or packed into ``(W, rows, 128)``
buckets, compressed by the bucket kernels and unpacked
(``use_kernel=True``: the tree-in/tree-out kernel form).

The wire format packs the signs 8 to a ``uint8`` (bit i of byte k is
element 8k + i) beside one f32 scale per leaf: 1/32 of the f32 payload.
Packing and unpacking are plain PyTorch bit ops.  sign(0) packs as +1,
where the unpacked compressor gives 0: an exact-zero delta differs
between the two forms, in both packages.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import flatbuf
from repro_torch.kernels import ops as kops
from repro_torch.utils import (tree_flatten, tree_leaves, tree_map,
                               tree_unflatten)


def _row_abs_sums(x):
    """(n,) f32: sum |x| of each of x's n leading rows (a stacked leaf's
    workers), one reduction a row, so a row's sum does not depend on how
    many rows lie beside it."""
    xf = x.float()
    if xf.dim() == 0:
        return xf.abs().reshape(1)
    return torch.stack([r.abs().sum() for r in xf.unbind(0)])


def leaf_abs_totals(leaves, *, across=None):
    """(L,) f32: sum |x| of each of ``leaves`` over all its leading rows,
    the rows' sums added one after another in row (worker) order
    (``kernels.ops.lead_total``).  ``across`` (a
    ``backend.collectives.Collectives``) holds the other workers' rows on
    other ranks: every rank's per-worker sums of every leaf are gathered
    (one all-gather) and added in worker order, the adds one process
    makes."""
    per = torch.stack([_row_abs_sums(x) for x in leaves], dim=1)   # (n, L)
    if across is not None:
        per = across.gather_workers(per, scope="compress")
    return kops.lead_total(per)


def _leaf_count(x, across=None) -> int:
    """The element count a stacked leaf's scale averages over: all its
    workers', every rank's too with ``across``."""
    if across is None or x.dim() == 0:
        return x.numel()
    return x[0].numel() * across.layout.num_workers


def sign_compress_leaf(x, *, total=None, across=None):
    """sign(x) * mean|x| of one tensor, as f32: the 1-bit + scale
    compressor.  The |x| total is :func:`leaf_abs_totals`'s (its leading
    rows' sums in row order), or ``total`` when the caller has it; with
    ``across`` x is this rank's rows of a leaf stacked over every rank's
    workers, and the mean runs over all of them."""
    if total is None:
        total = leaf_abs_totals([x], across=across)[0]
    return torch.sign(x.float()) * (total / _leaf_count(x, across))


def _sign_compress_leaves(leaves, across=None):
    """:func:`sign_compress_leaf` of every leaf, their totals in one
    gather across ranks."""
    if not leaves:
        return []
    totals = leaf_abs_totals(leaves, across=across)
    return [sign_compress_leaf(x, total=t, across=across)
            for x, t in zip(leaves, totals.unbind(0))]


def worker_abs_totals(layout, b: int, x, *, across=None):
    """Sum |x| per leaf of bucket ``b``'s ``(*lead, rows, 128)`` buffer (the
    whole bucket, or one shard's region on a rank of a shard group), each
    leading index on its own -> ``(*lead, num_segments)`` f32: the
    ``row_abs_sum`` launch on the shard regions' view, one ``segment_sum``
    launch over every (worker, region) row, the regions' totals added in
    shard order (``flatbuf.shard_sum``; ``across`` adds the shard
    group's)."""
    xr = flatbuf.shard_regions(layout, b, x.float().contiguous())
    part = kops.bucket_abs_totals(
        xr, flatbuf.segment_index(layout, b, x.device), per_lead=True)
    return flatbuf.shard_sum(layout, b, part.movedim(-1, -2), across)


def sign_compress_bucket(layout, b: int, x, *, leading: int = 0,
                         across=None):
    """sign(x) * mean|x| per leaf segment of bucket ``b``, straight on a
    ``(*lead, rows, 128)`` buffer; returns f32 of x's shape.

    With ``leading=1`` the per-leaf scale averages |x| over ALL workers
    (the reference tiles the row map W times and divides by size * W),
    so one scale per leaf is shared by every worker.  Padding compresses
    to sign(0) * scale = 0.

    ``across`` (a ``backend.collectives.Collectives``) holds the other
    workers on other ranks: the totals then add this rank's row sums onto
    the previous ranks' running totals in worker order
    (:meth:`~repro_torch.backend.collectives.Collectives.ordered_segment_sum`),
    the adds one process makes, in its order.  A sharded sub-bucket (whole,
    or one shard's region across ranks) totals each worker's leaves over
    its shard regions in shard order (:func:`worker_abs_totals`), then
    adds the workers' totals in worker order: the same adds in one process
    and across ranks.  Every add runs in a fixed order on either device
    (``kernels.ops.segment_sum``), so a worker's shard ranks compute a
    replicated bucket's totals from the same rows with the same bits.
    """
    sizes = flatbuf.const("segment_sizes", layout, b, x.device)
    W = math.prod(x.shape[:leading])
    xf = x.float().contiguous()
    if layout.bucket_shard_count(b) > 1:
        per = worker_abs_totals(layout, b, xf, across=across)
        n = W
        if leading and across is not None:
            per = across.gather_workers(per, scope="compress")
            n = across.layout.num_workers
        tot = kops.lead_total(per.reshape(-1, per.shape[-1]))
        seg = flatbuf.const("row_segments_local", layout, b, x.device)
        return kops.bucket_scale_sign(flatbuf.shard_regions(layout, b, xf),
                                      seg, tot / (sizes * n)).view(x.shape)
    seg = flatbuf.const("row_segments", layout, b, x.device)
    index = flatbuf.segment_index(layout, b, x.device)
    if across is None:
        y, _ = kops.bucket_sign_compress(xf, seg, sizes * W, index=index)
        return y
    assert leading == 1, leading
    rows = kops.bucket_row_abs_sums(xf)                  # (W_local, rows)
    totals = across.ordered_segment_sum(rows, index, scope="compress")
    scales = totals / (sizes * across.layout.num_workers)
    return kops.bucket_scale_sign(xf, seg, scales)


def ef_compress_bucket(layout, b: int, d, e, *, leading: int = 0,
                       across=None):
    """EF compression of one bucket: returns (compressed, new_memory,
    input) with input = d + e and new_memory = input - compressed."""
    inp = d.float() + e.float()
    out = sign_compress_bucket(layout, b, inp, leading=leading, across=across)
    return out, inp - out, inp


def compress_stage(layout, stage, d, e=None, *, leading: int = 0,
                   across=None):
    """Apply a pack stage's declared mode to its bucket's delta ``d``
    (``e`` is the EF memory for ``ef_sign``; ``across`` as in
    :func:`sign_compress_bucket`).  Returns (compressed, new_memory,
    input) uniformly; for ``none`` that is (d, e, d)."""
    assert stage.kind == "pack" and len(stage.buckets) == 1, stage
    b = stage.buckets[0]
    mode = stage.compression
    if mode == "none":
        return d, e, d
    if mode == "sign":
        return (sign_compress_bucket(layout, b, d, leading=leading,
                                     across=across), e, d)
    if mode == "ef_sign":
        return ef_compress_bucket(layout, b, d, e, leading=leading,
                                  across=across)
    raise ValueError(f"unknown stage compression {mode!r}")


def sign_compress_buckets(layout, bufs, *, leading: int = 0, across=None):
    """:func:`sign_compress_bucket` of every bucket in ``bufs``."""
    return [sign_compress_bucket(layout, b, x, leading=leading, across=across)
            for b, x in enumerate(bufs)]


def ef_compress_buckets(layout, dbufs, ebufs, *, leading: int = 0,
                        across=None):
    """EF compression of every bucket: (compressed, new_memory) lists, both
    f32; compressed + new_memory == delta + memory exactly in f32."""
    outs = [ef_compress_bucket(layout, b, d, e, leading=leading, across=across)
            for b, (d, e) in enumerate(zip(dbufs, ebufs, strict=True))]
    return [o[0] for o in outs], [o[1] for o in outs]


def _sign_compress_bucketed(tree, bucketable=None, across=None):
    """The tree-in/tree-out kernel form on a stacked ``(W, ...)`` tree: the
    leaves packed into ``(W, rows, 128)`` buckets, one ``row_abs_sum`` +
    ``segment_sum`` + ``scale_sign_rows`` launch each (the per-leaf scales
    over all W workers; with ``across`` this rank's rows, the totals
    chained over the ranks in worker order), unpacked.  Leaves flagged
    False in ``bucketable`` take the per-leaf compressor."""
    leaves, treedef = tree_flatten(tree)
    flags = (tree_leaves(bucketable) if bucketable is not None
             else [True] * len(leaves))
    out: list = [None] * len(leaves)
    on = [i for i, m in enumerate(flags) if m]
    off = [i for i, m in enumerate(flags) if not m]
    for i, v in zip(off, _sign_compress_leaves([leaves[i] for i in off],
                                               across)):
        out[i] = v
    if on:
        sub = [leaves[i] for i in on]
        layout = flatbuf.build_layout(sub, leading=1)
        ys = sign_compress_buckets(
            layout, flatbuf.flatten(layout, sub, leading=1), leading=1,
            across=across)
        for i, v in zip(on, flatbuf.unflatten(layout, ys, leading=1)):
            out[i] = v
    return tree_unflatten(treedef, out)


def sign_compress(tree, *, use_kernel: bool = False, bucketable=None,
                  across=None):
    """sign(x) * mean|x| of every leaf, as f32 (the kernel form takes the
    stacked ``(W, ...)`` delta of the tree sync).  ``across`` (a
    ``backend.collectives.Collectives``): the tree holds this rank's
    workers, and each leaf's scale is the mean over every rank's."""
    if use_kernel:
        return _sign_compress_bucketed(tree, bucketable, across)
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, _sign_compress_leaves(leaves, across))


def ef_compress(delta, memory, *, use_kernel: bool = False, bucketable=None,
                across=None):
    """Error-feedback compression: compress(delta + e); e' = input - output.
    Returns (compressed, new_memory), both f32, with compressed +
    new_memory == delta + memory exactly in f32 (``across`` as in
    :func:`sign_compress`)."""
    inp = tree_map(lambda d, e: d.float() + e.float(), delta, memory)
    out = sign_compress(inp, use_kernel=use_kernel, bucketable=bucketable,
                        across=across)
    return out, tree_map(lambda i, o: i - o, inp, out)


def compressed_bytes(tree) -> int:
    """Wire size of the compressed payload: 1 bit an element plus one f32
    scale a tensor."""
    return int(sum(-(-t.numel() // 8) + 4 for t in tree_leaves(tree)))


def dense_bytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


# ---------------------------------------------------------------------------
# The 1-bit wire format
# ---------------------------------------------------------------------------

def _pack_bits(x):
    """(..., L) with L % 8 == 0 -> (..., L / 8) uint8: bit i of byte k is
    set where x[..., 8k + i] >= 0 (sign(0) packs as +1)."""
    xb = x.reshape(*x.shape[:-1], -1, 8)
    packed = torch.zeros(xb.shape[:-1], dtype=torch.uint8, device=x.device)
    for i in range(8):
        packed |= (xb[..., i] >= 0).to(torch.uint8) << i
    return packed


def _unpack_bits(packed):
    """(..., n) uint8 -> (..., 8n) f32 of +-1."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return (2.0 * bits.float() - 1.0).reshape(*packed.shape[:-1], -1)


def pack_signs(x, axis: int = -1):
    """x: (W, *shape) -> (packed uint8 with dim ``axis`` moved last and
    8x smaller, padded to whole bytes; scale (W,) f32 = mean |x| per
    worker).  ``axis`` must not be the worker dim."""
    ax = axis % x.dim()
    assert ax >= 1, "cannot pack along the worker dim"
    xf = torch.movedim(x.float(), ax, -1)
    scale = xf.abs().mean(dim=tuple(range(1, xf.dim())))
    pad = (-xf.shape[-1]) % 8
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    return _pack_bits(xf), scale


def unpack_signs(packed, scale, shape, axis: int = -1):
    """Inverse of :func:`pack_signs` -> (W, *shape) f32 sign * scale."""
    W = packed.shape[0]
    full = (W,) + tuple(shape)
    ax = axis % len(full)
    signs = _unpack_bits(packed)[..., :full[ax]]
    signs = torch.movedim(signs, -1, ax)
    return signs * scale.reshape((W,) + (1,) * len(shape))


def pack_bucket_signs(x2, seg_ids, seg_sizes, *, index=None):
    """Buckets ``(*lead, rows, 128)`` -> (packed ``(*lead, rows, 16)``
    uint8, per-leaf scales ``(*lead, num_segments)`` f32), each leading
    index (worker) packed on its own, as the reference vmaps its
    one-worker pack.  Scales are each worker's per-leaf |x| totals (the
    compressor's row sums and segmented sum) over the TRUE element counts
    ``seg_sizes``, so bucket padding never biases them."""
    if index is None:
        index = kops.segment_index(seg_ids, int(seg_sizes.shape[0]))
    totals = kops.bucket_abs_totals(x2, index, per_lead=True)
    return _pack_bits(x2), totals / seg_sizes


def unpack_bucket_signs(packed, scales, seg_ids):
    """Inverse of :func:`pack_bucket_signs` over gathered payloads: packed
    ``(W, rows, 16)`` + scales ``(W, num_segments)`` -> ``(W, rows, 128)``
    f32 sign * scale."""
    return _unpack_bits(packed) * scales[..., seg_ids.long()][..., None]


def pack_bucket(layout, b: int, x, *, across=None):
    """The 1-bit wire pack of bucket ``b``'s ``(*lead, rows, 128)`` buffer
    (the whole bucket, or one shard's region across ranks): packed
    ``(*lead, rows, 16)`` uint8 and per-leaf scales ``(*lead,
    num_segments)``, each leading index (worker) on its own.  A sharded
    sub-bucket's scales are its workers' global per-leaf totals
    (:func:`worker_abs_totals`) over the leaves' GLOBAL sizes; a
    replicated one's (:func:`pack_bucket_signs`) are summed in the same
    fixed order on each of a worker's shard ranks, from the same rows."""
    sizes = flatbuf.const("segment_sizes", layout, b, x.device)
    if layout.bucket_shard_count(b) == 1:
        seg = flatbuf.const("row_segments", layout, b, x.device)
        return pack_bucket_signs(x, seg, sizes,
                                 index=flatbuf.segment_index(layout, b,
                                                             x.device))
    return _pack_bits(x), worker_abs_totals(layout, b, x, across=across) / sizes


def unpack_bucket(layout, b: int, packed, scales):
    """Inverse of :func:`pack_bucket` over gathered payloads ``(W, rows,
    16)`` + scales ``(W, num_segments)`` -> ``(W, rows, 128)`` f32, rows
    the whole bucket's or one shard region's."""
    rows = packed.shape[-2]
    name = ("row_segments" if rows == layout.bucket_rows[b]
            else "row_segments_local")
    return unpack_bucket_signs(packed, scales,
                               flatbuf.const(name, layout, b, packed.device))
