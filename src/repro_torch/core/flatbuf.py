"""Flat parameter bus: (dtype, sharding-class)-bucketed ``(rows, 128)``
views of a param tree (the port of ``repro.core.flatbuf``).

Layout invariants are the reference's, row for row:

* Leaves are visited in ``jax.tree.flatten`` order (dict keys sorted;
  :func:`repro_torch.utils.tree_flatten`); one bucket per distinct
  (dtype, sharding class), in order of first appearance.  A leaf's class
  (:class:`ShardClass`) is its effective within-worker sharding under a
  :class:`~repro_torch.sharding.layout.MeshLayout`, from
  :func:`shard_classes`; without classes every leaf is of the replicated
  class and there is one bucket per dtype.
* Each leaf is flattened, zero-padded to a multiple of ``LANE`` (128) and
  its row count rounded up to a multiple of ``SUBLANE`` (8).  Hopper needs
  neither; keeping them makes bucket buffers compare directly with the
  JAX package's.
* A SHARDED sub-bucket (S = the class's shard count > 1) is laid out
  shard-major: each leaf's sharded dims are split into (factor, local)
  and the factors moved to the front, every shard's part is padded on
  its own, and the bucket holds shard 0's rows of every leaf, then shard
  1's, ...  So shard s's region is the contiguous row range
  ``[s * local_rows, (s + 1) * local_rows)`` with the same leaf layout in
  every region: a rank that holds shard s holds exactly those rows.
  Slot ``row_offset`` / ``rows`` are shard-local, ``size`` stays the
  leaf's GLOBAL element count.  Per-row constants come in a ``*_local``
  form (one region) and a tiled form (all S regions), so a segmented
  reduction over all rows yields global per-leaf totals.
* ``flatten``/``unflatten`` take a ``leading`` dim count for stacked
  ``(W, ...)`` worker trees; the layout is keyed on per-worker shapes.

``unflatten`` returns VIEWS into replicated buckets (a sharded leaf is
gathered from its S regions: a copy).  The resident local step builds
each worker's param tree with :func:`unflatten_grad_into` instead: the
same values, whose backward writes every leaf's gradient once into its
rows of a grad bucket that the caller zeroed, so the gradient comes out
as a bucket whose padding is exactly zero without a full-bucket pass per
leaf.

The reference's ``bucket_pspec`` (a bucket's mesh ``PartitionSpec``) has
no counterpart: the port places shard regions on ranks itself
(``core/local_sgd``, ``sharding.layout.WorkerLayout``).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.utils import tree_flatten, tree_leaves, tree_map, tree_unflatten

LANE = 128
SUBLANE = 8


@dataclass(frozen=True)
class ShardClass:
    """Effective within-worker sharding of one leaf.

    ``axes`` — mesh axis names sharding the leaf, in dim-major order; the
               empty tuple is the replicated class.
    ``dims`` — (leaf dim index, shard factor) per sharded dim.

    Leaves share a sub-bucket iff they share (dtype, ``axes``, total
    factor), whichever of their dims each one shards.
    """
    axes: tuple[str, ...] = ()
    dims: tuple[tuple[int, int], ...] = ()

    @property
    def shards(self) -> int:
        return math.prod(f for _, f in self.dims) if self.dims else 1


REPLICATED = ShardClass()


@dataclass(frozen=True)
class LeafSlot:
    """Static metadata for one leaf inside its bucket.  In a sharded
    sub-bucket ``row_offset`` / ``rows`` are shard-local (the leaf takes
    the same rows of every shard's region) and ``size`` is global."""
    index: int                 # position in tree-flatten order
    bucket: int                # (dtype, class) bucket id
    seg: int                   # segment id within the bucket (leaf order)
    row_offset: int            # first (shard-local) row of this leaf
    rows: int                  # (shard-local) rows occupied (multiple of SUBLANE)
    size: int                  # true (unpadded) GLOBAL element count
    shape: tuple[int, ...]     # per-worker shape
    dtype: str                 # numpy dtype name
    skip_wd: bool = False      # True => weight decay is masked off
    pack_axis: int = -1        # the reference's per-leaf wire-pack axis (tree path, A.7)
    shard_dims: tuple[tuple[int, int], ...] = ()  # (dim, factor) per sharded dim


@dataclass(frozen=True)
class FlatLayout:
    """Static, hashable description of the bucketization of one tree."""
    treedef: Any
    slots: tuple[LeafSlot, ...]
    bucket_dtypes: tuple[str, ...]
    bucket_rows: tuple[int, ...]                        # TOTAL rows (all shards)
    bucket_classes: tuple[tuple[str, ...], ...] = ()    # mesh axes per bucket
    bucket_shards: tuple[int, ...] = ()                 # shard count per bucket

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_dtypes)

    @property
    def num_leaves(self) -> int:
        return len(self.slots)

    def bucket_slots(self, b: int) -> list[LeafSlot]:
        return [s for s in self.slots if s.bucket == b]

    def bucket_class(self, b: int) -> tuple[str, ...]:
        """Mesh axes sharding bucket ``b``'s rows (() = replicated)."""
        return self.bucket_classes[b] if self.bucket_classes else ()

    def bucket_shard_count(self, b: int) -> int:
        return self.bucket_shards[b] if self.bucket_shards else 1

    def bucket_local_rows(self, b: int) -> int:
        """Rows of ONE shard's region (all rows for a replicated bucket)."""
        return self.bucket_rows[b] // self.bucket_shard_count(b)

    def bucket_bytes(self, b: int) -> int:
        return self.bucket_rows[b] * LANE * np.dtype(self.bucket_dtypes[b]).itemsize

    def total_bytes(self) -> int:
        return sum(self.bucket_bytes(b) for b in range(self.num_buckets))


def dtype_name(dtype) -> str:
    """numpy name of a torch or numpy dtype ('float32', ...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _leaf_rows(size: int) -> int:
    rows = -(-max(size, 1) // LANE)
    return -(-rows // SUBLANE) * SUBLANE


def _is_class(x) -> bool:
    return x is None or isinstance(x, ShardClass)


def build_layout(tree, *, wd_mask=None, leading: int = 0,
                 shard_classes=None) -> FlatLayout:
    """Build the static bucket layout for ``tree``.

    Leaves may be tensors, numpy arrays or anything with ``.shape`` and
    ``.dtype`` (``models.base.abstract``).  ``leading`` strips that many
    leading dims before recording the per-worker shape; ``wd_mask`` is a
    congruent tree of skip-weight-decay bits.  ``shard_classes`` is a
    congruent tree of :class:`ShardClass` (None entries: replicated):
    leaves are bucketed per (dtype, class) and sharded classes take the
    shard-major rows.  ``None`` gives one replicated bucket per dtype, the
    same layout as a tree of replicated classes.  A class whose factors
    do not divide its leaf raises ``ValueError`` (``shard_classes`` never
    makes one; the reference asserts).
    """
    leaves, treedef = tree_flatten(tree)
    n = len(leaves)
    wd = tree_leaves(wd_mask) if wd_mask is not None else [False] * n
    sc = (tree_leaves(shard_classes, is_leaf=_is_class)
          if shard_classes is not None else [REPLICATED] * n)
    assert len(wd) == n and len(sc) == n, (n, len(wd), len(sc))
    keys: list[tuple] = []          # (dtype, class axes, shard count)
    rows_used: list[int] = []       # shard-LOCAL rows per bucket
    segs: list[int] = []
    slots: list[LeafSlot] = []
    for i, leaf in enumerate(leaves):
        shape = tuple(int(d) for d in leaf.shape[leading:])
        dt = dtype_name(leaf.dtype)
        c = sc[i] if sc[i] is not None else REPLICATED
        S = c.shards
        key = (dt, c.axes, S)
        if key not in keys:
            keys.append(key)
            rows_used.append(0)
            segs.append(0)
        b = keys.index(key)
        size = math.prod(shape) if shape else 1
        if any(shape[d] % f for d, f in c.dims):
            raise ValueError(f"leaf {i} of shape {shape}: the class {c} "
                             f"does not divide it")
        rows = _leaf_rows(size // S)
        slots.append(LeafSlot(index=i, bucket=b, seg=segs[b],
                              row_offset=rows_used[b], rows=rows, size=size,
                              shape=shape, dtype=dt, skip_wd=bool(wd[i]),
                              shard_dims=c.dims))
        rows_used[b] += rows
        segs[b] += 1
    return FlatLayout(treedef=treedef, slots=tuple(slots),
                      bucket_dtypes=tuple(k[0] for k in keys),
                      bucket_rows=tuple(r * k[2] for r, k in zip(rows_used, keys)),
                      bucket_classes=tuple(k[1] for k in keys),
                      bucket_shards=tuple(k[2] for k in keys))


# ---------------------------------------------------------------------------
# Flatten / unflatten
# ---------------------------------------------------------------------------

def _to_shard_major(x, shard_dims, leading: int):
    """(*lead, *shape) -> (*lead, S, local_size): each sharded dim split
    into (factor, local), the factors moved to the front in dim order."""
    lead = tuple(x.shape[:leading])
    fac = dict(shard_dims)
    new_shape = list(lead)
    factor_pos: list[int] = []
    local_pos: list[int] = []
    for i, d in enumerate(x.shape[leading:]):
        f = fac.get(i)
        if f:
            factor_pos.append(len(new_shape))
            new_shape.append(f)
        local_pos.append(len(new_shape))
        new_shape.append(d // f if f else d)
    y = x.reshape(new_shape).permute(list(range(leading)) + factor_pos
                                     + local_pos)
    return y.reshape(lead + (math.prod(f for _, f in shard_dims), -1))


def _from_shard_major(y, shard_dims, shape, leading: int):
    """Inverse of :func:`_to_shard_major`: (*lead, S, local_size) ->
    (*lead, *shape)."""
    lead = tuple(y.shape[:leading])
    fac = dict(shard_dims)
    factors = [f for _, f in sorted(shard_dims)]
    local = tuple(d // fac.get(i, 1) for i, d in enumerate(shape))
    y = y.reshape(lead + tuple(factors) + local)
    k = len(factors)
    perm = list(range(leading))
    fidx = 0
    for i in range(len(shape)):
        if i in fac:
            perm.append(leading + fidx)
            fidx += 1
        perm.append(leading + k + i)
    return y.permute(perm).reshape(lead + tuple(shape))


def _regions(layout: FlatLayout, b: int, flat):
    """A bucket's flat ``(*lead, rows * 128)`` buffer as ``(*lead, S,
    local_rows * 128)``: shard s's region in row s (S = 1: one region)."""
    S = layout.bucket_shard_count(b)
    return flat.reshape(flat.shape[:-1] + (S, layout.bucket_local_rows(b) * LANE))


def flatten(layout: FlatLayout, tree, *, leading: int = 0,
            bucket_dtypes: Sequence[str] | None = None) -> list[torch.Tensor]:
    """Pack ``tree`` (tensors) into one ``(*lead, rows, 128)`` buffer per
    bucket, shard-major for sharded sub-buckets; padding is zero.
    ``bucket_dtypes`` overrides the buffers' dtypes, keeping the layout's
    geometry."""
    leaves = tree_leaves(tree)
    assert len(leaves) == layout.num_leaves, (len(leaves), layout.num_leaves)
    buckets = []
    for b in range(layout.num_buckets):
        dt = torch_dtype((bucket_dtypes or layout.bucket_dtypes)[b])
        S = layout.bucket_shard_count(b)
        slots = layout.bucket_slots(b)
        x0 = leaves[slots[0].index]
        lead = tuple(x0.shape[:leading])
        buf = torch.zeros(lead + (layout.bucket_rows[b] * LANE,), dtype=dt,
                          device=x0.device)
        reg = _regions(layout, b, buf)
        for s in slots:
            off = s.row_offset * LANE
            x = leaves[s.index]
            if S > 1:
                x = _to_shard_major(x, s.shard_dims, leading)
            reg[..., off:off + s.size // S] = x.reshape(lead + (S, -1))
        buckets.append(buf.view(lead + (layout.bucket_rows[b], LANE)))
    return buckets


def unflatten(layout: FlatLayout, buckets: Sequence[torch.Tensor], *,
              leading: int = 0):
    """Inverse of :func:`flatten`: a tree with the per-leaf padding dropped
    (VIEWS into replicated buckets, copies of sharded leaves)."""
    assert len(buckets) == layout.num_buckets
    vals: list = [None] * layout.num_leaves
    for b, buf in enumerate(buckets):
        lead = tuple(buf.shape[:leading])
        S = layout.bucket_shard_count(b)
        reg = _regions(layout, b, buf.reshape(lead + (-1,)))
        for s in layout.bucket_slots(b):
            off = s.row_offset * LANE
            seg = reg[..., off:off + s.size // S]
            vals[s.index] = (seg.reshape(lead + s.shape) if S == 1 else
                             _from_shard_major(seg, s.shard_dims, s.shape,
                                               leading))
    return tree_unflatten(layout.treedef, vals)


class _LeafViews(torch.autograd.Function):
    """The leaves of one single-copy bucket (forward): views of a
    replicated bucket, shard-major gathers of a sharded one.  Backward
    copies each leaf's gradient into its rows of ``out``, a bucket whose
    padding the caller zeroed (through the shard-major relayout in a
    sharded bucket), and returns ``out`` itself: the gradient lands once,
    where plain slicing would build one zero-filled bucket per leaf
    (``slice_backward``) and add them up."""

    @staticmethod
    def _segment(reg, s, S):
        """Slot ``s``'s elements in every region of ``reg`` (S, -1)."""
        off = s.row_offset * LANE
        return reg[:, off:off + s.size // S]

    @staticmethod
    def forward(ctx, buf, slots, out, S):
        ctx.slots, ctx.out, ctx.S = slots, out, S
        ctx.set_materialize_grads(False)
        reg = buf.view(S, -1)
        vals = []
        for s in slots:
            seg = _LeafViews._segment(reg, s, S)
            vals.append(seg.view(s.shape) if S == 1 else
                        _from_shard_major(seg, s.shard_dims, s.shape, 0))
        return tuple(vals)

    @staticmethod
    def backward(ctx, *grads):
        # drop the node's reference to the grad bucket: on the card the
        # node outlives the step, and held one stacked grad bucket (W x
        # 478 MB at paper-lm's width) from one step into the next
        out, ctx.out = ctx.out, None
        S = ctx.S
        reg = out.view(S, -1)
        for s, g in zip(ctx.slots, grads):
            dst = _LeafViews._segment(reg, s, S)
            if g is None:
                dst.zero_()
            elif S == 1:
                dst.copy_(g.reshape(1, -1))
            else:
                dst.copy_(_to_shard_major(g, s.shard_dims, 0))
        return out, None, None, None


def unflatten_grad_into(layout: FlatLayout, buckets: Sequence[torch.Tensor],
                        grads: Sequence[torch.Tensor]):
    """:func:`unflatten` of single-copy ``buckets`` (which require grad)
    whose gradient lands in ``grads``: differentiating through the leaves
    writes each leaf's gradient into its rows of ``grads[b]`` in one pass
    (shard-major in a sharded bucket) and yields ``grads[b]`` as the
    bucket's gradient.  The caller zeroes ``grads`` (same shape as
    ``buckets``) once; its padding stays zero."""
    assert len(buckets) == len(grads) == layout.num_buckets
    vals: list = [None] * layout.num_leaves
    for b, (buf, out) in enumerate(zip(buckets, grads)):
        assert buf.shape == out.shape, (buf.shape, out.shape)
        slots = tuple(layout.bucket_slots(b))
        for s, v in zip(slots, _LeafViews.apply(
                buf, slots, out, layout.bucket_shard_count(b))):
            vals[s.index] = v
    return tree_unflatten(layout.treedef, vals)


@dataclass(frozen=True)
class BucketState:
    """Bucket buffers + their static layout.  ``leading=1`` marks
    worker-stacked ``(W, rows, 128)`` buffers; the same layout describes
    the stacked and the single-copy form.

    While a ``BucketState`` is live the buffers are the single source of
    truth; the tree view exists only through :meth:`unpack`.
    """
    layout: FlatLayout
    buckets: tuple
    leading: int = 0

    @classmethod
    def pack(cls, tree, *, layout: FlatLayout | None = None, wd_mask=None,
             leading: int = 0) -> "BucketState":
        if layout is None:
            layout = build_layout(tree, wd_mask=wd_mask, leading=leading)
        return cls(layout=layout,
                   buckets=tuple(flatten(layout, tree, leading=leading)),
                   leading=leading)

    def unpack(self):
        return unflatten(self.layout, list(self.buckets), leading=self.leading)

    def with_buckets(self, buckets, *, leading: int | None = None) -> "BucketState":
        return BucketState(layout=self.layout, buckets=tuple(buckets),
                           leading=self.leading if leading is None else leading)

    @property
    def num_buckets(self) -> int:
        return self.layout.num_buckets


def is_bucket_state(x) -> bool:
    return isinstance(x, BucketState)


def abstract_buckets(layout: FlatLayout, *, lead: tuple = (),
                     device="meta") -> list[torch.Tensor]:
    """One uninitialized ``(*lead, rows, LANE)`` tensor per bucket, on
    ``device`` (``"meta"``: shape and dtype only, no storage).

    The template form of the resident checkpoint restores and the serving
    weight subscriber (a :class:`BucketState` of these restores a
    published bucket snapshot without a pytree view), and, on a real
    device with ``lead=(num_pages, page_size)``, the serving page pools.
    """
    return [torch.empty(tuple(lead) + (layout.bucket_rows[b], LANE),
                        dtype=torch_dtype(layout.bucket_dtypes[b]),
                        device=device)
            for b in range(layout.num_buckets)]


# ---------------------------------------------------------------------------
# Per-bucket constants (numpy; tensor forms cached per device).  The
# ``*_local`` forms describe one shard's region; the plain forms are them
# tiled over the bucket's S regions (identical for a replicated bucket).
# ---------------------------------------------------------------------------

def _tile_shards(layout: FlatLayout, b: int, local: np.ndarray) -> np.ndarray:
    """Tile a shard-local per-row constant over the bucket's S regions
    (identity for a replicated bucket): every region has the same leaf
    layout, so a segmented reduction over all rows adds across shards."""
    S = layout.bucket_shard_count(b)
    if S == 1:
        return local
    return np.tile(local, (S,) + (1,) * (local.ndim - 1))


def wd_rows_local(layout: FlatLayout, b: int) -> np.ndarray:
    """(local_rows, 1) f32 mask: 1.0 on rows whose leaf takes weight decay."""
    m = np.zeros((layout.bucket_local_rows(b), 1), np.float32)
    for s in layout.bucket_slots(b):
        if not s.skip_wd:
            m[s.row_offset:s.row_offset + s.rows] = 1.0
    return m


def wd_rows(layout: FlatLayout, b: int) -> np.ndarray:
    """(rows, 1) f32 weight-decay mask over all regions."""
    return _tile_shards(layout, b, wd_rows_local(layout, b))


def row_segments_local(layout: FlatLayout, b: int) -> np.ndarray:
    """(local_rows,) int32: leaf segment id per row of ONE shard's region."""
    seg = np.zeros((layout.bucket_local_rows(b),), np.int32)
    for s in layout.bucket_slots(b):
        seg[s.row_offset:s.row_offset + s.rows] = s.seg
    return seg


def row_order_local(layout: FlatLayout, b: int) -> np.ndarray:
    """(local_rows,) int64: the rows of one shard's region listed leaf by
    leaf, each leaf's rows in row order (a stable sort of
    :func:`row_segments_local`): the ``order`` of
    ``kernels.fused_bucket.segment_sum``."""
    return np.argsort(row_segments_local(layout, b), kind="stable").astype(
        np.int64)


def segment_offsets_local(layout: FlatLayout, b: int) -> np.ndarray:
    """(num_segments + 1,) int64: where each leaf's rows start in
    :func:`row_order_local` (the ``offsets`` of ``segment_sum``)."""
    counts = np.bincount(row_segments_local(layout, b),
                         minlength=len(layout.bucket_slots(b)))
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def segment_index(layout: FlatLayout, b: int, device) -> tuple:
    """(seg_ids, order, offsets) tensors of bucket ``b``'s per-region
    segments on ``device`` (``kernels.fused_bucket.segment_index``'s
    form), built once per device."""
    return (const("row_segments_local", layout, b, device),
            const("row_order_local", layout, b, device),
            const("segment_offsets_local", layout, b, device))


def row_segments(layout: FlatLayout, b: int) -> np.ndarray:
    """(rows,) int32: bucket-local leaf segment id per row, tiled over the
    shard regions of a sharded sub-bucket."""
    return _tile_shards(layout, b, row_segments_local(layout, b))


def segment_sizes(layout: FlatLayout, b: int) -> np.ndarray:
    """(num_segments,) f32: TRUE (global) element count per leaf."""
    slots = layout.bucket_slots(b)
    out = np.zeros((len(slots),), np.float32)
    for s in slots:
        out[s.seg] = float(s.size)
    return out


def segment_skip_wd(layout: FlatLayout, b: int) -> np.ndarray:
    """(num_segments,) bool: True where the leaf opts out of weight decay
    (norm/bias params, which also take the plain LR under LARS)."""
    slots = layout.bucket_slots(b)
    out = np.zeros((len(slots),), bool)
    for s in slots:
        out[s.seg] = s.skip_wd
    return out


def valid_mask(layout: FlatLayout, b: int) -> np.ndarray:
    """(rows, 128) f32 mask: 1.0 on true elements, 0.0 on padding (each
    shard region padded on its own)."""
    S = layout.bucket_shard_count(b)
    m = np.zeros((layout.bucket_local_rows(b), LANE), np.float32)
    flat = m.reshape(-1)
    for s in layout.bucket_slots(b):
        off = s.row_offset * LANE
        flat[off:off + s.size // S] = 1.0
    return _tile_shards(layout, b, m)


def lane_counts_local(layout: FlatLayout, b: int) -> np.ndarray:
    """(local_rows, 1) int32: number of valid lanes per row of one region."""
    S = layout.bucket_shard_count(b)
    c = np.zeros((layout.bucket_local_rows(b), 1), np.int32)
    for s in layout.bucket_slots(b):
        c[s.row_offset:s.row_offset + s.rows, 0] = np.clip(
            s.size // S - np.arange(s.rows) * LANE, 0, LANE)
    return c


def lane_counts(layout: FlatLayout, b: int) -> np.ndarray:
    """(rows, 1) int32: number of valid lanes per row, over all regions."""
    return _tile_shards(layout, b, lane_counts_local(layout, b))


@functools.lru_cache(maxsize=64)
def _const(fn_name: str, layout: FlatLayout, b: int, device: str):
    arr = globals()[fn_name](layout, b)
    return torch.from_numpy(arr).to(device)


def const(fn_name: str, layout: FlatLayout, b: int, device) -> torch.Tensor:
    """Tensor form of one of the per-bucket numpy constants above
    (``"wd_rows"``, ``"row_segments_local"``, ...), built once per device."""
    return _const(fn_name, layout, b, str(torch.device(device)))


def shard_regions(layout: FlatLayout, b: int, x: torch.Tensor) -> torch.Tensor:
    """A ``(*lead, rows, 128)`` buffer of bucket ``b`` as the view
    ``(*lead, R, local_rows, 128)`` of its shard regions: R = S when ``x``
    holds the whole bucket (one process), R = 1 when it holds one shard's
    region (a rank of a within-worker grid, or a replicated bucket).
    Kernels launched on this view take the ``*_local`` constants and give
    one partial a region, which callers add in shard order."""
    lr = layout.bucket_local_rows(b)
    rows = int(x.shape[-2])
    if rows not in (lr, layout.bucket_rows[b]):
        raise ValueError(f"bucket {b}: {rows} rows is neither the bucket's "
                         f"{layout.bucket_rows[b]} nor one shard's {lr}")
    return x.view(tuple(x.shape[:-2]) + (rows // lr, lr, x.shape[-1]))


def mask_padding(layout: FlatLayout, b: int, x: torch.Tensor) -> torch.Tensor:
    """Zero the padding slots of a ``(*lead, rows, 128)`` buffer holding the
    whole bucket or one shard's region."""
    cnt = const("lane_counts_local", layout, b, x.device)
    lane = torch.arange(LANE, device=x.device, dtype=torch.int32)[None, :]
    keep = (lane < cnt).to(x.dtype)
    return (shard_regions(layout, b, x) * keep).view(x.shape)


# ---------------------------------------------------------------------------
# Sharding-derived metadata
# ---------------------------------------------------------------------------

def shard_classes(specs, layout):
    """Per-leaf :class:`ShardClass` tree from a ``models.base.ParamSpec``
    tree and a :class:`~repro_torch.sharding.layout.MeshLayout` (with its
    axis sizes).  Classification goes through ``MeshLayout.dim_shards``,
    the rule application with the shape-aware divisibility drop and the
    first-wins mesh-axis dedup, so a leaf lands in a sharded sub-bucket
    iff its effective spec shards it."""
    from repro_torch.models import base as mbase

    def cls(ps) -> ShardClass:
        axes: list[str] = []
        dims: list[tuple[int, int]] = []
        for i, r in enumerate(layout.dim_shards(ps.axes, ps.shape)):
            if r is None:
                continue
            f = layout.axis_size(r)
            if f <= 1:
                continue
            axes.extend((r,) if isinstance(r, str) else r)
            dims.append((i, f))
        return ShardClass(axes=tuple(axes), dims=tuple(dims))

    return tree_map(cls, specs, is_leaf=mbase.is_spec)


def replicated_tree(classes):
    """bool tree: True where the leaf's class is replicated."""
    return tree_map(lambda c: c.axes == (), classes,
                    is_leaf=lambda x: isinstance(x, ShardClass))


def shard_sum(layout: FlatLayout, b: int, part: torch.Tensor,
              across=None) -> torch.Tensor:
    """Per-region partial sums ``(..., R)`` of bucket ``b`` (a kernel's
    output on :func:`shard_regions`' view, the region axis moved last) ->
    the bucket's totals ``(...)``, added in shard order.  One process adds
    its R = S regions; a rank that holds one region of a sharded bucket
    adds the shard group's partials (``across.shard_total``, the same
    adds in the same order).  A replicated bucket's single region is its
    total: it is counted once, never summed over the shard ranks."""
    acc = part[..., 0]
    for s in range(1, part.shape[-1]):
        acc = acc + part[..., s]
    if part.shape[-1] == 1 and layout.bucket_shard_count(b) > 1:
        if across is None:
            raise ValueError(f"bucket {b}: one shard region of a sharded "
                             f"bucket needs the shard group to total it")
        acc = across.shard_total(acc)
    return acc
