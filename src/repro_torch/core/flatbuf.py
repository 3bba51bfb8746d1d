"""Flat parameter bus: dtype-bucketed ``(rows, 128)`` views of a param tree
(the port of ``repro.core.flatbuf``, replicated class only).

Layout invariants are the reference's, row for row:

* Leaves are visited in ``jax.tree.flatten`` order (dict keys sorted;
  :func:`repro_torch.utils.tree_flatten`); one bucket per dtype, in order
  of first appearance.
* Each leaf is flattened, zero-padded to a multiple of ``LANE`` (128) and
  its row count rounded up to a multiple of ``SUBLANE`` (8).  Hopper needs
  neither; keeping them makes bucket buffers compare directly with the
  JAX package's.
* ``flatten``/``unflatten`` take a ``leading`` dim count for stacked
  ``(W, ...)`` worker trees; the layout is keyed on per-worker shapes.

``unflatten`` returns VIEWS into the bucket buffers.  The resident local
step builds each worker's param tree with :func:`unflatten_grad_into`
instead: the same views, whose backward writes every leaf's gradient
once into its rows of a grad bucket that the caller zeroed, so the
gradient comes out as a bucket whose padding is exactly zero without a
full-bucket pass per leaf.

Sharding classes (FSDP/TP sub-buckets, shard-major packing) are not
ported yet: :func:`build_layout` raises on a non-replicated class.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.utils import tree_flatten, tree_leaves, tree_unflatten

LANE = 128
SUBLANE = 8


@dataclass(frozen=True)
class LeafSlot:
    """Static metadata for one leaf inside its bucket."""
    index: int                 # position in tree-flatten order
    bucket: int                # dtype bucket id
    seg: int                   # segment id within the bucket (leaf order)
    row_offset: int            # first row of this leaf
    rows: int                  # rows occupied (multiple of SUBLANE)
    size: int                  # true (unpadded) element count
    shape: tuple[int, ...]     # per-worker shape
    dtype: str                 # numpy dtype name
    skip_wd: bool = False      # True => weight decay is masked off


@dataclass(frozen=True)
class FlatLayout:
    """Static, hashable description of the bucketization of one tree."""
    treedef: Any
    slots: tuple[LeafSlot, ...]
    bucket_dtypes: tuple[str, ...]
    bucket_rows: tuple[int, ...]

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_dtypes)

    @property
    def num_leaves(self) -> int:
        return len(self.slots)

    def bucket_slots(self, b: int) -> list[LeafSlot]:
        return [s for s in self.slots if s.bucket == b]

    def bucket_local_rows(self, b: int) -> int:
        """Rows of one shard's region: every bucket of the port is of the
        replicated class, so all of ``bucket_rows[b]``."""
        return self.bucket_rows[b]

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


def build_layout(tree, *, wd_mask=None, leading: int = 0,
                 shard_classes=None) -> FlatLayout:
    """Build the static bucket layout for ``tree``.

    Leaves may be tensors, numpy arrays or anything with ``.shape`` and
    ``.dtype`` (``models.base.abstract``).  ``leading`` strips that many
    leading dims before recording the per-worker shape; ``wd_mask`` is a
    congruent tree of skip-weight-decay bits.
    """
    if shard_classes is not None:
        for c in tree_leaves(shard_classes):
            if c is not None and getattr(c, "axes", ()) != ():
                raise NotImplementedError(
                    "sharded sub-buckets are not ported yet: the port's "
                    "flat bus holds the replicated class only")
    leaves, treedef = tree_flatten(tree)
    n = len(leaves)
    wd = tree_leaves(wd_mask) if wd_mask is not None else [False] * n
    assert len(wd) == n, (n, len(wd))
    dtypes: list[str] = []
    rows_used: list[int] = []
    slots: list[LeafSlot] = []
    for i, leaf in enumerate(leaves):
        shape = tuple(int(d) for d in leaf.shape[leading:])
        dt = dtype_name(leaf.dtype)
        if dt not in dtypes:
            dtypes.append(dt)
            rows_used.append(0)
        b = dtypes.index(dt)
        size = int(np.prod(shape)) if shape else 1
        rows = _leaf_rows(size)
        seg = sum(1 for s in slots if s.bucket == b)
        slots.append(LeafSlot(index=i, bucket=b, seg=seg,
                              row_offset=rows_used[b], rows=rows, size=size,
                              shape=shape, dtype=dt, skip_wd=bool(wd[i])))
        rows_used[b] += rows
    return FlatLayout(treedef=treedef, slots=tuple(slots),
                      bucket_dtypes=tuple(dtypes),
                      bucket_rows=tuple(rows_used))


def flatten(layout: FlatLayout, tree, *, leading: int = 0,
            bucket_dtypes: Sequence[str] | None = None) -> list[torch.Tensor]:
    """Pack ``tree`` (tensors) into one ``(*lead, rows, 128)`` buffer per
    bucket; padding is zero."""
    leaves = tree_leaves(tree)
    assert len(leaves) == layout.num_leaves, (len(leaves), layout.num_leaves)
    buckets = []
    for b in range(layout.num_buckets):
        dt = torch_dtype((bucket_dtypes or layout.bucket_dtypes)[b])
        slots = layout.bucket_slots(b)
        x0 = leaves[slots[0].index]
        lead = tuple(x0.shape[:leading])
        buf = torch.zeros(lead + (layout.bucket_rows[b] * LANE,), dtype=dt,
                          device=x0.device)
        for s in slots:
            off = s.row_offset * LANE
            buf[..., off:off + s.size] = leaves[s.index].reshape(lead + (-1,))
        buckets.append(buf.view(lead + (layout.bucket_rows[b], LANE)))
    return buckets


def unflatten(layout: FlatLayout, buckets: Sequence[torch.Tensor], *,
              leading: int = 0):
    """Inverse of :func:`flatten`: a tree of VIEWS into the buckets, with
    the per-leaf padding dropped."""
    assert len(buckets) == layout.num_buckets
    vals: list = [None] * layout.num_leaves
    for b, buf in enumerate(buckets):
        lead = tuple(buf.shape[:leading])
        flat = buf.reshape(lead + (-1,))
        for s in layout.bucket_slots(b):
            off = s.row_offset * LANE
            vals[s.index] = flat[..., off:off + s.size].reshape(lead + s.shape)
    return tree_unflatten(layout.treedef, vals)


class _LeafViews(torch.autograd.Function):
    """The leaves of one single-copy bucket as views (forward).  Backward
    copies each leaf's gradient into its slice of ``out``, a bucket whose
    padding the caller zeroed, and returns ``out`` itself: the gradient
    lands once, where plain slicing would build one zero-filled bucket per
    leaf (``slice_backward``) and add them up."""

    @staticmethod
    def forward(ctx, buf, slots, out):
        ctx.slots, ctx.out = slots, out
        ctx.set_materialize_grads(False)
        flat = buf.view(-1)
        return tuple(flat[s.row_offset * LANE:s.row_offset * LANE + s.size]
                     .view(s.shape) for s in slots)

    @staticmethod
    def backward(ctx, *grads):
        # drop the node's reference to the grad bucket: on the card the
        # node outlives the step, and held one stacked grad bucket (W x
        # 478 MB at paper-lm's width) from one step into the next
        out, ctx.out = ctx.out, None
        flat = out.view(-1)
        for s, g in zip(ctx.slots, grads):
            dst = flat[s.row_offset * LANE:s.row_offset * LANE + s.size]
            if g is None:
                dst.zero_()
            else:
                dst.copy_(g.reshape(-1))
        return out, None, None


def unflatten_grad_into(layout: FlatLayout, buckets: Sequence[torch.Tensor],
                        grads: Sequence[torch.Tensor]):
    """:func:`unflatten` of single-copy ``buckets`` (which require grad)
    whose gradient lands in ``grads``: differentiating through the views
    writes each leaf's gradient into its rows of ``grads[b]`` in one pass
    and yields ``grads[b]`` as the bucket's gradient.  The caller zeroes
    ``grads`` (same shape as ``buckets``) once; its padding stays zero."""
    assert len(buckets) == len(grads) == layout.num_buckets
    vals: list = [None] * layout.num_leaves
    for b, (buf, out) in enumerate(zip(buckets, grads)):
        assert buf.shape == out.shape, (buf.shape, out.shape)
        slots = tuple(layout.bucket_slots(b))
        for s, v in zip(slots, _LeafViews.apply(buf, slots, out)):
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
# Per-bucket constants (numpy; tensor forms cached per device)
# ---------------------------------------------------------------------------

def wd_rows(layout: FlatLayout, b: int) -> np.ndarray:
    """(rows, 1) f32 mask: 1.0 on rows whose leaf takes weight decay."""
    m = np.zeros((layout.bucket_rows[b], 1), np.float32)
    for s in layout.bucket_slots(b):
        if not s.skip_wd:
            m[s.row_offset:s.row_offset + s.rows] = 1.0
    return m


def row_segments(layout: FlatLayout, b: int) -> np.ndarray:
    """(rows,) int32: bucket-local leaf segment id per row."""
    seg = np.zeros((layout.bucket_rows[b],), np.int32)
    for s in layout.bucket_slots(b):
        seg[s.row_offset:s.row_offset + s.rows] = s.seg
    return seg


def segment_sizes(layout: FlatLayout, b: int) -> np.ndarray:
    """(num_segments,) f32: true element count per leaf (no padding)."""
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
    """(rows, 128) f32 mask: 1.0 on true elements, 0.0 on padding."""
    m = np.zeros((layout.bucket_rows[b], LANE), np.float32)
    flat = m.reshape(-1)
    for s in layout.bucket_slots(b):
        off = s.row_offset * LANE
        flat[off:off + s.size] = 1.0
    return m


def lane_counts(layout: FlatLayout, b: int) -> np.ndarray:
    """(rows, 1) int32: number of valid lanes per row."""
    c = np.zeros((layout.bucket_rows[b], 1), np.int32)
    for s in layout.bucket_slots(b):
        c[s.row_offset:s.row_offset + s.rows, 0] = np.clip(
            s.size - np.arange(s.rows) * LANE, 0, LANE)
    return c


@functools.lru_cache(maxsize=64)
def _const(fn_name: str, layout: FlatLayout, b: int, device: str):
    arr = globals()[fn_name](layout, b)
    return torch.from_numpy(arr).to(device)


def const(fn_name: str, layout: FlatLayout, b: int, device) -> torch.Tensor:
    """Tensor form of one of the per-bucket numpy constants above
    (``"wd_rows"``, ``"row_segments"``, ...), built once per device."""
    return _const(fn_name, layout, b, str(torch.device(device)))


def mask_padding(layout: FlatLayout, b: int, x: torch.Tensor) -> torch.Tensor:
    """Zero the padding slots of a ``(*lead, rows, 128)`` buffer."""
    cnt = const("lane_counts", layout, b, x.device)
    lane = torch.arange(LANE, device=x.device, dtype=torch.int32)[None, :]
    return x * (lane < cnt).to(x.dtype)
