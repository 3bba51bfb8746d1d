"""Paged KV cache on the flat-bus bucket convention (the port of
``repro.serving.paged``).

* One decoding token's KV across ALL layers is flattened by
  :func:`repro_torch.core.flatbuf.build_layout` into ``rows_per_token``
  rows of 128 lanes (paper-lm: 2 x 12 layers x 12 heads x 64 float32 =
  73,728 bytes, 144 rows), with the reference's leaf order and padding.
* A **page** is ``page_size`` consecutive token positions of one
  sequence: a ``(page_size, rows_per_token_b, 128)`` slab of bucket
  ``b``'s pool ``(num_pages, page_size, rows, 128)``.
* A **page table** is a ``(pages_per_seq,)`` int32 row of pool page ids;
  page 0 is the reserved **null page**, kept all-zero, so gathering an
  unallocated entry yields exact zeros.

:func:`gather` materializes the contiguous cache view from the pool (one
index per bucket + the flatbuf unflatten + a transpose per leaf back to
the model's layout), so ``lm.decode_step`` runs unmodified on paged
storage and paged decode equals contiguous decode bit for bit.  The view
is rebuilt on every decode step (an in-kernel page gather is not
written: the reference's design, ported as it is).
:func:`scatter_token` writes the decoded token's rows back and
:func:`scatter_prefill` an admitted prompt's KV.

The reference's ``mode="drop"`` scatters become writes whose dropped rows
are redirected to the null page with zero values: the null page stays
zero, no other page is touched, and no host sync is needed to build a
mask.  Callers keep the reference's invariant that a page sits in at
most one table (the null page aside) and that no live row maps a
position to the null page.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import flatbuf
from repro_torch.core.flatbuf import LANE, FlatLayout
from repro_torch.models.base import ShapeDtype
from repro_torch.utils import tree_flatten, tree_leaves, tree_unflatten

NULL_PAGE = 0       # reserved all-zero page: unallocated table entries


@dataclass(frozen=True)
class PageLayout:
    """Static description of one model's paged KV cache.

    ``token_layout`` is a :class:`~repro_torch.core.flatbuf.FlatLayout`
    over the per-token cache slices (each cache leaf without its batch
    and kv_seq axes); ``leaf_axes`` keeps each cache leaf's logical axes
    (flatten order) for the transposes between the model's cache layout
    and the (batch, position)-leading page view.
    """
    token_layout: FlatLayout
    leaf_axes: tuple
    page_size: int              # token positions per page
    num_pages: int              # pool pages per bucket (incl. null page 0)
    pages_per_seq: int          # table length: ceil(max_len / page_size)

    @property
    def max_tokens(self) -> int:
        """Gathered contiguous view length (>= the engine's max_len)."""
        return self.page_size * self.pages_per_seq

    @property
    def rows_per_token(self) -> tuple[int, ...]:
        return self.token_layout.bucket_rows

    def pool_bytes(self) -> int:
        return sum(self.num_pages * self.page_size * r * LANE
                   * torch.empty((), dtype=flatbuf.torch_dtype(d)).element_size()
                   for r, d in zip(self.token_layout.bucket_rows,
                                   self.token_layout.bucket_dtypes))


def _is_axes(x):
    return (isinstance(x, tuple) and len(x) > 0
            and all(isinstance(e, (str, type(None))) for e in x))


def build_page_layout(cfg, *, page_size: int, max_len: int, num_pages: int,
                      dtype=torch.float32) -> PageLayout:
    """Derive the page layout from the model's cache structure (every
    cache leaf carries a ``batch`` and a ``kv_seq`` axis; a recurrent
    model's fixed-size states have none, and raise: they serve from the
    contiguous path, ``launch.steps.build_serve``).  A cross-attention
    decoder's ``xk`` / ``xv`` take their per-token slices like ``k`` /
    ``v``: the reference's ``enc_len`` sizes only their length, which a
    per-token layout drops."""
    from repro_torch.models import lm

    flat_axes = tree_leaves(lm.cache_axes_tree(cfg), is_leaf=_is_axes)
    shapes, treedef = tree_flatten(
        lm.init_cache(cfg, 1, 1, dtype=dtype, device="meta"))
    assert len(flat_axes) == len(shapes)
    per_token = []
    for ax, sd in zip(flat_axes, shapes):
        if "batch" not in ax or "kv_seq" not in ax:
            raise ValueError(
                f"paged KV cache needs (batch, kv_seq) axes on every cache "
                f"leaf; got {ax} for shape {tuple(sd.shape)} — recurrent "
                f"caches (mamba2/xLSTM) serve from the contiguous path "
                f"(launch.steps.build_serve)")
        keep = [i for i, a in enumerate(ax) if a not in ("batch", "kv_seq")]
        per_token.append(ShapeDtype(tuple(sd.shape[i] for i in keep), dtype))
    token_layout = flatbuf.build_layout(tree_unflatten(treedef, per_token))
    pages_per_seq = -(-int(max_len) // int(page_size))
    return PageLayout(token_layout=token_layout, leaf_axes=tuple(flat_axes),
                      page_size=int(page_size), num_pages=int(num_pages),
                      pages_per_seq=pages_per_seq)


def init_pool(pl: PageLayout, device=None) -> list:
    """Zero page pools, one per dtype bucket, on ``device`` (page 0 is
    the null page and stays zero)."""
    return [t.zero_() for t in flatbuf.abstract_buckets(
        pl.token_layout, lead=(pl.num_pages, pl.page_size),
        device=device if device is not None else "cpu")]


# ---------------------------------------------------------------------------
# Model-layout <-> (batch, position)-leading transposes
# ---------------------------------------------------------------------------

def _to_bs(leaf, ax):
    """Model cache leaf -> (B, S, *per_token dims in original order)."""
    return torch.movedim(leaf, (ax.index("batch"), ax.index("kv_seq")), (0, 1))


def _from_bs(leaf, ax):
    """Inverse of :func:`_to_bs`."""
    return torch.movedim(leaf, (0, 1), (ax.index("batch"), ax.index("kv_seq")))


# ---------------------------------------------------------------------------
# Gather / scatter
# ---------------------------------------------------------------------------

def gather(pl: PageLayout, pools, tables):
    """The contiguous cache view of each sequence's pages.

    ``tables``: (B, pages_per_seq) int page ids.  Returns the model's
    cache tree with kv_seq length ``pl.max_tokens``; unallocated entries
    read the null page (exact zeros), and positions past a sequence's
    ``cache_len`` are masked by decode attention.
    """
    B, P = tables.shape
    idx = tables.long()
    views = [pool[idx].reshape(B, P * pl.page_size, -1, LANE)
             for pool in pools]                # (B, P*page, rows, LANE)
    leaves = tree_leaves(flatbuf.unflatten(pl.token_layout, views, leading=2))
    out = [_from_bs(leaf, ax) for leaf, ax in zip(leaves, pl.leaf_axes)]
    return tree_unflatten(pl.token_layout.treedef, out)


def _write(pools, bufs, page, off, keep):
    """``pool[page, off] = buf`` per bucket; rows with ``keep`` False write
    zeros into the null page instead (the reference's dropped writes)."""
    page = torch.where(keep, page, torch.zeros_like(page)).long()
    off = off.long()
    for pool, buf in zip(pools, bufs):
        m = keep.reshape(keep.shape + (1,) * (buf.dim() - keep.dim()))
        pool.index_put_((page, off),
                        torch.where(m, buf.to(pool.dtype),
                                    torch.zeros((), dtype=pool.dtype,
                                                device=pool.device)))
    return pools


def scatter_token(pl: PageLayout, pools, cache, positions, tables,
                  active=None):
    """Write each sequence's token at ``positions`` from a contiguous
    cache view back into its page, in place.

    ``positions``: (B,) token positions (``cache_len - 1``); ``active``:
    optional (B,) bool — inactive rows write nothing into their pages.
    """
    tok = []
    for leaf, ax in zip(tree_leaves(cache), pl.leaf_axes):
        bs = _to_bs(leaf, ax)                  # (B, S, *per_tok)
        tok.append(bs[torch.arange(bs.shape[0], device=bs.device),
                      positions.long()])
    bufs = flatbuf.flatten(pl.token_layout,
                           tree_unflatten(pl.token_layout.treedef, tok),
                           leading=1)          # [(B, rows_b, LANE)]
    pos = positions.long()
    page = torch.gather(tables.long(), 1, (pos // pl.page_size)[:, None])[:, 0]
    keep = (active if active is not None
            else torch.ones_like(page, dtype=torch.bool))
    return _write(pools, bufs, page, pos % pl.page_size, keep)


def scatter_prefill(pl: PageLayout, pools, cache, tables, lengths):
    """Bulk-write admitted sequences' prefilled KV into their pages, in
    place.

    ``cache``: the model cache of a batch-B prefill (kv_seq length S <=
    ``pl.max_tokens``, each row right-padded past its length);
    ``tables``: (B, pages_per_seq) (one (pages_per_seq,) row is promoted
    to B=1); ``lengths``: (B,) — row b's positions ``>= lengths[b]`` write
    nothing, so a length-0 row (an idle slot, or a resident mid-decode)
    leaves its pages untouched.
    """
    tables = torch.as_tensor(tables)
    if tables.dim() == 1:
        tables = tables[None]
    B = tables.shape[0]
    dev = pools[0].device
    tables = tables.to(dev).long()
    lengths = torch.as_tensor(lengths, device=dev).reshape(-1).long()
    bs_leaves = [_to_bs(leaf, ax)[:B]
                 for leaf, ax in zip(tree_leaves(cache), pl.leaf_axes)]
    S = bs_leaves[0].shape[1]
    bufs = flatbuf.flatten(pl.token_layout,
                           tree_unflatten(pl.token_layout.treedef, bs_leaves),
                           leading=2)          # [(B, S, rows_b, LANE)]
    t = torch.arange(S, device=dev)
    page = tables[:, t // pl.page_size]        # (B, S)
    off = (t % pl.page_size)[None].expand(B, S)
    return _write(pools, bufs, page, off, t[None, :] < lengths[:, None])


def paged_decode_step(cfg, params, tokens, pools, tables, cache_lens,
                      pl: PageLayout):
    """Page-table-aware decode step: gather -> ``lm.decode_step`` ->
    write-back.

    ``cache_lens``: (B,) INCLUDING the new token (0 marks an idle slot: its
    logits are garbage and it writes nothing).  Returns ``(logits,
    pools)``, the pools updated in place.
    """
    from repro_torch.models import lm

    cache = gather(pl, pools, tables)
    logits, cache = lm.decode_step(cfg, params, tokens, cache, cache_lens)
    positions = (cache_lens - 1).clamp_min(0)
    pools = scatter_token(pl, pools, cache, positions, tables,
                          active=cache_lens > 0)
    return logits, pools
