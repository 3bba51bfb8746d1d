"""Elastic worker-axis resize: carry a ``LocalSGDState`` through a W change
(the port of ``repro.core.elastic``).

The worker axis is the leading dim of every stacked buffer of a resident
:class:`~repro_torch.core.local_sgd.LocalSGDState`: params, momentum and
EF memory are ``(W, rows, 128)`` bucket buffers with ``leading=1``.  A
resize maps that axis to a new width without building the tree view:

* **shrink** (W -> W', W % W' == 0): fold groups of ``W // W'``
  consecutive workers.  ``fold="mean"`` averages the group (the
  reduction of the sync's ``group_mean``), so the departing workers'
  momentum and EF memory fold into the survivors instead of being
  dropped.  ``fold="slice"`` keeps the first W' workers bit for bit (the
  checkpoint restore, where the surviving state must round-trip exactly).
* **grow** (W -> W', W' % W == 0): ``repeat_interleave`` each worker
  ``W' // W`` times.  The clones start from the same state and diverge
  through their data shards, as a fresh run from the synced model would.

A tree path's state (``local_sgd`` with ``use_kernel=False``) folds the
same way leaf by leaf: params, momentum and EF memory are stacked
``(W, ...)`` trees.

The same fold serves sharded sub-bucket buffers (FSDP / TP classes in
one process): a bucket's shard regions are rows of one worker's buffer,
so folding the worker axis folds every leaf, region by region, as the
tree view would (``tests/test_torch_sharded.py``).  Single-copy state
(anchor, global_u, step, the generator) has no worker
axis and passes through untouched.  The telemetry accumulator carries
its ``(W,)`` fields through the same fold, so ``round_summary``'s
``num_workers`` follows the live worker set.

Across ranks (``backend.DistributedBackend``) each rank folds its own
``(W_local, rows, 128)`` rows -- its shard region of a sharded
sub-bucket -- from W / G to W' / G workers (``num_groups`` = G, the
worker groups): with W' a multiple of G
(``sharding.layout.WorkerLayout.resized``) every fold group and every
clone run lies inside one rank's rows, so the rank's new rows are the
one-process ``resize_state``'s rows of its new workers, and no row moves
between ranks.  The padding of a shard region stays zero: a mean of
zeros and a clone of zeros.

A tree state across ranks folds the same way: each rank's ``(W_local,
...)`` leaves from W / G to W' / G workers, on a within-worker grid its
shard's slices of the sharded leaves (a fold and a clone act on every
element alone, so a slice folds as the whole leaf's slice does).

The LR co-scaling on a resize (Lau et al. 2024) lives in ``fit``, not
here: this module is state surgery only.
"""
from __future__ import annotations

import torch

from repro_torch.core import flatbuf
from repro_torch.telemetry import stats as tstats
from repro_torch.utils import tree_map


def resize_axis(x: torch.Tensor, new_w: int, *,
                fold: str = "mean") -> torch.Tensor:
    """Resize the leading (worker) axis of ``x`` to ``new_w``.

    Shrink needs ``W % new_w == 0`` (consecutive groups, ``group_mean``'s
    convention), grow ``new_w % W == 0`` (uniform clones).  The dtype is
    kept: the mean fold sums in at least float32 and rounds back through
    the input dtype, as the reference's ``jnp.mean`` does.
    """
    w = int(x.shape[0])
    if new_w == w:
        return x
    if fold not in ("mean", "slice"):
        raise ValueError(f"unknown fold {fold!r} (want 'mean' or 'slice')")
    if new_w < w:
        if w % new_w:
            raise ValueError(
                f"cannot shrink worker axis {w} -> {new_w}: not divisible")
        if fold == "slice":
            return x[:new_w]
        g = w // new_w
        acc = torch.promote_types(x.dtype, torch.float32)
        return (x.reshape((new_w, g) + tuple(x.shape[1:]))
                .to(acc).mean(dim=1).to(x.dtype))
    if new_w % w:
        raise ValueError(
            f"cannot grow worker axis {w} -> {new_w}: not divisible")
    return torch.repeat_interleave(x, new_w // w, dim=0)


def _resize_stacked(tree, new_w: int, *, fold: str):
    """:func:`resize_axis` over a stacked field: the buffers of a
    ``BucketState`` with ``leading=1`` (its layout describes one worker's
    rows, so it carries over unchanged), or every leaf of a tree path's
    stacked ``(W, ...)`` tree; a ``leading=0`` state or None passes
    through."""
    if tree is None:
        return None
    if flatbuf.is_bucket_state(tree):
        if tree.leading != 1:
            return tree
        return tree.with_buckets(
            [resize_axis(b, new_w, fold=fold) for b in tree.buckets])
    return tree_map(lambda x: resize_axis(x, new_w, fold=fold), tree)


def resize_stats(stats, new_w: int, *, fold: str = "mean"):
    """Carry a StatsAccumulator through a resize: the (W,) fields fold like
    the state; the scalars (round counters, the sync pair, the
    compression-error slots) persist."""
    if stats is None:
        return None
    r = lambda x: resize_axis(x, new_w, fold=fold)
    return tstats.StatsAccumulator(
        acc_grad_sq=r(stats.acc_grad_sq),
        acc_update_sq=r(stats.acc_update_sq),
        acc_steps=stats.acc_steps,
        round_grad_sq=r(stats.round_grad_sq),
        round_update_sq=r(stats.round_update_sq),
        round_steps=stats.round_steps,
        pre_sync_sq=stats.pre_sync_sq, post_sync_sq=stats.post_sync_sq,
        comp_err_sq=stats.comp_err_sq, comp_ref_sq=stats.comp_ref_sq,
        rounds=stats.rounds)


def resize_state(state, new_w: int, *, fold: str = "mean",
                 num_groups: int = 1):
    """``state`` with its worker axis resized to ``new_w``, staying
    resident.  ``fold`` sets the shrink semantics; grow always clones.
    ``num_groups`` (G > 1 across ranks) says the state holds one worker
    group's W / G rows: they become its W' / G rows (``new_w % G`` must
    be 0).
    anchor / global_u / step / rng are single-copy and unchanged, which
    keeps an anchored resize consistent: the anchor still is the last
    synced model, and the next sync's model difference is taken against
    it per surviving or cloned worker."""
    from repro_torch.core.local_sgd import LocalSGDState
    if new_w % num_groups:
        raise ValueError(f"cannot resize to {new_w} workers over {num_groups}"
                         f" worker groups: W' % G must be 0")
    new_w //= num_groups
    return LocalSGDState(
        params=_resize_stacked(state.params, new_w, fold=fold),
        momentum=_resize_stacked(state.momentum, new_w, fold=fold),
        anchor=state.anchor,
        global_u=state.global_u,
        ef_memory=_resize_stacked(state.ef_memory, new_w, fold=fold),
        step=state.step,
        rng=state.rng,
        stats=resize_stats(state.stats, new_w, fold=fold))
