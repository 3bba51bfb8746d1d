"""The data-parallel layout: W workers in P rank slices (the port of the
worker axis of ``repro.sharding.layout``).

The reference places its workers with a mesh and a :class:`MeshLayout`
whose ``worker_axes`` shard the stacked ``(W, ...)`` state; its
``DistributedBackend`` uses ``train_layout(("data",),
worker_axes=("data",))``, where the workers lie along the process axis
and no worker is split within itself.  The port has no mesh: a
:class:`WorkerLayout` says which workers a rank holds.  Rank r holds the
``w_local = W / P`` consecutive workers ``r * w_local ... (r + 1) *
w_local - 1`` as the leading rows of its ``(w_local, rows, 128)``
buckets, so the worker order across ranks is the one-process order.

Within-worker layouts (FSDP / tensor-parallel sub-buckets, the
reference's ``fsdp_within_worker_layout`` and ``within_worker_size > 1``)
are not ported: they raise ``NotImplementedError`` naming ROADMAP A.5.
"""
from __future__ import annotations

from dataclasses import dataclass

WITHIN_WORKER_NOT_PORTED = (
    "within-worker layouts (FSDP / tensor-parallel sub-buckets, "
    "flatbuf.shard_classes, row_segments_local) are not ported yet: they "
    "come with a later slice of ROADMAP A.5; the port splits the worker "
    "axis across processes only")


@dataclass(frozen=True)
class WorkerLayout:
    """``num_workers`` workers over ``num_ranks`` processes, seen from
    ``rank``; every worker lives whole on one rank."""
    num_workers: int
    num_ranks: int
    rank: int

    def __post_init__(self):
        W, P, r = self.num_workers, self.num_ranks, self.rank
        if P < 1 or W < 1:
            raise ValueError(f"need W >= 1 workers and P >= 1 ranks, got "
                             f"W={W}, P={P}")
        if W % P:
            raise ValueError(
                f"{W} workers do not split evenly over {P} ranks: each rank "
                f"holds W / P whole workers, so W % P must be 0")
        if not 0 <= r < P:
            raise ValueError(f"rank {r} outside 0..{P - 1}")

    @property
    def w_local(self) -> int:
        return self.num_workers // self.num_ranks

    @property
    def worker_lo(self) -> int:
        """The first worker id (row of the global worker axis) of this rank."""
        return self.rank * self.w_local

    @property
    def worker_ids(self) -> tuple[int, ...]:
        return tuple(range(self.worker_lo, self.worker_lo + self.w_local))

    def rank_of(self, worker: int) -> int:
        if not 0 <= worker < self.num_workers:
            raise ValueError(f"worker {worker} outside 0..{self.num_workers - 1}")
        return worker // self.w_local

    def block_ranks(self, group: int) -> tuple[tuple[int, ...], ...]:
        """The ranks that hold each block of ``group`` consecutive workers
        (Alg. 5's inner mean), in block order.  A block lies inside one
        rank when ``group`` divides ``w_local``, and covers whole ranks
        when ``w_local`` divides ``group``; any other block straddles a
        rank boundary unevenly and raises."""
        W, wl = self.num_workers, self.w_local
        if group < 1 or W % group:
            raise ValueError(f"block size {group} does not divide W={W}")
        if wl % group and group % wl:
            raise ValueError(
                f"a block of {group} workers straddles a rank boundary "
                f"unevenly (each rank holds {wl}): choose a block size that "
                f"divides {wl} or is a multiple of it")
        return tuple(tuple(sorted({self.rank_of(w)
                                   for w in range(s, s + group)}))
                     for s in range(0, W, group))

    def block_is_local(self, group: int) -> bool:
        """True when every block of ``group`` workers lies inside one rank."""
        return all(len(rs) == 1 for rs in self.block_ranks(group))


def train_layout(num_workers: int, num_ranks: int, rank: int, *,
                 fsdp_axes: tuple[str, ...] = ()) -> WorkerLayout:
    """The training layout of the reference's distributed backend (workers
    along the process axis, none split within itself).  ``fsdp_axes``
    (within-worker FSDP) raises: not ported."""
    if fsdp_axes:
        raise NotImplementedError(WITHIN_WORKER_NOT_PORTED)
    return WorkerLayout(num_workers, num_ranks, rank)


def fsdp_within_worker_layout(*args, **kw):
    """The reference's ZeRO-3-style within-worker layout: not ported."""
    raise NotImplementedError(WITHIN_WORKER_NOT_PORTED)


def check_within_worker_size(size: int) -> None:
    """Refuse a layout that splits a worker over ``size`` > 1 processes."""
    if int(size) != 1:
        raise NotImplementedError(WITHIN_WORKER_NOT_PORTED)
