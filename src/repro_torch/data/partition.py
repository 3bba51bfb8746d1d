"""Disjoint data partitioning with a global per-epoch reshuffle (the
port's copy of ``repro.data.partition``).  Batches are dicts of
``(W, B_loc, ...)`` numpy arrays; the trainer moves them to the device."""
from __future__ import annotations

import numpy as np


def epoch_partition(n: int, num_workers: int, *, epoch: int, seed: int = 0):
    """Disjoint index shards for one epoch. Returns (W, n//W) int64."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    perm = rng.permutation(n)
    per = n // num_workers
    return perm[: per * num_workers].reshape(num_workers, per)


class ShardedBatches:
    """Iterate (W, B_loc, ...) batches over a dict of arrays; one pass is
    one epoch, reshuffled globally between epochs."""

    def __init__(self, data: dict, num_workers: int, local_batch: int,
                 *, seed: int = 0):
        self.data = data
        self.n = len(next(iter(data.values())))
        self.W = num_workers
        self.B = local_batch
        self.seed = seed
        self.epoch = 0
        self._reshard()

    def _reshard(self):
        self.shards = epoch_partition(self.n, self.W, epoch=self.epoch,
                                      seed=self.seed)
        self.cursor = 0
        self.per_worker = self.shards.shape[1]

    def __iter__(self):
        return self

    def __next__(self):
        if self.cursor + self.B > self.per_worker:
            self.epoch += 1
            self._reshard()
        idx = self.shards[:, self.cursor:self.cursor + self.B]   # (W, B)
        self.cursor += self.B
        return {k: v[idx] for k, v in self.data.items()}

    def resize(self, num_workers: int, *, local_batch: int | None = None):
        """Elastic re-partition to a new worker count (the backend seam):
        the CURRENT epoch's permutation is re-sharded among the live
        workers and the pass restarts, so every example is still drawn
        from a disjoint shard, now among W' workers.  ``local_batch``
        optionally co-scales B.  Across ranks every rank holds this
        global iterator and resizes it alike; each takes its new
        workers' rows of the (W', B, ...) batch, so the ranks together
        draw the one-process batch."""
        if num_workers <= 0:
            raise ValueError(f"num_workers must be positive, got {num_workers}")
        self.W = int(num_workers)
        if local_batch is not None:
            self.B = int(local_batch)
        self._reshard()
        return self
