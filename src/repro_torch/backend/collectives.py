"""Collectives across ranks: a thin layer over one ``torch.distributed``
process group (what GSPMD lowers the reference's mean over a sharded
worker axis to).

:class:`Collectives` holds the rank's :class:`~repro_torch.sharding.layout.WorkerLayout`
and offers what the distributed local SGD needs:

* :meth:`Collectives.all_reduce_sum` (in place), over the whole group or
  over an Alg. 5 block's sub-group;
* :meth:`Collectives.all_gather` of equal-shaped tensors into one
  ``(P, *shape)`` tensor, in rank order (:meth:`Collectives.gather_workers`
  reshapes it to the W workers);
* :meth:`Collectives.ordered_segment_sum`: a scatter-add whose additions
  run rank after rank in worker order (P broadcasts), for the
  compressor's shared per-leaf scales;
* :meth:`Collectives.block_groups`: the sub-groups of the blocks that span
  ranks, made once per block size with ``dist.new_group`` in block order
  on every rank (``new_group`` must be called by every rank, members or
  not, in the same order).

Every call counts the bytes this rank hands to the collective, by op and
scope (``totals``), and by sync stage (:meth:`Collectives.take_stage_bytes`,
which the comms ledger reads as its measured bytes).  All ranks hand
equal-shaped tensors to each call, so the bytes handed by all ranks
together are P times this rank's.

The ``gloo`` backend of the torch the card runs (2.11) takes all-reduce,
all-gather and broadcast on CUDA tensors (a probe on the card ran each
of them; gloo copies the tensors through host memory itself), so
nothing is staged here: a backend that refused a CUDA tensor would
raise, never fall back to the CPU.
"""
from __future__ import annotations

import torch


class Collectives:
    """Collectives of one rank over ``group`` (default: the world)."""

    def __init__(self, layout, *, group=None):
        import torch.distributed as dist
        self.layout = layout
        self.group = group
        self.backend = dist.get_backend(group)
        size = dist.get_world_size(group)
        if size != layout.num_ranks or dist.get_rank(group) != layout.rank:
            raise ValueError(
                f"process group (rank {dist.get_rank(group)} of {size}) "
                f"disagrees with the worker layout (rank {layout.rank} of "
                f"{layout.num_ranks})")
        self.totals: dict = {}          # "op/scope" -> {"calls", "bytes"}
        self._stage_bytes: dict = {}    # (scope, stage) -> bytes, until taken
        self._blocks: dict = {}         # block size -> sub-group per block

    @property
    def rank(self) -> int:
        return self.layout.rank

    @property
    def size(self) -> int:
        return self.layout.num_ranks

    # -- accounting -------------------------------------------------------
    def _count(self, op: str, x: torch.Tensor, scope: str, stage):
        nbytes = x.numel() * x.element_size()
        t = self.totals.setdefault(f"{op}/{scope}", {"calls": 0, "bytes": 0})
        t["calls"] += 1
        t["bytes"] += nbytes
        if stage is not None:
            key = (scope, int(stage))
            self._stage_bytes[key] = self._stage_bytes.get(key, 0) + nbytes

    def take_stage_bytes(self, scope: str, num_stages: int) -> list:
        """Bytes all ranks handed to each of the last ``scope`` sync's
        ``num_stages`` collective stages (P x this rank's), and forget
        them."""
        return [float(self.size * self._stage_bytes.pop((scope, i), 0))
                for i in range(num_stages)]

    # -- collectives ------------------------------------------------------
    def all_reduce_sum(self, x: torch.Tensor, *, scope: str, stage=None,
                       group=None) -> torch.Tensor:
        """Sum ``x`` (contiguous) over the group's ranks, in place; returns
        ``x``.  ``group`` is a sub-group from :meth:`block_groups`."""
        import torch.distributed as dist
        self._count("all_reduce", x, scope, stage)
        dist.all_reduce(x, group=self.group if group is None else group)
        return x

    def all_gather(self, x: torch.Tensor, *, scope: str, stage=None):
        """Every rank's ``x`` (equal shapes) stacked in rank order:
        ``(P, *x.shape)``."""
        import torch.distributed as dist
        x = x.contiguous()
        self._count("all_gather", x, scope, stage)
        out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather(list(out.unbind(0)), x, group=self.group)
        return out

    def broadcast(self, x: torch.Tensor, src: int, *, scope: str,
                  stage=None) -> torch.Tensor:
        """Rank ``src``'s ``x`` (contiguous) into every rank's ``x``, in
        place; returns ``x``.  Every rank counts the bytes it hands over
        (the receivers' copies included), as for the other ops."""
        import torch.distributed as dist
        self._count("broadcast", x, scope, stage)
        dist.broadcast(x, src, group=self.group)
        return x

    def ordered_segment_sum(self, vals: torch.Tensor, seg_ids: torch.Tensor,
                            num_segments: int, *, scope: str) -> torch.Tensor:
        """``kernels.ops.segment_sum`` over every rank's ``vals`` in rank
        order, as if concatenated: rank r scatter-adds its values onto
        rank r - 1's running totals and broadcasts the result, so on the
        CPU (where the adds run in index order) every rank ends with the
        one-process totals bit for bit.  P broadcasts of
        ``num_segments`` floats, one after another."""
        acc = torch.zeros((num_segments,), dtype=vals.dtype,
                          device=vals.device)
        for r in range(self.size):
            if r == self.rank:
                acc.index_add_(0, seg_ids.long(), vals)
            self.broadcast(acc, r, scope=scope)
        return acc

    def gather_workers(self, x: torch.Tensor, *, scope: str, stage=None):
        """This rank's ``(W_local, ...)`` rows -> all W workers' ``(W, ...)``,
        in worker order."""
        g = self.all_gather(x, scope=scope, stage=stage)
        return g.reshape((self.layout.num_workers,) + tuple(x.shape[1:]))

    def block_groups(self, group: int) -> dict:
        """The sub-group of every block of ``group`` workers that spans
        ranks, keyed by the block's rank tuple; made on first use, on every
        rank in block order (a block inside one rank needs none)."""
        import torch.distributed as dist
        if group not in self._blocks:
            made = {}
            for ranks in self.layout.block_ranks(group):
                if len(ranks) > 1 and ranks not in made:
                    made[ranks] = dist.new_group(list(ranks))
            self._blocks[group] = made
        return self._blocks[group]

    def describe(self) -> dict:
        return {"backend": self.backend, "rank": self.rank,
                "ranks": self.size,
                "workers": list(self.layout.worker_ids),
                "totals": {k: dict(v) for k, v in sorted(self.totals.items())}}
