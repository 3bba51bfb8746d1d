"""Collectives across ranks: a thin layer over one ``torch.distributed``
process group (what GSPMD lowers the reference's mean over a sharded
worker axis, and its within-worker gathers, to).

:class:`Collectives` holds the rank's :class:`~repro_torch.sharding.layout.WorkerLayout`
and offers what the distributed local SGD needs.  Over the rank's
*worker group* (the G ranks that hold its shard index of every worker;
the whole world when no worker is split):

* :meth:`Collectives.all_reduce_sum` (in place), over the worker group or
  over an Alg. 5 block's sub-group;
* :meth:`Collectives.all_gather` of equal-shaped tensors into one
  ``(G, *shape)`` tensor, in rank order (:meth:`Collectives.gather_workers`
  reshapes it to the W workers);
* :meth:`Collectives.ordered_segment_sum`: a segmented sum whose adds
  run rank after rank in worker order (G broadcasts), for the
  compressor's shared per-leaf scales of a replicated bucket;
* :meth:`Collectives.block_groups`: the sub-groups of the blocks that span
  ranks.

Over the whole process group: :meth:`Collectives.gather_ranks` (every
rank's rows onto one rank, for a checkpoint of the whole state).

Over the rank's *shard group* (the S ranks of its worker, S > 1 only):
:meth:`Collectives.gather_shards` (a sharded bucket's regions into its
whole rows), :meth:`Collectives.reduce_scatter_shards` (FSDP's gradient
sum into each rank's region), :meth:`Collectives.shard_total` (partial
sums added in shard order).  Sub-groups are made once, in the same
order on every rank (``new_group`` must be called by every rank, members
or not), and kept by their rank tuple in a cache that outlives a resize:
the Collectives of the new W finds its shard and worker groups there,
and makes only the Alg. 5 block groups that the new blocks need.

Every call counts the bytes this rank hands to the collective, by op and
scope (``totals``), and by sync stage (:meth:`Collectives.take_stage_bytes`,
which the comms ledger reads as its measured bytes).  All ranks hand
equal-shaped tensors to each sync collective, so the bytes handed by all
ranks together are P times this rank's.  Shard-group traffic is never
counted under a sync stage: the local step's bucket gathers and gradient
reductions under the scope ``"within"``, the small cross-shard sums of
partials under ``"shard_sums"``.

The ``gloo`` backend of the torch the card runs (2.11) takes all-reduce,
all-gather, reduce-scatter and broadcast on CUDA tensors, on sub-groups
too (a probe on the card ran each of them; gloo copies the tensors
through host memory itself), so nothing is staged here: a backend that
refused a CUDA tensor would raise, never fall back to the CPU.
"""
from __future__ import annotations

import torch


class Collectives:
    """Collectives of one rank over ``group`` (default: the world)."""

    def __init__(self, layout, *, group=None, groups: dict | None = None):
        """``groups`` caches sub-groups by their rank tuple across the
        Collectives of one process group (a resize builds a new one for
        the new W; every rank asks for the same sub-groups in the same
        order, so every rank finds them in its cache or makes them
        together)."""
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
        self._groups = groups if groups is not None else {}
        self._blocks: dict = {}         # block size -> sub-group per block
        self.worker_group = group       # the world when no worker is split
        self.shard_group = None
        if layout.within_worker_size > 1:
            # every rank makes (or finds) every sub-group, in this order
            for g in range(layout.num_groups):
                pg = self._sub_group(layout.shard_group_ranks(g))
                if g == layout.group:
                    self.shard_group = pg
            for s in range(layout.within_worker_size):
                pg = self._sub_group(layout.worker_group_ranks(s))
                if s == layout.shard:
                    self.worker_group = pg

    def _sub_group(self, ranks: tuple):
        """The process sub-group of ``ranks``, made on first use (by every
        rank: ``new_group`` is collective over the world)."""
        import torch.distributed as dist
        ranks = tuple(ranks)
        if ranks not in self._groups:
            self._groups[ranks] = dist.new_group(list(ranks))
        return self._groups[ranks]

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

    # -- over the worker group --------------------------------------------
    def all_reduce_sum(self, x: torch.Tensor, *, scope: str, stage=None,
                       group=None) -> torch.Tensor:
        """Sum ``x`` (contiguous) over the worker group's ranks, in place;
        returns ``x``.  ``group`` is a sub-group from :meth:`block_groups`."""
        import torch.distributed as dist
        self._count("all_reduce", x, scope, stage)
        dist.all_reduce(x, group=self.worker_group if group is None else group)
        return x

    def all_gather(self, x: torch.Tensor, *, scope: str, stage=None,
                   group=None, n: int | None = None):
        """Every rank's ``x`` (equal shapes) stacked in rank order:
        ``(G, *x.shape)`` over the worker group, or ``(n, ...)`` over
        ``group``."""
        import torch.distributed as dist
        x = x.contiguous()
        self._count("all_gather", x, scope, stage)
        n = self.layout.num_groups if group is None else n
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather(list(out.unbind(0)), x,
                        group=self.worker_group if group is None else group)
        return out

    def broadcast(self, x: torch.Tensor, src: int, *, scope: str,
                  stage=None) -> torch.Tensor:
        """Rank ``src``'s ``x`` (contiguous) into every worker-group rank's
        ``x``, in place; returns ``x``.  Every rank counts the bytes it
        hands over (the receivers' copies included), as for the other
        ops."""
        import torch.distributed as dist
        self._count("broadcast", x, scope, stage)
        dist.broadcast(x, src, group=self.worker_group)
        return x

    def ordered_segment_sum(self, vals: torch.Tensor, index, *,
                            scope: str) -> torch.Tensor:
        """``kernels.ops.segment_totals`` over every worker-group rank's
        ``vals`` (W_local, rows) in rank order, chained as if the ranks'
        rows were one stack: rank r adds its rows onto the previous ranks'
        running totals (``chain=True, init=``) and broadcasts the result,
        so every rank ends with the one-process totals bit for bit, on the
        CPU and on the card (whose segmented sum adds in the same fixed
        order).  ``index`` is the rows' ``flatbuf.segment_index``.  G
        broadcasts of ``num_segments`` floats, one after another: the
        chain of adds runs through every rank in turn."""
        from repro_torch.kernels import ops as kops
        n_seg = index[2].numel() - 1
        acc = torch.zeros((n_seg,), dtype=torch.float32, device=vals.device)
        for r in self.layout.worker_group_ranks():
            if r == self.rank:
                acc = kops.segment_totals(vals, index, chain=True, init=acc)
            self.broadcast(acc, r, scope=scope)
        return acc

    def gather_ranks(self, x: torch.Tensor, *, scope: str):
        """Every rank's ``x`` (equal shapes), stacked in rank order over the
        whole process group: ``(P, *x.shape)`` on rank 0, None on the others
        (the checkpoint's gather of a state, one bucket at a time)."""
        import torch.distributed as dist
        x = x.contiguous()
        self._count("gather", x, scope, None)
        out = None
        if self.rank == 0:
            out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device)
        dist.gather(x, None if out is None else list(out.unbind(0)), dst=0,
                    group=self.group)
        return out

    def gather_workers(self, x: torch.Tensor, *, scope: str, stage=None):
        """This rank's ``(W_local, ...)`` rows -> all W workers' ``(W, ...)``,
        in worker order (over the worker group: the same shard index)."""
        g = self.all_gather(x, scope=scope, stage=stage)
        return g.reshape((self.layout.num_workers,) + tuple(x.shape[1:]))

    def block_groups(self, group: int) -> dict:
        """The sub-group of every block of ``group`` workers that spans
        worker groups, keyed by the block's rank tuple (one per shard
        index); made on first use, on every rank in block order (a block
        inside one worker group needs none)."""
        import torch.distributed as dist
        if group not in self._blocks:
            made = {}
            for s in range(self.layout.within_worker_size):
                for ranks in self.layout.block_ranks(group, s):
                    if len(ranks) > 1 and ranks not in made:
                        made[ranks] = self._sub_group(ranks)
            self._blocks[group] = made
        return self._blocks[group]

    # -- over the shard group (within a worker) ---------------------------
    def gather_shards(self, x: torch.Tensor, *, scope: str = "within"):
        """The S shard ranks' ``x`` stacked in shard order: ``(S, *x.shape)``."""
        return self.all_gather(x, scope=scope, group=self.shard_group,
                               n=self.layout.within_worker_size)

    def reduce_scatter_shards(self, x: torch.Tensor, *,
                              scope: str = "within") -> torch.Tensor:
        """``x`` ``(S * n, ...)`` summed over the shard group, rank s keeping
        rows ``[s * n, (s + 1) * n)``: ``(n, ...)``."""
        import torch.distributed as dist
        x = x.contiguous()
        S = self.layout.within_worker_size
        self._count("reduce_scatter", x, scope, None)
        out = torch.empty((x.shape[0] // S,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=self.shard_group)
        return out

    def all_reduce_shards(self, x: torch.Tensor, *,
                          scope: str = "within") -> torch.Tensor:
        """Sum ``x`` (contiguous) over the shard group, in place."""
        import torch.distributed as dist
        self._count("all_reduce", x, scope, None)
        dist.all_reduce(x, group=self.shard_group)
        return x

    def shard_total(self, part: torch.Tensor, *,
                    scope: str = "shard_sums") -> torch.Tensor:
        """This shard's partial sums -> the worker's totals: the S partials
        gathered and added in shard order, as one process adds its
        ``S`` regions' partials (``core/local_sgd.shard_sum``)."""
        parts = self.gather_shards(part, scope=scope)
        acc = parts[0]
        for s in range(1, parts.shape[0]):
            acc = acc + parts[s]
        return acc

    def describe(self) -> dict:
        return {"backend": self.backend, "rank": self.rank,
                "ranks": self.size,
                "within_worker_size": self.layout.within_worker_size,
                "workers": list(self.layout.worker_ids),
                "totals": {k: dict(v) for k, v in sorted(self.totals.items())}}
