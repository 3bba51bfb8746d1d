"""Collectives across ranks: a thin layer over one ``torch.distributed``
process group (what GSPMD lowers the reference's mean over a sharded
worker axis, and its within-worker gathers, to).

:class:`Collectives` holds the rank's :class:`~repro_torch.sharding.layout.WorkerLayout`
and offers what the distributed local SGD needs.  Over the rank's
*worker group* (the G ranks that hold its shard index of every worker;
the whole world when no worker is split):

* :meth:`Collectives.ordered_mean`: the mean over every worker of the
  worker group (or of an Alg. 5 block's sub-group) that adds the workers
  in worker order, as one process does: a chained reduce, pipelined over
  chunks, whose results come back along the chain (the ring all-reduce's
  traffic in all, at any number of workers a rank);
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

Every call counts the bytes this rank hands to the collective -- its
input, the one definition for every op (the ordered mean's input is the
f32 running total the rank hands on: one bucket, as for the all-reduce
it replaced) -- by op and scope (``totals``), and by sync stage
(:meth:`Collectives.take_stage_bytes`, which the comms ledger reads as
its measured bytes).  All ranks hand equal-shaped tensors to each sync
collective, so the bytes handed by all ranks together are P times this
rank's.  What the ordered mean's point-to-point sends carry is counted
apart (``sent``).  Shard-group traffic is never counted under a sync
stage: the local step's bucket gathers and gradient reductions under the
scope ``"within"``, the small cross-shard sums of partials under
``"shard_sums"``.

The ``gloo`` backend of the torch the card runs (2.11) takes all-reduce,
all-gather, all-to-all, reduce-scatter and broadcast on CUDA tensors, on
sub-groups too (probes on the card ran each of them; gloo copies the
tensors through host memory itself).  The ordered mean's chain hands its
``send`` / ``recv`` pinned host buffers of its own (the adds stay on the
card, one chunk at a time); nothing else is staged here.
"""
from __future__ import annotations

import math

import torch


# the ordered mean's chunk (elements): its pipeline's unit over the chain
OM_CHUNK = 1 << 20
# how many chunks a rank sends out before it passes a result back on
OM_LAG = 8


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
        self.sent: dict = {}            # "op/scope" -> bytes sent point to point
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
    def _count(self, op: str, x: torch.Tensor, scope: str, stage,
               nbytes: int | None = None):
        if nbytes is None:
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
    def ordered_mean(self, x: torch.Tensor, *, scope: str, stage=None,
                     group=None, n: int | None = None) -> torch.Tensor:
        """The mean over ``n`` workers (default: every worker of the worker
        group) of this rank's ``(W_local, *shape)`` rows ``x`` and the
        other members' -> ``shape``, in x's dtype, on every member.
        ``group`` is a sub-group from :meth:`block_groups` (an Alg. 5
        block that spans ranks).

        A chained reduce, pipelined over chunks of ``OM_CHUNK`` elements:
        the Q members in rank order hold workers in worker order, so
        member 0 adds its rows' chunk in f32 from zero and sends the
        running total on; member j adds its rows onto what it receives
        and sends it on; the last member scales and casts the chunk and
        sends it back along the chain (last -> 0 -> 1 -> ... -> Q - 2).
        Each element is the sum one process's ``x.mean(dim=0)`` makes
        (workers in index order from zero, in f32) scaled as it scales:
        divided by the count on the CPU, times ``f32(out) / f32(in)``
        elements on the card (``at::mean``'s two forms).  On the card
        that mean adds in index order only up to four workers (more are
        split over its accumulators: ``tests/test_torch_cuda.py``), so
        the equality holds for W <= 4 there and for every W on the CPU.

        Bytes handed: one f32 bucket a rank, the running total it hands
        on (``totals``, the ledger's measured bytes), as the all-reduce
        of a rank's presummed rows handed.  Traffic (``sent``): Q - 1
        f32 partials and Q - 1 results over the chain, the ring
        all-reduce's 2 (Q - 1) buckets in all at any W_local (member 0
        and the middle ones send two buckets, the last two one).  Extra
        memory: the result (one bucket) on the device; the chunks cross
        ``send`` / ``recv`` in pinned host buffers (a bucket each way)."""
        import torch.distributed as dist
        pg = self.worker_group if group is None else group
        members = dist.get_process_group_ranks(
            dist.group.WORLD if pg is None else pg)
        Q, wl = len(members), x.shape[0]
        j = members.index(dist.get_rank())
        n = n or wl * Q
        shape = tuple(x.shape[1:])
        N = math.prod(shape)
        rows = x.reshape(wl, N)
        dev = x.device
        cuda = dev.type == "cuda"
        if cuda:
            # at::mean on the card: the sum times f32(out) / f32(in), the
            # one process's mean over this bucket's (W, ...) stack
            W = self.layout.num_workers
            fac = float(torch.tensor(float(N * (W // n)), dtype=torch.float32)
                        / torch.tensor(float(N * W), dtype=torch.float32))
        self._count("ordered_mean", x, scope, stage, nbytes=N * 4)
        out = torch.empty((N,), dtype=x.dtype, device=dev)
        last = j == Q - 1
        nxt = None if last else members[j + 1]
        # the results' way back: last -> 0 -> 1 -> ... -> Q - 2
        fprev = None if last else members[j - 1] if j else members[-1]
        fnext = ((members[0] if Q > 1 else None) if last
                 else members[j + 1] if j < Q - 2 else None)
        chunks = [slice(a, min(a + OM_CHUNK, N)) for a in range(0, N, OM_CHUNK)]
        host = dict(pin_memory=True) if cuda else {}
        part = (torch.empty((N,), dtype=torch.float32, **host)
                if Q > 1 else None)
        fin = torch.empty((N,), dtype=x.dtype, **host) if Q > 1 else None
        # every receive is posted up front, so no send waits on a receiver
        precv = ([dist.irecv(part[sl], members[j - 1], group=pg, tag=1)
                  for sl in chunks] if j else [])
        frecv = ([dist.irecv(fin[sl], fprev, group=pg, tag=2)
                  for sl in chunks] if fprev is not None else [])
        sends, sent = [], 0

        def send(buf, dst, tag):
            nonlocal sent
            if cuda:                        # the copy into buf has landed
                torch.cuda.current_stream(dev).synchronize()
            sends.append(dist.isend(buf, dst, group=pg, tag=tag))
            sent += buf.numel() * buf.element_size()

        def take(k):
            """Result chunk k is back: pass it on, keep it."""
            frecv[k].wait()
            if fnext is not None:
                send(fin[chunks[k]], fnext, 2)
            out[chunks[k]].copy_(fin[chunks[k]], non_blocking=True)

        for k, sl in enumerate(chunks):
            if j:
                precv[k].wait()
                acc = part[sl].to(dev, non_blocking=True)
            else:
                acc = torch.zeros((sl.stop - sl.start,), dtype=torch.float32,
                                  device=dev)
            for w in range(wl):             # this rank's workers, in order
                acc = acc + rows[w, sl].float()
            if last:
                res = (acc.mul_(fac) if cuda else acc.div_(n)).to(x.dtype)
                out[sl].copy_(res)
                if fnext is not None:
                    fin[sl].copy_(res, non_blocking=True)
                    send(fin[sl], fnext, 2)
                continue
            part[sl].copy_(acc, non_blocking=True)
            send(part[sl], nxt, 1)
            if k >= OM_LAG:
                # the result of a chunk OM_LAG back is on its way: passing
                # it on here keeps the way back pipelined with the way out
                take(k - OM_LAG)
        for k in range(max(len(frecv) - OM_LAG, 0), len(frecv)):
            take(k)
        for s in sends:
            s.wait()
        if cuda:
            # the host buffers outlive the copies out of them
            torch.cuda.current_stream(dev).synchronize()
        key = f"ordered_mean/{scope}"
        self.sent[key] = self.sent.get(key, 0) + sent
        return out.view(shape)

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
        n_seg = index.offsets.numel() - 1
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
                "totals": {k: dict(v) for k, v in sorted(self.totals.items())},
                "sent": dict(sorted(self.sent.items()))}
