"""Layouts: logical tensor axes onto mesh axes, and ranks onto workers and
shards (the port of ``repro.sharding.layout``).

:class:`MeshLayout` is the reference's rule machinery: ``worker_axes``
enumerate the local-SGD workers, ``rules`` map logical axes (``"embed"``,
``"heads"``, ``"batch"``, ...) to the mesh axes that shard them within a
worker, and ``sizes`` give each mesh axis its size.  The port has no
mesh, so the sizes are given explicitly (:meth:`MeshLayout.with_sizes`,
the counterpart of ``with_mesh``).  ``flatbuf.shard_classes`` reads a
leaf's sharding class from :meth:`MeshLayout.dim_shards`.

:class:`WorkerLayout` places the ranks: W workers over P processes, in
``G = P / S`` worker groups of ``S`` shard ranks each (S is the
within-worker size, 1 when no worker is split).  Rank ``r = g * S + s``
holds the ``w_local = W / G`` consecutive workers of group g and, of
every sharded sub-bucket, shard s's region of their rows; replicated
sub-buckets it holds whole.  The S ranks of group g are its *shard
group*; the G ranks that hold shard s of every worker are shard s's
*worker group*.  With S = 1 this is the reference's
``train_layout(("data",), worker_axes=("data",))`` placement, worker
order across ranks being the one-process order.

``serve_layout``, ``long_context_serve_layout``, ``choose_worker_axes``
and ``param_bytes_per_chip`` are not on the training path and are not
ported (ROADMAP A.8).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

AxisVal = None | str | tuple[str, ...]


def _names(v: AxisVal) -> tuple[str, ...]:
    return () if v is None else ((v,) if isinstance(v, str) else tuple(v))


@dataclass(frozen=True)
class MeshLayout:
    mesh_axes: tuple[str, ...]
    worker_axes: tuple[str, ...]
    rules: dict = field(default_factory=dict)
    # mesh axis sizes; with them, rules that do not divide a concrete dim
    # are dropped (kv_heads=1 cannot shard over a 2-way model axis)
    sizes: dict = field(default_factory=dict)

    def rule(self, name: str) -> AxisVal:
        return self.rules.get(name)

    def axis_size(self, v: AxisVal) -> int:
        return math.prod(self.sizes.get(a, 1) for a in _names(v))

    def _effective(self, axes, dims, used: set) -> tuple[AxisVal, ...]:
        """The rules applied to logical ``axes`` as a PartitionSpec would
        be built: shape-aware divisibility drop, then first-wins mesh-axis
        dedup (``used`` collects the axes consumed)."""
        out: list[AxisVal] = []
        for i, a in enumerate(axes):
            r = None if a is None else self.rule(a)
            if r is not None and dims is not None and self.sizes:
                if dims[i] % self.axis_size(r) != 0:
                    r = None
            if r is not None:
                names = _names(r)
                if any(nm in used for nm in names):
                    r = None
                else:
                    used.update(names)
            out.append(r)
        return tuple(out)

    def dim_shards(self, axes, dims=None) -> tuple[AxisVal, ...]:
        """Per-dim EFFECTIVE within-worker sharding of a leaf: the rule
        applied to each dim after the divisibility drop and the dedup."""
        return self._effective(axes, dims, set())

    def with_sizes(self, sizes: dict) -> "MeshLayout":
        """This layout with its mesh axis sizes (the reference's
        ``with_mesh`` without a mesh)."""
        return replace(self, sizes={a: int(n) for a, n in sizes.items()})

    def within_worker_size(self) -> int:
        """Ranks a worker spans: the product of the non-worker axes."""
        return math.prod(self.sizes.get(a, 1) for a in self.mesh_axes
                         if a not in self.worker_axes)

    def batch_split(self) -> int:
        """Ways the ``"batch"`` rule splits a worker's batch (FSDP: S;
        tensor parallel: 1)."""
        return self.axis_size(self.rule("batch"))

    def validate(self) -> None:
        """The reference's checks against the layout's own axes."""
        for a in self.worker_axes:
            if a not in self.mesh_axes:
                raise ValueError(f"worker axis {a!r} not in mesh {self.mesh_axes}")
        used: list[str] = []
        for v in self.rules.values():
            for a in _names(v):
                if a not in self.mesh_axes:
                    raise ValueError(f"rule axis {a!r} not in mesh {self.mesh_axes}")
                used.append(a)
        overlap = set(used) & set(self.worker_axes)
        if overlap:
            raise ValueError(
                f"mesh axes {sorted(overlap)} are both worker axes and "
                "within-worker rule axes; a worker's parameter copy cannot be "
                "sharded over the axis that distinguishes workers")


def train_layout(mesh_axes: tuple[str, ...], *, worker_axes: tuple[str, ...],
                 fsdp_axes: tuple[str, ...] = ()) -> MeshLayout:
    """Training layout: tensor parallel over ``"model"``; optional
    within-worker FSDP axes shard the embed dim and the per-worker batch.
    Worker axes appear in no rule."""
    tp = "model"
    return MeshLayout(
        mesh_axes=tuple(mesh_axes),
        worker_axes=tuple(worker_axes),
        rules={
            "batch": fsdp_axes or None,
            "embed": fsdp_axes or None,
            "heads": tp,
            "kv_heads": tp,
            "mlp": tp,
            "vocab": tp,
            "experts": tp,
            "expert_mlp": None,
            "ssm_inner": tp,
            "seq": None,
            "kv_seq": None,
        },
    )


def fsdp_within_worker_layout(mesh_axes: tuple[str, ...], *,
                              worker_axes: tuple[str, ...],
                              shard_axes: tuple[str, ...] = ("model",)
                              ) -> MeshLayout:
    """ZeRO-3-style within-worker layout: weights sharded on their embed /
    vocab dims over ``shard_axes`` and gathered on use, the per-worker
    batch sharded over the same axes."""
    fs = shard_axes if len(shard_axes) != 1 else shard_axes[0]
    return MeshLayout(
        mesh_axes=tuple(mesh_axes),
        worker_axes=tuple(worker_axes),
        rules={
            "batch": fs,
            "embed": fs,
            "vocab": fs,       # head stays output-sharded (dedup drops embed)
            "heads": None,
            "kv_heads": None,
            "mlp": None,
            "experts": fs,
            "expert_mlp": None,
            "ssm_inner": None,
            "seq": None,
            "kv_seq": None,
        },
    )


@dataclass(frozen=True)
class WorkerLayout:
    """``num_workers`` workers over ``num_ranks`` processes in worker groups
    of ``within_worker_size`` shard ranks, seen from ``rank`` (see the
    module docstring: rank = group * S + shard)."""
    num_workers: int
    num_ranks: int
    rank: int
    within_worker_size: int = 1

    def __post_init__(self):
        W, P, r, S = (self.num_workers, self.num_ranks, self.rank,
                      self.within_worker_size)
        if P < 1 or W < 1 or S < 1:
            raise ValueError(f"need W >= 1 workers, P >= 1 ranks and S >= 1 "
                             f"shards, got W={W}, P={P}, S={S}")
        if P % S:
            raise ValueError(
                f"{P} ranks do not split into worker groups of {S} shard "
                f"ranks: P % S must be 0")
        if W % (P // S):
            raise ValueError(
                f"{W} workers do not split evenly over {P // S} worker "
                f"groups: each group holds W / (P / S) whole workers, so "
                f"W % P must be 0" + (f" with P = {P // S} groups" if S > 1
                                      else ""))
        if not 0 <= r < P:
            raise ValueError(f"rank {r} outside 0..{P - 1}")

    @property
    def num_groups(self) -> int:
        """G: worker groups (ranks per shard index)."""
        return self.num_ranks // self.within_worker_size

    @property
    def group(self) -> int:
        return self.rank // self.within_worker_size

    @property
    def shard(self) -> int:
        return self.rank % self.within_worker_size

    @property
    def w_local(self) -> int:
        return self.num_workers // self.num_groups

    @property
    def worker_lo(self) -> int:
        """The first worker id (row of the global worker axis) of this rank."""
        return self.group * self.w_local

    @property
    def worker_ids(self) -> tuple[int, ...]:
        return tuple(range(self.worker_lo, self.worker_lo + self.w_local))

    def shard_group_ranks(self, group: int | None = None) -> tuple[int, ...]:
        """The S ranks of worker group ``group`` (default this rank's), in
        shard order."""
        g = self.group if group is None else group
        S = self.within_worker_size
        return tuple(range(g * S, (g + 1) * S))

    def worker_group_ranks(self, shard: int | None = None) -> tuple[int, ...]:
        """The G ranks that hold shard ``shard`` (default this rank's) of
        every worker, in worker order."""
        s = self.shard if shard is None else shard
        return tuple(g * self.within_worker_size + s
                     for g in range(self.num_groups))

    def group_of(self, worker: int) -> int:
        if not 0 <= worker < self.num_workers:
            raise ValueError(f"worker {worker} outside 0..{self.num_workers - 1}")
        return worker // self.w_local

    def rank_of(self, worker: int, shard: int | None = None) -> int:
        """The rank that holds shard ``shard`` (default this rank's) of
        ``worker``."""
        s = self.shard if shard is None else shard
        return self.group_of(worker) * self.within_worker_size + s

    def block_ranks(self, group: int, shard: int | None = None
                    ) -> tuple[tuple[int, ...], ...]:
        """The ranks that hold shard ``shard`` (default this rank's) of each
        block of ``group`` consecutive workers (Alg. 5's inner mean), in
        block order.  A block lies inside one worker group when ``group``
        divides ``w_local``, and covers whole groups when ``w_local``
        divides ``group``; any other block straddles a group boundary
        unevenly and raises."""
        W, wl = self.num_workers, self.w_local
        if group < 1 or W % group:
            raise ValueError(f"block size {group} does not divide W={W}")
        if wl % group and group % wl:
            raise ValueError(
                f"a block of {group} workers straddles a rank boundary "
                f"unevenly (each rank holds {wl}): choose a block size that "
                f"divides {wl} or is a multiple of it")
        return tuple(tuple(sorted({self.rank_of(w, shard)
                                   for w in range(s, s + group)}))
                     for s in range(0, W, group))

    def resized(self, new_w: int) -> "WorkerLayout":
        """The grid for ``new_w`` workers on the same ranks: a resize keeps
        the process group, so every rank keeps its worker group and shard.

        Across ranks a shrink or a grow moves no row only when W' is a
        multiple of the G worker groups: then each fold group of W / W'
        consecutive workers (a shrink) and each run of W' / W clones (a
        grow) lies inside one worker group's rows.  Any other W' raises
        ``ValueError`` here, before a caller changes any state.  The
        reference's mesh has no such rule: its worker axis is one array,
        resharded by XLA as a whole."""
        W, G, new_w = self.num_workers, self.num_groups, int(new_w)
        if new_w < 1 or new_w % G:
            raise ValueError(
                f"cannot resize {W} -> {new_w} workers across {G} worker "
                f"groups: W' % G must be 0 (W' a multiple of the worker "
                f"groups), so that every fold group and every clone run "
                f"lies inside one rank's rows")
        if (W % new_w) if new_w < W else (new_w % W):
            raise ValueError(
                f"cannot resize {W} -> {new_w} workers: a shrink needs W % W'"
                f" == 0, a grow W' % W == 0 (whole fold groups, whole clone "
                f"runs)")
        return replace(self, num_workers=new_w)

    def block_is_local(self, group: int) -> bool:
        """True when every block of ``group`` workers lies inside one
        worker group."""
        return all(len(rs) == 1 for rs in self.block_ranks(group))
