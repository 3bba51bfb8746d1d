"""Multi-process ``torch.distributed`` backend: the worker axis across
ranks, and optionally each worker across a shard group of ranks (the
port of ``repro.backend.distributed``).

With ``within_worker_size=1`` (the default) each of the P ranks holds
``W / P`` consecutive workers as the leading rows of its own buckets, on
its own device (``cuda:LOCAL_RANK % device_count``, or the CPU when the
caller asks for it): the layout of the reference's default
``train_layout(("data",), worker_axes=("data",))``, where no worker is
split within itself.  With ``within_worker_size=S`` the ranks form
``P / S`` worker groups of S shard ranks (rank = group * S + shard,
``sharding.layout.WorkerLayout``), and ``layout`` (a ``MeshLayout``,
default ``train_layout(("data", "model"), worker_axes=("data",))``: tensor
parallel over ``"model"``; ``fsdp_within_worker_layout`` for FSDP)
classifies the leaves into sharded and replicated sub-buckets: each rank
holds its shard's rows of the sharded ones.  :meth:`DistributedBackend.build`
returns a bundle from ``launch.steps.build_train(run, worker_set=...,
dist=..., layout=...)`` whose steps and syncs run collectives over the
process group (``backend.collectives.Collectives``).

Launch one process per rank, e.g.::

    python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --backend distributed ...

``use_kernel=False`` (the reference's default) builds the per-leaf tree
path on every rank, and ``resident=False`` its tree-in/tree-out kernel
form: each rank holds its workers' rows of the stacked trees.  It refuses
up front: the tree path with ``within_worker_size`` > 1 (whole workers
only), a single process (as the reference does), W not a
multiple of the worker groups and NCCL with more ranks on a host than it
has cards (before ``init_process_group``: :func:`check_nccl_ranks`).  It
never builds a one-process bundle under this backend's name.

The worker set changes as on the other backends: :meth:`demote` /
:meth:`promote` edit the census (a demoted worker keeps its rows and
syncs on the outer scope: the plan's blocks, which may span ranks), and
:meth:`resize` takes a new census for W' and builds again on the same
process group and device.  W' must be a multiple of the worker groups
(``WorkerLayout.resized``; ``ValueError`` before anything changes), so
that ``core.elastic.resize_state`` folds each rank's own rows.  The
Collectives of every build share one cache of sub-groups; a resize's
carries the run's byte counts on.  Every rank must take every decision
alike: the workers run in lockstep, so :meth:`worker_step_times` reads
nothing (the base class's None), and a controller sees only numbers
that every rank holds.
"""
from __future__ import annotations

import os

from repro_torch.backend.base import Backend


def check_nccl_ranks(backend: str, ranks_on_host: int, cards: int) -> None:
    """Raise ``ValueError`` when NCCL would put two ranks on one card: NCCL
    takes one rank a GPU (use ``gloo`` to run several ranks on one)."""
    if backend == "nccl" and ranks_on_host > cards:
        raise ValueError(
            f"NCCL needs one card a rank: {ranks_on_host} ranks on a host "
            f"with {cards} card(s); launch at most {cards} ranks per host, "
            f"or use the gloo backend (several ranks may share a card)")


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


class DistributedBackend(Backend):
    kind = "distributed"

    def __init__(self, num_workers: int | None = None, *,
                 coordinator_address: str | None = None,
                 process_id: int | None = None,
                 num_processes: int | None = None, backend: str = "nccl",
                 device=None, local_rank: int | None = None,
                 within_worker_size: int = 1, layout=None,
                 timeout_s: float | None = None, use_kernel: bool = True,
                 resident: bool | None = None):
        """Explicit arguments win over torchrun's environment (``RANK``,
        ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``).
        ``device=None`` means ``cuda:LOCAL_RANK % device_count`` (and
        raises without CUDA); ``"cpu"`` runs the plain versions there.
        ``timeout_s`` bounds every collective's wait (torch's default when
        None).  ``within_worker_size`` S > 1 splits every worker over S
        ranks by ``layout`` (a ``sharding.layout.MeshLayout``; sizes it
        lacks are filled in at build: its worker axis gets P / S, its
        other axis S).  ``use_kernel`` and ``resident`` go to
        ``build_train`` on every build (a resize's too): ``use_kernel=False``
        is the reference's tree path, ``resident=False`` its kernel form;
        with ``within_worker_size`` > 1 either raises ``ValueError`` here,
        before any collective."""
        tree = not use_kernel or resident is False
        if tree and int(within_worker_size) > 1:
            raise ValueError(
                f"DistributedBackend(use_kernel={use_kernel}, resident="
                f"{resident}, within_worker_size={within_worker_size}): the "
                "tree path across ranks holds whole workers; a worker split "
                "over shard ranks runs the resident path only")
        super().__init__(num_workers)
        self.use_kernel = use_kernel
        self.resident = resident
        if coordinator_address is None and os.environ.get("MASTER_ADDR"):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', '29500')}")
        self.coordinator_address = coordinator_address
        self.process_id = (process_id if process_id is not None
                           else _env_int("RANK"))
        self.num_processes = (num_processes if num_processes is not None
                              else _env_int("WORLD_SIZE"))
        self.local_rank = (local_rank if local_rank is not None
                           else _env_int("LOCAL_RANK"))
        self.backend = backend
        self.device = device
        self.within_worker_size = int(within_worker_size)
        self.layout = layout
        self.timeout_s = timeout_s
        self.collectives = None
        self._groups: dict = {}     # sub-groups by rank tuple, for every build

    def ensure_initialized(self):
        """Bring up the default process group once (a no-op when the
        launcher already did)."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return
        if not self.coordinator_address:
            raise RuntimeError(
                "DistributedBackend needs a coordinator: pass "
                "coordinator_address='host:port' (or set MASTER_ADDR / "
                "MASTER_PORT), with process_id and num_processes, and launch "
                "one process per card, e.g.\n"
                "  python -m torch.distributed.run --nproc-per-node 4 -m "
                "repro_torch.launch.train --backend distributed ...\n"
                "For single-process runs use --backend local or "
                "--backend simulated.")
        if self.process_id is None or self.num_processes is None:
            raise RuntimeError(
                "DistributedBackend: a multi-process launch needs "
                "process_id= and num_processes= (or RANK / WORLD_SIZE) with "
                "the coordinator")
        if self.backend == "nccl":
            import torch
            on_host = _env_int("LOCAL_WORLD_SIZE") or int(self.num_processes)
            check_nccl_ranks("nccl", on_host, torch.cuda.device_count())
        kw = {}
        if self.timeout_s is not None:
            import datetime
            kw["timeout"] = datetime.timedelta(seconds=float(self.timeout_s))
        dist.init_process_group(
            self.backend, init_method=f"tcp://{self.coordinator_address}",
            world_size=int(self.num_processes), rank=int(self.process_id), **kw)

    def rank_device(self):
        """This rank's device: the caller's, else ``cuda:LOCAL_RANK %
        device_count`` (raising without CUDA)."""
        import torch
        from repro_torch.utils import resolve_device
        if self.device is not None:
            return resolve_device(self.device)
        resolve_device(None)
        local = self.local_rank if self.local_rank is not None else (
            self.process_id or 0)
        return torch.device("cuda", local % torch.cuda.device_count())

    def mesh_layout(self, num_ranks: int):
        """The ``MeshLayout`` of a within-worker grid of ``num_ranks`` ranks
        (None without one): the caller's, else tensor parallel over
        ``"model"``, its missing axis sizes filled in (one worker axis:
        P / S worker groups; one other axis: S shards)."""
        from repro_torch.sharding.layout import train_layout
        S = self.within_worker_size
        lay = self.layout
        if lay is None:
            if S == 1:
                return None
            lay = train_layout(("data", "model"), worker_axes=("data",))
        if not lay.sizes:
            within = [a for a in lay.mesh_axes if a not in lay.worker_axes]
            if len(lay.worker_axes) != 1 or len(within) != 1:
                raise ValueError(
                    f"layout axes {lay.mesh_axes}: give their sizes "
                    f"(layout.with_sizes) when there is not one worker axis "
                    f"and one within-worker axis")
            lay = lay.with_sizes({lay.worker_axes[0]: num_ranks // S,
                                  within[0]: S})
        if lay.within_worker_size() != S:
            raise ValueError(f"the layout splits a worker "
                             f"{lay.within_worker_size()} ways, "
                             f"within_worker_size={S}")
        return lay

    def build(self, run, **kw):
        from repro_torch.sharding.layout import WorkerLayout
        self.ensure_initialized()
        import torch.distributed as dist
        if dist.get_world_size() <= 1:
            raise RuntimeError(
                "DistributedBackend requires a multi-process launch "
                f"(world_size={dist.get_world_size()}); use LocalBackend / "
                "SimulatedBackend for single-process runs.")
        from repro_torch.backend.collectives import Collectives
        from repro_torch.launch import steps as steps_mod
        ws = self._census()
        P = dist.get_world_size()
        grid = WorkerLayout(ws.num_workers, P, dist.get_rank(),
                            within_worker_size=self.within_worker_size)
        # one Collectives a bundle, over the sub-groups made so far
        self.collectives = Collectives(grid, groups=self._groups)
        kw.setdefault("device", self.rank_device())
        kw.setdefault("layout", self.mesh_layout(P))
        kw.setdefault("use_kernel", self.use_kernel)
        kw.setdefault("resident", self.resident)
        bundle = steps_mod.build_train(run, worker_set=ws,
                                       dist=self.collectives, **kw)
        self._worker_set = bundle.worker_set
        return bundle

    def check_resize(self, new_w: int) -> None:
        """Raise ``ValueError`` unless the ranks can take ``new_w`` workers
        without moving rows (``WorkerLayout.resized``: W' % G == 0)."""
        if self.collectives is not None:
            self.collectives.layout.resized(new_w)

    def resize(self, run, new_w: int, **kw):
        """A new census for ``new_w`` workers, then :meth:`build` on the same
        process group and device (the state surgery is the caller's:
        ``core.elastic.resize_state(state, new_w, num_groups=G)``)."""
        self.check_resize(new_w)
        totals = self.collectives.totals if self.collectives else {}
        bundle = super().resize(run, new_w, **kw)
        # the run's byte counts carry on across the resize
        self.collectives.totals = totals
        return bundle

    def describe(self) -> dict:
        out = super().describe()
        if self.collectives is not None:
            out.update(rank=self.collectives.rank,
                       ranks=self.collectives.size,
                       local_workers=list(self.collectives.layout.worker_ids))
            if self.within_worker_size > 1:
                out.update(within_worker_size=self.within_worker_size,
                           shard=self.collectives.layout.shard)
        return out
