"""Multi-process ``torch.distributed`` backend (structural).

One process per card, each holding its workers' rows; the WorkerSet
census and the resize / demote bookkeeping are the local backend's (and
tested), while execution needs a real multi-process launch: on a single
process :meth:`DistributedBackend.build` raises with launch guidance,
and a multi-process build raises ``NotImplementedError`` until the
across-GPU half of ROADMAP A.5 lands (NCCL process groups, the sharded
layout, the wire pack's payload all-gathers across processes).  It
never builds a local bundle under this backend's name.
"""
from __future__ import annotations

import os

from repro_torch.backend.base import Backend

ACROSS_GPUS_NOT_PORTED = (
    "DistributedBackend.build across processes is not ported yet: it needs "
    "the across-GPU half of ROADMAP A.5 (NCCL process groups, "
    "sharding/layout, flatbuf.shard_classes, the wire pack's payload "
    "all-gathers across processes and measured NCCL bytes)")


class DistributedBackend(Backend):
    kind = "distributed"

    def __init__(self, num_workers: int | None = None, *,
                 coordinator_address: str | None = None,
                 process_id: int | None = None,
                 num_processes: int | None = None, backend: str = "nccl"):
        super().__init__(num_workers)
        if coordinator_address is None and os.environ.get("MASTER_ADDR"):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', '29500')}")
        self.coordinator_address = coordinator_address
        self.process_id = process_id
        self.num_processes = num_processes
        self.backend = backend

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
                "  MASTER_ADDR=localhost MASTER_PORT=29500 torchrun "
                "--nproc-per-node 4 -m repro_torch.launch.train --backend "
                "distributed ...\n"
                "For single-process runs use --backend local or "
                "--backend simulated.")
        if self.process_id is None or self.num_processes is None:
            raise RuntimeError(
                "DistributedBackend: a multi-process launch needs "
                "process_id= and num_processes= with the coordinator")
        dist.init_process_group(
            self.backend, init_method=f"tcp://{self.coordinator_address}",
            world_size=int(self.num_processes), rank=int(self.process_id))

    def build(self, run, **kw):
        self.ensure_initialized()
        import torch.distributed as dist
        if dist.get_world_size() <= 1:
            raise RuntimeError(
                "DistributedBackend requires a multi-process launch "
                f"(world_size={dist.get_world_size()}); use LocalBackend / "
                "SimulatedBackend for single-process runs.")
        raise NotImplementedError(ACROSS_GPUS_NOT_PORTED)
