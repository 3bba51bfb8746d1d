"""Step builders: paper-lm + resident local SGD as a ``TrainBundle``, and
the serving forms ``build_serve`` / ``build_engine`` (the port of
``repro.launch.steps``: no mesh; a training bundle's workers may be
split over processes, ``build_train(dist=)``, and its leaves sharded
within a worker by a ``sharding.layout.MeshLayout``, ``build_train(layout=)``).

``build_train`` builds the resident flat-bus path by default — the one
the reference selects with ``use_kernel=True`` — so every local step runs
the fused SGD or LARS kernels and every sign / EF-sign sync the
compressor kernels.  ``use_kernel=False`` builds the reference's default,
the per-leaf tree path (``core.local_sgd``'s tree branch, plain PyTorch),
in one process or across ranks, whole workers a rank or each worker split
over shard ranks.  **A kept difference:** the reference's default is
``use_kernel=False``; the port's stays True, so that no caller moves off
the kernels without asking.  The sync plan takes the config's topology
(``syncplan.resolve_topology``: hierarchical when ``block_steps > 1``).
Telemetry is on when ``run.controller.wants_telemetry``, and the
speculative compression error when ``run.controller.wants_speculation``
(the compression-escalating controllers).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.backend.base import WorkerSet
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import flatbuf
from repro_torch.core import syncplan as splan
from repro_torch.core.local_sgd import (make_local_sgd, needs_anchor,
                                        pack_axes_tree)
from repro_torch.models import base as mbase
from repro_torch.models import lm
from repro_torch.utils import resolve_device


@dataclass
class TrainBundle:
    cfg: ModelConfig
    run: RunConfig
    num_workers: int
    specs: Any
    init: Callable
    local_step: Callable
    sync: Callable
    device: torch.device
    layout: Any = None          # flatbuf.FlatLayout of the param buckets
    sync_plan: Any = None       # compiled syncplan.SyncPlan (fit's default)
    telemetry: bool = False     # state.stats carries a StatsAccumulator
    n_comp: int = 1             # compression-error slots: one per bucket
    worker_set: Any = None      # backend.base.WorkerSet this bundle was built for
    # across processes: the rank's backend.collectives.Collectives (its
    # .layout: rank, W_local, worker ids); None with every worker here
    dist: Any = None
    # sharding.layout.MeshLayout whose classes bucket the leaves, or None
    mesh_layout: Any = None
    # its flatbuf.shard_classes of the specs (None without a layout): a
    # tree state on a within-worker grid needs them to gather or restore
    shard_classes: Any = None

    @property
    def rank(self) -> int:
        return 0 if self.dist is None else self.dist.rank

    @property
    def w_local(self) -> int:
        """Workers whose state this process holds."""
        return len(self.worker_ids)

    @property
    def worker_ids(self) -> tuple:
        """The global worker ids (rows of the plan's worker axis) whose
        state this process holds."""
        if self.dist is None:
            return tuple(range(self.num_workers))
        return self.dist.layout.worker_ids


def build_train(run: RunConfig, *, num_workers: int | None = None,
                worker_set=None, device=None, dist=None,
                layout=None, use_kernel: bool = True,
                resident: bool | None = None) -> TrainBundle:
    """Resident-bucket local SGD for ``run.model`` with its workers stacked
    on one device: ``worker_set`` (a ``backend.WorkerSet``) names them,
    else ``num_workers`` (default 1) and the bundle gets
    ``WorkerSet.of(num_workers)``; the two must agree when both are
    given.  ``device=None`` means the card and raises when CUDA is
    absent; tests pass ``device="cpu"``.  ``dist`` (a
    ``backend.collectives.Collectives``) puts this process's ``W / P``
    workers here and the rest on the other ranks; the sync plan stays
    the global plan over all W.

    ``layout`` (a ``sharding.layout.MeshLayout`` with its axis sizes:
    ``train_layout`` for tensor parallel, ``fsdp_within_worker_layout``)
    classifies ``lm.param_specs(cfg)`` with ``flatbuf.shard_classes``,
    as the reference's build_train does on a mesh: the leaves ride
    (dtype, class) sub-buckets.  In one process they stay whole; with a
    ``dist`` of within-worker size S each rank holds its shard's rows,
    and the layout's ``"batch"`` rule says whether a worker's batch is
    split over its shard ranks (FSDP) or not (tensor parallel).  Without
    a layout every leaf is of the replicated class, bit for bit.

    ``use_kernel=False`` builds the tree path, and ``resident=False`` with
    the kernels on its tree-in/tree-out kernel form (the reference's
    ``make_local_sgd(use_kernel=True, resident=False)``); with a ``dist``
    each rank holds its workers' rows of the stacked trees, and on a
    within-worker grid (S > 1) its shard's slice of every sharded leaf
    (``flatbuf.LeafShards``).  With a ``layout`` the tree path's sharded
    leaves stay off the flat bus (``bucketable``), the wire pack packs
    each of them along its largest unsharded dim
    (``local_sgd.pack_axes_tree``), as the reference's tree path does on a
    mesh, and every sum over a sharded leaf (the clip norm, LARS's norms,
    the sign scales, telemetry) adds its slices' partials in shard order,
    in one process as on the ranks."""
    tree = not use_kernel or resident is False
    if worker_set is not None:
        if num_workers is not None and num_workers != worker_set.num_workers:
            raise ValueError(
                f"num_workers={num_workers} disagrees with "
                f"worker_set ({worker_set.num_workers} workers)")
        num_workers = worker_set.num_workers
    if num_workers is None:
        num_workers = 1
    if worker_set is None:
        worker_set = WorkerSet.of(num_workers)
    device = resolve_device(device)
    cfg = run.model
    specs = lm.param_specs(cfg)
    wd_mask = mbase.norm_param_mask(specs)
    shard_cls = None
    batch_split = 1
    S = 1 if dist is None else dist.layout.within_worker_size
    if layout is not None:
        if not layout.sizes:
            raise ValueError("the MeshLayout has no axis sizes: give them "
                             "with layout.with_sizes({axis: size, ...})")
        layout.validate()
        shard_cls = flatbuf.shard_classes(specs, layout)
        if S > 1:
            if layout.within_worker_size() != S:
                raise ValueError(
                    f"the layout splits a worker {layout.within_worker_size()}"
                    f" ways, the ranks {S} ways")
            batch_split = layout.batch_split()
    elif S > 1:
        raise ValueError(f"a within-worker grid of {S} shard ranks needs a "
                         f"MeshLayout that shards the leaves (layout=)")

    def loss(params, batch):
        return lm.loss_fn(cfg, params, batch, remat=run.remat)

    telemetry = run.controller.wants_telemetry
    tree_kw = {}
    if tree:
        tree_kw = dict(use_kernel=use_kernel, resident=False)
        if shard_cls is not None:
            tree_kw.update(bucketable=flatbuf.replicated_tree(shard_cls),
                           packed_mean_fn=(None, pack_axes_tree(specs, layout)))
    init, local_step, sync = make_local_sgd(
        run, loss, num_workers=num_workers, wd_mask=wd_mask,
        telemetry=telemetry,
        speculate_compression=run.controller.wants_speculation, dist=dist,
        shard_classes=shard_cls, batch_split=batch_split, **tree_kw)
    blayout = flatbuf.build_layout(
        mbase.abstract(specs, flatbuf.torch_dtype(cfg.param_dtype)),
        wd_mask=wd_mask, shard_classes=shard_cls)
    plan = splan.make_sync_plan(
        blayout, num_workers=num_workers,
        topology=splan.resolve_topology(run.local_sgd, num_workers),
        compression=run.local_sgd.sync_compression,
        anchored=needs_anchor(run.local_sgd),
        wire_pack=run.local_sgd.wire_pack,
        coalesce=run.local_sgd.sync_coalesce)
    return TrainBundle(cfg=cfg, run=run, num_workers=num_workers, specs=specs,
                       init=init, local_step=local_step, sync=sync,
                       device=device, layout=blayout, sync_plan=plan,
                       telemetry=telemetry,
                       n_comp=1 if tree else blayout.num_buckets,
                       worker_set=worker_set, dist=dist, mesh_layout=layout,
                       shard_classes=shard_cls)


@dataclass
class ServeBundle:
    cfg: ModelConfig
    specs: Any
    prefill: Callable           # (params, batch) -> (last logits, cache)
    decode_step: Callable       # (params, batch, cache, cache_len) -> (logits, cache)
    device: torch.device


def build_serve(cfg: ModelConfig, *, device=None) -> ServeBundle:
    """Contiguous-cache serving functions for ``cfg`` (``batch["tokens"]``,
    and a prefill's ``batch["prefix_embed"]`` or ``batch["frames"]``, in;
    ``lm.prefill`` / ``lm.decode_step`` out), on the card unless
    ``device`` says otherwise (the reference's ``shape`` sizes its
    shardings, which the single-device port has none of)."""
    device = resolve_device(device)

    def prefill_fn(params, batch):
        return lm.prefill(cfg, params, batch["tokens"],
                          prefix_embed=batch.get("prefix_embed"),
                          enc_frames=batch.get("frames"))

    def decode_fn(params, batch, cache, cache_len):
        return lm.decode_step(cfg, params, batch["tokens"], cache, cache_len)

    return ServeBundle(cfg=cfg, specs=lm.param_specs(cfg), prefill=prefill_fn,
                       decode_step=decode_fn, device=device)


def build_engine(cfg: ModelConfig, shape, params=None, *, page_size: int = 8,
                 num_pages: int | None = None, prefill_len: int | None = None,
                 eos_id: int | None = None, seed: int = 0, tracer=None,
                 metrics=None, device=None, on_logits=None):
    """Continuous-batching serving engine (see
    :mod:`repro_torch.serving.engine`): ``shape.global_batch`` decode
    slots, ``shape.seq_len`` max sequence length, a paged KV pool sized
    for full occupancy, on the card unless ``device`` says otherwise.
    ``params=None`` draws weights from the specs with a
    ``torch.Generator(seed)`` on that device.  The engine admits token
    prompts only: a VLM serves text-only (no prefix), as the reference's
    engine does, and an encoder-decoder is refused (it has no frames to
    encode; the reference's engine fails at its first prefill)."""
    from repro_torch.serving.engine import DecodeEngine

    if cfg.cross_attention:
        raise ValueError(
            f"{cfg.name}: the paged engine feeds no encoder frames, so a "
            f"cross-attention decoder has no encoder output to attend to; "
            f"serve it from the contiguous path (launch.steps.build_serve)")
    device = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = mbase.materialize(lm.param_specs(cfg), gen, device)
    return DecodeEngine(cfg, params, max_batch=shape.global_batch,
                        max_len=shape.seq_len, page_size=page_size,
                        num_pages=num_pages, prefill_len=prefill_len,
                        eos_id=eos_id, tracer=tracer, metrics=metrics,
                        on_logits=on_logits)
