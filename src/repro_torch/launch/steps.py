"""Step builder: wire paper-lm + resident local SGD into a ``TrainBundle``
(the port of ``repro.launch.steps.build_train``, without a mesh).

The port always builds the resident flat-bus path — the one the
reference selects with ``use_kernel=True`` — so every local step runs the
fused SGD kernel and every sign / EF-sign sync the compressor kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import flatbuf
from repro_torch.core import syncplan as splan
from repro_torch.core.local_sgd import make_local_sgd, needs_anchor
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


def build_train(run: RunConfig, *, num_workers: int = 1,
                device=None) -> TrainBundle:
    """Resident-bucket local SGD for ``run.model`` with ``num_workers``
    workers stacked on one device.  ``device=None`` means the card and
    raises when CUDA is absent; tests pass ``device="cpu"``."""
    device = resolve_device(device)
    cfg = run.model
    specs = lm.param_specs(cfg)
    wd_mask = mbase.norm_param_mask(specs)

    def loss(params, batch):
        return lm.loss_fn(cfg, params, batch)

    init, local_step, sync = make_local_sgd(run, loss, num_workers=num_workers,
                                            wd_mask=wd_mask)
    layout = flatbuf.build_layout(
        mbase.abstract(specs, flatbuf.torch_dtype(cfg.param_dtype)),
        wd_mask=wd_mask)
    plan = splan.make_sync_plan(layout, num_workers=num_workers,
                                compression=run.local_sgd.sync_compression,
                                anchored=needs_anchor(run.local_sgd))
    return TrainBundle(cfg=cfg, run=run, num_workers=num_workers, specs=specs,
                       init=init, local_step=local_step, sync=sync,
                       device=device, layout=layout, sync_plan=plan)
