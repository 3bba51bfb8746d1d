"""Schedules: the paper's H(t) local-step schedules and the LR schedule
(the port's copy of ``repro.core.schedule``), all on the host."""
from __future__ import annotations

import math

import numpy as np

from repro_torch.configs.base import LocalSGDConfig, OptimConfig


def local_steps_at(cfg: LocalSGDConfig, step: int) -> int:
    """Number of local steps H for the round starting at ``step``."""
    H = cfg.local_steps
    if cfg.post_local_switch >= 0:
        return 1 if step < cfg.post_local_switch else H
    if cfg.warmup_kind != "none" and cfg.warmup_steps > 0:
        frac = min(step / cfg.warmup_steps, 1.0)
        if cfg.warmup_kind == "linear":
            return max(1, min(H, int(round(1 + frac * (H - 1)))))
        if cfg.warmup_kind == "exp":
            if frac >= 1.0:
                return H
            return max(1, min(H, int(2 ** math.floor(frac * math.log2(max(H, 1))))))
        if cfg.warmup_kind == "constant":
            return 1 if frac < 1.0 else H
    return H


class DynamicSchedule:
    """Stateful sync-boundary tracker: with ``block_steps`` H^b > 1 every
    H-th step is an inner (level-1) sync and every (H * H^b)-th an outer
    (level-2) sync."""

    def __init__(self, cfg: LocalSGDConfig, h_at):
        self.cfg = cfg
        self.h_at = h_at
        self.since_sync = 0
        self.rounds = 0
        self.block_steps = cfg.block_steps

    def advance(self, step: int) -> int:
        """Advance one local step; returns the sync level due AFTER step
        ``step`` (0 = keep local, 1 = block sync, 2 = global)."""
        H = max(int(self.h_at(step)), 1)
        self.since_sync += 1
        if self.since_sync < H:
            return 0
        self.since_sync = 0
        self.rounds += 1
        if self.block_steps > 1:
            return 2 if self.rounds % self.block_steps == 0 else 1
        return 2


def sync_boundaries(cfg: LocalSGDConfig, total_steps: int):
    """Yield (step, level) sync events; level 1 = block, 2 = global."""
    sched = DynamicSchedule(cfg, lambda t: local_steps_at(cfg, t))
    for t in range(total_steps):
        level = sched.advance(t)
        if level:
            yield t, level


def lr_at(cfg: OptimConfig, step, *, global_batch: int) -> np.float32:
    """Linear-scaled LR with gradual warmup and step decay.

    Computed in float32 exactly as the reference's jnp form does (the
    Python-float constants enter as weakly typed f32); float64 would
    drift by about 1e-8 relative.
    """
    f32 = np.float32
    scale = global_batch / cfg.base_batch
    peak = cfg.base_lr * scale
    step = f32(step)
    if cfg.lr_warmup_steps:
        warm = f32(cfg.base_lr) + f32(peak - cfg.base_lr) * (
            step / f32(cfg.lr_warmup_steps))
        lr = warm if step < cfg.lr_warmup_steps else f32(peak)
    else:
        lr = f32(peak)
    for b in cfg.lr_decay_steps:
        if step >= b:
            lr = lr * f32(cfg.lr_decay_factor)
    return f32(lr)
