"""On-device per-round training statistics (the port of
``repro.telemetry.stats``).

A :class:`StatsAccumulator` rides in ``LocalSGDState.stats`` when
telemetry is on (``ControllerConfig.wants_telemetry``).  Two groups of
fields, all small tensors on the training device:

* ``acc_*`` — added to every LOCAL step.  The per-worker grad-norm^2 and
  update-norm^2 come out of the update kernel that the step launches
  anyway (``stats=True``), so per-step telemetry costs no extra pass.
* ``round_* / pre_sync_sq / post_sync_sq / comp_*`` — the last completed
  round, written at each GLOBAL sync (:func:`record_sync`): the
  accumulators roll into ``round_*`` and reset, and the sync adds its
  pre-/post-mean norm pair and the per-bucket compression error.

The pre-/post-mean pair is the gradient-diversity sensor: for the synced
quantity x_k (the model difference on anchored paths, the mean-centred
params p_k - pbar on the plain mean path, where post = 0 exactly)

    pre  = mean_k ||x_k||^2        post = ||mean_k x_k||^2
    dispersion = pre - post = mean_k ||x_k - mean x||^2   (>= 0)

:func:`round_summary` turns the last round into host floats with the
reference's keys (across processes, after gathering every worker
group's per-worker slices).  A worker split over shard ranks sums its
shard regions' partials before anything is recorded (the optimizers'
and the sync's ``flatbuf.shard_sum``), so the accumulator always holds
unsharded per-worker values, the same on every shard rank.  Nothing in the port reads it yet but callers and
tests: no JSONL record, ledger or controller.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.noise import noise_decomposition


@dataclass
class StatsAccumulator:
    # per-round accumulators (every local step adds into these)
    acc_grad_sq: Any      # (W,) f32: sum over steps of per-worker ||g||^2
    acc_update_sq: Any    # (W,) f32: sum over steps of per-worker ||dp||^2
    acc_steps: Any        # () int32: local steps since the last global sync
    # last completed round (written by record_sync at global syncs)
    round_grad_sq: Any    # (W,) f32
    round_update_sq: Any  # (W,) f32
    round_steps: Any      # () int32
    pre_sync_sq: Any      # () f32: mean_k ||x_k||^2 at the last sync
    post_sync_sq: Any     # () f32: ||mean_k x_k||^2 at the last sync
    comp_err_sq: Any      # (n_comp,) f32: per-bucket ||input - C(input)||^2
    comp_ref_sq: Any      # (n_comp,) f32: per-bucket ||input||^2
    rounds: Any           # () int32: completed global rounds


def init_stats(num_workers: int, n_comp: int = 1, device="cpu") -> StatsAccumulator:
    """Zero accumulator with ``n_comp`` compression-error slots (one per
    bucket)."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    i0 = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return StatsAccumulator(
        acc_grad_sq=z(num_workers), acc_update_sq=z(num_workers),
        acc_steps=i0(),
        round_grad_sq=z(num_workers), round_update_sq=z(num_workers),
        round_steps=i0(), pre_sync_sq=z(), post_sync_sq=z(),
        comp_err_sq=z(n_comp), comp_ref_sq=z(n_comp), rounds=i0())


def accumulate_step(stats: StatsAccumulator, grad_sq_w,
                    update_sq_w) -> StatsAccumulator:
    """Add one local step's per-worker (W,) grad/update norms."""
    return dataclasses.replace(
        stats, acc_grad_sq=stats.acc_grad_sq + grad_sq_w,
        acc_update_sq=stats.acc_update_sq + update_sq_w,
        acc_steps=stats.acc_steps + 1)


def record_sync(stats: StatsAccumulator, *, pre_sync_sq, post_sync_sq,
                comp_err_sq=None, comp_ref_sq=None) -> StatsAccumulator:
    """Close a round at a GLOBAL sync: roll the accumulators into the
    ``round_*`` snapshot, record the sync-time pair, reset for the next
    round.  ``comp_*`` default to zeros (no compressor ran)."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                    device=stats.rounds.device)
    z = torch.zeros_like
    return StatsAccumulator(
        acc_grad_sq=z(stats.acc_grad_sq),
        acc_update_sq=z(stats.acc_update_sq),
        acc_steps=z(stats.acc_steps),
        round_grad_sq=stats.acc_grad_sq,
        round_update_sq=stats.acc_update_sq,
        round_steps=stats.acc_steps,
        pre_sync_sq=f32(pre_sync_sq), post_sync_sq=f32(post_sync_sq),
        comp_err_sq=(z(stats.comp_err_sq) if comp_err_sq is None
                     else f32(comp_err_sq)),
        comp_ref_sq=(z(stats.comp_ref_sq) if comp_ref_sq is None
                     else f32(comp_ref_sq)),
        rounds=stats.rounds + 1)


def round_summary(stats: StatsAccumulator, *, eps: float = 1e-12,
                  dist=None) -> dict:
    """Host-side summary of the last completed round (floats/lists), with
    the reference's keys.  Across processes (``dist``, a
    ``backend.collectives.Collectives``) the rank's per-worker slices are
    all-gathered first, so every rank summarizes all W workers, as one
    process does.

    ``diversity`` is the worker dispersion at sync over the mean
    per-worker accumulated update norm^2; ``comp_rel_err`` the per-bucket
    relative L2 compression error; ``signal_sq``/``noise_sq``/
    ``noise_ratio`` split the update energy (:func:`noise_decomposition`).
    """
    if dist is not None:
        # over the worker group: one rank a worker group, each holding its
        # workers' unsharded values
        both = dist.gather_workers(
            torch.stack([stats.round_grad_sq, stats.round_update_sq], dim=1),
            scope="telemetry")
        stats = dataclasses.replace(stats, round_grad_sq=both[:, 0].contiguous(),
                                    round_update_sq=both[:, 1].contiguous())
    s = {f.name: getattr(stats, f.name).detach().cpu().numpy()
         for f in dataclasses.fields(stats)}
    num_workers = int(s["round_grad_sq"].shape[0])
    grad_sq = float(np.mean(s["round_grad_sq"]))
    update_sq = float(np.mean(s["round_update_sq"]))
    pre = float(s["pre_sync_sq"])
    post = float(s["post_sync_sq"])
    dispersion = max(pre - post, 0.0)
    ref = np.asarray(s["comp_ref_sq"], np.float64)
    err = np.asarray(s["comp_err_sq"], np.float64)
    return {
        "rounds": int(s["rounds"]),
        "round_steps": int(s["round_steps"]),
        "num_workers": num_workers,
        "grad_sq": grad_sq,
        "update_sq": update_sq,
        "pre_sync_sq": pre,
        "post_sync_sq": post,
        "dispersion": dispersion,
        "diversity": dispersion / (update_sq + eps),
        **noise_decomposition(update_sq, dispersion, num_workers, eps=eps),
        "comp_rel_err": [float(e / (r + eps)) for e, r in zip(err, ref)],
        "comp_measured": bool(ref.sum() > 0),
    }
