"""Adaptive sync controllers: close the comm/performance loop (the port of
``repro.core.controller``).

The paper pre-schedules the communication/performance trade-off (the
static H(t) of ``core/schedule.py``); these controllers measure it at
run time from the telemetry round summary
(``telemetry.stats.round_summary``) and drive H, the sync compressor,
the per-worker batch and the learning rate from it, stepped on the host
at each global sync.

Control signals:

* ``diversity`` — worker dispersion at sync over the accumulated update
  norm (gradient diversity, Yin et al. 2017): collapse means averaging is
  redundant and H can grow; growth means averaging pays and H shrinks.
* ``loss`` plateau — relative improvement under ``tol`` for ``patience``
  rounds: grow the per-worker batch instead of decaying the LR (Lau et
  al. 2024).
* ``comp_rel_err`` — measured (or speculative) per-bucket relative L2
  compression error: escalate none -> sign -> ef_sign per bucket while it
  stays under ``err_budget``.
* ``signal_sq`` / ``noise_sq`` — the update-energy split of
  ``core.noise.noise_decomposition``: the critical batch B_noise
  (McCandlish et al. 2018) drives batch growth while the total batch is
  noise-dominated, then hands off to LR decay (``lr_scale``) once the
  batch is capped.

Protocol: ``h_at(step)`` is consulted EVERY local step (so the static
policy gives the plain scheduler's trajectory bit for bit);
``update(report)`` runs once per GLOBAL sync with the host-side summary;
``plan_delta(step)`` then emits the next round's :class:`PlanDelta`
(:func:`traced_decision` runs the pair inside a ``controller`` span).

``ElasticController`` moves workers instead: scripted resizes and
straggler demotion / promotion from the backend's per-worker step times
(``worker_step_skew``, ``worker_step_s_by_id``), actuated by ``fit``
through the backend seam (``repro_torch.backend``).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Protocol, runtime_checkable

from repro_torch.configs.base import RunConfig
from repro_torch.core import noise as noise_mod
from repro_torch.core.schedule import local_steps_at
from repro_torch.core.local_sgd import needs_anchor
from repro_torch.core.syncplan import (PlanDelta, Topology, default_block_size,
                                       flat, hierarchical)


@dataclass
class RoundReport:
    """Host-side record of one global round, handed to ``update`` (and
    written as one JSONL line by ``launch/train.fit``)."""
    round: int
    step: int
    h: int
    loss: float
    stats: dict = field(default_factory=dict)   # telemetry round_summary
    wire_bytes: float = 0.0
    collectives: int = 0


@runtime_checkable
class SyncController(Protocol):
    def h_at(self, step: int) -> int: ...
    def compression(self) -> Any: ...           # None | str | per-bucket tuple
    def batch_scale(self) -> int: ...
    def update(self, report: RoundReport) -> None: ...
    def plan_delta(self, step: int) -> PlanDelta: ...
    # lr_scale() -> float is optional (fit reads 1.0 without it)


class _EmitsPlanDelta:
    """Every policy emits ONE :class:`PlanDelta` per global round: the next
    H, the per-bucket compressor rewrite, an optional topology switch, the
    batch scale and the LR scale.  A policy that decides nothing emits a
    delta that rewrites nothing, and ``apply`` returns the SAME plan.

    ``_topology_switch`` is the hook of topology-driving policies (the
    elastic policy's demotion): set it to a :class:`Topology` and the next
    delta carries it once."""

    _topology_switch: Topology | None = None

    def lr_scale(self) -> float:
        """Runtime LR multiplier for the next round (1.0 unless a policy
        overrides it)."""
        return 1.0

    def plan_delta(self, step: int) -> PlanDelta:
        topo, self._topology_switch = self._topology_switch, None
        return PlanDelta(h=int(self.h_at(step)),
                         compression=self.compression(),
                         topology=topo,
                         batch_scale=int(self.batch_scale()),
                         lr_scale=float(self.lr_scale()))


class StaticController(_EmitsPlanDelta):
    """The pre-scheduled H(t): ``h_at`` is ``local_steps_at``, ``update``
    decides nothing."""

    kind = "static"

    def __init__(self, run: RunConfig):
        self.ls = run.local_sgd

    def h_at(self, step: int) -> int:
        return local_steps_at(self.ls, step)

    def compression(self):
        return None

    def batch_scale(self) -> int:
        return 1

    def update(self, report: RoundReport) -> None:
        pass


class DiversityHController(_EmitsPlanDelta):
    """Adapt H from the measured gradient diversity: its EMA under ``low``
    doubles H (up to ``h_max``), over ``high`` halves it (down to
    ``h_min``).  Starts at ``h0`` (default: ``local_steps``)."""

    kind = "diversity_h"

    def __init__(self, run: RunConfig):
        cc = run.controller
        self.cc = cc
        self.h = int(cc.h0 or run.local_sgd.local_steps)
        self.h = min(max(self.h, cc.h_min), cc.h_max)
        self.ema = None

    def h_at(self, step: int) -> int:
        return self.h

    def compression(self):
        return None

    def batch_scale(self) -> int:
        return 1

    def update(self, report: RoundReport) -> None:
        d = report.stats.get("diversity")
        if d is None:
            return
        self.ema = d if self.ema is None else \
            self.cc.ema * self.ema + (1 - self.cc.ema) * d
        if self.ema < self.cc.low:
            self.h = min(self.h * 2, self.cc.h_max)
        elif self.ema > self.cc.high:
            self.h = max(self.h // 2, self.cc.h_min)


class AdaptiveBatchController(_EmitsPlanDelta):
    """Grow the per-worker batch on a loss plateau (Lau et al. 2024).

    Keeps the configured H schedule; when the EMA loss improves by less
    than ``tol`` (relative) for ``patience`` consecutive rounds, the batch
    scale doubles (up to ``max_batch_scale``).  Each doubling re-baselines
    the detector (``ema`` / ``best`` reset), so the larger batch is judged
    on its own losses."""

    kind = "adaptive_batch"

    def __init__(self, run: RunConfig):
        self.ls = run.local_sgd
        self.cc = run.controller
        self.scale = 1
        self.ema = None
        self.best = None
        self.stall = 0

    def h_at(self, step: int) -> int:
        return local_steps_at(self.ls, step)

    def compression(self):
        return None

    def batch_scale(self) -> int:
        return self.scale

    def update(self, report: RoundReport) -> None:
        loss = report.loss
        self.ema = loss if self.ema is None else \
            self.cc.ema * self.ema + (1 - self.cc.ema) * loss
        if self.best is None or self.ema < self.best * (1 - self.cc.tol):
            self.best = self.ema
            self.stall = 0
            return
        self.stall += 1
        if self.stall >= self.cc.patience and \
                self.scale < self.cc.max_batch_scale:
            self.scale *= 2
            self.stall = 0
            self.ema = None
            self.best = None


class _CompressionLadder:
    """Per-bucket none -> sign -> ef_sign escalation with symmetric streak
    hysteresis (shared by ``auto_compress`` and ``noise_adaptive``): both
    edges need ``patience`` CONSECUTIVE qualifying rounds, none -> sign on
    (speculative) sign error under ``err_budget``, sign -> ef_sign on
    measured error over it.  One streak counter per bucket; every
    transition resets it."""

    def __init__(self, n_comp: int, *, err_budget: float, patience: int):
        self.err_budget = err_budget
        self.patience = max(int(patience), 1)
        self.modes = ["none"] * n_comp
        self.streak = [0] * n_comp

    def step(self, stats: dict) -> list:
        """Advance on one round's telemetry; returns the bucket ids whose
        mode changed.  A round with ``comp_measured`` False carries no
        signal; a slot reading exactly 0.0 had no reference energy and
        neither advances nor resets its streak."""
        errs = stats.get("comp_rel_err") or []
        if not stats.get("comp_measured"):
            return []
        changed = []
        for b, e in enumerate(errs[:len(self.modes)]):
            if self.modes[b] == "ef_sign" or e <= 0.0:
                continue
            under = e <= self.err_budget
            hit = under if self.modes[b] == "none" else not under
            self.streak[b] = self.streak[b] + 1 if hit else 0
            if self.streak[b] >= self.patience:
                self.modes[b] = ("sign" if self.modes[b] == "none"
                                 else "ef_sign")
                self.streak[b] = 0
                changed.append(b)
        return changed


class AutoCompressController(_EmitsPlanDelta):
    """Escalate the sync compressor none -> sign -> ef_sign per bucket from
    the measured (speculative while uncompressed) relative error; needs
    ``sync_compression='ef_sign'`` so the state allocates the anchor and
    the EF memory up front.  Escalation is monotone."""

    kind = "auto_compress"

    def __init__(self, run: RunConfig, *, n_comp: int = 1):
        if run.local_sgd.sync_compression != "ef_sign":
            raise ValueError(
                "auto_compress requires sync_compression='ef_sign' so the "
                "state allocates anchor + EF memory for runtime escalation")
        self.cc = run.controller
        self.ls = run.local_sgd
        self.ladder = _CompressionLadder(n_comp,
                                         err_budget=run.controller.err_budget,
                                         patience=run.controller.patience)

    @property
    def modes(self):
        return self.ladder.modes

    def h_at(self, step: int) -> int:
        return local_steps_at(self.ls, step)

    def compression(self):
        return tuple(self.ladder.modes)

    def batch_scale(self) -> int:
        return 1

    def update(self, report: RoundReport) -> None:
        self.ladder.step(report.stats)


class NoiseAdaptiveController(_EmitsPlanDelta):
    """The composite policy: one RoundReport stream in, one PlanDelta out.

    1. Noise-scaled batch growth: while the EMA critical batch B_noise
       exceeds ``noise_grow`` x the current TOTAL batch for ``patience``
       consecutive rounds, the per-worker batch doubles (re-baselining the
       EMA).
    2. LR-decay handoff: once the batch is at ``max_batch_scale``, further
       trips decay ``lr_scale`` by ``lr_cap_decay`` down to
       ``lr_scale_min``.
    3. Diversity-driven H, with ``diversity_h``'s thresholds.
    4. The per-bucket compression ladder, when the config allocated EF
       memory (``sync_compression='ef_sign'``); otherwise that axis stays
       off and the other three run.

    Under sign / EF-sign the dispersion is measured on the compressed
    payload, so the split saturates (``signal_sq`` 0): the policy reads
    it as the reference does.  ``decisions`` holds the last round's
    provenance, which sensor drove which actuation (written to the fit
    JSONL)."""

    kind = "noise_adaptive"

    def __init__(self, run: RunConfig, *, n_comp: int = 1):
        cc = run.controller
        self.cc = cc
        self.ls = run.local_sgd
        self.global_batch = run.shape.global_batch
        self.h = int(cc.h0 or run.local_sgd.local_steps)
        self.h = min(max(self.h, cc.h_min), cc.h_max)
        self.scale = 1
        self.lr = 1.0
        self.div_ema = None
        self.noise_ema = None
        self.grow_streak = 0
        self.ladder = (_CompressionLadder(n_comp, err_budget=cc.err_budget,
                                          patience=cc.patience)
                       if run.local_sgd.sync_compression == "ef_sign"
                       else None)
        self.decisions: dict = {}

    def h_at(self, step: int) -> int:
        return self.h

    def compression(self):
        return tuple(self.ladder.modes) if self.ladder is not None else None

    def batch_scale(self) -> int:
        return self.scale

    def lr_scale(self) -> float:
        return self.lr

    def update(self, report: RoundReport) -> None:
        st = report.stats
        self.decisions = {}
        # (1) per-bucket compression ladder
        if self.ladder is not None:
            changed = self.ladder.step(st)
            if changed:
                self.decisions["compression"] = {
                    "buckets": changed,
                    "modes": list(self.ladder.modes),
                    "comp_rel_err": st.get("comp_rel_err")}
        # (2) diversity-driven H
        d = st.get("diversity")
        if d is not None:
            self.div_ema = d if self.div_ema is None else \
                self.cc.ema * self.div_ema + (1 - self.cc.ema) * d
            h0 = self.h
            if self.div_ema < self.cc.low:
                self.h = min(self.h * 2, self.cc.h_max)
            elif self.div_ema > self.cc.high:
                self.h = max(self.h // 2, self.cc.h_min)
            if self.h != h0:
                self.decisions["h"] = {"from": h0, "to": self.h,
                                       "diversity_ema": self.div_ema}
        # (3) noise-scaled batch growth with the LR-decay cap handoff
        sig = st.get("signal_sq")
        noi = st.get("noise_sq")
        w = st.get("num_workers") or 0
        if sig is None or noi is None or w <= 0:
            return
        b_loc = self.global_batch / w * self.scale   # measurement batch
        b_noise = noise_mod.critical_batch(sig, noi, b_loc)
        self.noise_ema = b_noise if self.noise_ema is None else \
            self.cc.ema * self.noise_ema + (1 - self.cc.ema) * b_noise
        self.decisions["b_noise"] = {"raw": b_noise, "ema": self.noise_ema}
        total = self.global_batch * self.scale
        if self.noise_ema > self.cc.noise_grow * total:
            self.grow_streak += 1
        else:
            self.grow_streak = 0
            return
        if self.grow_streak < self.cc.patience:
            return
        self.grow_streak = 0
        if self.scale < self.cc.max_batch_scale:
            self.scale *= 2
            # re-baseline: the estimate's variance changes with the
            # measurement batch
            self.noise_ema = None
            self.decisions["batch"] = {"scale": self.scale,
                                       "b_noise_ema": None,
                                       "total_batch": total * 2}
        elif self.lr > self.cc.lr_scale_min:
            self.lr = max(self.lr * self.cc.lr_cap_decay,
                          self.cc.lr_scale_min)
            self.decisions["lr"] = {"lr_scale": self.lr,
                                    "reason": "batch at cap, "
                                              "noise still dominant"}


class ElasticController(_EmitsPlanDelta):
    """Worker-set policy on the backend seam.  Its actuations ride the same
    per-round :class:`PlanDelta` as every other policy's:

    * **resize** — ``resize_at`` maps a global-round index to a worker-set
      width; at that round the delta carries ``workers=W'`` and ``fit``
      does the state surgery (``core/elastic``), rebuilds the bundle
      through the backend and co-scales the LR (Lau et al. 2024).  The
      scripted map stands in for a membership signal: join / leave events
      would feed the same field.
    * **straggler demotion** — when the ``worker_step_skew`` gauge (the
      backend's per-worker step times; absent on the lockstep local
      backend) exceeds ``skew_threshold`` for ``skew_patience``
      consecutive rounds, the slowest worker is demoted: ``demote=<id>``
      moves it to the outer scope in the backend's census, and, when the
      config can serve block syncs (the plain mean path: compression and
      global momentum need flat local SGD), the delta also switches the
      plan to ``hierarchical(W // 2)`` and stretches the outer cadence
      with ``block_steps``, so the demoted worker stops gating every
      round.
    * **promotion back** — the backend's by-id census
      (``worker_step_s_by_id``, which unlike the active-only skew still
      sees demoted workers) is watched per demoted id; once a worker's
      excess over the active mean stays under ``skew_threshold`` for
      ``skew_patience`` consecutive rounds it returns to the inner scope
      with ``promote=<id>`` (one a round).  When the LAST demoted worker
      comes back, the delta also restores the pre-demotion topology
      (``flat`` for a flat-scheduled run) and block cadence.

    H, compression and batch follow the static schedule: this policy only
    moves workers.
    """

    kind = "elastic"

    def __init__(self, run: RunConfig, *, resize_at: dict | None = None,
                 demote_block_steps: int = 2):
        self.ls = run.local_sgd
        self.cc = run.controller
        self.resize_at = {int(k): int(v) for k, v in (resize_at or {}).items()}
        self.demote_block_steps = int(demote_block_steps)
        self.can_block = not needs_anchor(self.ls)
        self.skew_streak = 0
        self.demoted: set[int] = set()
        self.recovery_streak: dict[int, int] = {}
        self.decisions: dict = {}
        self._pending_workers: int | None = None
        self._pending_demote: int | None = None
        self._pending_promote: int | None = None
        self._pending_block_steps: int | None = None

    def h_at(self, step: int) -> int:
        return local_steps_at(self.ls, step)

    def compression(self):
        return None

    def batch_scale(self) -> int:
        return 1

    def update(self, report: RoundReport) -> None:
        self.decisions = {}
        target = self.resize_at.get(report.round)
        if target is not None:
            self._pending_workers = target
            self.decisions["resize"] = {"workers": target,
                                        "round": report.round}
        self._maybe_promote(report)
        skew = report.stats.get("worker_step_skew")
        if skew is None:
            return
        if skew > self.cc.skew_threshold:
            self.skew_streak += 1
        else:
            self.skew_streak = 0
        slowest = report.stats.get("worker_slowest")
        if (self.skew_streak >= self.cc.skew_patience
                and slowest is not None and slowest not in self.demoted):
            slowest = int(slowest)
            self.skew_streak = 0
            self.demoted.add(slowest)
            self._pending_demote = slowest
            self.decisions["straggler"] = {"demote": slowest,
                                           "skew": float(skew),
                                           "scheduled": self.can_block}
            if self.can_block:
                w = int(report.stats.get("num_workers") or 0)
                if w > 1:
                    self._topology_switch = hierarchical(default_block_size(w))
                    self._pending_block_steps = self.demote_block_steps

    def _maybe_promote(self, report: RoundReport) -> None:
        """Watch the demoted workers in the by-id census; return one to the
        inner scope once its excess over the active mean has stayed under
        ``skew_threshold`` for ``skew_patience`` rounds."""
        by_id = report.stats.get("worker_step_s_by_id")
        if not self.demoted or not by_id:
            return
        by_id = {int(k): float(v) for k, v in by_id.items()}
        active = [t for i, t in by_id.items() if i not in self.demoted]
        mean_active = sum(active) / len(active) if active else 0.0
        if mean_active <= 0:
            return
        for d in sorted(self.demoted):
            if d not in by_id:
                continue
            excess = (by_id[d] - mean_active) / mean_active
            if excess < self.cc.skew_threshold:
                self.recovery_streak[d] = self.recovery_streak.get(d, 0) + 1
            else:
                self.recovery_streak[d] = 0
        ready = [d for d in sorted(self.demoted)
                 if self.recovery_streak.get(d, 0) >= self.cc.skew_patience]
        if not ready:
            return
        back = ready[0]                       # one promotion a round
        self.demoted.discard(back)
        self.recovery_streak.pop(back, None)
        self._pending_promote = back
        self.decisions["recovered"] = {"promote": back,
                                       "restored": not self.demoted}
        if not self.demoted and self.can_block:
            # the last straggler is back: undo the demotion-era schedule
            if self.ls.block_steps == 1:
                self._topology_switch = flat()
            self._pending_block_steps = self.ls.block_steps

    def plan_delta(self, step: int) -> PlanDelta:
        delta = super().plan_delta(step)
        w, self._pending_workers = self._pending_workers, None
        d, self._pending_demote = self._pending_demote, None
        p, self._pending_promote = self._pending_promote, None
        b, self._pending_block_steps = self._pending_block_steps, None
        if w is None and d is None and p is None and b is None:
            return delta
        return replace(delta, workers=w, demote=d, promote=p, block_steps=b)


_KINDS = {
    "static": StaticController,
    "diversity_h": DiversityHController,
    "adaptive_batch": AdaptiveBatchController,
    "auto_compress": AutoCompressController,
    "noise_adaptive": NoiseAdaptiveController,
    "elastic": ElasticController,
}


def make_controller(run: RunConfig, *, n_comp: int = 1) -> SyncController:
    """Instantiate the policy named by ``run.controller.kind``.  ``n_comp``
    is the number of compression-error slots the telemetry reports (one
    per bucket), the granularity at which ``auto_compress`` /
    ``noise_adaptive`` escalate."""
    kind = run.controller.kind
    if kind not in _KINDS:
        raise ValueError(f"unknown controller kind {kind!r}; "
                         f"one of {sorted(_KINDS)}")
    if kind in ("auto_compress", "noise_adaptive"):
        return _KINDS[kind](run, n_comp=n_comp)
    return _KINDS[kind](run)


def traced_decision(tracer, controller: SyncController, report: RoundReport,
                    step: int) -> PlanDelta:
    """One ``update`` + ``plan_delta`` inside a ``controller`` span whose
    attributes are the emitted :class:`PlanDelta` and the policy's
    ``decisions`` provenance, so the trace shows which sensor drove which
    actuation at each round.  With the null tracer this is exactly the
    bare ``update`` + ``plan_delta`` pair."""
    with tracer.span("controller", round=report.round, step=report.step,
                     kind=getattr(controller, "kind", "custom")) as sp:
        controller.update(report)
        delta = controller.plan_delta(step)
        sp.set(next_h=delta.h,
               compression=(list(delta.compression)
                            if isinstance(delta.compression, (tuple, list))
                            else delta.compression),
               topology=(delta.topology.describe()
                         if delta.topology is not None else None),
               batch_scale=delta.batch_scale, lr_scale=delta.lr_scale,
               workers=delta.workers, demote=delta.demote,
               promote=delta.promote,
               decisions=dict(getattr(controller, "decisions", None) or {}))
    return delta
