"""Span-based host tracing: the seconds half of the telemetry (the port of
``repro.telemetry.trace``).

A :class:`Tracer` records host-side :class:`Span` s around the round
loop (``launch/train.fit``), the sync pipeline (``core/syncplan``
collective stages), the controller decisions and the serving engine, so
every quantity the comms ledger prices in bytes also gets a wall-clock
figure, exported to Perfetto / Prometheus by
:mod:`repro_torch.telemetry.export`.  The span names and categories are
the reference's:

=============  ============================================================
``round``      one global sync round: H local steps + the global sync
``local_steps``one ``bundle.local_step`` call
``sync``       one ``bundle.sync`` call (scope attr: ``block``/``global``)
``pack``       a sync pack stage (reserved for per-stage executors)
``collective`` one collective stage of the SyncPlan schedule, with the
               SAME ``stage`` id ``CommsLedger.record_plan`` prices
``apply``      a sync apply stage (reserved for per-stage executors)
``controller`` one ``update`` + ``plan_delta`` decision
``eval``       one ``eval_fn`` call
``checkpoint`` one ``checkpoint_fn`` call
``admit``      serving: one admission wave (queue -> engine slots)
``prefill``    serving: one prompt prefill + page write
``decode``     serving: one continuous-batching decode step
``swap``       serving: one live weight install (hot-swap)
=============  ============================================================

Measurement semantics: CUDA launches are asynchronous, so a span around
a step measures the launches, with the device work of span *i* possibly
draining inside span *i+1*.  ``Tracer(fence=True)`` makes
``Span.fence(value)`` call ``torch.cuda.synchronize`` on the card that
holds ``value``, so durations become wall-clock of the work, at the
cost of the host no longer running ahead of the card.  Tracing observes
only: ``fit`` without a tracer runs the untraced path, and with one the
trajectory is the same bit for bit.

``Tracer(annotate=True)`` enters ``torch.profiler.record_function(name)``
for the span's life, so host spans line up with the device kernels in a
``torch.profiler`` capture (a no-op when no profiler runs).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.core import flatbuf

SPAN_NAMES = ("round", "local_steps", "sync", "pack", "collective", "apply",
              "controller", "eval", "checkpoint",
              "admit", "prefill", "decode", "swap")

# span name -> Perfetto category (groups the trace viewer's tracks)
SPAN_CATEGORIES = {
    "round": "train", "local_steps": "train",
    "sync": "sync", "pack": "sync", "collective": "sync", "apply": "sync",
    "controller": "control", "eval": "eval", "checkpoint": "checkpoint",
    "admit": "serve", "prefill": "serve", "decode": "serve", "swap": "serve",
}


def _cuda_device(value):
    """The CUDA device of the first card tensor inside ``value`` (a
    tensor, a ``BucketState``, a dataclass such as ``LocalSGDState``, or
    a dict / list / tuple of them), else None."""
    if isinstance(value, torch.Tensor):
        return value.device if value.is_cuda else None
    if flatbuf.is_bucket_state(value):
        value = value.buckets                 # not the layout's metadata
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        value = [getattr(value, f.name) for f in dataclasses.fields(value)]
    elif isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            dev = _cuda_device(v)
            if dev is not None:
                return dev
    return None


@dataclass
class Span:
    """One traced interval.  ``ts_s`` is seconds since the tracer's origin
    (``time.perf_counter`` based); ``dur_s`` is set on finish (None while
    open and on the disabled tracer)."""
    name: str
    ts_s: float = 0.0
    dur_s: float | None = None
    attrs: dict = field(default_factory=dict)
    tid: int = 0
    _tracer: Any = None
    _annotation: Any = None

    @property
    def cat(self) -> str:
        return SPAN_CATEGORIES.get(self.name, "misc")

    def set(self, **attrs) -> "Span":
        """Attach attributes (exported as Perfetto ``args``)."""
        if self._tracer is not None:
            self.attrs.update(attrs)
        return self

    def fence(self, value):
        """With ``Tracer(fence=True)``, wait until the card holding
        ``value`` has finished its queued work, so the span measures the
        work and not its launch.  Returns ``value`` unchanged."""
        if self._tracer is not None and self._tracer.fence:
            dev = _cuda_device(value)
            if dev is not None:
                torch.cuda.synchronize(dev)
        return value

    # context-manager form: ``with tracer.span("sync") as sp: ...``
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc):
        if self._tracer is not None:
            self._tracer.finish(self)
        return False


_NULL_SPAN = Span(name="null")          # shared, attr-dropping no-op


class Tracer:
    """Collects :class:`Span` s; thread-safe appends, perf_counter base.

    ``fence``    — make ``Span.fence`` synchronize the card (off by
                   default: fencing stops the host running ahead).
    ``annotate`` — wrap spans in ``torch.profiler.record_function``.
    ``metrics``  — optional :class:`~repro_torch.telemetry.metrics.MetricsRegistry`
                   that consumers feed beside the spans (``fit`` does).
    """

    def __init__(self, *, fence: bool = False, annotate: bool = False,
                 metrics=None):
        self.fence = bool(fence)
        self.annotate = bool(annotate)
        self.metrics = metrics
        self.spans: list[Span] = []
        self._origin = time.perf_counter()
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return True

    def now(self) -> float:
        return time.perf_counter() - self._origin

    def start(self, name: str, **attrs) -> Span:
        sp = Span(name=name, ts_s=self.now(), attrs=dict(attrs),
                  tid=threading.get_ident(), _tracer=self)
        if self.annotate:
            sp._annotation = torch.profiler.record_function(name)
            sp._annotation.__enter__()
        return sp

    def finish(self, span: Span, **attrs) -> Span:
        if span._tracer is None:                 # null span / double finish
            return span
        if attrs:
            span.attrs.update(attrs)
        if span._annotation is not None:
            span._annotation.__exit__(None, None, None)
            span._annotation = None
        span.dur_s = self.now() - span.ts_s
        span._tracer = None
        with self._lock:
            self.spans.append(span)
        return span

    def span(self, name: str, **attrs) -> Span:
        """Context-manager span: finished (and recorded) on exit."""
        return self.start(name, **attrs)

    def record(self, name: str, ts_s: float, dur_s: float, **attrs) -> Span:
        """Append an already-measured interval (``sync_stage_spans``
        splits one measured sync over its collective stages)."""
        sp = Span(name=name, ts_s=ts_s, dur_s=float(dur_s),
                  attrs=dict(attrs), tid=threading.get_ident())
        with self._lock:
            self.spans.append(sp)
        return sp


class NullTracer(Tracer):
    """The disabled tracer ``fit`` and the engine use when none is passed:
    every hook is a no-op and nothing is recorded."""

    def __init__(self):                  # no clock, no lock, no list
        self.fence = False
        self.annotate = False
        self.metrics = None
        self.spans = []

    @property
    def enabled(self) -> bool:
        return False

    def now(self) -> float:
        return 0.0

    def start(self, name: str, **attrs) -> Span:
        return _NULL_SPAN

    def finish(self, span: Span, **attrs) -> Span:
        return span

    def span(self, name: str, **attrs) -> Span:
        return _NULL_SPAN

    def record(self, name: str, ts_s: float, dur_s: float, **attrs) -> Span:
        return _NULL_SPAN


NULL = NullTracer()


def sync_stage_spans(tracer: Tracer, plan, scope: str, parent: Span,
                     *, seconds: float | None = None) -> list[tuple[int, float]]:
    """Emit one ``collective`` span per collective stage of
    ``plan.schedule(scope)``, spreading the measured sync duration over
    the stages by their ring-model wire bytes — the same weights
    ``CommsLedger.record_plan(seconds=)`` uses, under the same ``stage``
    ids, so the two streams join.  The spans carry ``attributed=True``:
    only the total is measured.

    Returns ``[(stage_id, seconds), ...]``; empty on a disabled tracer or
    an unfinished parent.
    """
    total = parent.dur_s if seconds is None else seconds
    if not tracer.enabled or total is None:
        return []
    stages = list(plan.collective_stages(scope))
    if not stages:
        return []
    est = sum(s.wire_bytes for s in stages)
    shares = ([s.wire_bytes / est for s in stages] if est > 0
              else [1.0 / len(stages)] * len(stages))
    out = []
    t = parent.ts_s
    for i, (s, w) in enumerate(zip(stages, shares)):
        dur = total * w
        tracer.record("collective", t, dur, stage=i, scope=scope,
                      buckets=list(s.buckets), compression=s.compression,
                      group=s.group, wire_bytes=s.wire_bytes,
                      collectives=s.collectives, coalesced=s.coalesced,
                      attributed=True)
        out.append((i, dur))
        t += dur
    return out
