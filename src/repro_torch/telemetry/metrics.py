"""Host-side metrics registry (counters / gauges / histograms): the
port's copy of ``repro.telemetry.metrics``, pure Python, with the same
Prometheus text exposition (``# HELP`` / ``# TYPE`` headers, cumulative
``_bucket{le=...}`` histogram rows, ``_sum`` / ``_count``) and the same
``repro_`` metric names, so one scraper reads either package.

``benchmarks.common.time_fn`` and ``wall_timer`` feed the shared
``bench_seconds`` histogram (label ``name``).  The ``observe_*`` feeders
map the quantities a trainer or a serving engine already has onto the
standard set:

* ``repro_step_time_seconds``   (histogram) one local_step call
* ``repro_sync_time_seconds``   (histogram, label ``scope``)
* ``repro_stage_time_seconds``  (counter, labels ``scope``/``stage``)
* ``repro_wire_bytes_total``    (counter) cumulative priced sync bytes
* ``repro_rounds_total``        (counter, label ``scope``)
* ``repro_h`` / ``repro_batch_scale`` / ``repro_lr_scale`` (gauges)
* ``repro_loss``                (gauge) last round's training loss
* ``repro_worker_step_skew``    (gauge) per-worker step-time spread
  (max-min)/mean; 0 when the workers step in lockstep on one device
"""
from __future__ import annotations

from dataclasses import dataclass, field

DEFAULT_BUCKETS = (0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers render bare."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _label_str(names, values) -> str:
    if not names:
        return ""
    esc = lambda s: str(s).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")
    return "{" + ",".join(f'{n}="{esc(v)}"' for n, v in zip(names, values)) + "}"


@dataclass
class _Child:
    """One labeled time series of a metric family."""
    kind: str
    buckets: tuple = ()
    value: float = 0.0
    bucket_counts: list = field(default_factory=list)
    sum: float = 0.0
    count: int = 0

    def __post_init__(self):
        if self.kind == "histogram" and not self.bucket_counts:
            self.bucket_counts = [0] * (len(self.buckets) + 1)  # + +Inf

    def inc(self, amount: float = 1.0):
        assert self.kind == "counter", "inc() is for counters"
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += amount

    def set(self, value: float):
        assert self.kind == "gauge", "set() is for gauges"
        self.value = float(value)

    def observe(self, value: float):
        assert self.kind == "histogram", "observe() is for histograms"
        v = float(value)
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.bucket_counts[i] += 1
                break
        else:
            self.bucket_counts[-1] += 1
        self.sum += v
        self.count += 1


class Metric:
    """A metric family: ``labels(**kv)`` returns the child time series
    (created on first use); label-less metrics proxy the default child
    so ``m.inc()`` / ``m.set()`` / ``m.observe()`` work directly."""

    def __init__(self, name: str, help: str, kind: str, label_names=(),
                 buckets=()):
        self.name = name
        self.help = help
        self.kind = kind
        self.label_names = tuple(label_names)
        self.buckets = tuple(buckets)
        self._children: dict[tuple, _Child] = {}
        if not self.label_names:
            self._children[()] = _Child(kind=kind, buckets=self.buckets)

    def labels(self, **kv) -> _Child:
        if set(kv) != set(self.label_names):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.label_names}, got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _Child(kind=self.kind,
                                                 buckets=self.buckets)
        return child

    # label-less convenience
    def inc(self, amount: float = 1.0):
        self._children[()].inc(amount)

    def set(self, value: float):
        self._children[()].set(value)

    def observe(self, value: float):
        self._children[()].observe(value)

    def exposition_lines(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, c in sorted(self._children.items()):
            ls = _label_str(self.label_names, key)
            if self.kind == "histogram":
                cum = 0
                for le, n in zip(self.buckets, c.bucket_counts):
                    cum += n
                    lb = _label_str(self.label_names + ("le",),
                                    key + (_fmt(le),))
                    lines.append(f"{self.name}_bucket{lb} {cum}")
                cum += c.bucket_counts[-1]
                lb = _label_str(self.label_names + ("le",), key + ("+Inf",))
                lines.append(f"{self.name}_bucket{lb} {cum}")
                lines.append(f"{self.name}_sum{ls} {_fmt(c.sum)}")
                lines.append(f"{self.name}_count{ls} {c.count}")
            else:
                lines.append(f"{self.name}{ls} {_fmt(c.value)}")
        return lines


class MetricsRegistry:
    """Prefix-namespaced metric families with idempotent registration
    (re-registering the same (name, kind) returns the existing family,
    so module-level helpers can call ``counter(...)`` per use)."""

    def __init__(self, prefix: str = "repro"):
        self.prefix = prefix
        self._metrics: dict[str, Metric] = {}

    def _register(self, name: str, help: str, kind: str, labels=(),
                  buckets=()) -> Metric:
        full = f"{self.prefix}_{name}" if self.prefix else name
        m = self._metrics.get(full)
        if m is not None:
            if m.kind != kind or m.label_names != tuple(labels):
                raise ValueError(f"metric {full} re-registered as {kind} "
                                 f"{tuple(labels)} (was {m.kind} "
                                 f"{m.label_names})")
            return m
        m = Metric(full, help, kind, labels, buckets)
        self._metrics[full] = m
        return m

    def counter(self, name: str, help: str = "", labels=()) -> Metric:
        return self._register(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Metric:
        return self._register(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=DEFAULT_BUCKETS) -> Metric:
        return self._register(name, help, "histogram", labels,
                              buckets=tuple(sorted(buckets)))

    def exposition(self) -> str:
        """Prometheus text exposition of every registered family."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].exposition_lines())
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Feeders: the quantities fit already has, mapped onto the standard set
# ---------------------------------------------------------------------------

def observe_step(reg: MetricsRegistry, step_s: float):
    """One ``bundle.local_step`` wall measurement."""
    reg.histogram("step_time_seconds",
                  "wall seconds per local_step call").observe(step_s)


def observe_worker_times(reg: MetricsRegistry, worker_step_s=None):
    """Per-worker step times -> the straggler sensor.  ``None`` (workers
    in lockstep on one device) reports a structural 0 skew."""
    g = reg.gauge("worker_step_skew",
                  "per-worker step-time spread (max-min)/mean; 0 in the "
                  "lockstep single-program simulator")
    if worker_step_s is None or len(worker_step_s) == 0:
        g.set(0.0)
        return
    ts = [float(t) for t in worker_step_s]
    mean = sum(ts) / len(ts)
    g.set((max(ts) - min(ts)) / mean if mean > 0 else 0.0)


def observe_round(reg: MetricsRegistry, *, scope: str, h: int,
                  wire_bytes: float, loss: float | None = None,
                  batch_scale: int = 1, lr_scale: float = 1.0,
                  round_s: float | None = None, sync_s: float | None = None,
                  stage_s=(), worker_step_s=None):
    """One sync round from the RoundReport/CommsLedger stream.

    ``stage_s`` is ``[(stage_id, seconds), ...]``: the attributed
    per-stage seconds, accumulated under the same stage ids the ledger
    prices.
    """
    reg.counter("rounds_total", "completed sync rounds",
                labels=("scope",)).labels(scope=scope).inc()
    reg.counter("wire_bytes_total",
                "cumulative priced sync bytes on the wire").inc(wire_bytes)
    reg.gauge("h", "current local steps between syncs").set(h)
    reg.gauge("batch_scale", "controller batch multiplier").set(batch_scale)
    reg.gauge("lr_scale", "controller runtime LR multiplier").set(lr_scale)
    if loss is not None:
        reg.gauge("loss", "last round training loss").set(loss)
    if sync_s is not None:
        reg.histogram("sync_time_seconds", "wall seconds per sync call",
                      labels=("scope",)).labels(scope=scope).observe(sync_s)
    if round_s is not None:
        reg.histogram("round_time_seconds",
                      "wall seconds per global round "
                      "(local steps + sync)").observe(round_s)
    for stage_id, s in stage_s:
        reg.counter("stage_time_seconds",
                    "attributed seconds per sync collective stage",
                    labels=("scope", "stage")) \
           .labels(scope=scope, stage=stage_id).inc(s)
    observe_worker_times(reg, worker_step_s)


def observe_serve_step(reg: MetricsRegistry, *, new_tokens: int,
                       queue_depth: int, occupancy: float,
                       decode_s: float | None = None):
    """One continuous-batching engine step.

    ``occupancy`` is the fraction of decode slots holding a live
    sequence — the quantity continuous batching exists to maximize;
    ``queue_depth`` is requests still waiting for a slot."""
    reg.counter("serve_tokens_total",
                "tokens decoded by the serving engine").inc(new_tokens)
    reg.gauge("serve_queue_depth",
              "requests waiting for a decode slot").set(queue_depth)
    reg.gauge("serve_batch_occupancy",
              "fraction of decode slots occupied").set(occupancy)
    if decode_s is not None:
        reg.histogram("serve_decode_seconds",
                      "wall seconds per engine decode step").observe(decode_s)


def observe_swap(reg: MetricsRegistry, *, version: int, swap_s: float):
    """One live weight install (hot-swap) on the serving engine."""
    reg.gauge("serve_weight_version",
              "manifest version of the weights currently serving") \
       .set(version)
    reg.histogram("serve_swap_seconds",
                  "wall seconds per live weight install").observe(swap_s)
