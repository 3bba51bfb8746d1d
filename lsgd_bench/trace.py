"""The profiler trace of a traced window, reduced to what the per-layer
metrics read: every device activity (kernel, copy, fill) with its
interval and the ranges it belongs to.

A device activity belongs to a range when the call that launched it was
made inside the range.  A range named ``bench.*`` (the harness's own,
around the calls into the program) takes every launch made while it is
open, on any thread: the backward's kernels are launched from autograd's
device thread while ``bench.local_step`` waits for them.  A range of the
program (``attention``, ``moe.dispatch``) takes the launches made inside
it on its own thread and, in the backward, those of every autograd node
that a forward op inside it created (matched by autograd sequence
number).  Device time is the union of the intervals, in seconds.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass

EVAL_FN = "autograd::engine::evaluate_function: "


@dataclass(frozen=True)
class Activity:
    start: float            # seconds, host clock domain
    end: float
    name: str
    ranges: frozenset
    launcher: str           # the host event the activity is linked to


@dataclass
class Window:
    """A traced window and what a metric may need besides the trace."""
    acts: list
    window_s: float         # the traced steps' wall seconds
    wall_s: float           # the same number of steps' untraced
    steps: int
    syncs: int
    workers: int
    step_flops: float       # model FLOPs of one step, all workers
    bucket_elements: int    # one worker's bucket elements

    def busy_s(self, pred=None) -> float:
        return union_s([(a.start, a.end) for a in self.acts
                        if pred is None or pred(a)])

    def in_range(self, *names) -> float:
        """Device seconds of the activities inside any of ``names``."""
        want = set(names)
        return self.busy_s(lambda a: not want.isdisjoint(a.ranges))


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class _Spans:
    """Per (thread, name) sorted intervals of one kind of host range."""

    def __init__(self):
        self.by = defaultdict(list)

    def add(self, thread, name, s, e):
        self.by[(thread, name)].append((s, e))

    def done(self):
        for v in self.by.values():
            v.sort()
        self.names = defaultdict(list)
        for (thread, name) in self.by:
            self.names[thread].append(name)

    def around(self, thread, t) -> set:
        """Names of the ranges of ``thread`` open at time ``t``."""
        out = set()
        for name in self.names.get(thread, ()):
            iv = self.by[(thread, name)]
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][1] >= t:
                out.add(name)
        return out


def _innermost(iv, t):
    """The innermost interval of a sorted list of nested or disjoint
    (start, end, payload) intervals open at ``t``, or None."""
    i = bisect.bisect_right(iv, (t, float("inf"))) - 1
    while i >= 0 and iv[i][1] < t:
        i -= 1
    return iv[i] if i >= 0 else None


def reduce(events, range_names) -> list:
    """Activities of a profile's raw events (``prof.profiler.
    kineto_results.events()``), with the ranges of ``range_names`` each
    belongs to."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    by_corr = {e.correlation_id(): e for e in cpu if e.correlation_id() > 0}
    spans = _Spans()
    bench = []                                  # (start, end, name), any thread
    evals = defaultdict(list)                   # thread -> (start, end, seq)
    for e in cpu:
        name, th = e.name(), e.start_thread_id()
        s, t = e.start_ns(), e.end_ns()
        if name in range_names:
            if name.startswith("bench."):
                bench.append((s, t, name))
            else:
                spans.add(th, name, s, t)
        elif name.startswith(EVAL_FN):
            evals[th].append((s, t, e.sequence_nr()))
    spans.done()
    for v in evals.values():
        v.sort()
    bench.sort()
    seq_ranges = {}
    for e in cpu:
        sq = e.sequence_nr()
        if sq >= 0 and not e.name().startswith(EVAL_FN):
            r = spans.around(e.start_thread_id(), e.start_ns())
            if r:
                seq_ranges[sq] = seq_ranges.get(sq, set()) | r
    acts = []
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        if e.name() in range_names:
            continue
        ranges, launcher = set(), "?"
        src = by_corr.get(e.linked_correlation_id())
        if src is not None:
            th, t = src.start_thread_id(), src.start_ns()
            ranges |= spans.around(th, t)
            ev = _innermost(evals.get(th, []), t)
            if ev is not None:
                ranges |= seq_ranges.get(ev[2], set())
            # the bench ranges follow one another, none inside another
            i = bisect.bisect_right(bench, (t, float("inf"), "")) - 1
            if i >= 0 and bench[i][1] >= t:
                ranges.add(bench[i][2])
            launcher = src.name()
        acts.append(Activity(e.start_ns() / 1e9, e.end_ns() / 1e9, e.name(),
                             frozenset(ranges), launcher))
    return acts


def breakdown(acts, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by the host event linked to the activity that ends each."""
    ops = defaultdict(float)
    for a in acts:
        ops[a.name] += a.end - a.start
    gaps = defaultdict(float)
    ordered = sorted(acts, key=lambda a: a.start)
    busy_to = None
    for a in ordered:
        if busy_to is not None and a.start > busy_to:
            gaps[a.launcher] += a.start - busy_to
        busy_to = a.end if busy_to is None else max(busy_to, a.end)
    pick = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": pick(ops), "idle_gaps": pick(gaps)}
