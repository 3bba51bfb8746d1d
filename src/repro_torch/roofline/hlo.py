"""Collective and op census (the port of ``repro.roofline.hlo``).

The reference parses XLA HLO text; the GPU counterpart of that text is a
``torch.profiler`` trace.  :func:`parse_collectives` reads its c10d
records (``c10d::allreduce_``, ``c10d::_allgather_base_``,
``c10d::broadcast_``, ``c10d::send``, ...) with the input dims and dtype
that the backend's record of the same call carries (``gloo:all_reduce``,
``nccl:...``: the c10d record of a tensor-list op carries none), counts
each call once, and applies the standard ring-algorithm per-device byte
costs to its result:

    all-reduce          2 (N-1)/N * bytes
    all-gather            (N-1)/N * bytes      (result = gathered shape)
    reduce-scatter        (N-1)   * bytes      (result = shard shape)
    all-to-all            (N-1)/N * bytes
    collective-permute              bytes      (send; broadcast, gather)

A receive is the other end of a send, which its sender counts: receives
are left out.  Each op also keeps the bytes this rank handed to the call
(``handed_bytes``: its input), the definition
``backend.collectives.Collectives`` counts by.

:func:`op_counts` is the counterpart of ``jaxpr_op_counts``: a
``TorchDispatchMode`` census of the aten ops one call dispatches (views
left out), with the port's kernels as leaves under their own names (the
analogue of ``counts["pallas_call"]``).
"""
from __future__ import annotations

import contextlib
import importlib
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the profiler's dtype names -> bytes an element
_DTYPE_BYTES = {
    "double": 8, "float": 4, "c10::BFloat16": 2, "c10::Half": 2,
    "long int": 8, "long": 8, "int": 4, "short int": 2, "short": 2,
    "signed char": 1, "unsigned char": 1, "bool": 1,
    "c10::complex<float>": 8, "c10::complex<double>": 16,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d op -> (ring op, the result's size in units of the handed input:
# "n" = times the group size, "1/n" = over it)
_C10D = {
    "c10d::allreduce_": ("all-reduce", "1"),
    "c10d::allreduce_coalesced_": ("all-reduce", "1"),
    "c10d::allgather_": ("all-gather", "n"),
    "c10d::_allgather_base_": ("all-gather", "n"),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", "n"),
    "c10d::reduce_scatter_": ("reduce-scatter", "1/n"),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", "1/n"),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", "1/n"),
    "c10d::alltoall_": ("all-to-all", "1"),
    "c10d::alltoall_base_": ("all-to-all", "1"),
    "c10d::send": ("collective-permute", "1"),
    "c10d::broadcast_": ("broadcast", "1"),
    "c10d::gather_": ("gather", "1"),
}
# c10d records whose payload is a receive (the sender counts it)
_SKIPPED = ("c10d::recv_", "c10d::recv_any_source_")
# the c10d ops whose own record carries the handed tensor (index)
_OWN_INPUT = {"c10d::_allgather_base_": 1, "c10d::_reduce_scatter_base_": 1}
_BACKENDS = ("gloo:", "nccl:", "ucc:", "mpi:")


@dataclass
class CollectiveOp:
    op: str
    result_bytes: int
    group_size: int
    crosses_pod: bool
    moved_bytes: float   # ring-cost per-device bytes
    handed_bytes: int = 0    # the input this rank handed to the call
    name: str = ""           # the c10d op


@dataclass
class CollectiveSummary:
    ops: list = field(default_factory=list)

    def total_bytes(self, *, cross_pod: bool | None = None) -> float:
        return float(sum(o.moved_bytes for o in self.ops
                         if cross_pod is None or o.crosses_pod == cross_pod))

    def by_op(self) -> dict:
        out: dict[str, float] = {}
        for o in self.ops:
            out[o.op] = out.get(o.op, 0.0) + o.moved_bytes
        return out

    def count(self) -> int:
        return len(self.ops)

    def handed_by_op(self) -> dict:
        """Bytes handed to each op (this rank's inputs), by ring op."""
        out: dict[str, int] = {}
        for o in self.ops:
            out[o.op] = out.get(o.op, 0) + o.handed_bytes
        return out


def _ring_bytes(op: str, result_bytes: float, n: int) -> float:
    """Per-device bytes a ring collective of ``n`` members moves for a
    result of ``result_bytes``."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if op == "all-gather":
        return (n - 1) / n * result_bytes
    if op == "reduce-scatter":
        return float(n - 1) * result_bytes
    if op == "all-to-all":
        return (n - 1) / n * result_bytes
    return float(result_bytes)  # collective-permute


def _payload_bytes(shapes, dtypes) -> int:
    """Bytes of the tensors among a record's inputs (scalars, groups and
    tensor lists without dims carry none)."""
    total = 0
    for dims, dt in zip(shapes or (), dtypes or ()):
        if dt not in _DTYPE_BYTES or not isinstance(dims, (list, tuple)):
            continue
        if dims and isinstance(dims[0], (list, tuple)):     # a tensor list
            for d in dims:
                total += _numel(d) * _DTYPE_BYTES[dt]
        elif dims:
            total += _numel(dims) * _DTYPE_BYTES[dt]
    return total


def _numel(dims) -> int:
    n = 1
    for d in dims:
        n *= int(d)
    return n


def _attrs(ev):
    """(name, start, input shapes, input dtypes) of a profiler record: a
    raw kineto event (``prof.profiler.kineto_results.events()``, whose
    dtypes every torch keeps), a ``FunctionEvent`` (``prof.events()``; its
    ``input_dtypes`` are newer than torch 2.11) or a tuple of those four."""
    if isinstance(ev, tuple):
        return ev
    if callable(getattr(ev, "name", None)):
        return ev.name(), ev.start_ns(), ev.shapes(), ev.dtypes()
    return (ev.name, ev.time_range.start, getattr(ev, "input_shapes", None),
            getattr(ev, "input_dtypes", None))


def profile_records(prof) -> list:
    """The raw records of a finished ``torch.profiler.profile``."""
    return list(prof.profiler.kineto_results.events())


def parse_collectives(events, *, group_size: int,
                      pod_size: int = 0) -> CollectiveSummary:
    """Every collective call among ``events`` (:func:`profile_records` of a
    ``torch.profiler.profile(record_shapes=True)``), once each.

    A c10d record opens a call; the payload comes from its own input
    (``_allgather_base_``, ``_reduce_scatter_base_``: the input tensor)
    or from the first backend record after it (``gloo:...``), which
    carries the handed tensors' dims and dtype.  The records carry no
    group: ``group_size`` is the group every call ran over (a
    ``Collectives`` group's size); ``pod_size`` > 0 marks a group larger
    than a pod as crossing pods."""
    recs = sorted((_attrs(e) for e in events), key=lambda a: a[1])
    summary = CollectiveSummary()
    n = max(int(group_size), 1)
    crosses = bool(pod_size) and n > pod_size
    pending = None
    for name, _start, shapes, dtypes in recs:
        if name.startswith("c10d::"):
            if name in _C10D and name in _OWN_INPUT:
                i = _OWN_INPUT[name]
                handed = _payload_bytes(shapes[i:i + 1], dtypes[i:i + 1])
                _append(summary, name, handed, n, crosses)
                pending = ("own", name)      # its backend record is consumed
            elif name in _C10D or name in _SKIPPED:
                pending = ("payload", name)
            continue
        if pending is not None and name.startswith(_BACKENDS):
            kind, c10d = pending
            pending = None
            if kind == "payload" and c10d in _C10D:
                _append(summary, c10d, _payload_bytes(shapes, dtypes), n,
                        crosses)
    return summary


def _append(summary, c10d: str, handed: int, n: int, crosses: bool):
    op, unit = _C10D[c10d]
    result = handed * n if unit == "n" else handed // n if unit == "1/n" \
        else handed
    summary.ops.append(CollectiveOp(
        op=op, result_bytes=result, group_size=n, crosses_pod=crosses,
        moved_bytes=_ring_bytes(op, result, n), handed_bytes=handed,
        name=c10d))


# ---------------------------------------------------------------------------
# Op census (dispatched aten ops; the port's kernels as leaves)
# ---------------------------------------------------------------------------

# the kernel wrappers: (module, function, the launch counter's key it
# launches under).  The per-tensor flash API's two entries launch the one
# flash kernel (``ops.flash_attention`` is the same function, bound at
# import)
KERNEL_WRAPPERS = tuple(
    ("repro_torch.kernels.fused_bucket", k, k)
    for k in ("fused_sgd_bucket", "sq_sum", "row_abs_sum", "scale_sign_rows",
              "lars_row_norms", "fused_lars_bucket", "segment_sum")) + (
    ("repro_torch.kernels.fused_sgd", "fused_sgd_2d", "fused_sgd_2d"),
    ("repro_torch.kernels.sign_compress", "abs_sum", "abs_sum"),
    ("repro_torch.kernels.sign_compress", "scale_sign", "scale_sign"),
    ("repro_torch.kernels.flash_attention", "flash_attention_bhsd",
     "flash_attention_bhsd"),
    ("repro_torch.kernels.flash_attention", "flash_attention",
     "flash_attention_bhsd"),
    ("repro_torch.kernels.ops", "flash_attention", "flash_attention_bhsd"),
)


def kernel_names() -> tuple:
    """The kernels' names (their launch counters' keys), in order."""
    return tuple(dict.fromkeys(k for _, _, k in KERNEL_WRAPPERS))


class _Census(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: dict = {}
        self.depth = 0           # > 0 inside a kernel wrapper

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.depth and not func.is_view:
            name = func.overloadpacket.__name__
            self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _kernel_leaves(census: _Census):
    """Each kernel wrapper counts one call under its kernel's name, and the
    ops inside it (the plain version on the CPU, scratch on the card)
    none."""
    saved = []

    def leaf(key, fn):
        def call(*a, **k):
            if not census.depth:
                census.counts[key] = census.counts.get(key, 0) + 1
            census.depth += 1
            try:
                return fn(*a, **k)
            finally:
                census.depth -= 1
        return call

    try:
        for mod, name, key in KERNEL_WRAPPERS:
            m = importlib.import_module(mod)
            fn = getattr(m, name)
            saved.append((m, name, fn))
            setattr(m, name, leaf(key, fn))
        yield
    finally:
        for m, name, fn in reversed(saved):
            setattr(m, name, fn)


def op_counts(fn, *args, **kwargs) -> dict:
    """Op occurrences of one call ``fn(*args, **kwargs)``, by aten op name
    (``"cat"``, ``"constant_pad_nd"``, ``"mm"``, ...; views left out),
    with each kernel wrapper a leaf under its own name (``"sq_sum"``,
    ``"fused_sgd_bucket"``, ...): on either device, one count a call,
    as the kernel launches once a call on the card.  Used by the
    resident-state census: no pack (``cat``, ``constant_pad_nd``) between
    syncs, the kernel launches a step and a sync."""
    census = _Census()
    with _kernel_leaves(census), census:
        fn(*args, **kwargs)
    return census.counts
