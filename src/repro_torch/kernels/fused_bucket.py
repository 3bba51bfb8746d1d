"""The six flat-bus bucket kernels: wrappers, plain versions, launch counts.

Each wrapper takes float32 bucket tensors of shape ``(*lead, rows, 128)``
(``lead`` is ``()`` or the worker dim ``(W,)``).  On a CPU tensor it runs
the plain PyTorch version beside it; on a CUDA tensor it launches the
CUDA kernel from ``csrc/fused_bucket.cu`` (built at first use, see
``build.py``) or raises — there is no fallback.  ``LAUNCHES`` counts the
kernel launches per wrapper; the plain versions do not count.

=================  ================================================
wrapper            replaces (JAX package, Pallas TPU kernel)
=================  ================================================
fused_sgd_bucket   repro/kernels/fused_bucket.py::fused_sgd_bucket_2d
sq_sum             repro/kernels/fused_bucket.py::sq_sum_2d
row_abs_sum        repro/kernels/fused_bucket.py::row_abs_sum_2d
scale_sign_rows    repro/kernels/fused_bucket.py::scale_sign_rows_2d
lars_row_norms     repro/kernels/fused_bucket.py::lars_row_norms_2d
fused_lars_bucket  repro/kernels/fused_bucket.py::fused_lars_bucket_2d
segment_sum        (no TPU kernel: ``jax.ops.segment_sum`` of the
                   per-leaf totals, outside any Pallas kernel)
=================  ================================================

``segment_sum`` is the port's own kernel: a segmented sum whose adds run
one after another in row order, as the CPU's ``index_add_`` and XLA's
scatter run them, without atomics, so the compressor's and the wire
pack's per-leaf scales and LARS's layer norms take the CPU's bits, and
the same bits in every run, in one process and across ranks.  Its launches count in ``PORT_LAUNCHES``, apart
from the six ports of the TPU kernels in ``LAUNCHES``.

The SGD and LARS updates are IN PLACE on ``p`` and ``u`` on both routes:
at the main path's width that saves a second copy of 2 x W x 478 MB.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

LANE = 128
THREADS = 256
# blocks per worker for the grid-stride passes with stats: about two waves
# of 256-thread blocks over 132 SMs at the main path's W = 4.  The count is
# fixed by the rows alone, never by W, so a rank that holds W / P workers
# adds each worker's partials in the one-process run's order (same bits)
_BLOCKS_PER_WORKER = 2 * 132 * 8 // 4
# sq_sum's blocks per worker: the card's fb_sq_sum_blocks() total (4 an SM)
# shared by this many workers, whatever W is, for the same reason
_SQ_SUM_WORKERS_PER_GRID = 4

LAUNCHES = {"fused_sgd_bucket": 0, "sq_sum": 0, "row_abs_sum": 0,
            "scale_sign_rows": 0, "lars_row_norms": 0, "fused_lars_bucket": 0}
PORT_LAUNCHES = {"segment_sum": 0}
# sq_sum's scratch per (device, stream): block partials and one zeroed
# ticket counter per worker, which picks the block that folds the worker's
# partials
_SQ_SUM_SCRATCH: dict = {}


def reset_launches():
    for d in (LAUNCHES, PORT_LAUNCHES):
        for k in d:
            d[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int64
_F = ctypes.c_float
_LIB = build.Library("fused_bucket", {
    "fb_fused_sgd": [_P, _P, _P, _P, _P, _F, _F, _F, ctypes.c_int, _I, _I,
                     ctypes.c_int, _P, _I, _P, _P],
    "fb_sq_sum_blocks": [_P],
    "fb_sq_sum": [_P, _I, _I, _P, _I, _P, _P, _P],
    "fb_row_abs_sum": [_P, _I, _P, _P],
    "fb_scale_sign_rows": [_P, _P, _I, _I, _P, _P],
    "fb_lars_row_norms": [_P, _P, _P, _F, _I, _I, _P, _P, _P],
    "fb_fused_lars": [_P, _P, _P, _P, _P, _F, _F, _F, ctypes.c_int, _I, _I,
                      ctypes.c_int, _P, _I, _P, _P],
    "fb_segment_sum": [_P, _I, _I, _P, _P, _P, _P, _I, _P, ctypes.c_int,
                       _P, _P],
    "fb_fadd_chain": [_F, _F, _I, _P, _P],
})


def _check(x: torch.Tensor, name: str):
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 bucket expected, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != LANE:
        raise ValueError(f"{name}: (*lead, rows, {LANE}) bucket expected, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: contiguous, 16-byte aligned bucket expected")


def _lead_rows(x: torch.Tensor) -> tuple[int, int]:
    """(W, rows) of a (*lead, rows, 128) bucket; W = prod(lead)."""
    W = 1
    for d in x.shape[:-2]:
        W *= int(d)
    return W, int(x.shape[-2])


def _grid_x(rows: int) -> int:
    n4 = rows * (LANE // 4)
    return max(1, min(-(-n4 // THREADS), _BLOCKS_PER_WORKER))


def _check_same(**buckets) -> tuple[int, int]:
    """Check equal-shaped (*lead, rows, 128) f32 buckets; (W, rows)."""
    for name, t in buckets.items():
        _check(t, name)
    shapes = {n: tuple(t.shape) for n, t in buckets.items()}
    if len(set(shapes.values())) != 1:
        raise ValueError(f"bucket shapes differ: {shapes}")
    return _lead_rows(next(iter(buckets.values())))


def _row_vector(v: torch.Tensor, n: int, name: str, device=None) -> torch.Tensor:
    """``v`` flattened to a contiguous (n,) f32 vector (on ``device`` if
    given), or raise."""
    v = v.reshape(-1)
    if v.numel() != n or v.dtype != torch.float32 or not v.is_contiguous() \
            or (device is not None and v.device != device):
        raise ValueError(f"{name}: ({n},) contiguous f32 on "
                         f"{device or 'the same device'} expected")
    return v


def _stats_scratch(p: torch.Tensor, W: int, rows: int, stats: bool):
    """(partials, out, grid_x) for an update launch; None scratch without
    stats."""
    gx = _grid_x(rows)
    if not stats:
        return None, None, gx
    return (torch.empty((W, 2, gx), dtype=torch.float32, device=p.device),
            torch.empty((W, 2), dtype=torch.float32, device=p.device), gx)


def _stats_out(p: torch.Tensor, out):
    """The per-worker (sum g^2, sum (lr*step)^2) pair, each ``lead``-shaped,
    or None without stats."""
    if out is None:
        return None
    lead = p.shape[:-2]
    return out[:, 0].reshape(lead), out[:, 1].reshape(lead)


# ---------------------------------------------------------------------------
# fused SGD
# ---------------------------------------------------------------------------

def fused_sgd_bucket_plain(p, g, u, lr, wd_row, *, momentum: float,
                           weight_decay: float, nesterov: bool, gscale=None,
                           stats: bool = False):
    """Plain PyTorch version of :func:`fused_sgd_bucket` (same op order; in
    float32, p and u rounded once to their dtype, as the reference's kernel
    does for a bfloat16 bucket)."""
    W, rows = _lead_rows(p)
    lr = float(lr)
    pf, gf, uf = p.float(), g.float(), u.float()
    if gscale is not None:
        gf = gf * gscale.reshape(p.shape[:-2] + (1, 1))
    gsq = (gf * gf).sum(dim=(-2, -1)) if stats else None
    if weight_decay:
        gf = gf + (weight_decay * wd_row).reshape(rows, 1) * pf
    u_new = momentum * uf + gf
    step = momentum * u_new + gf if nesterov else u_new
    d = lr * step
    p.copy_(pf - d)
    u.copy_(u_new)
    if stats:
        return gsq, (d * d).sum(dim=(-2, -1))
    return None


def fused_sgd_bucket(p, g, u, lr, wd_row, *, momentum: float,
                     weight_decay: float, nesterov: bool, gscale=None,
                     stats: bool = False):
    """One fused SGD launch over a whole bucket, IN PLACE on p and u.

    ``g += wd * wd_row[row] * p``; ``u' = momentum * u + g``;
    ``p' = p - lr * (momentum * u' + g)`` (Nesterov) or ``p - lr * u'``.
    ``lr`` is a host float; ``wd_row`` the (rows,) or (rows, 1) f32
    decay mask; ``gscale`` an optional per-worker (``lead``-shaped) grad
    multiplier applied before everything else (the grad clip).  With
    ``stats`` returns ``(sum g^2, sum (lr*step)^2)`` per worker, each of
    shape ``lead``, g after the clip scale and before decay.
    """
    if not build.on_cuda(p, g, u, wd_row):
        return fused_sgd_bucket_plain(p, g, u, lr, wd_row, momentum=momentum,
                                      weight_decay=weight_decay,
                                      nesterov=nesterov, gscale=gscale,
                                      stats=stats)
    W, rows = _check_same(p=p, g=g, u=u)
    wd_row = _row_vector(wd_row, rows, "wd_row")
    if gscale is not None:
        gscale = _row_vector(gscale, W, "gscale", p.device)
    partials, out, gx = _stats_scratch(p, W, rows, stats)
    _LIB("fb_fused_sgd", p.data_ptr(), g.data_ptr(), u.data_ptr(),
          wd_row.data_ptr(), gscale.data_ptr() if gscale is not None else None,
          float(lr), float(momentum), float(weight_decay), int(bool(nesterov)),
          W, rows, int(bool(stats)),
          partials.data_ptr() if stats else None, gx,
          out.data_ptr() if stats else None, build.stream(p))
    LAUNCHES["fused_sgd_bucket"] += 1
    return _stats_out(p, out)


# ---------------------------------------------------------------------------
# sum of squares
# ---------------------------------------------------------------------------

def sq_sum_plain(x):
    xf = x.float()
    return (xf * xf).sum(dim=(-2, -1))


def _sq_sum_scratch(x, W: int, stream: int):
    """(partials pointer, the most blocks of W workers, tickets pointer) for
    sq_sum on x's device and this stream, allocated once (again only for a
    larger W): the kernel leaves the tickets zeroed for the next call.
    Each worker gets at most the same number of blocks whatever W is, so
    its partials, and the bits of its sum, depend on its rows alone."""
    key = (x.get_device(), stream)
    got = _SQ_SUM_SCRATCH.get(key)
    if got is None or got[1].numel() < W:
        blocks = ctypes.c_int(0)
        _LIB("fb_sq_sum_blocks", ctypes.byref(blocks))
        per = max(blocks.value // _SQ_SUM_WORKERS_PER_GRID, 1)
        partials = torch.empty((W * per,), dtype=torch.float32,
                               device=x.device)
        tickets = torch.zeros((W,), dtype=torch.int32, device=x.device)
        got = (partials, tickets)
        _SQ_SUM_SCRATCH[key] = got
    partials, tickets = got
    per = partials.numel() // tickets.numel()
    return partials.data_ptr(), W * per, tickets.data_ptr()


def sq_sum(x):
    """sum(x^2) per worker of a (*lead, rows, 128) bucket -> ``lead``-shaped
    f32 (a scalar for a single bucket).

    On the card: one launch; each worker's block partials are folded in
    block order by its last block to finish, no atomics in the sum, so two
    runs on the same input give the same bits."""
    if not build.on_cuda(x):
        return sq_sum_plain(x)
    _check(x, "x")
    W, rows = _lead_rows(x)
    st = build.stream(x)
    part_ptr, n_part, ticket_ptr = _sq_sum_scratch(x, W, st)
    out = torch.empty((W,), dtype=torch.float32, device=x.device)
    _LIB("fb_sq_sum", x.data_ptr(), W, rows, part_ptr, n_part, ticket_ptr,
         out.data_ptr(), st)
    LAUNCHES["sq_sum"] += 1
    return out.reshape(x.shape[:-2])


# ---------------------------------------------------------------------------
# per-row |x| sums
# ---------------------------------------------------------------------------

def row_abs_sum_plain(x):
    return x.float().abs().sum(dim=-1)


def row_abs_sum(x):
    """Per-row sum |x| of a (*lead, rows, 128) bucket -> (*lead, rows) f32."""
    if not build.on_cuda(x):
        return row_abs_sum_plain(x)
    _check(x, "x")
    W, rows = _lead_rows(x)
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    _LIB("fb_row_abs_sum", x.data_ptr(), W * rows, out.data_ptr(), build.stream(x))
    LAUNCHES["row_abs_sum"] += 1
    return out


# ---------------------------------------------------------------------------
# scaled sign
# ---------------------------------------------------------------------------

def scale_sign_rows_plain(x, scale_row):
    return torch.sign(x) * scale_row.reshape(-1, 1)


def scale_sign_rows(x, scale_row):
    """``sign(x) * scale_row[row]`` with sign(0) = 0: x (*lead, rows, 128),
    scale_row (rows,) shared by every leading index -> f32 like x."""
    if not build.on_cuda(x, scale_row):
        return scale_sign_rows_plain(x, scale_row)
    _check(x, "x")
    W, rows = _lead_rows(x)
    scale_row = scale_row.reshape(-1)
    if scale_row.numel() != rows or scale_row.dtype != torch.float32 \
            or not scale_row.is_contiguous():
        raise ValueError(f"scale_row: ({rows},) contiguous f32 expected")
    y = torch.empty_like(x)
    _LIB("fb_scale_sign_rows", x.data_ptr(), scale_row.data_ptr(), W * rows,
          rows, y.data_ptr(), build.stream(x))
    LAUNCHES["scale_sign_rows"] += 1
    return y


# ---------------------------------------------------------------------------
# LARS: per-row norms and the fused update
# ---------------------------------------------------------------------------

def lars_row_norms_plain(p, g, wd_row, *, weight_decay: float):
    """Plain PyTorch version of :func:`lars_row_norms` (same op order, in
    float32)."""
    W, rows = _lead_rows(p)
    pf, gf = p.float(), g.float()
    if weight_decay:
        gf = gf + (weight_decay * wd_row).reshape(rows, 1) * pf
    return (pf * pf).sum(dim=-1), (gf * gf).sum(dim=-1)


def lars_row_norms(p, g, wd_row, *, weight_decay: float):
    """Per-row sum p^2 and sum (g + wd * wd_row[row] * p)^2 of
    (*lead, rows, 128) buckets in one pass -> two (*lead, rows) f32."""
    if not build.on_cuda(p, g, wd_row):
        return lars_row_norms_plain(p, g, wd_row, weight_decay=weight_decay)
    W, rows = _check_same(p=p, g=g)
    wd_row = _row_vector(wd_row, rows, "wd_row")
    pn = torch.empty(p.shape[:-1], dtype=torch.float32, device=p.device)
    gn = torch.empty_like(pn)
    _LIB("fb_lars_row_norms", p.data_ptr(), g.data_ptr(), wd_row.data_ptr(),
          float(weight_decay), W, rows, pn.data_ptr(), gn.data_ptr(), build.stream(p))
    LAUNCHES["lars_row_norms"] += 1
    return pn, gn


def fused_lars_bucket_plain(p, g, u, lr, wd_row, ratio_row, *, momentum: float,
                            weight_decay: float, nesterov: bool,
                            stats: bool = False):
    """Plain PyTorch version of :func:`fused_lars_bucket` (same op order; in
    float32, p and u rounded once to their dtype)."""
    W, rows = _lead_rows(p)
    lr = float(lr)
    pf, gf, uf = p.float(), g.float(), u.float()
    gsq = (gf * gf).sum(dim=(-2, -1)) if stats else None
    if weight_decay:
        gf = gf + (weight_decay * wd_row).reshape(rows, 1) * pf
    gf = gf * ratio_row.reshape(p.shape[:-1] + (1,))
    u_new = momentum * uf + gf
    step = momentum * u_new + gf if nesterov else u_new
    d = lr * step
    p.copy_(pf - d)
    u.copy_(u_new)
    if stats:
        return gsq, (d * d).sum(dim=(-2, -1))
    return None


def fused_lars_bucket(p, g, u, lr, wd_row, ratio_row, *, momentum: float,
                      weight_decay: float, nesterov: bool,
                      stats: bool = False):
    """One fused LARS launch over a whole bucket, IN PLACE on p and u.

    ``g += wd * wd_row[row] * p``; ``g *= ratio_row[..., row]``; then the
    momentum update of :func:`fused_sgd_bucket`.  ``ratio_row`` is the
    (*lead, rows) per-worker, per-row trust ratio (1.0 on rows of leaves
    that take the plain LR); ``wd_row`` the (rows,) decay mask shared by
    every worker.  With ``stats`` returns ``(sum g^2, sum (lr*step)^2)``
    per worker, g raw (before decay and ratio).
    """
    if not build.on_cuda(p, g, u, wd_row, ratio_row):
        return fused_lars_bucket_plain(p, g, u, lr, wd_row, ratio_row,
                                       momentum=momentum,
                                       weight_decay=weight_decay,
                                       nesterov=nesterov, stats=stats)
    W, rows = _check_same(p=p, g=g, u=u)
    wd_row = _row_vector(wd_row, rows, "wd_row")
    ratio_row = _row_vector(ratio_row, W * rows, "ratio_row")
    partials, out, gx = _stats_scratch(p, W, rows, stats)
    _LIB("fb_fused_lars", p.data_ptr(), g.data_ptr(), u.data_ptr(),
          wd_row.data_ptr(), ratio_row.data_ptr(), float(lr), float(momentum),
          float(weight_decay), int(bool(nesterov)), W, rows, int(bool(stats)),
          partials.data_ptr() if stats else None, gx,
          out.data_ptr() if stats else None, build.stream(p))
    LAUNCHES["fused_lars_bucket"] += 1
    return _stats_out(p, out)


# ---------------------------------------------------------------------------
# segmented sums in a fixed order (the port's own kernel)
# ---------------------------------------------------------------------------

class SegmentIndex(NamedTuple):
    """A row -> segment map, as :func:`segment_sum` reads it.

    Segment s holds ``offsets[s + 1] - offsets[s]`` rows, listed in row
    order as the (start row, length) ranges ``runs[run_offsets[s] :
    run_offsets[s + 1]]``; ``by_length`` lists the segments longest
    first.  All int64."""
    seg_ids: torch.Tensor
    offsets: torch.Tensor
    runs: torch.Tensor
    run_offsets: torch.Tensor
    by_length: torch.Tensor

    def to(self, device) -> "SegmentIndex":
        return SegmentIndex(*(t.to(device) for t in self))


def segment_index(seg_ids: torch.Tensor, num_segments: int) -> SegmentIndex:
    """The :class:`SegmentIndex` of a row -> segment map, on its device.  A
    leaf of a bucket is one row range, so its rows are one run; a random
    map has about a run a row.  Build it once per map: it synchronizes
    with the device."""
    seg = seg_ids.reshape(-1).long()
    order = torch.sort(seg, stable=True).indices       # segment by segment
    counts = torch.bincount(seg, minlength=num_segments)
    offsets = torch.zeros((num_segments + 1,), dtype=torch.int64,
                          device=seg.device)
    offsets[1:] = torch.cumsum(counts, 0)
    # a run starts where the row is not the one after the previous row,
    # and at each segment's first row
    starts = torch.ones_like(order, dtype=torch.bool)
    starts[1:] = order[1:] != order[:-1] + 1
    starts[offsets[:-1][counts > 0]] = True
    at = torch.nonzero(starts).reshape(-1)
    lengths = torch.diff(at, append=offsets[-1:])
    runs = torch.stack([order[at], lengths], dim=1).contiguous()
    run_offsets = torch.searchsorted(at, offsets)
    by_length = torch.sort(counts, descending=True, stable=True).indices
    return SegmentIndex(seg, offsets, runs, run_offsets, by_length)


def segment_sum_plain(vals, seg_ids, num_segments: int, *,
                      chain: bool = False, init=None):
    """Plain PyTorch version of :func:`segment_sum`: ``index_add_`` on the
    host, whose adds run one after another in index order (on the card
    they are atomic), back on ``vals``' device."""
    L = vals.shape[0]
    v = vals.detach().cpu().reshape(-1)
    seg = seg_ids.detach().cpu().reshape(-1).long()
    if chain:
        acc = (init.detach().cpu().clone() if init is not None else
               torch.zeros((num_segments,), dtype=torch.float32))
        out = acc.index_add_(0, seg.repeat(L), v)
    else:
        ids = (seg[None] + num_segments * torch.arange(L)[:, None]).reshape(-1)
        out = torch.zeros((L * num_segments,), dtype=torch.float32)
        out = out.index_add_(0, ids, v).reshape(L, num_segments)
    return out.to(vals.device)


def segment_sum(vals, index: SegmentIndex, *, chain: bool = False,
                init=None):
    """Per-segment sums of the rows of ``vals`` (L, rows) f32, the segments
    given by ``index`` (:func:`segment_index`): (L, num_segments) f32, or
    with ``chain`` (num_segments,), the L leading rows added one after
    another onto ``init`` (num_segments,) or 0 -- a total over all workers
    in worker order.

    Every total is added one value after another in row order, as the
    CPU's ``index_add_`` (the plain version) adds it.  On the card: one
    launch, a block per (segment, leading row) or per chained segment
    streaming the segment's runs through shared memory to one thread's
    chain of adds, no atomics: the plain version's bits, in every run."""
    n_seg = index.offsets.numel() - 1
    if not build.on_cuda(vals, *index, *(() if init is None else (init,))):
        return segment_sum_plain(vals, index.seg_ids, n_seg, chain=chain,
                                 init=init)
    if vals.dtype != torch.float32 or vals.dim() != 2 \
            or not vals.is_contiguous():
        raise ValueError(f"vals: contiguous (L, rows) f32 expected, got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    L, rows = vals.shape
    runs, run_offsets, offsets, by_length = (
        index.runs, index.run_offsets, index.offsets, index.by_length)
    if any(t.dtype != torch.int64 or not t.is_contiguous()
           for t in (runs, run_offsets, offsets, by_length)) \
            or index.seg_ids.numel() != rows or runs.dim() != 2 \
            or runs.shape[1] != 2 or run_offsets.numel() != n_seg + 1 \
            or by_length.numel() != n_seg or n_seg * L >= 2 ** 31:
        raise ValueError(f"a SegmentIndex of {rows} rows (contiguous int64 "
                         f"runs (n, 2), run_offsets, offsets, by_length) "
                         f"expected, got runs {tuple(runs.shape)}, offsets "
                         f"{tuple(offsets.shape)}, L={L}")
    if init is not None:
        init = _row_vector(init, n_seg, "init", vals.device)
    out = torch.empty((n_seg,) if chain else (L, n_seg), dtype=torch.float32,
                      device=vals.device)
    _LIB("fb_segment_sum", vals.data_ptr(), L, rows, runs.data_ptr(),
         run_offsets.data_ptr(), offsets.data_ptr(), by_length.data_ptr(),
         n_seg, init.data_ptr() if init is not None else None,
         int(bool(chain)), out.data_ptr(), build.stream(vals))
    PORT_LAUNCHES["segment_sum"] += 1
    return out


def fadd_chain_s_per_add(n_adds: int = 1 << 22, reps: int = 5,
                         device="cuda") -> float:
    """Seconds one dependent ``__fadd_rn`` takes on the card: one thread
    adding ``n_adds`` (a multiple of 16) values one after another, timed
    with CUDA events, the median of ``reps`` launches.  The segmented
    sum's chain bound is its longest chain's adds times this.  A probe,
    not a kernel of any path: it counts no launch."""
    if n_adds % 16 or n_adds < 16:
        raise ValueError(f"n_adds: a positive multiple of 16, got {n_adds}")
    out = torch.empty((1,), dtype=torch.float32, device=device)
    if not out.is_cuda:
        raise ValueError("the chain probe times the card: a CUDA device "
                         f"expected, got {out.device}")
    launch = lambda: _LIB("fb_fadd_chain", 1.0, 1e-7, n_adds, out.data_ptr(),
                          build.stream(out))
    launch()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / n_adds)
    if not torch.isfinite(out).all():
        raise RuntimeError(f"the chain probe's total is not finite: {out}")
    return sorted(times)[len(times) // 2]
