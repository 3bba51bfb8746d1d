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
=================  ================================================

The SGD and LARS updates are IN PLACE on ``p`` and ``u`` on both routes:
at the main path's width that saves a second copy of 2 x W x 478 MB.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LANE = 128
THREADS = 256
# blocks per worker for the grid-stride passes: about two waves of
# 256-thread blocks over 132 SMs in total, whatever W is
_BLOCKS_TOTAL = 2 * 132 * 8

LAUNCHES = {"fused_sgd_bucket": 0, "sq_sum": 0, "row_abs_sum": 0,
            "scale_sign_rows": 0, "lars_row_norms": 0, "fused_lars_bucket": 0}
# sq_sum's scratch per (device, stream): block partials and one zeroed
# ticket counter per worker, which picks the block that folds the worker's
# partials
_SQ_SUM_SCRATCH: dict = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _grid_x(W: int, rows: int) -> int:
    n4 = rows * (LANE // 4)
    return max(1, min(-(-n4 // THREADS), _BLOCKS_TOTAL // max(W, 1)))


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
    gx = _grid_x(W, rows)
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
    """Plain PyTorch version of :func:`fused_sgd_bucket` (same op order)."""
    W, rows = _lead_rows(p)
    lr = float(lr)
    gf = g if gscale is None else g * gscale.reshape(p.shape[:-2] + (1, 1))
    gsq = (gf * gf).sum(dim=(-2, -1)) if stats else None
    if weight_decay:
        gf = gf + (weight_decay * wd_row).reshape(rows, 1) * p
    u_new = momentum * u + gf
    step = momentum * u_new + gf if nesterov else u_new
    d = lr * step
    p.sub_(d)
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
    return (x * x).sum(dim=(-2, -1))


def _sq_sum_scratch(x, W: int, stream: int):
    """(partials pointer, their count, tickets pointer) for sq_sum on x's
    device and this stream, allocated once (again only for a larger W):
    the kernel leaves the tickets zeroed for the next call."""
    key = (x.get_device(), stream)
    got = _SQ_SUM_SCRATCH.get(key)
    if got is None or got[1].numel() < W:
        blocks = ctypes.c_int(0)
        _LIB("fb_sq_sum_blocks", ctypes.byref(blocks))
        partials = torch.empty((max(blocks.value, W),), dtype=torch.float32,
                               device=x.device)
        tickets = torch.zeros((W,), dtype=torch.int32, device=x.device)
        got = (partials, tickets)
        _SQ_SUM_SCRATCH[key] = got
    partials, tickets = got
    return partials.data_ptr(), partials.numel(), tickets.data_ptr()


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
    return x.abs().sum(dim=-1)


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
    """Plain PyTorch version of :func:`lars_row_norms` (same op order)."""
    W, rows = _lead_rows(p)
    gf = g
    if weight_decay:
        gf = gf + (weight_decay * wd_row).reshape(rows, 1) * p
    return (p * p).sum(dim=-1), (gf * gf).sum(dim=-1)


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
    """Plain PyTorch version of :func:`fused_lars_bucket` (same op order)."""
    W, rows = _lead_rows(p)
    lr = float(lr)
    gsq = (g * g).sum(dim=(-2, -1)) if stats else None
    gf = g
    if weight_decay:
        gf = gf + (weight_decay * wd_row).reshape(rows, 1) * p
    gf = gf * ratio_row.reshape(p.shape[:-1] + (1,))
    u_new = momentum * u + gf
    step = momentum * u_new + gf if nesterov else u_new
    d = lr * step
    p.sub_(d)
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
