"""The four flat-bus bucket kernels: wrappers, plain versions, launch counts.

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
=================  ================================================

The SGD update is IN PLACE on ``p`` and ``u`` on both routes: at the
main path's width that saves a second copy of 2 x W x 478 MB.
"""
from __future__ import annotations

import ctypes

import torch

LANE = 128
THREADS = 256
# blocks per worker for the grid-stride passes: about two waves of
# 256-thread blocks over 132 SMs in total, whatever W is
_BLOCKS_TOTAL = 2 * 132 * 8

LAUNCHES = {"fused_sgd_bucket": 0, "sq_sum": 0, "row_abs_sum": 0,
            "scale_sign_rows": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int64
_F = ctypes.c_float
_SIGNATURES = {
    "fb_fused_sgd": [_P, _P, _P, _P, _P, _F, _F, _F, ctypes.c_int, _I, _I,
                     ctypes.c_int, _P, _I, _P, _P],
    "fb_sq_sum": [_P, _I, _I, _P, _I, _P, _P],
    "fb_row_abs_sum": [_P, _I, _P, _P],
    "fb_scale_sign_rows": [_P, _P, _I, _I, _P, _P],
}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load("fused_bucket")
        for fn, args in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _call(fn: str, *args):
    err = getattr(_lib(), fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")


def _on_cuda(*tensors) -> bool:
    """True when every tensor is on CUDA, False when all are on the CPU;
    raises on a mix or any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"bucket kernels take all-CPU or all-CUDA tensors, got {kinds}")


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


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


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
    if not _on_cuda(p, g, u, wd_row):
        return fused_sgd_bucket_plain(p, g, u, lr, wd_row, momentum=momentum,
                                      weight_decay=weight_decay,
                                      nesterov=nesterov, gscale=gscale,
                                      stats=stats)
    for t, n in ((p, "p"), (g, "g"), (u, "u")):
        _check(t, n)
    if not (p.shape == g.shape == u.shape):
        raise ValueError(f"p, g, u shapes differ: {p.shape}, {g.shape}, {u.shape}")
    W, rows = _lead_rows(p)
    wd_row = wd_row.reshape(-1)
    if wd_row.numel() != rows or wd_row.dtype != torch.float32 \
            or not wd_row.is_contiguous():
        raise ValueError(f"wd_row: ({rows},) contiguous f32 expected")
    if gscale is not None:
        gscale = gscale.reshape(-1)
        if gscale.numel() != W or gscale.dtype != torch.float32 \
                or gscale.device != p.device or not gscale.is_contiguous():
            raise ValueError(f"gscale: ({W},) contiguous f32 on {p.device} expected")
    gx = _grid_x(W, rows)
    partials = out = None
    if stats:
        partials = torch.empty((W, 2, gx), dtype=torch.float32, device=p.device)
        out = torch.empty((W, 2), dtype=torch.float32, device=p.device)
    _call("fb_fused_sgd", p.data_ptr(), g.data_ptr(), u.data_ptr(),
          wd_row.data_ptr(), gscale.data_ptr() if gscale is not None else None,
          float(lr), float(momentum), float(weight_decay), int(bool(nesterov)),
          W, rows, int(bool(stats)),
          partials.data_ptr() if stats else None, gx,
          out.data_ptr() if stats else None, _stream(p))
    LAUNCHES["fused_sgd_bucket"] += 1
    if stats:
        lead = p.shape[:-2]
        return out[:, 0].reshape(lead), out[:, 1].reshape(lead)
    return None


# ---------------------------------------------------------------------------
# sum of squares
# ---------------------------------------------------------------------------

def sq_sum_plain(x):
    return (x * x).sum(dim=(-2, -1))


def sq_sum(x):
    """sum(x^2) per worker of a (*lead, rows, 128) bucket -> ``lead``-shaped
    f32 (a scalar for a single bucket)."""
    if not _on_cuda(x):
        return sq_sum_plain(x)
    _check(x, "x")
    W, rows = _lead_rows(x)
    gx = _grid_x(W, rows)
    partials = torch.empty((W, gx), dtype=torch.float32, device=x.device)
    out = torch.empty((W,), dtype=torch.float32, device=x.device)
    _call("fb_sq_sum", x.data_ptr(), W, rows, partials.data_ptr(), gx,
          out.data_ptr(), _stream(x))
    LAUNCHES["sq_sum"] += 1
    return out.reshape(x.shape[:-2])


# ---------------------------------------------------------------------------
# per-row |x| sums
# ---------------------------------------------------------------------------

def row_abs_sum_plain(x):
    return x.abs().sum(dim=-1)


def row_abs_sum(x):
    """Per-row sum |x| of a (*lead, rows, 128) bucket -> (*lead, rows) f32."""
    if not _on_cuda(x):
        return row_abs_sum_plain(x)
    _check(x, "x")
    W, rows = _lead_rows(x)
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    _call("fb_row_abs_sum", x.data_ptr(), W * rows, out.data_ptr(), _stream(x))
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
    if not _on_cuda(x, scale_row):
        return scale_sign_rows_plain(x, scale_row)
    _check(x, "x")
    W, rows = _lead_rows(x)
    scale_row = scale_row.reshape(-1)
    if scale_row.numel() != rows or scale_row.dtype != torch.float32 \
            or not scale_row.is_contiguous():
        raise ValueError(f"scale_row: ({rows},) contiguous f32 expected")
    y = torch.empty_like(x)
    _call("fb_scale_sign_rows", x.data_ptr(), scale_row.data_ptr(), W * rows,
          rows, y.data_ptr(), _stream(x))
    LAUNCHES["scale_sign_rows"] += 1
    return y
