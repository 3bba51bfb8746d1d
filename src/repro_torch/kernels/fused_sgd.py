"""Per-tensor fused SGD: wrapper, plain version, launch count.

Counterpart of ``repro/kernels/fused_sgd.py::fused_sgd_2d``, reached
through :func:`repro_torch.kernels.ops.fused_sgd`.  One launch updates one
tensor of any shape (float32 or bfloat16); the TPU kernel's 128-lane
padding is not needed here.  On a CPU tensor the wrapper runs the plain
PyTorch version beside it; on a CUDA tensor it launches ``ps_fused_sgd``
from ``csrc/per_tensor.cu`` (built at first use, see ``build.py``) or
raises — there is no fallback.  ``LAUNCHES`` counts kernel launches; the
plain version does not count.

Unlike the bucket kernels, which update in place, this API is
functional like the reference: it returns new tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
LAUNCHES = {"fused_sgd_2d": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int64
_F = ctypes.c_float
_C = ctypes.c_int
_LIB = build.Library("per_tensor", {
    "ps_fused_sgd": [_P, _P, _P, _P, _P, _F, _P, _F, _F, _C, _I, _C, _C, _P],
})


def check_tensors(name: str, *tensors) -> bool:
    """Check same-shaped, same-dtype contiguous float32/bfloat16 tensors;
    returns whether every pointer allows 4-element vector access."""
    t0 = tensors[0]
    for t in tensors:
        if t.dtype not in DTYPES or t.dtype != t0.dtype:
            raise TypeError(f"{name}: float32 or bfloat16 tensors of one dtype "
                            f"expected, got {[t.dtype for t in tensors]}")
        if t.shape != t0.shape or not t.is_contiguous():
            raise ValueError(f"{name}: contiguous tensors of one shape expected, "
                             f"got {[tuple(t.shape) for t in tensors]}")
    return all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)


def fused_sgd_2d_plain(p, g, u, lr, *, momentum: float, weight_decay: float,
                       nesterov: bool):
    """Plain PyTorch version of :func:`fused_sgd_2d` (same op order, f32)."""
    pf, gf, uf = p.float(), g.float(), u.float()
    if weight_decay:
        gf = gf + weight_decay * pf
    u_new = momentum * uf + gf
    step = momentum * u_new + gf if nesterov else u_new
    return (pf - lr * step).to(p.dtype), u_new.to(u.dtype)


def fused_sgd_2d(p, g, u, lr, *, momentum: float, weight_decay: float,
                 nesterov: bool):
    """One fused SGD update of one tensor; returns NEW (p', u').

    ``g' = g + wd * p``; ``u' = momentum * u + g'``;
    ``p' = p - lr * (momentum * u' + g')`` (Nesterov) or ``p - lr * u'``,
    in float32, written in p's and u's dtype.  ``lr`` is a host float or a
    0-d float32 tensor on p's device, which the kernel reads there (a
    schedule on the device costs no host read-back).
    """
    lr_dev = isinstance(lr, torch.Tensor) and lr.device.type == "cuda"
    if not build.on_cuda(p, g, u, *([lr] if lr_dev else [])):
        return fused_sgd_2d_plain(p, g, u, lr, momentum=momentum,
                                  weight_decay=weight_decay, nesterov=nesterov)
    vec = check_tensors("fused_sgd_2d", p, g, u)
    if lr_dev and (lr.numel() != 1 or lr.dtype != torch.float32
                   or lr.device != p.device):
        raise ValueError("fused_sgd_2d: lr must be a float or a one-element "
                         "float32 tensor on p's device")
    po, uo = torch.empty_like(p), torch.empty_like(u)
    if p.numel():
        _LIB("ps_fused_sgd", p.data_ptr(), g.data_ptr(), u.data_ptr(),
             po.data_ptr(), uo.data_ptr(), 0.0 if lr_dev else float(lr),
             lr.data_ptr() if lr_dev else None, float(momentum),
             float(weight_decay), int(bool(nesterov)), p.numel(),
             int(p.dtype == torch.bfloat16), int(vec), build.stream(p))
        LAUNCHES["fused_sgd_2d"] += 1
    return po, uo
