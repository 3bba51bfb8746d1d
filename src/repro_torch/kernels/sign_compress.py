"""Per-tensor sign compressor kernels: wrappers, plain versions, launch counts.

Counterparts of ``repro/kernels/sign_compress.py::abs_sum_2d`` and
``scale_sign_2d``, reached through
:func:`repro_torch.kernels.ops.sign_compress` (``sign(x) * mean|x|``, the
paper's Alg. 3/4 compressor on one tensor).  Each takes one float32 or
bfloat16 tensor of any shape.  On a CPU tensor a wrapper runs the plain
PyTorch version beside it; on a CUDA tensor it launches its kernel from
``csrc/per_tensor.cu`` or raises — there is no fallback.  ``LAUNCHES``
counts kernel launches; the plain versions do not count.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_sgd import check_tensors

LAUNCHES = {"abs_sum": 0, "scale_sign": 0}
# abs_sum's scratch per (device, stream): block partials and the zeroed
# ticket counter that picks the block which folds them
_ABS_SUM_SCRATCH: dict = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int64
_C = ctypes.c_int
_LIB = build.Library("per_tensor", {
    "ps_abs_sum_blocks": [_P],
    "ps_abs_sum": [_P, _I, _C, _P, _I, _P, _P, _P],
    "ps_scale_sign": [_P, _P, _I, _C, _C, _P, _P],
})


def abs_sum_plain(x):
    return x.float().abs().sum()


def _abs_sum_scratch(x, stream: int):
    """(partials pointer, their count, ticket pointer) for abs_sum on x's
    device and this stream, allocated once: the kernel leaves the ticket
    zeroed for the next call."""
    key = (x.get_device(), stream)
    got = _ABS_SUM_SCRATCH.get(key)
    if got is None:
        blocks = ctypes.c_int(0)
        _LIB("ps_abs_sum_blocks", ctypes.byref(blocks))
        partials = torch.empty((blocks.value,), dtype=torch.float32, device=x.device)
        ticket = torch.zeros((1,), dtype=torch.int32, device=x.device)
        got = (partials, ticket, partials.data_ptr(), blocks.value, ticket.data_ptr())
        _ABS_SUM_SCRATCH[key] = got
    return got[2:]


def abs_sum(x):
    """sum |x| over the whole tensor -> 0-d float32 on x's device.

    On the card: one launch; block partials folded in block order by the
    last block to finish, no atomics in the sum, so two runs on the same
    input give the same bits."""
    if not build.on_cuda(x):
        return abs_sum_plain(x)
    check_tensors("abs_sum", x)
    st = build.stream(x)
    part_ptr, blocks, ticket_ptr = _abs_sum_scratch(x, st)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    _LIB("ps_abs_sum", x.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
         part_ptr, blocks, ticket_ptr, out.data_ptr(), st)
    LAUNCHES["abs_sum"] += 1
    return out


def scale_sign_plain(x, s):
    return torch.sign(x.float()) * s


def scale_sign(x, s):
    """``sign(x) * s`` as float32 whatever x's dtype, sign(0) = 0.  ``s``
    is a one-element float32 tensor on x's device, read by the kernel
    there (no host read-back between the two launches of a compressor)."""
    if not build.on_cuda(x, s):
        return scale_sign_plain(x, s)
    vec = check_tensors("scale_sign", x)
    if s.numel() != 1 or s.dtype != torch.float32 or s.device != x.device:
        raise ValueError("scale_sign: s must be a one-element float32 tensor "
                         "on x's device")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.numel():
        _LIB("ps_scale_sign", x.data_ptr(), s.data_ptr(), x.numel(),
             int(x.dtype == torch.bfloat16), int(vec), y.data_ptr(),
             build.stream(x))
        LAUNCHES["scale_sign"] += 1
    return y
