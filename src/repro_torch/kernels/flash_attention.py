"""Flash attention forward: wrappers, plain version, launch count.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention_bhsd``,
reached through :func:`repro_torch.kernels.ops.flash_attention`.  On CPU
tensors a wrapper runs the plain PyTorch version; on CUDA tensors it
launches ``fa_forward`` from ``csrc/flash_attention.cu`` or raises — there
is no fallback.  ``LAUNCHES`` counts kernel launches; the plain version
does not count.

The function is the reference's: ``softmax(q k^T * scale) v`` with
``scale or 1/sqrt(D)``, a causal mask ``k_pos <= q_pos``, a window mask
``q_pos - k_pos < window`` (applied with or without causal), query
positions aligned to the START of the keys (``q_pos`` is the query's row,
so for Sq != Sk this is not ``reference_attention``'s end-aligned
convention), masked scores at ``NEG_INF = -1e30``, f32 arithmetic and the
output in q's dtype.  A row with no unmasked key (a window with Sq > Sk)
is degenerate: the reference kernel, like this one, gives the mean of
the values in the tiles it visited, the plain version the mean over all
keys; no caller relies on it.  ``block_q`` / ``block_k``
are accepted for the reference's signature; the result does not depend
on them, and the kernel picks its own tiles from the dtype and D.  On
the card it computes in 3xTF32 (f32) or with bf16 products and p split
into two bf16 parts (bf16): f32 accuracy on the tensor cores.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
LAUNCHES = {"flash_attention_bhsd": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P = ctypes.c_void_p
_I = ctypes.c_int64
_C = ctypes.c_int
_LIB = build.Library("flash_attention", {
    "fa_forward": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                   _C, _I, _C, _P],
})


def band_mask(Sq: int, Sk: int, *, causal: bool, window: int, device=None):
    """(Sq, Sk) bool: True where query row i may attend to key j, with
    query positions aligned to the start of the keys."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= qp - kp < window
    return mask


def flash_attention_bhsd_plain(q, k, v, *, causal: bool = True,
                               window: int = 0, scale: float = 0.0):
    """Plain PyTorch version of :func:`flash_attention_bhsd`: the dense
    masked softmax in f32."""
    D = q.shape[-1]
    scale = scale or 1.0 / math.sqrt(D)
    s = torch.einsum("bqd,bkd->bqk", q.float() * scale, k.float())
    mask = band_mask(q.shape[1], k.shape[1], causal=causal, window=window,
                     device=q.device)
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _check(q, k, v):
    """Validate (B, S, heads, D) views for the kernel; returns (B, Sq, H,
    KH, Sk, D)."""
    for t in (q, k, v):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash attention: float32 or bfloat16 q, k, v of "
                            f"one dtype expected, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {D} is not one the kernel "
                         f"takes {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or H % KH:
        raise ValueError(f"flash attention: q {tuple(q.shape)} with k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (heads a "
                         f"multiple of kv heads) expected")
    return B, Sq, H, KH, Sk, D


def _launch(q, k, v, o, dims, *, causal: bool, window: int, scale: float):
    """Launch over (B, S, heads, D) views, each with its own strides and
    the head dim contiguous; ``dims`` is :func:`_check`'s."""
    B, Sq, H, KH, Sk, D = dims
    vec = 16 // q.element_size()             # elements per 16-byte copy
    strides, ptrs = [], []
    for t in (q, k, v, o):
        sb, ss, sh, sd = t.stride()
        ptr = t.data_ptr()
        if sd != 1 or ptr % 16 or sb % vec or ss % vec or sh % vec:
            raise ValueError("flash attention: contiguous head dim, 16-byte "
                             "aligned pointers and strides expected")
        strides += (sb, sh, ss)                      # batch, head, seq
        ptrs.append(ptr)
    if not o.numel():
        return o
    st = (ctypes.c_int64 * 12)(*strides)
    _LIB("fa_forward", *ptrs, st, B, H, KH, Sq, Sk, D,
         float(scale or 1.0 / math.sqrt(D)), int(bool(causal)), int(window),
         int(q.dtype == torch.bfloat16), build.stream(q))
    LAUNCHES["flash_attention_bhsd"] += 1
    return o


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0,
                         scale: float = 0.0, block_q: int = 128,
                         block_k: int = 128):
    """q: (BH, Sq, D); k, v: (BH, Sk, D), as the reference takes them.
    Returns (BH, Sq, D) in q's dtype."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or k.shape[0] != q.shape[0]:
        raise ValueError("flash_attention_bhsd: q (BH, Sq, D), k, v (BH, Sk, D) "
                         "expected")
    heads = lambda x: x[:, :, None]          # (BH, S, 1, D): one head each
    q4, k4, v4 = heads(q), heads(k), heads(v)
    dims = _check(q4, k4, v4)
    if not build.on_cuda(q, k, v):
        return flash_attention_bhsd_plain(q, k, v, causal=causal, window=window,
                                          scale=scale)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(q4, k4, v4, heads(o), dims, causal=causal, window=window,
            scale=scale)
    return o


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float = 0.0):
    """Plain PyTorch version of :func:`flash_attention`: kv heads repeated
    as the reference repeats them, then :func:`flash_attention_bhsd_plain`."""
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    rows = lambda x, g: x.transpose(1, 2).repeat_interleave(g, dim=1).reshape(
        B * H, x.shape[1], D)
    out = flash_attention_bhsd_plain(rows(q, 1), rows(k, G), rows(v, G),
                                     causal=causal, window=window, scale=scale)
    return out.reshape(B, H, Sq, D).transpose(1, 2)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float = 0.0, block_q: int = 128, block_k: int = 128):
    """q: (B, Sq, H, D); k, v: (B, Sk, KH, D) with H % KH == 0 (query head h
    reads kv head h // (H / KH)).  Returns (B, Sq, H, D) in q's dtype.  On
    the card the kernel reads this layout through its strides, no copy."""
    dims = _check(q, k, v)
    if not build.on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, o, dims, causal=causal, window=window, scale=scale)
