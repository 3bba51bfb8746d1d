"""Shared layers in plain PyTorch: RMS norm, RoPE, causal attention, SwiGLU
(the port of the training-path parts of ``repro.models.layers``).

All functions are single-worker, float32 in and out for float32 params.
Attention is plain ``matmul``/``softmax``: on this path the reference
runs jnp ``chunked_attention`` (no Pallas kernel); the flash kernel's port
is later work.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def rms_norm(x, scale, *, eps: float = 1e-6, plus_one: bool = False):
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    s = scale.float()
    if plus_one:
        s = 1.0 + s
    return (xf * s).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, *, theta: float):
    """x: (..., S, H, D); positions: (..., S) int."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)              # (d/2,)
    ang = positions[..., None].float() * inv                  # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_attention(q, k, v, *, scale: float = 0.0):
    """Causal softmax attention with GQA, counterpart of the reference's
    ``chunked_attention(causal=True, window=0)`` in train mode.

    q: (B, S, H, D); k, v: (B, S, KH, D) with H % KH == 0.
    """
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = scale or 1.0 / math.sqrt(D)
    qh = q.reshape(B, S, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]                       # (q, k)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def swiglu(gate, up):
    return torch.nn.functional.silu(gate.float()).to(gate.dtype) * up
