"""Shared layers in plain PyTorch: RMS norm (gemma's ``plus_one`` form
too), layer norm, RoPE, sinusoidal positions (whisper's encoder), causal
attention with an optional sliding window and score softcap, non-causal
attention over keys of another length (whisper's encoder and
cross-attention), the decode step's cache write and single-token
attention, SwiGLU and GeGLU (the port of ``repro.models.layers``).

All functions are single-worker, float32 in and out for float32 params;
they compute in float32 or wider (:func:`f32up`), so a float64 input
runs the same code in float64 (the reference for a float32 run's
rounding).
The training path's attention is plain ``matmul``/``softmax``, as the
reference runs jnp ``chunked_attention`` there (no Pallas kernel); the
flash kernel is reached only through ``kernels.ops.flash_attention``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def f32up(x):
    """x in float32, or as it is when float64: the dtype the layers
    compute in (the reference's ``astype(float32)``, widened for a
    float64 evaluation)."""
    return x if x.dtype == torch.float64 else x.float()


def rms_norm(x, scale, *, eps: float = 1e-6, plus_one: bool = False):
    dtype = x.dtype
    xf = f32up(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    s = f32up(scale)
    if plus_one:
        s = 1.0 + s
    return (xf * s).to(dtype)


def layer_norm(x, scale, bias, *, eps: float = 1e-5):
    """Layer norm over the last axis in float32 (or wider), cast back.
    No model of the registry calls it: the reference defines it beside
    ``rms_norm``, and the port keeps the module whole."""
    dtype = x.dtype
    xf = f32up(x)
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * f32up(scale) + f32up(bias)).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, *, theta: float):
    """x: (..., S, H, D); positions: (..., S) int."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)              # (d/2,)
    ang = positions[..., None].to(inv.dtype) * inv            # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(f32up(x), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(num_pos: int, dim: int, device=None):
    """(num_pos, dim) float32 table: sin in the even columns, cos in the
    odd ones, frequencies 10000^(-2i/dim) (whisper's encoder positions;
    the caller casts it to the activations' dtype)."""
    pos = torch.arange(num_pos, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((num_pos, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _softcap(s, cap: float):
    if cap and cap > 0:
        s = torch.tanh(s / cap) * cap
    return s


def causal_attention(q, k, v, *, window: int = 0, softcap: float = 0.0,
                     scale: float = 0.0):
    """Causal softmax attention with GQA, counterpart of the reference's
    ``chunked_attention(causal=True)`` in train and prefill mode.

    q, k: (B, S, H | KH, D); v: (B, S, KH, Dv) with H % KH == 0 — v's
    head width may differ from q's (MLA's v is narrower than its
    nope + rope q/k; the reference pads v to q's width and slices after,
    which gives the same numbers).  ``window`` > 0 keeps the keys less
    than ``window`` positions behind each query (gemma3's sliding
    layers); ``softcap`` caps the scores as ``tanh(s / cap) * cap``
    before the mask; ``scale`` 0 means 1/sqrt(D).
    """
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = scale or 1.0 / math.sqrt(D)
    # a profiler span: a profile books these ops and their backward to
    # attention
    with torch.profiler.record_function("attention"):
        qh = q.reshape(B, S, KH, G, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", f32up(qh), f32up(k)) * scale
        s = _softcap(s, softcap)
        pos = torch.arange(S, device=q.device)
        mask = pos[None, :] <= pos[:, None]                       # (q, k)
        if window:
            mask &= pos[:, None] - pos[None, :] < window
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, f32up(v))
        return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def full_attention(q, k, v, *, softcap: float = 0.0, scale: float = 0.0):
    """Non-causal softmax attention with GQA, counterpart of the
    reference's ``chunked_attention(causal=False)`` in train and prefill
    mode (no mask): q (B, Sq, H, D) against k, v (B, Sk, KH,
    D), Sq and Sk free (whisper's encoder attends over its own frames,
    cross-attention from the decoder's tokens over the encoder's
    output).  ``softcap`` caps the scores as ``tanh(s / cap) * cap``;
    ``scale`` 0 means 1/sqrt(D)."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = scale or 1.0 / math.sqrt(D)
    qh = q.reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", f32up(qh), f32up(k)) * scale
    p = torch.softmax(_softcap(s, softcap), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, f32up(v))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def reference_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale: float = 0.0):
    """O(S^2) oracle (the reference's ``reference_attention``).

    q: (B, Sq, H, D); k, v: (B, Sk, KH, D).  Query positions are aligned
    to the END of the keys (query i sits at key position i + Sk - Sq),
    unlike the flash kernel's start-aligned rows: the two agree only
    where Sq == Sk."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = scale or 1.0 / math.sqrt(D)
    qh = q.reshape(B, Sq, KH, G, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qh.float(), k.float()) * scale
    s = _softcap(s, softcap)
    Sk = k.shape[1]
    qpos = torch.arange(Sq, device=q.device) + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def cache_write(buf, new, write):
    """Write one token's k/v rows into a sequence-major cache buffer, IN
    PLACE, and return it (the reference returns an updated copy; the port
    updates the buffer the caller holds, as the reference's donated
    buffers are updated).

    ``buf``: (B, S, ...); ``new``: (B, 1, ...); ``write``: an int, a 0-d
    or a (B,) int tensor — the target position along axis 1, one per row
    for continuous batching.  Positions are taken in ``[0, S)``.
    """
    new = new.to(buf.dtype)
    w = torch.as_tensor(write, device=buf.device)
    if w.dim() == 0:
        buf[:, w] = new[:, 0]
    else:
        buf[torch.arange(buf.shape[0], device=buf.device), w.long()] = new[:, 0]
    return buf


def decode_attention(q, k_cache, v_cache, *, cache_len, window: int = 0,
                     softcap: float = 0.0, scale: float = 0.0):
    """Single-token attention over a KV cache (the reference's
    ``decode_attention``), accumulated in float32.

    q: (B, 1, H, D); caches: (B, S, KH, D); ``cache_len``: int, 0-d or
    (B,) — the number of valid cache entries, the new token's k/v already
    written at ``cache_len - 1``.  ``window`` keeps the last ``window``
    entries; ``softcap`` caps the scores as ``tanh(s / cap) * cap``.
    """
    B, _, H, D = q.shape
    KH = k_cache.shape[2]
    G = H // KH
    S = k_cache.shape[1]
    scale = scale or 1.0 / math.sqrt(D)
    qh = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", f32up(qh), f32up(k_cache)) * scale
    s = _softcap(s, softcap)
    pos = torch.arange(S, device=q.device)
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    clen = clen.expand(B, 1)
    valid = pos[None, :] < clen
    if window:
        valid &= pos[None, :] >= clen - window
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    out = torch.einsum("bhgk,bkhd->bhgd", p, f32up(v_cache))
    out = out / p.sum(dim=-1)[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)


def swiglu(gate, up):
    return torch.nn.functional.silu(f32up(gate)).to(gate.dtype) * up


def gelu(x):
    """GELU in its tanh approximation (``jax.nn.gelu``'s default, not
    torch's exact erf form), in float32 or wider, cast back."""
    return torch.nn.functional.gelu(f32up(x), approximate="tanh").to(x.dtype)


def geglu(gate, up):
    """GELU (tanh approximation) of the gate in float32, cast back, times
    up (gemma3's FFN)."""
    return gelu(gate) * up
