"""Shared layers in plain PyTorch: RMS norm (gemma's ``plus_one`` form
too), layer norm, RoPE, sinusoidal positions (whisper's encoder), the
blockwise attention of training and prefill (``chunked_attention``:
causal with an optional sliding window and score softcap, or non-causal
over keys of another length for whisper's encoder and cross-attention),
the decode step's cache write and single-token attention, SwiGLU and
GeGLU (the port of ``repro.models.layers``).

All functions are single-worker, float32 in and out for float32 params;
they compute in float32 or wider (:func:`f32up`), so a float64 input
runs the same code in float64 (the reference for a float32 run's
rounding).
The training and prefill attention is the reference's jnp
``chunked_attention`` in plain PyTorch (no Pallas kernel there); the
flash kernel is reached only through ``kernels.ops.flash_attention``.
"""
from __future__ import annotations

import contextlib
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


def _pick_block(seq: int, want: int) -> int:
    """The largest block of at most ``want`` positions that divides
    ``seq`` (1 for a prime ``seq`` above ``want``)."""
    b = min(want, seq)
    while seq % b:
        b -= 1
    return max(b, 1)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0, softcap: float = 0.0,
                      scale: float = 0.0, block_q: int = 512,
                      block_k: int = 512, differentiable: bool = True):
    """Blockwise softmax attention with GQA (the reference's
    ``chunked_attention``): an online softmax over ``block_k``-key blocks
    for each ``block_q``-query block (each trimmed by :func:`_pick_block`),
    visiting only the key blocks inside the causal / window band, so no
    (Sq, Sk) score square is ever built.

    q: (B, Sq, H, D); k: (B, Sk, KH, D); v: (B, Sk, KH, Dv) with H % KH
    == 0.  v's width may differ from q's (MLA's v is narrower than its
    nope + rope q / k: the reference pads v to q's width and slices after;
    each output column is its own sum over the keys, so the narrower v
    gives the same numbers).  ``causal=False`` takes Sq and Sk free
    (whisper's encoder, cross-attention).  ``window`` > 0 keeps the keys
    less than ``window`` positions behind each query; ``q_offset`` is q[0]'s
    position among the keys; ``softcap`` caps the scores as ``tanh(s /
    cap) * cap`` before the mask; ``scale`` 0 means 1/sqrt(D).

    Each block takes the reference's op order: the f32 scores times the
    scale, the softcap, the mask to ``NEG_INF``, the running max, the
    correction ``exp(m - m_new)``, ``p = exp(s - m_new)``, the row sums and
    the accumulator, and after the last block the division by ``max(l,
    1e-30)``.  The mask is skipped for a block it leaves whole (the same
    numbers).  The block max is ``max(dim).values``, whose backward keeps
    the argmax indices rather than the block's scores (``amax`` would
    keep the scores beside the exponentials: twice the bytes); its
    gradient is the reference's but where a row ties at its maximum (the
    softmax's sum of those terms is 0 up to rounding).  Both of the
    reference's schedules are one Python loop with static bounds, whose
    step t takes the t-th key block of every q block at once (the
    reference's prefill form maps over the q blocks the same way):
    ``differentiable=True`` (train) runs under autograd,
    ``differentiable=False`` (prefill) under ``torch.no_grad``.  No step
    reads a number back to the host.  Computes in float32, or in float64
    for a float64 input."""
    B, Sq, H, D = q.shape
    KH, Sk, Dv = k.shape[2], k.shape[1], v.shape[-1]
    G = H // KH
    scale = scale or 1.0 / math.sqrt(D)
    bq, bk = _pick_block(Sq, block_q), _pick_block(Sk, block_k)
    nq, nk = Sq // bq, Sk // bk
    dt = f32up(q).dtype
    dev = q.device

    def bounds(i: int):
        hi = min((q_offset + (i + 1) * bq - 1) // bk + 1, nk) if causal else nk
        lo = (max((q_offset + i * bq - window + 1) // bk, 0)
              if (window and causal) else 0)
        return lo, hi

    def whole(i: int, j: int) -> bool:
        """Whether the mask keeps every pair of q block i and key block j."""
        q0, k0 = q_offset + i * bq, j * bk
        return ((not causal or k0 + bk - 1 <= q0)
                and (not window or q0 + bq - 1 - k0 < window))

    # q block i visits key blocks lo_i, lo_i + 1, ..., hi_i - 1 in order.
    # Step t takes every q block's t-th key block at once, q blocks sorted
    # by how many they visit, so a step's blocks are a suffix of that
    # order and the ones done leave from its front: each block sees its
    # keys in the reference's order, and a step's Python cost does not
    # grow with the number of blocks (a prime length's blocks are 1 wide)
    spans = [bounds(i) for i in range(nq)]
    order = sorted(range(nq), key=lambda i: spans[i][1] - spans[i][0])
    lo = [spans[i][0] for i in order]
    count = [spans[i][1] - spans[i][0] for i in order]
    sorted_q = order != list(range(nq))

    grad = contextlib.nullcontext() if differentiable else torch.no_grad()
    # a profiler span: a profile books these ops and their backward to
    # attention
    with torch.profiler.record_function("attention"), grad:
        # blocks outermost, then (B, KH), then the block's positions: a
        # step's matmuls read a run of blocks without a copy; the
        # reference's (B, q, KH, G, k) is the same numbers in another
        # memory order
        qt = (f32up(q).reshape(B, nq, bq, KH, G, D).permute(1, 0, 3, 2, 4, 5)
              .reshape(nq, B, KH, bq * G, D))
        kt = f32up(k).reshape(B, nk, bk, KH, D).permute(1, 0, 3, 4, 2).contiguous()
        vt = f32up(v).reshape(B, nk, bk, KH, Dv).permute(1, 0, 3, 2, 4).contiguous()
        # the blocks' bounds again on the device (no copy from the host)
        q_idx = torch.arange(nq, device=dev)
        lo_t = torch.zeros_like(q_idx)
        if window and causal:
            lo_t = (q_offset + q_idx * bq - window + 1).div(
                bk, rounding_mode="floor").clamp_min(0)
        if sorted_q:
            hi_t = torch.full_like(q_idx, nk)
            if causal:
                hi_t = ((q_offset + (q_idx + 1) * bq - 1).div(
                    bk, rounding_mode="floor") + 1).clamp_max(nk)
            q_idx = torch.argsort(hi_t - lo_t, stable=True)
            qt, lo_t = qt.index_select(0, q_idx), lo_t[q_idx]
        q_start = q_offset + bq * q_idx
        ar_q = torch.arange(bq, device=dev)
        ar_k = torch.arange(bk, device=dev)
        outs = []
        a = 0
        while a < nq and count[a] == 0:          # no key in reach: zeros
            a += 1
        if a:
            outs.append(qt.new_zeros((a, B, KH, bq, G, Dv)))
        na = nq - a
        m = torch.full((na, B, KH, bq, G), NEG_INF, dtype=dt, device=dev)
        l = torch.zeros((na, B, KH, bq, G), dtype=dt, device=dev)
        acc = torch.zeros((na, B, KH, bq, G, Dv), dtype=dt, device=dev)
        for t in range(count[-1] if nq else 0):
            na = nq - a
            js = [lo[r] + t for r in range(a, nq)]
            if js.count(js[0]) == na:                    # one key block
                k_t, v_t = kt[js[0]:js[0] + 1], vt[js[0]:js[0] + 1]
            elif js == list(range(js[0], js[0] + na)):   # a run of them
                k_t, v_t = kt[js[0]:js[0] + na], vt[js[0]:js[0] + na]
            else:
                jdx = lo_t[a:] + t
                k_t, v_t = kt.index_select(0, jdx), vt.index_select(0, jdx)
            s = (qt[a:] @ k_t).view(na, B, KH, bq, G, bk) * scale
            s = _softcap(s, softcap)
            if not all(whole(order[a + r], js[r]) for r in range(na)):
                q_pos = q_start[a:, None] + ar_q                   # (na, bq)
                k_pos = (lo_t[a:, None] + t) * bk + ar_k           # (na, bk)
                mask = torch.ones((na, bq, bk), dtype=torch.bool, device=dev)
                if causal:
                    mask &= k_pos[:, None, :] <= q_pos[:, :, None]
                if window:
                    mask &= q_pos[:, :, None] - k_pos[:, None, :] < window
                s = s.masked_fill(~mask[:, None, None, :, None, :], NEG_INF)
            m_new = torch.maximum(m, s.max(dim=-1).values)
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + (
                p.view(na, B, KH, bq * G, bk) @ v_t).view(na, B, KH, bq, G, Dv)
            m = m_new
            done = 0
            while a + done < nq and count[a + done] == t + 1:
                done += 1
            if done:
                outs.append(acc[:done] / torch.clamp_min(l[:done], 1e-30)[..., None])
                m, l, acc = m[done:], l[done:], acc[done:]
                a += done
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        if sorted_q:
            out = out.index_select(0, torch.argsort(q_idx))
        out = out.permute(1, 0, 3, 2, 4, 5).reshape(B, Sq, H, Dv)
        return out.to(q.dtype)


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
