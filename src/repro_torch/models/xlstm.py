"""xLSTM blocks (the port of ``repro.models.xlstm``; arXiv:2405.04517):
the mLSTM (matrix memory, chunkwise-parallel) and the sLSTM (scalar
memory, a step-by-step recurrence).

mLSTM: within a chunk of Q steps a Q x Q gate-weighted product, across
chunks a Python loop carrying ``(C, n, m)`` where the reference runs
``lax.scan``; every gate sum stays in log space with the running
stabiliser ``m``, so the chunked form equals the sequential recurrence
(:func:`mlstm_reference`) up to rounding.  The port works head-major,
(B, H, Q, .), where the reference keeps heads last; the sums are the
same.  sLSTM: a Python loop over the S steps of one cell each.  The
reference computes both in jnp with no Pallas kernel, and so does the
port in plain PyTorch.

Masked positions of the Q x Q log-weights hold ``NEG`` (-1e30), set by
``torch.where`` after the subtraction, so their exp is 0 and their
gradient 0, never NaN.  The mLSTM's output norm is per head: the
(inner,) weight is read as (H, dk) and each head normalised over dk.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import ParamSpec
from repro_torch.models.blocks import Ctx
from repro_torch.models.layers import f32up, rms_norm

NEG = -1e30


def _dims(cfg: ModelConfig):
    inner = cfg.ssm.expand * cfg.d_model
    H = cfg.num_heads
    return inner, H, inner // H


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ModelConfig):
    s = cfg.ssm
    E = cfg.d_model
    inner, H, dk = _dims(cfg)
    return {
        "w_up": ParamSpec((E, 2 * inner), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((s.conv_dim, inner), (None, "ssm_inner"), scale=0.5),
        "conv_b": ParamSpec((inner,), ("ssm_inner",), init="zeros"),
        "wq": ParamSpec((H, dk, dk), ("ssm_inner", None, None)),
        "wk": ParamSpec((H, dk, dk), ("ssm_inner", None, None)),
        "wv": ParamSpec((H, dk, dk), ("ssm_inner", None, None)),
        "w_if": ParamSpec((E, 2 * H), ("embed", None), scale=0.5),
        "b_if": ParamSpec((2 * H,), (None,), init="zeros"),
        "norm": ParamSpec((inner,), ("ssm_inner",), init="ones"),
        "wo": ParamSpec((inner, E), ("ssm_inner", "embed")),
    }


def _conv_silu(x, w, b, state=None):
    """Depthwise causal conv of x (B, S, C) with w (K, C), then SiLU in
    f32.  ``state`` (B, K-1, C): the inputs before x (decode); None means
    zeros."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        ext = F.pad(x, (0, 0, K - 1, 0))
    else:
        ext = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(ext[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu(f32up(out + b)).to(x.dtype)


def _mlstm_qkv_gates(cfg, p, x, conv_state=None):
    """q, k, v (B, S, H, dk), z (B, S, inner), log input gate and log
    forget gate (B, S, H) f32, and the up-projected xm (B, S, inner)."""
    inner, H, dk = _dims(cfg)
    B, S, _ = x.shape
    xm, z = torch.chunk(x @ p["w_up"], 2, dim=-1)
    xc = _conv_silu(xm, p["conv_w"], p["conv_b"], conv_state).reshape(B, S, H, dk)
    q = torch.einsum("bshk,hkl->bshl", xc, p["wq"])
    k = torch.einsum("bshk,hkl->bshl", xc, p["wk"]) / math.sqrt(dk)
    v = torch.einsum("bshk,hkl->bshl", xm.reshape(B, S, H, dk), p["wv"])
    g = f32up(x @ p["w_if"] + p["b_if"]).reshape(B, S, 2, H)
    logi = g[:, :, 0]                                  # pre-activation input gate
    logf = F.logsigmoid(g[:, :, 1] + 3.0)              # forget gate, bias toward keep
    return q, k, v, z, logi, logf, xm


def _mlstm_out(cfg, p, h, z):
    """h (B, S, inner) -> per-head RMS norm, SiLU(z) gate, out projection."""
    inner, H, dk = _dims(cfg)
    B, S, _ = h.shape
    h = rms_norm(h.reshape(B, S, H, dk), p["norm"].reshape(H, dk),
                 eps=cfg.norm_eps).reshape(B, S, inner)
    h = h * F.silu(f32up(z)).to(h.dtype)
    return h @ p["wo"]


def _mlstm_step(C, n, m, q, k, v, logi, logf):
    """One step of the sequential recurrence: q, k, v (B, H, dk) f32,
    gates (B, H).  Returns (C, n, m, h (B, H, dk))."""
    m_new = torch.maximum(logf + m, logi)
    fs = torch.exp(logf + m - m_new)
    is_ = torch.exp(logi - m_new)
    C = C * fs[..., None, None] + is_[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = n * fs[..., None] + is_[..., None] * k
    num = (q[..., None, :] @ C)[..., 0, :]
    den = torch.maximum((q * n).sum(-1).abs(), torch.exp(-m_new))
    return C, n, m_new, num / den[..., None]


def mlstm_apply(cfg: ModelConfig, p, x, ctx: Ctx):
    """x (B, S, E) -> (out, cache): None in train mode; in prefill mode
    ``{"C": (B, H, dk, dk), "n": (B, H, dk), "m": (B, H)}`` f32 and
    ``"conv"``, the last K-1 up-projected inputs."""
    if ctx.mode == "decode":
        return _mlstm_decode(cfg, p, x, ctx)
    s = cfg.ssm
    inner, H, dk = _dims(cfg)
    B, S, _ = x.shape
    Q = min(s.chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q

    q, k, v, z, logi, logf, xm = _mlstm_qkv_gates(cfg, p, x)
    # head-major chunks: (B, nc, H, Q, dk) and gates (B, nc, H, Q)
    hm = lambda a: f32up(a).reshape(B, nc, Q, H, dk).transpose(2, 3)
    qf, kf, vf = hm(q), hm(k), hm(v)
    gi = logi.reshape(B, nc, Q, H).transpose(2, 3)
    b = torch.cumsum(logf.reshape(B, nc, Q, H).transpose(2, 3), dim=-1)
    btot = b[..., -1]                                           # (B,nc,H)

    # a profiler span: a profile books the chunk loop (and its backward)
    with torch.profiler.record_function("mlstm.chunks"):
        tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
        # intra log-weights w[i, j] = b_i - b_j + logi_j (j <= i)
        wij = b[..., :, None] - b[..., None, :] + gi[..., None, :]  # (B,nc,H,Q,Q)
        wij = torch.where(tri, wij, torch.full_like(wij, NEG))
        m_intra = wij.amax(dim=-1)                                  # (B,nc,H,Q)
        # state-update log-weights u[j] = btot - b_j + logi_j
        uj = btot[..., None] - b + gi                               # (B,nc,H,Q)
        u_max = uj.amax(dim=-1)                                     # (B,nc,H)

        C = qf.new_zeros((B, H, dk, dk))
        n = qf.new_zeros((B, H, dk))
        m = qf.new_zeros((B, H))
        hs = []
        for c in range(nc):
            qc, kc, vc = qf[:, c], kf[:, c], vf[:, c]               # (B,H,Q,dk)
            d_inter = m[..., None] + b[:, c]                        # (B,H,Q)
            m_loc = torch.maximum(m_intra[:, c], d_inter)
            P = torch.exp(wij[:, c] - m_loc[..., None])             # (B,H,Q,Q)
            scores = qc @ kc.transpose(-1, -2)
            num = (scores * P) @ vc
            den_vec = P @ kc
            scale = torch.exp(d_inter - m_loc)[..., None]           # (B,H,Q,1)
            num = num + scale * (qc @ C)
            den_vec = den_vec + scale * n[:, :, None, :]
            den = torch.maximum((qc * den_vec).sum(-1).abs(), torch.exp(-m_loc))
            hs.append(num / den[..., None])

            m_new = torch.maximum(m + btot[:, c], u_max[:, c])
            carry = torch.exp(m + btot[:, c] - m_new)
            kw = kc * torch.exp(uj[:, c] - m_new[..., None])[..., None]
            C = C * carry[..., None, None] + kw.transpose(-1, -2) @ vc
            n = n * carry[..., None] + kw.sum(dim=2)
            m = m_new
    h = torch.stack(hs, dim=1).transpose(2, 3).reshape(B, S, inner).to(x.dtype)
    out = _mlstm_out(cfg, p, h, z)
    new_cache = None
    if ctx.mode == "prefill":
        K = p["conv_w"].shape[0]
        new_cache = {"C": C, "n": n, "m": m, "conv": xm[:, -(K - 1):]}
    return out, new_cache


def _mlstm_decode(cfg: ModelConfig, p, x, ctx: Ctx):
    inner, H, dk = _dims(cfg)
    B = x.shape[0]
    cache = ctx.cache
    q, k, v, z, logi, logf, xm = _mlstm_qkv_gates(cfg, p, x, conv_state=cache["conv"])
    conv = torch.cat([cache["conv"], xm.to(cache["conv"].dtype)], dim=1)[:, 1:]
    C, n, m, h = _mlstm_step(cache["C"], cache["n"], cache["m"],
                             f32up(q[:, 0]), f32up(k[:, 0]), f32up(v[:, 0]),
                             logi[:, 0], logf[:, 0])
    out = _mlstm_out(cfg, p, h.reshape(B, 1, inner).to(x.dtype), z)
    return out, {"C": C, "n": n, "m": m, "conv": conv}


def mlstm_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
                     device=None):
    inner, H, dk = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dk, dk), **f32),
            "n": torch.zeros((batch, H, dk), **f32),
            "m": torch.zeros((batch, H), **f32),
            "conv": torch.zeros((batch, cfg.ssm.conv_dim - 1, inner), dtype=dtype,
                                device=device)}


def mlstm_cache_axes():
    return {"C": ("batch", "ssm_inner", None, None),
            "n": ("batch", "ssm_inner", None),
            "m": ("batch", "ssm_inner"),
            "conv": ("batch", None, "ssm_inner")}


def mlstm_reference(cfg: ModelConfig, p, x, ctx: Ctx):
    """Strict sequential recurrence (the tests' oracle)."""
    inner, H, dk = _dims(cfg)
    B, S, _ = x.shape
    q, k, v, z, logi, logf, _ = _mlstm_qkv_gates(cfg, p, x)
    C = logi.new_zeros((B, H, dk, dk))
    n = logi.new_zeros((B, H, dk))
    m = logi.new_zeros((B, H))
    hs = []
    for t in range(S):
        C, n, m, h = _mlstm_step(C, n, m, f32up(q[:, t]), f32up(k[:, t]),
                                 f32up(v[:, t]), logi[:, t], logf[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, inner).to(x.dtype)
    return _mlstm_out(cfg, p, h, z), None


# ---------------------------------------------------------------------------
# sLSTM: scalar memory, one cell per step
# ---------------------------------------------------------------------------

def slstm_specs(cfg: ModelConfig):
    E = cfg.d_model
    H = cfg.num_heads
    Dh = E // H
    return {
        "w": ParamSpec((E, 4 * E), ("embed", "ssm_inner")),
        "r": ParamSpec((H, Dh, 4 * Dh), (None, None, None), scale=0.5),
        "b": ParamSpec((4 * E,), ("ssm_inner",), init="zeros"),
        "norm": ParamSpec((E,), (None,), init="ones"),
        "wo": ParamSpec((E, E), ("embed", None), scale=1.0),
    }


def _slstm_cell(p, H, Dh, carry, xt_w):
    """One sLSTM step. carry: (c, n, m, h) each (B, H, Dh) f32; xt_w:
    (B, 4E) the step's input projection."""
    c, n, m, h = carry
    B = c.shape[0]
    rec = torch.einsum("bhd,hdk->bhk", h, p["r"])               # (B,H,4Dh)
    g = xt_w.reshape(B, H, 4, Dh) + rec.reshape(B, H, 4, Dh)
    zt = torch.tanh(g[:, :, 0])
    it = g[:, :, 1]
    ft = g[:, :, 2]
    ot = torch.sigmoid(g[:, :, 3])
    m_new = torch.maximum(ft + m, it)
    fs = torch.exp(ft + m - m_new)
    is_ = torch.exp(it - m_new)
    c_new = fs * c + is_ * zt
    n_new = fs * n + is_
    h_new = ot * c_new / n_new.clamp_min(1e-6)
    return (c_new, n_new, m_new, h_new), h_new


def slstm_apply(cfg: ModelConfig, p, x, ctx: Ctx):
    """x (B, S, E) -> (out, cache): the cell runs over the S steps in
    train and prefill mode (prefill caches the final ``c, n, m, h``), once
    on the cached state in decode mode."""
    E = cfg.d_model
    H = cfg.num_heads
    Dh = E // H
    B, S, _ = x.shape
    xw = f32up(x @ p["w"] + p["b"])                             # (B,S,4E)
    if ctx.mode == "decode":
        cache = ctx.cache
        carry = (cache["c"], cache["n"], cache["m"], cache["h"])
        carry, h = _slstm_cell(p, H, Dh, carry, xw[:, 0])
        h = h.reshape(B, 1, E)
        new_cache = dict(zip("cnmh", carry))
    else:
        carry = tuple(xw.new_zeros((B, H, Dh)) for _ in range(4))
        hs = []
        with torch.profiler.record_function("slstm.cells"):    # a profiler span
            for t in range(S):
                carry, ht = _slstm_cell(p, H, Dh, carry, xw[:, t])
                hs.append(ht)
        h = torch.stack(hs, dim=1).reshape(B, S, E)
        new_cache = dict(zip("cnmh", carry)) if ctx.mode == "prefill" else None
    h = rms_norm(h.to(x.dtype), p["norm"], eps=cfg.norm_eps)
    return h @ p["wo"], new_cache


def slstm_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
                     device=None):
    E, H = cfg.d_model, cfg.num_heads
    z = lambda: torch.zeros((batch, H, E // H), dtype=torch.float32, device=device)
    return {"c": z(), "n": z(), "m": z(), "h": z()}


def slstm_cache_axes():
    ax = ("batch", None, None)
    return {k: ax for k in "cnmh"}
