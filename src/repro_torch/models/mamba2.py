"""Mamba-2 (SSD) mixer, chunked scan (the port of ``repro.models.mamba2``;
arXiv:2405.21060 via Zamba2, arXiv:2411.15242).

Within a chunk of Q steps the scan is a Q x Q decay-weighted product
(``L[i, j] = exp(sum_{j<k<=i} dA_k)``); across chunks a Python loop
carries the (B, H, N, P) state where the reference runs ``lax.scan``.
All decays are in log space with non-positive exponents, so no
stabiliser is needed.  The reference computes this in jnp with no Pallas
kernel, and so does the port in plain PyTorch.

The intra-chunk product is written with known intermediates: the (B, nc,
H, Q, Q) f32 decay ``L`` is multiplied by the C.B scores once, and the
result meets ``x * dt`` in one batched matmul (the reference's
three-operand einsum leaves its intermediates to XLA).  At zamba2's
width (112 heads, Q 256) ``L`` is 470 MB a layer at batch 8, seq 512.

``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``F.softplus`` turns linear
above 20, where the two differ by at most 2e-9 (exp(-20)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import ParamSpec
from repro_torch.models.blocks import Ctx
from repro_torch.models.layers import f32up, rms_norm


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    nheads = s.num_heads or inner // s.head_dim
    return inner, nheads, s.head_dim, s.state_dim


def mamba2_specs(cfg: ModelConfig):
    s = cfg.ssm
    E = cfg.d_model
    inner, H, P, N = _dims(cfg)
    conv_ch = inner + 2 * N
    return {
        "wz": ParamSpec((E, inner), ("embed", "ssm_inner")),
        "wxbc": ParamSpec((E, conv_ch), ("embed", "ssm_inner")),
        "wdt": ParamSpec((E, H), ("embed", None)),
        "dt_bias": ParamSpec((H,), (None,), init="zeros"),
        "A_log": ParamSpec((H,), (None,), init="zeros"),
        "D": ParamSpec((H,), (None,), init="ones"),
        "conv_w": ParamSpec((s.conv_dim, conv_ch), (None, "ssm_inner"), scale=0.5),
        "conv_b": ParamSpec((conv_ch,), ("ssm_inner",), init="zeros"),
        "norm": ParamSpec((inner,), ("ssm_inner",), init="ones"),
        "wo": ParamSpec((inner, E), ("ssm_inner", "embed")),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv, then SiLU in f32.  x: (B, S, C), w: (K, C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu(f32up(out + b)).to(x.dtype)


def _segsum(a):
    """a: (..., Q) log-decay per step -> (..., Q, Q): sum_{j<k<=i} a_k on
    and below the diagonal, -inf above.  The mask is applied after the
    subtraction (``torch.where``), so exp of it is 0 above the diagonal
    and its gradient there is 0, never NaN."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, torch.full_like(diff, -torch.inf))


def _gates(cfg: ModelConfig, p, x):
    """The projections of x (B, S, E): z, the pre-conv xBC, dt (B, S, H)
    f32 and A (H,) f32 < 0."""
    z = x @ p["wz"]
    xbc_in = x @ p["wxbc"]
    dt = F.softplus(f32up(x @ p["wdt"] + p["dt_bias"]))
    A = -torch.exp(f32up(p["A_log"]))
    return z, xbc_in, dt, A


def _out(cfg: ModelConfig, p, y, xh, z, dtype):
    """Skip term, gate, per-layer RMS norm, out projection.  y, xh:
    (B, S, H, P) f32."""
    B, S, H, P = y.shape
    y = y + xh * f32up(p["D"])[:, None]
    y = y.reshape(B, S, H * P).to(dtype)
    y = rms_norm(y * F.silu(f32up(z)).to(dtype), p["norm"], eps=cfg.norm_eps)
    return y @ p["wo"]


def mamba2_apply(cfg: ModelConfig, p, x, ctx: Ctx):
    """x (B, S, E) -> (out (B, S, E), cache): the cache is None in train
    mode, ``{"ssm": (B, H, N, P) f32 final state, "conv": the last K-1
    pre-conv xBC inputs}`` in prefill mode; decode takes one token."""
    if ctx.mode == "decode":
        return _mamba2_decode(cfg, p, x, ctx)
    s = cfg.ssm
    inner, H, P, N = _dims(cfg)
    B, S, _ = x.shape
    Q = min(s.chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q

    z, xbc_in, dt, A = _gates(cfg, p, x)
    xbc = _causal_conv(xbc_in, p["conv_w"], p["conv_b"])
    xin, Bm, Cm = torch.split(xbc, [inner, N, N], dim=-1)

    xh = f32up(xin.reshape(B, nc, Q, H, P))
    dtc = dt.reshape(B, nc, Q, H)
    Bc = f32up(Bm.reshape(B, nc, Q, N))
    Cc = f32up(Cm.reshape(B, nc, Q, N))
    dA = dtc * A                                                # (B,nc,Q,H) <= 0
    dAc = torch.cumsum(dA, dim=2)
    xdt = xh * dtc[..., None]                                   # (B,nc,Q,H,P)

    # intra-chunk: (scores x L) once, then one batched matmul with xdt
    # (a profiler span: a profile books these ops and their backward to
    # the Q x Q decay)
    with torch.profiler.record_function("mamba2.decay"):
        L = torch.exp(_segsum(dA.transpose(2, 3)))              # (B,nc,H,Q,Q)
        scores = Cc @ Bc.transpose(-1, -2)                      # (B,nc,Q,Q)
        y_diag = (L * scores[:, :, None]) @ xdt.permute(0, 1, 3, 2, 4)  # (B,nc,H,Q,P)

    # chunk states: sum_j exp(dAc_last - dAc_j) B_j (x) xdt_j
    decay_to_end = torch.exp(dAc[:, :, -1:, :] - dAc)           # (B,nc,Q,H)
    wx = (xdt * decay_to_end[..., None]).reshape(B, nc, Q, H * P)
    states = (Bc.transpose(-1, -2) @ wx).reshape(B, nc, N, H, P).transpose(2, 3)

    # inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(dAc[:, :, -1, :])                   # (B,nc,H)
    st = xh.new_zeros((B, H, N, P))
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                      # (B,nc,H,N,P)

    in_decay = torch.exp(dAc)                                   # (B,nc,Q,H)
    y_off = (Cc[:, :, None] @ prev_states).transpose(2, 3) * in_decay[..., None]

    y = y_diag.transpose(2, 3) + y_off                          # (B,nc,Q,H,P)
    out = _out(cfg, p, y.reshape(B, S, H, P), xh.reshape(B, S, H, P), z, x.dtype)
    new_cache = None
    if ctx.mode == "prefill":
        new_cache = {"ssm": st, "conv": xbc_in[:, S - (s.conv_dim - 1):, :]}
    return out, new_cache


def _mamba2_decode(cfg: ModelConfig, p, x, ctx: Ctx):
    """One recurrent step. x: (B, 1, E); returns (out, new cache)."""
    inner, H, P, N = _dims(cfg)
    B = x.shape[0]
    cache = ctx.cache
    z, xbc_t, dt, A = _gates(cfg, p, x[:, 0])
    conv = torch.cat([cache["conv"].to(xbc_t.dtype), xbc_t[:, None, :]], dim=1)
    conv_out = (conv * p["conv_w"]).sum(dim=1) + p["conv_b"]
    xbc = F.silu(f32up(conv_out)).to(x.dtype)
    xin, Bm, Cm = torch.split(xbc, [inner, N, N], dim=-1)
    xh = f32up(xin.reshape(B, H, P))
    dA = torch.exp(dt * A)                                      # (B,H)
    h = (cache["ssm"] * dA[..., None, None]
         + f32up(Bm)[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :])
    y = (f32up(Cm)[:, None, None, :] @ h)[:, :, 0]             # (B,H,P)
    out = _out(cfg, p, y[:, None], xh[:, None], z[:, None], x.dtype)
    return out, {"ssm": h, "conv": conv[:, 1:, :]}


def mamba2_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      *, device=None):
    s = cfg.ssm
    inner, H, P, N = _dims(cfg)
    return {"ssm": torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.conv_dim - 1, inner + 2 * N), dtype=dtype,
                                device=device)}


def mamba2_cache_axes():
    return {"ssm": ("batch", "ssm_inner", None, None),
            "conv": ("batch", None, "ssm_inner")}


def mamba2_reference(cfg: ModelConfig, p, x, ctx: Ctx):
    """Sequential-scan oracle for the tests (no chunking)."""
    inner, H, P, N = _dims(cfg)
    B, S, _ = x.shape
    z, xbc_in, dt, A = _gates(cfg, p, x)
    xbc = _causal_conv(xbc_in, p["conv_w"], p["conv_b"])
    xin, Bm, Cm = torch.split(xbc, [inner, N, N], dim=-1)
    xh = f32up(xin.reshape(B, S, H, P))
    h = xh.new_zeros((B, H, N, P))
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A[None])
        h = (h * dA[..., None, None]
             + f32up(Bm[:, t])[:, None, :, None]
             * (dt[:, t, :, None] * xh[:, t])[:, :, None, :])
        ys.append((f32up(Cm[:, t])[:, None, None, :] @ h)[:, :, 0])
    return _out(cfg, p, torch.stack(ys, dim=1), xh, z, x.dtype), None
