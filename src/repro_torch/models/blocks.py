"""Transformer blocks of the training path: GQA attention and the dense
SwiGLU FFN (the port of ``repro.models.blocks``, train mode only)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import ParamSpec
from repro_torch.models.layers import apply_rope, causal_attention, rms_norm, swiglu


def attn_specs(cfg: ModelConfig, *, num_heads=None, num_kv_heads=None):
    H = num_heads or cfg.num_heads
    KH = num_kv_heads or cfg.num_kv_heads or H
    D = cfg.resolved_head_dim
    E = cfg.d_model
    s = {
        "wq": ParamSpec((E, H * D), ("embed", "heads")),
        "wk": ParamSpec((E, KH * D), ("embed", "kv_heads")),
        "wv": ParamSpec((E, KH * D), ("embed", "kv_heads")),
        "wo": ParamSpec((H * D, E), ("heads", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((D,), (None,), init="ones")
        s["k_norm"] = ParamSpec((D,), (None,), init="ones")
    return s


def attn_apply(cfg: ModelConfig, p, x, positions, *, rope_theta: float | None = None):
    """Causal self-attention, train mode. x: (B, S, E) -> (B, S, E)."""
    B, S, E = x.shape
    D = cfg.resolved_head_dim
    H = p["wq"].shape[1] // D
    KH = p["wk"].shape[1] // D
    theta = rope_theta if rope_theta is not None else cfg.rope_theta

    q = (x @ p["wq"]).reshape(B, S, H, D)
    k = (x @ p["wk"]).reshape(B, S, KH, D)
    v = (x @ p["wv"]).reshape(B, S, KH, D)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], eps=cfg.norm_eps)
    q = apply_rope(q, positions, theta=theta)
    k = apply_rope(k, positions, theta=theta)
    out = causal_attention(q, k, v, scale=cfg.attn_scale)
    return out.reshape(B, S, H * D) @ p["wo"]


def ffn_specs(cfg: ModelConfig, kind: str, *, d_ff=None):
    E, F = cfg.d_model, d_ff or cfg.d_ff
    if kind != "swiglu":
        raise NotImplementedError(f"ffn kind {kind!r} is not ported yet")
    return {"wg": ParamSpec((E, F), ("embed", "mlp")),
            "wu": ParamSpec((E, F), ("embed", "mlp")),
            "wd": ParamSpec((F, E), ("mlp", "embed"))}


def ffn_apply(cfg: ModelConfig, p, x, kind: str = "swiglu"):
    if kind != "swiglu":
        raise NotImplementedError(f"ffn kind {kind!r} is not ported yet")
    return swiglu(x @ p["wg"], x @ p["wu"]) @ p["wd"]
