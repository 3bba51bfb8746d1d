"""Transformer blocks: GQA attention and the dense SwiGLU FFN (the port of
``repro.models.blocks`` for the dense decoder), in the reference's three
modes: ``train``, ``prefill`` (the attention block also returns its k/v
as the cache) and ``decode`` (one token against a cache)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import ParamSpec
from repro_torch.models.layers import (apply_rope, cache_write, causal_attention,
                                       decode_attention, rms_norm, swiglu)


@dataclass
class Ctx:
    """Per-call context threaded through the blocks."""
    mode: str = "train"                  # train | prefill | decode
    positions: Any = None                # (B, S) absolute positions
    cache: Any = None                    # this layer's cache dict (decode)
    cache_len: Any = None                # int, 0-d or (B,): valid entries incl. current


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


def attn_apply(cfg: ModelConfig, p, x, ctx: Ctx, *,
               rope_theta: float | None = None):
    """Causal self-attention. x: (B, S, E).  Returns ``(y, new_cache)``:
    ``new_cache`` is None in train mode, this layer's k/v in prefill mode,
    and ``ctx.cache`` with the new token written in place in decode mode."""
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
    q = apply_rope(q, ctx.positions, theta=theta)
    k = apply_rope(k, ctx.positions, theta=theta)

    new_cache = None
    if ctx.mode == "decode":
        write = torch.as_tensor(ctx.cache_len, device=x.device) - 1
        kc = cache_write(ctx.cache["k"], k, write)
        vc = cache_write(ctx.cache["v"], v, write)
        out = decode_attention(q, kc, vc, cache_len=ctx.cache_len,
                               scale=cfg.attn_scale)
        new_cache = {"k": kc, "v": vc}
    else:
        out = causal_attention(q, k, v, scale=cfg.attn_scale)
        if ctx.mode == "prefill":
            new_cache = {"k": k, "v": v}
    return out.reshape(B, S, H * D) @ p["wo"], new_cache


def attn_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    *, device=None, num_kv_heads=None):
    KH = num_kv_heads or cfg.num_kv_heads or cfg.num_heads
    D = cfg.resolved_head_dim
    return {"k": torch.zeros((batch, max_len, KH, D), dtype=dtype, device=device),
            "v": torch.zeros((batch, max_len, KH, D), dtype=dtype, device=device)}


def attn_cache_axes():
    return {"k": ("batch", "kv_seq", "kv_heads", None),
            "v": ("batch", "kv_seq", "kv_heads", None)}


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
