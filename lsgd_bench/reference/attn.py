"""Causal multi-head self-attention with rotary positions and optional
per-head RMS norm of q and k: the whole (S, S) score square, softmax."""
from __future__ import annotations

import math

import torch

from .layers import rms_norm, rope


def shapes(cfg) -> dict:
    E, D = cfg["hidden_size"], cfg["head_dim"]
    H, KH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    s = {"wq": (E, H * D), "wk": (E, KH * D), "wv": (E, KH * D),
         "wo": (H * D, E)}
    if cfg.get("qk_norm"):
        s["q_norm"] = (D,)
        s["k_norm"] = (D,)
    return s


def apply(cfg, p, x, positions):
    B, S, _ = x.shape
    D = cfg["head_dim"]
    H, KH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    q = (x @ p["wq"]).view(B, S, H, D)
    k = (x @ p["wk"]).view(B, S, KH, D)
    v = (x @ p["wv"]).view(B, S, KH, D)
    if cfg.get("qk_norm"):
        q = rms_norm(q, p["q_norm"], cfg["rms_norm_eps"])
        k = rms_norm(k, p["k_norm"], cfg["rms_norm_eps"])
    q = rope(q, positions, cfg["rope_theta"]).transpose(1, 2)
    k = rope(k, positions, cfg["rope_theta"]).transpose(1, 2)
    v = v.transpose(1, 2)
    if KH != H:                          # head h reads kv head h // (H / KH)
        k = k.repeat_interleave(H // KH, dim=1)
        v = v.repeat_interleave(H // KH, dim=1)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(D)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    out = (a @ v).transpose(1, 2).reshape(B, S, H * D)
    return out @ p["wo"], 0.0
