"""Model FLOPs of a training step, counted from a configuration file.

PaLM's count (Chowdhery et al. 2022, App. B): 6 x the matmul weights a
token passes through x tokens, plus 12 x attention layers x attention
width (heads x head size) x sequence x tokens for the attention scores
and their use.  A routed layer counts its router and only the k experts
a token is sent to, never the capacity padding; the embedding lookup is
no matmul, the head is; recompute and elementwise work are not counted.
"""
from __future__ import annotations


def _mixer_weights(cfg, kind: str) -> int:
    if kind != "attn":
        raise ValueError(f"no FLOP count for the mixer kind {kind!r}")
    E, D = cfg["hidden_size"], cfg["head_dim"]
    H, KH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return 2 * E * H * D + 2 * E * KH * D


def _ffn_weights(cfg, kind: str) -> int:
    E, Fd = cfg["hidden_size"], cfg["intermediate_size"]
    if kind == "swiglu":
        return 3 * E * Fd
    if kind == "moe":
        return E * cfg["num_experts"] + 3 * cfg["num_experts_per_tok"] * E * Fd
    raise ValueError(f"no FLOP count for the FFN kind {kind!r}")


def _layers(cfg):
    pattern = cfg["layer_pattern"]
    return [pattern[i % len(pattern)] for i in range(cfg["num_hidden_layers"])]


def matmul_weights(cfg) -> int:
    """Weights a token multiplies with in the forward pass."""
    n = cfg["hidden_size"] * cfg["vocab_size"]        # the head
    for mixer, ffn in _layers(cfg):
        n += _mixer_weights(cfg, mixer) + _ffn_weights(cfg, ffn)
    return n


def worker_step_flops(cfg, batch: int, seq: int) -> float:
    """One worker's forward and backward over ``batch`` sequences of
    ``seq`` tokens."""
    tokens = batch * seq
    attn = sum(1 for mixer, _ in _layers(cfg) if mixer == "attn")
    width = cfg["num_attention_heads"] * cfg["head_dim"]
    return float(6 * matmul_weights(cfg) * tokens
                 + 12 * attn * width * seq * tokens)
