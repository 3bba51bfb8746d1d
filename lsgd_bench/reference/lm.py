"""The decoder: embedding, the layer pattern repeated (pre-norm residual
blocks of a mixer then an FFN, each kind a module of this package found
by its name), a final RMS norm, the head (the embedding's transpose when
tied) and the mean cross-entropy plus the MoE layers' load-balance
terms."""
from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

from .layers import rms_norm


def kind(name: str):
    """The module of a mixer or FFN kind (``attn``, ``swiglu``, ``moe``)."""
    return importlib.import_module(f"{__package__}.{name}")


def repeats(cfg) -> int:
    n, period = cfg["num_hidden_layers"], len(cfg["layer_pattern"])
    if n % period:
        raise ValueError(f"{n} layers are not whole repeats of a pattern of "
                         f"{period}")
    return n // period


def param_shapes(cfg) -> dict:
    """Name -> shape of every weight, each layer's stacked over the
    pattern's repeats."""
    E, V, G = cfg["hidden_size"], cfg["vocab_size"], repeats(cfg)
    shapes = {"embed": (V, E), "final_norm": (E,)}
    if not cfg["tie_word_embeddings"]:
        shapes["head"] = (E, V)
    for i, (mixer, ffn) in enumerate(cfg["layer_pattern"]):
        shapes[f"layers.{i}.ln1"] = (G, E)
        shapes[f"layers.{i}.ln2"] = (G, E)
        for part, k in (("mix", mixer), ("ffn", ffn)):
            for name, s in kind(k).shapes(cfg).items():
                shapes[f"layers.{i}.{part}.{name}"] = (G,) + tuple(s)
    return shapes


def _layer(params, i: int, part: str, g: int) -> dict:
    pre = f"layers.{i}.{part}."
    return {k[len(pre):]: v[g] for k, v in params.items() if k.startswith(pre)}


def loss(cfg, params, tokens, labels):
    """(xent + aux, xent) of one worker's batch: tokens, labels (B, S)."""
    eps = cfg["rms_norm_eps"]
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = 0.0
    for g in range(repeats(cfg)):
        for i, (mixer, ffn) in enumerate(cfg["layer_pattern"]):
            h = rms_norm(x, params[f"layers.{i}.ln1"][g], eps)
            y, _ = kind(mixer).apply(cfg, _layer(params, i, "mix", g), h,
                                     positions)
            x = x + y
            h = rms_norm(x, params[f"layers.{i}.ln2"][g], eps)
            y, a = kind(ffn).apply(cfg, _layer(params, i, "ffn", g), h,
                                   positions)
            x = x + y
            aux = aux + a
    x = rms_norm(x, params["final_norm"], eps)
    head = (params["embed"].t() if cfg["tie_word_embeddings"]
            else params["head"])
    logits = x @ head
    xent = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))
    return xent + aux, xent
