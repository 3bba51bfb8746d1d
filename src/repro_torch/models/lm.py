"""Decoder LM of the training path (the port of ``repro.models.lm`` for the
dense attention + SwiGLU family: paper-lm).

The param tree has the reference's nesting: ``embed``, ``final_norm``,
``layers`` (a tuple with one dict per block of the repeating pattern,
each leaf stacked over the pattern's repeats) and ``rem`` (the unstacked
remainder).  A Python loop over the stacked layers takes the place of
``lax.scan``.  Embeddings are tied.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import BlockDef, ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models.base import ParamSpec, is_spec
from repro_torch.models.layers import rms_norm
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten


def _norm_spec(cfg):
    return ParamSpec((cfg.d_model,), (None,), init="ones")


def _check_supported(cfg: ModelConfig):
    for bd in cfg.blocks:
        if bd.mixer != "attn" or bd.ffn != "swiglu":
            raise NotImplementedError(
                f"block {bd} is not ported yet (attn + swiglu only)")
    if (not cfg.tie_embeddings or cfg.post_norm or cfg.cross_attention
            or cfg.encoder_layers or cfg.num_prefix_tokens
            or cfg.family != "dense" or cfg.logit_softcap
            or cfg.scale_embeddings):
        raise NotImplementedError(f"{cfg.name}: only tied dense decoders "
                                  "like paper-lm are ported yet")


def layer_specs(cfg: ModelConfig, bd: BlockDef):
    return {"ln1": _norm_spec(cfg), "mix": B.attn_specs(cfg),
            "ln2": _norm_spec(cfg), "ffn": B.ffn_specs(cfg, bd.ffn)}


def _stack_specs(tree, n: int):
    return tree_map(lambda sp: ParamSpec((n,) + sp.shape, ("layers",) + sp.axes,
                                         sp.init, sp.scale), tree, is_leaf=is_spec)


def _schedule_groups(cfg: ModelConfig):
    period = len(cfg.blocks)
    return period, cfg.num_layers // period, cfg.num_layers % period


def param_specs(cfg: ModelConfig):
    _check_supported(cfg)
    E, V = cfg.d_model, cfg.vocab_size
    specs: dict = {
        "embed": ParamSpec((V, E), ("vocab", "embed"), init="embed"),
        "final_norm": _norm_spec(cfg),
    }
    period, n_groups, rem = _schedule_groups(cfg)
    group = tuple(layer_specs(cfg, cfg.blocks[i]) for i in range(period))
    specs["layers"] = _stack_specs(group, n_groups) if n_groups else ()
    specs["rem"] = tuple(layer_specs(cfg, cfg.block_at(n_groups * period + i))
                         for i in range(rem))
    return specs


def apply_layer(cfg: ModelConfig, bd: BlockDef, p, x, positions):
    """Pre-norm residual block."""
    h = rms_norm(x, p["ln1"], eps=cfg.norm_eps)
    theta = cfg.rope_theta_global or cfg.rope_theta
    x = x + B.attn_apply(cfg, p["mix"], h, positions, rope_theta=theta)
    h = rms_norm(x, p["ln2"], eps=cfg.norm_eps)
    return x + B.ffn_apply(cfg, p["ffn"], h, bd.ffn)


def forward(cfg: ModelConfig, params, tokens):
    """Train-mode decoder stack: tokens (B, S) int -> hidden (B, S, E)."""
    x = params["embed"][tokens]
    Bsz, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(Bsz, S)
    period, n_groups, rem = _schedule_groups(cfg)
    # unbind each stacked leaf once: its backward stacks the per-layer
    # grads in one pass, where indexing a[g] per layer would make autograd
    # zero-fill and add a full stacked-size grad for every layer
    groups = []
    for i in range(period if n_groups else 0):
        leaves, treedef = tree_flatten(params["layers"][i])
        groups.append((treedef, [leaf.unbind(0) for leaf in leaves]))
    for g in range(n_groups):
        for i, (treedef, per_layer) in enumerate(groups):
            lp = tree_unflatten(treedef, [p[g] for p in per_layer])
            x = apply_layer(cfg, cfg.blocks[i], lp, x, positions)
    for i in range(rem):
        x = apply_layer(cfg, cfg.block_at(n_groups * period + i),
                        params["rem"][i], x, positions)
    return rms_norm(x, params["final_norm"], eps=cfg.norm_eps)


def chunked_xent(cfg: ModelConfig, params, hidden, labels, *, block: int = 512):
    """Cross-entropy over sequence blocks of at most ``block`` positions
    (the (B, block, V) logits of one block at a time).  Labels < 0 are
    ignored.  Returns (sum_loss, num_valid)."""
    B_, S, E = hidden.shape
    blk = min(block, S)
    while S % blk:
        blk -= 1
    head = params["embed"].t()
    total = hidden.new_zeros(())
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for s0 in range(0, S, blk):
        h = hidden[:, s0:s0 + blk]
        y = labels[:, s0:s0 + blk]
        lg = (h @ head).float()
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, y.clamp_min(0)[..., None])[..., 0]
        valid = y >= 0
        total = total + torch.where(valid, lse - gold, torch.zeros_like(lse)).sum()
        count = count + valid.sum()
    return total, count


def loss_fn(cfg: ModelConfig, params, batch):
    """batch: dict(tokens (B,S), labels (B,S)) int tensors.
    Returns (loss, metrics) like the reference's ``loss_fn``."""
    hidden = forward(cfg, params, batch["tokens"])
    s, n = chunked_xent(cfg, params, hidden, batch["labels"])
    loss = s / n.clamp_min(1)
    return loss, {"xent": loss, "aux": loss.new_zeros(()), "tokens": n}

