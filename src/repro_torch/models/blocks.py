"""Transformer blocks (the port of ``repro.models.blocks``): GQA attention
(global or sliding-window, causal or not, with or without RoPE),
whisper's cross-attention over the encoder output, MLA (DeepSeek-V2's
multi-head latent attention), the dense SwiGLU / GeGLU / GELU FFN and the
capacity-routed MoE FFN, in the reference's three modes: ``train``,
``prefill`` (an attention block also returns its cache) and ``decode``
(one token against a cache)."""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.base import ParamSpec
from repro_torch.models.layers import (NEG_INF, apply_rope, cache_write,
                                       chunked_attention, decode_attention,
                                       geglu, gelu, rms_norm, swiglu)


@dataclass
class Ctx:
    """Per-call context threaded through the blocks."""
    mode: str = "train"                  # train | prefill | decode
    positions: Any = None                # (B, S) absolute positions
    cache: Any = None                    # this layer's cache dict (decode)
    cache_len: Any = None                # int, 0-d or (B,): valid entries incl. current
    emb0: Any = None                     # the embedding output (zamba2's shared-block skip)
    enc_out: Any = None                  # the encoder output (whisper's cross-attention)
    aux_losses: list = field(default_factory=list)   # MoE load-balance terms
    block_q: int = 512                   # chunked_attention's query block
    block_k: int = 512                   # and key block (train, prefill)


def attn_specs(cfg: ModelConfig, *, num_heads=None, num_kv_heads=None,
               cross: bool = False):
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
    if cfg.qk_norm and not cross:
        s["q_norm"] = ParamSpec((D,), (None,), init="ones")
        s["k_norm"] = ParamSpec((D,), (None,), init="ones")
    return s


def attn_apply(cfg: ModelConfig, p, x, ctx: Ctx, *, window: int = 0,
               rope_theta: float | None = None, causal: bool = True,
               use_rope: bool = True):
    """Self-attention. x: (B, S, E).  Returns ``(y, new_cache)``:
    ``new_cache`` is None in train mode, this layer's k/v in prefill mode,
    and ``ctx.cache`` with the new token written in place in decode mode.
    ``window`` > 0 is a sliding layer: it attends to the last ``window``
    positions, counted from each query's own position (its cache stays
    full length and is masked by absolute position); scores take
    ``cfg.logit_softcap``.  ``causal=False, use_rope=False`` is
    whisper's encoder layer (train mode only: the encoder keeps no
    cache; it takes no window)."""
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
    if use_rope:
        q = apply_rope(q, ctx.positions, theta=theta)
        k = apply_rope(k, ctx.positions, theta=theta)

    new_cache = None
    if ctx.mode == "decode":
        write = torch.as_tensor(ctx.cache_len, device=x.device) - 1
        kc = cache_write(ctx.cache["k"], k, write)
        vc = cache_write(ctx.cache["v"], v, write)
        out = decode_attention(q, kc, vc, cache_len=ctx.cache_len,
                               window=window, softcap=cfg.logit_softcap,
                               scale=cfg.attn_scale)
        new_cache = {"k": kc, "v": vc}
    else:
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                softcap=cfg.logit_softcap, scale=cfg.attn_scale,
                                block_q=ctx.block_q, block_k=ctx.block_k,
                                differentiable=ctx.mode == "train")
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


def cross_attn_apply(cfg: ModelConfig, p, x, ctx: Ctx):
    """Cross-attention of the decoder's x (B, S, E) over the encoder
    output ``ctx.enc_out`` (B, Se, E), non-causal, without RoPE, without
    ``cfg.attn_scale`` and the softcap (the reference passes neither).
    Train computes k / v from ``enc_out``; prefill does too and returns
    them as ``{"xk", "xv"}``; decode reads them from ``ctx.cache`` and
    returns that cache, re-encoding nothing.  Returns ``(y, new_cache)``."""
    B_, S, _ = x.shape
    D = cfg.resolved_head_dim
    H = p["wq"].shape[1] // D
    KH = p["wk"].shape[1] // D
    # a profiler span: a profile books these ops and their backward to
    # the cross-attention
    with torch.profiler.record_function("cross_attention"):
        q = (x @ p["wq"]).reshape(B_, S, H, D)
        if ctx.mode == "decode":
            k, v = ctx.cache["xk"], ctx.cache["xv"]
            new_cache = ctx.cache
        else:
            enc = ctx.enc_out
            if enc is None:
                raise ValueError(f"{cfg.name}: cross-attention needs the encoder "
                                 f"output: pass enc_frames (a batch's frames)")
            k = (enc @ p["wk"]).reshape(B_, enc.shape[1], KH, D)
            v = (enc @ p["wv"]).reshape(B_, enc.shape[1], KH, D)
            new_cache = {"xk": k, "xv": v} if ctx.mode == "prefill" else None
        out = chunked_attention(q, k, v, causal=False, block_q=ctx.block_q,
                                block_k=ctx.block_k,
                                differentiable=ctx.mode == "train")
        return out.reshape(B_, S, H * D) @ p["wo"], new_cache


_GATED = {"swiglu": swiglu, "geglu": geglu}


def ffn_specs(cfg: ModelConfig, kind: str, *, d_ff=None):
    E, F = cfg.d_model, d_ff or cfg.d_ff
    if kind in _GATED:
        return {"wg": ParamSpec((E, F), ("embed", "mlp")),
                "wu": ParamSpec((E, F), ("embed", "mlp")),
                "wd": ParamSpec((F, E), ("mlp", "embed"))}
    if kind == "gelu":
        return {"w1": ParamSpec((E, F), ("embed", "mlp")),
                "b1": ParamSpec((F,), ("mlp",), init="zeros"),
                "w2": ParamSpec((F, E), ("mlp", "embed")),
                "b2": ParamSpec((E,), (None,), init="zeros")}
    raise ValueError(kind)


def ffn_apply(cfg: ModelConfig, p, x, kind: str = "swiglu"):
    """A gated FFN (SwiGLU / GeGLU), or whisper's ``gelu`` one: GELU (tanh
    approximation, in float32) of ``x @ w1 + b1``, then ``@ w2 + b2``."""
    if kind in _GATED:
        return _GATED[kind](x @ p["wg"], x @ p["wu"]) @ p["wd"]
    if kind == "gelu":
        return gelu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention (arXiv:2405.04434)
# ---------------------------------------------------------------------------

def mla_specs(cfg: ModelConfig):
    m = cfg.mla
    H, E = cfg.num_heads, cfg.d_model
    dq = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq": ParamSpec((E, H * dq), ("embed", "heads")),
        "w_dkv": ParamSpec((E, m.kv_lora_rank + m.qk_rope_dim), ("embed", None)),
        "kv_norm": ParamSpec((m.kv_lora_rank,), (None,), init="ones"),
        "w_uk": ParamSpec((m.kv_lora_rank, H * m.qk_nope_dim), (None, "heads")),
        "w_uv": ParamSpec((m.kv_lora_rank, H * m.v_dim), (None, "heads")),
        "wo": ParamSpec((H * m.v_dim, E), ("heads", "embed")),
    }


def mla_apply(cfg: ModelConfig, p, x, ctx: Ctx):
    """MLA over x (B, S, E); returns ``(y, new_cache)`` as ``attn_apply``.

    Train and prefill build the full per-head k = [k_nope, k_rope] (width
    qk_nope + qk_rope) and v from the normalised latent ``c``; prefill
    caches ``c`` (``ckv``) and the shared roped key (``k_rope``).  Decode
    scores in the latent space with ``w_uk`` absorbed into q and applies
    ``w_uv`` after the softmax (the reference's serving form: another
    operation order than the full path, equal to it within rounding)."""
    m = cfg.mla
    B_, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv, L = m.qk_nope_dim, m.qk_rope_dim, m.v_dim, m.kv_lora_rank
    scale = 1.0 / math.sqrt(dn + dr)

    q = (x @ p["wq"]).reshape(B_, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, ctx.positions, theta=cfg.rope_theta)

    ckv = x @ p["w_dkv"]                                      # (B, S, L + dr)
    c, k_rope = ckv[..., :L], ckv[..., L:]
    c = rms_norm(c, p["kv_norm"], eps=cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], ctx.positions,
                        theta=cfg.rope_theta)[:, :, 0]        # (B, S, dr)

    new_cache = None
    if ctx.mode == "decode":
        clen = torch.as_tensor(ctx.cache_len, device=x.device)
        cc = cache_write(ctx.cache["ckv"], c, clen - 1)
        rc = cache_write(ctx.cache["k_rope"], k_rope, clen - 1)
        q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope,
                             p["w_uk"].reshape(L, H, dn))     # (B, 1, H, L)
        s = (torch.einsum("bqhl,bkl->bhqk", q_lat.float(), cc.float())
             + torch.einsum("bqhr,bkr->bhqk", q_rope.float(), rc.float())) * scale
        valid = (torch.arange(cc.shape[1], device=x.device)[None, :]
                 < clen.reshape(-1, 1))
        s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
        pattn = torch.softmax(s, dim=-1)
        ctx_lat = torch.einsum("bhqk,bkl->bqhl", pattn, cc.float())
        out = torch.einsum("bqhl,lhv->bqhv", ctx_lat,
                           p["w_uv"].reshape(L, H, dv).float()).to(x.dtype)
        new_cache = {"ckv": cc, "k_rope": rc}
    else:
        k_nope = (c @ p["w_uk"]).reshape(B_, S, H, dn)
        v = (c @ p["w_uv"]).reshape(B_, S, H, dv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B_, S, H, dr)], -1)
        out = chunked_attention(torch.cat([q_nope, q_rope], -1), k, v,
                                scale=scale, block_q=ctx.block_q,
                                block_k=ctx.block_k,
                                differentiable=ctx.mode == "train")
        if ctx.mode == "prefill":
            new_cache = {"ckv": c, "k_rope": k_rope}
    return out.reshape(B_, S, H * dv) @ p["wo"], new_cache


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, *,
                   device=None):
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dtype,
                                  device=device)}


def mla_cache_axes():
    return {"ckv": ("batch", "kv_seq", None), "k_rope": ("batch", "kv_seq", None)}


# ---------------------------------------------------------------------------
# MoE FFN — capacity-routed experts, gather/scatter dispatch
# ---------------------------------------------------------------------------

def moe_specs(cfg: ModelConfig):
    mo = cfg.moe
    E, X, Fe = cfg.d_model, mo.num_experts, mo.d_expert
    s = {
        "router": ParamSpec((E, X), ("embed", "experts"), scale=0.5),
        "wg": ParamSpec((X, E, Fe), ("experts", "embed", "expert_mlp")),
        "wu": ParamSpec((X, E, Fe), ("experts", "embed", "expert_mlp")),
        "wd": ParamSpec((X, Fe, E), ("experts", "expert_mlp", "embed")),
    }
    if mo.num_shared:
        Fs = mo.num_shared * Fe
        s["shared"] = {"wg": ParamSpec((E, Fs), ("embed", "mlp")),
                       "wu": ParamSpec((E, Fs), ("embed", "mlp")),
                       "wd": ParamSpec((Fs, E), ("mlp", "embed"))}
    return s


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: cf * top_k * tokens / X,
    rounded up to a multiple of 4 (at least 4)."""
    mo = cfg.moe
    c = math.ceil(mo.capacity_factor * mo.top_k * tokens / mo.num_experts)
    return max(4, -(-c // 4) * 4)


class Routing(NamedTuple):
    """One MoE layer's routing of T tokens over X experts x C slots."""
    probs: torch.Tensor        # (T, X) f32 router softmax
    top_p: torch.Tensor        # (T, K) renormalised weights of the choices
    top_i: torch.Tensor        # (T, K) chosen experts, best first
    slots: list                # K x (T,) buffer row per choice; X*C = dropped
    valids: list               # K x (T,) bool: the choice got a slot
    aux: torch.Tensor          # () f32 weighted load-balance loss
    capacity: int              # C


# the sinks of open ``record_routes`` contexts: each gets every moe_apply's
# Routing while it is open
_ROUTE_SINKS: list = []


@contextlib.contextmanager
def record_routes():
    """Collect the :class:`Routing` of every ``moe_apply`` call made
    inside the context, in call order (for measurement: capacity drops,
    routes held against another device).  Nothing is kept outside it."""
    sink: list = []
    _ROUTE_SINKS.append(sink)
    try:
        yield sink
    finally:
        _ROUTE_SINKS.remove(sink)


@contextlib.contextmanager
def routes_paused():
    """Hide the open ``record_routes`` sinks inside the context: a layer
    that checkpoint replays in the backward routes its tokens again, and
    the sinks keep the forward's routes only."""
    held = _ROUTE_SINKS[:]
    _ROUTE_SINKS.clear()
    try:
        yield
    finally:
        _ROUTE_SINKS[:] = held


def moe_route(cfg: ModelConfig, router, xf) -> Routing:
    """Route xf (T, E): softmax in f32, top-k, renormalise by max(sum,
    1e-9); then, choice slot j by slot j, each token claims the next free
    row of its expert's capacity buffer by a cumulative count carried
    across slots; a token past capacity C is dropped (its slot is the
    trash row X*C).  Exact ties take the lower expert index first, as
    ``jax.lax.top_k`` does (a stable descending sort)."""
    mo = cfg.moe
    T = xf.shape[0]
    X, K = mo.num_experts, mo.top_k
    C = moe_capacity(cfg, T)
    probs = torch.softmax((xf @ router).float(), dim=-1)     # (T, X)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :K], top_i[:, :K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch-style load-balance loss over all K choices
    me = probs.mean(dim=0)                                    # (X,)
    ce = torch.zeros((X,), dtype=torch.float32, device=xf.device)
    counts = torch.zeros((X,), dtype=torch.int64, device=xf.device)
    trash = torch.full((T,), X * C, dtype=torch.int64, device=xf.device)
    slots, valids = [], []
    for j in range(K):
        e = top_i[:, j]
        oh = torch.nn.functional.one_hot(e, X)                # (T, X)
        ce = ce + oh.sum(dim=0).float() / (T * K)
        pos = torch.cumsum(oh, dim=0) - oh                    # rank among slot j
        pos_t = pos.gather(1, e[:, None])[:, 0] + counts[e]
        counts = counts + oh.sum(dim=0)
        valid = pos_t < C
        slots.append(torch.where(valid, e * C + pos_t, trash))
        valids.append(valid)
    aux = X * torch.sum(me * ce) * mo.router_aux_weight
    return Routing(probs, top_p, top_i, slots, valids, aux, C)


def moe_apply(cfg: ModelConfig, p, x, ctx: Ctx):
    """Top-k routed experts with capacity (the reference's ``moe_apply``);
    appends the layer's aux loss to ``ctx.aux_losses``.

    The reference scatters each choice's token into an (X*C + 1, E)
    buffer whose last row takes the dropped tokens; here each buffer row
    gathers the token that claimed it (the trash row and unclaimed rows
    read a zero row), which is the same buffer and the same gradient
    without materialising K scattered copies.  Experts run as batched
    matmuls over (X, C, E); each choice's output is gathered back from
    its slot and weighted by ``top_p * valid``; shared experts are added
    densely."""
    mo = cfg.moe
    B_, S, E = x.shape
    T = B_ * S
    X, K = mo.num_experts, mo.top_k
    xf = x.reshape(T, E)
    # profiler spans: a profile attributes the routing, dispatch and
    # combine ops (and, by their autograd sequence numbers, their
    # backward) to the MoE layer
    with torch.profiler.record_function("moe.dispatch"):
        r = moe_route(cfg, p["router"], xf)
        for sink in _ROUTE_SINKS:
            sink.append(r)
        ctx.aux_losses.append(r.aux)
        C = r.capacity
        tok = torch.arange(T, device=x.device).repeat(K)
        owner = torch.full((X * C + 1,), T, dtype=torch.int64, device=x.device)
        owner = owner.index_put((torch.cat(r.slots),), tok)  # dup writes: trash row only
        xe = torch.cat([xf, xf.new_zeros(1, E)])[owner[:X * C]].view(X, C, E)
    h = swiglu(torch.bmm(xe, p["wg"]), torch.bmm(xe, p["wu"]))
    ye = torch.bmm(h, p["wd"]).reshape(X * C, E)

    with torch.profiler.record_function("moe.combine"):
        ye = torch.cat([ye, ye.new_zeros(1, E)])
        out = torch.zeros((T, E), dtype=torch.float32, device=x.device)
        for j in range(K):
            out = out + ye[r.slots[j]].float() * (r.top_p[:, j] * r.valids[j])[:, None]
        out = out.to(x.dtype)
    if mo.num_shared:
        sp = p["shared"]
        out = out + swiglu(xf @ sp["wg"], xf @ sp["wu"]) @ sp["wd"]
    return out.reshape(B_, S, E)
