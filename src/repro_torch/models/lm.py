"""The LM of every registered family (the port of ``repro.models.lm``):
blocks of GQA attention (global or sliding-window), MLA, mamba2, mLSTM,
sLSTM or zamba2's shared attention, followed by a SwiGLU, GeGLU, GELU or
MoE FFN or by none: paper-lm, olmoe-1b-7b, deepseek-v2-lite-16b,
qwen3-32b, phi4-mini-3.8b, minitron-4b, gemma3-1b, xlstm-1.3b,
zamba2-7b, whisper-small and internvl2-76b): the training forward and
loss (cross-entropy plus the MoE layers' load-balance aux), and the
serving entry points ``prefill`` / ``decode_step`` over a cache.

whisper-small (``encoder_layers``, ``cross_attention``) runs an encoder
over stubbed frame embeddings ``enc_frames`` (B, Se, E): the ``frontend``
projection, sinusoidal positions, non-causal attention + GELU layers
(``params["enc"]``: ``layers``, a 1-tuple of dicts stacked over the
encoder's depth, and ``norm``), then an RMS norm; every decoder layer
adds a cross-attention sub-block (``lnx``, ``xattn``) over that output,
whose k / v a prefill caches as ``xk`` / ``xv`` (B, Se, KH, D) and a
decode reads back.  internvl2-76b (``num_prefix_tokens``) projects
stubbed patch embeddings ``prefix_embed`` (B, Np, E) through
``frontend`` and puts them before the tokens' embeddings: the hidden
state, the positions and the cache cover Np + S positions, the loss
skips the prefix (labels -1), and a decode's ``cache_len`` counts it.

zamba2's ``shared_attn`` layers run one attention + FFN block whose
weights live once, in ``params["shared"]`` (``ln1``, ``attn``, ``ln2``,
``ffn``), fed the hidden state plus the embedding output ``emb0``; such
a layer keeps its own ``ln1`` / ``ln2`` / ``ffn`` leaves, as the
reference's specs give them, and never reads them (they take no
gradient, only weight decay).

gemma3's options ride the config: ``post_norm`` adds the ``ln1p`` /
``ln2p`` norms after each sub-block and puts every norm in the
``plus_one`` form, ``scale_embeddings`` multiplies the looked-up rows by
sqrt(d_model) (a tied head uses the unscaled table), ``logit_softcap``
caps the attention scores and the logits, and the global ``attn`` layers
take ``rope_theta_global`` where the ``attn_sliding`` ones take
``rope_theta`` and ``sliding_window``.

The param tree has the reference's nesting: ``embed``, ``final_norm``,
``head`` (untied configs only), ``layers`` (a tuple with one dict per
block of the repeating pattern, each leaf stacked over the pattern's
repeats) and ``rem`` (the unstacked remainder).  A Python loop over the
stacked layers takes the place of ``lax.scan``.  The cache has the same
nesting: ``{"layers": (one dict per block, stacked over the repeats),
"rem": (...)}``; an attention or shared-attention block caches ``k`` /
``v`` (repeats, B, S, KH, D), axes ``("layers", "batch", "kv_seq",
"kv_heads", None)``, an MLA block ``ckv`` (repeats, B, S, kv_lora) and
``k_rope`` (repeats, B, S, qk_rope), axes ``("layers", "batch",
"kv_seq", None)``; a recurrent block its fixed-size state (mamba2 ``ssm``
/ ``conv``, mLSTM ``C`` / ``n`` / ``m`` / ``conv``, sLSTM ``c`` / ``n``
/ ``m`` / ``h``), with no ``kv_seq`` axis.  ``decode_step`` writes the
new token's entries and the new recurrent states into the cache it is
given, in place.  A recurrent cache serves from this contiguous path
only: the paged engine needs a ``kv_seq`` axis on every leaf.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockDef, ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import mamba2 as M2
from repro_torch.models import xlstm as XL
from repro_torch.models.base import ParamSpec, is_spec
from repro_torch.models.layers import f32up, rms_norm, sinusoidal_positions
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten


def _norm_spec(cfg):
    return ParamSpec((cfg.d_model,), (None,), init="ones")


def _mixer_specs(cfg: ModelConfig, bd: BlockDef):
    k = bd.mixer
    if k in ("attn", "attn_sliding"):
        return B.attn_specs(cfg)
    if k == "mla":
        return B.mla_specs(cfg)
    if k == "mamba2":
        return M2.mamba2_specs(cfg)
    if k == "mlstm":
        return XL.mlstm_specs(cfg)
    if k == "slstm":
        return XL.slstm_specs(cfg)
    if k == "shared_attn":
        return {}                       # the weights live in params["shared"]
    raise ValueError(k)


def layer_specs(cfg: ModelConfig, bd: BlockDef, *, cross: bool = False):
    s = {"ln1": _norm_spec(cfg), "mix": _mixer_specs(cfg, bd)}
    if cross:
        s["lnx"] = _norm_spec(cfg)
        s["xattn"] = B.attn_specs(cfg, cross=True)
    if bd.ffn != "none":
        s["ln2"] = _norm_spec(cfg)
        s["ffn"] = B.moe_specs(cfg) if bd.ffn == "moe" else B.ffn_specs(cfg, bd.ffn)
    if cfg.post_norm:
        s["ln1p"] = _norm_spec(cfg)
        if bd.ffn != "none":
            s["ln2p"] = _norm_spec(cfg)
    return s


def _shared_block(cfg: ModelConfig):
    """The BlockDef of the first ``shared_attn`` layer, or None."""
    return next((bd for bd in cfg.blocks if bd.mixer == "shared_attn"), None)


def _stack_specs(tree, n: int):
    return tree_map(lambda sp: ParamSpec((n,) + sp.shape, ("layers",) + sp.axes,
                                         sp.init, sp.scale), tree, is_leaf=is_spec)


def _schedule_groups(cfg: ModelConfig):
    period = len(cfg.blocks)
    return period, cfg.num_layers // period, cfg.num_layers % period


def param_specs(cfg: ModelConfig):
    E, V = cfg.d_model, cfg.vocab_size
    specs: dict = {
        "embed": ParamSpec((V, E), ("vocab", "embed"), init="embed"),
        "final_norm": _norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((E, V), ("embed", "vocab"))
    cross = cfg.cross_attention
    period, n_groups, rem = _schedule_groups(cfg)
    group = tuple(layer_specs(cfg, cfg.blocks[i], cross=cross)
                  for i in range(period))
    specs["layers"] = _stack_specs(group, n_groups) if n_groups else ()
    specs["rem"] = tuple(layer_specs(cfg, cfg.block_at(n_groups * period + i),
                                     cross=cross) for i in range(rem))
    shared_bd = _shared_block(cfg)
    if shared_bd is not None:
        specs["shared"] = {
            "ln1": _norm_spec(cfg),
            "attn": B.attn_specs(cfg),
            "ln2": _norm_spec(cfg),
            "ffn": (B.ffn_specs(cfg, shared_bd.ffn) if shared_bd.ffn != "none"
                    else {}),
        }
    if cfg.num_prefix_tokens or cfg.family in ("vlm", "audio"):
        specs["frontend"] = ParamSpec((E, E), ("embed", None), scale=1.0)
    if cfg.encoder_layers:
        one = {"ln1": _norm_spec(cfg), "mix": B.attn_specs(cfg),
               "ln2": _norm_spec(cfg), "ffn": B.ffn_specs(cfg, "gelu")}
        specs["enc"] = {"layers": _stack_specs((one,), cfg.encoder_layers),
                        "norm": _norm_spec(cfg)}
    return specs


def _apply_mixer(cfg: ModelConfig, bd: BlockDef, p, x, ctx: B.Ctx, shared=None):
    k = bd.mixer
    if k == "mla":
        return B.mla_apply(cfg, p["mix"], x, ctx)
    if k == "attn_sliding":
        return B.attn_apply(cfg, p["mix"], x, ctx, window=cfg.sliding_window)
    if k == "attn":
        theta = cfg.rope_theta_global or cfg.rope_theta
        return B.attn_apply(cfg, p["mix"], x, ctx, rope_theta=theta)
    if k == "mamba2":
        return M2.mamba2_apply(cfg, p["mix"], x, ctx)
    if k == "mlstm":
        return XL.mlstm_apply(cfg, p["mix"], x, ctx)
    if k == "slstm":
        return XL.slstm_apply(cfg, p["mix"], x, ctx)
    if k == "shared_attn":
        # zamba2: the shared attention, fed the hidden state plus the
        # embedding output, under the shared block's own first norm
        xin = x if ctx.emb0 is None else x + ctx.emb0
        xin = rms_norm(xin, shared["ln1"], eps=cfg.norm_eps)
        return B.attn_apply(cfg, shared["attn"], xin, ctx)
    raise ValueError(k)


def apply_layer(cfg: ModelConfig, bd: BlockDef, p, x, ctx: B.Ctx, shared=None):
    """Residual block, pre-norm (with ``post_norm``, each sub-block's
    output normed again before the residual add); ``ffn == "none"`` has
    no FFN sub-block; a layer with ``xattn`` (whisper's decoder) adds
    the cross-attention sub-block between the two.  A ``shared_attn``
    layer runs ``shared``'s attention and FFN (``params["shared"]``; no
    ``ln1`` of its own, no post-norm).  Returns ``(x, new_cache, aux)``:
    ``aux`` sums the load-balance losses the block appended to ``ctx``."""
    post = cfg.post_norm
    shared_mix = bd.mixer == "shared_attn"
    if shared_mix:
        y, new_cache = _apply_mixer(cfg, bd, p, x, ctx, shared)
    else:
        h = rms_norm(x, p["ln1"], eps=cfg.norm_eps, plus_one=post)
        y, new_cache = _apply_mixer(cfg, bd, p, h, ctx, shared)
        if post:
            y = rms_norm(y, p["ln1p"], eps=cfg.norm_eps, plus_one=True)
    x = x + y
    if "xattn" in p:
        h = rms_norm(x, p["lnx"], eps=cfg.norm_eps)
        y, xc = B.cross_attn_apply(cfg, p["xattn"], h, ctx)
        if xc is not None:
            new_cache = xc if new_cache is None else {**new_cache, **xc}
        x = x + y
    if bd.ffn != "none":
        fp = shared["ffn"] if shared_mix else p["ffn"]
        fln = shared["ln2"] if shared_mix else p["ln2"]
        h = rms_norm(x, fln, eps=cfg.norm_eps, plus_one=post)
        if bd.ffn == "moe":
            y = B.moe_apply(cfg, fp, h, ctx)
        else:
            y = B.ffn_apply(cfg, fp, h, bd.ffn)
        if post and not shared_mix:
            y = rms_norm(y, p["ln2p"], eps=cfg.norm_eps, plus_one=True)
        x = x + y
    aux = sum(ctx.aux_losses, x.new_zeros((), dtype=torch.float32))
    return x, new_cache, aux


def _embed_tokens(cfg: ModelConfig, params, tokens):
    """The embedding rows of ``tokens``, times sqrt(d_model) with
    ``scale_embeddings`` (gemma).  ``F.embedding``, not ``embed[tokens]``:
    its backward adds each row's gradients in token order, where the
    CPU's backward of advanced indexing adds them with atomics across
    threads (at 512 tokens and more), whose order, and so whose last bits,
    change from run to run."""
    x = F.embedding(tokens, params["embed"])
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def _unbind_stacked(stacked):
    """(treedef, per-leaf tuples of layer slices) of a dict of leaves
    stacked over layers.  Unbinding each leaf once makes its backward
    stack the per-layer grads in one pass, where indexing a[g] per layer
    would make autograd zero-fill and add a full stacked-size grad for
    every layer."""
    leaves, treedef = tree_flatten(stacked)
    return treedef, [leaf.unbind(0) for leaf in leaves]


def _encode(cfg: ModelConfig, params, frames, *, block_q: int = 512,
            block_k: int = 512):
    """whisper's encoder over stubbed frame embeddings (B, Se, E): the
    ``frontend`` projection, sinusoidal positions, the encoder layers
    (pre-norm non-causal attention without RoPE, then the GELU FFN), the
    encoder's RMS norm.  Always train mode, in a prefill too, as the
    reference's: the encoder keeps no cache, and recomputes nothing."""
    # a profiler span: a profile books these ops and their backward to
    # the encoder
    with torch.profiler.record_function("encoder"):
        x = frames @ params["frontend"]
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     device=x.device).to(x.dtype)[None]
        ctx = B.Ctx(mode="train", block_q=block_q, block_k=block_k)
        treedef, per_layer = _unbind_stacked(params["enc"]["layers"][0])
        for g in range(cfg.encoder_layers):
            lp = tree_unflatten(treedef, [p[g] for p in per_layer])
            h = rms_norm(x, lp["ln1"], eps=cfg.norm_eps)
            y, _ = B.attn_apply(cfg, lp["mix"], h, ctx, causal=False,
                                use_rope=False)
            x = x + y
            h = rms_norm(x, lp["ln2"], eps=cfg.norm_eps)
            x = x + B.ffn_apply(cfg, lp["ffn"], h, "gelu")
        return rms_norm(x, params["enc"]["norm"], eps=cfg.norm_eps)


# the sinks of open ``record_remat`` contexts: each gets ``(fn, args, keep)``
# of every layer call that runs under checkpoint while it is open
_REMAT_SINKS: list = []


@contextlib.contextmanager
def record_remat():
    """Collect ``(fn, args, keep)`` of every layer that ``remat="block"``
    runs under checkpoint inside the context, in call order: ``fn(*args)``
    replays the layer, and ``args`` and ``keep`` (the tensors the layer
    reads besides them) are what checkpoint keeps alive for the backward
    (for measurement: ``launch.dryrun`` counts both)."""
    sink: list = []
    _REMAT_SINKS.append(sink)
    try:
        yield sink
    finally:
        _REMAT_SINKS.remove(sink)


def _remat(fn, *args, keep=()):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    autograd keeps the arguments and runs ``fn`` again in the backward.
    The replay records no MoE routes (``blocks.record_routes`` sees each
    layer once); its outputs, the aux loss among them, are dropped.
    ``keep``: the tensors ``fn`` reads besides ``args``, for
    :func:`record_remat`."""
    for sink in _REMAT_SINKS:
        sink.append((fn, args, keep))
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        with B.routes_paused():
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False)


def _decoder(cfg: ModelConfig, params, tokens, *, mode: str = "train",
             cache=None, cache_len=None, prefix_embed=None, enc_frames=None,
             remat: str = "none", block_q: int = 512, block_k: int = 512):
    """The decoder stack in any mode: (hidden (B, Np + S, E), new cache,
    aux).

    ``remat="block"`` runs each layer of the period groups under
    checkpoint (:func:`_remat`) in train mode while grad is on, as the
    reference wraps them in ``jax.checkpoint``: the backward keeps each
    layer's input and recomputes the layer.  The remainder layers and the
    encoder are not wrapped (nor are the reference's); ``"none"`` and
    ``"full"`` recompute nothing (the reference tests for ``"block"``
    only).  ``block_q`` / ``block_k`` are the attention's blocks
    (``layers.chunked_attention``).

    Train mode returns no cache; prefill stacks each block's cache over
    the repeats; decode writes the new token's entries and the new
    recurrent states into ``cache`` in place (through per-layer views)
    and returns it.  ``aux`` () f32 sums the layers' MoE load-balance
    losses in layer order (0 without MoE).  ``prefix_embed`` (B, Np, E)
    goes through ``frontend`` before the tokens (Np = 0 without it);
    ``enc_frames`` (B, Se, E) runs the encoder for the cross-attention
    (train and prefill; a decode reads the cached ``xk`` / ``xv``)."""
    x = _embed_tokens(cfg, params, tokens)
    if prefix_embed is not None:
        with torch.profiler.record_function("prefix_projection"):
            pe = (prefix_embed @ params["frontend"]).to(x.dtype)
            x = torch.cat([pe, x], dim=1)
    enc_out = None
    if cfg.encoder_layers and enc_frames is not None:
        enc_out = _encode(cfg, params, enc_frames, block_q=block_q,
                          block_k=block_k)
    emb0 = x if _shared_block(cfg) is not None else None
    shared = params.get("shared")
    Bsz, S = x.shape[:2]
    if mode == "decode":
        last = torch.as_tensor(cache_len, device=tokens.device).reshape(-1) - 1
        positions = last[:, None].expand(Bsz, 1)
    else:
        positions = torch.arange(S, device=tokens.device)[None].expand(Bsz, S)
    period, n_groups, rem = _schedule_groups(cfg)
    groups = [_unbind_stacked(params["layers"][i])
              for i in range(period if n_groups else 0)]
    group_caches = [[] for _ in groups]
    aux = x.new_zeros((), dtype=torch.float32)
    recompute = (remat == "block" and mode == "train"
                 and torch.is_grad_enabled())

    def one(bd, lp, x, lc):
        x, nc, a = apply_layer(cfg, bd, lp, x,
                               B.Ctx(mode=mode, positions=positions, cache=lc,
                                     cache_len=cache_len, emb0=emb0,
                                     enc_out=enc_out, block_q=block_q,
                                     block_k=block_k), shared)
        if mode == "decode":
            # the cache contract: the caller's cache holds the new state
            for k, v in nc.items():
                if v is not lc[k]:
                    lc[k].copy_(v)
        return x, nc, a

    for g in range(n_groups):
        for i, (treedef, per_layer) in enumerate(groups):
            lp = tree_unflatten(treedef, [p[g] for p in per_layer])
            lc = (None if cache is None else
                  {k: v[g] for k, v in cache["layers"][i].items()})
            if recompute:
                x, nc, a = _remat(one, cfg.blocks[i], lp, x, lc,
                                  keep=(positions, emb0, enc_out))
            else:
                x, nc, a = one(cfg.blocks[i], lp, x, lc)
            aux = aux + a
            group_caches[i].append(nc)
    rem_caches = []
    for i in range(rem):
        lc = None if cache is None else cache["rem"][i]
        x, nc, a = one(cfg.block_at(n_groups * period + i), params["rem"][i], x, lc)
        aux = aux + a
        rem_caches.append(nc)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps,
                 plus_one=cfg.post_norm)
    if mode != "prefill":
        return x, cache, aux
    layers = tuple({k: torch.stack([c[k] for c in cs]) for k in cs[0]}
                   for cs in group_caches)
    return x, {"layers": layers, "rem": tuple(rem_caches)}, aux


def forward(cfg: ModelConfig, params, tokens, *, prefix_embed=None,
            enc_frames=None, remat: str = "none", block_q: int = 512,
            block_k: int = 512):
    """Train-mode stack: tokens (B, S) int (after ``prefix_embed`` (B, Np,
    E) when given; over the encoder output of ``enc_frames`` (B, Se, E)
    when given) -> hidden (B, Np + S, E).  ``remat``, ``block_q``,
    ``block_k`` as in :func:`_decoder`."""
    return _decoder(cfg, params, tokens, prefix_embed=prefix_embed,
                    enc_frames=enc_frames, remat=remat, block_q=block_q,
                    block_k=block_k)[0]


def _head(cfg: ModelConfig, params):
    """The (E, V) output projection: the embedding's transpose when tied."""
    return params["embed"].t() if cfg.tie_embeddings else params["head"]


def _softcap_logits(cfg: ModelConfig, logits):
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def chunked_xent(cfg: ModelConfig, params, hidden, labels, *, block: int = 512):
    """Cross-entropy over sequence blocks of at most ``block`` positions
    (the (B, block, V) logits of one block at a time).  Labels < 0 are
    ignored.  Returns (sum_loss, num_valid)."""
    B_, S, E = hidden.shape
    blk = min(block, S)
    while S % blk:
        blk -= 1
    head = _head(cfg, params)
    total = hidden.new_zeros(())
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for s0 in range(0, S, blk):
        h = hidden[:, s0:s0 + blk]
        y = labels[:, s0:s0 + blk]
        lg = _softcap_logits(cfg, f32up(h @ head))
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, y.clamp_min(0)[..., None])[..., 0]
        valid = y >= 0
        total = total + torch.where(valid, lse - gold, torch.zeros_like(lse)).sum()
        count = count + valid.sum()
    return total, count


def loss_fn(cfg: ModelConfig, params, batch, *, remat: str = "none",
            block_q: int = 512, block_k: int = 512):
    """batch: dict(tokens (B,S), labels (B,S)) int tensors, with
    ``prefix_embed`` (B, Np, E) or ``frames`` (B, Se, E) float tensors
    for the VLM and encoder-decoder families.  The prefix positions take
    label -1 (no loss).  Returns ``(xent + aux, metrics)`` like the
    reference's ``loss_fn``.  ``remat="block"`` recomputes each period
    layer in the backward (:func:`_decoder`); the port's default is
    ``"none"``, where the reference's is ``"block"`` (a kept difference:
    the same losses and gradients, a third more FLOPs).  ``block_q`` /
    ``block_k``: the attention's blocks."""
    prefix = batch.get("prefix_embed")
    hidden, _, aux = _decoder(cfg, params, batch["tokens"], prefix_embed=prefix,
                              enc_frames=batch.get("frames"), remat=remat,
                              block_q=block_q, block_k=block_k)
    labels = batch["labels"]
    if prefix is not None:
        pad = labels.new_full((labels.shape[0], prefix.shape[1]), -1)
        labels = torch.cat([pad, labels], dim=1)
    s, n = chunked_xent(cfg, params, hidden, labels)
    loss = s / n.clamp_min(1)
    return loss + aux, {"xent": loss, "aux": aux, "tokens": n}


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _is_axes(x) -> bool:
    return (isinstance(x, tuple) and len(x) > 0
            and all(isinstance(e, (str, type(None))) for e in x))


_CROSS_KV = ("xk", "xv")          # cross-attention k / v: the encoder's length


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, axes: bool = False, device=None,
               enc_len: int | None = None):
    """Zero cache, one per block's mixer (``axes=True``: the logical-axes
    tree instead).  A ``shared_attn`` layer gets an attention cache of its
    own: each invocation of the shared block attends over its own keys.
    A cross-attention decoder's ``attn`` layers add ``xk`` / ``xv`` (B,
    ``enc_len``, KH, D), ``enc_len`` defaulting to ``max_len`` as in the
    reference."""
    period, n_groups, rem = _schedule_groups(cfg)
    recurrent = {"mamba2": (M2.mamba2_cache_axes, M2.mamba2_init_cache),
                 "mlstm": (XL.mlstm_cache_axes, XL.mlstm_init_cache),
                 "slstm": (XL.slstm_cache_axes, XL.slstm_init_cache)}

    def one(bd):
        if bd.mixer in recurrent:
            ax, mk = recurrent[bd.mixer]
            return ax() if axes else mk(cfg, batch, max_len, dtype, device=device)
        # a sliding layer keeps a full-length cache, masked by position
        if bd.mixer == "mla":
            return (B.mla_cache_axes() if axes else
                    B.mla_init_cache(cfg, batch, max_len, dtype, device=device))
        c = (B.attn_cache_axes() if axes else
             B.attn_init_cache(cfg, batch, max_len, dtype, device=device))
        if cfg.cross_attention and bd.mixer == "attn":
            x = (B.attn_cache_axes() if axes else B.attn_init_cache(
                cfg, batch, max_len if enc_len is None else enc_len, dtype,
                device=device))
            c.update(xk=x["k"], xv=x["v"])
        return c

    def stack(c):
        if axes:
            return tree_map(lambda a: ("layers",) + a, c, is_leaf=_is_axes)
        return tree_map(lambda a: a[None].repeat((n_groups,) + (1,) * a.dim()), c)

    group = tuple(stack(one(cfg.blocks[i])) for i in range(period))
    return {"layers": group if n_groups else (),
            "rem": tuple(one(cfg.block_at(n_groups * period + i))
                         for i in range(rem))}


def cache_axes_tree(cfg: ModelConfig):
    """Logical-axes tree congruent with :func:`init_cache` trees (whatever
    their ``enc_len``)."""
    return init_cache(cfg, 1, 1, axes=True)


def grow_cache(cfg: ModelConfig, cache, max_len: int):
    """Zero-extend every cache leaf along its ``kv_seq`` axis to
    ``max_len`` (dtype kept); recurrent leaves (no ``kv_seq`` axis) and
    the cross-attention ``xk`` / ``xv`` (the encoder's length, not the
    decoder's) pass through."""
    axes = cache_axes_tree(cfg)

    def grow(leaf, ax):
        si = ax.index("kv_seq")
        if leaf.shape[si] >= max_len:
            return leaf
        shape = list(leaf.shape)
        shape[si] = max_len
        out = leaf.new_zeros(shape)
        out.narrow(si, 0, leaf.shape[si]).copy_(leaf)
        return out

    return {part: tuple({k: (v if k in _CROSS_KV or "kv_seq" not in ax[k]
                             else grow(v, ax[k])) for k, v in c.items()}
                        for c, ax in zip(cache[part], axes[part], strict=True))
            for part in ("layers", "rem")}


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------

def logits_from_hidden(cfg: ModelConfig, params, hidden):
    return _softcap_logits(cfg, hidden @ _head(cfg, params).to(hidden.dtype))


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens, *, max_len=None, lengths=None,
            prefix_embed=None, enc_frames=None, block_q: int = 512,
            block_k: int = 512):
    """Forward over the prompt, building its KV cache; returns
    ``(last_logits (B, 1, V), cache)``.

    ``lengths`` ((B,) int): true prompt lengths of right-padded
    ``tokens`` — the logits are read at ``lengths - 1`` (after the
    prefix: at ``Np + lengths - 1``); causal attention keeps the
    positions before it independent of the padding, so a padded prefill
    reads what an exact-length prefill reads.  A recurrent block's final
    state has run over the padding, as in the reference: its cache is an
    exact-length prefill's only when no row is padded.  ``max_len``
    grows the cache to that length (:func:`grow_cache`) when it passes
    the TEXT length S, as the reference compares it, although a prefix
    prefill's cache holds Np + S positions (a ``max_len`` up to Np + S
    leaves it as it is).  ``prefix_embed`` / ``enc_frames`` as in
    :func:`forward`; the cross-attention's ``xk`` / ``xv`` keep the
    encoder's length.  ``block_q`` / ``block_k``: the attention's blocks
    (its ``differentiable=False`` form; the encoder keeps train mode).
    """
    Bsz, S = tokens.shape
    hidden, cache, _ = _decoder(cfg, params, tokens, mode="prefill",
                                prefix_embed=prefix_embed, enc_frames=enc_frames,
                                block_q=block_q, block_k=block_k)
    if lengths is None:
        last = hidden[:, -1:]
    else:
        Np = 0 if prefix_embed is None else prefix_embed.shape[1]
        idx = (torch.as_tensor(lengths, device=tokens.device).reshape(-1)
               .long() - 1 + Np).clamp_min(0)
        last = hidden[torch.arange(Bsz, device=tokens.device), idx][:, None]
    logits = logits_from_hidden(cfg, params, last)
    if max_len is not None and max_len > S:
        cache = grow_cache(cfg, cache, max_len)
    return logits, cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token, cache, cache_len):
    """One decode step: ``token`` (B, 1); ``cache_len`` (int, 0-d or (B,))
    counts the new token (and a prefix).  Returns ``(logits (B, 1, V),
    cache)``, the cache updated in place.  A cross-attention decoder
    reads the encoder's k / v from the cache (``xk`` / ``xv``) and
    encodes nothing: the reference's ``enc_frames`` argument, which its
    decode encodes and never reads, is not taken."""
    hidden, cache, _ = _decoder(cfg, params, token, mode="decode",
                                cache=cache, cache_len=cache_len)
    return logits_from_hidden(cfg, params, hidden), cache
