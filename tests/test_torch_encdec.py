"""Port parity for the encoder-decoder family, whisper-small (a non-causal
encoder over stubbed frame embeddings, cross-attention in every decoder
layer), and the cases it shares with the prefix-token family,
internvl2-76b, parametrised over both (``repro_torch`` vs ``repro``, on
the CPU at smoke size): the new layers (sinusoidal positions, layer
norm, the tanh-GELU FFN, non-causal attention with Sq != Sk), the
cross-attention in its three modes, the encoder, configs, specs and
bucket layouts (full size too: 278,575,104 and 70,620,815,360 params),
the loss and its gradients, the cache trees, prefill / decode against
the teacher-forced forward, ``make_train_batch``, the page layouts, the
engine's refusal, W=2 post-local SGD trajectories, a W=1 ``fit``, and
``convert`` / ``save_flat``.  internvl2's own cases (the prefix, its
labels, its prefill offsets, the text-only engine) are in
``test_torch_prefix.py``.

The JAX weights (``repro.models.base.materialize``) are carried over
through numpy; inputs are numpy arrays from seeded generators.
Tolerances: layers rtol = atol = 1e-5 (float32, another summation
order); loss rtol 1e-5; each gradient leaf rtol 1e-5, atol 1e-5 x the
leaf's largest entry; logits and caches against the reference rtol =
atol = 1e-4 (the serving tests' tolerance); decode against the
teacher-forced forward |a - b| <= 2e-4 x (1 + |b|) (the reference's
``tests/test_decode.py``); the trajectories as in
``test_torch_recurrent``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.configs import base as jcb
from repro.core import flatbuf as jfb
from repro.data.partition import ShardedBatches as JBatches
from repro.launch import inputs as jinputs
from repro.launch import train as jtrain
from repro.launch.steps import build_engine as jbuild_engine
from repro.launch.steps import build_train as jbuild
from repro.models import base as jmbase
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serving import paged as jpaged
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpoint import restore_flat, save_flat
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference
from repro_torch.core import flatbuf as tfb
from repro_torch.core.schedule import sync_boundaries
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.launch import inputs as tinputs
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import build_engine, build_serve
from repro_torch.launch.steps import build_train as tbuild
from repro_torch.models import base as tmbase
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as tlayers
from repro_torch.models import lm
from repro_torch.models.base import ShapeDtype
from repro_torch.serving import paged
from repro_torch.utils import tree_flatten, tree_leaves, tree_map, tree_unflatten

torch.set_num_threads(2)

ARCHS = ("whisper-small", "internvl2-76b")
COUNTS = {"whisper-small": 278_575_104, "internvl2-76b": 70_620_815_360}
B, S, SE, W = 2, 16, 24, 2          # batch, text tokens, encoder frames, workers
DECODE_TOL = 2e-4


def _is_axes(x):
    return isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(e, (str, type(None))) for e in x)


def _params(arch, seed=0):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jmbase.materialize(jlm.param_specs(jcfg), jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


def _extras(cfg, rng, b=B, se=SE):
    """The family's float inputs (numpy float32): whisper's ``frames``
    (b, se, E), internvl2's ``prefix_embed`` (b, Np, E)."""
    if cfg.family == "audio":
        return {"frames": rng.normal(size=(b, se, cfg.d_model)).astype(np.float32)}
    return {"prefix_embed": rng.normal(
        size=(b, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)}


def _kw(extras, to):
    """The model's keyword arguments for a batch's extras (``frames`` is
    ``enc_frames`` there), each through ``to``."""
    return {("enc_frames" if k == "frames" else k): to(v) for k, v in extras.items()}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, msg="", tol=1e-4):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


def _rel_close(got, want, tol, msg=""):
    err = float((np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
                 / (1 + np.abs(np.asarray(want, np.float64)))).max())
    assert err <= tol, (msg, err)


# ---------------------------------------------------------------------------
# Layers and blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_pos,dim", [(24, 128), (1500, 768), (7, 10)])
def test_sinusoidal_positions_match_reference(num_pos, dim):
    """Within 1e-5 + num_pos x 2^-23: the frequencies come from float32
    ``exp``, whose last bit may differ between the libraries, and the
    angle ``pos x freq`` carries that bit times the position."""
    got = tlayers.sinusoidal_positions(num_pos, dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (num_pos, dim)
    want = np.asarray(jlayers.sinusoidal_positions(num_pos, dim))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 + num_pos * 2.0 ** -23)


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 64)) * 3 + 1).astype(np.float32)
    sc, bi = rng.normal(size=(2, 64)).astype(np.float32)
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi))
    got = tlayers.layer_norm(_t(x), _t(sc), _t(bi))
    _close(got.numpy(), np.asarray(want), tol=1e-5)
    bf = tlayers.layer_norm(_t(x).bfloat16(), _t(sc), _t(bi))
    assert bf.dtype == torch.bfloat16


def test_gelu_ffn_is_the_tanh_form_like_the_reference():
    """``jax.nn.gelu`` defaults to the tanh approximation: the port's
    GELU FFN matches it, and torch's exact erf form would not."""
    cfg = tconfigs.get_smoke("whisper-small")
    jcfg = jconfigs.get_smoke("whisper-small")
    specs = jblocks.ffn_specs(jcfg, "gelu")
    assert [(k, s.shape, s.init) for k, s in sorted(specs.items())] == \
        [(k, s.shape, s.init) for k, s in sorted(tblocks.ffn_specs(cfg, "gelu").items())]
    jp = jmbase.materialize(specs, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    jp = {**jp, "b1": jnp.asarray(rng.normal(size=jp["b1"].shape), jnp.float32),
          "b2": jnp.asarray(rng.normal(size=jp["b2"].shape), jnp.float32)}
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    want = np.asarray(jblocks.ffn_apply(jcfg, jp, jnp.asarray(x), jblocks.Ctx(), "gelu"))
    got = tblocks.ffn_apply(cfg, tp, _t(x), "gelu").numpy()
    _close(got, want, tol=1e-5)
    erf = (torch.nn.functional.gelu(_t(x) @ tp["w1"] + tp["b1"]) @ tp["w2"]
           + tp["b2"]).numpy()
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("sq,sk,h,kh", [(16, 24, 4, 4), (5, 33, 4, 2), (24, 24, 8, 1)])
def test_noncausal_attention_matches_reference(sq, sk, h, kh):
    """The port's ``chunked_attention(causal=False)`` against the
    reference's (blocks of 8, so the online softmax streams several key
    blocks; 5 and 33 trim them to 5 and 3) and the O(S^2) oracle, with
    GQA, Sq != Sk and a softcap."""
    rng = np.random.default_rng(sq + sk)
    q = rng.normal(size=(2, sq, h, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, sk, kh, 32)).astype(np.float32) for _ in range(2))
    for softcap in (0.0, 5.0):
        want = jlayers.chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
            softcap=softcap, block_q=8, block_k=8)
        got = tlayers.chunked_attention(_t(q), _t(k), _t(v), causal=False,
                                        softcap=softcap, block_q=8, block_k=8)
        _close(got.numpy(), np.asarray(want), tol=1e-5)
    oracle = tlayers.reference_attention(_t(q), _t(k), _t(v), causal=False)
    _close(tlayers.chunked_attention(_t(q), _t(k), _t(v), causal=False,
                                     block_q=8, block_k=8).numpy(),
           oracle.numpy(), tol=1e-5)


def test_cross_attention_train_prefill_decode_match_reference():
    """``cross_attn_apply``: train computes k / v from the encoder output;
    prefill also returns them as ``xk`` / ``xv``; decode reads them from
    the cache (no encoder output given) and returns that cache.  No
    ``q_norm`` / ``k_norm`` even under ``qk_norm``, and neither
    ``attn_scale`` nor the softcap (the reference passes neither)."""
    jcfg = jconfigs.get_smoke("whisper-small").replace(
        qk_norm=True, attn_scale=0.5, logit_softcap=3.0)
    tcfg = tconfigs.get_smoke("whisper-small").replace(
        qk_norm=True, attn_scale=0.5, logit_softcap=3.0)
    specs = jblocks.attn_specs(jcfg, cross=True)
    assert sorted(specs) == sorted(tblocks.attn_specs(tcfg, cross=True)) \
        == ["wk", "wo", "wq", "wv"]
    assert "q_norm" in tblocks.attn_specs(tcfg)
    jp = jmbase.materialize(specs, jax.random.PRNGKey(1))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 6, tcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(B, SE, tcfg.d_model)).astype(np.float32)
    for mode in ("train", "prefill"):
        jy, jc = jblocks.cross_attn_apply(
            jcfg, jp, jnp.asarray(x),
            jblocks.Ctx(mode=mode, enc_out=jnp.asarray(enc), block_q=6, block_k=8))
        ty, tc = tblocks.cross_attn_apply(
            tcfg, tp, _t(x), tblocks.Ctx(mode=mode, enc_out=_t(enc)))
        _close(ty.numpy(), np.asarray(jy), mode)
        assert (tc is None) == (jc is None) == (mode == "train")
    assert sorted(tc) == ["xk", "xv"]
    for a in ("xk", "xv"):
        assert tuple(tc[a].shape) == (B, SE, tcfg.num_kv_heads, tcfg.resolved_head_dim)
        _close(tc[a].numpy(), np.asarray(jc[a]), a)
    cache = {"k": torch.zeros(1), **tc}
    jy, jc2 = jblocks.cross_attn_apply(
        jcfg, jp, jnp.asarray(x[:, :1]),
        jblocks.Ctx(mode="decode", cache={k: jnp.asarray(v.numpy()) for k, v in cache.items()}))
    ty, tc2 = tblocks.cross_attn_apply(tcfg, tp, _t(x[:, :1]),
                                       tblocks.Ctx(mode="decode", cache=cache))
    assert tc2 is cache
    _close(ty.numpy(), np.asarray(jy), "decode")
    # decode over the cache = train over the encoder output, row 0
    _close(ty.numpy(), tblocks.cross_attn_apply(
        tcfg, tp, _t(x[:, :1]), tblocks.Ctx(enc_out=_t(enc)))[0].numpy(), tol=1e-5)


def test_encoder_matches_reference():
    jcfg, tcfg, jp, tp = _params("whisper-small", seed=2)
    frames = np.random.default_rng(2).normal(size=(B, SE, tcfg.d_model)).astype(np.float32)
    want = jlm._encode(jcfg, jp, jnp.asarray(frames),
                       jblocks.Ctx(block_q=8, block_k=8))
    got = lm._encode(tcfg, tp, _t(frames))
    _close(got.numpy(), np.asarray(want))
    assert tuple(got.shape) == (B, SE, tcfg.d_model)


# ---------------------------------------------------------------------------
# Configs, specs, layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_configs_equal_reference(arch, size):
    get = (lambda m: m.get(arch)) if size == "full" else (lambda m: m.get_smoke(arch))
    jc, tc = get(jconfigs), get(tconfigs)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert jc.citation == tc.citation
    # the registries agree: every reference arch, every pair of the matrix
    assert tconfigs.ARCHS == jconfigs.ARCHS and arch in tconfigs.ARCHS
    assert tconfigs.SKIPS == jconfigs.SKIPS
    assert tconfigs.runnable_pairs() == jconfigs.runnable_pairs()
    assert (arch, "long_500k") in tconfigs.SKIPS


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_param_specs_and_layout_match_reference(arch, size):
    """The same leaves in ``jax.tree.flatten`` order (``embed < enc <
    final_norm < frontend < head < layers < rem``; the decoder layers'
    ``lnx`` / ``xattn``; the encoder's 1-tuple of stacked dicts), the same
    init law, weight-decay mask and bucket layout row for row: the
    stacked ``b1`` and encoder norms take decay, ``enc.norm`` does not."""
    get = (lambda m: m.get(arch)) if size == "full" else (lambda m: m.get_smoke(arch))
    jcfg, tcfg = get(jconfigs), get(tconfigs)
    jspecs, tspecs = jlm.param_specs(jcfg), lm.param_specs(tcfg)
    jl = jax.tree.leaves(jspecs, is_leaf=jmbase.is_spec)
    tl = tree_leaves(tspecs, is_leaf=tmbase.is_spec)
    assert [(s.shape, s.axes, s.init, s.scale) for s in tl] == \
        [(s.shape, s.axes, s.init, s.scale) for s in jl]
    assert tmbase.count_params(tspecs) == jmbase.count_params(jspecs)
    if size == "full":
        assert tmbase.count_params(tspecs) == COUNTS[arch]
    keys = sorted(tspecs)
    assert "frontend" in keys and ("enc" in keys) == (arch == "whisper-small")
    layer = tspecs["layers"][0]
    assert ("xattn" in layer and "lnx" in layer) == (arch == "whisper-small")
    jwd, twd = jmbase.norm_param_mask(jspecs), tmbase.norm_param_mask(tspecs)
    assert tree_leaves(twd) == jax.tree.leaves(jwd)
    if arch == "whisper-small":
        enc = tspecs["enc"]
        assert isinstance(enc["layers"], tuple) and len(enc["layers"]) == 1
        n = tcfg.encoder_layers
        assert enc["layers"][0]["ffn"]["b1"].shape == (n, tcfg.d_ff)
        assert twd["enc"]["norm"] and not twd["enc"]["layers"][0]["ln1"]
        assert not twd["enc"]["layers"][0]["ffn"]["b1"]
        assert "q_norm" not in layer["xattn"]
    if size == "full" and arch == "internvl2-76b":
        return      # 70.6 B params: the layout below is the same code path
    jlay = jfb.build_layout(jmbase.abstract(jspecs, jnp.float32), wd_mask=jwd)
    tlay = tfb.build_layout(tmbase.abstract(tspecs), wd_mask=twd)
    assert tlay.bucket_rows == jlay.bucket_rows
    assert [(s.row_offset, s.rows, s.size, s.shape, s.skip_wd) for s in tlay.slots] == \
        [(s.row_offset, s.rows, s.size, s.shape, s.skip_wd) for s in jlay.slots]


def test_internvl2_full_layout_at_cut_depths():
    """internvl2-76b's bucket layout at the depths the card runs (1 and 2
    layers): the reference's rows, and the counts of ``m_reckon``
    (3,024,117,760 and 3,879,772,160 params)."""
    for layers, count in ((1, 3_024_117_760), (2, 3_879_772_160)):
        jcfg = jconfigs.get("internvl2-76b").replace(num_layers=layers)
        tcfg = tconfigs.get("internvl2-76b").replace(num_layers=layers)
        jspecs, tspecs = jlm.param_specs(jcfg), lm.param_specs(tcfg)
        assert tmbase.count_params(tspecs) == count
        jlay = jfb.build_layout(jmbase.abstract(jspecs, jnp.float32),
                                wd_mask=jmbase.norm_param_mask(jspecs))
        tlay = tfb.build_layout(tmbase.abstract(tspecs),
                                wd_mask=tmbase.norm_param_mask(tspecs))
        assert tlay.bucket_rows == jlay.bucket_rows
        assert tlay.bucket_rows[0] * 128 > 2 ** 31       # past int32 indexing


# ---------------------------------------------------------------------------
# Loss, caches, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """The loss with ``frames`` / ``prefix_embed`` and every gradient leaf
    (the encoder's, the frontend's and the cross-attention's too)."""
    jcfg, tcfg, jp, tp = _params(arch, seed=1)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], **_extras(tcfg, rng)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, jb, block_q=8, block_k=8), has_aux=True))(jp)
    leaves, treedef = tree_flatten(tp)
    leaves = [a.clone().requires_grad_(True) for a in leaves]
    tb = {k: _t(v).long() if v.dtype.kind == "i" else _t(v) for k, v in batch.items()}
    tloss, tm = lm.loss_fn(tcfg, tree_unflatten(treedef, leaves), tb)
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert int(tm["tokens"]) == int(jm["tokens"]) == B * S
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(leaves)
    for a, b in zip(leaves, jleaves):
        b = np.asarray(b)
        assert a.grad is not None and np.abs(b).max() > 0
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_trees_match_reference(arch):
    """``init_cache(enc_len=)`` shapes and dtypes, ``cache_axes_tree``, and
    ``grow_cache``: the self-attention k / v grow, whisper's ``xk`` /
    ``xv`` keep the encoder's length (passed through as they are; the
    axes and the grown shapes equal the reference's for every
    ``enc_len`` it is given)."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    for enc_len in (None, 30):
        jc = jlm.init_cache(jcfg, 3, 16, enc_len=enc_len)
        tc = lm.init_cache(tcfg, 3, 16, enc_len=enc_len)
        assert [(tuple(a.shape), str(a.dtype).removeprefix("torch."))
                for a in tree_leaves(tc)] == \
            [(b.shape, str(b.dtype)) for b in jax.tree.leaves(jc)]
        ta = tree_leaves(lm.cache_axes_tree(tcfg), is_leaf=_is_axes)
        assert ta == jax.tree.leaves(jlm.cache_axes_tree(jcfg, enc_len=enc_len),
                                     is_leaf=_is_axes)
        jg = jlm.grow_cache(jcfg, jc, 40, enc_len=enc_len)
        tg = lm.grow_cache(tcfg, tc, 40)
        assert [tuple(a.shape) for a in tree_leaves(tg)] == \
            [b.shape for b in jax.tree.leaves(jg)]
        layer, grown = tc["layers"][0], tg["layers"][0]
        assert sorted(layer) == (["k", "v", "xk", "xv"] if arch == "whisper-small"
                                 else ["k", "v"])
        for key in layer:
            assert (grown[key] is layer[key]) == (key in ("xk", "xv")), key
        if arch == "whisper-small":
            assert layer["xk"].shape[2] == (16 if enc_len is None else enc_len)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_and_forward(arch):
    """Prefill (with frames / the prefix) and decode: the prefill's logits
    and cache and the first decode step against the reference's (1e-4);
    then 4 decode steps against the teacher-forced train-mode forward
    (2e-4 x (1 + |logit|)), the cache written in place."""
    jcfg, tcfg, jp, tp = _params(arch, seed=2)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tcfg.vocab_size, (B, 14))
    ex = _extras(tcfg, rng)
    Np = tcfg.num_prefix_tokens if arch == "internvl2-76b" else 0
    pre, max_len = 10, 40
    jl, jc = jlm.prefill(jcfg, jp, jnp.asarray(toks[:, :pre], jnp.int32),
                         max_len=max_len, block_q=2, block_k=8, **_kw(ex, jnp.asarray))
    tl, tc = lm.prefill(tcfg, tp, _t(toks[:, :pre]), max_len=max_len, **_kw(ex, _t))
    _close(tl.numpy(), np.asarray(jl), "prefill")
    assert [tuple(x.shape) for x in tree_leaves(tc)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jc)]
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(a.numpy(), np.asarray(b), "prefill cache")
    jl, _ = jlm.decode_step(jcfg, jp, jnp.asarray(toks[:, pre:pre + 1], jnp.int32),
                            jc, jnp.int32(Np + pre + 1))
    with torch.no_grad():
        full = lm.logits_from_hidden(tcfg, tp, lm.forward(tcfg, tp, _t(toks),
                                                          **_kw(ex, _t)))
    held = tree_leaves(tc)
    rows = [tl[:, -1]]
    for i in range(pre, 14):
        lg, tc2 = lm.decode_step(tcfg, tp, _t(toks[:, i:i + 1]), tc, Np + i + 1)
        assert all(a is b for a, b in zip(tree_leaves(tc2), held))
        if i == pre:
            _close(lg.numpy(), np.asarray(jl), "decode step 0")
        rows.append(lg[:, -1])
    for j, r in enumerate(rows):
        _rel_close(r.numpy(), full[:, Np + pre - 1 + j].numpy(), DECODE_TOL,
                   f"position {pre - 1 + j}")


def test_reference_whisper_decode_drops_its_self_attention_write():
    """Pinned reference fault, not reproduced: the reference's
    ``apply_layer`` merges the cross-attention's decode cache (the dict it
    was given, holding the OLD k / v) over the self-attention's new one,
    so its decode returns a cache without the new token's k / v and its
    second step reads a zero key there.  The port writes the cache in
    place and its decode stays on the teacher-forced forward; the two
    agree on the first step."""
    jcfg, tcfg, jp, tp = _params("whisper-small", seed=6)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tcfg.vocab_size, (B, 12))
    ex = _extras(tcfg, rng)
    jl, jc = jlm.prefill(jcfg, jp, jnp.asarray(toks[:, :10], jnp.int32), max_len=16,
                         **_kw(ex, jnp.asarray))
    tl, tc = lm.prefill(tcfg, tp, _t(toks[:, :10]), max_len=16, **_kw(ex, _t))
    with torch.no_grad():
        full = lm.logits_from_hidden(tcfg, tp, lm.forward(tcfg, tp, _t(toks),
                                                          **_kw(ex, _t))).numpy()
    errs = []
    for i in (10, 11):
        jl, jc = jlm.decode_step(jcfg, jp, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                                 jc, jnp.int32(i + 1))
        tl, tc = lm.decode_step(tcfg, tp, _t(toks[:, i:i + 1]), tc, i + 1)
        assert not np.asarray(jc["layers"][0]["k"])[:, :, i].any()   # not written
        assert tc["layers"][0]["k"][:, :, i].abs().sum() > 0
        _rel_close(tl[:, 0].numpy(), full[:, i], DECODE_TOL, f"port step {i}")
        errs.append(np.abs(np.asarray(jl)[:, 0] - full[:, i]).max())
    assert errs[0] < 1e-4 and errs[1] > 1e-2, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_build_serve_passes_the_family_inputs(arch):
    """``build_serve``'s prefill passes ``batch["prefix_embed"]`` /
    ``batch["frames"]`` on (the reference's ``build_serve`` does too):
    its logits and cache are ``lm.prefill``'s with them.  Without frames
    a cross-attention decoder has nothing to attend to and raises (the
    reference fails there too, on ``None @ wk``)."""
    _, tcfg, _, tp = _params(arch, seed=7)
    rng = np.random.default_rng(7)
    toks = _t(rng.integers(0, tcfg.vocab_size, (B, 9)))
    ex = {k: _t(v) for k, v in _extras(tcfg, rng).items()}
    sb = build_serve(tcfg, device="cpu")
    lg, cache = sb.prefill(tp, {"tokens": toks, **ex})
    want, wc = lm.prefill(tcfg, tp, toks, **_kw(ex, lambda v: v))
    assert torch.equal(lg, want)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache), tree_leaves(wc)))
    if arch == "whisper-small":
        with pytest.raises(ValueError, match="enc_frames"):
            sb.prefill(tp, {"tokens": toks})
    else:
        bare, _ = sb.prefill(tp, {"tokens": toks})       # text-only
        assert not torch.allclose(lg, bare)


# ---------------------------------------------------------------------------
# Inputs, page layouts, the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ("paper-lm",))
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_train_batch_and_serve_specs_match_reference(arch, size):
    """``train_batch_shapes``, ``make_train_batch`` array for array (the
    same draws) and ``serve_token_specs``: whisper's decoder capped at 448
    tokens under 1,500 frames, internvl2's text after its prefix."""
    get = (lambda m: m.get(arch)) if size == "full" else (lambda m: m.get_smoke(arch))
    jcfg, tcfg = get(jconfigs), get(tconfigs)
    seq = 1500 if size == "full" else 40
    if arch == "internvl2-76b" and size == "full":
        seq = 512
    shape_j, shape_t = (cb.InputShape("t", seq, 4, "train") for cb in (jcb, tcb))
    assert tinputs.WHISPER_MAX_DECODER == jinputs.WHISPER_MAX_DECODER == 448
    assert tinputs.train_batch_shapes(tcfg, shape_t, 2) == \
        jinputs.train_batch_shapes(jcfg, shape_j, 2)
    if size == "smoke":
        jb = jinputs.make_train_batch(jcfg, shape_j, 2, seed=5)
        tb = tinputs.make_train_batch(tcfg, shape_t, 2, seed=5, device="cpu")
        assert list(tb) == list(jb)
        for k in jb:
            assert str(tb[k].dtype).removeprefix("torch.") == str(jb[k].dtype)
            assert np.array_equal(tb[k].numpy(), np.asarray(jb[k])), k
    for prefill in (True, False):
        js = jinputs.serve_token_specs(jcfg, shape_j, prefill=prefill)
        ts = tinputs.serve_token_specs(tcfg, shape_t, prefill=prefill)
        assert list(ts) == list(js)
        assert [(t.shape, str(t.dtype).removeprefix("torch.")) for t in ts.values()] \
            == [(j.shape, str(j.dtype)) for j in js.values()]
    if arch == "whisper-small" and size == "full":
        assert tinputs.train_batch_shapes(tcfg, shape_t, 4)["tokens"][0] == (4, 1, 448)


@pytest.mark.parametrize("arch", ARCHS)
def test_page_layouts_match_reference(arch):
    """``build_page_layout``: the rows per token and slots of the
    reference's layout, whatever ``enc_len`` the reference is given
    (whisper's per-token slices carry ``xk`` / ``xv``)."""
    tcfg, jcfg = tconfigs.get_smoke(arch), jconfigs.get_smoke(arch)
    tl = paged.build_page_layout(tcfg, page_size=4, max_len=20, num_pages=9)
    for enc_len in (None, 30):
        jl = jpaged.build_page_layout(jcfg, page_size=4, max_len=20, num_pages=9,
                                      enc_len=enc_len)
        assert tl.rows_per_token == jl.rows_per_token
        assert tl.pages_per_seq == jl.pages_per_seq and tl.leaf_axes == jl.leaf_axes
        assert tl.pool_bytes() == jl.pool_bytes()
        assert [(s.row_offset, s.rows, s.size, s.shape) for s in tl.token_layout.slots] \
            == [(s.row_offset, s.rows, s.size, s.shape) for s in jl.token_layout.slots]
    assert len(tl.leaf_axes) == (2 if arch == "internvl2-76b" else 4)


def test_build_engine_refuses_whisper_where_the_reference_fails_late():
    """The port's ``build_engine`` refuses a cross-attention config and
    names why; the reference's builds and fails at its first prefill (no
    encoder output to attend to)."""
    tcfg, jcfg = tconfigs.get_smoke("whisper-small"), jconfigs.get_smoke("whisper-small")
    shape = type("S", (), {"global_batch": 2, "seq_len": 16})()
    with pytest.raises(ValueError, match="encoder frames"):
        build_engine(tcfg, shape, device="cpu")
    eng = jbuild_engine(jcfg, shape, page_size=4, jit=False)
    eng.submit([1, 2, 3], max_new=2)
    with pytest.raises(TypeError):
        eng.run()


# ---------------------------------------------------------------------------
# Training: trajectories, fit, checkpoints
# ---------------------------------------------------------------------------

def _run(cb, cfg, mode, workers=W, steps=4):
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", S, workers * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=2, post_local_switch=2,
                                    sync_compression=mode),
        optim=cb.OptimConfig(base_lr=0.3, base_batch=W * B, weight_decay=1e-2,
                             grad_clip=1.0, lr_warmup_steps=1),
        steps=steps)


def _data(cfg, n, seed=0):
    """markov_lm examples (tokens, labels) plus the family's float inputs
    (float32 numpy), ``n`` of each; whisper's frames run SE long under S
    decoder tokens, internvl2's text fills S after its prefix."""
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=n, seq_len=S,
                                 seed=seed))
    return {**data, **_extras(cfg, np.random.default_rng(seed + 100), b=n)}


def _pinned(ts, js, fields):
    """The port's state with the reference's buffers (new tensors)."""
    return dataclasses.replace(ts, **{
        f: getattr(ts, f).with_buckets(tuple(
            torch.tensor(np.asarray(x)).to(t.dtype)
            for x, t in zip(getattr(js, f).buckets, getattr(ts, f).buckets, strict=True)))
        for f in fields if getattr(ts, f) is not None})


@pytest.mark.parametrize("mode", ["none", "ef_sign"])
@pytest.mark.parametrize("arch", ARCHS)
def test_post_local_trajectory_matches_reference(arch, mode):
    """Post-local SGD at W=2 (syncs at steps 0, 1, 3) through the bucket
    path of both packages, the batches carrying frames / prefix
    embeddings.  Every sync also runs on a port state holding the
    reference's own buffers: params and anchor within 1e-6 x their
    largest entry, momentum and EF memory within 1e-5 x.  The free port's
    sign flips are counted and printed, its loss held at rtol 1e-5 until
    the first flip, its end state at most 1e-4 of the elements beyond 1e-4
    x the largest, over the elements that never flipped."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jb = jbuild(_run(jcb, jcfg, mode), num_workers=W, use_kernel=True)
    tb = tbuild(_run(tcb, tcfg, mode), num_workers=W, device="cpu")
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    js = jb.init(jax.random.PRNGKey(1), p0)
    ts = tb.init(params_from_reference(jax.tree.map(np.asarray, p0), "cpu"))
    jstep = jax.jit(jb.local_step)
    jsync = jax.jit(lambda s: jb.sync(s, plan=jb.sync_plan, scope="global"))
    it = iter(ShardedBatches(_data(tcfg, 16), W, B))
    steps = 4
    syncs = dict(sync_boundaries(tb.run.local_sgd, steps))
    assert list(syncs) == [0, 1, 3]
    fields = ("params", "momentum", "anchor", "ef_memory")
    flips = []
    flipped = [torch.zeros((W,) + b.shape, dtype=torch.bool) for b in ts.anchor.buckets] \
        if mode != "none" else None
    for t in range(steps):
        batch = next(it)
        assert batch["tokens"].shape == (W, B, S)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tb.local_step(ts, batch)
        if not flips or sum(flips) == 0:
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        if t not in syncs:
            continue
        if mode != "none":
            bufs = lambda st: [
                [torch.as_tensor(np.asarray(x)) for x in getattr(st, f).buckets]
                for f in ("anchor", "params", "ef_memory")]
            ins = [[a[None] - p + e for a, p, e in zip(*bufs(st))] for st in (ts, js)]
            now = [(a >= 0) != (b >= 0) for a, b in zip(*ins)]
            flips.append(sum(int(x.sum()) for x in now))
            flipped = [x | y for x, y in zip(flipped, now)]
        pinned = _pinned(ts, js, fields)
        js = jsync(js)
        ts = tb.sync(ts, plan=tb.sync_plan)
        pinned = tb.sync(pinned, plan=tb.sync_plan)
        for f in fields:
            jf, tf = getattr(js, f), getattr(pinned, f)
            assert (jf is None) == (tf is None), f
            for a, b in zip(tf.buckets if tf else (), jf.buckets if jf else ()):
                b = np.asarray(b)
                tol = 1e-5 if f in ("momentum", "ef_memory") else 1e-6
                err = np.abs(a.numpy() - b).max() / np.abs(b).max()
                assert err <= tol, (f, err)
    print(f"{arch} {mode}: sign flips per sync {flips}")
    for f in fields:
        jf, tf = getattr(js, f), getattr(ts, f)
        for i, (a, b) in enumerate(zip(tf.buckets if tf else (), jf.buckets if jf else ())):
            b = np.asarray(b)
            beyond = np.abs(a.numpy() - b) > 1e-4 * np.abs(b).max()
            if flipped is not None:
                beyond &= ~flipped[i].numpy().any(axis=0)
            assert float(np.mean(beyond)) <= 1e-4, (f, flips)


@pytest.mark.parametrize("arch", ARCHS)
def test_fit_at_one_worker_matches_reference(arch):
    """``fit`` at W=1 (a sync is a no-op mean, the schedule's rounds are
    still counted) on the same weights and batches: per-step loss rtol
    1e-5, comm rounds equal."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    data = _data(tcfg, 12, seed=3)
    rj, rt = _run(jcb, jcfg, "none", workers=1, steps=5), _run(tcb, tcfg, "none",
                                                                 workers=1, steps=5)
    jb = jbuild(rj, num_workers=1, use_kernel=True)
    jb.local_step = jax.jit(jb.local_step)
    jb.sync = jax.jit(jb.sync, static_argnames=("group", "compression", "plan",
                                                 "scope"))
    _, jhist, jsum = jtrain.fit(rj, JBatches(data, 1, B), bundle=jb, seed=0,
                                log=lambda *a: None)
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    tb = tbuild(rt, num_workers=1, device="cpu")
    _, thist, tsum = ttrain.fit(rt, ShardedBatches(data, 1, B), bundle=tb,
                                params0=params_from_reference(
                                    jax.tree.map(np.asarray, p0), "cpu"),
                                log=lambda *a: None)
    assert len(thist) == len(jhist) == 5
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    assert tsum["comm_rounds"] == jsum["comm_rounds"]


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_and_save_flat_roundtrips(arch, tmp_path):
    """``params_from_reference`` keeps the tree (``enc``'s 1-tuple of
    stacked layers, ``frontend``, ``lnx`` / ``xattn``, the GELU biases); a
    reference ``save_flat`` restores into the port and a port
    ``save_flat`` into the reference, leaf for leaf exactly; the resident
    state crosses through ``save_flat`` / ``restore_flat`` too."""
    jcfg, tcfg, jp, tp = _params(arch, seed=5)
    jl = jax.tree.leaves(jp)
    tl, _ = tree_flatten(tp)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert sorted(tp) == sorted(jp)
    if arch == "whisper-small":
        assert tuple(tp["enc"]["layers"][0]["ffn"]["b1"].shape) == \
            (tcfg.encoder_layers, tcfg.d_ff)
        assert sorted(tp["layers"][0]) == ["ffn", "ln1", "ln2", "lnx", "mix", "xattn"]
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_flat(jpath, jp, step=3)
    got = restore_flat(jpath, tree_map(lambda x: ShapeDtype(tuple(x.shape), x.dtype), tp))
    for a, b in zip(tree_leaves(got), tl):
        assert torch.equal(a, b)
    save_flat(tpath, tp, step=3)
    back = jckpt.restore_flat(tpath, jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jp))
    for a, b in zip(jax.tree.leaves(back), jl):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    tb = tbuild(_run(tcb, tcfg, "ef_sign"), num_workers=W, device="cpu")
    st, _ = tb.local_step(tb.init(tp), next(iter(ShardedBatches(_data(tcfg, 8), W, B))))
    spath = str(tmp_path / "state")
    save_flat(spath, st, step=1)
    again = restore_flat(spath, st)
    for f in ("params", "momentum", "anchor", "ef_memory"):
        for a, b in zip(getattr(again, f).buckets, getattr(st, f).buckets):
            assert torch.equal(a, b), f
