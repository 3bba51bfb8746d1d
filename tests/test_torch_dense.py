"""Port parity for the dense variants, qwen3-32b, phi4-mini-3.8b,
minitron-4b and gemma3-1b (``repro_torch`` vs ``repro``), at smoke size.

gemma3's parts first, each against the reference's own function: GeGLU,
``rms_norm(plus_one=True)``, the score softcap, the sliding-window
training attention at S = 64 past a window of 16 (against the
reference's online-softmax ``chunked_attention``), windowed
``decode_attention`` with each row's window starting past the first
16-position page, ``scale_embeddings``, and the layer mixers (global
layers at ``rope_theta_global``, sliding layers at ``rope_theta`` with
the window).  Then each of the four smoke configs, initialized by the
reference and carried over by ``convert.params_from_reference``: the
loss and its gradients, prefill plus 3 decode steps, the paged engine
against the contiguous path on the engine's own batches, one local step
+ sync.

Tolerances (float32 sums in another order throughout): layers and
attention rtol = atol = 1e-5; loss rtol 1e-5; each gradient leaf rtol
1e-5, atol 1e-5 x the leaf's largest entry (a norm scale's gradient sums
B*S terms with cancellation); logits rtol = atol = 1e-5 with equal cache
shapes; paged against contiguous |a - b| <= 1e-5 (1 + |b|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jcb
from repro.launch.steps import build_train as jbuild
from repro.models import base as jmbase
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.launch.steps import build_engine
from repro_torch.launch.steps import build_train as tbuild
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as tlayers
from repro_torch.models import lm
from repro_torch.utils import tree_flatten, tree_leaves, tree_map, tree_unflatten

torch.set_num_threads(2)

ARCHS = ("qwen3-32b", "phi4-mini-3.8b", "minitron-4b", "gemma3-1b")
B, S, W = 2, 64, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _params(arch, seed=0):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jmbase.materialize(jlm.param_specs(jcfg), jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


def _batch(vocab, seed=0, b=B, s=S):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# gemma3's parts
# ---------------------------------------------------------------------------

def test_geglu_matches_reference():
    rng = np.random.default_rng(0)
    g, u = (rng.normal(size=(2, 8, 96)).astype(np.float32) * 3 for _ in range(2))
    np.testing.assert_allclose(tlayers.geglu(_t(g), _t(u)).numpy(),
                               np.asarray(jlayers.geglu(jnp.asarray(g), jnp.asarray(u))),
                               **TOL)


def test_rms_norm_plus_one_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 128)).astype(np.float32)
    sc = rng.normal(size=(128,)).astype(np.float32) * 0.1
    for plus_one in (False, True):
        np.testing.assert_allclose(
            tlayers.rms_norm(_t(x), _t(sc), eps=1e-6, plus_one=plus_one).numpy(),
            np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(sc), eps=1e-6,
                                        plus_one=plus_one)), **TOL)
    assert not np.allclose(tlayers.rms_norm(_t(x), _t(sc), plus_one=True).numpy(),
                           tlayers.rms_norm(_t(x), _t(sc)).numpy())


def test_softcap_matches_reference():
    s = np.linspace(-200, 200, 801, dtype=np.float32)
    for cap in (0.0, 30.0, 50.0):
        np.testing.assert_allclose(tlayers._softcap(_t(s), cap).numpy(),
                                   np.asarray(jlayers._softcap(jnp.asarray(s), cap)),
                                   **TOL)
    cfg = tconfigs.get_smoke("gemma3-1b").replace(logit_softcap=30.0)
    jcfg = jconfigs.get_smoke("gemma3-1b").replace(logit_softcap=30.0)
    _, _, jp, tp = _params("gemma3-1b", seed=4)
    h = np.random.default_rng(4).normal(size=(2, 3, 128)).astype(np.float32) * 40
    got = lm.logits_from_hidden(cfg, tp, _t(h)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlm.logits_from_hidden(jcfg, jp, jnp.asarray(h))),
                               **TOL)
    assert np.abs(got).max() <= 30.0


@pytest.mark.parametrize("window,softcap,kh", [(16, 0.0, 1), (16, 20.0, 2),
                                               (5, 0.0, 4), (0, 20.0, 1)])
def test_windowed_training_attention_matches_chunked(window, softcap, kh):
    """S = 64 past the window: the port's ``chunked_attention`` against
    the reference's, both over 16-wide blocks (the window mask ``q - k <
    window`` and the causal one together)."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, S, 4, 32)).astype(np.float32) * 2
    k = rng.normal(size=(2, S, kh, 32)).astype(np.float32) * 2
    v = rng.normal(size=(2, S, kh, 32)).astype(np.float32)
    got = tlayers.chunked_attention(_t(q), _t(k), _t(v), window=window,
                                    softcap=softcap, block_q=16, block_k=16)
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=True, window=window, softcap=softcap,
                                     block_q=16, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if window:
        full = tlayers.chunked_attention(_t(q), _t(k), _t(v), softcap=softcap,
                                         block_q=16, block_k=16)
        assert torch.allclose(got[:, :window], full[:, :window], atol=1e-6)
        assert not torch.allclose(got[:, window:], full[:, window:], atol=1e-3)


@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_decode_attention_window_past_the_first_page(softcap):
    """Rows at their own cache lengths (20 and 37 of 48): a window of 16
    counts back from each row's ``cache_len``, past the first 16-position
    page, not from the cache's length."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 1, 4, 32)).astype(np.float32)
    kc = rng.normal(size=(2, 48, 1, 32)).astype(np.float32)
    vc = rng.normal(size=(2, 48, 1, 32)).astype(np.float32)
    clen = np.array([20, 37], np.int32)
    got = tlayers.decode_attention(_t(q), _t(kc), _t(vc), cache_len=_t(clen),
                                   window=16, softcap=softcap)
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                    cache_len=jnp.asarray(clen), window=16,
                                    softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the same as attending to the last 16 positions alone
    for r, n in enumerate(clen):
        alone = tlayers.decode_attention(_t(q[r:r + 1]), _t(kc[r:r + 1, n - 16:n]),
                                         _t(vc[r:r + 1, n - 16:n]), cache_len=16,
                                         softcap=softcap)
        np.testing.assert_allclose(got[r:r + 1].numpy(), alone.numpy(), **TOL)


def test_scale_embeddings_and_the_unscaled_tied_head():
    jcfg, tcfg, jp, tp = _params("gemma3-1b", seed=5)
    assert tcfg.scale_embeddings and tcfg.tie_embeddings
    toks = _batch(tcfg.vocab_size, seed=5)["tokens"]
    got = lm._embed_tokens(tcfg, tp, _t(toks).long())
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jlm._embed_tokens(jcfg, jp, jnp.asarray(toks), None)),
                               **TOL)
    np.testing.assert_allclose(got.numpy(), tp["embed"][_t(toks).long()].numpy()
                               * np.sqrt(tcfg.d_model), rtol=1e-6)
    assert torch.equal(lm._head(tcfg, tp), tp["embed"].t())


@pytest.mark.parametrize("mixer", ["attn_sliding", "attn"])
def test_layer_mixers_take_their_theta_and_window(mixer):
    """Each mixer of gemma3-smoke on a (2, 64) batch in train mode against
    the reference's ``_apply_mixer``: the global layer at
    ``rope_theta_global``, the sliding one at ``rope_theta`` and its window
    of 16.  Swapping the thetas moves the output, so the check sees them."""
    jcfg, tcfg, jp, tp = _params("gemma3-1b", seed=6)
    assert tcfg.rope_theta_global != tcfg.rope_theta and tcfg.sliding_window == 16
    i = [bd.mixer for bd in tcfg.blocks].index(mixer)
    bd = tcfg.blocks[i]
    x = np.random.default_rng(6).normal(size=(2, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).copy()
    jlp = jax.tree.map(lambda a: a[0], jp["layers"][i])
    tlp = tree_map(lambda a: a[0], tp["layers"][i])
    want, _ = jlm._apply_mixer(jcfg, bd, jlp, None, jnp.asarray(x),
                               jblocks.Ctx(mode="train", positions=jnp.asarray(pos)))
    got, _ = lm._apply_mixer(tcfg, bd, tlp, _t(x),
                             tblocks.Ctx(mode="train", positions=_t(pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    swapped = tcfg.replace(rope_theta=tcfg.rope_theta_global,
                           rope_theta_global=tcfg.rope_theta)
    moved, _ = lm._apply_mixer(swapped, bd, tlp, _t(x),
                               tblocks.Ctx(mode="train", positions=_t(pos)))
    assert not torch.allclose(moved, got, atol=1e-4)


def test_gemma3_keeps_its_pattern_when_cut():
    """26 layers are 4 stacked groups of the 5 sliding : 1 global pattern
    plus 2 remainder layers (sliding), as in the reference; a depth cut to
    7 keeps the pattern (one group, one sliding remainder)."""
    for layers, groups, rem in ((26, 4, 2), (7, 1, 1)):
        tcfg = tconfigs.get("gemma3-1b").replace(num_layers=layers)
        jcfg = jconfigs.get("gemma3-1b").replace(num_layers=layers)
        assert lm._schedule_groups(tcfg) == jlm._schedule_groups(jcfg) == (6, groups, rem)
        specs = lm.param_specs(tcfg)
        assert len(specs["layers"]) == 6 and len(specs["rem"]) == rem
        assert specs["layers"][0]["ln1p"].shape == (groups, tcfg.d_model)
        assert [bd.mixer for bd in tcfg.layer_schedule()].count("attn") == layers // 6


# ---------------------------------------------------------------------------
# the four archs, end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, tcfg, jp, tp = _params(arch, seed=1)
    batch = _batch(tcfg.vocab_size, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    leaves, treedef = tree_flatten(tp)
    leaves = [a.clone().requires_grad_(True) for a in leaves]
    tloss, tm = lm.loss_fn(tcfg, tree_unflatten(treedef, leaves),
                           {k: _t(v).long() for k, v in batch.items()})
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tm["xent"]), float(jm["xent"]), rtol=1e-5)
    assert float(tm["aux"]) == 0.0
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(leaves)
    for a, b in zip(leaves, jleaves):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """A 40-token prompt (past gemma3-smoke's window of 16), then 3 decode
    steps: logits within 1e-5, equal cache shapes."""
    jcfg, tcfg, jp, tp = _params(arch, seed=2)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, tcfg.vocab_size, (B, 40))
    forced = rng.integers(0, tcfg.vocab_size, (B, 3))
    jl, jc = jlm.prefill(jcfg, jp, jnp.asarray(prompts, jnp.int32), max_len=48)
    tl, tc = lm.prefill(tcfg, tp, _t(prompts), max_len=48)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill", **TOL)
    assert [tuple(x.shape) for x in tree_leaves(tc)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jc)]
    for i in range(forced.shape[1]):
        cl = np.array([41 + i, 41 + i], np.int32)
        jl, jc = jlm.decode_step(jcfg, jp, jnp.asarray(forced[:, i:i + 1], jnp.int32),
                                 jc, jnp.asarray(cl))
        tl, tc = lm.decode_step(tcfg, tp, _t(forced[:, i:i + 1]), tc, _t(cl))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"decode step {i}", **TOL)
    is_axes = lambda x: isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(e, (str, type(None))) for e in x)
    assert tree_leaves(lm.cache_axes_tree(tcfg), is_leaf=is_axes) == \
        jax.tree.leaves(jlm.cache_axes_tree(jcfg), is_leaf=is_axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_contiguous_decode_on_its_batches(arch):
    """Mixed-length requests (prompts up to 30, past gemma3-smoke's window)
    on the paged engine (3 slots, pages of 4): each program's inputs,
    replayed through the contiguous ``lm.prefill`` / ``lm.decode_step``
    on a (slots, max_len) cache (idle rows zeroed, as the null page
    reads), give the paged step's logits row for row; the tokens equal
    each request's isolated contiguous greedy decode."""
    _, tcfg, _, tp = _params(arch, seed=3)
    slots, max_len = 3, 48
    is_axes = lambda x: isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(e, (str, type(None))) for e in x)
    bdim = [ax.index("batch") for ax in
            tree_leaves(lm.cache_axes_tree(tcfg), is_leaf=is_axes)]
    cont = None
    seen = {"prefill": 0, "decode": 0, "worst": 0.0}

    def hook(kind, rows, logits, inputs):
        nonlocal cont
        tok, lens = inputs
        live = [s for s, _ in rows]
        seen[kind] += 1
        if kind == "prefill":
            _, c = lm.prefill(tcfg, tp, tok, lengths=lens, max_len=max_len)
            if cont is None:
                cont = c
            idx = torch.tensor(live)
            for dst, src, d in zip(tree_leaves(cont), tree_leaves(c), bdim):
                dst.index_copy_(d, idx, src.index_select(d, idx))
            return
        for leaf, d in zip(tree_leaves(cont), bdim):
            leaf.index_fill_(d, torch.nonzero(lens == 0)[:, 0], 0.0)
        want, _ = lm.decode_step(tcfg, tp, tok, cont, lens)
        err = ((logits - want).abs() / (1 + want.abs()))[lens > 0]
        seen["worst"] = max(seen["worst"], float(err.max()))

    eng = build_engine(tcfg, type("S", (), {"global_batch": slots, "seq_len": max_len})(),
                       tp, page_size=4, device="cpu", on_logits=hook)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, tcfg.vocab_size, rng.integers(2, 31)).tolist(),
             int(rng.integers(2, 10))) for _ in range(6)]
    uids = [eng.submit(p, max_new=n) for p, n in reqs]
    with torch.no_grad():
        got = {r.uid: r for r in eng.run()}
    assert len(got) == len(reqs) and eng.idle
    assert seen["prefill"] >= 2 and seen["decode"] > 0
    assert seen["worst"] <= 1e-5
    assert not any(bool(pool[0].any()) for pool in eng.pools)       # null page
    for uid, (p, n) in zip(uids, reqs):
        lg, c = lm.prefill(tcfg, tp, torch.tensor([p]), max_len=max_len)
        want = [int(lg[0, -1].argmax())]
        for i in range(n - 1):
            lg, c = lm.decode_step(tcfg, tp, torch.tensor([[want[-1]]]), c,
                                   len(p) + 1 + i)
            want.append(int(lg[0, -1].argmax()))
        assert got[uid].tokens == want, uid


def _run(cb, cfg):
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", S, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=1, sync_compression="ef_sign",
                                    wire_pack=True),
        optim=cb.OptimConfig(base_lr=0.3, base_batch=W * B, weight_decay=1e-2,
                             grad_clip=1.0))


def _near_zero(deltas):
    """(rows, 128) bool: elements whose delta is within rounding of zero
    (1e-6 of the largest) for some worker: where sign may flip."""
    return [(d.abs() <= 1e-6 * d.abs().max()).any(dim=0) for d in deltas]


@pytest.mark.parametrize("arch", ARCHS)
def test_local_step_and_wire_packed_sync_match_reference(arch):
    """One resident local step and one wire-packed EF-sign sync at W=2:
    the loss within 1e-5; params, anchor and EF memory within 1e-5 x the
    bucket's largest entry, except at zero-delta sign flips, which are
    counted (each off element must sit where a delta is within rounding
    of zero) and printed."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jb = jbuild(_run(jcb, jcfg), num_workers=W, use_kernel=True)
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    js = jb.init(jax.random.PRNGKey(1), p0)
    tb = tbuild(_run(tcb, tcfg), num_workers=W, device="cpu")
    ts = tb.init(params_from_reference(jax.tree.map(np.asarray, p0), "cpu"))
    assert tb.sync_plan.wire_pack and tb.sync_plan.describe() == jb.sync_plan.describe()
    batch = next(iter(ShardedBatches(lm_examples(markov_lm(
        vocab=tcfg.vocab_size, num_seqs=16, seq_len=S)), W, B)))
    js, jm = jax.jit(jb.local_step)(js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts, tm = tb.local_step(ts, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    near = _near_zero([a[None] - p for a, p in zip(ts.anchor.buckets,
                                                     ts.params.buckets)])
    js = jax.jit(lambda s: jb.sync(s, plan=jb.sync_plan, scope="global"))(js)
    ts = tb.sync(ts, plan=tb.sync_plan)
    flips = {}
    for f in ("params", "momentum", "anchor", "ef_memory"):
        for a, b, nz in zip(getattr(ts, f).buckets, getattr(js, f).buckets, near,
                            strict=True):
            b = np.asarray(b)
            off = torch.from_numpy(np.abs(a.numpy() - b) > 1e-5 * np.abs(b).max())
            off = off.reshape(-1, *nz.shape).any(dim=0)
            assert not (off & ~nz).any(), (f, int((off & ~nz).sum()))
            flips[f] = int(off.sum())
    print(f"{arch}: zero-delta sign flips {flips}")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_specs_match_reference(arch):
    """The full and smoke configs field for field; the param specs in
    ``jax.tree.flatten`` order (gemma3's ``ln1p`` / ``ln2p`` included)
    with the reference's init law and parameter count."""
    from repro.models.base import count_params as jcount
    from repro_torch.models.base import count_params as tcount
    from repro_torch.models.base import is_spec
    for get in ("get", "get_smoke"):
        jc, tc = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        js, ts = jlm.param_specs(jc), lm.param_specs(tc)
        assert [(s.shape, s.axes, s.init, s.scale) for s in tree_leaves(ts, is_leaf=is_spec)] \
            == [(s.shape, s.axes, s.init, s.scale)
                for s in jax.tree.leaves(js, is_leaf=jmbase.is_spec)]
        assert tcount(ts) == jcount(js)
        assert ("head" in ts) == (not tc.tie_embeddings)
    # convert.py carries every leaf of the smoke config over, none missing
    # or extra (gemma3's ln1p / ln2p, the untied heads)
    _, tcfg, jp, tp = _params(arch)
    assert tree_flatten(tp)[1] == tree_flatten(lm.param_specs(tcfg), is_leaf=is_spec)[1]
    assert [tuple(t.shape) for t in tree_leaves(tp)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jp)]
