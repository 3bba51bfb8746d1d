"""Port parity for the prefix-token family, internvl2-76b (stubbed ViT
patch embeddings projected by ``frontend`` and put before the text), on
the CPU at smoke size (``repro_torch`` vs ``repro``): the forward over
prefix + text, the loss's ``-1`` labels over the prefix, the prefill's
``lengths`` offset by the prefix, the pinned ``max_len``-versus-text-
length quirk, a decode's ``cache_len`` counting the prefix, the
``frontend``'s gradient, and the paged engine serving text-only as the
reference's does.  The cases it shares with whisper-small are in
``test_torch_encdec.py``.

The JAX weights are carried over through numpy; inputs are numpy arrays
from seeded generators.  Tolerances: hidden states, logits and caches
rtol = atol = 1e-4 (the serving tests'); loss rtol 1e-5; gradients
rtol 1e-5, atol 1e-5 x the leaf's largest entry; decode against the
teacher-forced forward |a - b| <= 2e-4 x (1 + |b|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.steps import build_engine as jbuild_engine
from repro.models import base as jmbase
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_reference
from repro_torch.launch.steps import build_engine
from repro_torch.models import lm
from repro_torch.utils import tree_flatten, tree_leaves, tree_unflatten

torch.set_num_threads(2)

ARCH = "internvl2-76b"
B, S = 2, 12


def _params(seed=0):
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jp = jmbase.materialize(jlm.param_specs(jcfg), jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s + 1)).astype(np.int32)
    pre = rng.normal(size=(B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return toks, pre


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=msg)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


def test_forward_puts_the_projected_prefix_before_the_text():
    """hidden (B, Np + S, E) equal to the reference's; the first Np rows
    see only the prefix (causal), so changing the text leaves them."""
    jcfg, tcfg, jp, tp = _params(1)
    toks, pre = _inputs(tcfg, 1)
    Np = tcfg.num_prefix_tokens
    want = jlm.forward(jcfg, jp, jnp.asarray(toks[:, :S]), prefix_embed=jnp.asarray(pre),
                       block_q=4, block_k=4)["hidden"]
    with torch.no_grad():
        got = lm.forward(tcfg, tp, _t(toks[:, :S]).long(), prefix_embed=_t(pre))
        other = lm.forward(tcfg, tp, _t(toks[:, 1:]).long(), prefix_embed=_t(pre))
    assert tuple(got.shape) == (B, Np + S, tcfg.d_model)
    _close(got.numpy(), np.asarray(want))
    assert torch.equal(got[:, :Np], other[:, :Np])
    assert not torch.allclose(got[:, Np:], other[:, Np:])


def test_loss_skips_the_prefix_positions():
    """The prefix takes label -1: the loss equals the reference's, counts
    B x S tokens, and equals the cross-entropy of the text positions'
    logits alone."""
    jcfg, tcfg, jp, tp = _params(2)
    toks, pre = _inputs(tcfg, 2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "prefix_embed": pre}
    jloss, jm = jlm.loss_fn(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()},
                            block_q=4, block_k=4)
    tb = {k: _t(v).long() if v.dtype.kind == "i" else _t(v) for k, v in batch.items()}
    with torch.no_grad():
        tloss, tm = lm.loss_fn(tcfg, tp, tb)
        hidden = lm.forward(tcfg, tp, tb["tokens"], prefix_embed=tb["prefix_embed"])
        lg = lm.logits_from_hidden(tcfg, tp, hidden[:, tcfg.num_prefix_tokens:])
        manual = torch.nn.functional.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                                   tb["labels"].reshape(-1))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert int(tm["tokens"]) == int(jm["tokens"]) == B * S
    np.testing.assert_allclose(float(tm["xent"]), float(manual), rtol=1e-5)


def test_frontend_takes_gradient_only_through_the_prefix():
    """With a prefix the ``frontend`` gradient is the reference's; a
    text-only batch leaves it without one (zero in the reference)."""
    jcfg, tcfg, jp, tp = _params(3)
    toks, pre = _inputs(tcfg, 3)
    for with_prefix in (True, False):
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if with_prefix:
            batch["prefix_embed"] = pre
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jg = jax.grad(lambda p: jlm.loss_fn(jcfg, p, jb, block_q=4, block_k=4)[0])(jp)
        leaves, treedef = tree_flatten(tp)
        leaves = [a.clone().requires_grad_(True) for a in leaves]
        params = tree_unflatten(treedef, leaves)
        tb = {k: _t(v).long() if v.dtype.kind == "i" else _t(v) for k, v in batch.items()}
        lm.loss_fn(tcfg, params, tb)[0].backward()
        want = np.asarray(jg["frontend"])
        got = params["frontend"].grad
        if with_prefix:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
        else:
            assert got is None and not want.any()


def test_padded_prefill_reads_lengths_after_the_prefix():
    """``lengths`` count text tokens: the logits sit at Np + lengths - 1,
    equal to the reference's and to an exact-length prefill's."""
    jcfg, tcfg, jp, tp = _params(4)
    toks, pre = _inputs(tcfg, 4)
    lengths = np.array([S, 5], np.int32)
    padded = toks[:, :S].copy()
    padded[1, 5:] = 0
    jl, jc = jlm.prefill(jcfg, jp, jnp.asarray(padded), lengths=jnp.asarray(lengths),
                         prefix_embed=jnp.asarray(pre), block_q=4, block_k=4)
    tl, tc = lm.prefill(tcfg, tp, _t(padded).long(), lengths=_t(lengths),
                        prefix_embed=_t(pre))
    _close(tl.numpy(), np.asarray(jl), "padded prefill")
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(a.numpy(), np.asarray(b), "padded prefill cache")
    el, _ = lm.prefill(tcfg, tp, _t(toks[1:, :5]).long(), prefix_embed=_t(pre[1:]))
    _close(tl[1:].numpy(), el.numpy(), "padded = exact length")
    nl, _ = lm.prefill(tcfg, tp, _t(padded).long(), lengths=_t(lengths))   # no prefix
    assert not torch.allclose(nl, tl)


@pytest.mark.parametrize("extra", [0, 3, 8, 9, 20])
def test_prefill_max_len_is_compared_with_the_text_length(extra):
    """Pinned quirk of the reference, reproduced: a prefix prefill grows
    its cache only when ``max_len`` passes the TEXT length S, while the
    cache holds Np + S positions; a ``max_len`` up to Np + S leaves the
    cache at Np + S, a larger one grows it to ``max_len`` (positions, the
    prefix included)."""
    jcfg, tcfg, jp, tp = _params(5)
    toks, pre = _inputs(tcfg, 5)
    Np = tcfg.num_prefix_tokens
    assert Np == 8
    max_len = S + extra
    _, jc = jlm.prefill(jcfg, jp, jnp.asarray(toks[:, :S]), max_len=max_len,
                        prefix_embed=jnp.asarray(pre), block_q=4, block_k=4)
    _, tc = lm.prefill(tcfg, tp, _t(toks[:, :S]).long(), max_len=max_len,
                       prefix_embed=_t(pre))
    lens = {int(x.shape[2]) for x in tree_leaves(tc)}
    assert lens == {int(x.shape[2]) for x in jax.tree.leaves(jc)}
    assert lens == {max(Np + S, max_len)}


def test_decode_cache_len_counts_the_prefix():
    """Decode after a prefix prefill takes ``cache_len = Np + text + 1``
    (as the reference's ``tests/test_decode.py``): 4 steps on the
    teacher-forced forward within 2e-4 x (1 + |logit|); counting the text
    alone writes over the prefix's last slots and reads other logits."""
    jcfg, tcfg, jp, tp = _params(6)
    toks, pre = _inputs(tcfg, 6)
    Np, pre_len = tcfg.num_prefix_tokens, 8
    with torch.no_grad():
        full = lm.logits_from_hidden(tcfg, tp, lm.forward(
            tcfg, tp, _t(toks[:, :S]).long(), prefix_embed=_t(pre))).numpy()
    lg, cache = lm.prefill(tcfg, tp, _t(toks[:, :pre_len]).long(), max_len=Np + S,
                           prefix_embed=_t(pre))
    assert _rel(lg[:, 0].numpy(), full[:, Np + pre_len - 1]) <= 2e-4
    jl, jc = jlm.prefill(jcfg, jp, jnp.asarray(toks[:, :pre_len]), max_len=Np + S,
                         prefix_embed=jnp.asarray(pre), block_q=4, block_k=4)
    for i in range(pre_len, pre_len + 4):
        tok = toks[:, i:i + 1]
        lg, cache = lm.decode_step(tcfg, tp, _t(tok).long(), cache, Np + i + 1)
        jl, jc = jlm.decode_step(jcfg, jp, jnp.asarray(tok), jc, jnp.int32(Np + i + 1))
        _close(lg.numpy(), np.asarray(jl), f"decode {i}")
        assert _rel(lg[:, 0].numpy(), full[:, Np + i]) <= 2e-4, i
    _, c2 = lm.prefill(tcfg, tp, _t(toks[:, :pre_len]).long(), max_len=Np + S,
                       prefix_embed=_t(pre))
    wrong, _ = lm.decode_step(tcfg, tp, _t(toks[:, pre_len:pre_len + 1]).long(), c2,
                              pre_len + 1)
    assert _rel(wrong[:, 0].numpy(), full[:, Np + pre_len]) > 1e-2


def test_engine_serves_text_only_like_the_reference():
    """The paged engine admits token prompts and feeds no prefix, as the
    reference's engine does: the same greedy tokens as the reference's
    engine on the same requests, every logit row the reference's
    contiguous text-only logits teacher-forced on them (1e-4), and the
    ``frontend`` weight unread (another value serves the same)."""
    jcfg, tcfg, jp, tp = _params(7)
    max_len = 24
    shape = type("S", (), {"global_batch": 3, "seq_len": max_len})()
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, tcfg.vocab_size, rng.integers(2, 7)).tolist(),
             int(rng.integers(2, 7))) for _ in range(5)]

    def serve(params):
        seen = {}
        eng = build_engine(tcfg, shape, params, page_size=4, device="cpu",
                           on_logits=lambda kind, rows, lg, inp: [
                               seen.setdefault(u, []).append(lg[s, -1].clone())
                               for s, u in rows])
        uids = [eng.submit(p, max_new=n) for p, n in reqs]
        got = {r.uid: r.tokens for r in eng.run()}
        return [got[u] for u in uids], [seen[u] for u in uids]

    tokens, logits = serve(tp)
    jeng = jbuild_engine(jcfg, shape, jp, page_size=4, jit=False)
    juids = [jeng.submit(p, max_new=n) for p, n in reqs]
    jgot = {r.uid: r.tokens for r in jeng.run()}
    assert tokens == [jgot[u] for u in juids]
    for (p, _), toks, rows in zip(reqs, tokens, logits):
        lg, c = jlm.prefill(jcfg, jp, jnp.asarray([p], jnp.int32), max_len=max_len)
        want = [np.asarray(lg)[0, -1]]
        for i, t in enumerate(toks[:-1]):
            lg, c = jlm.decode_step(jcfg, jp, jnp.asarray([[t]], jnp.int32), c,
                                    jnp.int32(len(p) + 1 + i))
            want.append(np.asarray(lg)[0, -1])
        for a, b in zip(rows, want):
            _close(a.numpy(), b)
    other = {**tp, "frontend": torch.randn_like(tp["frontend"])}
    tokens2, logits2 = serve(other)
    assert tokens2 == tokens
    assert all(torch.equal(a, b) for r, r2 in zip(logits, logits2)
               for a, b in zip(r, r2))
