"""Port parity: serving (``repro_torch.models.lm.prefill`` / ``decode_step``,
``repro_torch.serving.{paged,engine,publish}``, ``launch.steps.build_engine``
/ ``build_serve``) against the JAX package, paper-lm smoke on the CPU.

The reference's ``tests/test_serving.py`` and ``tests/test_decode.py``
cases, on the port, with weights drawn by JAX and carried over by
``repro_torch.convert``.  Tolerance against the reference: logits within
1e-4 absolute + 1e-4 relative (float32; the two packages sum attention
and matmuls in other orders), every prefill and decode step teacher-forced
on one side's token stream.  Greedy tokens are compared across packages
only up to the first step whose top-2 logit gap is within 2e-3 (smoke
weights give near-flat logits, so argmax may flip on rounding alone).
Within the port, paged decode equals contiguous decode bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.steps import build_engine as jbuild_engine
from repro.models import base as jmbase
from repro.models import lm as jlm
from repro.serving import WeightPublisher as JPublisher
from repro.serving import WeightSubscriber as JSubscriber
from repro.serving import build_page_layout as jbuild_page_layout
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_reference
from repro_torch.core import flatbuf
from repro_torch.launch.steps import build_engine, build_serve
from repro_torch.models import lm
from repro_torch.serving import (NULL_PAGE, DecodeEngine, WeightPublisher,
                                 WeightSubscriber, build_page_layout,
                                 init_pool, paged)
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.trace import SPAN_CATEGORIES, Tracer
from repro_torch.utils import tree_leaves, tree_map

torch.set_num_threads(2)
RTOL = ATOL = 1e-4
GAP = 2e-3


def cfgs():
    return jconfigs.get_smoke("paper-lm"), tconfigs.get_smoke("paper-lm")


def make_params(seed=0):
    """(reference params, the same weights as port tensors)."""
    jcfg, _ = cfgs()
    jp = jmbase.materialize(jlm.param_specs(jcfg), jax.random.PRNGKey(seed))
    return jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


def ref_greedy(cfg, params, prompt, n, max_len):
    """Isolated per-request reference on the port: prefill + decode."""
    lg, c = lm.prefill(cfg, params, torch.tensor([list(prompt)]), max_len=max_len)
    out = [int(lg[0, -1].argmax())]
    ln = len(prompt) + 1
    for _ in range(n - 1):
        lg, c = lm.decode_step(cfg, params, torch.tensor([[out[-1]]]), c, ln)
        out.append(int(lg[0, -1].argmax()))
        ln += 1
    return out


def jax_forced_logits(jp, prompt, tokens, max_len):
    """The reference's contiguous logits teacher-forced on ``tokens``:
    [prefill(prompt), decode(tokens[0]), ..., decode(tokens[-2])]."""
    jcfg, _ = cfgs()
    lg, c = jlm.prefill(jcfg, jp, jnp.asarray([list(prompt)], jnp.int32),
                        max_len=max_len)
    out = [np.asarray(lg)[0, -1]]
    ln = len(prompt) + 1
    for t in tokens[:-1]:
        lg, c = jlm.decode_step(jcfg, jp, jnp.asarray([[t]], jnp.int32), c,
                                jnp.int32(ln))
        out.append(np.asarray(lg)[0, -1])
        ln += 1
    return out


def _close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=msg)


# ---------------------------------------------------------------------------
# prefill / decode_step against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_len_kind", ["scalar", "vector"])
def test_prefill_decode_logits_match_reference(cache_len_kind):
    jcfg, tcfg = cfgs()
    jp, tp = make_params()
    B, L, max_len = 2, 6, 16
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, tcfg.vocab_size, (B, L))
    forced = rng.integers(0, tcfg.vocab_size, (B, 5))
    jl, jc = jlm.prefill(jcfg, jp, jnp.asarray(prompts, jnp.int32),
                         max_len=max_len)
    tl, tc = lm.prefill(tcfg, tp, torch.from_numpy(prompts), max_len=max_len)
    _close(tl.numpy(), np.asarray(jl), "prefill")
    assert [tuple(x.shape) for x in tree_leaves(tc)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jc)]
    for i in range(forced.shape[1]):
        n = L + i + 1
        cl = (n if cache_len_kind == "scalar" else
              np.full(B, n, np.int32))
        jl, jc = jlm.decode_step(jcfg, jp, jnp.asarray(forced[:, i:i + 1],
                                                       jnp.int32), jc,
                                 jnp.asarray(cl))
        tl, tc = lm.decode_step(tcfg, tp, torch.from_numpy(forced[:, i:i + 1]),
                                tc, torch.as_tensor(cl))
        _close(tl.numpy(), np.asarray(jl), f"decode step {i}")
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(a.numpy(), np.asarray(b), "cache")


@pytest.mark.parametrize("window,softcap,vector", [
    (0, 0.0, False), (0, 0.0, True), (3, 0.0, True), (0, 30.0, True)])
def test_decode_attention_and_cache_write_match_reference(window, softcap,
                                                          vector):
    """The layers under decode_step: per-row cache writes and masked
    single-token attention (GQA, window, softcap) against the reference's
    ``cache_write`` / ``decode_attention``."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    rng = np.random.default_rng(5)
    B, S, H, KH, D = 3, 9, 4, 2, 8
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    new = rng.standard_normal((B, 1, KH, D)).astype(np.float32)
    lens = np.array([4, 9, 6], np.int32) if vector else np.int32(7)
    jk = jlayers.cache_write(jnp.asarray(k), jnp.asarray(new),
                             jnp.asarray(lens) - 1)
    tk = tlayers.cache_write(torch.from_numpy(k.copy()), torch.from_numpy(new),
                             torch.as_tensor(lens) - 1)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jo = jlayers.decode_attention(jnp.asarray(q), jk, jnp.asarray(v),
                                  cache_len=jnp.asarray(lens), window=window,
                                  softcap=softcap)
    to = tlayers.decode_attention(torch.from_numpy(q), tk, torch.from_numpy(v),
                                  cache_len=torch.as_tensor(lens),
                                  window=window, softcap=softcap)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)


def test_decode_matches_prefill_positionwise():
    _, tcfg = cfgs()
    _, tp = make_params()
    B, S = 2, 12
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (B, S)))
    hidden, _, _ = lm._decoder(tcfg, tp, tokens, mode="prefill")
    full = lm.logits_from_hidden(tcfg, tp, hidden).detach().numpy()
    lg, cache = lm.prefill(tcfg, tp, tokens[:, :1], max_len=S)
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 0], rtol=1e-4, atol=1e-4)
    for i in range(1, S):
        lg, cache = lm.decode_step(tcfg, tp, tokens[:, i:i + 1], cache, i + 1)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i], rtol=1e-4,
                                   atol=1e-4, err_msg=f"position {i}")


def test_prefill_forward_matches_train_forward():
    """The prefill stack is the train stack: same hidden states."""
    _, tcfg = cfgs()
    _, tp = make_params()
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 10)))
    with torch.no_grad():
        h_train = lm.forward(tcfg, tp, tokens)
    h_pre, _, _ = lm._decoder(tcfg, tp, tokens, mode="prefill")
    assert torch.equal(h_train, h_pre)


def test_prefill_lengths_reads_true_last_position():
    """A right-padded prefill with ``lengths`` reads the exact-length
    prefill's logits."""
    jcfg, tcfg = cfgs()
    jp, tp = make_params()
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, 5)
    lg_exact, _ = lm.prefill(tcfg, tp, torch.from_numpy(prompt[None]))
    padded = np.zeros((1, 16), np.int64)
    padded[0, :5] = prompt
    lg_pad, _ = lm.prefill(tcfg, tp, torch.from_numpy(padded),
                           lengths=torch.tensor([5]))
    # equal up to float32 rounding: the matmuls block differently per S
    np.testing.assert_allclose(lg_pad.numpy(), lg_exact.numpy(), rtol=1e-5,
                               atol=1e-6)
    jl, _ = jlm.prefill(jcfg, jp, jnp.asarray(padded, jnp.int32),
                        lengths=jnp.asarray([5]))
    _close(lg_pad.numpy(), np.asarray(jl))


def test_grow_cache_and_axes_match_reference():
    jcfg, tcfg = cfgs()
    assert lm.cache_axes_tree(tcfg) == jlm.cache_axes_tree(jcfg)
    c = lm.init_cache(tcfg, 2, 5, dtype=torch.float32)
    c = tree_map(lambda a: a + 1.0, c)
    g = lm.grow_cache(tcfg, c, 9)
    for leaf in tree_leaves(g):
        assert leaf.shape[2] == 9 and leaf.dtype == torch.float32
        assert bool((leaf[:, :, :5] == 1).all()) and not leaf[:, :, 5:].any()
    ref = jlm.init_cache(jcfg, 2, 9, dtype=jnp.float32)
    assert [tuple(x.shape) for x in tree_leaves(g)] == \
        [x.shape for x in jax.tree.leaves(ref)]


def test_build_serve_bundle():
    jcfg, tcfg = cfgs()
    jp, tp = make_params()
    sb = build_serve(tcfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, 512, (2, 7))
    lg, cache = sb.prefill(tp, {"tokens": torch.from_numpy(toks)})
    jl, _ = jlm.prefill(jcfg, jp, jnp.asarray(toks, jnp.int32))
    _close(lg.numpy(), np.asarray(jl))
    cache = lm.grow_cache(tcfg, cache, 9)
    lg2, _ = sb.decode_step(tp, {"tokens": lg.argmax(-1)}, cache, 8)
    assert lg2.shape == (2, 1, tcfg.vocab_size)
    assert sb.device.type == "cpu"


# ---------------------------------------------------------------------------
# paged KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page_size", [1, 4, 8])
def test_paged_decode_identical_to_contiguous(page_size):
    """Paged decode (gather -> decode -> scatter) equals decoding on the
    contiguous cache bit for bit."""
    _, cfg = cfgs()
    _, params = make_params()
    B, L, max_len = 2, 6, 16
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, L)))
    logits, cache = lm.prefill(cfg, params, prompts, max_len=max_len)
    pl = build_page_layout(cfg, page_size=page_size, max_len=max_len,
                           num_pages=1 + B * (-(-max_len // page_size)))
    pools = init_pool(pl)
    tables = np.zeros((B, pl.pages_per_seq), np.int64)
    free = list(range(1, pl.num_pages))
    for b in range(B):
        tables[b] = [free.pop(0) for _ in range(pl.pages_per_seq)]
        sel = [leaf.index_select(ax.index("batch"), torch.tensor([b]))
               for leaf, ax in zip(tree_leaves(cache), pl.leaf_axes)]
        cb = paged.tree_unflatten(pl.token_layout.treedef, sel)
        paged.scatter_prefill(pl, pools, cb, torch.from_numpy(tables[b]), L)
    tok = tok_p = logits.argmax(-1)
    cache_c = lm.grow_cache(cfg, tree_map(torch.clone, cache), max_len)
    lens = np.full(B, L, np.int64)
    for _ in range(4):
        lens += 1
        lg_c, cache_c = lm.decode_step(cfg, params, tok, cache_c,
                                       torch.from_numpy(lens))
        lg_p, pools = paged.paged_decode_step(
            cfg, params, tok_p, pools, torch.from_numpy(tables),
            torch.from_numpy(lens), pl)
        assert torch.equal(lg_c, lg_p)
        tok, tok_p = lg_c.argmax(-1), lg_p.argmax(-1)
    assert not any(pool[NULL_PAGE].any() for pool in pools)


def test_page_layout_equals_reference():
    """rows_per_token, leaf order and shapes, page counts and pool bytes
    are the reference's, at smoke size and at paper-lm's full width."""
    for jcfg, tcfg in (cfgs(), (jconfigs.get("paper-lm"), tconfigs.get("paper-lm"))):
        jl = jbuild_page_layout(jcfg, page_size=16, max_len=512, num_pages=513)
        tl = build_page_layout(tcfg, page_size=16, max_len=512, num_pages=513)
        assert tl.rows_per_token == jl.rows_per_token
        assert tl.pages_per_seq == jl.pages_per_seq == 32
        assert tl.max_tokens == jl.max_tokens
        assert tl.pool_bytes() == jl.pool_bytes()
        assert tl.leaf_axes == jl.leaf_axes
        assert [(s.shape, s.row_offset, s.rows, s.size) for s in tl.token_layout.slots] \
            == [(s.shape, s.row_offset, s.rows, s.size) for s in jl.token_layout.slots]
    assert tl.rows_per_token == (144,)                  # paper-lm, float32
    assert tl.pool_bytes() == 513 * 16 * 144 * 128 * 4
    assert all(r % flatbuf.SUBLANE == 0 for r in tl.rows_per_token)


def test_null_page_stays_zero_and_pages_conserve():
    _, cfg = cfgs()
    _, params = make_params()
    eng = DecodeEngine(cfg, params, max_batch=3, max_len=16, page_size=4)
    total_free = len(eng.free_pages)
    assert total_free == eng.pl.num_pages - 1
    eng.submit([1, 2, 3], max_new=4)
    eng.run()
    assert len(eng.free_pages) == total_free
    for pool in eng.pools:
        assert not pool[NULL_PAGE].any()


def test_idle_rows_write_nothing():
    """scatter_token with inactive rows and scatter_prefill with length-0
    rows leave every page but the written ones as they were, and the null
    page zero (the reference's dropped writes)."""
    _, cfg = cfgs()
    _, params = make_params()
    pl = build_page_layout(cfg, page_size=4, max_len=8, num_pages=5)
    pools = init_pool(pl)
    g = torch.Generator().manual_seed(0)
    pools[0][1:].copy_(torch.randn(pools[0][1:].shape, generator=g))
    before = pools[0].clone()
    _, cache = lm.prefill(cfg, params, torch.zeros((2, 8), dtype=torch.long))
    tables = torch.tensor([[1, 2], [0, 0]])
    paged.scatter_prefill(pl, pools, cache, tables, torch.tensor([0, 0]))
    assert torch.equal(pools[0], before)
    paged.scatter_token(pl, pools, cache, torch.tensor([5, 3]), tables,
                        active=torch.tensor([False, False]))
    assert torch.equal(pools[0], before)
    paged.scatter_token(pl, pools, cache, torch.tensor([5, 3]), tables,
                        active=torch.tensor([True, False]))
    changed = (pools[0] != before).flatten(2).any(-1)   # (pages, page_size)
    assert changed.nonzero().tolist() == [[2, 1]]       # page 2, offset 1
    assert not pools[0][NULL_PAGE].any()


def test_queue_waits_for_pages_then_runs():
    _, cfg = cfgs()
    _, params = make_params()
    max_len = 16
    pl = build_page_layout(cfg, page_size=8, max_len=max_len, num_pages=0)
    eng = DecodeEngine(cfg, params, max_batch=2, max_len=max_len,
                       page_size=8, num_pages=1 + pl.pages_per_seq)
    rng = np.random.default_rng(3)
    p0 = rng.integers(0, cfg.vocab_size, 4).tolist()
    p1 = rng.integers(0, cfg.vocab_size, 3).tolist()
    u0 = eng.submit(p0, max_new=3)
    u1 = eng.submit(p1, max_new=3)
    eng.step()
    assert eng.num_active == 1 and len(eng.queue) == 1
    res = {r.uid: r for r in eng.run()}
    assert res[u0].tokens == ref_greedy(cfg, params, p0, 3, max_len)
    assert res[u1].tokens == ref_greedy(cfg, params, p1, 3, max_len)


# ---------------------------------------------------------------------------
# continuous batching engine
# ---------------------------------------------------------------------------

def _mixed_requests(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, rng.integers(2, 7)).tolist(),
             int(rng.integers(2, 9))) for _ in range(n)]


def test_engine_matches_isolated_reference_mixed_lengths():
    _, cfg = cfgs()
    _, params = make_params()
    max_len = 24
    eng = build_engine(cfg, type("S", (), {"global_batch": 3,
                                           "seq_len": max_len})(),
                       params, page_size=4, device="cpu")
    reqs = _mixed_requests(cfg.vocab_size)
    uids = [eng.submit(p, max_new=n) for p, n in reqs]
    results = {r.uid: r for r in eng.run()}
    assert len(results) == len(reqs)
    for uid, (p, n) in zip(uids, reqs):
        assert results[uid].tokens == ref_greedy(cfg, params, p, n, max_len)
        assert results[uid].finish_reason == "length"
    assert eng.idle and eng.tokens_out == sum(n for _, n in reqs)


def test_engine_logits_match_reference_engine():
    """Mixed lengths through the port's engine: every prefill and decode
    logit row equals the reference's contiguous logits teacher-forced on
    the port's tokens (tolerance above); the reference's own engine emits
    the port's tokens up to the first near-tie."""
    jcfg, cfg = cfgs()
    jp, params = make_params()
    max_len = 24
    shape = type("S", (), {"global_batch": 3, "seq_len": max_len})()
    seen: dict = {}

    def on_logits(kind, rows, logits, inputs):
        for slot, uid in rows:
            seen.setdefault(uid, []).append(logits[slot, -1].clone())

    eng = build_engine(cfg, shape, params, page_size=4, device="cpu",
                       on_logits=on_logits)
    reqs = _mixed_requests(cfg.vocab_size, seed=1)
    uids = [eng.submit(p, max_new=n) for p, n in reqs]
    got = {r.uid: r for r in eng.run()}
    jeng = jbuild_engine(jcfg, shape, jp, page_size=4)
    juids = [jeng.submit(p, max_new=n) for p, n in reqs]
    jgot = {r.uid: r for r in jeng.run()}
    compared = 0
    for uid, juid, (p, n) in zip(uids, juids, reqs):
        toks = got[uid].tokens
        lg = [x.numpy() for x in seen[uid]]
        assert len(lg) == len(toks) == n
        want = jax_forced_logits(jp, p, toks, max_len)
        for i, (a, b) in enumerate(zip(lg, want)):
            _close(a, b, f"request {uid} token {i}")
        for i, a in enumerate(lg):
            top2 = np.sort(a)[-2:]
            if top2[1] - top2[0] <= GAP:
                break
            assert jgot[juid].tokens[i] == toks[i], (uid, i)
            compared += 1
    assert compared >= len(reqs)


def test_engine_eos_retirement():
    _, cfg = cfgs()
    _, params = make_params()
    prompt = [5, 9, 2]
    ref = ref_greedy(cfg, params, prompt, 8, 16)
    eos = ref[2]
    eng = DecodeEngine(cfg, params, max_batch=2, max_len=16, page_size=4,
                       eos_id=eos)
    uid = eng.submit(prompt, max_new=8)
    res = {r.uid: r for r in eng.run()}
    assert res[uid].finish_reason == "eos"
    assert res[uid].tokens == ref[:ref.index(eos) + 1]


def test_engine_rejects_oversized_and_empty():
    _, cfg = cfgs()
    _, params = make_params()
    eng = DecodeEngine(cfg, params, max_batch=1, max_len=8, page_size=4)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit([1] * 6, max_new=4)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([])
    with pytest.raises(ValueError, match="prefill_len"):
        DecodeEngine(cfg, params, max_batch=1, max_len=8, prefill_len=9)


def test_build_engine_draws_weights_on_the_device():
    _, cfg = cfgs()
    shape = type("S", (), {"global_batch": 2, "seq_len": 16})()
    a = build_engine(cfg, shape, device="cpu", seed=3)
    b = build_engine(cfg, shape, device="cpu", seed=3)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                 tree_leaves(b.params)))
    assert a.describe()["pool_bytes"] == a.pl.pool_bytes()


# ---------------------------------------------------------------------------
# live weight hot-swap + publish channel
# ---------------------------------------------------------------------------

def test_publish_manifest_and_subscriber_roundtrip(tmp_path):
    _, cfg = cfgs()
    _, p_v0 = make_params(0)
    _, p_v1 = make_params(1)
    pub = WeightPublisher(str(tmp_path))
    assert pub.publish(p_v0, step=0) == 0
    stacked = flatbuf.BucketState.pack(
        tree_map(lambda a: torch.stack([a, a]), p_v1), leading=1)
    assert pub.publish(stacked, step=10) == 1
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["latest"] == 1
    assert set(manifest["versions"]) == {"0", "1"}
    assert manifest["versions"]["1"]["step"] == 10
    sub = WeightSubscriber(str(tmp_path), lm.param_specs(cfg))
    ver, state = sub.poll()
    assert ver == 1 and flatbuf.is_bucket_state(state)
    for got, want in zip(tree_leaves(state.unpack()), tree_leaves(p_v1)):
        assert torch.equal(got, want)     # mean of two equal copies: exact
    assert sub.poll(newer_than=1) is None
    assert sub.latest_version() == 1


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_publish_channel_crosses_packages(tmp_path, direction):
    """A version published by one package is read by the other's
    subscriber, every leaf exact (worker-stacked publishes included)."""
    jcfg, cfg = cfgs()
    jp, tp = make_params(2)
    if direction == "jax_to_port":
        from repro.core import flatbuf as jflat
        JPublisher(str(tmp_path)).publish(jflat.BucketState.pack(
            jax.tree.map(lambda a: jnp.stack([a, a]), jp), leading=1), step=4)
        ver, st = WeightSubscriber(str(tmp_path), lm.param_specs(cfg)).poll()
        got = tree_leaves(st.unpack())
    else:
        WeightPublisher(str(tmp_path)).publish(flatbuf.BucketState.pack(
            tree_map(lambda a: torch.stack([a, a]), tp), leading=1), step=4)
        ver, st = JSubscriber(str(tmp_path), jlm.param_specs(jcfg)).poll()
        got = [torch.from_numpy(np.asarray(x)) for x in
               jax.tree.leaves(st.unpack())]
    assert ver == 0
    for a, b in zip(got, tree_leaves(tp)):
        assert torch.equal(a, b)


def test_hot_swap_equals_restart_on_new_weights(tmp_path):
    """k tokens under v0, v1 installed mid-generation: the continuation
    equals a fresh engine on v1 whose prompt is the history so far."""
    _, cfg = cfgs()
    _, p_v0 = make_params(0)
    _, p_v1 = make_params(1)
    max_len = 24
    pub = WeightPublisher(str(tmp_path))
    pub.publish(p_v0, step=0)
    pub.publish(p_v1, step=10)
    sub = WeightSubscriber(str(tmp_path), lm.param_specs(cfg))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 5).tolist()
    eng = DecodeEngine(cfg, p_v0, max_batch=2, max_len=max_len, page_size=4)
    uid = eng.submit(prompt, max_new=10)
    for _ in range(3):
        eng.step()
    k = int(eng.gen[0])
    hist_k = list(eng.hist[0])
    assert eng.poll_weights(sub) == 1
    assert eng.poll_weights(sub) is None
    res = {r.uid: r for r in eng.run()}
    fresh = DecodeEngine(cfg, p_v1, max_batch=2, max_len=max_len, page_size=4)
    uid2 = fresh.submit(hist_k, max_new=10 - k)
    res2 = {r.uid: r for r in fresh.run()}
    assert res[uid].tokens[k:] == res2[uid2].tokens
    assert res[uid].weight_versions == (-1, 1)
    assert eng.weight_version == 1


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def test_serving_spans_and_metrics():
    assert all(SPAN_CATEGORIES[n] == "serve"
               for n in ("admit", "prefill", "decode", "swap"))
    _, cfg = cfgs()
    _, params = make_params()
    tracer = Tracer()
    reg = MetricsRegistry()
    eng = DecodeEngine(cfg, params, max_batch=2, max_len=16, page_size=4,
                       tracer=tracer, metrics=reg)
    eng.submit([1, 2, 3], max_new=4)
    eng.submit([4, 5], max_new=2)
    eng.run()
    _, p1 = make_params(1)
    eng.install_weights(p1, version=7)
    names = {s.name for s in tracer.spans}
    assert {"admit", "prefill", "decode", "swap"} <= names
    swap = [s for s in tracer.spans if s.name == "swap"][0]
    assert swap.attrs["version"] == 7 and swap.dur_s is not None
    admits = [s for s in tracer.spans if s.name == "admit"]
    assert sum(s.attrs["admitted"] for s in admits) == 2
    expo = reg.exposition()
    for fam in ("repro_serve_tokens_total", "repro_serve_queue_depth",
                "repro_serve_batch_occupancy", "repro_serve_decode_seconds",
                "repro_serve_swap_seconds", "repro_serve_weight_version"):
        assert fam in expo, fam
    assert "repro_serve_weight_version 7" in expo
    assert eng.describe()["tokens_out"] == 6


def test_serving_entry_points_raise_without_cuda(monkeypatch):
    """build_engine / build_serve run on the card unless told otherwise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = cfgs()
    shape = type("S", (), {"global_batch": 2, "seq_len": 16})()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(cfg, shape)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_serve(cfg)
