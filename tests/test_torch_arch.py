"""Port parity for the MoE and MLA decoders, olmoe-1b-7b and
deepseek-v2-lite-16b, end to end at smoke size (``repro_torch`` vs
``repro``): configs, param specs and bucket layouts, the loss and its
gradients, one resident local step plus a sync, prefill / decode, the
paged engine, and the resident checkpoint.

The JAX weights (``repro.models.base.materialize``) are carried over
through numpy; batches are numpy.  Tolerances (float32 sums in another
order throughout):

* loss, xent, aux: rtol 1e-5; each gradient leaf rtol 1e-5, atol 1e-5 x
  the leaf's largest entry (the grad-bucket tolerance of
  ``test_torch_model``: a norm scale's gradient sums B*S terms with
  cancellation, and an entry near 0 keeps the absolute rounding of the
  larger terms it sums);
* one local step + sync (W=2; mean sync for olmoe, EF-sign for
  deepseek): the mean loss rtol 1e-5, params and momentum buckets rtol
  1e-5, atol 1e-6;
* logits (prefill, decode, engine): rtol = atol = 1e-4, the serving
  tests' tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jcb
from repro.core import flatbuf as jfb
from repro.launch.steps import build_train as jbuild
from repro.models import base as jmbase
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpoint import restore_flat, save_flat
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.core import flatbuf as tfb
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.launch.steps import build_engine
from repro_torch.launch.steps import build_train as tbuild
from repro_torch.models import base as tmbase
from repro_torch.models import lm
from repro_torch.utils import tree_flatten, tree_leaves, tree_unflatten

torch.set_num_threads(2)

ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
SYNC = {"olmoe-1b-7b": "none", "deepseek-v2-lite-16b": "ef_sign"}
B, S, W = 2, 32, 2


def _params(arch, seed=0):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jmbase.materialize(jlm.param_specs(jcfg), jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


def _batch(vocab, seed=0, b=B, s=S):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_configs_equal_reference(arch, size):
    get = (lambda m: m.get(arch)) if size == "full" else (lambda m: m.get_smoke(arch))
    jc, tc = get(jconfigs), get(tconfigs)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert type(tc.moe).__name__ == "MoEConfig"
    assert (tc.mla is None) == (jc.mla is None)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_param_specs_and_layout_match_reference(arch, size):
    """Same leaves in ``jax.tree.flatten`` order (the nested
    ``ffn.shared`` dict included), the same init law, weight-decay mask
    and bucket layout row for row."""
    get = (lambda m: m.get(arch)) if size == "full" else (lambda m: m.get_smoke(arch))
    jspecs, tspecs = jlm.param_specs(get(jconfigs)), lm.param_specs(get(tconfigs))
    jl = jax.tree.leaves(jspecs, is_leaf=jmbase.is_spec)
    tl = tree_leaves(tspecs, is_leaf=tmbase.is_spec)
    assert [(s.shape, s.axes, s.init, s.scale) for s in tl] == \
        [(s.shape, s.axes, s.init, s.scale) for s in jl]
    assert tmbase.count_params(tspecs) == jmbase.count_params(jspecs)
    assert "head" in tspecs
    jwd, twd = jmbase.norm_param_mask(jspecs), tmbase.norm_param_mask(tspecs)
    assert tree_leaves(twd) == jax.tree.leaves(jwd)
    jlay = jfb.build_layout(jmbase.abstract(jspecs, jnp.float32), wd_mask=jwd)
    tlay = tfb.build_layout(tmbase.abstract(tspecs), wd_mask=twd)
    assert tlay.bucket_rows == jlay.bucket_rows
    assert [(s.row_offset, s.rows, s.size, s.shape, s.skip_wd) for s in tlay.slots] == \
        [(s.row_offset, s.rows, s.size, s.shape, s.skip_wd) for s in jlay.slots]
    # stacked q/k/kv norms (rank 2) take weight decay, as in the reference
    stacked_norms = [s for s in tlay.slots if len(s.shape) == 2 and s.shape[0] == 2
                     and s.shape[1] in (32, 128, 512)]
    if size == "smoke":
        assert stacked_norms and not any(s.skip_wd for s in stacked_norms)


def test_materialize_scales_the_router():
    """The port's own init honours a spec's ``scale``: the router's std is
    0.5 / sqrt(fan-in), the experts' 1 / sqrt(fan-in)."""
    cfg = tconfigs.get_smoke("olmoe-1b-7b").replace(d_model=512)
    p = tmbase.materialize(lm.param_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    ffn = p["layers"][0]["ffn"]
    assert abs(float(ffn["router"].std()) - 0.5 / np.sqrt(512)) < 2e-3
    assert abs(float(ffn["wg"].std()) - 1 / np.sqrt(512)) < 2e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_grads_match_reference(arch):
    jcfg, tcfg, jp, tp, = _params(arch, seed=1)
    batch = _batch(tcfg.vocab_size, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    leaves, treedef = tree_flatten(tp)
    leaves = [a.clone().requires_grad_(True) for a in leaves]
    tloss, tm = lm.loss_fn(tcfg, tree_unflatten(treedef, leaves),
                           {k: torch.from_numpy(v).long() for k, v in batch.items()})
    tloss.backward()
    tloss = tloss.detach()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(tm["aux"]) > 0
    np.testing.assert_allclose(float(tloss), float(tm["xent"] + tm["aux"]), rtol=1e-7)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(leaves)
    for a, b in zip(leaves, jleaves):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


def _run(cb, cfg, mode):
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", S, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=1, sync_compression=mode),
        optim=cb.OptimConfig(base_lr=0.3, base_batch=W * B, weight_decay=1e-2,
                             grad_clip=1.0))


@pytest.mark.parametrize("arch", ARCHS)
def test_local_step_and_sync_match_reference(arch):
    """One resident local step and one global sync at W=2 through the
    bucket path: the reference's ``build_train(use_kernel=True)`` (its
    Pallas kernels in interpret mode) against the port's on the CPU (the
    kernels' plain versions)."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    mode = SYNC[arch]
    jb = jbuild(_run(jcb, jcfg, mode), num_workers=W, use_kernel=True)
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    js = jb.init(jax.random.PRNGKey(1), p0)
    tb = tbuild(_run(tcb, tcfg, mode), num_workers=W, device="cpu")
    ts = tb.init(params_from_reference(jax.tree.map(np.asarray, p0), "cpu"))
    batch = next(iter(ShardedBatches(lm_examples(markov_lm(
        vocab=tcfg.vocab_size, num_seqs=16, seq_len=S)), W, B)))
    js, jm = jax.jit(jb.local_step)(js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts, tm = tb.local_step(ts, batch)
    for k in ("loss", "xent", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    js = jax.jit(lambda s: jb.sync(s, plan=jb.sync_plan, scope="global"))(js)
    ts = tb.sync(ts, plan=tb.sync_plan)
    for f in ("params", "momentum"):
        for a, b in zip(getattr(ts, f).buckets, getattr(js, f).buckets, strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6, err_msg=f)
    # the reference's resident state carried over continues as it does there
    tc = state_from_reference(jax.tree.map(np.asarray, js), layout=tb.layout,
                              device="cpu")
    for f in ("params", "momentum", "anchor", "ef_memory"):
        a, b = getattr(tc, f), getattr(js, f)
        assert (a is None) == (b is None), f
        if a is not None:
            for x, y in zip(a.buckets, b.buckets, strict=True):
                assert np.array_equal(x.numpy(), np.asarray(y)), f
    js, jm = jax.jit(jb.local_step)(js, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm = tb.local_step(tc, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=msg)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, tcfg, jp, tp = _params(arch, seed=2)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, tcfg.vocab_size, (B, 6))
    forced = rng.integers(0, tcfg.vocab_size, (B, 3))
    jl, jc = jlm.prefill(jcfg, jp, jnp.asarray(prompts, jnp.int32), max_len=16)
    tl, tc = lm.prefill(tcfg, tp, torch.from_numpy(prompts), max_len=16)
    _close(tl.numpy(), np.asarray(jl), "prefill")
    assert [tuple(x.shape) for x in tree_leaves(tc)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jc)]
    for i in range(forced.shape[1]):
        cl = np.array([7 + i, 7 + i], np.int32)
        jl, jc = jlm.decode_step(jcfg, jp, jnp.asarray(forced[:, i:i + 1], jnp.int32),
                                 jc, jnp.asarray(cl))
        tl, tc = lm.decode_step(tcfg, tp, torch.from_numpy(forced[:, i:i + 1]), tc,
                                torch.from_numpy(cl))
        _close(tl.numpy(), np.asarray(jl), f"decode step {i}")
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(a.numpy(), np.asarray(b), "cache")
    is_axes = lambda x: isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(e, (str, type(None))) for e in x)
    assert tree_leaves(lm.cache_axes_tree(tcfg), is_leaf=is_axes) == \
        jax.tree.leaves(jlm.cache_axes_tree(jcfg), is_leaf=is_axes)


def _forced(jcfg, jp, prompt, tokens, max_len):
    """The reference's contiguous logits teacher-forced on ``tokens``."""
    lg, c = jlm.prefill(jcfg, jp, jnp.asarray([list(prompt)], jnp.int32),
                        max_len=max_len)
    out = [np.asarray(lg)[0, -1]]
    n = len(prompt) + 1
    for t in tokens[:-1]:
        lg, c = jlm.decode_step(jcfg, jp, jnp.asarray([[t]], jnp.int32), c, jnp.int32(n))
        out.append(np.asarray(lg)[0, -1])
        n += 1
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_contiguous_decode(arch):
    """Mixed lengths through the paged engine (3 slots, pages of 4): its
    tokens equal the port's isolated contiguous greedy decode, and every
    logit row the reference's contiguous logits teacher-forced on them
    (the smoke configs' capacity never drops a token, so a row's routing
    does not depend on its batch)."""
    jcfg, tcfg, jp, tp = _params(arch, seed=3)
    max_len = 24
    seen: dict = {}
    eng = build_engine(tcfg, type("S", (), {"global_batch": 3, "seq_len": max_len})(),
                       tp, page_size=4, device="cpu",
                       on_logits=lambda kind, rows, lg, inp: [
                           seen.setdefault(u, []).append(lg[s, -1].clone())
                           for s, u in rows])
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, tcfg.vocab_size, rng.integers(2, 7)).tolist(),
             int(rng.integers(2, 7))) for _ in range(5)]
    uids = [eng.submit(p, max_new=n) for p, n in reqs]
    got = {r.uid: r for r in eng.run()}
    assert len(got) == len(reqs) and eng.idle
    assert not any(bool(pool[0].any()) for pool in eng.pools)       # null page
    for uid, (p, n) in zip(uids, reqs):
        lg, c = lm.prefill(tcfg, tp, torch.tensor([p]), max_len=max_len)
        want = [int(lg[0, -1].argmax())]
        for i in range(n - 1):
            lg, c = lm.decode_step(tcfg, tp, torch.tensor([[want[-1]]]), c, len(p) + 1 + i)
            want.append(int(lg[0, -1].argmax()))
        assert got[uid].tokens == want, uid
        for i, (a, b) in enumerate(zip(seen[uid], _forced(jcfg, jp, p, want, max_len))):
            _close(a.numpy(), b, f"request {uid} token {i}")



@pytest.mark.parametrize("arch", ARCHS)
def test_engine_hook_inputs_replay_its_batches(arch):
    """The engine's ``on_logits`` hook gets each program's inputs on the
    card: replayed through the contiguous ``lm.prefill`` /
    ``lm.decode_step`` on a (slots, max_len) cache (idle rows zeroed),
    they give the paged step's logits row for row, at a capacity factor
    where a row's routing depends on its batch."""
    jcfg, tcfg, jp, tp = _params(arch, seed=4)
    tcfg = tcfg.replace(moe=tcb.MoEConfig(**{**tcfg.moe.__dict__,
                                             "capacity_factor": 0.5}))
    slots, max_len = 3, 24
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
        assert tok.shape[0] == slots and lens.shape == (slots,)
        assert all(int(lens[s]) > 0 for s in live)
        seen[kind] += 1
        if kind == "prefill":
            _, c = lm.prefill(tcfg, tp, tok, lengths=lens, max_len=max_len)
            if cont is None:
                cont = c
            idx = torch.tensor(live)
            for dst, src, d in zip(tree_leaves(cont), tree_leaves(c), bdim):
                dst.index_copy_(d, idx, src.index_select(d, idx))
            return
        assert tok.shape == (slots, 1)
        for leaf, d in zip(tree_leaves(cont), bdim):
            leaf.index_fill_(d, torch.nonzero(lens == 0)[:, 0], 0.0)
        want, _ = lm.decode_step(tcfg, tp, tok, cont, lens)
        err = ((logits - want).abs() / (1 + want.abs()))[lens > 0]
        seen["worst"] = max(seen["worst"], float(err.max()))

    eng = build_engine(tcfg, type("S", (), {"global_batch": slots, "seq_len": max_len})(),
                       tp, page_size=4, device="cpu", on_logits=hook)
    rng = np.random.default_rng(4)
    for _ in range(6):
        eng.submit(rng.integers(0, tcfg.vocab_size, rng.integers(2, 12)).tolist(),
                   max_new=int(rng.integers(2, 8)))
    with torch.no_grad():
        assert len(eng.run()) == 6
    assert seen["prefill"] >= 2 and seen["decode"] > 0
    assert seen["worst"] <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_save_restore_flat_roundtrips_moe_state(arch, tmp_path):
    tcfg = tconfigs.get_smoke(arch)
    tb = tbuild(_run(tcb, tcfg, SYNC[arch]), num_workers=W, device="cpu")
    p0 = tmbase.materialize(tb.specs, torch.Generator().manual_seed(0), "cpu")
    state = tb.init(p0, seed=1)
    batch = next(iter(ShardedBatches(lm_examples(markov_lm(
        vocab=tcfg.vocab_size, num_seqs=16, seq_len=S)), W, B)))
    state, _ = tb.local_step(state, batch)
    state = tb.sync(state, plan=tb.sync_plan)
    path = str(tmp_path / "moe")
    save_flat(path, state, step=state.step)
    out = restore_flat(path, tb.init(p0, seed=9))
    assert out.step == state.step == 1
    for f in ("params", "momentum", "anchor", "global_u", "ef_memory"):
        a, b = getattr(state, f), getattr(out, f)
        assert (a is None) == (b is None), f
        if a is not None:
            for x, y in zip(a.buckets, b.buckets, strict=True):
                assert torch.equal(x, y), f
    assert (state.ef_memory is not None) == (SYNC[arch] == "ef_sign")


def _lars_run(cb, cfg, mode, wire_pack):
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", S, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=1, sync_compression=mode,
                                    wire_pack=wire_pack),
        optim=cb.OptimConfig(optimizer="lars", base_lr=0.3, base_batch=W * B,
                             weight_decay=1e-2, lars_trust=0.02))


def _pinned(ts, js, fields):
    """The port's state with the reference's buffers (new tensors: the
    port's sync writes in place)."""
    return dataclasses.replace(ts, **{
        f: getattr(ts, f).with_buckets(tuple(
            torch.tensor(np.asarray(x)).to(t.dtype)
            for x, t in zip(getattr(js, f).buckets, getattr(ts, f).buckets, strict=True)))
        for f in fields if getattr(ts, f) is not None})


@pytest.mark.parametrize("mode,wire_pack", [("none", False), ("ef_sign", False),
                                            ("ef_sign", True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_lars_trajectory_matches_reference(arch, mode, wire_pack):
    """LARS at W=2, 3 rounds of one local step + a global sync, through
    the bucket path of both packages.  Every sync runs a second time on a
    port state that holds the reference's own buffers (so both packages
    compress the same bits, and no sign can flip): after it, params and
    anchor within 1e-6 x their largest entry, momentum and EF memory
    within 1e-5 x (sums of another order over up to 65,536 elements).
    The free-running port trajectory beside it: each EF-sign sync's sign
    flips are counted (an element whose compressor input, delta + EF
    memory, is >= 0 in one package and < 0 in the other: an input within
    rounding of zero) and printed; its loss is held at rtol 1e-5 until
    the first flip, and its end state to the compressed trajectory
    tolerance of ``test_torch_local_sgd`` (at most 1e-4 of the elements
    beyond 1e-4 x the largest), as a flip moves its element by a whole
    scale."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jb = jbuild(_lars_run(jcb, jcfg, mode, wire_pack), num_workers=W, use_kernel=True)
    tb = tbuild(_lars_run(tcb, tcfg, mode, wire_pack), num_workers=W, device="cpu")
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    js = jb.init(jax.random.PRNGKey(1), p0)
    ts = tb.init(params_from_reference(jax.tree.map(np.asarray, p0), "cpu"))
    jstep = jax.jit(jb.local_step)
    jsync = jax.jit(lambda s: jb.sync(s, plan=jb.sync_plan, scope="global"))
    it = iter(ShardedBatches(lm_examples(markov_lm(
        vocab=tcfg.vocab_size, num_seqs=16, seq_len=S)), W, B))
    fields = ("params", "momentum", "anchor", "ef_memory")
    flips = []
    for _ in range(3):
        batch = next(it)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tb.local_step(ts, batch)
        if not flips or sum(flips) == 0:
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        if mode != "none":
            bufs = lambda st: [
                [torch.as_tensor(np.asarray(x)) for x in getattr(st, f).buckets]
                for f in ("anchor", "params", "ef_memory")]
            ins = [[a[None] - p + e for a, p, e in zip(*bufs(st))] for st in (ts, js)]
            flips.append(sum(int(((a >= 0) != (b >= 0)).sum()) for a, b in zip(*ins)))
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
    print(f"{arch} LARS {mode} wire_pack={wire_pack}: sign flips per sync {flips}")
    for f in fields:
        jf, tf = getattr(js, f), getattr(ts, f)
        for a, b in zip(tf.buckets if tf else (), jf.buckets if jf else ()):
            b = np.asarray(b)
            frac = float(np.mean(np.abs(a.numpy() - b) > 1e-4 * np.abs(b).max()))
            assert frac <= 1e-4, (f, frac, flips)
