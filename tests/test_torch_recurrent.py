"""Port parity for the recurrent families, xlstm-1.3b (mLSTM + sLSTM) and
zamba2-7b (mamba2 + the shared attention block), end to end
(``repro_torch`` vs ``repro``) on the CPU at smoke size: configs, param
specs and bucket layouts (full size too: 1,944,369,488 and 7,741,337,920
params), the loss and its gradients, the cache trees, prefill / decode
(the cache updated in place), the padded prefill, the paged path's
refusal, a W=2 post-local SGD trajectory through the bucket path, the
CLI, and ``convert`` / ``save_flat`` round trips.

The JAX weights (``repro.models.base.materialize``) are carried over
through numpy; batches are numpy.  Tolerances: loss rtol 1e-5; each
gradient leaf rtol 1e-5, atol 1e-5 x the leaf's largest entry (the
gradient tolerance of ``test_torch_arch``); logits and caches rtol =
atol = 1e-4 (the serving tests' tolerance); the trajectory as in
``test_torch_arch``'s LARS test (see there).
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
from repro.launch.steps import build_train as jbuild
from repro.models import base as jmbase
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpoint import restore_flat, save_flat
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference
from repro_torch.core import flatbuf as tfb
from repro_torch.core.schedule import sync_boundaries
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import build_engine, build_serve
from repro_torch.launch.steps import build_train as tbuild
from repro_torch.models import base as tmbase
from repro_torch.models import lm
from repro_torch.models.base import ShapeDtype
from repro_torch.serving import paged
from repro_torch.utils import tree_flatten, tree_leaves, tree_map, tree_unflatten

torch.set_num_threads(2)

ARCHS = ("xlstm-1.3b", "zamba2-7b")
COUNTS = {"xlstm-1.3b": 1_944_369_488, "zamba2-7b": 7_741_337_920}
B, S, W = 2, 32, 2


def _is_axes(x):
    return isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(e, (str, type(None))) for e in x)


def _params(arch, seed=0):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jmbase.materialize(jlm.param_specs(jcfg), jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


def _batch(vocab, seed=0, b=B, s=S):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=msg)


def _unused_shared_leaves(cfg):
    """Indices (in flatten order) of the per-layer leaves of the
    ``shared_attn`` layers, which ``apply_layer`` never reads."""
    specs = lm.param_specs(cfg)
    paths = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            paths.append(path)
    walk(specs, ())
    period = len(cfg.blocks)
    out = []
    for i, p in enumerate(paths):
        if p[0] == "layers" and cfg.blocks[p[1]].mixer == "shared_attn":
            out.append(i)
        if p[0] == "rem" and cfg.block_at(
                (cfg.num_layers // period) * period + p[1]).mixer == "shared_attn":
            out.append(i)
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_configs_equal_reference(arch, size):
    get = (lambda m: m.get(arch)) if size == "full" else (lambda m: m.get_smoke(arch))
    jc, tc = get(jconfigs), get(tconfigs)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert type(tc.ssm).__name__ == "SSMConfig"
    assert jc.citation == tc.citation and arch in tconfigs.ARCHS
    # both run long_500k: no skip in either registry
    assert (arch, "long_500k") not in tconfigs.SKIPS
    assert (arch, "long_500k") in tconfigs.runnable_pairs()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_param_specs_and_layout_match_reference(arch, size):
    """The same leaves in ``jax.tree.flatten`` order (the ``shared``
    subtree, the shared layers' empty ``mix`` dicts, no ``ln2`` / ``ffn``
    where ``ffn == "none"``), the same init law, weight-decay mask and
    bucket layout row for row."""
    get = (lambda m: m.get(arch)) if size == "full" else (lambda m: m.get_smoke(arch))
    jspecs, tspecs = jlm.param_specs(get(jconfigs)), lm.param_specs(get(tconfigs))
    jl = jax.tree.leaves(jspecs, is_leaf=jmbase.is_spec)
    tl = tree_leaves(tspecs, is_leaf=tmbase.is_spec)
    assert [(s.shape, s.axes, s.init, s.scale) for s in tl] == \
        [(s.shape, s.axes, s.init, s.scale) for s in jl]
    assert tmbase.count_params(tspecs) == jmbase.count_params(jspecs)
    if size == "full":
        assert tmbase.count_params(tspecs) == COUNTS[arch]
    assert ("shared" in tspecs) == (arch == "zamba2-7b")
    for layer in tspecs["layers"]:
        assert ("ffn" in layer) == ("ln2" in layer)
    jwd, twd = jmbase.norm_param_mask(jspecs), tmbase.norm_param_mask(tspecs)
    assert tree_leaves(twd) == jax.tree.leaves(jwd)
    jlay = jfb.build_layout(jmbase.abstract(jspecs, jnp.float32), wd_mask=jwd)
    tlay = tfb.build_layout(tmbase.abstract(tspecs), wd_mask=twd)
    assert tlay.bucket_rows == jlay.bucket_rows
    assert [(s.row_offset, s.rows, s.size, s.shape, s.skip_wd) for s in tlay.slots] == \
        [(s.row_offset, s.rows, s.size, s.shape, s.skip_wd) for s in jlay.slots]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Loss and every gradient leaf; zamba2's shared block is invoked
    twice (layers 1 and 3) and takes both invocations' gradient, and the
    per-layer leaves of its layers get none (zero in the reference)."""
    jcfg, tcfg, jp, tp = _params(arch, seed=1)
    batch = _batch(tcfg.vocab_size, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, jb), has_aux=True))(jp)
    leaves, treedef = tree_flatten(tp)
    leaves = [a.clone().requires_grad_(True) for a in leaves]
    tloss, _ = lm.loss_fn(tcfg, tree_unflatten(treedef, leaves),
                          {k: torch.from_numpy(v).long() for k, v in batch.items()})
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(leaves)
    unused = set(_unused_shared_leaves(tcfg))
    if arch == "zamba2-7b":
        assert sum(bd.mixer == "shared_attn" for bd in tcfg.layer_schedule()) >= 2
        assert len(unused) == 5                     # ln1, ln2, ffn wd / wg / wu
    for i, (a, b) in enumerate(zip(leaves, jleaves)):
        b = np.asarray(b)
        if i in unused:
            assert a.grad is None and not b.any()
            continue
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_trees_match_reference(arch):
    """``init_cache`` shapes and dtypes, ``cache_axes_tree``, and
    ``grow_cache``: recurrent leaves (no ``kv_seq`` axis) pass through,
    the shared block's attention caches grow."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jc = jlm.init_cache(jcfg, 3, 16)
    tc = lm.init_cache(tcfg, 3, 16)
    assert [(tuple(a.shape), str(a.dtype).removeprefix("torch.")) for a in tree_leaves(tc)] \
        == [(b.shape, str(b.dtype)) for b in jax.tree.leaves(jc)]
    ta = tree_leaves(lm.cache_axes_tree(tcfg), is_leaf=_is_axes)
    assert ta == jax.tree.leaves(jlm.cache_axes_tree(jcfg), is_leaf=_is_axes)
    assert any("kv_seq" not in a for a in ta)
    jg = jlm.grow_cache(jcfg, jc, 40)
    tg = lm.grow_cache(tcfg, tc, 40)
    assert [tuple(a.shape) for a in tree_leaves(tg)] == [b.shape for b in jax.tree.leaves(jg)]
    for a, b, ax in zip(tree_leaves(tc), tree_leaves(tg), ta):
        assert (a is b) == ("kv_seq" not in ax)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Exact-length prefill, then 3 decode steps: logits and every cache
    leaf against the reference's; decode writes into the cache it is
    given (the same tensors, their values advanced)."""
    jcfg, tcfg, jp, tp = _params(arch, seed=2)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, tcfg.vocab_size, (B, 6))
    forced = rng.integers(0, tcfg.vocab_size, (B, 3))
    jl, jc = jax.jit(lambda p, t: jlm.prefill(jcfg, p, t, max_len=16))(
        jp, jnp.asarray(prompts, jnp.int32))
    tl, tc = lm.prefill(tcfg, tp, torch.from_numpy(prompts), max_len=16)
    jdecode = jax.jit(lambda p, t, c, n: jlm.decode_step(jcfg, p, t, c, n))
    _close(tl.numpy(), np.asarray(jl), "prefill")
    assert [tuple(x.shape) for x in tree_leaves(tc)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jc)]
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(a.numpy(), np.asarray(b), "prefill cache")
    held = tree_leaves(tc)
    before = [x.clone() for x in held]
    for i in range(forced.shape[1]):
        cl = np.array([7 + i, 7 + i], np.int32)
        jl, jc = jdecode(jp, jnp.asarray(forced[:, i:i + 1], jnp.int32), jc,
                         jnp.asarray(cl))
        tl, tc2 = lm.decode_step(tcfg, tp, torch.from_numpy(forced[:, i:i + 1]), tc,
                                 torch.from_numpy(cl))
        assert all(a is b for a, b in zip(tree_leaves(tc2), held))
        _close(tl.numpy(), np.asarray(jl), f"decode step {i}")
    for a, b, b0 in zip(held, jax.tree.leaves(jc), before):
        _close(a.numpy(), np.asarray(b), "decoded cache")
        assert not torch.equal(a, b0)


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_prefill_is_pinned_to_reference(arch):
    """A right-padded prefill with ``lengths`` reads its logits at
    ``lengths - 1`` (equal to the exact-length prefill's), while the
    recurrent states have run over the padding: the port's cache equals
    the reference's padded cache, not the exact-length one."""
    jcfg, tcfg, jp, tp = _params(arch, seed=3)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (B, 10))
    lengths = np.array([10, 6], np.int32)
    padded = toks.copy()
    padded[1, 6:] = 0
    jl, jc = jlm.prefill(jcfg, jp, jnp.asarray(padded, jnp.int32),
                         lengths=jnp.asarray(lengths))
    tl, tc = lm.prefill(tcfg, tp, torch.from_numpy(padded), lengths=torch.from_numpy(lengths))
    _close(tl.numpy(), np.asarray(jl), "padded prefill logits")
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(a.numpy(), np.asarray(b), "padded prefill cache")
    el, ec = lm.prefill(tcfg, tp, torch.from_numpy(toks[1:, :6]))
    _close(tl[1:].numpy(), el.numpy(), "padded logits = exact-length logits")
    # row 1's recurrent states against the exact-length prefill's
    moved = []
    for a, e, ax in zip(tree_leaves(tc), tree_leaves(ec),
                        tree_leaves(lm.cache_axes_tree(tcfg), is_leaf=_is_axes)):
        if "kv_seq" not in ax:
            row = a.narrow(ax.index("batch"), 1, 1)
            moved.append(not torch.allclose(row, e, rtol=1e-4, atol=1e-4))
    assert moved and any(moved)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_path_refuses_and_build_serve_decodes(arch):
    """The paged engine needs ``kv_seq`` on every cache leaf: the layout
    and ``build_engine`` raise, naming the contiguous path; ``build_serve``
    (prefill, grown cache, decode) gives the teacher-forced logits."""
    tcfg = tconfigs.get_smoke(arch)
    with pytest.raises(ValueError, match="contiguous"):
        paged.build_page_layout(tcfg, page_size=4, max_len=16, num_pages=8)
    with pytest.raises(ValueError, match="contiguous"):
        build_engine(tcfg, type("S", (), {"global_batch": 2, "seq_len": 16})(),
                     page_size=4, device="cpu")
    _, _, _, tp = _params(arch, seed=4)
    sb = build_serve(tcfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, tcfg.vocab_size, (B, 9)))
    lg, cache = sb.prefill(tp, {"tokens": toks[:, :6]})
    cache = lm.grow_cache(tcfg, cache, 12)
    rows = [lg[:, -1]]
    for i in range(6, 9):
        lg, cache = sb.decode_step(tp, {"tokens": toks[:, i:i + 1]}, cache, i + 1)
        rows.append(lg[:, -1])
    with torch.no_grad():
        full = lm.logits_from_hidden(tcfg, tp, lm.forward(tcfg, tp, toks))
    for j, r in enumerate(rows):
        _close(r.numpy(), full[:, 5 + j].numpy(), f"position {5 + j}")


def _run(cb, cfg, mode):
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", S, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=2, post_local_switch=2,
                                    sync_compression=mode),
        optim=cb.OptimConfig(base_lr=0.3, base_batch=W * B, weight_decay=1e-2,
                             grad_clip=1.0))


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
    """Post-local SGD at W=2 (syncs every step before the switch at step
    2, every H=2 steps after it), 4 steps through the bucket path of both
    packages.  Every sync also runs on a port state holding the
    reference's own buffers: params and anchor within 1e-6 x their
    largest entry, momentum and EF memory within 1e-5 x.  The free
    port's sign flips are counted and printed, its loss held at rtol
    1e-5 until the first flip, its end state to the compressed-trajectory
    tolerance of ``test_torch_arch`` (at most 1e-4 of the elements beyond
    1e-4 x the largest), counted over the elements that never flipped:
    xlstm's sLSTM input and forget gate biases have gradients that are 0
    up to rounding (on the first step their effect on c and n cancels in
    h = o c / n), so about 140 of them take a rounding-decided sign at
    every sync and move by a whole scale.  Under the mean sync, zamba2's
    unused shared-layer leaves shrink by weight decay alone."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jb = jbuild(_run(jcb, jcfg, mode), num_workers=W, use_kernel=True)
    tb = tbuild(_run(tcb, tcfg, mode), num_workers=W, device="cpu")
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    js = jb.init(jax.random.PRNGKey(1), p0)
    ts = tb.init(params_from_reference(jax.tree.map(np.asarray, p0), "cpu"))
    jstep = jax.jit(jb.local_step)
    jsync = jax.jit(lambda s: jb.sync(s, plan=jb.sync_plan, scope="global"))
    it = iter(ShardedBatches(lm_examples(markov_lm(
        vocab=tcfg.vocab_size, num_seqs=32, seq_len=S)), W, B))
    steps = 4
    syncs = dict(sync_boundaries(tb.run.local_sgd, steps))
    assert list(syncs) == [0, 1, 3]
    fields = ("params", "momentum", "anchor", "ef_memory")
    flips = []
    flipped = [torch.zeros((W,) + b.shape, dtype=torch.bool) for b in ts.anchor.buckets] \
        if mode != "none" else None
    for t in range(steps):
        batch = next(it)
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
                # an element whose compressor input took opposite signs in
                # some worker at some sync moved by a whole scale there,
                # for every worker (the sync sends each the mean)
                beyond &= ~flipped[i].numpy().any(axis=0)
            frac = float(np.mean(beyond))
            assert frac <= 1e-4, (f, frac, flips)
    if arch == "zamba2-7b" and mode == "none":
        # the shared layers' own leaves take no gradient: weight decay
        # (they are > 1-D) shrinks every element toward 0 without a sign
        # change (the mean sync of equal copies keeps them)
        par = tfb.unflatten(tb.layout, [b[0] for b in ts.params.buckets])
        p0t = params_from_reference(jax.tree.map(np.asarray, p0), "cpu")
        for i in _unused_shared_leaves(tcfg):
            p, q = tree_leaves(par)[i], tree_leaves(p0t)[i]
            assert bool((p.abs() <= q.abs()).all()) and bool((p * q >= 0).all())
            assert float(p.abs().sum()) < float(q.abs().sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_the_smoke_config(arch, capsys):
    ttrain.main(["--arch", arch, "--device", "cpu", "--steps", "3", "--seq", "32",
                 "--local-batch", "2", "--sync-compression", "ef_sign"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("done: final loss=")
    loss = float(last.split("final loss=")[1].split()[0])
    assert np.isfinite(loss)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_and_save_flat_roundtrips(arch, tmp_path):
    """``params_from_reference`` keeps the tree (the ``shared`` subtree in
    sorted-key order, the shared layers' empty ``mix`` dicts, the (n, H)
    stacked ``dt_bias`` / ``A_log`` / ``D``); a reference ``save_flat``
    of the params restores into the port and a port ``save_flat`` into
    the reference, leaf for leaf exactly."""
    jcfg, tcfg, jp, tp = _params(arch, seed=5)
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = tree_flatten(tp)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert np.array_equal(a.numpy(), np.asarray(b))
    if arch == "zamba2-7b":
        assert sorted(tp["shared"]) == ["attn", "ffn", "ln1", "ln2"]
        assert tp["layers"][1]["mix"] == {}
        n = tcfg.num_layers // len(tcfg.blocks)
        H = tcfg.ssm.expand * tcfg.d_model // tcfg.ssm.head_dim
        for k in ("dt_bias", "A_log", "D"):
            assert tuple(tp["layers"][0]["mix"][k].shape) == (n, H)
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
