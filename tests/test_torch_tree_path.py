"""Port parity: the per-leaf tree path of local SGD (repro_torch vs repro).

The reference's ``make_local_sgd`` without residency keeps its state as
stacked ``(W, ...)`` trees; it is the reference's default
(``use_kernel=False``: per-leaf jnp) and, with ``use_kernel=True,
resident=False``, the tree-in/tree-out kernel form.  The port's tree path
(``make_local_sgd(..., use_kernel=False)`` / ``resident=False``) is held
against it here on the same numpy weights and batches: the harness of the
reference's ``tests/test_resident_state.py`` (W=4 workers, H=2 local
steps a round, 3 rounds, a masked bias), with the reference's kernel form
in Pallas interpret mode and the port's on its kernels' plain versions.

Tolerances:

* float32 trajectories: every leaf of params, momentum, anchor, global
  momentum and EF memory within rtol 1e-5, atol 1e-6 (the same math; the
  norms, L1 scales and means sum in another order);
* bfloat16 params: the dtypes exactly, the values within one bf16 ulp
  (rtol 2^-7, atol 1e-3): a rounding to bf16 of an f32 result that
  differs in its last bits can land one ulp away;
* telemetry: every field of ``state.stats`` within rtol 1e-5 (float32
  norms summed in another order), atol 1e-9 (the centred sync's post
  norm is 0 exactly on both sides, a compressor's error on a leaf of
  zeros too).

A sign-compressed paper-lm trajectory (the layout test) counts flips:
all but 1e-4 of the elements within 1e-4 x the largest entry.

Tree against resident in the port itself (the reference's
``test_resident_state.py`` pairs) is held at that file's rtol 2e-4,
atol 1e-6 (bf16: rtol 0.05, atol 1e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import base as jcb
from repro.core import compression as jcomp
from repro.core import elastic as jelastic
from repro.core import flatbuf as jflat
from repro.core import local_sgd as jsgd
from repro.core import syncplan as jsp
from repro.models import base as jmbase
from repro.optim import lars as jlars
from repro.optim import sgd as jsgd_opt
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference
from repro_torch.core import compression as tcomp
from repro_torch.core import elastic as telastic
from repro_torch.core import flatbuf as tflat
from repro_torch.core import local_sgd as tsgd
from repro_torch.core import syncplan as tsp
from repro_torch.models import base as tmbase
from repro_torch.optim import lars as tlars
from repro_torch.optim import sgd as tsgd_opt
from repro_torch.telemetry import stats as tstats
from repro_torch.utils import tree_leaves

torch.set_num_threads(2)

W = 4
H = 2        # local steps per sync round
ROUNDS = 3
FIELDS = ("params", "momentum", "anchor", "global_u", "ef_memory")
WD_MASK = {"w1": False, "b1": True, "w2": False}
FORMS = ("plain", "kernel")


def _jloss(params, batch):
    w1 = params["w1"].astype(jnp.float32)
    w2 = params["w2"].astype(jnp.float32)
    pred = jnp.tanh(batch["x"] @ w1 + params["b1"]) @ w2
    l = jnp.mean((pred - batch["y"]) ** 2)
    return l, {"xent": l}


def _tloss(params, batch):
    w1 = params["w1"].float()
    w2 = params["w2"].float()
    pred = torch.tanh(batch["x"] @ w1 + params["b1"]) @ w2
    l = ((pred - batch["y"]) ** 2).mean()
    return l, {"xent": l}


def _init_params(dtype=jnp.float32):
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    return {"w1": (jax.random.normal(k1, (6, 5)) * 0.4).astype(dtype),
            "b1": jnp.zeros((5,)),
            "w2": (jax.random.normal(k2, (5, 2)) * 0.4).astype(dtype)}


def _cfg(cb, *, compression="none", wire_pack=False, optimizer="sgd",
         momentum=0.9, nesterov=True, wd=1e-3, clip=0.0, global_momentum=0.0,
         block_steps=1, noise_eta=0.0):
    return cb.RunConfig(
        model=cb.ModelConfig(name="q", family="dense", citation=""),
        shape=cb.InputShape("t", 8, W * 4, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=H, sync_compression=compression,
                                    wire_pack=wire_pack, local_momentum=momentum,
                                    nesterov=nesterov, block_steps=block_steps,
                                    global_momentum=global_momentum),
        optim=cb.OptimConfig(optimizer=optimizer, base_lr=0.05,
                             base_batch=W * 4, weight_decay=wd, grad_clip=clip,
                             lars_trust=0.01, noise_eta=noise_eta,
                             lr_decay_steps=()))


def _batch(t):
    k = jax.random.fold_in(jax.random.PRNGKey(2), t)
    x = jax.random.normal(k, (W, 4, 6))
    y = jnp.tanh(x @ (jnp.ones((6, 5)) * 0.3)) @ (jnp.ones((5, 2)) * 0.3)
    return {"x": np.asarray(x), "y": np.asarray(y)}


def _scopes(block_steps: int):
    """The scope of each round's sync: Alg. 5 alternates block and global."""
    return [("global" if block_steps == 1 or (r + 1) % block_steps == 0
             else "block") for r in range(ROUNDS)]


def _jplan(state, ls, topology):
    return jsp.make_sync_plan(jflat.build_layout(state.params, leading=1),
                              topology=topology, num_workers=W,
                              compression=ls.sync_compression,
                              wire_pack=ls.wire_pack,
                              anchored=jsgd.needs_anchor(ls))


def _tplan(state, ls, topology):
    return tsp.make_sync_plan(tflat.build_layout(state.params, leading=1),
                              topology=topology, num_workers=W,
                              compression=ls.sync_compression,
                              wire_pack=ls.wire_pack,
                              anchored=tsgd.needs_anchor(ls))


def _jrun(kw, *, use_kernel, dtype=jnp.float32, rounds=ROUNDS,
          bucket_sync=True, **mk):
    """The reference's tree path: rounds x H local steps, a sync a round."""
    run = _cfg(jcb, **kw)
    init, local_step, sync = jsgd.make_local_sgd(
        run, _jloss, num_workers=W, wd_mask=WD_MASK, use_kernel=use_kernel,
        resident=False, bucket_sync=bucket_sync, **mk)
    state = init(jax.random.PRNGKey(0), _init_params(dtype))
    assert not jsgd.is_resident(state)
    topo = (jsp.hierarchical(2) if run.local_sgd.block_steps > 1
            else jsp.flat())
    losses = []
    for r, scope in zip(range(rounds), _scopes(run.local_sgd.block_steps)):
        for _ in range(H):
            b = _batch(int(state.step))
            state, m = local_step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        state = sync(state, plan=_jplan(state, run.local_sgd, topo),
                     scope=scope)
    return state, losses


def _trun(kw, *, form, dtype=jnp.float32, rounds=ROUNDS, bucket_sync=True,
          **mk):
    """The port: ``form`` "plain" / "kernel" (the tree path's two forms) or
    "resident"."""
    run = _cfg(tcb, **kw)
    init, local_step, sync = tsgd.make_local_sgd(
        run, _tloss, num_workers=W, wd_mask=WD_MASK,
        use_kernel=form != "plain", resident=form == "resident",
        bucket_sync=bucket_sync, **mk)
    p0 = params_from_reference(jax.tree.map(np.asarray, _init_params(dtype)),
                               "cpu")
    state = init(p0, seed=0)
    assert tsgd.is_resident(state) == (form == "resident")
    topo = (tsp.hierarchical(2) if run.local_sgd.block_steps > 1
            else tsp.flat())
    losses = []
    for r, scope in zip(range(rounds), _scopes(run.local_sgd.block_steps)):
        for _ in range(H):
            state, m = local_step(state, _batch(int(state.step)))
            losses.append(float(m["loss"]))
        plan = (tsp.make_sync_plan(state.params.layout, num_workers=W,
                                   topology=topo,
                                   compression=run.local_sgd.sync_compression,
                                   wire_pack=run.local_sgd.wire_pack,
                                   anchored=tsgd.needs_anchor(run.local_sgd))
                if form == "resident" else _tplan(state, run.local_sgd, topo))
        state = sync(state, plan=plan, scope=scope)
    return state, losses


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, np.float32)


def _dtype_name(x):
    return (str(x.dtype).replace("torch.", "") if isinstance(x, torch.Tensor)
            else np.dtype(x.dtype).name)


def _assert_trees(got_state, want_state, *, rtol=1e-5, atol=1e-6):
    for f in FIELDS:
        got, want = getattr(got_state, f), getattr(want_state, f)
        assert (got is None) == (want is None), f
        if got is None:
            continue
        for k in want:
            assert _dtype_name(got[k]) == _dtype_name(want[k]), (f, k)
            assert tuple(got[k].shape) == tuple(want[k].shape), (f, k)
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=rtol,
                                       atol=atol, err_msg=f"{f}/{k}")


def _assert_stats(got, want):
    for fld in dataclasses.fields(tstats.StatsAccumulator):
        a = np.asarray(getattr(want, fld.name))
        b = getattr(got, fld.name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, fld.name
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-9,
                                   err_msg=fld.name)


# ---------------------------------------------------------------------------
# 1. Trajectories against the reference's tree path, both forms
# ---------------------------------------------------------------------------

SGD_CASES = [dict(momentum=0.0, nesterov=False),
             dict(momentum=0.9, nesterov=False, wd=0.0),
             dict(momentum=0.9, nesterov=True, clip=0.5),
             dict(momentum=0.9, nesterov=True, wd=1e-2, clip=0.05)]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", range(len(SGD_CASES)))
def test_sgd_tree_matches_reference(form, case):
    """Momentum / Nesterov / the wd mask / the per-worker clip, mean sync."""
    kw = SGD_CASES[case]
    js, jl = _jrun(kw, use_kernel=form == "kernel")
    ts, tl = _trun(kw, form=form)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _assert_trees(ts, js)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("compression", ["none", "ef_sign"])
def test_lars_tree_matches_reference(form, compression):
    """LARS: per-worker, per-leaf trust ratios (the masked bias takes the
    plain LR); grad_clip is set and ignored, as in the reference."""
    kw = dict(optimizer="lars", wd=1e-2, clip=0.5, compression=compression)
    js, jl = _jrun(kw, use_kernel=form == "kernel")
    ts, tl = _trun(kw, form=form)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _assert_trees(ts, js)


SYNC_CASES = [("sign", False, 0.0), ("sign", True, 0.0), ("ef_sign", False, 0.0),
              ("ef_sign", True, 0.0), ("sign", True, 0.9), ("none", False, 0.9)]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("compression,wire_pack,gm", SYNC_CASES)
def test_compressed_sync_tree_matches_reference(form, compression, wire_pack,
                                                gm):
    """Sign / EF-sign (the per-leaf scale over all W workers of a leaf),
    the 1-bit wire pack (per worker, through the flat bus) and global
    momentum on the anchored sync."""
    kw = dict(compression=compression, wire_pack=wire_pack,
              global_momentum=gm, clip=0.5)
    js, jl = _jrun(kw, use_kernel=form == "kernel")
    ts, tl = _trun(kw, form=form)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _assert_trees(ts, js)


@pytest.mark.parametrize("compression,wire_pack", [("none", False),
                                                   ("ef_sign", True)])
def test_per_leaf_sync_matches_reference(compression, wire_pack):
    """``bucket_sync=False``: means and the wire pack leaf by leaf (the
    per-leaf pack along the last dim, a scale per worker)."""
    kw = dict(compression=compression, wire_pack=wire_pack, clip=0.5)
    js, jl = _jrun(kw, use_kernel=False, bucket_sync=False)
    ts, tl = _trun(kw, form="plain", bucket_sync=False)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _assert_trees(ts, js)


@pytest.mark.parametrize("form", FORMS)
def test_block_scope_tree_matches_reference(form):
    """Hierarchical local SGD (Alg. 5): blocks of 2 of the 4 workers at
    the block scope, all 4 at the global one (rounds: block, global,
    block)."""
    kw = dict(block_steps=2, clip=0.5)
    js, jl = _jrun(kw, use_kernel=form == "kernel")
    ts, tl = _trun(kw, form=form)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    _assert_trees(ts, js)
    # the last sync was a block sync: the two blocks differ
    p = ts.params["w1"]
    assert torch.equal(p[0], p[1]) and torch.equal(p[2], p[3])
    assert not torch.equal(p[0], p[2])


TELEMETRY_CASES = [dict(clip=0.05), dict(compression="ef_sign", clip=0.05),
                   dict(compression="sign", wire_pack=True),
                   dict(optimizer="lars", clip=0.5),
                   dict(global_momentum=0.5)]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", range(len(TELEMETRY_CASES)))
def test_telemetry_tree_matches_reference(form, case):
    """``state.stats``: the analytic post-clip grad norm (none under
    LARS), the update norm from the f32 difference, the centred mean-sync
    pair, the compressors' error; with speculation on (the last case) the
    would-be sign error of an uncompressed anchored sync.  The trajectory
    is the one without telemetry, bit for bit."""
    kw = TELEMETRY_CASES[case]
    spec = kw.get("global_momentum", 0.0) > 0
    js, _ = _jrun(kw, use_kernel=form == "kernel", telemetry=True,
                  speculate_compression=spec)
    ts, tl = _trun(kw, form=form, telemetry=True, speculate_compression=spec)
    assert ts.stats.comp_err_sq.shape == (1,)
    _assert_trees(ts, js)
    _assert_stats(ts.stats, js.stats)
    if spec or kw.get("compression", "none") != "none":
        assert float(ts.stats.comp_ref_sq[0]) > 0
    bare, bl = _trun(kw, form=form)
    assert bl == tl
    for a, b in zip(tree_leaves(bare.params), tree_leaves(ts.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form,clip", [("plain", 0.5), ("kernel", 0.0),
                                       ("kernel", 0.5)])
def test_bf16_dtype_promotion_matches_reference(form, clip):
    """bf16 params (the bias stays f32: two dtypes): momentum and EF memory
    start in the params' dtype, the EF memory and global momentum become
    float32 at the first sync, the anchor keeps the params' dtype.  Values
    within one bf16 ulp, but for the kernel form with a clip: the port
    folds the clip scale into the update launch in f32, where the
    reference rounds the clipped bf16 gradient to bf16 first (a kept
    difference, ROADMAP C), so there the reference's own bf16 tolerance
    between its kernel and per-leaf forms holds (rtol 0.05, atol 1e-2;
    losses rtol 2^-7)."""
    kw = dict(compression="ef_sign", global_momentum=0.9, clip=clip)
    run = _cfg(tcb, **kw)
    init, _, _ = tsgd.make_local_sgd(run, _tloss, num_workers=W,
                                     wd_mask=WD_MASK, use_kernel=form == "kernel",
                                     resident=False)
    s0 = init(params_from_reference(
        jax.tree.map(np.asarray, _init_params(jnp.bfloat16)), "cpu"))
    assert s0.ef_memory["w1"].dtype == torch.bfloat16
    assert s0.global_u["w1"].dtype == torch.bfloat16
    js, jl = _jrun(kw, use_kernel=form == "kernel", dtype=jnp.bfloat16)
    ts, tl = _trun(kw, form=form, dtype=jnp.bfloat16)
    assert ts.params["w1"].dtype == ts.momentum["w1"].dtype == torch.bfloat16
    assert ts.params["b1"].dtype == torch.float32
    assert ts.ef_memory["w1"].dtype == ts.global_u["w1"].dtype == torch.float32
    assert ts.anchor["w1"].dtype == torch.bfloat16
    wide = form == "kernel" and clip > 0
    np.testing.assert_allclose(tl, jl, rtol=2 ** -7 if wide else 1e-5)
    _assert_trees(ts, js, rtol=0.05 if wide else 2 ** -7,
                  atol=1e-2 if wide else 1e-3)


def test_tree_metrics_and_mean_params():
    """Metrics are worker means; ``mean_params`` of a tree state is each
    leaf's worker mean, as the reference's; across ranks its leaves ride
    dtype buckets through the collectives' ordered mean, one call a bucket
    (``tests/test_torch_tree_dist.py`` runs it on ``gloo`` ranks)."""
    run = _cfg(tcb)
    init, local_step, _ = tsgd.make_local_sgd(run, _tloss, num_workers=W,
                                              wd_mask=WD_MASK, use_kernel=False)
    jinit, jstep, _ = jsgd.make_local_sgd(_cfg(jcb), _jloss, num_workers=W,
                                          wd_mask=WD_MASK)
    p0 = _init_params()
    ts = init(params_from_reference(jax.tree.map(np.asarray, p0), "cpu"))
    js = jinit(jax.random.PRNGKey(0), p0)
    b = _batch(0)
    ts, tm = local_step(ts, b)
    js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    assert set(tm) == set(jm)
    for k in ("loss", "xent", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    mp, jmp = tsgd.mean_params(ts), jsgd.mean_params(js)
    for k in jmp:
        np.testing.assert_allclose(mp[k].numpy(), np.asarray(jmp[k]),
                                   rtol=1e-6, atol=1e-7)
    calls = []

    class OneRank:
        """Collectives of one rank holding every worker."""
        def ordered_mean(self, x, *, scope, stage=None, group=None, n=None):
            calls.append((scope, tuple(x.shape)))
            return x.mean(dim=0)

    dm = tsgd.mean_params(ts, dist=OneRank())
    assert [c[0] for c in calls] == ["eval"] and calls[0][1][0] == W
    for k in mp:
        assert torch.equal(dm[k], mp[k]), k


# ---------------------------------------------------------------------------
# 2. The tree path against the resident path, in the port
#    (the reference's tests/test_resident_state.py pairs)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
@pytest.mark.parametrize("wd,clip", [(0.0, 0.0), (1e-3, 0.5)])
def test_sgd_resident_matches_tree(momentum, nesterov, wd, clip):
    kw = dict(momentum=momentum, nesterov=nesterov, wd=wd, clip=clip)
    s_res, _ = _trun(kw, form="resident")
    s_ref, _ = _trun(kw, form="plain")
    _assert_trees(tsgd.unpack_state(s_res), s_ref, rtol=2e-4)


@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_lars_resident_matches_tree(wd):
    kw = dict(optimizer="lars", wd=wd)
    s_res, _ = _trun(kw, form="resident")
    s_ref, _ = _trun(kw, form="plain")
    _assert_trees(tsgd.unpack_state(s_res), s_ref, rtol=2e-4)


@pytest.mark.parametrize("compression,wire_pack,gm", SYNC_CASES)
def test_compressed_sync_resident_matches_tree(compression, wire_pack, gm):
    """The resident EF memory is float32 from the start; the tree path's
    becomes float32 at its first sync, so after a sync the two agree in
    dtype too."""
    kw = dict(compression=compression, wire_pack=wire_pack,
              global_momentum=gm, clip=0.5)
    s_res, _ = _trun(kw, form="resident")
    s_ref, _ = _trun(kw, form="plain")
    _assert_trees(tsgd.unpack_state(s_res), s_ref, rtol=2e-4)


def test_resident_bf16_matches_tree():
    s_res, _ = _trun({}, form="resident", dtype=jnp.bfloat16)
    s_ref, _ = _trun({}, form="plain", dtype=jnp.bfloat16)
    view = tsgd.unpack_state(s_res)
    assert view.params["w1"].dtype == view.momentum["w1"].dtype == torch.bfloat16
    assert view.params["b1"].dtype == torch.float32
    _assert_trees(view, s_ref, rtol=0.05, atol=1e-2)


# ---------------------------------------------------------------------------
# 3. The tree forms of the optimizers and compressors, leaf for leaf
# ---------------------------------------------------------------------------

def _stacked(seed=7, lead=(W,)):
    rng = np.random.default_rng(seed)
    return {"w1": rng.normal(size=lead + (6, 5)).astype(np.float32),
            "b1": rng.normal(size=lead + (5,)).astype(np.float32),
            "w2": rng.normal(size=lead + (5, 2)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("optimizer", ["sgd", "lars"])
def test_apply_tree_optimizer_matches_reference(use_kernel, optimizer):
    """``apply_sgd`` / ``apply_lars`` on stacked trees (``leading=1``)
    against the reference's one-worker call under ``vmap``, and on one
    worker's tree (``leading=0``) against the reference's call."""
    p, g, u = _stacked(1), _stacked(2), _stacked(3)
    if optimizer == "sgd":
        kw = dict(lr=0.1, momentum_coef=0.9, weight_decay=1e-2, nesterov=True,
                  wd_mask=WD_MASK, grad_clip=1.5)
        jf, tf = jsgd_opt.apply_sgd, tsgd_opt.apply_sgd
    else:
        kw = dict(lr=0.1, trust=0.02, momentum_coef=0.9, weight_decay=1e-2,
                  nesterov=True, wd_mask=WD_MASK)
        jf, tf = jlars.apply_lars, tlars.apply_lars
    jp, ju = jax.vmap(lambda a, b, c: jf(a, b, c, use_kernel=use_kernel, **kw))(
        _j(p), _j(g), _j(u))
    tp, tu = tf(_t(p), _t(g), _t(u), use_kernel=use_kernel, leading=1, **kw)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-5,
                                   atol=1e-6)
    one = lambda t: {k: v[1] for k, v in t.items()}
    jp1, _ = jf(_j(one(p)), _j(one(g)), _j(one(u)), use_kernel=use_kernel, **kw)
    tp1, _ = tf(_t(one(p)), _t(one(g)), _t(one(u)), use_kernel=use_kernel, **kw)
    for k in p:
        np.testing.assert_allclose(tp1[k].numpy(), np.asarray(jp1[k]),
                                   rtol=1e-5, atol=1e-6)


def test_clip_by_global_norm_per_worker():
    g = _stacked(4)
    got = tsgd_opt.clip_by_global_norm(_t(g), 2.0, leading=1)
    want = jax.vmap(lambda x: jsgd_opt.clip_by_global_norm(x, 2.0))(_j(g))
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
    assert tsgd_opt.clip_by_global_norm(_t(g), 0.0)["w1"] is not None
    mom = tsgd_opt.init_momentum(_t(g))
    assert all(float(v.abs().sum()) == 0 for v in mom.values())


@pytest.mark.parametrize("use_kernel", [False, True])
def test_tree_compressors_match_reference(use_kernel):
    """``sign_compress`` / ``ef_compress`` on a stacked delta: the per-leaf
    scale over all W workers of a leaf; the EF invariant compressed +
    memory' == delta + memory exactly in f32."""
    d, e = _stacked(5), _stacked(6)
    jc = jcomp.sign_compress(_j(d), use_kernel=use_kernel)
    tc = tcomp.sign_compress(_t(d), use_kernel=use_kernel)
    jo, je = jcomp.ef_compress(_j(d), _j(e), use_kernel=use_kernel)
    to, te = tcomp.ef_compress(_t(d), _t(e), use_kernel=use_kernel)
    for k in d:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-6)
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), rtol=1e-6)
        np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]), rtol=1e-5,
                                   atol=1e-6)
        inp = torch.from_numpy(d[k]) + torch.from_numpy(e[k])
        assert torch.equal(te[k], inp - to[k])
    # one worker's tree (a worker dim of 1) and a leaf kept off the flat bus
    one = {k: v[:1] for k, v in d.items()}
    got = tcomp.sign_compress(_t(one), use_kernel=use_kernel,
                              bucketable={"w1": True, "b1": False, "w2": True})
    want = jcomp.sign_compress(_j(one), use_kernel=use_kernel)
    for k in d:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)


def test_bucket_compressors_match_reference():
    """``sign_compress_buckets`` / ``ef_compress_buckets`` on stacked
    buckets against the reference's."""
    d, e = _stacked(8), _stacked(9)
    jl = jflat.build_layout(_j(d), leading=1)
    tl = tflat.build_layout(_t(d), leading=1)
    jb = jflat.flatten(jl, _j(d), leading=1)
    tb = tflat.flatten(tl, _t(d), leading=1)
    je = jflat.flatten(jl, _j(e), leading=1)
    te = tflat.flatten(tl, _t(e), leading=1)
    for a, b in zip(jcomp.sign_compress_buckets(jl, jb, leading=1),
                    tcomp.sign_compress_buckets(tl, tb, leading=1)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    jo, jm = jcomp.ef_compress_buckets(jl, jb, je, leading=1)
    to, tm = tcomp.ef_compress_buckets(tl, tb, te, leading=1)
    for a, b, c, d_ in zip(jo, to, jm, tm):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
        np.testing.assert_allclose(d_.numpy(), np.asarray(c), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_bucket_means_match_reference(group):
    """``bucket_group_mean`` (a tensor of its own: no two workers share
    storage), ``bucket_worker_mean`` and ``bucket_packed_mean`` against the
    reference's, a leaf kept off the bus by ``bucketable``."""
    d = _stacked(10)
    flags = {"w1": True, "b1": False, "w2": True}
    got = tsgd.bucket_group_mean(_t(d), group, flags)
    want = jsgd.bucket_group_mean(_j(d), group, flags)
    for k in d:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
        assert got[k].stride()[0] != 0
    before = got["w2"][1].clone()
    got["w2"][0].add_(1.0)
    assert torch.equal(got["w2"][1], before)
    wm = tsgd.bucket_worker_mean(_t(d), flags)
    pm = tsgd.bucket_packed_mean(_t(d), flags)
    jwm = jsgd.bucket_worker_mean(_j(d), flags)
    jpm = jsgd.bucket_packed_mean(_j(d), flags)
    for k in d:
        np.testing.assert_allclose(wm[k].numpy(), np.asarray(jwm[k]), rtol=1e-6)
        # a mean of +-scale over W: its cancellation needs an atol (an
        # f32 ulp of the O(1) scales)
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jpm[k]), rtol=1e-6,
                                   atol=2e-7)


def test_stack_and_unstack_mean_match_reference():
    """``stack`` copies (writing one worker leaves the others), and
    ``unstack_mean`` is each leaf's worker mean; ``stack_tree`` copies
    too."""
    p = {k: v[0] for k, v in _stacked(11).items()}
    for fn in (lambda t: tmbase.stack(t, W), lambda t: tsgd.stack_tree(t, W)):
        st = fn(_t(p))
        want = jmbase.stack(_j(p), W)
        for k in p:
            assert torch.equal(st[k], torch.from_numpy(np.asarray(want[k])))
        st["w1"][0].add_(1.0)
        assert torch.equal(st["w1"][1], torch.from_numpy(p["w1"]))
    d = _stacked(12)
    got, want = tmbase.unstack_mean(_t(d)), jmbase.unstack_mean(_j(d))
    for k in d:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("kind", ["tp", "fsdp"])
def test_pack_axes_tree_matches_reference(kind):
    """The per-leaf pack axis on every paper-lm leaf (full width), from the
    effective rules of a TP / FSDP layout with its sizes."""
    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro.sharding import layout as jlayout
    from repro_torch import configs as tconfigs
    from repro_torch.models import lm as tlm
    from repro_torch.sharding import layout as tlayout

    def lay(lib):
        if kind == "tp":
            out = lib.train_layout(("data", "model"), worker_axes=("data",))
        else:
            out = lib.fsdp_within_worker_layout(("data", "model"),
                                                worker_axes=("data",),
                                                shard_axes=("model",))
        sizes = {"data": 2, "model": 4}
        return (out.with_sizes(sizes) if lib is tlayout
                else dataclasses.replace(out, sizes=sizes))

    got = tsgd.pack_axes_tree(tlm.param_specs(tconfigs.get("paper-lm")),
                              lay(tlayout))
    want = jsgd.pack_axes_tree(jlm.param_specs(jconfigs.get("paper-lm")),
                               lay(jlayout))
    assert tree_leaves(got) == jax.tree.leaves(want)
    assert len(set(tree_leaves(got))) > 1


def test_tree_path_with_a_layout_matches_reference():
    """``build_train(use_kernel=False, layout=)``: the leaves a TP layout
    shards stay off the flat bus (``bucketable``) and the wire pack packs
    each of them along ``pack_axes_tree``'s axis, as the reference's tree
    path does with ``bucketable`` and ``packed_mean_fn=(None, axes)``;
    EF-sign with the wire pack on paper-lm smoke, against the reference's
    ``make_local_sgd`` on the same leaves, weights and batches: losses
    rtol 1e-5, params by the sign-flip rule of ``test_torch_local_sgd``."""
    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro.sharding import layout as jlayout
    from repro_torch import configs as tconfigs
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.launch.steps import build_train as tbuild
    from repro_torch.sharding import layout as tlayout

    Wl, Bl, S = 2, 2, 16
    sizes = {"data": 2, "model": 2}
    tlay = tlayout.train_layout(("data", "model"),
                                worker_axes=("data",)).with_sizes(sizes)
    jlay = dataclasses.replace(
        jlayout.train_layout(("data", "model"), worker_axes=("data",)),
        sizes=sizes)

    def run(cb, cfg):
        return cb.RunConfig(
            model=cfg, shape=cb.InputShape("t", S, Wl * Bl, "train"),
            local_sgd=cb.LocalSGDConfig(local_steps=2, sync_compression="ef_sign",
                                        wire_pack=True),
            optim=cb.OptimConfig(base_lr=0.3, base_batch=Wl * Bl,
                                 grad_clip=1.0))

    jcfg = jconfigs.get_smoke("paper-lm")
    rj = run(jcb, jcfg)
    specs = jlm.param_specs(jcfg)
    bucketable = jflat.replicated_tree(jflat.shard_classes(specs, jlay))
    assert not all(jax.tree.leaves(bucketable))
    init, jstep, jsync = jsgd.make_local_sgd(
        rj, lambda p, b: jlm.loss_fn(jcfg, p, b), num_workers=Wl,
        wd_mask=jmbase.norm_param_mask(specs), bucketable=bucketable,
        packed_mean_fn=(None, jsgd.pack_axes_tree(specs, jlay)))
    p0 = jmbase.materialize(specs, jax.random.PRNGKey(0))
    js = init(jax.random.PRNGKey(1), p0)
    tb = tbuild(run(tcb, tconfigs.get_smoke("paper-lm")), num_workers=Wl,
                device="cpu", use_kernel=False, layout=tlay)
    ts = tb.init(params_from_reference(jax.tree.map(np.asarray, p0), "cpu"))
    it = ShardedBatches(lm_examples(markov_lm(vocab=jcfg.vocab_size,
                                              num_seqs=16, seq_len=S)), Wl, Bl)
    jstep = jax.jit(jstep)
    for t in range(4):
        b = next(it)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tb.local_step(ts, b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        if t % 2 == 1:
            js = jsync(js)
            ts = tb.sync(ts, plan=tb.sync_plan)
    # a delta within rounding of 0 may take the other sign in the other
    # framework and move its element by a whole scale: all but 1e-4 of
    # the elements within 1e-4 x the largest entry
    got = np.concatenate([a.numpy().ravel() for a in tree_leaves(ts.params)])
    want = np.concatenate([np.asarray(b).ravel()
                           for b in jax.tree.leaves(js.params)])
    assert np.mean(np.abs(got - want) > 1e-4 * np.abs(want).max()) <= 1e-4


# ---------------------------------------------------------------------------
# 4. Resizes and checkpoints of a tree state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("new_w,fold", [(2, "mean"), (2, "slice"), (8, "mean")])
def test_resize_tree_state_matches_reference(new_w, fold):
    """``elastic.resize_state`` folds or clones every stacked leaf (params,
    momentum, EF memory, the stats' (W,) fields); the single-copy anchor
    passes through."""
    kw = dict(compression="ef_sign", clip=0.5)
    js, _ = _jrun(kw, use_kernel=False, rounds=1, telemetry=True)
    ts, _ = _trun(kw, form="plain", rounds=1, telemetry=True)
    jr = jelastic.resize_state(js, new_w, fold=fold)
    tr = telastic.resize_state(ts, new_w, fold=fold)
    assert tr.params["w1"].shape[0] == new_w
    assert tr.anchor is ts.anchor
    _assert_trees(tr, jr)
    assert tr.stats.acc_grad_sq.shape == (new_w,)
    _assert_stats(tr.stats, jr.stats)


def test_tree_checkpoint_reference_restores_and_packs_resident(tmp_path):
    """A tree state saved by the port restores in the reference (member for
    member) and in the port, where ``pack_state`` turns it resident: the
    buckets hold the tree's values (EF memory float32), and a step from
    there is the resident path's step from the tree state packed the same
    way."""
    kw = dict(compression="ef_sign", clip=0.5)
    ts, _ = _trun(kw, form="plain", rounds=2)
    js, _ = _jrun(kw, use_kernel=False, rounds=2)
    path = str(tmp_path / "tree")
    tckpt.save(path, ts, step=int(ts.step))
    tmpl = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), js)
    back_j = jckpt.restore(path, tmpl)
    assert int(back_j.step) == ts.step
    for f in FIELDS:
        got, want = getattr(back_j, f), getattr(ts, f)
        assert (got is None) == (want is None)
        for k in (want or {}):
            np.testing.assert_array_equal(np.asarray(got[k]), want[k].numpy())
    back_t = tckpt.restore(path, ts)
    res = tsgd.pack_state(back_t, wd_mask=WD_MASK)
    assert tsgd.is_resident(res) and res.step == ts.step
    assert res.ef_memory.buckets[0].dtype == torch.float32
    lay = tflat.build_layout(ts.params, wd_mask=WD_MASK, leading=1)
    assert res.params.layout == lay
    for a, b in zip(res.params.buckets,
                    tflat.flatten(lay, ts.params, leading=1)):
        assert torch.equal(a, b)
    run = _cfg(tcb, **kw)
    _, step_res, _ = tsgd.make_local_sgd(run, _tloss, num_workers=W,
                                         wd_mask=WD_MASK)
    res2 = tsgd.pack_state(ts, wd_mask=WD_MASK)
    s1, _ = step_res(res, _batch(int(res.step)))
    s2, _ = step_res(res2, _batch(int(res2.step)))
    for a, b in zip(s1.params.buckets, s2.params.buckets):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# 5. What the tree path refuses, and its noise
# ---------------------------------------------------------------------------

def test_tree_path_refusals():
    """A per-bucket mode tuple (the reference's ValueError), compression
    without an anchor, a compressed block sync, workers split over shard
    ranks (S > 1) without the leaves' sharding classes (with them it
    builds, and a rank holds its shard's slices; whole workers a rank
    build too), classes of another shard count than the grid's, a custom
    per-leaf wire pack beside sharding classes, and resident=True without
    the kernels."""
    run = _cfg(tcb, compression="ef_sign")
    init, local_step, sync = tsgd.make_local_sgd(run, _tloss, num_workers=W,
                                                 wd_mask=WD_MASK,
                                                 use_kernel=False)
    s = init(params_from_reference(jax.tree.map(np.asarray, _init_params()),
                                   "cpu"))
    lay = tflat.build_layout(s.params, leading=1)
    two = tflat.build_layout({"a": torch.zeros(W, 3),
                              "b": torch.zeros(W, 3, dtype=torch.bfloat16)},
                             leading=1)
    plan = tsp.make_sync_plan(two, num_workers=W, compression=("sign", "ef_sign"))
    with pytest.raises(ValueError, match="single compression mode"):
        sync(s, plan=plan)
    plain = _cfg(tcb)
    _, _, psync = tsgd.make_local_sgd(plain, _tloss, num_workers=W,
                                      use_kernel=False)
    with pytest.raises(ValueError, match="anchor"):
        psync(s, plan=tsp.make_sync_plan(lay, num_workers=W,
                                         compression="sign", anchored=False))
    with pytest.raises(ValueError, match="flat"):
        sync(s, plan=tsp.make_sync_plan(lay, num_workers=W,
                                        topology=tsp.hierarchical(2),
                                        compression="ef_sign"),
             scope="block")
    from types import SimpleNamespace
    from repro_torch.sharding.layout import WorkerLayout
    split = SimpleNamespace(layout=WorkerLayout(W, 4, 0, within_worker_size=2))
    with pytest.raises(ValueError, match="sharding classes"):
        tsgd.make_local_sgd(run, _tloss, num_workers=W, use_kernel=False,
                            dist=split)
    whole = SimpleNamespace(layout=WorkerLayout(W, 2, 1))
    init2, _, _ = tsgd.make_local_sgd(run, _tloss, num_workers=W,
                                      use_kernel=False, dist=whole)
    assert init2(s.anchor).params["w1"].shape[0] == W // 2
    # a worker split over shard ranks builds with the leaves' classes: the
    # rank holds its workers' rows of its shard's slice of w1 (6 = 2 x 3)
    cls = {"w1": tflat.ShardClass(("model",), ((0, 2),)),
           "b1": tflat.REPLICATED, "w2": tflat.REPLICATED}
    shard1 = SimpleNamespace(layout=WorkerLayout(W, 4, 1,
                                                 within_worker_size=2))
    for kw in (dict(use_kernel=False), dict(resident=False)):
        init3, _, _ = tsgd.make_local_sgd(run, _tloss, num_workers=W,
                                          dist=shard1, shard_classes=cls,
                                          **kw)
        s3 = init3(s.anchor)
        assert s3.params["w1"].shape == (W // 2, 3, 5)
        assert torch.equal(s3.anchor["w1"], s.anchor["w1"][3:])
        assert s3.params["w2"].shape == (W // 2, 5, 2)
    with pytest.raises(ValueError, match="slices of 2 only"):
        tsgd.make_local_sgd(run, _tloss, num_workers=W, use_kernel=False,
                            dist=split, shard_classes={
                                **cls, "w1": tflat.ShardClass(("m",),
                                                              ((0, 3),))})
    with pytest.raises(ValueError, match="sharded leaves' scales"):
        tsgd.make_local_sgd(run, _tloss, num_workers=W, resident=False,
                            shard_classes=cls,
                            packed_mean_fn=(lambda d, a: d.mean(0), None))
    with pytest.raises(ValueError, match="use_kernel and bucket_sync"):
        tsgd.make_local_sgd(run, _tloss, num_workers=W, use_kernel=False,
                            resident=True)


@pytest.mark.parametrize("form", FORMS)
def test_tree_noise_is_per_worker_and_seeded(form):
    """Gradient noise on the tree path: drawn per leaf from the state's
    generator, worker after worker, so workers differ, one seed repeats
    bit for bit, and another seed differs.  (The reference's threefry
    stream has no torch counterpart: noisy runs compare statistically,
    as ``tests/test_torch_noise.py`` does.)"""
    run = _cfg(tcb, noise_eta=0.05, momentum=0.0, wd=0.0)
    init, local_step, _ = tsgd.make_local_sgd(
        run, lambda p, b: ((p["w1"] * 0).sum(), {}), num_workers=W,
        use_kernel=form == "kernel", resident=False)
    p0 = {"w1": torch.zeros(64, 32)}

    def one(seed):
        s, _ = local_step(init(p0, seed=seed), {"x": np.zeros((W, 1))})
        return s.params["w1"]

    a, b, c = one(3), one(3), one(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])
    # one step of lr * N(0, eta): the update's variance
    lr = float(tsgd.lr_at(run.optim, 0, global_batch=run.shape.global_batch))
    var = float((a / lr).var())
    assert abs(var / 0.05 - 1) < 0.05, var


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_per_worker_sums_do_not_depend_on_the_workers_beside(workers):
    """The tree path's per-worker sums (``optim.sgd.sum_from`` with one
    leading axis: the grad clip's and LARS's norms, the telemetry's sums of
    squares) reduce one worker at a time, so worker w's sum is the same
    bits in a process holding W workers as on a rank holding some of them
    (the card reduces a (W, n) tensor over n in an order that depends on
    W), and equal to the reference's per-worker sum within rounding."""
    rng = np.random.default_rng(workers)
    x = torch.from_numpy(rng.normal(size=(4, 3, 1000)).astype(np.float32))
    whole = tsgd_opt.sum_from(x, 1)
    part = tsgd_opt.sum_from(x[4 - workers:].clone(), 1)
    assert torch.equal(whole[4 - workers:], part)
    assert all(torch.equal(whole[w], x[w].sum()) for w in range(4))
    np.testing.assert_allclose(whole.numpy(), np.asarray(
        jnp.sum(jnp.asarray(x.numpy()), axis=(1, 2))), rtol=1e-5)
    sq = tsgd._tree_sumsq_w({"a": x, "b": x[:, 0]})
    assert sq.shape == (4,) and torch.equal(
        tsgd._tree_sumsq_w({"a": x[2:], "b": x[2:, 0]}), sq[2:])


# ---------------------------------------------------------------------------
# 6. Sharded leaves in one process: the adds the ranks make
# ---------------------------------------------------------------------------

# a toy tree with two leaves sharded 2 ways (w1 on dim 0, w2 on dim 1)
SH_CLASSES = {"b1": tflat.REPLICATED,
              "w1": tflat.ShardClass(("model",), ((0, 2),)),
              "w2": tflat.ShardClass(("model",), ((1, 2),))}
SH_MASK = {"b1": True, "w1": False, "w2": False}


def _sh_tree(seed):
    rng = np.random.default_rng(seed)
    return {"b1": torch.from_numpy(rng.normal(size=(W, 6)).astype(np.float32)),
            "w1": torch.from_numpy(rng.normal(size=(W, 8, 6)).astype(np.float32)),
            "w2": torch.from_numpy(rng.normal(size=(W, 6, 4)).astype(np.float32))}


def _shard_order_sums(tree, fn):
    """Per leaf (tree-flatten order) the per-worker sum of ``fn(x)``: a
    sharded leaf's two numpy-cut slices summed one worker at a time,
    partials added in shard order; a replicated leaf in one reduction a
    worker."""
    out = []
    for k in sorted(tree):
        v = fn(tree[k])
        dims = SH_CLASSES[k].dims
        if not dims:
            out.append(torch.stack([r.sum() for r in v.unbind(0)]))
            continue
        parts = [torch.from_numpy(np.ascontiguousarray(p))
                 for p in np.split(v.numpy(), dims[0][1], axis=1 + dims[0][0])]
        out.append(torch.stack([
            torch.stack([p[w].reshape(-1).sum() for w in range(W)])
            for p in parts]).T)
        out[-1] = out[-1][:, 0] + out[-1][:, 1]
    return out


def test_one_process_tree_sums_sharded_leaves_in_shard_order():
    """With sharding classes (a sized TP / FSDP layout's), the one-process
    tree path adds every sum over a sharded leaf as its slices' partials in
    shard order, the adds a shard group's ranks make: the clip norm, LARS's
    layer norms, the sign scales and telemetry's sums of squares, bit for
    bit against the same adds made here by hand; the kernel form runs the
    classes' sharded sub-buckets (``apply_sgd_buckets`` on the whole
    buckets' shard regions).  The results agree with the whole-leaf sums
    (no classes) within rounding: rtol 1e-6."""
    sh = tflat.LeafShards.of(SH_CLASSES)
    p, g, u = _sh_tree(1), _sh_tree(2), _sh_tree(3)
    # the clip norm
    gn2 = 0.0
    for t in _shard_order_sums(g, lambda x: x * x):
        gn2 = gn2 + t
    scale = torch.clamp(1.5 / torch.clamp(torch.sqrt(gn2), min=1e-12), max=1.0)
    got = tsgd_opt.clip_by_global_norm(g, 1.5, leading=1, shards=sh)
    for k in g:
        assert torch.equal(got[k], g[k] * scale.reshape(
            (W,) + (1,) * (g[k].dim() - 1))), k
    # telemetry and the sign scales
    want = _shard_order_sums(g, lambda x: x.float() * x.float())
    assert torch.equal(tsgd._tree_sumsq_w(g, sh), sum(want))
    tot = tcomp.leaf_abs_totals(tree_leaves(g), shards=sh)
    want = _shard_order_sums(g, lambda x: x.abs())
    for j, w in enumerate(want):
        acc = w[0]
        for i in range(1, W):                  # the workers in worker order
            acc = acc + w[i]
        assert torch.equal(tot[j], acc), j
    # LARS's layer norms: the step of a sharded leaf from hand-made norms
    kw = dict(lr=0.1, trust=0.02, momentum_coef=0.9, weight_decay=1e-2,
              nesterov=True, wd_mask=SH_MASK, leading=1)
    lp, lu = tlars.apply_lars(p, g, u, shards=sh, **kw)
    pw = _shard_order_sums(p, lambda x: x * x)
    gwd = {k: g[k] + 1e-2 * p[k] for k in g}
    gw = _shard_order_sums(gwd, lambda x: x * x)
    for j, k in enumerate(sorted(p)):
        if SH_MASK[k]:
            continue
        np_, nu = tlars._lars_leaf(p[k], g[k], u[k], False, lr=0.1, trust=0.02,
                                   momentum=0.9, wd=1e-2, nesterov=True,
                                   leading=1, norms=(torch.sqrt(pw[j]),
                                                     torch.sqrt(gw[j])))
        assert torch.equal(lp[k], np_) and torch.equal(lu[k], nu), k
    # both forms against the whole-leaf sums, and the kernel form on the
    # classes' sub-buckets
    skw = dict(lr=0.1, momentum_coef=0.9, weight_decay=1e-2, nesterov=True,
               wd_mask=SH_MASK, grad_clip=1.5, leading=1)
    plain = tsgd_opt.apply_sgd(p, g, u, shards=sh, **skw)
    kern = tsgd_opt.apply_sgd(p, g, u, shards=sh, use_kernel=True, **skw)
    ref = tsgd_opt.apply_sgd(p, g, u, **skw)
    lay = tflat.build_layout(p, wd_mask=SH_MASK, leading=1,
                             shard_classes=SH_CLASSES)
    assert sorted(lay.bucket_shards) == [1, 2]
    pb, gb, ub = (tflat.flatten(lay, t, leading=1) for t in (p, g, u))
    tsgd_opt.apply_sgd_buckets(lay, pb, gb, ub, lr=0.1, momentum_coef=0.9,
                               weight_decay=1e-2, nesterov=True,
                               grad_clip=1.5)
    byhand = tflat.unflatten(lay, pb, leading=1)
    for k in p:
        assert torch.equal(kern[0][k], byhand[k]), k
        for other in (plain, ref):
            np.testing.assert_allclose(kern[0][k].numpy(), other[0][k].numpy(),
                                       rtol=1e-6, atol=1e-7)


def test_leaf_count_counts_the_whole_leaf():
    """A rank that holds one of S slices of a leaf averages its sign scale
    over the WHOLE leaf (``_leaf_count(factor=S)``): else every sign of a
    sharded leaf would come out S times too large.  The slice's signs then
    equal the whole leaf's slice bit for bit."""
    from types import SimpleNamespace
    from repro_torch.sharding.layout import WorkerLayout
    x = _sh_tree(4)["w1"]                          # (W, 8, 6)
    half = x[:, 4:].clone()
    assert tcomp._leaf_count(half, None, factor=2) == x.numel()
    across = SimpleNamespace(layout=WorkerLayout(2 * W, 4, 2,
                                                 within_worker_size=2))
    assert tcomp._leaf_count(half, across, factor=2) == 8 * 6 * 2 * W
    total = tcomp.leaf_abs_totals([x])[0]
    whole = tcomp.sign_compress_leaf(x, total=total)
    assert torch.equal(tcomp.sign_compress_leaf(half, total=total, factor=2),
                       whole[:, 4:])
    assert not torch.equal(tcomp.sign_compress_leaf(half, total=total),
                           whole[:, 4:])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_tree_shards_of_replicated_leaves_keep_the_bits(use_kernel):
    """Classes that shard no leaf (a layout without sizes on the model
    axis) change nothing: the optimizers, the compressor and telemetry give
    the bits of the tree path without classes."""
    sh = tflat.LeafShards.of({k: tflat.REPLICATED for k in SH_CLASSES})
    p, g, u = _sh_tree(5), _sh_tree(6), _sh_tree(7)
    skw = dict(lr=0.1, momentum_coef=0.9, weight_decay=1e-2, nesterov=True,
               wd_mask=SH_MASK, grad_clip=1.5, leading=1,
               use_kernel=use_kernel)
    lkw = dict(lr=0.1, trust=0.02, momentum_coef=0.9, weight_decay=1e-2,
               nesterov=True, wd_mask=SH_MASK, leading=1,
               use_kernel=use_kernel)
    for a, b in ((tsgd_opt.apply_sgd(p, g, u, shards=sh, **skw),
                  tsgd_opt.apply_sgd(p, g, u, **skw)),
                 (tlars.apply_lars(p, g, u, shards=sh, **lkw),
                  tlars.apply_lars(p, g, u, **lkw)),
                 ((tcomp.sign_compress(g, use_kernel=use_kernel, shards=sh),),
                  (tcomp.sign_compress(g, use_kernel=use_kernel),))):
        for x, y in zip(a, b):
            for k in p:
                assert torch.equal(x[k], y[k]), k
    assert torch.equal(tsgd._tree_sumsq_w(g, sh), tsgd._tree_sumsq_w(g))
