"""Port parity: within-worker sharded sub-buckets (FSDP and TP classes) on
the flat bus, in one process (repro_torch vs repro, on the CPU).

* Layout and metadata (the reference's ``test_sharded_subbuckets.py``
  unit tests, ported): leaves bucketed per (dtype, sharding class), the
  shard-major rows equal to the reference's ``flatten`` byte for byte,
  the round trip, every per-row constant (tiled and local) equal, the
  segment totals global, the sharded wire-pack mean against dense signs,
  uneven shard factors refused, and the autograd leaf views writing each
  gradient into its shard-major rows (leaves sharded on dim 0 and dim 1).
* ``shard_classes`` and ``build_layout`` of every registry model at smoke
  size, and of paper-lm at full width through ``models.base.abstract``,
  under the tensor-parallel and the FSDP layout with sizes
  ``{data: 2, model: 2}``: equal to the reference's, slot for slot.
* One-process trajectories on the reference's ``CLS`` toy (W=4, H=2, 3
  rounds) against its meshless resident path: SGD + clip under the mean
  sync, sign and EF-sign with the wire pack, with and without
  ``sync_coalesce``, and LARS: every field within 1e-6 of its largest
  entry (EF memory 1e-5), elements moved by a sign flip counted.
* Repacks and carry-over: ``unpack_state`` -> ``pack_state`` bit for bit,
  ``save_flat`` / ``restore_flat`` bit for bit, a reference state carried
  into the port and back through the reference's ``restore_flat`` row for
  row, and the worker-axis resize of sub-bucket state leaf by leaf.
* ``build_train(layout=)`` on paper-lm smoke: the sub-buckets, the plan's
  coalesced stage priced on shard-local rows, and a local step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jcb
from repro.core import compression as jcomp
from repro.core import flatbuf as jflat
from repro.core import local_sgd as jsgd
from repro.models import base as jmbase
from repro.models import lm as jlm
from repro.sharding import layout as jlayout
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.core import compression as tcomp
from repro_torch.core import elastic as telastic
from repro_torch.core import flatbuf as tflat
from repro_torch.core import local_sgd as tsgd
from repro_torch.core import syncplan as tsp
from repro_torch.models import base as tmbase
from repro_torch.models import lm as tlm
from repro_torch.sharding import layout as tlayout
from repro_torch.utils import tree_leaves

torch.set_num_threads(2)

W, H, ROUNDS = 4, 2, 3
JCLS = {"w1": jflat.ShardClass(axes=("model",), dims=((1, 2),)),
        "b1": jflat.REPLICATED,
        "w2": jflat.ShardClass(axes=("model",), dims=((0, 2),))}
TCLS = {"w1": tflat.ShardClass(axes=("model",), dims=((1, 2),)),
        "b1": tflat.REPLICATED,
        "w2": tflat.ShardClass(axes=("model",), dims=((0, 2),))}
WD_MASK = {"w1": False, "b1": True, "w2": False}
SIZES = {"data": 2, "model": 2}
# elements a sign-compressed run may move by a flip: a delta within
# rounding of 0 takes the other sign against the reference's (measured 0)
FLIPS = 2


def _np_params(seed=1):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(6, 4)) * 0.4).astype(np.float32),
            "b1": np.zeros((4,), np.float32),
            "w2": (rng.normal(size=(4, 2)) * 0.4).astype(np.float32)}


def _np_batch(t):
    rng = np.random.default_rng(100 + t)
    x = rng.normal(size=(W, 4, 6)).astype(np.float32)
    y = np.tanh(x @ (np.ones((6, 4), np.float32) * 0.3)) @ (
        np.ones((4, 2), np.float32) * 0.3)
    return {"x": x, "y": y.astype(np.float32)}


def _jloss(params, batch):
    pred = jnp.tanh(batch["x"] @ params["w1"] + params["b1"]) @ params["w2"]
    l = jnp.mean((pred - batch["y"]) ** 2)
    return l, {"xent": l}


def _tloss(params, batch):
    pred = torch.tanh(batch["x"] @ params["w1"] + params["b1"]) @ params["w2"]
    l = torch.mean((pred - batch["y"]) ** 2)
    return l, {"xent": l}


def _cfg(cb, *, compression="none", wire_pack=False, coalesce=False,
         optimizer="sgd", clip=0.0):
    return cb.RunConfig(
        model=cb.ModelConfig(name="q", family="dense", citation=""),
        shape=cb.InputShape("t", 8, W * 4, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=H, sync_compression=compression,
                                    wire_pack=wire_pack, sync_coalesce=coalesce,
                                    local_momentum=0.9, nesterov=True),
        optim=cb.OptimConfig(optimizer=optimizer, base_lr=0.05,
                             base_batch=W * 4, weight_decay=1e-3,
                             grad_clip=clip, lars_trust=0.02,
                             lr_decay_steps=()))


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) <= rel * scale


def _beyond(got, want, rel):
    """Elements farther than ``rel`` x the largest entry."""
    scale = max(float(np.abs(want).max()), 1e-30)
    return int((np.abs(got - want) > rel * scale).sum())


# ---------------------------------------------------------------------------
# 1. Layout and metadata
# ---------------------------------------------------------------------------

def _layouts(wd=True):
    p = _np_params()
    jl = jflat.build_layout(jax.tree.map(jnp.asarray, p),
                            wd_mask=WD_MASK if wd else None,
                            shard_classes=JCLS)
    tl = tflat.build_layout(params_from_reference(p, "cpu"),
                            wd_mask=WD_MASK if wd else None,
                            shard_classes=TCLS)
    return p, jl, tl


def _same_layout(tl, jl):
    assert tl.bucket_dtypes == jl.bucket_dtypes
    assert tl.bucket_rows == jl.bucket_rows
    assert tl.bucket_classes == jl.bucket_classes
    assert tl.bucket_shards == jl.bucket_shards
    assert len(tl.slots) == len(jl.slots)
    for a, b in zip(tl.slots, jl.slots):
        for f in ("index", "bucket", "seg", "row_offset", "rows", "size",
                  "shape", "dtype", "skip_wd", "pack_axis", "shard_dims"):
            assert getattr(a, f) == getattr(b, f), (f, a, b)


def test_sharded_layout_buckets_by_class():
    _, jl, tl = _layouts()
    _same_layout(tl, jl)
    assert tl.num_buckets == 2
    assert {tl.bucket_class(b) for b in range(2)} == {(), ("model",)}
    sb = [b for b in range(2) if tl.bucket_class(b)][0]
    assert tl.bucket_shard_count(sb) == 2
    assert tl.bucket_rows[sb] == 2 * tl.bucket_local_rows(sb)
    assert len(tl.bucket_slots(sb)) == 2
    # without classes: one replicated bucket a dtype, as before
    p = params_from_reference(_np_params(), "cpu")
    plain = tflat.build_layout(p, wd_mask=WD_MASK)
    assert plain == tflat.build_layout(
        p, wd_mask=WD_MASK, shard_classes={k: tflat.REPLICATED for k in p})
    assert plain.bucket_shards == (1,) and plain.bucket_classes == ((),)


def test_sharded_flatten_byte_equal_and_roundtrip():
    p, jl, tl = _layouts()
    jb = jflat.flatten(jl, jax.tree.map(jnp.asarray, p))
    tp = params_from_reference(p, "cpu")
    tb = tflat.flatten(tl, tp)
    for a, b in zip(jb, tb, strict=True):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    out = tflat.unflatten(tl, tb)
    for k in p:
        assert torch.equal(out[k], tp[k]), k
    # each shard's region holds exactly its slice of every leaf
    sb = [b for b in range(2) if tl.bucket_class(b)][0]
    flat = tb[sb].numpy().reshape(2, -1)
    s1 = [s for s in tl.slots if s.shape == (6, 4)][0]
    s2 = [s for s in tl.slots if s.shape == (4, 2)][0]
    for s_ in range(2):
        np.testing.assert_array_equal(
            flat[s_, s1.row_offset * 128:s1.row_offset * 128 + 12],
            p["w1"][:, s_ * 2:(s_ + 1) * 2].reshape(-1))
        np.testing.assert_array_equal(
            flat[s_, s2.row_offset * 128:s2.row_offset * 128 + 4],
            p["w2"][s_ * 2:(s_ + 1) * 2].reshape(-1))
    # stacked (W, ...) trees too
    st = {k: np.stack([v + i for i in range(W)]) for k, v in p.items()}
    jb = jflat.flatten(jl, jax.tree.map(jnp.asarray, st), leading=1)
    tb = tflat.flatten(tl, params_from_reference(st, "cpu"), leading=1)
    for a, b in zip(jb, tb, strict=True):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("fn", ["wd_rows", "row_segments", "row_segments_local",
                                "segment_sizes", "segment_skip_wd",
                                "valid_mask", "lane_counts"])
def test_sharded_constants_equal_reference(fn):
    _, jl, tl = _layouts()
    for b in range(tl.num_buckets):
        got = getattr(tflat, fn)(tl, b)
        want = getattr(jflat, fn)(jl, b)
        assert got.dtype == want.dtype and np.array_equal(got, want), (fn, b)
    for fn_l, fn_t in (("wd_rows_local", "wd_rows"),
                       ("lane_counts_local", "lane_counts")):
        for b in range(tl.num_buckets):
            S = tl.bucket_shard_count(b)
            assert np.array_equal(np.tile(getattr(tflat, fn_l)(tl, b), (S, 1)),
                                  getattr(tflat, fn_t)(tl, b))


def test_tiled_metadata_yields_global_totals():
    """The L1 compressor on a sharded bucket gives mean|x| over the whole
    leaf (shard regions totalled in shard order): the reference's dense
    sign compressor, within 1e-6."""
    p, _, tl = _layouts()
    tp = params_from_reference(p, "cpu")
    bufs = tflat.flatten(tl, tp)
    out = tflat.unflatten(tl, [tcomp.sign_compress_bucket(tl, b, x)
                               for b, x in enumerate(bufs)])
    want = jcomp.sign_compress(jax.tree.map(jnp.asarray, p), use_kernel=False)
    for k in p:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    # and per worker, shared over W (leading=1)
    st = {k: torch.stack([v * (i + 1) for i in range(W)]) for k, v in tp.items()}
    sb = tflat.flatten(tl, st, leading=1)
    got = tflat.unflatten(tl, [tcomp.sign_compress_bucket(tl, b, x, leading=1)
                               for b, x in enumerate(sb)], leading=1)
    for k, v in st.items():
        want = torch.sign(v) * v.abs().mean()
        torch.testing.assert_close(got[k], want, rtol=1e-6, atol=1e-7)


def test_packed_mean_local_sharded_matches_reference():
    """The one-process wire pack over a sharded sub-bucket against the
    reference's ``_packed_mean_flat_local`` (padding masked): within 1e-6;
    the payload byte for byte."""
    p, jl, tl = _layouts()
    st = {k: np.stack([v + i - 1.5 for i in range(W)]) for k, v in p.items()}
    jb = jflat.flatten(jl, jax.tree.map(jnp.asarray, st), leading=1)
    tb = tflat.flatten(tl, params_from_reference(st, "cpu"), leading=1)
    for b in range(tl.num_buckets):
        want = np.asarray(jflat.mask_padding(
            jl, b, jsgd._packed_mean_flat_local(jb[b], jl, b)))
        got = tflat.mask_padding(tl, b, tsgd._packed_mean_flat_local(tb[b], tl, b))
        assert _close(got.numpy(), want, 1e-6), b
        pk, sc = tcomp.pack_bucket(tl, b, tb[b])
        jpk, jsc = jax.vmap(lambda x: jcomp.pack_bucket_signs(
            x, jnp.asarray(jflat.row_segments(jl, b)),
            jnp.asarray(jflat.segment_sizes(jl, b))))(jb[b])
        assert np.array_equal(pk.numpy(), np.asarray(jpk))
        np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=1e-6)
        # padding stays zero after the mask
        assert not got.numpy()[tflat.valid_mask(tl, b) == 0].any()


def test_uneven_shard_factor_refused():
    """A class whose factor does not divide its leaf dim cannot build (the
    reference asserts; the port raises ValueError)."""
    bad = {"w": tflat.ShardClass(axes=("model",), dims=((0, 4),))}
    with pytest.raises(ValueError, match="does not divide"):
        tflat.build_layout({"w": torch.zeros((6, 3))}, shard_classes=bad)
    with pytest.raises(AssertionError):
        jflat.build_layout({"w": jnp.zeros((6, 3))}, shard_classes={
            "w": jflat.ShardClass(axes=("model",), dims=((0, 4),))})


def test_leaf_views_write_shard_major_grads():
    """The autograd leaf views of a sharded bucket: values equal to the
    leaves, and the gradient of a loss lands in the shard-major rows that
    ``flatten`` of the plain gradient gives, padding zero."""
    p, _, tl = _layouts()
    tp = params_from_reference(p, "cpu")
    bufs = [b.clone().requires_grad_(True) for b in tflat.flatten(tl, tp)]
    grads = [torch.zeros_like(b) for b in bufs]
    views = tflat.unflatten_grad_into(tl, bufs, grads)
    coef = {k: torch.arange(v.numel(), dtype=torch.float32).reshape(v.shape) + 1
            for k, v in tp.items()}
    for k in tp:
        assert torch.equal(views[k], tp[k])
    loss = sum((views[k] * coef[k] * views[k]).sum() for k in tp)
    got = torch.autograd.grad(loss, bufs)
    want = tflat.flatten(tl, {k: 2 * coef[k] * tp[k] for k in tp})
    for g, o, w_ in zip(got, grads, want):
        assert g is o
        assert torch.equal(g, w_)


# ---------------------------------------------------------------------------
# 2. shard_classes of every registry model
# ---------------------------------------------------------------------------

def _mesh_layouts(lib, kind):
    if kind == "tp":
        lay = lib.train_layout(("data", "model"), worker_axes=("data",))
    else:
        lay = lib.fsdp_within_worker_layout(("data", "model"),
                                            worker_axes=("data",),
                                            shard_axes=("model",))
    if lib is tlayout:
        return lay.with_sizes(SIZES)
    import dataclasses
    return dataclasses.replace(lay, sizes=dict(SIZES))


def _class_layouts(arch, kind, full=False):
    get_j = jconfigs.get if full else jconfigs.get_smoke
    get_t = tconfigs.get if full else tconfigs.get_smoke
    jcfg, tcfg = get_j(arch), get_t(arch)
    jspecs, tspecs = jlm.param_specs(jcfg), tlm.param_specs(tcfg)
    jcls = jflat.shard_classes(jspecs, _mesh_layouts(jlayout, kind))
    tcls = tflat.shard_classes(tspecs, _mesh_layouts(tlayout, kind))
    jl = jflat.build_layout(jmbase.abstract(jspecs, jnp.dtype(jcfg.param_dtype)),
                            wd_mask=jmbase.norm_param_mask(jspecs),
                            shard_classes=jcls)
    tl = tflat.build_layout(tmbase.abstract(tspecs, getattr(torch, tcfg.param_dtype)),
                            wd_mask=tmbase.norm_param_mask(tspecs),
                            shard_classes=tcls)
    return jcls, tcls, jl, tl


@pytest.mark.parametrize("kind", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ("paper-lm",) + tuple(tconfigs.ARCHS))
def test_shard_classes_equal_reference(arch, kind):
    jcls, tcls, jl, tl = _class_layouts(arch, kind)
    jc = jax.tree.leaves(jcls, is_leaf=lambda x: isinstance(x, jflat.ShardClass))
    tc = tree_leaves(tcls, is_leaf=lambda x: isinstance(x, tflat.ShardClass))
    assert [(c.axes, c.dims) for c in tc] == [(c.axes, c.dims) for c in jc]
    _same_layout(tl, jl)


@pytest.mark.parametrize("kind", ["tp", "fsdp"])
def test_paper_lm_full_width_sub_buckets(kind):
    """paper-lm at full width, abstract (no allocation): two f32
    sub-buckets, a ("model",) class of 8 leaves in 933,888 rows (466,944 a
    shard) and a replicated class of 3 leaves in 152 rows: the 934,040
    rows of the one replicated bucket."""
    _, _, jl, tl = _class_layouts("paper-lm", kind, full=True)
    _same_layout(tl, jl)
    got = sorted((tl.bucket_class(b), len(tl.bucket_slots(b)), tl.bucket_rows[b],
                  tl.bucket_local_rows(b)) for b in range(tl.num_buckets))
    assert got == [((), 3, 152, 152), (("model",), 8, 933_888, 466_944)]
    assert set(tl.bucket_dtypes) == {"float32"}
    assert sum(tl.bucket_rows) == 934_040


# ---------------------------------------------------------------------------
# 3. One-process trajectories against the reference's meshless resident path
# ---------------------------------------------------------------------------

def _ref_run(run, rounds=ROUNDS):
    init, local_step, sync = jsgd.make_local_sgd(
        run, _jloss, num_workers=W, wd_mask=WD_MASK, use_kernel=True,
        bucket_sync=True, shard_classes=JCLS)
    state = init(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, _np_params()))
    losses = []
    for _ in range(rounds):
        for _ in range(H):
            b = jax.tree.map(jnp.asarray, _np_batch(int(state.step)))
            state, m = local_step(state, b)
            losses.append(float(m["loss"]))
        state = sync(state)
    return state, losses


def _port_run(run, rounds=ROUNDS, classes=TCLS):
    init, local_step, sync = tsgd.make_local_sgd(
        run, _tloss, num_workers=W, wd_mask=WD_MASK, shard_classes=classes)
    state = init(params_from_reference(_np_params(), "cpu"))
    losses = []
    for _ in range(rounds):
        for _ in range(H):
            state, m = local_step(state, _np_batch(state.step))
            losses.append(float(m["loss"]))
        state = sync(state)
    return state, losses


VARIANTS = {
    "sgd_clip_mean": dict(clip=0.5),
    "sign_wire": dict(compression="sign", wire_pack=True, clip=0.5),
    "sign_wire_coalesce": dict(compression="sign", wire_pack=True,
                               coalesce=True, clip=0.5),
    "ef_sign_wire": dict(compression="ef_sign", wire_pack=True, clip=0.5),
    "ef_sign_wire_coalesce": dict(compression="ef_sign", wire_pack=True,
                                  coalesce=True, clip=0.5),
    "ef_sign": dict(compression="ef_sign", clip=0.5),
    "lars": dict(optimizer="lars"),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_sharded_trajectory_matches_reference(name):
    kw = VARIANTS[name]
    js, jl = _ref_run(_cfg(jcb, **kw))
    ts, tl = _port_run(_cfg(tcb, **kw))
    lay = ts.params.layout
    assert sorted(lay.bucket_shards) == [1, 2]
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    flips = 0
    for field in ("params", "momentum", "anchor", "global_u", "ef_memory"):
        got, want = getattr(ts, field), getattr(js, field)
        assert (got is None) == (want is None), field
        if got is None:
            continue
        rel = 1e-5 if field == "ef_memory" else 1e-6
        for b, (g, w_) in enumerate(zip(got.buckets, want.buckets, strict=True)):
            g, w_ = g.float().numpy(), np.asarray(w_, np.float32)
            assert g.shape == w_.shape, (field, b)
            if kw.get("compression", "none") == "none":
                assert _close(g, w_, rel), (field, b, np.abs(g - w_).max())
            else:
                flips += _beyond(g, w_, rel)
    print(f"{name}: elements beyond tolerance {flips}")
    assert flips <= FLIPS, flips


def test_coalesced_plan_merges_sub_buckets():
    """With ``sync_coalesce`` the two f32 sub-buckets share one wire-packed
    collective stage, priced on shard-local rows, as the reference's plan."""
    from repro.core import syncplan as jsp
    _, jl, tl = _layouts()
    for coalesce in (False, True):
        kw = dict(num_workers=W, compression="ef_sign", anchored=True,
                  wire_pack=True, coalesce=coalesce)
        tplan = tsp.make_sync_plan(tl, **kw)
        jplan = jsp.make_sync_plan(jl, **kw)
        tst = [(s.kind, s.scope, s.buckets, s.compression, s.group,
                s.wire_bytes, s.collectives, s.coalesced) for s in tplan.stages]
        jst = [(s.kind, s.scope, s.buckets, s.compression, s.group,
                s.wire_bytes, s.collectives, s.coalesced) for s in jplan.stages]
        assert tst == jst
        coll = tplan.collective_stages("global")
        assert len(coll) == (1 if coalesce else 2)
        assert coll[0].coalesced == coalesce
    rows = sum(tl.bucket_local_rows(b) for b in range(2))
    assert rows < sum(tl.bucket_rows)


# ---------------------------------------------------------------------------
# 4. Repacks and carry-over
# ---------------------------------------------------------------------------

def test_sharded_unpack_pack_roundtrip_bit_exact():
    ts, _ = _port_run(_cfg(tcb, compression="ef_sign", wire_pack=True, clip=0.5))
    back = tsgd.pack_state(tsgd.unpack_state(ts), wd_mask=WD_MASK,
                           shard_classes=TCLS)
    assert back.params.layout == ts.params.layout
    for f in ("params", "momentum", "anchor", "ef_memory"):
        for a, b in zip(getattr(back, f).buckets, getattr(ts, f).buckets):
            assert a.dtype == b.dtype and torch.equal(a, b), f


def test_sharded_resident_checkpoint_roundtrip(tmp_path):
    from repro_torch.checkpoint import checkpoint as tckpt
    ts, _ = _port_run(_cfg(tcb, compression="sign", wire_pack=True, clip=0.5))
    path = str(tmp_path / "flat")
    tckpt.save_flat(path, ts, step=ROUNDS * H)
    out = tckpt.restore_flat(path, ts)
    assert out.params.layout == ts.params.layout
    for f in ("params", "momentum", "anchor"):
        for a, b in zip(getattr(out, f).buckets, getattr(ts, f).buckets):
            assert torch.equal(a, b), f


def test_convert_sharded_state_both_ways(tmp_path):
    """A reference state with sharded sub-buckets carried into the port row
    for row (``state_from_reference``), and the port's ``save_flat`` of it
    restored by the reference into its own state bit for bit."""
    from repro.checkpoint import checkpoint as jckpt
    from repro_torch.checkpoint import checkpoint as tckpt
    js, _ = _ref_run(_cfg(jcb, compression="ef_sign", wire_pack=True, clip=0.5))
    tl = tflat.build_layout(params_from_reference(_np_params(), "cpu"),
                            wd_mask=WD_MASK, shard_classes=TCLS)
    npst = jax.tree.map(np.asarray, js)
    ts = state_from_reference(npst, layout=tl, device="cpu")
    for f in ("params", "momentum", "anchor", "ef_memory"):
        for a, b in zip(getattr(ts, f).buckets, getattr(js, f).buckets):
            assert np.asarray(b, np.float32).tobytes() == a.float().numpy().tobytes()
    path = str(tmp_path / "flat")
    tckpt.save_flat(path, ts, step=ROUNDS * H)
    tmpl = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), js)
    back = jckpt.restore_flat(path, tmpl)
    for f in ("params", "momentum", "anchor", "ef_memory"):
        for a, b in zip(getattr(back, f).buckets, getattr(js, f).buckets):
            assert np.array_equal(np.asarray(a), np.asarray(b)), f


def test_resize_fsdp_subbuckets():
    """The worker-axis fold on sub-bucket buffers (the reference's
    ``test_resize_fsdp_subbuckets``): W 4 -> 2 -> 4 agrees leaf by leaf with
    the same fold of the tree view, and the layout carries over."""
    ts, _ = _port_run(_cfg(tcb, compression="ef_sign", wire_pack=True, clip=0.5))
    small = telastic.resize_state(ts, 2)
    assert small.params.layout == ts.params.layout
    assert small.params.buckets[0].shape[0] == 2
    view, sview = tsgd.unpack_state(ts), tsgd.unpack_state(small)
    for f in ("params", "momentum", "ef_memory"):
        for k, v in getattr(view, f).items():
            want = v.reshape((2, 2) + v.shape[1:]).mean(dim=1)
            torch.testing.assert_close(getattr(sview, f)[k], want,
                                       rtol=1e-6, atol=1e-7)
    big = telastic.resize_state(small, 4)
    bview = tsgd.unpack_state(big)
    for k, v in sview.params.items():
        assert torch.equal(bview.params[k], v.repeat_interleave(2, dim=0))
    # and the reference's fold of the same state agrees bit for bit
    from repro.core import elastic as jelastic
    js, _ = _ref_run(_cfg(jcb, compression="ef_sign", wire_pack=True, clip=0.5))
    jsmall = jelastic.resize_state(js, 2)
    tsm = telastic.resize_state(
        state_from_reference(jax.tree.map(np.asarray, js),
                             layout=ts.params.layout, device="cpu"), 2)
    for a, b in zip(tsm.params.buckets, jsmall.params.buckets):
        assert _close(a.numpy(), np.asarray(b), 1e-7)


# ---------------------------------------------------------------------------
# 5. build_train(layout=) on paper-lm smoke, one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["tp", "fsdp"])
def test_build_train_with_layout(kind):
    from repro_torch.launch.steps import build_train
    run = tcb.RunConfig(
        model=tconfigs.get_smoke("paper-lm"),
        shape=tcb.InputShape("t", 16, 2 * 2, "train"),
        local_sgd=tcb.LocalSGDConfig(local_steps=1, sync_compression="ef_sign",
                                     wire_pack=True, sync_coalesce=True),
        optim=tcb.OptimConfig(base_lr=0.1, base_batch=4, grad_clip=1.0))
    lay = _mesh_layouts(tlayout, kind)
    b = build_train(run, num_workers=2, device="cpu", layout=lay)
    plain = build_train(run, num_workers=2, device="cpu")
    assert b.mesh_layout is lay and plain.mesh_layout is None
    assert sorted(b.layout.bucket_shards) == [1, 2]
    assert plain.layout.bucket_shards == (1,)
    assert sum(b.layout.bucket_rows) == sum(plain.layout.bucket_rows)
    coll = b.sync_plan.collective_stages("global")
    assert len(coll) == 1 and coll[0].coalesced and coll[0].buckets == (0, 1)
    # priced on shard-local rows: less than the whole buckets' payload
    local = sum(b.layout.bucket_local_rows(x) for x in range(2))
    assert local < sum(b.layout.bucket_rows)
    gen = torch.Generator().manual_seed(0)
    p0 = tmbase.materialize(b.specs, gen, "cpu")
    st = b.init(p0)
    batch = {"tokens": np.random.default_rng(0).integers(0, 512, (2, 2, 16)),
             "labels": np.random.default_rng(1).integers(0, 512, (2, 2, 16))}
    st, m = b.local_step(st, batch)
    st = b.sync(st, plan=b.sync_plan)
    assert np.isfinite(float(m["loss"]))
    # the same step on the replicated layout: the same model to 1e-6
    sp = plain.init(p0)
    sp, mp = plain.local_step(sp, batch)
    sp = plain.sync(sp, plan=plain.sync_plan)
    np.testing.assert_allclose(float(m["loss"]), float(mp["loss"]), rtol=1e-6)
    got = tsgd.mean_params(st)
    want = tsgd.mean_params(sp)
    for a, w_ in zip(tree_leaves(got), tree_leaves(want)):
        assert _close(a.numpy(), w_.numpy(), 1e-5)


def test_fit_takes_the_layout():
    """``fit(layout=)`` builds its bundle on the layout's sub-buckets: the
    same losses as a bundle built with ``build_train(layout=)``."""
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import build_train
    run = tcb.RunConfig(
        model=tconfigs.get_smoke("paper-lm"),
        shape=tcb.InputShape("t", 16, 2 * 2, "train"),
        local_sgd=tcb.LocalSGDConfig(local_steps=2),
        optim=tcb.OptimConfig(base_lr=0.1, base_batch=4, grad_clip=1.0))
    lay = _mesh_layouts(tlayout, "fsdp")
    data = lm_examples(markov_lm(vocab=512, num_seqs=16, seq_len=16))
    got = ttrain.fit(run, ShardedBatches(data, 2, 2), num_steps=2,
                     device="cpu", layout=lay, log=lambda *a: None)
    want = ttrain.fit(run, ShardedBatches(data, 2, 2), num_steps=2,
                      bundle=build_train(run, num_workers=2, device="cpu",
                                         layout=lay), log=lambda *a: None)
    assert sorted(got[0].params.layout.bucket_shards) == [1, 2]
    assert [h["loss"] for h in got[1]] == [h["loss"] for h in want[1]]

