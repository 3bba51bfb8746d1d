"""Port parity: checkpoints (``repro_torch.checkpoint.checkpoint``).

The reference's ``tests/test_checkpoint.py`` cases on the port (per-leaf
and flat round trips, the elastic worker-axis restore, a non-elastic
mismatch that still raises), ``publish_flat`` / ``latest_flat``, and the
cross-package files: a JAX ``save_flat`` / ``save`` of a resident
paper-lm smoke state restores into the port and the reverse, every
bucket, the statistics and the step equal row for row (exact: the bytes
move as they are).  A port -> port resume equals the uninterrupted run
bit for bit, with gradient noise off and on (the generator's stream
resumes exactly).
"""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.configs import base as jcb
from repro.launch.steps import build_train as jbuild
from repro.models import base as jmbase
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import (load_meta, restore, restore_flat,
                                               save, save_flat)
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference
from repro_torch.core import flatbuf
from repro_torch.core.elastic import resize_axis
from repro_torch.core.schedule import sync_boundaries
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.launch.steps import build_train as tbuild
from repro_torch.models import base as mbase
from repro_torch.models.base import ShapeDtype
from repro_torch.utils import tree_leaves, tree_map

torch.set_num_threads(2)


def _sds(tree):
    return tree_map(lambda x: ShapeDtype(tuple(x.shape), x.dtype), tree)


def test_roundtrip_params(tmp_path):
    tree = {"a": {"w": torch.arange(6.0).reshape(2, 3)},
            "b": (torch.ones(4), torch.zeros((2, 2), dtype=torch.int32),
                  torch.arange(5.0).to(torch.bfloat16))}
    path = str(tmp_path / "ckpt")
    save(path, tree, step=7, extra={"note": "x"})
    out = restore(path, _sds(tree))
    for a, b in zip(tree_leaves(tree), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    meta = load_meta(path)
    assert meta["step"] == 7 and meta["note"] == "x"
    names = set(np.load(path + ".npz").files)
    assert names == {"['a']/['w']", "['b']/[0]", "['b']/[1]", "['b']/[2]"}
    # a template whose dicts are not in sorted-key order (as the model's
    # layer dicts are built) restores each leaf under its own key
    unsorted = {"z": torch.zeros(3), "a": torch.ones(2, dtype=torch.int32)}
    for fs, fr in ((save, restore), (save_flat, restore_flat)):
        fs(path + "u", {"z": torch.arange(3.0), "a": torch.tensor([4, 5],
                                                                 dtype=torch.int32)})
        got = fr(path + "u", unsorted)
        assert torch.equal(got["z"], torch.arange(3.0))
        assert torch.equal(got["a"], torch.tensor([4, 5], dtype=torch.int32))


def _smoke_run(cb, cfg, mode="ef_sign", noise_eta=0.0, telemetry=True):
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", 16, 4, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=2, sync_compression=mode),
        optim=cb.OptimConfig(base_lr=0.3, base_batch=4, lr_warmup_steps=1,
                             grad_clip=1.0, noise_eta=noise_eta),
        controller=cb.ControllerConfig(telemetry=telemetry), steps=8)


def _data(vocab=512):
    return lm_examples(markov_lm(vocab=vocab, num_seqs=32, seq_len=16))


def _steps(bundle, state, it, t0, t1):
    """Local steps t0..t1-1 with the run's syncs (no controller)."""
    syncs = dict(sync_boundaries(bundle.run.local_sgd, t1))
    losses = []
    for t in range(t0, t1):
        state, m = bundle.local_step(state, next(it))
        losses.append(float(m["loss"]))
        if syncs.get(t) == 2:
            state = bundle.sync(state, plan=bundle.sync_plan, scope="global")
    return state, losses


def _fields(state):
    return {f: getattr(state, f) for f in ("params", "momentum", "anchor",
                                           "global_u", "ef_memory")}


def test_roundtrip_local_sgd_state(tmp_path):
    cfg = tconfigs.get_smoke("paper-lm")
    run = _smoke_run(tcb, cfg)
    b = tbuild(run, num_workers=2, device="cpu")
    p0 = mbase.materialize(b.specs, torch.Generator().manual_seed(0), "cpu")
    state, _ = _steps(b, b.init(p0, seed=3), iter(ShardedBatches(_data(), 2, 2)), 0, 3)
    for fn_save, fn_restore in ((save, restore), (save_flat, restore_flat)):
        path = str(tmp_path / fn_save.__name__)
        fn_save(path, state, step=state.step)
        out = fn_restore(path, b.init(tree_map(torch.zeros_like, p0), seed=9))
        assert out.step == 3 and isinstance(out.step, int)
        for k, v in _fields(state).items():
            if v is None:
                assert getattr(out, k) is None
                continue
            assert flatbuf.is_bucket_state(getattr(out, k))
            for x, y in zip(v.buckets, getattr(out, k).buckets):
                assert torch.equal(x, y)
        for f in ("acc_grad_sq", "acc_steps", "round_update_sq", "rounds"):
            assert torch.equal(getattr(out.stats, f), getattr(state.stats, f))
        assert torch.equal(out.rng.get_state(), state.rng.get_state())
    assert load_meta(str(tmp_path / "save_flat"))["resident"] is True


# ---------------------------------------------------------------------------
# elastic worker-axis restore
# ---------------------------------------------------------------------------

def _stacked_state(w, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = lambda s: torch.randn(s, generator=g)
    return {"params": {"w": mk((w, 6, 3)), "b": mk((w, 3))},
            "momentum": {"w": mk((w, 6, 3)), "b": mk((w, 3))},
            "anchor": {"w": mk((6, 3)), "b": mk((3,))},
            "step": torch.tensor(5, dtype=torch.int32)}


@pytest.mark.parametrize("new_w", [2, 8])
def test_elastic_restore_flat_rebuckets_worker_axis(tmp_path, new_w):
    state4 = _stacked_state(4)
    path = str(tmp_path / "w4")
    save_flat(path, state4, step=5)
    out = restore_flat(path, _sds(_stacked_state(new_w, seed=1)))
    for name in ("params", "momentum"):
        for k, saved in state4[name].items():
            got = out[name][k]
            if new_w < 4:
                assert torch.equal(got, saved[:new_w])
            else:
                assert torch.equal(got, saved.repeat_interleave(new_w // 4, 0))
    for k, v in state4["anchor"].items():
        assert torch.equal(out["anchor"][k], v)
    assert int(out["step"]) == 5


def test_elastic_restore_flat_resident(tmp_path):
    g = torch.Generator().manual_seed(2)
    params4 = {"w": torch.randn((4, 6, 3), generator=g),
               "b": torch.randn((4, 3), generator=g)}
    st4 = flatbuf.BucketState.pack(params4, leading=1)
    path = str(tmp_path / "res4")
    save_flat(path, {"params": st4}, step=9)
    tmpl = {"params": flatbuf.BucketState.pack(
        tree_map(lambda x: torch.zeros_like(x[:2]), params4), leading=1)}
    out = restore_flat(path, tmpl)
    assert flatbuf.is_bucket_state(out["params"])
    for a, b in zip(tree_leaves(out["params"].unpack()),
                    tree_leaves(tree_map(lambda x: x[:2], params4))):
        assert torch.equal(a, b)


def test_restore_flat_non_elastic_mismatch_still_raises(tmp_path):
    state4 = _stacked_state(4)
    path = str(tmp_path / "w4bad")
    save_flat(path, state4, step=5)
    bad = _stacked_state(4, seed=1)
    bad["params"]["w"] = torch.zeros((4, 7, 3))
    with pytest.raises(ValueError, match="layout mismatch"):
        restore_flat(path, _sds(bad))
    mixed = _stacked_state(4, seed=1)
    mixed["params"]["w"] = torch.zeros((2, 6, 3))
    mixed["momentum"]["w"] = torch.zeros((8, 6, 3))
    with pytest.raises(ValueError, match="layout mismatch"):
        restore_flat(path, _sds(mixed))
    with pytest.raises(ValueError, match="layout mismatch"):
        restore_flat(path, _sds(_stacked_state(3, seed=1)))


@pytest.mark.parametrize("w,new_w", [(4, 2), (4, 1), (2, 6), (3, 3)])
def test_resize_axis_matches_reference_slice_fold(w, new_w):
    from repro.core.elastic import resize_axis as jresize
    x = np.random.default_rng(w).standard_normal((w, 5, 4)).astype(np.float32)
    got = resize_axis(torch.from_numpy(x), new_w, fold="slice").numpy()
    np.testing.assert_array_equal(got, np.asarray(jresize(jnp.asarray(x), new_w,
                                                          fold="slice")))
    with pytest.raises(ValueError, match="not divisible"):
        resize_axis(torch.from_numpy(x), 5)


def test_publish_flat_latest_helpers(tmp_path):
    tree = {"a": torch.arange(8, dtype=torch.float32)}
    assert ckpt.latest_flat(str(tmp_path)) is None
    v0, p0 = ckpt.publish_flat(str(tmp_path), tree, step=1)
    v1, p1 = ckpt.publish_flat(str(tmp_path), tree, step=2)
    assert (v0, v1) == (0, 1) and p0 != p1
    ver, path = ckpt.latest_flat(str(tmp_path))
    assert ver == 1 and path == p1
    assert torch.equal(ckpt.restore_flat(path, tree)["a"], tree["a"])
    m = json.loads((tmp_path / "manifest.json").read_text())
    assert m["versions"]["1"] == {"path": "weights_v1.npz", "step": 2}
    assert not (tmp_path / "manifest.json.tmp").exists()
    # the reference reads the port's channel
    assert jckpt.latest_flat(str(tmp_path)) == (1, p1)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _jax_state(mode, telemetry, steps=3):
    """A resident reference state after ``steps`` steps of paper-lm smoke."""
    run = _smoke_run(jcb, jconfigs.get_smoke("paper-lm"), mode,
                     telemetry=telemetry)
    jb = jbuild(run, num_workers=2, use_kernel=True)
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    st = jb.init(jax.random.PRNGKey(7), p0)
    from repro.data.partition import ShardedBatches as JBatches
    it = iter(JBatches(_data(), 2, 2))
    ls = jax.jit(jb.local_step)
    for _ in range(steps):
        st, _ = ls(st, next(it))
    st = jax.jit(jb.sync)(st)
    return st, p0


def _port_template(mode, telemetry, p0):
    run = _smoke_run(tcb, tconfigs.get_smoke("paper-lm"), mode,
                     telemetry=telemetry)
    tb = tbuild(run, num_workers=2, device="cpu")
    params = params_from_reference(jax.tree.map(np.asarray, p0), "cpu")
    return tb.init(tree_map(torch.zeros_like, params), seed=11)


def _assert_same_state(jst, tst):
    for f in ("params", "momentum", "anchor", "global_u", "ef_memory"):
        jv, tv = getattr(jst, f), getattr(tst, f)
        assert (jv is None) == (tv is None), f
        if jv is None:
            continue
        for a, b in zip(jv.buckets, tv.buckets):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(np.asarray(jst.step)) == int(tst.step)
    if jst.stats is not None:
        for k in ("acc_grad_sq", "acc_steps", "round_update_sq", "pre_sync_sq",
                  "comp_err_sq", "rounds"):
            np.testing.assert_array_equal(np.asarray(getattr(jst.stats, k)),
                                          getattr(tst.stats, k).numpy())


@pytest.mark.parametrize("fmt", ["flat", "leaf"])
@pytest.mark.parametrize("mode,telemetry", [("ef_sign", True), ("none", False)])
def test_jax_checkpoint_restores_into_port(tmp_path, fmt, mode, telemetry):
    jst, p0 = _jax_state(mode, telemetry)
    path = str(tmp_path / "j")
    (jckpt.save_flat if fmt == "flat" else jckpt.save)(
        path, jst, step=int(jst.step))
    tmpl = _port_template(mode, telemetry, p0)
    with pytest.warns(UserWarning, match="JAX key"):
        got = (restore_flat if fmt == "flat" else restore)(path, tmpl)
    _assert_same_state(jst, got)
    # the generator is seeded from the key's two words, as documented
    hi, lo = (int(x) for x in np.asarray(jst.rng))
    assert got.rng.initial_seed() == (hi << 32) | lo


@pytest.mark.parametrize("fmt", ["flat", "leaf"])
@pytest.mark.parametrize("mode,telemetry", [("ef_sign", True), ("none", False)])
def test_port_checkpoint_restores_into_jax(tmp_path, fmt, mode, telemetry):
    jst, p0 = _jax_state(mode, telemetry)
    path = str(tmp_path / "j")
    jckpt.save_flat(path, jst, step=int(jst.step))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        tst = restore_flat(path, _port_template(mode, telemetry, p0))
    tpath = str(tmp_path / "t")
    (save_flat if fmt == "flat" else save)(tpath, tst, step=tst.step)
    tmpl = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jst)
    back = (jckpt.restore_flat if fmt == "flat" else jckpt.restore)(tpath, tmpl)
    _assert_same_state(back, tst)
    np.testing.assert_array_equal(np.asarray(back.rng), np.asarray(jst.rng))
    if fmt == "flat":
        jm, tm = jckpt.load_meta(path), load_meta(tpath)
        for k in ("bucket_dtypes", "bucket_rows", "leaf_shapes", "leaf_dtypes",
                  "num_leaves", "resident", "format"):
            assert tm[k] == jm[k], k


def test_member_names_equal_reference(tmp_path):
    """Per-leaf snapshots of the same state carry the reference's member
    names (plus the generator's state), and a param tree's too."""
    jst, p0 = _jax_state("ef_sign", True, steps=1)
    jckpt.save(str(tmp_path / "j"), jst)
    tst = _port_template("ef_sign", True, p0)
    save(str(tmp_path / "t"), tst)
    jn = set(np.load(str(tmp_path / "j.npz")).files)
    tn = set(np.load(str(tmp_path / "t.npz")).files)
    assert tn == jn | {".rng#generator"}
    jckpt.save(str(tmp_path / "jp"), p0)
    save(str(tmp_path / "tp"), params_from_reference(
        jax.tree.map(np.asarray, p0), "cpu"))
    assert set(np.load(str(tmp_path / "tp.npz")).files) == \
        set(np.load(str(tmp_path / "jp.npz")).files)


@pytest.mark.parametrize("noise_eta", [0.0, 0.01])
@pytest.mark.parametrize("fmt", ["flat", "leaf"])
def test_port_resume_equals_uninterrupted_run(tmp_path, noise_eta, fmt):
    """4 steps, checkpoint, restore into a fresh state, 4 more: losses and
    final buckets equal the 8-step run's bit for bit (the noise stream
    resumes from the saved generator)."""
    cfg = tconfigs.get_smoke("paper-lm")
    run = _smoke_run(tcb, cfg, noise_eta=noise_eta)
    b = tbuild(run, num_workers=2, device="cpu")
    p0 = mbase.materialize(b.specs, torch.Generator().manual_seed(0), "cpu")
    data = _data()
    full, l_full = _steps(b, b.init(tree_map(torch.clone, p0), seed=5),
                          iter(ShardedBatches(data, 2, 2)), 0, 8)
    it = iter(ShardedBatches(data, 2, 2))
    half, l1 = _steps(b, b.init(tree_map(torch.clone, p0), seed=5), it, 0, 4)
    path = str(tmp_path / "mid")
    (save_flat if fmt == "flat" else save)(path, half, step=half.step)
    fresh = b.init(tree_map(torch.zeros_like, p0), seed=123)
    back = (restore_flat if fmt == "flat" else restore)(path, fresh)
    rest, l2 = _steps(b, back, it, 4, 8)
    assert l1 + l2 == l_full
    for k, v in _fields(full).items():
        if v is not None:
            for x, y in zip(v.buckets, getattr(rest, k).buckets):
                assert torch.equal(x, y)
    assert rest.step == full.step == 8
