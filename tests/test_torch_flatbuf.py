"""Port parity: flat bus, param specs, data, schedules (repro_torch vs repro).

Same inputs (numpy, fixed seeds) go through the JAX package and the
PyTorch port.  Layout, flatten, data and schedule results must agree
EXACTLY: they are integer bookkeeping or copies, with no float
arithmetic that could round differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import LocalSGDConfig as JLocalSGDConfig
from repro.configs.base import OptimConfig as JOptimConfig
from repro.core import flatbuf as jfb
from repro.core import schedule as jsched
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.models import base as jmbase
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.configs.base import LocalSGDConfig, OptimConfig
from repro_torch.convert import params_from_reference
from repro_torch.core import flatbuf as tfb
from repro_torch.core import schedule as tsched
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.models import base as tmbase
from repro_torch.models import lm as tlm
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten

torch.set_num_threads(2)

SLOT_FIELDS = ("index", "bucket", "seg", "row_offset", "rows", "size",
               "shape", "dtype", "skip_wd")


def _layouts(name, smoke):
    jcfg = jconfigs.get_smoke(name) if smoke else jconfigs.get(name)
    tcfg = tconfigs.get_smoke(name) if smoke else tconfigs.get(name)
    jspecs, tspecs = jlm.param_specs(jcfg), tlm.param_specs(tcfg)
    jl = jfb.build_layout(jmbase.abstract(jspecs, jnp.float32),
                          wd_mask=jmbase.norm_param_mask(jspecs))
    tl = tfb.build_layout(tmbase.abstract(tspecs, torch.float32),
                          wd_mask=tmbase.norm_param_mask(tspecs))
    return jl, tl, jspecs, tspecs


def _slots(layout):
    return [tuple(getattr(s, f) for f in SLOT_FIELDS) for s in layout.slots]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_slot_table_matches_reference(smoke):
    """Exact: every leaf lands on the same rows of the same bucket."""
    jl, tl, jspecs, tspecs = _layouts("paper-lm", smoke)
    assert _slots(tl) == _slots(jl)
    assert tl.bucket_rows == jl.bucket_rows
    assert tl.bucket_dtypes == jl.bucket_dtypes
    assert tmbase.count_params(tspecs) == jmbase.count_params(jspecs)
    if smoke:
        assert tl.bucket_rows == (3096,)
    else:
        # one f32 bucket of 934,040 rows (478.2 MB a copy), 119,556,864 params
        assert tl.bucket_rows == (934_040,)
        assert tl.total_bytes() == 934_040 * 128 * 4
        assert tmbase.count_params(tspecs) == 119_556_864


def test_param_specs_match_reference():
    jspecs = jlm.param_specs(jconfigs.get("paper-lm"))
    tspecs = tlm.param_specs(tconfigs.get("paper-lm"))
    jl, jdef = jax.tree.flatten(jspecs, is_leaf=jmbase.is_spec)
    tl, _ = tree_flatten(tspecs, is_leaf=tmbase.is_spec)
    assert [(s.shape, s.axes, s.init, s.scale) for s in jl] == \
        [(s.shape, s.axes, s.init, s.scale) for s in tl]
    # the same nesting (dict keys, the one-group `layers` tuple, empty `rem`)
    tzero = tree_map(lambda s: 0, tspecs, is_leaf=tmbase.is_spec)
    assert jax.tree.structure(tzero) == jdef


def test_stacked_norms_take_weight_decay_like_the_reference():
    """Reference quirk kept on purpose: rank is tested on the STORED shape,
    so the stacked (12, 768) ln1/ln2 take decay; only final_norm skips."""
    tspecs = tlm.param_specs(tconfigs.get("paper-lm"))
    mask = tmbase.norm_param_mask(tspecs)
    assert mask["final_norm"] is True
    assert mask["layers"][0]["ln1"] is False and mask["layers"][0]["ln2"] is False
    jspecs = jlm.param_specs(jconfigs.get("paper-lm"))
    assert jax.tree.leaves(jmbase.norm_param_mask(jspecs)) == \
        tree_flatten(mask)[0]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_segment_skip_wd_matches_reference(smoke):
    """The per-leaf skip bits that pick LARS's plain-LR leaves: under the
    stacked-norm quirk above only final_norm takes the plain LR, and the
    stacked ln1/ln2 get trust ratios like the matrices."""
    jl, tl, _, tspecs = _layouts("paper-lm", smoke)
    skip = tfb.segment_skip_wd(tl, 0)
    assert skip.dtype == bool and skip.shape == (tl.num_leaves,)
    assert np.array_equal(skip, jfb.segment_skip_wd(jl, 0))
    assert skip.sum() == 1
    leaves, _ = tree_flatten(tmbase.norm_param_mask(tspecs))
    assert skip.tolist() == leaves
    assert torch.equal(tfb.const("segment_skip_wd", tl, 0, "cpu"),
                       torch.from_numpy(skip))


def test_tree_flatten_order_matches_jax():
    tree = {"b": (np.zeros(2), [np.ones(1), {"z": np.zeros(3), "a": np.ones(4)}]),
            "a": np.zeros(5), "c": (), "d": None}
    jl, _ = jax.tree.flatten(tree)
    tl, tdef = tree_flatten(tree)
    assert [x.shape for x in tl] == [x.shape for x in jl]
    back = tree_unflatten(tdef, tl)
    assert back["c"] == () and back["d"] is None
    assert isinstance(back["b"][1], list)


def _smoke_params(seed=0):
    specs = jlm.param_specs(jconfigs.get_smoke("paper-lm"))
    p = jmbase.materialize(specs, jax.random.PRNGKey(seed))
    return specs, p, params_from_reference(jax.tree.map(np.asarray, p), "cpu")


@pytest.mark.parametrize("leading", [0, 1])
def test_flatten_bit_exact_and_unflatten_views(leading):
    """Flattened smoke buckets equal the reference's bit for bit; the
    port's unflatten returns views into the bucket."""
    specs, jp, tp = _smoke_params()
    if leading:
        jp = jax.tree.map(lambda a: jnp.stack([a, 2 * a, -a]), jp)
        tp = tree_map(lambda a: torch.stack([a, 2 * a, -a]), tp)
    jl = jfb.build_layout(jp, wd_mask=jmbase.norm_param_mask(specs), leading=leading)
    tl = tfb.build_layout(tp, wd_mask=tmbase.norm_param_mask(
        tlm.param_specs(tconfigs.get_smoke("paper-lm"))), leading=leading)
    assert _slots(tl) == _slots(jl)
    jb = jfb.flatten(jl, jp, leading=leading)
    tb = tfb.flatten(tl, tp, leading=leading)
    for a, b in zip(jb, tb, strict=True):
        assert np.array_equal(np.asarray(a), b.numpy())
    back = tfb.unflatten(tl, tb, leading=leading)
    for a, b in zip(tree_flatten(tp)[0], tree_flatten(back)[0], strict=True):
        assert torch.equal(a, b)
        assert b.untyped_storage().data_ptr() == tb[0].untyped_storage().data_ptr()


def _odd_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"emb": rng.normal(size=(33, 7)).astype(np.float32),
            "w130": rng.normal(size=(130,)).astype(np.float32),
            "norm": rng.normal(size=(5,)).astype(np.float32),
            "scalar": np.float32(rng.normal()),
            "h": rng.normal(size=(16, 9)).astype(np.float16)}


def test_per_bucket_constants_match_reference():
    tree = _odd_tree()
    wd = {"emb": False, "w130": False, "norm": True, "scalar": True, "h": False}
    jl = jfb.build_layout(jax.tree.map(jnp.asarray, tree), wd_mask=wd)
    tl = tfb.build_layout(params_from_reference(tree, "cpu"), wd_mask=wd)
    assert _slots(tl) == _slots(jl) and tl.num_buckets == 2
    for b in range(tl.num_buckets):
        for fn in ("wd_rows", "row_segments", "segment_sizes", "valid_mask",
                   "lane_counts"):
            assert np.array_equal(getattr(tfb, fn)(tl, b), getattr(jfb, fn)(jl, b)), fn
        x = np.random.default_rng(b).normal(size=(2, tl.bucket_rows[b], 128))
        x = x.astype(np.float32)
        want = np.asarray(jfb.mask_padding(jl, b, jnp.asarray(x)))
        assert np.array_equal(tfb.mask_padding(tl, b, torch.from_numpy(x)).numpy(), want)
    jb = jfb.flatten(jl, jax.tree.map(jnp.asarray, tree))
    tb = tfb.flatten(tl, params_from_reference(tree, "cpu"))
    for a, b in zip(jb, tb, strict=True):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_bucket_state_pack_unpack_roundtrip():
    _, _, tp = _smoke_params(3)
    st = tfb.BucketState.pack(tp)
    for a, b in zip(tree_flatten(tp)[0], tree_flatten(st.unpack())[0]):
        assert torch.equal(a, b)
    st2 = st.with_buckets([b * 2 for b in st.buckets])
    assert st2.layout is st.layout and st2.num_buckets == 1


def test_sharded_classes_not_ported_yet():
    """Sharded classes are ported now (``tests/test_torch_sharded.py`` holds
    them against the reference): a sharded class builds its own
    shard-major sub-bucket instead of raising, and a replicated one keeps
    the dtype bucket."""
    cls = {"w": tfb.ShardClass(axes=("model",), dims=((0, 2),)),
           "b": tfb.REPLICATED}
    tree = {"w": torch.arange(8.0).reshape(4, 2), "b": torch.ones(3)}
    lay = tfb.build_layout(tree, shard_classes=cls)
    assert lay.bucket_classes == ((), ("model",))
    assert lay.bucket_shards == (1, 2)
    assert lay.bucket_local_rows(1) == 8 and lay.bucket_rows[1] == 16
    bufs = tfb.flatten(lay, tree)
    assert torch.equal(bufs[1].reshape(2, -1)[:, :4],
                       tree["w"].reshape(2, 4))
    out = tfb.unflatten(lay, bufs)
    assert all(torch.equal(out[k], tree[k]) for k in tree)


def test_data_matches_reference():
    """markov_lm / lm_examples / ShardedBatches: identical arrays."""
    kw = dict(vocab=64, num_seqs=40, seq_len=12, seed=3)
    assert np.array_equal(tsyn.markov_lm(**kw), jsyn.markov_lm(**kw))
    assert np.array_equal(tsyn.markov_lm(**kw, sample_seed=9),
                          jsyn.markov_lm(**kw, sample_seed=9))
    data_t = tsyn.lm_examples(tsyn.markov_lm(**kw))
    data_j = jsyn.lm_examples(jsyn.markov_lm(**kw))
    it_t = tpart.ShardedBatches(data_t, 4, 3, seed=1)
    it_j = jpart.ShardedBatches(data_j, 4, 3, seed=1)
    for _ in range(7):                   # crosses an epoch boundary
        bt, bj = next(it_t), next(it_j)
        for k in ("tokens", "labels"):
            assert bt[k].dtype == np.int32 and np.array_equal(bt[k], bj[k])


@pytest.mark.parametrize("fn,kw", [
    ("cluster_classification", dict(num_classes=10, dim=32, n_train=96,
                                    n_test=64, seed=0, margin=1.15,
                                    label_noise=0.2)),
    ("cluster_classification", dict(num_classes=3, dim=5, n_train=40,
                                    n_test=7, seed=4)),
    ("logreg_data", dict(n=300, d=100, seed=0)),
    ("logreg_data", dict(n=50, d=7, seed=2, flip=0.3)),
])
def test_classification_data_matches_reference(fn, kw):
    """The paper harness's data (cluster_classification, logreg_data):
    identical arrays and dtypes (float32 features, int32 or +-1 float32
    labels)."""
    got, want = getattr(tsyn, fn)(**kw), getattr(jsyn, fn)(**kw)
    flat = lambda t: [a for x in t for a in (x if isinstance(x, tuple) else (x,))]
    got, want = flat(got), flat(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_schedule_matches_reference():
    """lr_at is float32 like the reference's jnp form: bitwise equal."""
    for ls_kw in (dict(local_steps=4, post_local_switch=6),
                  dict(local_steps=6, warmup_kind="exp", warmup_steps=8),
                  dict(local_steps=5, warmup_kind="linear", warmup_steps=7),
                  dict(local_steps=3, block_steps=2)):
        jls, tls = JLocalSGDConfig(**ls_kw), LocalSGDConfig(**ls_kw)
        assert [tsched.local_steps_at(tls, t) for t in range(30)] == \
            [jsched.local_steps_at(jls, t) for t in range(30)]
        assert list(tsched.sync_boundaries(tls, 40)) == \
            list(jsched.sync_boundaries(jls, 40))
    for op_kw in (dict(base_lr=0.3, base_batch=32, lr_warmup_steps=7,
                       lr_decay_steps=(20, 30)),
                  dict(base_lr=0.1, base_batch=256),
                  dict(base_lr=0.2, base_batch=24, lr_warmup_steps=10,
                       lr_decay_steps=(50,), lr_decay_factor=0.3)):
        jop, top = JOptimConfig(**op_kw), OptimConfig(**op_kw)
        for gb in (32, 96):
            got = [tsched.lr_at(top, t, global_batch=gb) for t in range(60)]
            want = [np.float32(jsched.lr_at(jop, t, global_batch=gb))
                    for t in range(60)]
            assert all(isinstance(g, np.float32) for g in got)
            assert np.array_equal(np.array(got), np.array(want))


def test_run_configs_match_reference():
    """The run-level config dataclasses: the same fields with the same
    defaults (every ControllerConfig knob: patience, tol, max_batch_scale,
    err_budget, noise_grow, lr_cap_decay, lr_scale_min, skew_*), and the
    same telemetry / speculation switches for every controller kind."""
    import dataclasses

    from repro.configs import base as jcb
    from repro_torch.configs import base as tcb

    for name in ("LocalSGDConfig", "OptimConfig", "ControllerConfig"):
        jf = {f.name: f.default for f in dataclasses.fields(getattr(jcb, name))}
        tf = {f.name: f.default for f in dataclasses.fields(getattr(tcb, name))}
        assert tf == jf, name
    for f in ("controller", "local_sgd", "optim", "seed", "steps"):
        assert f in {x.name for x in dataclasses.fields(tcb.RunConfig)}
    # the shape registry and the arch x shape matrix of the archs ported
    assert tcb.INPUT_SHAPES == {k: tcb.InputShape(*dataclasses.astuple(v))
                                for k, v in jcb.INPUT_SHAPES.items()}
    from repro import configs as jc
    from repro_torch import configs as tc
    assert set(tc.ARCHS) <= set(jc.ARCHS)
    assert tc.runnable_pairs() == [p for p in jc.runnable_pairs() if p[0] in tc.ARCHS]
    assert tc.SKIPS == {k: v for k, v in jc.SKIPS.items() if k[0] in tc.ARCHS}
    kinds = ("static", "diversity_h", "adaptive_batch", "auto_compress",
             "noise_adaptive", "elastic")
    for kind in kinds:
        for tel in (None, True, False):
            j = jcb.ControllerConfig(kind=kind, telemetry=tel)
            t = tcb.ControllerConfig(kind=kind, telemetry=tel)
            assert (t.wants_telemetry, t.wants_speculation) == \
                (j.wants_telemetry, j.wants_speculation), (kind, tel)


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ["paper-lm", "qwen3-32b", "phi4-mini-3.8b",
                                  "minitron-4b", "gemma3-1b", "olmoe-1b-7b",
                                  "deepseek-v2-lite-16b", "whisper-small",
                                  "internvl2-76b"])
def test_model_configs_match_reference(arch, size):
    """The port's copy of each registered config, field for field, and
    its citation."""
    import dataclasses
    get = "get" if size == "full" else "get_smoke"
    jc, tc = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.citation == jc.citation
    assert arch in tconfigs.ARCHS + ("paper-lm",)
