"""Port parity: the paper-experiment harness (``repro_torch.benchmarks``)
against the reference's own harness (the top-level ``benchmarks`` package:
``common.train_local_sgd`` on the JAX tree path, jitted).

Both sides start from the reference's weights (``mlp_init(PRNGKey(0),
width)`` through numpy; the JAX and torch generators never compare draw
for draw) and see the same numpy batches, at width 64, K = 4, B_loc 16.
The port runs on the CPU, where its kernels run their plain versions.

Tolerances (float32 sums in another order on each side):
* per-step loss rtol 1e-4; comm rounds equal; block and global syncs
  equal, in the same order;
* the final worker-mean params rtol 2e-4, atol 1e-6 (the reference's own
  tree-vs-resident tolerance, ``tests/test_resident_state.py``); under
  sign / EF-sign a delta within rounding of 0 can take the other sign and
  move its element by a whole scale, so up to 1e-3 of the entries may lie
  outside it (phase C's rule);
* test accuracy within 2 / n_test;
* Fig. 4's Hessian-vector product rtol 1e-4 of the largest entry, its
  lambda_max (100 power iterations from each side's own start vector)
  within 1e-2 relative; Section 5's noise traces rtol 1e-4; the convex
  run's (sim_time, steps, comm, reached) equal and f* rtol 1e-5;
* the metrics exposition identical text.
"""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:      # the reference's top-level benchmarks/
    sys.path.append(str(ROOT))

from benchmarks import bench_convex as jcv                     # noqa: E402
from benchmarks import common as jc                            # noqa: E402
from benchmarks import paper_tables as jpt                     # noqa: E402
from repro.core.noise import gradient_noise_trace as jnoise_trace  # noqa: E402
from repro.telemetry import metrics as jmetrics                # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.benchmarks import bench_convex as tcv         # noqa: E402
from repro_torch.benchmarks import common as tc                # noqa: E402
from repro_torch.benchmarks import paper_tables as tpt         # noqa: E402
from repro_torch.benchmarks import run as trun                 # noqa: E402
from repro_torch.configs import base as tcb                    # noqa: E402
from repro_torch.convert import params_from_reference          # noqa: E402
from repro_torch.core import flatbuf                           # noqa: E402
from repro_torch.core import local_sgd as tsgd                 # noqa: E402
from repro_torch.core.local_sgd import mean_params             # noqa: E402
from repro_torch.data.partition import ShardedBatches          # noqa: E402
from repro_torch.data.synthetic import lm_examples, markov_lm  # noqa: E402
from repro_torch.launch.steps import build_train               # noqa: E402
from repro_torch.models import base as tmbase                  # noqa: E402
from repro_torch.telemetry import metrics as tmetrics          # noqa: E402

WIDTH, K, B_LOC, STEPS = 64, 4, 16, 24
TRAIN, TEST = jc.dataset()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's tests, then the old count."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _p0(width=WIDTH):
    return jax.tree.map(np.asarray, jc.mlp_init(jax.random.PRNGKey(0), width))


def _record_scopes(monkeypatch):
    """Wrap the port harness's ``make_local_sgd`` so each sync appends its
    scope ("block" or "global") to the returned list."""
    seen = []
    real = tc.make_local_sgd

    def wrapped(*a, **k):
        init, step, sync = real(*a, **k)

        def rec_sync(state, **kw):
            seen.append(kw.get("scope", "global"))
            return sync(state, **kw)
        return init, step, rec_sync
    monkeypatch.setattr(tc, "make_local_sgd", wrapped)
    return seen


def _pair(steps=STEPS, **kw):
    ref = jc.train_local_sgd(steps=steps, train=TRAIN, width=WIDTH,
                             return_history=True, **kw)
    port = tc.train_local_sgd(steps=steps, train=TRAIN, width=WIDTH,
                              return_history=True, params0=_p0(),
                              device="cpu", **kw)
    return ref, port


def _ref_mean(js):
    return jax.tree.map(lambda a: np.asarray(a.mean(axis=0)), js.params)


def _check(ref, port, *, flip_frac=0.0, losses=True):
    (js, jcomm, jh), (ts, tcomm, th) = ref, port
    assert tcomm == jcomm
    if losses:
        assert [h["step"] for h in th] == [h["step"] for h in jh]
        np.testing.assert_allclose([h["loss"] for h in th],
                                   [h["loss"] for h in jh], rtol=1e-4)
    jm = _ref_mean(js)
    tm = {k: v.numpy() for k, v in mean_params(ts).items()}
    assert sorted(tm) == sorted(jm)
    if flip_frac:
        out = np.concatenate([(np.abs(tm[k] - jm[k])
                               > 2e-4 * np.abs(jm[k]) + 1e-6).ravel() for k in jm])
        assert out.mean() <= flip_frac, out.mean()
    else:
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=2e-4, atol=1e-6,
                                       err_msg=k)
    assert abs(tc.test_acc(ts, TEST) - jc.test_acc(js, TEST)) <= 2 / len(TEST["y"])


def test_harness_dataset_and_mlp_loss_match_reference():
    """dataset(): equal arrays; mlp_loss on the same (converted) params
    and batch: loss rtol 1e-6, acc equal; test_acc of a single-copy tree
    and of a stacked one."""
    ttrain, ttest = tc.dataset()
    for a, b in ((TRAIN, ttrain), (TEST, ttest)):
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
                   for k in ("x", "y"))
    p0 = _p0()
    tp = params_from_reference(p0, "cpu")
    xb, yb = TRAIN["x"][:96], TRAIN["y"][:96]
    jl, jm = jc.mlp_loss(jax.tree.map(jnp.asarray, p0),
                         {"x": jnp.asarray(xb), "y": jnp.asarray(yb)})
    tl, tm = tc.mlp_loss(tp, {"x": torch.from_numpy(xb),
                              "y": torch.from_numpy(yb).long()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(tm["acc"]) == float(jm["acc"])
    acc = jc.test_acc(jax.tree.map(jnp.asarray, p0), TEST)
    assert tc.test_acc(tp, TEST) == acc
    stacked = {k: torch.stack([v, v]) for k, v in tp.items()}
    assert tc.test_acc(stacked, TEST) == acc


def test_mlp_init_draws_the_reference_distributions():
    """The port's own init: the reference's keys and shapes, zero biases,
    weights N(0, 1/fan_in) (std within 5 %), from an explicit generator
    (one seed, the same bits)."""
    p = tc.mlp_init(torch.Generator().manual_seed(3), 256)
    ref = jc.mlp_init(jax.random.PRNGKey(3), 256)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    for k, v in p.items():
        if k.startswith("b"):
            assert not v.any()
        else:
            std = float(v.std()) * np.sqrt(v.shape[0])
            assert abs(std - 1) < 0.05, (k, std)
    again = tc.mlp_init(torch.Generator().manual_seed(3), 256)
    assert all(torch.equal(p[k], again[k]) for k in p)


@pytest.mark.parametrize("name,kw", [
    ("post_local", dict(H=4, post_local_switch=STEPS // 2)),
    ("local_H4", dict(H=4)),
    ("minibatch_H1", dict(H=1)),
])
def test_fig1_style_runs_match_reference(name, kw):
    _check(*_pair(K=K, B_loc=B_LOC, **kw))


def test_table8_global_momentum_matches_reference():
    _check(*_pair(K=K, B_loc=B_LOC, H=2, global_momentum=0.3))


def test_table16_hierarchical_matches_reference(monkeypatch):
    """Alg. 5 (block_steps=2, blocks of K/2 = 2): the port syncs at the
    reference harness's rule (the sync numbered c is a block mean unless
    c is a multiple of block_steps), and table16's split counts them."""
    Hb = 2
    scopes = _record_scopes(monkeypatch)
    ref, port = _pair(K=K, B_loc=B_LOC, H=2, block_steps=Hb)
    _check(ref, port)
    assert scopes == ["block" if c % Hb else "global"
                      for c in range(1, ref[1] + 1)]
    assert tpt.sync_split(port[1], Hb) == (scopes.count("global"),
                                           scopes.count("block")) == (6, 6)


@pytest.mark.parametrize("kind", ["linear", "exp", "constant"])
def test_fig10_warmup_matches_reference(kind, monkeypatch):
    """Fig. 10's warmup runs (K=8, B_loc 32, width 256, H ramped to 8 over
    STEPS // 4) at STEPS = 24: the reference's ``_train_with_warmup``
    against the port's."""
    monkeypatch.setattr(jpt, "STEPS", STEPS)
    monkeypatch.setattr(tpt, "STEPS", STEPS)
    ref = jpt._train_with_warmup(kind, TRAIN)
    port = tpt._train_with_warmup(kind, TRAIN, device="cpu", params0=_p0(256))
    _check(ref, port, losses=False)


@pytest.mark.parametrize("mode", ["sign", "ef_sign"])
def test_table4_sign_compression_matches_reference(mode):
    _check(*_pair(steps=8, K=K, B_loc=B_LOC, H=1, lr=0.05,
                  sync_compression=mode), flip_frac=1e-3)


def test_table14_noise_runs_with_the_reference_schedule():
    """Gradient noise compares with the reference only statistically: the
    port's losses are finite, its comm rounds the reference's, and the
    bucket padding stays exactly zero."""
    (js, jcomm, _), (ts, tcomm, th) = _pair(K=K, B_loc=B_LOC, H=1,
                                            noise_eta=1e-4)
    assert tcomm == jcomm == STEPS
    assert all(np.isfinite(h["loss"]) for h in th)
    layout = ts.params.layout
    pad = 1 - torch.from_numpy(flatbuf.valid_mask(layout, 0)).float()
    for buf in (ts.params.buckets[0], ts.momentum.buckets[0]):
        assert float((buf * pad).abs().max()) == 0.0
    assert float(ts.momentum.buckets[0].abs().max()) > 0


def _eig_batch():
    xb, yb = TRAIN["x"][:256], TRAIN["y"][:256]
    return ({"x": jnp.asarray(xb), "y": jnp.asarray(yb)},
            {"x": torch.from_numpy(xb), "y": torch.from_numpy(yb).long()})


def test_fig4_hvp_matches_jax():
    """The Hessian-vector product (jvp of grad) on one vector, flattened in
    ravel_pytree order, against jax.jvp(jax.grad(...))."""
    p0 = _p0()
    jb, tb = _eig_batch()
    flat, unravel = jax.flatten_util.ravel_pytree(jax.tree.map(jnp.asarray, p0))
    u = np.random.default_rng(1).normal(size=flat.shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda u: jax.jvp(
        jax.grad(lambda f: jc.mlp_loss(unravel(f), jb)[0]), (flat,), (u,))[1])(
            jnp.asarray(u)))
    tflat, hvp = tpt._hvp(params_from_reference(p0, "cpu"), tb)
    assert np.array_equal(tflat.numpy(), np.asarray(flat))
    got = hvp(torch.from_numpy(u)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_fig4_lambda_max_matches_reference():
    p0 = _p0()
    jb, tb = _eig_batch()
    want = jpt._dominant_eig(jax.tree.map(jnp.asarray, p0), jb, iters=100)
    got = tpt._dominant_eig(params_from_reference(p0, "cpu"), tb, iters=100)
    assert abs(got - want) <= 1e-2 * abs(want), (got, want)


def test_sec5_noise_traces_match_reference():
    """tr(Sigma) from 16 workers' gradients at B_loc 16..128 on the same
    index draws (``default_rng(0)``), per the reference's sec5 recipe."""
    pj = jc.mlp_init(jax.random.PRNGKey(0))
    gfun = jax.jit(jax.vmap(lambda b: jax.grad(
        lambda p, bb: jc.mlp_loss(p, bb)[0])(pj, b)))
    rng = np.random.default_rng(0)
    want = {}
    for B in tpt.SEC5_BATCHES:
        idx = rng.integers(0, len(TRAIN["x"]), size=(16, B))
        g = gfun({"x": jnp.asarray(TRAIN["x"][idx]),
                  "y": jnp.asarray(TRAIN["y"][idx])})
        want[B] = float(jnoise_trace(g)[0])
    got = tpt.noise_traces(params_from_reference(jax.tree.map(np.asarray, pj),
                                                 "cpu"), TRAIN, "cpu")
    assert list(got) == list(want)
    np.testing.assert_allclose([got[b] for b in want], list(want.values()),
                               rtol=1e-4)


@pytest.mark.parametrize("K_,H,lr,reached", [(8, 1, 8.0, True), (4, 2, 8.0, False)])
def test_convex_run_config_matches_reference(K_, H, lr, reached):
    want = jcv.run_config(K_, H, 16, steps=40, lr=lr)
    got = tcv.run_config(K_, H, 16, steps=40, lr=lr, device="cpu")
    assert got == want and got[3] is reached


def test_convex_fstar_matches_reference():
    x, y = tcv.logreg_data(n=tcv.N, d=tcv.D, seed=0)
    want = jcv._fstar(jnp.asarray(x), jnp.asarray(y))
    got = tcv._fstar(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _feed(m, reg):
    """The same observations through one package's metrics module."""
    m.observe_step(reg, 0.0123)
    m.observe_step(reg, 3.0)
    m.observe_round(reg, scope="global", h=4, wire_bytes=1.5e6, loss=2.25,
                    batch_scale=2, lr_scale=0.5, round_s=0.75, sync_s=0.002,
                    stage_s=[("s0", 0.001), ("s1", 0.0005)],
                    worker_step_s=[1.0, 1.5, 2.0])
    m.observe_round(reg, scope="block", h=1, wire_bytes=7, sync_s=1e-5)
    m.observe_serve_step(reg, new_tokens=12, queue_depth=3, occupancy=0.75,
                         decode_s=0.02)
    m.observe_swap(reg, version=5, swap_s=0.4)
    h = reg.histogram("bench_seconds", "wall seconds per benchmark measurement",
                      labels=("name",))
    for name, s in (("fig1/A1", 4.8), ('we"ird\\name', 1e-5), ("fig1/A1", 100.0)):
        h.labels(name=name).observe(s)
    reg.counter("plain").inc()
    reg.gauge("g", "a gauge", labels=("a", "b")).labels(a=1, b="x").set(-0.5)
    return reg.exposition()


def test_metrics_exposition_identical_to_reference():
    """The same observations into both registries give the same Prometheus
    text; the registries refuse the same misuse."""
    want = _feed(jmetrics, jmetrics.MetricsRegistry())
    got = _feed(tmetrics, tmetrics.MetricsRegistry())
    assert got == want
    assert "repro_bench_seconds_bucket" in got
    assert _feed(tmetrics, tmetrics.MetricsRegistry(prefix="")) == \
        _feed(jmetrics, jmetrics.MetricsRegistry(prefix=""))
    reg = tmetrics.MetricsRegistry()
    reg.counter("c", labels=("x",))
    with pytest.raises(ValueError):
        reg.gauge("c")
    with pytest.raises(ValueError):
        reg.counter("c", labels=("x",)).labels(y=1)
    with pytest.raises(ValueError):
        reg.counter("c", labels=("x",)).labels(x=1).inc(-1)


def test_bench_metrics_histogram_fed_by_the_timers():
    reg = tc.bench_metrics()
    before = reg.exposition()
    with tc.wall_timer("probe/wall") as w:
        pass
    us = tc.time_fn(lambda: torch.ones(3).sum(), iters=3, warmup=1,
                    name="probe/fn")
    text = reg.exposition()
    assert w["s"] >= 0 and us > 0 and text != before
    for name in ("probe/wall", "probe/fn"):
        assert f'repro_bench_seconds_count{{name="{name}"}}' in text


def test_float_batch_fields_reach_loss_fn_unchanged():
    """local_step moves integer fields as int64 and floating ones as
    float32 with their values: the MLP's features and logreg's +-1
    targets are not truncated."""
    seen = []

    def loss_fn(params, batch):
        seen.append({k: v.clone() for k, v in batch.items()})
        return (params["w"] * batch["x"].sum()).sum(), {}

    run = tcb.RunConfig(model=tcb.ModelConfig(name="t", family="dense",
                                              citation=""),
                        shape=tcb.InputShape("t", 4, 2, "train"))
    init, local_step, _ = tsgd.make_local_sgd(run, loss_fn, num_workers=2)
    st = init({"w": torch.zeros(4)})
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(2, 1, 4)).astype(np.float32),
             "y": np.array([[[-1.0]], [[1.0]]], np.float32),
             "i": np.array([[[7]], [[9]]], np.int32)}
    local_step(st, batch)
    for w in range(2):
        got = seen[w]
        assert got["x"].dtype == got["y"].dtype == torch.float32
        assert got["i"].dtype == torch.int64
        for k in batch:
            assert np.array_equal(got[k].numpy(), batch[k][w]), k


def _pre_fix_to_device(v, dev):
    """The batch move before float fields: every field as int64."""
    return torch.as_tensor(v).to(dev, torch.int64)


def test_paper_lm_trajectory_bitwise_after_float_repair(monkeypatch):
    """paper-lm's token batches move as before: every buffer and loss
    after 4 steps with syncs equals the pre-repair cast's, bit for bit
    (int32 views)."""
    run = tcb.RunConfig(
        model=tconfigs.get_smoke("paper-lm"),
        shape=tcb.InputShape("t", 32, 4 * 2, "train"),
        local_sgd=tcb.LocalSGDConfig(local_steps=2, sync_compression="ef_sign"),
        optim=tcb.OptimConfig(base_lr=0.3, base_batch=8, lr_warmup_steps=2,
                              grad_clip=1.0))
    data = lm_examples(markov_lm(vocab=512, num_seqs=32, seq_len=32))
    out = {}
    for name, fn in (("fixed", tsgd._to_device), ("pre_fix", _pre_fix_to_device)):
        monkeypatch.setattr(tsgd, "_to_device", fn)
        tb = build_train(run, num_workers=4, device="cpu")
        ts = tb.init(tmbase.materialize(tb.specs,
                                        torch.Generator().manual_seed(0), "cpu"))
        it, vals = ShardedBatches(data, 4, 2), []
        for _ in range(4):
            ts, m = tb.local_step(ts, next(it))
            vals.append(m["loss"])
            if ts.step % 2 == 0:
                ts = tb.sync(ts, plan=tb.sync_plan)
        for f in dataclasses.fields(ts):
            v = getattr(ts, f.name)
            if flatbuf.is_bucket_state(v):
                vals.extend(v.buckets)
        out[name] = vals
    bits = lambda t: t.view(torch.int32)
    assert len(out["fixed"]) == len(out["pre_fix"]) > 4
    assert all(torch.equal(bits(a), bits(b))
               for a, b in zip(out["fixed"], out["pre_fix"]))


def test_run_cli_on_cpu(tmp_path, capsys, monkeypatch):
    """``run --device cpu`` prints the reference's rows for sec5 and table17
    and embeds the bench_seconds exposition; a bench left with the
    reference prints its ERROR row and exits 1; with no card and no
    device the CLI raises."""
    out = tmp_path / "bench.json"
    assert trun.main(["--only", "table17,sec5", "--device", "cpu",
                      "--json-out", str(out)]) == 0
    rows = [l.split(",")[0] for l in capsys.readouterr().out.splitlines()]
    assert rows[:1] == ["name"] and rows[1:4] == [
        "table17/H2_Hb1", "table17/H2_Hb4", "table17/H2_Hb16"]
    assert rows[4:9] == [f"sec5/noise_trace_B{b}" for b in tpt.SEC5_BATCHES] + [
        "sec5/trace_ratio_16_vs_128"]
    art = json.loads(out.read_text())
    assert art["device"] == "cpu" and art["failures"] == 0
    assert {"sec5/trace_ratio_16_vs_128", "table17/H2_Hb16"} <= \
        {r["name"] for r in art["records"]}
    assert art["metrics_exposition"] == tc.bench_metrics().exposition()
    assert trun.main(["--only", "kernels", "--device", "cpu"]) == 1
    assert "kernels,0.0,ERROR" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["--only", "table17"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.train_local_sgd(K=1, B_loc=4, H=1, steps=1, train=TRAIN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcv.run_config(1, 1, 4, steps=1)
