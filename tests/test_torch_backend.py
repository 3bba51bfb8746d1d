"""Port parity: the backend seam and the elastic worker pool on one card
(repro_torch vs repro; the twin of ``tests/test_backend.py``).

* ``WorkerSet`` semantics, step by step equal to the reference's.
* ``resize_axis`` (mean / slice / grow, f32 and bf16), ``resize_state``
  and ``resize_stats`` on a resident state, against ``repro.core.elastic``
  on the converted state.  A mean over groups of 2 is one add and one
  halving in both packages: bit for bit.  Over groups of 4 the two sum in
  another order: rtol 1e-6 (f32); bf16 rounds both once from a float32
  sum: within one bf16 ulp.
* Static W: the hand-made bundle, an explicit ``LocalBackend`` and the
  default backend give the same bits; only the hand-made bundle warns.
* ``fit`` with ``ElasticController(resize_at=...)``: SGD / LARS x none /
  EF-sign, bit for bit against the port's own fresh-run oracle (the
  resized state handed to a fresh bundle at the new W, LR x new_w / 4),
  and within 1e-5 (relative, losses and buckets) of the reference's
  elastic ``fit`` on the resident path (``use_kernel=True``, Pallas in
  interpret mode, as its own tests run it), from the same weights and
  batches.
* The simulated straggler: demoted and promoted back at the reference's
  rounds, the same JSONL keys, ``controller`` and ``resize`` trace spans.
* The W 4 -> 2 -> 4 acceptance run: the ledger's ``worker_sets`` equal
  the reference's.
* Distributed gating (one process), two ``gloo`` processes building,
  taking a step and a sync and resizing W 4 -> 2 under ``fit``, the
  up-front refusals, the ``make_backend`` kinds, and the CLI with a
  simulated straggler (``tests/test_torch_distributed.py`` holds the
  distributed runs, ``tests/test_torch_elastic_dist.py`` their resizes,
  demotion and checkpoints).

The reference's ``test_resize_fsdp_subbuckets`` has its port in
``tests/test_torch_sharded.py`` (one process) and
``tests/test_torch_elastic_dist.py`` (across shard ranks).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backend as jbackend
from repro.backend.local import LocalBackend as JLocalBackend
from repro.backend.simulated import SimulatedBackend as JSimulatedBackend
from repro.configs import base as jcb
from repro.core import controller as jctl
from repro.core import elastic as jelastic
from repro.core import flatbuf as jflatbuf
from repro.core.local_sgd import LocalSGDState as JState
from repro.core.local_sgd import make_local_sgd as jmake_local_sgd
from repro.core.local_sgd import unpack_state as junpack
from repro.data.partition import ShardedBatches as JBatches
from repro.launch import train as jtrain
from repro.launch.steps import TrainBundle as JBundle
from repro.models import base as jmbase
from repro.telemetry import MetricsRegistry as JMetrics
from repro.telemetry import Tracer as JTracer
from repro.telemetry import stats as jstats
from repro_torch import backend as tbackend
from repro_torch.backend import WorkerSet, make_backend
from repro_torch.backend.local import LocalBackend
from repro_torch.backend.simulated import SimulatedBackend
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.core import controller as tctl
from repro_torch.core import elastic
from repro_torch.core import flatbuf
from repro_torch.core.local_sgd import make_local_sgd, unpack_state
from repro_torch.core.schedule import DynamicSchedule, local_steps_at
from repro_torch.data.partition import ShardedBatches
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import TrainBundle
from repro_torch.models.base import ParamSpec
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import stats as tstats
from repro_torch.telemetry import trace as ttrace

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
D, C = 6, 3
W0 = 4
B = 8
QUAD_SPECS = {"w": ParamSpec((D, C), (None, None)),
              "b": ParamSpec((C,), (None,), init="zeros")}
J_QUAD_SPECS = {"w": jmbase.ParamSpec((D, C), (None, None)),
                "b": jmbase.ParamSpec((C,), (None,), init="zeros")}
RTOL = 1e-5
quiet = lambda *a: None


def quad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {"xent": loss}


def j_quad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = jnp.mean((pred - batch["y"]) ** 2)
    return loss, {"xent": loss}


def quad_data(n=4096, seed=0, noise=0.01):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = (x @ (np.ones((D, C), np.float32) * 0.5)
         + noise * rng.standard_normal((n, C)).astype(np.float32))
    return {"x": x, "y": y}


def make_runs(H=2, controller=None, *, steps=24, optimizer="sgd", **ls_kw):
    """The same quad RunConfig in both packages (the reference test's)."""
    out = []
    for cb in (jcb, tcb):
        out.append(cb.RunConfig(
            model=cb.ModelConfig(name="quad", family="dense", citation=""),
            shape=cb.InputShape("t", 8, W0 * B, "train"),
            local_sgd=cb.LocalSGDConfig(local_steps=H, local_momentum=0.9,
                                        nesterov=True, **ls_kw),
            optim=cb.OptimConfig(optimizer=optimizer, base_lr=0.03,
                                 base_batch=W0 * B, weight_decay=0.0,
                                 lr_warmup_steps=0, lr_decay_steps=()),
            controller=cb.ControllerConfig(**(controller or {})),
            steps=steps))
    return out


def quad_builder():
    """``LocalBackend(build_fn=...)`` factory: the quad bundle for whatever
    worker set the backend owns (a resize calls back through it)."""
    def build(run, ws):
        cc = run.controller
        init, local_step, sync = make_local_sgd(
            run, quad_loss, num_workers=ws.num_workers,
            telemetry=cc.wants_telemetry,
            speculate_compression=cc.wants_speculation)
        return TrainBundle(cfg=run.model, run=run, num_workers=ws.num_workers,
                           specs=QUAD_SPECS, init=init, local_step=local_step,
                           sync=sync, device=torch.device("cpu"),
                           telemetry=cc.wants_telemetry, n_comp=1,
                           worker_set=ws)
    return build


def j_quad_builder():
    """The reference test's builder, on its resident path."""
    def build(run, ws):
        cc = run.controller
        init, local_step, sync = jmake_local_sgd(
            run, j_quad_loss, num_workers=ws.num_workers, use_kernel=True,
            telemetry=cc.wants_telemetry,
            speculate_compression=cc.wants_speculation)
        return JBundle(cfg=run.model, run=run, layout=None,
                       num_workers=ws.num_workers, specs=J_QUAD_SPECS,
                       init=init, local_step=local_step, sync=sync,
                       telemetry=cc.wants_telemetry, n_comp=1, worker_set=ws)
    return build


def params0(seed=0):
    """The reference fit's starting weights, carried into the port."""
    p = jmbase.materialize(J_QUAD_SPECS, jax.random.PRNGKey(seed),
                           dtype=jnp.float32)
    return params_from_reference(jax.tree.map(np.asarray, p), "cpu")


def buffers(state):
    """(params, momentum) worker-stacked trees as numpy, either package."""
    if isinstance(state, JState):
        up = junpack(state)
        conv = lambda t: {k: np.asarray(v) for k, v in t.items()}
    else:
        up = unpack_state(state)
        conv = lambda t: {k: v.detach().numpy().copy() for k, v in t.items()}
    return conv(up.params), conv(up.momentum)


def assert_buffers_equal(a, b):
    for x, y in zip(buffers(a), buffers(b)):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def assert_buffers_close(port, ref, rtol=RTOL):
    for x, y in zip(buffers(port), buffers(ref)):
        for k in x:
            np.testing.assert_allclose(x[k], y[k], rtol=rtol,
                                       atol=rtol * np.abs(y[k]).max(),
                                       err_msg=k)


def losses(hist):
    return np.array([h["loss"] for h in hist])


# ---------------------------------------------------------------------------
# WorkerSet + resize_axis / resize_state / resize_stats
# ---------------------------------------------------------------------------

def test_worker_set_semantics():
    """The reference test's census, then one op sequence through both
    packages' WorkerSets: the same ids and demotions after every op."""
    ws = WorkerSet.of(4)
    assert ws.ids == (0, 1, 2, 3) and ws.num_workers == 4
    assert ws.resize(2).ids == (0, 1)
    assert ws.resize(2).resize(4).ids == (0, 1, 2, 3)
    assert ws.resize(3).resize(6).ids == (0, 1, 2, 3, 4, 5)
    assert ws.demote(3).active == (0, 1, 2)
    assert ws.demote(3).resize(2).demoted == ()
    assert ws.demote(3).resize(8).demoted == (3,)
    assert ws.demote(1).promote(1) == ws and ws.promote(2) is ws
    assert ws.demote(1).demote(1).demoted == (1,)
    assert ws.row_of(2) == 2
    for bad in (lambda: ws.demote(9), lambda: ws.promote(9),
                lambda: ws.resize(0)):
        with pytest.raises(ValueError):
            bad()
    ops = [("demote", 3), ("resize", 8), ("demote", 6), ("promote", 3),
           ("resize", 2), ("demote", 0), ("resize", 6), ("promote", 0)]
    t, j = WorkerSet.of(4), jbackend.WorkerSet.of(4)
    for op, arg in ops:
        t, j = getattr(t, op)(arg), getattr(j, op)(arg)
        assert (t.ids, t.demoted, t.active) == (j.ids, j.demoted, j.active)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w,new_w,fold", [(4, 2, "mean"), (4, 1, "mean"),
                                          (8, 4, "mean"), (4, 2, "slice"),
                                          (2, 8, "mean"), (3, 6, "slice")])
def test_resize_axis_matches_reference(dtype, w, new_w, fold):
    x = np.random.default_rng(w * 10 + new_w).standard_normal(
        (w, 5, 7)).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jelastic.resize_axis(jx, new_w, fold=fold)
                      .astype(jnp.float32))
    got_t = elastic.resize_axis(tx, new_w, fold=fold)
    assert got_t.dtype == tx.dtype and got_t.shape == (new_w, 5, 7)
    got = got_t.float().numpy()
    group = w // new_w if new_w < w else 1
    if group <= 2 or fold == "slice":
        np.testing.assert_array_equal(got, want)
    elif dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:                       # one bf16 rounding of a float32 sum
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)


def test_resize_axis_edges():
    x = torch.arange(8.0).reshape(4, 2)
    assert torch.equal(elastic.resize_axis(x, 2),
                       torch.tensor([[1.0, 2.0], [5.0, 6.0]]))
    assert elastic.resize_axis(x, 4) is x
    g = elastic.resize_axis(x, 8)
    assert torch.equal(g[0], g[1]) and torch.equal(g[6], x[3])
    with pytest.raises(ValueError, match="not divisible"):
        elastic.resize_axis(x, 3)
    with pytest.raises(ValueError, match="not divisible"):
        elastic.resize_axis(x, 6)
    with pytest.raises(ValueError, match="unknown fold"):
        elastic.resize_axis(x, 2, fold="nope")


def _resident_pair(telemetry):
    """One resident state in both packages: the reference's, with random
    buffers, and the port's converted from it."""
    key = jax.random.PRNGKey(0)
    tree = {"w": jax.random.normal(key, (W0, D, C)),
            "b": jax.random.normal(jax.random.fold_in(key, 1), (W0, C))}
    st = jflatbuf.BucketState.pack(tree, leading=1)
    mom = jflatbuf.BucketState.pack(jax.tree.map(lambda x: 0.5 * x, tree),
                                    leading=1)
    anchor = jflatbuf.BucketState.pack({k: v[0] for k, v in tree.items()})
    stats = None
    if telemetry:
        stats = dataclasses.replace(
            jstats.init_stats(W0, 2), acc_grad_sq=jnp.arange(4.0) + 1,
            round_update_sq=jnp.arange(4.0) * 3, rounds=jnp.int32(5))
    jstate = JState(params=st, momentum=mom, anchor=anchor, global_u=None,
                    ef_memory=mom, step=jnp.int32(7), rng=key, stats=stats)
    np_state = jax.tree.map(np.asarray, jstate)
    layout = flatbuf.build_layout(params_from_reference(
        {k: np.asarray(v[0]) for k, v in tree.items()}, "cpu"))
    return jstate, state_from_reference(np_state, layout=layout, device="cpu")


@pytest.mark.parametrize("new_w", [2, 8])
def test_resize_state_resident_matches_reference(new_w):
    """Resident stays resident: the stacked buffers fold (or clone) as the
    reference's do, the layout carries over, single-copy fields pass
    through as the same objects."""
    jstate, state = _resident_pair(telemetry=False)
    jout = jelastic.resize_state(jstate, new_w)
    out = elastic.resize_state(state, new_w)
    assert out.params.leading == 1 and out.params.layout is state.params.layout
    assert out.anchor is state.anchor and out.rng is state.rng
    assert out.step == 7 and out.global_u is None
    for f in ("params", "momentum", "ef_memory"):
        for a, b in zip(getattr(out, f).buckets, getattr(jout, f).buckets):
            assert a.shape[0] == new_w
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # anchored state after a shrink: its model differences are per survivor
    assert torch.equal(out.anchor.buckets[0], state.anchor.buckets[0])


def test_resize_stats_matches_reference():
    jstate, state = _resident_pair(telemetry=True)
    for new_w in (2, 8):
        jout = jelastic.resize_stats(jstate.stats, new_w)
        out = elastic.resize_stats(state.stats, new_w)
        for f in dataclasses.fields(tstats.StatsAccumulator):
            np.testing.assert_array_equal(
                getattr(out, f.name).numpy(),
                np.asarray(getattr(jout, f.name)), err_msg=f.name)
        assert tstats.round_summary(out)["num_workers"] == new_w
    assert elastic.resize_stats(None, 2) is None
    np.testing.assert_array_equal(
        elastic.resize_stats(state.stats, 2).acc_grad_sq.numpy(), [1.5, 3.5])


# ---------------------------------------------------------------------------
# static W: backend path bit for bit, the hand-made-bundle shim
# ---------------------------------------------------------------------------

def test_static_backend_bitwise_and_shim():
    """The same quad run three ways (hand-made bundle through the default
    backend, an explicit LocalBackend(build_fn=), the default backend with
    a built bundle) gives the same bits; only the hand-made bundle warns."""
    steps = 12
    _, run = make_runs(H=3, steps=steps)
    p0 = params0()
    data = quad_data()

    def go(**kw):
        return ttrain.fit(run, ShardedBatches(data, W0, B), num_steps=steps,
                          seed=0, params0=p0, log=quiet, **kw)

    bundle = quad_builder()(run, WorkerSet.of(W0))
    bundle.worker_set = None                  # a bundle made by hand
    with pytest.warns(DeprecationWarning, match="worker_set"):
        ref, h_ref, s_ref = go(bundle=bundle)
    assert bundle.worker_set == WorkerSet.of(W0)
    assert s_ref["backend"]["kind"] == "local" and s_ref["resizes"] == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        be = LocalBackend(W0, device="cpu", build_fn=quad_builder())
        st_be, h_be, s_be = go(backend=be)
        st_def, h_def, _ = go(bundle=quad_builder()(run, WorkerSet.of(W0)))
    assert s_be["backend"] == {"kind": "local", "num_workers": 4,
                               "worker_ids": [0, 1, 2, 3], "demoted": []}
    assert s_be["resizes"] == 0
    for st, h in ((st_be, h_be), (st_def, h_def)):
        assert_buffers_equal(ref, st)
        assert [x["loss"] for x in h] == [x["loss"] for x in h_ref]


def test_static_paper_lm_through_backend_is_the_bundle_path():
    """paper-lm smoke: fit through a LocalBackend that builds the bundle
    equals fit on build_train's bundle, bit for bit."""
    from repro_torch import configs as tconfigs
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.launch.steps import build_train
    smoke = tconfigs.get_smoke("paper-lm")
    run = tcb.RunConfig(model=smoke, shape=tcb.InputShape("t", 32, 4, "train"),
                        local_sgd=tcb.LocalSGDConfig(local_steps=2),
                        optim=tcb.OptimConfig(base_batch=4), steps=4)
    data = lm_examples(markov_lm(vocab=smoke.vocab_size, num_seqs=16,
                                 seq_len=32))
    a, ha, _ = ttrain.fit(run, ShardedBatches(data, 2, 2),
                          bundle=build_train(run, num_workers=2, device="cpu"),
                          num_steps=4, log=quiet)
    be = LocalBackend(2, device="cpu")
    b, hb, sb = ttrain.fit(run, ShardedBatches(data, 2, 2), backend=be,
                           num_steps=4, log=quiet)
    assert sb["backend"]["num_workers"] == 2
    assert [h["loss"] for h in ha] == [h["loss"] for h in hb]
    assert all(torch.equal(x, y) for x, y in zip(a.params.buckets,
                                                 b.params.buckets))


# ---------------------------------------------------------------------------
# elastic trajectories: a resize == a fresh run at the new W
# ---------------------------------------------------------------------------

def _oracle(run, data, *, p0, resize_round, new_w, steps):
    """The port's fresh-run oracle (the reference test's
    ``_reference_elastic``): hand-driven local steps and syncs at W0, then
    the resized state handed to a FRESH bundle at ``new_w``, the data
    re-partitioned and the LR co-scaled by new_w / W0.  Returns (state,
    per-step losses)."""
    ls = run.local_sgd
    build = quad_builder()
    bundle = build(run, WorkerSet.of(W0))
    it = ShardedBatches(data, W0, B)
    state = bundle.init(p0, seed=0)
    since, rounds, lr_resize, out = 0, 0, None, []
    for t in range(steps):
        b = next(it)
        state, m = (bundle.local_step(state, b) if lr_resize is None
                    else bundle.local_step(state, b, lr_resize))
        out.append(float(m["loss"]))
        since += 1
        if since >= local_steps_at(ls, t):
            since = 0
            rounds += 1
            state = bundle.sync(state)
            if rounds == resize_round:
                state = elastic.resize_state(state, new_w)
                bundle = build(run, WorkerSet.of(new_w))
                it.resize(new_w)
                lr_resize = new_w / W0
    return state, np.array(out)


@pytest.mark.parametrize("optimizer", ["sgd", "lars"])
@pytest.mark.parametrize("ls_kw", [dict(), dict(sync_compression="ef_sign")],
                         ids=["none", "ef_sign"])
def test_elastic_resize_matches_fresh_run(optimizer, ls_kw):
    """A mid-run shrink W=4 -> 2 through fit's elastic path equals the
    port's fresh-run oracle bit for bit, and the reference's elastic fit
    within 1e-5 (losses and buckets)."""
    steps, H, resize_round, new_w = 16, 2, 3, 2
    jrun, run = make_runs(H=H, steps=steps, optimizer=optimizer,
                          controller=dict(kind="elastic"), **ls_kw)
    data = quad_data()
    p0 = params0()
    ref, ref_losses = _oracle(run, data, p0=p0, resize_round=resize_round,
                              new_w=new_w, steps=steps)
    be = LocalBackend(W0, device="cpu", build_fn=quad_builder())
    ctl = tctl.ElasticController(run, resize_at={resize_round: new_w})
    state, hist, summary = ttrain.fit(run, ShardedBatches(data, W0, B),
                                      backend=be, controller=ctl,
                                      num_steps=steps, seed=0, params0=p0,
                                      log=quiet)
    assert summary["resizes"] == 1
    assert be.worker_set.num_workers == new_w
    assert state.params.buckets[0].shape[0] == new_w
    assert_buffers_equal(ref, state)
    np.testing.assert_array_equal(losses(hist), ref_losses)

    jbe = JLocalBackend(W0, build_fn=j_quad_builder())
    jc = jctl.ElasticController(jrun, resize_at={resize_round: new_w})
    jstate, jhist, jsum = jtrain.fit(jrun, JBatches(data, W0, B), backend=jbe,
                                     controller=jc, num_steps=steps, seed=0,
                                     log=quiet)
    assert jsum["resizes"] == 1
    np.testing.assert_allclose(losses(hist), losses(jhist), rtol=RTOL)
    assert_buffers_close(state, jstate)


def test_schedule_block_steps_runtime_knob():
    """The runtime ``block_steps`` knob (the demotion actuator) changes the
    cadence from the next round and leaves the config as it was."""
    ls = tcb.LocalSGDConfig(local_steps=2, block_steps=1)
    c = DynamicSchedule(ls, lambda t: 1)
    assert [c.advance(t) for t in range(4)] == [2, 2, 2, 2]
    c.block_steps = 2
    assert [c.advance(t) for t in range(4, 8)] == [1, 2, 1, 2]
    assert c.cfg.block_steps == 1


# ---------------------------------------------------------------------------
# the elastic policy on report streams
# ---------------------------------------------------------------------------

def _delta(d):
    topo = d.topology.describe() if d.topology is not None else None
    return (d.h, d.compression, d.batch_scale, d.lr_scale, d.workers,
            d.demote, d.promote, d.block_steps, topo)


@pytest.mark.parametrize("ls_kw", [dict(), dict(sync_compression="ef_sign"),
                                   dict(block_steps=2)],
                         ids=["flat", "anchored", "blocked"])
def test_elastic_policy_matches_reference_on_streams(ls_kw):
    """One skew / by-id stream (a straggler, its recovery, a second one, a
    resize) into both packages' policies: every delta and every
    ``decisions`` record equal."""
    jrun, trun = make_runs(H=2, controller=dict(kind="elastic"), **ls_kw)
    resize_at = {3: 2, 9: 4}
    jc = jctl.ElasticController(jrun, resize_at=resize_at)
    tc = tctl.ElasticController(trun, resize_at=resize_at)
    assert tc.can_block == jc.can_block
    assert _delta(tc.plan_delta(0)) == _delta(jc.plan_delta(0))
    slow = {1: 2, 2: 2, 3: 2, 4: 2, 5: None, 6: None, 7: None, 8: 1, 9: 1,
            10: 1, 11: None, 12: None}
    for r in range(1, 13):
        by_id = {i: 0.01 + (0.05 if slow[r] == i else 0.0) for i in range(4)}
        st = {"num_workers": 4, "worker_step_s_by_id": by_id}
        if slow[r] is not None:
            st.update(worker_step_skew=2.0, worker_slowest=slow[r])
        else:
            st.update(worker_step_skew=0.0, worker_slowest=0)
        reps = [pkg.RoundReport(round=r, step=2 * r, h=2, loss=1.0,
                                stats=dict(st)) for pkg in (jctl, tctl)]
        jc.update(reps[0])
        tc.update(reps[1])
        assert _delta(tc.plan_delta(2 * r + 1)) == \
            _delta(jc.plan_delta(2 * r + 1)), r
        assert tc.decisions == jc.decisions, r
    assert tc.demoted == jc.demoted


def test_demotion_not_scheduled_for_anchored_configs():
    """Compression / global momentum cannot serve block syncs: the policy
    still demotes the worker in the census but switches no topology."""
    _, run = make_runs(H=2, sync_compression="ef_sign",
                       controller=dict(kind="elastic"))
    ctl = tctl.ElasticController(run)
    assert not ctl.can_block
    stats = {"worker_step_skew": 2.0, "worker_slowest": 1, "num_workers": 4}
    for r in (1, 2):
        ctl.update(tctl.RoundReport(round=r, step=2 * r, h=2, loss=1.0,
                                    stats=stats))
    delta = ctl.plan_delta(4)
    assert delta.demote == 1
    assert delta.topology is None and delta.block_steps is None


# ---------------------------------------------------------------------------
# the simulated straggler -> skew gauge -> demotion -> promotion back
# ---------------------------------------------------------------------------

def _simulated_pair(tmp_path, steps, *, recover_every=0):
    """The same simulated-straggler run through both packages: (port
    records, reference records, port tracer, reference tracer, port
    backend, port summary, port history, reference history)."""
    jrun, run = make_runs(H=2, steps=steps, controller=dict(kind="elastic"))
    data = quad_data()
    out = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            be = JSimulatedBackend(4, latency_s={2: 0.05},
                                   build_fn=j_quad_builder())
            tracer = JTracer(metrics=JMetrics())
        else:
            be = SimulatedBackend(4, latency_s={2: 0.05}, device="cpu",
                                  build_fn=quad_builder())
            tracer = ttrace.Tracer(metrics=tmetrics.MetricsRegistry())

        def recover(state, be=be):          # eval hook: the straggler heals
            be.latency_s.clear()
            return {}

        kw = dict(eval_fn=recover, eval_every=recover_every) \
            if recover_every else {}
        jsonl = tmp_path / f"{pkg}.jsonl"
        if pkg == "ref":
            _, hist, summary = jtrain.fit(
                jrun, JBatches(data, 4, B), backend=be, num_steps=steps,
                seed=0, telemetry_path=str(jsonl), tracer=tracer, log=quiet,
                **kw)
        else:
            _, hist, summary = ttrain.fit(
                run, ShardedBatches(data, 4, B), backend=be, num_steps=steps,
                seed=0, params0=params0(), telemetry_path=str(jsonl),
                tracer=tracer, log=quiet, **kw)
        recs = [json.loads(l) for l in open(jsonl)]
        out.append((recs, tracer, be, summary, hist))
    (jrecs, jtr, _, jsum, jhist), (recs, tr, be, summary, hist) = out
    # the same records, key for key; the decision fields equal
    assert [sorted(r) for r in recs] == [sorted(r) for r in jrecs]
    for r, j in zip(recs, jrecs):
        for k in ("round", "step", "h", "num_workers", "worker_step_s",
                  "worker_step_skew", "worker_slowest", "worker_step_s_by_id",
                  "next_h", "topology", "next_workers", "demote", "promote",
                  "decisions"):
            assert r.get(k) == j.get(k), (r["round"], k)
        np.testing.assert_allclose(r["loss"], j["loss"], rtol=RTOL)
    np.testing.assert_allclose(losses(hist), losses(jhist), rtol=RTOL)
    assert summary["topology"] == jsum["topology"]
    assert summary["comm_rounds"] == jsum["comm_rounds"]
    assert summary["backend"] == jsum["backend"]
    for name in ("controller", "resize"):
        spans = [s.attrs for s in tr.spans if s.name == name]
        jspans = [s.attrs for s in jtr.spans if s.name == name]
        assert spans == jspans, name
    return recs, tr, be, summary


def test_simulated_backend_skew_and_demotion(tmp_path):
    """Injected latency makes the skew gauge nonzero, the elastic policy
    demotes the straggler at round ``skew_patience`` (the reference's
    round, JSONL and trace decision stream), post-demotion skew is 0, the
    plan goes hierarchical with block syncs."""
    recs, tr, be, summary = _simulated_pair(tmp_path, 24)
    cc = tcb.ControllerConfig()
    pre = [r for r in recs if "demote" not in r and r["round"] <= 2]
    post = [r for r in recs if r["round"] > 2]
    assert all(r["worker_step_skew"] > cc.skew_threshold for r in pre)
    demoted = [r for r in recs if "demote" in r]
    assert len(demoted) == 1 and demoted[0]["demote"] == 2
    assert demoted[0]["round"] == cc.skew_patience
    assert all(r["worker_step_skew"] == 0.0 for r in post)
    assert be.worker_set.demoted == (2,)
    assert be.worker_step_times(h=1) == [be.base_step_s] * 3
    assert summary["topology"].startswith("hierarchical")
    assert summary["comm_rounds"]["block"] > 0
    spans = [s for s in tr.spans if s.name == "controller"
             and s.attrs.get("demote") is not None]
    assert len(spans) == 1
    assert spans[0].attrs["decisions"]["straggler"]["demote"] == 2
    assert be.round_seconds(h=1, scope="block") == pytest.approx(
        be.base_step_s)
    assert be.round_seconds(h=1, scope="global") == pytest.approx(
        be.base_step_s + 0.05)


def test_simulated_backend_promotion_back(tmp_path):
    """Clearing the latency mid-run (an eval hook) makes the by-id census
    report recovery; after ``skew_patience`` clean rounds the worker is
    promoted back at the reference's round: census, flat topology and
    cadence restored."""
    recs, tr, be, summary = _simulated_pair(tmp_path, 40, recover_every=10)
    demoted = [r for r in recs if "demote" in r]
    promoted = [r for r in recs if "promote" in r]
    assert len(demoted) == 1 and demoted[0]["demote"] == 2
    assert len(promoted) == 1 and promoted[0]["promote"] == 2
    assert promoted[0]["step"] > 10
    assert be.worker_set.demoted == ()
    assert be.worker_step_times(h=1) == [be.base_step_s] * 4
    assert summary["topology"] == "flat"
    post = [r for r in recs if r["round"] > promoted[0]["round"]]
    assert post and all(r["topology"] == "flat" for r in post)
    assert all("worker_step_s_by_id" in r for r in recs)
    spans = [s for s in tr.spans if s.name == "controller"
             and s.attrs.get("promote") is not None]
    assert len(spans) == 1
    assert spans[0].attrs["decisions"]["recovered"] == {
        "promote": 2, "restored": True}


# ---------------------------------------------------------------------------
# the acceptance run: W = 4 -> 2 -> 4, resident state carried through
# ---------------------------------------------------------------------------

def test_elastic_w4_2_4_acceptance(tmp_path):
    """Two resizes with the state carried on the bus: the decision stream,
    W-independent sync boundaries, convergence, the ledger's per-worker-set
    pricing equal to the reference's, the resize spans, and the losses
    within 1e-5 of the reference's."""
    steps = 40
    jrun, run = make_runs(H=2, steps=steps, controller=dict(kind="elastic"))
    data = quad_data()
    resize_at = {4: 2, 9: 4}
    be = LocalBackend(4, device="cpu", build_fn=quad_builder())
    tr = ttrace.Tracer()
    state, hist, summary = ttrain.fit(
        run, ShardedBatches(data, 4, B), backend=be,
        controller=tctl.ElasticController(run, resize_at=resize_at),
        num_steps=steps, seed=0, params0=params0(),
        telemetry_path=str(tmp_path / "t.jsonl"), tracer=tr, log=quiet)
    jbe = JLocalBackend(4, build_fn=j_quad_builder())
    jstate, jhist, jsum = jtrain.fit(
        jrun, JBatches(data, 4, B), backend=jbe,
        controller=jctl.ElasticController(jrun, resize_at=resize_at),
        num_steps=steps, seed=0, telemetry_path=str(tmp_path / "j.jsonl"),
        log=quiet)
    assert summary["resizes"] == jsum["resizes"] == 2
    assert flatbuf.is_bucket_state(state.params)
    assert state.params.buckets[0].shape[0] == 4
    wsets = summary["ledger"]["worker_sets"]
    assert set(wsets) == {"W=2", "W=4"} and wsets["W=2"]["rounds"] >= 3
    assert wsets["W=2"]["bytes_per_round"] < wsets["W=4"]["bytes_per_round"]
    assert wsets == jsum["ledger"]["worker_sets"]
    recs = [json.loads(l) for l in open(tmp_path / "t.jsonl")]
    assert [r["next_workers"] for r in recs if "next_workers" in r] == [2, 4]
    assert [r["step"] for r in recs] == list(range(1, steps, 2))
    assert all(r["h"] == 2 for r in recs)
    assert hist[-1]["loss"] < 0.1 * hist[0]["loss"]
    rs = [s for s in tr.spans if s.name == "resize"]
    assert [(s.attrs["from_workers"], s.attrs["to_workers"]) for s in rs] == \
        [(4, 2), (2, 4)]
    assert all(s.dur_s is not None and s.dur_s >= 0 for s in rs)
    np.testing.assert_allclose(losses(hist), losses(jhist), rtol=RTOL)
    assert_buffers_close(state, jstate)


def test_resize_needs_a_resizable_data_iterator():
    _, run = make_runs(H=2, steps=4, controller=dict(kind="elastic"))
    data = ShardedBatches(quad_data(), 4, B)
    with pytest.raises(RuntimeError, match="resizable data iterator"):
        ttrain.fit(run, (b for b in data),
                   backend=LocalBackend(4, device="cpu",
                                        build_fn=quad_builder()),
                   controller=tctl.ElasticController(run, resize_at={1: 2}),
                   num_steps=4, params0=params0(), log=quiet)


# ---------------------------------------------------------------------------
# backends: distributed gating, make_backend, no card, the CLI
# ---------------------------------------------------------------------------

def test_distributed_backend_gating(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    be = make_backend("distributed", 4)
    assert be.kind == "distributed" and be.worker_set == WorkerSet.of(4)
    be.demote(1)
    assert be.worker_set.demoted == (1,)
    _, run = make_runs()
    with pytest.raises(RuntimeError, match="coordinator|multi-process"):
        be.build(run)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1234")
    assert make_backend("distributed", 2).coordinator_address == "localhost:1234"
    with pytest.raises(RuntimeError, match="coordinator|multi-process"):
        make_backend("distributed", 2).build(run)


_TWO_PROCESSES = textwrap.dedent("""
    import json, socket, sys
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    def rank(r, port, out):
        torch.set_num_threads(1)
        from repro_torch import configs
        from repro_torch.backend import make_backend
        from repro_torch.configs import base as tcb
        from repro_torch.core.syncplan import PlanDelta
        from repro_torch.data.partition import ShardedBatches
        from repro_torch.data.synthetic import lm_examples, markov_lm
        from repro_torch.launch import train as ttrain
        from repro_torch.models import base as mbase
        import torch.distributed as dist
        be = make_backend("distributed", 4, backend="gloo", device="cpu",
                          coordinator_address=f"localhost:{port}",
                          process_id=r, num_processes=2)
        run = tcb.RunConfig(
            model=configs.get_smoke("paper-lm"),
            shape=tcb.InputShape("t", 16, 8, "train"),
            local_sgd=tcb.LocalSGDConfig(local_steps=1,
                                         sync_compression="ef_sign",
                                         wire_pack=True))
        bundle = be.build(run)
        data = lm_examples(markov_lm(vocab=512, num_seqs=16, seq_len=16))
        p0 = mbase.materialize(bundle.specs, torch.Generator().manual_seed(0),
                               "cpu")
        state = bundle.init(p0)
        state, metrics = bundle.local_step(state, next(iter(
            ShardedBatches(data, 4, 2))))
        state = bundle.sync(state)
        got = {"rows": list(state.params.buckets[0].shape),
               "workers": list(bundle.worker_ids),
               "loss": float(metrics["loss"]),
               "param_sum": float(state.params.buckets[0].double().sum()),
               "totals": bundle.dist.describe()["totals"]}
        # a resize decision under fit: W 4 -> 2 after the first round
        class Resize:
            kind = "custom"
            def h_at(self, t): return 1
            def plan_delta(self, t): return PlanDelta(workers=2) if t else PlanDelta()
            def update(self, report): pass
            def batch_scale(self): return 1
            def compression(self): return None
        state, hist, summ = ttrain.fit(
            run, ShardedBatches(data, 4, 2), bundle=bundle, backend=be,
            num_steps=2, controller=Resize(), params0=p0, log=lambda *a: None)
        got["resize"] = {"resizes": summ["resizes"],
                         "rows": list(state.params.buckets[0].shape),
                         "workers": be.describe()["local_workers"],
                         "loss": [h["loss"] for h in hist],
                         "param_sum": float(state.params.buckets[0].double().sum()),
                         "worker_sets": sorted(summ["ledger"]["worker_sets"])}
        dist.destroy_process_group()
        open(f"{out}.{r}", "w").write(json.dumps(got))

    if __name__ == "__main__":
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        mp.spawn(rank, args=(port, sys.argv[1]), nprocs=2)
""")


def test_distributed_backend_two_processes_build_step_and_sync(tmp_path):
    """Two real ``gloo`` processes build paper-lm smoke at W=4 (two workers
    each), take a local step and a wire-packed EF-sign sync: both ranks
    end with the same synced model and the same loss, their sync gathered
    the payload and the scales; a resize decision under ``fit`` takes W
    4 -> 2 (one worker a rank), and both ranks agree after it."""
    script = tmp_path / "two.py"
    script.write_text(_TWO_PROCESSES)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(script), str(tmp_path / "r")],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = [json.loads((tmp_path / f"r.{r}").read_text()) for r in (0, 1)]
    assert [g["workers"] for g in got] == [[0, 1], [2, 3]]
    assert got[0]["rows"][0] == got[1]["rows"][0] == 2
    assert got[0]["loss"] == got[1]["loss"]
    assert got[0]["param_sum"] == got[1]["param_sum"]
    for g in got:
        assert g["totals"]["all_gather/global"]["calls"] == 2   # payload, scales
        assert "all_reduce/global" not in g["totals"]
        assert g["resize"]["resizes"] == 1
        assert g["resize"]["rows"][0] == 1          # W' / P workers a rank
        assert g["resize"]["worker_sets"] == ["W=2", "W=4"]
    assert [g["resize"]["workers"] for g in got] == [[0], [1]]
    assert got[0]["resize"]["loss"] == got[1]["resize"]["loss"]
    assert got[0]["resize"]["param_sum"] == got[1]["resize"]["param_sum"]


def test_distributed_refuses_up_front(monkeypatch):
    """NCCL with more ranks than cards (before init_process_group), a
    worker count the ranks do not divide, blocks that straddle ranks
    unevenly, and a resize to a W' that is not a multiple of the worker
    groups (before the census changes).  Within-worker layouts, resizes,
    demotion, the elastic controller and checkpoint_fn, refused until
    they were ported, go on to the build."""
    from repro_torch.backend.distributed import (DistributedBackend,
                                                 check_nccl_ranks)
    from repro_torch.sharding import layout as tlayout
    check_nccl_ranks("gloo", 4, 1)
    check_nccl_ranks("nccl", 2, 2)
    with pytest.raises(ValueError, match="one card a rank"):
        check_nccl_ranks("nccl", 4, 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    be = DistributedBackend(4, coordinator_address="localhost:1",
                            process_id=0, num_processes=2)
    with pytest.raises(ValueError, match="one card a rank"):
        be.ensure_initialized()
    with pytest.raises(ValueError, match="W % P"):
        tlayout.WorkerLayout(6, 4, 0)
    _, run = make_runs()
    # within-worker layouts are ported now: they build, and a backend that
    # splits workers over shard ranks gets as far as the coordinator
    tp = tlayout.train_layout(("data", "model"), worker_axes=("data",),
                              fsdp_axes=("model",))
    assert tp.rules["batch"] == ("model",) and tp.rules["heads"] == "model"
    fs = tlayout.fsdp_within_worker_layout(("data", "model"),
                                           worker_axes=("data",))
    assert fs.rules["embed"] == "model" and fs.rules["heads"] is None
    assert fs.with_sizes({"data": 2, "model": 2}).batch_split() == 2
    assert tlayout.WorkerLayout(4, 8, 5, within_worker_size=2).worker_ids == (2,)
    with pytest.raises(RuntimeError, match="coordinator"):
        DistributedBackend(4, within_worker_size=2).build(run)
    assert DistributedBackend(4, within_worker_size=2).mesh_layout(8).sizes == \
        {"data": 4, "model": 2}
    assert tlayout.WorkerLayout(8, 4, 1).block_ranks(4) == ((0, 1), (2, 3))
    assert tlayout.WorkerLayout(8, 2, 1).block_is_local(2)
    with pytest.raises(ValueError, match="unevenly"):
        tlayout.WorkerLayout(6, 2, 0).block_ranks(2)
    # resizes: W' a multiple of the worker groups, or ValueError before the
    # census changes (once built, a backend checks against its grid)
    be = DistributedBackend(4)
    be.collectives = type("C", (), {"layout": tlayout.WorkerLayout(4, 2, 0)})()
    with pytest.raises(ValueError, match="W' % G must be 0"):
        be.resize(run, 1)
    assert be.worker_set == WorkerSet.of(4)
    be.check_resize(2)
    # the elastic controller, demotion and checkpoint_fn are no longer
    # refused: fit goes on to the build (here: no coordinator)
    _, erun = make_runs(controller=dict(kind="elastic"))
    for kw in (dict(run=erun), dict(run=run, checkpoint_fn=lambda s, t: None)):
        be = DistributedBackend(4)
        be.demote(3)
        with pytest.raises(RuntimeError, match="coordinator"):
            ttrain.fit(kw.pop("run"), iter(()), backend=be, **kw)


def test_make_backend_kinds_and_no_card(monkeypatch):
    assert make_backend("local", 2, device="cpu").kind == "local"
    sim = make_backend("simulated", 2, device="cpu", latency_s={1: 0.1})
    assert sim.kind == "simulated" and sim.worker_step_times(h=2) == \
        pytest.approx([0.02, 0.22])
    assert sim.worker_times_by_id(h=1) == pytest.approx({0: 0.01, 1: 0.11})
    assert make_backend("distributed", 2).kind == "distributed"
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend("ray", 2)
    assert tbackend.LocalBackend is LocalBackend
    with pytest.raises(AttributeError):
        tbackend.Nope
    assert LocalBackend(2, device="cpu").worker_step_times() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_backend("simulated", 4)


def test_build_train_worker_set_seam():
    from repro_torch import configs as tconfigs
    from repro_torch.launch.steps import build_train
    run = tcb.RunConfig(model=tconfigs.get_smoke("paper-lm"))
    assert build_train(run, device="cpu").worker_set == WorkerSet.of(1)
    ws = WorkerSet.of(4).demote(2)
    b = build_train(run, worker_set=ws, device="cpu")
    assert b.num_workers == 4 and b.worker_set is ws
    assert b.sync_plan.num_workers == 4
    with pytest.raises(ValueError, match="disagrees"):
        build_train(run, num_workers=2, worker_set=ws, device="cpu")


def test_cli_simulated_straggler(capsys, tmp_path):
    """``--backend simulated --straggler-s 0.05 --controller elastic`` on
    paper-lm smoke: the last worker is demoted at round 2, the plan goes
    hierarchical, the JSONL carries the decision."""
    ttrain.main(["--smoke", "--device", "cpu", "--steps", "12", "--seq", "32",
                 "--local-batch", "2", "--backend", "simulated",
                 "--straggler-s", "0.05", "--controller", "elastic",
                 "--trace-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "'kind': 'simulated'" in out and "'demoted': [3]" in out
    assert "topology=hierarchical(block_size=2)" in out
    recs = [json.loads(l) for l in open(tmp_path / "telemetry.jsonl")]
    assert [r.get("demote") for r in recs] == [None, 3]
    assert recs[0]["worker_slowest"] == 3
