"""Port parity: the adaptive sync controllers and the controller loop of
``fit`` (repro_torch vs repro).

* Policies on synthetic ``RoundReport`` streams: the same stream goes
  into the reference's policy and the port's, and every emitted
  ``PlanDelta`` (and ``decisions`` provenance) must be EQUAL — host
  floats, the same arithmetic in the same order.  The streams are the
  reference tests' (``tests/test_controller.py``,
  ``tests/test_noise_controller.py``): the golden traces, the
  re-baselining after a doubling, the single-spike hysteresis, the
  unmeasured slots and the cap handoff floor.
* ``fit`` with each of the five policies on paper-lm smoke against the
  reference's resident ``fit`` (``use_kernel=True``, jitted by the test)
  at ``noise_eta = 0``, from the same weights and batches: per-round
  decisions, comm rounds and ledger bytes EQUAL; per-step loss rtol 1e-4
  (sign / EF-sign included: a flip of a delta within rounding of 0 moves
  the loss far less); the sensors the decisions read (diversity,
  compression error) rtol 1e-3, and each decision's margin to its
  threshold is checked to be wider than that.
* ``local_step(..., lr_scale)``: 0.5 against the reference's and against
  half the base lr at tolerance; ``None`` bit for bit the two-argument
  call.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jcb
from repro.core import controller as jctl
from repro.data.partition import ShardedBatches as JBatches
from repro.launch import train as jtrain
from repro.launch.steps import build_train as jbuild
from repro.models import base as jmbase
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference
from repro_torch.core import controller as tctl
from repro_torch.core import syncplan as tsp
from repro_torch.core.schedule import local_steps_at
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import build_train as tbuild

torch.set_num_threads(2)

W = 4
DELTA_FIELDS = ("h", "compression", "batch_scale", "lr_scale", "workers",
                "demote", "promote", "block_steps")


# ---------------------------------------------------------------------------
# policies on synthetic RoundReport streams
# ---------------------------------------------------------------------------

def _runs(cc_kw=None, *, H=1, mode="none", gb=W * 4, **ls_kw):
    """The same RunConfig in both packages (quad-sized: only the
    controller, schedule and batch fields matter to a policy)."""
    out = []
    for cb in (jcb, tcb):
        out.append(cb.RunConfig(
            model=cb.ModelConfig(name="quad", family="dense", citation=""),
            shape=cb.InputShape("t", 8, gb, "train"),
            local_sgd=cb.LocalSGDConfig(local_steps=H, sync_compression=mode,
                                        **ls_kw),
            optim=cb.OptimConfig(base_lr=0.03, base_batch=gb),
            controller=cb.ControllerConfig(**(cc_kw or {}))))
    return out


def _report(pkg, i, *, loss=1.0, diversity=None, signal=None, noise=None,
            workers=W, errs=None, measured=None):
    st = {}
    if diversity is not None:
        st["diversity"] = diversity
    if signal is not None:
        st.update(signal_sq=signal, noise_sq=noise, num_workers=workers)
    if errs is not None:
        st.update(comp_rel_err=list(errs),
                  comp_measured=True if measured is None else measured)
    return pkg.RoundReport(round=i, step=i, h=1, loss=loss, stats=st)


def _delta(d):
    topo = d.topology.describe() if d.topology is not None else None
    return tuple(getattr(d, f) for f in DELTA_FIELDS) + (topo,)


def _drive(cc_kw, stream, *, n_comp=1, **run_kw):
    """Feed one stream of report kwargs to both policies; every delta and
    provenance must be equal.  Returns the port's controller and its
    per-round (h, batch_scale, lr_scale, compression)."""
    jrun, trun = _runs(cc_kw, **run_kw)
    jc = jctl.make_controller(jrun, n_comp=n_comp)
    tc = tctl.make_controller(trun, n_comp=n_comp)
    assert type(tc).__name__ == type(jc).__name__ and tc.kind == jc.kind
    assert _delta(tc.plan_delta(0)) == _delta(jc.plan_delta(0))
    trace = []
    for i, kw in enumerate(stream):
        jc.update(_report(jctl, i, **kw))
        tc.update(_report(tctl, i, **kw))
        assert _delta(tc.plan_delta(i + 1)) == _delta(jc.plan_delta(i + 1)), i
        assert getattr(tc, "decisions", None) == getattr(jc, "decisions", None), i
        assert tc.lr_scale() == jc.lr_scale()
        trace.append((tc.h_at(i), tc.batch_scale(), tc.lr_scale(),
                      tc.compression()))
    return tc, trace


def test_static_policy_is_the_schedule():
    """Static: h_at is local_steps_at (post-local switch, warmup), the
    delta rewrites nothing and apply returns the SAME plan object."""
    _, trace = _drive({}, [dict(loss=1.0, diversity=0.01)] * 3,
                      H=4, post_local_switch=6, warmup_kind="linear",
                      warmup_steps=4)
    _, trun = _runs({}, H=4, post_local_switch=6, warmup_kind="linear",
                    warmup_steps=4)
    c = tctl.make_controller(trun)
    assert [c.h_at(t) for t in range(20)] == \
        [local_steps_at(trun.local_sgd, t) for t in range(20)]
    assert [t[1:] for t in trace] == [(1, 1.0, None)] * 3
    layout = tbuild(tcb.RunConfig(model=tconfigs.get_smoke("paper-lm")),
                    num_workers=W, device="cpu").layout
    plan = tsp.make_sync_plan(layout, num_workers=W)
    assert c.plan_delta(0).apply(plan) is plan
    assert tsp.PlanDelta().apply(plan) is plan


def test_diversity_h_stream():
    """EMA under ``low`` doubles H up to h_max, over ``high`` halves it down
    to h_min."""
    divs = [0.05, 0.05, 0.05, 0.05, 0.05, 0.9, 0.9, 2.0, 2.0, 2.0, 2.0, 0.3]
    _, trace = _drive(dict(kind="diversity_h", h_max=8, h_min=1, ema=0.5),
                      [dict(diversity=d) for d in divs], H=2)
    assert [t[0] for t in trace] == [4, 8, 8, 8, 8, 8, 4, 2, 1, 1, 1, 1]


@pytest.mark.parametrize("case", ["plateaus", "rebaseline"])
def test_adaptive_batch_stream(case):
    """The reference's two golden scale traces: two plateaus, each needing
    a fresh baseline; and no second doubling while the post-doubling loss
    keeps improving (the re-baselining after a doubling)."""
    if case == "plateaus":
        cc = dict(kind="adaptive_batch", tol=0.01, patience=2, ema=0.0)
        losses = [1.0, 0.5, 0.499, 0.499, 0.499, 0.499, 0.499]
        want = [1, 1, 1, 2, 2, 2, 4]
    else:
        cc = dict(kind="adaptive_batch", ema=0.9, tol=0.01, patience=1,
                  max_batch_scale=8)
        losses = [1.0, 1.0, 0.9, 0.8, 0.7, 0.6]
        want = [1, 2, 2, 2, 2, 2]
    c, trace = _drive(cc, [dict(loss=v) for v in losses])
    assert [t[1] for t in trace] == want
    if case == "rebaseline":
        assert c.best is not None and c.best < 0.95


def test_auto_compress_single_spike_does_not_escalate():
    """Symmetric streak hysteresis: one over-budget round does not move a
    signed bucket to ef_sign; two consecutive do."""
    stream = [[0.4, 0.9], [0.4, 0.9], [0.9, 0.4], [0.4, 0.4], [0.9, 0.4],
              [0.9, 0.4]]
    want = [("none", "none"), ("sign", "none"), ("sign", "none"),
            ("sign", "sign"), ("sign", "sign"), ("ef_sign", "sign")]
    _, trace = _drive(dict(kind="auto_compress", err_budget=0.5, patience=2),
                      [dict(errs=e) for e in stream], n_comp=2, mode="ef_sign")
    assert [t[3] for t in trace] == want


def test_ladder_ignores_unmeasured_slots():
    """A slot reading exactly 0.0 neither advances nor resets; a round with
    comp_measured False advances nothing."""
    _, trace = _drive(dict(kind="auto_compress", err_budget=0.5, patience=2),
                      [dict(errs=[0.4, 0.0])] * 4, n_comp=2, mode="ef_sign")
    assert trace[-1][3] == ("sign", "none")
    _, trace = _drive(dict(kind="auto_compress", err_budget=0.5, patience=1),
                      [dict(errs=[0.4], measured=False)], mode="ef_sign")
    assert trace[-1][3] == ("none",)
    lad = tctl._CompressionLadder(2, err_budget=0.5, patience=2)
    for _ in range(4):
        lad.step({"comp_rel_err": [0.4, 0.0], "comp_measured": True})
    assert lad.modes == ["sign", "none"]


def _na(**kw):
    cc = dict(kind="noise_adaptive", ema=0.0, patience=1, low=0.1, high=0.5,
              h_max=8, max_batch_scale=2, noise_grow=1.0, lr_cap_decay=0.5,
              lr_scale_min=0.2, err_budget=0.5)
    cc.update(kw)
    return cc


def test_noise_adaptive_golden_trace():
    """One stream drives all four axes (global batch 16, W=4): the
    reference's golden (h, scale, lr_scale, modes) after every round."""
    stream = [dict(diversity=0.05, signal=1.0, noise=8.0, errs=[0.4, 0.4]),
              dict(diversity=0.05, signal=1.0, noise=8.0, errs=[0.9, 0.4]),
              dict(diversity=0.6, signal=8.0, noise=0.1, errs=[0.4, 0.9])]
    c, trace = _drive(_na(), stream, n_comp=2, mode="ef_sign")
    assert trace == [(2, 2, 1.0, ("sign", "sign")),
                     (4, 2, 0.5, ("ef_sign", "sign")),
                     (2, 2, 0.5, ("ef_sign", "ef_sign"))]
    d = c.plan_delta(3)
    assert (d.h, d.batch_scale, d.lr_scale, d.compression) == \
        (2, 2, 0.5, ("ef_sign", "ef_sign"))


def test_noise_adaptive_batch_growth_and_provenance():
    c, trace = _drive(_na(max_batch_scale=4),
                      [dict(signal=1.0, noise=8.0), dict(signal=8.0, noise=0.1)],
                      mode="ef_sign")
    assert [t[1] for t in trace] == [2, 2]
    assert c.grow_streak == 0 and "batch" not in c.decisions
    assert "b_noise" in c.decisions


def test_noise_adaptive_cap_handoff_floor():
    """At the batch cap, noise trips decay lr_scale down to the floor and
    then stop actuating."""
    c, trace = _drive(_na(max_batch_scale=1, lr_scale_min=0.3),
                      [dict(signal=1.0, noise=8.0)] * 3, mode="ef_sign")
    assert [t[2] for t in trace] == [0.5, 0.3, 0.3]
    assert "lr" not in c.decisions


def test_noise_adaptive_ema_crossing():
    """H reacts to the EMA crossing the band edges, not to raw samples."""
    _, trace = _drive(_na(ema=0.5),
                      [dict(diversity=d) for d in (0.3, 0.05, 0.05, 0.05, 2.0)],
                      mode="ef_sign")
    assert [t[0] for t in trace] == [1, 1, 1, 2, 1]


def test_noise_adaptive_without_ef_config():
    """Without ef_sign the compression axis stays off; the others run."""
    c, trace = _drive(dict(kind="noise_adaptive", ema=0.0, patience=1),
                      [dict(diversity=0.01, signal=1.0, noise=8.0,
                            errs=[0.1, 0.1])], n_comp=2)
    assert trace == [(2, 2, 1.0, None)]


def test_registry_and_refusals():
    """make_controller's kinds; auto_compress needs the EF allocation;
    elastic is the ElasticController (the reference's class) from the
    registry, builds through build_train and runs from the CLI; an unknown
    kind is a ValueError."""
    for kind, cls in (("static", "StaticController"),
                      ("diversity_h", "DiversityHController"),
                      ("adaptive_batch", "AdaptiveBatchController"),
                      ("noise_adaptive", "NoiseAdaptiveController"),
                      ("elastic", "ElasticController")):
        got = tctl.make_controller(_runs(dict(kind=kind))[1])
        assert type(got).__name__ == cls
        assert type(jctl.make_controller(_runs(dict(kind=kind))[0])).__name__ == cls
    assert isinstance(tctl.make_controller(_runs()[1]), tctl.SyncController)
    with pytest.raises(ValueError, match="ef_sign"):
        tctl.make_controller(_runs(dict(kind="auto_compress"))[1])
    elastic = _runs(dict(kind="elastic"))[1]
    assert isinstance(tctl.make_controller(elastic), tctl.ElasticController)
    smoke = dataclasses.replace(elastic, model=tconfigs.get_smoke("paper-lm"))
    bundle = tbuild(smoke, num_workers=2, device="cpu")
    assert bundle.telemetry and bundle.worker_set.num_workers == 2
    ttrain.main(["--smoke", "--device", "cpu", "--steps", "1", "--seq", "16",
                 "--local-batch", "1", "--controller", "elastic"])
    bogus = dataclasses.replace(
        elastic, controller=dataclasses.replace(elastic.controller, kind="x"))
    with pytest.raises(ValueError, match="unknown controller"):
        tctl.make_controller(bogus)


def test_fit_refuses_worker_set_deltas():
    """A custom policy that resizes workers (W=4 -> 2 after the first
    round): fit actuates it through the default backend — the state folds
    to 2 workers, the data re-partitions, the LR halves, the ledger prices
    the rounds per worker set — instead of ignoring the decision."""
    class Resize(tctl.StaticController):
        def plan_delta(self, step):
            d = super().plan_delta(step)
            return dataclasses.replace(d, workers=2) if step else d

    run = _fit_run(tcb, tconfigs.get_smoke("paper-lm"), {}, "none", H=1)
    data = lm_examples(markov_lm(vocab=512, num_seqs=16, seq_len=S))
    it = ShardedBatches(data, W, B)
    logs = []
    state, hist, summary = ttrain.fit(
        run, it, bundle=tbuild(run, num_workers=W, device="cpu"),
        controller=Resize(run), num_steps=3, log=logs.append)
    assert summary["resizes"] == 1 and it.W == 2
    assert summary["backend"]["num_workers"] == 2
    assert state.params.buckets[0].shape[0] == 2
    assert summary["controller"]["lr_scale"] == 0.5
    assert set(summary["ledger"]["worker_sets"]) == {"W=2", "W=4"}
    assert logs == ["resize: W 4 -> 2 at step 0 (lr x0.5)"]
    assert all(np.isfinite(h["loss"]) for h in hist)


# ---------------------------------------------------------------------------
# fit with each policy against the reference's fit
# ---------------------------------------------------------------------------

B, S, STEPS = 2, 32, 8
# (controller kwargs, sync compression, H): each policy actuates within
# the run at these settings (asserted below)
KINDS = {
    "static": (dict(telemetry=True), "none", 2),
    "diversity_h": (dict(kind="diversity_h", h_max=8), "none", 4),
    "adaptive_batch": (dict(kind="adaptive_batch", patience=1, tol=0.05,
                            max_batch_scale=2), "none", 1),
    "auto_compress": (dict(kind="auto_compress", patience=1, err_budget=0.95),
                      "ef_sign", 2),
    "noise_adaptive": (dict(kind="noise_adaptive", patience=1, err_budget=0.95,
                            max_batch_scale=2, h_max=4), "ef_sign", 2),
}
NEXT = ("next_h", "next_compression", "next_batch_scale", "next_lr_scale",
        "wire_bytes", "collectives", "cum_wire_bytes", "topology", "round",
        "step", "h", "rounds", "round_steps", "num_workers", "comp_measured")


def _fit_run(cb, cfg, cc, mode, H):
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", S, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=H, sync_compression=mode),
        optim=cb.OptimConfig(base_lr=0.3, base_batch=W * B, lr_warmup_steps=2,
                             grad_clip=1.0),
        controller=cb.ControllerConfig(**cc), steps=STEPS)


def _margins(recs, run):
    """Relative distance of each sensor a decision read to its threshold,
    over a run's JSONL records: the diversity EMA to ``low`` / ``high``,
    each compression error to ``err_budget``, the critical-batch EMA to
    ``noise_grow`` x the total batch."""
    cc, out, ema, scale = run.controller, [], None, 1
    for r in recs:
        if cc.kind in ("diversity_h", "noise_adaptive"):
            d = r["diversity"]
            ema = d if ema is None else cc.ema * ema + (1 - cc.ema) * d
            out += [abs(ema - t) / t for t in (cc.low, cc.high)]
        if cc.kind in ("auto_compress", "noise_adaptive") and r["comp_measured"]:
            out += [abs(e - cc.err_budget) / cc.err_budget
                    for e in r["comp_rel_err"]]
        bn = r.get("decisions", {}).get("b_noise")
        if bn:
            total = cc.noise_grow * run.shape.global_batch * scale
            out.append(abs(bn["ema"] - total) / total)
        scale = r["next_batch_scale"]
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_fit_with_controller_matches_reference(kind, tmp_path):
    cc, mode, H = KINDS[kind]
    data = lm_examples(markov_lm(vocab=512, num_seqs=64, seq_len=S))
    rj = _fit_run(jcb, jconfigs.get_smoke("paper-lm"), cc, mode, H)
    jb = jbuild(rj, num_workers=W, use_kernel=True)
    jb.local_step = jax.jit(jb.local_step)
    jb.sync = jax.jit(jb.sync, static_argnames=("group", "compression",
                                                 "plan", "scope"))
    _, jhist, jsum = jtrain.fit(rj, JBatches(data, W, B), bundle=jb, seed=0,
                                telemetry_path=str(tmp_path / "j.jsonl"),
                                log=lambda *a: None)
    rt = _fit_run(tcb, tconfigs.get_smoke("paper-lm"), cc, mode, H)
    tb = tbuild(rt, num_workers=W, device="cpu")
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    _, thist, tsum = ttrain.fit(
        rt, ShardedBatches(data, W, B), bundle=tb,
        params0=params_from_reference(jax.tree.map(np.asarray, p0), "cpu"),
        telemetry_path=str(tmp_path / "t.jsonl"), log=lambda *a: None)
    jrec = [json.loads(x) for x in (tmp_path / "j.jsonl").read_text().splitlines()]
    trec = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().splitlines()]

    assert len(trec) == len(jrec) == tsum["comm_rounds"]["global"] > 1
    for j, t in zip(jrec, trec, strict=True):
        # the JSONL schema is the reference's untraced one
        assert set(t) == set(j), set(t) ^ set(j)
        for k in NEXT:
            assert t[k] == j[k], (k, t[k], j[k])
        if "decisions" in j:
            assert set(t["decisions"]) == set(j["decisions"])
            for k in ("compression", "h", "batch", "lr"):
                if k in j["decisions"]:
                    got = {f: v for f, v in t["decisions"][k].items()
                           if not isinstance(v, float) and f != "comp_rel_err"}
                    assert got == {f: v for f, v in j["decisions"][k].items()
                                   if not isinstance(v, float)
                                   and f != "comp_rel_err"}, k
        np.testing.assert_allclose(t["diversity"], j["diversity"], rtol=1e-3)
        np.testing.assert_allclose(t["comp_rel_err"], j["comp_rel_err"],
                                   rtol=1e-3)
    margins = _margins(trec, rt)
    assert all(m > 1e-2 for m in margins), margins
    assert [h["synced"] for h in thist] == [h["synced"] for h in jhist]
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-4)
    assert tsum["comm_rounds"] == jsum["comm_rounds"]
    assert tsum["controller"] == jsum["controller"]
    for k in ("sync_rounds", "wire_bytes", "collectives", "scaling"):
        assert tsum["ledger"][k] == jsum["ledger"][k], k
    rows = lambda s: {k: {f: v[f] for f in ("rounds", "wire_bytes",
                                            "collectives")}
                      for k, v in s["ledger"]["topologies"].items()}
    assert rows(tsum) == rows(jsum)
    # every adaptive policy actuated within the run
    first = {k: trec[0][k] for k in ("next_h", "next_compression",
                                     "next_batch_scale", "next_lr_scale")}
    start = {"next_h": H, "next_compression": "none" if mode == "ef_sign"
             else "config", "next_batch_scale": 1, "next_lr_scale": 1.0}
    moved = any(r[k] != start[k] for r in trec for k in start)
    assert moved == (kind != "static"), (first, start)


# ---------------------------------------------------------------------------
# local_step's lr_scale
# ---------------------------------------------------------------------------

def _one_step(cb, cfg, lr):
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", S, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=1),
        optim=cb.OptimConfig(base_lr=lr, base_batch=W * B, grad_clip=1.0,
                             weight_decay=1e-2))


def test_local_step_lr_scale():
    """lr_scale=0.5: the port against the reference's resident step at the
    same scale (1e-5 x the buffer's largest entry) and against a step at
    half the base lr (rtol 1e-6); None: bit for bit the two-argument call."""
    data = lm_examples(markov_lm(vocab=512, num_seqs=16, seq_len=S))
    batch = next(ShardedBatches(data, W, B))
    rj = _one_step(jcb, jconfigs.get_smoke("paper-lm"), 0.3)
    jb = jbuild(rj, num_workers=W, use_kernel=True)
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    js, _ = jax.jit(jb.local_step)(jb.init(jax.random.PRNGKey(1), p0),
                                   {k: jnp.asarray(v) for k, v in batch.items()},
                                   0.5)
    params0 = params_from_reference(jax.tree.map(np.asarray, p0), "cpu")
    out = {}
    for name, lr, scale in (("half", 0.3, 0.5), ("base_half", 0.15, None),
                            ("none", 0.3, None), ("two_arg", 0.3, "two")):
        tb = tbuild(_one_step(tcb, tconfigs.get_smoke("paper-lm"), lr),
                    num_workers=W, device="cpu")
        ts = tb.init(params0)
        ts, m = (tb.local_step(ts, batch) if scale == "two"
                 else tb.local_step(ts, batch, scale))
        out[name] = (ts.params.buckets[0], ts.momentum.buckets[0], m["lr"])
    ref = np.asarray(js.params.buckets[0])
    d = np.abs(out["half"][0].numpy() - ref).max()
    assert d <= 1e-5 * np.abs(ref).max(), d
    assert out["half"][2] == float(np.float32(0.3) * np.float32(0.5))
    for a, b in zip(out["half"][:2], out["base_half"][:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    for a, b in zip(out["none"][:2], out["two_arg"][:2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not torch.equal(out["half"][0], out["none"][0])
