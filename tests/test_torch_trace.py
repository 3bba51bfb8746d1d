"""Port parity: the trace spine (``repro_torch.telemetry.{trace,export}``,
the ledger's seconds, the controller span and the traced ``fit``), the
reference's ``tests/test_trace.py`` case by case on the port, plus the
cross-package checks: ``config_hash`` of the same run equals the
reference's, and a traced smoke run's JSONL carries the reference's keys.

Timings are host seconds on the CPU here: the tests check structure and
arithmetic (stage seconds sum to the sync's, to rtol 1e-9 / 1e-6), never
a speed.  Tracing must be a pure observer: the traced trajectory equals
the untraced one bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jcb
from repro.data.partition import ShardedBatches as JBatches
from repro.launch import train as jtrain
from repro.launch.steps import build_train as jbuild
from repro.models import base as jmbase
from repro.telemetry import Tracer as JTracer
from repro.telemetry import export as jexport
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference
from repro_torch.core import flatbuf
from repro_torch.core import syncplan as splan
from repro_torch.core.local_sgd import make_local_sgd, needs_anchor
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import TrainBundle
from repro_torch.launch.steps import build_train as tbuild
from repro_torch.models.base import ParamSpec, ShapeDtype
from repro_torch.telemetry import export as texport
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry import trace as ttrace
from repro_torch.telemetry.ledger import CommsLedger

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]

W, D, C = 4, 6, 3


# ---------------------------------------------------------------------------
# Tracer / Span basics
# ---------------------------------------------------------------------------

def test_span_lifecycle_and_attrs():
    tr = ttrace.Tracer()
    assert tr.enabled
    with tr.span("round", step=0) as sp:
        sp.set(h=2)
        with tr.span("sync", scope="global") as inner:
            pass
    assert [s.name for s in tr.spans] == ["sync", "round"]  # finish order
    rd = tr.spans[1]
    assert rd.attrs == {"step": 0, "h": 2}
    assert rd.dur_s is not None and rd.dur_s >= 0
    assert rd.cat == "train" and tr.spans[0].cat == "sync"
    assert rd.ts_s <= inner.ts_s
    assert inner.ts_s + inner.dur_s <= rd.ts_s + rd.dur_s + 1e-6


def test_finish_is_idempotent_and_finish_attrs_land():
    tr = ttrace.Tracer()
    sp = tr.start("eval", step=3)
    tr.finish(sp, extra=1)
    n = len(tr.spans)
    tr.finish(sp)                       # double finish: no second append
    assert len(tr.spans) == n
    assert sp.attrs == {"step": 3, "extra": 1}


def test_null_tracer_is_inert():
    tr = ttrace.NULL
    assert not tr.enabled
    with tr.span("round", step=0) as sp:
        sp.set(h=2)                     # attr dropped, no error
        out = sp.fence(torch.ones(3))   # fence still returns the value
    assert torch.equal(out, torch.ones(3))
    assert tr.spans == [] and sp.attrs == {}
    assert tr.record("collective", 0.0, 1.0) is ttrace._NULL_SPAN


@pytest.mark.parametrize("fence", [False, True])
def test_fence_returns_value_and_leaves_cpu_values_alone(fence, monkeypatch):
    """The fence synchronizes only a card the value lives on: CPU tensors
    (and a state of them) never reach torch.cuda.synchronize."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(d))
    v = torch.arange(4.0)
    st = flatbuf.BucketState.pack({"w": torch.zeros(3)})
    tr = ttrace.Tracer(fence=fence)
    with tr.span("local_steps") as sp:
        assert sp.fence(v) is v
        assert sp.fence(st) is st
        assert sp.fence({"a": [v, None]}) is not None
    assert calls == []


def test_annotate_enters_a_profiler_range():
    """annotate=True wraps each span in record_function: the span's name
    appears among a CPU profile's events."""
    tr = ttrace.Tracer(annotate=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("sync"):
            torch.ones(8).sum()
    assert "sync" in {e.key for e in prof.key_averages()}
    with tr.span("eval"):               # no profiler running: no error
        pass
    assert [s.name for s in tr.spans] == ["sync", "eval"]


def test_record_appends_premeasured_interval():
    tr = ttrace.Tracer()
    sp = tr.record("collective", 1.0, 0.25, stage=0)
    assert sp.dur_s == 0.25 and sp.ts_s == 1.0
    assert tr.spans == [sp]


def test_span_names_and_categories_are_the_references():
    from repro.telemetry import trace as jtrace
    assert ttrace.SPAN_NAMES == jtrace.SPAN_NAMES
    assert ttrace.SPAN_CATEGORIES == jtrace.SPAN_CATEGORIES


# ---------------------------------------------------------------------------
# stage attribution: spans <-> ledger
# ---------------------------------------------------------------------------

def _layout():
    return flatbuf.build_layout({"w": ShapeDtype((D, C), torch.float32),
                                 "b": ShapeDtype((C,), torch.float32)})


def _plan(num_workers=W, compression="sign", **kw):
    return splan.make_sync_plan(_layout(), compression=compression,
                                num_workers=num_workers, anchored=True, **kw)


def _two_bucket_plan():
    """Stages of different sizes, so the byte weights differ."""
    lay = flatbuf.build_layout({"w": ShapeDtype((64, 32), torch.float32),
                                "b": ShapeDtype((3,), torch.bfloat16)})
    return splan.make_sync_plan(lay, compression="none", num_workers=W)


@pytest.mark.parametrize("mk", [_plan, _two_bucket_plan])
def test_sync_stage_spans_apportion_to_parent_total(mk):
    tr = ttrace.Tracer()
    plan = mk()
    parent = tr.start("sync", scope="global")
    tr.finish(parent)
    parent.dur_s = 0.5                  # pin for exact arithmetic
    stage_s = ttrace.sync_stage_spans(tr, plan, "global", parent)
    stages = plan.collective_stages("global")
    assert [i for i, _ in stage_s] == list(range(len(stages)))
    np.testing.assert_allclose(sum(s for _, s in stage_s), 0.5, rtol=1e-9)
    col = [s for s in tr.spans if s.name == "collective"]
    assert len(col) == len(stages)
    for i, sp in enumerate(col):
        assert sp.attrs["stage"] == i and sp.attrs["attributed"]
        assert sp.attrs["wire_bytes"] == stages[i].wire_bytes
    assert col[0].ts_s == parent.ts_s
    wb = [s.wire_bytes for s in stages]
    if max(wb) > min(wb):
        big, small = wb.index(max(wb)), wb.index(min(wb))
        assert stage_s[big][1] > stage_s[small][1]


def test_sync_stage_spans_disabled_or_unfinished():
    plan = _plan()
    assert ttrace.sync_stage_spans(ttrace.NULL, plan, "global",
                                   ttrace._NULL_SPAN) == []
    tr = ttrace.Tracer()
    open_span = tr.start("sync")        # dur_s is None
    assert ttrace.sync_stage_spans(tr, plan, "global", open_span) == []


@pytest.mark.parametrize("mk", [_plan, _two_bucket_plan])
def test_record_plan_seconds_apportioning_matches_spans(mk):
    """The ledger's stage_s split equals the trace's span split: the same
    stage ids and byte weights, both summing to the measured total."""
    plan = mk()
    led = CommsLedger()
    out = led.record_plan(step=4, level=2, h=2, plan=plan, seconds=0.8)
    assert out["sync_s"] == pytest.approx(0.8)
    rows = [e for e in led.entries if "stage_s" in e]
    assert [r["stage"] for r in rows] == \
        list(range(len(plan.collective_stages("global"))))
    np.testing.assert_allclose(sum(r["stage_s"] for r in rows), 0.8)
    tr = ttrace.Tracer()
    parent = tr.start("sync")
    tr.finish(parent)
    spans = ttrace.sync_stage_spans(tr, plan, "global", parent, seconds=0.8)
    for (sid, s), row in zip(spans, rows):
        assert sid == row["stage"]
        np.testing.assert_allclose(s, row["stage_s"], rtol=1e-9)
    assert led.summary()["sync_seconds"] == pytest.approx(0.8)
    # untimed rows carry no seconds, and the summary then has none
    led2 = CommsLedger()
    assert "sync_s" not in led2.record_plan(step=0, level=2, h=2, plan=plan)
    assert "sync_seconds" not in led2.summary()


def test_record_plan_seconds_match_reference_ledger():
    """The same stages priced with the same seconds give the reference
    ledger's rows (bytes and stage_s) on the reference's plan."""
    from repro.core import flatbuf as jflat
    from repro.core import syncplan as jsplan
    from repro.telemetry import CommsLedger as JLedger
    lay = jflat.build_layout({
        "w": jax.ShapeDtypeStruct((64, 32), np.float32),
        "b": jax.ShapeDtypeStruct((3,), jax.numpy.bfloat16)})
    jl = JLedger()
    jl.record_plan(step=3, level=2, h=2, num_workers=W, seconds=0.3,
                   plan=jsplan.make_sync_plan(lay, compression="none",
                                              num_workers=W))
    tl = CommsLedger()
    tl.record_plan(step=3, level=2, h=2, plan=_two_bucket_plan(), seconds=0.3)
    assert len(jl.entries) == len(tl.entries)
    for a, b in zip(jl.entries, tl.entries):
        assert a["bytes_on_wire"] == b["bytes_on_wire"]
        np.testing.assert_allclose(b["stage_s"], a["stage_s"], rtol=1e-12)
    assert tl.summary()["sync_seconds"] == pytest.approx(
        jl.summary()["sync_seconds"], rel=1e-12)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_exposition_format_and_cumulative_buckets():
    reg = tmetrics.MetricsRegistry()
    h = reg.histogram("step_time_seconds", "t", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    reg.counter("rounds_total", "r", labels=("scope",)) \
       .labels(scope="global").inc()
    reg.gauge("h", "h").set(8)
    text = reg.exposition()
    assert "# HELP repro_step_time_seconds t" in text
    assert "# TYPE repro_step_time_seconds histogram" in text
    assert 'repro_step_time_seconds_bucket{le="0.1"} 1' in text
    assert 'repro_step_time_seconds_bucket{le="1"} 2' in text
    assert 'repro_step_time_seconds_bucket{le="+Inf"} 3' in text
    assert "repro_step_time_seconds_count 3" in text
    assert 'repro_rounds_total{scope="global"} 1' in text
    assert "repro_h 8" in text


def test_observe_round_feeds_standard_set():
    reg = tmetrics.MetricsRegistry()
    tmetrics.observe_step(reg, 0.01)
    tmetrics.observe_round(reg, scope="global", h=4, wire_bytes=1000.0,
                           loss=0.5, round_s=0.2, sync_s=0.05,
                           stage_s=[(0, 0.03), (1, 0.02)])
    text = reg.exposition()
    for frag in ("repro_wire_bytes_total 1000", "repro_h 4",
                 'repro_rounds_total{scope="global"} 1',
                 'repro_stage_time_seconds{scope="global",stage="0"} 0.03',
                 "repro_worker_step_skew 0", "repro_loss 0.5"):
        assert frag in text, frag


# ---------------------------------------------------------------------------
# exporters + validators
# ---------------------------------------------------------------------------

def test_perfetto_trace_passes_chrome_validator():
    tr = ttrace.Tracer()
    with tr.span("round", step=0, h=2):
        with tr.span("sync", scope="global"):
            pass
    tr.start("eval")                    # left open: must be skipped
    obj = texport.perfetto_trace(tr, extra={"wall_s": 1.0})
    assert texport.validate_chrome_trace(obj) == []
    assert jexport.validate_chrome_trace(obj) == []     # the reference's gate
    assert len(obj["traceEvents"]) == 2
    ev = {e["name"]: e for e in obj["traceEvents"]}
    assert ev["round"]["ph"] == "X" and ev["round"]["args"]["h"] == 2
    assert ev["round"]["cat"] == "train"
    assert obj["otherData"] == {"wall_s": 1.0}
    assert ev["sync"]["ts"] >= ev["round"]["ts"]


def test_chrome_validator_catches_malformed():
    assert texport.validate_chrome_trace([]) != []
    assert texport.validate_chrome_trace({"traceEvents": [{}]}) != []
    bad = {"traceEvents": [{"name": "x", "ph": "X", "ts": 0.0,
                            "pid": 1, "tid": 0}]}        # X without dur
    assert any("dur" in e for e in texport.validate_chrome_trace(bad))
    neg = {"traceEvents": [{"name": "x", "ph": "X", "ts": 0.0, "dur": -1.0,
                            "pid": 1, "tid": 0, "args": []}]}
    errs = texport.validate_chrome_trace(neg)
    assert any("negative" in e for e in errs) and any("args" in e for e in errs)


def test_jsonl_validator():
    assert texport.JSONL_REQUIRED == jexport.JSONL_REQUIRED
    assert texport.JSONL_TRACED == jexport.JSONL_TRACED
    good = {k: 1 for k in texport.JSONL_REQUIRED}
    good["topology"] = "flat"
    assert texport.validate_round_jsonl([json.dumps(good)]) == []
    errs = texport.validate_round_jsonl([json.dumps(good)], traced=True)
    assert any("round_s" in e for e in errs)
    traced = dict(good, round_s=0.1, sync_s=0.05, stage_s={"0": 0.05})
    assert texport.validate_round_jsonl([json.dumps(traced)]) == []
    assert texport.validate_round_jsonl(
        [json.dumps(traced), json.dumps(good)]) != []
    bad = dict(traced, stage_s={"0": "fast"})
    assert any("stage_s" in e
               for e in texport.validate_round_jsonl([json.dumps(bad)]))
    missing = dict(good)
    missing.pop("wire_bytes")
    assert any("wire_bytes" in e
               for e in texport.validate_round_jsonl([json.dumps(missing)]))
    assert any("not JSON" in e for e in texport.validate_round_jsonl(["{"]))


def test_run_manifest_fields():
    run = _quad_run(steps=8)
    m = texport.run_manifest(run=run, plan=_plan(), device="cpu")
    assert m["schema"] == "repro_torch.run_manifest/1"
    assert m["config_hash"] == texport.config_hash(run)
    assert len(m["config_hash"]) == 16
    assert m["torch"] == torch.__version__ and m["cuda"] == torch.version.cuda
    assert m["device"] == "cpu" and m["device_count"] == 1
    assert m["plan"]["topology"] and m["plan"]["num_workers"] == W
    assert m["local_sgd"]["local_steps"] == run.local_sgd.local_steps
    assert "jax" not in m and "backend" not in m
    run2 = dataclasses.replace(run, steps=run.steps + 1)
    assert texport.config_hash(run2) != m["config_hash"]


def _paper_run(cb, cfg, **ls):
    # remat set in both packages: their defaults differ (the port's "none",
    # the reference's "block"; ROADMAP's kept differences)
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", 32, 8, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=2, post_local_switch=2, **ls),
        optim=cb.OptimConfig(base_lr=0.3, base_batch=8, lr_warmup_steps=2,
                             lr_decay_steps=(4,), grad_clip=1.0),
        controller=cb.ControllerConfig(kind="noise_adaptive", patience=1),
        steps=6, remat="none")


@pytest.mark.parametrize("arch,ls", [
    ("paper-lm", {}),
    ("paper-lm", {"sync_compression": "ef_sign", "block_steps": 1}),
    ("paper-lm-full", {"sync_topology": "hierarchical", "block_steps": 2}),
])
def test_config_hash_equals_reference(arch, ls):
    """The same run hashes the same in both packages (full width and
    smoke, with compression and Alg. 5)."""
    if arch == "paper-lm-full":
        jcfg, tcfg = jconfigs.get("paper-lm"), tconfigs.get("paper-lm")
    else:
        jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jr, tr_ = _paper_run(jcb, jcfg, **ls), _paper_run(tcb, tcfg, **ls)
    assert texport.config_hash(tr_) == jexport.config_hash(jr)
    assert texport.config_hash(tr_) != texport.config_hash(
        dataclasses.replace(tr_, seed=1))


# ---------------------------------------------------------------------------
# fit-level acceptance
# ---------------------------------------------------------------------------

QUAD_SPECS = {"w": ParamSpec((D, C), (None, None)),
              "b": ParamSpec((C,), (None,), init="zeros")}


def quad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {"xent": loss}


def quad_batches(seed=1, b=8):
    rng = np.random.default_rng(seed)
    while True:
        x = rng.standard_normal((W, b, D)).astype(np.float32)
        y = x @ (np.ones((D, C), np.float32) * 0.5) + 0.01 * rng.standard_normal(
            (W, b, C)).astype(np.float32)
        yield {"x": x, "y": y}


def _quad_run(H=2, steps=12, controller=None, **ls_kw):
    ls_kw.setdefault("sync_compression", "sign")
    return tcb.RunConfig(
        model=tcb.ModelConfig(name="quad", family="dense", citation=""),
        shape=tcb.InputShape("t", 8, W * 4, "train"),
        local_sgd=tcb.LocalSGDConfig(local_steps=H, local_momentum=0.9,
                                     nesterov=True, **ls_kw),
        optim=tcb.OptimConfig(base_lr=0.03, base_batch=W * 4, weight_decay=0.0,
                              lr_warmup_steps=0, lr_decay_steps=()),
        controller=controller or tcb.ControllerConfig(),
        steps=steps)


def _quad_bundle(run):
    cc = run.controller
    init, local_step, sync = make_local_sgd(
        run, quad_loss, num_workers=W, telemetry=cc.wants_telemetry,
        speculate_compression=cc.wants_speculation)
    layout = _layout()
    plan = splan.make_sync_plan(
        layout, num_workers=W,
        topology=splan.resolve_topology(run.local_sgd, W),
        compression=run.local_sgd.sync_compression,
        anchored=needs_anchor(run.local_sgd))
    return TrainBundle(cfg=run.model, run=run, num_workers=W,
                       specs=QUAD_SPECS, init=init, local_step=local_step,
                       sync=sync, device=torch.device("cpu"), layout=layout,
                       sync_plan=plan, telemetry=cc.wants_telemetry,
                       n_comp=layout.num_buckets)


def test_traced_fit_emits_validated_artifacts(tmp_path):
    """One traced fit gives a Perfetto trace whose per-stage sync spans
    carry the ledger's stage ids, a Prometheus exposition with the step
    and round series, the extended JSONL and the run manifest, all passing
    the validators; a checkpoint span per checkpoint_fn call."""
    steps = 12
    run = _quad_run(steps=steps)
    tr = ttrace.Tracer(metrics=tmetrics.MetricsRegistry())
    tlog = tmp_path / "telemetry.jsonl"
    saved = []
    state, hist, summary = ttrain.fit(
        run, quad_batches(), bundle=_quad_bundle(run), num_steps=steps,
        telemetry_path=str(tlog), tracer=tr,
        manifest_path=str(tmp_path / "manifest.json"),
        eval_every=4, eval_fn=lambda s: {"probe": 0.0},
        checkpoint_every=6, checkpoint_fn=lambda s, t: saved.append(t),
        log=lambda *a, **k: None)

    names = {s.name for s in tr.spans}
    assert {"round", "local_steps", "sync", "collective",
            "controller", "eval", "checkpoint"} <= names
    rounds = steps // run.local_sgd.local_steps
    assert sum(s.name == "round" for s in tr.spans) == rounds
    assert sum(s.name == "local_steps" for s in tr.spans) == steps
    assert saved == [5, 11]
    assert [s.attrs["step"] for s in tr.spans if s.name == "checkpoint"] == saved

    obj = texport.write_perfetto(str(tmp_path / "trace.json"), tr)
    assert texport.validate_chrome_trace(obj) == []
    col = [s for s in tr.spans if s.name == "collective"]
    n_stages = len({s.attrs["stage"] for s in col})
    assert n_stages >= 1
    assert summary["ledger"]["sync_rounds"] == rounds
    assert summary["ledger"]["sync_seconds"] > 0
    assert {s.attrs["stage"] for s in col} == set(range(n_stages))
    syncs = [s for s in tr.spans if s.name == "sync"]
    np.testing.assert_allclose(summary["ledger"]["sync_seconds"],
                               sum(s.dur_s for s in syncs), rtol=1e-9)

    text = texport.write_prometheus(str(tmp_path / "metrics.prom"), tr.metrics)
    assert f"repro_step_time_seconds_count {steps}" in text
    assert "repro_worker_step_skew 0" in text
    assert 'repro_sync_time_seconds_count{scope="global"} ' \
        f"{rounds}" in text

    recs = [json.loads(l) for l in tlog.read_text().splitlines()]
    assert len(recs) == rounds
    for r, sp in zip(recs, syncs):
        assert r["sync_s"] == sp.dur_s     # each round's sync_s IS its span
        assert r["round_s"] >= r["sync_s"]
        assert set(r["stage_s"]) == {str(i) for i in range(n_stages)}
        np.testing.assert_allclose(sum(r["stage_s"].values()), r["sync_s"],
                                   rtol=1e-6)
    assert texport.check_trace_dir(str(tmp_path)) == []
    assert summary["trace"] == {"spans": len(tr.spans), "fenced": False}


def test_check_trace_dir_reports_missing_and_bad(tmp_path):
    errs = texport.check_trace_dir(str(tmp_path))
    assert {"trace.json missing", "telemetry.jsonl missing",
            "manifest.json missing"} <= set(errs)
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": []}))
    (tmp_path / "telemetry.jsonl").write_text("{}\n")
    (tmp_path / "manifest.json").write_text("{}")
    errs = texport.check_trace_dir(str(tmp_path))
    assert "trace.json: no events recorded" in errs
    assert any("missing 'torch'" in e for e in errs)
    assert any("round_s" in e for e in errs)
    assert texport.main(["--check", str(tmp_path)]) == 1


def test_tracing_is_bitwise_noop(tmp_path):
    """fit with a fenced, annotating tracer (+ metrics + JSONL) against
    fit with no tracer: per-step losses and final buckets bit-equal."""
    steps = 8
    run = _quad_run(steps=steps)
    st_a, h_a, _ = ttrain.fit(run, quad_batches(), bundle=_quad_bundle(run),
                              num_steps=steps, log=lambda *a, **k: None)
    tr = ttrace.Tracer(fence=True, annotate=True,
                       metrics=tmetrics.MetricsRegistry())
    st_b, h_b, _ = ttrain.fit(run, quad_batches(), bundle=_quad_bundle(run),
                              num_steps=steps, tracer=tr,
                              telemetry_path=str(tmp_path / "t.jsonl"),
                              log=lambda *a, **k: None)
    assert tr.spans
    assert [h["loss"] for h in h_a] == [h["loss"] for h in h_b]
    for field in ("params", "momentum", "anchor"):
        for a, b in zip(getattr(st_a, field).buckets,
                        getattr(st_b, field).buckets):
            assert torch.equal(a, b)


def test_traced_paper_lm_fit_is_bitwise_noop():
    """The same on paper-lm smoke with EF-sign under noise_adaptive (which
    grows the batch to 8x): the traced run's losses and buckets equal the
    untraced run's bit for bit."""
    cfg = tconfigs.get_smoke("paper-lm")
    run = _paper_run(tcb, cfg, sync_compression="ef_sign")
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=32, seq_len=32))
    out = []
    for tracer in (None, ttrace.Tracer(fence=True, annotate=True,
                                       metrics=tmetrics.MetricsRegistry())):
        bundle = tbuild(run, num_workers=4, device="cpu")
        out.append(ttrain.fit(run, ShardedBatches(data, 4, 2), bundle=bundle,
                              tracer=tracer, log=lambda *a: None))
    (sa, ha, _), (sb, hb, sumb) = out
    assert [h["loss"] for h in ha] == [h["loss"] for h in hb]
    for a, b in zip(sa.params.buckets + sa.ef_memory.buckets,
                    sb.params.buckets + sb.ef_memory.buckets):
        assert torch.equal(a, b)
    assert sumb["trace"]["fenced"] and sumb["ledger"]["sync_seconds"] > 0


def test_traced_noise_adaptive_controller_spans(tmp_path):
    """Controller decision spans carry the emitted PlanDelta."""
    steps = 16
    run = _quad_run(H=2, steps=steps, sync_compression="ef_sign",
                    controller=tcb.ControllerConfig(kind="noise_adaptive",
                                                    patience=1, h_max=8,
                                                    err_budget=0.95))
    tr = ttrace.Tracer()
    ttrain.fit(run, quad_batches(), bundle=_quad_bundle(run), num_steps=steps,
               tracer=tr, log=lambda *a, **k: None)
    ctl = [s for s in tr.spans if s.name == "controller"]
    assert ctl and all(s.attrs["kind"] == "noise_adaptive" for s in ctl)
    for s in ctl:
        assert {"next_h", "compression", "batch_scale", "lr_scale",
                "decisions"} <= set(s.attrs)
    assert any(s.attrs["decisions"] for s in ctl)


def test_traced_jsonl_keys_equal_reference(tmp_path):
    """A traced paper-lm smoke run writes JSONL records with the
    reference's keys, round for round (noise_adaptive: telemetry, the
    decisions provenance and the seconds extension)."""
    data = lm_examples(markov_lm(vocab=512, num_seqs=32, seq_len=32))
    rj = _paper_run(jcb, jconfigs.get_smoke("paper-lm"))
    jb = jbuild(rj, num_workers=4, use_kernel=True)
    jb.local_step = jax.jit(jb.local_step)
    jb.sync = jax.jit(jb.sync, static_argnames=("group", "compression",
                                                 "plan", "scope"))
    jtrain.fit(rj, JBatches(data, 4, 2), bundle=jb, log=lambda *a: None,
               tracer=JTracer(), telemetry_path=str(tmp_path / "j.jsonl"))
    rt = _paper_run(tcb, tconfigs.get_smoke("paper-lm"))
    tb = tbuild(rt, num_workers=4, device="cpu")
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    ttrain.fit(rt, ShardedBatches(data, 4, 2), bundle=tb, log=lambda *a: None,
               params0=params_from_reference(jax.tree.map(np.asarray, p0), "cpu"),
               tracer=ttrace.Tracer(), telemetry_path=str(tmp_path / "t.jsonl"))
    jr = [json.loads(l) for l in (tmp_path / "j.jsonl").read_text().splitlines()]
    tr_ = [json.loads(l) for l in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert len(jr) == len(tr_) >= 2
    for a, b in zip(jr, tr_):
        assert set(b) == set(a)
        assert set(b["stage_s"]) == set(a["stage_s"])
    assert texport.validate_round_jsonl(
        (tmp_path / "t.jsonl").read_text().splitlines(), traced=True) == []
    assert (tmp_path / "t.jsonl.manifest.json").exists()


def test_trace_dir_cli_writes_a_valid_directory(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu --steps 4
    --trace-dir DIR`` writes a directory check_trace_dir accepts."""
    out = tmp_path / "traced"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "4", "--seq", "32", "--local-batch", "2",
         "--trace-dir", str(out)], capture_output=True, text=True, env=env,
        timeout=300)
    assert r.returncode == 0, r.stderr
    assert "trace:" in r.stdout
    assert texport.check_trace_dir(str(out)) == []
    m = json.loads((out / "manifest.json").read_text())
    assert m["device"] == "cpu" and m["model"] == "paper-lm-smoke"
    r = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.export",
                        "--check", str(out)], capture_output=True, text=True,
                       env=env, timeout=120)
    assert r.returncode == 0 and "valid" in r.stdout
