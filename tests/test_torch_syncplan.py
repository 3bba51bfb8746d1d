"""Port parity: sync plans and the comms ledger (repro_torch vs repro).

The same bucket layout is built in both packages — paper-lm smoke's one
f32 bucket, and a small tree of f32 and bf16 leaves that gives two
buckets, so the overlap topology's pipelined order differs from flat's —
and every plan is compared stage by stage: kind, scope, buckets,
compressor, group, reduce axes, coalescing, collectives and the
ring-model wire bytes.  Bytes are float64 sums of the same integer-valued
terms in the same order, so everything compares exactly.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jcb
from repro.core import flatbuf as jflat
from repro.core import syncplan as jsp
from repro.models import base as jmbase
from repro.models import lm as jlm
from repro.telemetry import ledger as jled
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tcb
from repro_torch.core import flatbuf as tflat
from repro_torch.core import syncplan as tsp
from repro_torch.models import base as tmbase
from repro_torch.models import lm as tlm
from repro_torch.telemetry import ledger as tled

W = 4
STAGE_FIELDS = ("kind", "scope", "buckets", "compression", "group",
                "reduce_axes", "wire_bytes", "collectives", "coalesced")
# two buckets (f32, bf16), leaves of ragged sizes
MIXED = {"a": ((3, 200), "float32"), "b": ((5, 7), "bfloat16"),
         "c": ((130,), "float32"), "d": ((40,), "bfloat16")}


def _layouts(which: str):
    """(reference layout, port layout) of one tree."""
    if which == "paper-lm":
        jspecs = jlm.param_specs(jconfigs.get_smoke("paper-lm"))
        tspecs = tlm.param_specs(tconfigs.get_smoke("paper-lm"))
        return (jflat.build_layout(jmbase.abstract(jspecs, jnp.float32),
                                   wd_mask=jmbase.norm_param_mask(jspecs)),
                tflat.build_layout(tmbase.abstract(tspecs, torch.float32),
                                   wd_mask=tmbase.norm_param_mask(tspecs)))
    jtree = {k: jax.ShapeDtypeStruct(s, jnp.dtype(d)) for k, (s, d) in MIXED.items()}
    ttree = {k: torch.empty(s, dtype=getattr(torch, d)) for k, (s, d) in MIXED.items()}
    return jflat.build_layout(jtree), tflat.build_layout(ttree)


def _stages(plan):
    return [tuple(getattr(s, f) for f in STAGE_FIELDS) for s in plan.stages]


TOPOLOGIES = {"flat": ("flat", ()), "hierarchical(2)": ("hierarchical", (2,)),
              "overlap()": ("overlap", ()), "overlap(2)": ("overlap", (2,))}


@pytest.mark.parametrize("tree", ["paper-lm", "mixed"])
@pytest.mark.parametrize("mode", ["none", "ef_sign"])
@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_plan_stages_match_reference(tree, mode, topo):
    """Stage by stage, with the anchored pack stages of a compressed
    sync; the plan's describe line and per-scope costs too."""
    jl, tl = _layouts(tree)
    assert tl.bucket_dtypes == jl.bucket_dtypes
    assert [tl.bucket_local_rows(b) for b in range(tl.num_buckets)] \
        == [jl.bucket_local_rows(b) for b in range(jl.num_buckets)]
    fn, args = TOPOLOGIES[topo]
    jp = jsp.make_sync_plan(jl, topology=getattr(jsp, fn)(*args),
                            compression=mode, num_workers=W)
    tp = tsp.make_sync_plan(tl, topology=getattr(tsp, fn)(*args),
                            compression=mode, num_workers=W)
    assert tp.topology.describe() == jp.topology.describe()
    assert tp.topology.has_block == jp.topology.has_block
    assert (tp.modes, tp.anchored) == (jp.modes, jp.anchored)
    assert _stages(tp) == _stages(jp)
    for scope in ("block", "global") if tp.topology.has_block else ("global",):
        assert tp.scope_cost(scope) == jp.scope_cost(scope)
        assert _stages(tp.with_modes(None)) == _stages(jp)
        assert [tuple(getattr(s, f) for f in STAGE_FIELDS)
                for s in tp.collective_stages(scope)] \
            == [tuple(getattr(s, f) for f in STAGE_FIELDS)
                for s in jp.collective_stages(scope)]
    if not tp.topology.has_block:
        with pytest.raises(ValueError):
            tp.schedule("block")
    # the same table, the wire-pack and coalesce flags included
    assert tp.describe() == jp.describe()


def test_overlap_pipelines_the_global_stages():
    """Two buckets: overlap issues bucket 1's collective before bucket 0's
    apply; the stage sets are flat's."""
    _, tl = _layouts("mixed")
    assert tl.num_buckets == 2
    fp = tsp.make_sync_plan(tl, num_workers=W, compression="ef_sign")
    op = tsp.make_sync_plan(tl, num_workers=W, compression="ef_sign",
                            topology=tsp.overlap())
    order = lambda p: [(s.kind, s.buckets[0]) for s in p.schedule("global")]
    assert order(fp) == [("pack", 0), ("collective", 0), ("apply", 0),
                         ("pack", 1), ("collective", 1), ("apply", 1)]
    assert order(op) == [("pack", 0), ("collective", 0), ("pack", 1),
                         ("collective", 1), ("apply", 0), ("apply", 1)]
    assert sorted(fp.stages, key=repr) == sorted(op.stages, key=repr)


def test_plan_rewrites_match_reference():
    """with_modes / with_topology recompile as the reference's do; a no-op
    rewrite returns the same plan object."""
    jl, tl = _layouts("mixed")
    jp = jsp.make_sync_plan(jl, num_workers=W, compression="none",
                            anchored=True)
    tp = tsp.make_sync_plan(tl, num_workers=W, compression="none",
                            anchored=True)
    assert tp.with_modes(None) is tp and tp.with_modes("none") is tp
    assert tp.with_topology(None) is tp and tp.with_topology(tsp.flat()) is tp
    for modes in ("sign", ("ef_sign", "none"), ("sign",)):
        assert _stages(tp.with_modes(modes)) == _stages(jp.with_modes(modes))
    for fn, args in TOPOLOGIES.values():
        assert _stages(tp.with_topology(getattr(tsp, fn)(*args))) \
            == _stages(jp.with_topology(getattr(jsp, fn)(*args)))
    with pytest.raises(ValueError):
        tp.with_modes(("sign", "none", "sign"))
    with pytest.raises(ValueError):
        tsp.hierarchical(0)


@pytest.mark.parametrize("workers", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("block_steps", [1, 2])
@pytest.mark.parametrize("kind", ["auto", "flat", "hierarchical", "overlap"])
def test_resolve_topology_matches_reference(kind, block_steps, workers):
    jls = jcb.LocalSGDConfig(block_steps=block_steps, sync_topology=kind)
    tls = tcb.LocalSGDConfig(block_steps=block_steps, sync_topology=kind)
    assert tsp.default_block_size(workers) == jsp.default_block_size(workers)
    if kind == "flat" and block_steps > 1:
        with pytest.raises(ValueError):
            jsp.resolve_topology(jls, workers)
        with pytest.raises(ValueError, match="block_steps > 1"):
            tsp.resolve_topology(tls, workers)
        return
    jt, tt = jsp.resolve_topology(jls, workers), tsp.resolve_topology(tls, workers)
    assert (tt.kind, tt.block_size) == (jt.kind, jt.block_size)


def test_unported_plan_options_raise():
    """The wire pack and coalescing build plans with their flags (their
    stages: ``tests/test_torch_wire_pack.py``); an unknown topology still
    raises."""
    jl, tl = _layouts("mixed")
    for kw in (dict(wire_pack=True), dict(coalesce=True),
               dict(wire_pack=True, coalesce=True)):
        tp = tsp.make_sync_plan(tl, num_workers=W, compression="sign", **kw)
        jp = jsp.make_sync_plan(jl, num_workers=W, compression="sign", **kw)
        assert (tp.wire_pack, tp.coalesce) == (jp.wire_pack, jp.coalesce)
        assert _stages(tp) == _stages(jp) and tp.describe() == jp.describe()
    with pytest.raises(ValueError, match="unknown sync_topology"):
        tsp.resolve_topology(
            tcb.LocalSGDConfig(sync_topology="ring"), W)   # type: ignore


@pytest.mark.parametrize("tree", ["paper-lm", "mixed"])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("modes,wire_pack", [(None, False), ("sign", False),
                                             ("ef_sign", True),
                                             (("sign", "none"), True)])
def test_analytic_sync_cost_matches_reference(tree, group, modes, wire_pack):
    jl, tl = _layouts(tree)
    if isinstance(modes, tuple):
        modes = modes[:tl.num_buckets]               # one mode per bucket
    jc = jled.analytic_sync_cost(jl, group=group, modes=modes, wire_pack=wire_pack)
    tc = tled.analytic_sync_cost(tl, group=group, modes=modes, wire_pack=wire_pack)
    assert (tc.bytes_on_wire, tc.collectives, tc.source) \
        == (jc.bytes_on_wire, jc.collectives, jc.source)


def _record_rounds(sp, led, layout, plan_kw):
    """The rounds of a hierarchical run with H^b = 2 and a flat plan's
    round, by record_plan, and one hand-priced round by record."""
    hp = sp.make_sync_plan(layout, num_workers=W,
                           topology=sp.hierarchical(2), **plan_kw)
    fp = sp.make_sync_plan(layout, num_workers=W, **plan_kw)
    out = []
    for step, level in ((0, 1), (1, 2), (2, 1), (3, 2), (7, 1), (11, 2)):
        scope = "block" if level == 1 else "global"
        out.append(led.record_plan(step=step, level=level, h=4, plan=hp,
                                   scope=scope, num_workers=W))
    out.append(led.record_plan(step=12, level=2, h=4, plan=fp, num_workers=2))
    return out


@pytest.mark.parametrize("tree", ["paper-lm", "mixed"])
@pytest.mark.parametrize("mode", ["none", "ef_sign"])
def test_comms_ledger_matches_reference(tree, mode):
    """The same rounds recorded in both ledgers give the same rows and the
    same summary (the reference's rows without clock fields: no seconds
    were given)."""
    jl, tl = _layouts(tree)
    # hierarchical block stages need the mean sync: the global stages
    # may compress
    kw = dict(compression=mode, anchored=mode != "none")
    jl_, tl_ = jled.CommsLedger(), tled.CommsLedger()
    jr = _record_rounds(jsp, jl_, jl, kw)
    tr = _record_rounds(tsp, tl_, tl, kw)
    assert tr == jr
    jc = jled.analytic_sync_cost(jl, group=W, modes=mode)
    tc = tled.analytic_sync_cost(tl, group=W, modes=mode)
    assert tl_.record(step=13, level=2, h=1, cost=tc, compression=(mode,)) \
        == jl_.record(step=13, level=2, h=1, cost=jc, compression=(mode,))
    assert tl_.entries == jl_.entries
    ts, js = tl_.summary(), jl_.summary()
    assert ts == js
    assert ts["sync_rounds"] == 8 and set(ts["topologies"]) == {
        "hierarchical/block", "hierarchical/global", "flat/global",
        "round/global"}
    assert tl_.total_bytes(level=1) == jl_.total_bytes(level=1)
    assert tled.CommsLedger().summary() == jled.CommsLedger().summary()


def test_full_width_ledger_bytes():
    """paper-lm at full width, W=4, blocks of 2: a block round is one
    all-reduce over 2 workers of the 478.2 MB bucket, a global one over 4
    (1.5x the bucket, 717.3 MB); 3 + 3 rounds total 7.5 buckets, 3,586.7
    MB (6 flat rounds: 9 buckets, 4,304.1 MB)."""
    specs = tlm.param_specs(tconfigs.get("paper-lm"))
    layout = tflat.build_layout(tmbase.abstract(specs, torch.float32),
                                wd_mask=tmbase.norm_param_mask(specs))
    bucket = layout.bucket_bytes(0)
    assert layout.num_buckets == 1 and bucket == 934_040 * 512
    plan = tsp.make_sync_plan(layout, num_workers=W,
                              topology=tsp.resolve_topology(
                                  tcb.LocalSGDConfig(block_steps=2), W))
    assert plan.scope_cost("block") == (bucket, 1)
    assert plan.scope_cost("global") == (1.5 * bucket, 1)
    led = tled.CommsLedger()
    for step, level in ((0, 1), (1, 2), (2, 1), (3, 2), (7, 1), (11, 2)):
        led.record_plan(step=step, level=level, h=4, plan=plan,
                        scope="block" if level == 1 else "global")
    topo = led.summary()["topologies"]
    assert topo["hierarchical/block"]["bytes_per_round"] == bucket
    assert topo["hierarchical/global"]["bytes_per_round"] == 1.5 * bucket
    assert led.total_bytes() == 7.5 * bucket
    assert round(led.total_bytes() / 1e6, 1) == 3586.7
    assert 6 * tsp.make_sync_plan(layout, num_workers=W).scope_cost()[0] \
        == 9 * bucket
