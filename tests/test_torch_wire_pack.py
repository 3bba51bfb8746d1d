"""Port parity: the 1-bit wire format and coalesced syncs (repro_torch vs
repro), on the CPU.

* The bucket pack: the ``uint8`` payload byte for byte equal to the
  reference's ``pack_bucket_signs`` on the same numpy bucket (exact zeros
  included: sign(0) packs as +1), the per-leaf scales within rtol 1e-6
  (float32 row sums in another order), the unpack within 1e-6.
* ``pack_signs`` / ``unpack_signs`` along every axis of odd-length
  tensors (padded to whole bytes).
* The port's packed mean, bucket by bucket, on the ``mixed`` tree's
  buckets (an f32 and a bf16 bucket of ragged leaves) against the
  reference's flat and coalesced ones, padding masked after: within
  1e-6.
* Plans: ``describe()`` and every stage equal for flat, hierarchical and
  overlap, with ``coalesce`` on and off, and the stage wire bytes equal
  to ``analytic_sync_cost(wire_pack=True)``.
* ``sign`` / ``ef_sign`` trajectories with ``wire_pack=True`` (W=4, paper-
  lm smoke, 4 rounds of H=2, telemetry on under EF-sign) against the
  reference's resident path.  Every sync runs a second time on a port
  state that holds the reference's own buffers, and its output is held
  at 1e-6 x the largest entry on every element, the telemetry at rtol
  1e-5; the free-running port's sign flips of every sync are counted
  and printed, and its end state held to the unpacked trajectory test's
  tolerance (see the test).
"""
import dataclasses

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
from repro.core import syncplan as jsp
from repro.launch.steps import build_train as jbuild
from repro.models import base as jmbase
from repro.models import lm as jlm
from repro.telemetry import export as jexport
from repro.telemetry import ledger as jled
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference
from repro_torch.core import compression as tcomp
from repro_torch.core import flatbuf as tflat
from repro_torch.core import local_sgd as tsgd
from repro_torch.core import syncplan as tsp
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.launch.steps import build_train as tbuild
from repro_torch.models import base as tmbase
from repro_torch.models import lm as tlm
from repro_torch.telemetry import export as texport
from repro_torch.telemetry import ledger as tled
from repro_torch.telemetry import stats as tstats

torch.set_num_threads(2)

W, B, S, H, ROUNDS = 4, 2, 32, 2, 4
FIELDS = ("params", "momentum", "anchor", "ef_memory")
MIXED = {"a": ((3, 200), "float32"), "b": ((5, 7), "bfloat16"),
         "c": ((130,), "float32"), "d": ((40,), "bfloat16")}


def _layouts(which: str):
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


def _bucket(layout, b, seed, zeros=True):
    """A (W, rows, 128) f32 bucket of sign*scale-like values with exact
    zeros (a few true elements and all the padding)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(W, layout.bucket_rows[b], 128)).astype(np.float32)
    if zeros:
        x[rng.random(x.shape) < 0.01] = 0.0
    return x * tflat.valid_mask(layout, b)[None]


@pytest.mark.parametrize("tree", ["paper-lm", "mixed"])
def test_bucket_payload_byte_equal_to_reference(tree):
    jl, tl = _layouts(tree)
    for b in range(tl.num_buckets):
        x = _bucket(tl, b, seed=b)
        seg = jflat.row_segments(jl, b)
        sizes = jflat.segment_sizes(jl, b)
        tp, ts = tcomp.pack_bucket_signs(torch.from_numpy(x), torch.from_numpy(seg),
                                         torch.from_numpy(sizes))
        assert tp.dtype == torch.uint8 and tuple(tp.shape) == (W, x.shape[1], 16)
        jp, js = [], []
        for w in range(W):
            p, s = jcomp.pack_bucket_signs(jnp.asarray(x[w]), jnp.asarray(seg),
                                           jnp.asarray(sizes))
            jp.append(np.asarray(p))
            js.append(np.asarray(s))
        assert np.array_equal(tp.numpy(), np.stack(jp))
        np.testing.assert_allclose(ts.numpy(), np.stack(js), rtol=1e-6, atol=0)
        got = tcomp.unpack_bucket_signs(tp, ts, torch.from_numpy(seg))
        want = jcomp.unpack_bucket_signs(jnp.stack([jnp.asarray(p) for p in jp]),
                                         jnp.stack([jnp.asarray(s) for s in js]),
                                         jnp.asarray(seg))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
        # bit i of byte k is element 8k + i; a zero packs as +1
        bits = (tp[..., None] >> torch.arange(8, dtype=torch.uint8)) & 1
        assert torch.equal(bits.reshape(x.shape).bool(), torch.from_numpy(x >= 0))


@pytest.mark.parametrize("shape", [(3, 13), (2, 5, 13), (2, 9, 3, 7), (4, 1)])
def test_pack_signs_odd_lengths(shape):
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(np.float32)
    x.reshape(-1)[::5] = 0.0
    for axis in range(1, len(shape)):
        jp, js = jcomp.pack_signs(jnp.asarray(x), axis=axis)
        tp, ts = tcomp.pack_signs(torch.from_numpy(x), axis=axis)
        assert tp.shape[-1] == -(-shape[axis] // 8)
        assert np.array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
        got = tcomp.unpack_signs(tp, ts, shape[1:], axis=axis)
        assert tuple(got.shape) == shape
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jcomp.unpack_signs(jp, js, shape[1:], axis=axis)),
            rtol=1e-6)
    tree = {"x": torch.from_numpy(x), "y": torch.zeros(9, dtype=torch.bfloat16)}
    jtree = {"x": jnp.asarray(x), "y": jnp.zeros(9, jnp.bfloat16)}
    assert tcomp.compressed_bytes(tree) == jcomp.compressed_bytes(jtree)
    assert tcomp.dense_bytes(tree) == jcomp.dense_bytes(jtree)


def test_packed_means_match_reference_on_mixed_buckets():
    """The port's meshless packed mean, bucket by bucket, on the two
    buckets of the mixed tree (f32, bf16), against the reference's flat
    and coalesced ones (the coalesced gather only concatenates packed
    bytes), padding masked after, as ``sync`` does."""
    jl, tl = _layouts("mixed")
    xs = [_bucket(tl, b, seed=10 + b) for b in range(tl.num_buckets)]
    flat = [tsgd._packed_mean_flat_local(torch.from_numpy(x), tl, b)
            for b, x in enumerate(xs)]
    jcoal = jsgd._packed_mean_coalesced_local([jnp.asarray(x) for x in xs], jl, (0, 1))
    for b, x in enumerate(xs):
        want = np.asarray(jsgd._packed_mean_flat_local(jnp.asarray(x), jl, b))
        np.testing.assert_allclose(flat[b].numpy(), want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(flat[b].numpy(), np.asarray(jcoal[b]), rtol=1e-6,
                                   atol=1e-7)
        # the unpack fills padding with +scale; the mask zeroes it again
        masked = tflat.mask_padding(tl, b, flat[b]).numpy()
        np.testing.assert_array_equal(masked * (1 - tflat.valid_mask(tl, b)), 0.0)
        np.testing.assert_allclose(
            masked, np.asarray(jflat.mask_padding(jl, b, jnp.asarray(want))),
            rtol=1e-6, atol=1e-7)


STAGE_FIELDS = ("kind", "scope", "buckets", "compression", "group",
                "reduce_axes", "wire_bytes", "collectives", "coalesced")
TOPOLOGIES = {"flat": ("flat", ()), "hierarchical(2)": ("hierarchical", (2,)),
              "overlap()": ("overlap", ()), "overlap(2)": ("overlap", (2,))}


@pytest.mark.parametrize("tree", ["paper-lm", "mixed"])
@pytest.mark.parametrize("coalesce", [False, True])
@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_wire_pack_plans_match_reference(tree, coalesce, topo):
    """Every stage and the describe table; the global round's bytes equal
    the ledger's analytic cost with ``wire_pack``; a per-bucket mode
    rewrite (one bucket dense) recompiles as the reference's does."""
    jl, tl = _layouts(tree)
    fn, args = TOPOLOGIES[topo]
    for mode in ("sign", "ef_sign", "none"):
        kw = dict(compression=mode, num_workers=W, wire_pack=True, coalesce=coalesce)
        jp = jsp.make_sync_plan(jl, topology=getattr(jsp, fn)(*args), **kw)
        tp = tsp.make_sync_plan(tl, topology=getattr(tsp, fn)(*args), **kw)
        assert (tp.wire_pack, tp.coalesce) == (jp.wire_pack, jp.coalesce) == (True, coalesce)
        st = lambda p: [tuple(getattr(s, f) for f in STAGE_FIELDS) for s in p.stages]
        assert st(tp) == st(jp)
        assert tp.describe() == jp.describe()
        for scope in ("block", "global") if tp.topology.has_block else ("global",):
            assert tp.scope_cost(scope) == jp.scope_cost(scope)
        cost = tled.analytic_sync_cost(tl, group=W, modes=tp.modes, wire_pack=True)
        jcost = jled.analytic_sync_cost(jl, group=W, modes=jp.modes, wire_pack=True)
        assert (cost.bytes_on_wire, cost.collectives) == tp.scope_cost("global") \
            == (jcost.bytes_on_wire, jcost.collectives)
        if mode != "none":
            assert all(s.collectives == 2 for s in tp.collective_stages("global"))
            # the payload: 1 bit an element, 1/32 of the f32 all-reduce's
            # bucket, plus one f32 scale a leaf
            rows = sum(tl.bucket_local_rows(b) for b in range(tl.num_buckets))
            leaves = len(tl.slots)
            assert tp.scope_cost("global")[0] == (W - 1) / W * W * (rows * 16 + leaves * 4)
        if tl.num_buckets > 1:
            modes = ("sign", "none")
            assert st(tp.with_modes(modes)) == st(jp.with_modes(modes))
    # the run manifest carries the plan's flags as the reference's does
    m = texport.run_manifest(plan=tp, device="cpu")["plan"]
    jm = jexport.run_manifest(plan=jp)["plan"]
    assert set(m) == set(jm)
    assert {k: m[k] for k in ("coalesce", "wire_pack", "describe")} \
        == {k: jm[k] for k in ("coalesce", "wire_pack", "describe")}


def test_coalesced_stage_sync_matches_reference():
    """A hand-made plan whose one global collective stage coalesces both
    buckets of the mixed tree (the port's layouts never give two buckets
    of one dtype, so ``make_sync_plan`` never does): both packages' sync
    on the same EF-sign state.  The port packs each bucket of the stage
    on its own, so its result equals the per-bucket plan's bit for bit."""
    run = lambda cb: cb.RunConfig(
        model=tconfigs.get_smoke("paper-lm") if cb is tcb else jconfigs.get_smoke("paper-lm"),
        local_sgd=cb.LocalSGDConfig(sync_compression="ef_sign", wire_pack=True,
                                    sync_coalesce=True),
        controller=cb.ControllerConfig(telemetry=True))
    ttree = {k: torch.zeros(s, dtype=getattr(torch, d)) for k, (s, d) in MIXED.items()}
    jtree = {k: jnp.zeros(s, jnp.dtype(d)) for k, (s, d) in MIXED.items()}
    tinit, _, tsync = tsgd.make_local_sgd(run(tcb), lambda p, b: None, num_workers=W,
                                          telemetry=True)
    jinit, _, jsync = jsgd.make_local_sgd(run(jcb), lambda p, b: None, num_workers=W,
                                          use_kernel=True, telemetry=True)
    gen = np.random.default_rng(5)

    def fresh():
        ts = tinit(ttree)
        for f in ("params", "anchor", "ef_memory"):
            for b, x in enumerate(getattr(ts, f).buckets):
                x.copy_(tflat.mask_padding(ts.params.layout, b, torch.from_numpy(
                    gen.normal(size=x.shape).astype(np.float32))))
        return ts

    ts = fresh()
    js = jinit(jax.random.PRNGKey(0), jtree)
    # copies: the port's sync updates its buffers in place.  The port's EF
    # memory is float32 in every bucket: the reference gets it as float32,
    # the dtype its own first EF-sign sync gives it
    js = dataclasses.replace(js, **{
        f: getattr(js, f).with_buckets(tuple(
            jnp.asarray(np.array(x.float().numpy(), copy=True)).astype(
                jnp.float32 if x.dtype == torch.float32 else y.dtype)
            for x, y in zip(getattr(ts, f).buckets, getattr(js, f).buckets)))
        for f in ("params", "anchor", "ef_memory")})
    tl, jl = ts.params.layout, js.params.layout

    def coalesced(sp, layout):
        plan = sp.make_sync_plan(layout, num_workers=W, compression="ef_sign",
                                 anchored=True, wire_pack=True)
        g = plan.stages
        coll = dataclasses.replace(g[1], buckets=(0, 1), coalesced=True)
        return dataclasses.replace(plan, stages=(g[0], g[3], coll, g[2], g[5]))

    tplan, jplan = coalesced(tsp, tl), coalesced(jsp, jl)
    assert [s.kind for s in tplan.stages] == ["pack", "pack", "collective", "apply", "apply"]
    before = [x.clone() for f in FIELDS if getattr(ts, f) is not None
              for x in getattr(ts, f).buckets]
    out = tsync(ts, plan=tplan)
    js = jsync(js, plan=jplan, scope="global")
    for f in ("params", "anchor", "ef_memory"):
        for a, b in zip(getattr(out, f).buckets, getattr(js, f).buckets, strict=True):
            b = np.asarray(b, np.float32)
            np.testing.assert_allclose(a.float().numpy(), b, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(b).max()), err_msg=f)
    for fld in ("pre_sync_sq", "post_sync_sq", "comp_err_sq", "comp_ref_sq"):
        np.testing.assert_allclose(getattr(out.stats, fld).numpy(),
                                   np.asarray(getattr(js.stats, fld)), rtol=1e-5,
                                   err_msg=fld)
    # the same state through the plain per-bucket plan: the same bits
    ts2 = fresh()
    for x, y in zip([x for f in FIELDS if getattr(ts2, f) is not None
                     for x in getattr(ts2, f).buckets], before):
        x.copy_(y)
    out2 = tsync(ts2, plan=tsp.make_sync_plan(tl, num_workers=W, compression="ef_sign",
                                              anchored=True, wire_pack=True))
    for f in ("params", "anchor", "ef_memory"):
        for a, b in zip(getattr(out2, f).buckets, getattr(out, f).buckets):
            assert torch.equal(a, b), f


@pytest.mark.parametrize("wire_pack", [False, True])
def test_ef_memory_stays_float32_over_two_syncs(wire_pack):
    """Two EF-sign syncs on the mixed f32 + bf16 tree from both packages'
    ``init`` (zero EF memory; random params and anchor, the same bf16
    values in both): the port's EF memory is float32 in every bucket
    from ``init`` on, and after each sync it equals the reference's (whose
    first sync turns its bf16 memory into the f32 residual) within 1e-6
    x the largest entry.  Between the syncs both packages get the same
    new params, and the port the reference's anchor, so both compress
    the same deltas; each carries its own EF memory."""
    run = lambda cb: cb.RunConfig(
        model=tconfigs.get_smoke("paper-lm") if cb is tcb else jconfigs.get_smoke("paper-lm"),
        local_sgd=cb.LocalSGDConfig(sync_compression="ef_sign",
                                    wire_pack=wire_pack))
    ttree = {k: torch.zeros(s, dtype=getattr(torch, d)) for k, (s, d) in MIXED.items()}
    jtree = {k: jnp.zeros(s, jnp.dtype(d)) for k, (s, d) in MIXED.items()}
    tinit, _, tsync = tsgd.make_local_sgd(run(tcb), lambda p, b: None, num_workers=W)
    jinit, _, jsync = jsgd.make_local_sgd(run(jcb), lambda p, b: None, num_workers=W,
                                          use_kernel=True)
    ts, js = tinit(ttree), jinit(jax.random.PRNGKey(0), jtree)
    tl = ts.params.layout
    assert [str(b.dtype) for b in js.ef_memory.buckets] == ["float32", "bfloat16"]
    assert all(b.dtype == torch.float32 and not b.any() for b in ts.ef_memory.buckets)
    gen = np.random.default_rng(6)

    def put(fields):
        """The same random values (rounded to each bucket's dtype) into
        the port's and the reference's ``fields``."""
        out = {}
        for f in fields:
            tb = []
            for b, x in enumerate(getattr(ts, f).buckets):
                x.copy_(tflat.mask_padding(tl, b, torch.from_numpy(
                    gen.normal(size=x.shape).astype(np.float32))))
                # a copy: the port's sync updates its buffers in place
                tb.append(jnp.asarray(np.array(x.float().numpy(), copy=True))
                          .astype(getattr(js, f).buckets[b].dtype))
            out[f] = getattr(js, f).with_buckets(tuple(tb))
        return dataclasses.replace(js, **out)

    js = put(("params", "anchor"))
    for rnd in range(2):
        ts = tsync(ts, plan=tsp.make_sync_plan(tl, num_workers=W, compression="ef_sign",
                                               anchored=True, wire_pack=wire_pack))
        js = jsync(js, plan=jsp.make_sync_plan(js.params.layout, num_workers=W,
                                               compression="ef_sign", anchored=True,
                                               wire_pack=wire_pack), scope="global")
        assert all(b.dtype == torch.float32 for b in ts.ef_memory.buckets)
        assert [str(b.dtype) for b in js.ef_memory.buckets] == ["float32"] * 2
        for a, b in zip(ts.ef_memory.buckets, js.ef_memory.buckets, strict=True):
            b = np.asarray(b)
            assert np.abs(b).max() > 0
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(b).max()),
                                       err_msg=f"sync {rnd}")
        if rnd == 0:
            # new local params for both, and the reference's anchor in the port
            js = put(("params",))
            for x, y in zip(ts.anchor.buckets, js.anchor.buckets):
                x.copy_(torch.from_numpy(np.asarray(y, np.float32)).to(x.dtype))


def _run(cb, cfg, mode, telemetry):
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", S, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=H, sync_compression=mode,
                                    wire_pack=True, sync_coalesce=True),
        optim=cb.OptimConfig(base_lr=0.3, base_batch=W * B, lr_warmup_steps=2,
                             weight_decay=1e-2, grad_clip=1.0),
        controller=cb.ControllerConfig(telemetry=telemetry))


def _inputs(anchor, params, ef):
    """(W, rows, 128) compressor input of each bucket: the delta, plus
    the EF memory under EF-sign."""
    return [a[None] - p + (e if e is not None else 0)
            for a, p, e in zip(anchor, params, ef or [None] * len(params))]


def _pinned(ts, js):
    """The port's state with every resident buffer and the telemetry
    taken from the reference's state (new tensors: the port's sync writes
    in place)."""
    kw = {f: getattr(ts, f).with_buckets(tuple(
              torch.tensor(np.asarray(x)).to(t.dtype)
              for x, t in zip(getattr(js, f).buckets, getattr(ts, f).buckets,
                              strict=True)))
          for f in FIELDS if getattr(ts, f) is not None}
    if ts.stats is not None:
        kw["stats"] = tstats.StatsAccumulator(**{
            fld.name: torch.tensor(np.asarray(getattr(js.stats, fld.name)))
            for fld in dataclasses.fields(tstats.StatsAccumulator)})
    return dataclasses.replace(ts, **kw)


def _rel_err(js, ts):
    """Per field, max |port - reference| over the largest |reference|."""
    out = {}
    for f in FIELDS:
        jf, tf = getattr(js, f), getattr(ts, f)
        assert (jf is None) == (tf is None), f
        for a, b in zip(tf.buckets if tf else (), jf.buckets if jf else ()):
            b = np.asarray(b)
            out[f] = max(out.get(f, 0.0),
                         float(np.abs(a.numpy() - b).max() / np.abs(b).max()))
    return out


def _pre_sync_sq_f64(layout, inputs):
    """mean_k ||C(x_k)||^2 in float64 of the compressor inputs ``inputs``
    (one (W, rows, 128) tensor a bucket): sign(x) times the per-leaf scale
    shared by the W workers."""
    tot = 0.0
    for b, x in enumerate(inputs):
        x = x.double()
        seg = tflat.const("row_segments", layout, b, "cpu").long()
        sizes = tflat.const("segment_sizes", layout, b, "cpu").double()
        sums = torch.zeros(len(sizes), dtype=torch.float64).index_add_(
            0, seg, x.abs().sum(dim=(0, 2)))
        y = torch.sign(x) * (sums / (sizes * x.shape[0]))[seg][None, :, None]
        tot = tot + (y * y).sum(dim=(1, 2))
    return float(tot.mean())


@pytest.mark.parametrize("mode", ["sign", "ef_sign"])
def test_wire_pack_trajectory_matches_reference(mode):
    """Every sync is held on the reference's own state: before it, the
    reference's buffers and telemetry are copied into a port state, so
    both packages pack the same bits (no element can flip), and every
    element of the port's params, momentum, anchor and EF memory after
    the sync is within 1e-6 x the largest of the reference's, the
    telemetry within rtol 1e-5 (``pre_sync_sq`` of the float64 sum, which
    the reference's float32 sum misses by up to 2e-5 here).  The free-running port trajectory is run
    beside it: each sync's sign flips (an element whose compressor input
    is >= 0 in one package and < 0 in the other: a delta within rounding
    of zero; sign(0) packs as +1) are counted and printed, and at the
    end at most 1e-4 of its elements are beyond 1e-4 x the largest."""
    smoke_j, smoke_t = jconfigs.get_smoke("paper-lm"), tconfigs.get_smoke("paper-lm")
    telemetry = mode == "ef_sign"
    jb = jbuild(_run(jcb, smoke_j, mode, telemetry), num_workers=W, use_kernel=True)
    tb = tbuild(_run(tcb, smoke_t, mode, telemetry), num_workers=W, device="cpu")
    assert tb.sync_plan.describe() == jb.sync_plan.describe()
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    js = jb.init(jax.random.PRNGKey(1), p0)
    ts = tb.init(params_from_reference(jax.tree.map(np.asarray, p0), "cpu"))
    jstep = jax.jit(jb.local_step)
    jsync = jax.jit(lambda s: jb.sync(s, plan=jb.sync_plan, scope="global"))
    it = ShardedBatches(lm_examples(markov_lm(vocab=512, num_seqs=64, seq_len=S)), W, B)
    flips, errs, pre_errs = [], [], []
    for _ in range(ROUNDS * H):
        batch = next(it)
        js, _ = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, _ = tb.local_step(ts, batch)
        if ts.step % H:
            continue
        buf = lambda st, f: (None if getattr(st, f) is None
                             else [torch.as_tensor(np.asarray(x))
                                   for x in getattr(st, f).buckets])
        ins = lambda st: _inputs(*(buf(st, f) for f in ("anchor", "params", "ef_memory")))
        jin = ins(js)
        flips.append(sum(int(((a >= 0) != (b >= 0)).sum())
                         for a, b in zip(ins(ts), jin)))
        pinned = _pinned(ts, js)
        assert all(torch.equal(a, b) for a, b in zip(ins(pinned), jin))
        js = jsync(js)
        ts = tb.sync(ts, plan=tb.sync_plan)
        pinned = tb.sync(pinned, plan=tb.sync_plan)
        errs.append(_rel_err(js, pinned))
        assert max(errs[-1].values()) <= 1e-6, errs
        if telemetry:     # pre / post sync norms and compression errors
            for fld in dataclasses.fields(tstats.StatsAccumulator):
                if fld.name != "pre_sync_sq":
                    np.testing.assert_allclose(
                        getattr(pinned.stats, fld.name).numpy(),
                        np.asarray(getattr(js.stats, fld.name)), rtol=1e-5,
                        atol=0, err_msg=fld.name)
            pre = _pre_sync_sq_f64(ts.params.layout, jin)
            np.testing.assert_allclose(float(pinned.stats.pre_sync_sq), pre, rtol=1e-5)
            pre_errs.append(float(js.stats.pre_sync_sq) / pre - 1)
    print(f"{mode}: sign flips per sync {flips}; pinned syncs' errors {errs}; "
          f"the reference's pre_sync_sq against float64 {pre_errs}")
    for f in FIELDS:
        for a, b in zip(getattr(ts, f).buckets if getattr(ts, f) else (),
                        getattr(js, f).buckets if getattr(js, f) else ()):
            b = np.asarray(b)
            frac = float(np.mean(np.abs(a.numpy() - b) > 1e-4 * np.abs(b).max()))
            assert frac <= 1e-4, (f, frac, flips)


@pytest.mark.parametrize("synced", [False, True])
def test_reference_ef_memory_restores_as_float32(synced, tmp_path):
    """A reference EF-sign state of the mixed tree, taken before its first
    sync (bf16 EF memory in the bf16 bucket) or after it (f32), reaches
    the port with float32 EF memory of the same values, through
    ``state_from_reference`` and through a reference ``save_flat`` file
    restored by ``restore_flat``; an elastic resize keeps it float32."""
    from repro.checkpoint.checkpoint import save_flat as jsave_flat
    from repro_torch.checkpoint.checkpoint import restore_flat
    from repro_torch.convert import state_from_reference
    from repro_torch.core.elastic import resize_state

    run = lambda cb: cb.RunConfig(
        model=tconfigs.get_smoke("paper-lm") if cb is tcb else jconfigs.get_smoke("paper-lm"),
        local_sgd=cb.LocalSGDConfig(sync_compression="ef_sign"))
    ttree = {k: torch.zeros(s, dtype=getattr(torch, d)) for k, (s, d) in MIXED.items()}
    jtree = {k: jnp.zeros(s, jnp.dtype(d)) for k, (s, d) in MIXED.items()}
    tinit = tsgd.make_local_sgd(run(tcb), lambda p, b: None, num_workers=W)[0]
    jinit, _, jsync = jsgd.make_local_sgd(run(jcb), lambda p, b: None, num_workers=W,
                                          use_kernel=True)
    js = jinit(jax.random.PRNGKey(0), jtree)
    gen = np.random.default_rng(7)
    js = dataclasses.replace(js, params=js.params.with_buckets(tuple(
        jnp.asarray(gen.normal(size=b.shape)).astype(b.dtype) for b in js.params.buckets)))
    if synced:
        js = jsync(js, plan=jsp.make_sync_plan(js.params.layout, num_workers=W,
                                               compression="ef_sign", anchored=True),
                   scope="global")
    want = [np.asarray(b, np.float32) for b in js.ef_memory.buckets]
    assert [str(b.dtype) for b in js.ef_memory.buckets] == \
        ["float32", "float32" if synced else "bfloat16"]
    assert (max(np.abs(w).max() for w in want) > 0) == synced
    template = tinit(ttree)
    path = str(tmp_path / "ref")
    jsave_flat(path, js, step=int(js.step))
    for got in (state_from_reference(jax.tree.map(np.asarray, js),
                                     layout=template.params.layout, device="cpu"),
                restore_flat(path, template)):
        assert [b.dtype for b in got.ef_memory.buckets] == [torch.float32] * 2
        for a, b in zip(got.ef_memory.buckets, want, strict=True):
            assert np.array_equal(a.numpy(), b)
        for a, b, t in zip(got.params.buckets, js.params.buckets,
                           template.params.buckets, strict=True):
            assert a.dtype == t.dtype
            assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))
        small = resize_state(got, 2)
        assert [b.dtype for b in small.ef_memory.buckets] == [torch.float32] * 2
