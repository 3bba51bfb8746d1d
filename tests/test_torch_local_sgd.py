"""Port parity: resident local SGD trajectories (repro_torch vs repro).

Both sides start from the same JAX-materialized weights and see the same
numpy batches.  The reference runs ``build_train(run, num_workers=4,
use_kernel=True)`` — the resident bucket path with its Pallas kernels in
interpret mode — jitted by the test; the port runs ``build_train(run,
num_workers=4, device="cpu")`` (the kernels' plain versions).  After N
local steps with a global sync every H steps, every resident buffer is
compared:

* mean sync: all elements within 1e-5 x the buffer's largest entry
  (float32, sums in another order);
* sign / EF-sign: a delta within rounding of 0 can take the other sign
  in the other framework, and the flip then moves that element by a
  whole scale, so all but at most 1e-4 of the elements must lie within
  1e-4 x the buffer's largest entry.

With telemetry on, every field of ``state.stats`` must agree within 1e-5
relative (float32 norms summed in another order; the dispersion ``pre``
is a sum of squared worker differences and the most sensitive of them).
LARS runs with ``grad_clip=1.0`` set: the reference ignores it under
LARS, and so must the port.

Hierarchical local SGD (Alg. 5, ``block_steps=2``, blocks of 2 workers)
alternates block and global syncs and is held to the same tolerances.
The overlap topology only reorders the stages of the same per-bucket
dataflow, so the port's overlap trajectory must equal its flat one bit
for bit (``torch.equal``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.configs import base as jcb
from repro.launch.steps import build_train as jbuild
from repro.models import base as jmbase
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.core import flatbuf
from repro_torch.core import local_sgd as tsgd
from repro_torch.core import syncplan as tsp
from repro_torch.core.local_sgd import make_local_sgd, mean_params, unpack_state
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.kernels import fused_bucket as tkb
from repro_torch.kernels import ops as tops
from repro_torch.launch.steps import build_train as tbuild
from repro_torch.models import base as tmbase
from repro_torch.telemetry import stats as tstats
from repro_torch.utils import tree_flatten, tree_map

torch.set_num_threads(2)

W, B, S, H, N = 4, 2, 32, 2, 4
FIELDS = ("params", "momentum", "anchor", "global_u", "ef_memory")


def _run(cb, cfg, mode, clip, nesterov, gm=0.0, optimizer="sgd",
         telemetry=False, block_steps=1, topology="auto"):
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", S, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=H, sync_compression=mode,
                                    nesterov=nesterov, global_momentum=gm,
                                    block_steps=block_steps,
                                    sync_topology=topology),
        optim=cb.OptimConfig(optimizer=optimizer, base_lr=0.3, base_batch=W * B,
                             lr_warmup_steps=2, weight_decay=1e-2,
                             grad_clip=clip, lars_trust=0.02),
        controller=cb.ControllerConfig(telemetry=telemetry))


def _pair(mode, clip, nesterov, gm=0.0, **kw):
    rj = _run(jcb, jconfigs.get_smoke("paper-lm"), mode, clip, nesterov, gm, **kw)
    rt = _run(tcb, tconfigs.get_smoke("paper-lm"), mode, clip, nesterov, gm, **kw)
    jb = jbuild(rj, num_workers=W, use_kernel=True)
    p0 = jmbase.materialize(jb.specs, jax.random.PRNGKey(0))
    js = jb.init(jax.random.PRNGKey(1), p0)
    tb = tbuild(rt, num_workers=W, device="cpu")
    ts = tb.init(params_from_reference(jax.tree.map(np.asarray, p0), "cpu"))
    jstep = jax.jit(jb.local_step)
    jsync = jax.jit(lambda s: jb.sync(s, plan=jb.sync_plan, scope="global"))
    data = lm_examples(markov_lm(vocab=512, num_seqs=64, seq_len=S))
    return jb, js, jstep, jsync, tb, ts, ShardedBatches(data, W, B)


def _steps(n, js, jstep, jsync, tb, ts, it, losses=None):
    for t in range(n):
        batch = next(it)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tb.local_step(ts, batch)
        if losses is not None:
            losses.append((float(jm["loss"]), float(tm["loss"])))
        if (ts.step) % H == 0:
            js = jsync(js)
            ts = tb.sync(ts, plan=tb.sync_plan)
    return js, ts


def _compare(js, ts, exact_mode: bool):
    for f in FIELDS:
        jf, tf = getattr(js, f), getattr(ts, f)
        assert (jf is None) == (tf is None), f
        if jf is None:
            continue
        for a, b in zip(jf.buckets, tf.buckets, strict=True):
            a, b = np.asarray(a), b.numpy()
            assert a.shape == b.shape
            d = np.abs(a - b)
            scale = float(np.abs(a).max())
            if exact_mode:
                assert d.max() <= 1e-5 * scale, (f, d.max(), scale)
            else:
                frac = float(np.mean(d > 1e-4 * scale))
                assert frac <= 1e-4, (f, frac)


def _compare_stats(js, ts):
    for fld in dataclasses.fields(tstats.StatsAccumulator):
        a = np.asarray(getattr(js.stats, fld.name))
        b = getattr(ts.stats, fld.name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, fld.name
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=0, err_msg=fld.name)


# mode x grad_clip x nesterov: every value of each axis is swept
CASES = [("none", 0.0, True), ("none", 1.0, False),
         ("sign", 1.0, True), ("sign", 0.0, False),
         ("ef_sign", 1.0, False), ("ef_sign", 0.0, True)]


@pytest.mark.parametrize("mode,clip,nesterov", CASES)
def test_resident_trajectory_matches_reference(mode, clip, nesterov):
    jb, js, jstep, jsync, tb, ts, it = _pair(mode, clip, nesterov)
    losses = []
    js, ts = _steps(N, js, jstep, jsync, tb, ts, it, losses)
    assert ts.step == int(js.step) == N
    np.testing.assert_allclose([l[1] for l in losses], [l[0] for l in losses],
                               rtol=1e-6)
    _compare(js, ts, exact_mode=(mode == "none"))


def test_global_momentum_and_state_carry_over():
    """A reference state carried over mid-run (state_from_reference)
    continues on the port as it does on the reference; global momentum
    rides the anchored sync."""
    jb, js, jstep, jsync, tb, ts, it = _pair("none", 1.0, True, gm=0.5)
    it_ref = ShardedBatches(it.data, W, B)
    for _ in range(H):                        # reference alone for one round
        js = jstep(js, {k: jnp.asarray(v) for k, v in next(it_ref).items()})[0]
    js = jsync(js)
    ts = state_from_reference(jax.tree.map(np.asarray, js), layout=tb.layout,
                              device="cpu")
    assert ts.step == H and ts.global_u is not None
    js, ts = _steps(H, js, jstep, jsync, tb, ts, it_ref)
    _compare(js, ts, exact_mode=True)


def test_mean_params_and_launch_counts_on_cpu():
    """mean_params is the single-copy tree of the worker average; on the
    CPU the wrappers take the plain route and count no kernel launch."""
    rt = _run(tcb, tconfigs.get_smoke("paper-lm"), "ef_sign", 1.0, True)
    tb = tbuild(rt, num_workers=W, device="cpu")
    gen = torch.Generator().manual_seed(0)
    ts = tb.init(tmbase.materialize(tb.specs, gen, "cpu"))
    it = ShardedBatches(lm_examples(markov_lm(vocab=512, num_seqs=64,
                                              seq_len=S)), W, B)
    tkb.reset_launches()
    for _ in range(H - 1):                  # stop before the sync: workers differ
        ts = tb.local_step(ts, next(it))[0]
    assert all(v == 0 for v in tkb.LAUNCHES.values())
    mp = mean_params(ts)
    stacked = unpack_state(ts).params
    for m, s in zip(tree_flatten(mp)[0], tree_flatten(stacked)[0]):
        torch.testing.assert_close(m, s.mean(0))
    assert not torch.equal(ts.params.buckets[0][0], ts.params.buckets[0][1])
    ts = tb.sync(ts, plan=tb.sync_plan)
    for w in range(1, W):                   # broadcast back from the anchor
        assert torch.equal(ts.params.buckets[0][w], ts.anchor.buckets[0])


def test_unported_options_raise():
    """LARS, telemetry with the static schedule, hierarchical local SGD,
    gradient noise, the adaptive and elastic controllers, the 1-bit wire
    pack and coalesced syncs build (the last two take a local step and a
    sync, with the flags in the bundle's plan); an optimizer the port
    lacks and an unknown sync topology still raise."""
    smoke = tconfigs.get_smoke("paper-lm")
    kinds = ("diversity_h", "adaptive_batch", "noise_adaptive", "elastic")
    for kw in (dict(optim=tcb.OptimConfig(optimizer="lars")),
               dict(controller=tcb.ControllerConfig(telemetry=True)),
               dict(local_sgd=tcb.LocalSGDConfig(block_steps=2)),
               dict(optim=tcb.OptimConfig(noise_eta=0.1)),
               *(dict(controller=tcb.ControllerConfig(kind=k)) for k in kinds),
               dict(local_sgd=tcb.LocalSGDConfig(sync_compression="ef_sign"),
                    controller=tcb.ControllerConfig(kind="auto_compress"))):
        tbuild(tcb.RunConfig(model=smoke, **kw), num_workers=2, device="cpu")
    data = lm_examples(markov_lm(vocab=512, num_seqs=8, seq_len=S))
    for ls in (tcb.LocalSGDConfig(wire_pack=True, sync_compression="sign"),
               tcb.LocalSGDConfig(sync_coalesce=True, wire_pack=True,
                                  sync_compression="ef_sign")):
        tb = tbuild(tcb.RunConfig(model=smoke, shape=tcb.InputShape("t", S, 2 * B,
                                                                    "train"),
                                  local_sgd=ls), num_workers=2, device="cpu")
        assert (tb.sync_plan.wire_pack, tb.sync_plan.coalesce) == \
            (ls.wire_pack, ls.sync_coalesce)
        ts = tb.init(tmbase.materialize(tb.specs, torch.Generator().manual_seed(0),
                                        "cpu"))
        ts, m = tb.local_step(ts, next(iter(ShardedBatches(data, 2, B))))
        ts = tb.sync(ts, plan=tb.sync_plan)
        assert torch.isfinite(m["loss"]) and torch.equal(ts.params.buckets[0][0],
                                                         ts.params.buckets[0][1])
    with pytest.raises(NotImplementedError, match="optimizer"):
        tbuild(tcb.RunConfig(model=smoke, optim=tcb.OptimConfig(optimizer="adam")),
               num_workers=2, device="cpu")
    with pytest.raises(ValueError, match="unknown sync_topology"):
        tbuild(tcb.RunConfig(model=smoke, local_sgd=tcb.LocalSGDConfig(
            sync_topology="ring")), num_workers=2, device="cpu")


class _FullBucketCensus(TorchDispatchMode):
    """Counts the ops (views excluded) whose output holds at least one
    bucket's worth of elements, by op name; ``paused`` skips a region."""

    def __init__(self, numel):
        super().__init__()
        self.numel, self.paused, self.counts = numel, False, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if not self.paused and not func.is_view and any(
                isinstance(o, torch.Tensor) and o.numel() >= self.numel
                for o in outs):
            name = func.overloadpacket.__name__
            self.counts[name] = self.counts.get(name, 0) + 1
        return out


def _pre_fix_worker_grad(layout, loss_fn, pbs_w, batch_w, gw):
    """The gradient assembly before ``flatbuf.unflatten_grad_into``: plain
    slicing views, whose backward builds one zero-filled bucket per leaf
    and adds them, then a copy into the stacked grad."""
    src = [b.detach().requires_grad_(True) for b in pbs_w]
    loss, metrics = loss_fn(flatbuf.unflatten(layout, src), batch_w)
    for g_all, g in zip(gw, torch.autograd.grad(loss, src)):
        g_all.copy_(g)
    return loss, metrics


@pytest.mark.parametrize("optimizer", ["sgd", "lars"])
def test_gradient_lands_once_per_worker(optimizer, monkeypatch):
    """Census (the reference's "zero pack/unpack per step" claim, counted
    with a dispatch mode on the CPU): in one local_step of W=2 workers, the
    ops outside the optimizer update whose output is at least a bucket.
    Each worker's gradient lands in its row in one pass: 1 op per step in
    all (the zero fill of the stacked grad buckets, 0.5 per worker), where
    the pre-fix assembly takes 22 more per worker (11 slice_backward, 10
    add and 1 copy_)."""
    w2 = 2
    run = dataclasses.replace(
        _run(tcb, tconfigs.get_smoke("paper-lm"), "ef_sign", 1.0, True,
             optimizer=optimizer),
        shape=tcb.InputShape("t", S, w2 * B, "train"))
    tb = tbuild(run, num_workers=w2, device="cpu")
    batch = next(ShardedBatches(lm_examples(markov_lm(vocab=512, num_seqs=16,
                                                      seq_len=S)), w2, B))
    out = {}
    for name, fn in (("fixed", tsgd._worker_grad), ("pre_fix", _pre_fix_worker_grad)):
        census = _FullBucketCensus(tb.layout.bucket_rows[0] * 128)
        for upd in ("apply_sgd_buckets", "apply_lars_buckets"):
            real = getattr(tsgd, upd)

            def paused(*a, _real=real, **k):
                census.paused = True
                try:
                    return _real(*a, **k)
                finally:
                    census.paused = False
            monkeypatch.setattr(tsgd, upd, paused)
        monkeypatch.setattr(tsgd, "_worker_grad", fn)
        st = tb.init(tmbase.materialize(tb.specs,
                                        torch.Generator().manual_seed(0), "cpu"))
        with census:
            tb.local_step(st, batch)
        out[name] = census.counts
        monkeypatch.undo()
    assert out["fixed"] == {"zeros_like": 1}, out
    assert sum(out["fixed"].values()) <= 2 * w2
    assert out["pre_fix"] == {"zeros_like": 1, "slice_backward": 22, "add": 20,
                              "copy_": 2}, out


@pytest.mark.parametrize("optimizer,telemetry,mode", [
    ("sgd", False, "none"), ("sgd", True, "ef_sign"), ("lars", False, "ef_sign"),
    ("lars", True, "none")])
def test_gradient_assembly_bitwise_equal_to_pre_fix(optimizer, telemetry, mode,
                                                    monkeypatch):
    """The one-pass gradient assembly against the pre-fix one (slicing
    views, per-leaf zero buckets added up, a copy): every buffer, stats
    field and loss after N steps with syncs, bit for bit (int32 views, so
    even the sign of a zero must agree)."""
    smoke = tconfigs.get_smoke("paper-lm")
    run = _run(tcb, smoke, mode, 1.0, True, optimizer=optimizer,
               telemetry=telemetry)
    data = lm_examples(markov_lm(vocab=512, num_seqs=64, seq_len=S))
    out = {}
    for name, fn in (("fixed", tsgd._worker_grad), ("pre_fix", _pre_fix_worker_grad)):
        monkeypatch.setattr(tsgd, "_worker_grad", fn)
        tb = tbuild(run, num_workers=W, device="cpu")
        ts = tb.init(tmbase.materialize(tb.specs,
                                        torch.Generator().manual_seed(0), "cpu"))
        it, losses = ShardedBatches(data, W, B), []
        for _ in range(N):
            ts, m = tb.local_step(ts, next(it))
            losses.append(m["loss"])
            if ts.step % H == 0:
                ts = tb.sync(ts, plan=tb.sync_plan)
        stats = ([getattr(ts.stats, f.name)
                  for f in dataclasses.fields(tstats.StatsAccumulator)]
                 if telemetry else [])
        out[name] = _buffers(ts) + stats + losses
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    assert len(out["fixed"]) == len(out["pre_fix"])
    assert all(torch.equal(bits(a), bits(b))
               for a, b in zip(out["fixed"], out["pre_fix"]))


@pytest.mark.parametrize("mode", ["none", "ef_sign"])
def test_lars_telemetry_trajectory_matches_reference(mode, monkeypatch):
    """LARS (per-worker trust ratios, W=4) with telemetry: buffers, losses
    and every stats field against the reference after N steps; the port
    takes no clip norm under LARS (sq_sum never runs)."""
    def no_clip_norm(*a, **k):
        raise AssertionError("LARS must not take the grad-clip norm")
    monkeypatch.setattr(tops, "bucket_sq_sum", no_clip_norm)
    jb, js, jstep, jsync, tb, ts, it = _pair(mode, 1.0, True, optimizer="lars",
                                             telemetry=True)
    assert tb.telemetry and tb.n_comp == tb.layout.num_buckets == 1
    losses = []
    js, ts = _steps(N, js, jstep, jsync, tb, ts, it, losses)
    np.testing.assert_allclose([l[1] for l in losses], [l[0] for l in losses],
                               rtol=1e-6)
    _compare(js, ts, exact_mode=(mode == "none"))
    _compare_stats(js, ts)
    assert int(ts.stats.rounds) == N // H and int(ts.stats.round_steps) == H
    assert bool(ts.stats.comp_ref_sq.sum() > 0) == (mode == "ef_sign")


def test_sgd_mean_telemetry_matches_reference():
    """SGD + mean sync with telemetry: the centred pre/post pair (post = 0
    exactly) and the post-clip grad norms agree with the reference."""
    jb, js, jstep, jsync, tb, ts, it = _pair("none", 1.0, False, telemetry=True)
    js, ts = _steps(N, js, jstep, jsync, tb, ts, it)
    _compare(js, ts, exact_mode=True)
    _compare_stats(js, ts)
    assert float(ts.stats.post_sync_sq) == 0.0 and float(ts.stats.pre_sync_sq) > 0


def test_state_carry_over_with_stats():
    """A reference LARS + EF-sign state with telemetry, carried over after
    one round (state_from_reference brings ``stats`` along), continues on
    the port as on the reference."""
    jb, js, jstep, jsync, tb, ts, it = _pair("ef_sign", 0.0, True,
                                             optimizer="lars", telemetry=True)
    it_ref = ShardedBatches(it.data, W, B)
    for _ in range(H):
        js = jstep(js, {k: jnp.asarray(v) for k, v in next(it_ref).items()})[0]
    js = jsync(js)
    ts = state_from_reference(jax.tree.map(np.asarray, js), layout=tb.layout,
                              device="cpu")
    for fld in dataclasses.fields(tstats.StatsAccumulator):
        assert np.array_equal(getattr(ts.stats, fld.name).numpy(),
                              np.asarray(getattr(js.stats, fld.name))), fld.name
    assert tstats.round_summary(ts.stats)["rounds"] == 1
    js, ts = _steps(H, js, jstep, jsync, tb, ts, it_ref)
    _compare(js, ts, exact_mode=False)
    _compare_stats(js, ts)


def _hier_steps(n, js, jstep, jsyncs, tb, ts, it, losses):
    """n local steps with a sync every H steps, block and global in turn
    (H^b = 2): the reference's sync jitted per scope."""
    rounds = 0
    for _ in range(n):
        batch = next(it)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tb.local_step(ts, batch)
        losses.append((float(jm["loss"]), float(tm["loss"])))
        if ts.step % H == 0:
            rounds += 1
            scope = "global" if rounds % 2 == 0 else "block"
            js = jsyncs[scope](js)
            ts = tb.sync(ts, plan=tb.sync_plan, scope=scope)
    return js, ts


@pytest.mark.parametrize("clip,nesterov,telemetry", [(1.0, True, False),
                                                     (0.0, False, True)])
def test_hierarchical_trajectory_matches_reference(clip, nesterov, telemetry):
    """Alg. 5 at W=4 (blocks of 2 consecutive workers): two block and two
    global syncs in 4 rounds of H=2 steps; losses rtol 1e-6, buffers and
    (with telemetry, which only global syncs record) every stats field as
    in the flat trajectory tests."""
    jb, js, jstep, _, tb, ts, it = _pair("none", clip, nesterov,
                                         telemetry=telemetry, block_steps=2)
    assert jb.sync_plan.topology.kind == tb.sync_plan.topology.kind \
        == "hierarchical"
    assert tb.sync_plan.topology.block_size == 2
    jsyncs = {sc: jax.jit(lambda s, sc=sc: jb.sync(s, plan=jb.sync_plan,
                                                   scope=sc))
              for sc in ("block", "global")}
    losses = []
    js, ts = _hier_steps(4 * H, js, jstep, jsyncs, tb, ts, it, losses)
    np.testing.assert_allclose([l[1] for l in losses], [l[0] for l in losses],
                               rtol=1e-6)
    _compare(js, ts, exact_mode=True)
    if telemetry:
        _compare_stats(js, ts)
        assert int(ts.stats.rounds) == 2
    # the last sync was global: every worker holds the same model; after a
    # block sync only the two workers of a block agree
    p = ts.params.buckets[0]
    assert all(torch.equal(p[0], p[w]) for w in range(1, W))
    ts = tb.local_step(ts, next(it))[0]
    ts = tb.sync(ts, plan=tb.sync_plan, scope="block")
    p = ts.params.buckets[0]
    assert torch.equal(p[0], p[1]) and torch.equal(p[2], p[3])
    assert not torch.equal(p[0], p[2])


def test_block_sync_needs_the_mean_sync():
    """A block sync of an anchored config (compression or global momentum)
    raises, as in the reference; its global sync runs."""
    rt = _run(tcb, tconfigs.get_smoke("paper-lm"), "ef_sign", 1.0, True,
              block_steps=2)
    tb = tbuild(rt, num_workers=W, device="cpu")
    ts = tb.init(tmbase.materialize(tb.specs, torch.Generator().manual_seed(0),
                                    "cpu"))
    with pytest.raises(ValueError, match="require flat local SGD"):
        tb.sync(ts, plan=tb.sync_plan, scope="block")
    tb.sync(ts, plan=tb.sync_plan, scope="global")
    with pytest.raises(ValueError, match="cannot serve block_steps"):
        tbuild(_run(tcb, tconfigs.get_smoke("paper-lm"), "none", 1.0, True,
                    block_steps=2, topology="flat"), num_workers=W, device="cpu")


def _buffers(state):
    return [b for f in FIELDS if getattr(state, f) is not None
            for b in getattr(state, f).buckets]


@pytest.mark.parametrize("mode,block_steps", [("none", 1), ("ef_sign", 1),
                                              ("none", 2)])
def test_overlap_trajectory_equals_flat_bitwise(mode, block_steps):
    """The overlap topology against flat (hierarchical with H^b = 2) from
    the same weights and batches: every buffer and loss bit for bit."""
    smoke = tconfigs.get_smoke("paper-lm")
    p0 = tmbase.materialize(tbuild(_run(tcb, smoke, mode, 1.0, True),
                                   num_workers=W, device="cpu").specs,
                            torch.Generator().manual_seed(3), "cpu")
    data = lm_examples(markov_lm(vocab=512, num_seqs=64, seq_len=S))
    out = {}
    for topo in ("auto", "overlap"):
        tb = tbuild(_run(tcb, smoke, mode, 1.0, True, block_steps=block_steps,
                         topology=topo), num_workers=W, device="cpu")
        ts = tb.init(tree_map(lambda t: t.clone(), p0))
        it, losses, rounds = ShardedBatches(data, W, B), [], 0
        for _ in range(4 * H):
            ts, m = tb.local_step(ts, next(it))
            losses.append(m["loss"])
            if ts.step % H == 0:
                rounds += 1
                scope = ("block" if block_steps > 1 and rounds % 2 else "global")
                ts = tb.sync(ts, plan=tb.sync_plan, scope=scope)
        out[topo] = (tb.sync_plan.topology.kind, losses, _buffers(ts))
    (ka, la, ba), (ko, lo, bo) = out["auto"], out["overlap"]
    assert (ka, ko) == ("flat" if block_steps == 1 else "hierarchical", "overlap")
    assert all(torch.equal(a, b) for a, b in zip(la, lo))
    assert len(ba) == len(bo) and all(torch.equal(a, b) for a, b in zip(ba, bo))


@pytest.mark.parametrize("mode", ["none", "sign", "ef_sign"])
def test_overlap_sync_equals_flat_on_two_buckets(mode):
    """A state of two buckets (f32 and bf16 leaves), workers apart: the
    overlap plan applies bucket 0 after bucket 1's collective, and the
    synced state equals the flat plan's bit for bit."""
    tree = {"a": torch.zeros((3, 200)), "b": torch.zeros((5, 7), dtype=torch.bfloat16),
            "c": torch.zeros((130,))}
    run = _run(tcb, tconfigs.get_smoke("paper-lm"), mode, 0.0, True)
    init, _, sync = make_local_sgd(run, lambda p, b: None, num_workers=W)
    out = []
    for topo in (tsp.flat(), tsp.overlap()):
        st = init(tree)
        gen = torch.Generator().manual_seed(11)
        for x in _buffers(st):                # anchor, momentum, EF memory
            x.copy_(torch.randn(x.shape, generator=gen).to(x.dtype))
        plan = tsp.make_sync_plan(st.params.layout, num_workers=W, topology=topo,
                                  compression=mode, anchored=mode != "none")
        assert plan.num_buckets == 2
        out.append(_buffers(sync(st, plan=plan)))
    assert all(torch.equal(a, b) for a, b in zip(*out))
