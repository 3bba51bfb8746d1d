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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jcb
from repro.launch.steps import build_train as jbuild
from repro.models import base as jmbase
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tcb
from repro_torch.convert import params_from_reference, state_from_reference
from repro_torch.core.local_sgd import mean_params, unpack_state
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.kernels import fused_bucket as tkb
from repro_torch.launch.steps import build_train as tbuild
from repro_torch.models import base as tmbase
from repro_torch.utils import tree_flatten

torch.set_num_threads(2)

W, B, S, H, N = 4, 2, 32, 2, 4
FIELDS = ("params", "momentum", "anchor", "global_u", "ef_memory")


def _run(cb, cfg, mode, clip, nesterov, gm=0.0):
    return cb.RunConfig(
        model=cfg, shape=cb.InputShape("t", S, W * B, "train"),
        local_sgd=cb.LocalSGDConfig(local_steps=H, sync_compression=mode,
                                    nesterov=nesterov, global_momentum=gm),
        optim=cb.OptimConfig(base_lr=0.3, base_batch=W * B, lr_warmup_steps=2,
                             weight_decay=1e-2, grad_clip=clip))


def _pair(mode, clip, nesterov, gm=0.0):
    rj = _run(jcb, jconfigs.get_smoke("paper-lm"), mode, clip, nesterov, gm)
    rt = _run(tcb, tconfigs.get_smoke("paper-lm"), mode, clip, nesterov, gm)
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
    for kw in (dict(optim=tcb.OptimConfig(noise_eta=0.1)),
               dict(optim=tcb.OptimConfig(optimizer="lars")),
               dict(local_sgd=tcb.LocalSGDConfig(wire_pack=True,
                                                 sync_compression="sign")),
               dict(local_sgd=tcb.LocalSGDConfig(block_steps=2)),
               dict(controller=tcb.ControllerConfig(kind="diversity_h"))):
        run = tcb.RunConfig(model=tconfigs.get_smoke("paper-lm"), **kw)
        with pytest.raises(NotImplementedError):
            tbuild(run, num_workers=2, device="cpu")
