"""Port parity: gradient noise (``noise_eta > 0``, the paper's Table 14
baseline) and the noise analysis of ``core/noise.py`` (repro_torch vs
repro).

The port draws its noise from an explicit ``torch.Generator``, the
reference from JAX keys: the streams differ, so the noise is held to the
same DISTRIBUTION, as the reference holds its own bucket noise to its
per-leaf noise (``tests/test_noise_parity.py``): per-element moments,
per-segment variance, exact-zero padding, and streams that differ.
Monte-Carlo tolerances: the mean within 5 standard errors, the standard
deviation within 2 % (5 % per leaf segment) over 400 draws.  The
deterministic parts (the sigma schedule, ``noise_decomposition``,
``critical_batch``, ``gradient_noise_trace``) agree with the reference
within float32 rounding (rtol 1e-6), and one seed gives the same bits.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flatbuf as jfb
from repro.core import noise as jnoise
from repro.core.local_sgd import _bucket_noise as j_bucket_noise
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tcb
from repro_torch.core import flatbuf as tfb
from repro_torch.core import noise as tnoise
from repro_torch.core.local_sgd import _bucket_noise
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import build_train
from repro_torch.models import base as tmbase

torch.set_num_threads(2)

SHAPES = {"a": (40, 7), "b": (130,)}
ETA, GAMMA, STEP = 0.3, 0.55, 4
SIGMA = float(np.sqrt(ETA / (1.0 + STEP) ** GAMMA))
TRIALS = 400


def _tree():
    return {k: torch.zeros(s) for k, s in SHAPES.items()}


def _bucket_samples(seed=0, step=STEP):
    """TRIALS draws of the port's bucket noise on zero grad buckets, from
    one generator: (layout, [(TRIALS, rows, 128) per bucket])."""
    tree = _tree()
    layout = tfb.build_layout(tree)
    gen = torch.Generator().manual_seed(seed)
    draws = []
    for _ in range(TRIALS):
        gbs = tfb.flatten(layout, tree)
        draws.append(_bucket_noise(layout, gbs, gen, step=step, eta=ETA,
                                   gamma=GAMMA))
    return layout, [torch.stack([d[b] for d in draws]).numpy()
                    for b in range(layout.num_buckets)]


def _ref_bucket_samples():
    tree = {k: jnp.zeros(s, jnp.float32) for k, s in SHAPES.items()}
    layout = jfb.build_layout(tree)
    gbs = jfb.flatten(layout, tree)
    keys = jax.random.split(jax.random.PRNGKey(0), TRIALS)
    return [np.asarray(x) for x in jax.vmap(lambda k: j_bucket_noise(
        layout, gbs, k, step=STEP, eta=ETA, gamma=GAMMA))(keys)]


def test_bucket_noise_moments_match_reference():
    """Mean and standard deviation of the port's bucket noise and of its
    per-leaf ``isotropic_noise`` against N(0, sigma_t^2), and against the
    reference's bucket noise drawn at the same schedule."""
    layout, bufs = _bucket_samples()
    ref = _ref_bucket_samples()
    for b, (buf, rbuf) in enumerate(zip(bufs, ref, strict=True)):
        mask = tfb.valid_mask(layout, b).astype(bool)
        vals = buf[:, mask]
        assert abs(vals.mean()) < 5 * SIGMA / np.sqrt(vals.size), (b, vals.mean())
        np.testing.assert_allclose(vals.std(), SIGMA, rtol=0.02)
        np.testing.assert_allclose(vals.std(), rbuf[:, mask].std(), rtol=0.02)
    gen = torch.Generator().manual_seed(1)
    leaf = [tnoise.isotropic_noise(_tree(), gen, step=STEP, eta=ETA, gamma=GAMMA)
            for _ in range(TRIALS)]
    for k in SHAPES:
        v = torch.stack([d[k] for d in leaf]).numpy()
        np.testing.assert_allclose(v.std(), SIGMA, rtol=0.02)
        assert abs(v.mean()) < 5 * SIGMA / np.sqrt(v.size)


def test_bucket_noise_per_segment_variance():
    """Every leaf segment of a bucket sees the same noise scale."""
    layout, bufs = _bucket_samples()
    for b, buf in enumerate(bufs):
        arr = buf.reshape(TRIALS, -1)
        for s in layout.bucket_slots(b):
            off = s.row_offset * tfb.LANE
            np.testing.assert_allclose(arr[:, off:off + s.size].std(), SIGMA,
                                       rtol=0.05, err_msg=f"segment {s.seg}")


def test_bucket_noise_keeps_padding_zero():
    layout, bufs = _bucket_samples()
    for b, buf in enumerate(bufs):
        pad = ~tfb.valid_mask(layout, b).astype(bool)
        assert pad.any() and np.all(buf[:, pad] == 0.0)


def test_bucket_noise_streams_differ_seeds_repeat():
    """Same distribution, another stream: the bucket noise differs from the
    per-leaf noise of the same seed and from the reference's; one seed
    gives the same bits, another seed other bits; eta 0 is the identity."""
    tree = _tree()
    layout = tfb.build_layout(tree)
    draw = lambda seed: _bucket_noise(layout, tfb.flatten(layout, tree),
                                      torch.Generator().manual_seed(seed),
                                      step=STEP, eta=ETA, gamma=GAMMA)
    a, a2, c = draw(3), draw(3), draw(4)
    assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, a2))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    leaf = tnoise.isotropic_noise(tree, torch.Generator().manual_seed(3),
                                  step=STEP, eta=ETA, gamma=GAMMA)
    assert not all(torch.allclose(x, y) for x, y in
                   zip(a, tfb.flatten(layout, leaf)))
    ref = _ref_bucket_samples()
    assert not np.allclose(a[0].numpy(), ref[0][0])
    gbs = tfb.flatten(layout, tree)
    assert _bucket_noise(layout, gbs, None, step=0, eta=0.0, gamma=GAMMA) is gbs
    assert tnoise.isotropic_noise(tree, None, step=0, eta=0.0, gamma=GAMMA) is tree


@pytest.mark.parametrize("step", [0, 10])
def test_sigma_schedule(step):
    """sigma_t^2 = eta / (1+t)^gamma: the sample variance of one large draw
    within 1 % of it (the reference's schedule)."""
    n = 1 << 20
    layout = tfb.build_layout({"x": torch.zeros(n)})
    g = _bucket_noise(layout, tfb.flatten(layout, {"x": torch.zeros(n)}),
                      torch.Generator().manual_seed(step), step=step, eta=ETA,
                      gamma=GAMMA)[0]
    want = float(jnp.sqrt(ETA / (1.0 + jnp.int32(step)) ** GAMMA))
    np.testing.assert_allclose(math.sqrt(ETA / (1.0 + step) ** GAMMA), want,
                               rtol=1e-6)
    np.testing.assert_allclose(float(g.var()), want ** 2, rtol=1e-2)


def test_noise_analysis_matches_reference():
    """noise_decomposition / critical_batch (host floats: equal) and
    gradient_noise_trace (float32 sums: rtol 1e-6) on the same inputs."""
    for args in ((10.0, 6.0, 4), (1.0, 0.5, 1), (1.0, 5.0, 4), (3.0, 0.0, 8)):
        assert tnoise.noise_decomposition(*args) == jnoise.noise_decomposition(*args)
    for args in ((2.0, 8.0, 4), (0.0, 1.0, 2), (1e-3, 0.3, 16.0)):
        assert tnoise.critical_batch(*args) == jnoise.critical_batch(*args)
    rng = np.random.default_rng(0)
    grads = {"w": rng.normal(size=(4, 33, 7)).astype(np.float32),
             "b": (0.1 + rng.normal(size=(4, 130))).astype(np.float32)}
    t = tnoise.gradient_noise_trace({k: torch.from_numpy(v)
                                     for k, v in grads.items()})
    j = jnoise.gradient_noise_trace({k: jnp.asarray(v) for k, v in grads.items()})
    np.testing.assert_allclose([float(x) for x in t], [float(x) for x in j],
                               rtol=1e-6)


def _noisy_run(eta=0.05):
    W, B, S = 2, 2, 16
    return tcb.RunConfig(
        model=tconfigs.get_smoke("paper-lm"),
        shape=tcb.InputShape("t", S, W * B, "train"),
        local_sgd=tcb.LocalSGDConfig(local_steps=2),
        optim=tcb.OptimConfig(base_lr=0.3, base_batch=W * B, grad_clip=1.0,
                              noise_eta=eta)), W, B, S


def test_fit_with_noise_is_seeded():
    """noise_eta > 0 through fit: finite losses, param padding exactly zero,
    one seed the same bits, another seed another trajectory; and the noise
    does move the trajectory off the noiseless one."""
    run, W, B, S = _noisy_run()
    data = lm_examples(markov_lm(vocab=512, num_seqs=32, seq_len=S))
    out = {}
    for name, seed, eta in (("a", 0, 0.05), ("a2", 0, 0.05), ("b", 1, 0.05),
                            ("clean", 0, 0.0)):
        r = _noisy_run(eta)[0]
        tb = build_train(r, num_workers=W, device="cpu")
        p0 = tmbase.materialize(tb.specs, torch.Generator().manual_seed(0),
                                "cpu")
        state, hist, _ = ttrain.fit(r, ShardedBatches(data, W, B), bundle=tb,
                                    num_steps=4, seed=seed, params0=p0,
                                    log=lambda *a: None)
        out[name] = (state.params.buckets[0], [h["loss"] for h in hist])
        pad = ~torch.from_numpy(tfb.valid_mask(tb.layout, 0).astype(bool))
        assert torch.all(state.params.buckets[0][:, pad] == 0)
        assert np.isfinite(out[name][1]).all()
    assert torch.equal(out["a"][0].view(torch.int32), out["a2"][0].view(torch.int32))
    assert out["a"][1] == out["a2"][1]
    assert not torch.equal(out["a"][0], out["b"][0])
    assert not torch.equal(out["a"][0], out["clean"][0])
