"""Port parity: the telemetry accumulator and its round summary
(``repro_torch.telemetry.stats``, ``repro_torch.core.noise``) against the
JAX package's on the same numbers.

The accumulator's arithmetic is a few float32 adds, the same on both
sides, so the fields must agree exactly; the summary is host float64
arithmetic on those numbers, so it must agree exactly too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import noise as jnoise
from repro.telemetry import stats as jstats
from repro_torch.core import noise as tnoise
from repro_torch.telemetry import stats as tstats

FIELDS = [f.name for f in dataclasses.fields(tstats.StatsAccumulator)]


def _both(W, n_comp, rounds, seed):
    """The same sequence of steps and syncs through both accumulators."""
    rng = np.random.default_rng(seed)
    js, ts = jstats.init_stats(W, n_comp), tstats.init_stats(W, n_comp)
    for r in range(rounds):
        for _ in range(r + 2):
            g, u = (rng.random(W).astype(np.float32) for _ in range(2))
            js = jstats.accumulate_step(js, jnp.asarray(g), jnp.asarray(u))
            ts = tstats.accumulate_step(ts, torch.from_numpy(g), torch.from_numpy(u))
        pre, post = np.float32(rng.random() + 1), np.float32(rng.random())
        if r % 2:
            err = rng.random(n_comp).astype(np.float32)
            ref = err + rng.random(n_comp).astype(np.float32)
            js = jstats.record_sync(js, pre_sync_sq=pre, post_sync_sq=post,
                                    comp_err_sq=jnp.asarray(err),
                                    comp_ref_sq=jnp.asarray(ref))
            ts = tstats.record_sync(ts, pre_sync_sq=torch.tensor(pre),
                                    post_sync_sq=torch.tensor(post),
                                    comp_err_sq=torch.from_numpy(err),
                                    comp_ref_sq=torch.from_numpy(ref))
        else:
            js = jstats.record_sync(js, pre_sync_sq=pre, post_sync_sq=post)
            ts = tstats.record_sync(ts, pre_sync_sq=float(pre), post_sync_sq=float(post))
    return js, ts


@pytest.mark.parametrize("W,n_comp,rounds", [(4, 1, 3), (4, 2, 2), (1, 1, 1),
                                             (2, 3, 0)])
def test_accumulator_and_round_summary_match_reference(W, n_comp, rounds):
    js, ts = _both(W, n_comp, rounds, seed=W + n_comp + rounds)
    jn = jax.tree.map(np.asarray, js)
    for name in FIELDS:
        a, b = getattr(jn, name), getattr(ts, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert jstats.round_summary(js) == tstats.round_summary(ts)
    # the last round measured a compressor iff it was an odd-numbered one
    assert tstats.round_summary(ts)["comp_measured"] == (rounds > 0 and rounds % 2 == 0)


def test_noise_decomposition_matches_reference():
    for update_sq in (0.0, 1e-6, 0.5, 3.0):
        for dispersion in (0.0, 1e-7, 0.4, 5.0, -1.0):
            for W in (1, 2, 4, 8):
                assert tnoise.noise_decomposition(update_sq, dispersion, W) == \
                    jnoise.noise_decomposition(update_sq, dispersion, W)
