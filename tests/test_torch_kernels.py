"""Port parity: the four bucket kernels' plain versions vs the Pallas
kernels of the JAX package (interpret mode on the CPU), and the
compressor built on them.

On the CPU every wrapper runs its plain PyTorch version (the CUDA kernels
need the card: ``tests/test_torch_cuda.py`` compares kernel and plain
version there and skips here).  Tolerances, each with its reason:

* elementwise SGD update: rtol 1e-6, atol 1e-7 — the same op order in
  float32, so differences are single roundings;
* reductions (sum g^2, sum x^2, per-row |x|): rtol 1e-5 — float32 sums
  taken in another order;
* sign: exact; compressor scales: 1e-6 relative on equal input.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core import flatbuf as jfb
from repro.kernels import fused_bucket as jkb
from repro.kernels import ops as jops
from repro.models import base as jmbase
from repro.models import lm as jlm
from repro import configs as jconfigs
from repro_torch.core import compression as tcomp
from repro_torch.core import flatbuf as tfb
from repro_torch.core import syncplan as tsplan
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import fused_bucket as tkb
from repro_torch.kernels import ops as tops
from repro_torch.models import base as tmbase
from repro_torch.models import lm as tlm
from repro_torch import configs as tconfigs

torch.set_num_threads(2)

W = 3
ROWS = (264, 3096)     # ragged against the TPU kernels' 256-row blocks


def _rand(rows, seed, lead=(W,), zero_frac=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (rows, 128)).astype(np.float32)
    if zero_frac:
        x[rng.random(x.shape) < zero_frac] = 0.0
    return x


def _wd_row(rows, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((rows, 1)) < 0.7).astype(np.float32)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("nesterov", [True, False])
@pytest.mark.parametrize("wd", [0.0, 1e-2])
@pytest.mark.parametrize("clip", [False, True])
def test_fused_sgd_plain_matches_pallas(rows, nesterov, wd, clip):
    p, g, u = (_rand(rows, s) for s in (1, 2, 3))
    u *= 0.1
    wd_row = _wd_row(rows, 4)
    lr, mom = np.float32(0.05), 0.9
    gscale = np.array([1.0, 0.25, 0.5], np.float32) if clip else None
    pt, ut = torch.from_numpy(p.copy()), torch.from_numpy(u.copy())
    gsq_t, usq_t = tkb.fused_sgd_bucket(
        pt, torch.from_numpy(g), ut, lr, torch.from_numpy(wd_row),
        momentum=mom, weight_decay=wd, nesterov=nesterov,
        gscale=torch.from_numpy(gscale) if clip else None, stats=True)
    assert tkb.LAUNCHES["fused_sgd_bucket"] == 0     # plain route: no launch
    for w in range(W):
        gw = g[w] * gscale[w] if clip else g[w]
        po, uo, gsq, usq = jkb.fused_sgd_bucket_2d(
            jnp.asarray(p[w]), jnp.asarray(gw), jnp.asarray(u[w]),
            jnp.full((1, 1), lr), jnp.asarray(wd_row), momentum=mom,
            weight_decay=wd, nesterov=nesterov, stats=True, interpret=True)
        np.testing.assert_allclose(pt[w].numpy(), np.asarray(po), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ut[w].numpy(), np.asarray(uo), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(gsq_t[w]), float(gsq), rtol=1e-5)
        np.testing.assert_allclose(float(usq_t[w]), float(usq), rtol=1e-5)


@pytest.mark.parametrize("rows", ROWS)
def test_sq_sum_and_row_abs_sum_match_pallas(rows):
    x = _rand(rows, 7)
    xt = torch.from_numpy(x)
    sq = tkb.sq_sum(xt)
    ra = tkb.row_abs_sum(xt)
    assert sq.shape == (W,) and ra.shape == (W, rows)
    for w in range(W):
        np.testing.assert_allclose(float(sq[w]), float(jkb.sq_sum_2d(
            jnp.asarray(x[w]), interpret=True)), rtol=1e-5)
        np.testing.assert_allclose(ra[w].numpy(), np.asarray(jkb.row_abs_sum_2d(
            jnp.asarray(x[w]), interpret=True))[:, 0], rtol=1e-5)
    assert tkb.sq_sum(xt[0]).shape == ()


@pytest.mark.parametrize("rows", ROWS)
def test_scale_sign_rows_matches_pallas_exactly(rows):
    x = _rand(rows, 8, zero_frac=0.05)           # sign(0) = 0 must survive
    scale = np.abs(np.random.default_rng(9).normal(size=(rows,))).astype(np.float32)
    y = tkb.scale_sign_rows(torch.from_numpy(x), torch.from_numpy(scale))
    for w in range(W):
        want = np.asarray(jkb.scale_sign_rows_2d(
            jnp.asarray(x[w]), jnp.asarray(scale[:, None]), interpret=True))
        assert np.array_equal(y[w].numpy(), want)
    assert (y.numpy()[x == 0] == 0).all()


def test_segment_sum_matches_reference():
    """Scatter-add in index order on the CPU, as XLA's: float32 totals
    within one rounding of jax.ops.segment_sum."""
    rng = np.random.default_rng(0)
    seg = np.tile(np.repeat(np.arange(5), [8, 16, 8, 24, 8]), 3).astype(np.int32)
    vals = rng.random(seg.size).astype(np.float32)
    got = tops.segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), 5)
    want = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), num_segments=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7)


def _smoke_layouts():
    jspecs = jlm.param_specs(jconfigs.get_smoke("paper-lm"))
    tspecs = tlm.param_specs(tconfigs.get_smoke("paper-lm"))
    jl = jfb.build_layout(jmbase.abstract(jspecs, jnp.float32),
                          wd_mask=jmbase.norm_param_mask(jspecs))
    tl = tfb.build_layout(tmbase.abstract(tspecs, torch.float32),
                          wd_mask=tmbase.norm_param_mask(tspecs))
    return jl, tl


def _delta(layout, seed, lead=(4,)):
    """A worker-stacked delta bucket with zero padding and a few exact
    zeros inside the leaves."""
    x = _rand(layout.bucket_rows[0], seed, lead=lead, zero_frac=0.01)
    return x * tfb.valid_mask(layout, 0)


def test_bucket_sign_compress_matches_reference():
    """ops level: equal input -> signs exact, scales within 1e-6 rel."""
    jl, tl = _smoke_layouts()
    x = _delta(tl, 11)
    seg = tfb.row_segments(tl, 0)
    sizes = tfb.segment_sizes(tl, 0)
    y, scales = tops.bucket_sign_compress(torch.from_numpy(x),
                                          torch.from_numpy(seg),
                                          torch.from_numpy(sizes * 4))
    jy, jscales = jops.bucket_sign_compress(
        jnp.asarray(x.reshape(-1, 128)), np.tile(seg, 4), sizes * 4,
        interpret=True)
    np.testing.assert_allclose(scales.numpy(), np.asarray(jscales), rtol=1e-6)
    jy = np.asarray(jy).reshape(x.shape)
    assert np.array_equal(np.sign(y.numpy()), np.sign(jy))
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-6)


@pytest.mark.parametrize("mode", ["sign", "ef_sign"])
def test_compress_stage_matches_reference(mode):
    """Module level (core/compression): the per-leaf L1 scale is shared
    across the W workers (leading=1), EF memory keeps e' = input - out."""
    jl, tl = _smoke_layouts()
    d = _delta(tl, 12)
    e = 0.1 * _delta(tl, 13)
    st = tsplan.SyncStage("pack", "global", (0,), mode, 4)
    y, e_new, inp = tcomp.compress_stage(tl, st, torch.from_numpy(d),
                                         torch.from_numpy(e), leading=1)
    from repro.core.syncplan import SyncStage as JStage
    jy, je, jinp = jcomp.compress_stage(jl, JStage("pack", "global", (0,), mode, 4),
                                        jnp.asarray(d), jnp.asarray(e),
                                        leading=1, kernel=True)
    jy, je, jinp = (np.asarray(a) for a in (jy, je, jinp))
    assert np.array_equal(inp.numpy(), jinp)
    assert np.array_equal(np.sign(y.numpy()), np.sign(jy))
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-6)
    if mode == "ef_sign":
        np.testing.assert_allclose(e_new.numpy(), je, rtol=1e-6, atol=1e-6)
        # EF invariant: compressed + e' == input, to one float32 rounding
        np.testing.assert_allclose((y + e_new).numpy(), inp.numpy(), rtol=0,
                                   atol=2 * np.finfo(np.float32).eps
                                   * float(inp.abs().max()))
    assert (y.numpy() * (1 - tfb.valid_mask(tl, 0)) == 0).all()   # padding stays 0


def test_wrappers_refuse_other_devices():
    """No silent fallback: only CPU (plain) or CUDA (kernel) tensors."""
    x = torch.empty((2, 8, 128), device="meta")
    for fn in (tkb.sq_sum, tkb.row_abs_sum):
        with pytest.raises(ValueError):
            fn(x)
    with pytest.raises(ValueError):
        tkb.scale_sign_rows(x, torch.zeros(8))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tbuild.build_all()
