"""Port parity: the per-tensor kernel API (``ops.fused_sgd``,
``ops.sign_compress``) against ``repro.kernels.ops`` running its Pallas
kernels in interpret mode on the CPU.

On the CPU every wrapper runs its plain PyTorch version (the CUDA kernels
need the card: ``tests/test_torch_cuda.py`` compares kernel and plain
version there).  Inputs come from numpy with a seed; bfloat16 inputs are
the same float32 draws rounded to bfloat16 on both sides.  Tolerances:
the reference's own ``_tol`` (``tests/test_kernels.py``): rtol 1e-5 /
atol 1e-6 in float32, 2e-2 in bfloat16; the compressor rtol 1e-5 / atol
1e-6 (an L1 sum in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import fused_sgd as tfs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sign_compress as tsc

torch.set_num_threads(2)

SHAPES = [(5,), (128,), (129,), (64, 64), (3, 7, 11), (2048,), (300, 5)]
DTYPES = ["float32", "bfloat16"]


def _tol(dt):
    return dict(rtol=1e-5, atol=1e-6) if dt == "float32" else dict(rtol=2e-2, atol=2e-2)


def _pair(x, dt):
    """The same float32 draws as a JAX and a torch array of dtype ``dt``."""
    return jnp.asarray(x, getattr(jnp, dt)), torch.from_numpy(x).to(getattr(torch, dt))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nesterov", [True, False])
def test_fused_sgd_matches_reference(shape, dtype, nesterov):
    rng = np.random.default_rng(
        [SHAPES.index(shape), DTYPES.index(dtype), int(nesterov)])
    (pj, pt), (gj, gt), (uj, ut) = (
        _pair(rng.normal(size=shape).astype(np.float32), dtype) for _ in range(3))
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-2, nesterov=nesterov)
    want = jops.fused_sgd(pj, gj, uj, **kw)
    got = tops.fused_sgd(pt, gt, ut, **kw)
    for a, b in zip(got, want):
        assert a.dtype == getattr(torch, dtype) and tuple(a.shape) == shape
        np.testing.assert_allclose(_np(a), np.float32(b), **_tol(dtype))
    assert tfs.LAUNCHES["fused_sgd_2d"] == 0          # plain route: no launch


@pytest.mark.parametrize("lr", [0.2, 0.4])
def test_fused_sgd_lr_as_a_tensor(lr):
    """lr as a 0-d f32 tensor, the counterpart of the reference's traced lr
    (``tests/test_kernels.py::test_fused_sgd_traced_lr``), matches the
    reference's jitted call and the float form."""
    rng = np.random.default_rng(7)
    p, g, u = (rng.normal(size=(3, 129)).astype(np.float32) for _ in range(3))

    @jax.jit
    def step(lr):
        return jops.fused_sgd(jnp.asarray(p), jnp.asarray(g), jnp.asarray(u),
                              lr=lr, momentum=0.9, weight_decay=1e-3)

    want = step(jnp.float32(lr))
    kw = dict(momentum=0.9, weight_decay=1e-3)
    pt, gt, ut = (torch.from_numpy(a) for a in (p, g, u))
    got = tops.fused_sgd(pt, gt, ut, lr=torch.tensor(lr, dtype=torch.float32), **kw)
    for a, b, c in zip(got, want, tops.fused_sgd(pt, gt, ut, lr=lr, **kw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        assert torch.equal(a, c)


def test_fused_sgd_is_functional():
    """New tensors out, inputs untouched (the bucket kernels update in
    place; this API, like the reference, does not)."""
    p, g, u = torch.ones(10), torch.full((10,), 0.5), torch.zeros(10)
    po, uo = tops.fused_sgd(p, g, u, lr=0.2, momentum=0.0, nesterov=False)
    np.testing.assert_allclose(po.numpy(), 0.9, rtol=1e-6)
    np.testing.assert_allclose(uo.numpy(), 0.5)
    assert float(p.sum()) == 10.0 and float(u.abs().sum()) == 0.0


def test_fused_sgd_ref_oracle_matches_reference():
    from repro.kernels import ref as jref
    rng = np.random.default_rng(3)
    p, g, u = (rng.normal(size=(300, 5)).astype(np.float32) for _ in range(3))
    kw = dict(momentum=0.9, weight_decay=1e-2, nesterov=True)
    want = jref.fused_sgd_ref(*(jnp.asarray(a) for a in (p, g, u)), 0.1, **kw)
    got = tref.fused_sgd_ref(*(torch.from_numpy(a) for a in (p, g, u)), 0.1, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sign_compress_matches_reference(shape, dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=shape).astype(np.float32), dtype)
    y = tops.sign_compress(xt)
    assert y.dtype == torch.float32 and tuple(y.shape) == shape
    np.testing.assert_allclose(y.numpy(), np.asarray(jops.sign_compress(xj)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), tref.sign_compress_ref(xt).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert tsc.LAUNCHES == {"abs_sum": 0, "scale_sign": 0}


@pytest.mark.parametrize("n", [130, 33000])
def test_sign_compress_scale_uses_the_true_count(n):
    """``tests/test_wire_pack.py``'s cases: n=130 (the reference pads to
    256 lanes), n=33000 (258 of its 128-lane rows: a partial block of its
    reduction).  The one magnitude is mean|x| over the TRUE count."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=n).astype(np.float32)
    y = tops.sign_compress(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jops.sign_compress(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.unique(np.abs(y[y != 0])),
                               [np.abs(x).mean()], rtol=1e-5)


def test_sign_compress_zero_stays_zero():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(40, 33)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = 0.0
    y = tops.sign_compress(torch.from_numpy(x)).numpy()
    assert (y[x == 0] == 0).all() and (np.sign(y) == np.sign(x)).all()
    np.testing.assert_allclose(y, np.asarray(jops.sign_compress(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_sign_compress_parts_match_reference_kernels():
    """abs_sum and scale_sign one by one against the reference's
    ``abs_sum_2d`` / ``scale_sign_2d`` on a (rows, 128) array."""
    from repro.kernels import sign_compress as jsc
    rng = np.random.default_rng(5)
    x = rng.normal(size=(264, 128)).astype(np.float32)
    x[:3] = 0.0
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(float(tsc.abs_sum(xt)),
                               float(jsc.abs_sum_2d(jnp.asarray(x))), rtol=1e-5)
    s = np.float32(0.37)
    np.testing.assert_array_equal(
        tsc.scale_sign(xt, torch.tensor(s)).numpy(),
        np.asarray(jsc.scale_sign_2d(jnp.asarray(x), jnp.full((1, 1), s))))


def test_cuda_route_launches_or_raises(monkeypatch):
    """A wrapper handed a CUDA tensor goes to its kernel and never to its
    plain version: with the device test forced true and no kernel library
    to be had, each raises instead of computing on the CPU."""
    def no_library(name):
        raise RuntimeError(f"no {name} library")

    def plain(*a, **k):
        pytest.fail("a CUDA tensor reached a plain version")

    monkeypatch.setattr(tbuild, "on_cuda", lambda *t: True)
    monkeypatch.setattr(tbuild, "stream", lambda x: 0)
    monkeypatch.setattr(tbuild, "load", no_library)
    for mod, fn in ((tfs, "fused_sgd_2d_plain"), (tsc, "abs_sum_plain"),
                    (tsc, "scale_sign_plain")):
        monkeypatch.setattr(mod, fn, plain)
    x = torch.ones(16)
    with pytest.raises(RuntimeError, match="no per_tensor library"):
        tops.fused_sgd(x, x, x, lr=0.1, momentum=0.9)
    with pytest.raises(RuntimeError, match="no per_tensor library"):
        tops.sign_compress(x)
    with pytest.raises(RuntimeError, match="no per_tensor library"):
        tsc.scale_sign(x, torch.tensor(1.0))
    assert tfs.LAUNCHES["fused_sgd_2d"] == 0
    assert tsc.LAUNCHES == {"abs_sum": 0, "scale_sign": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.ones(8)
    with pytest.raises(ValueError):                       # mixed devices
        tbuild.on_cuda(x, torch.empty(0, device="meta"))
    with pytest.raises(TypeError):
        tfs.check_tensors("t", x, x.double())
    with pytest.raises(ValueError):
        tfs.check_tensors("t", x, torch.ones(9))
    with pytest.raises(ValueError):
        tfs.check_tensors("t", torch.ones(4, 4).t())
    assert tfs.check_tensors("t", x) is True
    assert tfs.check_tensors("t", x[1:]) is False         # 4 bytes off: scalar loop
