"""Port parity for the recurrent mixers (``repro_torch.models.mamba2`` /
``xlstm`` against ``repro.models.mamba2`` / ``xlstm``) at the smoke
configs' widths, on the CPU.

The JAX weights (``repro.models.base.materialize``) are carried over
through numpy; inputs are numpy draws.  Tolerances:

* the port against the reference's same function (train output,
  prefill caches, decode outputs and states): rtol 1e-5, atol 1e-6 x
  the largest entry (float32 sums in another order);
* every gradient leaf and the input's gradient under a random
  cotangent: rtol 1e-5, atol 1e-5 x the leaf's largest entry, the
  gradient tolerance of ``test_torch_model`` / ``test_torch_arch`` (a
  leaf's gradient sums B x S terms of both signs, and an entry near 0
  keeps the absolute rounding of the larger terms it sums); the mLSTM's
  at atol 5e-5 x the largest entry: its gradients pass through the
  stabilised exponentials of cumulative log-gates and the division by
  the normaliser (measured: the gate bias ``b_if`` 1.3e-5 and the
  input's gradient 1.2e-5 of their largest entries at chunk 8, the
  other leaves within 3e-6), and its train output over S 32 at atol
  1e-5 x the largest entry (2.3e-6 measured: the chunk's num / den);
* the chunked forms against the sequential oracles: 1e-4 (mamba2) and
  2e-4 (mLSTM), the reference's own ``tests/test_ssm.py`` tolerances.

Chunks 4, 8 and 32 at S 32, and chunk 8 at the prime S 31 (the chunk
drops until it divides S: Q 1, 31 chunks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SSMConfig as JSSM
from repro.models import base as jmbase
from repro.models import mamba2 as JM2
from repro.models import xlstm as JXL
from repro.models.blocks import Ctx as JCtx
from repro_torch import configs as tconfigs
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.convert import params_from_reference
from repro_torch.models import mamba2 as TM2
from repro_torch.models import xlstm as TXL
from repro_torch.models.blocks import Ctx as TCtx
from repro_torch.utils import tree_flatten, tree_leaves, tree_unflatten

torch.set_num_threads(2)

B = 2
CHUNK_S = [(4, 32), (8, 32), (32, 32), (8, 31)]


def _cfgs(arch, **ssm):
    j, t = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    if ssm:
        j = j.replace(ssm=JSSM(**{**j.ssm.__dict__, **ssm}))
        t = t.replace(ssm=TSSM(**{**t.ssm.__dict__, **ssm}))
    return j, t


def _params(specs_fn, jcfg, seed=0):
    jp = jmbase.materialize(specs_fn(jcfg), jax.random.PRNGKey(seed))
    # non-trivial gate biases and decays (the specs init them to 0 / 1)
    rng = np.random.default_rng(seed)
    jp = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.5)
              if k in ("dt_bias", "A_log", "D", "b_if", "conv_b") else v)
          for k, v in jp.items()}
    return jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, S, E, b=B, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(b, S, E)) * scale).astype(np.float32)


def _close(got, want, msg="", atol=1e-6):
    """rtol 1e-5, atol ``atol`` x the largest entry of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=atol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=msg)


def _grads_match(japply, tapply, jp, tp, x, seed, atol=1e-5, grads=True,
                 out_atol=1e-6):
    """Output and every gradient (params and x) under one random
    cotangent, the port against the reference, gradients at rtol 1e-5 and
    atol ``atol`` x each leaf's largest entry.  ``grads=False`` checks
    only that every gradient is finite."""
    jout = jax.jit(japply)(jp, jnp.asarray(x))
    g = np.random.default_rng(seed + 100).normal(size=jout.shape).astype(np.float32)
    jgp, jgx = jax.jit(jax.grad(lambda p, xx: jnp.sum(japply(p, xx) * g),
                                argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves, treedef = tree_flatten(tp)
    leaves = [a.clone().requires_grad_(True) for a in leaves]
    xt = torch.from_numpy(x).requires_grad_(True)
    tout = tapply(tree_unflatten(treedef, leaves), xt)
    _close(tout.detach().numpy(), jout, "output", atol=out_atol)
    (tout * torch.from_numpy(g)).sum().backward()
    jl = jax.tree.leaves(jgp) + [jgx]
    names = sorted(tp) + ["x"]
    tg = [a.grad for a in leaves] + [xt.grad]
    assert len(jl) == len(tg) == len(names)
    for name, a, b in zip(names, tg, jl):
        assert torch.isfinite(a).all(), name
        if grads:
            _close(a.numpy(), b, f"grad {name}", atol=atol)


# ---------------------------------------------------------------------------
# mamba2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,S", CHUNK_S)
def test_mamba2_train_and_grads_match_reference(chunk, S):
    jcfg, tcfg = _cfgs("zamba2-7b", chunk=chunk)
    jp, tp = _params(JM2.mamba2_specs, jcfg, seed=1)
    x = _x(1, S, tcfg.d_model)
    _grads_match(lambda p, xx: JM2.mamba2_apply(jcfg, p, xx, JCtx(mode="train"))[0],
                 lambda p, xx: TM2.mamba2_apply(tcfg, p, xx, TCtx(mode="train"))[0],
                 jp, tp, x, seed=1)


@pytest.mark.parametrize("chunk,S", CHUNK_S)
def test_mamba2_chunked_matches_sequential_oracle(chunk, S):
    jcfg, tcfg = _cfgs("zamba2-7b", chunk=chunk)
    _, tp = _params(JM2.mamba2_specs, jcfg, seed=2)
    x = torch.from_numpy(_x(2, S, tcfg.d_model))
    with torch.no_grad():
        y = TM2.mamba2_apply(tcfg, tp, x, TCtx(mode="train"))[0]
        want = TM2.mamba2_reference(tcfg, tp, x, TCtx(mode="train"))[0]
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_mamba2_prefill_and_decode_match_reference():
    """Prefill caches (the final state, the last K-1 pre-conv inputs),
    then 3 decode steps from them: outputs and states against the
    reference's, and the last step against the sequential oracle over
    the whole sequence (1e-4)."""
    jcfg, tcfg = _cfgs("zamba2-7b")
    jp, tp = _params(JM2.mamba2_specs, jcfg, seed=3)
    x = _x(3, 24, tcfg.d_model)
    xs = [_x(30 + i, 1, tcfg.d_model) for i in range(3)]
    jy, jc = JM2.mamba2_apply(jcfg, jp, jnp.asarray(x), JCtx(mode="prefill"))
    with torch.no_grad():
        ty, tc = TM2.mamba2_apply(tcfg, tp, torch.from_numpy(x), TCtx(mode="prefill"))
        _close(ty.numpy(), jy, "prefill out")
        assert sorted(tc) == sorted(jc) == ["conv", "ssm"]
        for k in tc:
            assert tuple(tc[k].shape) == jc[k].shape, k
            _close(tc[k].numpy(), jc[k], f"prefill {k}")
        for i, xt in enumerate(xs):
            jy, jc = JM2.mamba2_apply(jcfg, jp, jnp.asarray(xt),
                                      JCtx(mode="decode", cache=jc))
            ty, tc = TM2.mamba2_apply(tcfg, tp, torch.from_numpy(xt),
                                      TCtx(mode="decode", cache=tc))
            _close(ty.numpy(), jy, f"decode {i}")
            for k in tc:
                _close(tc[k].numpy(), jc[k], f"decode {i} {k}")
        full = torch.from_numpy(np.concatenate([x] + xs, axis=1))
        want = TM2.mamba2_reference(tcfg, tp, full, TCtx(mode="train"))[0]
    np.testing.assert_allclose(ty[:, 0].numpy(), want[:, -1].numpy(), rtol=1e-4,
                               atol=1e-4)


def test_mamba2_cache_init_and_axes_match_reference():
    jcfg, tcfg = _cfgs("zamba2-7b")
    jc = JM2.mamba2_init_cache(jcfg, 3, 16, jnp.bfloat16)
    tc = TM2.mamba2_init_cache(tcfg, 3, 16, torch.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tc.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jc.items()}
    assert TM2.mamba2_cache_axes() == JM2.mamba2_cache_axes()
    assert not any(v.any() for v in tc.values())


def test_segsum_masked_branch_is_zero_and_nan_free():
    """exp(segsum) is 0 above the diagonal, equal to the reference's
    below it, and its gradient is finite everywhere (the -inf branch is
    selected after the subtraction)."""
    a = np.random.default_rng(4).normal(size=(3, 8)).astype(np.float32) - 2.0
    jL = jnp.exp(JM2._segsum(jnp.asarray(a)))
    at = torch.from_numpy(a).requires_grad_(True)
    L = torch.exp(TM2._segsum(at))
    _close(L.detach().numpy(), jL)
    assert not L.detach().triu(1).any()
    g = np.random.default_rng(5).normal(size=L.shape).astype(np.float32)
    (L * torch.from_numpy(g)).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jnp.exp(JM2._segsum(v)) * g))(jnp.asarray(a))
    assert torch.isfinite(at.grad).all()
    _close(at.grad.numpy(), jg)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,S", CHUNK_S)
def test_mlstm_train_and_grads_match_reference(chunk, S):
    jcfg, tcfg = _cfgs("xlstm-1.3b", chunk=chunk)
    jp, tp = _params(JXL.mlstm_specs, jcfg, seed=6)
    x = _x(6, S, tcfg.d_model)
    _grads_match(lambda p, xx: JXL.mlstm_apply(jcfg, p, xx, JCtx(mode="train"))[0],
                 lambda p, xx: TXL.mlstm_apply(tcfg, p, xx, TCtx(mode="train"))[0],
                 jp, tp, x, seed=6, atol=5e-5, out_atol=1e-5)


@pytest.mark.parametrize("chunk,S", CHUNK_S)
def test_mlstm_chunked_matches_sequential_oracle(chunk, S):
    jcfg, tcfg = _cfgs("xlstm-1.3b", chunk=chunk)
    _, tp = _params(JXL.mlstm_specs, jcfg, seed=7)
    x = torch.from_numpy(_x(7, S, tcfg.d_model))
    with torch.no_grad():
        y = TXL.mlstm_apply(tcfg, tp, x, TCtx(mode="train"))[0]
        want = TXL.mlstm_reference(tcfg, tp, x, TCtx(mode="train"))[0]
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_mlstm_prefill_and_decode_match_reference():
    jcfg, tcfg = _cfgs("xlstm-1.3b")
    jp, tp = _params(JXL.mlstm_specs, jcfg, seed=8)
    x = _x(8, 24, tcfg.d_model)
    xs = [_x(80 + i, 1, tcfg.d_model) for i in range(3)]
    jy, jc = JXL.mlstm_apply(jcfg, jp, jnp.asarray(x), JCtx(mode="prefill"))
    with torch.no_grad():
        ty, tc = TXL.mlstm_apply(tcfg, tp, torch.from_numpy(x), TCtx(mode="prefill"))
        _close(ty.numpy(), jy, "prefill out")
        assert sorted(tc) == sorted(jc) == ["C", "conv", "m", "n"]
        for k in tc:
            assert tuple(tc[k].shape) == jc[k].shape, k
            _close(tc[k].numpy(), jc[k], f"prefill {k}")
        for i, xt in enumerate(xs):
            jy, jc = JXL.mlstm_apply(jcfg, jp, jnp.asarray(xt),
                                     JCtx(mode="decode", cache=jc))
            ty, tc = TXL.mlstm_apply(tcfg, tp, torch.from_numpy(xt),
                                     TCtx(mode="decode", cache=tc))
            _close(ty.numpy(), jy, f"decode {i}")
            for k in tc:
                _close(tc[k].numpy(), jc[k], f"decode {i} {k}")
        full = torch.from_numpy(np.concatenate([x] + xs, axis=1))
        want = TXL.mlstm_reference(tcfg, tp, full, TCtx(mode="train"))[0]
    np.testing.assert_allclose(ty[:, 0].numpy(), want[:, -1].numpy(), rtol=2e-4,
                               atol=2e-4)


def test_mlstm_masked_weights_stay_nan_free():
    """Forget gates near 0 (log f about -20 a step) and large input gates
    drive the stabilised exponents far apart: the chunked output matches
    the reference's and every gradient stays finite (in this regime the
    gradients are sums that cancel to near 0, rounding-bound in both
    packages, so only their finiteness is held)."""
    jcfg, tcfg = _cfgs("xlstm-1.3b", chunk=8)
    jp, tp = _params(JXL.mlstm_specs, jcfg, seed=9)
    H = tcfg.num_heads
    b_if = np.concatenate([np.full(H, 8.0), np.full(H, -23.0)]).astype(np.float32)
    jp = {**jp, "b_if": jnp.asarray(b_if)}
    tp = {**tp, "b_if": torch.from_numpy(b_if)}
    x = _x(9, 32, tcfg.d_model)
    _grads_match(lambda p, xx: JXL.mlstm_apply(jcfg, p, xx, JCtx(mode="train"))[0],
                 lambda p, xx: TXL.mlstm_apply(tcfg, p, xx, TCtx(mode="train"))[0],
                 jp, tp, x, seed=9, grads=False)


def test_mlstm_cache_init_and_axes_match_reference():
    jcfg, tcfg = _cfgs("xlstm-1.3b")
    jc = JXL.mlstm_init_cache(jcfg, 3, 16, jnp.bfloat16)
    tc = TXL.mlstm_init_cache(tcfg, 3, 16, torch.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in tc.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in jc.items()}
    assert TXL.mlstm_cache_axes() == JXL.mlstm_cache_axes()


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [16, 31])
def test_slstm_train_and_grads_match_reference(S):
    jcfg, tcfg = _cfgs("xlstm-1.3b")
    jp, tp = _params(JXL.slstm_specs, jcfg, seed=10)
    x = _x(10, S, tcfg.d_model)
    _grads_match(lambda p, xx: JXL.slstm_apply(jcfg, p, xx, JCtx(mode="train"))[0],
                 lambda p, xx: TXL.slstm_apply(tcfg, p, xx, TCtx(mode="train"))[0],
                 jp, tp, x, seed=10)


def test_slstm_prefill_and_decode_match_reference():
    """The final cell state of a prefill, 3 decode steps from it against
    the reference's, and the last against a train-mode pass over the
    whole sequence (rtol 1e-5)."""
    jcfg, tcfg = _cfgs("xlstm-1.3b")
    jp, tp = _params(JXL.slstm_specs, jcfg, seed=11)
    x = _x(11, 16, tcfg.d_model)
    xs = [_x(110 + i, 1, tcfg.d_model) for i in range(3)]
    jy, jc = JXL.slstm_apply(jcfg, jp, jnp.asarray(x), JCtx(mode="prefill"))
    with torch.no_grad():
        ty, tc = TXL.slstm_apply(tcfg, tp, torch.from_numpy(x), TCtx(mode="prefill"))
        _close(ty.numpy(), jy, "prefill out")
        assert sorted(tc) == sorted(jc) == ["c", "h", "m", "n"]
        for k in tc:
            _close(tc[k].numpy(), jc[k], f"prefill {k}")
        for i, xt in enumerate(xs):
            jy, jc = JXL.slstm_apply(jcfg, jp, jnp.asarray(xt),
                                     JCtx(mode="decode", cache=jc))
            ty, tc = TXL.slstm_apply(tcfg, tp, torch.from_numpy(xt),
                                     TCtx(mode="decode", cache=tc))
            _close(ty.numpy(), jy, f"decode {i}")
            for k in tc:
                _close(tc[k].numpy(), jc[k], f"decode {i} {k}")
        full = torch.from_numpy(np.concatenate([x] + xs, axis=1))
        want = TXL.slstm_apply(tcfg, tp, full, TCtx(mode="train"))[0]
    np.testing.assert_allclose(ty[:, 0].numpy(), want[:, -1].numpy(), rtol=1e-5,
                               atol=1e-5)
    jcache = JXL.slstm_init_cache(jcfg, 3, 16, jnp.float32)
    tcache = TXL.slstm_init_cache(tcfg, 3, 16, torch.float32)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    assert TXL.slstm_cache_axes() == JXL.slstm_cache_axes()


@pytest.mark.parametrize("fn", ["mamba2", "mlstm", "slstm"])
def test_specs_match_reference(fn):
    arch = "zamba2-7b" if fn == "mamba2" else "xlstm-1.3b"
    mod_j, mod_t = (JM2, TM2) if fn == "mamba2" else (JXL, TXL)
    for get in (lambda m: m.get(arch), lambda m: m.get_smoke(arch)):
        js = getattr(mod_j, f"{fn}_specs")(get(jconfigs))
        ts = getattr(mod_t, f"{fn}_specs")(get(tconfigs))
        jl = jax.tree.leaves(js, is_leaf=jmbase.is_spec)
        tl = tree_leaves(ts)
        assert sorted(ts) == sorted(js)
        assert [(s.shape, s.axes, s.init, s.scale) for s in tl] == \
            [(s.shape, s.axes, s.init, s.scale) for s in jl]
