"""Port parity: ``ops.flash_attention`` and ``models.layers.
reference_attention`` against the JAX package (its Pallas flash kernel in
interpret mode on the CPU, its jnp oracle).

On the CPU the flash wrapper runs its plain version (the CUDA kernel
needs the card: ``tests/test_torch_cuda.py``).  Inputs come from numpy
with a seed.  Tolerances: 2e-5 in float32 (the reference's own,
``tests/test_flash_kernel.py``: online against dense softmax, sums in
another order); bfloat16 outputs within 0.05 as the reference's bf16 test,
and within one bf16 rounding of the reference's kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import reference_attention as j_reference_attention
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.layers import causal_attention
from repro_torch.models.layers import reference_attention as t_reference_attention

torch.set_num_threads(2)


def _qkv(seed, B, Sq, Sk, H, KH, D, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, S, h, D)).astype(np.float32)
            for S, h in ((Sq, H), (Sk, KH), (Sk, KH))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,bq,bk", [(32, 8, 8), (48, 16, 8), (64, 64, 64)])
@pytest.mark.parametrize("gqa", [(4, 4), (4, 2)])
def test_flash_matches_reference_kernel(causal, S, bq, bk, gqa):
    """``tests/test_flash_kernel.py``'s grid, against the Pallas kernel."""
    H, KH = gqa
    (qj, kj, vj), (qt, kt, vt) = _qkv(S + H + KH, 2, S, S, H, KH, 16)
    want = jops.flash_attention(qj, kj, vj, causal=causal, block_q=bq, block_k=bk)
    got = tops.flash_attention(qt, kt, vt, causal=causal, block_q=bq, block_k=bk)
    assert got.shape == qt.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert tfa.LAUNCHES["flash_attention_bhsd"] == 0    # plain route: no launch


@pytest.mark.parametrize("causal", [True, False])
def test_flash_sliding_window(causal):
    """Window 16, with causal and without (the reference applies the
    window either way)."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 1, 64, 64, 2, 2, 16)
    want = jops.flash_attention(qj, kj, vj, causal=causal, window=16,
                                block_q=16, block_k=16)
    got = tops.flash_attention(qt, kt, vt, causal=causal, window=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_bf16():
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, 1, 32, 32, 2, 2, 32, "bfloat16")
    want = jops.flash_attention(qj, kj, vj, block_q=8, block_k=8)
    got = tops.flash_attention(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.float32(want),
                               rtol=0.05, atol=0.05)
    # both compute in f32 and round once: within one bf16 step of each other
    np.testing.assert_allclose(got.float().numpy(), np.float32(want),
                               rtol=2 ** -7, atol=2 ** -9)


@pytest.mark.parametrize("Sq,Sk,causal", [(32, 48, True), (48, 32, True),
                                          (24, 40, False)])
def test_flash_query_rows_are_start_aligned(Sq, Sk, causal):
    """Sq != Sk: the reference kernel puts query i at key position i (not
    i + Sk - Sq as ``reference_attention`` does); so does the port."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(Sq * Sk, 2, Sq, Sk, 4, 2, 16)
    want = jops.flash_attention(qj, kj, vj, causal=causal, block_q=8, block_k=8)
    got = tops.flash_attention(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    if causal:      # and differs from the end-aligned oracle
        end = t_reference_attention(qt, kt, vt, causal=True).numpy()
        assert np.abs(got.numpy() - end).max() > 1e-2


@pytest.mark.parametrize("window", [0, 24])
def test_flash_bhsd_matches_reference_kernel(window):
    """The (BH, S, D) entry point, q, k and v with the same rows as the
    reference takes them."""
    rng = np.random.default_rng(window)
    q, k, v = (rng.normal(size=(8, 48, 32)).astype(np.float32) for _ in range(3))
    want = jfa.flash_attention_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=True, window=window, block_q=16,
                                    block_k=16)
    got = tfa.flash_attention_bhsd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_bhsd_refuses_fewer_kv_rows():
    """GQA lives in ``ops.flash_attention``; the (BH, S, D) entry point
    takes k and v with q's rows, as the reference does."""
    q, k = torch.zeros((8, 16, 32)), torch.zeros((4, 16, 32))
    with pytest.raises(ValueError, match="BH, Sk, D"):
        tfa.flash_attention_bhsd(q, k, k)


def test_flash_result_does_not_depend_on_block_sizes():
    _, (qt, kt, vt) = _qkv(9, 1, 40, 40, 4, 2, 16)
    outs = [tops.flash_attention(qt, kt, vt, window=12, block_q=bq, block_k=bk)
            for bq, bk in ((8, 8), (40, 20), (128, 128))]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_flash_matches_training_attention():
    """Causal, Sq == Sk, no window: the function the training path runs."""
    _, (qt, kt, vt) = _qkv(4, 2, 40, 40, 4, 2, 32)
    np.testing.assert_allclose(tops.flash_attention(qt, kt, vt).numpy(),
                               causal_attention(qt, kt, vt).numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("D", [24, 512])
def test_flash_refuses_head_dims_the_kernel_does_not_take(D):
    """The check runs on every route: a head dim the kernel does not take
    raises on the CPU too, as it does for a CUDA tensor (no fallback)."""
    _, (qt, kt, vt) = _qkv(0, 1, 8, 8, 2, 2, D)
    with pytest.raises(ValueError, match="head dim"):
        tops.flash_attention(qt, kt, vt)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_bhsd(qt[:, :, 0], kt[:, :, 0], vt[:, :, 0])


def test_flash_cuda_route_launches_or_raises(monkeypatch):
    from repro_torch.kernels import build as tbuild

    def no_library(name):
        raise RuntimeError(f"no {name} library")

    def plain(*a, **k):
        pytest.fail("a CUDA tensor reached the plain version")

    monkeypatch.setattr(tbuild, "on_cuda", lambda *t: True)
    monkeypatch.setattr(tbuild, "stream", lambda x: 0)
    monkeypatch.setattr(tbuild, "load", no_library)
    monkeypatch.setattr(tfa, "flash_attention_plain", plain)
    monkeypatch.setattr(tfa, "flash_attention_bhsd_plain", plain)
    _, (qt, kt, vt) = _qkv(0, 1, 8, 8, 2, 1, 16)
    with pytest.raises(RuntimeError, match="no flash_attention library"):
        tops.flash_attention(qt, kt, vt)
    with pytest.raises(RuntimeError, match="no flash_attention library"):
        tfa.flash_attention_bhsd(qt[:, :, 0], kt[:, :, 0], vt[:, :, 0])
    assert tfa.LAUNCHES["flash_attention_bhsd"] == 0


@pytest.mark.parametrize("Sq,Sk,causal,window,softcap", [
    (32, 32, True, 0, 0.0), (32, 32, False, 0, 0.0), (32, 32, True, 8, 0.0),
    (32, 32, True, 0, 5.0), (16, 40, True, 8, 3.0), (16, 40, False, 8, 0.0)])
def test_reference_attention_matches_reference(Sq, Sk, causal, window, softcap):
    """The O(S^2) oracle, end-aligned queries, window and softcap."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(Sq + Sk + window, 2, Sq, Sk, 4, 2, 16)
    want = j_reference_attention(qj, kj, vj, causal=causal, window=window,
                                 softcap=softcap)
    got = t_reference_attention(qt, kt, vt, causal=causal, window=window,
                                softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_ref_oracle_matches_reference():
    (qj, kj, vj), (qt, kt, vt) = _qkv(3, 2, 32, 32, 4, 2, 16)
    want = jref.flash_attention_ref(qj, kj, vj, causal=True, window=8)
    got = tref.flash_attention_ref(qt, kt, vt, causal=True, window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tops.flash_attention(qt, kt, vt, window=8).numpy(),
                               got.numpy(), rtol=2e-5, atol=2e-5)
