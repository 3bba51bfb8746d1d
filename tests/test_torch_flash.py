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
from repro_torch.models.layers import chunked_attention
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
    """Causal, Sq == Sk, no window: the function the training path runs
    (over blocks of 8 keys)."""
    _, (qt, kt, vt) = _qkv(4, 2, 40, 40, 4, 2, 32)
    np.testing.assert_allclose(tops.flash_attention(qt, kt, vt).numpy(),
                               chunked_attention(qt, kt, vt, block_q=8,
                                                 block_k=8).numpy(),
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


# ---- the card kernel's numerical design, emulated in plain torch ----
# The CUDA kernel cannot run here; these pin its arithmetic: 3xTF32 for
# both products in f32, bf16 q.k with p split into two bf16 parts in
# bf16, held at chip_smoke.py's tolerances against the plain version (f32:
# 2e-5 of the largest entry; bf16: that plus 2^-7 of each entry).  The
# single-rounded variants (1xTF32, p rounded once to bf16) must miss them:
# the kernel may not take those shortcuts.

def _tf32(x):
    """cvt.rna.tf32.f32: float32 to 10 mantissa bits, to nearest, ties
    away from zero (add half of the dropped 13 bits' range to the
    magnitude bits, then clear them)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, route):
    """a @ b in f32 as the tensor cores compute it on ``route``."""
    if route == "tf32x1":
        return _tf32(a) @ _tf32(b)
    if route == "tf32x3":            # big.small + small.big + big.big
        ab, bb = _tf32(a), _tf32(b)
        asm, bsm = _tf32(a - ab), _tf32(b - bb)
        return ab @ bsm + asm @ bb + ab @ bb
    return a @ b                     # bf16 values: products exact in f32


def _pv(p, v, route):
    if route == "bf16_split":        # p_lo first, then p_hi, one accumulator
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        return lo @ v + hi @ v
    if route == "bf16_single":
        return p.bfloat16().float() @ v
    return _mm(p, v, route)


def _flash_emulated(q, k, v, *, causal, window, qk_route, pv_route, BK=64):
    """The kernel's online softmax over tiles of BK keys, (BH, S, D): raw
    scores times scale * log2(e), masked at -1e30, p = exp2(s - m), keys
    past Sk p = 0, output acc / max(l, 1e-30) in q's dtype."""
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    mask = tfa.band_mask(Sq, Sk, causal=causal, window=window)
    sl2 = (1.0 / np.sqrt(D)) * np.log2(np.e)
    m = torch.full((q.shape[0], Sq, 1), -1e30)
    l = torch.zeros((q.shape[0], Sq, 1))
    acc = torch.zeros_like(qf)
    for k0 in range(0, Sk, BK):
        kt, vt = kf[:, k0:k0 + BK], vf[:, k0:k0 + BK]
        s = _mm(qf, kt.transpose(1, 2), qk_route) * np.float32(sl2)
        s = s.masked_fill(~mask[:, k0:k0 + BK], -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + _pv(p, vt, pv_route)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _err_over_tol(got, want):
    rtol = 2 ** -7 if got.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    bound = 2e-5 * want.abs().max() + rtol * want.abs()
    return float(((got - want).abs() / bound).max())


def _design_inputs(D, dtype, S=256, BH=2):
    rng = np.random.default_rng(D)
    return [torch.from_numpy(rng.normal(size=(BH, S, D)).astype(np.float32))
            .to(dtype) for _ in range(3)]


def test_tf32_rounding_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10                 # TF32 spacing in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0])
    assert torch.equal(_tf32(x), want)


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("window", [0, 96])
def test_flash_3xtf32_design_meets_f32_tolerance(D, window):
    """f32: 3xTF32 for q.k and p.v is within 2e-5 of the max; one TF32
    rounding (1xTF32) is not."""
    q, k, v = _design_inputs(D, torch.float32)
    want = tfa.flash_attention_bhsd_plain(q, k, v, causal=True, window=window)
    three = _flash_emulated(q, k, v, causal=True, window=window,
                            qk_route="tf32x3", pv_route="tf32x3")
    one = _flash_emulated(q, k, v, causal=True, window=window,
                          qk_route="tf32x1", pv_route="tf32x1")
    assert _err_over_tol(three, want) <= 0.1
    assert _err_over_tol(one, want) > 1.0


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("window", [0, 96])
def test_flash_split_bf16_design_meets_bf16_tolerance(D, window):
    """bf16: q.k of bf16 values in f32, p = p_hi + p_lo in two bf16
    products is within the bf16 tolerance; p rounded once to bf16 is not."""
    q, k, v = _design_inputs(D, torch.bfloat16)
    want = tfa.flash_attention_bhsd_plain(q, k, v, causal=True, window=window)
    split = _flash_emulated(q, k, v, causal=True, window=window,
                            qk_route="bf16", pv_route="bf16_split")
    single = _flash_emulated(q, k, v, causal=True, window=window,
                             qk_route="bf16", pv_route="bf16_single")
    assert split.dtype == torch.bfloat16
    assert _err_over_tol(split, want) <= 1.0
    assert _err_over_tol(single, want) > 1.0


def test_flash_sweep_variants_match_the_kernel_source():
    """Each design variant of ``kernels/flash_sweep.py`` is one text
    substitution of the CUDA source: the text must still be there, once."""
    from repro_torch.kernels import build as tbuild
    from repro_torch.kernels import flash_sweep

    src = tbuild.SOURCES["flash_attention"].read_text()
    assert flash_sweep.VARIANTS["chosen"] is None
    for name, sub in flash_sweep.VARIANTS.items():
        if sub is not None:
            assert src.count(sub[0]) == 1, name
