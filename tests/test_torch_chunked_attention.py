"""Port parity for the blockwise attention
(``repro_torch.models.layers.chunked_attention``) against the reference's
(``repro.models.layers.chunked_attention``), at small sizes, and a
meta-device census of its matmul FLOPs at paper-lm's full shapes.

The function over a grid: causal and not, windows 0, 16 and 40 (not a
multiple of the block), the softcap, GQA with KH in {1, 2, H}, Sq != Sk,
``q_offset`` > 0, lengths whose block ``_pick_block`` trims (100 with
block 32 picks 25), both schedules; the differentiable form's gradients
against ``jax.grad`` of the reference.  The census: at S = 4,096 the
attention computes 36/64 of the S x S square causal, 15/64 with a window
of 512, 64/64 non-causal.  The models at block 16 and remat are in
``tests/test_torch_remat.py``.

Tolerances (float32 sums in another order): rtol = atol = 1e-5
(``tests/test_torch_dense.py``); each gradient rtol 1e-5, atol 1e-5 x its
largest entry.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.models import layers as jlayers
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# (Sq, Sk, H, KH, causal, window, softcap, q_offset, block)
GRID = [
    (64, 64, 4, 4, True, 0, 0.0, 0, 16),
    (64, 64, 4, 2, True, 0, 20.0, 0, 16),
    (64, 64, 4, 1, True, 16, 0.0, 0, 16),
    (64, 64, 4, 2, True, 40, 20.0, 0, 16),
    (100, 100, 4, 2, True, 40, 0.0, 0, 32),       # blocks of 25
    (32, 64, 4, 2, True, 0, 0.0, 32, 16),         # q_offset: the last 32 rows
    (32, 64, 4, 1, True, 16, 5.0, 32, 16),
    (48, 80, 4, 2, False, 0, 0.0, 0, 16),         # cross-attention's shapes
    (64, 64, 4, 4, False, 0, 5.0, 0, 16),         # the encoder's
    (33, 50, 4, 1, False, 0, 0.0, 0, 16),         # 11 and 10: trimmed
]


def _qkv(sq, sk, h, kh, seed, d=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, sq, h, d)).astype(np.float32) * 2
    k = rng.normal(size=(2, sk, kh, d)).astype(np.float32) * 2
    v = rng.normal(size=(2, sk, kh, d)).astype(np.float32)
    return q, k, v


def test_pick_block_matches_reference():
    for seq, want in ((512, 512), (4096, 512), (1500, 512), (100, 32), (97, 16),
                      (33, 16), (8, 16), (1, 512)):
        assert tlayers._pick_block(seq, want) == jlayers._pick_block(seq, want)
    assert tlayers._pick_block(1500, 512) == 500
    assert tlayers._pick_block(100, 32) == 25
    assert tlayers._pick_block(97, 16) == 1


@pytest.mark.parametrize("differentiable", [True, False])
@pytest.mark.parametrize("sq,sk,h,kh,causal,window,softcap,q_offset,blk", GRID)
def test_chunked_attention_matches_reference(sq, sk, h, kh, causal, window,
                                             softcap, q_offset, blk,
                                             differentiable):
    q, k, v = _qkv(sq, sk, h, kh, seed=sq + sk + kh + window)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset,
              block_q=blk, block_k=blk, differentiable=differentiable)
    want = jax.jit(lambda *a: jlayers.chunked_attention(*a, **kw))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tlayers.chunked_attention(_t(q), _t(k), _t(v), **kw)
    assert got.shape == (2, sq, h, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if causal and not q_offset and sq == sk:
        oracle = tlayers.reference_attention(_t(q), _t(k), _t(v), window=window,
                                             softcap=softcap)
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL)


@pytest.mark.parametrize("sq,sk,h,kh,causal,window,softcap,q_offset,blk",
                         [GRID[i] for i in (1, 3, 4, 6, 7, 9)])
def test_chunked_attention_grads_match_reference(sq, sk, h, kh, causal, window,
                                                 softcap, q_offset, blk):
    """The differentiable form's gradients w.r.t. q, k and v against
    ``jax.grad`` of the reference, for a random cotangent."""
    q, k, v = _qkv(sq, sk, h, kh, seed=sq + sk + kh + window + 1)
    ct = np.random.default_rng(7).normal(size=(2, sq, h, 32)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset,
              block_q=blk, block_k=blk)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jlayers.chunked_attention(*a, **kw)
                                             * jnp.asarray(ct)),
                          argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    (tlayers.chunked_attention(*ts, **kw) * _t(ct)).sum().backward()
    for name, a, b in zip("qkv", ts, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("s,block_q,block_k,window", [
    (18, 8, 12, 3),       # blocks of 6 and 9: q blocks visit 1, 2, 1 key blocks
    (37, 16, 16, 8),      # a prime length: blocks of 1
    (40, 16, 16, 0),      # blocks of 8: 5 x 5, causal
])
def test_chunked_attention_uneven_blocks_match_reference(s, block_q, block_k,
                                                         window):
    """Query and key blocks of other sizes (the q blocks are then taken in
    the order of how many key blocks they visit), and a prime length whose
    blocks ``_pick_block`` trims to 1: values of both forms and the
    gradients against the reference."""
    q, k, v = _qkv(s, s, 4, 2, seed=s + window)
    ct = np.random.default_rng(8).normal(size=(2, s, 4, 32)).astype(np.float32)
    kw = dict(window=window, block_q=block_q, block_k=block_k)
    want = jax.jit(lambda *a: jlayers.chunked_attention(*a, **kw))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for differentiable in (True, False):
        got = tlayers.chunked_attention(_t(q), _t(k), _t(v),
                                        differentiable=differentiable, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jlayers.chunked_attention(*a, **kw)
                                             * jnp.asarray(ct)),
                          argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    (tlayers.chunked_attention(*ts, **kw) * _t(ct)).sum().backward()
    for name, a, b in zip("qkv", ts, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_prefill_form_builds_no_graph():
    """``differentiable=False`` runs under ``torch.no_grad`` (the
    reference's prefill form cannot be differentiated either) and gives
    the differentiable form's numbers bit for bit."""
    q, k, v = (_t(a).requires_grad_(True) for a in _qkv(64, 64, 4, 2, seed=3))
    kw = dict(window=16, block_q=16, block_k=16)
    off = tlayers.chunked_attention(q, k, v, differentiable=False, **kw)
    on = tlayers.chunked_attention(q, k, v, **kw)
    assert off.grad_fn is None and on.grad_fn is not None
    assert torch.equal(off, on.detach())


def test_chunked_attention_float64_and_narrower_v():
    """A float64 input computes in float64; MLA's narrower v equals the
    reference's zero-padded v sliced back."""
    q, k, v = _qkv(64, 64, 4, 4, seed=5, d=48)
    v = v[..., :32]
    got64 = tlayers.chunked_attention(_t(q).double(), _t(k).double(),
                                      _t(v).double(), block_q=16, block_k=16)
    assert got64.dtype == torch.float64
    padded = np.concatenate([v, np.zeros((2, 64, 4, 16), np.float32)], -1)
    want = jax.jit(lambda *a: jlayers.chunked_attention(
        *a, scale=0.125, block_q=16, block_k=16))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(padded))
    got = tlayers.chunked_attention(_t(q), _t(k), _t(v), scale=0.125,
                                    block_q=16, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., :32], **TOL)
    np.testing.assert_allclose(got64.float().numpy(), tlayers.chunked_attention(
        _t(q), _t(k), _t(v), block_q=16, block_k=16).numpy(), **TOL)


# ---------------------------------------------------------------------------
# the census at S = 4,096
# ---------------------------------------------------------------------------

def _attention_flops(S_, window, causal):
    cfg = tconfigs.get("paper-lm")
    H, D = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = (torch.empty((1, S_, H, D), device="meta") for _ in range(3))
    with FlopCounterMode(display=False) as fc:
        tlayers.chunked_attention(q, k, v, causal=causal, window=window)
    return fc.get_total_flops(), 2 * 2 * H * S_ * S_ * D


@pytest.mark.parametrize("window,causal,blocks", [(0, True, 36), (512, True, 15),
                                                  (0, False, 64)])
def test_attention_census_at_4096(window, causal, blocks):
    """paper-lm's heads at S = 4,096 on the meta device: the matmul FLOPs
    are the visited blocks' share of the S x S square (8 x 8 blocks of
    512): 36/64 causal, 15/64 with a window of 512, 64/64 non-causal."""
    got, square = _attention_flops(4096, window, causal)
    assert got * 64 == square * blocks
    assert math.isclose(got / square, blocks / 64)
