"""Port parity: MLA, DeepSeek-V2's multi-head latent attention
(``repro_torch.models.blocks.mla_apply`` vs ``repro.models.blocks``), at
the smoke size of deepseek-v2-lite-16b.

Train and prefill build the full per-head k/v from the latent; decode
scores in the latent space with ``w_uk`` absorbed into q.  Each mode is
held against the reference on the same weights and inputs (rtol 1e-5,
atol 1e-5: float32 matmuls and softmax sums in another order; the
reference's online-softmax attention takes its sums blockwise), and the
port's absorbed decode against its own full path at the same position
(rtol 1e-4, atol 1e-5: the two are different operation orders, and the
reference holds them to each other only to a tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import base as jmbase
from repro.models import blocks as jB
from repro.models import layers as jlayers
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_reference
from repro_torch.models import blocks as tB
from repro_torch.models import layers as tlayers

torch.set_num_threads(2)

ARCH = "deepseek-v2-lite-16b"
B, S, MAX = 2, 24, 32
RTOL, ATOL = 1e-5, 1e-5


def _setup(seed=0):
    jcfg, tcfg = jconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    jp = jmbase.materialize(jB.mla_specs(jcfg), jax.random.PRNGKey(seed))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    return jcfg, tcfg, jp, tp, x, pos, rng


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mla_full_path_matches_reference(mode):
    jcfg, tcfg, jp, tp, x, pos, _ = _setup()
    jy, jc = jB.mla_apply(jcfg, jp, jnp.asarray(x),
                          jB.Ctx(mode=mode, positions=jnp.asarray(pos),
                                 block_q=8, block_k=8))
    with torch.no_grad():
        ty, tc = tB.mla_apply(tcfg, tp, torch.from_numpy(x),
                              tB.Ctx(mode=mode, positions=torch.from_numpy(pos)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    if mode == "train":
        assert jc is None and tc is None
        return
    assert sorted(tc) == sorted(jc) == ["ckv", "k_rope"]
    for k in tc:
        assert tuple(tc[k].shape) == jc[k].shape
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=RTOL,
                                   atol=ATOL)


def test_mla_train_grads_match_reference():
    jcfg, tcfg, jp, tp, x, pos, rng = _setup(1)
    g = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)

    def f(p, xx):
        y, _ = jB.mla_apply(jcfg, p, xx, jB.Ctx(mode="train",
                                                positions=jnp.asarray(pos),
                                                block_q=8, block_k=8))
        return jnp.sum(y * jnp.asarray(g))
    gp, gx = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = tB.mla_apply(tcfg, tp, xt, tB.Ctx(mode="train",
                                             positions=torch.from_numpy(pos)))
    torch.sum(y * torch.from_numpy(g)).backward()
    for k in tp:
        want = np.asarray(gp[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), want, rtol=RTOL,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=RTOL,
                               atol=1e-6 * np.abs(np.asarray(gx)).max())


@pytest.mark.parametrize("vector", [False, True])
def test_mla_absorbed_decode_matches_reference(vector):
    """One decode token against a cache of random latents, the new
    token's entries written at ``cache_len - 1`` (per row when
    ``vector``)."""
    jcfg, tcfg, jp, tp, x, _, rng = _setup(2)
    m = tcfg.mla
    ckv = rng.normal(size=(B, MAX, m.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, MAX, m.qk_rope_dim)).astype(np.float32)
    cl = np.array([9, 17], np.int32) if vector else np.int32(13)
    pos = (np.broadcast_to(np.asarray(cl).reshape(-1), (B,)) - 1)[:, None]
    xt = x[:, :1]
    jy, jc = jB.mla_apply(jcfg, jp, jnp.asarray(xt), jB.Ctx(
        mode="decode", positions=jnp.asarray(pos),
        cache={"ckv": jnp.asarray(ckv), "k_rope": jnp.asarray(kr)},
        cache_len=jnp.asarray(cl)))
    cache = {"ckv": torch.from_numpy(ckv.copy()), "k_rope": torch.from_numpy(kr.copy())}
    with torch.no_grad():
        ty, tc = tB.mla_apply(tcfg, tp, torch.from_numpy(xt), tB.Ctx(
            mode="decode", positions=torch.from_numpy(pos),
            cache=cache, cache_len=torch.as_tensor(cl)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    assert tc["ckv"] is cache["ckv"]                      # written in place
    for k in ("ckv", "k_rope"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=RTOL,
                                   atol=ATOL)


def test_mla_absorbed_decode_matches_full_path():
    """Prefill S-1 tokens, decode the S-th: the latent-space decode equals
    the full path's output at position S-1."""
    _, tcfg, _, tp, x, pos, _ = _setup(3)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        full, _ = tB.mla_apply(tcfg, tp, xt, tB.Ctx(
            mode="train", positions=torch.from_numpy(pos)))
        _, c = tB.mla_apply(tcfg, tp, xt[:, :S - 1], tB.Ctx(
            mode="prefill", positions=torch.from_numpy(pos[:, :S - 1])))
        cache = {k: torch.cat([v, v.new_zeros(B, MAX - (S - 1), v.shape[-1])], 1)
                 for k, v in c.items()}
        dec, _ = tB.mla_apply(tcfg, tp, xt[:, S - 1:], tB.Ctx(
            mode="decode", positions=torch.from_numpy(pos[:, S - 1:]),
            cache=cache, cache_len=S))
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=1e-4, atol=ATOL)


def test_causal_attention_takes_a_narrower_v():
    """v narrower than q/k equals the reference's way (v zero-padded to
    q's width, the output sliced back), with the explicit scale."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(2, 16, 4, 48)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 16, 4, 48)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 16, 4, 32)).astype(np.float32))
    got = tlayers.chunked_attention(q, k, v, scale=0.125, block_q=8, block_k=8)
    padded = torch.cat([v, v.new_zeros(2, 16, 4, 16)], -1)
    want = tlayers.chunked_attention(q, k, padded, scale=0.125, block_q=8,
                                     block_k=8)[..., :32]
    assert got.shape == (2, 16, 4, 32)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    jwant = jlayers.chunked_attention(*(jnp.asarray(a.numpy())
                                        for a in (q, k, padded)), causal=True,
                                      scale=0.125, block_q=8, block_k=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant)[..., :32],
                               rtol=RTOL, atol=ATOL)
