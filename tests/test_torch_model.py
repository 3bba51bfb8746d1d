"""Port parity: paper-lm in plain PyTorch vs ``repro.models`` (smoke size).

The JAX weights (``repro.models.base.materialize``) are carried over with
``repro_torch.convert``; the same numpy batch goes through both.
Tolerances: layers and attention rtol/atol 1e-5 (float32 matmuls and
softmax sums taken in another order); loss rtol 2e-6; the grad bucket
atol 1e-5 x its largest entry.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import flatbuf as jfb
from repro.models import base as jmbase
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_reference
from repro_torch.core import flatbuf as tfb
from repro_torch.models import base as tmbase
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.utils import tree_flatten

torch.set_num_threads(2)

B, S = 2, 32


def _setup(seed=0):
    jcfg, tcfg = jconfigs.get_smoke("paper-lm"), tconfigs.get_smoke("paper-lm")
    specs = jlm.param_specs(jcfg)
    jp = jmbase.materialize(specs, jax.random.PRNGKey(seed))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    return jcfg, tcfg, specs, jp, tp, batch, tbatch


def _np(x):
    return np.asarray(x)


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    sc = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(sc)).numpy(),
        _np(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(sc))), rtol=1e-5, atol=1e-6)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                           theta=10_000.0).numpy(),
        _np(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=10_000.0)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kh", [4, 2])
def test_causal_attention_matches_chunked_attention(kh):
    """The port's ``chunked_attention`` against the reference's, both
    over several 16-wide q/kv blocks (GQA at kh=2)."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 64, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, 64, kh, 32)).astype(np.float32)
    v = rng.normal(size=(2, 64, kh, 32)).astype(np.float32)
    got = tlayers.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=True, block_q=16, block_k=16)
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=True, block_q=16, block_k=16)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_forward_and_loss_match_reference():
    jcfg, tcfg, specs, jp, tp, batch, tbatch = _setup()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    hid_j = jlm.forward(jcfg, jp, jb["tokens"])["hidden"]
    hid_t = tlm.forward(tcfg, tp, tbatch["tokens"])
    np.testing.assert_allclose(hid_t.numpy(), _np(hid_j), rtol=1e-5, atol=1e-5)
    lj, mj = jlm.loss_fn(jcfg, jp, jb)
    lt, mt = tlm.loss_fn(tcfg, tp, tbatch)
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-6)
    assert int(mt["tokens"]) == int(mj["tokens"]) == B * S
    # ignored labels (< 0) drop out of both
    jb2 = dict(jb, labels=jb["labels"].at[:, :5].set(-1))
    tb2 = dict(tbatch, labels=tbatch["labels"].clone())
    tb2["labels"][:, :5] = -1
    np.testing.assert_allclose(float(tlm.loss_fn(tcfg, tp, tb2)[0]),
                               float(jlm.loss_fn(jcfg, jp, jb2)[0]), rtol=2e-6)


def test_grad_bucket_matches_reference():
    """The gradient taken w.r.t. the param BUCKET (the resident path's
    way) equals the reference's AD-through-unflatten grad bucket, and its
    padding is exactly zero (the grad-clip norm relies on it)."""
    jcfg, tcfg, specs, jp, tp, batch, tbatch = _setup(4)
    wd = jmbase.norm_param_mask(specs)
    jl = jfb.build_layout(jp, wd_mask=wd)
    jbuf = jfb.flatten(jl, jp)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    gj = jax.grad(lambda bufs: jlm.loss_fn(jcfg, jfb.unflatten(jl, bufs),
                                           jbatch)[0])(jbuf)[0]
    tl = tfb.build_layout(tp, wd_mask=tmbase.norm_param_mask(
        tlm.param_specs(tcfg)))
    src = [b.requires_grad_(True) for b in tfb.flatten(tl, tp)]
    loss, _ = tlm.loss_fn(tcfg, tfb.unflatten(tl, src), tbatch)
    (gt,) = torch.autograd.grad(loss, src)
    gj = _np(gj)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                               atol=1e-5 * np.abs(gj).max())
    pad = tfb.valid_mask(tl, 0) == 0
    assert (gt.numpy()[pad] == 0).all()


def test_materialize_follows_the_init_law():
    """The port draws its own numbers (torch.Generator), with the
    reference's law: ones for norms, std 0.02 embeddings, fan-in normal."""
    specs = tlm.param_specs(tconfigs.get_smoke("paper-lm"))
    p = tmbase.materialize(specs, torch.Generator().manual_seed(0), "cpu")
    q = tmbase.materialize(specs, torch.Generator().manual_seed(0), "cpu")
    for a, b in zip(tree_flatten(p)[0], tree_flatten(q)[0]):
        assert torch.equal(a, b) and a.dtype == torch.float32
    assert torch.equal(p["final_norm"], torch.ones(128))
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    wq = p["layers"][0]["mix"]["wq"]                    # fan-in 128
    assert abs(float(wq.std()) - 1 / math.sqrt(128)) < 5e-3
    wd = p["layers"][0]["ffn"]["wd"]                    # fan-in 256
    assert abs(float(wd.std()) - 1 / math.sqrt(256)) < 5e-3


def test_unported_model_families_raise():
    """No family waits for a later slice any more: an untied head (olmoe,
    deepseek, the dense variants), the recurrent blocks (mamba2, mLSTM,
    with or without an FFN), whisper's encoder + cross-attention and
    internvl2's prefix tokens build; what the port does not run raises,
    naming why (an unknown FFN kind; a cross-attention decoder on the
    paged engine, which feeds no encoder frames)."""
    from repro_torch.configs import base as tcb
    from repro_torch.configs.base import BlockDef
    cfg = tconfigs.get_smoke("paper-lm")
    assert "head" in tlm.param_specs(cfg.replace(tie_embeddings=False))
    ssm = tcb.SSMConfig(state_dim=16, head_dim=32, chunk=16)
    for blocks, mixer in (((BlockDef("mamba2", "none"),), "wxbc"),
                          ((BlockDef("mlstm", "swiglu"),), "w_up")):
        specs = tlm.param_specs(cfg.replace(blocks=blocks, ssm=ssm))
        layer = specs["layers"][0]
        assert mixer in layer["mix"]
        assert ("ffn" in layer) == (blocks[0].ffn != "none")
    enc = tlm.param_specs(cfg.replace(encoder_layers=2, cross_attention=True,
                                      family="audio"))
    assert "enc" in enc and "frontend" in enc and "xattn" in enc["layers"][0]
    vlm = tlm.param_specs(cfg.replace(num_prefix_tokens=16))
    assert "frontend" in vlm and "enc" not in vlm
    with pytest.raises(ValueError, match="relu"):
        tlm.param_specs(cfg.replace(blocks=(BlockDef("attn", "relu"),)))
    from repro_torch.launch.steps import build_engine
    with pytest.raises(ValueError, match="encoder frames"):
        build_engine(tconfigs.get_smoke("whisper-small"),
                     type("S", (), {"global_batch": 2, "seq_len": 16})(),
                     device="cpu")
