"""Port parity for block remat and the models' blockwise attention
(``repro_torch.models.lm``: ``loss_fn(remat=, block_q=, block_k=)``,
``prefill(block_q=, block_k=)``) against the reference
(``repro.models.lm``), at smoke size.

The models at block 16 and S = 64, so attention streams several blocks:
paper-lm, gemma3 (window 16), deepseek-v2-lite (MLA), whisper (48
frames) and internvl2 (8 prefix tokens, 72 positions: blocks of 12).
The loss and every gradient leaf of the port under remat "none" and
"block" against the reference's (its default, "block"); prefill logits
and cache.  Then the port alone: gradients with and without remat, bit
for bit on the CPU; what remat wraps (the period layers in train mode
with grad on; not the remainder, the encoder, a prefill); the dry run's
remat trace (FLOPs the no-remat count plus the replayed forward, the
saved bytes down to the layer inputs, the replay's transient).

Tolerances (float32 sums in another order): logits, caches and the aux
rtol = atol = 1e-5, the loss rtol 1e-5 (``tests/test_torch_dense.py``);
each gradient leaf rtol 1e-5, atol 1e-5 x the leaf's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.models import base as jmbase
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_reference
from repro_torch.launch import dryrun
from repro_torch.models import base as tmbase
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm
from repro_torch.utils import tree_flatten, tree_leaves, tree_map, tree_unflatten

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("paper-lm", "gemma3-1b", "deepseek-v2-lite-16b", "whisper-small",
         "internvl2-76b")
B, S, SE, BLK = 2, 64, 48, 16        # batch, tokens, whisper's frames, block


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _params(arch, seed):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jmbase.materialize(jlm.param_specs(jcfg), jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, seed):
    """Tokens and labels (B, S), whisper's frames (B, SE, E) or
    internvl2's prefix (B, Np, E): numpy from a seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(B, SE, cfg.d_model)).astype(np.float32)
    elif cfg.num_prefix_tokens:
        batch["prefix_embed"] = rng.normal(
            size=(B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: _t(v).long() if v.dtype.kind == "i" else _t(v)
            for k, v in batch.items()}


def _port_grads(cfg, params, batch, remat):
    leaves, treedef = tree_flatten(params)
    leaves = [a.clone().requires_grad_(True) for a in leaves]
    loss, m = lm.loss_fn(cfg, tree_unflatten(treedef, leaves), batch,
                         remat=remat, block_q=BLK, block_k=BLK)
    loss.backward()
    return loss.detach(), m, [a.grad for a in leaves]


@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_and_grads_match_reference(arch):
    """The port under remat "none" and "block" against the reference's
    loss and gradient under its default, ``remat="block"``."""
    jcfg, tcfg, jp, tp = _params(arch, seed=1)
    batch = _batch(tcfg, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, jb, remat="block", block_q=BLK,
                              block_k=BLK), has_aux=True))(jp)
    jleaves = [np.asarray(b) for b in jax.tree.leaves(jg)]
    runs = {}
    for remat in ("none", "block"):
        tloss, tm, grads = runs[remat] = _port_grads(tcfg, tp,
                                                     _torch_batch(batch), remat)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(tm["aux"].detach()), float(jm["aux"]),
                                   **TOL)
        assert len(jleaves) == len(grads)
        for a, b in zip(grads, jleaves):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max(),
                                       err_msg=remat)
    # the port alone: the same bits with and without remat
    (l0, _, g0), (l1, _, g1) = runs["none"], runs["block"]
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_matches_reference(arch):
    """Prefill at block 16 (the ``differentiable=False`` form): the last
    logits and every cache leaf."""
    jcfg, tcfg, jp, tp = _params(arch, seed=2)
    batch = _batch(tcfg, seed=2)
    kw = {("enc_frames" if k == "frames" else k): v for k, v in batch.items()
          if k in ("frames", "prefix_embed")}
    jl, jc = jlm.prefill(jcfg, jp, jnp.asarray(batch["tokens"]), block_q=BLK,
                         block_k=BLK, **{k: jnp.asarray(v) for k, v in kw.items()})
    tl, tc = lm.prefill(tcfg, tp, _t(batch["tokens"]).long(), block_q=BLK,
                        block_k=BLK, **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jleaves = jax.tree.leaves(jc)
    assert [tuple(a.shape) for a in tree_leaves(tc)] == [b.shape for b in jleaves]
    for a, b in zip(tree_leaves(tc), jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-7b"])
def test_remat_gradients_equal_no_remat(arch):
    """The port alone: the loss, its metrics and every gradient leaf with
    ``remat="block"`` equal those without it, bit for bit on the CPU (the
    replay recomputes the same ops in the same order, and the tied
    embedding's two contributions meet in the same order, as in the five
    models above); the MoE aux is added once; zamba2's shared block,
    read by several checkpointed layers, sums its gradients as without
    remat."""
    cfg = tconfigs.get_smoke(arch)
    _, _, _, tp = _params(arch, seed=3)
    batch = _torch_batch(_batch(cfg, seed=3))
    l0, m0, g0 = _port_grads(cfg, tp, batch, "none")
    l1, m1, g1 = _port_grads(cfg, tp, batch, "block")
    assert torch.equal(l0, l1)
    for key in ("xent", "aux", "tokens"):
        assert torch.equal(m0[key].detach(), m1[key].detach()), key
    if cfg.moe is not None:
        assert float(m1["aux"].detach()) > 0
    for a, b in zip(g0, g1):
        # zamba2's shared-attention layers' own norms and FFN are never read
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def test_remat_wraps_only_the_period_layers():
    """``remat="block"`` checkpoints the period groups' layers in train mode
    with grad on: not the remainder layers, not the encoder, not a prefill
    and not a forward without grad; MoE routes are recorded once a layer
    (the replay's are hidden)."""
    cfg = tconfigs.get_smoke("olmoe-1b-7b").replace(num_layers=3)
    cfg = cfg.replace(blocks=cfg.blocks * 2)             # period 2: 1 group + 1 rem
    tp = tree_map(lambda t: t.requires_grad_(True), tmbase.materialize(
        lm.param_specs(cfg), torch.Generator().manual_seed(4), "cpu"))
    batch = _torch_batch(_batch(cfg, seed=4))
    with lm.record_remat() as calls, tblocks.record_routes() as routes:
        loss, _ = lm.loss_fn(cfg, tp, batch, remat="block")
        loss.backward()
    assert len(calls) == 2 and len(routes) == 3
    with lm.record_remat() as calls:
        lm.loss_fn(cfg, tp, batch, remat="full")
        lm.loss_fn(cfg, tp, batch)
        with torch.no_grad():
            lm.loss_fn(cfg, tp, batch, remat="block")
        lm.prefill(cfg, tp, batch["tokens"])
    assert calls == []
    wcfg = tconfigs.get_smoke("whisper-small")
    wp = tmbase.materialize(lm.param_specs(wcfg), torch.Generator().manual_seed(4),
                            "cpu")
    with lm.record_remat() as calls:
        lm.loss_fn(wcfg, wp, _torch_batch(_batch(wcfg, seed=4)), remat="block")
    assert len(calls) == wcfg.num_layers          # the decoder's, not the encoder's


# ---------------------------------------------------------------------------
# the dry run's remat trace, and the census at S = 4,096
# ---------------------------------------------------------------------------

def _forward_flops(cfg, local_batch, seq):
    params = dryrun.trace_params(cfg, "meta")
    batch = dryrun.worker_batch(cfg, local_batch, seq, "meta")
    with FlopCounterMode(display=False) as fc:
        lm.forward(cfg, params, batch["tokens"])
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", ["paper-lm", "gemma3-1b", "olmoe-1b-7b"])
def test_remat_trace_counts_the_replay(arch):
    """The remat trace's FLOPs are the no-remat count plus one forward of
    the layer stack (the head and the loss are not replayed).  A replay
    stops after the last op whose saved tensors the backward needs
    (checkpoint's early stop): paper-lm's layer ends in the FFN's down
    projection, whose output nothing saves, so its replay leaves that
    matmul out; gemma3's post-norm and olmoe's weighted combine save after
    it.  The saved bytes drop to the layer inputs and the ops outside the
    layers; ``recompute_bytes`` is one layer's saves."""
    cfg = tconfigs.get_smoke(arch)
    none = dryrun.trace_train(cfg, 2, S, device="meta")
    block = dryrun.trace_train(cfg, 2, S, device="meta", remat="block")
    fwd = _forward_flops(cfg, 2, S)
    skipped = (cfg.num_layers * 2 * 2 * S * cfg.d_ff * cfg.d_model
               if arch == "paper-lm" else 0)
    assert block["flops"] == none["flops"] + fwd - skipped
    one_layer = dryrun.trace_train(cfg.replace(num_layers=1), 2, S,
                                   device="meta")["saved_bytes"]
    assert block["saved_bytes"] < none["saved_bytes"]
    assert block["recompute_bytes"] <= one_layer
    assert block["recompute_bytes"] > 0.5 * (none["saved_bytes"]
                                             - block["saved_bytes"]) / cfg.num_layers
    rc = dryrun.reckon_card(cfg, block, workers=2, mode="none")
    assert rc["recompute_bytes"] == block["recompute_bytes"]
    assert rc["step_peak_bytes"] == (rc["step_copies"] * rc["copy_bytes"]
                                     + block["saved_bytes"]
                                     + block["logits_grad_bytes"]
                                     + block["recompute_bytes"])
