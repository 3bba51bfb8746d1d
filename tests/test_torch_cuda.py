"""On the card: the port's CUDA kernels against their plain versions, and
the trainer on the card against the trainer on the CPU.

Every test here is marked ``cuda`` and skips with a reason without a GPU.
This file imports torch and the port only (no JAX), so it also runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: the elementwise SGD update 2e-6 x the largest entry (nvcc
contracts a*b+c into one FMA, the plain version rounds twice);
reductions rtol 1e-5 (float32 sums in another order); sign exact.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import InputShape, LocalSGDConfig, OptimConfig, RunConfig
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.kernels import fused_bucket as tkb
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import build_train
from repro_torch.models import base as mbase
from repro_torch.utils import tree_map


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3096 + 5, 264])
def test_cuda_kernels_match_plain(cuda, rows):
    """Each kernel against its plain version on the same CUDA inputs, and
    one launch counted per wrapper call."""
    dev = cuda
    tkb.reset_launches()
    g = torch.Generator(device=dev).manual_seed(rows)
    mk = lambda: torch.randn((4, rows, 128), generator=g, device=dev)
    p, gr, u = mk(), mk(), 0.1 * mk()
    wd_row = (torch.rand((rows,), generator=g, device=dev) < 0.7).float()
    gscale = torch.tensor([1.0, 0.5, 0.25, 0.125], device=dev)
    for nesterov in (True, False):
        p1, u1, p2, u2 = p.clone(), u.clone(), p.clone(), u.clone()
        kw = dict(momentum=0.9, weight_decay=1e-2, nesterov=nesterov,
                  gscale=gscale, stats=True)
        st_k = tkb.fused_sgd_bucket(p1, gr, u1, 0.05, wd_row, **kw)
        st_p = tkb.fused_sgd_bucket_plain(p2, gr, u2, 0.05, wd_row, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(p1, p2, rtol=0, atol=2e-6 * p2.abs().max().item())
        torch.testing.assert_close(u1, u2, rtol=0, atol=2e-6 * u2.abs().max().item())
        for a, b in zip(st_k, st_p):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    assert tkb.fused_sgd_bucket(p1, gr, u1, 0.05, wd_row, momentum=0.9,
                                weight_decay=0.0, nesterov=True) is None
    x = mk()
    torch.testing.assert_close(tkb.sq_sum(x), tkb.sq_sum_plain(x), rtol=1e-5, atol=0)
    torch.testing.assert_close(tkb.sq_sum(x[0]), tkb.sq_sum_plain(x[0]),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(tkb.row_abs_sum(x), tkb.row_abs_sum_plain(x),
                               rtol=1e-5, atol=1e-5)
    s = torch.rand((rows,), generator=g, device=dev)
    x[:, :3] = 0.0
    assert torch.equal(tkb.scale_sign_rows(x, s), tkb.scale_sign_rows_plain(x, s))
    assert tkb.LAUNCHES == {"fused_sgd_bucket": 3, "sq_sum": 2,
                            "row_abs_sum": 1, "scale_sign_rows": 1}


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_input(cuda):
    x = torch.zeros((2, 8, 128), device=cuda)
    with pytest.raises(TypeError):
        tkb.sq_sum(x.double())
    with pytest.raises(ValueError):
        tkb.row_abs_sum(x[:, :, :64])
    with pytest.raises(ValueError):
        tkb.sq_sum(x.transpose(0, 1))
    with pytest.raises(ValueError):
        tkb.scale_sign_rows(x, torch.zeros(8))          # scale on the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "ef_sign"])
def test_trainer_on_card_matches_cpu(cuda, mode):
    """paper-lm smoke, post-local SGD, from the same weights: the card's
    kernels and the CPU's plain versions give the same per-step loss
    (rtol 1e-4) and the same params, all but 1e-4 of the elements within
    1e-4 x the largest entry (an EF-sign delta within rounding of 0 may
    flip)."""
    W, B, S = 4, 2, 64
    cfg = configs.get_smoke("paper-lm")
    run = RunConfig(model=cfg, shape=InputShape("t", S, W * B, "train"),
                    local_sgd=LocalSGDConfig(local_steps=2, post_local_switch=2,
                                             sync_compression=mode),
                    optim=OptimConfig(base_lr=0.3, base_batch=W * B,
                                      lr_warmup_steps=2, grad_clip=1.0))
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=64, seq_len=S))
    p0 = mbase.materialize(build_train(run, num_workers=W, device="cpu").specs,
                           torch.Generator().manual_seed(0), "cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        tkb.reset_launches()
        tb = build_train(run, num_workers=W, device=dev)
        state, hist, summ = ttrain.fit(run, ShardedBatches(data, W, B), bundle=tb,
                                       num_steps=6,
                                       params0=tree_map(lambda t: t.to(dev), p0),
                                       log=lambda *a: None)
        out[dev] = (state.params.buckets[0].cpu(), [h["loss"] for h in hist],
                    dict(tkb.LAUNCHES), summ["comm_rounds"]["global"])
    (pg, lg, cg, ng), (pc, lc, cc, nc) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    d = (pg - pc).abs()
    assert float((d > 1e-4 * pc.abs().max()).float().mean()) <= 1e-4
    assert ng == nc == 4
    comp = ng if mode != "none" else 0
    assert cg == {"fused_sgd_bucket": 6, "sq_sum": 6, "row_abs_sum": comp,
                  "scale_sign_rows": comp}
    assert all(v == 0 for v in cc.values())
