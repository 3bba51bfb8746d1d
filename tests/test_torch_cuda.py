"""On the card: the port's CUDA kernels against their plain versions, and
the trainer on the card against the trainer on the CPU.

Every test here is marked ``cuda`` and skips with a reason without a GPU.
This file imports torch and the port only (no JAX), so it also runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: the elementwise SGD / LARS update 2e-6 x the largest entry
(nvcc contracts a*b+c into one FMA, the plain version rounds twice);
reductions rtol 1e-5 (float32 sums in another order); sign exact.  The
per-tensor SGD kernel rounds every operation on its own, as its plain
version does: 2e-6 of the largest entry in f32 and one bf16 ulp in bf16
are the stated bounds, not the expected error.  Flash attention: 2e-5 x
the largest entry in f32 (the reference's own test tolerance; online
against dense softmax); in bf16, both compute in f32 and round once, so
each entry within one bf16 rounding (2^-7 of itself) plus that 2e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import (ControllerConfig, InputShape,
                                      LocalSGDConfig, OptimConfig, RunConfig)
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import lm_examples, markov_lm
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_bucket as tkb
from repro_torch.kernels import fused_sgd as tfs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sign_compress as tsc
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import build_train
from repro_torch.models import base as mbase
from repro_torch.telemetry.stats import round_summary
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
                            "row_abs_sum": 1, "scale_sign_rows": 1,
                            "lars_row_norms": 0, "fused_lars_bucket": 0}


@pytest.mark.cuda
def test_cuda_mlp_bucket_kernels_match_plain(cuda):
    """The three kernels of the paper harness's path at its bucket (K=8
    workers x 624 rows: the width-256 MLP), as the harness calls them (no
    clip scale, no stats), against their plain versions; one launch each."""
    tkb.reset_launches()
    g = torch.Generator(device=cuda).manual_seed(624)
    mk = lambda: torch.randn((8, 624, 128), generator=g, device=cuda)
    p, gr, u = mk(), mk(), 0.1 * mk()
    wd_row = (torch.rand((624,), generator=g, device=cuda) < 0.9).float()
    kw = dict(momentum=0.9, weight_decay=1e-4, nesterov=True)
    p1, u1, p2, u2 = p.clone(), u.clone(), p.clone(), u.clone()
    assert tkb.fused_sgd_bucket(p1, gr, u1, 0.15, wd_row, **kw) is None
    tkb.fused_sgd_bucket_plain(p2, gr, u2, 0.15, wd_row, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(p1, p2, rtol=0, atol=2e-6 * p2.abs().max().item())
    torch.testing.assert_close(u1, u2, rtol=0, atol=2e-6 * u2.abs().max().item())
    x = mk()
    x[:, :7] = 0.0
    torch.testing.assert_close(tkb.row_abs_sum(x), tkb.row_abs_sum_plain(x),
                               rtol=1e-5, atol=1e-5)
    s = torch.rand((624,), generator=g, device=cuda)
    assert torch.equal(tkb.scale_sign_rows(x, s), tkb.scale_sign_rows_plain(x, s))
    assert tkb.LAUNCHES == {"fused_sgd_bucket": 1, "sq_sum": 0,
                            "row_abs_sum": 1, "scale_sign_rows": 1,
                            "lars_row_norms": 0, "fused_lars_bucket": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "ef_sign"])
def test_paper_harness_on_card_matches_cpu(cuda, mode):
    """The paper harness (``benchmarks.common.train_local_sgd``, width 64,
    K=4, post-local SGD) on the card and on the CPU from the same weights:
    per-step loss rtol 1e-4, params all but 1e-4 of the elements within
    1e-4 x the largest entry, the same comm rounds; one fused SGD launch a
    step and, under EF-sign, one compressor pair a sync, on the card only."""
    from repro_torch.benchmarks import common as hc
    train, _ = hc.dataset()
    kw = dict(K=4, B_loc=16, H=4, steps=16, post_local_switch=8, lr=0.05,
              width=64, sync_compression=mode, return_history=True, train=train)
    out = {}
    for dev in ("cuda", "cpu"):
        tkb.reset_launches()
        st, comm, hist = hc.train_local_sgd(device=dev, **kw)
        out[dev] = (st.params.buckets[0].cpu(), [h["loss"] for h in hist],
                    dict(tkb.LAUNCHES), comm)
    (pg, lg, cg, ng), (pc, lc, cc, nc) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    d = (pg - pc).abs()
    assert float((d > 1e-4 * pc.abs().max()).float().mean()) <= 1e-4
    assert ng == nc == 10
    comp = ng if mode != "none" else 0
    assert cg == {"fused_sgd_bucket": 16, "sq_sum": 0, "row_abs_sum": comp,
                  "scale_sign_rows": comp, "lars_row_norms": 0,
                  "fused_lars_bucket": 0}
    assert all(v == 0 for v in cc.values())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 3096 + 5, 65_536 + 3])
@pytest.mark.parametrize("W", [1, 4])
def test_cuda_sq_sum_one_launch_same_bits(cuda, W, rows):
    """sq_sum within 1e-5 relative of its plain version (float32 sums in
    another order), per worker and on a lone bucket; the same bits on every
    call (the fold takes the partials in block order, no atomics in the
    sum); the per-stream scratch reused from call to call, a second stream
    given its own; one launch counted per call."""
    tkb.reset_launches()
    g = torch.Generator(device=cuda).manual_seed(W * rows)
    x = torch.randn((W, rows, 128), generator=g, device=cuda)
    x[:, :3] = 0.0
    a = tkb.sq_sum(x)
    torch.testing.assert_close(a, tkb.sq_sum_plain(x), rtol=1e-5, atol=0)
    key = (x.get_device(), torch.cuda.current_stream().cuda_stream)
    scratch = tkb._SQ_SUM_SCRATCH[key]
    assert scratch[1].numel() >= W
    assert torch.equal(a, tkb.sq_sum(x))
    assert tkb._SQ_SUM_SCRATCH[key] is scratch
    lone = tkb.sq_sum(x[W - 1])
    assert lone.shape == ()
    torch.testing.assert_close(lone, tkb.sq_sum_plain(x[W - 1]), rtol=1e-5, atol=0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        b, c = tkb.sq_sum(x), tkb.sq_sum(x)
        side_key = (x.get_device(), side.cuda_stream)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c)
    assert side_key in tkb._SQ_SUM_SCRATCH and tkb._SQ_SUM_SCRATCH[key] is scratch
    assert all(int(t.abs().sum()) == 0                     # tickets left zeroed
               for _, t in tkb._SQ_SUM_SCRATCH.values())
    assert tkb.LAUNCHES["sq_sum"] == 5


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3096 + 5, 264])
def test_cuda_lars_kernels_match_plain(cuda, rows):
    """The two LARS kernels against their plain versions, with a trust
    ratio that differs per worker and per row, stats on."""
    dev = cuda
    tkb.reset_launches()
    g = torch.Generator(device=dev).manual_seed(rows + 1)
    mk = lambda: torch.randn((4, rows, 128), generator=g, device=dev)
    p, gr, u = mk(), mk(), 0.1 * mk()
    wd_row = (torch.rand((rows,), generator=g, device=dev) < 0.7).float()
    ratio = 0.01 + 2 * torch.rand((4, rows), generator=g, device=dev)
    for wd in (0.0, 1e-2):
        for a, b in zip(tkb.lars_row_norms(p, gr, wd_row, weight_decay=wd),
                        tkb.lars_row_norms_plain(p, gr, wd_row, weight_decay=wd)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for nesterov in (True, False):
        p1, u1, p2, u2 = p.clone(), u.clone(), p.clone(), u.clone()
        kw = dict(momentum=0.9, weight_decay=1e-2, nesterov=nesterov, stats=True)
        st_k = tkb.fused_lars_bucket(p1, gr, u1, 0.05, wd_row, ratio, **kw)
        st_p = tkb.fused_lars_bucket_plain(p2, gr, u2, 0.05, wd_row, ratio, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(p1, p2, rtol=0, atol=2e-6 * p2.abs().max().item())
        torch.testing.assert_close(u1, u2, rtol=0, atol=2e-6 * u2.abs().max().item())
        for a, b in zip(st_k, st_p):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    with pytest.raises(ValueError):                        # ratio not per worker
        tkb.fused_lars_bucket(p1, gr, u1, 0.05, wd_row, ratio[0], momentum=0.9,
                              weight_decay=0.0, nesterov=True)
    assert tkb.LAUNCHES == {"fused_sgd_bucket": 0, "sq_sum": 0,
                            "row_abs_sum": 0, "scale_sign_rows": 0,
                            "lars_row_norms": 2, "fused_lars_bucket": 2}


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
                  "scale_sign_rows": comp, "lars_row_norms": 0,
                  "fused_lars_bucket": 0}
    assert all(v == 0 for v in cc.values())


def _topology_fit(dev, p0, block_steps, topology, steps=8):
    """fit of paper-lm smoke, post-local SGD with mean sync, on ``dev``:
    (params, losses, launches, summary)."""
    W, B, S = 4, 2, 64
    cfg = configs.get_smoke("paper-lm")
    run = RunConfig(model=cfg, shape=InputShape("t", S, W * B, "train"),
                    local_sgd=LocalSGDConfig(local_steps=2, post_local_switch=2,
                                             block_steps=block_steps,
                                             sync_topology=topology),
                    optim=OptimConfig(base_lr=0.3, base_batch=W * B,
                                      lr_warmup_steps=2, grad_clip=1.0))
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=64, seq_len=S))
    tkb.reset_launches()
    tb = build_train(run, num_workers=W, device=dev)
    state, hist, summ = ttrain.fit(run, ShardedBatches(data, W, B), bundle=tb,
                                   num_steps=steps,
                                   params0=tree_map(lambda t: t.to(dev), p0),
                                   log=lambda *a: None)
    return (state.params.buckets[0].cpu(), [h["loss"] for h in hist],
            dict(tkb.LAUNCHES), summ)


def _smoke_params():
    cfg = configs.get_smoke("paper-lm")
    return mbase.materialize(build_train(RunConfig(model=cfg), num_workers=4,
                                         device="cpu").specs,
                             torch.Generator().manual_seed(0), "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("topology", ["hierarchical", "overlap"])
def test_hierarchical_trainer_on_card_matches_cpu(cuda, topology):
    """Alg. 5 (block_steps=2, blocks of 2 of 4 workers) through fit, card
    against CPU from the same weights: per-step loss rtol 1e-4, params all
    but 1e-4 of the elements within 1e-4 x the largest (mean sync: no
    sign flips, float32 sums in another order); 3 block + 2 global rounds
    and the same ledger; one fused SGD and one sq_sum launch a step."""
    p0 = _smoke_params()
    (pg, lg, cg, sg), (pc, lc, cc, sc) = (_topology_fit(d, p0, 2, topology)
                                          for d in (cuda, "cpu"))
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    d = (pg - pc).abs()
    assert float((d > 1e-4 * pc.abs().max()).float().mean()) <= 1e-4
    assert sg["comm_rounds"] == sc["comm_rounds"] == {"block": 3, "global": 2}
    assert sg["topology"] == sc["topology"] == f"{topology}(block_size=2)"
    assert sg["ledger"] == sc["ledger"]
    assert cg == {"fused_sgd_bucket": 8, "sq_sum": 8, "row_abs_sum": 0,
                  "scale_sign_rows": 0, "lars_row_norms": 0,
                  "fused_lars_bucket": 0}
    assert all(v == 0 for v in cc.values())


@pytest.mark.cuda
def test_overlap_trainer_on_card_equals_flat(cuda):
    """The overlap topology on the card gives flat's bits (the same
    per-bucket dataflow in another stage order), and agrees with the CPU
    as above."""
    p0 = _smoke_params()
    pf, lf, _, sf = _topology_fit(cuda, p0, 1, "flat")
    po, lo, _, so = _topology_fit(cuda, p0, 1, "overlap")
    assert (sf["topology"], so["topology"]) == ("flat", "overlap")
    assert lf == lo and torch.equal(pf, po)
    pc, lc, _, _ = _topology_fit("cpu", p0, 1, "overlap")
    np.testing.assert_allclose(lo, lc, rtol=1e-4)
    assert float(((po - pc).abs() > 1e-4 * pc.abs().max()).float().mean()) <= 1e-4


# round_summary fields computed from ||mean_k x_k||^2 (post_sync_sq)
SYNC_MEAN_KEYS = ("post_sync_sq", "dispersion", "diversity", "signal_sq",
                  "noise_sq", "noise_ratio")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "ef_sign"])
def test_lars_telemetry_trainer_on_card_matches_cpu(cuda, mode):
    """LARS with telemetry at smoke size, card against CPU from the same
    weights, at chip_smoke.py's phase C settings (lr scaled by 8/32, H=4
    after 4 steps); grad_clip is set and LARS ignores it (no sq_sum
    launch).  Per-step loss rtol 1e-4; params by the fraction rule above;
    every round-summary float within 1e-4 relative.  LARS + EF-sign flips
    more signs than SGD + EF-sign (rounding-level changes of the starting
    weights alone flip more than 1e-4 of the elements on the CPU), so
    there the fraction is 1e-3 and the fields read from ||mean_k x_k||^2,
    which each flip moves by about one element's share, take 1e-2."""
    W, B, S = 4, 2, 64
    cfg = configs.get_smoke("paper-lm")
    run = RunConfig(model=cfg, shape=InputShape("t", S, W * B, "train"),
                    local_sgd=LocalSGDConfig(local_steps=4, post_local_switch=4,
                                             sync_compression=mode),
                    optim=OptimConfig(optimizer="lars", base_lr=0.3,
                                      base_batch=32, lr_warmup_steps=2,
                                      grad_clip=1.0, lars_trust=0.02),
                    controller=ControllerConfig(telemetry=True))
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
                    dict(tkb.LAUNCHES), round_summary(state.stats))
    (pg, lg, cg, sg), (pc, lc, cc, sc) = out["cuda"], out["cpu"]
    flips = mode == "ef_sign"
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    d = (pg - pc).abs()
    assert float((d > 1e-4 * pc.abs().max()).float().mean()) <= (1e-3 if flips else 1e-4)
    assert sg["rounds"] == sc["rounds"] == 4 and sg["comp_measured"] == flips
    for k, v in sc.items():
        tol = 1e-2 if flips and k in SYNC_MEAN_KEYS else 1e-4
        np.testing.assert_allclose(sg[k], v, rtol=tol, atol=0, err_msg=k)
    comp = 4 if flips else 0
    assert cg == {"fused_sgd_bucket": 0, "sq_sum": 0, "row_abs_sum": comp,
                  "scale_sign_rows": comp, "lars_row_norms": 6,
                  "fused_lars_bucket": 6}
    assert all(v == 0 for v in cc.values())


def _bf16_ulp(x):
    """One bf16 ulp at each entry of x (f32), the smallest normal's below it."""
    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 129, 1_000_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nesterov", [True, False])
def test_cuda_fused_sgd_matches_plain(cuda, n, dtype, nesterov):
    """Per-tensor fused SGD against its plain version, lr as a float and
    as a device scalar; one launch per call; new tensors, inputs kept."""
    tfs.reset_launches()
    g = torch.Generator(device=cuda).manual_seed(n)
    p, gr, u = (torch.randn((n,), generator=g, device=cuda).to(dtype)
                for _ in range(3))
    p0 = p.clone()
    kw = dict(momentum=0.9, weight_decay=1e-2, nesterov=nesterov)
    want = tfs.fused_sgd_2d_plain(p, gr, u, 0.05, **kw)
    for lr in (0.05, torch.tensor(0.05, device=cuda)):
        got = tfs.fused_sgd_2d(p, gr, u, lr, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == dtype and a.shape == b.shape
            d = (a.float() - b.float()).abs()
            if dtype == torch.float32:
                assert float(d.max()) <= 2e-6 * float(b.abs().max())
            else:
                assert bool((d <= _bf16_ulp(b)).all())
    assert torch.equal(p, p0)
    assert tfs.LAUNCHES["fused_sgd_2d"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 130, 33_000, 1_000_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sign_compress_kernels_match_plain(cuda, n, dtype):
    """abs_sum within 1e-5 relative and bitwise repeatable; scale_sign
    exact with sign(0) = 0; ops.sign_compress = two launches."""
    tsc.reset_launches()
    g = torch.Generator(device=cuda).manual_seed(n + 7)
    x = torch.randn((n,), generator=g, device=cuda).to(dtype)
    x[::3] = 0.0
    a, b = tsc.abs_sum(x), tsc.abs_sum_plain(x)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    assert torch.equal(a, tsc.abs_sum(x))                 # no atomics
    # starts 1 and 3 elements into the storage (a scalar head before the
    # 16-byte loads), lengths n - 1 and n - 3 (n % 8 != 0 in bf16 for all)
    for off in (1, 3):
        xs = x[off:]
        got = tsc.abs_sum(xs)
        torch.testing.assert_close(got, tsc.abs_sum_plain(xs), rtol=1e-5, atol=0)
        assert torch.equal(got, tsc.abs_sum(xs))
    s = a / n
    y = tsc.scale_sign(x, s)
    assert y.dtype == torch.float32
    assert torch.equal(y, tsc.scale_sign_plain(x, s))
    assert bool((y[::3] == 0).all())
    torch.testing.assert_close(tops.sign_compress(x),
                               torch.sign(x.float()) * x.float().abs().mean(),
                               rtol=1e-5, atol=0)
    assert tsc.LAUNCHES == {"abs_sum": 7, "scale_sign": 2}


def _flash_close(got, want):
    """The flash tolerance above, in got's dtype."""
    rtol = 2 ** -7 if got.dtype == torch.bfloat16 else 0.0
    got, want = got.float().cpu(), want.float().cpu()
    bound = 2e-5 * want.abs().max() + rtol * want.abs()
    return bool(((got - want).abs() <= bound).all())


# query and key lengths at the kernel's tile edges (64-row query tiles,
# 64- or 32-key tiles), Sq != Sk
FLASH_EDGE_LENGTHS = ((1, 63), (63, 65), (65, 63), (127, 129), (129, 127),
                      (200, 1), (1, 200), (65, 200), (200, 129))


@pytest.mark.cuda
@pytest.mark.parametrize("D", tfa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 40),
                                           (False, 40), (True, 64), (False, 64)])
def test_cuda_flash_matches_plain(cuda, D, dtype, causal, window):
    """The flash kernel against its plain version, (B, S, H, D) layout
    with GQA, a ragged S = 200, Sq != Sk (start-aligned rows) and lengths
    at the tile edges; window 64 ends on a tile edge.  A row with no
    unmasked key (a window with Sq > Sk + window - 1) is degenerate (the
    module docstring) and only checked finite."""
    tfa.reset_launches()
    g = torch.Generator(device=cuda).manual_seed(D)
    for Sq, Sk in ((200, 200), (96, 170), *FLASH_EDGE_LENGTHS):
        mk = lambda S, h: torch.randn((2, S, h, D), generator=g,
                                      device=cuda).to(dtype)
        q, k, v = mk(Sq, 4), mk(Sk, 2), mk(Sk, 2)
        got = tops.flash_attention(q, k, v, causal=causal, window=window)
        want = tfa.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=causal,
                                   window=window)
        torch.cuda.synchronize()
        rows = tfa.band_mask(Sq, Sk, causal=causal, window=window).any(dim=1)
        assert got.dtype == dtype and got.shape == q.shape
        assert bool(torch.isfinite(got.float()).all()), (Sq, Sk)
        assert _flash_close(got[:, rows.to(cuda)], want[:, rows]), (Sq, Sk)
    # the (BH, S, D) entry point, kv heads repeated to q's rows
    qb = q.transpose(1, 2).reshape(-1, Sq, D)
    kb, vb = (x.transpose(1, 2).repeat_interleave(2, dim=1).reshape(-1, Sk, D)
              for x in (k, v))
    got = tfa.flash_attention_bhsd(qb, kb, vb, causal=causal, window=window)
    want = tfa.flash_attention_bhsd_plain(qb, kb, vb, causal=causal, window=window)
    assert _flash_close(got[:, rows.to(cuda)], want[:, rows])
    assert tfa.LAUNCHES["flash_attention_bhsd"] == 2 + len(FLASH_EDGE_LENGTHS) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_gqa_and_strided_views(cuda, D, dtype):
    """GQA 4:1 with q every other batch of a larger tensor and k, v
    slices of one packed (B, S, H + 2, D) tensor: the kernel reads them
    through their strides, no copy; causal, and a 64-key window."""
    g = torch.Generator(device=cuda).manual_seed(D + 1)
    B, S, H = 2, 150, 4
    q = torch.randn((2 * B, S, H, D), generator=g, device=cuda).to(dtype)[::2]
    kv = torch.randn((B, S, H + 2, D), generator=g, device=cuda).to(dtype)
    k, v = kv[:, :, H:H + 1], kv[:, :, H + 1:]
    assert not q.is_contiguous() and not k.is_contiguous()
    for window in (0, 64):
        got = tops.flash_attention(q, k, v, causal=True, window=window)
        want = tfa.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True,
                                   window=window)
        torch.cuda.synchronize()
        assert _flash_close(got, want), window


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_per_tensor_kernels_take_unaligned_tensors(cuda, dtype):
    """A tensor that starts one element into its storage is not aligned for
    vector loads: the kernels take their scalar loop, same results."""
    g = torch.Generator(device=cuda).manual_seed(3)
    p, gr, u = (torch.randn((1001,), generator=g, device=cuda).to(dtype)[1:]
                for _ in range(3))
    assert not tfs.check_tensors("t", p, gr, u)
    kw = dict(momentum=0.9, weight_decay=1e-2, nesterov=True)
    for a, b in zip(tfs.fused_sgd_2d(p, gr, u, 0.05, **kw),
                    tfs.fused_sgd_2d_plain(p, gr, u, 0.05, **kw)):
        assert torch.equal(a, b)
    torch.testing.assert_close(tsc.abs_sum(p), tsc.abs_sum_plain(p), rtol=1e-5,
                               atol=0)
    s = torch.tensor(0.5, device=cuda)
    assert torch.equal(tsc.scale_sign(p, s), tsc.scale_sign_plain(p, s))


@pytest.mark.cuda
def test_cuda_per_tensor_wrappers_refuse_bad_input(cuda):
    x = torch.zeros((1, 8, 2, 24), device=cuda)
    with pytest.raises(ValueError):                      # head dim 24
        tops.flash_attention(x, x, x)
    x = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        tops.flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(ValueError):                      # kv on the CPU
        tops.flash_attention(x, x.cpu(), x.cpu())
    p = torch.zeros(10, device=cuda)
    with pytest.raises(TypeError):
        tfs.fused_sgd_2d(p, p.double(), p, 0.1, momentum=0.9,
                         weight_decay=0.0, nesterov=True)
    with pytest.raises(ValueError):                      # s on the CPU
        tsc.scale_sign(p, torch.tensor(1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("step", [0, 10])
def test_cuda_bucket_noise(cuda, step):
    """Gradient noise drawn on the card: per-element variance within 1 % of
    sigma_t^2 = eta / (1+t)^gamma over about 1.6 million draws (9 standard
    errors), mean within 1 % of sigma_t (12), padding exactly zero,
    one seed the same bits and another seed other bits."""
    from repro_torch.core import flatbuf
    from repro_torch.core.local_sgd import _bucket_noise

    tree = {"a": torch.zeros((3000, 130)), "b": torch.zeros((7777,))}
    layout = flatbuf.build_layout(tree)
    rows = layout.bucket_rows[0]
    eta, gamma = 0.01, 0.55
    sigma = (eta / (1.0 + step) ** gamma) ** 0.5

    def draw(seed):
        g = torch.zeros((4, rows, 128), device=cuda)
        return _bucket_noise(layout, [g], torch.Generator(device=cuda)
                             .manual_seed(seed), step=step, eta=eta,
                             gamma=gamma)[0]

    g = draw(1)
    valid = flatbuf.const("valid_mask", layout, 0, cuda).bool()
    vals = g[:, valid].double()
    assert abs(float(vals.var()) / sigma ** 2 - 1) < 1e-2
    assert abs(float(vals.mean())) < 1e-2 * sigma
    assert float(g[:, ~valid].abs().max()) == 0.0
    assert torch.equal(g.view(torch.int32), draw(1).view(torch.int32))
    assert not torch.equal(g, draw(2))


@pytest.mark.cuda
def test_noise_adaptive_trainer_on_card_matches_cpu(cuda, tmp_path):
    """The noise-adaptive policy (EF memory allocated, so all four axes)
    on paper-lm smoke, from the same weights: the card's run makes the
    CPU's decisions round by round (H, compressor, batch, LR and the
    provenance's non-float fields) with per-step loss rtol 1e-4, and the
    compressor pair launches once per global round, speculatively while
    the bucket is uncompressed."""
    import json

    W, B, S, steps = 4, 2, 64, 8
    cfg = configs.get_smoke("paper-lm")
    run = RunConfig(model=cfg, shape=InputShape("t", S, W * B, "train"),
                    local_sgd=LocalSGDConfig(local_steps=4, post_local_switch=4,
                                             sync_compression="ef_sign"),
                    optim=OptimConfig(base_lr=0.3, base_batch=32,
                                      lr_warmup_steps=2, grad_clip=1.0),
                    controller=ControllerConfig(
                        kind="noise_adaptive", max_batch_scale=2, patience=2,
                        err_budget=0.95, h0=2))
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=64, seq_len=S))
    p0 = mbase.materialize(build_train(run, num_workers=W, device="cpu").specs,
                           torch.Generator().manual_seed(0), "cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        tkb.reset_launches()
        path = tmp_path / f"{dev}.jsonl"
        tb = build_train(run, num_workers=W, device=dev)
        _, hist, summ = ttrain.fit(run, ShardedBatches(data, W, B), bundle=tb,
                                   num_steps=steps, telemetry_path=str(path),
                                   params0=tree_map(lambda t: t.to(dev), p0),
                                   log=lambda *a: None)
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        trace = [(r["next_h"], r["next_compression"], r["next_batch_scale"],
                  r["next_lr_scale"],
                  {k: {f: v for f, v in d.items() if not isinstance(v, float)
                       and f != "comp_rel_err"}
                   for k, d in r.get("decisions", {}).items() if k != "b_noise"})
                 for r in recs]
        out[dev] = ([h["loss"] for h in hist], trace, dict(tkb.LAUNCHES),
                    summ["comm_rounds"]["global"])
    (lg, tg, cg, ng), (lc, tc, _, nc) = out["cuda"], out["cpu"]
    assert tg == tc and ng == nc > 1
    assert any(t[4] for t in tg), "the policy never actuated"
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert cg == {"fused_sgd_bucket": steps, "sq_sum": steps, "row_abs_sum": ng,
                  "scale_sign_rows": ng, "lars_row_norms": 0,
                  "fused_lars_bucket": 0}
