"""On the card: the port's CUDA kernels against their plain versions, and
the trainer on the card against the trainer on the CPU.

Every test here is marked ``cuda`` and skips with a reason without a GPU.
This file imports torch and the port only (no JAX), so it also runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: the elementwise SGD / LARS update 2e-6 x the largest entry
(a stated bound: since its operations round one by one, the update takes
its plain version's bits, which ``test_cuda_update_stats_form_same_bits``
holds exactly);
reductions rtol 1e-5 (float32 sums in another order); sign exact.  The
per-tensor SGD kernel rounds every operation on its own, as its plain
version does: 2e-6 of the largest entry in f32 and one bf16 ulp in bf16
are the stated bounds, not the expected error.  Flash attention: 2e-5 x
the largest entry in f32 (the reference's own test tolerance; online
against dense softmax); in bf16, both compute in f32 and round once, so
each entry within one bf16 rounding (2^-7 of itself) plus that 2e-5.
"""
import json
import math

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

import _torch_segment_maps as segmaps


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
@pytest.mark.parametrize("case", segmaps.CARD_MAPS)
@pytest.mark.parametrize("L", [1, 4, 8, 16])
def test_cuda_segment_sum_equals_plain_bit_for_bit(cuda, case, L):
    """The port's segmented sum (no TPU kernel: the reference's
    jax.ops.segment_sum) per leading row and chained over the rows, from
    a running total and from 0, against its plain version (the host's
    index_add_): the same adds in the same order, so the same bits,
    twice, with one launch counted a call; index_add_ on the card is what
    it replaces.  The maps: leaves of random sizes with trailing rows in
    segment 0, paper-lm's full-width index (934,040 rows), a shard
    region of its 2 x 2 FSDP and TP sub-buckets, one segment of 2^20 + 5
    rows (the ring wraps ~1,000 times a leading row), runs starting at
    every residue mod 4, a random map (a run a row), empty segments."""
    dev = cuda
    index, n_seg = segmaps.segment_index(case, dev, seed=L)
    rows = index.seg_ids.numel()
    g = torch.Generator(device=dev).manual_seed(rows + L)
    vals = torch.randn((L, rows), generator=g, device=dev)
    init = torch.randn((n_seg,), generator=g, device=dev)
    seg = index.seg_ids
    tkb.reset_launches()
    per = tkb.segment_sum(vals, index)
    chain = tkb.segment_sum(vals, index, chain=True, init=init)
    chain0 = tkb.segment_sum(vals, index, chain=True)
    assert tkb.PORT_LAUNCHES["segment_sum"] == 3
    assert per.shape == (L, n_seg) and chain.shape == (n_seg,)
    assert torch.equal(per, tkb.segment_sum_plain(vals, seg, n_seg))
    assert torch.equal(chain, tkb.segment_sum_plain(vals, seg, n_seg,
                                                    chain=True, init=init))
    assert torch.equal(chain0, tkb.segment_sum_plain(vals, seg, n_seg,
                                                     chain=True))
    assert torch.equal(per, tkb.segment_sum(vals, index))
    assert torch.equal(chain, tkb.segment_sum(vals, index, chain=True,
                                              init=init))
    assert torch.equal(chain0, tkb.segment_sum(vals, index, chain=True))
    assert tkb.PORT_LAUNCHES["segment_sum"] == 6
    empty = (index.offsets[1:] == index.offsets[:-1])
    assert (per[:, empty] == 0).all() and torch.equal(chain[empty], init[empty])
    if case.startswith("sizes-"):
        assert torch.equal(tops.segment_sum(vals, seg, n_seg),
                           tkb.segment_sum_plain(vals.cpu(), seg.cpu(),
                                                 n_seg).to(dev))


@pytest.mark.cuda
def test_cuda_chain_probe_times_an_add(cuda):
    """The chain probe: one thread's dependent __fadd_rn, a positive,
    finite time an add (a few cycles at 1-2 GHz), and no launch counted
    on the segmented sum."""
    tkb.reset_launches()
    s = tkb.fadd_chain_s_per_add(1 << 20, reps=3)
    assert math.isfinite(s) and 0 < s < 1e-7
    assert tkb.PORT_LAUNCHES["segment_sum"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3096 + 5, 65_536 + 3])
def test_cuda_per_worker_sums_do_not_depend_on_w(cuda, rows):
    """A worker's sq_sum and its update's stats take the same bits whether
    the launch holds 4, 2 or 1 workers: a rank that holds W / P workers
    adds each worker's partials in the one-process run's order.  So do the
    updated p and u."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    mk = lambda: torch.randn((4, rows, 128), generator=g, device=cuda)
    x, p, u = mk(), mk(), 0.1 * mk()
    wd_row = (torch.rand((rows,), generator=g, device=cuda) < 0.7).float()
    gscale = torch.rand((4,), generator=g, device=cuda)
    kw = dict(momentum=0.9, weight_decay=1e-2, nesterov=True, stats=True)
    whole = tkb.sq_sum(x)
    p4, u4 = p.clone(), u.clone()
    st4 = tkb.fused_sgd_bucket(p4, x, u4, 0.05, wd_row, gscale=gscale, **kw)
    for n in (2, 1):
        for lo in range(0, 4, n):
            sl = slice(lo, lo + n)
            assert torch.equal(tkb.sq_sum(x[sl].contiguous()), whole[sl])
            pn, un = p[sl].clone(), u[sl].clone()
            st = tkb.fused_sgd_bucket(pn, x[sl].contiguous(), un, 0.05, wd_row,
                                      gscale=gscale[sl].contiguous(), **kw)
            assert all(torch.equal(a, b[sl]) for a, b in zip(st, st4))
            assert torch.equal(pn, p4[sl]) and torch.equal(un, u4[sl])


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
    index = tkb.segment_index(torch.zeros(8, dtype=torch.int32,
                                          device=cuda), 2)
    with pytest.raises(ValueError):                     # 9 rows, 8 indexed
        tkb.segment_sum(torch.zeros((2, 9), device=cuda), index)
    with pytest.raises(ValueError):                     # int32 runs
        tkb.segment_sum(torch.zeros((2, 8), device=cuda),
                        index._replace(runs=index.runs.int()))


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


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3096 + 5, 264])
@pytest.mark.parametrize("nesterov", [True, False])
def test_cuda_update_stats_form_same_bits(cuda, rows, nesterov):
    """The fused SGD / LARS update gives the same p and u bits with its
    stats on or off (telemetry observes only), and its plain version's
    bits: every operation rounds on its own, no FMA contraction."""
    dev = cuda
    g = torch.Generator(device=dev).manual_seed(rows + nesterov)
    mk = lambda: torch.randn((4, rows, 128), generator=g, device=dev)
    p, gr, u = mk(), mk(), 0.1 * mk()
    wd_row = (torch.rand((rows,), generator=g, device=dev) < 0.7).float()
    ratio = torch.rand((4, rows), generator=g, device=dev)
    gscale = torch.tensor([1.0, 0.5, 0.25, 0.125], device=dev)
    kw = dict(momentum=0.9, weight_decay=1e-2, nesterov=nesterov)
    calls = {"sgd": lambda fn, p_, u_, st: fn(p_, gr, u_, 0.05, wd_row,
                                             gscale=gscale, stats=st, **kw),
             "lars": lambda fn, p_, u_, st: fn(p_, gr, u_, 0.05, wd_row, ratio,
                                               stats=st, **kw)}
    fns = {"sgd": (tkb.fused_sgd_bucket, tkb.fused_sgd_bucket_plain),
           "lars": (tkb.fused_lars_bucket, tkb.fused_lars_bucket_plain)}
    for name, call in calls.items():
        outs = []
        for fn, st in ((fns[name][0], False), (fns[name][0], True),
                       (fns[name][1], False)):
            p1, u1 = p.clone(), u.clone()
            call(fn, p1, u1, st)
            outs.append((p1, u1))
        torch.cuda.synchronize()
        for p1, u1 in outs[1:]:
            assert torch.equal(p1, outs[0][0]), name
            assert torch.equal(u1, outs[0][1]), name


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "lars"])
def test_tree_kernel_form_on_card_matches_plain_form(cuda, optimizer):
    """The tree path's two forms on the card, paper-lm smoke, EF-sign,
    from the same weights: the tree-in/tree-out kernel form
    (``build_train(resident=False)``) launches the bucket kernels every
    step and every compressed sync (never the plain version on a CUDA
    tensor), the per-leaf plain form (``use_kernel=False``) none; losses
    rtol 1e-4, the params all but 1e-4 of their elements within 1e-4 x
    the largest entry (an EF-sign delta within rounding of 0 may flip), as
    the resident trainer's card-vs-CPU test holds them."""
    from repro_torch.core.local_sgd import is_resident
    from repro_torch.utils import tree_leaves
    W, B, S, steps = 4, 2, 64, 6
    cfg = configs.get_smoke("paper-lm")
    opt = (dict(optimizer="lars", lars_trust=0.02) if optimizer == "lars"
           else {})
    run = RunConfig(model=cfg, shape=InputShape("t", S, W * B, "train"),
                    local_sgd=LocalSGDConfig(local_steps=2, post_local_switch=2,
                                             sync_compression="ef_sign"),
                    optim=OptimConfig(base_lr=0.3, base_batch=W * B,
                                      lr_warmup_steps=2, grad_clip=1.0, **opt))
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=64, seq_len=S))
    p0 = mbase.materialize(build_train(run, num_workers=W, device="cpu").specs,
                           torch.Generator().manual_seed(0), "cpu")
    out = {}
    for form, kw in (("kernel", dict(resident=False)),
                     ("plain", dict(use_kernel=False))):
        tkb.reset_launches()
        tb = build_train(run, num_workers=W, device=cuda, **kw)
        state, hist, summ = ttrain.fit(run, ShardedBatches(data, W, B), bundle=tb,
                                       num_steps=steps,
                                       params0=tree_map(lambda t: t.to(cuda), p0),
                                       log=lambda *a: None)
        assert not is_resident(state)
        out[form] = (tree_map(lambda t: t.cpu(), state.params),
                     [h["loss"] for h in hist], dict(tkb.LAUNCHES),
                     tkb.PORT_LAUNCHES["segment_sum"],
                     summ["comm_rounds"]["global"])
    (pk, lk, ck, sk, nk), (pp, lp, cp, sp, np_) = out["kernel"], out["plain"]
    np.testing.assert_allclose(lk, lp, rtol=1e-4)
    flat = lambda t: torch.cat([x.reshape(-1) for x in tree_leaves(t)])
    a, b = flat(pk), flat(pp)
    assert float(((a - b).abs() > 1e-4 * b.abs().max()).float().mean()) <= 1e-4
    assert nk == np_ == 4
    lars = optimizer == "lars"
    assert ck == {"fused_sgd_bucket": 0 if lars else steps,
                  "sq_sum": 0 if lars else steps,
                  "row_abs_sum": nk, "scale_sign_rows": nk,
                  "lars_row_norms": steps if lars else 0,
                  "fused_lars_bucket": steps if lars else 0}
    assert sk == nk + (steps if lars else 0)
    assert all(v == 0 for v in cp.values()) and sp == 0


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3096 + 5, 264])
def test_cuda_kernels_across_worker_resizes(cuda, rows):
    """sq_sum and fused_sgd_bucket against their plain versions while W
    shrinks and grows on one stream (4 -> 2 -> 4 -> 8, an elastic run's
    widths): sq_sum's per-stream scratch is kept for a smaller W and grown
    only for a larger one, its tickets left zeroed after every call."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    key = (0, torch.cuda.current_stream().cuda_stream)
    tkb.reset_launches()
    for i, W in enumerate((4, 2, 4, 8)):
        mk = lambda: torch.randn((W, rows, 128), generator=g, device=cuda)
        p, gr, u = mk(), mk(), 0.1 * mk()
        wd_row = (torch.rand((rows,), generator=g, device=cuda) < 0.7).float()
        gscale = torch.rand((W,), generator=g, device=cuda)
        p1, u1, p2, u2 = p.clone(), u.clone(), p.clone(), u.clone()
        kw = dict(momentum=0.9, weight_decay=1e-2, nesterov=True,
                  gscale=gscale, stats=True)
        st_k = tkb.fused_sgd_bucket(p1, gr, u1, 0.05, wd_row, **kw)
        st_p = tkb.fused_sgd_bucket_plain(p2, gr, u2, 0.05, wd_row, **kw)
        torch.testing.assert_close(p1, p2, rtol=0, atol=2e-6 * p2.abs().max().item())
        torch.testing.assert_close(u1, u2, rtol=0, atol=2e-6 * u2.abs().max().item())
        for a, b in zip(st_k, st_p):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
        for x in (p, gr, p1):
            torch.testing.assert_close(tkb.sq_sum(x), tkb.sq_sum_plain(x),
                                       rtol=1e-5, atol=0)
        assert tkb._SQ_SUM_SCRATCH[key][1].numel() >= W
        torch.cuda.synchronize()
        assert all(int(t.abs().sum()) == 0
                   for _, t in tkb._SQ_SUM_SCRATCH.values())
    assert tkb.LAUNCHES["sq_sum"] == 12 and tkb.LAUNCHES["fused_sgd_bucket"] == 4


@pytest.mark.cuda
def test_elastic_trainer_on_card_matches_cpu(cuda, tmp_path):
    """paper-lm smoke through a SimulatedBackend with a straggler (worker 2)
    and two resizes (W = 4 -> 2 -> 4), from the same weights: the same
    resize and demotion decisions on the card and on the CPU, per-step
    loss rtol 1e-4."""
    from repro_torch.backend import SimulatedBackend
    from repro_torch.core.controller import ElasticController
    W, B, S, steps = 4, 2, 64, 16
    cfg = configs.get_smoke("paper-lm")
    run = RunConfig(model=cfg, shape=InputShape("t", S, W * B, "train"),
                    local_sgd=LocalSGDConfig(local_steps=4, post_local_switch=4),
                    optim=OptimConfig(base_lr=0.3, base_batch=32,
                                      lr_warmup_steps=2, grad_clip=1.0),
                    controller=ControllerConfig(kind="elastic"))
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=64, seq_len=S))
    p0 = _smoke_params()
    keys = ("round", "step", "next_workers", "demote", "promote", "topology",
            "num_workers", "worker_slowest")
    out = {}
    for dev in ("cuda", "cpu"):
        be = SimulatedBackend(W, latency_s={2: 0.05}, device=dev)
        path = tmp_path / f"{dev}.jsonl"
        _, hist, summ = ttrain.fit(
            run, ShardedBatches(data, W, B), backend=be,
            controller=ElasticController(run, resize_at={3: 2, 4: 4}),
            num_steps=steps, params0=tree_map(lambda t: t.to(dev), p0),
            telemetry_path=str(path), log=lambda *a: None)
        recs = [{k: r[k] for k in keys if k in r}
                for r in map(json.loads, open(path))]
        out[dev] = ([h["loss"] for h in hist], summ, recs)
    (lg, sg, rg), (lc, sc, rc) = out["cuda"], out["cpu"]
    assert rg == rc
    assert [r.get("next_workers") for r in rg if "next_workers" in r] == [2, 4]
    assert [r["demote"] for r in rg if "demote" in r] == [2]
    assert sg["resizes"] == sc["resizes"] == 2
    assert sg["comm_rounds"] == sc["comm_rounds"]
    assert sg["backend"] == sc["backend"]
    np.testing.assert_allclose(lg, lc, rtol=1e-4)


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


def _smoke_serve_params(dev):
    from repro_torch.models import lm
    cfg = configs.get_smoke("paper-lm")
    p = mbase.materialize(lm.param_specs(cfg), torch.Generator().manual_seed(0),
                          "cpu")
    return cfg, tree_map(lambda t: t.to(dev), p)


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [1, 8])
def test_paged_decode_on_card_matches_contiguous(cuda, page_size):
    """On the card, paged decode (gather -> decode -> write-back) against
    decoding on the contiguous cache: logits within 1e-5 x (1 + |logit|)
    (the gathered view's strides may route the attention einsum to other
    kernels than the contiguous cache's), the null page zero."""
    from repro_torch.models import lm
    from repro_torch.serving import NULL_PAGE, build_page_layout, init_pool, paged
    cfg, params = _smoke_serve_params(cuda)
    B, L, max_len = 3, 6, 32
    prompts = torch.randint(0, cfg.vocab_size, (B, L),
                            generator=torch.Generator().manual_seed(1)).to(cuda)
    logits, cache = lm.prefill(cfg, params, prompts, max_len=max_len)
    pl = build_page_layout(cfg, page_size=page_size, max_len=max_len,
                           num_pages=1 + B * (-(-max_len // page_size)))
    pools = init_pool(pl, cuda)
    tables = torch.arange(1, 1 + B * pl.pages_per_seq, device=cuda).reshape(B, -1)
    paged.scatter_prefill(pl, pools, cache, tables, torch.full((B,), L))
    tok = logits.argmax(-1)
    lens = torch.full((B,), L, device=cuda)
    for _ in range(6):
        lens = lens + 1
        lg_c, cache = lm.decode_step(cfg, params, tok, cache, lens)
        lg_p, pools = paged.paged_decode_step(cfg, params, tok, pools, tables,
                                              lens, pl)
        err = ((lg_p.double() - lg_c.double()).abs()
               / (1 + lg_c.double().abs())).max()
        assert float(err) <= 1e-5
        tok = lg_c.argmax(-1)
    assert not any(bool(p[NULL_PAGE].any()) for p in pools)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda):
    """The continuous-batching engine at smoke size on the card against the
    same engine on the CPU, same weights and requests: every logit row
    within 1e-4 x (1 + |logit|), teacher-forced on the CPU's tokens by
    comparing only while the two token streams agree; the streams agree
    up to the first near-tie (top-2 gap within 2e-4)."""
    from repro_torch.launch.steps import build_engine
    cfg, params = _smoke_serve_params("cpu")
    shape = type("S", (), {"global_batch": 3, "seq_len": 32})()
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(2, 9))).tolist(),
             int(rng.integers(2, 12))) for _ in range(7)]
    out = {}
    for dev in ("cpu", cuda):
        rows: dict = {}
        eng = build_engine(cfg, shape, tree_map(lambda t: t.to(dev), params),
                           page_size=4, device=dev,
                           on_logits=lambda k, live, lg, inp: [
                               rows.setdefault(u, []).append(lg[s, -1].cpu())
                               for s, u in live])
        uids = [eng.submit(p, max_new=n) for p, n in reqs]
        res = {r.uid: r.tokens for r in eng.run()}
        out[dev] = ([res[u] for u in uids], [rows[u] for u in uids])
    compared = 0
    for tc, tg, lc, lg in zip(out["cpu"][0], out[cuda][0], out["cpu"][1],
                              out[cuda][1]):
        for a, b, x, y in zip(tc, tg, lc, lg):
            err = ((y.double() - x.double()).abs() / (1 + x.double().abs())).max()
            assert float(err) <= 1e-4
            top2 = torch.topk(x.double(), 2).values
            if a != b:
                assert float(top2[0] - top2[1]) <= 2e-4
                break
            compared += 1
    assert compared >= len(reqs)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"])
def test_cuda_bucket_kernels_on_moe_mla_layouts(cuda, arch):
    """Kernels 1-4 (fused SGD, sq_sum, row_abs_sum, scale_sign_rows)
    against their plain versions on W=2 buckets packed from the MoE / MLA
    layout (smoke widths: expert stacks, the router padded to 128 lanes,
    MLA's w_dkv, the stacked q/k/kv norms) with the layout's own weight-
    decay rows and segments; the padding stays exactly zero; one launch
    per call."""
    from repro_torch.core import compression
    from repro_torch.core import flatbuf
    from repro_torch.models import lm

    cfg = configs.get_smoke(arch)
    specs = lm.param_specs(cfg)
    layout = flatbuf.build_layout(mbase.abstract(specs),
                                  wd_mask=mbase.norm_param_mask(specs))
    gen = torch.Generator(device=cuda).manual_seed(3)

    def bucket(scale=1.0):
        t = mbase.materialize(specs, gen, cuda)
        return flatbuf.flatten(layout, tree_map(
            lambda a: torch.stack([a, -0.5 * a]) * scale, t), leading=1)[0]

    tkb.reset_launches()
    p, gr, u = bucket(), bucket(), bucket(0.1)
    wd_row = flatbuf.const("wd_rows", layout, 0, cuda)
    gscale = torch.tensor([1.0, 0.5], device=cuda)
    kw = dict(momentum=0.9, weight_decay=1e-2, nesterov=True, gscale=gscale,
              stats=True)
    p1, u1, p2, u2 = p.clone(), u.clone(), p.clone(), u.clone()
    st_k = tkb.fused_sgd_bucket(p1, gr, u1, 0.05, wd_row, **kw)
    st_p = tkb.fused_sgd_bucket_plain(p2, gr, u2, 0.05, wd_row, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(p1, p2, rtol=0, atol=2e-6 * p2.abs().max().item())
    torch.testing.assert_close(u1, u2, rtol=0, atol=2e-6 * u2.abs().max().item())
    for a, b in zip(st_k, st_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    assert torch.equal(flatbuf.mask_padding(layout, 0, p1), p1)
    torch.testing.assert_close(tkb.sq_sum(gr), tkb.sq_sum_plain(gr), rtol=1e-5, atol=0)
    torch.testing.assert_close(tkb.row_abs_sum(gr), tkb.row_abs_sum_plain(gr),
                               rtol=1e-5, atol=1e-5)
    seg = flatbuf.const("row_segments", layout, 0, cuda)
    s = torch.rand((int(seg.max()) + 1,), generator=gen, device=cuda)[seg.long()]
    assert torch.equal(tkb.scale_sign_rows(gr, s), tkb.scale_sign_rows_plain(gr, s))
    y = compression.sign_compress_bucket(layout, 0, gr, leading=1)
    assert torch.equal(flatbuf.mask_padding(layout, 0, y), y)
    assert tkb.LAUNCHES == {"fused_sgd_bucket": 1, "sq_sum": 1,
                            "row_abs_sum": 2, "scale_sign_rows": 2,
                            "lars_row_norms": 0, "fused_lars_bucket": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"])
def test_moe_trainer_and_decode_on_card_match_cpu(cuda, arch):
    """The MoE smoke configs, one local step and one sync (olmoe mean sync
    at W=4, deepseek EF-sign at W=2) on the card and on the CPU from the
    same weights: loss within 1e-4 relative, all but 1e-4 of the param
    elements within 1e-4 x the largest; then decode logits of the synced
    model within 1e-4 x (1 + |logit|)."""
    from repro_torch.core.local_sgd import mean_params
    from repro_torch.models import lm

    mode, W = {"olmoe-1b-7b": ("none", 4), "deepseek-v2-lite-16b": ("ef_sign", 2)}[arch]
    B, S = 2, 64
    cfg = configs.get_smoke(arch)
    run = RunConfig(model=cfg, shape=InputShape("t", S, W * B, "train"),
                    local_sgd=LocalSGDConfig(local_steps=1, sync_compression=mode),
                    optim=OptimConfig(base_lr=0.3, base_batch=W * B, grad_clip=1.0))
    p0 = mbase.materialize(lm.param_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    batch = next(iter(ShardedBatches(lm_examples(markov_lm(
        vocab=cfg.vocab_size, num_seqs=W * B, seq_len=S)), W, B)))
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (2, 10), generator=g)
    forced = torch.randint(0, cfg.vocab_size, (2, 3), generator=g)
    out = {}
    for dev in ("cpu", cuda):
        tb = build_train(run, num_workers=W, device=dev)
        st, m = tb.local_step(tb.init(tree_map(lambda t: t.to(dev), p0)), batch)
        st = tb.sync(st, plan=tb.sync_plan)
        params = mean_params(st)
        with torch.no_grad():
            lg, cache = lm.prefill(cfg, params, prompt.to(dev), max_len=16)
            rows = [lg[:, -1].cpu()]
            for i in range(forced.shape[1]):
                lg, cache = lm.decode_step(cfg, params, forced[:, i:i + 1].to(dev),
                                           cache, prompt.shape[1] + 1 + i)
                rows.append(lg[:, -1].cpu())
        out[dev] = (float(m["loss"]), st.params.buckets[0].cpu(), rows)
    (lc, pc, rc), (lg, pg, rg) = out["cpu"], out[cuda]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert float(((pg - pc).abs() > 1e-4 * pc.abs().max()).float().mean()) <= 1e-4
    for a, b in zip(rg, rc):
        assert float(((a.double() - b.double()).abs() / (1 + b.double().abs())).max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3096 + 5, 264])
def test_cuda_wire_pack_matches_cpu(cuda, rows):
    """The 1-bit wire pack of a (4, rows, 128) bucket on the card against
    the same pack on the CPU: the uint8 payload byte for byte, the per-leaf
    scales within rtol 2e-5 (the scatter-add's atomics add in another
    order), the unpacked packed mean within 2e-5 x its largest entry."""
    from repro_torch.core import compression as comp
    from repro_torch.core import flatbuf
    from repro_torch.core.local_sgd import _packed_mean_flat_local
    from repro_torch.models import lm

    layout = flatbuf.build_layout(mbase.abstract(lm.param_specs(
        configs.get_smoke("paper-lm"))))
    g = torch.Generator().manual_seed(rows)
    x = torch.randn((4, rows, 128), generator=g)
    x[torch.rand(x.shape, generator=g) < 0.01] = 0.0
    seg = torch.arange(rows, dtype=torch.int32) * 7 // rows
    sizes = torch.bincount(seg.long(), minlength=7).float() * 128 - 5
    pc, sc = comp.pack_bucket_signs(x, seg, sizes)
    pg, sg = comp.pack_bucket_signs(x.to(cuda), seg.to(cuda), sizes.to(cuda))
    assert pg.dtype == torch.uint8 and torch.equal(pg.cpu(), pc)
    torch.testing.assert_close(sg.cpu(), sc, rtol=2e-5, atol=0)
    torch.testing.assert_close(comp.unpack_bucket_signs(pg, sg, seg.to(cuda)).cpu(),
                               comp.unpack_bucket_signs(pc, sc, seg), rtol=2e-5, atol=0)
    xb = torch.randn((4, layout.bucket_rows[0], 128), generator=g)
    xb = flatbuf.mask_padding(layout, 0, xb)
    mc = _packed_mean_flat_local(xb, layout, 0)
    mg = _packed_mean_flat_local(xb.to(cuda), layout, 0).cpu()
    assert float((mg - mc).abs().max()) <= 2e-5 * float(mc.abs().max())


@pytest.mark.cuda
def test_gemma3_forward_and_decode_on_card_match_cpu(cuda):
    """gemma3-smoke (sliding window 16, GeGLU, post-norm, scaled
    embeddings, tied head; ``logit_softcap`` set to 30 to drive the
    softcap too) on the card and on the CPU from the same weights: the
    loss of a (2, 64) batch past the window within 1e-4 relative and its
    gradient (the window's mask in the backward) within 1e-4 x each
    leaf's largest entry, then prefill of a 40-token prompt and 3 decode
    steps within 1e-4 x (1 + |logit|)."""
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves

    cfg = configs.get_smoke("gemma3-1b").replace(logit_softcap=30.0)
    p0 = mbase.materialize(lm.param_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=g)
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), generator=g)
    forced = torch.randint(0, cfg.vocab_size, (2, 3), generator=g)
    out = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda t: t.to(dev).requires_grad_(True), p0)
        loss, _ = lm.loss_fn(cfg, params, {"tokens": toks[:, :-1].to(dev),
                                           "labels": toks[:, 1:].to(dev)})
        grads = [x.cpu() for x in torch.autograd.grad(loss, tree_leaves(params))]
        with torch.no_grad():
            lg, cache = lm.prefill(cfg, params, prompt.to(dev), max_len=48)
            rows = [lg[:, -1].cpu()]
            for i in range(forced.shape[1]):
                lg, cache = lm.decode_step(cfg, params, forced[:, i:i + 1].to(dev),
                                           cache, prompt.shape[1] + 1 + i)
                rows.append(lg[:, -1].cpu())
        out[dev] = (float(loss.detach()), grads, rows)
    (lc, gc, rc), (lg_, gg, rg) = out["cpu"], out[cuda]
    assert abs(lg_ - lc) <= 1e-4 * abs(lc)
    for a, b in zip(gg, gc, strict=True):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    for a, b in zip(rg, rc):
        assert float(((a.double() - b.double()).abs() / (1 + b.double().abs())).max()) <= 1e-4

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-7b"])
def test_recurrent_forward_grads_and_decode_on_card_match_cpu(cuda, arch):
    """The recurrent smoke models (mLSTM + sLSTM; mamba2 + the shared
    attention block, invoked twice) on the card and on the CPU from the
    same weights: the loss of a (2, 64) batch within 1e-4 relative and
    every gradient within 1e-4 x its leaf's largest entry (zamba2's
    unused shared-layer leaves get none on either device); then on the
    card, prefill of a 12-token prompt and 4 decode steps held against
    the train-mode forward over the same tokens within 2e-4 x (1 +
    |logit|), the reference's decode tolerance, and the card's decode
    logits against the CPU's within 1e-4 x (1 + |logit|)."""
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves

    cfg = configs.get_smoke(arch)
    p0 = mbase.materialize(lm.param_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=g)
    seq = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    out = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda t: t.to(dev).requires_grad_(True), p0)
        loss, _ = lm.loss_fn(cfg, params, {"tokens": toks[:, :-1].to(dev),
                                           "labels": toks[:, 1:].to(dev)})
        grads = [None if x is None else x.cpu() for x in torch.autograd.grad(
            loss, tree_leaves(params), allow_unused=True)]
        with torch.no_grad():
            params = tree_map(lambda t: t.detach(), params)
            full = lm.logits_from_hidden(cfg, params, lm.forward(cfg, params, seq.to(dev)))
            lg, cache = lm.prefill(cfg, params, seq[:, :12].to(dev), max_len=16)
            rows, want = [lg[:, -1]], [full[:, 11]]
            for i in range(12, 16):
                lg, cache = lm.decode_step(cfg, params, seq[:, i:i + 1].to(dev), cache,
                                           i + 1)
                rows.append(lg[:, -1])
                if i < 15:
                    want.append(full[:, i])
        rel = lambda a, b: float(((a.double() - b.double()).abs()
                                  / (1 + b.double().abs())).max())
        assert max(rel(a, b) for a, b in zip(rows, want)) <= 2e-4, dev
        out[dev] = (float(loss.detach()), grads, [r.cpu() for r in rows])
    (lc, gc, rc), (lg_, gg, rg) = out["cpu"], out[cuda]
    assert abs(lg_ - lc) <= 1e-4 * abs(lc)
    assert [a is None for a in gg] == [b is None for b in gc]
    assert sum(a is None for a in gg) == (5 if arch == "zamba2-7b" else 0)
    for a, b in zip(gg, gc, strict=True):
        if a is not None:
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    for a, b in zip(rg, rc):
        assert float(((a.double() - b.double()).abs() / (1 + b.double().abs())).max()) <= 1e-4


@pytest.mark.cuda
def test_ef_memory_is_float32_on_card(cuda):
    """A bf16 bucket's EF memory is float32 on the card from ``init`` on,
    and one EF-sign sync of a mixed f32 + bf16 tree on the card gives the
    CPU's memory within 1e-6 x its largest entry."""
    from repro_torch.core import flatbuf
    from repro_torch.core import local_sgd as tsgd

    mixed = {"a": ((3, 200), torch.float32), "b": ((5, 7), torch.bfloat16),
             "c": ((130,), torch.float32), "d": ((40,), torch.bfloat16)}
    run = RunConfig(model=configs.get_smoke("paper-lm"),
                    local_sgd=LocalSGDConfig(sync_compression="ef_sign"))
    init, _, sync = tsgd.make_local_sgd(run, lambda p, b: None, num_workers=4)
    g = torch.Generator().manual_seed(0)
    out = {}
    for dev in ("cpu", cuda):
        st = init({k: torch.zeros(s, dtype=d, device=dev) for k, (s, d) in mixed.items()})
        assert [b.dtype for b in st.ef_memory.buckets] == [torch.float32] * 2
        g.manual_seed(0)
        for b, x in enumerate(st.params.buckets):
            x.copy_(flatbuf.mask_padding(st.params.layout, b, torch.randn(
                x.shape, generator=g)).to(dev))
        st = sync(st)
        assert [b.dtype for b in st.ef_memory.buckets] == [torch.float32] * 2
        out[dev] = [b.cpu() for b in st.ef_memory.buckets]
    for a, b in zip(out[cuda], out["cpu"]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-76b"])
def test_encdec_and_prefix_trainer_and_decode_on_card_match_cpu(cuda, arch):
    """whisper-smoke (the encoder over 48 frames, cross-attention; EF-sign
    at W=2) and internvl2-smoke (8 prefix embeddings; mean sync at W=2):
    one local step and one sync on the card and on the CPU from the same
    weights and batch: loss within 1e-4 relative, all but 1e-4 of the
    param elements within 1e-4 x the largest; then, with the synced
    model, a prefill of a 12-token prompt (with its frames / prefix) and
    4 decode steps held against the train-mode forward within 2e-4 x (1 +
    |logit|) on each device, and the card's logits against the CPU's
    within 1e-4 x (1 + |logit|)."""
    from repro_torch.core.local_sgd import mean_params
    from repro_torch.models import lm

    mode = "ef_sign" if arch == "whisper-small" else "none"
    W, B, S, SE = 2, 2, 32, 48
    cfg = configs.get_smoke(arch)
    run = RunConfig(model=cfg, shape=InputShape("t", S, W * B, "train"),
                    local_sgd=LocalSGDConfig(local_steps=1, sync_compression=mode),
                    optim=OptimConfig(base_lr=0.3, base_batch=W * B, grad_clip=1.0))
    p0 = mbase.materialize(lm.param_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    key, n = (("frames", SE) if arch == "whisper-small"
              else ("prefix_embed", cfg.num_prefix_tokens))
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=W * B, seq_len=S))
    data[key] = rng.normal(size=(W * B, n, cfg.d_model)).astype(np.float32)
    batch = next(iter(ShardedBatches(data, W, B)))
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    extra = torch.from_numpy(rng.normal(size=(2, n, cfg.d_model)).astype(np.float32))
    kw_name = "enc_frames" if key == "frames" else key
    Np = n if key == "prefix_embed" else 0
    out = {}
    for dev in ("cpu", cuda):
        tb = build_train(run, num_workers=W, device=dev)
        st, m = tb.local_step(tb.init(tree_map(lambda t: t.to(dev), p0)), batch)
        st = tb.sync(st, plan=tb.sync_plan)
        params = mean_params(st)
        kw = {kw_name: extra.to(dev)}
        with torch.no_grad():
            full = lm.logits_from_hidden(cfg, params, lm.forward(cfg, params,
                                                                 seq.to(dev), **kw))
            lg, cache = lm.prefill(cfg, params, seq[:, :12].to(dev), max_len=Np + 16,
                                   **kw)
            rows, want = [lg[:, -1]], [full[:, Np + 11]]
            for i in range(12, 16):
                lg, cache = lm.decode_step(cfg, params, seq[:, i:i + 1].to(dev), cache,
                                           Np + i + 1)
                rows.append(lg[:, -1])
                if i < 15:
                    want.append(full[:, Np + i])
        rel = lambda a, b: float(((a.double() - b.double()).abs()
                                  / (1 + b.double().abs())).max())
        assert max(rel(a, b) for a, b in zip(rows, want)) <= 2e-4, dev
        out[dev] = (float(m["loss"]), st.params.buckets[0].cpu(), [r.cpu() for r in rows])
    (lc, pc, rc), (lg_, pg, rg) = out["cpu"], out[cuda]
    assert abs(lg_ - lc) <= 1e-4 * abs(lc)
    assert float(((pg - pc).abs() > 1e-4 * pc.abs().max()).float().mean()) <= 1e-4
    for a, b in zip(rg, rc):
        assert float(((a.double() - b.double()).abs() / (1 + b.double().abs())).max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tp", "fsdp"])
def test_sharded_layout_trainer_on_card_matches_cpu(cuda, kind):
    """paper-lm smoke on sharded sub-buckets in one process (the TP or
    FSDP classes with sizes {data: 2, model: 2}), EF-sign with the wire
    pack and coalesced syncs: every kernel launched on the buckets' shard
    regions (two sub-buckets, one launch each a step), the card against
    the CPU as in test_trainer_on_card_matches_cpu."""
    from repro_torch.sharding import layout as sl
    W, B, S = 2, 2, 64
    cfg = configs.get_smoke("paper-lm")
    run = RunConfig(model=cfg, shape=InputShape("t", S, W * B, "train"),
                    local_sgd=LocalSGDConfig(local_steps=2, post_local_switch=2,
                                             sync_compression="ef_sign",
                                             wire_pack=True, sync_coalesce=True),
                    optim=OptimConfig(base_lr=0.3, base_batch=W * B,
                                      lr_warmup_steps=2, grad_clip=1.0))
    lay = (sl.train_layout(("data", "model"), worker_axes=("data",)) if kind == "tp"
           else sl.fsdp_within_worker_layout(("data", "model"),
                                             worker_axes=("data",)))
    lay = lay.with_sizes({"data": 2, "model": 2})
    data = lm_examples(markov_lm(vocab=cfg.vocab_size, num_seqs=64, seq_len=S))
    p0 = mbase.materialize(build_train(run, num_workers=W, device="cpu").specs,
                           torch.Generator().manual_seed(0), "cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        tkb.reset_launches()
        tb = build_train(run, num_workers=W, device=dev, layout=lay)
        state, hist, summ = ttrain.fit(run, ShardedBatches(data, W, B), bundle=tb,
                                       num_steps=6,
                                       params0=tree_map(lambda t: t.to(dev), p0),
                                       log=lambda *a: None)
        out[dev] = ([b.cpu() for b in state.params.buckets],
                    [h["loss"] for h in hist], dict(tkb.LAUNCHES),
                    summ["comm_rounds"]["global"])
    (pg, lg, cg, ng), (pc, lc, cc, nc) = out["cuda"], out["cpu"]
    assert len(pg) == 2
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for a, b in zip(pg, pc):
        d = (a - b).abs()
        assert float((d > 1e-4 * b.abs().max()).float().mean()) <= 1e-4
    assert ng == nc == 4
    assert cg == {"fused_sgd_bucket": 12, "sq_sum": 12, "row_abs_sum": 16,
                  "scale_sign_rows": 8, "lars_row_norms": 0,
                  "fused_lars_bucket": 0}
    assert all(v == 0 for v in cc.values())


def _card_mean_scale(x) -> float:
    """``at::mean``'s factor on the card for a mean over dim 0 of ``x``:
    f32(output elements) / f32(input elements)."""
    n_out = x[0].numel()
    return float(torch.tensor(float(n_out), dtype=torch.float32)
                 / torch.tensor(float(x.numel()), dtype=torch.float32))


def _ordered(x):
    """The workers of ``x`` added in index order from zero in f32, scaled
    as the card's mean scales, rounded once to x's dtype."""
    acc = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    for w in range(x.shape[0]):
        acc = acc + x[w].float()
    return (acc * _card_mean_scale(x)).to(x.dtype)


def _workers(g, W, shape, dtype, device):
    return (torch.randn((W,) + shape, generator=g, device=device)
            * torch.rand((W,) + (1,) * len(shape), generator=g,
                         device=device) * 10).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mean_adds_workers_in_index_order(cuda, dtype):
    """The card's ``x.mean(dim=0)`` over up to four workers (W = 4 and 2:
    the resident and tree paths' dense sync, and ``group_mean``'s blocks
    of two; W = 3) adds them in index order from zero, in f32, then
    scales by f32(out) / f32(in) and rounds once: the sum
    ``Collectives.ordered_mean`` makes across ranks, so a dense mean
    across ranks is one process's bit for bit.  Shapes: a bucket of
    paper-lm smoke's rows and stacked leaves of the tree path."""
    from repro_torch.core.local_sgd import group_mean
    g = torch.Generator(device=cuda).manual_seed(0)
    for W in (4, 3, 2):
        for shape in ((3096 + 5, 128), (768,), (512, 64), (5,), (1, 768)):
            x = _workers(g, W, shape, dtype, cuda)
            assert torch.equal(x.mean(dim=0), _ordered(x)), (W, shape)
    x = torch.randn((4, 3101, 128), generator=g, device=cuda).to(dtype)
    gm = group_mean(x, 2)
    assert torch.equal(gm[0], _ordered(x[:2])) and torch.equal(gm[3],
                                                               _ordered(x[2:]))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [5, 6, 8])
def test_cuda_mean_of_more_than_four_workers_splits_them(cuda, W):
    """The limit of the equality above: beyond four workers the card's
    mean over dim 0 adds worker w into accumulator w % 4 and then adds
    the four in order, so a sum in index order (``ordered_mean``'s) is
    not its bits; the port's dense means are one process's bit for bit
    on the card for W <= 4 only."""
    g = torch.Generator(device=cuda).manual_seed(W)
    for shape in ((3101, 128), (768,), (5,)):
        x = _workers(g, W, shape, torch.float32, cuda)
        acc = [torch.zeros(shape, device=cuda) for _ in range(4)]
        for w in range(W):
            acc[w % 4] = acc[w % 4] + x[w]
        four = ((acc[0] + acc[1]) + acc[2]) + acc[3]
        assert torch.equal(x.mean(dim=0), four * _card_mean_scale(x)), shape
    assert not torch.equal(x.mean(dim=0), _ordered(x))


_MEAN_RANKS = '''
import socket, sys
import torch
import torch.multiprocessing as mp

def rank(r, port, P, W, out):
    import torch.distributed as dist
    from repro_torch.backend.collectives import Collectives
    from repro_torch.sharding.layout import WorkerLayout
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=P, rank=r)
    c = Collectives(WorkerLayout(W, P, r))
    wl = W // P
    res = {}
    for i, (shape, dt) in enumerate((((3101, 128), torch.float32),
                                     ((3101, 128), torch.bfloat16),
                                     (((1 << 21) + 3,), torch.float32),
                                     ((5,), torch.float32))):
        g = torch.Generator(device="cuda").manual_seed(i)
        full = (torch.randn((W,) + shape, generator=g, device="cuda")
                * torch.rand((W,) + (1,) * len(shape), generator=g,
                             device="cuda") * 10).to(dt)
        x = full[r * wl:(r + 1) * wl].contiguous()
        res[i] = bool(torch.equal(c.ordered_mean(x, scope="global"),
                                  full.mean(dim=0)))
    torch.save(res, f"{out}/m{P}_{W}_{r}.pt")
    dist.destroy_process_group()

if __name__ == "__main__":
    out = sys.argv[1]
    for P, W in ((3, 3), (2, 4), (4, 4)):
        s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]
        s.close()
        mp.spawn(rank, args=(port, P, W, out), nprocs=P)
'''


@pytest.mark.cuda
def test_cuda_ordered_mean_across_ranks_is_one_process_mean(cuda, tmp_path):
    """``Collectives.ordered_mean`` of CUDA rows on ``gloo`` ranks of the
    card (3 x 1, 2 x 2, 4 x 1 workers; f32, bf16, a size of three chunks
    with a short last one, a part of one) equals one process's
    ``mean(dim=0)`` of all W workers on the card bit for bit."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    script = tmp_path / "mean.py"
    script.write_text(_MEAN_RANKS)
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    for P, W in ((3, 3), (2, 4), (4, 4)):
        for r in range(P):
            got = torch.load(tmp_path / f"m{P}_{W}_{r}.pt")
            assert all(got.values()), (P, W, r, got)


_TREE_RANKS = '''
import json, socket, sys
import numpy as np
import torch
import torch.multiprocessing as mp
sys.path.insert(0, sys.argv[3])
from _torch_tree_variants import B, FORMS, W, make_data, make_run
from repro_torch import configs
from repro_torch.backend.distributed import DistributedBackend
from repro_torch.backend.local import LocalBackend
from repro_torch.configs import base as tcb
from repro_torch.data.partition import ShardedBatches
from repro_torch.kernels import fused_bucket as fb
from repro_torch.launch import train as ttrain
from repro_torch.models import base as mbase
from repro_torch.utils import tree_leaves, tree_map

def train(be, form, out, tag):
    run = make_run(tcb, configs.get_smoke("paper-lm"), "ef_wire_gm")
    bundle = be.build(run)
    p0 = mbase.materialize(bundle.specs, torch.Generator().manual_seed(0), "cpu")
    fb.reset_launches()
    state, hist, _ = ttrain.fit(run, ShardedBatches(make_data(), W, B),
                                backend=be, bundle=bundle, log=lambda *a: None,
                                params0=tree_map(lambda t: t.to("cuda"), p0))
    np.savez(f"{out}/{tag}.npz", *[x.float().cpu().numpy()
                                   for x in tree_leaves(state.params)])
    with open(f"{out}/{tag}.json", "w") as f:
        json.dump({"loss": [h["loss"] for h in hist],
                   "launches": dict(fb.LAUNCHES)}, f)

def rank(r, port, out):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    for form, kw in FORMS.items():
        be = DistributedBackend(W, backend="gloo", device="cuda:0",
                                coordinator_address=f"localhost:{port}",
                                process_id=r, num_processes=2, **kw)
        train(be, form, out, f"r{r}.{form}")
    import torch.distributed as dist
    dist.destroy_process_group()

if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    out = sys.argv[1]
    for form, kw in FORMS.items():
        train(LocalBackend(W, device="cuda", **kw), form, out, f"one.{form}")
    s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]
    s.close()
    mp.spawn(rank, args=(port, out), nprocs=2)
'''


@pytest.mark.cuda
def test_tree_path_across_ranks_on_card(cuda, tmp_path):
    """The tree path's two forms on 2 ``gloo`` ranks of the card (EF-sign,
    the wire pack, global momentum; paper-lm smoke) against the same form
    in one process on the card: losses and every worker's params bit for
    bit, and the launches.  The kernel form launches the update and
    compressor kernels on every rank, the plain form only its wire pack's
    row sums (the pack's scales); the two forms agree within the plain-vs-kernel
    test's bounds (losses rtol 1e-4)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    script = tmp_path / "ranks.py"
    script.write_text(_TREE_RANKS)
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, str(script), str(tmp_path),
                          str(root / "tests"), str(root / "tests")],
                         capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    load = lambda tag: (json.loads((tmp_path / f"{tag}.json").read_text()),
                        np.load(tmp_path / f"{tag}.npz"))
    for form in ("plain", "kernel"):
        one_m, one_a = load(f"one.{form}")
        ranks = [load(f"r{r}.{form}") for r in range(2)]
        for m, _ in ranks:
            assert m["loss"] == one_m["loss"], form
            # a rank launches what one process does (one launch a bucket
            # for its rows); the plain form's update and compressor launch
            # nothing, its wire pack's scale sums the bucket row sums
            assert m["launches"] == one_m["launches"], form
            kl = m["launches"]
            if form == "kernel":
                assert kl["fused_sgd_bucket"] > 0 and kl["scale_sign_rows"] > 0
            else:
                assert kl["fused_sgd_bucket"] == kl["sq_sum"] == \
                    kl["scale_sign_rows"] == 0 and kl["row_abs_sum"] > 0
        for i in range(len(one_a.files)):
            got = np.concatenate([a[f"arr_{i}"] for _, a in ranks])
            assert np.array_equal(got, one_a[f"arr_{i}"]), (form, i)
    np.testing.assert_allclose(load("one.kernel")[0]["loss"],
                               load("one.plain")[0]["loss"], rtol=1e-4)
