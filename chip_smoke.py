#!/usr/bin/env python3
"""GPU check of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Needs a CUDA card and ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` into ``build/`` at first use).  Imports
torch and the port only — nothing of JAX or of the JAX package.  Every
line of standard output but the last is one JSON object (the card's
``nvidia-smi`` name/power line excepted); the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero without printing that line.

Phases:
  build    nvcc for every CUDA source, all started at once; build seconds;
           flash attention's ``-Xptxas -v`` readings (registers, stack,
           spills per instantiation) and the tensor-core instructions
           (HMMA / HGMMA) in each instantiation's SASS.
  kernels  each kernel against its plain PyTorch version on the same card
           inputs, at full size and at a ragged size: the six bucket
           kernels at the main path's shape (W=4 workers x 934,040 rows x
           128, float32: paper-lm's bucket) and at 3,101 rows; the three
           per-tensor kernels on one tensor of paper-lm's parameter count
           (119,556,864; fused SGD in float32 and bfloat16) and of
           1,000,003 elements; flash attention at paper-lm's attention
           (B 32, S 512, 12 heads, D 64, causal, f32), at gemma3-1b's local
           layer (B 1, S 4096, 4 heads, 1 kv head, D 256, window 512; f32
           and bf16) and at two ragged shapes.  Max errors against the
           stated tolerance, and times (median of CUDA-event-timed runs):
           kernel, plain version, the one PyTorch call that computes the
           same function where there is one (timed only, never used by
           the port), and the bound (bytes; for flash attention the
           operations of the unmasked pairs at the tensor-core rate of its
           route: 3xTF32 in f32, bf16 q·k and split-bf16 p·v in bf16).
           Flash attention, abs_sum and sq_sum also give device time per
           call over back-to-back calls (``device_ms``, and the library
           call's ``library_device_ms``, the two timed in turns), beside
           the per-call time; abs_sum and sq_sum must give the same bits
           twice.  The three kernels of the paper harness's path (fused
           SGD, row_abs_sum, scale_sign_rows) also at its bucket: K=8
           workers x 624 rows x 128 (the width-256 MLP), timed.
  A        the main path: paper-lm at full width, W=4 stacked on the card,
           post-local SGD, mean sync, 12 steps; launch counts.
  B        the same with EF-sign sync; the compressor kernels launch once
           per global sync.
  L        the same with LARS (the paper's Table 5 optimizer) and telemetry:
           the two LARS kernels every step, their stats form feeding the
           round statistics, grad_clip set and ignored (no sq_sum launch);
           the last round's summary.
  H        hierarchical local SGD (Alg. 5) at phase A's settings with
           block_steps=2 (blocks of 2 of the 4 workers): syncs at
           (0 block) (1 global) (2 block) (3 global) (7 block) (11 global);
           launch counts as in A; the comms ledger's rounds and ring-model
           bytes per topology and scope (a block round one bucket, a
           global round 1.5 buckets); step time beside phase A's.
  T        the per-tensor kernel API at full width: paper-lm's parameter
           tree (W=1) on the card; one SGD step with ops.fused_sgd on every
           leaf against the same step by the bucket kernel on the flat bus;
           ops.sign_compress on every leaf of a delta tree against the
           bucket compressor; ops.flash_attention against the training
           path's attention (models.layers.causal_attention) at paper-lm's
           attention shape; launch counts (one per leaf, one flash).
  N        noise-adaptive post-local SGD at full width: phase B's settings
           with the noise_adaptive controller (NOISE_CC), 12 steps; per
           round the H, compressor, batch and LR scale it ran under, the
           speculative / measured sign error, the decisions and each
           sensor's margin to its threshold; at least one actuation, the
           launch counts (the update and sq_sum every step, the compressor
           pair once per global round), the ledger's scaling block against
           the decisions; median step time per batch scale beside phase
           B's, peak memory.
  noise    gradient noise at full width: the bucket noise on a zero
           (W, 934,040, 128) grad bucket at t = 0 and 10 against
           sigma_t^2 = eta / (1+t)^gamma (variance within 1e-3 relative,
           mean below 1e-3 sigma_t, padding exactly zero, one seed the
           same bits), then 4 full-width steps with noise_eta = 0.01.
  P        torch.profiler over two full-width local steps and one EF-sign
           sync, for SGD (phase B's run) and for LARS with telemetry
           (phase L's): device busy time by kernel family and the idle
           share (profiler overhead included; not a timing of record), and
           the gradient assembly's float add / fill kernels and aten ops.
           SGD's window must show no reduce_rows_kernel (sq_sum folds its
           partials in its one launch; only the update's stats form uses
           the second pass).
  C        the trainer on the card against the trainer on the CPU (the
           kernels' plain versions) at smoke size, from the same weights:
           SGD + EF-sign, hierarchical SGD (block_steps=2, mean sync), and
           LARS with telemetry, mean and EF-sign sync; then the
           auto_compress and noise_adaptive policies with EF-sign: the same
           decisions round by round, with each sensor's margin to its
           threshold.
  G        the paper's experiments (``repro_torch.benchmarks``) at the
           harness's full size (MLP width 256, 1,536 train / 2,048 test
           examples, K up to 8): Fig. 1's A5 and Table 4's EFsign_post_H8
           for 24 steps on the card against the CPU from the same weights;
           then 240 steps of five rows (G_ROUNDS: Fig. 1 A1, A2, A5, Table
           4's EFsign_post_H8, Table 16's H1_Hb8; the CLI runs them all):
           test accuracy, global / block syncs pinned to the reference's
           schedule, wall µs per step (as the CLI's rows), first and final
           loss, launch counts (one fused SGD a step, one compressor pair a
           compressed sync); and torch.profiler over 24 steps of A2 and of H1_Hb8
           (device busy, idle share, the host's busiest ops).
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

W = 4
FULL_ROWS = 934_040          # paper-lm: one f32 bucket, 478.2 MB a copy
RAGGED_ROWS = 3_096 + 5
FULL_N = 119_556_864         # paper-lm's parameter count, as one tensor
RAGGED_N = 1_000_003
STEPS = 12
TOL = {"elementwise": 2e-6, "reduction": 1e-5, "sign": 0.0,
       # flash: f32 against the largest entry; bf16 elementwise, one bf16
       # rounding of the entry (both round an f32 result once) plus that
       "flash_f32": 2e-5, "flash_bf16_rtol": 2 ** -7,
       # the bucket compressor's per-leaf |x| totals: a float32 scatter-add
       # of up to 221,184 row sums into one slot, one after another
       "scatter_add": 1e-4}
# flash attention checks: (label, B, S, H, KH, D, window, dtype), causal
FLASH_MAIN = ("paper-lm", 32, 512, 12, 12, 64, 0, "float32")
FLASH_FULL = (FLASH_MAIN,
              ("gemma3-1b local", 1, 4096, 4, 1, 256, 512, "float32"),
              ("gemma3-1b local", 1, 4096, 4, 1, 256, 512, "bfloat16"))
FLASH_RAGGED = (("ragged", 2, 333, 12, 4, 64, 0, "float32"),
                ("ragged", 1, 1000, 4, 1, 256, 100, "bfloat16"))
# each kernel: (the TPU kernel it replaces, under src/repro/kernels/; its
# source, under src/repro_torch/kernels/csrc/)
KERNELS = {
    "fused_sgd_bucket": ("fused_bucket.py:107", "fused_bucket.cu"),
    "sq_sum": ("fused_bucket.py:153", "fused_bucket.cu"),
    "row_abs_sum": ("fused_bucket.py:177", "fused_bucket.cu"),
    "scale_sign_rows": ("fused_bucket.py:304", "fused_bucket.cu"),
    "lars_row_norms": ("fused_bucket.py:204", "fused_bucket.cu"),
    "fused_lars_bucket": ("fused_bucket.py:258", "fused_bucket.cu"),
    "fused_sgd_2d": ("fused_sgd.py:48", "per_tensor.cu"),
    "abs_sum": ("sign_compress.py:34", "per_tensor.cu"),
    "scale_sign": ("sign_compress.py:56", "per_tensor.cu"),
    "flash_attention_bhsd": ("flash_attention.py:74", "flash_attention.cu"),
}
# phase L: LARS step size; the update of a layer is about lr * trust * ||w||
LARS_LR, LARS_TRUST = 0.3, 0.02
# phase N: noise-adaptive post-local SGD; patience / err_budget / h0 from a
# CPU probe at full width cut to 2 layers (decisions at rounds 1-2: H 2 -> 1,
# none -> sign, batch x2; sign errors 0.49-0.58 against the 0.95 budget)
NOISE_CC = dict(kind="noise_adaptive", max_batch_scale=2, patience=2,
                err_budget=0.95, noise_grow=1.0, h0=2)
# phase C: the two compression-escalating policies at smoke size
C_CONTROLLERS = (dict(kind="auto_compress", patience=1, err_budget=0.95),
                 NOISE_CC)
# the gradient-noise check: eta of the noisy steps; steps t of the draws
NOISE_ETA, NOISE_GAMMA, NOISE_STEPS = 0.01, 0.55, (0, 10)
# phase G: the paper harness's bucket (the width-256 MLP's 76,810 params,
# padded, as one f32 bucket) at K = 8 workers, and its run length
MLP_W, MLP_ROWS = 8, 624
G_STEPS = 240
# the full rows phase G runs (every row of Fig. 1, Tables 4 and 16 runs
# through `python -m repro_torch.benchmarks.run`): the K=1 baseline, large
# mini-batch, Alg. 5 with the most block syncs, post-local SGD and post-local
# EF-sign; each with its (global, block) syncs in 240 steps, the reference's
# schedule, read from `python -m benchmarks.run` of the JAX package on the CPU
G_ROUNDS = {"fig1/A1_small_mb": (240, 0), "fig1/A2_large_mb": (240, 0),
            "table16/H1_Hb8": (30, 210), "fig1/A5_post_local": (150, 0),
            "table4/EFsign_post_H8": (135, 0)}
# round_summary fields computed from ||mean_k x_k||^2 (post_sync_sq)
SYNC_MEAN_KEYS = ("post_sync_sq", "dispersion", "diversity", "signal_sq",
                  "noise_sq", "noise_ratio")


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_rates(name: str):
    """(memory bytes/s, float32 non-tensor flop/s, bf16 dense tensor-core
    flop/s, TF32 dense tensor-core flop/s) from NVIDIA's data sheets for
    the card present (the sheets' sparse tensor rates halved)."""
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12, 756e12, 378e12
    if "H100" in name and "NVL" in name:
        return 3.9e12, 60e12, 835e12, 418e12
    if "H200" in name:
        return 4.8e12, 67e12, 989e12, 495e12
    return 3.35e12, 67e12, 989e12, 495e12  # H100 SXM


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=25, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, library, calls=20, rounds=3):
    """Device time per call of ``fn`` and of ``library`` (the PyTorch call
    computing the same function), each over ``calls`` back-to-back calls
    between two events (the host's launch latency hidden behind the
    queue), beside ``time_ms``, which times one call at a time.  Taken in
    turns (fn, library, library, fn, ...) so that a drift of the card's
    state falls on both; medians of ``2 * rounds`` runs each."""
    import torch
    fn()
    library()
    times = ([], [])
    for _ in range(rounds):
        for which in (0, 1, 1, 0):
            f = (fn, library)[which]
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                f()
            end.record()
            end.synchronize()
            times[which].append(start.elapsed_time(end) / calls)
    return statistics.median(times[0]), statistics.median(times[1])


def flash_instance(symbol: str):
    """``f32/D64``, ``bf16/D256``... for a mangled flash_kernel symbol,
    else None."""
    k = re.search(r"flash_kernelI(\w+?)Li(\d+)E", symbol)
    return f"{'f32' if k.group(1) == 'f' else 'bf16'}/D{k.group(2)}" if k else None


def ptxas_table(log: str) -> dict:
    """Registers, stack and spills per flash instantiation from nvcc
    ``-Xptxas -v`` output."""
    table, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = flash_instance(m.group(1)) or m.group(1)
            table[cur] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            table[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            table[cur]["registers"] = int(m.group(1))
    return table


def sass_mma_counts(lib: Path) -> dict:
    """HMMA (tensor-core) instructions per flash instantiation in the
    built library's SASS (``cuobjdump -sass``); None without cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = flash_instance(m.group(1))
            if cur:
                counts[cur] = {"HMMA": 0, "HGMMA": 0}
        elif cur:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[cur][op] += 1
                    break
    return counts


def rel_err(got, want):
    """(max |got - want|, that over max |want|)."""
    d = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    return d, d / scale if scale else d


def check_kernels(rows: int, bw: float, flops_peak: float, timed: bool):
    """Every kernel against its plain version at (W, rows, 128)."""
    import torch
    from repro_torch.kernels import fused_bucket as fb

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(rows)
    mk = lambda: torch.randn((W, rows, 128), generator=gen, device=dev)
    n = W * rows * 128
    nbytes = 4 * n
    res = {}

    # fused SGD (Nesterov, decay mask, clip scale, stats), in place on p/u
    p, g, u = mk(), mk(), 0.1 * mk()
    wd_row = (torch.rand((rows,), generator=gen, device=dev) < 0.9).float()
    gscale = torch.tensor([1.0, 0.5, 0.25, 0.125], device=dev)
    kw = dict(momentum=0.9, weight_decay=1e-4, nesterov=True, gscale=gscale,
              stats=True)
    pk, uk, pp, up = p.clone(), u.clone(), p.clone(), u.clone()
    sk = fb.fused_sgd_bucket(pk, g, uk, 0.05, wd_row, **kw)
    sp = fb.fused_sgd_bucket_plain(pp, g, up, 0.05, wd_row, **kw)
    torch.cuda.synchronize()
    errs = [rel_err(pk, pp), rel_err(uk, up)]
    serr = [rel_err(a, b) for a, b in zip(sk, sp)]
    ok = (all(e[1] <= TOL["elementwise"] for e in errs)
          and all(e[1] <= TOL["reduction"] for e in serr))
    res["fused_sgd_bucket"] = dict(
        max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
        stats_rel_err=max(e[1] for e in serr), tol=TOL["elementwise"],
        stats_tol=TOL["reduction"], ok=ok, bytes=5 * nbytes + 4 * rows,
        flops=10 * n)
    if timed:
        res["fused_sgd_bucket"].update(
            ms=time_ms(lambda: fb.fused_sgd_bucket(pk, g, uk, 0.05, wd_row, **kw)),
            plain_ms=time_ms(lambda: fb.fused_sgd_bucket_plain(pp, g, up, 0.05,
                                                               wd_row, **kw)),
            library_ms=None)
    del p, g, u, pk, uk, pp, up

    x = mk()
    x[:, :7] = 0.0                        # exact zeros: sign(0) must be 0
    a, b = fb.sq_sum(x), fb.sq_sum_plain(x)
    e = rel_err(a, b)
    repeat = bool(torch.equal(a, fb.sq_sum(x)))         # no atomics
    res["sq_sum"] = dict(max_abs_err=e[0], max_rel_err=e[1],
                         tol=TOL["reduction"], same_bits_twice=repeat,
                         ok=e[1] <= TOL["reduction"] and repeat,
                         bytes=nbytes + 4 * W, flops=2 * n)
    a, b = fb.row_abs_sum(x), fb.row_abs_sum_plain(x)
    e = rel_err(a, b)
    res["row_abs_sum"] = dict(max_abs_err=e[0], max_rel_err=e[1],
                              tol=TOL["reduction"], ok=e[1] <= TOL["reduction"],
                              bytes=nbytes + 4 * W * rows, flops=2 * n)
    s = torch.rand((rows,), generator=gen, device=dev)
    a, b = fb.scale_sign_rows(x, s), fb.scale_sign_rows_plain(x, s)
    e = rel_err(a, b)
    res["scale_sign_rows"] = dict(max_abs_err=e[0], max_rel_err=e[1],
                                  tol=TOL["sign"], ok=bool(torch.equal(a, b)),
                                  bytes=2 * nbytes + 4 * rows, flops=n)
    if timed:
        lib = lambda: torch.linalg.vector_norm(x, 2, dim=(-2, -1)).square()
        dev_ms, lib_dev_ms = device_ms(lambda: fb.sq_sum(x), lib)
        res["sq_sum"].update(
            ms=time_ms(lambda: fb.sq_sum(x)),
            plain_ms=time_ms(lambda: fb.sq_sum_plain(x)),
            library_ms=time_ms(lib), device_ms=dev_ms,
            library_device_ms=lib_dev_ms)
        res["row_abs_sum"].update(
            ms=time_ms(lambda: fb.row_abs_sum(x)),
            plain_ms=time_ms(lambda: fb.row_abs_sum_plain(x)),
            library_ms=time_ms(lambda: torch.linalg.vector_norm(x, 1, dim=-1)))
        res["scale_sign_rows"].update(
            ms=time_ms(lambda: fb.scale_sign_rows(x, s)),
            plain_ms=time_ms(lambda: fb.scale_sign_rows_plain(x, s)),
            library_ms=None)
    del x

    # LARS: row norms, then the update with a per-worker, per-row ratio
    p, g, u = mk(), mk(), 0.1 * mk()
    ratio = 0.01 + 2 * torch.rand((W, rows), generator=gen, device=dev)
    a, b = (fb.lars_row_norms(p, g, wd_row, weight_decay=1e-4),
            fb.lars_row_norms_plain(p, g, wd_row, weight_decay=1e-4))
    errs = [rel_err(x, y) for x, y in zip(a, b)]
    res["lars_row_norms"] = dict(
        max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
        tol=TOL["reduction"], ok=all(e[1] <= TOL["reduction"] for e in errs),
        bytes=2 * nbytes + 4 * rows + 2 * 4 * W * rows, flops=6 * n)
    kw = dict(momentum=0.9, weight_decay=1e-4, nesterov=True, stats=True)
    pk, uk, pp, up = p.clone(), u.clone(), p.clone(), u.clone()
    sk = fb.fused_lars_bucket(pk, g, uk, 0.05, wd_row, ratio, **kw)
    sp = fb.fused_lars_bucket_plain(pp, g, up, 0.05, wd_row, ratio, **kw)
    torch.cuda.synchronize()
    errs = [rel_err(pk, pp), rel_err(uk, up)]
    serr = [rel_err(x, y) for x, y in zip(sk, sp)]
    res["fused_lars_bucket"] = dict(
        max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
        stats_rel_err=max(e[1] for e in serr), tol=TOL["elementwise"],
        stats_tol=TOL["reduction"],
        ok=(all(e[1] <= TOL["elementwise"] for e in errs)
            and all(e[1] <= TOL["reduction"] for e in serr)),
        bytes=5 * nbytes + 4 * rows + 4 * W * rows, flops=12 * n)
    if timed:
        res["lars_row_norms"].update(
            ms=time_ms(lambda: fb.lars_row_norms(p, g, wd_row, weight_decay=1e-4)),
            plain_ms=time_ms(lambda: fb.lars_row_norms_plain(p, g, wd_row,
                                                             weight_decay=1e-4)),
            library_ms=None)
        res["fused_lars_bucket"].update(
            ms=time_ms(lambda: fb.fused_lars_bucket(pk, g, uk, 0.05, wd_row,
                                                    ratio, **kw)),
            plain_ms=time_ms(lambda: fb.fused_lars_bucket_plain(
                pp, g, up, 0.05, wd_row, ratio, **kw)),
            library_ms=None)
    del p, g, u, pk, uk, pp, up
    return report(res, bw, flops_peak, W=W, rows=rows)


def check_mlp_bucket(bw: float, flops_peak: float):
    """The kernels of the paper harness's path against their plain versions
    at its bucket, (MLP_W, MLP_ROWS, 128) f32, as the harness calls them:
    the update without a clip scale or stats (grad_clip 0, telemetry off)."""
    import torch
    from repro_torch.kernels import fused_bucket as fb

    dev, W_, rows = "cuda", MLP_W, MLP_ROWS
    gen = torch.Generator(device=dev).manual_seed(rows)
    mk = lambda: torch.randn((W_, rows, 128), generator=gen, device=dev)
    n = W_ * rows * 128
    nbytes = 4 * n
    res = {}
    p, g, u = mk(), mk(), 0.1 * mk()
    wd_row = (torch.rand((rows,), generator=gen, device=dev) < 0.9).float()
    kw = dict(momentum=0.9, weight_decay=1e-4, nesterov=True)
    pk, uk, pp, up = p.clone(), u.clone(), p.clone(), u.clone()
    fb.fused_sgd_bucket(pk, g, uk, 0.15, wd_row, **kw)
    fb.fused_sgd_bucket_plain(pp, g, up, 0.15, wd_row, **kw)
    torch.cuda.synchronize()
    errs = [rel_err(pk, pp), rel_err(uk, up)]
    res["fused_sgd_bucket"] = dict(
        max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs),
        tol=TOL["elementwise"], ok=all(e[1] <= TOL["elementwise"] for e in errs),
        bytes=5 * nbytes + 4 * rows, flops=10 * n,
        ms=time_ms(lambda: fb.fused_sgd_bucket(pk, g, uk, 0.15, wd_row, **kw)),
        plain_ms=time_ms(lambda: fb.fused_sgd_bucket_plain(pp, g, up, 0.15,
                                                           wd_row, **kw)),
        library_ms=None)
    x = mk()
    x[:, :7] = 0.0                        # exact zeros: sign(0) must be 0
    a, b = fb.row_abs_sum(x), fb.row_abs_sum_plain(x)
    e = rel_err(a, b)
    res["row_abs_sum"] = dict(
        max_abs_err=e[0], max_rel_err=e[1], tol=TOL["reduction"],
        ok=e[1] <= TOL["reduction"], bytes=nbytes + 4 * W_ * rows, flops=2 * n,
        ms=time_ms(lambda: fb.row_abs_sum(x)),
        plain_ms=time_ms(lambda: fb.row_abs_sum_plain(x)),
        library_ms=time_ms(lambda: torch.linalg.vector_norm(x, 1, dim=-1)))
    s_ = torch.rand((rows,), generator=gen, device=dev)
    a, b = fb.scale_sign_rows(x, s_), fb.scale_sign_rows_plain(x, s_)
    e = rel_err(a, b)
    res["scale_sign_rows"] = dict(
        max_abs_err=e[0], max_rel_err=e[1], tol=TOL["sign"],
        ok=bool(torch.equal(a, b)), bytes=2 * nbytes + 4 * rows, flops=n,
        ms=time_ms(lambda: fb.scale_sign_rows(x, s_)),
        plain_ms=time_ms(lambda: fb.scale_sign_rows_plain(x, s_)),
        library_ms=None)
    return report(res, bw, flops_peak, W=W_, rows=rows, shape="mlp bucket")


def report(res: dict, bw: float, flops_peak: float, **where):
    """Add each record's bound, emit it, and raise on a disagreement."""
    import torch
    for name, r in res.items():
        ops_s = r.pop("ops_s", r["flops"] / flops_peak)
        r["bound_ms"] = 1e3 * max(r["bytes"] / bw, ops_s)
        r["bound_by"] = "bytes" if r["bytes"] / bw >= ops_s else "operations"
        emit({"phase": "kernels", "kernel": name, **where, **r})
        if not r["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version at "
                                 f"{where}: {r}")
    torch.cuda.empty_cache()
    return res


def bf16_ulp(x):
    """One bfloat16 ulp at each entry of x (as f32)."""
    import torch
    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check_per_tensor(n: int, bw: float, flops_peak: float, timed: bool):
    """The three per-tensor kernels against their plain versions on one
    tensor of n elements."""
    import torch
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.kernels import sign_compress as sc

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(n)
    res = {}
    kw = dict(momentum=0.9, weight_decay=1e-4, nesterov=True)
    for dt in (torch.float32, torch.bfloat16):
        p, g, u = (torch.randn((n,), generator=gen, device=dev).to(dt)
                   for _ in range(3))
        got = fs.fused_sgd_2d(p, g, u, 0.05, **kw)
        want = fs.fused_sgd_2d_plain(p, g, u, 0.05, **kw)
        torch.cuda.synchronize()
        errs = [rel_err(a.float(), b.float()) for a, b in zip(got, want)]
        r = dict(dtype=str(dt).removeprefix("torch."),
                 max_abs_err=max(e[0] for e in errs),
                 max_rel_err=max(e[1] for e in errs),
                 bytes=5 * p.element_size() * n, flops=8 * n)
        if dt == torch.float32:
            r.update(tol=TOL["elementwise"],
                     ok=all(e[1] <= TOL["elementwise"] for e in errs))
        else:
            ulps = max(float(((a.float() - b.float()).abs() / bf16_ulp(b)).max())
                       for a, b in zip(got, want))
            r.update(tol="1 bf16 ulp", max_ulps=ulps, ok=ulps <= 1.0)
        if timed:
            # torch._fused_sgd_ (SGD(fused=True)'s kernel) computes the same
            # update in place: timed on clones, never used by the port
            lib = [[t.clone()] for t in (p, g, u)]
            sgd = lambda: torch._fused_sgd_(
                *lib, weight_decay=1e-4, momentum=0.9, lr=0.05, dampening=0.0,
                nesterov=True, maximize=False, is_first_step=False)
            sgd()
            lib_err = max(rel_err(a[0].float(), b.float())[1]
                          for a, b in zip((lib[0], lib[2]), want))
            r.update(ms=time_ms(lambda: fs.fused_sgd_2d(p, g, u, 0.05, **kw)),
                     plain_ms=time_ms(lambda: fs.fused_sgd_2d_plain(p, g, u, 0.05,
                                                                   **kw)),
                     library_ms=time_ms(sgd), library_max_rel_err=lib_err)
            del lib
        res["fused_sgd_2d" + ("" if dt == torch.float32 else "_bf16")] = r
        del p, g, u, got, want

    x = torch.randn((n,), generator=gen, device=dev)
    x[::7] = 0.0                          # exact zeros: sign(0) must be 0
    a, b = sc.abs_sum(x), sc.abs_sum_plain(x)
    e = rel_err(a, b)
    repeat = bool(torch.equal(a, sc.abs_sum(x)))        # no atomics
    res["abs_sum"] = dict(max_abs_err=e[0], max_rel_err=e[1],
                          tol=TOL["reduction"], same_bits_twice=repeat,
                          ok=e[1] <= TOL["reduction"] and repeat,
                          bytes=4 * n + 4, flops=2 * n)
    s = a / n
    y, yp = sc.scale_sign(x, s), sc.scale_sign_plain(x, s)
    e = rel_err(y, yp)
    res["scale_sign"] = dict(max_abs_err=e[0], max_rel_err=e[1], tol=TOL["sign"],
                             ok=bool(torch.equal(y, yp)), bytes=8 * n + 4,
                             flops=n)
    if timed:
        lib = lambda: torch.linalg.vector_norm(x, 1)
        dev_ms, lib_dev_ms = device_ms(lambda: sc.abs_sum(x), lib)
        res["abs_sum"].update(
            ms=time_ms(lambda: sc.abs_sum(x)),
            plain_ms=time_ms(lambda: sc.abs_sum_plain(x)),
            library_ms=time_ms(lib), device_ms=dev_ms,
            library_device_ms=lib_dev_ms)
        res["scale_sign"].update(
            ms=time_ms(lambda: sc.scale_sign(x, s)),
            plain_ms=time_ms(lambda: sc.scale_sign_plain(x, s)),
            library_ms=None)
    del x, y, yp
    return report(res, bw, flops_peak, n=n)


def sdpa_call(q, k, v, window: int):
    """``scaled_dot_product_attention`` on the same inputs, causal (and
    banded by an explicit mask with a window), kv heads repeated outside
    the call: the yardstick, never used by the port."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    G = q.shape[2] // k.shape[2]
    qs = q.transpose(1, 2)
    ks = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vs = v.transpose(1, 2).repeat_interleave(G, dim=1)
    mask = (fa.band_mask(q.shape[1], k.shape[1], causal=True, window=window,
                         device=q.device) if window else None)
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  is_causal=mask is None)


def check_flash(spec, bw: float, flops_peak: float, bf16_peak: float,
                tf32_peak: float, timed: bool):
    """The flash kernel (through ops.flash_attention) against its plain
    version, causal, on random (B, S, H, D) inputs.  The bound is the
    least time for a result of f32 accuracy on the tensor cores, over the
    unmasked (q, k) pairs of this mask counted exactly, 2·D flops a pair
    for q·k and 2·D for p·v: f32 both products in 3xTF32 (three TF32
    products each, so a third of the TF32 rate); bf16 q·k at the bf16
    rate (a product of bf16 values is exact in f32) and p·v at half of it
    (p split into two bf16 parts)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    label, B, S, H, KH, D, window, dtype = spec
    dev, dt = "cuda", getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(S + D)
    mk = lambda h: torch.randn((B, S, h, D), generator=gen, device=dev).to(dt)
    q, k, v = mk(H), mk(KH), mk(KH)
    run = lambda: ops.flash_attention(q, k, v, causal=True, window=window)
    plain = lambda: fa.flash_attention_plain(q, k, v, causal=True, window=window)
    got, want = run(), plain()
    torch.cuda.synchronize()
    e = rel_err(got.float(), want.float())
    rtol = 0.0 if dtype == "float32" else TOL["flash_bf16_rtol"]
    bound = TOL["flash_f32"] * want.float().abs().max() + rtol * want.float().abs()
    ratio = float(((got.float() - want.float()).abs() / bound).max())
    pairs = int(fa.band_mask(S, S, causal=True, window=window,
                             device=dev).sum()) * B * H
    qk_rate, pv_rate = ((tf32_peak / 3, tf32_peak / 3) if dtype == "float32"
                        else (bf16_peak, bf16_peak / 2))
    r = dict(max_abs_err=e[0], max_rel_err=e[1], tol=TOL["flash_f32"],
             elementwise_rtol=rtol, max_err_over_tol=ratio, ok=ratio <= 1.0,
             unmasked_pairs=pairs, flops=4 * D * pairs,
             ops_s=2 * D * pairs / qk_rate + 2 * D * pairs / pv_rate,
             bytes=q.element_size() * 2 * (q.numel() + k.numel()))
    if timed:
        lib = sdpa_call(q, k, v, window)
        dev_ms, lib_dev_ms = device_ms(run, lib)
        r.update(ms=time_ms(run), plain_ms=time_ms(plain), library_ms=time_ms(lib),
                 device_ms=dev_ms, library_device_ms=lib_dev_ms,
                 library_max_rel_err=rel_err(lib().transpose(1, 2).float(),
                                             want.float())[1])
    del q, k, v, got, want
    name = "flash_attention_bhsd" + ("" if spec == FLASH_MAIN else
                                     f"@{label}/{dtype}")
    return report({name: r}, bw, flops_peak, shape=label, B=B, S=S, H=H, KH=KH,
                  D=D, causal=True, window=window, dtype=dtype)


def train_run(run, *, device, steps, params0=None, seed=0, telemetry_path=None):
    """fit() on markov_lm data; returns (state, history, summary, step_s):
    host seconds per step, each from one local step's start to the next's
    (a device synchronize before each), the sync included on sync steps."""
    import torch
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.steps import build_train

    S = run.shape.seq_len
    B = run.shape.global_batch // W
    data = lm_examples(markov_lm(vocab=run.model.vocab_size, num_seqs=W * B * 4,
                                 seq_len=S, seed=seed))
    bundle = build_train(run, num_workers=W, device=device)
    step_s = []
    local_step = bundle.local_step

    def timed_step(*args):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        step_s.append(time.perf_counter())
        return local_step(*args)

    bundle.local_step = timed_step
    state, hist, summ = ttrain.fit(run, ShardedBatches(data, W, B, seed=seed),
                                   bundle=bundle, num_steps=steps, seed=seed,
                                   params0=params0, log=lambda *a: None,
                                   telemetry_path=telemetry_path)
    step_s.append(summ["wall_s"] + step_s[0])
    return state, hist, summ, [b - a for a, b in zip(step_s, step_s[1:])]


# aten ops of the gradient assembly, read from phase P's profile
ASSEMBLY_OPS = ("aten::add", "aten::add_", "aten::slice_backward",
                "aten::zeros_like", "aten::copy_", "aten::fill_")
BUCKET_KERNELS = ("update_kernel", "sq_sum_kernel", "reduce_rows_kernel",
                  "row_abs_sum_kernel", "scale_sign_rows_kernel",
                  "lars_row_norms_kernel")


def kernel_family(name: str) -> str:
    if any(k in name for k in BUCKET_KERNELS):
        return "bucket kernels (this port)"
    low = name.lower()
    if "gemm" in low or "xmma" in low or "cutlass" in low:
        return "matmul"
    if "softmax" in low:
        return "softmax"
    return "other (elementwise, reductions, copies)"


def profile_phase(run):
    """Device time by kernel under torch.profiler for 2 local steps + 1
    sync of the full-width trainer (after 3 warm-up steps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.partition import ShardedBatches
    from repro_torch.data.synthetic import lm_examples, markov_lm
    from repro_torch.launch.steps import build_train
    from repro_torch.models import base as mbase

    B = run.shape.global_batch // W
    data = lm_examples(markov_lm(vocab=run.model.vocab_size, num_seqs=W * B * 2,
                                 seq_len=run.shape.seq_len))
    it = ShardedBatches(data, W, B)
    bundle = build_train(run, num_workers=W, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = bundle.init(mbase.materialize(bundle.specs, gen, "cuda"))
    for _ in range(3):
        state = bundle.local_step(state, next(it))[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state = bundle.local_step(state, next(it))[0]
        state = bundle.sync(state, plan=bundle.sync_plan)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    fam: dict = {}
    for e in kern:
        f = kernel_family(e.key)
        fam[f] = fam.get(f, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    reduce_rows = sum(e.count for e in kern if "reduce_rows_kernel" in e.key)
    # the gradient assembly's share: the float add and fill kernels, and
    # the aten ops that launch them, with their device time
    kernel_calls = {f: [sum(e.count for e in kern if f in e.key),
                        sum(e.self_device_time_total for e in kern
                            if f in e.key) / 1e3]
                    for f in ("CUDAFunctor_add<float>", "FillFunctor<float>")}
    aten = {e.key: [e.count, e.device_time_total / 1e3]
            for e in prof.key_averages() if e.key in ASSEMBLY_OPS}
    emit({"phase": "P", "optimizer": run.optim.optimizer,
          "telemetry": run.controller.wants_telemetry,
          "window": "2 local steps + 1 ef_sign sync",
          "wall_ms_under_profiler": wall_ms,
          "device_busy_ms": busy_ms if kern else None,
          "idle_share": 1 - busy_ms / wall_ms if kern else None,
          "by_family_ms": fam,
          "top_kernels": [[e.key[:90], e.self_device_time_total / 1e3, e.count]
                          for e in top],
          "reduce_rows_launches": reduce_rows,
          "kernel_calls_ms": kernel_calls, "aten_calls_device_ms": aten})
    if not run.controller.wants_telemetry and reduce_rows:
        raise AssertionError(f"phase P: {reduce_rows} reduce_rows_kernel "
                             "launches in an SGD window without stats")
    del state


def phase_t(cfg) -> dict:
    """Phase T: the per-tensor kernel API at full width on paper-lm's
    parameter tree (W=1), each result held against the path it mirrors;
    returns the launch counts of the driven calls."""
    import torch
    from repro_torch.core import flatbuf
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.kernels import fused_sgd as fs
    from repro_torch.kernels import ops
    from repro_torch.kernels import sign_compress as sc
    from repro_torch.models import base as mbase
    from repro_torch.models import lm
    from repro_torch.models.layers import causal_attention
    from repro_torch.utils import tree_leaves, tree_map

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(13)
    params = mbase.materialize(lm.param_specs(cfg), gen, dev)
    noise = lambda scale: tree_map(
        lambda t: scale * torch.randn(t.shape, generator=gen, device=dev), params)
    grads, mom, delta = noise(1e-2), noise(1e-3), noise(1e-3)
    layout = flatbuf.build_layout(params)
    n_leaves = layout.num_leaves
    lr, kw = 0.05, dict(momentum=0.9, weight_decay=1e-4, nesterov=True)
    lr_dev = torch.tensor(lr, device=dev)
    B, S, H, KH, D = FLASH_MAIN[1:6]
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev)
               for h in (H, KH, KH))
    leaves = list(zip(*(tree_leaves(t) for t in (params, grads, mom))))
    per_leaf_sgd = lambda: [ops.fused_sgd(p, g, u, lr=lr_dev, **kw)
                            for p, g, u in leaves]
    per_leaf_sign = lambda: [ops.sign_compress(d) for d in tree_leaves(delta)]

    for mod in (fs, sc, fa):
        mod.reset_launches()
    upd = per_leaf_sgd()
    ys = per_leaf_sign()
    o_flash = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    counts = {**fs.LAUNCHES, **sc.LAUNCHES, **fa.LAUNCHES}

    # the same SGD step by the bucket kernel: lead (), decay on every row
    P, G, U = (flatbuf.flatten(layout, t)[0] for t in (params, grads, mom))
    wd_row = torch.ones((P.shape[0],), device=dev)
    bucket_sgd = lambda: fb.fused_sgd_bucket(P, G, U, lr, wd_row, **kw)
    bucket_sgd()
    pb = tree_leaves(flatbuf.unflatten(layout, [P]))
    ub = tree_leaves(flatbuf.unflatten(layout, [U]))
    p_err = max(float((a - b).abs().max()) for (a, _), b in zip(upd, pb))
    u_err = max(float((a - b).abs().max()) for (_, a), b in zip(upd, ub))
    p_max = max(float(b.abs().max()) for b in pb)
    u_max = max(float(b.abs().max()) for b in ub)

    # the same compressor by the bucket kernels, per-segment scales
    X = flatbuf.flatten(layout, delta)[0]
    seg = flatbuf.const("row_segments", layout, 0, dev)
    sizes = flatbuf.const("segment_sizes", layout, 0, dev)
    bucket_sign = lambda: ops.bucket_sign_compress(X, seg, sizes)
    yb, scales = bucket_sign()
    leaf_scales = torch.stack([y.abs().amax() for y in ys])
    exact = torch.stack([d.double().abs().sum() / d.numel()
                         for d in tree_leaves(delta)])
    rel = lambda a, b: float(((a.double() - b).abs() / b).max())
    scale_rel = rel(leaf_scales, scales.double())
    leaf_rel, bucket_rel = rel(leaf_scales, exact), rel(scales, exact)
    signs_equal = all(torch.equal(torch.sign(a), torch.sign(b)) for a, b in
                      zip(ys, tree_leaves(flatbuf.unflatten(layout, [yb]))))

    o_train = causal_attention(q, k, v)
    f_err = rel_err(o_flash, o_train)
    rec = {"phase": "T", "model": cfg.name, "leaves": n_leaves,
           "params": sum(t.numel() for t in tree_leaves(params)),
           "launches": counts,
           "sgd_p_max_abs_err": p_err, "sgd_p_rel": p_err / p_max,
           "sgd_u_max_abs_err": u_err, "sgd_u_rel": u_err / u_max,
           "sgd_tol": TOL["elementwise"],
           "sign_scale_max_rel_err": scale_rel, "sign_scale_tol": TOL["scatter_add"],
           "leaf_scale_vs_f64_rel": leaf_rel, "leaf_scale_vs_f64_tol": TOL["reduction"],
           "bucket_scale_vs_f64_rel": bucket_rel,
           "signs_equal": signs_equal,
           "flash_vs_training_attention_max_abs_err": f_err[0],
           "flash_vs_training_attention_rel": f_err[1],
           "flash_tol": TOL["flash_f32"],
           "per_leaf_sgd_ms": time_ms(per_leaf_sgd),
           "bucket_sgd_ms": time_ms(bucket_sgd),
           "per_leaf_sign_ms": time_ms(per_leaf_sign),
           "bucket_sign_ms": time_ms(bucket_sign),
           "flash_ms": time_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
           "training_attention_ms": time_ms(lambda: causal_attention(q, k, v)),
           "library_ms": time_ms(sdpa_call(q, k, v, 0))}
    emit(rec)
    want = {"fused_sgd_2d": n_leaves, "abs_sum": n_leaves,
            "scale_sign": n_leaves, "flash_attention_bhsd": 1}
    bad = [k for k, ok in (
        ("launches", counts == want),
        ("sgd", max(p_err / p_max, u_err / u_max) <= TOL["elementwise"]),
        ("sign scales", scale_rel <= TOL["scatter_add"]),
        ("per-leaf scales", leaf_rel <= TOL["reduction"]), ("signs", signs_equal),
        ("flash", f_err[1] <= TOL["flash_f32"])) if not ok]
    if bad:
        raise AssertionError(f"phase T: {', '.join(bad)} (launches {counts}, "
                             f"want {want})")
    return counts


def phase_run(mode: str, cfg, seq: int, local_batch: int, *, steps=STEPS,
              lars: bool = False, block_steps: int = 1, controller=None,
              noise_eta: float = 0.0):
    """The phases' RunConfig; ``lars`` switches to LARS with telemetry
    (grad_clip stays set: LARS ignores it); ``block_steps`` > 1 is
    hierarchical local SGD (Alg. 5, the default two blocks);
    ``controller`` a ``ControllerConfig`` keyword dict (an adaptive
    policy); ``noise_eta`` the gradient noise."""
    from repro_torch.configs.base import (ControllerConfig, InputShape,
                                          LocalSGDConfig, OptimConfig, RunConfig)
    opt = (dict(optimizer="lars", base_lr=LARS_LR, lars_trust=LARS_TRUST)
           if lars else dict(base_lr=0.3))
    return RunConfig(
        model=cfg, shape=InputShape("chip", seq, W * local_batch, "train"),
        local_sgd=LocalSGDConfig(local_steps=4, post_local_switch=4,
                                 sync_compression=mode,
                                 block_steps=block_steps),
        optim=OptimConfig(base_batch=32, lr_warmup_steps=2, grad_clip=1.0,
                          noise_eta=noise_eta, **opt),
        controller=ControllerConfig(**(controller or dict(telemetry=lars))),
        steps=steps)


def phase_h(cfg, a_step_s: float) -> dict:
    """Phase H: hierarchical local SGD (Alg. 5) at full width with phase
    A's settings and block_steps=2; returns its launch counts."""
    import torch
    from repro_torch.core.schedule import sync_boundaries
    from repro_torch.kernels import fused_bucket as fb

    run = phase_run("none", cfg, seq=512, local_batch=8, block_steps=2)
    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    state, hist, summ, step_s = train_run(run, device="cuda", steps=STEPS)
    counts = dict(fb.LAUNCHES)
    losses = [h["loss"] for h in hist]
    syncs = [(h["step"], h["synced"]) for h in hist if h["synced"]]
    want_syncs = [(t, "block" if level == 1 else "global")
                  for t, level in sync_boundaries(run.local_sgd, STEPS)]
    bucket = FULL_ROWS * 128 * 4          # one worker copy of the f32 bucket
    led = summ["ledger"]
    topo = {k: (v["rounds"], v["wire_bytes"], v["collectives"])
            for k, v in led["topologies"].items()}
    # ring all-reduce over n workers: 2 (n - 1) / n x the bucket each
    want_topo = {"hierarchical/block": (3, 3 * 1.0 * bucket, 3),
                 "hierarchical/global": (3, 3 * 1.5 * bucket, 3)}
    median = statistics.median(step_s[1:])
    tokens = run.shape.global_batch * run.shape.seq_len
    emit({"phase": "H", "model": cfg.name, "W": W, "local_batch": 8, "seq": 512,
          "block_steps": 2, "topology": summ["topology"], "steps": STEPS,
          "loss": losses, "comm_rounds": summ["comm_rounds"], "syncs": syncs,
          "ledger_topologies": led["topologies"],
          "ledger_wire_MB": led["wire_bytes"] / 1e6,
          "flat_rounds_wire_MB": 6 * 1.5 * bucket / 1e6,
          "step_s": step_s, "step_s_median": median,
          "phase_A_step_s_median": a_step_s, "step_s_over_phase_A": median / a_step_s,
          "tokens_per_s": tokens / median, "wall_s": summ["wall_s"],
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
          "launches": counts})
    want = {k: 0 for k in fb.LAUNCHES}
    want.update(fused_sgd_bucket=STEPS, sq_sum=STEPS)
    bad = [k for k, ok in (
        ("loss not finite or not falling",
         all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]),
        ("syncs", syncs == want_syncs == [(0, "block"), (1, "global"), (2, "block"),
                                          (3, "global"), (7, "block"), (11, "global")]),
        ("comm rounds", summ["comm_rounds"] == {"block": 3, "global": 3}),
        ("topology", summ["topology"] == "hierarchical(block_size=2)"),
        ("ledger", topo == want_topo and led["wire_bytes"] == 7.5 * bucket),
        ("launches", counts == want)) if not ok]
    if bad:
        raise AssertionError(f"phase H: {', '.join(bad)} (syncs {syncs}, ledger "
                             f"{topo}, launches {counts})")
    del state
    return counts


def read_jsonl(path: Path) -> list:
    return [json.loads(x) for x in path.read_text().splitlines()]


def round_modes(recs: list) -> list:
    """Per global round, the (h, compression, batch_scale, lr_scale) the
    round RAN under: the previous record's next_* (the first round runs
    under the controller's initial decision)."""
    out, prev = [], None
    for r in recs:
        out.append(prev)
        prev = (r["next_h"], r["next_compression"], r["next_batch_scale"],
                r["next_lr_scale"])
    return out


def sensor_margins(recs: list, cc: dict, global_batch: int) -> dict:
    """Relative distance of each sensor a decision read to its threshold,
    per round: the diversity EMA to low / high (diversity_h and
    noise_adaptive), each compression error to err_budget, the
    critical-batch EMA to noise_grow x the total batch."""
    from repro_torch.configs.base import ControllerConfig
    c = ControllerConfig(**cc)
    out, ema, scale = [], None, 1
    for r in recs:
        m = {}
        if c.kind in ("diversity_h", "noise_adaptive") and "diversity" in r:
            d = r["diversity"]
            ema = d if ema is None else c.ema * ema + (1 - c.ema) * d
            m["diversity_ema"] = min(abs(ema - t) / t for t in (c.low, c.high))
        if c.kind in ("auto_compress", "noise_adaptive") and r["comp_measured"]:
            m["comp_rel_err"] = min(abs(e - c.err_budget) / c.err_budget
                                    for e in r["comp_rel_err"])
        bn = r.get("decisions", {}).get("b_noise")
        if bn:
            total = c.noise_grow * global_batch * scale
            m["b_noise_ema"] = abs(bn["ema"] - total) / total
        scale = r["next_batch_scale"]
        out.append(m)
    return out


def decision_trace(recs: list) -> list:
    """Per round: the next decisions and the non-float provenance."""
    keep = lambda d: {k: {f: v for f, v in d[k].items()
                          if not isinstance(v, float) and f != "comp_rel_err"}
                      for k in d if k != "b_noise"}
    return [(r["next_h"], r["next_compression"], r["next_batch_scale"],
             r["next_lr_scale"], keep(r.get("decisions", {}))) for r in recs]


def phase_n(cfg, b_step_s: float) -> dict:
    """Phase N: noise-adaptive post-local SGD at full width (phase B's
    settings with NOISE_CC): the controller actuates H, the compressor and
    the batch from the round telemetry; every global sync launches the
    compressor pair once, speculatively while the bucket is uncompressed.
    Returns the launch counts."""
    import torch
    from repro_torch.kernels import fused_bucket as fb

    run = phase_run("ef_sign", cfg, seq=512, local_batch=8, controller=NOISE_CC)
    path = ROOT / "build" / "phase_n.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    fb.reset_launches()
    state, hist, summ, step_s = train_run(run, device="cuda", steps=STEPS,
                                          telemetry_path=path)
    counts = dict(fb.LAUNCHES)
    recs = read_jsonl(path)
    ran = round_modes(recs)
    margins = sensor_margins(recs, NOISE_CC, run.shape.global_batch)
    for r, under, m in zip(recs, ran, margins):
        mode = under[1] if under else "none"
        emit({"phase": "N", "round": r["round"], "step": r["step"], "h": r["h"],
              "compression": mode, "batch_scale": under[2] if under else 1,
              "lr_scale": under[3] if under else 1.0,
              "comp_rel_err": r["comp_rel_err"],
              "comp_err_kind": "speculative" if mode == "none" else "measured",
              "diversity": r["diversity"], "signal_sq": r["signal_sq"],
              "noise_sq": r["noise_sq"], "loss": r["loss"],
              "next": [r["next_h"], r["next_compression"], r["next_batch_scale"],
                       r["next_lr_scale"]],
              "decisions": r.get("decisions", {}), "margins": m})
    # the batch scale each step ran at: a round's decision holds from the
    # step after its sync
    scale_at, scale = [], 1
    by_step = {r["step"]: r["next_batch_scale"] for r in recs}
    for t in range(STEPS):
        scale_at.append(scale)
        scale = by_step.get(t, scale)
    med = {s: statistics.median([x for t, x in enumerate(step_s)
                                 if scale_at[t] == s and t > 0] or [float("nan")])
           for s in sorted(set(scale_at))}
    losses = [h["loss"] for h in hist]
    rounds = summ["comm_rounds"]["global"]
    led = summ["ledger"]["scaling"]
    ran_scales = [u[2] if u else 1 for u in ran]
    ran_lr = [u[3] if u else 1.0 for u in ran]
    actuated = [r["round"] for r in recs
                if set(r.get("decisions", {})) & {"h", "compression", "batch", "lr"}]
    emit({"phase": "N", "model": cfg.name, "W": W, "local_batch": 8, "seq": 512,
          "controller": NOISE_CC, "steps": STEPS, "loss": losses,
          "comm_rounds": summ["comm_rounds"], "actuated_rounds": actuated,
          "batch_scale_at_step": scale_at, "step_s": step_s,
          "step_s_median_by_scale": {str(k): v for k, v in med.items()},
          "phase_B_step_s_median": b_step_s,
          "tokens_per_s_by_scale": {str(k): W * 8 * k * 512 / v
                                    for k, v in med.items()},
          "ledger_scaling": led, "summary_controller": summ["controller"],
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
          "launches": counts,
          "min_margin": min((v for m in margins for v in m.values()),
                            default=None)})
    want = {k: 0 for k in fb.LAUNCHES}
    want.update(fused_sgd_bucket=STEPS, sq_sum=STEPS, row_abs_sum=rounds,
                scale_sign_rows=rounds)
    bad = [k for k, ok in (
        ("no decision changed an actuator", bool(actuated)),
        ("loss not finite", all(math.isfinite(v) for v in losses)),
        ("launches", counts == want),
        ("rounds", rounds == len(recs) > 0),
        ("ledger scaling", led["batch_scale_range"] == [min(ran_scales),
                                                        max(ran_scales)]
         and led["lr_scale_range"] == [min(ran_lr), max(ran_lr)]),
        ("summary", summ["controller"]["batch_scale"] == recs[-1]["next_batch_scale"]
         and summ["controller"]["lr_scale"] == recs[-1]["next_lr_scale"]))
        if not ok]
    if bad:
        raise AssertionError(f"phase N: {', '.join(bad)} (launches {counts}, want "
                             f"{want}; ledger {led}; decisions {actuated})")
    del state
    return counts


def noise_check(cfg) -> dict:
    """Gradient noise at full width: ``_bucket_noise`` on a zero grad bucket
    (W x 934,040 x 128) at t = 0 and t = 10 against sigma_t^2 = eta /
    (1+t)^gamma (per-element variance within 1e-3 relative, mean below
    1e-3 sigma_t, padding exactly zero, one seed the same bits), then 4
    full-width steps with noise; returns the launch counts of the steps."""
    import torch
    from repro_torch.core import flatbuf
    from repro_torch.core.local_sgd import _bucket_noise
    from repro_torch.kernels import fused_bucket as fb
    from repro_torch.models import base as mbase
    from repro_torch.models import lm

    dev = "cuda"
    layout = flatbuf.build_layout(mbase.abstract(lm.param_specs(cfg), torch.float32))
    rows = layout.bucket_rows[0]
    valid = flatbuf.const("valid_mask", layout, 0, dev)
    n = float(valid.sum()) * W
    bad = []
    for t in NOISE_STEPS:
        sigma = math.sqrt(NOISE_ETA / (1.0 + t) ** NOISE_GAMMA)
        draw = lambda: _bucket_noise(
            layout, [torch.zeros((W, rows, 128), device=dev)],
            torch.Generator(device=dev).manual_seed(t), step=t, eta=NOISE_ETA,
            gamma=NOISE_GAMMA)[0]
        g = draw()
        mean = float(g.sum(dtype=torch.float64)) / n
        var = float((g.double() ** 2).sum()) / n - mean ** 2
        pad_max = float((g * (1 - valid)).abs().max())
        same = bool(torch.equal(g.view(torch.int32), draw().view(torch.int32)))
        rec = {"phase": "noise", "shape": [W, rows, 128], "step": t,
               "eta": NOISE_ETA, "gamma": NOISE_GAMMA, "sigma": sigma,
               "var_rel_err": abs(var / sigma ** 2 - 1), "var_tol": 1e-3,
               "mean_over_sigma": abs(mean) / sigma, "mean_tol": 1e-3,
               "padding_max_abs": pad_max, "same_bits_same_seed": same}
        emit(rec)
        if not (rec["var_rel_err"] <= 1e-3 and rec["mean_over_sigma"] <= 1e-3
                and pad_max == 0.0 and same):
            bad.append(f"t={t}")
        del g
    run = phase_run("none", cfg, seq=512, local_batch=8, steps=4,
                    noise_eta=NOISE_ETA)
    fb.reset_launches()
    state, hist, _, step_s = train_run(run, device="cuda", steps=4)
    counts = dict(fb.LAUNCHES)
    losses = [h["loss"] for h in hist]
    emit({"phase": "noise", "model": cfg.name, "noise_eta": NOISE_ETA,
          "steps": 4, "loss": losses, "step_s": step_s, "launches": counts})
    want = {k: 0 for k in fb.LAUNCHES}
    want.update(fused_sgd_bucket=4, sq_sum=4)
    if not all(math.isfinite(v) for v in losses) or counts != want:
        bad.append(f"noisy steps: losses {losses}, launches {counts}")
    if bad:
        raise AssertionError(f"gradient noise check failed: {bad}")
    del state
    return counts


def phase_c_controllers(smoke, p0):
    """Phase C for the compression-escalating policies: the trainer with
    auto_compress / noise_adaptive on the card and on the CPU at smoke
    size, from the same weights: the same decision sequence, and losses
    and params within phase C's EF-sign tolerances."""
    import torch
    from repro_torch.utils import tree_map

    rel = lambda a, b: abs(a - b) / abs(b) if b else abs(a)
    for cc in C_CONTROLLERS:
        run = phase_run("ef_sign", smoke, seq=64, local_batch=2, steps=8,
                        controller=cc)
        out = {}
        for dev in ("cuda", "cpu"):
            path = ROOT / "build" / f"phase_c_{cc['kind']}_{dev}.jsonl"
            path.parent.mkdir(parents=True, exist_ok=True)
            st, hist, summ, _ = train_run(
                run, device=dev, steps=8, telemetry_path=path,
                params0=tree_map(lambda t: t.to(dev).clone(), p0))
            out[dev] = (st.params.buckets[0].cpu(), [h["loss"] for h in hist],
                        summ, read_jsonl(path))
        (pg, lg, sg, rg), (pc, lc, sc, rc) = out["cuda"], out["cpu"]
        loss_rel = max(rel(a, b) for a, b in zip(lg, lc))
        d = (pg - pc).abs()
        frac = float((d > 1e-4 * pc.abs().max()).float().mean())
        dg, dc = decision_trace(rg), decision_trace(rc)
        margins = sensor_margins(rg, cc, run.shape.global_batch)
        low = [(i + 1, k, v) for i, m in enumerate(margins)
               for k, v in m.items() if v < 1e-3]
        emit({"phase": "C", "model": smoke.name, "controller": cc,
              "sync_compression": "ef_sign", "steps": 8,
              "comm_rounds": sg["comm_rounds"], "decisions_gpu": dg,
              "decisions_cpu": dc, "decisions_equal": dg == dc,
              "loss_gpu": lg, "loss_cpu": lc, "loss_max_rel_diff": loss_rel,
              "loss_tol": 1e-4, "params_frac_beyond_1e-4_of_max": frac,
              "frac_tol": 1e-4, "sensor_margins": margins,
              "margins_below_1e-3": low})
        from repro_torch.core.controller import make_controller
        d0 = make_controller(run, n_comp=1).plan_delta(0)
        actuated = any(x[1] != "|".join(d0.compression) or x[2] != 1
                       or x[3] != 1.0 or "h" in x[4] for x in dc)
        if dg != dc or loss_rel > 1e-4 or frac > 1e-4 or not actuated \
                or sg["comm_rounds"] != sc["comm_rounds"]:
            raise AssertionError(f"phase C ({cc['kind']}): the controller on "
                                 f"the card disagrees with the CPU's (or never "
                                 f"actuated): {dg} vs {dc}")
        torch.cuda.empty_cache()


def phase_g() -> dict:
    """Phase G: the paper's experiments through the port's harness
    (``repro_torch.benchmarks``) at its full size: card vs CPU, the full
    rows of G_ROUNDS, two profiles; returns the full rows' launch counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.benchmarks import common as hc
    from repro_torch.benchmarks import paper_tables as pt
    from repro_torch.kernels import fused_bucket as fb

    t_phase = time.perf_counter()
    train, test = hc.dataset()
    rel = lambda a, b: abs(a - b) / abs(b) if b else abs(a)
    # card vs CPU from the same weights (drawn on the CPU, then moved)
    for name, kw in (("fig1/A5_post_local", dict(pt.fig1_rows(24))["A5_post_local"]),
                     ("table4/EFsign_post_H8",
                      dict(pt.table4_rows(24))["EFsign_post_H8"])):
        out = {}
        for dev in ("cuda", "cpu"):
            st, comm, hist = hc.train_local_sgd(steps=24, train=train, device=dev,
                                                return_history=True, **kw)
            out[dev] = (st.params.buckets[0].cpu(), comm,
                        [h["loss"] for h in hist], hc.test_acc(st, test))
        (pg, cg, lg, ag), (pc, cc, lc, ac) = out["cuda"], out["cpu"]
        loss_rel = max(rel(a, b) for a, b in zip(lg, lc))
        frac = float(((pg - pc).abs() > 1e-4 * pc.abs().max()).float().mean())
        emit({"phase": "G", "check": "card vs cpu", "row": name, **kw,
              "steps": 24, "comm_rounds_gpu": cg, "comm_rounds_cpu": cc,
              "loss_gpu": lg, "loss_cpu": lc, "loss_max_rel_diff": loss_rel,
              "loss_tol": 1e-4, "params_frac_beyond_1e-4_of_max": frac,
              "frac_tol": 1e-4, "test_acc_gpu": ag, "test_acc_cpu": ac})
        if cg != cc or loss_rel > 1e-4 or frac > 1e-4:
            raise AssertionError(f"phase G ({name}): the harness on the card "
                                 f"disagrees with the CPU's")

    rows = dict([("fig1/" + n, kw) for n, kw in pt.fig1_rows(G_STEPS)]
                + [("table4/" + n, kw) for n, kw in pt.table4_rows(G_STEPS)]
                + [("table16/" + n, kw) for n, kw in pt.table16_rows()])
    launches = {k: 0 for k in fb.LAUNCHES}
    t0 = time.perf_counter()
    for name in G_ROUNDS:
        kw = rows[name]
        fb.reset_launches()
        with hc.wall_timer() as w:
            st, comm, hist = hc.train_local_sgd(steps=G_STEPS, train=train,
                                                return_history=True,
                                                device="cuda", **kw)
        counts = dict(fb.LAUNCHES)
        rounds = pt.sync_split(comm, kw.get("block_steps", 1))
        losses = [h["loss"] for h in hist]
        acc = hc.test_acc(st, test)
        comp = rounds[0] if kw.get("sync_compression", "none") != "none" else 0
        want = {k: 0 for k in fb.LAUNCHES}
        want.update(fused_sgd_bucket=G_STEPS, row_abs_sum=comp, scale_sign_rows=comp)
        emit({"phase": "G", "row": name, **kw, "steps": G_STEPS,
              "test_acc": acc, "global_sync": rounds[0], "block_sync": rounds[1],
              "us_per_step": w["us"] / G_STEPS,
              "loss_first": losses[0], "loss_final": losses[-1],
              "launches": counts})
        bad = [k for k, ok in (
            ("comm rounds", rounds == G_ROUNDS[name]),
            ("loss not finite or not falling",
             all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]),
            ("test acc <= 0.5", acc > 0.5),
            ("launches", counts == want)) if not ok]
        if bad:
            raise AssertionError(f"phase G ({name}): {', '.join(bad)} (rounds "
                                 f"{rounds}, want {G_ROUNDS[name]}; launches "
                                 f"{counts}, want {want})")
        for k, v in counts.items():
            launches[k] += v
        del st
    rows_s = time.perf_counter() - t0

    # device busy, idle share and the host's busiest ops over 24 steps of
    # two K=8 rows: B_loc 64 and 32
    for name in ("fig1/A2_large_mb", "table16/H1_Hb8"):
        kw = dict(rows[name], steps=24, train=train, device="cuda")
        hc.train_local_sgd(**dict(kw, steps=4))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            hc.train_local_sgd(**kw)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t1)
        ev = prof.key_averages()
        kern = [e for e in ev
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        host = [e for e in ev if e.device_type == DeviceType.CPU]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        emit({"phase": "G", "profile": name, "steps": 24,
              "wall_ms_under_profiler": wall_ms,
              "device_busy_ms": busy_ms if kern else None,
              "idle_share": 1 - busy_ms / wall_ms if kern else None,
              "kernel_launches": sum(e.count for e in kern),
              "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                              for e in sorted(kern, key=lambda e:
                                              -e.self_device_time_total)[:6]],
              "top_host_ops_self_ms": [
                  [e.key[:60], e.self_cpu_time_total / 1e3, e.count]
                  for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]]})
    emit({"phase": "G", "full_rows_s": rows_s,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run this from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check runs on the card only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import configs
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import fused_bucket as fb

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    bw, flops_peak, bf16_peak, tf32_peak = card_rates(name)
    emit({"phase": "card", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "mem_bw_Bps": bw,
          "f32_peak_flops": flops_peak, "bf16_tensor_peak_flops": bf16_peak,
          "tf32_tensor_peak_flops": tf32_peak,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    libs = kbuild.build_all()
    emit({"phase": "build", "build_s": time.perf_counter() - t0,
          "libraries": {k: str(v.relative_to(ROOT)) if v.is_relative_to(ROOT)
                        else str(v) for k, v in libs.items()}})
    # flash attention's instantiations: nvcc -Xptxas -v, and tensor-core
    # instructions in the SASS (HMMA: mma.sync, HGMMA: wgmma)
    ptxas = ptxas_table(kbuild.build_log("flash_attention"))
    sass = sass_mma_counts(libs["flash_attention"])
    emit({"phase": "build", "source": "flash_attention.cu", "ptxas": ptxas,
          "sass_tensor_core_instructions": sass})
    if not ptxas or any(r.get("spill_stores", 1) or r.get("spill_loads", 1)
                        for r in ptxas.values()):
        print(f"chip_smoke: flash attention spills registers: {ptxas}",
              file=sys.stderr, flush=True)
    if sass is not None and not all(c["HMMA"] + c["HGMMA"] for c in sass.values()):
        raise AssertionError(f"a flash instantiation has no tensor-core "
                             f"instruction: {sass}")

    check_kernels(RAGGED_ROWS, bw, flops_peak, timed=False)
    full = check_kernels(FULL_ROWS, bw, flops_peak, timed=True)
    check_mlp_bucket(bw, flops_peak)
    check_per_tensor(RAGGED_N, bw, flops_peak, timed=False)
    full.update(check_per_tensor(FULL_N, bw, flops_peak, timed=True))
    for spec in FLASH_RAGGED:
        check_flash(spec, bw, flops_peak, bf16_peak, tf32_peak, timed=False)
    for spec in FLASH_FULL:
        full.update(check_flash(spec, bw, flops_peak, bf16_peak, tf32_peak,
                                timed=True))

    # ---- the main path: phases A (mean), B (EF-sign), L (LARS) ----
    from repro_torch.telemetry.stats import round_summary
    cfg = configs.get("paper-lm")
    launches = {k: 0 for k in fb.LAUNCHES}
    step_median = {}
    for phase, mode, lars in (("A", "none", False), ("B", "ef_sign", False),
                              ("L", "ef_sign", True)):
        run = phase_run(mode, cfg, seq=512, local_batch=8, lars=lars)
        torch.cuda.reset_peak_memory_stats()
        fb.reset_launches()
        state, hist, summ, step_s = train_run(run, device="cuda", steps=STEPS)
        counts = dict(fb.LAUNCHES)
        losses = [h["loss"] for h in hist]
        syncs = summ["comm_rounds"]["global"]
        tokens = run.shape.global_batch * run.shape.seq_len
        rec = {"phase": phase, "model": cfg.name, "W": W, "local_batch": 8,
               "seq": 512, "sync_compression": mode,
               "optimizer": run.optim.optimizer, "base_lr": run.optim.base_lr,
               "lars_trust": run.optim.lars_trust if lars else None,
               "grad_clip": run.optim.grad_clip, "steps": STEPS,
               "loss": losses, "comm_rounds": summ["comm_rounds"],
               "step_s": step_s, "step_s_median": statistics.median(step_s[1:]),
               "tokens_per_s": tokens / statistics.median(step_s[1:]),
               "wall_s": summ["wall_s"],
               "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
               "launches": counts}
        step_median[phase] = rec["step_s_median"]
        summary = round_summary(state.stats) if lars else None
        if lars:
            rec["round_summary"] = summary
        emit(rec)
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"phase {phase}: loss not finite or not "
                                 f"falling: {losses}")
        if syncs != 6:
            raise AssertionError(f"phase {phase}: {syncs} global syncs, want 6")
        comp = syncs if mode != "none" else 0
        want = {k: 0 for k in fb.LAUNCHES}
        want.update(row_abs_sum=comp, scale_sign_rows=comp)
        if lars:
            want.update(lars_row_norms=STEPS, fused_lars_bucket=STEPS)
        else:
            want.update(fused_sgd_bucket=STEPS, sq_sum=STEPS)
        if counts != want:
            raise AssertionError(f"phase {phase}: launches {counts}, want {want}")
        if lars:
            floats = [v for k, v in summary.items() if isinstance(v, float)]
            floats += summary["comp_rel_err"]
            if (summary["rounds"] != syncs or not summary["comp_measured"]
                    or not all(math.isfinite(v) for v in floats)):
                raise AssertionError(f"phase {phase}: telemetry {summary}")
        for k, v in counts.items():
            launches[k] += v
        del state
        torch.cuda.empty_cache()

    for k, v in phase_h(cfg, step_median["A"]).items():
        launches[k] += v
    torch.cuda.empty_cache()

    launches.update(phase_t(cfg))
    torch.cuda.empty_cache()

    for k, v in phase_n(cfg, step_median["B"]).items():
        launches[k] += v
    torch.cuda.empty_cache()
    for k, v in noise_check(cfg).items():
        launches[k] += v
    torch.cuda.empty_cache()

    for lars in (False, True):
        profile_phase(phase_run("ef_sign", cfg, seq=512, local_batch=8, lars=lars))
        torch.cuda.empty_cache()

    # ---- C: the trainer on the card vs on the CPU (plain versions) ----
    # Loss 1e-4 relative per step; params: all but frac_tol of the elements
    # within 1e-4 x the largest; summary floats 1e-4 relative.  Under
    # EF-sign a delta within rounding of 0 may take the other sign on the
    # other device and move its element by a whole scale.  LARS + EF-sign
    # flips more of them than SGD + EF-sign (on the CPU, rounding-level
    # changes of the starting weights alone flip more than 1e-4 of the
    # elements), so it takes frac_tol 1e-3, and the summary fields read
    # from ||mean_k x_k||^2, which each flip moves by about one element's
    # share, take 1e-2.  LARS + mean sync has no flips and takes them all.
    from repro_torch.models import base as mbase
    from repro_torch.models import lm
    from repro_torch.utils import tree_map
    smoke = configs.get_smoke("paper-lm")
    p0 = mbase.materialize(lm.param_specs(smoke),
                           torch.Generator().manual_seed(0), "cpu")
    rel = lambda a, b: abs(a - b) / abs(b) if b else abs(a)
    for optimizer, mode, block_steps in (("sgd", "ef_sign", 1), ("sgd", "none", 2),
                                         ("lars", "none", 1), ("lars", "ef_sign", 1)):
        lars = optimizer == "lars"
        flips = lars and mode == "ef_sign"
        frac_tol = 1e-3 if flips else 1e-4
        run = phase_run(mode, smoke, seq=64, local_batch=2, steps=6, lars=lars,
                        block_steps=block_steps)
        sg, hg, sumg, _ = train_run(run, device="cuda", steps=6,
                                    params0=tree_map(lambda t: t.to("cuda"), p0))
        sc, hc, sumc, _ = train_run(run, device="cpu", steps=6,
                                    params0=tree_map(lambda t: t.clone(), p0))
        lg, lc = [h["loss"] for h in hg], [h["loss"] for h in hc]
        loss_rel = max(rel(a, b) for a, b in zip(lg, lc))
        pg, pc = sg.params.buckets[0].cpu(), sc.params.buckets[0]
        d = (pg - pc).abs()
        frac = float((d > 1e-4 * pc.abs().max()).float().mean())
        rec = {"phase": "C", "model": smoke.name, "optimizer": optimizer,
               "sync_compression": mode, "block_steps": block_steps,
               "topology": sumg["topology"], "comm_rounds": sumg["comm_rounds"],
               "steps": 6, "loss_gpu": lg,
               "loss_cpu": lc, "loss_max_rel_diff": loss_rel, "loss_tol": 1e-4,
               "params_max_abs_diff": float(d.max()),
               "params_frac_beyond_1e-4_of_max": frac, "frac_tol": frac_tol}
        bad = []
        if lars:
            ssg, ssc = round_summary(sg.stats), round_summary(sc.stats)
            errs = {k: rel(ssg[k], v) for k, v in ssc.items() if isinstance(v, float)}
            errs["comp_rel_err"] = max(rel(a, b) for a, b in
                                       zip(ssg["comp_rel_err"], ssc["comp_rel_err"]))
            tols = {k: 1e-2 if flips and k in SYNC_MEAN_KEYS else 1e-4 for k in errs}
            bad = [k for k in errs if errs[k] > tols[k]]
            rec.update(round_summary_gpu=ssg, round_summary_cpu=ssc,
                       stats_rel_diff=errs, stats_tol=tols)
        if sumg["comm_rounds"] != sumc["comm_rounds"]:
            bad.append("comm_rounds")
        emit(rec)
        if loss_rel > 1e-4 or frac > frac_tol or bad:
            raise AssertionError(f"phase C ({optimizer}, {mode}): the trainer on "
                                 f"the card disagrees with the trainer on the CPU"
                                 f"{': ' + ', '.join(bad) if bad else ''}")

    phase_c_controllers(smoke, p0)

    for k, v in phase_g().items():
        launches[k] += v
    torch.cuda.empty_cache()

    # launches: phases A, B, L, H, N, G and the noise check for the bucket
    # kernels, T for the others
    if not all(launches[k] > 0 for k in KERNELS):
        raise AssertionError(f"a kernel was not launched on its path: {launches}")
    emit({"kernels": [
        {"name": k, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/" + KERNELS[k][1],
         "replaces": "src/repro/kernels/" + KERNELS[k][0],
         "launches": launches[k], "max_abs_err": full[k]["max_abs_err"],
         "ms": full[k]["ms"], "plain_ms": full[k]["plain_ms"],
         "bound_ms": full[k]["bound_ms"], "bound_by": full[k]["bound_by"],
         "library_ms": full[k]["library_ms"]}
        for k in KERNELS]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
