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
  build    nvcc for every CUDA source, all started at once; build seconds.
  kernels  each kernel against its plain PyTorch version on the same card
           inputs, at the main path's shape (W=4 workers x 934,040 rows x
           128, float32: paper-lm's bucket) and at a ragged 3,101 rows;
           max errors against the stated tolerance, and times (median of
           CUDA-event-timed runs): kernel, plain version, the one PyTorch
           call that computes the same function where there is one
           (timed only, never used by the port), and the byte bound.
  A        the main path: paper-lm at full width, W=4 stacked on the card,
           post-local SGD, mean sync, 12 steps; launch counts.
  B        the same with EF-sign sync; the compressor kernels launch once
           per global sync.
  P        torch.profiler over two full-width local steps and one EF-sign
           sync: device busy time by kernel family and the idle share
           (profiler overhead included; not a timing of record).
  C        the trainer on the card against the trainer on the CPU (the
           kernels' plain versions) at smoke size, from the same weights.
"""
from __future__ import annotations

import json
import math
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
STEPS = 12
TOL = {"elementwise": 2e-6, "reduction": 1e-5, "sign": 0.0}
REPLACES = {
    "fused_sgd_bucket": "src/repro/kernels/fused_bucket.py:107",
    "sq_sum": "src/repro/kernels/fused_bucket.py:153",
    "row_abs_sum": "src/repro/kernels/fused_bucket.py:177",
    "scale_sign_rows": "src/repro/kernels/fused_bucket.py:304",
}
SOURCE = "src/repro_torch/kernels/csrc/fused_bucket.cu"


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_rates(name: str):
    """(memory bytes/s, float32 non-tensor flop/s) from NVIDIA's data
    sheets for the card present."""
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12
    if "H100" in name and "NVL" in name:
        return 3.9e12, 60e12
    if "H200" in name:
        return 4.8e12, 67e12
    return 3.35e12, 67e12          # H100 SXM


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
    res["sq_sum"] = dict(max_abs_err=e[0], max_rel_err=e[1],
                         tol=TOL["reduction"], ok=e[1] <= TOL["reduction"],
                         bytes=nbytes, flops=2 * n)
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
        res["sq_sum"].update(
            ms=time_ms(lambda: fb.sq_sum(x)),
            plain_ms=time_ms(lambda: fb.sq_sum_plain(x)),
            library_ms=time_ms(lambda: torch.linalg.vector_norm(
                x, 2, dim=(-2, -1)).square()))
        res["row_abs_sum"].update(
            ms=time_ms(lambda: fb.row_abs_sum(x)),
            plain_ms=time_ms(lambda: fb.row_abs_sum_plain(x)),
            library_ms=time_ms(lambda: torch.linalg.vector_norm(x, 1, dim=-1)))
        res["scale_sign_rows"].update(
            ms=time_ms(lambda: fb.scale_sign_rows(x, s)),
            plain_ms=time_ms(lambda: fb.scale_sign_rows_plain(x, s)),
            library_ms=None)
    del x
    for name, r in res.items():
        r["bound_ms"] = 1e3 * max(r["bytes"] / bw, r["flops"] / flops_peak)
        r["bound_by"] = "bytes" if r["bytes"] / bw >= r["flops"] / flops_peak \
            else "operations"
        emit({"phase": "kernels", "kernel": name, "W": W, "rows": rows, **r})
        if not r["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version at "
                                 f"rows={rows}: {r}")
    torch.cuda.empty_cache()
    return res


def train_run(run, *, device, steps, params0=None, seed=0):
    """fit() on markov_lm data; returns (state, history, summary, step_s)."""
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
    it = ShardedBatches(data, W, B, seed=seed)
    step_s = []

    class Timed:                       # host clock per step, synchronized
        def __next__(self):
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            step_s.append(time.perf_counter())
            return next(it)

    state, hist, summ = ttrain.fit(run, Timed(), bundle=bundle, num_steps=steps,
                                   seed=seed, params0=params0,
                                   log=lambda *a: None)
    step_s.append(summ["wall_s"] + step_s[0])
    return state, hist, summ, [b - a for a, b in zip(step_s, step_s[1:])]


BUCKET_KERNELS = ("sgd_kernel", "sq_sum_kernel", "reduce_rows_kernel",
                  "row_abs_sum_kernel", "scale_sign_rows_kernel")


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
    emit({"phase": "P", "window": "2 local steps + 1 ef_sign sync",
          "wall_ms_under_profiler": wall_ms,
          "device_busy_ms": busy_ms if kern else None,
          "idle_share": 1 - busy_ms / wall_ms if kern else None,
          "by_family_ms": fam,
          "top_kernels": [[e.key[:90], e.self_device_time_total / 1e3, e.count]
                          for e in top]})
    del state


def phase_run(mode: str, cfg, seq: int, local_batch: int, *, device="cuda",
              steps=STEPS, params0=None):
    from repro_torch.configs.base import (InputShape, LocalSGDConfig,
                                          OptimConfig, RunConfig)
    return RunConfig(
        model=cfg, shape=InputShape("chip", seq, W * local_batch, "train"),
        local_sgd=LocalSGDConfig(local_steps=4, post_local_switch=4,
                                 sync_compression=mode),
        optim=OptimConfig(base_lr=0.3, base_batch=32, lr_warmup_steps=2,
                          grad_clip=1.0),
        steps=steps)


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
    bw, flops_peak = card_rates(name)
    emit({"phase": "card", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "mem_bw_Bps": bw,
          "f32_peak_flops": flops_peak,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    libs = kbuild.build_all()
    emit({"phase": "build", "build_s": time.perf_counter() - t0,
          "libraries": {k: str(v.relative_to(ROOT)) if v.is_relative_to(ROOT)
                        else str(v) for k, v in libs.items()}})

    check_kernels(RAGGED_ROWS, bw, flops_peak, timed=False)
    full = check_kernels(FULL_ROWS, bw, flops_peak, timed=True)

    # ---- the main path: phases A (mean) and B (EF-sign) at full width ----
    cfg = configs.get("paper-lm")
    launches = {k: 0 for k in fb.LAUNCHES}
    expect_syncs = None
    for phase, mode in (("A", "none"), ("B", "ef_sign")):
        run = phase_run(mode, cfg, seq=512, local_batch=8)
        torch.cuda.reset_peak_memory_stats()
        fb.reset_launches()
        state, hist, summ, step_s = train_run(run, device="cuda", steps=STEPS)
        counts = dict(fb.LAUNCHES)
        losses = [h["loss"] for h in hist]
        syncs = summ["comm_rounds"]["global"]
        tokens = run.shape.global_batch * run.shape.seq_len
        emit({"phase": phase, "model": cfg.name, "W": W, "local_batch": 8,
              "seq": 512, "sync_compression": mode, "steps": STEPS,
              "loss": losses, "comm_rounds": summ["comm_rounds"],
              "step_s": step_s, "step_s_median": statistics.median(step_s[1:]),
              "tokens_per_s": tokens / statistics.median(step_s[1:]),
              "wall_s": summ["wall_s"],
              "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
              "launches": counts})
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"phase {phase}: loss not finite or not "
                                 f"falling: {losses}")
        want = {"fused_sgd_bucket": STEPS, "sq_sum": STEPS,
                "row_abs_sum": syncs if mode != "none" else 0,
                "scale_sign_rows": syncs if mode != "none" else 0}
        if counts != want:
            raise AssertionError(f"phase {phase}: launches {counts}, want {want}")
        expect_syncs = syncs if expect_syncs is None else expect_syncs
        if syncs != expect_syncs or syncs != 6:
            raise AssertionError(f"phase {phase}: {syncs} global syncs, want 6")
        for k, v in counts.items():
            launches[k] += v
        del state
        torch.cuda.empty_cache()

    profile_phase(phase_run("ef_sign", cfg, seq=512, local_batch=8))
    torch.cuda.empty_cache()

    # ---- C: the trainer on the card vs on the CPU (plain versions) ----
    from repro_torch.models import base as mbase
    from repro_torch.models import lm
    smoke = configs.get_smoke("paper-lm")
    run = phase_run("ef_sign", smoke, seq=64, local_batch=2, steps=6)
    from repro_torch.utils import tree_map
    p0 = mbase.materialize(lm.param_specs(smoke),
                           torch.Generator().manual_seed(0), "cpu")
    sg, hg, _, _ = train_run(run, device="cuda", steps=6,
                             params0=tree_map(lambda t: t.to("cuda"), p0))
    sc, hc, _, _ = train_run(run, device="cpu", steps=6,
                             params0=tree_map(lambda t: t.clone(), p0))
    lg, lc = [h["loss"] for h in hg], [h["loss"] for h in hc]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    pg, pc = sg.params.buckets[0].cpu(), sc.params.buckets[0]
    d = (pg - pc).abs()
    frac = float((d > 1e-4 * pc.abs().max()).float().mean())
    emit({"phase": "C", "model": smoke.name, "steps": 6, "loss_gpu": lg,
          "loss_cpu": lc, "loss_max_rel_diff": loss_rel, "loss_tol": 1e-4,
          "params_max_abs_diff": float(d.max()),
          "params_frac_beyond_1e-4_of_max": frac, "frac_tol": 1e-4})
    if loss_rel > 1e-4 or frac > 1e-4:
        raise AssertionError("phase C: the trainer on the card disagrees with "
                             "the trainer on the CPU")

    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": full[k]["max_abs_err"],
         "ms": full[k]["ms"], "plain_ms": full[k]["plain_ms"],
         "bound_ms": full[k]["bound_ms"], "bound_by": full[k]["bound_by"],
         "library_ms": full[k]["library_ms"]}
        for k in REPLACES]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
