"""Shared harness of the paper experiments (the port of the top-level
``benchmarks/common.py``).

CIFAR-scale experiments are reproduced on a synthetic Gaussian-cluster
classification task with a small MLP, structured enough (label noise and
a finite train set) to show a train/test generalization gap.  Training
runs the port's resident local SGD (``core.local_sgd``): the MLP's
parameters fill one float32 bucket, every local step is one fused SGD
launch and every sign / EF-sign sync one compressor pair.  Every
benchmark prints ``name,us_per_call,derived`` CSV rows through
:func:`emit`.

Entry points run on the card unless the caller passes ``device="cpu"``;
with no card and no device given they raise.
"""
from __future__ import annotations

import math
import time
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (InputShape, LocalSGDConfig, ModelConfig,
                                      OptimConfig, RunConfig)
from repro_torch.convert import params_from_reference
from repro_torch.core.local_sgd import LocalSGDState, make_local_sgd, mean_params
from repro_torch.core.schedule import local_steps_at
from repro_torch.data.partition import ShardedBatches
from repro_torch.data.synthetic import cluster_classification
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.utils import resolve_device

ROWS: list[str] = []
RECORDS: list[dict] = []

_METRICS = None


def bench_metrics():
    """The shared bench MetricsRegistry: every timing helper feeds the
    ``repro_bench_seconds`` histogram (label ``name``), so one Prometheus
    exposition covers the whole bench run (``run --json-out`` embeds it)."""
    global _METRICS
    if _METRICS is None:
        _METRICS = MetricsRegistry()
    return _METRICS


def _observe_bench(name: str, seconds: float):
    bench_metrics().histogram(
        "bench_seconds", "wall seconds per benchmark measurement",
        labels=("name",)).labels(name=name).observe(seconds)


def _parse_derived(derived: str) -> dict:
    """Best-effort parse of the semi-structured derived column
    ("k=v;k2=v2;freeform") into typed fields for the JSON artifact."""
    out: dict = {}
    for part in derived.split(";"):
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        v = v.strip().split(" ")[0]
        try:
            out[k.strip()] = int(v)
        except ValueError:
            try:
                out[k.strip()] = float(v)
            except ValueError:
                out[k.strip()] = v
    return out


def emit(name: str, us_per_call: float, derived: str = ""):
    """Print one CSV row and append the structured record."""
    row = f"{name},{us_per_call:.1f},{derived}"
    ROWS.append(row)
    RECORDS.append({"name": name, "us_per_call": round(us_per_call, 1),
                    **_parse_derived(derived),
                    "derived_raw": derived})
    print(row, flush=True)


# ---------------------------------------------------------------------------
# Small MLP classifier (the CIFAR/ResNet-20 stand-in)
# ---------------------------------------------------------------------------

DIM, CLASSES = 32, 10


def mlp_init(gen: torch.Generator, width=128):
    """The reference's distributions from an explicit generator, on its
    device: weights normal / sqrt(fan_in), drawn w1, w2, w3; zero biases.
    The draws never match JAX's: parity tests pass the reference's weights
    (``train_local_sgd(params0=...)``)."""
    dev = gen.device
    s = lambda a, b: torch.randn((a, b), generator=gen, device=dev) / math.sqrt(a)
    z = lambda n: torch.zeros((n,), device=dev)
    w1, w2, w3 = s(DIM, width), s(width, width), s(width, CLASSES)
    return {"w1": w1, "b1": z(width), "w2": w2, "b2": z(width),
            "w3": w3, "b3": z(CLASSES)}


def _logits(params, x):
    h = torch.relu(x @ params["w1"] + params["b1"])
    h = torch.relu(h @ params["w2"] + params["b2"])
    return h @ params["w3"] + params["b3"]


def mlp_loss(params, batch):
    logits = _logits(params, batch["x"])
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, batch["y"][..., None]).mean()
    acc = (logits.argmax(-1) == batch["y"]).float().mean()
    return nll, {"xent": nll, "acc": acc}


def dataset(seed=0, n_train=1536, n_test=2048, label_noise=0.2, margin=1.15):
    """Hard regime (tuned so batch-size noise effects are measurable):
    close clusters + 20% label noise + small train set. Seed-to-seed test
    accuracy spread is ~+/-0.5%; gaps below that are reported as ties."""
    (xtr, ytr), (xte, yte) = cluster_classification(
        num_classes=CLASSES, dim=DIM, n_train=n_train, n_test=n_test,
        seed=seed, margin=margin, label_noise=label_noise)
    return {"x": xtr, "y": ytr}, {"x": xte, "y": yte}


def test_acc(state_or_params, test):
    """Test accuracy of the worker-mean model (``mean_params`` of a state,
    the mean over the leading dim of a stacked tree, a single-copy tree as
    it is): float32 logits and argmax on the params' device."""
    if isinstance(state_or_params, LocalSGDState):
        p = mean_params(state_or_params)
    else:
        p = state_or_params
        if p["w1"].dim() == 3:
            p = {k: v.mean(dim=0) for k, v in p.items()}
    dev = p["w1"].device
    x = torch.as_tensor(test["x"]).to(dev, torch.float32)
    y = torch.as_tensor(test["y"]).to(dev, torch.int64)
    with torch.no_grad():
        return float((_logits(p, x).argmax(-1) == y).float().mean())


def _sync_device():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def train_local_sgd(*, K, B_loc, H, steps, lr=0.15, post_local_switch=-1,
                    block_steps=1, sync_compression="none", local_momentum=0.9,
                    global_momentum=0.0, noise_eta=0.0, seed=0, train=None,
                    lr_decay_frac=(0.5, 0.75), base_batch=None, width=256,
                    return_history=False, warmup_kind="none", warmup_steps=0,
                    params0=None, device=None):
    """The paper's training protocol on the synthetic task, on the port's
    resident path; returns (state, comm_rounds, history).

    LR decayed /10 at 50% and 75% of training, warmup 5% of steps.
    base_batch=None disables linear LR scaling.  ``warmup_kind`` /
    ``warmup_steps`` ramp H (Fig. 10).  A sync follows whenever the
    rounds' local steps reach ``local_steps_at``; with ``block_steps`` >
    1 every ``block_steps``-th sync is global and the others are Alg. 5
    block means over two blocks of K/2 workers.

    ``params0`` is a single-copy numpy tree (the reference's weights,
    through ``convert.params_from_reference``); without it the weights
    come from :func:`mlp_init` on a CPU generator seeded with ``seed``
    and are then moved, so the card and the CPU start alike.  The state's
    noise stream is seeded with ``seed + 1``.
    """
    dev = resolve_device(device)
    base_batch = base_batch or K * B_loc
    train = train or dataset()[0]
    run = RunConfig(
        model=ModelConfig(name="mlp", family="dense", citation=""),
        shape=InputShape("b", DIM, K * B_loc, "train"),
        local_sgd=LocalSGDConfig(local_steps=H, block_steps=block_steps,
                                 post_local_switch=post_local_switch,
                                 warmup_kind=warmup_kind,
                                 warmup_steps=warmup_steps,
                                 sync_compression=sync_compression,
                                 local_momentum=local_momentum,
                                 global_momentum=global_momentum),
        optim=OptimConfig(base_lr=lr, base_batch=base_batch,
                          lr_warmup_steps=max(steps // 20, 1),
                          lr_decay_steps=tuple(int(steps * f) for f in lr_decay_frac),
                          weight_decay=1e-4, noise_eta=noise_eta))
    init, local_step, sync = make_local_sgd(run, mlp_loss, num_workers=K)
    if params0 is None:
        p0 = mlp_init(torch.Generator().manual_seed(seed), width)
        p0 = {k: v.to(dev) for k, v in p0.items()}
    else:
        p0 = params_from_reference(params0, dev)
    state = init(p0, seed=seed + 1)
    it = ShardedBatches(train, K, B_loc, seed=seed)

    since = 0
    comm = 0
    hist = []
    for t in range(steps):
        state, m = local_step(state, next(it))
        since += 1
        if since >= local_steps_at(run.local_sgd, t):
            since = 0
            comm += 1
            scope = ("block" if block_steps > 1 and comm % block_steps != 0
                     else "global")
            state = sync(state, scope=scope)
        if return_history and (t % max(steps // 40, 1) == 0 or t == steps - 1):
            hist.append({"step": t, "loss": float(m["loss"])})
    return state, comm, hist


def time_fn(fn, *args, iters=20, warmup=3, name=None):
    """THE timing helper: warmup, then ``perf_counter`` around ``iters``
    calls ending in a device synchronize; returns µs per call.  ``name``
    also lands the measurement in the shared ``bench_seconds`` histogram."""
    for _ in range(warmup):
        fn(*args)
    _sync_device()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync_device()
    per_call_s = (time.perf_counter() - t0) / iters
    if name is not None:
        _observe_bench(name, per_call_s)
    return per_call_s * 1e6


@contextmanager
def wall_timer(name=None):
    """One-shot wall measurement for whole training loops (no warmup: the
    first call's set-up is part of what these benches report), between
    two device synchronizes.  Yields a dict that gains ``s``/``us`` on
    exit; feeds ``bench_seconds`` like :func:`time_fn` when ``name`` is
    given:

        with wall_timer("fig1/A1") as w:
            train_local_sgd(...)
        emit("fig1/A1", w["us"] / STEPS, ...)
    """
    out = {}
    _sync_device()
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        _sync_device()
        out["s"] = time.perf_counter() - t0
        out["us"] = out["s"] * 1e6
        if name is not None:
            _observe_bench(name, out["s"])
