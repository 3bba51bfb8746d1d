"""Figure 6 (App. B.2): convex logistic regression, time-to-accuracy under
simulated communication cost (comm = 25x one gradient step), on the port
(the twin of the top-level ``benchmarks/bench_convex.py``).

The w8a dataset is offline-unavailable; the synthetic sparse binary
stand-in ``data.synthetic.logreg_data`` takes its place with the same
protocol: grid over (K, H, B_loc), count gradient evaluations +
communication rounds to a target suboptimality. With a constant step
size the SGD noise floor sits at ~1e-2 suboptimality on this data, so
the target is eps = 0.02 (the paper's 0.005 needs their 1/t decayed
grid-searched step sizes).  ``device=None`` means the card.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad

from repro_torch.benchmarks.common import emit
from repro_torch.configs.base import (InputShape, LocalSGDConfig, ModelConfig,
                                      OptimConfig, RunConfig)
from repro_torch.core import flatbuf
from repro_torch.core.local_sgd import make_local_sgd
from repro_torch.data.synthetic import logreg_data
from repro_torch.utils import resolve_device

N, D = 4096, 100
LAMBDA = 1.0 / N
COMM_COST = 25.0


def _full_loss(w, x, y):
    z = x @ w
    return torch.mean(torch.log1p(torch.exp(-y * z))) + 0.5 * LAMBDA * torch.sum(w * w)


def _loss(params, batch):
    w = params["w"]
    z = batch["x"] @ w
    l = torch.mean(torch.log1p(torch.exp(-batch["y"] * z))) + 0.5 * LAMBDA * torch.sum(w * w)
    return l, {"xent": l}


def run_config(K, H, B_loc, *, steps=400, lr=8.0, seed=0, device=None):
    """(simulated time, steps, comm rounds, reached) of local SGD with H
    local steps to f* + 0.02, checking worker 0's model after each sync."""
    dev = resolve_device(device)
    x, y = logreg_data(n=N, d=D, seed=0)
    xj, yj = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    fstar = _fstar(xj, yj)
    run = RunConfig(model=ModelConfig(name="lr", family="dense", citation=""),
                    shape=InputShape("c", D, K * B_loc, "train"),
                    local_sgd=LocalSGDConfig(local_steps=H, local_momentum=0.0,
                                             nesterov=False),
                    optim=OptimConfig(base_lr=lr, base_batch=K * B_loc,
                                      lr_decay_steps=(), weight_decay=0.0))
    init, local_step, sync = make_local_sgd(run, _loss, num_workers=K)
    state = init({"w": torch.zeros(D, device=dev)}, seed=seed)
    layout = state.params.layout
    rng = np.random.default_rng(seed)
    target = fstar + 0.02
    comm = 0
    for t in range(steps):
        idx = torch.from_numpy(rng.integers(0, N, size=(K, B_loc))).to(dev)
        state, _ = local_step(state, {"x": xj[idx], "y": yj[idx]})
        if (t + 1) % H == 0:
            state = sync(state)
            comm += 1
            # worker 0's model, read from the resident buckets
            wbar = flatbuf.unflatten(layout, [b[0] for b in state.params.buckets])["w"]
            if float(_full_loss(wbar, xj, yj)) <= target:
                sim_time = (t + 1) + comm * COMM_COST
                return sim_time, t + 1, comm, True
    return steps + comm * COMM_COST, steps, comm, False


_FSTAR_CACHE = {}


def _fstar(x, y):
    """f* by 600 full-batch GD steps (step 4.0) on x's device; cached per
    dataset and device."""
    key = (tuple(x.shape), float(x.sum()), x.device.type)
    if key not in _FSTAR_CACHE:
        w = torch.zeros(x.shape[1], device=x.device)
        loss_grad = grad(lambda w: _full_loss(w, x, y))
        for _ in range(600):  # full-batch GD to near-optimum
            w = w - 4.0 * loss_grad(w)
        _FSTAR_CACHE[key] = float(_full_loss(w, x, y))
    return _FSTAR_CACHE[key]


def _best_over_lrs(K, H, B_loc, device=None):
    """Paper protocol: best step size by grid search per (K, H, B)."""
    best = None
    for lr in (2.0, 4.0, 8.0, 16.0):
        out = run_config(K=K, H=H, B_loc=B_loc, lr=lr, steps=800, device=device)
        if best is None or (out[3], -out[0]) > (best[3], -best[0]):
            best = out
    return best


def fig6_convex(device=None):
    base = None
    for H in (1, 2, 4, 8, 16):
        sim, steps, comm, hit = _best_over_lrs(K=8, H=H, B_loc=16, device=device)
        if H == 1:
            base = sim
        emit(f"fig6/K8_H{H}", sim,
             f"rel_time={sim/base:.3f};steps={steps};comm={comm};reached={hit}")


def fig6b_speedup_over_K(device=None):
    ref = None
    for K in (1, 2, 4, 8, 16):
        sim, steps, comm, hit = _best_over_lrs(K=K, H=8, B_loc=16, device=device)
        if K == 1:
            ref = sim
        emit(f"fig6b/H8_K{K}", sim, f"speedup={ref/sim:.2f};reached={hit}")
