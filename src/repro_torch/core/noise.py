"""Stochastic-noise tooling for the paper's Section 5 analysis (the port
of ``repro.core.noise``).

* Isotropic gradient-noise injection (Neelakantan et al. 2015), the
  baseline the paper compares post-local SGD against (Table 14):
  g <- g + N(0, sigma_t^2), sigma_t^2 = eta / (1+t)^gamma.  The resident
  training path draws it per bucket (``core.local_sgd._bucket_noise``);
  :func:`isotropic_noise` is the per-leaf form.
* The signal/noise split of the per-round update energy and the critical
  batch it implies (the ``noise_adaptive`` controller's sensor).
* A gradient-noise-scale probe estimating tr(Sigma(w)) from per-worker
  gradients.

Random draws take an explicit ``torch.Generator``, never the global RNG.
"""
from __future__ import annotations

import math

import torch

from repro_torch.utils import tree_flatten, tree_leaves, tree_unflatten


def isotropic_noise(grads, gen: torch.Generator, *, step, eta: float,
                    gamma: float):
    """``grads`` (a tree of tensors) plus N(0, sigma_t^2) per element,
    drawn from ``gen`` leaf by leaf in tree order; ``eta <= 0`` returns
    ``grads`` itself.  Same schedule and moments as the reference, another
    stream: comparable statistically, not bitwise."""
    if eta <= 0:
        return grads
    sigma = math.sqrt(eta / (1.0 + float(step)) ** gamma)
    leaves, treedef = tree_flatten(grads)
    noisy = [g + (sigma * torch.randn(g.shape, generator=gen,
                                      dtype=torch.float32,
                                      device=g.device)).to(g.dtype)
             for g in leaves]
    return tree_unflatten(treedef, noisy)


def noise_decomposition(update_sq: float, dispersion: float,
                        num_workers: int, *, eps: float = 1e-12) -> dict:
    """Split the per-round update energy into signal and noise (host
    floats).

    With W workers on disjoint data accumulating x_k = sum_t eta_t
    (G + xi_{k,t}) over a round, the coherent drift G survives the
    between-worker difference while the noise does not:

        E update_sq  = S + N              S = sum_t eta_t^2 ||G_t||^2
        E dispersion = (1 - 1/W) N        N = sum_t eta_t^2 tr(Sigma)/B_loc

    so ``noise_sq = dispersion * W/(W-1)`` (clipped to [0, update_sq]) and
    ``signal_sq = update_sq - noise_sq``.  Both scale as 1/B_loc; their
    ratio times the measurement batch is the batch-invariant critical
    batch (:func:`critical_batch`).
    """
    w = max(int(num_workers), 1)
    noise_sq = float(dispersion) * (w / (w - 1) if w > 1 else 0.0)
    noise_sq = min(max(noise_sq, 0.0), float(update_sq))
    signal_sq = max(float(update_sq) - noise_sq, 0.0)
    return {"signal_sq": signal_sq, "noise_sq": noise_sq,
            "noise_ratio": noise_sq / (signal_sq + eps)}


def critical_batch(signal_sq: float, noise_sq: float,
                   batch_per_worker: float, *, eps: float = 1e-12) -> float:
    """McCandlish et al. (2018) simple noise scale B_noise ~=
    tr(Sigma)/||G||^2 from the :func:`noise_decomposition` split:
    ``noise_sq/signal_sq = tr(Sigma)/(B_loc ||G||^2)``, so the per-worker
    batch the round was measured at times that ratio is B_noise, the
    total batch below which gradient error is noise-dominated."""
    return float(batch_per_worker) * float(noise_sq) / (float(signal_sq) + eps)


def gradient_noise_trace(per_worker_grads):
    """Estimate tr(Sigma) from a tree of stacked per-worker grads (W, ...):
    the between-worker variance (unbiased, W - 1 in the denominator) and
    the squared norm of the worker mean, each summed over leaves, as
    float32 tensors (trace_estimate, mean_grad_norm2)."""
    tr = mn = 0.0
    for g in tree_leaves(per_worker_grads):
        gf = g.float()
        mean = gf.mean(dim=0, keepdim=True)
        tr = tr + torch.sum(torch.square(gf - mean)) / max(g.shape[0] - 1, 1)
        mn = mn + torch.sum(torch.square(mean))
    return tr, mn
