"""Gradient-noise analysis for the paper's Section 5: the port of
``repro.core.noise.noise_decomposition``, which the telemetry round summary
reports.  Gradient-noise injection (``noise_eta > 0``) is not ported yet.
"""
from __future__ import annotations


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
    ``signal_sq = update_sq - noise_sq``.
    """
    w = max(int(num_workers), 1)
    noise_sq = float(dispersion) * (w / (w - 1) if w > 1 else 0.0)
    noise_sq = min(max(noise_sq, 0.0), float(update_sq))
    signal_sq = max(float(update_sq) - noise_sq, 0.0)
    return {"signal_sq": signal_sq, "noise_sq": noise_sq,
            "noise_ratio": noise_sq / (signal_sq + eps)}
