"""Plain-torch oracles for the per-tensor kernel API (the port of
``repro.kernels.ref``)."""
from __future__ import annotations

import torch


def fused_sgd_ref(p, g, u, lr, *, momentum: float, weight_decay: float,
                  nesterov: bool):
    pf, gf, uf = (a.float() for a in (p, g, u))
    if weight_decay:
        gf = gf + weight_decay * pf
    u_new = momentum * uf + gf
    step = momentum * u_new + gf if nesterov else u_new
    return (pf - lr * step).to(p.dtype), u_new.to(u.dtype)


def sign_compress_ref(x):
    xf = x.float()
    return torch.sign(xf) * torch.mean(torch.abs(xf))


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=0.0):
    """``reference_attention``: queries aligned to the END of the keys, so
    an oracle of the flash kernel only where Sq == Sk."""
    from repro_torch.models.layers import reference_attention
    return reference_attention(q, k, v, causal=causal, window=window, scale=scale)
