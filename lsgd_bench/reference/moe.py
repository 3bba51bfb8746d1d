"""Top-k routed SwiGLU experts with a capacity per expert.

The router's softmax over X experts, the k best (ties to the lower
index), their weights renormalised to sum 1 when ``norm_topk_prob``.
Choices claim an expert's C slots in order: the first choice of every
token in token order, then the second, and so on; a choice past C is
dropped.  Each expert runs on the tokens it kept; their outputs are
added back weighted.  The load-balance term is X * sum(mean prob *
share of choices) * coef, over every choice, kept or dropped.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def shapes(cfg) -> dict:
    E, X, Fe = cfg["hidden_size"], cfg["num_experts"], cfg["intermediate_size"]
    return {"router": (E, X), "wg": (X, E, Fe), "wu": (X, E, Fe),
            "wd": (X, Fe, E)}


def capacity(cfg, tokens: int) -> int:
    """Slots an expert: capacity_factor * k * tokens / X, rounded up to a
    multiple of 4, at least 4."""
    c = math.ceil(cfg["capacity_factor"] * cfg["num_experts_per_tok"] * tokens
                  / cfg["num_experts"])
    return max(4, -(-c // 4) * 4)


def apply(cfg, p, x, positions):
    B, S, E = x.shape
    T, X, K = B * S, cfg["num_experts"], cfg["num_experts_per_tok"]
    xf = x.reshape(T, E)
    probs = torch.softmax(xf @ p["router"], dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :K], top_i[:, :K]
    if cfg["norm_topk_prob"]:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # claim order: choice slot major, token minor
    claims = top_i.t().reshape(-1)
    onehot = F.one_hot(claims, X)
    rank = (torch.cumsum(onehot, dim=0) - onehot).gather(1, claims[:, None])[:, 0]
    kept = (rank < capacity(cfg, T)).view(K, T).t()
    out = torch.zeros_like(xf)
    for e in range(X):
        t_idx, k_idx = torch.nonzero((top_i == e) & kept, as_tuple=True)
        if t_idx.numel() == 0:
            continue
        xe = xf[t_idx]
        ye = (F.silu(xe @ p["wg"][e]) * (xe @ p["wu"][e])) @ p["wd"][e]
        out = out.index_add(0, t_idx, ye * top_p[t_idx, k_idx][:, None])
    share = torch.bincount(top_i.reshape(-1), minlength=X).float() / (T * K)
    aux = X * torch.sum(probs.mean(dim=0) * share) * cfg["router_aux_loss_coef"]
    return out.view(B, S, E), aux
