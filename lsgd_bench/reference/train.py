"""W workers of post-local SGD, followed step by step: each worker's loss
and gradient, its gradient clipped to a global norm, SGD with Nesterov
momentum and weight decay, and a global sync where the schedule puts
one: the mean of the workers' models, or sign / EF-sign compression of
each worker's change since the last sync, optionally through the 1-bit
wire format.  Returns the readings the comparison needs."""
from __future__ import annotations

import torch

from . import lm


def lr_at(traffic, step: int) -> float:
    """Linear-scaled LR (base_lr x global batch / base_batch) reached by a
    linear warm-up from base_lr over ``lr_warmup_steps``."""
    base = traffic["base_lr"]
    peak = base * traffic["workers"] * traffic["local_batch"] / traffic["base_batch"]
    warm = traffic["lr_warmup_steps"]
    return base + (peak - base) * step / warm if step < warm else peak


def decays(shape) -> bool:
    """Weight decay applies to weights stored with two or more dims (so to
    the stacked per-layer norms, not to the final norm)."""
    return len(shape) >= 2


def norms(t) -> torch.Tensor:
    """(W,) f32 L2 norm of each worker's row of a (W, ...) tensor."""
    return t.detach().float().reshape(t.shape[0], -1).norm(dim=1)


def _compress(traffic, a, p, e):
    """One leaf's sync payload of every worker (W, ...): the compressed
    change since the anchor, and the new EF memory."""
    mode = traffic["sync_compression"]
    inp = (a[None] - p) + (e if mode == "ef_sign" else 0.0)
    scale = inp.abs().sum() / inp.numel()       # one scale, every worker's |x|
    x = torch.sign(inp) * scale
    return x, (inp - x if mode == "ef_sign" else e)


def _sync(traffic, params, anchor, memory):
    W = traffic["workers"]
    for n, p in params.items():
        if traffic["sync_compression"] == "none":
            p.copy_(p.mean(dim=0, keepdim=True).expand_as(p))
            continue
        e = None if memory is None else memory[n]
        x, e = _compress(traffic, anchor[n], p, e)
        if memory is not None:
            memory[n] = e
        if traffic["wire_pack"]:
            # each worker sends sign bits (0 as +1) and its own mean |x|
            s = x.abs().reshape(W, -1).mean(dim=1)
            sent = torch.where(x >= 0, 1.0, -1.0) * s.view((W,) + (1,) * (x.dim() - 1))
        else:
            sent = x
        anchor[n] -= sent.mean(dim=0)
        p.copy_(anchor[n][None].expand_as(p))


def follow(cfg, traffic, weights, batches, sync_after, *,
           tf32: bool = False) -> dict:
    """Train ``traffic["workers"]`` copies of ``weights`` (name -> tensor)
    on ``batches`` (dicts of (W, B, S) ``tokens`` / ``labels``), one step
    a batch, a global sync after step t where ``sync_after[t]``.

    Returns ``loss``: each step's mean over the workers; ``grad``: name
    -> (W,) norms of the first step's gradient after the clip (before
    decay); ``change``: name -> (W,) norms of each worker's model minus
    ``weights`` after the last step and its sync.

    Every matmul in float32 with TF32 off, as the configurations state,
    or in TF32 with ``tf32`` (the control); the flags are put back as
    they were afterwards."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    was = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = tf32
    try:
        return _follow(cfg, traffic, weights, batches, sync_after)
    finally:
        for f, w in zip(flags, was):
            f.allow_tf32 = w


def _follow(cfg, traffic, weights, batches, sync_after) -> dict:
    W = traffic["workers"]
    mu, wd = traffic["momentum"], traffic["weight_decay"]
    names = list(weights)
    params = {n: weights[n][None].repeat((W,) + (1,) * weights[n].dim())
              for n in names}
    mom = {n: torch.zeros_like(params[n]) for n in names}
    anchor = {n: weights[n].clone() for n in names} \
        if traffic["sync_compression"] != "none" else None
    memory = {n: torch.zeros_like(params[n]) for n in names} \
        if traffic["sync_compression"] == "ef_sign" else None
    out = {"loss": [], "grad": {}}
    for t, batch in enumerate(batches):
        lr = lr_at(traffic, t)
        losses, first = [], {n: [] for n in names}
        for w in range(W):          # the workers are apart until a sync
            leaves = [params[n][w].detach().requires_grad_(True) for n in names]
            total, _ = lm.loss(cfg, dict(zip(names, leaves)),
                               batch["tokens"][w], batch["labels"][w])
            gs = torch.autograd.grad(total, leaves)
            del leaves
            losses.append(total.detach())
            with torch.no_grad():
                gn = torch.sqrt(sum((g.float() ** 2).sum() for g in gs))
                clip = torch.clamp(traffic["grad_clip"] / torch.clamp(gn, min=1e-12),
                                   max=1.0)
                for n, g in zip(names, gs):
                    g = g * clip
                    if t == 0:
                        first[n].append(g.float().norm())
                    p, u = params[n][w], mom[n][w]
                    if decays(weights[n].shape):
                        g = g + wd * p
                    u.mul_(mu).add_(g)
                    p.sub_(lr * (mu * u + g if traffic["nesterov"] else u))
            del gs
        if t == 0:
            out["grad"] = {n: torch.stack(v) for n, v in first.items()}
        out["loss"].append(torch.stack(losses).mean())
        if sync_after[t]:
            with torch.no_grad():
                _sync(traffic, params, anchor, memory)
    with torch.no_grad():
        out["change"] = {n: norms(params[n] - weights[n][None]) for n in names}
    return out
