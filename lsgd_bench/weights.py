"""A cell's starting weights, made on the device from the seed: one
normal draw for every weight at once, then each weight's view scaled by
its init law (fan-in scaled normal, the router at half scale, a 0.02-std
embedding, ones for the norms)."""
from __future__ import annotations

import math

import torch

NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")


def std(name: str, shape) -> float | None:
    """The normal draw's scale for weight ``name``; None for a norm."""
    last = name.rsplit(".", 1)[-1]
    if last in NORMS:
        return None
    if last == "embed":
        return 0.02
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return (0.5 if last == "router" else 1.0) / math.sqrt(fan_in)


def make(shapes: dict, seed: int, device) -> dict:
    """name -> weight of ``shapes`` (views into one buffer), the same for
    the same seed on the same device."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    sizes = {n: math.prod(s) for n, s in shapes.items()}
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device)
    out, off = {}, 0
    for n in sorted(shapes):
        v = flat[off:off + sizes[n]].view(shapes[n])
        off += sizes[n]
        s = std(n, shapes[n])
        if s is None:
            v.fill_(1.0)
        else:
            v.mul_(s)
        out[n] = v
    return out
