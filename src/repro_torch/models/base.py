"""Parameter specs: a tree of :class:`ParamSpec` leaves describes a model's
parameters (the port of ``repro.models.base``).

``materialize`` follows the reference's init law (zeros / ones / fan-in
scaled normal / 0.02-std embedding) but draws from a ``torch.Generator``,
so its numbers differ from JAX's; parity tests carry JAX's weights over
through ``repro_torch.convert`` instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.utils import tree_flatten, tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]       # logical axis per dim
    init: str = "normal"               # normal | zeros | ones | embed
    scale: float = 1.0                 # stddev multiplier for normal init

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


@dataclass(frozen=True)
class ShapeDtype:
    """Abstract leaf (shape + dtype), the counterpart of a
    ``jax.ShapeDtypeStruct``: enough for ``flatbuf.build_layout``."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _init_leaf(spec: ParamSpec, generator: torch.Generator, device, dtype):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / math.sqrt(max(fan_in, 1))
    if spec.init == "embed":
        std = 0.02 * spec.scale
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * std).to(device=device, dtype=dtype)


def materialize(specs, generator: torch.Generator, device, dtype=torch.float32):
    """Concrete tensors for a spec tree, on ``device``."""
    leaves, treedef = tree_flatten(specs, is_leaf=is_spec)
    return tree_unflatten(treedef, [_init_leaf(s, generator, device, dtype)
                                    for s in leaves])


def abstract(specs, dtype=torch.float32):
    return tree_map(lambda s: ShapeDtype(tuple(s.shape), dtype), specs,
                    is_leaf=is_spec)


def stack(params, num_workers: int):
    """Replicate a single param tree into a stacked (W, ...) tree of COPIES
    (``repeat``, never ``expand``: the workers' rows must not share storage,
    or an in-place update of one would write them all)."""
    return tree_map(lambda p: p[None].repeat((num_workers,) + (1,) * p.dim()),
                    params)


def unstack_mean(params):
    """The worker mean of a stacked (W, ...) tree."""
    return tree_map(lambda p: p.mean(dim=0), params)


def count_params(specs) -> int:
    return int(sum(np.prod(s.shape) for s in tree_leaves(specs, is_leaf=is_spec)))


def norm_param_mask(specs):
    """True for params of rank <= 1 — excluded from weight decay.

    As in the reference, the test is on the rank of the STORED shape, so
    the stacked per-layer norms ``layers[0].ln1``/``ln2`` (rank 2) do take
    weight decay and only ``final_norm`` skips it.
    """
    return tree_map(lambda s: len(s.shape) <= 1, specs, is_leaf=is_spec)
