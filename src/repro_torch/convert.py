"""Carry weights and optimizer state over from the JAX package.

The reference's param pytree, converted to numpy arrays (for example
``jax.tree.map(np.asarray, params)``), becomes the port's param tree with
the same nesting; a resident ``LocalSGDState`` of the reference (its
sharded sub-buckets in their shard-major rows too) whose
bucket buffers (and telemetry stats, if any) are numpy arrays becomes the
port's resident state.  The
bucket layouts agree row for row (``core/flatbuf``), so buffers move
as they are.  Nothing here imports JAX: the inputs are numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import flatbuf
from repro_torch.core.local_sgd import LocalSGDState
from repro_torch.telemetry.stats import StatsAccumulator


def generator_from_key(key, device) -> torch.Generator:
    """A torch generator for a reference PRNG key (``uint32[2]``), seeded
    with the key's two words as one 64-bit seed: the inverse of
    :func:`key_from_generator`.  JAX's threefry stream has no torch
    counterpart, so its draws differ from the reference's (gradient noise
    compares across packages only statistically)."""
    hi, lo = (int(x) for x in np.asarray(key).astype(np.uint64).reshape(-1)[:2])
    return torch.Generator(device=device).manual_seed((hi << 32) | lo)


def key_from_generator(gen: torch.Generator) -> np.ndarray:
    """The reference's key for a generator: ``[seed >> 32, seed &
    0xffffffff]`` of its ``initial_seed()``, what ``jax.random.PRNGKey``
    gives for the same seed."""
    seed = int(gen.initial_seed())
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _tensor(x, device) -> torch.Tensor:
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":         # ml_dtypes' bfloat16: raw words
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_reference(np_tree, device):
    """Nested dict/tuple/list of numpy arrays -> the same nesting of
    tensors on ``device``."""
    if isinstance(np_tree, dict):
        return {k: params_from_reference(v, device) for k, v in np_tree.items()}
    if isinstance(np_tree, (tuple, list)):
        return type(np_tree)(params_from_reference(v, device) for v in np_tree)
    if np_tree is None:
        return None
    return _tensor(np_tree, device)


def state_from_reference(ref_state, *, layout: flatbuf.FlatLayout, device,
                         ) -> LocalSGDState:
    """A resident ``LocalSGDState`` of the reference (fields ``params``,
    ``momentum``, ``anchor``, ``global_u``, ``ef_memory`` with numpy
    ``.buckets``, ``step``, and ``stats``: None or a ``StatsAccumulator``
    of numpy arrays) -> the port's state on ``device``.

    ``layout`` is the port's layout for the same model (e.g.
    ``TrainBundle.layout``); every buffer must have its bucket rows.
    The state's generator (the gradient noise's stream) comes from the
    reference's key by :func:`generator_from_key`.  EF memory becomes
    float32 in every bucket, as the port keeps it: the reference holds a
    bf16 bucket's memory in bf16 until its first EF-sign sync writes the
    f32 residual there, so the cast is exact either way.
    """
    def conv(field, leading, dtype=None):
        if field is None:
            return None
        bufs = tuple(_tensor(b, device) for b in field.buckets)
        if dtype is not None:
            bufs = tuple(x.to(dtype) for x in bufs)
        for b, buf in enumerate(bufs):
            want = layout.bucket_rows[b]
            if buf.shape[leading:] != (want, flatbuf.LANE):
                raise ValueError(f"bucket {b}: shape {tuple(buf.shape)} does "
                                 f"not match the layout's ({want}, 128)")
        return flatbuf.BucketState(layout, bufs, leading=leading)

    ref_stats = getattr(ref_state, "stats", None)
    stats = None
    if ref_stats is not None:
        stats = StatsAccumulator(**{
            f.name: _tensor(np.asarray(getattr(ref_stats, f.name)), device)
            for f in dataclasses.fields(StatsAccumulator)})
    return LocalSGDState(params=conv(ref_state.params, 1),
                         momentum=conv(ref_state.momentum, 1),
                         anchor=conv(ref_state.anchor, 0),
                         global_u=conv(ref_state.global_u, 0),
                         ef_memory=conv(ref_state.ef_memory, 1, torch.float32),
                         step=int(np.asarray(ref_state.step)), stats=stats,
                         rng=generator_from_key(ref_state.rng, device))
