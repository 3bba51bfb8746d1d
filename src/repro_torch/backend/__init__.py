"""Execution backends: who the workers are, behind one seam (the port of
``repro.backend``).

Only :mod:`repro_torch.backend.base` (``WorkerSet`` / ``Backend``, pure
bookkeeping) is imported eagerly; the concrete backends resolve lazily
through the module ``__getattr__``, because ``backend.local`` imports
``launch.steps`` and ``launch.steps`` imports ``backend.base``.
"""
from __future__ import annotations

from repro_torch.backend.base import Backend, WorkerSet

_LAZY = {
    "LocalBackend": ("repro_torch.backend.local", "LocalBackend"),
    "SimulatedBackend": ("repro_torch.backend.simulated", "SimulatedBackend"),
    "DistributedBackend": ("repro_torch.backend.distributed",
                           "DistributedBackend"),
}

__all__ = ["Backend", "WorkerSet", *_LAZY, "make_backend"]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make_backend(kind: str, num_workers: int | None = None, **kw) -> Backend:
    """CLI/config entry point: ``local`` / ``simulated`` / ``distributed``."""
    kinds = {"local": "LocalBackend", "simulated": "SimulatedBackend",
             "distributed": "DistributedBackend"}
    if kind not in kinds:
        raise ValueError(f"unknown backend {kind!r} (want one of {sorted(kinds)})")
    return __getattr__(kinds[kind])(num_workers, **kw)
