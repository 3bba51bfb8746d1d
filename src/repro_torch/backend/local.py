"""Local backend: the W workers stacked on one device (the default).

``LocalBackend.build`` calls :func:`repro_torch.launch.steps.build_train`
on the backend's device, so a static-W run through the backend seam is
bit for bit the bundle path (``tests/test_torch_backend.py``).  The
backend's value is the census: it owns the
:class:`~repro_torch.backend.base.WorkerSet`, and ``resize`` rebuilds
local_step / sync / SyncPlan for a new W while ``fit`` carries the
resident state across with :func:`repro_torch.core.elastic.resize_state`.

The reference's ``mesh`` / ``jit`` arguments have no counterpart: the
port has one device and nothing to compile.  ``use_kernel`` goes to
``build_train``: True (the port's default; the reference's is False)
builds the resident kernel path, False the per-leaf tree path.
``layout`` (a ``sharding.layout.MeshLayout`` with its sizes) buckets the
leaves by sharding class, whole on the device, as the reference's
meshless resident path does.

Workers on this backend run one after another on one clock, so their
step times cannot be told apart: ``worker_step_times`` returns ``None``
(the simulated backend is the one that makes the skew gauge move).
"""
from __future__ import annotations

import warnings

from repro_torch.backend.base import Backend, WorkerSet
from repro_torch.utils import resolve_device


class LocalBackend(Backend):
    kind = "local"

    def __init__(self, num_workers: int | None = None, *, device=None,
                 build_fn=None, layout=None, use_kernel: bool = True):
        """``device=None`` means the card and raises when CUDA is absent.
        ``build_fn(run, worker_set) -> TrainBundle`` is the seam for models
        outside the launch zoo (tests, benches): a resize calls it back
        with the NEW worker set, so an elastic run rebuilds the same model
        at another W."""
        super().__init__(num_workers)
        self.device = resolve_device(device)
        self.build_fn = build_fn
        self.layout = layout
        self.use_kernel = use_kernel

    def build(self, run, **kw):
        if self.build_fn is not None:
            bundle = self.build_fn(run, self._worker_set)
            if getattr(bundle, "worker_set", None) is None:
                bundle.worker_set = (self._worker_set
                                     or WorkerSet.of(bundle.num_workers))
            self._worker_set = bundle.worker_set
            return bundle
        from repro_torch.launch import steps as steps_mod
        kw.setdefault("device", self.device)
        kw.setdefault("layout", self.layout)
        kw.setdefault("use_kernel", self.use_kernel)
        bundle = steps_mod.build_train(run, worker_set=self._worker_set, **kw)
        # build_train defaults the census when the backend had none yet
        self._worker_set = bundle.worker_set
        return bundle

    def adopt(self, bundle) -> WorkerSet:
        """Take ownership of a hand-made bundle's worker set (the shim for
        callers that construct a TrainBundle themselves); stamps
        ``bundle.worker_set`` when it is missing, with a warning."""
        if bundle.worker_set is None:
            warnings.warn(
                "TrainBundle without a worker_set is deprecated; build it "
                "through a Backend (repro_torch.backend.LocalBackend) or "
                "launch.steps.build_train so the worker census is owned by "
                "the backend seam",
                DeprecationWarning, stacklevel=3)
            bundle.worker_set = WorkerSet.of(bundle.num_workers)
        self._worker_set = bundle.worker_set
        return self._worker_set
