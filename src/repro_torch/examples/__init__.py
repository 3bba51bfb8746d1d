"""Twins of the reference's training examples (``examples/*.py``) on the
port: ``quickstart``, ``train_lm``, ``hierarchical_local_sgd`` and
``adaptive_local_sgd``, each run as ``python -m
repro_torch.examples.<name>`` on the card (``--device cpu`` for the plain
PyTorch path) and callable as ``main(argv) -> summary``.

The reference's scripts run its default, the per-leaf tree path
(``use_kernel=False``); the twins run the port's default, the resident
kernel path (``launch.steps.build_train`` / ``core.local_sgd.
make_local_sgd`` with ``use_kernel=True``): the same trajectory within
float32 rounding, on the kernels.
"""
