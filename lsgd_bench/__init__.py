"""The port's benchmark: post-local SGD training cells run on one H100.

``run.py`` runs one cell (``BENCHMARK.json``'s ``workloads``); the data
it needs is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<cell>.json`` and one reader a
per-layer metric in ``metrics/<name>.py``.  ``reference/`` is the plain
PyTorch model, optimizer and sync that decide ``correct``.
"""
