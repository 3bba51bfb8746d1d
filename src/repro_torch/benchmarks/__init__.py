"""The paper's experiments on the port (the twin of the top-level
``benchmarks`` package's paper tables): ``common`` (the harness),
``paper_tables``, ``bench_convex`` and the ``run`` entry point."""
