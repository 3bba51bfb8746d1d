"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100 (sm_90a).

The JAX package ``repro`` is the reference; this package mirrors its
module names so each module's counterpart is easy to find.  It imports
torch and numpy only — never jax, and nothing of ``repro``.

The port covers the main training path: paper-lm, W workers stacked on
one card, post-local SGD (Alg. 2) with mean / sign / EF-sign sync
(Alg. 1/3/4) on the resident flat bus, with SGD or LARS (the paper's
Table 5) as the local optimizer and optional on-device round statistics
(``telemetry.stats``); and the six bucket kernels of that path (fused
SGD, sum of squares, per-row |x| sums, per-row scaled sign, LARS row
norms, fused LARS) as hand-written CUDA (``kernels/csrc/fused_bucket.cu``).
The paper's own experiments (Fig. 1, Tables 1/2/4/8/14/16/17, Figs.
2b/4/6/10, Section 5) run on the same resident path through
``benchmarks`` (``python -m repro_torch.benchmarks.run``).  Around the
trainer: the trace spine (``telemetry.trace`` / ``export``: spans,
Perfetto / Prometheus / run manifest, the ledger's sync seconds), the
reference's checkpoint files (``checkpoint``) and serving (``serving``:
a paged KV cache, a continuous-batching engine, live weight hot-swap
from the trainer's published versions; ``launch.steps.build_engine``).

Entry points (``launch.steps.build_train`` / ``build_serve`` /
``build_engine``, ``launch.train.fit``, the ``benchmarks`` harness and
its CLI) run on the card unless the caller passes ``device="cpu"``; with
no card and no device given they raise.
"""
