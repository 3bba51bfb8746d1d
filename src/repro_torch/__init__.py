"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100 (sm_90a).

The JAX package ``repro`` is the reference; this package mirrors its
module names so each module's counterpart is easy to find.  It imports
torch and numpy only — never jax, and nothing of ``repro``.

This slice covers the main training path: paper-lm, W workers stacked on
one card, post-local SGD (Alg. 2) with mean / sign / EF-sign sync
(Alg. 1/3/4) on the resident flat bus, and the four bucket kernels
(fused SGD, sum of squares, per-row |x| sums, per-row scaled sign) as
hand-written CUDA (``kernels/csrc/fused_bucket.cu``).

Entry points (``launch.steps.build_train``, ``launch.train.fit``) run on
the card unless the caller passes ``device="cpu"``; with no card and no
device given they raise.
"""
