"""Synthetic data (numpy only): the port's copy of ``repro.data.synthetic``,
draw for draw.

* ``markov_lm`` / ``lm_examples`` — token sequences for the LM trainer.
* ``cluster_classification`` — Gaussian-mixture classification with label
  noise; stands in for CIFAR in the paper-table benchmarks.
* ``logreg_data`` — binary data for the convex experiments (App. B.2).
"""
from __future__ import annotations

import numpy as np


def markov_lm(*, vocab: int, num_seqs: int, seq_len: int, seed: int = 0,
              sample_seed: int | None = None, branching: int = 4,
              noise: float = 0.1):
    """Returns int32 tokens (num_seqs, seq_len+1); next-token targets.

    ``seed`` fixes the chain structure; ``sample_seed`` draws other
    sequences from the same chain (held-out splits).
    """
    srng = np.random.default_rng(seed)
    succ = srng.integers(0, vocab, size=(vocab, branching))
    probs = srng.dirichlet(np.ones(branching) * 2.0, size=vocab)
    rng = np.random.default_rng(seed if sample_seed is None else sample_seed)
    toks = np.empty((num_seqs, seq_len + 1), np.int32)
    state = rng.integers(0, vocab, size=num_seqs)
    toks[:, 0] = state
    for t in range(1, seq_len + 1):
        u = rng.random(num_seqs)
        noisy = u < noise
        choice = np.array([np.searchsorted(np.cumsum(probs[s]), v)
                           for s, v in zip(state, rng.random(num_seqs))])
        choice = np.clip(choice, 0, branching - 1)
        nxt = succ[state, choice]
        nxt = np.where(noisy, rng.integers(0, vocab, size=num_seqs), nxt)
        toks[:, t] = nxt
        state = nxt
    return toks


def lm_examples(tokens):
    """tokens (N, S+1) -> dict(tokens (N,S), labels (N,S))."""
    return {"tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32)}


def cluster_classification(*, num_classes: int, dim: int, n_train: int,
                           n_test: int, seed: int = 0, margin: float = 2.0,
                           label_noise: float = 0.05):
    """((x_train f32, y_train int32), (x_test, y_test)) drawn around
    ``num_classes`` Gaussian centres; a ``label_noise`` share of labels
    redrawn uniformly."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(num_classes, dim)) * margin

    def sample(n):
        y = rng.integers(0, num_classes, size=n)
        x = centers[y] + rng.normal(size=(n, dim))
        flip = rng.random(n) < label_noise
        y = np.where(flip, rng.integers(0, num_classes, size=n), y)
        return x.astype(np.float32), y.astype(np.int32)
    xtr, ytr = sample(n_train)
    xte, yte = sample(n_test)
    return (xtr, ytr), (xte, yte)


def logreg_data(*, n: int, d: int, seed: int = 0, flip: float = 0.05):
    """Separable-ish binary classification (w8a stand-in, App. B.2):
    sparse binary float32 features and float32 +-1 labels."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=d) / np.sqrt(d)
    x = (rng.random((n, d)) < 0.1).astype(np.float32)
    logits = x @ w_true
    y = np.sign(logits + 0.1 * rng.normal(size=n))
    y = np.where(rng.random(n) < flip, -y, y)
    return x, y.astype(np.float32)
