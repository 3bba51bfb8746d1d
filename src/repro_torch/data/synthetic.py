"""Synthetic LM data (numpy only): the port's copy of ``markov_lm`` and
``lm_examples`` from ``repro.data.synthetic``, draw for draw."""
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
