"""The token stream: sequences of a seeded Markov chain over the
vocabulary (each token has ``branching`` successors with random
weights; with probability ``noise`` a uniform token instead), made on
the device and held there, cut into the steps' (W, B, S) batches."""
from __future__ import annotations

import torch

# the data stream's seed, apart from the weights' (any odd constant)
DATA_SEED = 0x9E3779B97F4A7C15


def markov_tokens(vocab: int, num_seqs: int, seq_len: int, *, branching: int,
                  noise: float, seed: int, device) -> torch.Tensor:
    """(num_seqs, seq_len + 1) int64 tokens."""
    gen = torch.Generator(device=device).manual_seed(
        ((seed * 2 + 1) ^ DATA_SEED) % 2 ** 63)
    kw = dict(generator=gen, device=device)
    succ = torch.randint(vocab, (vocab, branching), **kw)
    w = torch.rand((vocab, branching), **kw) + 0.05
    cum = (w / w.sum(dim=1, keepdim=True)).cumsum(dim=1)
    u = torch.rand((seq_len, num_seqs), **kw)
    noisy = torch.rand((seq_len, num_seqs), **kw) < noise
    uniform = torch.randint(vocab, (seq_len, num_seqs), **kw)
    state = torch.randint(vocab, (num_seqs,), **kw)
    out = [state]
    for t in range(seq_len):
        choice = (u[t, :, None] > cum[state]).sum(dim=1).clamp_max(branching - 1)
        state = torch.where(noisy[t], uniform[t], succ[state, choice])
        out.append(state)
    return torch.stack(out, dim=1)


def batches(cfg, traffic, seed: int, device) -> list:
    """``pool_steps`` batches, each a dict of (W, B, S) ``tokens`` and
    ``labels``; every row of every batch is a sequence of its own."""
    W, B, S = traffic["workers"], traffic["local_batch"], traffic["seq_len"]
    d = traffic["data"]
    if d["kind"] != "markov":
        raise ValueError(f"unknown data kind {d['kind']!r}")
    n = d["pool_steps"]
    toks = markov_tokens(cfg["vocab_size"], n * W * B, S, branching=d["branching"],
                         noise=d["noise"], seed=seed, device=device)
    toks = toks.view(n, W, B, S + 1)
    return [{"tokens": toks[i, :, :, :-1].contiguous(),
             "labels": toks[i, :, :, 1:].contiguous()} for i in range(n)]
