"""Serve a small model with batched requests: prefill + stepwise greedy
decode (the twin of the reference's ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch gemma3-1b --batch 4
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

The contiguous-cache serving path (``launch.steps.build_serve``:
``lm.prefill`` into a ``max_len`` cache, then ``lm.decode_step`` a token
at a time) on the arch's smoke config.  Runs on the card unless
``--device`` says otherwise; the weights come from the specs through a
``torch.Generator`` seeded with 0 on that device (``params0``, a numpy
tree such as the reference's, replaces them).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.convert import params_from_reference
from repro_torch.launch.steps import build_serve
from repro_torch.models import base as mbase
from repro_torch.models import lm


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, *, params0=None, log=print) -> dict:
    """Prefill and decode one batch; returns the generated ``tokens``
    (batch, gen), the prefill and decode seconds and the device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="the card by default (raises without one)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch)
    max_len = args.prompt_len + args.gen
    bundle = build_serve(cfg, device=args.device)
    dev = bundle.device
    if params0 is None:
        log(f"weights: {cfg.name}'s specs drawn from torch.Generator(seed 0) "
            f"on {dev}")
        params = mbase.materialize(
            bundle.specs, torch.Generator(device=dev).manual_seed(0), dev)
    else:
        params = params_from_reference(params0, dev)

    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (args.batch, args.prompt_len)),
                              dtype=torch.int64, device=dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = lm.prefill(cfg, params, prompts, max_len=max_len)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        tok = logits.argmax(-1)
        out = [tok]
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            logits, cache = lm.decode_step(cfg, params, tok, cache,
                                           args.prompt_len + i + 1)
            tok = logits.argmax(-1)
            out.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0

    gen = torch.cat(out, dim=1).cpu().numpy()
    log(f"arch={cfg.name} batch={args.batch}")
    log(f"prefill {args.prompt_len} toks: {t_prefill*1e3:.1f} ms")
    log(f"decode {args.gen-1} steps: {t_decode*1e3:.1f} ms "
        f"({t_decode/max(args.gen-1, 1)*1e3:.1f} ms/tok, batched "
        f"x{args.batch})")
    log("generated token ids (first request):", gen[0].tolist())
    return {"tokens": gen, "prompts": prompts.cpu().numpy(),
            "prefill_s": t_prefill, "decode_s": t_decode, "arch": cfg.name,
            "device": str(dev)}


if __name__ == "__main__":
    main()
