"""Time variants of the flash kernel's design on the card: a tuning aid,
on no path of the port.

    PYTHONPATH=src python -m repro_torch.kernels.flash_sweep

Each variant is ``csrc/flash_attention.cu`` with one text substitution,
built by ``nvcc`` into ``build/sweep/<variant>/`` and loaded in place of
the library; at paper-lm's attention and gemma3-1b's local layer it is
held against the plain version (error over the flash tolerance) and
timed: device ms per call over back-to-back calls, median of five runs.
Prints the card's ``nvidia-smi`` line, then one JSON object per (variant,
shape).  :func:`build_variants` and :func:`device_ms` serve the other
sweeps too (``sq_sum_sweep.py``).
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa

# (label, B, S, H, KH, D, window, dtype), causal: chip_smoke.py's full rows
SHAPES = (("paper-lm", 32, 512, 12, 12, 64, 0, "float32"),
          ("gemma3-1b local", 1, 4096, 4, 1, 256, 512, "float32"),
          ("gemma3-1b local", 1, 4096, 4, 1, 256, 512, "bfloat16"))
# variant -> (text in the source, its replacement); "chosen" is the source
VARIANTS = {
    "chosen": None,
    "cvt.rna split": (
        "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
        'uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n  return r;'),
    "f32 64-key tiles at D <= 64": (
        "struct Tile<float, D> {\n  static constexpr int BK = 32;",
        "struct Tile<float, D> {\n  static constexpr int BK = D <= 64 ? 64 : 32;"),
    "bf16 64-key tiles at D = 256": (
        "struct Tile<bf16, D> {\n  static constexpr int BK = D <= 128 ? 64 : 32;",
        "struct Tile<bf16, D> {\n  static constexpr int BK = 64;"),
}


def device_ms(fn, calls: int = 20) -> float:
    """Device ms per call over ``calls`` back-to-back calls, median of 5."""
    fn()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def build_variants(source: str, variants: dict) -> dict:
    """Build each variant of ``build.SOURCES[source]`` (None, or one
    (text, replacement) substitution) into ``build/sweep/<source>/``, one
    nvcc per variant, all at once; {variant: library path}."""
    src = build.SOURCES[source].read_text()
    procs = {}
    for name, sub in variants.items():
        text = src
        if sub is not None:
            if sub[0] not in text:
                raise ValueError(f"variant {name!r}: its text is not in the source")
            text = text.replace(sub[0], sub[1])
        d = build.build_dir().parent / "sweep" / source / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{source}.cu").write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / f"{source}.cu")]
        procs[name] = (d / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        libs[name] = so
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants("flash_attention", VARIANTS)
    for label, B, S, H, KH, D, window, dtype in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(S + D)
        mk = lambda h: torch.randn((B, S, h, D), generator=gen,
                                   device="cuda").to(getattr(torch, dtype))
        q, k, v = mk(H), mk(KH), mk(KH)
        want = fa.flash_attention_plain(q, k, v, causal=True, window=window).float()
        rtol = 2 ** -7 if dtype == "bfloat16" else 0.0
        bound = 2e-5 * want.abs().max() + rtol * want.abs()
        run = lambda: fa.flash_attention(q, k, v, causal=True, window=window)
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            lib.fa_forward.argtypes = fa._LIB.signatures["fa_forward"]
            lib.fa_forward.restype = ctypes.c_int
            fa._LIB._lib = lib
            err = float(((run().float() - want).abs() / bound).max())
            print(json.dumps({"variant": name, "shape": label, "dtype": dtype,
                              "device_ms": device_ms(run),
                              "max_err_over_tol": err}), flush=True)
        del q, k, v, want, bound
        torch.cuda.empty_cache()
    fa._LIB._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
