"""Time variants of the bucket ``sq_sum`` kernel's design on the card,
against ``torch.linalg.vector_norm``: a tuning aid, on no path of the port.

    PYTHONPATH=src python -m repro_torch.kernels.sq_sum_sweep [--reps 3]

Each variant is ``csrc/fused_bucket.cu`` with one text substitution, built
by ``nvcc`` into ``build/sweep/fused_bucket/<variant>/`` and loaded in
place of the library.  At the main path's shape (W=4 x 934,040 rows x 128
f32) each variant is checked against the plain version (relative error,
the same bits twice, also at 3,101 rows) and timed: device ms per call
over back-to-back calls, median of five runs, in ``--reps`` rounds that
take ``vector_norm(x, 2, dim=(-2, -1)).square()`` first and last.  Prints
the card's ``nvidia-smi`` line, one JSON object per (round, variant), and
a last object with each one's median over the rounds and its share of
the byte bound.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import fused_bucket as fb
from repro_torch.kernels.flash_sweep import build_variants, device_ms

W, ROWS, RAGGED_ROWS = 4, 934_040, 3_101
_LOOP4 = """  for (; i + 3 * stride < n4; i += 4 * stride) {
    const uint4 a = ld_stream(xv + i);
    const uint4 b = ld_stream(xv + i + stride);
    const uint4 c = ld_stream(xv + i + 2 * stride);
    const uint4 d = ld_stream(xv + i + 3 * stride);
    s0 += sq_sum16(a);
    s1 += sq_sum16(b);
    s2 += sq_sum16(c);
    s3 += sq_sum16(d);
  }"""
_LOOP8 = """  for (; i + 7 * stride < n4; i += 8 * stride) {
    uint4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = ld_stream(xv + i + k * stride);
    s0 += sq_sum16(v[0]) + sq_sum16(v[4]);
    s1 += sq_sum16(v[1]) + sq_sum16(v[5]);
    s2 += sq_sum16(v[2]) + sq_sum16(v[6]);
    s3 += sq_sum16(v[3]) + sq_sum16(v[7]);
  }"""
_GRID_STRIDE = """  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;"""
_CHUNKED = """  const int64_t chunk = (n4 + gridDim.x - 1) / gridDim.x;
  const int64_t lo = blockIdx.x * chunk < n4 ? blockIdx.x * chunk : n4;
  xv += lo;
  n4 = (n4 - lo < chunk) ? n4 - lo : chunk;
  const int64_t stride = blockDim.x;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int64_t i = threadIdx.x;"""
_BLOCKS = "constexpr int kSqSumThreads = 512;\nconstexpr int kSqSumBlocksPerSM = 4;"
_LOAD = '"ld.global.nc.L1::no_allocate.L2::256B.v4.u32'
# variant -> (text in the source, its replacement); "chosen" is the source
VARIANTS = {
    "chosen": None,
    "L2::128B fetches": (_LOAD, '"ld.global.nc.L1::no_allocate.L2::128B.v4.u32'),
    "no cache hints": (_LOAD, '"ld.global.nc.v4.u32'),
    "evict-first loads (ld.global.cs)": (_LOAD, '"ld.global.cs.v4.u32'),
    "8 x 256 threads per SM": (_BLOCKS, _BLOCKS.replace("512", "256")
                               .replace("= 4;", "= 8;")),
    "2 x 512 threads per SM": (_BLOCKS, _BLOCKS.replace("= 4;", "= 2;")),
    "8 x 512 threads per SM (two waves)": (_BLOCKS, _BLOCKS.replace("= 4;", "= 8;")),
    "8 loads in flight": (_LOOP4, _LOOP8),
    "a contiguous chunk per block": (_GRID_STRIDE, _CHUNKED),
}


def _use(so) -> None:
    """Load ``so`` in place of the fused_bucket library."""
    lib = ctypes.CDLL(str(so))
    for f, argtypes in fb._LIB.signatures.items():
        getattr(lib, f).argtypes = argtypes
        getattr(lib, f).restype = ctypes.c_int
    fb._LIB._lib = lib
    fb._SQ_SUM_SCRATCH.clear()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sq_sum_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants("fused_bucket", VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(ROWS)
    x = torch.randn((W, ROWS, 128), generator=gen, device="cuda")
    small = torch.randn((W, RAGGED_ROWS, 128), generator=gen, device="cuda")
    bound_ms = 1e3 * 4 * x.numel() / 3.35e12      # H100 SXM data sheet
    checks = {}
    for name, so in libs.items():
        _use(so)
        errs, same = [], True
        for t in (x, small):
            got, want = fb.sq_sum(t), fb.sq_sum_plain(t)
            errs.append(float(((got.double() - want.double()).abs()
                               / want.double().abs()).max()))
            same = same and bool(torch.equal(got, fb.sq_sum(t)))
        checks[name] = {"max_rel_err": max(errs), "same_bits_twice": same}
    library = lambda: torch.linalg.vector_norm(x, 2, dim=(-2, -1)).square()
    times: dict = {"vector_norm (library)": []}
    for rep in range(args.reps):
        order = [None, *libs, None]
        for name in order:
            if name is None:
                t = device_ms(library)
                times["vector_norm (library)"].append(t)
                label = "vector_norm (library)"
            else:
                _use(libs[name])
                t = device_ms(lambda: fb.sq_sum(x))
                times.setdefault(name, []).append(t)
                label = name
            print(json.dumps({"round": rep, "variant": label, "device_ms": t,
                              **checks.get(label, {})}), flush=True)
    fb._LIB._lib = None
    fb._SQ_SUM_SCRATCH.clear()
    print(json.dumps({"bound_ms": bound_ms, "median_device_ms": {
        k: statistics.median(v) for k, v in times.items()},
        "share_of_bound": {k: bound_ms / statistics.median(v)
                           for k, v in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
