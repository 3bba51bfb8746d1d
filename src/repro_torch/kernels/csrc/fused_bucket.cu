// Flat-bus bucket kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// A bucket is a contiguous (rows, 128) float32 buffer holding many
// parameter leaves back to back (repro_torch/core/flatbuf.py); the
// trainer keeps W worker copies stacked as (W, rows, 128).  Each kernel
// below replaces one Pallas TPU kernel of the JAX package and computes
// what that kernel computes, not how its TPU grid did it: the 256-row
// grid blocks and the partial-block row mask of the TPU versions are
// gone, every block here covers whole float4 groups of real rows.
//
// Bounds, for the main path's shape W = 4, rows = 934,040 (paper-lm, one
// f32 bucket of 478.2 MB per worker copy) on an H100 SXM (3.35 TB/s HBM3,
// NVIDIA data sheet).  All four are memory-bound: at most a few flops per
// byte, against the ~20 flops/byte f32 CUDA cores need to be the limit.
//
//   fb_fused_sgd       replaces repro/kernels/fused_bucket.py::fused_sgd_bucket_2d
//                      (_sgd_kernel).  Reads p, g, u, writes p, u:
//                      5 x 1.913 GB = 9.57 GB -> 2.86 ms.  Design: one launch
//                      over the whole stacked buffer, float4 loads and
//                      stores, p and u updated IN PLACE (no second copy of
//                      2 x W x 478 MB), the per-row decay mask read as
//                      wd_row[row] (3.7 MB, L2 resident), the per-worker
//                      grad-clip scale folded in so the clip costs no extra
//                      pass.  Optional stats write per-(worker, block)
//                      partial sums that reduce_rows_kernel folds in a second,
//                      deterministic pass (no atomics).
//   fb_sq_sum          replaces fused_bucket.py::sq_sum_2d.  Reads x once:
//                      1.913 GB -> 0.571 ms.  Same partials + second pass.
//   fb_row_abs_sum     replaces fused_bucket.py::row_abs_sum_2d.  Reads x,
//                      writes one float per row: 1.928 GB -> 0.576 ms.
//                      One warp per 128-wide row (32 lanes x float4),
//                      shuffle reduction, no shared memory.
//   fb_scale_sign_rows replaces fused_bucket.py::scale_sign_rows_2d.  Reads
//                      x, writes y: 3.83 GB -> 1.14 ms.  Elementwise float4
//                      pass, sign(0) = 0, scale indexed by row % scale_rows
//                      so one (rows,) scale vector serves all W copies.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.  Accumulation is float32 throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kVecPerRow = kLane / 4;   // float4 groups per row
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of two values; the results are valid in thread 0.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads / 32];
  __shared__ float sb[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[wid] = a;
    sb[wid] = b;
  }
  __syncthreads();
  if (wid == 0) {
    const int nw = blockDim.x >> 5;
    a = lane < nw ? sa[lane] : 0.f;
    b = lane < nw ? sb[lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

struct SgdParams {
  float lr, momentum, weight_decay;
};

template <bool kNesterov, bool kStats>
__device__ __forceinline__ void sgd_one(float& p, float g, float& u,
                                        float dec, float gs,
                                        const SgdParams& hp, float& gsq,
                                        float& usq) {
  g = g * gs;                                   // grad-clip scale (1 if off)
  if (kStats) gsq += g * g;                     // raw grad, before decay
  if (hp.weight_decay != 0.f) g = g + dec * p;  // dec = wd * wd_row[row]
  const float un = hp.momentum * u + g;
  const float step = kNesterov ? hp.momentum * un + g : un;
  const float d = hp.lr * step;
  p = p - d;
  u = un;
  if (kStats) usq += d * d;
}

// grid = (grid_x, W); each block walks its worker's float4 groups with a
// grid stride.  partials: (W, 2, grid_x) = [sum g^2 | sum (lr*step)^2].
template <bool kNesterov, bool kStats>
__global__ void __launch_bounds__(kThreads)
sgd_kernel(float* __restrict__ p, const float* __restrict__ g,
           float* __restrict__ u, const float* __restrict__ wd_row,
           const float* __restrict__ gscale, SgdParams hp, int64_t n4,
           float* __restrict__ partials) {
  const int w = blockIdx.y;
  const int64_t base = static_cast<int64_t>(w) * n4;
  float4* p4 = reinterpret_cast<float4*>(p) + base;
  const float4* g4 = reinterpret_cast<const float4*>(g) + base;
  float4* u4 = reinterpret_cast<float4*>(u) + base;
  const float gs = gscale != nullptr ? gscale[w] : 1.f;
  float gsq = 0.f, usq = 0.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 pv = p4[i];
    const float4 gv = g4[i];
    float4 uv = u4[i];
    const float dec = hp.weight_decay * wd_row[i / kVecPerRow];
    sgd_one<kNesterov, kStats>(pv.x, gv.x, uv.x, dec, gs, hp, gsq, usq);
    sgd_one<kNesterov, kStats>(pv.y, gv.y, uv.y, dec, gs, hp, gsq, usq);
    sgd_one<kNesterov, kStats>(pv.z, gv.z, uv.z, dec, gs, hp, gsq, usq);
    sgd_one<kNesterov, kStats>(pv.w, gv.w, uv.w, dec, gs, hp, gsq, usq);
    p4[i] = pv;
    u4[i] = uv;
  }
  if (kStats) {
    block_sum2(gsq, usq);
    if (threadIdx.x == 0) {
      partials[(static_cast<int64_t>(w) * 2 + 0) * gridDim.x + blockIdx.x] = gsq;
      partials[(static_cast<int64_t>(w) * 2 + 1) * gridDim.x + blockIdx.x] = usq;
    }
  }
}

// grid = (grid_x, W); partials: (W, grid_x) per-block sums of x^2.
__global__ void __launch_bounds__(kThreads)
sq_sum_kernel(const float* __restrict__ x, int64_t n4,
              float* __restrict__ partials) {
  const int w = blockIdx.y;
  const float4* x4 = reinterpret_cast<const float4*>(x) + static_cast<int64_t>(w) * n4;
  float s = 0.f, unused = 0.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 v = x4[i];
    s += v.x * v.x;
    s += v.y * v.y;
    s += v.z * v.z;
    s += v.w * v.w;
  }
  block_sum2(s, unused);
  if (threadIdx.x == 0)
    partials[static_cast<int64_t>(w) * gridDim.x + blockIdx.x] = s;
}

// Second pass: out[r] = sum(in[r, 0:n]), one block per row, fixed order.
__global__ void __launch_bounds__(kThreads)
reduce_rows_kernel(const float* __restrict__ in, int64_t n,
                   float* __restrict__ out) {
  const float* row = in + static_cast<int64_t>(blockIdx.x) * n;
  float s = 0.f, unused = 0.f;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) s += row[i];
  block_sum2(s, unused);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// One warp per 128-wide row: out[r] = sum |x[r, :]|.
__global__ void __launch_bounds__(kThreads)
row_abs_sum_kernel(const float* __restrict__ x, int64_t n_rows,
                   float* __restrict__ out) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;   // whole warps exit together
  const float4 v = reinterpret_cast<const float4*>(x)[row * kVecPerRow + lane];
  float s = (fabsf(v.x) + fabsf(v.y)) + (fabsf(v.z) + fabsf(v.w));
  s = warp_sum(s);
  if (lane == 0) out[row] = s;
}

__device__ __forceinline__ float sign_of(float v) {
  return static_cast<float>((v > 0.f) - (v < 0.f));
}

// y = sign(x) * scale[row % scale_rows], elementwise over float4 groups.
__global__ void __launch_bounds__(kThreads)
scale_sign_rows_kernel(const float* __restrict__ x,
                       const float* __restrict__ scale, int64_t n4,
                       int64_t scale_rows, float* __restrict__ y) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    const float s = scale[(i / kVecPerRow) % scale_rows];
    float4 o;
    o.x = sign_of(v.x) * s;
    o.y = sign_of(v.y) * s;
    o.z = sign_of(v.z) * s;
    o.w = sign_of(v.w) * s;
    reinterpret_cast<float4*>(y)[i] = o;
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// p, u updated in place; g read only.  All (W, rows, 128) f32 contiguous.
// wd_row: (rows,) f32; gscale: (W,) f32 or null.  With stats != 0,
// partials is (W, 2, grid_x) scratch and stats_out (W, 2) receives
// [sum g^2, sum (lr*step)^2] per worker.
int fb_fused_sgd(void* p, const void* g, void* u, const void* wd_row,
                 const void* gscale, float lr, float momentum,
                 float weight_decay, int nesterov, int64_t W, int64_t rows,
                 int stats, void* partials, int64_t grid_x, void* stats_out,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n4 = rows * kVecPerRow;
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(W));
  const SgdParams hp{lr, momentum, weight_decay};
  float* pp = static_cast<float*>(p);
  const float* gp = static_cast<const float*>(g);
  float* up = static_cast<float*>(u);
  const float* wp = static_cast<const float*>(wd_row);
  const float* sp = static_cast<const float*>(gscale);
  float* part = static_cast<float*>(partials);
  if (nesterov && stats)
    sgd_kernel<true, true><<<grid, kThreads, 0, st>>>(pp, gp, up, wp, sp, hp, n4, part);
  else if (nesterov)
    sgd_kernel<true, false><<<grid, kThreads, 0, st>>>(pp, gp, up, wp, sp, hp, n4, part);
  else if (stats)
    sgd_kernel<false, true><<<grid, kThreads, 0, st>>>(pp, gp, up, wp, sp, hp, n4, part);
  else
    sgd_kernel<false, false><<<grid, kThreads, 0, st>>>(pp, gp, up, wp, sp, hp, n4, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !stats) return static_cast<int>(err);
  reduce_rows_kernel<<<static_cast<unsigned>(2 * W), kThreads, 0, st>>>(
      part, grid_x, static_cast<float*>(stats_out));
  return static_cast<int>(cudaGetLastError());
}

// x: (W, rows, 128) f32; partials: (W, grid_x) scratch; out: (W,).
int fb_sq_sum(const void* x, int64_t W, int64_t rows, void* partials,
              int64_t grid_x, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(W));
  sq_sum_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(x),
                                            rows * kVecPerRow,
                                            static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_rows_kernel<<<static_cast<unsigned>(W), kThreads, 0, st>>>(
      static_cast<const float*>(partials), grid_x, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x: (n_rows, 128) f32; out: (n_rows,) f32.
int fb_row_abs_sum(const void* x, int64_t n_rows, void* out, void* stream) {
  const int64_t blocks = cdiv(n_rows * 32, kThreads);
  row_abs_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n_rows, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x, y: (n_rows, 128) f32; scale: (scale_rows,) f32, n_rows % scale_rows == 0.
int fb_scale_sign_rows(const void* x, const void* scale, int64_t n_rows,
                       int64_t scale_rows, void* y, void* stream) {
  const int64_t n4 = n_rows * kVecPerRow;
  int64_t blocks = cdiv(n4, kThreads);
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
  scale_sign_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale), n4,
      scale_rows, static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
