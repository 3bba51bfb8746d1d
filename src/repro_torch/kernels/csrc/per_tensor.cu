// Per-tensor optimizer and compressor kernels for Hopper (sm_90a), plain C
// interface for ctypes.
//
// These are the kernels behind the per-tensor half of the kernel API
// (repro_torch/kernels/ops.py: fused_sgd, sign_compress): one call per
// tensor of any shape, float32 or bfloat16, where the bucket kernels of
// fused_bucket.cu take a whole (rows, 128) f32 bucket.  The TPU versions
// pad each tensor to 128 lanes; here a tensor is a flat run of n elements,
// read as 4-element vectors where every pointer allows it, with a scalar
// loop for the tail (and for the whole run when a pointer is not aligned).
//
// Bounds, for paper-lm's parameter count in one tensor, n = 119,556,864,
// on an H100 SXM (3.35 TB/s HBM3, NVIDIA data sheet).  All three are
// memory-bound: a few flops per element against the ~20 flops per byte the
// f32 CUDA cores need to be the limit.
//
//   ps_fused_sgd    replaces repro/kernels/fused_sgd.py::fused_sgd_2d
//                   (_kernel).  Reads p, g, u and writes p', u': 20 bytes
//                   an element in f32, 2.391 GB -> 0.714 ms (10 bytes in
//                   bf16).  Design: one elementwise grid-stride pass,
//                   arithmetic in f32, results written in the tensors' own
//                   dtype into NEW tensors (the reference is functional).
//                   Every multiply and add is rounded on its own
//                   (__fmul_rn/__fadd_rn: no FMA contraction), in the plain
//                   version's order, so the kernel gives the plain version's
//                   bits.  lr is a host float or read from a device scalar
//                   (a learning-rate schedule on the device costs no host
//                   read-back).
//   ps_abs_sum      replaces repro/kernels/sign_compress.py::abs_sum_2d.
//                   Reads x once: 4 bytes an element, 0.478 GB -> 0.143 ms.
//                   Per-block partial sums, then one block folds them in a
//                   fixed order: no atomics, and the grid depends on n only,
//                   so two runs give the same bits.
//   ps_scale_sign   replaces repro/kernels/sign_compress.py::scale_sign_2d.
//                   Reads x, writes f32 y = sign(x) * s: 8 bytes an element
//                   in f32, 0.956 GB -> 0.285 ms.  sign(0) = 0; s is read
//                   from a device scalar (the abs_sum total over n comes
//                   straight from the previous launch, no host read-back).
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// grid-stride passes: at most about two waves of 256-thread blocks per SM
constexpr int64_t kMaxBlocks = 2 * 132 * 8;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four elements at vector index i (16 bytes of f32, 8 bytes of bf16).
__device__ __forceinline__ void load4(const float* p, int64_t i, float v[4]) {
  const float4 x = reinterpret_cast<const float4*>(p)[i];
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const bf16* p, int64_t i, float v[4]) {
  const uint2 raw = reinterpret_cast<const uint2*>(p)[i];
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, int64_t i, const float v[4]) {
  reinterpret_cast<float4*>(p)[i] = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, int64_t i, const float v[4]) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2], v[3]);
  reinterpret_cast<uint2*>(p)[i] = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float a) {
  __shared__ float sa[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  a = warp_sum(a);
  if (lane == 0) sa[wid] = a;
  __syncthreads();
  if (wid == 0) {
    a = lane < (blockDim.x >> 5) ? sa[lane] : 0.f;
    a = warp_sum(a);
  }
  return a;
}

__device__ __forceinline__ float sign_of(float v) {
  return static_cast<float>((v > 0.f) - (v < 0.f));
}

struct SgdParams {
  float lr, momentum, weight_decay;
  const float* lr_dev;   // device scalar, or null to use lr
};

// The reference's update, each operation rounded on its own:
//   g' = g + wd p;  u' = mu u + g';  p' = p - lr (mu u' + g')  (Nesterov)
//                                    p' = p - lr u'            (heavy ball)
template <bool kNesterov>
__device__ __forceinline__ void sgd_one(float& p, float g, float& u,
                                        const SgdParams& hp, float lr) {
  if (hp.weight_decay != 0.f) g = __fadd_rn(g, __fmul_rn(hp.weight_decay, p));
  const float un = __fadd_rn(__fmul_rn(hp.momentum, u), g);
  const float step = kNesterov ? __fadd_rn(__fmul_rn(hp.momentum, un), g) : un;
  p = __fsub_rn(p, __fmul_rn(lr, step));
  u = un;
}

// vec != 0: every pointer is aligned for 4-element vectors.
template <typename T, bool kNesterov>
__global__ void __launch_bounds__(kThreads)
sgd_kernel(const T* __restrict__ p, const T* __restrict__ g,
           const T* __restrict__ u, T* __restrict__ po, T* __restrict__ uo,
           SgdParams hp, int64_t n, int vec) {
  const float lr = hp.lr_dev != nullptr ? *hp.lr_dev : hp.lr;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      float pv[4], gv[4], uv[4];
      load4(p, i, pv);
      load4(g, i, gv);
      load4(u, i, uv);
#pragma unroll
      for (int e = 0; e < 4; ++e) sgd_one<kNesterov>(pv[e], gv[e], uv[e], hp, lr);
      store4(po, i, pv);
      store4(uo, i, uv);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float pv = to_f32(p[i]), uv = to_f32(u[i]);
    sgd_one<kNesterov>(pv, to_f32(g[i]), uv, hp, lr);
    po[i] = from_f32<T>(pv);
    uo[i] = from_f32<T>(uv);
  }
}

// partials[blockIdx.x] = sum |x| over the block's share of x.
template <typename T>
__global__ void __launch_bounds__(kThreads)
abs_sum_kernel(const T* __restrict__ x, int64_t n, int vec,
               float* __restrict__ partials) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  float s = 0.f;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      float v[4];
      load4(x, i, v);
      s += (fabsf(v[0]) + fabsf(v[1])) + (fabsf(v[2]) + fabsf(v[3]));
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) s += fabsf(to_f32(x[i]));
  s = block_sum(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// out[0] = sum(in[0:n]) in a fixed order (one block).
__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ in, int64_t n, float* __restrict__ out) {
  float s = 0.f;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) s += in[i];
  s = block_sum(s);
  if (threadIdx.x == 0) out[0] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scale_sign_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  int64_t n, int vec, float* __restrict__ y) {
  const float s = *scale;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      float v[4];
      load4(x, i, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = sign_of(v[e]) * s;
      store4(y, i, v);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) y[i] = sign_of(to_f32(x[i])) * s;
}

int64_t grid_for(int64_t n) {
  const int64_t blocks = (n / 4 + kThreads - 1) / kThreads;
  return blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <typename T>
int launch_sgd(const void* p, const void* g, const void* u, void* po, void* uo,
               SgdParams hp, int nesterov, int64_t n, int vec, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>(grid_for(n));
  const T* pp = static_cast<const T*>(p);
  const T* gp = static_cast<const T*>(g);
  const T* up = static_cast<const T*>(u);
  if (nesterov)
    sgd_kernel<T, true><<<blocks, kThreads, 0, st>>>(pp, gp, up, static_cast<T*>(po),
                                                     static_cast<T*>(uo), hp, n, vec);
  else
    sgd_kernel<T, false><<<blocks, kThreads, 0, st>>>(pp, gp, up, static_cast<T*>(po),
                                                      static_cast<T*>(uo), hp, n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// p, g, u: n elements each of one dtype (is_bf16 ? bfloat16 : float32);
// po, uo: new outputs of that dtype.  lr_dev: device f32 scalar or null.
int ps_fused_sgd(const void* p, const void* g, const void* u, void* po,
                 void* uo, float lr, const void* lr_dev, float momentum,
                 float weight_decay, int nesterov, int64_t n, int is_bf16,
                 int vec, void* stream) {
  const SgdParams hp{lr, momentum, weight_decay, static_cast<const float*>(lr_dev)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_sgd<bf16>(p, g, u, po, uo, hp, nesterov, n, vec, st)
                 : launch_sgd<float>(p, g, u, po, uo, hp, nesterov, n, vec, st);
}

// x: n elements (f32 or bf16); partials: (2 * 132 * 8,) f32 scratch, one
// slot per block; out: one f32.
int ps_abs_sum(const void* x, int64_t n, int is_bf16, int vec, void* partials,
               void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t blocks = grid_for(n);
  float* part = static_cast<float*>(partials);
  if (is_bf16)
    abs_sum_kernel<bf16><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const bf16*>(x), n, vec, part);
  else
    abs_sum_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const float*>(x), n, vec, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_kernel<<<1, kThreads, 0, st>>>(part, blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x: n elements (f32 or bf16); scale: one f32 on the device; y: n f32.
int ps_scale_sign(const void* x, const void* scale, int64_t n, int is_bf16,
                  int vec, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(grid_for(n));
  const float* s = static_cast<const float*>(scale);
  if (is_bf16)
    scale_sign_kernel<bf16><<<blocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), s, n, vec, static_cast<float*>(y));
  else
    scale_sign_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), s, n, vec, static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
