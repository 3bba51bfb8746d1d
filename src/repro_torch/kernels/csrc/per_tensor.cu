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
//                   Design: one launch.  Each thread keeps four independent
//                   16-byte loads in flight (4 f32 or 8 bf16 elements
//                   each) over a grid of 4 blocks of 512 threads per SM; a
//                   scalar head up to the first 16-byte boundary and a
//                   scalar tail, so any start takes the vector loop.  Each block writes its partial;
//                   the last block to finish (a ticket counter, the one
//                   atomic, which never touches a sum) folds the partials
//                   in block order and resets the counter.  The grid
//                   depends on n and the SM count only: two runs give the
//                   same bits.
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
// abs_sum: 4 blocks of 512 threads per SM, four 16-byte loads in flight each
constexpr int kAbsSumThreads = 512;
constexpr int kAbsSumBlocksPerSM = 4;

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

// Block-wide sum of an abs_sum block; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float a) {
  __shared__ float sa[kAbsSumThreads / 32];
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

// sum |x| over 16 bytes of f32 or bf16 (the sign bit cleared, bf16 widened
// by a shift)
__device__ __forceinline__ float abs_sum16(const uint4 w, float) {
  return (fabsf(__uint_as_float(w.x)) + fabsf(__uint_as_float(w.y))) +
         (fabsf(__uint_as_float(w.z)) + fabsf(__uint_as_float(w.w)));
}
__device__ __forceinline__ float abs_pair(uint32_t w) {
  return __uint_as_float((w & 0x7fffu) << 16) + __uint_as_float(w & 0x7fff0000u);
}
__device__ __forceinline__ float abs_sum16(const uint4 w, bf16) {
  return (abs_pair(w.x) + abs_pair(w.y)) + (abs_pair(w.z) + abs_pair(w.w));
}

// 16 bytes read once: no L1 allocation, 256-byte L2 fetches
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// out[0] = sum |x|: block partials, folded by the last block to finish.
// ticket: a zeroed counter, left zeroed.
template <typename T>
__global__ void __launch_bounds__(kAbsSumThreads)
abs_sum_kernel(const T* __restrict__ x, int64_t n, float* __restrict__ partials,
               unsigned int* __restrict__ ticket, float* __restrict__ out) {
  constexpr int kV = 16 / sizeof(T);   // elements per 16-byte load
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t mis = (reinterpret_cast<uintptr_t>(x) % 16) / sizeof(T);
  const int64_t head = mis ? (kV - mis < n ? kV - mis : n) : 0;
  const int64_t nv = (n - head) / kV;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int64_t i = tid;
  for (; i + 3 * stride < nv; i += 4 * stride) {
    const uint4 a = ld_stream(xv + i);
    const uint4 b = ld_stream(xv + i + stride);
    const uint4 c = ld_stream(xv + i + 2 * stride);
    const uint4 d = ld_stream(xv + i + 3 * stride);
    s0 += abs_sum16(a, T());
    s1 += abs_sum16(b, T());
    s2 += abs_sum16(c, T());
    s3 += abs_sum16(d, T());
  }
  for (; i < nv; i += stride) s0 += abs_sum16(ld_stream(xv + i), T());
  for (int64_t j = tid; j < head; j += stride) s1 += fabsf(to_f32(x[j]));
  for (int64_t j = head + nv * kV + tid; j < n; j += stride) s2 += fabsf(to_f32(x[j]));
  const float s = block_sum((s0 + s1) + (s2 + s3));

  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();                   // the partial is visible before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float f = 0.f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += blockDim.x)
    f += __ldcg(partials + b);
  f = block_sum(f);
  if (threadIdx.x == 0) {
    out[0] = f;
    *ticket = 0u;
  }
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

// *blocks = the most blocks ps_abs_sum launches on the current device (the
// partials it needs): 4 a streaming multiprocessor.
int ps_abs_sum_blocks(int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = kAbsSumBlocksPerSM * sms;
  return static_cast<int>(err);
}

// x: n elements (f32 or bf16), any 2-byte (bf16) / 4-byte (f32) aligned
// start; partials: max_blocks f32 scratch; ticket: one zeroed uint32, left
// zeroed, for this stream's calls only; out: one f32.
int ps_abs_sum(const void* x, int64_t n, int is_bf16, void* partials,
               int64_t max_blocks, void* ticket, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t per_block = kAbsSumThreads * 4 * (is_bf16 ? 8 : 4);
  int64_t blocks = (n + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : (blocks > max_blocks ? max_blocks : blocks);
  float* part = static_cast<float*>(partials);
  unsigned int* tk = static_cast<unsigned int*>(ticket);
  float* o = static_cast<float*>(out);
  if (is_bf16)
    abs_sum_kernel<bf16><<<static_cast<unsigned>(blocks), kAbsSumThreads, 0, st>>>(
        static_cast<const bf16*>(x), n, part, tk, o);
  else
    abs_sum_kernel<float><<<static_cast<unsigned>(blocks), kAbsSumThreads, 0, st>>>(
        static_cast<const float*>(x), n, part, tk, o);
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
