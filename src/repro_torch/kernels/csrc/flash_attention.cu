// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_bhsd (the
// Pallas TPU kernel _kernel): softmax(q k^T * scale) v over (batch, head)
// pairs with a causal mask (k_pos <= q_pos), a sliding-window mask
// (q_pos - k_pos < window, applied with or without causal) and query
// positions aligned to the START of the keys (q_pos is the query's row).
// Numerics are the reference's: online softmax in f32 with masked scores
// set to NEG_INF = -1e30 (not -inf), q scaled in f32 before the product,
// output acc / max(l, 1e-30) in q's dtype.  GQA: query head h reads kv head
// h / (H / KH), so the caller never copies repeated kv heads; every tensor
// comes with its own (batch, head, sequence) strides, the head dim
// contiguous, so (B, S, H, D) and (BH, S, D) layouts both go in unchanged.
//
// What bounds it on an H100 SXM: operations.  Each unmasked (q, k) pair of a
// head costs 2 D multiply-adds (D for q.k, D for p.v), 4 D flops, against
// 67 TFLOP/s f32 on the CUDA cores (NVIDIA data sheet); q, k, v and o are
// read and written once, far less time at 3.35 TB/s.  For paper-lm's
// attention (B 32, S 512, H 12, D 64, causal) that is 12.9 GFLOP -> 0.19 ms
// against 0.06 ms of bytes.
//
// Design, a simple first kernel (f32 FMAs on the CUDA cores, no tensor
// cores, so float32 inputs keep float32 semantics):
//   - one block of 256 threads (16 x 16) per (batch x head, 64 query rows),
//     grid (B H, Sq / 64);
//   - the query tile, and one K and one V tile of BK keys at a time, staged
//     in shared memory as f32 (Q and K rows padded by one float, so the 16
//     rows a half-warp reads sit in distinct banks);
//   - each thread owns 4 query rows (ty + 16 i) and, of the score tile, the
//     columns tx + 16 j, and of the output the columns tx + 16 j; the
//     running max m, sum l and the output accumulator stay in f32
//     registers; a row's max and sum reduce over its 16 threads by shuffles;
//   - only KV tiles inside the causal / window band are visited; keys past
//     Sk take no part.  A visited tile that is fully masked for a row adds
//     exp(0) = 1 terms while the row's max is still NEG_INF, as in the
//     reference, and the first unmasked key wipes them (exp(-1e30 - m) = 0);
//   - tiles: BK = 64 keys for D <= 128, 32 for D = 256, where the f32 tiles
//     take 140 KB of the 227 KB of dynamic shared memory (above the 48 KB
//     default, so the launcher raises the kernel's limit first).
// wgmma, TMA and mma.sync are left for a later kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                // query rows per block
constexpr int kRows = kBQ / 16;        // query rows per thread
constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

struct Strides {
  int64_t b, h, s;                     // in elements; the head dim is contiguous
};

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides qs, ks, vs, os;
  int64_t B, H, KH, Sq, Sk, window;
  float scale;
  int causal;
};

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// R rows of D from row r0 of a (seq, D) slice with row stride rs into
// shared memory at pitch P, times mul; rows at or past n are zero.
template <typename T, int D, int R, int P>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int64_t rs,
                                          int64_t r0, int64_t n, float* dst,
                                          float mul) {
  constexpr int kVecPerRow = D / 4;
  for (int idx = threadIdx.x; idx < R * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow;
    const int c = (idx % kVecPerRow) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n) load4(src + (r0 + r) * rs + c, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r * P + c + e] = x[e] * mul;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D, int BK>
struct Smem {
  static constexpr int kQP = D + 1;    // Q and K row pitch (bank spread)
  static constexpr int kPP = BK + 1;   // P row pitch
  static constexpr int kFloats = kBQ * kQP + BK * kQP + BK * D + kBQ * kPP;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(FlashArgs a) {
  using S = Smem<D, BK>;
  constexpr int kCols = BK / 16;       // score columns per thread
  constexpr int kDCols = D / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * S::kQP;
  float* Vs = Ks + BK * S::kQP;
  float* Ps = Vs + BK * D;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t b = blockIdx.x / a.H;
  const int64_t h = blockIdx.x % a.H;
  const int64_t kh = h / (a.H / a.KH);
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kBQ;
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + kh * a.vs.h;
  T* o = static_cast<T*>(a.o) + b * a.os.b + h * a.os.h;

  // the reference scales q in f32 before the product
  load_tile<T, D, kBQ, S::kQP>(q, a.qs.s, q0, a.Sq, Qs, a.scale);

  // the band of keys any row of this tile may see
  int64_t k_lo = 0, k_hi = a.Sk;
  if (a.causal) {
    k_hi = q0 + kBQ < a.Sk ? q0 + kBQ : a.Sk;
    if (a.window && q0 - a.window + 1 > 0) k_lo = q0 - a.window + 1;
  }

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[i][j] = 0.f;
  }

  for (int64_t k0 = k_lo / BK * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();                   // the last tile's readers are done
    load_tile<T, D, BK, S::kQP>(k, a.ks.s, k0, a.Sk, Ks, 1.f);
    load_tile<T, D, BK, D>(v, a.vs.s, k0, a.Sk, Vs, 1.f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + 16 * i) * S::kQP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * S::kQP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int64_t kp = k0 + tx + 16 * j;
        bool keep = true;
        if (a.causal) keep = keep && kp <= qp;
        if (a.window) keep = keep && qp - kp < a.window;
        s[i][j] = keep && kp < a.Sk ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        // keys past Sk take no part; a masked key gives exp(NEG_INF - m_new)
        const float p = k0 + tx + 16 * j < a.Sk ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * S::kPP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[kDCols];
#pragma unroll
      for (int j = 0; j < kDCols; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = Ps[(ty + 16 * i) * S::kPP + c];
#pragma unroll
        for (int j = 0; j < kDCols; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t qp = q0 + ty + 16 * i;
    if (qp >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDCols; ++j)
      store1(o + qp * a.os.s + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const FlashArgs& a, cudaStream_t st) {
  constexpr int BK = D >= 256 ? 32 : 64;
  constexpr size_t bytes = Smem<D, BK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.B * a.H),
                  static_cast<unsigned>((a.Sq + kBQ - 1) / kBQ));
  flash_kernel<T, D, BK><<<grid, kThreads, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const FlashArgs& a, int64_t D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(a, st);
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 128: return launch<T, 128>(a, st);
    case 256: return launch<T, 256>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q: B x H heads of (Sq, D); k, v: B x KH heads of (Sk, D); o like q, all of
// one dtype (is_bf16 ? bfloat16 : float32).  strides: 12 int64 in elements,
// (batch, head, seq) for q, k, v and o in turn; the head dim is contiguous,
// every pointer and stride 16-byte aligned (f32) / 8-byte aligned (bf16).
// D in {16, 32, 64, 128, 256}; H % KH == 0; window 0 means none.
int fa_forward(const void* q, const void* k, const void* v, void* o,
               const int64_t* strides, int64_t B, int64_t H, int64_t KH,
               int64_t Sq, int64_t Sk, int64_t D, float scale, int causal,
               int64_t window, int is_bf16, void* stream) {
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.qs = Strides{strides[0], strides[1], strides[2]};
  a.ks = Strides{strides[3], strides[4], strides[5]};
  a.vs = Strides{strides[6], strides[7], strides[8]};
  a.os = Strides{strides[9], strides[10], strides[11]};
  a.B = B;
  a.H = H;
  a.KH = KH;
  a.Sq = Sq;
  a.Sk = Sk;
  a.window = window;
  a.scale = scale;
  a.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<bf16>(a, D, st) : launch_d<float>(a, D, st);
}

}  // extern "C"
