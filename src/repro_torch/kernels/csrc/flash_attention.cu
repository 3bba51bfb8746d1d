// Flash attention forward for Hopper (sm_90a) on the tensor cores, plain C
// interface for ctypes.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_bhsd (the
// Pallas TPU kernel _kernel): softmax(q k^T * scale) v over (batch, head)
// pairs with a causal mask (k_pos <= q_pos), a sliding-window mask
// (q_pos - k_pos < window, applied with or without causal) and query
// positions aligned to the START of the keys (q_pos is the query's row).
// The reference's softmax: online in f32, masked scores at NEG_INF = -1e30
// (finite, so a visited tile masked for a row adds exp(0) = 1 terms until
// the row's first unmasked key wipes them), keys past Sk give p = 0, output
// acc / max(l, 1e-30) in q's dtype.  GQA: query head h reads kv head
// h / (H / KH).  Every tensor comes with its own (batch, head, seq) strides,
// the head dim contiguous, so (B, S, H, D) and (BH, S, D) both go in as
// they are.  D in {16, 32, 64, 128, 256}, each its own instantiation of the
// one kernel below (no other variant).
//
// What bounds it on an H100 SXM: operations.  Each unmasked (q, k) pair of
// a head costs 2 D flops for q.k and 2 D for p.v (paper-lm's attention, B 32,
// S 512, H 12, D 64, causal: 12.91 GFLOP; gemma3-1b's local layer, S 4096,
// H 4, D 256, window 512: 8.05 GFLOP).  The bound is the least time for a
// result of f32 accuracy on the tensor cores (NVIDIA data sheet, dense):
//   f32 inputs   3xTF32 for both products: 495 / 3 = 165 TFLOP/s effective
//                -> 0.078 ms (paper-lm), 0.049 ms (gemma3-1b local);
//   bf16 inputs  q.k on bf16 MMAs at 989 TFLOP/s, p.v at 989 / 2 (split p)
//                -> 0.0122 ms at gemma3-1b's local layer (bytes 0.0063).
//
// Numerics.
//   f32:  both products in 3xTF32: x = big + small, each rounded to TF32
//         with cvt.rna.tf32.f32's rounding (to nearest, ties away; done in
//         two integer ops, see tf32() below); a.b ~ big.small + small.big +
//         big.big (the small terms first), accumulated in f32.  That is the
//         arithmetic of SDPA's f32 path (CUTLASS OpMultiplyAddFastF32); one
//         TF32 rounding misses the f32 tolerance (2e-5 of the max) 13-20x.
//   bf16: q.k on bf16 MMAs with f32 accumulators (a product of two bf16
//         values is exact in f32); scale applied to the f32 scores after
//         the product (1/sqrt(D) is not a power of two at D = 32, 128).
//         p.v takes p = p_hi + p_lo, p_hi = bf16(p), p_lo = bf16(p - p_hi),
//         in two MMAs into one accumulator (v is exact in bf16); one bf16
//         rounding of p misses the bf16 tolerance 12-19x.
//   The scale folds in log2(e), and p = ex2.approx(s - m) (MUFU.EX2).
//
// Design.
//   - Route: mma.sync (m16n8k8 TF32, m16n8k16 bf16) for both dtypes, not
//     wgmma.  A warp's score accumulators ARE its p.v A operand: in bf16
//     the C fragment of two 8-key subtiles is the m16n8k16 A fragment; in
//     TF32 the A fragment's column t <-> key 2t, t + 4 <-> key 2t + 1
//     (and V's rows read in that order), so P never leaves registers and
//     needs no shuffle.  The split operands (3 MMAs per TF32 product, 2 per
//     bf16 p.v) stay per warp; wgmma's TF32 form takes only K-major
//     operands from shared memory, so p.v would need a transposed, split V
//     tile, and its register-A form the fragment reshuffle.
//   - One block of 4 warps (128 threads) per (batch x head, 64 query rows),
//     16 rows per warp; the grid runs the query tiles last to first, so the
//     longest causal bands start first.  Tiles of BK keys: 32 in f32, 64 in
//     bf16 (32 at D = 256).
//   - K/V tiles arrive by cp.async (16 bytes, zero-filled past Sk) into a
//     ring of two stages, one barrier a tile: tile j + 1 loads while tile j
//     computes.  Tiles stay in the input dtype in shared memory (bf16
//     halves the f32 staging of the first kernel); the TF32 split happens
//     in registers.  Pitches: f32 Q/K rows D + 8 floats (64-bit fragment
//     loads without bank conflicts), V rows D + 4; bf16 rows D + 8
//     (ldmatrix rows 16 bytes apart mod 128).
//   - Softmax in registers: each thread holds 2 rows x BK/4 scores; the
//     row max reduces over the 4 lanes of a row by __shfl_xor_sync, the row
//     sum stays per lane until the end.
//   - Masks are computed only on tiles that cross the band's edge (causal
//     diagonal, window start, Sk).  The block visits the causal / window
//     band of its 64 rows; a warp skips tiles wholly outside its own 16
//     rows' band, which changes nothing for a row with an unmasked key.
//   - Dynamic shared memory above 48 KB is raised once per instantiation
//     and device.
//   Variants timed against this design by kernels/flash_sweep.py (PERF.md):
//   cvt.rna.tf32.f32 for the split, 64-key f32 tiles, 64-key bf16 tiles at
//   D = 256.
//
// Per instantiation (nvcc 12.9 -Xptxas -v, sm_90a; 0 bytes stack and 0
// spills in all ten; `chip_smoke.py` prints them), registers / dynamic
// shared memory / blocks per SM (the smaller of the register and the
// shared-memory limit):
//   f32   D16  66 / 17,408 B / 7     bf16  D16  70 / 15,360 B / 7
//         D32  75 / 29,696 B / 6           D32 109 / 25,600 B / 4
//         D64 127 / 54,272 B / 4           D64 128 / 46,080 B / 4
//         D128 165 / 103,424 B / 2         D128 181 / 87,040 B / 2
//         D256 247 / 201,728 B / 1         D256 254 / 101,376 B / 2
//   paper-lm (B 32, H 12, S 512, D 64 f32): 3,072 blocks at 4 an SM, 5.8
//   waves of 528; gemma3-1b local (H 4, S 4096, D 256): 256 blocks, f32 at
//   1 an SM (1.9 waves), bf16 at 2 an SM (one wave).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;       // query rows per block, 16 per warp
constexpr int kStages = 2;             // the K/V ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// Tile geometry per (dtype, D): keys per tile and row pitches (elements).
template <typename T, int D>
struct Tile;
template <int D>
struct Tile<float, D> {
  static constexpr int BK = 32;
  static constexpr int QP = D + 8;
  static constexpr int KP = D + 8;
  static constexpr int VP = D + 4;
};
template <int D>
struct Tile<bf16, D> {
  static constexpr int BK = D <= 128 ? 64 : 32;
  static constexpr int QP = D + 8;
  static constexpr int KP = D + 8;
  static constexpr int VP = D + 8;
};

// dynamic shared memory: the Q tile and kStages K and V tiles
template <typename T, int D>
struct Smem {
  using G = Tile<T, D>;
  static constexpr size_t kBytes =
      sizeof(T) * (kBQ * G::QP + kStages * G::BK * (G::KP + G::VP));
  static_assert(kBytes <= 232448, "a block takes at most 227 KB of shared memory");
};

// ---- PTX helpers ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; bytes < 16 zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero) in two
// integer ops: add half of the 13 dropped bits' range to the magnitude,
// clear them.  The same bits for finite x; sm_90a's cvt.rna.tf32.f32 is a
// longer emulated sequence.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}
// bf16x2 of (x, y), x in the low half, and the bf16x2 of what it left out
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// R rows of D from row r0 of a (seq, D) slice with row stride rs into
// shared memory at pitch P, by cp.async; rows at or past n are zero.
template <typename T, int D, int R, int P>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          int64_t rs, int64_t r0, int64_t n) {
  constexpr int kE = 16 / sizeof(T);   // elements per 16-byte chunk
  constexpr int kChunks = D / kE;
  for (int idx = threadIdx.x; idx < R * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * kE;
    const bool in = r0 + r < n;
    cp_async16(dst + r * P + c, in ? src + (r0 + r) * rs + c : src, in ? 16 : 0);
  }
}

// ---- s = q k^T (unscaled) for a warp's 16 rows against BK keys ----
// f32, 3xTF32 on m16n8k8.  The k index t <-> d 2t, t + 4 <-> d 2t + 1, so a
// thread's two A values of a row and two B values are one 64-bit load each.
template <int D, int BK, int QP, int KP>
__device__ __forceinline__ void qk(const float* Qw, const float* Kt,
                                   float (&s)[BK / 8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll(D <= 64 ? D / 8 : 4)
  for (int kk = 0; kk < D / 8; ++kk) {
    const float* qr = Qw + g * QP + kk * 8 + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(qr);
    const float2 x1 = *reinterpret_cast<const float2*>(qr + 8 * QP);
    uint32_t ab[4], as[4];
    split_tf32(x0.x, ab[0], as[0]);
    split_tf32(x1.x, ab[1], as[1]);
    split_tf32(x0.y, ab[2], as[2]);
    split_tf32(x1.y, ab[3], as[3]);
#pragma unroll
    for (int ni = 0; ni < BK / 8; ++ni) {
      const float2 y = *reinterpret_cast<const float2*>(Kt + (ni * 8 + g) * KP + kk * 8 + 2 * t);
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(y.x, bb0, bs0);
      split_tf32(y.y, bb1, bs1);
      mma_tf32(s[ni], ab, bs0, bs1);
      mma_tf32(s[ni], as, bb0, bb1);
      mma_tf32(s[ni], ab, bb0, bb1);
    }
  }
}
// bf16 on m16n8k16, fragments by ldmatrix.
template <int D, int BK, int QP, int KP>
__device__ __forceinline__ void qk(const bf16* Qw, const bf16* Kt,
                                   float (&s)[BK / 8][4], int lane) {
#pragma unroll(D <= 128 ? D / 16 : 4)
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, Qw + (lane & 15) * QP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * KP + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// ---- o += p v for a warp's 16 rows; p in the score registers ----
// f32, 3xTF32: the A column t <-> key 2t, t + 4 <-> key 2t + 1 of each
// 8-key subtile, so A is the C fragment reordered in registers.
template <int D, int BK, int VP>
__device__ __forceinline__ void pv(const float (&p)[BK / 8][4], const float* Vt,
                                   float (&o)[D / 8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(p[kk][0], ab[0], as[0]);
    split_tf32(p[kk][2], ab[1], as[1]);
    split_tf32(p[kk][1], ab[2], as[2]);
    split_tf32(p[kk][3], ab[3], as[3]);
    const float* v0 = Vt + (kk * 8 + 2 * t) * VP + g;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(v0[dn * 8], bb0, bs0);
      split_tf32(v0[VP + dn * 8], bb1, bs1);
      mma_tf32(o[dn], ab, bs0, bs1);
      mma_tf32(o[dn], as, bb0, bb1);
      mma_tf32(o[dn], ab, bb0, bb1);
    }
  }
}
// bf16: p = p_hi + p_lo, two MMAs per product; v by ldmatrix.trans.
template <int D, int BK, int VP>
__device__ __forceinline__ void pv(const float (&p)[BK / 8][4], const bf16* Vt,
                                   float (&o)[D / 8][4], int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16x2(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
    split_bf16x2(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
    split_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, Vt + (kk * 16 + (lane & 15)) * VP + dp * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], lo, b[0], b[1]);
      mma_bf16(o[2 * dp], hi, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], lo, b[2], b[3]);
      mma_bf16(o[2 * dp + 1], hi, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(FlashArgs a) {
  using G = Tile<T, D>;
  constexpr int BK = G::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBQ * G::QP;            // kStages tiles
  T* Vs = Ks + kStages * BK * G::KP;   // kStages tiles

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t b = blockIdx.x / a.H;
  const int64_t h = blockIdx.x % a.H;
  const int64_t kh = h / (a.H / a.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // longest bands first
  const int Sq = static_cast<int>(a.Sq), Sk = static_cast<int>(a.Sk);
  const int window = static_cast<int>(a.window);
  const T* q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* k = static_cast<const T*>(a.k) + b * a.ks.b + kh * a.ks.h;
  const T* v = static_cast<const T*>(a.v) + b * a.vs.b + kh * a.vs.h;
  T* o = static_cast<T*>(a.o) + b * a.os.b + h * a.os.h;

  // the band of keys any row of this block may see
  int k_lo = 0, k_hi = Sk;
  if (a.causal) {
    k_hi = q0 + kBQ < Sk ? q0 + kBQ : Sk;
    if (window && q0 - window + 1 > 0) k_lo = q0 - window + 1;
  }
  const int first = k_lo / BK * BK;
  const int n_tiles = k_hi > first ? (k_hi - first + BK - 1) / BK : 0;
  auto load_tile = [&](int j) {        // tile j into stage j % kStages
    const int st = j % kStages;
    load_rows<T, D, BK, G::KP>(Ks + st * BK * G::KP, k, a.ks.s, first + j * BK, Sk);
    load_rows<T, D, BK, G::VP>(Vs + st * BK * G::VP, v, a.vs.s, first + j * BK, Sk);
  };

  // prologue: Q and the first kStages - 1 tiles, one commit group each
  load_rows<T, D, kBQ, G::QP>(Qs, q, a.qs.s, q0, Sq);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_tile(j);
    cp_async_commit();
  }

  const int qw = q0 + 16 * warp;       // this warp's first row
  const float sl2 = a.scale * kLog2e;
  float o_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = first + j * BK;
    cp_async_wait<kStages - 2>();      // tile j (and Q) have landed ...
    __syncthreads();                   // ... for every thread; tile j - 1 is done
    if (j + kStages - 1 < n_tiles) load_tile(j + kStages - 1);   // into j - 1's stage
    cp_async_commit();

    // tiles wholly outside this warp's rows' band change none of its rows
    const bool skip = qw >= Sq || (a.causal && k0 > qw + 15) ||
                      (window && qw - (k0 + BK - 1) >= window);
    if (skip) continue;
    const T* Kt = Ks + (j % kStages) * BK * G::KP;
    const T* Vt = Vs + (j % kStages) * BK * G::VP;
    float s[BK / 8][4];
#pragma unroll
    for (int ni = 0; ni < BK / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
    qk<D, BK, G::QP, G::KP>(Qs + 16 * warp * G::QP, Kt, s, lane);

    // a tile that crosses the band's edge (or Sk) takes the masks
    const bool edge = k0 + BK > Sk || (a.causal && k0 + BK - 1 > qw) ||
                      (window && qw + 15 - k0 >= window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int ni = 0; ni < BK / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[ni][e] * sl2;
        if (edge) {
          const int r = qw + g + 8 * (e >> 1);
          const int kp = k0 + ni * 8 + 2 * t + (e & 1);
          bool keep = kp < Sk;
          if (a.causal) keep = keep && kp <= r;
          if (window) keep = keep && r - kp < window;
          x = keep ? x : kNegInf;
        }
        s[ni][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = ex2(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int ni = 0; ni < BK / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // keys past Sk take no part; a masked key gives ex2(NEG_INF - m)
        float p = ex2(s[ni][e] - m[e >> 1]);
        if (edge && k0 + ni * 8 + 2 * t + (e & 1) >= Sk) p = 0.f;
        s[ni][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o_acc[dn][e] *= corr[e >> 1];
    pv<D, BK, G::VP>(s, Vt, o_acc, lane);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = qw + g + 8 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + static_cast<int64_t>(r) * a.os.s + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      store2(orow + dn * 8, o_acc[dn][2 * i] / denom, o_acc[dn][2 * i + 1] / denom);
  }
}

template <typename T, int D>
int launch(const FlashArgs& a, cudaStream_t st) {
  constexpr size_t bytes = Smem<T, D>::kBytes;
  // raise the dynamic shared-memory limit once per device
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(flash_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>(a.B * a.H),
                  static_cast<unsigned>((a.Sq + kBQ - 1) / kBQ));
  flash_kernel<T, D><<<grid, kThreads, bytes, st>>>(a);
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
// every pointer and stride 16-byte aligned (cp.async copies 16 bytes).
// D in {16, 32, 64, 128, 256}; H % KH == 0; Sq, Sk < 2^31; window 0 means
// none.
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
