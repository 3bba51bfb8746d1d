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
// NVIDIA data sheet).  All six are memory-bound: at most a few flops per
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
//                      1.913 GB -> 0.571 ms.  Design: one launch over a
//                      (blocks per worker, W) grid of 512-thread blocks,
//                      about 4 blocks per SM at W = 4; each thread
//                      keeps four independent 16-byte streaming loads in
//                      flight.  Each block writes its partial and takes its
//                      worker's ticket (a counter, the one atomic, which
//                      never touches a sum); the worker's last block folds
//                      that worker's partials in block order, writes
//                      out[w] and resets the ticket.  A worker's blocks
//                      depend on its rows and the SM count only, never on
//                      W: two runs give the same bits, and so does a rank
//                      that holds fewer workers than one process.  The
//                      scratch (partials, W tickets) is the
//                      caller's, kept per stream.
//   fb_row_abs_sum     replaces fused_bucket.py::row_abs_sum_2d.  Reads x,
//                      writes one float per row: 1.928 GB -> 0.576 ms.
//                      One warp per 128-wide row (32 lanes x float4),
//                      shuffle reduction, no shared memory.
//   fb_scale_sign_rows replaces fused_bucket.py::scale_sign_rows_2d.  Reads
//                      x, writes y: 3.83 GB -> 1.14 ms.  Elementwise float4
//                      pass, sign(0) = 0, scale indexed by row % scale_rows
//                      so one (rows,) scale vector serves all W copies.
//   fb_lars_row_norms  replaces fused_bucket.py::lars_row_norms_2d.  Reads p,
//                      g (and the 3.7 MB decay mask), writes two floats per
//                      row: 3.86 GB -> 1.15 ms.  One warp per row as in
//                      fb_row_abs_sum; the decayed gradient g + wd*mask*p
//                      lives in registers only, both sums in one pass.
//   fb_fused_lars      replaces fused_bucket.py::fused_lars_bucket_2d.  The
//                      fb_fused_sgd pass (same template) with the per-row
//                      trust ratio applied after the decay instead of the
//                      clip scale before it: 9.57 GB + a 14.9 MB (W, rows)
//                      ratio -> 2.86 ms.  The ratio is per worker, because
//                      each worker's layer norms are its own.
//
//   fb_segment_sum     replaces no TPU kernel: it is the port's segmented
//                      sum for the per-leaf totals that the reference takes
//                      with jax.ops.segment_sum outside any Pallas kernel
//                      (the compressor's and the wire pack's |x| scales,
//                      LARS's layer norms).  Each total is added one value
//                      after another in row order, as XLA's scatter and the
//                      CPU's index_add_ add it, so the card takes the CPU's
//                      bits and two runs take the same bits (index_add_ on
//                      the card adds with atomics, in no fixed order).  One
//                      warp per (segment, leading index), or per segment
//                      with the leading indices chained one after another
//                      (a total over all workers, in worker order, from an
//                      optional running total): the 32 lanes load 32 rows
//                      at once, the next 32 while the adds run, and the
//                      adds go one after another through warp shuffles.
//                      Reads the (L, rows) row sums once: at W = 4, 934,040
//                      rows 14.9 MB -> 4.5 us; the chain of dependent adds
//                      of the largest leaf sets the time, not the bytes.
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

struct UpdateParams {
  float lr, momentum, weight_decay;
};

// One element of the fused update.  SGD scales g by the per-worker
// grad-clip factor gs before everything else; LARS scales the decayed g
// by the row's trust ratio r.  The stats see g after the clip and before
// the decay, as the TPU kernels do.
template <bool kNesterov, bool kStats, bool kLars>
__device__ __forceinline__ void update_one(float& p, float g, float& u,
                                           float dec, float gs, float r,
                                           const UpdateParams& hp, float& gsq,
                                           float& usq) {
  if (!kLars) g = g * gs;                       // grad-clip scale (1 if off)
  if (kStats) gsq += g * g;                     // raw grad, before decay
  if (hp.weight_decay != 0.f) g = g + dec * p;  // dec = wd * wd_row[row]
  if (kLars) g = g * r;                         // trust ratio (1 on skip rows)
  const float un = hp.momentum * u + g;
  const float step = kNesterov ? hp.momentum * un + g : un;
  const float d = hp.lr * step;
  p = p - d;
  u = un;
  if (kStats) usq += d * d;
}

// grid = (grid_x, W); each block walks its worker's float4 groups with a
// grid stride.  gscale: (W,) or null (SGD only); ratio: (W, rows) (LARS
// only).  partials: (W, 2, grid_x) = [sum g^2 | sum (lr*step)^2].
template <bool kNesterov, bool kStats, bool kLars>
__global__ void __launch_bounds__(kThreads)
update_kernel(float* __restrict__ p, const float* __restrict__ g,
              float* __restrict__ u, const float* __restrict__ wd_row,
              const float* __restrict__ gscale,
              const float* __restrict__ ratio, UpdateParams hp, int64_t n4,
              float* __restrict__ partials) {
  const int w = blockIdx.y;
  const int64_t base = static_cast<int64_t>(w) * n4;
  float4* p4 = reinterpret_cast<float4*>(p) + base;
  const float4* g4 = reinterpret_cast<const float4*>(g) + base;
  float4* u4 = reinterpret_cast<float4*>(u) + base;
  const float gs = (!kLars && gscale != nullptr) ? gscale[w] : 1.f;
  const float* ratio_w = kLars ? ratio + static_cast<int64_t>(w) * (n4 / kVecPerRow)
                               : nullptr;
  float gsq = 0.f, usq = 0.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 pv = p4[i];
    const float4 gv = g4[i];
    float4 uv = u4[i];
    const int64_t row = i / kVecPerRow;
    const float dec = hp.weight_decay * wd_row[row];
    const float r = kLars ? ratio_w[row] : 1.f;
    update_one<kNesterov, kStats, kLars>(pv.x, gv.x, uv.x, dec, gs, r, hp, gsq, usq);
    update_one<kNesterov, kStats, kLars>(pv.y, gv.y, uv.y, dec, gs, r, hp, gsq, usq);
    update_one<kNesterov, kStats, kLars>(pv.z, gv.z, uv.z, dec, gs, r, hp, gsq, usq);
    update_one<kNesterov, kStats, kLars>(pv.w, gv.w, uv.w, dec, gs, r, hp, gsq, usq);
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

// sq_sum: 4 blocks of 512 threads per SM, four 16-byte loads in flight each
constexpr int kSqSumThreads = 512;
constexpr int kSqSumBlocksPerSM = 4;

// Block-wide sum of a sq_sum block; the result is valid in thread 0.
__device__ __forceinline__ float sq_block_sum(float a) {
  __shared__ float sa[kSqSumThreads / 32];
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

// 16 bytes read once: no L1 allocation, 256-byte L2 fetches
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ float sq_sum16(const uint4 v) {
  const float a = __uint_as_float(v.x), b = __uint_as_float(v.y);
  const float c = __uint_as_float(v.z), d = __uint_as_float(v.w);
  return (a * a + b * b) + (c * c + d * d);
}

// grid = (blocks per worker, W).  partials: (W, gridDim.x) block sums;
// tickets: (W,) zeroed counters, left zeroed; out[w] = sum x[w]^2.
__global__ void __launch_bounds__(kSqSumThreads)
sq_sum_kernel(const float* __restrict__ x, int64_t n4,
              float* __restrict__ partials, unsigned int* __restrict__ tickets,
              float* __restrict__ out) {
  const int w = blockIdx.y;
  const uint4* xv = reinterpret_cast<const uint4*>(x) + static_cast<int64_t>(w) * n4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    const uint4 a = ld_stream(xv + i);
    const uint4 b = ld_stream(xv + i + stride);
    const uint4 c = ld_stream(xv + i + 2 * stride);
    const uint4 d = ld_stream(xv + i + 3 * stride);
    s0 += sq_sum16(a);
    s1 += sq_sum16(b);
    s2 += sq_sum16(c);
    s3 += sq_sum16(d);
  }
  for (; i < n4; i += stride) s0 += sq_sum16(ld_stream(xv + i));
  const float s = sq_block_sum((s0 + s1) + (s2 + s3));

  float* part = partials + static_cast<int64_t>(w) * gridDim.x;
  __shared__ bool last;
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s;
    __threadfence();                   // the partial is visible before the ticket
    last = atomicAdd(tickets + w, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float f = 0.f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += blockDim.x)
    f += __ldcg(part + b);
  f = sq_block_sum(f);
  if (threadIdx.x == 0) {
    out[w] = f;
    tickets[w] = 0u;
  }
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

// One warp per 128-wide row of the stacked (W, rows, 128) buffers:
// pn[r] = sum p^2, gn[r] = sum (g + wd * wd_row[r % rows] * p)^2.
__global__ void __launch_bounds__(kThreads)
lars_row_norms_kernel(const float* __restrict__ p, const float* __restrict__ g,
                      const float* __restrict__ wd_row, float weight_decay,
                      int64_t n_rows, int64_t rows, float* __restrict__ pn,
                      float* __restrict__ gn) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;   // whole warps exit together
  const int64_t k = row * kVecPerRow + lane;
  const float4 pv = reinterpret_cast<const float4*>(p)[k];
  float4 gv = reinterpret_cast<const float4*>(g)[k];
  if (weight_decay != 0.f) {
    const float dec = weight_decay * wd_row[row % rows];
    gv.x = gv.x + dec * pv.x;
    gv.y = gv.y + dec * pv.y;
    gv.z = gv.z + dec * pv.z;
    gv.w = gv.w + dec * pv.w;
  }
  float sp = (pv.x * pv.x + pv.y * pv.y) + (pv.z * pv.z + pv.w * pv.w);
  float sg = (gv.x * gv.x + gv.y * gv.y) + (gv.z * gv.z + gv.w * gv.w);
  sp = warp_sum(sp);
  sg = warp_sum(sg);
  if (lane == 0) {
    pn[row] = sp;
    gn[row] = sg;
  }
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

// One warp per (segment s, leading index l) -- or per segment s with the
// leading indices chained (chain != 0) -- adds vals[l * rows + order[i]]
// for i in [offsets[s], offsets[s + 1]) one after another, starting from
// 0 (or from init[s] when chained).  Every lane runs the same chain of
// adds on values shuffled from the lane that loaded them.
__device__ __forceinline__ float load_seg(const float* v,
                                          const int64_t* __restrict__ order,
                                          int64_t i, int64_t hi) {
  return i < hi ? __ldg(v + __ldg(order + i)) : 0.f;
}

__global__ void __launch_bounds__(32)
segment_sum_kernel(const float* __restrict__ vals, int64_t L, int64_t rows,
                   const int64_t* __restrict__ order,
                   const int64_t* __restrict__ offsets, int64_t n_seg,
                   const float* __restrict__ init, int chain,
                   float* __restrict__ out) {
  const int64_t s = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t lo = offsets[s], hi = offsets[s + 1];
  const int64_t l0 = chain ? 0 : blockIdx.y;
  const int64_t l1 = chain ? L : l0 + 1;
  float acc = (chain && init != nullptr) ? init[s] : 0.f;
  for (int64_t l = l0; l < l1; ++l) {
    const float* v = vals + l * rows;
    float x = load_seg(v, order, lo + lane, hi);
    for (int64_t base = lo; base < hi; base += 32) {
      const float xn = load_seg(v, order, base + 32 + lane, hi);
      if (hi - base >= 32) {
#pragma unroll
        for (int j = 0; j < 32; ++j)
          acc = __fadd_rn(acc, __shfl_sync(0xffffffffu, x, j));
      } else {
        const int n = static_cast<int>(hi - base);
        for (int j = 0; j < n; ++j)
          acc = __fadd_rn(acc, __shfl_sync(0xffffffffu, x, j));
      }
      x = xn;
    }
  }
  if (lane == 0) out[(chain ? 0 : l0 * n_seg) + s] = acc;
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The fused update over the stacked buffer (four template variants), then,
// with stats, the second pass folding the (W, 2, grid_x) partials.
template <bool kLars>
int launch_update(void* p, const void* g, void* u, const void* wd_row,
                  const void* gscale, const void* ratio, UpdateParams hp,
                  int nesterov, int64_t W, int64_t rows, int stats,
                  void* partials, int64_t grid_x, void* stats_out,
                  cudaStream_t st) {
  const int64_t n4 = rows * kVecPerRow;
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(W));
  float* pp = static_cast<float*>(p);
  const float* gp = static_cast<const float*>(g);
  float* up = static_cast<float*>(u);
  const float* wp = static_cast<const float*>(wd_row);
  const float* sp = static_cast<const float*>(gscale);
  const float* rp = static_cast<const float*>(ratio);
  float* part = static_cast<float*>(partials);
  if (nesterov && stats)
    update_kernel<true, true, kLars><<<grid, kThreads, 0, st>>>(pp, gp, up, wp, sp, rp, hp, n4, part);
  else if (nesterov)
    update_kernel<true, false, kLars><<<grid, kThreads, 0, st>>>(pp, gp, up, wp, sp, rp, hp, n4, part);
  else if (stats)
    update_kernel<false, true, kLars><<<grid, kThreads, 0, st>>>(pp, gp, up, wp, sp, rp, hp, n4, part);
  else
    update_kernel<false, false, kLars><<<grid, kThreads, 0, st>>>(pp, gp, up, wp, sp, rp, hp, n4, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !stats) return static_cast<int>(err);
  reduce_rows_kernel<<<static_cast<unsigned>(2 * W), kThreads, 0, st>>>(
      part, grid_x, static_cast<float*>(stats_out));
  return static_cast<int>(cudaGetLastError());
}

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
  return launch_update<false>(p, g, u, wd_row, gscale, nullptr,
                              UpdateParams{lr, momentum, weight_decay},
                              nesterov, W, rows, stats, partials, grid_x,
                              stats_out, static_cast<cudaStream_t>(stream));
}

// As fb_fused_sgd, with ratio: (W, rows) f32 per-worker, per-row trust
// ratio in place of the clip scale.
int fb_fused_lars(void* p, const void* g, void* u, const void* wd_row,
                  const void* ratio, float lr, float momentum,
                  float weight_decay, int nesterov, int64_t W, int64_t rows,
                  int stats, void* partials, int64_t grid_x, void* stats_out,
                  void* stream) {
  return launch_update<true>(p, g, u, wd_row, nullptr, ratio,
                             UpdateParams{lr, momentum, weight_decay},
                             nesterov, W, rows, stats, partials, grid_x,
                             stats_out, static_cast<cudaStream_t>(stream));
}

// p, g: (W, rows, 128) f32; wd_row: (rows,) f32; pn, gn: (W, rows) f32.
int fb_lars_row_norms(const void* p, const void* g, const void* wd_row,
                      float weight_decay, int64_t W, int64_t rows, void* pn,
                      void* gn, void* stream) {
  const int64_t n_rows = W * rows;
  const int64_t blocks = cdiv(n_rows * 32, kThreads);
  lars_row_norms_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(g),
      static_cast<const float*>(wd_row), weight_decay, n_rows, rows,
      static_cast<float*>(pn), static_cast<float*>(gn));
  return static_cast<int>(cudaGetLastError());
}

// *blocks = 4 a streaming multiprocessor on the current device: the caller
// gives each worker *blocks / 4 of them at most, whatever W is.
int fb_sq_sum_blocks(int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = kSqSumBlocksPerSM * sms;
  return static_cast<int>(err);
}

// x: (W, rows, 128) f32; partials: max_blocks f32 scratch, max_blocks >= W,
// each worker taking at most max_blocks / W blocks;
// tickets: W zeroed uint32, left zeroed, for this stream's calls only;
// out: (W,) f32.
int fb_sq_sum(const void* x, int64_t W, int64_t rows, void* partials,
              int64_t max_blocks, void* tickets, void* out, void* stream) {
  const int64_t n4 = rows * kVecPerRow;
  int64_t per_worker = cdiv(n4, kSqSumThreads * 4);
  if (per_worker > max_blocks / W) per_worker = max_blocks / W;
  if (per_worker < 1) per_worker = 1;
  const dim3 grid(static_cast<unsigned>(per_worker), static_cast<unsigned>(W));
  sq_sum_kernel<<<grid, kSqSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n4, static_cast<float*>(partials),
      static_cast<unsigned int*>(tickets), static_cast<float*>(out));
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

// vals: (L, rows) f32; order: (rows,) int64, the rows segment by segment,
// each segment's in row order; offsets: (n_seg + 1,) int64 into order.
// chain == 0: out (L, n_seg); chain != 0: out (n_seg,), the leading
// indices added one after another onto init (n_seg,) or 0 (init null).
int fb_segment_sum(const void* vals, int64_t L, int64_t rows,
                   const void* order, const void* offsets, int64_t n_seg,
                   const void* init, int chain, void* out, void* stream) {
  if (L < 1 || n_seg < 1) return 0;
  const dim3 grid(static_cast<unsigned>(n_seg),
                  static_cast<unsigned>(chain ? 1 : L));
  segment_sum_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), L, rows,
      static_cast<const int64_t*>(order), static_cast<const int64_t*>(offsets),
      n_seg, static_cast<const float*>(init), chain, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
