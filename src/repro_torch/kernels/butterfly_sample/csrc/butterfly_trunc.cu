// Truncated categorical draws (top-k, top-p, min-p) on given weights for
// Hopper (sm_90a): a per-row weight threshold tau, then the butterfly
// draw of paper Alg. 9/10 on the masked row, w * [w >= tau].
//
// Replaces the TPU kernels of src/repro/kernels/butterfly_sample/kernel.py:
//   fused_trunc_draw   <- _fused_trunc_draw_kernel (fused_trunc_draw_pallas)  K9
//   masked_blocksums   <- _masked_blocksum_kernel  (masked_blocksums_pallas)  K11
//   walk_trunc         <- _walk_trunc_kernel       (walk_trunc_pallas)        K12
//
// K9 design.  One thread block per row.  The TPU kernel bisects on a row
// tile resident in VMEM; a vocabulary row (256,000 fp32 = 1 MB) is far
// over a block's 227 KB of shared memory, so the row is staged in dynamic
// shared memory while it fits and otherwise re-read from global memory
// (L2) on every pass.  tau follows transforms.thresholds_from_params step
// for step: the row max; for top-k (k > 0) 32 bisection steps over the
// uint32 bit patterns, mid = lo + (hi - lo) / 2, each a block-wide integer
// count of w >= mid compared as a float with k; for top-p (p < 1) the
// masked total, target = p * total, and 32 steps of block-wide masked
// sums; min-p as max(tau, p * rowmax).  The masked draw then runs the
// draw_tile.cuh steps: every warp sums a strided share of the W-blocks
// (the arithmetic one warp would use), warp 0 takes the running sums,
// selects the block, builds its Fenwick table and descends.  What bounds
// this design: about 66 passes over the row (2 x 32 bisection steps), so
// on-chip bandwidth per SM, not device memory; the staged row keeps those
// passes in shared memory (faster than L2 where both run, PERF.md).  The
// function itself needs only its bytes (the row read once): a radix
// select would find the same tau in 4 passes.  Sums are in a fixed order (per-thread in index order,
// an xor tree in the warp, warps in order), so a top-p tau can differ
// from XLA's or PyTorch's only where the masked mass lies within fp32
// rounding of p * total; counts are integers and exact.
//
// K11 and K12 are K2 and K3 of butterfly_sample.cu with a masking row
// loader (w[k] >= tau ? w[k] : 0).  K11 runs one thread block per row (a
// vocabulary row is too long for K2's one warp): the warps split the
// W-blocks as K9's draw does, then warp 0 writes the running sums itself
// (no cumsum follows), so K9 and K11 give equal sums.  K12 reads
// tau[rows[s]] and re-masks the one W-block it fetches, finding its block
// itself, one warp per draw as K3.  Bound: device memory (each weight read
// once by K11; one running row and one W-block per draw by K12).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "draw_tile.cuh"

namespace {

constexpr int kWarps = 4;            // K12: warps (draws) per block
constexpr int kTruncThreads = 1024;  // K9, K11: threads per block (one row)
constexpr int kTruncWarps = kTruncThreads / 32;
constexpr int kRedFloats = 2 * kTruncWarps;

using draw_tile::kFullMask;
using draw_tile::to_f32;
using draw_tile::warp_block_sums_strided;
using draw_tile::warp_running;
using draw_tile::warp_walk;

template <typename T>
struct MaskedRow {  // w[k] * [w[k] >= tau]: one row of given weights, masked
  const T* __restrict__ w;
  float tau;
  __device__ __forceinline__ float operator()(int k) const {
    const float v = to_f32(w[k]);
    return v >= tau ? v : 0.f;
  }
};

template <typename T>
struct TruncRow {  // the K9 row: staged in shared memory or read from w
  const T* __restrict__ w;
  const float* staged;  // nullptr when the row is not staged
  float tau;
  __device__ __forceinline__ float raw(int k) const {
    return staged ? staged[k] : to_f32(w[k]);
  }
  __device__ __forceinline__ float operator()(int k) const {
    const float v = raw(k);
    return v >= tau ? v : 0.f;
  }
};

// Block-wide reductions: an xor tree inside each warp, then the warps'
// partials in order; every thread returns the same value.  red holds
// kRedFloats floats; the trailing barrier lets the next call reuse it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < kTruncWarps; ++i) s = __fadd_rn(s, red[i]);
  __syncthreads();
  return s;
}

__device__ __forceinline__ unsigned block_count(unsigned v, float* red) {
  unsigned* r = reinterpret_cast<unsigned*>(red);
  v = __reduce_add_sync(kFullMask, v);
  if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned s = 0;
  for (int i = 0; i < kTruncWarps; ++i) s += r[i];
  __syncthreads();
  return s;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
  for (int i = 1; i < kTruncWarps; ++i) s = fmaxf(s, red[i]);
  __syncthreads();
  return s;
}

// The largest float tau in bit range [lo, hi) with keep(tau) true,
// keep(lo) assumed true: transforms._bisect.
template <typename Keep>
__device__ __forceinline__ float bisect(unsigned lo, unsigned hi, int iters,
                                        const Keep& keep) {
  for (int it = 0; it < iters; ++it) {
    const unsigned mid = lo + (hi - lo) / 2u;
    if (keep(__uint_as_float(mid)))
      lo = mid;
    else
      hi = mid;
  }
  return __uint_as_float(lo);
}

template <typename T>
__global__ void __launch_bounds__(kTruncThreads)
    fused_trunc_draw_kernel(const T* __restrict__ w,
                            const float* __restrict__ u,
                            const float* __restrict__ params,
                            int* __restrict__ out, int ncols, int nb, int W,
                            int iters, int staged) {
  extern __shared__ float smem[];
  float* red = smem;
  float* run = red + kRedFloats;
  float* t = run + nb;
  float* rowbuf = t + W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = blockIdx.x;
  const T* wr = w + static_cast<size_t>(row) * ncols;
  if (staged) {
    for (int k = tid; k < ncols; k += kTruncThreads) rowbuf[k] = to_f32(wr[k]);
    __syncthreads();
  }
  TruncRow<T> r{wr, staged ? rowbuf : nullptr, 0.f};

  float m = -__int_as_float(0x7f800000);  // -inf
  for (int k = tid; k < ncols; k += kTruncThreads) m = fmaxf(m, r.raw(k));
  const float rowmax = block_max(m, red);
  const unsigned above = __float_as_uint(rowmax) + 1u;
  const float pk = params[3 * row], pp = params[3 * row + 1],
              pm = params[3 * row + 2];
  float tau = 0.f;
  if (pk > 0.f) {  // top-k: #{w >= tau} >= k
    const float got = bisect(__float_as_uint(tau), above, iters, [&](float tm) {
      unsigned c = 0;
      for (int k = tid; k < ncols; k += kTruncThreads) c += r.raw(k) >= tm ? 1u : 0u;
      return static_cast<float>(block_count(c, red)) >= pk;
    });
    tau = fmaxf(got, tau);
  }
  if (pp < 1.f) {  // top-p on the survivors: sum(w[w >= tau]) >= p * total
    auto masked_sum = [&](float tm) {
      float s = 0.f;
      for (int k = tid; k < ncols; k += kTruncThreads) {
        const float v = r.raw(k);
        s = __fadd_rn(s, v >= tm ? v : 0.f);
      }
      return block_sum(s, red);
    };
    const float target = __fmul_rn(pp, masked_sum(tau));
    const float got = bisect(__float_as_uint(tau), above, iters,
                             [&](float tm) { return masked_sum(tm) >= target; });
    tau = fmaxf(got, tau);
  }
  if (pm > 0.f) tau = fmaxf(tau, __fmul_rn(pm, rowmax));  // min-p

  // the draw on the masked row
  r.tau = tau;
  warp_block_sums_strided<false>(r, ncols, nb, W, nullptr, run, lane, warp,
                                 kTruncWarps);
  __syncthreads();
  if (warp == 0) {
    warp_running(run, nb, lane);
    const int idx = warp_walk(r, run, ncols, nb, W, u[row], t, lane);
    if (lane == 0) out[row] = idx;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTruncThreads)
    masked_blocksums_kernel(const T* __restrict__ w,
                            const float* __restrict__ tau,
                            float* __restrict__ running, int ncols, int nb,
                            int W) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x;
  const MaskedRow<T> row{w + static_cast<size_t>(s) * ncols, tau[s]};
  // the output row doubles as the scan buffer
  float* out = running + static_cast<size_t>(s) * nb;
  warp_block_sums_strided<false>(row, ncols, nb, W, nullptr, out, lane, warp,
                                 kTruncWarps);
  __syncthreads();
  if (warp == 0) warp_running(out, nb, lane);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    walk_trunc_kernel(const T* __restrict__ w,
                      const float* __restrict__ running,
                      const float* __restrict__ u,
                      const float* __restrict__ tau,
                      const int* __restrict__ rows, int* __restrict__ out,
                      int Bt, int ncols, int nb, int W) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int s = blockIdx.x * kWarps + wib;
  if (s >= Bt) return;
  const size_t r = static_cast<size_t>(rows[s]);
  const MaskedRow<T> row{w + r * ncols, tau[r]};
  const int idx = warp_walk(row, running + r * nb, ncols, nb, W, u[s],
                            smem + wib * W, lane);
  if (lane == 0) out[s] = idx;
}

inline unsigned grid_for(int n) {
  return static_cast<unsigned>((n + kWarps - 1) / kWarps);
}

size_t trunc_smem_bytes(int ncols, int nb, int W, int staged) {
  return sizeof(float) *
         (static_cast<size_t>(kRedFloats) + nb + W + (staged ? ncols : 0));
}

template <typename T>
int launch_fused_trunc(const void* w, const void* u, const void* params,
                       void* out, int B, int ncols, int nb, int W, int iters,
                       int staged, cudaStream_t st) {
  const size_t smem = trunc_smem_bytes(ncols, nb, W, staged);
  cudaError_t e = cudaFuncSetAttribute(
      fused_trunc_draw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_trunc_draw_kernel<T><<<B, kTruncThreads, smem, st>>>(
      static_cast<const T*>(w), static_cast<const float*>(u),
      static_cast<const float*>(params), static_cast<int*>(out), ncols, nb, W,
      iters, staged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Every function launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" {

// params: (B, 3) float32 [top_k, top_p, min_p]; staged: 1 to stage each row
// in shared memory (the wrapper checks that it fits), 0 to read it from
// global memory on every pass.
int fused_trunc_draw(const void* w, const void* u, const void* params,
                     void* out, int B, int ncols, int nb, int W, int iters,
                     int staged, int dtype, void* stream) {
  if (B <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_fused_trunc<__nv_bfloat16>(w, u, params, out, B, ncols, nb,
                                             W, iters, staged, st);
  return launch_fused_trunc<float>(w, u, params, out, B, ncols, nb, W, iters,
                                   staged, st);
}

int masked_blocksums(const void* w, const void* tau, void* running, int B,
                     int ncols, int nb, int W, int dtype, void* stream) {
  if (B <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const float* tt = static_cast<const float*>(tau);
  float* r = static_cast<float*>(running);
  if (dtype == 1)
    masked_blocksums_kernel<__nv_bfloat16><<<B, kTruncThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(w), tt, r, ncols, nb, W);
  else
    masked_blocksums_kernel<float><<<B, kTruncThreads, 0, st>>>(
        static_cast<const float*>(w), tt, r, ncols, nb, W);
  return static_cast<int>(cudaGetLastError());
}

int walk_trunc(const void* w, const void* running, const void* u,
               const void* tau, const void* rows, void* out, int Bt, int ncols,
               int nb, int W, int dtype, void* stream) {
  if (Bt <= 0) return 0;
  const size_t smem = sizeof(float) * kWarps * W;
  auto st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(running);
  const float* uu = static_cast<const float*>(u);
  const float* tt = static_cast<const float*>(tau);
  const int* rw = static_cast<const int*>(rows);
  int* o = static_cast<int*>(out);
  if (dtype == 1)
    walk_trunc_kernel<__nv_bfloat16><<<grid_for(Bt), kWarps * 32, smem, st>>>(
        static_cast<const __nv_bfloat16*>(w), r, uu, tt, rw, o, Bt, ncols, nb,
        W);
  else
    walk_trunc_kernel<float><<<grid_for(Bt), kWarps * 32, smem, st>>>(
        static_cast<const float*>(w), r, uu, tt, rw, o, Bt, ncols, nb, W);
  return static_cast<int>(cudaGetLastError());
}

// Threads per block of K9 and K11; the wrapper decides from it whether a
// row can be staged in shared memory.
int butterfly_trunc_threads(void) { return kTruncThreads; }

}  // extern "C"
