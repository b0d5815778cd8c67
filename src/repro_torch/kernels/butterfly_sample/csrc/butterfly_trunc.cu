// Truncated categorical draws (top-k, top-p, min-p) on given weights for
// Hopper (sm_90a): a per-row weight threshold tau, then the butterfly
// draw of paper Alg. 9/10 on the masked row, w * [w >= tau].
//
// Replaces the TPU kernels of src/repro/kernels/butterfly_sample/kernel.py:
//   fused_trunc_draw   <- _fused_trunc_draw_kernel (fused_trunc_draw_pallas)  K9
//   fused_trunc_draw_rng <- _fused_trunc_draw_rng_kernel
//                           (fused_trunc_draw_rng_pallas)                   K10
//   masked_blocksums   <- _masked_blocksum_kernel  (masked_blocksums_pallas)  K11
//   walk_trunc         <- _walk_trunc_kernel       (walk_trunc_pallas)        K12
//
// K9 design.  One thread block of 1,024 threads per row.  The TPU kernel
// bisects on a row tile resident in VMEM; a vocabulary row (256,000 fp32 =
// 1 MB) is far over a block's 227 KB of shared memory, so the row is
// staged in dynamic shared memory while it fits and otherwise re-read from
// global memory (L2) on every pass.  Each thread owns the columns k = tid +
// j * 1024 and reads them in order, eight loads in flight.  tau is
// transforms.thresholds_from_params bit for bit, in five passes over the
// row, the draw's included:
//   1. the row max (for min-p and top-p's bracket) and, when top-k is on,
//      a histogram of the top 8 bits of each key, key = bits(v) & 0x7fffffff
//      for v >= 0 (-0.0 counts as +0.0, as it does in w >= tm; negative
//      values and NaN are never counted by any tm >= +0, so they have no key);
//   2-4. histograms of the next 8-bit digits over the keys that match the
//      digits found so far: tau_k is the key of the ceil(k)-th largest value
//      (0 when fewer keys exist), which is what the reference's 32 bisection
//      steps over the bit patterns find, since 32 steps are exact there.
//      Counts are integers, so the histograms' order does not matter; a
//      warp adds each distinct digit once (__match_any_sync), as softmax rows
//      put most keys in a few bins.  Pass 4 also counts each thread's keys at
//      or above the 24 bits found.  With iters < 32 the bisection runs
//      instead: a radix select would then be more exact than the reference;
//   5. top-p (p < 1): each thread lists those values (every survivor w >=
//      tau_k and the few just below it that share its top 24 bits), in its
//      index order, at offsets from a block-wide scan of the counts; the
//      masked total, target = p * total, and the 32 bisection steps of
//      block-wide masked sums then read that list.  Each thread adds its own
//      segment in order, then the same xor tree and warp order as a full-row
//      sum: the zeros of the values left out (and of the listed ones below
//      every tm) never changed a partial, so tau is bit-equal to the
//      full-row sums.  Where the list would overflow (top-k off, or ties at
//      tau_k), the row takes the full-row sums: same kernel, same result;
//   6. min-p as max(tau, p * rowmax), then the draw on the masked row, w *
//      [w >= tau]: the warps split the row's 128-column tiles and sum each
//      W-block with the arithmetic of draw_tile.cuh's warp_block_sums_strided
//      (an xor tree per 32-column piece, pieces added in order), then warp 0
//      takes the running sums, selects the block, builds its Fenwick table
//      and descends.
// list_cap = 0 runs the bisection body instead (32 count passes for top-k,
// 33 masked-sum passes for top-p, all over the row), for holding the two
// against each other.  What bounds the design: a few passes over the row by
// one SM (its loads in flight), not device memory; the function itself needs
// its bytes, the row read once.  Sums are in a fixed order (per-thread in
// index order, an xor tree in the warp, warps in order), so a top-p tau can
// differ from XLA's or PyTorch's only where the masked mass lies within fp32
// rounding of p * total; counts are exact.
//
// K10 is K9 with its u operand replaced by Threefry uniforms made in the
// kernel: one body (fused_trunc_draw_kernel), instantiated on its uniform
// source (threefry.cuh: ArrayU for K9, ThreefryU for K10).  Only warp 0
// reads the uniform, once, after the threshold phase; K10 keeps K9's
// staged-row / L2 switch, so a change to the threshold phase carries over.
//
// K11 and K12 are K2 and K3 of butterfly_sample.cu with a masking row
// loader (w[k] >= tau ? w[k] : 0).  K11 splits a row over P blocks of 256
// threads (grid (B, P), P so that the grid fills the card): each block
// takes a contiguous run of 128-column tiles, each summed by one warp as K9's
// draw sums them, into shared memory, written once.  The row's last block to
// arrive (a per-row counter after __threadfence) runs warp_running's scan
// over the row's sums through shared memory, in the same order, and writes
// the running sums, so K9 and K11 give equal sums.  The split
// (tile_block_sums, split_row_running, split_tiles_per_block) lives in
// draw_tile.cuh, where K4/K5's split layout (butterfly_sample.cu) shares
// it.  K12 reads tau[rows[s]] and re-masks the one W-block it fetches,
// finding its block itself.  Bound: device memory (each weight read once by
// K11; one running row and one W-block per draw by K12).
//
// K12 design.  Two layouts, which give the same index bit for bit.  The
// warp layout (one warp per draw: warp_walk's select, block load through
// shared memory, Fenwick table with a __syncwarp per level and one-lane
// descent) is K3's before its group walk.  The group layout, which the
// wrapper takes at every W, is K3's and K7's: a group of W / 4 lanes per
// draw runs draw_tile.cuh's group_walk over the running row in global
// memory, with MaskedRow4 loading a lane's four masked weights (one
// 16-byte load, 8 for bf16, where every row start is aligned; four loads
// otherwise).  The count over the running row, the Fenwick adds and the
// descent are warp_walk's, so the index is too; at W = 128 a group is a
// whole warp, and the gain is the register Fenwick table and the vector
// load, not more draws per warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "draw_tile.cuh"
#include "threefry.cuh"

namespace {

constexpr int kWarps = 4;            // K12: warps (draws) per block
constexpr int kTruncThreads = 1024;  // K9: threads per block (one row)
constexpr int kTruncWarps = kTruncThreads / 32;
constexpr int kRedFloats = 2 * kTruncWarps;
constexpr int kBins = 256;           // K9: 8-bit digits of the radix select
constexpr int kInFlight = 8;         // K9: loads in flight per thread in a pass

using draw_tile::group_walk;
using draw_tile::kFullMask;
using draw_tile::kSumThreads;
using draw_tile::kTile;
using draw_tile::split_row_running;
using draw_tile::split_sum_floats;
using draw_tile::split_tiles_per_block;
using draw_tile::tile_block_sums;
using draw_tile::to_f32;
using draw_tile::warp_running;
using draw_tile::warp_walk;
using threefry::ArrayU;
using threefry::ThreefryU;

template <typename T>
struct MaskedRow {  // w[k] * [w[k] >= tau]: one row of given weights, masked
  const T* __restrict__ w;
  float tau;
  __device__ __forceinline__ float operator()(int k) const {
    const float v = to_f32(w[k]);
    return v >= tau ? v : 0.f;
  }
};

// MaskedRow for a group of W / 4 lanes (K12's group layout): e[0..3] =
// the masked weights of columns k0..k0+3 (k0 % 4 == 0), zero past ncols,
// each v = w[k] kept where v >= tau as MaskedRow keeps it.  VEC: one load4,
// which needs ncols % 4 == 0 and aligned row starts; else four loads.
template <typename T, bool VEC>
struct MaskedRow4 {
  const T* __restrict__ w;
  int ncols;
  float tau;
  __device__ __forceinline__ void operator()(int k0, float (&e)[4]) const {
    if (VEC) {
      if (k0 < ncols) {
        draw_tile::load4<true>(w + k0, e);
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = e[i] >= tau ? e[i] : 0.f;
      } else {
        e[0] = e[1] = e[2] = e[3] = 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = k0 + i < ncols ? to_f32(w[k0 + i]) : 0.f;
        e[i] = v >= tau ? v : 0.f;
      }
    }
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

// Exclusive block-wide scan of one count per thread (thread order); every
// thread also gets the block's total.
__device__ __forceinline__ unsigned block_offset(unsigned v, float* red,
                                                 unsigned& total) {
  unsigned* r = reinterpret_cast<unsigned*>(red);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned n = __shfl_up_sync(kFullMask, inc, off);
    if (lane >= off) inc += n;
  }
  if (lane == 31) r[warp] = inc;
  __syncthreads();
  unsigned before = 0, all = 0;
  for (int i = 0; i < kTruncWarps; ++i) {
    before += i < warp ? r[i] : 0u;
    all += r[i];
  }
  __syncthreads();
  total = all;
  return before + inc - v;
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

// f(valid, v) for this thread's columns k = tid + j * kTruncThreads of the
// row, in order, with kInFlight loads issued before they are used; all
// lanes of a warp make the same calls (valid is false past the row), so f
// may use warp-wide intrinsics.
template <typename Row, typename F>
__device__ __forceinline__ void for_own_columns(const Row& r, int ncols,
                                                const F& f) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x - lane; b < ncols; b += kInFlight * kTruncThreads) {
    float v[kInFlight];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int k = b + i * kTruncThreads + lane;
      v[i] = k < ncols ? r.raw(k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kInFlight; ++i)
      f(b + i * kTruncThreads + lane < ncols, v[i]);
  }
}

// One row element's vote in a radix-select histogram: a key (v >= 0:
// bits(v) & 0x7fffffff, so -0.0 is +0.0; no key for negatives and NaN)
// whose bits under hmask equal prefix adds one to the bin of its digit at
// shift.  Called by all 32 lanes of a warp together; the lanes that share
// a digit add once.
__device__ __forceinline__ void radix_vote(unsigned* hist, bool valid, float v,
                                           unsigned hmask, unsigned prefix,
                                           int shift, int lane) {
  const unsigned key = __float_as_uint(v) & 0x7fffffffu;
  const bool on = valid && v >= 0.f && (key & hmask) == prefix;
  if (!__any_sync(kFullMask, on)) return;
  const unsigned digit = on ? (key >> shift) & 0xffu : 0x100u;
  const unsigned peers = __match_any_sync(kFullMask, digit);
  if (on && lane == __ffs(peers) - 1) atomicAdd(hist + digit, static_cast<unsigned>(__popc(peers)));
}

// The digit of the rem-th largest key counted in hist (one warp, every
// lane the same answer): its bin, and rem less the keys in the bins above
// it.  total gets the histogram's count; found is false when rem > total.
__device__ __forceinline__ bool radix_pick(const unsigned* hist, unsigned rem,
                                           int lane, unsigned& digit,
                                           unsigned& rest, unsigned& total) {
  unsigned h[8], own = 0;
  for (int j = 0; j < 8; ++j) {  // lane l holds bins 255 - 8l down to 248 - 8l
    h[j] = hist[kBins - 1 - 8 * lane - j];
    own += h[j];
  }
  unsigned inc = own;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned n = __shfl_up_sync(kFullMask, inc, off);
    if (lane >= off) inc += n;
  }
  total = __shfl_sync(kFullMask, inc, 31);
  unsigned acc = inc - own;  // keys in the bins above this lane's
  const bool here = acc < rem && rem <= inc;
  unsigned d = 0, above = 0;
  if (here) {
    for (int j = 0; j < 8; ++j) {
      if (acc + h[j] >= rem) {
        d = kBins - 1 - 8 * lane - j;
        above = acc;
        break;
      }
      acc += h[j];
    }
  }
  const unsigned who = __ballot_sync(kFullMask, here);
  if (!who) return false;
  const int src = __ffs(who) - 1;
  digit = __shfl_sync(kFullMask, d, src);
  rest = rem - __shfl_sync(kFullMask, above, src);
  return true;
}

// Dynamic shared memory of K9, in floats: kRedFloats for the reductions,
// then the scratch that holds the radix histogram, then the survivor list,
// then the draw's nb running sums and W-block (list_cap >= kBins, or 0 for
// the bisection body), then the staged row.
__host__ __device__ __forceinline__ int trunc_scratch_floats(int nb, int W,
                                                             int list_cap) {
  return list_cap > nb + W ? list_cap : nb + W;
}

// K9 (USrc = ArrayU) and K10 (ThreefryU): usrc(row) is the row's uniform.
template <typename T, typename USrc>
__global__ void __launch_bounds__(kTruncThreads)
    fused_trunc_draw_kernel(const T* __restrict__ w, const USrc usrc,
                            const float* __restrict__ params,
                            int* __restrict__ out, int ncols, int nb, int W,
                            int iters, int staged, int list_cap) {
  extern __shared__ float smem[];
  float* red = smem;
  float* scratch = red + kRedFloats;
  float* run = scratch;
  float* t = run + nb;
  float* rowbuf = scratch + trunc_scratch_floats(nb, W, list_cap);
  unsigned* hist = reinterpret_cast<unsigned*>(scratch);
  float* list = scratch;
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
  const float pk = params[3 * row], pp = params[3 * row + 1],
              pm = params[3 * row + 2];
  // top-k by radix select (the bisection's answer when iters >= 32)
  const bool select = list_cap > 0 && pk > 0.f && iters >= 32;

  if (select) {
    if (tid < kBins) hist[tid] = 0u;
    __syncthreads();
  }
  // pass 1: the row max (each thread's columns in the bisection body's
  // order) and the histogram of the top digit
  float m = -__int_as_float(0x7f800000);  // -inf
  for_own_columns(r, ncols, [&](bool valid, float v) {
    if (valid) m = fmaxf(m, v);
    if (select) radix_vote(hist, valid, v, 0u, 0u, 24, lane);
  });
  const float rowmax = block_max(m, red);
  const unsigned above = __float_as_uint(rowmax) + 1u;
  float tau = 0.f;
  // top-p's list (step 5) holds every key >= hi24: this thread's count,
  // taken in the last digit pass, or counted afresh when hi24 is unknown
  unsigned hi24 = 0u, cnt = 0u;
  bool counted = false;
  if (select) {
    unsigned digit, rest, total;
    radix_pick(hist, 1u, lane, digit, rest, total);
    // #{w >= +0} >= k compared as a float, as the bisection's first test
    if (static_cast<float>(total) >= pk) {
      unsigned rem = static_cast<unsigned>(ceilf(pk));
      unsigned prefix = 0u, hmask = 0u;
      for (int shift = 24; shift >= 0; shift -= 8) {
        if (shift < 24) {  // passes 2-4: the keys under the digits found
          __syncthreads();
          if (tid < kBins) hist[tid] = 0u;
          __syncthreads();
          for_own_columns(r, ncols, [&](bool valid, float v) {
            radix_vote(hist, valid, v, hmask, prefix, shift, lane);
            // keys >= the 24 bits found: a superset of the survivors
            if (shift == 0)
              cnt += valid && v >= 0.f && (__float_as_uint(v) & 0x7fffffffu) >= prefix
                         ? 1u : 0u;
          });
          __syncthreads();
        }
        radix_pick(hist, rem, lane, digit, rest, total);
        prefix |= digit << shift;
        hmask |= 0xffu << shift;
        rem = rest;
      }
      tau = __uint_as_float(prefix);
      hi24 = prefix & 0xffffff00u;
      counted = true;
    }
    __syncthreads();  // the histogram is read; the scratch is free
  } else if (pk > 0.f) {  // top-k by bisection: #{w >= tau} >= k
    const float got = bisect(__float_as_uint(tau), above, iters, [&](float tm) {
      unsigned c = 0;
      for (int k = tid; k < ncols; k += kTruncThreads) c += r.raw(k) >= tm ? 1u : 0u;
      return static_cast<float>(block_count(c, red)) >= pk;
    });
    tau = fmaxf(got, tau);
  }
  if (pp < 1.f) {  // top-p on the survivors: sum(w[w >= tau]) >= p * total
    // this thread's survivors, in its index order, at list[off, off + cnt):
    // every v >= tau, and with them any v with a key >= hi24 (zeros in
    // every masked sum below, as in the full-row sums)
    bool listed = false;
    unsigned off = 0;
    if (list_cap > 0) {
      const float lo = counted ? __uint_as_float(hi24) : tau;
      if (!counted)
        for_own_columns(r, ncols, [&](bool valid, float v) {
          cnt += valid && v >= lo ? 1u : 0u;
        });
      unsigned total;
      off = block_offset(cnt, red, total);
      listed = total <= static_cast<unsigned>(list_cap);
      if (listed) {
        unsigned j = off;
        for_own_columns(r, ncols, [&](bool valid, float v) {
          if (valid && v >= lo) list[j++] = v;
        });
        __syncthreads();
      }
    }
    auto masked_sum = [&](float tm) {
      float s = 0.f;
      if (listed) {
        for (unsigned i = off; i < off + cnt; ++i) {
          const float v = list[i];
          s = __fadd_rn(s, v >= tm ? v : 0.f);
        }
      } else {
        for (int k = tid; k < ncols; k += kTruncThreads) {
          const float v = r.raw(k);
          s = __fadd_rn(s, v >= tm ? v : 0.f);
        }
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
  const int Kp = nb * W;
  const int kv = ncols < Kp ? ncols : Kp;
  for (int ti = warp; ti * kTile < Kp; ti += kTruncWarps)
    tile_block_sums(r, ti, kv, Kp, W, run, 0, lane);
  __syncthreads();
  if (warp == 0) {
    warp_running(run, nb, lane);
    const int idx = warp_walk(r, run, ncols, nb, W, usrc(row), t, lane);
    if (lane == 0) out[row] = idx;
  }
}

// K11: block (s, p) sums the W-blocks of tiles [p * tpb, (p + 1) * tpb) of
// row s of the masked weights; the row's last block to arrive scans the
// row (draw_tile.cuh's split_row_running).
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    masked_blocksums_kernel(const T* __restrict__ w,
                            const float* __restrict__ tau,
                            float* __restrict__ running,
                            unsigned* __restrict__ arrived, int ncols, int nb,
                            int W, int tpb) {
  extern __shared__ float sbs[];
  const int s = blockIdx.x;
  const MaskedRow<T> row{w + static_cast<size_t>(s) * ncols, tau[s]};
  split_row_running(row, running + static_cast<size_t>(s) * nb, arrived + s,
                    ncols, nb, W, tpb, sbs);
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

// K12, group layout: draw s by the group of W / 4 lanes threadIdx.x / (W /
// 4) of its block (32 / (W / 4) draws per warp), on running row rows[s]
// read from global memory and block jb of weight row rows[s] masked by
// tau[rows[s]]; no shared memory.
template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    walk_trunc_group_kernel(const T* __restrict__ w,
                            const float* __restrict__ running,
                            const float* __restrict__ u,
                            const float* __restrict__ tau,
                            const int* __restrict__ rows, int* __restrict__ out,
                            int Bt, int ncols, int nb) {
  constexpr int G = W / 4;
  constexpr int kDraws = kWarps * 32 / G;  // draws per block
  const int base = blockIdx.x * kDraws;
  if (base + (threadIdx.x & ~31) / G >= Bt) return;  // the whole warp is past Bt
  const int q = threadIdx.x & (G - 1);
  const int gid = base + threadIdx.x / G;
  // a group past Bt redoes the last draw, so every lane joins the shuffles
  const int s = gid < Bt ? gid : Bt - 1;
  const size_t r = static_cast<size_t>(rows[s]);
  const MaskedRow4<T, VEC> row{w + r * ncols, ncols, tau[r]};
  const int idx = group_walk<W>(row, running + r * nb, nb, u[s], q);
  if (q == 0 && gid < Bt) out[s] = idx;
}

inline unsigned grid_for(int n) {
  return static_cast<unsigned>((n + kWarps - 1) / kWarps);
}

template <typename T, int W>
int launch_walk_trunc_group_w(const T* w, const float* r, const float* u,
                              const float* tau, const int* rows, int* out, int Bt,
                              int ncols, int nb, bool vec, cudaStream_t st) {
  constexpr int kDraws = kWarps * 32 / (W / 4);
  const unsigned grid = static_cast<unsigned>((Bt + kDraws - 1) / kDraws);
  if (vec)
    walk_trunc_group_kernel<T, W, true><<<grid, kWarps * 32, 0, st>>>(
        w, r, u, tau, rows, out, Bt, ncols, nb);
  else
    walk_trunc_group_kernel<T, W, false><<<grid, kWarps * 32, 0, st>>>(
        w, r, u, tau, rows, out, Bt, ncols, nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_walk_trunc_group(const void* w, const float* r, const float* u,
                            const float* tau, const int* rows, int* out, int Bt,
                            int ncols, int nb, int W, cudaStream_t st) {
  const T* wt = static_cast<const T*>(w);
  const bool vec = draw_tile::rows_aligned(wt, ncols);
  switch (W) {
    case 8:
      return launch_walk_trunc_group_w<T, 8>(wt, r, u, tau, rows, out, Bt, ncols, nb, vec,
                                             st);
    case 16:
      return launch_walk_trunc_group_w<T, 16>(wt, r, u, tau, rows, out, Bt, ncols, nb,
                                              vec, st);
    case 32:
      return launch_walk_trunc_group_w<T, 32>(wt, r, u, tau, rows, out, Bt, ncols, nb,
                                              vec, st);
    case 64:
      return launch_walk_trunc_group_w<T, 64>(wt, r, u, tau, rows, out, Bt, ncols, nb,
                                              vec, st);
    case 128:
      return launch_walk_trunc_group_w<T, 128>(wt, r, u, tau, rows, out, Bt, ncols, nb,
                                               vec, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

size_t trunc_smem_bytes(int ncols, int nb, int W, int staged, int list_cap) {
  return sizeof(float) *
         (static_cast<size_t>(kRedFloats) + trunc_scratch_floats(nb, W, list_cap) +
          (staged ? ncols : 0));
}

template <typename T, typename USrc>
int launch_fused_trunc_t(const void* w, USrc usrc, const void* params,
                         void* out, int B, int ncols, int nb, int W, int iters,
                         int staged, int list_cap, cudaStream_t st) {
  const size_t smem = trunc_smem_bytes(ncols, nb, W, staged, list_cap);
  cudaError_t e = cudaFuncSetAttribute(
      fused_trunc_draw_kernel<T, USrc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_trunc_draw_kernel<T, USrc><<<B, kTruncThreads, smem, st>>>(
      static_cast<const T*>(w), usrc, static_cast<const float*>(params),
      static_cast<int*>(out), ncols, nb, W, iters, staged, list_cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename USrc>
int launch_fused_trunc(const void* w, USrc usrc, const void* params, void* out,
                       int B, int ncols, int nb, int W, int iters, int staged,
                       int list_cap, int dtype, cudaStream_t st) {
  if (list_cap != 0 && list_cap < kBins)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return launch_fused_trunc_t<__nv_bfloat16>(w, usrc, params, out, B, ncols,
                                               nb, W, iters, staged, list_cap, st);
  return launch_fused_trunc_t<float>(w, usrc, params, out, B, ncols, nb, W,
                                     iters, staged, list_cap, st);
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Every function launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" {

// params: (B, 3) float32 [top_k, top_p, min_p]; staged: 1 to stage each row
// in shared memory (the wrapper checks that it fits), 0 to read it from
// global memory on every pass; list_cap: the top-p survivor list's floats
// (>= 256) for the radix-select body, 0 for the bisection body.
int fused_trunc_draw(const void* w, const void* u, const void* params,
                     void* out, int B, int ncols, int nb, int W, int iters,
                     int staged, int list_cap, int dtype, void* stream) {
  if (B <= 0) return 0;
  return launch_fused_trunc(w, ArrayU{static_cast<const float*>(u)}, params, out,
                            B, ncols, nb, W, iters, staged, list_cap, dtype,
                            static_cast<cudaStream_t>(stream));
}

// K10: (s0, s1) the seed already folded with TAG_U; row r draws with the
// uniform of global row row_offset + r (mod 2^32).
int fused_trunc_draw_rng(const void* w, const void* params, void* out, int B,
                         int ncols, int nb, int W, int iters, int staged,
                         int list_cap, unsigned s0, unsigned s1,
                         unsigned row_offset, int dtype, void* stream) {
  if (B <= 0) return 0;
  return launch_fused_trunc(w, ThreefryU{s0, s1, row_offset}, params, out, B,
                            ncols, nb, W, iters, staged, list_cap, dtype,
                            static_cast<cudaStream_t>(stream));
}

// arrived: B uint32 zeros (each row's block count; the kernel leaves them
// zero again).
int masked_blocksums(const void* w, const void* tau, void* running,
                     void* arrived, int B, int ncols, int nb, int W, int dtype,
                     void* stream) {
  if (B <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const float* tt = static_cast<const float*>(tau);
  float* r = static_cast<float*>(running);
  unsigned* a = static_cast<unsigned*>(arrived);
  const int tpb = split_tiles_per_block(B, nb, W);
  const int nt = (nb * W + kTile - 1) / kTile;
  const size_t smem = sizeof(float) * split_sum_floats(nb, W, tpb);
  const dim3 grid(B, (nt + tpb - 1) / tpb);
  if (dtype == 1)
    masked_blocksums_kernel<__nv_bfloat16><<<grid, kSumThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(w), tt, r, a, ncols, nb, W, tpb);
  else
    masked_blocksums_kernel<float><<<grid, kSumThreads, smem, st>>>(
        static_cast<const float*>(w), tt, r, a, ncols, nb, W, tpb);
  return static_cast<int>(cudaGetLastError());
}

// group: 0 for the warp layout, 1 for the group layout (W / 4 lanes per
// draw, no shared memory).
int walk_trunc(const void* w, const void* running, const void* u,
               const void* tau, const void* rows, void* out, int Bt, int ncols,
               int nb, int W, int group, int dtype, void* stream) {
  if (Bt <= 0) return 0;
  const size_t smem = sizeof(float) * kWarps * W;
  auto st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(running);
  const float* uu = static_cast<const float*>(u);
  const float* tt = static_cast<const float*>(tau);
  const int* rw = static_cast<const int*>(rows);
  int* o = static_cast<int*>(out);
  if (group) {
    if (dtype == 1)
      return launch_walk_trunc_group<__nv_bfloat16>(w, r, uu, tt, rw, o, Bt, ncols, nb, W,
                                                    st);
    return launch_walk_trunc_group<float>(w, r, uu, tt, rw, o, Bt, ncols, nb, W, st);
  }
  if (dtype == 1)
    walk_trunc_kernel<__nv_bfloat16><<<grid_for(Bt), kWarps * 32, smem, st>>>(
        static_cast<const __nv_bfloat16*>(w), r, uu, tt, rw, o, Bt, ncols, nb,
        W);
  else
    walk_trunc_kernel<float><<<grid_for(Bt), kWarps * 32, smem, st>>>(
        static_cast<const float*>(w), r, uu, tt, rw, o, Bt, ncols, nb, W);
  return static_cast<int>(cudaGetLastError());
}

// Threads per block of K9; the wrapper decides from it whether a row can be
// staged in shared memory.
int butterfly_trunc_threads(void) { return kTruncThreads; }

}  // extern "C"
