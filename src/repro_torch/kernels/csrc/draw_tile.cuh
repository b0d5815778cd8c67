// Shared per-warp draw-tile steps for the port's Hopper draw kernels.
//
// CUDA forms of the reference's tile steps in
// src/repro/kernels/butterfly_sample/kernel.py (_select_tile,
// _fenwick_tile, _descent_tile, _draw_tile), written for one warp that
// owns one sample from start to end.  Where the TPU code used one-hot lane
// reductions in place of gathers, a warp reads shared memory or registers
// directly and combines lanes with shuffles.
//
// Arithmetic is pinned with __fmul_rn / __fadd_rn so that nvcc never
// contracts a product and a sum into one FMA: the values added, and the
// order of the Fenwick and descent adds, are those of the plain PyTorch
// versions in repro_torch/kernels/butterfly_sample/kernel.py.  Only the
// order inside a block sum (an xor-shuffle tree) and inside the running
// sum (a warp scan) differs from theirs, which matters only where
// u * total lies within fp32 rounding of a partial-sum boundary.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace draw_tile {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Row loaders: load(k) is the weight of category k of one sample's row,
// for k below the row's width.  A loader reads one element per call, so
// the lanes of a warp that call it with neighbouring k read neighbouring
// addresses (coalesced).
template <typename T>
struct ProductRow {  // w[k] = a[k] * b[k]: a theta row times a phi row
  const T* __restrict__ a;
  const T* __restrict__ b;
  __device__ __forceinline__ float operator()(int k) const {
    return __fmul_rn(to_f32(a[k]), to_f32(b[k]));
  }
};

template <typename T>
struct WeightRow {  // w[k]: one row of given weights
  const T* __restrict__ w;
  __device__ __forceinline__ float operator()(int k) const { return to_f32(w[k]); }
};

// Per-W-block sums of the loaded row w[k] over k < Kp = nb * W, with
// w[k] = 0 for k >= ncols (the zero padding of K up to a multiple of W).
// Lanes read neighbouring k (coalesced).  Block sums go to bs[0..nb); with
// STORE the loaded values also go to prod[0..Kp).  W is a power of two in
// [8, 128].  bs and prod may be shared or global memory.
template <bool STORE, typename Load>
__device__ __forceinline__ void warp_block_sums(const Load& load, int ncols,
                                                int nb, int W, float* prod,
                                                float* bs, int lane) {
  const int Kp = nb * W;
  const int kv = ncols < Kp ? ncols : Kp;
  const int g = W < 32 ? W : 32;  // lanes that share one block per step
  for (int base = 0; base < Kp; base += 32) {
    const int k = base + lane;
    float v = 0.f;
    if (k < kv) v = load(k);
    if (STORE && k < Kp) prod[k] = v;
    for (int off = 1; off < g; off <<= 1)
      v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, off));
    if ((lane & (g - 1)) == 0 && k < Kp) {
      const int c = k / W;
      // W > 32: one lane adds the block's 32-wide pieces in order
      bs[c] = (W <= 32 || (k & (W - 1)) == 0) ? v : __fadd_rn(bs[c], v);
    }
  }
  __syncwarp();
}

// Block jb of the loaded row into t[0..W), zero past the row's width.
template <typename Load>
__device__ __forceinline__ void warp_load_block(const Load& load, int ncols,
                                                int jb, int W, float* t,
                                                int lane) {
  for (int i = lane; i < W; i += 32) {
    const int k = jb * W + i;
    t[i] = k < ncols ? load(k) : 0.f;
  }
}

// In-place inclusive running sum of bs[0..nb): a warp scan over chunks of
// 32 blocks, each chunk offset by the carry of the ones before it.
__device__ __forceinline__ void warp_running(float* bs, int nb, int lane) {
  __syncwarp();
  float carry = 0.f;
  for (int base = 0; base < nb; base += 32) {
    const int c = base + lane;
    float v = c < nb ? bs[c] : 0.f;
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(kFullMask, v, off);
      if (lane >= off) v = __fadd_rn(v, n);
    }
    v = __fadd_rn(v, carry);
    if (c < nb) bs[c] = v;
    carry = __shfl_sync(kFullMask, v, 31);
  }
  __syncwarp();
}

// Block-level search (paper Alg. 9): jb = #{c : running[c] <= stop},
// clipped to nb-1, and lo = running[jb-1] (0 when jb is 0).  An all-zero
// row (stop = 0) selects the last block; no division, so no NaN.
__device__ __forceinline__ void warp_select(const float* running, int nb,
                                            float stop, int lane, int& jb,
                                            float& lo) {
  unsigned cnt = 0;
  for (int c = lane; c < nb; c += 32) cnt += running[c] <= stop ? 1u : 0u;
  cnt = __reduce_add_sync(kFullMask, cnt);
  jb = static_cast<int>(cnt) < nb - 1 ? static_cast<int>(cnt) : nb - 1;
  lo = jb > 0 ? running[jb - 1] : 0.f;
}

// Blelloch up-sweep of one W-block t[0..W) in place (Fenwick layout):
// position d with ntz(d+1) = l ends up holding S[d-2^l+1 .. d].
__device__ __forceinline__ void warp_fenwick(float* t, int W, int lane) {
  __syncwarp();
  for (int bit = 1; bit < W; bit <<= 1) {
    const int pairs = W / (2 * bit);
    for (int i = lane; i < pairs; i += 32) {
      const int hi = i * 2 * bit + 2 * bit - 1;
      t[hi] = __fadd_rn(t[hi], t[hi - bit]);
    }
    __syncwarp();
  }
}

// Add-only descent (Alg. 10, Fenwick form): log2(W) reads of the block's
// table; every lane walks it (shared-memory broadcast) and gets the same R.
__device__ __forceinline__ int descent(const float* t, float stop, float lo,
                                       int W) {
  float acc = lo;
  int R = 0;
  for (int bit = W >> 1; bit > 0; bit >>= 1) {
    const float mid = __fadd_rn(acc, t[R + bit - 1]);
    if (stop >= mid) {
      acc = mid;
      R += bit;
    }
  }
  return R;
}

// The complete draw for one sample whose products are in prod[0..Kp) and
// whose block sums are in run[0..nb) (shared memory of this warp): running
// sums, selection, Fenwick build of the selected block, descent.  Returns
// the index in [0, Kp); the caller clips it to K-1.
__device__ __forceinline__ int warp_draw_tile(float* prod, float* run, int nb,
                                              int W, float u, int lane) {
  warp_running(run, nb, lane);
  const float stop = __fmul_rn(run[nb - 1], u);
  int jb;
  float lo;
  warp_select(run, nb, stop, lane, jb, lo);
  float* t = prod + jb * W;
  warp_fenwick(t, W, lane);
  return jb * W + descent(t, stop, lo, W);
}

}  // namespace draw_tile
