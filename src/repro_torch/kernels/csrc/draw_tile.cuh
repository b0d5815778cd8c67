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
//
// Besides the one-warp-per-sample steps, two layouts that other kernels
// share: a row split over several thread blocks (tile_block_sums,
// split_row_running; K4/K5's split layout and K11), which keeps one
// warp's order of every sum, and a draw walked by a group of W / 4 lanes
// (group_walk; K3), which makes exactly warp_walk's adds.
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
// w[k] = 0 for k >= ncols (the zero padding of K up to a multiple of W),
// over a strided share of the row: this warp sums units u0, u0 + ustep,
// ... of max(W, 32) columns each (one block for W >= 32, 32 / W blocks
// below), so the warps of a thread block can split one row and still
// write the values one warp (u0 = 0, ustep = 1) would.  Lanes read
// neighbouring k (coalesced).  Block sums go to bs[0..nb); with STORE the
// loaded values also go to prod[0..Kp).  W is a power of two in [8, 128].
// bs and prod may be shared or global memory.
template <bool STORE, typename Load>
__device__ __forceinline__ void warp_block_sums_strided(const Load& load,
                                                        int ncols, int nb,
                                                        int W, float* prod,
                                                        float* bs, int lane,
                                                        int u0, int ustep) {
  const int Kp = nb * W;
  const int kv = ncols < Kp ? ncols : Kp;
  const int g = W < 32 ? W : 32;  // lanes that share one block per step
  const int unit = W < 32 ? 32 : W;
  for (int ub = u0 * unit; ub < Kp; ub += ustep * unit) {
    for (int base = ub; base < ub + unit && base < Kp; base += 32) {
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
  }
  __syncwarp();
}

// The whole row by one warp.
template <bool STORE, typename Load>
__device__ __forceinline__ void warp_block_sums(const Load& load, int ncols,
                                                int nb, int W, float* prod,
                                                float* bs, int lane) {
  warp_block_sums_strided<STORE>(load, ncols, nb, W, prod, bs, lane, 0, 1);
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

// Select, Fenwick and descend for one sample whose running row is run
// (the walk of pass B): block jb of the loaded row goes to t[0..W).
// Returns the index in [0, Kp); the caller clips it to K-1.
template <typename Load>
__device__ __forceinline__ int warp_walk(const Load& row, const float* run,
                                         int ncols, int nb, int W, float u,
                                         float* t, int lane) {
  const float stop = __fmul_rn(run[nb - 1], u);
  int jb;
  float lo;
  warp_select(run, nb, stop, lane, jb, lo);
  warp_load_block(row, ncols, jb, W, t, lane);
  warp_fenwick(t, W, lane);
  return jb * W + descent(t, stop, lo, W);
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

// ---------------------------------------------------------------------------
// A row split over several thread blocks
// ---------------------------------------------------------------------------

constexpr int kTile = 128;            // columns a warp sums at once
constexpr int kSumThreads = 256;      // threads per block of a split row
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kSumBlocksPerSM = 8;    // blocks per SM the (B, P) grid aims at
constexpr int kMinBlocksPerRun = 32;  // least W-blocks a block sums
constexpr int kScanChunk = 4096;      // most sums the scanning block holds at once

// The W-block sums of columns [kTile * t, kTile * t + kTile) of a row (W
// divides kTile; columns at or past kv load as zero; blocks at or past
// Kp = nb * W are not written), by one warp with the arithmetic of
// warp_block_sums_strided: each 32-column piece an xor tree over min(W, 32)
// lanes, a block's pieces added in order.  The four pieces are loaded
// before any is summed.  Block c goes to bs[c - c0].
template <typename Load>
__device__ __forceinline__ void tile_block_sums(const Load& row, int t, int kv,
                                                int Kp, int W, float* bs,
                                                int c0, int lane) {
  const int k0 = kTile * t;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 32 * i + lane;
    v[i] = k < kv ? row(k) : 0.f;
  }
  const int g = W < 32 ? W : 32;  // lanes that share one block per piece
#pragma unroll
  for (int i = 0; i < 4; ++i)
    for (int off = 1; off < g; off <<= 1)
      v[i] = __fadd_rn(v[i], __shfl_xor_sync(kFullMask, v[i], off));
  if (W < 32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + 32 * i + lane;
      if ((lane & (g - 1)) == 0 && k < Kp) bs[k / W - c0] = v[i];
    }
  } else if (lane == 0) {
    const int c = k0 / W - c0;
    if (W == 32) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (k0 + 32 * i < Kp) bs[c + i] = v[i];
    } else if (W == 64) {
      if (k0 < Kp) bs[c] = __fadd_rn(v[0], v[1]);
      if (k0 + 64 < Kp) bs[c + 1] = __fadd_rn(v[2], v[3]);
    } else if (k0 < Kp) {  // W = 128
      bs[c] = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), v[2]), v[3]);
    }
  }
}

// warp_running over bs[0..n) with the carry of the sums before it; returns
// the carry after.  Chunks of n that are multiples of 32 chain into
// warp_running's order over the whole row.
__device__ __forceinline__ float warp_running_from(float* bs, int n, int lane,
                                                   float carry) {
  for (int base = 0; base < n; base += 32) {
    const int c = base + lane;
    float v = c < n ? bs[c] : 0.f;
    for (int off = 1; off < 32; off <<= 1) {
      const float x = __shfl_up_sync(kFullMask, v, off);
      if (lane >= off) v = __fadd_rn(v, x);
    }
    v = __fadd_rn(v, carry);
    if (c < n) bs[c] = v;
    carry = __shfl_sync(kFullMask, v, 31);
  }
  __syncwarp();
  return carry;
}

// Tiles per block of a row split over the (B, P) grid: P so that the grid
// fills the card (kSumBlocksPerSM blocks on every SM) while each block
// keeps at least kMinBlocksPerRun W-blocks and at most about kScanChunk.
inline int split_tiles_per_block(int B, int nb, int W) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int nt = (nb * W + kTile - 1) / kTile;
  int P = (kSumBlocksPerSM * sms + B - 1) / B;
  if (P > nb / kMinBlocksPerRun) P = nb / kMinBlocksPerRun;
  const int least = (nb + kScanChunk - 1) / kScanChunk;
  if (P < least) P = least;
  if (P < 1) P = 1;
  return (nt + P - 1) / P;
}

// Floats of the split row's shared buffer: one block's run of W-block
// sums, or one chunk of the scan, whichever is larger.
__host__ __device__ inline int split_sum_floats(int nb, int W, int tpb) {
  const int run_blocks = tpb * (kTile / W);
  const int scan = nb < kScanChunk ? nb : kScanChunk;
  return run_blocks > scan ? run_blocks : scan;
}

// The running W-block sums of one row by a split over gridDim.y blocks of
// kSumThreads threads: block p sums the W-blocks of tiles [p * tpb,
// (p + 1) * tpb) (a tile is kTile columns, one warp per tile) into sbs,
// writes them to out, and takes the row's arrival counter after a
// __threadfence.  The last block to arrive scans the row with
// warp_running's order, kScanChunk sums at a time through sbs, writes the
// running sums to out, leaves the counter at zero for the next launch and
// returns true; the others return false.  When nb <= kScanChunk, sbs then
// holds the whole running row too.  sbs holds split_sum_floats(nb, W, tpb)
// floats.
template <typename Load>
__device__ __forceinline__ bool split_row_running(const Load& row, float* out,
                                                  unsigned* arrived, int ncols,
                                                  int nb, int W, int tpb,
                                                  float* sbs) {
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Kp = nb * W;
  const int kv = ncols < Kp ? ncols : Kp;
  const int nt = (Kp + kTile - 1) / kTile;
  const int t0 = blockIdx.y * tpb;
  const int t1 = t0 + tpb < nt ? t0 + tpb : nt;
  const int c0 = t0 * (kTile / W);  // first W-block of this run
  const int c1 = t1 * (kTile / W) < nb ? t1 * (kTile / W) : nb;
  for (int ti = t0 + warp; ti < t1; ti += kSumWarps)
    tile_block_sums(row, ti, kv, Kp, W, sbs, c0, lane);
  __syncthreads();
  for (int i = tid; i < c1 - c0; i += kSumThreads) out[c0 + i] = sbs[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrived, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return false;
  __threadfence();
  if (tid == 0) *arrived = 0u;  // ready for the next launch
  float carry = 0.f;
  for (int c = 0; c < nb; c += kScanChunk) {
    const int n = nb - c < kScanChunk ? nb - c : kScanChunk;
    for (int i = tid; i < n; i += kSumThreads) sbs[i] = __ldcg(out + c + i);
    __syncthreads();
    if (warp == 0) carry = warp_running_from(sbs, n, lane, carry);
    __syncthreads();
    for (int i = tid; i < n; i += kSumThreads) out[c + i] = sbs[i];
    __syncthreads();
  }
  return true;
}

// ---------------------------------------------------------------------------
// One draw per group of W / 4 lanes
// ---------------------------------------------------------------------------

// Four consecutive weights w[0..3] as floats.  VEC: one 16-byte load (8
// for bf16), which needs w 16-byte (8-byte) aligned; else four loads.
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ w, float (&e)[4]) {
  if (VEC) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(w));
    e[0] = x.x; e[1] = x.y; e[2] = x.z; e[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = w[i];
  }
}

template <bool VEC>
__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ w,
                                      float (&e)[4]) {
  if (VEC) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(w));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
    e[0] = __low2float(a); e[1] = __high2float(a);
    e[2] = __low2float(b); e[3] = __high2float(b);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = to_f32(w[i]);
  }
}

// warp_walk for one sample by a group of G = W / 4 lanes (the group is
// aligned in its warp, every lane of the warp calls this): q = lane % G.
// The group counts #{c : run[c] <= stop} over its lanes (exact, so in any
// order); lane q holds weights 4q..4q+3 of block jb of row w (zero past
// ncols; VEC: ncols % 4 == 0 and w aligned for load4).  The Fenwick
// up-sweep makes warp_fenwick's adds (t[hi] += t[hi - bit]), the first two
// levels inside each lane and the others as shuffles up by bit / 4 lanes;
// the descent makes descent()'s log2(W) compares from lo, reading t[R + bit
// - 1] from its lane (element 3 while bit >= 4, then 1, then 0 or 2).  So
// the index equals warp_walk's bit for bit.  Returns it in [0, Kp).
template <int W, bool VEC, typename T>
__device__ __forceinline__ int group_walk(const T* __restrict__ w,
                                          const float* __restrict__ run,
                                          int ncols, int nb, float u, int q) {
  constexpr int G = W / 4;
  static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0, "W in [8, 128]");
  const float stop = __fmul_rn(run[nb - 1], u);
  unsigned cnt = 0;
#pragma unroll 4
  for (int c = q; c < nb; c += G) cnt += run[c] <= stop ? 1u : 0u;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    cnt += __shfl_xor_sync(kFullMask, cnt, off, G);
  const int jb = static_cast<int>(cnt) < nb - 1 ? static_cast<int>(cnt) : nb - 1;
  const float lo = jb > 0 ? run[jb - 1] : 0.f;
  const int k0 = jb * W + 4 * q;
  float e[4];
  if (VEC) {
    if (k0 < ncols) {
      load4<true>(w + k0, e);
    } else {
      e[0] = e[1] = e[2] = e[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = k0 + i < ncols ? to_f32(w[k0 + i]) : 0.f;
  }
  // Fenwick up-sweep: bit = 1 and 2 inside the lane, then bit = 4 b
  e[1] = __fadd_rn(e[1], e[0]);
  e[3] = __fadd_rn(e[3], e[2]);
  e[3] = __fadd_rn(e[3], e[1]);
#pragma unroll
  for (int b = 1; b < G; b <<= 1) {
    const float x = __shfl_up_sync(kFullMask, e[3], b, G);
    if (((q + 1) & (2 * b - 1)) == 0) e[3] = __fadd_rn(e[3], x);
  }
  // descent from lo
  float acc = lo;
  int R = 0;
#pragma unroll
  for (int bit = W >> 1; bit >= 4; bit >>= 1) {
    const float y = __shfl_sync(kFullMask, e[3], (R + bit - 1) >> 2, G);
    const float mid = __fadd_rn(acc, y);
    if (stop >= mid) {
      acc = mid;
      R += bit;
    }
  }
  const int L = R >> 2;  // bit = 2 reads t[R + 1], bit = 1 t[R] or t[R + 2]
  const float y1 = __shfl_sync(kFullMask, e[1], L, G);
  const float y0 = __shfl_sync(kFullMask, e[0], L, G);
  const float y2 = __shfl_sync(kFullMask, e[2], L, G);
  float mid = __fadd_rn(acc, y1);
  if (stop >= mid) {
    acc = mid;
    R += 2;
  }
  mid = __fadd_rn(acc, (R & 2) ? y2 : y0);
  if (stop >= mid) R += 1;
  return jb * W + R;
}

// ---------------------------------------------------------------------------
// Four columns a lane: K2's split layout, K8's and K7's group layouts
// ---------------------------------------------------------------------------
//
// The helpers below are K2's, K8's and K7's group layout's alone (K7's
// group layout runs the group_walk overload over a running row in global
// memory); the functions above, which K3, K4/K5, K6, K7's warp layout and
// K9-K11 run, are not routed through them.  A lane holds four
// consecutive columns and adds them as (e0 + e1) + (e2 + e3):
// the first two levels of a 32-lane xor tree over one column a lane, which
// is the balanced pairwise tree in index order.  xor shuffles over the
// lanes of each 32-column piece make its other three levels, and a W-block
// of several pieces adds them in order.  So every block sum is
// warp_block_sums_strided's (and tile_block_sums') bit for bit.

// True when every row of a (rows, ncols) array at w starts 16-byte aligned
// (8-byte for bf16): ncols % 4 == 0 and an aligned base, so that load4 may
// read a lane's four columns at once.  The launchers pick a loader's VEC
// instantiation with it.
template <typename T>
inline bool rows_aligned(const T* w, int ncols) {
  return ncols % 4 == 0 && reinterpret_cast<size_t>(w) % (4 * sizeof(T)) == 0;
}

// 4-wide row loaders: load(k0, e) sets e[0..3] to the weights of columns
// k0..k0+3 (k0 % 4 == 0), zero past ncols.  VEC: one load4 per operand,
// which needs ncols % 4 == 0 and aligned row starts (a lane's four columns
// are then all in the row or all past it); else four loads, each checked
// against ncols.
template <typename T, bool VEC>
struct WeightRow4 {  // w[k]: one row of given weights (K2)
  const T* __restrict__ w;
  int ncols;
  __device__ __forceinline__ void operator()(int k0, float (&e)[4]) const {
    if (VEC) {
      if (k0 < ncols) {
        load4<true>(w + k0, e);
      } else {
        e[0] = e[1] = e[2] = e[3] = 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = k0 + i < ncols ? to_f32(w[k0 + i]) : 0.f;
    }
  }
};

template <typename T, bool VEC>
struct ProductRow4 {  // w[k] = a[k] * b[k], as ProductRow forms it (K8)
  const T* __restrict__ a;
  const T* __restrict__ b;
  int ncols;
  __device__ __forceinline__ void operator()(int k0, float (&e)[4]) const {
    if (VEC) {
      if (k0 < ncols) {
        float x[4], y[4];
        load4<true>(a + k0, x);
        load4<true>(b + k0, y);
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = __fmul_rn(x[i], y[i]);
      } else {
        e[0] = e[1] = e[2] = e[3] = 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[i] = k0 + i < ncols ? __fmul_rn(to_f32(a[k0 + i]), to_f32(b[k0 + i])) : 0.f;
    }
  }
};

// The sum of one W-block by its G = W / 4 lanes (aligned in the warp, lane
// q of the block holding e = columns 4q..4q+3; every lane of the warp calls
// this): in-lane pairs, xor shuffles over each 32-column piece's
// P = min(G, 8) lanes, then the pieces in order.  The block's lane 0 gets
// the sum.
__device__ __forceinline__ float block_sum4(const float (&e)[4], int W, int lane) {
  const int G = W / 4;
  const int P = G < 8 ? G : 8;
  float v = __fadd_rn(__fadd_rn(e[0], e[1]), __fadd_rn(e[2], e[3]));
  for (int off = 1; off < P; off <<= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, off));
  if (G > P) {  // W > 32: the block's pieces in order
    const int base = lane & ~(G - 1);
    float t = __shfl_sync(kFullMask, v, base);
    for (int i = 1; i < G / P; ++i) t = __fadd_rn(t, __shfl_sync(kFullMask, v, base + i * P));
    v = t;
  }
  return v;
}

// K2's split: the W-block sums of tiles t and t + kSumWarps (a tile at or
// past t1 is skipped) from four columns a lane, both tiles' loads issued
// before either is summed; the sums of tile_block_sums bit for bit.  Block
// c goes to bs[c - c0].
template <typename Load4>
__device__ __forceinline__ void tile_pair_block_sums4(const Load4& row, int t, int t1,
                                                      int Kp, int W, float* bs, int c0,
                                                      int lane) {
  float e[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int tj = t + j * kSumWarps;
    if (tj < t1) {
      row(kTile * tj + 4 * lane, e[j]);
    } else {
      e[j][0] = e[j][1] = e[j][2] = e[j][3] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int tj = t + j * kSumWarps;
    const float v = block_sum4(e[j], W, lane);
    const int k = kTile * tj + 4 * lane;
    if (tj < t1 && (lane & (W / 4 - 1)) == 0 && k < Kp) bs[k / W - c0] = v;
  }
}

// warp_running_from over bs[0..n) (n <= kScanChunk) by every warp of a
// kSumThreads block, with the carry of the sums before it; returns the
// carry after.  Each warp scans chunks of 32 with warp_running's
// Hillis-Steele adds and leaves the chunk's total in cr[chunk + 1]; one
// thread chains the totals (the carry after chunk k is its total plus the
// carry before it, as warp_running_from's lane 31 forms it); then every
// sum adds the carry before its chunk.  So every sum is warp_running_from's
// bit for bit.  cr: n / 32 + 1 floats of shared memory.  Every thread of
// the block calls this; it ends with a __syncthreads.
__device__ __forceinline__ float block_running_from(float* bs, int n, float carry,
                                                    float* cr) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int g = (tid >> 5) * 32; g < n; g += kSumThreads) {
    float v = g + lane < n ? bs[g + lane] : 0.f;
    for (int off = 1; off < 32; off <<= 1) {
      const float x = __shfl_up_sync(kFullMask, v, off);
      if (lane >= off) v = __fadd_rn(v, x);
    }
    if (g + lane < n) bs[g + lane] = v;
    if (lane == 31) cr[g / 32 + 1] = v;
  }
  __syncthreads();
  const int nc = (n + 31) / 32;
  if (tid == 0) {
    float c = carry;
    cr[0] = c;
    for (int k = 1; k <= nc; ++k) {
      c = __fadd_rn(cr[k], c);
      cr[k] = c;
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += kSumThreads) bs[i] = __fadd_rn(bs[i], cr[i / 32]);
  const float after = cr[nc];
  __syncthreads();
  return after;
}

// split_row_running with tile_pair_block_sums4 in place of tile_block_sums
// and block_running_from in place of warp 0's warp_running_from (K2's
// split layout): the same runs of tiles per block, the same arrival
// counter, the same adds in the last block's scan, so the same running
// sums bit for bit.  row is a 4-wide loader.
template <typename Load4>
__device__ __forceinline__ void split_row_running4(const Load4& row, float* out,
                                                   unsigned* arrived, int nb, int W,
                                                   int tpb, float* sbs) {
  __shared__ bool last;
  __shared__ float cr[kScanChunk / 32 + 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Kp = nb * W;
  const int nt = (Kp + kTile - 1) / kTile;
  const int t0 = blockIdx.y * tpb;
  const int t1 = t0 + tpb < nt ? t0 + tpb : nt;
  const int c0 = t0 * (kTile / W);
  const int c1 = t1 * (kTile / W) < nb ? t1 * (kTile / W) : nb;
  for (int ti = t0 + warp; ti < t1; ti += 2 * kSumWarps)
    tile_pair_block_sums4(row, ti, t1, Kp, W, sbs, c0, lane);
  __syncthreads();
  for (int i = tid; i < c1 - c0; i += kSumThreads) out[c0 + i] = sbs[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrived, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) *arrived = 0u;  // ready for the next launch
  float carry = 0.f;
  for (int c = 0; c < nb; c += kScanChunk) {
    const int n = nb - c < kScanChunk ? nb - c : kScanChunk;
    for (int i = tid; i < n; i += kSumThreads) sbs[i] = __ldcg(out + c + i);
    __syncthreads();
    carry = block_running_from(sbs, n, carry, cr);
    for (int i = tid; i < n; i += kSumThreads) out[c + i] = sbs[i];
    __syncthreads();
  }
}

// K8's group layout: the nb W-block sums of one row by a group of G = W / 4
// lanes (aligned in its warp; every lane of the warp calls this with the
// same nb), lane q holding columns 4q..4q+3 of each block; the loads of
// kGroupBatch blocks are issued before the first of them is summed.  The
// group's lane 0 writes block c's sum to bs[c] (this group's shared
// memory).
constexpr int kGroupBatch = 8;

template <int W, typename Load4>
__device__ __forceinline__ void group_block_sums(const Load4& row, int nb, float* bs,
                                                 int q) {
  const int lane = threadIdx.x & 31;
  for (int b0 = 0; b0 < nb; b0 += kGroupBatch) {
    float e[kGroupBatch][4];
#pragma unroll
    for (int i = 0; i < kGroupBatch; ++i) {
      if (b0 + i < nb) {
        row((b0 + i) * W + 4 * q, e[i]);
      } else {
        e[i][0] = e[i][1] = e[i][2] = e[i][3] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kGroupBatch; ++i) {
      const float v = block_sum4(e[i], W, lane);
      if (q == 0 && b0 + i < nb) bs[b0 + i] = v;
    }
  }
  __syncwarp();
}

// warp_running over bs[0..nb) (this group's shared memory) by its G lanes:
// each chunk of 32 takes the Hillis-Steele levels off = 1 .. 16, element j
// of the chunk adding element j - off of the level before (j >= off), lane
// q doing elements q, q + G, ...; then the carry of the chunks before.
// These are warp_running's adds bit for bit.
template <int G>
__device__ __forceinline__ void group_running(float* bs, int nb, int q) {
  constexpr int R = 32 / G;  // chunk elements per lane
  float carry = 0.f;
  for (int base = 0; base < nb; base += 32) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float v[R];
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int j = s * G + q;
        const int c = base + j;
        v[s] = c < nb ? (j >= off ? __fadd_rn(bs[c], bs[c - off]) : bs[c]) : 0.f;
      }
      __syncwarp();
#pragma unroll
      for (int s = 0; s < R; ++s)
        if (base + s * G + q < nb) bs[base + s * G + q] = v[s];
      __syncwarp();
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int c = base + s * G + q;
      if (c < nb) bs[c] = __fadd_rn(bs[c], carry);
    }
    __syncwarp();
    if (base + 32 < nb) carry = bs[base + 31];
  }
}

// group_walk with a 4-wide loader (K8: the products of block jb, formed
// again from the factors): the same count, Fenwick up-sweep and descent,
// so the index equals warp_walk's bit for bit.  run may be shared memory.
template <int W, typename Load4>
__device__ __forceinline__ int group_walk(const Load4& row,
                                          const float* __restrict__ run, int nb,
                                          float u, int q) {
  constexpr int G = W / 4;
  static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0, "W in [8, 128]");
  const float stop = __fmul_rn(run[nb - 1], u);
  unsigned cnt = 0;
#pragma unroll 4
  for (int c = q; c < nb; c += G) cnt += run[c] <= stop ? 1u : 0u;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    cnt += __shfl_xor_sync(kFullMask, cnt, off, G);
  const int jb = static_cast<int>(cnt) < nb - 1 ? static_cast<int>(cnt) : nb - 1;
  const float lo = jb > 0 ? run[jb - 1] : 0.f;
  float e[4];
  row(jb * W + 4 * q, e);
  // Fenwick up-sweep: bit = 1 and 2 inside the lane, then bit = 4 b
  e[1] = __fadd_rn(e[1], e[0]);
  e[3] = __fadd_rn(e[3], e[2]);
  e[3] = __fadd_rn(e[3], e[1]);
#pragma unroll
  for (int b = 1; b < G; b <<= 1) {
    const float x = __shfl_up_sync(kFullMask, e[3], b, G);
    if (((q + 1) & (2 * b - 1)) == 0) e[3] = __fadd_rn(e[3], x);
  }
  // descent from lo
  float acc = lo;
  int R = 0;
#pragma unroll
  for (int bit = W >> 1; bit >= 4; bit >>= 1) {
    const float y = __shfl_sync(kFullMask, e[3], (R + bit - 1) >> 2, G);
    const float mid = __fadd_rn(acc, y);
    if (stop >= mid) {
      acc = mid;
      R += bit;
    }
  }
  const int L = R >> 2;  // bit = 2 reads t[R + 1], bit = 1 t[R] or t[R + 2]
  const float y1 = __shfl_sync(kFullMask, e[1], L, G);
  const float y0 = __shfl_sync(kFullMask, e[0], L, G);
  const float y2 = __shfl_sync(kFullMask, e[2], L, G);
  float mid = __fadd_rn(acc, y1);
  if (stop >= mid) {
    acc = mid;
    R += 2;
  }
  mid = __fadd_rn(acc, (R & 2) ? y2 : y0);
  if (stop >= mid) R += 1;
  return jb * W + R;
}

}  // namespace draw_tile
