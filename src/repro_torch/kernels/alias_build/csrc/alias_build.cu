// Closed-form alias table assembly (the split-based PSA build) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/alias_build/kernel.py:
//   alias_assemble  <- _assemble_kernel (alias_assemble_pallas)  K13
//
// Per row of lights-then-heavies scaled weights s (Kp columns), with the
// light count nL and the merged sweep rank of every position (both made
// outside the kernel, as in the reference), the kernel computes _assemble:
//   cs   = inclusive prefix sum of s,   csL = sum of the lights' s,
//   light  (pos < nL): prob = min(s, 1),
//                      apos = min(nL + rank - pos, Kp - 1);
//   heavy  (pos >= nL): j = pos - nL, i = clip(rank - j, 0, nL),
//                      r = (cs[i-1] (0 when i = 0) + (cs - csL)) - (i + j),
//                      prob = clip(r, 0, 1), apos = min(pos + 1, Kp - 1).
//
// Three layouts of the same adds (the wrapper's alias_layout picks one):
//
// block (the first port, any Kp).  One thread block per row.  The TPU
// kernel gathers PL(i) = cs[i-1] with one-hot lane buckets
// (_gather_rows_blocked), a Mosaic idiom; here it is a direct read.  The
// scan runs in chunks of kThreads * kItems columns: each thread scans
// kItems consecutive values, a warp scan (shfl_up) and the warps' totals in
// order give the chunk's prefix, and a carry joins the chunks.  cs goes to
// a scratch row in global memory (the wrapper allocates it), from which
// the gather reads.  csL: each thread slot sums its lights across the
// chunks in order, an xor tree sums a warp's slots, the warps' sums are
// added in order.  Adds are pinned with __fadd_rn/__fsub_rn; the scan
// order differs from torch.cumsum's, so prob differs from the plain
// version by rounding of sums over up to Kp terms, while apos (integer
// arithmetic on nL and rank) is exact.
//
// group (Kp a power of two, 4 <= Kp <= 1,024: one chunk a row).  A group of
// Kp / 4 lanes a row, kThreads * 4 / Kp rows a block: the block layout
// leaves 192 of its 256 threads idle at Kp = 256.  A lane loads its four
// columns of s and rank as one float4 and one int4, scans them in the block
// layout's order (the warp scan and the light xor tree only over the
// group's lanes: the lanes and warps the block layout adds past the row's
// data hold +0, and x + +0 = x for every sum here, none of which is -0),
// keeps the row's cs in shared memory for the gather, and stores prob and
// apos as 16-byte stores.  No cs scratch.
//
// split (Kp a multiple of 1,024, more than one chunk).  The block layout
// walks a row's Kp / 1,024 chunks on one SM, a load round trip and three
// barriers a chunk.  Its adds need no block-wide step: a warp's scan and
// its slots' light chains are the warp's own, and only the carry and csL
// join the warps.  So the split runs three kernels:
//   walk:  one warp per (row, warp slot q), 8 a row, walks the chunks in
//          order, two batches of kWalkUnroll chunks' loads in flight: the
//          light chain, the warp scan, and per chunk the terms the carry
//          adds (warp q's total; for q = 7 the last slot's shfl_up term and
//          its sum), each slot's shfl_up term, the light entries' prob and
//          apos, and at the end the warp's light xor tree;
//   chain: one warp per row stages the carry terms in shared memory, one
//          lane adds the carries chunk by chunk in the block layout's order
//          (9 adds a chunk);
//   heavy: the heavy entries, a few blocks per row: cs at the entry and at
//          i - 1 rebuilt from the carry, the warp totals, the slot's term
//          and its float4 of s, in the block layout's order.
// So every add of the block layout is made with the same operands in the
// same order, and the three layouts agree bit for bit
// (alias_build.ref.assemble_{block,group,split}_order_torch model them).
//
// Bound: device memory, 16 bytes an entry (s and rank read, prob and apos
// written).  The block layout adds 8 (its cs scratch written and read);
// the group layout moves the 16; the split adds 1 (the slot terms) and
// the heavies' rebuilds (a few L2 reads each).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    alias_assemble_kernel(const float* __restrict__ s,
                          const int* __restrict__ nL_rows,
                          const int* __restrict__ rank,
                          float* __restrict__ prob, int* __restrict__ apos,
                          float* __restrict__ cs, int Kp) {
  __shared__ float wsum[kWarps];
  __shared__ float bcast;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t off = static_cast<size_t>(blockIdx.x) * Kp;
  const float* sr = s + off;
  float* csr = cs + off;
  const int nL = nL_rows[blockIdx.x];

  // inclusive scan of the row into csr, and the lights' sum
  float carry = 0.f;
  float light = 0.f;
  for (int base = 0; base < Kp; base += kThreads * kItems) {
    const int k0 = base + tid * kItems;
    float x[kItems];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = k0 + i;
      const float v = k < Kp ? sr[k] : 0.f;
      if (k < nL) light = __fadd_rn(light, v);
      acc = __fadd_rn(acc, v);
      x[i] = acc;
    }
    float incl = acc;  // warp-inclusive scan of the thread totals
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, n);
    }
    const float up = __shfl_up_sync(kFullMask, incl, 1);
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    float before = carry;
    for (int i = 0; i < warp; ++i) before = __fadd_rn(before, wsum[i]);
    if (lane > 0) before = __fadd_rn(before, up);  // exclusive in the warp
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = k0 + i;
      if (k < Kp) csr[k] = __fadd_rn(before, x[i]);
    }
    if (tid == kThreads - 1) bcast = __fadd_rn(before, acc);
    __syncthreads();
    carry = bcast;
    __syncthreads();
  }
  // csL: block sum of the per-thread light sums (warps in order)
  for (int o = 16; o > 0; o >>= 1)
    light = __fadd_rn(light, __shfl_xor_sync(kFullMask, light, o));
  if (lane == 0) wsum[warp] = light;
  __syncthreads();
  float csL = 0.f;
  for (int i = 0; i < kWarps; ++i) csL = __fadd_rn(csL, wsum[i]);

  for (int pos = tid; pos < Kp; pos += kThreads) {
    const int rk = rank[off + pos];
    if (pos < nL) {
      prob[off + pos] = fminf(sr[pos], 1.f);
      const int q = nL + (rk - pos);
      apos[off + pos] = q < Kp - 1 ? q : Kp - 1;
    } else {
      const int j = pos - nL;
      int i = rk - j;
      i = i < 0 ? 0 : (i > nL ? nL : i);
      const float PLi = i > 0 ? csr[i - 1] : 0.f;
      const float r = __fsub_rn(__fadd_rn(PLi, __fsub_rn(csr[pos], csL)),
                                static_cast<float>(i + j));
      prob[off + pos] = fminf(fmaxf(r, 0.f), 1.f);
      apos[off + pos] = pos + 1 < Kp - 1 ? pos + 1 : Kp - 1;
    }
  }
}


// ---------------------------------------------------------------------------
// group and split layouts
// ---------------------------------------------------------------------------

// prob and apos of a light entry (pos < nL)
__device__ __forceinline__ float light_prob(float v) { return fminf(v, 1.f); }
__device__ __forceinline__ int light_apos(int rk, int pos, int nL, int Kp) {
  const int q = nL + (rk - pos);
  return q < Kp - 1 ? q : Kp - 1;
}

// i = clip(rank - j, 0, nL) of a heavy entry, j = pos - nL
__device__ __forceinline__ int heavy_i(int rk, int j, int nL) {
  const int i = rk - j;
  return i < 0 ? 0 : (i > nL ? nL : i);
}

// prob of a heavy entry from cs at the entry, PL(i) and csL
__device__ __forceinline__ float heavy_prob(float PLi, float cs, float csL, int i, int j) {
  const float r = __fsub_rn(__fadd_rn(PLi, __fsub_rn(cs, csL)), static_cast<float>(i + j));
  return fminf(fmaxf(r, 0.f), 1.f);
}

__device__ __forceinline__ int heavy_apos(int pos, int Kp) {
  return pos + 1 < Kp - 1 ? pos + 1 : Kp - 1;
}

// Group layout: L = Kp / 4 lanes a row (L a power of two, 1 .. 256).
template <int L>
__global__ void __launch_bounds__(kThreads)
    alias_group_kernel(const float* __restrict__ s, const int* __restrict__ nL_rows,
                       const int* __restrict__ rank, float* __restrict__ prob,
                       int* __restrict__ apos, int B) {
  constexpr int Kp = kItems * L;
  constexpr int kRows = kThreads / L;
  constexpr int kGroupWarps = L >= 32 ? L / 32 : 1;
  constexpr int kLaneMask = L >= 32 ? 31 : L - 1;
  __shared__ __align__(16) float cs_s[kRows * Kp];  // 4 KB at every L
  __shared__ float wsum[kWarps];
  __shared__ float lsum[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = tid / L;            // the block's row
  const int gl = tid % L;           // lane in the group: columns 4 gl .. 4 gl + 3
  const int wl = lane & kLaneMask;  // lane in the group's part of the warp
  const int row = blockIdx.x * kRows + g;
  const bool live = row < B;
  const size_t off = static_cast<size_t>(row) * Kp;
  const int nL = live ? nL_rows[row] : 0;
  float4 v4 = make_float4(0.f, 0.f, 0.f, 0.f);
  int4 r4 = make_int4(0, 0, 0, 0);
  if (live) {
    v4 = reinterpret_cast<const float4*>(s + off)[gl];
    r4 = reinterpret_cast<const int4*>(rank + off)[gl];
  }
  const float v[kItems] = {v4.x, v4.y, v4.z, v4.w};
  const int rk[kItems] = {r4.x, r4.y, r4.z, r4.w};
  const int k0 = gl * kItems;

  float x[kItems];
  float acc = 0.f;
  float light = 0.f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (k0 + i < nL) light = __fadd_rn(light, v[i]);
    acc = __fadd_rn(acc, v[i]);
    x[i] = acc;
  }
  float incl = acc;  // the group's inclusive scan of the lane totals
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(kFullMask, incl, o);
    if (wl >= o) incl = __fadd_rn(incl, n);
  }
  const float up = __shfl_up_sync(kFullMask, incl, 1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)  // the group's lights, an xor tree
    if (o <= kLaneMask) light = __fadd_rn(light, __shfl_xor_sync(kFullMask, light, o));
  if (lane == 31) wsum[warp] = incl;
  if (lane == 0) lsum[warp] = light;
  __syncthreads();
  const int w0 = warp - warp % kGroupWarps;  // the group's first warp
  float before = 0.f;  // the carry into the row's one chunk
  for (int i = w0; i < warp; ++i) before = __fadd_rn(before, wsum[i]);
  if (wl > 0) before = __fadd_rn(before, up);  // exclusive in the warp
  float cs[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) cs[i] = __fadd_rn(before, x[i]);
  reinterpret_cast<float4*>(cs_s + g * Kp)[gl] = make_float4(cs[0], cs[1], cs[2], cs[3]);
  float csL = 0.f;
  if (L < 32) {
    csL = __fadd_rn(csL, light);  // every lane of the group holds the sum
  } else {
    for (int i = w0; i < w0 + kGroupWarps; ++i) csL = __fadd_rn(csL, lsum[i]);
  }
  __syncthreads();
  if (!live) return;

  const float* csr = cs_s + g * Kp;
  float p[kItems];
  int a[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int pos = k0 + i;
    if (pos < nL) {
      p[i] = light_prob(v[i]);
      a[i] = light_apos(rk[i], pos, nL, Kp);
    } else {
      const int j = pos - nL;
      const int ii = heavy_i(rk[i], j, nL);
      p[i] = heavy_prob(ii > 0 ? csr[ii - 1] : 0.f, cs[i], csL, ii, j);
      a[i] = heavy_apos(pos, Kp);
    }
  }
  reinterpret_cast<float4*>(prob + off)[gl] = make_float4(p[0], p[1], p[2], p[3]);
  reinterpret_cast<int4*>(apos + off)[gl] = make_int4(a[0], a[1], a[2], a[3]);
}

constexpr int kChunk = kThreads * kItems;  // columns a chunk (1,024)
constexpr int kTStride = 16;               // floats a chunk's carry terms take
constexpr int kWalkWarps = 2;              // warps a walk block
constexpr int kWalkUnroll = 8;             // chunks a walk lane loads ahead

// The split's scratch, carved in this order from one float buffer of
// B * (Kp / 4 + (kTStride + 1) * Kp / kChunk + kWarps) floats (the
// wrapper's _split_work_floats):
struct SplitWork {
  float* up;     // (B, Kp / 4): each slot's shfl_up term, chunk by chunk
  float* T;      // (B, nc, kTStride): warp totals 0..6, then the last
                 // slot's shfl_up term and its own sum
  float* carry;  // (B, nc): the carry into each chunk
  float* lw;     // (B, kWarps): each warp's light sum
};

inline SplitWork split_work(float* base, int B, int Kp) {
  const size_t nc = static_cast<size_t>(Kp / kChunk);
  SplitWork w;
  w.up = base;
  w.T = w.up + static_cast<size_t>(B) * (Kp / kItems);
  w.carry = w.T + static_cast<size_t>(B) * nc * kTStride;
  w.lw = w.carry + static_cast<size_t>(B) * nc;
  return w;
}

// One walk lane's state: its row and thread slot, where it reads and
// writes, and its light chain.
struct WalkLane {
  const float4* s4;  // s[row, 4 t ..], chunk c at s4[c * kThreads]
  const int4* r4;
  float4* p4;
  int4* a4;
  float* prob;  // the row's
  int* apos;
  float* T;     // the row's carry terms
  float* U;     // the slot's shfl_up terms, chunk c at U[c * kThreads]
  int t, q, lane, nc, nL, Kp;
  float light;
};

// Load chunks c0 .. c0 + kWalkUnroll - 1 (those < nc): s, and rank where a
// light needs it.
__device__ __forceinline__ void walk_load(const WalkLane& w, int c0, float4 (&vb)[kWalkUnroll],
                                          int4 (&rb)[kWalkUnroll]) {
#pragma unroll
  for (int u = 0; u < kWalkUnroll; ++u) {
    const int c = c0 + u;
    vb[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    rb[u] = make_int4(0, 0, 0, 0);
    if (c < w.nc) vb[u] = w.s4[static_cast<size_t>(c) * kThreads];
    if (c < w.nc && c * kChunk + w.t * kItems < w.nL)
      rb[u] = w.r4[static_cast<size_t>(c) * kThreads];
  }
}

// The block layout's chunk body for one warp slot, chunks c0 .. (< nc):
// the light chain, the slot's sum, the warp scan; the carry terms, the
// shfl_up terms and the lights' prob and apos stored.
__device__ __forceinline__ void walk_chunks(WalkLane& w, int c0,
                                            const float4 (&vb)[kWalkUnroll],
                                            const int4 (&rb)[kWalkUnroll]) {
#pragma unroll
  for (int u = 0; u < kWalkUnroll; ++u) {
    const int c = c0 + u;
    if (c >= w.nc) break;
    const int k0 = c * kChunk + w.t * kItems;
    const float v[kItems] = {vb[u].x, vb[u].y, vb[u].z, vb[u].w};
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (k0 + i < w.nL) w.light = __fadd_rn(w.light, v[i]);
      acc = __fadd_rn(acc, v[i]);
    }
    float incl = acc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(kFullMask, incl, o);
      if (w.lane >= o) incl = __fadd_rn(incl, n);
    }
    const float up = __shfl_up_sync(kFullMask, incl, 1);
    w.U[static_cast<size_t>(c) * kThreads] = up;
    if (w.lane == 31) {
      float* Tc = w.T + static_cast<size_t>(c) * kTStride;
      if (w.q < kWarps - 1) {
        Tc[w.q] = incl;
      } else {
        Tc[kWarps - 1] = up;
        Tc[kWarps] = acc;
      }
    }
    const int rk[kItems] = {rb[u].x, rb[u].y, rb[u].z, rb[u].w};
    if (k0 + kItems <= w.nL) {
      w.p4[static_cast<size_t>(c) * kThreads] = make_float4(
          light_prob(v[0]), light_prob(v[1]), light_prob(v[2]), light_prob(v[3]));
      w.a4[static_cast<size_t>(c) * kThreads] = make_int4(
          light_apos(rk[0], k0, w.nL, w.Kp), light_apos(rk[1], k0 + 1, w.nL, w.Kp),
          light_apos(rk[2], k0 + 2, w.nL, w.Kp), light_apos(rk[3], k0 + 3, w.nL, w.Kp));
    } else if (k0 < w.nL) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        if (k0 + i < w.nL) {
          w.prob[k0 + i] = light_prob(v[i]);
          w.apos[k0 + i] = light_apos(rk[i], k0 + i, w.nL, w.Kp);
        }
      }
    }
  }
}

// One warp per (row, warp slot q), the row's chunks in order, two batches
// of kWalkUnroll chunks' loads in flight (the next loaded while this one
// is scanned).
__global__ void __launch_bounds__(32 * kWalkWarps)
    alias_split_walk_kernel(const float* __restrict__ s, const int* __restrict__ nL_rows,
                            const int* __restrict__ rank, float* __restrict__ prob,
                            int* __restrict__ apos, SplitWork wk, int B, int Kp) {
  const int gw = blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  const int row = gw / kWarps;
  if (row >= B) return;
  WalkLane w;
  w.q = gw % kWarps;  // the block layout's warp
  w.lane = threadIdx.x & 31;
  w.t = w.q * 32 + w.lane;  // the block layout's thread slot
  w.nc = Kp / kChunk;
  w.nL = nL_rows[row];
  w.Kp = Kp;
  const size_t off = static_cast<size_t>(row) * Kp;
  w.s4 = reinterpret_cast<const float4*>(s + off) + w.t;
  w.r4 = reinterpret_cast<const int4*>(rank + off) + w.t;
  w.p4 = reinterpret_cast<float4*>(prob + off) + w.t;
  w.a4 = reinterpret_cast<int4*>(apos + off) + w.t;
  w.prob = prob + off;
  w.apos = apos + off;
  w.T = wk.T + static_cast<size_t>(row) * w.nc * kTStride;
  w.U = wk.up + static_cast<size_t>(row) * (Kp / kItems) + w.t;
  w.light = 0.f;

  float4 va[kWalkUnroll], vb[kWalkUnroll];
  int4 ra[kWalkUnroll], rb[kWalkUnroll];
  walk_load(w, 0, va, ra);
  for (int c0 = 0; c0 < w.nc; c0 += 2 * kWalkUnroll) {
    walk_load(w, c0 + kWalkUnroll, vb, rb);
    walk_chunks(w, c0, va, ra);
    walk_load(w, c0 + 2 * kWalkUnroll, va, ra);
    walk_chunks(w, c0 + kWalkUnroll, vb, rb);
  }
  for (int o = 16; o > 0; o >>= 1)
    w.light = __fadd_rn(w.light, __shfl_xor_sync(kFullMask, w.light, o));
  if (w.lane == 0) wk.lw[static_cast<size_t>(row) * kWarps + w.q] = w.light;
}

constexpr int kChainWarps = 4;   // rows a chain block
constexpr int kChainTile = 64;   // chunks a chain warp stages at a time
constexpr int kChainTerms = 12;  // floats staged a chunk: the 9 terms, as 3 float4

// One warp per row: the warp stages kChainTile chunks' carry terms in shared
// memory, then its first lane adds them in the block layout's order.
__global__ void __launch_bounds__(32 * kChainWarps)
    alias_split_chain_kernel(SplitWork wk, int B, int Kp) {
  __shared__ __align__(16) float tile[kChainWarps][kChainTile * kChainTerms];
  const int lane = threadIdx.x & 31;
  const int wp = threadIdx.x >> 5;
  const int row = blockIdx.x * kChainWarps + wp;
  if (row >= B) return;
  const int nc = Kp / kChunk;
  const float* T = wk.T + static_cast<size_t>(row) * nc * kTStride;
  float* carry_r = wk.carry + static_cast<size_t>(row) * nc;
  float4* tile4 = reinterpret_cast<float4*>(tile[wp]);
  float carry = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kChainTile) {
    const int n = nc - c0 < kChainTile ? nc - c0 : kChainTile;
#pragma unroll
    for (int k = 0; k < kChainTile * 3 / 32; ++k) {
      const int e = k * 32 + lane;  // float4 e: chunk e / 3, terms 4 (e % 3) ..
      if (e < n * 3)
        tile4[e] = reinterpret_cast<const float4*>(
            T + static_cast<size_t>(c0 + e / 3) * kTStride)[e % 3];
    }
    __syncwarp();
    if (lane == 0) {
      for (int c = 0; c < n; ++c) {
        const float* Tc = tile[wp] + c * kChainTerms;
        carry_r[c0 + c] = carry;
        float before = carry;
#pragma unroll
        for (int i = 0; i < kWarps - 1; ++i) before = __fadd_rn(before, Tc[i]);
        before = __fadd_rn(before, Tc[kWarps - 1]);  // the last slot's shfl_up term
        carry = __fadd_rn(before, Tc[kWarps]);       // and its own sum
      }
    }
    __syncwarp();
  }
}

// cs[p] of one row, rebuilt in the block layout's order: the carry into p's
// chunk, the earlier warps' totals, the slot's shfl_up term (not for a
// warp's first lane) and the slot's own sum up to p.
__device__ __forceinline__ float split_cs(const float* s_row, const float* T,
                                          const float* carry, const float* U, int p) {
  const int c = p / kChunk;
  const int t = (p % kChunk) / kItems;
  const int e = p % kItems;
  const float* Tc = T + static_cast<size_t>(c) * kTStride;
  float before = carry[c];
#pragma unroll
  for (int i = 0; i < kWarps - 1; ++i)  // the earlier warps' totals, loaded together
    if (i < (t >> 5)) before = __fadd_rn(before, Tc[i]);
  if ((t & 31) > 0) before = __fadd_rn(before, U[static_cast<size_t>(c) * kThreads + t]);
  const float4 v = reinterpret_cast<const float4*>(s_row)[p / kItems];
  float x = __fadd_rn(0.f, v.x);
  if (e > 0) x = __fadd_rn(x, v.y);
  if (e > 1) x = __fadd_rn(x, v.z);
  if (e > 2) x = __fadd_rn(x, v.w);
  return __fadd_rn(before, x);
}

__global__ void __launch_bounds__(kThreads)
    alias_split_heavy_kernel(const float* __restrict__ s, const int* __restrict__ nL_rows,
                             const int* __restrict__ rank, float* __restrict__ prob,
                             int* __restrict__ apos, SplitWork wk, int Kp) {
  const int row = blockIdx.y;
  const int nc = Kp / kChunk;
  const int nL = nL_rows[row];
  const size_t off = static_cast<size_t>(row) * Kp;
  const float* lw = wk.lw + static_cast<size_t>(row) * kWarps;
  float csL = 0.f;
  for (int i = 0; i < kWarps; ++i) csL = __fadd_rn(csL, lw[i]);
  const float* T = wk.T + static_cast<size_t>(row) * nc * kTStride;
  const float* carry = wk.carry + static_cast<size_t>(row) * nc;
  const float* U = wk.up + static_cast<size_t>(row) * (Kp / kItems);
  for (int pos = nL + blockIdx.x * kThreads + threadIdx.x; pos < Kp;
       pos += gridDim.x * kThreads) {
    const int j = pos - nL;
    const int i = heavy_i(rank[off + pos], j, nL);
    const float PLi = i > 0 ? split_cs(s + off, T, carry, U, i - 1) : 0.f;
    prob[off + pos] = heavy_prob(PLi, split_cs(s + off, T, carry, U, pos), csL, i, j);
    apos[off + pos] = heavy_apos(pos, Kp);
  }
}

template <int L>
int launch_group(const float* s, const int* nL, const int* rank, float* prob, int* apos,
                 int B, cudaStream_t st) {
  constexpr int kRows = kThreads / L;
  alias_group_kernel<L><<<(B + kRows - 1) / kRows, kThreads, 0, st>>>(s, nL, rank, prob,
                                                                      apos, B);
  return static_cast<int>(cudaGetLastError());
}

int launch_split(const float* s, const int* nL, const int* rank, float* prob, int* apos,
                 float* work, int B, int Kp, cudaStream_t st) {
  const SplitWork wk = split_work(work, B, Kp);
  const int walk_blocks = (B * kWarps + kWalkWarps - 1) / kWalkWarps;
  alias_split_walk_kernel<<<walk_blocks, 32 * kWalkWarps, 0, st>>>(s, nL, rank, prob, apos,
                                                                   wk, B, Kp);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  alias_split_chain_kernel<<<(B + kChainWarps - 1) / kChainWarps, 32 * kChainWarps, 0, st>>>(
      wk, B, Kp);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  // heavy blocks per row: enough for 8 blocks on every SM, at most a chunk each
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long P = (8L * sms + B - 1) / B;
  if (P > Kp / kChunk) P = Kp / kChunk;
  const dim3 grid(static_cast<unsigned>(P), static_cast<unsigned>(B));
  alias_split_heavy_kernel<<<grid, kThreads, 0, st>>>(s, nL, rank, prob, apos, wk, Kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  s: (B, Kp) float32, nL: (B,)
// int32, rank: (B, Kp) int32 -> prob (B, Kp) float32, apos (B, Kp) int32.
// layout 0 (block): work is a (B, Kp) float32 cs scratch, any Kp;
// 1 (group): no work (null), Kp a power of two in [4, 1024]; 2 (split):
// work as SplitWork says, Kp a multiple of 1,024, B <= 65,535.  Launches
// on the given stream, does not synchronise, returns cudaGetLastError() (0
// on success; cudaErrorInvalidValue for a shape the layout does not take).
extern "C" {

int alias_assemble(const void* s, const void* nL, const void* rank, void* prob,
                   void* apos, void* work, int B, int Kp, int layout, void* stream) {
  if (B <= 0 || Kp <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  const int* np = static_cast<const int*>(nL);
  const int* rp = static_cast<const int*>(rank);
  float* pp = static_cast<float*>(prob);
  int* ap = static_cast<int*>(apos);
  if (layout == 0) {
    alias_assemble_kernel<<<B, kThreads, 0, st>>>(sp, np, rp, pp, ap,
                                                  static_cast<float*>(work), Kp);
    return static_cast<int>(cudaGetLastError());
  }
  if (layout == 1) {
    switch (Kp) {
      case 4: return launch_group<1>(sp, np, rp, pp, ap, B, st);
      case 8: return launch_group<2>(sp, np, rp, pp, ap, B, st);
      case 16: return launch_group<4>(sp, np, rp, pp, ap, B, st);
      case 32: return launch_group<8>(sp, np, rp, pp, ap, B, st);
      case 64: return launch_group<16>(sp, np, rp, pp, ap, B, st);
      case 128: return launch_group<32>(sp, np, rp, pp, ap, B, st);
      case 256: return launch_group<64>(sp, np, rp, pp, ap, B, st);
      case 512: return launch_group<128>(sp, np, rp, pp, ap, B, st);
      case 1024: return launch_group<256>(sp, np, rp, pp, ap, B, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (layout == 2 && Kp % kChunk == 0 && Kp > kChunk && B <= 65535)
    return launch_split(sp, np, rp, pp, ap, static_cast<float*>(work), B, Kp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
