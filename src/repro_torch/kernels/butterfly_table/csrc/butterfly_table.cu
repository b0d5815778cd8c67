// The paper's butterfly-patterned partial-sums table (Alg. 8) for Hopper
// (sm_90a), in the paper's own GPU form: W lanes of a warp hold one W x W
// block of samples x categories and exchange values with __shfl_xor_sync.
//
// Replaces the TPU kernel of src/repro/kernels/butterfly_table/kernel.py:
//   butterfly_table  <- _table_kernel  (butterfly_table_pallas)  K1
//
// Design.  A group of W samples is handled by W lanes (a warp segment;
// for W < 32, 32 / W groups share a warp).  Lane r holds a[k] = weight of
// sample k at category r of the block, so each of the W loads is
// coalesced along r; register k then holds sample k ("transposed"
// products, Alg. 8 lines 9-18).  The log2(W) rounds of the replacement
// [[a,b],[c,d]] -> [[a,d],[a+b,c+d]] (lines 20-31) run on registers
// indexed by constants only: W is a template parameter and every loop is
// unrolled.  Lane r carries sample r's running prefix through the nb
// blocks in order, as the TPU kernel's carry_ref does across its
// sequential grid axis (lines 33-34).  Adds are pinned with __fadd_rn so
// the table equals the plain PyTorch version (core.build_butterfly_table)
// bit for bit wherever their adds agree, and the closed form on integer
// weights.
//
// W = 64 and 128.  One lane still keeps W floats in registers, but a
// block's W lanes span W / 32 warps, so one thread block holds one group:
// the rounds with bit < 32 stay __shfl_xor_sync inside a warp, and the
// rounds with bit >= 32 exchange through shared memory between the warps
// of the block (at most W / 64 values per lane per round), with a barrier
// before each read and before the next write.  Two schedules: serial, one
// block per group walking its nb blocks in order, and split, a group's
// blocks built by several thread blocks with no carry, then the running
// row added by a second kernel in the serial order (see the split kernels
// below); the wrapper picks one (kernel.table_schedule).  The wrapper
// rejects any W that is not a power of two in [2, 128].
//
// Layouts.  layout 0 writes the reference's (B, K) table: block (g, c)
// at rows g*W.., columns c*W..; layout 1 writes (G, nb, W, W), the form
// the butterfly search reads, so no permuted copy is made.
//
// Bound.  Memory: every weight is read once (4 or 2 bytes) and every
// table entry written once (4 bytes); the (W/2) log2(W) adds per lane and
// block are far below the fp32 rate.  The split schedule's second kernel
// reads and writes row W - 1 again: 2 / W of the table more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "draw_tile.cuh"

namespace {

constexpr int kWarps = 4;  // warps per block

using draw_tile::kFullMask;
using draw_tile::to_f32;

__host__ __device__ constexpr int ilog2(int w) {
  return w <= 1 ? 0 : 1 + ilog2(w >> 1);
}

template <typename T, int W, bool BLOCKS>
__global__ void __launch_bounds__(kWarps * 32)
    butterfly_table_kernel(const T* __restrict__ w, float* __restrict__ out,
                           int G, int nb) {
  constexpr int kGroups = 32 / W;  // sample groups per warp
  constexpr int kLog2 = ilog2(W);
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp * kGroups >= G) return;  // warp-uniform
  const int r = lane & (W - 1);     // category within the block
  const int g = warp * kGroups + lane / W;
  // a segment past the last group still shuffles (zeros), never stores
  const bool valid = g < G;
  const int Kp = nb * W;
  const size_t row0 = static_cast<size_t>(valid ? g : 0) * W;
  float carry = 0.f;
  for (int c = 0; c < nb; ++c) {
    float a[W];
#pragma unroll
    for (int k = 0; k < W; ++k)
      a[k] = valid ? to_f32(w[(row0 + k) * Kp + c * W + r]) : 0.f;
#pragma unroll
    for (int b = 0; b < kLog2; ++b) {
      const int bit = 1 << b;
      const bool has = (r & bit) != 0;
#pragma unroll
      for (int i = 0; i < W / (2 * bit); ++i) {
        const int d = bit - 1 + 2 * bit * i;
        const float ad = a[d];
        const float adb = a[d + bit];
        // h = (r & bit) ? a[d] : a[d+bit]; v = shuffleXor(h, bit)
        const float v = __shfl_xor_sync(kFullMask, has ? ad : adb, bit, W);
        // if (r & bit) a[d] <- a[d+bit]; a[d+bit] <- a[d] + v
        const float nd = has ? adb : ad;
        a[d] = nd;
        a[d + bit] = __fadd_rn(nd, v);
      }
    }
    carry = __fadd_rn(carry, a[W - 1]);  // sample r's running prefix
    a[W - 1] = carry;
    if (valid) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const size_t idx =
            BLOCKS ? ((static_cast<size_t>(g) * nb + c) * W + i) * W + r
                   : (row0 + i) * Kp + c * W + r;
        out[idx] = a[i];
      }
    }
  }
}

// The log2(W) rounds of one W x W block held by the W threads of a block
// (W in {64, 128}; thread r holds a[k] = sample k at category r): the
// rounds with bit < 32 are __shfl_xor_sync inside a warp, those with
// bit >= 32 exchange through xs ((W / 64) * W floats of shared memory),
// with a barrier before each read and before the next write.  a[W - 1]
// ends as sample r's block total.
template <int W>
__device__ __forceinline__ void wide_rounds(float (&a)[W], int r, float* xs) {
  constexpr int kLog2 = ilog2(W);
#pragma unroll
  for (int b = 0; b < kLog2; ++b) {
    const int bit = 1 << b;
    const bool has = (r & bit) != 0;
    if (bit < 32) {
#pragma unroll
      for (int i = 0; i < W / (2 * bit); ++i) {
        const int d = bit - 1 + 2 * bit * i;
        const float ad = a[d];
        const float adb = a[d + bit];
        const float v = __shfl_xor_sync(kFullMask, has ? ad : adb, bit);
        const float nd = has ? adb : ad;
        a[d] = nd;
        a[d + bit] = __fadd_rn(nd, v);
      }
    } else {
      constexpr int kMaxPairs = W / 64;
      const int pairs = W / (2 * bit);
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        if (i < pairs) {
          const int d = bit - 1 + 2 * bit * i;
          xs[i * W + r] = has ? a[d] : a[d + bit];
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kMaxPairs; ++i) {
        if (i < pairs) {
          const int d = bit - 1 + 2 * bit * i;
          const float v = xs[i * W + (r ^ bit)];
          const float nd = has ? a[d + bit] : a[d];
          a[d] = nd;
          a[d + bit] = __fadd_rn(nd, v);
        }
      }
      __syncthreads();
    }
  }
}

// Block (g, c) of the table from thread r's registers, in either layout.
template <int W, bool BLOCKS>
__device__ __forceinline__ void wide_store(float* __restrict__ out, const float (&a)[W],
                                           int g, int c, int nb, int r) {
  const int Kp = nb * W;
  const size_t row0 = static_cast<size_t>(g) * W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const size_t idx = BLOCKS ? ((static_cast<size_t>(g) * nb + c) * W + i) * W + r
                              : (row0 + i) * Kp + c * W + r;
    out[idx] = a[i];
  }
}

// Serial schedule, W in {64, 128}: one group of W samples per thread block
// of W threads; thread r is the group's lane r (category r of each block)
// and carries sample r's running prefix through the nb blocks in order.
template <typename T, int W, bool BLOCKS>
__global__ void __launch_bounds__(W)
    butterfly_table_wide_kernel(const T* __restrict__ w,
                                float* __restrict__ out, int nb) {
  __shared__ float xs[(W / 64) * W];  // exchange rows for bit >= 32
  const int r = threadIdx.x;
  const int g = blockIdx.x;
  const int Kp = nb * W;
  const size_t row0 = static_cast<size_t>(g) * W;
  float carry = 0.f;
  for (int c = 0; c < nb; ++c) {
    float a[W];
#pragma unroll
    for (int k = 0; k < W; ++k) a[k] = to_f32(w[(row0 + k) * Kp + c * W + r]);
    wide_rounds<W>(a, r, xs);
    carry = __fadd_rn(carry, a[W - 1]);  // sample r's running prefix
    a[W - 1] = carry;
    wide_store<W, BLOCKS>(out, a, g, c, nb, r);
  }
}

// Split schedule, W in {64, 128}.  The serial schedule walks a group's nb
// blocks on one SM (at G = 1, one of 132; 2.8 us a block at W = 128 on the
// H100).  The split runs in two kernels:
//
// Pass 1, butterfly_table_split_kernel on a (G, P) grid of W threads a
// block: block (g, p) builds blocks [p * run, (p + 1) * run) of group g
// with the serial schedule's rounds and no carry, so row W - 1 of each
// block holds its own totals.  P is sized by split_run: kSplitThreadsPerSM
// threads on every SM, which __launch_bounds__ lets reside (168 registers
// a thread at W = 128).
//
// Pass 2, butterfly_table_carry_kernel on a (G, W / kCarryLanes) grid of
// kCarryThreads threads: block (g, y) owns lanes kCarryLanes * y .. + 7 of
// group g's running row (32 bytes of each block's row W - 1).  Its
// threads copy up to kCarryChunk blocks' totals into shared memory with
// 16-byte loads, kCarryLoads in flight a thread; then thread r < kCarryLanes adds
// carry = __fadd_rn(carry, total[c]) for c = 0 .. nb - 1 in order, and
// every thread writes the running sums back.  These are the serial
// schedule's adds in its order, so both schedules give the same table bit
// for bit, whatever P is.
constexpr int kSplitThreadsPerSM = 384;  // resident pass-1 threads per SM
constexpr int kCarryLanes = 8;           // running-row lanes per pass-2 block
constexpr int kCarryThreads = 256;
constexpr int kCarryChunk = 4096;        // blocks' totals staged at once (128 KB)
constexpr int kCarryLoads = 16;          // 16-byte loads in flight per thread
constexpr int kCarryBatch = 16;          // totals read ahead of the adds

template <typename T, int W, bool BLOCKS>
__global__ void __launch_bounds__(W, kSplitThreadsPerSM / W)
    butterfly_table_split_kernel(const T* __restrict__ w, float* __restrict__ out,
                                 int nb, int run) {
  __shared__ float xs[(W / 64) * W];
  const int r = threadIdx.x;
  const int g = blockIdx.x;
  const int c0 = blockIdx.y * run;
  const int c1 = c0 + run < nb ? c0 + run : nb;
  const int Kp = nb * W;
  const size_t row0 = static_cast<size_t>(g) * W;
  for (int c = c0; c < c1; ++c) {
    float a[W];
#pragma unroll
    for (int k = 0; k < W; ++k) a[k] = to_f32(w[(row0 + k) * Kp + c * W + r]);
    wide_rounds<W>(a, r, xs);
    wide_store<W, BLOCKS>(out, a, g, c, nb, r);
  }
}

template <int W, bool BLOCKS>
__global__ void __launch_bounds__(kCarryThreads)
    butterfly_table_carry_kernel(float* __restrict__ out, int nb) {
  extern __shared__ float4 s4[];  // block c's 8 totals at s4[2c], s4[2c + 1]
  // row W - 1 of block c, lane kCarryLanes * y + j, is at base[c * kStride + j]
  constexpr size_t kStride = BLOCKS ? W * W : W;
  const int tid = threadIdx.x;
  const size_t g = blockIdx.x;
  float* base = out + (BLOCKS ? (g * nb * W + (W - 1)) * W : (g * W + (W - 1)) * nb * W) +
                blockIdx.y * kCarryLanes;
  float* s = reinterpret_cast<float*>(s4);
  float carry = 0.f;
  for (int c0 = 0; c0 < nb; c0 += kCarryChunk) {
    const int n = nb - c0 < kCarryChunk ? nb - c0 : kCarryChunk;
    for (int e0 = tid; e0 < 2 * n; e0 += kCarryThreads * kCarryLoads) {
      float4 v[kCarryLoads];
#pragma unroll
      for (int i = 0; i < kCarryLoads; ++i) {
        const int e = e0 + i * kCarryThreads;
        if (e < 2 * n)
          v[i] = *reinterpret_cast<const float4*>(base + (c0 + e / 2) * kStride + (e & 1) * 4);
      }
#pragma unroll
      for (int i = 0; i < kCarryLoads; ++i) {
        const int e = e0 + i * kCarryThreads;
        if (e < 2 * n) s4[e] = v[i];
      }
    }
    __syncthreads();
    if (tid < kCarryLanes) {
      float v[kCarryBatch];
#pragma unroll
      for (int i = 0; i < kCarryBatch; ++i) v[i] = i < n ? s[i * kCarryLanes + tid] : 0.f;
      for (int i0 = 0; i0 < n; i0 += kCarryBatch) {
        float next[kCarryBatch];  // the next batch's reads ahead of this one's adds
#pragma unroll
        for (int i = 0; i < kCarryBatch; ++i) {
          const int c = i0 + kCarryBatch + i;
          next[i] = c < n ? s[c * kCarryLanes + tid] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kCarryBatch; ++i) {
          if (i0 + i < n) {
            carry = __fadd_rn(carry, v[i]);
            s[(i0 + i) * kCarryLanes + tid] = carry;
          }
        }
#pragma unroll
        for (int i = 0; i < kCarryBatch; ++i) v[i] = next[i];
      }
    }
    __syncthreads();
    for (int e = tid; e < 2 * n; e += kCarryThreads)
      *reinterpret_cast<float4*>(base + (c0 + e / 2) * kStride + (e & 1) * 4) = s4[e];
    __syncthreads();
  }
}

// W-blocks a pass-1 block builds: P = ceil(kSplitThreadsPerSM / W * SMs /
// G) blocks per group fill the card once, at most one per W-block; then
// run = ceil(nb / P) and gridDim.y = ceil(nb / run).
inline int split_run(int G, int nb, int W) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long P = (static_cast<long>(kSplitThreadsPerSM / W) * sms + G - 1) / G;
  if (P > nb) P = nb;
  if (P < 1) P = 1;
  return static_cast<int>((nb + P - 1) / P);
}

template <typename T, int W, bool BLOCKS>
int launch_wide_layout(const T* src, float* dst, int G, int nb, bool split,
                       cudaStream_t st) {
  if (!split) {
    butterfly_table_wide_kernel<T, W, BLOCKS><<<G, W, 0, st>>>(src, dst, nb);
    return static_cast<int>(cudaGetLastError());
  }
  const int run = split_run(G, nb, W);
  const dim3 grid1(static_cast<unsigned>(G), static_cast<unsigned>((nb + run - 1) / run));
  butterfly_table_split_kernel<T, W, BLOCKS><<<grid1, W, 0, st>>>(src, dst, nb, run);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const size_t smem = sizeof(float) * kCarryLanes * (nb < kCarryChunk ? nb : kCarryChunk);
  const cudaError_t e = cudaFuncSetAttribute(butterfly_table_carry_kernel<W, BLOCKS>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid2(static_cast<unsigned>(G), W / kCarryLanes);
  butterfly_table_carry_kernel<W, BLOCKS><<<grid2, kCarryThreads, smem, st>>>(dst, nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int launch_wide(const void* w, void* out, int G, int nb, int layout, bool split,
                cudaStream_t st) {
  const T* src = static_cast<const T*>(w);
  float* dst = static_cast<float*>(out);
  if (layout == 1) return launch_wide_layout<T, W, true>(src, dst, G, nb, split, st);
  return launch_wide_layout<T, W, false>(src, dst, G, nb, split, st);
}

template <typename T, int W>
int launch(const void* w, void* out, int G, int nb, int layout,
           cudaStream_t st) {
  constexpr int kGroups = 32 / W;
  const int warps = (G + kGroups - 1) / kGroups;
  const unsigned grid = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  const T* src = static_cast<const T*>(w);
  float* dst = static_cast<float*>(out);
  if (layout == 1)
    butterfly_table_kernel<T, W, true><<<grid, kWarps * 32, 0, st>>>(src, dst, G, nb);
  else
    butterfly_table_kernel<T, W, false><<<grid, kWarps * 32, 0, st>>>(src, dst, G, nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_w(const void* w, void* out, int G, int nb, int W, int layout,
               bool split, cudaStream_t st) {
  if (split && W < 64) return static_cast<int>(cudaErrorInvalidValue);
  switch (W) {
    case 2: return launch<T, 2>(w, out, G, nb, layout, st);
    case 4: return launch<T, 4>(w, out, G, nb, layout, st);
    case 8: return launch<T, 8>(w, out, G, nb, layout, st);
    case 16: return launch<T, 16>(w, out, G, nb, layout, st);
    case 32: return launch<T, 32>(w, out, G, nb, layout, st);
    case 64: return launch_wide<T, 64>(w, out, G, nb, layout, split, st);
    case 128: return launch_wide<T, 128>(w, out, G, nb, layout, split, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  weights: (G * W, nb * W), dtype
// 0 = float32, 1 = bfloat16; out: float32, layout 0 = (B, K), 1 = (G, nb,
// W, W); split 0 = the serial schedule, 1 = the split schedule (W = 64 and
// 128 only; two kernels back to back).  Launches on the given stream, does
// not synchronise, and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a W outside {2, 4, 8, 16, 32, 64, 128} or a
// split below W = 64).
extern "C" {

int butterfly_table(const void* weights, void* out, int G, int nb, int W,
                    int layout, int dtype, int split, void* stream) {
  if (G <= 0 || nb <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_w<__nv_bfloat16>(weights, out, G, nb, W, layout, split != 0, st);
  return dispatch_w<float>(weights, out, G, nb, W, layout, split != 0, st);
}

}  // extern "C"
