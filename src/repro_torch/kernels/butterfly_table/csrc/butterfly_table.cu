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
// Limit.  One lane keeps W floats in registers and the xor partner is a
// lane of the same warp, so W <= 32 (W = 64 or 128 would need shared
// memory for the rounds with bit >= 32).  The wrapper rejects larger W.
//
// Layouts.  layout 0 writes the reference's (B, K) table: block (g, c)
// at rows g*W.., columns c*W..; layout 1 writes (G, nb, W, W), the form
// the butterfly search reads, so no permuted copy is made.
//
// Bound.  Memory: every weight is read once (4 or 2 bytes) and every
// table entry written once (4 bytes); the (W/2) log2(W) adds per lane and
// block are far below the fp32 rate.

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
               cudaStream_t st) {
  switch (W) {
    case 2: return launch<T, 2>(w, out, G, nb, layout, st);
    case 4: return launch<T, 4>(w, out, G, nb, layout, st);
    case 8: return launch<T, 8>(w, out, G, nb, layout, st);
    case 16: return launch<T, 16>(w, out, G, nb, layout, st);
    case 32: return launch<T, 32>(w, out, G, nb, layout, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  weights: (G * W, nb * W), dtype
// 0 = float32, 1 = bfloat16; out: float32, layout 0 = (B, K), 1 = (G, nb,
// W, W).  Launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for a W outside
// {2, 4, 8, 16, 32}).
extern "C" {

int butterfly_table(const void* weights, void* out, int G, int nb, int W,
                    int layout, int dtype, void* stream) {
  if (G <= 0 || nb <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_w<__nv_bfloat16>(weights, out, G, nb, W, layout, st);
  return dispatch_w<float>(weights, out, G, nb, W, layout, st);
}

}  // extern "C"
