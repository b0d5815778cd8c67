// Categorical draws on given weights for Hopper (sm_90a): block sums,
// block selection, a Fenwick table of the selected W-block and the
// add-only descent (paper Alg. 9/10 in the Fenwick form), one warp per
// sample.
//
// Replaces the TPU kernels of src/repro/kernels/butterfly_sample/kernel.py:
//   blocksums       <- _blocksum_kernel       (blocksums_pallas)       K2
//   walk            <- _walk_kernel           (walk_pallas)            K3
//   fused_draw      <- _fused_draw_kernel     (fused_draw_pallas)      K4
//   fused_draw_rng  <- _fused_draw_rng_kernel (fused_draw_rng_pallas)  K5
//
// Design.  These are the factored LDA kernels of lda_draw.cu with one
// row of given weights in place of a theta row times a phi row: the same
// draw_tile.cuh steps, fed by a WeightRow loader.  One warp owns one
// sample from start to end and reads its row coalesced; K is padded to
// Kp = nb * W virtually (columns at or past the row's width read as zero).
//
// K2 writes the running block sums directly (a warp scan after the
// block sums, as K6 does), so the caller's cumsum of the reference
// (_build_sums_impl) is gone.  K3 computes its block jb itself from the
// running row, so the reference's XLA block search before pass B is not
// needed; rows[s] lets S draws per row share one launch.  K4 keeps no
// copy of the row: it stages only the nb running sums and one W-block in
// shared memory ((nb + W) floats per warp) and re-reads block jb from
// global memory (still in L2), so it runs to a much larger K than K8.
// Both routes run the same sums in the same order, so they give the same
// indices.
//
// K5 is K4 with its u operand replaced by uniforms made in the kernel:
// one body (fused_draw_kernel), instantiated on its uniform source
// (threefry.cuh): ArrayU for K4, ThreefryU for K5, PhiloxU for K5 with
// hw=True.  Every lane of a sample's warp computes the sample's uniform
// (20 Threefry rounds, or 10 Philox rounds, of integer ops: far below the
// row's reads), so no shuffle is needed.  threefry_uniforms writes the
// Threefry stream alone, so that tests can hold the device cipher
// against rng.row_uniforms bit for bit; no draw path calls it.
//
// Bound.  Memory: K2, K4 and K5 read each weight once (4 or 2 bytes) and
// write 4 nb (K2) or 4 (K4, K5) bytes per row; K3 reads one running row
// and one W-block per draw.  The adds are far below the fp32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "draw_tile.cuh"
#include "threefry.cuh"

namespace {

constexpr int kWarps = 4;  // warps (samples in flight) per block

using draw_tile::warp_block_sums;
using draw_tile::warp_running;
using draw_tile::warp_walk;
using draw_tile::WeightRow;
using threefry::ArrayU;
using threefry::PhiloxU;
using threefry::ThreefryU;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    blocksums_kernel(const T* __restrict__ w, float* __restrict__ running,
                     int B, int ncols, int nb, int W) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= B) return;  // warp-uniform
  const WeightRow<T> row{w + static_cast<size_t>(s) * ncols};
  // the output row doubles as the scan buffer
  float* out = running + static_cast<size_t>(s) * nb;
  warp_block_sums<false>(row, ncols, nb, W, nullptr, out, lane);
  warp_running(out, nb, lane);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    walk_kernel(const T* __restrict__ w, const float* __restrict__ running,
                const float* __restrict__ u, const int* __restrict__ rows,
                int* __restrict__ out, int Bt, int ncols, int nb, int W) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int s = blockIdx.x * kWarps + wib;
  if (s >= Bt) return;
  const size_t r = static_cast<size_t>(rows[s]);
  const WeightRow<T> row{w + r * ncols};
  const int idx = warp_walk(row, running + r * nb, ncols, nb, W, u[s],
                           smem + wib * W, lane);
  if (lane == 0) out[s] = idx;
}

// K4 (USrc = ArrayU) and K5 (ThreefryU, PhiloxU): usrc(s) is sample s's
// uniform.
template <typename T, typename USrc>
__global__ void __launch_bounds__(kWarps * 32)
    fused_draw_kernel(const T* __restrict__ w, const USrc usrc,
                      int* __restrict__ out, int B, int ncols, int nb, int W) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int s = blockIdx.x * kWarps + wib;
  if (s >= B) return;
  float* run = smem + wib * (nb + W);
  float* t = run + nb;
  const WeightRow<T> row{w + static_cast<size_t>(s) * ncols};
  warp_block_sums<false>(row, ncols, nb, W, nullptr, run, lane);
  warp_running(run, nb, lane);
  const int idx = warp_walk(row, run, ncols, nb, W, usrc(s), t, lane);
  if (lane == 0) out[s] = idx;
}

__global__ void threefry_uniforms_kernel(ThreefryU src, float* __restrict__ out,
                                         int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = src(i);
}

inline unsigned grid_for(int n) {
  return static_cast<unsigned>((n + kWarps - 1) / kWarps);
}

template <typename USrc>
int launch_fused(const void* w, USrc usrc, void* out, int B, int ncols, int nb,
                 int W, int dtype, cudaStream_t st) {
  const size_t smem = sizeof(float) * kWarps * (nb + W);
  int* o = static_cast<int*>(out);
  if (dtype == 1)
    fused_draw_kernel<__nv_bfloat16, USrc><<<grid_for(B), kWarps * 32, smem, st>>>(
        static_cast<const __nv_bfloat16*>(w), usrc, o, B, ncols, nb, W);
  else
    fused_draw_kernel<float, USrc><<<grid_for(B), kWarps * 32, smem, st>>>(
        static_cast<const float*>(w), usrc, o, B, ncols, nb, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Every function launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" {

int blocksums(const void* w, void* running, int B, int ncols, int nb, int W,
              int dtype, void* stream) {
  if (B <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(running);
  if (dtype == 1)
    blocksums_kernel<__nv_bfloat16><<<grid_for(B), kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(w), r, B, ncols, nb, W);
  else
    blocksums_kernel<float><<<grid_for(B), kWarps * 32, 0, st>>>(
        static_cast<const float*>(w), r, B, ncols, nb, W);
  return static_cast<int>(cudaGetLastError());
}

int walk(const void* w, const void* running, const void* u, const void* rows,
         void* out, int Bt, int ncols, int nb, int W, int dtype, void* stream) {
  if (Bt <= 0) return 0;
  const size_t smem = sizeof(float) * kWarps * W;
  auto st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(running);
  const float* uu = static_cast<const float*>(u);
  const int* rw = static_cast<const int*>(rows);
  int* o = static_cast<int*>(out);
  if (dtype == 1)
    walk_kernel<__nv_bfloat16><<<grid_for(Bt), kWarps * 32, smem, st>>>(
        static_cast<const __nv_bfloat16*>(w), r, uu, rw, o, Bt, ncols, nb, W);
  else
    walk_kernel<float><<<grid_for(Bt), kWarps * 32, smem, st>>>(
        static_cast<const float*>(w), r, uu, rw, o, Bt, ncols, nb, W);
  return static_cast<int>(cudaGetLastError());
}

int fused_draw(const void* w, const void* u, void* out, int B, int ncols,
               int nb, int W, int dtype, void* stream) {
  if (B <= 0) return 0;
  return launch_fused(w, ArrayU{static_cast<const float*>(u)}, out, B, ncols, nb,
                      W, dtype, static_cast<cudaStream_t>(stream));
}

// (s0, s1): the seed already folded with TAG_U; sample s draws with the
// uniform of global row row_offset + s (mod 2^32).  hw: 1 for the Philox
// stream, 0 for Threefry.
int fused_draw_rng(const void* w, void* out, int B, int ncols, int nb, int W,
                   unsigned s0, unsigned s1, unsigned row_offset, int hw,
                   int dtype, void* stream) {
  if (B <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (hw)
    return launch_fused(w, PhiloxU{s0, s1, row_offset}, out, B, ncols, nb, W,
                        dtype, st);
  return launch_fused(w, ThreefryU{s0, s1, row_offset}, out, B, ncols, nb, W,
                      dtype, st);
}

// out[i] = uniform(seed, (row0 + i, 0)) for i < n: rng.row_uniforms.
int threefry_uniforms(void* out, int n, unsigned s0, unsigned s1, unsigned row0,
                      void* stream) {
  if (n <= 0) return 0;
  threefry_uniforms_kernel<<<(n + 255) / 256, 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      ThreefryU{s0, s1, row0}, static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// Warps per block; the wrapper sizes the fused draw's shared memory
// (kWarps * (nb + W) floats) from it to pick the fused or two-pass route.
int butterfly_sample_warps_per_block(void) { return kWarps; }

}  // extern "C"
