// Categorical draws on given weights for Hopper (sm_90a): block sums,
// block selection, a Fenwick table of the selected W-block and the
// add-only descent (paper Alg. 9/10 in the Fenwick form): one warp per
// row (K2, K4/K5's warp layout), several blocks per row (K2's and K4/K5's
// split layouts) or a group of W / 4 lanes per draw (K3).
//
// Replaces the TPU kernels of src/repro/kernels/butterfly_sample/kernel.py:
//   blocksums       <- _blocksum_kernel       (blocksums_pallas)       K2
//   walk            <- _walk_kernel           (walk_pallas)            K3
//   fused_draw      <- _fused_draw_kernel     (fused_draw_pallas)      K4
//   fused_draw_rng  <- _fused_draw_rng_kernel (fused_draw_rng_pallas)  K5
//
// Design.  These are the factored LDA kernels of lda_draw.cu with one
// row of given weights in place of a theta row times a phi row: the same
// draw_tile.cuh steps, fed by a WeightRow loader.  K is padded to Kp = nb
// * W virtually (columns at or past the row's width read as zero).
//
// K2 writes the running block sums directly (a warp scan after the block
// sums, as K6 does), so the caller's cumsum of the reference
// (_build_sums_impl) is gone.  It has two layouts, picked by the wrapper
// from (B, nb, W):
// - warp: one warp per row, for narrow rows and many of them (the sweep's
//   chunk).
// - split: a wide row (a vocabulary) read by one warp is latency-bound
//   (5.4 ms for 64 rows of 256,000), so the row is split over a (B, P)
//   grid of 256-thread blocks with K4/K5's and K11's P and runs of tiles
//   (draw_tile.cuh's split_row_running4), the row's last block scanning in
//   place in the output with all its warps (block_running_from: one warp
//   scanning 2,000 sums alone is the launch's tail, most at small B).  A lane
//   reads four columns (one 16-byte load, 8 for bf16, where rows are
//   aligned; a four-load instantiation otherwise) and a warp has two tiles'
//   loads in flight (tile_pair_block_sums4), so more bytes are in flight
//   per SM than with one column a lane.  Its sums are tile_block_sums' bit
//   for bit and its scan makes warp_running's adds, so the layouts agree
//   bit for bit.  Each block is held to kSumBlocksPerSM blocks per SM's
//   registers.
//
// K3 computes its block jb itself from the running row, so the
// reference's XLA block search before pass B is not needed; rows[s] lets
// S draws per row share one launch.  Its work per draw is small (nb
// running sums and one W-block; 15 and 16 at the sweep's chunk) and its
// time is the latency of three dependent reads (rows[s] and u[s], the
// running row, the block), so the draws in flight set its speed: a group
// of G = W / 4 lanes owns a draw (32 / G draws per warp), each lane holding
// four consecutive weights of the block, read with one 16-byte load (8 for
// bf16) where rows are 16-byte aligned (ncols % 4 == 0) and four loads
// otherwise (a second instantiation the wrapper picks from the shape).
// The group's count, Fenwick up-sweep and descent (draw_tile.cuh's
// group_walk) make exactly warp_walk's adds, so the index is the one a
// warp per draw gives.
//
// K4 has two layouts, picked by the wrapper from (B, nb, W):
// - warp: one warp per sample, kWarps samples per block; it keeps no copy
//   of the row, only the nb running sums and one W-block in shared memory
//   ((nb + W) floats per warp), and re-reads block jb from global memory
//   (still in L2).  For narrow rows and many of them (the sweep's chunk).
// - split: a wide row (a vocabulary: 1 MB at 256,000 fp32) read by one
//   warp is latency-bound (16 of 132 SMs busy at B = 64), so the row is
//   split over a (B, P) grid of 256-thread blocks as K11 splits it
//   (draw_tile.cuh's split_row_running: 128-column tiles summed with
//   warp_block_sums_strided's arithmetic into a (B, nb) scratch, the
//   row's last block scanning in warp_running's order); then that block's
//   warp 0 runs warp_walk over the scanned row.
// Both layouts make the same adds in the same order as K2 + K3, so the
// fused and two-pass routes give the same indices, and so do the layouts.
//
// K5 is K4 with its u operand replaced by uniforms made in the kernel:
// one body per layout, instantiated on its uniform source (threefry.cuh):
// ArrayU for K4, ThreefryU for K5, PhiloxU for K5 with hw=True.  Every
// lane of the walking warp computes the sample's uniform (20 Threefry
// rounds, or 10 Philox rounds, of integer ops: far below the row's
// reads), so no shuffle is needed.  threefry_uniforms writes the Threefry
// stream alone, so that tests can hold the device cipher against
// rng.row_uniforms bit for bit; no draw path calls it.
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

using draw_tile::group_walk;
using draw_tile::kSumThreads;
using draw_tile::kTile;
using draw_tile::rows_aligned;
using draw_tile::split_row_running;
using draw_tile::split_row_running4;
using draw_tile::split_sum_floats;
using draw_tile::split_tiles_per_block;
using draw_tile::warp_block_sums;
using draw_tile::warp_running;
using draw_tile::warp_walk;
using draw_tile::WeightRow;
using draw_tile::WeightRow4;
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

// K2, split layout: block (s, p) sums the W-blocks of its run of row s's
// tiles; the row's last block scans the row in place in running.  VEC: row
// starts 16-byte aligned (8-byte for bf16), one load for a lane's four
// columns.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kSumThreads, draw_tile::kSumBlocksPerSM)
    blocksums_split_kernel(const T* __restrict__ w, float* __restrict__ running,
                           unsigned* __restrict__ arrived, int ncols, int nb, int W,
                           int tpb) {
  extern __shared__ float sbs[];
  const int s = blockIdx.x;
  split_row_running4(WeightRow4<T, VEC>{w + static_cast<size_t>(s) * ncols, ncols},
                     running + static_cast<size_t>(s) * nb, arrived + s, nb, W, tpb,
                     sbs);
}

// K3: draw s by the group of W / 4 lanes threadIdx.x / (W / 4) of its block.
template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    walk_kernel(const T* __restrict__ w, const float* __restrict__ running,
                const float* __restrict__ u, const int* __restrict__ rows,
                int* __restrict__ out, int Bt, int ncols, int nb) {
  constexpr int G = W / 4;
  constexpr int kDraws = kWarps * 32 / G;  // draws per block
  const int base = blockIdx.x * kDraws;
  if (base + (threadIdx.x & ~31) / G >= Bt) return;  // the whole warp is past Bt
  const int q = threadIdx.x & (G - 1);
  const int gid = base + threadIdx.x / G;
  // a group past Bt redoes the last draw, so every lane joins the shuffles
  const int s = gid < Bt ? gid : Bt - 1;
  const size_t r = static_cast<size_t>(rows[s]);
  const int idx = group_walk<W, VEC>(w + r * ncols, running + r * nb, ncols, nb,
                                     u[s], q);
  if (q == 0 && gid < Bt) out[s] = idx;
}

// K4 (USrc = ArrayU) and K5 (ThreefryU, PhiloxU), warp layout: usrc(s) is
// sample s's uniform.
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

// K4 and K5, split layout: block (s, p) sums its run of row s's tiles into
// scratch; the row's last block scans it and its warp 0 walks.  When nb <=
// kScanChunk the scanned row is still in shared memory and the walk reads
// it there.  t: W floats for the walk's block past the sums' buffer.
template <typename T, typename USrc>
__global__ void __launch_bounds__(kSumThreads)
    fused_draw_split_kernel(const T* __restrict__ w, const USrc usrc,
                            float* __restrict__ scratch,
                            unsigned* __restrict__ arrived,
                            int* __restrict__ out, int ncols, int nb, int W,
                            int tpb) {
  extern __shared__ float sbs[];
  const int s = blockIdx.x;
  const WeightRow<T> row{w + static_cast<size_t>(s) * ncols};
  float* run = scratch + static_cast<size_t>(s) * nb;
  if (!split_row_running(row, run, arrived + s, ncols, nb, W, tpb, sbs)) return;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float* t = sbs + split_sum_floats(nb, W, tpb);
    const float* r = nb <= draw_tile::kScanChunk ? sbs : run;
    const int idx = warp_walk(row, r, ncols, nb, W, usrc(s), t, lane);
    if (lane == 0) out[s] = idx;
  }
}

__global__ void threefry_uniforms_kernel(ThreefryU src, float* __restrict__ out,
                                         int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = src(i);
}

inline unsigned grid_for(int n) {
  return static_cast<unsigned>((n + kWarps - 1) / kWarps);
}

template <typename T>
int launch_blocksums_split(const T* w, float* running, unsigned* arrived, int B,
                           int ncols, int nb, int W, cudaStream_t st) {
  const int tpb = split_tiles_per_block(B, nb, W);
  const int nt = (nb * W + kTile - 1) / kTile;
  const size_t smem = sizeof(float) * split_sum_floats(nb, W, tpb);
  const dim3 grid(B, (nt + tpb - 1) / tpb);
  if (rows_aligned(w, ncols))
    blocksums_split_kernel<T, true><<<grid, kSumThreads, smem, st>>>(
        w, running, arrived, ncols, nb, W, tpb);
  else
    blocksums_split_kernel<T, false><<<grid, kSumThreads, smem, st>>>(
        w, running, arrived, ncols, nb, W, tpb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename USrc>
int launch_fused_t(const void* w, USrc usrc, void* out, void* scratch,
                   void* arrived, int B, int ncols, int nb, int W, int split,
                   cudaStream_t st) {
  const T* wt = static_cast<const T*>(w);
  int* o = static_cast<int*>(out);
  if (!split) {
    const size_t smem = sizeof(float) * kWarps * (nb + W);
    fused_draw_kernel<T, USrc><<<grid_for(B), kWarps * 32, smem, st>>>(
        wt, usrc, o, B, ncols, nb, W);
    return static_cast<int>(cudaGetLastError());
  }
  const int tpb = split_tiles_per_block(B, nb, W);
  const int nt = (nb * W + kTile - 1) / kTile;
  const size_t smem = sizeof(float) * (split_sum_floats(nb, W, tpb) + W);
  const dim3 grid(B, (nt + tpb - 1) / tpb);
  fused_draw_split_kernel<T, USrc><<<grid, kSumThreads, smem, st>>>(
      wt, usrc, static_cast<float*>(scratch), static_cast<unsigned*>(arrived),
      o, ncols, nb, W, tpb);
  return static_cast<int>(cudaGetLastError());
}

template <typename USrc>
int launch_fused(const void* w, USrc usrc, void* out, void* scratch,
                 void* arrived, int B, int ncols, int nb, int W, int split,
                 int dtype, cudaStream_t st) {
  if (dtype == 1)
    return launch_fused_t<__nv_bfloat16>(w, usrc, out, scratch, arrived, B, ncols,
                                         nb, W, split, st);
  return launch_fused_t<float>(w, usrc, out, scratch, arrived, B, ncols, nb, W,
                               split, st);
}

template <typename T, int W>
int launch_walk_w(const void* w, const float* running, const float* u,
                  const int* rows, int* out, int Bt, int ncols, int nb, int vec,
                  cudaStream_t st) {
  constexpr int kDraws = kWarps * 32 / (W / 4);
  const unsigned grid = static_cast<unsigned>((Bt + kDraws - 1) / kDraws);
  const T* wt = static_cast<const T*>(w);
  if (vec)
    walk_kernel<T, W, true><<<grid, kWarps * 32, 0, st>>>(wt, running, u, rows,
                                                         out, Bt, ncols, nb);
  else
    walk_kernel<T, W, false><<<grid, kWarps * 32, 0, st>>>(wt, running, u, rows,
                                                          out, Bt, ncols, nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_walk(const void* w, const float* running, const float* u,
                const int* rows, int* out, int Bt, int ncols, int nb, int W,
                int vec, cudaStream_t st) {
  switch (W) {
    case 8:
      return launch_walk_w<T, 8>(w, running, u, rows, out, Bt, ncols, nb, vec, st);
    case 16:
      return launch_walk_w<T, 16>(w, running, u, rows, out, Bt, ncols, nb, vec, st);
    case 32:
      return launch_walk_w<T, 32>(w, running, u, rows, out, Bt, ncols, nb, vec, st);
    case 64:
      return launch_walk_w<T, 64>(w, running, u, rows, out, Bt, ncols, nb, vec, st);
    case 128:
      return launch_walk_w<T, 128>(w, running, u, rows, out, Bt, ncols, nb, vec, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Every function launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" {

// split: 0 for the warp layout (arrived unused), 1 for the split layout:
// arrived B uint32 zeros (each row's block count; the kernel leaves them
// zero again).
int blocksums(const void* w, void* running, void* arrived, int B, int ncols,
              int nb, int W, int split, int dtype, void* stream) {
  if (B <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(running);
  if (split) {
    unsigned* a = static_cast<unsigned*>(arrived);
    if (dtype == 1)
      return launch_blocksums_split(static_cast<const __nv_bfloat16*>(w), r, a, B,
                                    ncols, nb, W, st);
    return launch_blocksums_split(static_cast<const float*>(w), r, a, B, ncols, nb, W,
                                  st);
  }
  if (dtype == 1)
    blocksums_kernel<__nv_bfloat16><<<grid_for(B), kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(w), r, B, ncols, nb, W);
  else
    blocksums_kernel<float><<<grid_for(B), kWarps * 32, 0, st>>>(
        static_cast<const float*>(w), r, B, ncols, nb, W);
  return static_cast<int>(cudaGetLastError());
}

// vec: 1 when every row start is 16-byte aligned (8-byte for bf16), so
// K3 reads its four weights per lane with one load; 0 for four loads.
int walk(const void* w, const void* running, const void* u, const void* rows,
         void* out, int Bt, int ncols, int nb, int W, int vec, int dtype,
         void* stream) {
  if (Bt <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(running);
  const float* uu = static_cast<const float*>(u);
  const int* rw = static_cast<const int*>(rows);
  int* o = static_cast<int*>(out);
  if (dtype == 1)
    return launch_walk<__nv_bfloat16>(w, r, uu, rw, o, Bt, ncols, nb, W, vec, st);
  return launch_walk<float>(w, r, uu, rw, o, Bt, ncols, nb, W, vec, st);
}

// split: 0 for the warp layout (scratch and arrived unused), 1 for the
// split layout: scratch (B, nb) float32, arrived B uint32 zeros (each row's
// block count; the kernel leaves them zero again).
int fused_draw(const void* w, const void* u, void* out, void* scratch,
               void* arrived, int B, int ncols, int nb, int W, int split,
               int dtype, void* stream) {
  if (B <= 0) return 0;
  return launch_fused(w, ArrayU{static_cast<const float*>(u)}, out, scratch,
                      arrived, B, ncols, nb, W, split, dtype,
                      static_cast<cudaStream_t>(stream));
}

// (s0, s1): the seed already folded with TAG_U; sample s draws with the
// uniform of global row row_offset + s (mod 2^32).  hw: 1 for the Philox
// stream, 0 for Threefry.  split, scratch, arrived: as fused_draw.
int fused_draw_rng(const void* w, void* out, void* scratch, void* arrived, int B,
                   int ncols, int nb, int W, int split, unsigned s0, unsigned s1,
                   unsigned row_offset, int hw, int dtype, void* stream) {
  if (B <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (hw)
    return launch_fused(w, PhiloxU{s0, s1, row_offset}, out, scratch, arrived, B,
                        ncols, nb, W, split, dtype, st);
  return launch_fused(w, ThreefryU{s0, s1, row_offset}, out, scratch, arrived, B,
                      ncols, nb, W, split, dtype, st);
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

// Warps per block; the wrapper sizes the fused draw's shared memory in the
// warp layout (kWarps * (nb + W) floats) from it to pick the fused or
// two-pass route.
int butterfly_sample_warps_per_block(void) { return kWarps; }

}  // extern "C"
