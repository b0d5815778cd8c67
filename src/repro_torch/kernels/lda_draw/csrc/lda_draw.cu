// Factored LDA topic draws for Hopper (sm_90a): the paper's fused inner
// loop, z ~ Categorical(theta[doc] * phi[word]), without ever forming the
// (samples, K) weight tensor.
//
// Replaces the TPU kernels of src/repro/kernels/lda_draw/kernel.py:
//   lda_fused_draw   <- _fused_factored_kernel    (lda_fused_draw_pallas)  K8
//   lda_blocksums    <- _factored_blocksum_kernel (lda_blocksums_pallas)   K6
//   lda_walk         <- _factored_walk_kernel     (lda_walk_pallas)        K7
//
// Design.  K6, K7 and K8's warp layout: one warp owns one sample from
// start to end; kWarps warps share a block only to fill the SM, never to
// exchange data.  The TPU kernels fetch
// the theta and phi rows with scalar-prefetch index maps and carry a (tb, Kp)
// tile across a sequential grid axis; here each warp loads its own doc and
// word ids and reads the two rows coalesced (lane i reads k = i, i+32, ...),
// and nothing is carried between blocks, which run in no order.  The TPU's
// one-hot lane reductions become shuffles and direct shared-memory reads
// (draw_tile.cuh).  K is padded to Kp = nb * W virtually: columns at or past
// the rows' width read as zero, so callers never copy phi to pad it.
//
// K8 has a second layout, group, which the wrapper picks where it fits (the
// sweep's chunk: K = 240, W = 32).  One warp per draw keeps few draws in
// flight, and each of its 32-column steps waits on that step's loads
// before its shuffle tree, so a draw pays a chain of dependent L2 round
// trips.  In the group layout a group of G = W / 4 lanes owns a draw (32 /
// G draws per warp, as K3 walks): lane q holds columns 4q..4q+3 of each
// W-block of theta and phi, read with one 16-byte load per factor (8 for
// bf16) where every row start is aligned and four loads otherwise (a
// second instantiation), the loads of draw_tile::kGroupBatch blocks issued
// before the first sum (group_block_sums).  It keeps only the nb block sums
// of each draw in shared memory, scans them with warp_running's adds
// (group_running) and walks block jb with group_walk, forming its products
// again from the factors (L1/L2).  Every add is the warp layout's, so the
// layouts, and K8 and K6 + K7, give the same indices.
//
// K7 has the same group layout, which its wrapper takes at every W (it
// needs no shared memory): K8's group_walk over a running row read from
// global memory.  The warp layout's select, block load through shared
// memory, Fenwick table and one-lane descent cost it 37x its bound at the
// chunk (109,568 draws, S = 4).
//
// K6 has the same group layout too, which its wrapper takes where K8's
// fits: K8's group_block_sums and group_running into the group's shared
// memory, then the scanned row written to the output.  The warp layout
// reads 32 columns per step, one dependent L2 round trip per step (8 per
// sample at the chunk); the group layout issues kGroupBatch blocks' loads
// at once, 16 bytes a lane and factor.  Every add is the warp layout's,
// so the running sums are equal bit for bit.
//
// Bound.  All three are memory-bound gathers: per sample K8 and K6 read two
// K-wide rows (8K bytes in fp32) and do 2K flops; K7 reads one running row
// (4 nb bytes) and two W-wide slices.  The design keeps the only other
// traffic to 4 bytes of ids, 4 of u and 4 (K6: 4 nb) of output per sample;
// theta rows repeat across a document's words and hit L1/L2.
//
// Block address.  K7 computes its block jb from the running row itself, so
// the reference's separate XLA block search before pass B is not needed;
// the indices are the same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "draw_tile.cuh"

namespace {

constexpr int kWarps = 4;  // warps (samples in flight) per block

using draw_tile::group_block_sums;
using draw_tile::group_running;
using draw_tile::group_walk;
using draw_tile::ProductRow;
using draw_tile::ProductRow4;
using draw_tile::warp_block_sums;
using draw_tile::warp_draw_tile;
using draw_tile::warp_fenwick;
using draw_tile::warp_load_block;
using draw_tile::warp_running;
using draw_tile::warp_select;
using draw_tile::descent;

// K8, warp layout: one warp per draw, its product row and block sums in
// shared memory.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    lda_fused_draw_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                          const int* __restrict__ doc_ids,
                          const int* __restrict__ words,
                          const float* __restrict__ u, int* __restrict__ out,
                          int Bt, int ncols, int nb, int W) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int s = blockIdx.x * kWarps + wib;
  if (s >= Bt) return;  // warp-uniform: the whole warp leaves together
  const int Kp = nb * W;
  float* prod = smem + wib * (Kp + nb);
  float* run = prod + Kp;
  const ProductRow<T> row{theta + static_cast<size_t>(doc_ids[s]) * ncols,
                          phi + static_cast<size_t>(words[s]) * ncols};
  warp_block_sums<true>(row, ncols, nb, W, prod, run, lane);
  const int idx = warp_draw_tile(prod, run, nb, W, u[s], lane);
  if (lane == 0) out[s] = idx;
}

// K8, group layout: draw s by the group of W / 4 lanes threadIdx.x / (W /
// 4) of its block, its nb block sums in smem + (that group) * nb.  VEC:
// theta and phi rows 16-byte aligned (8-byte for bf16).
template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    lda_fused_group_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                           const int* __restrict__ doc_ids,
                           const int* __restrict__ words,
                           const float* __restrict__ u, int* __restrict__ out,
                           int Bt, int ncols, int nb) {
  extern __shared__ float smem[];
  constexpr int G = W / 4;
  constexpr int kDraws = kWarps * 32 / G;  // draws per block
  const int base = blockIdx.x * kDraws;
  if (base + (threadIdx.x & ~31) / G >= Bt) return;  // the whole warp is past Bt
  const int q = threadIdx.x & (G - 1);
  const int gi = threadIdx.x / G;
  const int gid = base + gi;
  // a group past Bt redoes the last draw, so every lane joins the shuffles
  const int s = gid < Bt ? gid : Bt - 1;
  const ProductRow4<T, VEC> row{theta + static_cast<size_t>(doc_ids[s]) * ncols,
                                phi + static_cast<size_t>(words[s]) * ncols, ncols};
  float* run = smem + gi * nb;
  group_block_sums<W>(row, nb, run, q);
  group_running<G>(run, nb, q);
  const int idx = group_walk<W>(row, run, nb, u[s], q);
  if (q == 0 && gid < Bt) out[s] = idx;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    lda_blocksums_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                         const int* __restrict__ doc_ids,
                         const int* __restrict__ words,
                         float* __restrict__ running, int Bt, int ncols, int nb,
                         int W) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= Bt) return;
  const ProductRow<T> row{theta + static_cast<size_t>(doc_ids[s]) * ncols,
                          phi + static_cast<size_t>(words[s]) * ncols};
  // the output row doubles as the scan buffer (__syncwarp orders global
  // memory among the warp's lanes as well as shared memory)
  float* out = running + static_cast<size_t>(s) * nb;
  warp_block_sums<false>(row, ncols, nb, W, nullptr, out, lane);
  warp_running(out, nb, lane);
}

// K6, group layout: sample s by the group of W / 4 lanes threadIdx.x / (W /
// 4) of its block, its nb block sums scanned in smem + (that group) * nb
// (lda_fused_group_kernel's pass A), then written to running[s, 0..nb).
template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    lda_blocksums_group_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                               const int* __restrict__ doc_ids,
                               const int* __restrict__ words,
                               float* __restrict__ running, int Bt, int ncols, int nb) {
  extern __shared__ float smem[];
  constexpr int G = W / 4;
  constexpr int kDraws = kWarps * 32 / G;  // samples per block
  const int base = blockIdx.x * kDraws;
  if (base + (threadIdx.x & ~31) / G >= Bt) return;  // the whole warp is past Bt
  const int q = threadIdx.x & (G - 1);
  const int gi = threadIdx.x / G;
  const int gid = base + gi;
  // a group past Bt redoes the last sample, so every lane joins the shuffles
  const int s = gid < Bt ? gid : Bt - 1;
  const ProductRow4<T, VEC> row{theta + static_cast<size_t>(doc_ids[s]) * ncols,
                                phi + static_cast<size_t>(words[s]) * ncols, ncols};
  float* run = smem + gi * nb;
  group_block_sums<W>(row, nb, run, q);
  group_running<G>(run, nb, q);
  if (gid >= Bt) return;
  float* out = running + static_cast<size_t>(s) * nb;
  for (int c = q; c < nb; c += G) out[c] = run[c];
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    lda_walk_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                    const float* __restrict__ running,
                    const float* __restrict__ u, const int* __restrict__ rows,
                    const int* __restrict__ doc_ids,
                    const int* __restrict__ words, int* __restrict__ out,
                    int Bt, int ncols, int nb, int W) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int s = blockIdx.x * kWarps + wib;
  if (s >= Bt) return;
  float* t = smem + wib * W;
  const float* run = running + static_cast<size_t>(rows[s]) * nb;
  const float stop = __fmul_rn(run[nb - 1], u[s]);
  int jb;
  float lo;
  warp_select(run, nb, stop, lane, jb, lo);
  // fetch only block jb of the two rows
  const ProductRow<T> row{theta + static_cast<size_t>(doc_ids[s]) * ncols,
                          phi + static_cast<size_t>(words[s]) * ncols};
  warp_load_block(row, ncols, jb, W, t, lane);
  warp_fenwick(t, W, lane);
  const int R = descent(t, stop, lo, W);
  if (lane == 0) out[s] = jb * W + R;
}

// K7, group layout: draw s by the group of W / 4 lanes threadIdx.x / (W /
// 4) of its block (32 / (W / 4) draws per warp), its running row read
// from global memory, block jb's products formed with one 16-byte load per
// lane and factor (VEC) or four loads; group_walk makes lda_walk_kernel's
// count, Fenwick adds and descent, so the index is the same bit for bit.
template <typename T, int W, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    lda_walk_group_kernel(const T* __restrict__ theta, const T* __restrict__ phi,
                          const float* __restrict__ running,
                          const float* __restrict__ u, const int* __restrict__ rows,
                          const int* __restrict__ doc_ids,
                          const int* __restrict__ words, int* __restrict__ out,
                          int Bt, int ncols, int nb) {
  constexpr int G = W / 4;
  constexpr int kDraws = kWarps * 32 / G;  // draws per block
  const int base = blockIdx.x * kDraws;
  if (base + (threadIdx.x & ~31) / G >= Bt) return;  // the whole warp is past Bt
  const int q = threadIdx.x & (G - 1);
  const int gid = base + threadIdx.x / G;
  // a group past Bt redoes the last draw, so every lane joins the shuffles
  const int s = gid < Bt ? gid : Bt - 1;
  const ProductRow4<T, VEC> row{theta + static_cast<size_t>(doc_ids[s]) * ncols,
                                phi + static_cast<size_t>(words[s]) * ncols, ncols};
  const int idx = group_walk<W>(row, running + static_cast<size_t>(rows[s]) * nb, nb,
                                u[s], q);
  if (q == 0 && gid < Bt) out[s] = idx;
}

inline unsigned grid_for(int Bt) {
  return static_cast<unsigned>((Bt + kWarps - 1) / kWarps);
}

template <typename T, int W>
int launch_group_w(const T* theta, const T* phi, const int* d, const int* w,
                   const float* u, int* out, int Bt, int ncols, int nb, bool vec,
                   cudaStream_t st) {
  constexpr int kDraws = kWarps * 32 / (W / 4);
  const unsigned grid = static_cast<unsigned>((Bt + kDraws - 1) / kDraws);
  const size_t smem = sizeof(float) * kDraws * nb;
  if (vec)
    lda_fused_group_kernel<T, W, true><<<grid, kWarps * 32, smem, st>>>(
        theta, phi, d, w, u, out, Bt, ncols, nb);
  else
    lda_fused_group_kernel<T, W, false><<<grid, kWarps * 32, smem, st>>>(
        theta, phi, d, w, u, out, Bt, ncols, nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_group(const void* theta, const void* phi, const int* d, const int* w,
                 const float* u, int* out, int Bt, int ncols, int nb, int W,
                 cudaStream_t st) {
  const T* th = static_cast<const T*>(theta);
  const T* ph = static_cast<const T*>(phi);
  const bool vec = draw_tile::rows_aligned(th, ncols) && draw_tile::rows_aligned(ph, ncols);
  switch (W) {
    case 8:
      return launch_group_w<T, 8>(th, ph, d, w, u, out, Bt, ncols, nb, vec, st);
    case 16:
      return launch_group_w<T, 16>(th, ph, d, w, u, out, Bt, ncols, nb, vec, st);
    case 32:
      return launch_group_w<T, 32>(th, ph, d, w, u, out, Bt, ncols, nb, vec, st);
    case 64:
      return launch_group_w<T, 64>(th, ph, d, w, u, out, Bt, ncols, nb, vec, st);
    case 128:
      return launch_group_w<T, 128>(th, ph, d, w, u, out, Bt, ncols, nb, vec, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int W>
int launch_blocksums_group_w(const T* theta, const T* phi, const int* d, const int* w,
                             float* r, int Bt, int ncols, int nb, bool vec,
                             cudaStream_t st) {
  constexpr int kDraws = kWarps * 32 / (W / 4);
  const unsigned grid = static_cast<unsigned>((Bt + kDraws - 1) / kDraws);
  const size_t smem = sizeof(float) * kDraws * nb;
  if (vec)
    lda_blocksums_group_kernel<T, W, true><<<grid, kWarps * 32, smem, st>>>(
        theta, phi, d, w, r, Bt, ncols, nb);
  else
    lda_blocksums_group_kernel<T, W, false><<<grid, kWarps * 32, smem, st>>>(
        theta, phi, d, w, r, Bt, ncols, nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_blocksums_group(const void* theta, const void* phi, const int* d,
                           const int* w, float* r, int Bt, int ncols, int nb, int W,
                           cudaStream_t st) {
  const T* th = static_cast<const T*>(theta);
  const T* ph = static_cast<const T*>(phi);
  const bool vec = draw_tile::rows_aligned(th, ncols) && draw_tile::rows_aligned(ph, ncols);
  switch (W) {
    case 8:
      return launch_blocksums_group_w<T, 8>(th, ph, d, w, r, Bt, ncols, nb, vec, st);
    case 16:
      return launch_blocksums_group_w<T, 16>(th, ph, d, w, r, Bt, ncols, nb, vec, st);
    case 32:
      return launch_blocksums_group_w<T, 32>(th, ph, d, w, r, Bt, ncols, nb, vec, st);
    case 64:
      return launch_blocksums_group_w<T, 64>(th, ph, d, w, r, Bt, ncols, nb, vec, st);
    case 128:
      return launch_blocksums_group_w<T, 128>(th, ph, d, w, r, Bt, ncols, nb, vec, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int W>
int launch_walk_group_w(const T* theta, const T* phi, const float* r, const float* u,
                        const int* rw, const int* d, const int* w, int* out, int Bt,
                        int ncols, int nb, bool vec, cudaStream_t st) {
  constexpr int kDraws = kWarps * 32 / (W / 4);
  const unsigned grid = static_cast<unsigned>((Bt + kDraws - 1) / kDraws);
  if (vec)
    lda_walk_group_kernel<T, W, true><<<grid, kWarps * 32, 0, st>>>(
        theta, phi, r, u, rw, d, w, out, Bt, ncols, nb);
  else
    lda_walk_group_kernel<T, W, false><<<grid, kWarps * 32, 0, st>>>(
        theta, phi, r, u, rw, d, w, out, Bt, ncols, nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_walk_group(const void* theta, const void* phi, const float* r, const float* u,
                      const int* rw, const int* d, const int* w, int* out, int Bt,
                      int ncols, int nb, int W, cudaStream_t st) {
  const T* th = static_cast<const T*>(theta);
  const T* ph = static_cast<const T*>(phi);
  const bool vec = draw_tile::rows_aligned(th, ncols) && draw_tile::rows_aligned(ph, ncols);
  switch (W) {
    case 8:
      return launch_walk_group_w<T, 8>(th, ph, r, u, rw, d, w, out, Bt, ncols, nb, vec, st);
    case 16:
      return launch_walk_group_w<T, 16>(th, ph, r, u, rw, d, w, out, Bt, ncols, nb, vec, st);
    case 32:
      return launch_walk_group_w<T, 32>(th, ph, r, u, rw, d, w, out, Bt, ncols, nb, vec, st);
    case 64:
      return launch_walk_group_w<T, 64>(th, ph, r, u, rw, d, w, out, Bt, ncols, nb, vec, st);
    case 128:
      return launch_walk_group_w<T, 128>(th, ph, r, u, rw, d, w, out, Bt, ncols, nb, vec,
                                         st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Every function launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" {

// group: 0 for the warp layout, 1 for the group layout (W / 4 lanes per
// draw; one 16-byte load per lane and factor where every row start is
// aligned, four loads otherwise).
int lda_fused_draw(const void* theta, const void* phi, const void* doc_ids,
                   const void* words, const void* u, void* out, int Bt,
                   int ncols, int nb, int W, int group, int dtype, void* stream) {
  if (Bt <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const int* d = static_cast<const int*>(doc_ids);
  const int* w = static_cast<const int*>(words);
  const float* uu = static_cast<const float*>(u);
  int* o = static_cast<int*>(out);
  if (group) {
    if (dtype == 1)
      return launch_group<__nv_bfloat16>(theta, phi, d, w, uu, o, Bt, ncols, nb, W, st);
    return launch_group<float>(theta, phi, d, w, uu, o, Bt, ncols, nb, W, st);
  }
  const size_t smem = sizeof(float) * kWarps * (nb * W + nb);
  if (dtype == 1)
    lda_fused_draw_kernel<__nv_bfloat16><<<grid_for(Bt), kWarps * 32, smem, st>>>(
        static_cast<const __nv_bfloat16*>(theta),
        static_cast<const __nv_bfloat16*>(phi), d, w, uu, o, Bt, ncols, nb, W);
  else
    lda_fused_draw_kernel<float><<<grid_for(Bt), kWarps * 32, smem, st>>>(
        static_cast<const float*>(theta), static_cast<const float*>(phi), d, w,
        uu, o, Bt, ncols, nb, W);
  return static_cast<int>(cudaGetLastError());
}

// group: 0 for the warp layout, 1 for the group layout (W / 4 lanes per
// sample, kWarps * 32 / (W / 4) * nb floats of shared memory a block).
int lda_blocksums(const void* theta, const void* phi, const void* doc_ids,
                  const void* words, void* running, int Bt, int ncols, int nb,
                  int W, int group, int dtype, void* stream) {
  if (Bt <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const int* d = static_cast<const int*>(doc_ids);
  const int* w = static_cast<const int*>(words);
  float* r = static_cast<float*>(running);
  if (group) {
    if (dtype == 1)
      return launch_blocksums_group<__nv_bfloat16>(theta, phi, d, w, r, Bt, ncols, nb, W,
                                                   st);
    return launch_blocksums_group<float>(theta, phi, d, w, r, Bt, ncols, nb, W, st);
  }
  if (dtype == 1)
    lda_blocksums_kernel<__nv_bfloat16><<<grid_for(Bt), kWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(theta),
        static_cast<const __nv_bfloat16*>(phi), d, w, r, Bt, ncols, nb, W);
  else
    lda_blocksums_kernel<float><<<grid_for(Bt), kWarps * 32, 0, st>>>(
        static_cast<const float*>(theta), static_cast<const float*>(phi), d, w,
        r, Bt, ncols, nb, W);
  return static_cast<int>(cudaGetLastError());
}

// group: 0 for the warp layout, 1 for the group layout (W / 4 lanes per
// draw, no shared memory).
int lda_walk(const void* theta, const void* phi, const void* running,
             const void* u, const void* rows, const void* doc_ids,
             const void* words, void* out, int Bt, int ncols, int nb, int W,
             int group, int dtype, void* stream) {
  if (Bt <= 0) return 0;
  const size_t smem = sizeof(float) * kWarps * W;
  auto st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(running);
  const float* uu = static_cast<const float*>(u);
  const int* rw = static_cast<const int*>(rows);
  const int* d = static_cast<const int*>(doc_ids);
  const int* w = static_cast<const int*>(words);
  int* o = static_cast<int*>(out);
  if (group) {
    if (dtype == 1)
      return launch_walk_group<__nv_bfloat16>(theta, phi, r, uu, rw, d, w, o, Bt, ncols,
                                              nb, W, st);
    return launch_walk_group<float>(theta, phi, r, uu, rw, d, w, o, Bt, ncols, nb, W, st);
  }
  if (dtype == 1)
    lda_walk_kernel<__nv_bfloat16><<<grid_for(Bt), kWarps * 32, smem, st>>>(
        static_cast<const __nv_bfloat16*>(theta),
        static_cast<const __nv_bfloat16*>(phi), r, uu, rw, d, w, o, Bt, ncols,
        nb, W);
  else
    lda_walk_kernel<float><<<grid_for(Bt), kWarps * 32, smem, st>>>(
        static_cast<const float*>(theta), static_cast<const float*>(phi), r, uu,
        rw, d, w, o, Bt, ncols, nb, W);
  return static_cast<int>(cudaGetLastError());
}

// Warps per block; the wrapper sizes the fused draw's shared memory from
// it: kWarps * (nb * W + nb) floats in the warp layout, kWarps * 32 / (W /
// 4) * nb in the group layout (K8's and K6's).
int lda_warps_per_block(void) { return kWarps; }

}  // extern "C"
