// The sparse sweep's counts and lists in one pass a document (S2) for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference counts with a scatter-add
// (repro/lda/sparse.py _counts_scatter) and lists each document's topics
// with lax.top_k, both plain XLA.  The port did the same with two float
// index_add_ calls over every position and a stable descending sort of
// the whole (M, K) counts, of which it kept cap columns.  Here one block
// of kThreads threads takes one document and writes, from z, docs and the
// mask:
//   doc_topic[doc, :]  its K counts as float32, zeros included (no memset);
//   word_topic[w, k]   += 1.0f for each live token (w, k) (a zeroed buffer;
//                      skipped when the caller passes none);
//   ids, cnt [doc, :]  its list, width slots: the order that
//                      torch.sort(descending=True, stable=True) gives,
//                      counts descending, the lower topic first among
//                      equal counts, then the zero-count topics in
//                      ascending id order;
//   *nnz_max           atomicMax of its number of nonzero topics.
//
// Steps of a block:
//   1. the histogram of its live tokens' topics in shared memory, by
//      shared integer atomics (and the word side's float atomics);
//   2. the row of doc_topic, coalesced;
//   3. the nonzero topics compacted in id order: thread t takes topics
//      [t seg, (t + 1) seg), seg = ceil(K / kThreads), counts its nonzero
//      ones, and a block scan (warp shuffles, then the warps' totals) gives
//      p, the nonzero topics below its first.  Walking its topics up, a
//      nonzero one goes to position p of the compacted list (and p rises);
//      a zero one, the (k - p)-th zero topic, goes straight to slot
//      nnz + k - p when that is below width;
//   4. the rank of compacted entry j: #{i : cnt_i > cnt_j} + #{i : cnt_i ==
//      cnt_j, i < j} (entries are in id order, so i < j is the lower id),
//      which is its slot in the stable descending sort; ranks >= width are
//      dropped.  Every slot below width is written once: the ranks are a
//      permutation of [0, nnz), and K - nnz >= width - nnz zero topics
//      fill the rest.
//
// Exactness.  Every count is an integer below 2^24, so each float32 value
// (a count, and a sum of 1.0f adds in any order) is exact: doc_topic and
// word_topic equal the index_add_ of the plain version bit for bit, and
// the lists equal its sort's columns.  z is in [0, K) at live positions
// and docs index word_topic's rows (not checked: that would synchronise);
// masked positions are not read.
//
// Bound.  Bytes: z, docs and the mask read once (9 bytes a position),
// doc_topic written once (4 K bytes a document), the lists (8 width bytes
// a document), and one 4-byte atomic a live token into word_topic, which
// at the paper's corpus (35.8 MB) stays in the 50 MB L2.  Work: the rank
// is nnz^2 shared-memory compares a document (nnz <= min(L, K)), broadcast
// reads, small beside the bytes for documents of a few hundred positions.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    sparse_counts_kernel(const int* __restrict__ z, const int* __restrict__ docs,
                         const uint8_t* __restrict__ mask, float* __restrict__ doc_topic,
                         float* __restrict__ word_topic, int* __restrict__ ids,
                         int* __restrict__ cnt, int* __restrict__ nnz_max, int L, int K,
                         int width, int nz_cap) {
  // the histogram (K ints), then the compacted nonzero topics' ids and
  // counts (nz_cap = min(L, K) ints each)
  extern __shared__ int smem[];
  int* s_hist = smem;
  int* s_nz_id = s_hist + K;
  int* s_nz_cnt = s_nz_id + nz_cap;
  __shared__ int s_warp[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int doc = blockIdx.x;
  const size_t base = static_cast<size_t>(doc) * L;

  for (int k = tid; k < K; k += kThreads) s_hist[k] = 0;
  __syncthreads();
  for (int i = tid; i < L; i += kThreads) {
    if (mask[base + i] != 0) {
      const int k = z[base + i];
      atomicAdd(s_hist + k, 1);
      if (word_topic != nullptr) {
        atomicAdd(word_topic + static_cast<size_t>(docs[base + i]) * K + k, 1.0f);
      }
    }
  }
  __syncthreads();

  float* row = doc_topic + static_cast<size_t>(doc) * K;
  for (int k = tid; k < K; k += kThreads) row[k] = __int2float_rn(s_hist[k]);

  // this thread's topics and its nonzero count, then the block's scan
  const int seg = (K + kThreads - 1) / kThreads;
  const int k0 = min(tid * seg, K), k1 = min(k0 + seg, K);
  int n = 0;
  for (int k = k0; k < k1; ++k) n += s_hist[k] > 0;
  int incl = n;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int p = incl - n, nnz = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int t = s_warp[w];
    if (w < warp) p += t;
    nnz += t;
  }
  if (tid == 0 && nnz > 0 && nnz > *reinterpret_cast<volatile int*>(nnz_max)) {
    atomicMax(nnz_max, nnz);
  }

  const size_t lrow = static_cast<size_t>(doc) * width;
  for (int k = k0; k < k1; ++k) {
    const int c = s_hist[k];
    if (c > 0) {
      s_nz_id[p] = k;
      s_nz_cnt[p] = c;
      ++p;
    } else {
      const int slot = nnz + (k - p);
      if (slot < width) {
        ids[lrow + slot] = k;
        cnt[lrow + slot] = 0;
      }
    }
  }
  __syncthreads();

  for (int j = tid; j < nnz; j += kThreads) {
    const int c = s_nz_cnt[j];
    int r = 0;
    for (int i = 0; i < nnz; ++i) {
      const int ci = s_nz_cnt[i];
      r += (ci > c) | ((ci == c) & (i < j));
    }
    if (r < width) {
      ids[lrow + r] = s_nz_id[j];
      cnt[lrow + r] = c;
    }
  }
}

}  // namespace

extern "C" {

int sparse_counts_threads() { return kThreads; }

// A block's shared memory with opting in on card `device`, or minus the
// CUDA error.
int sparse_counts_smem_optin(int device) {
  int n = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// One block a document.  doc_topic (M, K) float32 is written whole;
// word_topic (V, K) float32, zeroed by the caller, may be null (the word
// side is skipped); ids and cnt (M, width) int32, width <= K, are written
// whole; nnz_max one int32 the caller zeroed.  Shared memory: K + 2 min(L,
// K) ints, above 48 KB by opting in (the caller checked it fits).
int sparse_counts(const void* z, const void* docs, const void* mask, void* doc_topic,
                  void* word_topic, void* ids, void* cnt, void* nnz_max, int M, int L,
                  int K, int width, void* stream) {
  if (M <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nz_cap = L < K ? L : K;
  const size_t smem = static_cast<size_t>(K + 2 * nz_cap) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sparse_counts_kernel<<<static_cast<unsigned int>(M), kThreads, smem, st>>>(
      static_cast<const int*>(z), static_cast<const int*>(docs),
      static_cast<const uint8_t*>(mask), static_cast<float*>(doc_topic),
      static_cast<float*>(word_topic), static_cast<int*>(ids), static_cast<int*>(cnt),
      static_cast<int*>(nnz_max), L, K, width, nz_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
