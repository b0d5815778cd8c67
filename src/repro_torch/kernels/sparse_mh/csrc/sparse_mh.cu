// The sparse LDA MH sweep (S1) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's _mh_sweep
// (src/repro/lda/sparse.py) is one lax.scan over document chunks that XLA
// fuses.  Its PyTorch translation (ref.py's mh_sweep_torch) is a few
// hundred small launches per chunk, most of them the int64 Threefry of
// kernels/rng.py, so the sweep runs here as one launch.
//
// A cycle of a live token (document doc, position pos, word w, topic z):
//   u_j   = bits_to_uniform(threefry2x32(seed, (c, 5 s + j)).x),
//           c = (row0 + doc) * L + pos in uint32 (threefry.cuh);
//   word  k' from the word's alias row (u0, u1; 2 gathers) or by the
//         dyadic descent over its cdf row (u0 only; ceil(log2 K)
//         gathers); accepted iff u2 * theta[z] < theta[k'];
//   doc   t = u3 * (K alpha + sum cnt); t < K alpha: k' = min(t / alpha,
//         K - 1), else k' = ids[min(#{cc <= t - K alpha}, cap - 1)];
//         accepted iff u4 * den < num, num = theta[k'] phi[k'] (alpha +
//         n(z)), den = theta[z] phi[z] (alpha + n(k')), n(k) the
//         retained count of topic k in the document's list.
// Within a sweep every token's chain is independent: the counts, theta
// and phi are fixed at its start.  Masked positions keep their topic.
// The three counters (word accepts, doc accepts, live positions) are
// integer sums, added with one atomicAdd each a block: the same in any
// order.
//
// Two layouts, the same float operations in the same order:
//
// "position" (sparse_mh_kernel, the first port's body): one thread per
// word position, 64 positions of one document a block; the block stages
// its document's list (ids, cnt, and the prefix cc formed by thread 0)
// and each live thread scans all cap entries for #{cc <= x}, n(z) and
// n(k') every cycle.  Masked lanes sit out every cycle.
//
// "doc" (sparse_mh_doc_kernel): one document a block of 128 threads.  The
// block stages the document's list once (one warp: ids, the inclusive
// prefix of cnt by a warp scan of ints, then float32 as before) and
// scatters it into a topic -> count map of K ints in shared memory
// (shared atomicAdd; ids outside [0, K) skipped, which the scan never
// matches either), so n(z) and n(k') are two shared loads.  The
// doc-sparse position is an upper-bound binary search over cc, which
// counts #{cc <= x} because cc is non-decreasing (every cnt >= 0, as
// sparse_counts gives).  The document's live positions are compacted in
// order (ballot and per-warp counts) and the threads loop over them, so
// lanes work on live tokens only.  The word-proposal mode is a template
// parameter: cdf draws u0, u2, u3, u4 and never u1.  On the H100 its time
// is set by the gathers of theta, phi and the word tables (the cdf
// descent's first), not by Threefry (PERF.md).
//
// Exactness.  Every float operation is the reference's, in its order,
// pinned with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn (nvcc's
// default flags; no --use_fast_math), and float -> int conversions
// truncate as astype(int32) does, so z and the counts equal the plain
// version's bit for bit in both layouts.
//
// Bound.  Per live token and cycle: four (cdf) or five (alias) Threefry
// blocks, 66 integer instructions each (20 of them LOP3, which only the
// ALU pipe runs; the rest may also go to the FMA pipe), and about
// 2 + log2 K scalar gathers of theta, phi and the word tables; per
// position: z, the word and the mask read, z written.  At the paper's
// corpus the integer work sets the bound (chip_smoke.s1_bound).
#include <cstdint>

#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float mh_uniform(uint32_t s0, uint32_t s1, uint32_t ctr,
                                            uint32_t use) {
  return threefry::bits_to_uniform(threefry::threefry2x32(s0, s1, ctr, use).x);
}

__global__ void __launch_bounds__(kThreads)
    sparse_mh_kernel(const int* __restrict__ z, const int* __restrict__ docs,
                     const uint8_t* __restrict__ mask, const float* __restrict__ theta,
                     const float* __restrict__ phi, const int* __restrict__ ids,
                     const int* __restrict__ cnt, const float* __restrict__ tbl_a,
                     const int* __restrict__ tbl_b, int* __restrict__ z_out,
                     int* __restrict__ accepts, int L, int K, int cap, int steps,
                     int alias_mode, int span0, int parts, uint32_t s0, uint32_t s1,
                     uint32_t row0, float alpha) {
  extern __shared__ int smem[];
  int* s_ids = smem;
  int* s_cnt = smem + cap;
  float* s_cc = reinterpret_cast<float*>(smem + 2 * cap);
  __shared__ int s_acc[2][kWarps];

  const int doc = blockIdx.x / parts;
  const int pos = (blockIdx.x % parts) * kThreads + threadIdx.x;
  const bool inrow = pos < L;
  const size_t idx = static_cast<size_t>(doc) * L + pos;
  const bool live = inrow && mask[idx] != 0;
  int zc = inrow ? z[idx] : 0;
  int wa = 0, da = 0;
  const int nlive = __syncthreads_count(live);

  if (nlive) {
    const size_t drow = static_cast<size_t>(doc) * cap;
    for (int j = threadIdx.x; j < cap; j += kThreads) {
      s_ids[j] = ids[drow + j];
      s_cnt[j] = cnt[drow + j];
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // the integer prefix, then float32 (exact)
      int run = 0;
      for (int j = 0; j < cap; ++j) {
        run += s_cnt[j];
        s_cc[j] = __int2float_rn(run);
      }
    }
    __syncthreads();
    if (live) {
      const int w = docs[idx];
      const float* th = theta + static_cast<size_t>(doc) * K;
      const size_t wrow = static_cast<size_t>(w) * K;
      const float Kf = __int2float_rn(K);
      const float Ka = __fmul_rn(Kf, alpha);
      const float mass = __fadd_rn(Ka, s_cc[cap - 1]);
      const uint32_t ctr = (row0 + static_cast<uint32_t>(doc)) * static_cast<uint32_t>(L) +
                           static_cast<uint32_t>(pos);
      for (int s = 0; s < steps; ++s) {
        const uint32_t use = 5u * static_cast<uint32_t>(s);
        // ---- word proposal: k' ~ phi[w, :], accepted on the theta ratio
        const float u0 = mh_uniform(s0, s1, ctr, use);
        const float u1 = mh_uniform(s0, s1, ctr, use + 1u);
        int kp;
        if (alias_mode) {
          const int kr = min(__float2int_rz(__fmul_rn(u0, Kf)), K - 1);
          kp = (u1 < tbl_a[wrow + kr]) ? kr : tbl_b[wrow + kr];
        } else {
          const float t = __fmul_rn(u0, tbl_a[wrow + K - 1]);
          int base = 0;
          for (int span = span0; span > 1;) {
            span >>= 1;
            const int cand = base + span - 1;
            const float val = tbl_a[wrow + min(cand, K - 1)];
            if (cand < K && val < t) base += span;
          }
          kp = min(base, K - 1);
        }
        const float u2 = mh_uniform(s0, s1, ctr, use + 2u);
        if (__fmul_rn(u2, th[zc]) < th[kp]) {
          zc = kp;
          ++wa;
        }
        // ---- doc proposal: smoothing and doc-sparse branches
        const float u3 = mh_uniform(s0, s1, ctr, use + 3u);
        const float t = __fmul_rn(u3, mass);
        int kq;
        if (t < Ka) {
          kq = min(__float2int_rz(__fdiv_rn(t, alpha)), K - 1);
        } else {
          const float x = __fsub_rn(t, Ka);
          int p = 0;
          for (int j = 0; j < cap; ++j) p += s_cc[j] <= x;
          kq = s_ids[min(p, cap - 1)];
        }
        int ncur = 0, nprop = 0;
        for (int j = 0; j < cap; ++j) {
          const int id = s_ids[j], c = s_cnt[j];
          ncur += id == zc ? c : 0;
          nprop += id == kq ? c : 0;
        }
        const float num = __fmul_rn(__fmul_rn(th[kq], phi[wrow + kq]),
                                    __fadd_rn(alpha, __int2float_rn(ncur)));
        const float den = __fmul_rn(__fmul_rn(th[zc], phi[wrow + zc]),
                                    __fadd_rn(alpha, __int2float_rn(nprop)));
        const float u4 = mh_uniform(s0, s1, ctr, use + 4u);
        if (__fmul_rn(u4, den) < num) {
          zc = kq;
          ++da;
        }
      }
    }
  }
  if (inrow) z_out[idx] = zc;

  // the block's accept counts, then one atomic add each
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wa += __shfl_xor_sync(0xffffffffu, wa, off);
    da += __shfl_xor_sync(0xffffffffu, da, off);
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    s_acc[0][warp] = wa;
    s_acc[1][warp] = da;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int a = 0, b = 0;
    for (int i = 0; i < kWarps; ++i) {
      a += s_acc[0][i];
      b += s_acc[1][i];
    }
    if (a) atomicAdd(accepts, a);
    if (b) atomicAdd(accepts + 1, b);
    if (nlive) atomicAdd(accepts + 2, nlive);
  }
}

// ---------------------------------------------------------------------------
// The "doc" layout
// ---------------------------------------------------------------------------

constexpr int kDocThreads = 128;
constexpr int kDocWarps = kDocThreads / 32;

// #{j < cap : cc[j] <= x} for a non-decreasing cc: the upper bound by
// halving steps from top, the largest power of two <= cap.
__device__ __forceinline__ int count_le(const float* cc, int cap, int top, float x) {
  int p = 0;
  for (int step = top; step > 0; step >>= 1) {
    const int q = p + step;
    if (q <= cap && cc[q - 1] <= x) p = q;
  }
  return p;
}

// One document's list into shared memory, by one warp: ids, the float32
// inclusive prefix cc of the integer prefix of cnt, and cnt added into
// the zeroed topic -> count map.
__device__ __forceinline__ void stage_doc(const int* __restrict__ ids,
                                          const int* __restrict__ cnt, int cap, int K,
                                          int lane, int* s_ids, float* s_cc, int* s_map) {
  int carry = 0;
  for (int j0 = 0; j0 < cap; j0 += 32) {
    const int j = j0 + lane;
    int id = -1, c = 0;
    if (j < cap) {
      id = ids[j];
      c = cnt[j];
    }
    int x = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    x += carry;
    if (j < cap) {
      s_ids[j] = id;
      s_cc[j] = __int2float_rn(x);
      if (static_cast<unsigned>(id) < static_cast<unsigned>(K)) atomicAdd(s_map + id, c);
    }
    carry = __shfl_sync(0xffffffffu, x, 31);
  }
}

template <bool kAlias>
__global__ void __launch_bounds__(kDocThreads)
    sparse_mh_doc_kernel(const int* __restrict__ z, const int* __restrict__ docs,
                         const uint8_t* __restrict__ mask, const float* __restrict__ theta,
                         const float* __restrict__ phi, const int* __restrict__ ids,
                         const int* __restrict__ cnt, const float* __restrict__ tbl_a,
                         const int* __restrict__ tbl_b, int* __restrict__ z_out,
                         int* __restrict__ accepts, int L, int K, int cap, int steps,
                         int span0, uint32_t s0, uint32_t s1, uint32_t row0,
                         float alpha) {
  // the map (K ints), ids (cap ints), cc (cap floats), the live positions
  // (L ints)
  extern __shared__ int smem[];
  int* s_map = smem;
  int* s_ids = s_map + K;
  float* s_cc = reinterpret_cast<float*>(s_ids + cap);
  int* s_live = reinterpret_cast<int*>(s_cc + cap);
  __shared__ int s_warp[kDocWarps];
  __shared__ int s_acc[2][kDocWarps];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int doc = blockIdx.x;
  const size_t base = static_cast<size_t>(doc) * L;

  for (int i = threadIdx.x; i < K; i += kDocThreads) s_map[i] = 0;
  // the live positions in order; masked ones keep their topic
  int nlive = 0;
  for (int t0 = 0; t0 < L; t0 += kDocThreads) {
    const int p = t0 + threadIdx.x;
    const bool live = p < L && mask[base + p] != 0;
    if (p < L && !live) z_out[base + p] = z[base + p];
    const unsigned b = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_warp[warp] = __popc(b);
    __syncthreads();
    int off = nlive;
    for (int w = 0; w < kDocWarps; ++w) {
      if (w == warp) off = nlive;
      nlive += s_warp[w];
    }
    if (live) s_live[off + __popc(b & ((1u << lane) - 1u))] = p;
    __syncthreads();
  }
  if (nlive && warp == 0) {
    const size_t drow = static_cast<size_t>(doc) * cap;
    stage_doc(ids + drow, cnt + drow, cap, K, lane, s_ids, s_cc, s_map);
  }
  __syncthreads();

  const float Kf = __int2float_rn(K);
  const float Ka = __fmul_rn(Kf, alpha);
  const int top = 1 << (31 - __clz(cap));
  const float* th = theta + static_cast<size_t>(doc) * K;
  const float mass = __fadd_rn(Ka, s_cc[cap - 1]);
  int wa = 0, da = 0;
  for (int i = threadIdx.x; i < nlive; i += kDocThreads) {
    const int pos = s_live[i];
    const size_t idx = base + pos;
    const int w = docs[idx];
    int zc = z[idx];
    const size_t wrow = static_cast<size_t>(w) * K;
    const uint32_t ctr = (row0 + static_cast<uint32_t>(doc)) * static_cast<uint32_t>(L) +
                         static_cast<uint32_t>(pos);
    for (int s = 0; s < steps; ++s) {
      const uint32_t use = 5u * static_cast<uint32_t>(s);
      // the cycle's uniforms depend on the counter only
      const float u0 = mh_uniform(s0, s1, ctr, use);
      const float u2 = mh_uniform(s0, s1, ctr, use + 2u);
      const float u3 = mh_uniform(s0, s1, ctr, use + 3u);
      const float u4 = mh_uniform(s0, s1, ctr, use + 4u);
      // ---- word proposal: k' ~ phi[w, :], accepted on the theta ratio
      int kp;
      if (kAlias) {
        const float u1 = mh_uniform(s0, s1, ctr, use + 1u);
        const int kr = min(__float2int_rz(__fmul_rn(u0, Kf)), K - 1);
        kp = (u1 < tbl_a[wrow + kr]) ? kr : tbl_b[wrow + kr];
      } else {
        const float t = __fmul_rn(u0, tbl_a[wrow + K - 1]);
        int lo = 0;
        for (int span = span0; span > 1;) {
          span >>= 1;
          const int cand = lo + span - 1;
          const float val = tbl_a[wrow + min(cand, K - 1)];
          if (cand < K && val < t) lo += span;
        }
        kp = min(lo, K - 1);
      }
      if (__fmul_rn(u2, th[zc]) < th[kp]) {
        zc = kp;
        ++wa;
      }
      // ---- doc proposal: smoothing and doc-sparse branches
      const float t = __fmul_rn(u3, mass);
      int kq;
      if (t < Ka) {
        kq = min(__float2int_rz(__fdiv_rn(t, alpha)), K - 1);
      } else {
        const float x = __fsub_rn(t, Ka);
        kq = s_ids[min(count_le(s_cc, cap, top, x), cap - 1)];
      }
      const int ncur = s_map[zc], nprop = s_map[kq];
      const float num = __fmul_rn(__fmul_rn(th[kq], phi[wrow + kq]),
                                  __fadd_rn(alpha, __int2float_rn(ncur)));
      const float den = __fmul_rn(__fmul_rn(th[zc], phi[wrow + zc]),
                                  __fadd_rn(alpha, __int2float_rn(nprop)));
      if (__fmul_rn(u4, den) < num) {
        zc = kq;
        ++da;
      }
    }
    z_out[idx] = zc;
  }

  // the block's accept counts, then one atomic add each
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    wa += __shfl_xor_sync(0xffffffffu, wa, off);
    da += __shfl_xor_sync(0xffffffffu, da, off);
  }
  if (lane == 0) {
    s_acc[0][warp] = wa;
    s_acc[1][warp] = da;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int a = 0, b = 0;
    for (int i = 0; i < kDocWarps; ++i) {
      a += s_acc[0][i];
      b += s_acc[1][i];
    }
    if (a) atomicAdd(accepts, a);
    if (b) atomicAdd(accepts + 1, b);
    if (nlive) atomicAdd(accepts + 2, nlive);
  }
}

}  // namespace

extern "C" {

int sparse_mh_doc_threads() { return kDocThreads; }

// layout 0 "position", 1 "doc" (one document a block, with K + 2 cap + L
// ints of shared memory, which the caller checked fit).  accepts: three
// int32 counters the caller zeroed (word accepts, doc accepts, live
// positions).
int sparse_mh(const void* z, const void* docs, const void* mask, const void* theta,
              const void* phi, const void* ids, const void* cnt, const void* tbl_a,
              const void* tbl_b, void* z_out, void* accepts, int M, int L, int K, int cap,
              int steps, int alias_mode, int span0, int layout, unsigned int s0, unsigned int s1, unsigned int row0, float alpha,
              void* stream) {
  if (M <= 0 || L <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* zi = static_cast<const int*>(z);
  const int* di = static_cast<const int*>(docs);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const float* th = static_cast<const float*>(theta);
  const float* ph = static_cast<const float*>(phi);
  const int* id = static_cast<const int*>(ids);
  const int* cn = static_cast<const int*>(cnt);
  const float* ta = static_cast<const float*>(tbl_a);
  const int* tb = static_cast<const int*>(tbl_b);
  int* zo = static_cast<int*>(z_out);
  int* acc = static_cast<int*>(accepts);
  if (layout == 1) {
    const size_t smem = static_cast<size_t>(K + 2 * cap + L) * sizeof(int);
    const unsigned int grid = static_cast<unsigned int>(M);
    if (alias_mode) {
      sparse_mh_doc_kernel<true><<<grid, kDocThreads, smem, st>>>(
          zi, di, mk, th, ph, id, cn, ta, tb, zo, acc, L, K, cap, steps, span0, s0, s1,
          row0, alpha);
    } else {
      sparse_mh_doc_kernel<false><<<grid, kDocThreads, smem, st>>>(
          zi, di, mk, th, ph, id, cn, ta, tb, zo, acc, L, K, cap, steps, span0, s0, s1,
          row0, alpha);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int parts = (L + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(M) * parts;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(cap) * 3 * sizeof(int);
  sparse_mh_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, st>>>(
      zi, di, mk, th, ph, id, cn, ta, tb, zo, acc, L, K, cap, steps, alias_mode, span0,
      parts, s0, s1, row0, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
