// The sparse LDA MH sweep (S1) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's _mh_sweep
// (src/repro/lda/sparse.py) is one lax.scan over document chunks that XLA
// fuses.  Its PyTorch translation (ref.py's mh_sweep_torch) is a few
// hundred small launches per chunk, most of them the int64 Threefry of
// kernels/rng.py, so the sweep runs here as one launch.
//
// Design.  One thread per word position, kThreads positions of one
// document per block (a document of L positions takes ceil(L / kThreads)
// blocks).  Within a sweep every token's chain is independent: the counts,
// theta and phi are fixed at its start.  A block whose positions are all
// masked out copies z and exits; otherwise it stages its document's
// retained list (ids, cnt and the inclusive prefix cc of cnt, cap entries)
// in shared memory, and each live thread runs `steps` cycles in
// registers:
//   u_j   = bits_to_uniform(threefry2x32(seed, (c, 5 s + j)).x), j = 0..4,
//           c = (row0 + doc) * L + pos in uint32 (threefry.cuh);
//   word  k' from the word's alias row (2 gathers) or by the dyadic
//         descent over its cdf row (ceil(log2 K) gathers); accepted iff
//         u2 * theta[z] < theta[k'];
//   doc   t = u3 * (K alpha + sum cnt); t < K alpha: k' = min(t / alpha,
//         K - 1), else k' = ids[min(#{cc <= t - K alpha}, cap - 1)];
//         accepted iff u4 * den < num, num = theta[k'] phi[k'] (alpha +
//         n(z)), den = theta[z] phi[z] (alpha + n(k')), n from the list.
// Masked positions keep their topic.  Each block sums its accept counts
// (warp shuffles, then the warps' sums in shared memory) and its live
// positions (__syncthreads_count), and adds them to three global counters
// with one atomicAdd each: integer sums, the same in any order.
//
// Exactness.  Every float operation is the reference's, in its order,
// pinned with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn (nvcc's
// default flags; no --use_fast_math), and float -> int conversions
// truncate as astype(int32) does, so z and both counts equal the plain
// version's bit for bit.
//
// Bound.  Per live token and cycle: five Threefry blocks (~80 integer
// operations each) and about 2 + log2 K scalar gathers of theta, phi and
// the word tables (L2-resident at the paper's widths); per position: z,
// the word and the mask read, z written.  At the paper's corpus the
// integer work and the position arrays take about the same time, both a
// few hundredths of a millisecond (PERF.md).
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

}  // namespace

extern "C" {

int sparse_mh_threads() { return kThreads; }

// accepts: three int32 counters the caller zeroed (word accepts, doc
// accepts, live positions).
int sparse_mh(const void* z, const void* docs, const void* mask, const void* theta,
                    const void* phi, const void* ids, const void* cnt, const void* tbl_a,
                    const void* tbl_b, void* z_out, void* accepts, int M, int L, int K,
                    int cap, int steps, int alias_mode, int span0, unsigned int s0,
                    unsigned int s1, unsigned int row0, float alpha, void* stream) {
  if (M <= 0 || L <= 0) return 0;
  const int parts = (L + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(M) * parts;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(cap) * 3 * sizeof(int);
  sparse_mh_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(z), static_cast<const int*>(docs),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(theta),
      static_cast<const float*>(phi), static_cast<const int*>(ids),
      static_cast<const int*>(cnt), static_cast<const float*>(tbl_a),
      static_cast<const int*>(tbl_b), static_cast<int*>(z_out),
      static_cast<int*>(accepts), L, K, cap, steps, alias_mode, span0, parts, s0, s1,
      row0, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
