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
// Design.  One thread block per row.  The TPU kernel gathers
// PL(i) = cs[i-1] with one-hot lane buckets (_gather_rows_blocked), a
// Mosaic idiom; here it is a direct read.  The scan runs in chunks of
// kThreads * kItems columns: each thread scans kItems consecutive values,
// a warp scan (shfl_up) and the warps' totals in order give the chunk's
// prefix, and a carry joins the chunks, so any Kp is taken.  cs goes to a
// scratch row in global memory (the wrapper allocates it), from which the
// gather reads; the row is L2-resident by then.  csL is a block sum of the
// lights' s.  Adds are pinned with __fadd_rn/__fsub_rn; the scan order
// differs from torch.cumsum's, so prob differs from the plain version by
// rounding of sums over up to Kp terms, while apos (integer arithmetic on
// nL and rank) is exact.  Bound: device memory (s and rank read, prob and
// apos written, 16 bytes per entry; the cs scratch adds 8 more).

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

}  // namespace

// Plain C interface, loaded with ctypes.  s: (B, Kp) float32, nL: (B,)
// int32, rank: (B, Kp) int32 -> prob (B, Kp) float32, apos (B, Kp) int32;
// cs: (B, Kp) float32 scratch.  Launches on the given stream, does not
// synchronise, returns cudaGetLastError() (0 on success).
extern "C" {

int alias_assemble(const void* s, const void* nL, const void* rank, void* prob,
                   void* apos, void* cs, int B, int Kp, void* stream) {
  if (B <= 0 || Kp <= 0) return 0;
  alias_assemble_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const int*>(nL),
      static_cast<const int*>(rank), static_cast<float*>(prob),
      static_cast<int*>(apos), static_cast<float*>(cs), Kp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
