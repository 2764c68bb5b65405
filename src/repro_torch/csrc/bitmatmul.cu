// Packed boolean-semiring matrix product for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitmatmul.py::bitmatmul_kernel
// (launched by bitmatmul_pallas).  It computes what the plain version
// repro_torch/kernels/ref.py::bitmatmul_ref computes,
//
//     C[i, :] = OR over k < K with bit k of A[i] set of B[k, :]
//
// for A (M, Kw) packed words, B (K, Nw) packed words, C (M, Nw), with
// (Kw - 1) * 32 < K <= Kw * 32.  Bits of A past K select nothing.  Words are
// 32-bit, bit j of word w is column 32w + j; torch stores them as int32 and
// this file reads them as uint32.
//
// The path runs it in two regimes: skinny probes (B = 64 rows of A against a
// composed relation, a few set bits per row) and square compositions of
// relation planes that mostly hold one bit per row (a filter's or a join
// side's plane).  Both are select-ORs: no multiply, one AND/OR per B word a
// row of A selects.
//
// What bounds it on this card.  Bytes: each selected B row is streamed once
// per tile of rows that selects it, each A word is read once and each C word
// written once.  For the sparse operands of the path the logical operations
// are fewer than the words moved, so the memory rate, and for small shapes
// the launch latency, bound it.
//
// What the design does about that.
//   * The Pallas grid ORed partial tiles into a revisited output block along
//     a sequential k axis.  Blocks run in no order here, so the whole
//     contraction of one output tile stays inside one CTA: a CTA owns kTM
//     rows of C and walks every output word of them, so A is read once.
//   * The CTA stages its rows' A words (in chunks of kKC words) in shared
//     memory and compacts the 32-row groups that any of its rows selects into
//     a list.  Threads then walk only those groups, and in each only the set
//     bits (__ffs), so an unselected B row is never read: a one-bit-per-row
//     plane reads kTM B rows per tile.
//   * Each thread owns one output word per step (strided by kThreads); a
//     warp's threads read neighbouring words of the same B row, so every
//     B read and C write is one coalesced run.
//   * The last A word is masked past K, so stray bits select nothing.
//
// Known limits, for a later change: dense A re-reads B once per tile of kTM
// rows (an unpack to int8 and a wgmma product, or a ballot-driven warp
// scheme, would do better there); a skinny product of M = 64 rows runs
// 8 CTAs on 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 8;      // rows of C per CTA
constexpr int kKC = 1024;   // A words per row staged at a time (32 KB for kTM rows)

__global__ void __launch_bounds__(kThreads)
bitmatmul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 uint32_t* __restrict__ c, int M, int Kw, int K, int Nw) {
  __shared__ uint32_t sA[kTM * kKC];
  __shared__ int groups[kKC];
  __shared__ int n_groups;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kTM;
  const int nm = min(kTM, M - m0);
  const int n_chunks = (Kw + kKC - 1) / kKC;
  const uint32_t tail = (K % 32) ? ((1u << (K % 32)) - 1u) : 0xFFFFFFFFu;

  for (int wt = 0; wt < Nw; wt += kThreads) {
    const int w = wt + tid;
    uint32_t acc[kTM];
#pragma unroll
    for (int r = 0; r < kTM; ++r) acc[r] = 0u;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int k0 = ch * kKC;
      const int nk = min(kKC, Kw - k0);
      if (n_chunks > 1 || wt == 0) {  // uniform: every thread takes the same branch
        __syncthreads();              // the previous chunk is no longer read
        if (tid == 0) n_groups = 0;
        for (int i = tid; i < kTM * nk; i += kThreads) {
          const int r = i / nk, g = i % nk;
          uint32_t v = 0u;
          if (r < nm) {
            v = a[(size_t)(m0 + r) * Kw + k0 + g];
            if (k0 + g == Kw - 1) v &= tail;  // bits past K select nothing
          }
          sA[r * kKC + g] = v;
        }
        __syncthreads();
        for (int g = tid; g < nk; g += kThreads) {
          uint32_t any = 0u;
#pragma unroll
          for (int r = 0; r < kTM; ++r) any |= sA[r * kKC + g];
          if (any) groups[atomicAdd(&n_groups, 1)] = g;  // order is free: OR commutes
        }
        __syncthreads();
      }
      if (w < Nw) {
        const int ng = n_groups;
        for (int e = 0; e < ng; ++e) {
          const int g = groups[e];
          uint32_t sel[kTM];
          uint32_t any = 0u;
#pragma unroll
          for (int r = 0; r < kTM; ++r) {
            sel[r] = sA[r * kKC + g];
            any |= sel[r];
          }
          const uint32_t* col = b + (size_t)(k0 + g) * 32 * Nw + w;
          while (any) {
            const int j = __ffs(any) - 1;
            any &= any - 1u;
            const uint32_t v = __ldg(col + (size_t)j * Nw);
#pragma unroll
            for (int r = 0; r < kTM; ++r) acc[r] |= v & (0u - ((sel[r] >> j) & 1u));
          }
        }
      }
    }
    if (w < Nw) {
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
        if (r < nm) c[(size_t)(m0 + r) * Nw + w] = acc[r];
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 is success.  The caller checks shapes,
// types and contiguity: a (M, Kw), b (K, Nw), c (M, Nw), all on the device.
int bitmatmul_launch(const void* a, const void* b, void* c, int M, int Kw, int K,
                     int Nw, void* stream) {
  if (M < 0 || Kw < 0 || K < 0 || Nw < 0) return (int)cudaErrorInvalidValue;
  const int grid = M > 0 ? (M + kTM - 1) / kTM : 1;
  bitmatmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(c), M, Kw, K, Nw);
  return (int)cudaGetLastError();
}

const char* bitmatmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
