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
// The path runs it in two regimes: skinny probes (64 rows of A against a
// composed relation, a few set bits per row) and square compositions of
// relation planes that mostly hold one bit per row (a filter's or a join
// side's plane).  Both are select-ORs: no multiply, one AND/OR per B word a
// row of A selects.
//
// What bounds it on this card.  Bytes at the compositions: A read once, each
// selected B row once per tile of rows that selects it, C written once (the
// Census composition moves about 400 MB: 0.12 ms at 3.35 TB/s).  Latency at
// the probes, whose bytes take a fraction of a microsecond: the first design
// issued one B load per selected row and waited for it before the next, and
// ran 8 CTAs (M = 64 rows in tiles of 8) on 132 SMs.  It also re-walked A's
// groups once per 256-word pass over C (4 passes at Census's 1018 words).
//
// What the design does about that.
//   * A CTA owns kTM = 8 rows of C and a slice of SW consecutive words, and
//     does the whole contraction for them: blocks run in no order, so the
//     Pallas kernel's revisited output block along a sequential k axis
//     becomes a loop inside the CTA.
//   * Compaction, once per A tile.  Threads take runs of kGroupsPerThread
//     words of the tile's 8 A rows (independent loads, last word masked past
//     K), count the set bits of their OR, and after a block-wide scan place
//     each set bit in a shared list as (B row, 8-bit pattern over the tile's
//     rows).  A list holds kCap entries; a dense tile is walked in rounds, as
//     many as its set bits need (each round takes the longest prefix of
//     threads whose entries fit).  A sparse tile is one round.
//   * One pass over the output words with many loads in flight.  A thread
//     owns NWT words of the slice (NWT = 1, 2 or 4, kept in registers across
//     rounds) and walks the list kUnroll entries at a time: it issues
//     kUnroll x NWT independent __ldg's, then ORs each into the accumulators
//     of the rows the entry's pattern names.  Neighbouring threads read
//     neighbouring words of one B row, so every load and store coalesces.
//   * The grid fills the card.  The launcher keeps whole rows in one slice
//     (up to 1024 words, so A is read once) while the row tiles alone give at
//     least 2 x 132 CTAs, as at the compositions; with fewer tiles (the
//     probes, M = 64) it halves the slice, down to 32 words, and splits each
//     list across S = 256 / (32 x slices of a warp) groups of threads, which
//     merge their partial words with shared atomicOr before the store.
//   * Overlap of A and B traffic comes from occupancy, not from a staged
//     ring: a CTA needs 10-15 KB of shared memory and at most 85 registers a
//     thread (128 with four words a thread), so three CTAs (two) share an SM
//     and one's compaction (A loads) runs beside another's contraction (B
//     loads).  A two-stage cp.async ring of A tiles in a persistent CTA would
//     do the same inside one CTA; it needs its own path for Census's rows
//     (4072 bytes, not a multiple of 16) and is left open: the Census
//     composition already runs within 1.2x of its byte bound.
//
// What is still open: dense A re-reads B once per tile of 8 rows (an unpack
// to int8 and a wgmma product would do better there).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 8;               // rows of C per CTA
constexpr int kGroupsPerThread = 4;  // a round scans up to 1024 A words per row
constexpr int kCap = 2048;           // list entries per round
constexpr int kUnroll = 8;           // list entries per batch of loads

// Exclusive block-wide prefix sum of one int per thread.  Contains two
// __syncthreads; `sums` must not be written again before the caller's next
// barrier.
__device__ __forceinline__ int block_exclusive_scan(int x, int* sums) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = x;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, s);
    if (lane >= s) incl += y;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? sums[lane] : 0;
    int w_incl = v;
#pragma unroll
    for (int s = 1; s < kWarps; s <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w_incl, s);
      if (lane >= s) w_incl += y;
    }
    if (lane < kWarps) sums[lane] = w_incl - v;
  }
  __syncthreads();
  return sums[warp] + incl - x;
}

// S groups of threads split each list; a thread owns NWT words of the
// CTA's slice of SW = (kThreads / S) * NWT words.
template <int S, int NWT>
__global__ void __launch_bounds__(kThreads, NWT == 4 ? 2 : 3)
bitmatmul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 uint32_t* __restrict__ c, int M, int Kw, int K, int Nw) {
  constexpr int kTps = kThreads / S;  // threads per list slice
  constexpr int kSW = kTps * NWT;     // words of C per CTA
  __shared__ int rows[kCap];
  __shared__ uint8_t pats[kCap];
  __shared__ uint32_t merged[S > 1 ? kTM * kSW : 1];
  __shared__ int sums[kWarps];
  __shared__ int s_n;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kTM;
  const int nm = min(kTM, M - m0);
  if (nm <= 0) return;  // uniform: M = 0 launches one empty CTA
  const int ws0 = blockIdx.y * kSW;
  const int slice = tid / kTps, wt = tid % kTps;
  const uint32_t tail = (K % 32) ? ((1u << (K % 32)) - 1u) : 0xFFFFFFFFu;

  if (S > 1) {
    for (int i = tid; i < kTM * kSW; i += kThreads) merged[i] = 0u;
  }
  uint32_t acc[NWT][kTM];
#pragma unroll
  for (int j = 0; j < NWT; ++j)
#pragma unroll
    for (int r = 0; r < kTM; ++r) acc[j][r] = 0u;

  for (int g_begin = 0; g_begin < Kw;) {  // uniform: one round per list fill
    // compaction: this thread's A words of the tile's rows, all loads at once
    const int g0 = g_begin + tid * kGroupsPerThread;
    uint32_t aw[kGroupsPerThread][kTM];
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < kGroupsPerThread; ++i) {
      const int g = g0 + i;
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
        uint32_t v = (g < Kw && r < nm) ? __ldg(a + (size_t)(m0 + r) * Kw + g) : 0u;
        aw[i][r] = g == Kw - 1 ? v & tail : v;  // bits past K select nothing
      }
    }
#pragma unroll
    for (int i = 0; i < kGroupsPerThread; ++i) {
      uint32_t any = 0u;
#pragma unroll
      for (int r = 0; r < kTM; ++r) any |= aw[i][r];
      cnt += __popc(any);
    }
    if (tid == 0) s_n = 0;
    const int off = block_exclusive_scan(cnt, sums);
    const bool fits = off + cnt <= kCap;
    if (fits) atomicMax(&s_n, off + cnt);
    const int n_fit = __syncthreads_count(fits);  // fitting threads are a prefix
    if (fits) {
      int p = off;
#pragma unroll
      for (int i = 0; i < kGroupsPerThread; ++i) {
        uint32_t any = 0u;
#pragma unroll
        for (int r = 0; r < kTM; ++r) any |= aw[i][r];
        while (any) {
          const int j = __ffs(any) - 1;
          any &= any - 1u;
          uint32_t pat = 0u;
#pragma unroll
          for (int r = 0; r < kTM; ++r) pat |= ((aw[i][r] >> j) & 1u) << r;
          rows[p] = (g0 + i) * 32 + j;
          pats[p] = (uint8_t)pat;
          ++p;
        }
      }
    }
    __syncthreads();
    const int n = s_n;

    // contraction: kUnroll x NWT independent B loads, then the ORs
    for (int e0 = slice * kUnroll; e0 < n; e0 += S * kUnroll) {
      int row[kUnroll];
      uint32_t pat[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool live = e0 + u < n;
        row[u] = live ? rows[e0 + u] : 0;
        pat[u] = live ? pats[e0 + u] : 0u;
      }
      uint32_t v[kUnroll][NWT];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < NWT; ++j) {
          const int w = ws0 + j * kTps + wt;
          v[u][j] = (pat[u] && w < Nw) ? __ldg(b + (size_t)row[u] * Nw + w) : 0u;
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < NWT; ++j)
#pragma unroll
          for (int r = 0; r < kTM; ++r) acc[j][r] |= v[u][j] & (0u - ((pat[u] >> r) & 1u));
    }
    __syncthreads();  // the list is read; the next round may overwrite it
    g_begin += n_fit * kGroupsPerThread;
  }

  if (S > 1) {  // merge the list slices' partial words
#pragma unroll
    for (int r = 0; r < kTM; ++r)
      if (acc[0][r]) atomicOr(&merged[r * kSW + wt], acc[0][r]);
    __syncthreads();
    for (int i = tid; i < nm * kSW; i += kThreads) {
      const int r = i / kSW, w = ws0 + i % kSW;
      if (w < Nw) c[(size_t)(m0 + r) * Nw + w] = merged[i];
    }
  } else {
#pragma unroll
    for (int j = 0; j < NWT; ++j) {
      const int w = ws0 + j * kTps + wt;
      if (w < Nw) {
#pragma unroll
        for (int r = 0; r < kTM; ++r)
          if (r < nm) c[(size_t)(m0 + r) * Nw + w] = acc[j][r];
      }
    }
  }
}

template <int S, int NWT>
cudaError_t launch(const uint32_t* a, const uint32_t* b, uint32_t* c, int M, int Kw, int K,
                   int Nw, int word_slices, cudaStream_t stream) {
  const dim3 grid(M > 0 ? (M + kTM - 1) / kTM : 1, word_slices);
  bitmatmul_kernel<S, NWT><<<grid, kThreads, 0, stream>>>(a, b, c, M, Kw, K, Nw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 is success.  The caller checks shapes,
// types and contiguity: a (M, Kw), b (K, Nw), c (M, Nw), all on the device,
// and chooses the geometry: `slice_words` SW of C per CTA (1024, 512, 256,
// 128, 64 or 32) and `word_slices` = ceil(Nw / SW) (at least 1).
int bitmatmul_launch(const void* a, const void* b, void* c, int M, int Kw, int K,
                     int Nw, int slice_words, int word_slices, void* stream) {
  if (M < 0 || Kw < 0 || K < 0 || Nw < 0 || word_slices < 1 || word_slices > 65535)
    return (int)cudaErrorInvalidValue;
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  uint32_t* pc = static_cast<uint32_t*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slice_words) {
    case 1024: return (int)launch<1, 4>(pa, pb, pc, M, Kw, K, Nw, word_slices, s);
    case 512: return (int)launch<1, 2>(pa, pb, pc, M, Kw, K, Nw, word_slices, s);
    case 256: return (int)launch<1, 1>(pa, pb, pc, M, Kw, K, Nw, word_slices, s);
    case 128: return (int)launch<2, 1>(pa, pb, pc, M, Kw, K, Nw, word_slices, s);
    case 64: return (int)launch<4, 1>(pa, pb, pc, M, Kw, K, Nw, word_slices, s);
    case 32: return (int)launch<8, 1>(pa, pb, pc, M, Kw, K, Nw, word_slices, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* bitmatmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
