// Fused K-hop batched record walk for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/batched_walk.py::batched_walk_kernel
// (launched by batched_walk_pallas).  It computes what the plain version
// repro_torch/kernels/ref.py::batched_walk_ref computes: B packed probe masks
// walk K hops of (OR, AND) contraction through packed relation bitplanes,
//
//     cur_{j+1}[b, :] = OR over rows r of hop j with bit r of cur_j[b] set
//                       of plane_j[r, :]
//
// and counts[j, b] = popcount(cur_{j+1}[b, :]).  Words are 32-bit, bit i of
// word w is column 32w + i; torch stores them as int32 and this file reads
// them as uint32.
//
// What bounds it on this card.  The work is a select-OR: no multiply, one
// AND/OR per plane word a probe selects.  The bytes it must move are the
// plane rows some probe selects, which on the main path (B = 64 probes of
// about 8 rows, K = 7 hops at Compas) is well under a megabyte per hop: the
// byte bound is about a microsecond.  So what bounds it in practice is
// latency: the K hops are sequential, and within a hop the row loads.  The
// first design issued one load per selected row and waited for it before
// the next (one load in flight per thread), had every thread rescan every
// 32-row group of the frontier, and ran B/8 CTAs (8 at B = 64) on 132 SMs.
//
// What the design does about that.
//   * One launch walks all K hops.  Each CTA owns a block of BB probes and
//     keeps their frontier `cur` and the next frontier `nxt` in dynamic
//     shared memory for the whole walk: the masks are read from device
//     memory once and the result written once.  Hop j reads its own
//     (n_j, W_{j+1}) plane through a per-hop table of (address, rows, words)
//     passed as a kernel parameter: no square padding, no copy.
//   * Compaction, once per hop and CTA.  Threads take runs of kGroupsPerThread
//     32-row groups, OR the block's selector words (rows past n_j masked) and
//     count the set bits; a block-wide scan of the counts places each set bit
//     in a shared list as one word, row | (bit pattern over the BB probes) << 24.
//     The list holds `cap` entries (chosen by the launcher); a dense frontier
//     is walked in rounds: a round takes the longest prefix of threads whose
//     entries fit (__syncthreads_count), the next round starts where it
//     stopped.  A thread's entries never exceed 32 * kGroupsPerThread <= cap,
//     so every round makes progress.  Rows fit in 24 bits because the
//     launcher bounds the frontier by shared memory (n_j <= 32 * w_max < 2^24).
//   * Many loads in flight.  Threads stride over output words (split into
//     `slices` groups of threads that each take every slices-th run of kUnroll
//     entries, when the hop is narrower than the CTA); a thread issues kUnroll
//     independent __ldg's of its word of kUnroll selected rows, then ORs each
//     into the accumulators of the probes its pattern names.  A warp reads
//     neighbouring words of one row: every load is one coalesced run.  Slices
//     merge into `nxt` with shared atomicOr; rounds OR into it.
//   * The card is filled by the probe block: the launcher takes the largest
//     BB of 8, 4, 2, 1 that still leaves at least one CTA per SM, so B = 64
//     runs 64 CTAs of one probe each (rows shared between probes then come
//     from the 50 MB L2), while B >= 1049 shares each row load among 8 probes.
//   * The per-hop popcount (the fused bitset_rank) is a warp reduction of
//     __popc over the finished `nxt`, summed per probe in shared memory.
//
// What is still open.  One CTA walks a probe block's whole frontier; where
// one block's threads cannot cover the words (a dense frontier 1018 words
// wide, as Census's), splitting the words across a thread-block cluster that
// exchanges the frontier through distributed shared memory between hops
// would add SMs per probe.  Not done: on the main path a hop is one or two
// load round trips per CTA, which a cluster barrier per hop would not beat.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHops = 64;
constexpr int kGroupsPerThread = 4;  // a round scans up to 1024 groups (32,768 rows)
constexpr int kUnroll = 8;           // independent plane loads in flight per thread
constexpr uint32_t kRowMask = 0xFFFFFFu;

// Per-hop (plane address, rows n_j, words W_{j+1}), passed by value as a
// kernel parameter (1.5 KB): no device table, no host-to-device copy.
struct HopTable {
  long long v[3 * kMaxHops];
};

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

template <int BB>
__device__ __forceinline__ uint32_t group_any(const uint32_t* cur, int w_max, int g,
                                              int groups, uint32_t tail) {
  uint32_t any = 0u;
#pragma unroll
  for (int b = 0; b < BB; ++b) any |= cur[b * w_max + g];
  return g == groups - 1 ? any & tail : any;  // rows past n_j are not in the plane
}

template <int BB>
__global__ void __launch_bounds__(kThreads)
batched_walk_kernel(const uint32_t* __restrict__ mask, int B, int mask_words,
                    const HopTable meta, int K,
                    uint32_t* __restrict__ out, int out_words,
                    int* __restrict__ counts, int w_max, int cap, int slices) {
  extern __shared__ uint32_t smem[];
  uint32_t* cur = smem;
  uint32_t* nxt = smem + BB * w_max;
  uint32_t* list = smem + 2 * BB * w_max;  // cap entries: row | pattern << 24
  __shared__ int sums[kWarps];
  __shared__ int s_n;
  __shared__ int s_cnt[BB];
  const int b0 = blockIdx.x * BB;
  const int nb = min(BB, B - b0);
  const int tid = threadIdx.x;
  const int tps = kThreads / slices;  // threads per slice
  const int slice = tid / tps, wt = tid % tps;

  // the probe block's masks: read from device memory once
  for (int i = tid; i < BB * w_max; i += kThreads) {
    const int b = i / w_max, w = i % w_max;
    cur[i] = (b < nb && w < mask_words) ? mask[(size_t)(b0 + b) * mask_words + w] : 0u;
  }
  __syncthreads();

  for (int hop = 0; hop < K; ++hop) {
    const uint32_t* plane = reinterpret_cast<const uint32_t*>(meta.v[3 * hop]);
    const int rows = (int)meta.v[3 * hop + 1];
    const int words = (int)meta.v[3 * hop + 2];
    const int groups = (rows + 31) / 32;
    const uint32_t tail = (rows % 32) ? ((1u << (rows % 32)) - 1u) : 0xFFFFFFFFu;

    for (int i = tid; i < BB * words; i += kThreads) nxt[(i / words) * w_max + i % words] = 0u;
    if (tid < BB) s_cnt[tid] = 0;
    __syncthreads();  // an empty hop (n_j = 0) reaches the rank below with no round

    for (int g_begin = 0; g_begin < groups;) {  // uniform: one round per list fill
      // compaction: count this thread's set bits, place them after a scan
      const int g0 = g_begin + tid * kGroupsPerThread;
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < kGroupsPerThread; ++i) {
        if (g0 + i < groups) cnt += __popc(group_any<BB>(cur, w_max, g0 + i, groups, tail));
      }
      if (tid == 0) s_n = 0;
      const int off = block_exclusive_scan(cnt, sums);
      const bool fits = off + cnt <= cap;
      if (fits) atomicMax(&s_n, off + cnt);
      const int n_fit = __syncthreads_count(fits);  // fitting threads are a prefix
      if (fits) {
        int p = off;
        for (int i = 0; i < kGroupsPerThread; ++i) {
          const int g = g0 + i;
          if (g >= groups) break;
          uint32_t any = group_any<BB>(cur, w_max, g, groups, tail);
          while (any) {
            const int j = __ffs(any) - 1;
            any &= any - 1u;
            uint32_t pat = 0u;
#pragma unroll
            for (int b = 0; b < BB; ++b) pat |= ((cur[b * w_max + g] >> j) & 1u) << b;
            list[p++] = (uint32_t)(g * 32 + j) | (pat << 24);
          }
        }
      }
      __syncthreads();
      const int n = s_n;

      // contraction: kUnroll independent row loads, then the ORs
      for (int w = wt; w < words; w += tps) {
        uint32_t acc[BB];
#pragma unroll
        for (int b = 0; b < BB; ++b) acc[b] = 0u;
        const uint32_t* col = plane + w;
        for (int e0 = slice * kUnroll; e0 < n; e0 += slices * kUnroll) {
          uint32_t ent[kUnroll], v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) ent[u] = e0 + u < n ? list[e0 + u] : 0u;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            v[u] = e0 + u < n ? __ldg(col + (size_t)(ent[u] & kRowMask) * words) : 0u;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const uint32_t pat = ent[u] >> 24;
#pragma unroll
            for (int b = 0; b < BB; ++b) acc[b] |= v[u] & (0u - ((pat >> b) & 1u));
          }
        }
#pragma unroll
        for (int b = 0; b < BB; ++b) {
          if (slices > 1) {
            if (acc[b]) atomicOr(&nxt[b * w_max + w], acc[b]);
          } else {
            nxt[b * w_max + w] |= acc[b];
          }
        }
      }
      __syncthreads();  // the list is read; the next round may overwrite it
      g_begin += n_fit * kGroupsPerThread;
    }

    // fused rank: per-probe frontier size of this hop
    for (int b = 0; b < nb; ++b) {
      int c = 0;
      for (int w = tid; w < words; w += kThreads) c += __popc(nxt[b * w_max + w]);
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, s);
      if (tid % 32 == 0 && c) atomicAdd(&s_cnt[b], c);
    }
    __syncthreads();
    if (tid < nb) counts[(size_t)hop * B + b0 + tid] = s_cnt[tid];
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  __syncthreads();

  // the final frontier: written to device memory once
  for (int i = tid; i < nb * out_words; i += kThreads) {
    const int b = i / out_words, w = i % out_words;
    out[(size_t)(b0 + b) * out_words + w] = cur[b * w_max + w];
  }
}

template <int BB>
cudaError_t launch(const uint32_t* mask, int B, int mask_words, const HopTable& meta,
                   int K, uint32_t* out, int out_words, int* counts, int w_max, int cap,
                   int slices, cudaStream_t stream) {
  const size_t smem = ((size_t)2 * BB * w_max + cap) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(batched_walk_kernel<BB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + BB - 1) / BB;
  batched_walk_kernel<BB><<<grid, kThreads, smem, stream>>>(
      mask, B, mask_words, meta, K, out, out_words, counts, w_max, cap, slices);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 is success.  `meta` is a HOST array of K
// (plane address, rows n_j, words W_{j+1}) int64 triples, K <= kMaxHops;
// the planes themselves are on the device.  The launcher chooses the
// geometry and checks that it fits in shared memory: `bb` probes per CTA
// (1, 2, 4 or 8), `cap` list entries (>= 32 * kGroupsPerThread), and
// `slices` (1, 2, 4 or 8) groups of threads splitting each row list.
int batched_walk_launch(const void* mask, int B, int mask_words, const void* meta,
                        int K, void* out, int out_words, void* counts, int bb,
                        int w_max, int cap, int slices, void* stream) {
  const uint32_t* m = static_cast<const uint32_t*>(mask);
  if (K < 1 || K > kMaxHops || cap < 32 * kGroupsPerThread || w_max > (1 << 19) ||
      (slices != 1 && slices != 2 && slices != 4 && slices != 8))
    return (int)cudaErrorInvalidValue;
  HopTable mt;
  const long long* host = static_cast<const long long*>(meta);
  for (int i = 0; i < 3 * K; ++i) mt.v[i] = host[i];
  uint32_t* o = static_cast<uint32_t*>(out);
  int* c = static_cast<int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bb) {
    case 8: return (int)launch<8>(m, B, mask_words, mt, K, o, out_words, c, w_max, cap, slices, s);
    case 4: return (int)launch<4>(m, B, mask_words, mt, K, o, out_words, c, w_max, cap, slices, s);
    case 2: return (int)launch<2>(m, B, mask_words, mt, K, o, out_words, c, w_max, cap, slices, s);
    case 1: return (int)launch<1>(m, B, mask_words, mt, K, o, out_words, c, w_max, cap, slices, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* batched_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
