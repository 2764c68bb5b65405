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
// AND/OR per plane word a probe selects.  So it is bound by the plane bytes
// read from device memory (only the rows some probe of a block selects), and
// for sparse probes, where a hop touches a handful of rows, by the latency of
// the one launch and of the dependent row loads.
//
// What the design does about that.
//   * One launch walks all K hops.  Each CTA owns a block of BB probes and
//     keeps their frontier `cur` and the next frontier `nxt` in dynamic
//     shared memory (2 * BB * w_max words) for the whole walk: the mask is
//     read from device memory once and the result written once, never in
//     between.  The hop loop inside the CTA replaces the TPU's sequential
//     grid axes.
//   * Per-hop dims, no square padding: hop j reads its own (n_j, W_{j+1})
//     plane through a per-hop table of (address, rows, words) passed as a
//     kernel parameter, so the memoized planes are read where they lie,
//     with no copy and no host-to-device transfer before the launch.
//   * Threads stride over output words; for each 32-row group the CTA ORs the
//     BB probes' selector words (a shared-memory broadcast) and walks only
//     the set bits with __ffs.  A row no probe selects is never read, so a
//     sparse probe reads only its own rows.  A selected row is read as one
//     coalesced run of consecutive words per warp.
//   * The per-hop popcount (the fused bitset_rank) is a warp reduction of
//     __popc per probe after the hop's __syncthreads.
//
// Known limit, for a later change: one CTA per block of BB probes, so B = 64
// gives 8 CTAs on 132 SMs.  Splitting output words across CTAs with a
// grid-wide hop barrier, or a cluster sharing the frontier through DSMEM,
// would fill the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHops = 64;

// Per-hop (plane address, rows n_j, words W_{j+1}), passed by value as a
// kernel parameter (1.5 KB): no device table, no host-to-device copy.
struct HopTable {
  long long v[3 * kMaxHops];
};

template <int BB>
__global__ void __launch_bounds__(kThreads)
batched_walk_kernel(const uint32_t* __restrict__ mask, int B, int mask_words,
                    const HopTable meta, int K,
                    uint32_t* __restrict__ out, int out_words,
                    int* __restrict__ counts, int w_max) {
  extern __shared__ uint32_t smem[];
  uint32_t* cur = smem;
  uint32_t* nxt = smem + BB * w_max;
  const int b0 = blockIdx.x * BB;
  const int nb = min(BB, B - b0);
  const int tid = threadIdx.x;

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

    // contraction: every (probe, word) of nxt[:, :words] is written here
    for (int w = tid; w < words; w += kThreads) {
      uint32_t acc[BB];
#pragma unroll
      for (int b = 0; b < BB; ++b) acc[b] = 0u;
      const uint32_t* col = plane + w;
      for (int g = 0; g < groups; ++g) {
        uint32_t sel[BB];
        uint32_t any = 0u;
#pragma unroll
        for (int b = 0; b < BB; ++b) {
          sel[b] = cur[b * w_max + g];
          any |= sel[b];
        }
        if (g == groups - 1) any &= tail;  // rows past n_j are not in the plane
        while (any) {  // uniform across the CTA: every thread reads the same cur
          const int j = __ffs(any) - 1;
          any &= any - 1u;
          const uint32_t v = __ldg(col + (size_t)(g * 32 + j) * words);
#pragma unroll
          for (int b = 0; b < BB; ++b) acc[b] |= v & (0u - ((sel[b] >> j) & 1u));
        }
      }
#pragma unroll
      for (int b = 0; b < BB; ++b) nxt[b * w_max + w] = acc[b];
    }
    __syncthreads();

    // fused rank: per-probe frontier size of this hop
    const int warp = tid / 32, lane = tid % 32;
    for (int b = warp; b < nb; b += kThreads / 32) {
      int c = 0;
      for (int w = lane; w < words; w += 32) c += __popc(nxt[b * w_max + w]);
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, s);
      if (lane == 0) counts[(size_t)hop * B + b0 + b] = c;
    }
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
    __syncthreads();
  }

  // the final frontier: written to device memory once
  for (int i = tid; i < nb * out_words; i += kThreads) {
    const int b = i / out_words, w = i % out_words;
    out[(size_t)(b0 + b) * out_words + w] = cur[b * w_max + w];
  }
}

template <int BB>
cudaError_t launch(const uint32_t* mask, int B, int mask_words, const HopTable& meta,
                   int K, uint32_t* out, int out_words, int* counts, int w_max,
                   cudaStream_t stream) {
  const size_t smem = (size_t)2 * BB * w_max * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(batched_walk_kernel<BB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + BB - 1) / BB;
  batched_walk_kernel<BB><<<grid, kThreads, smem, stream>>>(
      mask, B, mask_words, meta, K, out, out_words, counts, w_max);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 is success.  `meta` is a HOST array of K
// (plane address, rows n_j, words W_{j+1}) int64 triples, K <= kMaxHops;
// the planes themselves are on the device.  `bb` is the probe
// block size, one of 1, 2, 4, 8; the caller checks that 2 * bb * w_max words
// fit in shared memory.
int batched_walk_launch(const void* mask, int B, int mask_words, const void* meta,
                        int K, void* out, int out_words, void* counts, int bb,
                        int w_max, void* stream) {
  const uint32_t* m = static_cast<const uint32_t*>(mask);
  if (K < 1 || K > kMaxHops) return (int)cudaErrorInvalidValue;
  HopTable mt;
  const long long* host = static_cast<const long long*>(meta);
  for (int i = 0; i < 3 * K; ++i) mt.v[i] = host[i];
  uint32_t* o = static_cast<uint32_t*>(out);
  int* c = static_cast<int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bb) {
    case 8: return (int)launch<8>(m, B, mask_words, mt, K, o, out_words, c, w_max, s);
    case 4: return (int)launch<4>(m, B, mask_words, mt, K, o, out_words, c, w_max, s);
    case 2: return (int)launch<2>(m, B, mask_words, mt, K, o, out_words, c, w_max, s);
    case 1: return (int)launch<1>(m, B, mask_words, mt, K, o, out_words, c, w_max, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* batched_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
