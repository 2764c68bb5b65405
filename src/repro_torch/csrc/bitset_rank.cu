// Batched inclusive rank over one packed bitset, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitset_rank.py::bitset_rank_kernel
// (launched by bitset_rank_pallas).  It computes what the plain version
// repro_torch/kernels/ref.py::bitset_rank_ref computes: for each position p,
//
//     rank(p) = popcount(bits[0..p])   (inclusive),   rank(p < 0) = 0,
//
// with p >= 32 * W read as the last bit (the rank of the whole set).  Words
// are 32-bit, bit j of word w is bit 32w + j; torch stores them as int32.
//
// What bounds it on this card.  Bytes and latency: every word is read once
// for the prefix and each query reads one word and one prefix entry.  The
// work is one __popc per word and per query.  At the shapes the per-hop
// baseline gives it (one frontier of B * W words, B queries) the launch
// latency dominates.
//
// What the design does about that.  One launch, one CTA of kThreads threads:
// the CTA takes the words in chunks of kChunk, each thread popcounts kItems
// consecutive words, and a block scan (warp shuffles, then one warp over the
// warp totals) turns them into the chunk's exclusive word prefix in shared
// memory, carried across chunks.  Each query whose word lies in the chunk is
// then answered from shared memory: prefix of its word plus the popcount of
// its word masked to bit p.  The Pallas kernel recomputed the prefix per
// query block; here it is computed once.
//
// Known limit, for a later change: one CTA reads the whole bitset, so a W of
// millions of words runs at one SM's bandwidth.  A two-pass scan through
// device memory over many CTAs would lift that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;  // 8192 words, 32 KB of prefix

__global__ void __launch_bounds__(kThreads)
bitset_rank_kernel(const uint32_t* __restrict__ words, int W,
                   const int* __restrict__ positions, int Q, int* __restrict__ out) {
  __shared__ int prefix[kChunk];
  __shared__ int warp_total[kThreads / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  for (int q = tid; q < Q; q += kThreads) out[q] = 0;  // p < 0, or an empty bitset

  int carry = 0;  // set bits before the chunk; the same in every thread
  for (int c0 = 0; c0 < W; c0 += kChunk) {
    const int n = min(kChunk, W - c0);
    const int base = tid * kItems;
    int cnt[kItems];
    int local = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      cnt[i] = (base + i < n) ? __popc(words[c0 + base + i]) : 0;
      local += cnt[i];
    }
    // block exclusive scan of the per-thread totals
    int incl = local;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, s);
      if (lane >= s) incl += v;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int t = warp_total[lane];
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, t, s);
        if (lane >= s) t += v;
      }
      warp_total[lane] = t;  // inclusive over warps
    }
    __syncthreads();
    int run = carry + (warp > 0 ? warp_total[warp - 1] : 0) + incl - local;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (base + i < n) prefix[base + i] = run;
      run += cnt[i];
    }
    const int chunk_total = warp_total[kThreads / 32 - 1];
    __syncthreads();
    for (int q = tid; q < Q; q += kThreads) {
      int p = positions[q];
      if (p < 0) continue;
      if (p >= 32 * W) p = 32 * W - 1;
      const int w = p >> 5;
      if (w < c0 || w >= c0 + n) continue;
      const uint32_t mask = 0xFFFFFFFFu >> (31 - (p & 31));
      out[q] = prefix[w - c0] + __popc(words[w] & mask);
    }
    carry += chunk_total;
    __syncthreads();  // prefix and warp_total are rewritten by the next chunk
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 is success.  words (W,), positions (Q,) and
// out (Q,) lie on the device; the caller checks types and contiguity and
// that 32 * W fits in an int.
int bitset_rank_launch(const void* words, int W, const void* positions, int Q, void* out,
                       void* stream) {
  if (W < 0 || Q < 0) return (int)cudaErrorInvalidValue;
  bitset_rank_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), W, static_cast<const int*>(positions), Q,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}

const char* bitset_rank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
