// Batched inclusive rank over one packed bitset, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitset_rank.py::bitset_rank_kernel
// (launched by bitset_rank_pallas).  It computes what the plain version
// repro_torch/kernels/ref.py::bitset_rank_ref computes: for each position p,
//
//     rank(p) = popcount(bits[0..p])   (inclusive),   rank(p < 0) = 0,
//
// with p >= 32 * W read as the last bit (the rank of the whole set) and an
// empty bitset (W = 0) ranking every position 0.  Words are 32-bit, bit j of
// word w is bit 32w + j; torch stores them as int32.
//
// What bounds it on this card.  Bytes: every word is read once, each query
// reads its position and writes its rank, and the work is one __popc a word.
// At the paper's largest frontier (TPC-DI SF20, 64 probes over 2,411,006
// rows: 4,822,016 words, 19.3 MB) that is 5.8 us at 3.35 TB/s; at the
// per-hop baseline's Compas and Census frontiers (54 KB and 261 KB) the
// launch latency sets the time instead.
//
// What the design does about that.  Two launches on one stream, no host
// sync between them, both programmatic dependent launches (PDL): each is
// scheduled while the kernel before it still runs and waits
// (griddepcontrol.wait) before it touches anything that kernel may write,
// so neither pays a full launch latency after its predecessor ends.
//
//  1. rank_tiles_kernel: one CTA per tile of kTileWords = 8192 words (32 KB).
//     Each thread issues kVec = 8 independent 128-bit loads (the CTA reads a
//     contiguous 4 KB per step, every load in flight before the first popc),
//     so a grid of W / 8192 CTAs keeps the whole bitset in flight at once and
//     the read runs at HBM bandwidth.  The CTA popcounts its 4-word chunks
//     into shared memory, sums them per 32-word line (256 lines, one a
//     thread), block-scans the line counts and writes each line's exclusive
//     prefix within the tile (W / 32 ints, 3% of the words' bytes) and the
//     tile's total.
//  2. rank_answer_kernel: one thread per query.  Before its wait it reads
//     only operands launch 1 does not write: its position and its word's
//     128-byte line, whose words before its word it popcounts, plus its word
//     masked to bit p.  After the wait it loads its line prefix and each CTA
//     scans the tile totals (at most 8192, W < 2^26) into an exclusive
//     prefix in shared memory; the rank is tile prefix + line prefix + that
//     partial count.
//
// So every word is read from HBM once by launch 1, and a query re-reads at
// most one 128-byte line of its tile (32 words, not the 8192 of the tile),
// one line prefix and one position.  The prefix of the tile totals is
// hand-written device code, not a library scan.  The Pallas kernel kept the
// whole bitset in VMEM and summed it per query block on one core; a CTA here
// holds one tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                       // both kernels
constexpr int kVec = 8;                             // 128-bit loads a thread in launch 1
constexpr int kTileWords = kThreads * kVec * 4;     // 8192 words, 32 KB
constexpr int kLineWords = 32;                      // 128 bytes
constexpr int kLinesPerTile = kTileWords / kLineWords;   // 256: one line a thread
constexpr int kMaxTiles = 8192;                     // W < 2^26 words (32 W < 2^31)
constexpr int kWarps = kThreads / 32;

static_assert(kLinesPerTile == kThreads, "one line per thread in launch 1");

// Exclusive block scan of one int per thread; returns the thread's exclusive
// prefix and writes the block total to *total.  Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sum, int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, incl, s);
    if (lane >= s) incl += u;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_sum[lane] : 0;
#pragma unroll
    for (int s = 1; s < kWarps; s <<= 1) {
      const int u = __shfl_up_sync(0xFFFFFFFFu, t, s);
      if (lane >= s) t += u;
    }
    if (lane < kWarps) warp_sum[lane] = t;            // inclusive over warps
  }
  __syncthreads();
  const int excl = (warp > 0 ? warp_sum[warp - 1] : 0) + incl - v;
  *total = warp_sum[kWarps - 1];
  __syncthreads();                                    // warp_sum may be reused
  return excl;
}

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// Launch 1: tile totals and per-line exclusive prefixes within the tile.
// vec: words is 16-byte aligned, so whole chunks take 128-bit loads.
__global__ void __launch_bounds__(kThreads)
rank_tiles_kernel(const uint32_t* __restrict__ words, int W, int vec,
                  int* __restrict__ tile_total, int* __restrict__ line_prefix) {
  // the kernels before this one have ended and their writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // let launch 2 be scheduled now: it reads nothing of ours before its wait
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ __align__(16) int chunk[kTileWords / 4];   // popcount of each 4-word chunk
  __shared__ int warp_sum[kWarps];
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kTileWords;
  const int n = min(kTileWords, W - base);
  int cnt[kVec];
  if (vec && n == kTileWords) {
    const uint4* p = reinterpret_cast<const uint4*>(words + base);
    uint4 v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = __ldcs(p + i * kThreads + tid);   // read once
#pragma unroll
    for (int i = 0; i < kVec; ++i) cnt[i] = popc4(v[i]);
  } else {
    uint32_t v[kVec][4];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int w0 = (i * kThreads + tid) * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k) v[i][k] = w0 + k < n ? __ldcs(words + base + w0 + k) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      cnt[i] = __popc(v[i][0]) + __popc(v[i][1]) + __popc(v[i][2]) + __popc(v[i][3]);
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) chunk[i * kThreads + tid] = cnt[i];
  __syncthreads();
  // thread t owns line t of the tile: chunks 8t .. 8t + 7
  const int4 a = reinterpret_cast<const int4*>(chunk)[2 * tid];
  const int4 b = reinterpret_cast<const int4*>(chunk)[2 * tid + 1];
  const int line = a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w;
  int total;
  const int excl = block_exclusive_scan(line, warp_sum, &total);
  if (tid * kLineWords < n) line_prefix[blockIdx.x * kLinesPerTile + tid] = excl;
  if (tid == 0) tile_total[blockIdx.x] = total;
}

// Launch 2: one thread per query.
__global__ void __launch_bounds__(kThreads)
rank_answer_kernel(const uint32_t* __restrict__ words, int W, int vec,
                   const int* __restrict__ positions, int Q,
                   const int* __restrict__ tile_total, int tiles,
                   const int* __restrict__ line_prefix, int* __restrict__ out) {
  __shared__ int tile_prefix[kMaxTiles];
  __shared__ int warp_sum[kWarps];
  const int tid = threadIdx.x;
  const int q = blockIdx.x * kThreads + tid;
  // a dependent scheduled now waits for this whole grid before its first access
  asm volatile("griddepcontrol.launch_dependents;");

  // before the wait: only the operands, never launch 1's outputs
  bool live = false;
  int line = 0, partial = 0;
  if (q < Q && W > 0) {
    int p = positions[q];
    if (p >= 0) {
      live = true;
      if (p >= 32 * W) p = 32 * W - 1;
      const int w = p >> 5;
      line = w / kLineWords;
      const int first = line * kLineWords;
      const int off = w - first;
      const uint32_t last = 0xFFFFFFFFu >> (31 - (p & 31));
      if (vec && first + kLineWords <= W) {
        const uint4* lp = reinterpret_cast<const uint4*>(words + first);
        uint4 v[kLineWords / 4];
#pragma unroll
        for (int i = 0; i < kLineWords / 4; ++i) v[i] = lp[i];
#pragma unroll
        for (int i = 0; i < kLineWords / 4; ++i) {
          const uint32_t x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * i + k;
            const uint32_t m = j < off ? 0xFFFFFFFFu : (j == off ? last : 0u);
            partial += __popc(x[k] & m);
          }
        }
      } else {
        for (int j = 0; j < off; ++j) partial += __popc(words[first + j]);
        partial += __popc(words[w] & last);
      }
    }
  }

  // launch 1's tile totals and line prefixes are complete and visible after this
  asm volatile("griddepcontrol.wait;" ::: "memory");

  const int lp = live ? line_prefix[line] : 0;   // in flight during the scan
  // exclusive prefix of the tile totals, in shared memory: each thread
  // sums the `per` consecutive totals it owns, four loads in flight at once
  const int per = (tiles + kThreads - 1) / kThreads;
  const int lo = tid * per;
  int sum = 0;
  for (int k0 = 0; k0 < per; k0 += 4) {
    int v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = k0 + k < per && lo + k0 + k < tiles ? tile_total[lo + k0 + k] : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) sum += v[k];
  }
  int total;
  int run = block_exclusive_scan(sum, warp_sum, &total);
  for (int k = 0; k < per && lo + k < tiles; ++k) {
    tile_prefix[lo + k] = run;
    run += tile_total[lo + k];
  }
  __syncthreads();

  if (q < Q) out[q] = live ? tile_prefix[line / kLinesPerTile] + lp + partial : 0;
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 is success.  words (W,), positions (Q,) and
// out (Q,) lie on the device; workspace holds tiles + ceil(W / 32) ints
// (tile totals, then line prefixes) with tiles = ceil(W / 8192).  The caller
// checks types and contiguity and that 32 * W fits in an int.  Launch 1 runs
// when W > 0 and Q > 0, launch 2 when Q > 0.
int bitset_rank_launch(const void* words, int W, const void* positions, int Q, void* out,
                       void* workspace, void* stream) {
  if (W < 0 || Q < 0 || W > kMaxTiles * kTileWords) return (int)cudaErrorInvalidValue;
  if (Q == 0) return (int)cudaSuccess;
  const int tiles = (W + kTileWords - 1) / kTileWords;
  const int vec = (reinterpret_cast<uintptr_t>(words) % 16) == 0;
  int* tile_total = static_cast<int*>(workspace);
  int* line_prefix = tile_total + tiles;
  const uint32_t* w = static_cast<const uint32_t*>(words);
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  cudaError_t e = cudaSuccess;
  if (tiles > 0) {
    cfg.gridDim = dim3(tiles);
    e = cudaLaunchKernelEx(&cfg, rank_tiles_kernel, w, W, vec, tile_total, line_prefix);
    if (e != cudaSuccess) return (int)e;
  }
  cfg.gridDim = dim3((Q + kThreads - 1) / kThreads);
  e = cudaLaunchKernelEx(&cfg, rank_answer_kernel, w, W, vec, static_cast<const int*>(positions),
                         Q, static_cast<const int*>(tile_total), tiles,
                         static_cast<const int*>(line_prefix), static_cast<int*>(out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* bitset_rank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
