// An equi-join's row pairs from its stably sorted right keys, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: repro/dataprep/ops.py::join matches with numpy
// (argsort, two searchsorteds, two repeats, a stack).  The port's first
// version (kept, corrected to numpy's key order, as
// repro_torch/kernels/ref.py::join_match_ref, the CPU's path) did the same
// with torch: two searchsorteds, two repeat_interleaves, a gather of the
// sorted keys, a gather of the order, a stack and a cast, about 1.0-1.1 ms
// of a 2.85 ms TPC-DI SF20 capture against a byte bound of 0.03 ms.  For L
// left keys, the R right keys in stable sorted order and the sort's int64
// order, it writes each left row's match count and exclusive offset
// (int32) and the (total, 2) int32 pairs (left row, right row): left rows
// ascending, each row's matches in sorted order, which is repro's order.
//
// Keys compare through order_key: the float's bits made sortable as
// unsigned, every NaN one key past +inf and -0.0 the key of 0.0, numpy's
// order (a NaN key matches the NaN run, -0.0 matches 0.0).
//
// What bounds it on this card.  Not bytes: at the SF20 shape (2,411,006
// left keys, 2,601,648 right ones, every left key matching one right key)
// each operand read once and each output written once is about 100 MB: the
// keys (9.6 + 10.4 MB), the order (20.8 MB), counts and offsets written and
// read (39 MB) and the pairs (19.3 MB), 0.03 ms at 3.35 TB/s.  What costs is
// the number of scattered loads: every lane of a warp reads its own 32-byte
// sector of the sorted keys, so each load instruction takes 32 of the L1's
// line lookups, about 17 us a load a key at SF20 (one load fewer a key took
// the search from 0.0996 to 0.0830 ms).  A binary search takes 22 a key.
//
// What the design does about that.  Launch 1 (match_count_kernel) is a
// persistent grid that takes tiles of kTile left rows by an atomic ticket.
// Each CTA first copies every stride-th sorted key and the last (stride a
// power of two, at most kMaxSplit splitters: 2,542 keys, 10 KB at SF20)
// into shared memory, and a thread finds its kItems keys' splitters side by
// side in a branch-free search of the same trip count for all.  Between two
// splitters it guesses the place by their values (exact for unique integer
// keys, as TPC-DI's) and gallops from the guess: a good guess costs three
// loads a key (the guess, the key before it, the key after it for the run's
// end), a bad one 2 log2(stride) at most; a long run's end is found by
// galloping, 2 log2(count) loads.  Halving the 1,024 places below a
// splitter instead took 0.258 ms at SF20, the guess 0.083 ms (0.158 ms
// where the right keys are random, not unique).  The tile's counts are
// scanned in the CTA and across tiles by a single-pass decoupled look-back
// (a warp reads 32 tiles' status words a step, flag and sum in one 64-bit
// word); the last tile writes the total, which the host reads once.  Launch
// 2 (match_write_kernel) is balanced by output, not by left row: a CTA owns
// kOutTile consecutive pairs, finds the left rows they span by two warp-wide
// 32-way searches of the offsets, stages those rows' offsets in shared
// memory when they fit, and each thread finds its pairs' rows by a
// branch-free search there and writes (row, order[start + j]) as one 8-byte
// store; the order's random reads bound it (0.039 ms at SF20).  A key with
// 10^6 matches costs what 10^6 unique matches cost, with no branch on the
// join's shape.  Both launches are programmatic dependent launches, as
// join_gather is.  Tried and dropped: 512 splitters (0.094 ms at SF20, 0.19
// on random keys), a 16-byte window of four keys around each guess (0.076
// and 0.195 ms: 60 registers), 8 CTAs an SM forced by launch bounds (0.086
// and 0.213), 16 pairs a thread in launch 2 (0.073 ms).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                        // left keys a thread searches side by side
constexpr int kTile = kThreads * kItems;         // left rows a tile of launch 1
constexpr int kMaxSplit = 4096;                  // splitters a CTA keeps in shared memory
constexpr int kOutItems = 8;                     // pairs a thread of launch 2 writes
constexpr int kOutTile = kThreads * kOutItems;   // consecutive pairs a CTA of launch 2 owns
constexpr int kMaxRows = INT32_MAX - kOutTile;   // rows and pairs the int32 indexes take
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 62;  // the tile's own sum is published
constexpr unsigned long long kPrefix = 1ull << 63;     // the sum of it and every tile before
constexpr unsigned long long kValue = kAggregate - 1;

// numpy's order of float32 as unsigned keys: NaN last, -0.0 == 0.0
__device__ __forceinline__ unsigned order_key(float f) {
  unsigned b = __float_as_uint(f);
  if ((b & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Branch-free lower bound of kItems keys over n >= 1 sorted places, side by
// side: base[k] ends at the last place whose key is below u[k] or at 0, and
// the result is base + (key(base) < u).  less(k, i) says whether place i's
// key is below u[k].
template <typename Less>
__device__ __forceinline__ void lower_bounds(int n, Less less, int (&base)[kItems]) {
  while (n > 1) {
    const int half = n >> 1;
    bool go[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) go[k] = less(k, base[k] + half);
#pragma unroll
    for (int k = 0; k < kItems; ++k) base[k] += go[k] ? half : 0;
    n -= half;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) base[k] += less(k, base[k]) ? 1 : 0;
}

// the float whose order_key is k (a NaN for the NaN key)
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// First i in [a, b] whose key is at or past u, given that rk[b]'s is and
// that vg is rk[g]'s key, a <= g <= b: gallop from g towards the bound,
// then halve the last step.  A good guess costs a load or two; a bad one
// 2 log2(b - a) at most.
__device__ __forceinline__ int gallop_lower(const float* __restrict__ rk, unsigned u, int a,
                                            int b, int g, unsigned vg) {
  int lo, hi;                                    // the bound lies in [lo, hi]
  int d = 1;
  if (vg < u) {
    while (g + d < b && order_key(__ldg(rk + g + d)) < u) d <<= 1;
    lo = g + (d >> 1) + 1;
    hi = min(g + d, b);
  } else {
    while (g - d >= a && order_key(__ldg(rk + g - d)) >= u) d <<= 1;
    lo = max(g - d + 1, a);
    hi = g - (d >> 1);
  }
  for (int m = hi - lo; m > 0;) {
    const int half = m >> 1;
    if (order_key(__ldg(rk + lo + half)) < u) {
      lo += half + 1;
      m -= half + 1;
    } else {
      m = half;
    }
  }
  return lo;
}

// first i in [a, b) with arr[i] > v, else b: the warp probes 32 places a step
__device__ __forceinline__ int warp_upper_bound(const int* arr, int a, int b, int v, int lane) {
  while (b - a > 32) {
    const int step = (b - a + 31) >> 5;
    const int i = a + lane * step;
    const int c = __popc(__ballot_sync(kFull, i < b && arr[i] <= v));
    if (c == 0) return a;
    const int na = a + (c - 1) * step + 1;
    b = min(a + c * step, b);
    a = na;
  }
  return a + __popc(__ballot_sync(kFull, a + lane < b && arr[a + lane] <= v));
}

__global__ void __launch_bounds__(kThreads)
match_count_kernel(const float* __restrict__ lk, int nl, const float* __restrict__ rk, int nr,
                   int stride, int n_split, int tiles, int* __restrict__ counts,
                   int* __restrict__ offsets, int* __restrict__ start,
                   unsigned long long* __restrict__ scratch) {
  __shared__ unsigned s_split[kMaxSplit + 1];
  __shared__ long long s_warp[kWarps];
  __shared__ long long s_prefix;
  __shared__ int s_tile;
  // the sort before this launch has ended and its keys are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int s = threadIdx.x; s <= n_split && nr > 0; s += kThreads)
    s_split[s] = order_key(rk[s < n_split ? s * stride : nr - 1]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  volatile unsigned long long* status = scratch + 2;
  for (;;) {
    if (threadIdx.x == 0) s_tile = (int)atomicAdd(scratch, 1ull);
    __syncthreads();                             // the splitters, and the ticket
    const int tile = s_tile;
    if (tile >= tiles) break;
    const int row0 = tile * kTile + threadIdx.x * kItems;
    float x[kItems];
    unsigned u[kItems];
    int s[kItems], lo[kItems], g[kItems], a[kItems], b[kItems], cnt[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      x[k] = row0 + k < nl ? lk[row0 + k] : 0.0f;
      u[k] = order_key(x[k]);
      s[k] = 0;
    }
    // s: the first splitter at or past u.  The lower bound is 0 for s = 0,
    // nr past the last splitter, else in [at(s - 1) + 1, at(s)]
    if (nr > 0) lower_bounds(n_split + 1, [&](int k, int i) { return s_split[i] < u[k]; }, s);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      lo[k] = s[k] == 0 ? 0 : nr;
      a[k] = b[k] = g[k] = -1;
      if (s[k] > 0 && s[k] <= n_split) {
        const int p0 = (s[k] - 1) * stride;
        a[k] = p0 + 1;
        b[k] = s[k] < n_split ? s[k] * stride : nr - 1;
        // the guess: x placed between the two splitters' values
        const float v0 = key_value(s_split[s[k] - 1]), v1 = key_value(s_split[s[k]]);
        g[k] = (a[k] + b[k]) >> 1;
        if (isfinite(x[k]) && isfinite(v0) && isfinite(v1)) {
          const float f = fminf(fmaxf((x[k] - v0) / (v1 - v0), 0.0f), 1.0f);
          g[k] = max(p0 + (int)(f * (float)(b[k] - p0)), a[k]);
        }
      }
    }
    unsigned vg[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) vg[k] = g[k] >= 0 ? order_key(__ldg(rk + g[k])) : 0u;
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (g[k] >= 0) lo[k] = gallop_lower(rk, u[k], a[k], b[k], g[k], vg[k]);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      int hi = lo[k];
      if (row0 + k < nl && lo[k] < nr &&
          (lo[k] == g[k] ? vg[k] : order_key(__ldg(rk + lo[k]))) == u[k]) {
        // gallop past the run of u, then halve the last step
        long long d = 1;
        while (lo[k] + d < nr && order_key(__ldg(rk + lo[k] + d)) == u[k]) d <<= 1;
        int c = (int)(lo[k] + d / 2 + 1), m = (int)(min(lo[k] + d, (long long)nr) - c);
        while (m > 0) {
          const int half = m >> 1;
          if (order_key(__ldg(rk + c + half)) == u[k]) { c += half + 1; m -= half + 1; }
          else m = half;
        }
        hi = c;
      }
      cnt[k] = hi - lo[k];
    }

    // the tile's exclusive scan: in the thread, the warp, the CTA
    long long sum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) sum += cnt[k];
    long long incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      long long w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
      for (int d = 1; d < kWarps; d <<= 1) {
        const long long v = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += v;
      }
      if (lane < kWarps) s_warp[lane] = w;
    }
    __syncthreads();
    // across tiles: publish this tile's sum, then add the sums of the tiles
    // before it back to the nearest published prefix, 32 tiles a step
    if (warp == 0) {
      const long long agg = s_warp[kWarps - 1];
      long long prefix = 0;
      if (tile > 0) {
        if (lane == 0) status[tile] = kAggregate | (unsigned long long)agg;
        for (int j = tile - 32 + lane;; j -= 32) {
          unsigned long long w = kPrefix;                        // before tile 0: a prefix of 0
          if (j >= 0) w = status[j];
          for (;;) {                                             // until all 32 have published
            const bool ready = (w & (kAggregate | kPrefix)) != 0;
            if (__all_sync(kFull, ready)) break;
            if (!ready) w = status[j];
          }
          const unsigned prefixes = __ballot_sync(kFull, (w & kPrefix) != 0);
          const int from = prefixes ? 31 - __clz(prefixes) : 0;   // the nearest prefix
          long long v = lane >= from ? (long long)(w & kValue) : 0;
#pragma unroll
          for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
          prefix += v;
          if (prefixes) break;
        }
      }
      if (lane == 0) {
        status[tile] = kPrefix | (unsigned long long)(prefix + agg);
        if (tile == tiles - 1) scratch[1] = (unsigned long long)(prefix + agg);
        s_prefix = prefix;
      }
    }
    __syncthreads();
    long long off = s_prefix + (warp > 0 ? s_warp[warp - 1] : 0) + incl - sum;
    int o[kItems], st[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      o[k] = (int)off;                           // the host raises past kMaxRows
      st[k] = (int)(lo[k] - off);
      off += cnt[k];
    }
    if (row0 + kItems <= nl) {                   // 16-byte aligned: row0 is a multiple of 4
      *reinterpret_cast<int4*>(counts + row0) = make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
      *reinterpret_cast<int4*>(offsets + row0) = make_int4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<int4*>(start + row0) = make_int4(st[0], st[1], st[2], st[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (row0 + k < nl) {
          counts[row0 + k] = cnt[k];
          offsets[row0 + k] = o[k];
          start[row0 + k] = st[k];
        }
      }
    }
    __syncthreads();                             // s_tile, s_warp, s_prefix reused
  }
  asm volatile("griddepcontrol.launch_dependents;");
}

__global__ void __launch_bounds__(kThreads)
match_write_kernel(const int* __restrict__ offsets, const int* __restrict__ start, int nl,
                   const long long* __restrict__ order, int total, int2* __restrict__ pairs) {
  __shared__ int s_off[kOutTile];
  __shared__ int s_start[kOutTile];
  __shared__ int s_rows[2];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
  const int p0 = blockIdx.x * kOutTile;
  const int p_last = min(p0 + kOutTile, total) - 1;
  // the rows of pairs p0 and p_last, a warp each: the last rows whose
  // offset is at or below them
  if (threadIdx.x < 64) {
    const int lane = threadIdx.x & 31;
    const int row = warp_upper_bound(offsets, 0, nl, threadIdx.x < 32 ? p0 : p_last, lane) - 1;
    if (lane == 0) s_rows[threadIdx.x >> 5] = row;
  }
  __syncthreads();
  const int first = s_rows[0], rows = s_rows[1] - first + 1;
  const int* off = offsets + first;
  const int* st = start + first;
  if (rows <= kOutTile) {                        // the same for the whole CTA
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      s_off[i] = off[i];
      s_start[i] = st[i];
    }
    __syncthreads();
    off = s_off;
    st = s_start;
  }
  // each pair's row: the last of the CTA's rows whose offset is at or below it
  int base[kOutItems];
#pragma unroll
  for (int k = 0; k < kOutItems; ++k) base[k] = 0;
  for (int n = rows; n > 1;) {
    const int half = n >> 1;
    bool go[kOutItems];
#pragma unroll
    for (int k = 0; k < kOutItems; ++k)
      go[k] = off[base[k] + half] <= min(p0 + k * kThreads + (int)threadIdx.x, p_last);
#pragma unroll
    for (int k = 0; k < kOutItems; ++k) base[k] += go[k] ? half : 0;
    n -= half;
  }
#pragma unroll
  for (int k = 0; k < kOutItems; ++k) {
    const int p = p0 + k * kThreads + threadIdx.x;
    if (p <= p_last) {
      const int i = base[k];
      pairs[p] = make_int2(first + i, (int)order[(long long)st[i] + p]);
    }
  }
}

// CTAs of launch 1 that fit the card at once, counted on the first call
cudaError_t resident_ctas(int* ctas) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, match_count_kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    resident = max(sms * per_sm, 1);
  }
  *ctas = resident;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 is success.  Phase 1 zeroes the scratch
// (ticket, total, one status word a tile: 2 + tiles int64) and launches the
// match: lk (nl,) and rk (nr,) float32, rk ascending in order_key's order,
// counts, offsets and start (nl,) int32 on the device; stride a power of two, n_split = ceil(nr / stride) <=
// kMaxSplit, tiles = ceil(nl / kTile).  The total is then scratch[1].  Phase
// 2 writes the total pairs (total, 2) int32 from offsets, start and the sort's
// order (nr,) int64.  The caller checks types, shapes and contiguity.
int join_match_launch(int phase, const void* lk, int nl, const void* rk, const void* order,
                      int nr, int stride, int n_split, int tiles, void* counts, void* offsets,
                      void* start, void* scratch, long long total, void* pairs, void* stream) {
  if (nl < 0 || nr < 0 || nl > kMaxRows || nr > kMaxRows || stride < 1 ||
      (stride & (stride - 1)) != 0 || n_split != (int)(((long long)nr + stride - 1) / stride) ||
      n_split > kMaxSplit || tiles != (int)(((long long)nl + kTile - 1) / kTile))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  cudaError_t e = cudaSuccess;
  if (phase == 1) {
    e = cudaMemsetAsync(scratch, 0, (size_t)(2 + tiles) * sizeof(unsigned long long), s);
    if (e != cudaSuccess || tiles == 0) return (int)e;
    int ctas = 0;
    e = resident_ctas(&ctas);
    if (e != cudaSuccess) return (int)e;
    cfg.gridDim = dim3((unsigned)min(ctas, tiles));
    e = cudaLaunchKernelEx(&cfg, match_count_kernel, static_cast<const float*>(lk), nl,
                           static_cast<const float*>(rk), nr, stride, n_split, tiles,
                           static_cast<int*>(counts), static_cast<int*>(offsets),
                           static_cast<int*>(start), static_cast<unsigned long long*>(scratch));
  } else if (phase == 2) {
    if (total < 1 || total > kMaxRows || nl < 1) return (int)cudaErrorInvalidValue;
    cfg.gridDim = dim3((unsigned)((total + kOutTile - 1) / kOutTile));
    e = cudaLaunchKernelEx(&cfg, match_write_kernel, static_cast<const int*>(offsets),
                           static_cast<const int*>(start), nl,
                           static_cast<const long long*>(order), (int)total,
                           static_cast<int2*>(pairs));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* join_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
