// An equi-join's output assembled from its row pairs, for Hopper (sm_90a).
//
// Replaces no TPU kernel: repro/dataprep/ops.py::join materialises its
// output with jnp/numpy gathers and wheres, and the port's first version
// (kept as repro_torch/kernels/ref.py::join_gather_ref, the CPU's path) did
// the same with eight gathers, six torch.where and two torch.cat, so every
// byte of the output was written three to four times and read about as
// often.  At the TPC-DI SF20 shape that assembly took 3.5-4 ms of a 6.7 ms
// capture, 15 x its byte bound.  For the pairs (n, 2) int32 (left row,
// right row; -1 where a side is absent), it writes the (n, 1 + L + R)
// float32 data and bool null of the output once, where L = cl - 1 and
// R = cr - 1 are the two tables' columns less their keys:
//
//     column 0        the left key where the left row is present, else the
//                     right key (0.0 / null where neither is);
//     columns 1..L    the left table's non-key columns in order: input
//                     column a - 1 + (a - 1 >= lkey) of output column a;
//     columns L+1..   the right table's likewise;
//
// 0.0 with null set where a side is absent.  A row outside its table counts
// as absent, so a malformed pair reads nothing out of bounds.  Values are
// copied as 32-bit words, bit for bit.
//
// What bounds it on this card.  Bytes: there is no arithmetic.  At the SF20
// shape (2,411,006 pairs, 21 + 15 -> 35 columns, every left row in order)
// the output is 422 MB written once; each input read once is the left
// table's 253 MB, the right rows the pairs touch (1.57 M of 2.6 M, 118 MB)
// and the pairs' 19 MB: 0.81 GB, 0.24 ms at 3.35 TB/s.  The right rows come
// in no order, so each pair reads its right row in whole 32-byte sectors,
// about 134 bytes for its 75: the kernel moves about 1.0 GB.
//
// What the design does about that.  A warp owns kRows = 32 consecutive
// output rows, one pair a lane, loaded once and coalesced; the warp's 32 x C
// output words are contiguous, and lane l writes words l, l + 32, ... of
// them, C words in all, taking each word's pair from the lane that loaded it
// by a shuffle: every store instruction of a warp writes 32 consecutive
// data words (128 bytes) and null bytes, and each word costs one load that
// depends on nothing but the pair.  Consecutive words of a row are
// consecutive columns of one input row, so the loads of a warp fall on the
// one or two input rows its output words come from.  A lane's (row, column)
// steps by (32 / C, 32 % C) with a carry, so no division is on the path, and
// it has kUnroll words' loads in flight before it stores (16 took 0.434 ms
// at the SF20 shape; 4, 8 and 12 took 0.449, 0.442 and 0.438, and capping
// registers for full occupancy made each slower).  The column map
// follows from lkey, rkey and the widths: no column list is copied to the
// card.  The kernel is a programmatic dependent launch, as the walk's rank
// and gather are: it waits (griddepcontrol.wait) before it reads the pairs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;     // output rows a warp, one pair a lane
constexpr int kUnroll = 16;   // output words a lane loads before it stores
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
join_gather_kernel(const unsigned* __restrict__ ldata, const unsigned char* __restrict__ lnull,
                   int nl, int cl, int lkey,
                   const unsigned* __restrict__ rdata, const unsigned char* __restrict__ rnull,
                   int nr, int cr, int rkey,
                   const int2* __restrict__ pairs, int n, int step_rows, int step_cols,
                   unsigned* __restrict__ out, unsigned char* __restrict__ onull) {
  // the kernels before this one have ended and their writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31;
  const long long row0 = (long long)((blockIdx.x * kThreads + threadIdx.x) >> 5) * kRows;
  if (row0 >= n) return;                       // whole warps leave together
  const int rows = (int)min((long long)kRows, n - row0);
  int li = -1, ri = -1;
  if (lane < rows) {
    const int2 p = pairs[row0 + lane];
    li = (unsigned)p.x < (unsigned)nl ? p.x : -1;
    ri = (unsigned)p.y < (unsigned)nr ? p.y : -1;
  }
  const int C = cl + cr - 1;
  const int words = rows * C;                  // this warp's output words
  const long long base = row0 * C;
  int r = lane / C, c = lane - (lane / C) * C;   // (row, column) of word `lane`
  for (int k0 = 0; k0 < C; k0 += kUnroll) {
    unsigned v[kUnroll];
    unsigned char nb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < C) {                        // the same for every lane
        const int l = __shfl_sync(kFull, li, r);
        const int q = __shfl_sync(kFull, ri, r);
        const unsigned* src = nullptr;
        const unsigned char* srcn = nullptr;
        long long off = 0;
        if (c == 0) {
          if (l >= 0) {
            src = ldata; srcn = lnull; off = (long long)l * cl + lkey;
          } else if (q >= 0) {
            src = rdata; srcn = rnull; off = (long long)q * cr + rkey;
          }
        } else if (c < cl) {
          const int a = c - 1;
          if (l >= 0) { src = ldata; srcn = lnull; off = (long long)l * cl + a + (a >= lkey); }
        } else {
          const int a = c - cl;
          if (q >= 0) { src = rdata; srcn = rnull; off = (long long)q * cr + a + (a >= rkey); }
        }
        v[u] = src ? src[off] : 0u;
        nb[u] = srcn ? srcn[off] : (unsigned char)1;
        c += step_cols;
        r += step_rows;
        if (c >= C) { c -= C; ++r; }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = lane + 32 * (k0 + u);
      if (k0 + u < C && w < words) {
        out[base + w] = v[u];
        onull[base + w] = nb[u];
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 is success.  ldata/lnull (nl, cl) and
// rdata/rnull (nr, cr) are the tables' float32 values and bool nulls, pairs
// (n, 2) int32, out/onull (n, cl + cr - 1) float32 and bool, all contiguous
// on the device; the caller checks types, shapes and contiguity.
int join_gather_launch(const void* ldata, const void* lnull, int nl, int cl, int lkey,
                       const void* rdata, const void* rnull, int nr, int cr, int rkey,
                       const void* pairs, int n, void* out, void* onull, void* stream) {
  if (n < 0 || nl < 0 || nr < 0 || cl < 1 || cr < 1 || lkey < 0 || lkey >= cl || rkey < 0 ||
      rkey >= cr || (long long)n + kThreads > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int C = cl + cr - 1;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((long long)n + kThreads / 32 * kRows - 1) / (kThreads / 32 * kRows)));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, join_gather_kernel, static_cast<const unsigned*>(ldata),
      static_cast<const unsigned char*>(lnull), nl, cl, lkey, static_cast<const unsigned*>(rdata),
      static_cast<const unsigned char*>(rnull), nr, cr, rkey, static_cast<const int2*>(pairs), n,
      32 / C, 32 % C, static_cast<unsigned*>(out), static_cast<unsigned char*>(onull));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* join_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
