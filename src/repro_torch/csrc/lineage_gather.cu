// Batched CSR probe into a padded neighbour table, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lineage_gather.py::lineage_gather_kernel
// (launched by lineage_gather_pallas).  It computes what the plain version
// repro_torch/kernels/ref.py::lineage_gather_ref computes: for query q with
// row r = queries[q],
//
//     out[q, j] = col_idx[row_ptr[r] + j]   for j < row_ptr[r + 1] - row_ptr[r]
//     out[q, j] = -1                        for the rest of the max_deg lanes,
//
// and a row of -1 for a query outside [0, R).  A row longer than max_deg is
// cut to max_deg entries.  Nothing past a row's degree is read, so col_idx
// needs no sentinel padding.
//
// What bounds it on this card.  Bytes and latency: each output word costs a
// chain of three dependent loads (the query, its two row pointers, the
// column) and one store; there is no arithmetic.  The relations the index
// keeps at scale mostly have degree 1 (the TPC-DI SF20 join's out -> in CSR
// has one entry in each of its 2.41 M rows): there queries, row pointers,
// columns and the table are 9.6 MB each, 11.5 us at 3.35 TB/s.  At the
// per-hop baseline's 64 queries the launch latency sets the time.
//
// What the design does about that.  The grid covers the Q x max_deg output,
// not the queries: a warp owns 32 * kPer consecutive row-major output words
// and lane l writes words l, l + 32, ... of them, so every lane works
// whatever max_deg is (one warp per degree-1 query left 31 of 32 lanes idle)
// and every load and store instruction of a warp touches 32 consecutive
// words: coalesced output, coalesced columns within a row, and query and
// row-pointer loads that neighbouring lanes share.  Each thread derives the
// (query, lane) of its kPer words with a multiply-high by a reciprocal of
// max_deg that the launcher computes (no integer division on the path to the
// first load), then issues its kPer query loads, its 2 * kPer row-pointer
// loads and its kPer column loads group by group, each group independent.
// The kernel is a programmatic dependent launch: it is scheduled while the
// kernel before it still runs and waits (griddepcontrol.wait) before its
// first access, so at the baseline's small shapes it does not pay a full
// launch latency after its predecessor ends.  The earlier kernel of this
// file (one warp per query, the row copied in strides of 32 lanes) is timed
// against this one in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;   // output words a thread, 32 apart

__global__ void __launch_bounds__(kThreads)
lineage_gather_kernel(const int* __restrict__ queries, const int* __restrict__ row_ptr, int R,
                      const int* __restrict__ col_idx, int max_deg, int total,
                      unsigned magic, int shift, int* __restrict__ out) {
  // the kernels before this one have ended and their writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int base = warp * (32 * kPer) + lane;
  int e[kPer], j[kPer], r[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    e[i] = base + 32 * i;
    // e / max_deg for e < 2^31 (Granlund and Montgomery's round-up method)
    const int q = (int)((__umulhi(magic, (unsigned)e[i]) + (unsigned)e[i]) >> shift);
    j[i] = e[i] - q * max_deg;
    r[i] = e[i] < total ? queries[q] : -1;
  }
  int start[kPer], deg[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const bool valid = r[i] >= 0 && r[i] < R;
    start[i] = valid ? row_ptr[r[i]] : 0;
    deg[i] = valid ? row_ptr[r[i] + 1] - start[i] : 0;
  }
  int v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = j[i] < deg[i] ? col_idx[start[i] + j[i]] : -1;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (e[i] < total) out[e[i]] = v[i];
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 is success.  queries (Q,), row_ptr (R + 1,),
// col_idx and out (Q, max_deg) lie on the device; the caller checks types,
// shapes and contiguity and that Q * max_deg fits in an int, and gives the
// reciprocal of max_deg: shift = ceil(log2(max_deg)) and
// magic = floor(2^32 (2^shift - max_deg) / max_deg) + 1.
int lineage_gather_launch(const void* queries, int Q, const void* row_ptr, int R,
                          const void* col_idx, int max_deg, unsigned magic, int shift,
                          void* out, void* stream) {
  if (Q < 0 || R < 0 || max_deg < 1 || shift < 0 || shift > 31) return (int)cudaErrorInvalidValue;
  const long long total = (long long)Q * max_deg;
  if (total > INT32_MAX - kThreads * kPer) return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaSuccess;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((total + kThreads * kPer - 1) / (kThreads * kPer)));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, lineage_gather_kernel, static_cast<const int*>(queries),
      static_cast<const int*>(row_ptr), R, static_cast<const int*>(col_idx), max_deg, (int)total,
      magic, shift, static_cast<int*>(out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* lineage_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
