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
// cut to max_deg entries.
//
// What bounds it on this card.  Bytes: each query reads two row pointers and
// its row's neighbours and writes max_deg words; there is no arithmetic.  At
// the shapes of the per-hop baseline (B queries, one per probe) the launch
// latency dominates.
//
// What the design does about that.  One warp per query, kThreads / 32
// queries per CTA.  Lane 0 reads the two row pointers and broadcasts them with
// a shuffle; the warp then copies the row in strides of 32 lanes, so the read
// of col_idx and the write of the table row are coalesced runs, and writes -1
// past the row's degree without reading there.  The TPU kernel read a whole
// max_deg window out of a sentinel-padded col_idx and masked it; this kernel
// never reads past a row's end, so col_idx needs no padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lineage_gather_kernel(const int* __restrict__ queries, int Q,
                      const int* __restrict__ row_ptr, int R,
                      const int* __restrict__ col_idx, int max_deg, int* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (q >= Q) return;  // a whole warp leaves together
  int start = 0, deg = 0;
  if (lane == 0) {
    const int r = queries[q];
    if (r >= 0 && r < R) {
      start = row_ptr[r];
      deg = row_ptr[r + 1] - start;
    }
  }
  start = __shfl_sync(0xFFFFFFFFu, start, 0);
  deg = __shfl_sync(0xFFFFFFFFu, deg, 0);
  int* row = out + (size_t)q * max_deg;
  for (int j = lane; j < max_deg; j += 32) row[j] = j < deg ? col_idx[start + j] : -1;
}

}  // namespace

extern "C" {

// Returns a cudaError_t code; 0 is success.  queries (Q,), row_ptr (R + 1,),
// col_idx and out (Q, max_deg) lie on the device; the caller checks types,
// shapes and contiguity.
int lineage_gather_launch(const void* queries, int Q, const void* row_ptr, int R,
                          const void* col_idx, int max_deg, void* out, void* stream) {
  if (Q < 0 || R < 0 || max_deg < 1) return (int)cudaErrorInvalidValue;
  const int per_cta = kThreads / 32;
  const int grid = Q > 0 ? (Q + per_cta - 1) / per_cta : 1;
  lineage_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(queries), Q, static_cast<const int*>(row_ptr), R,
      static_cast<const int*>(col_idx), max_deg, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

const char* lineage_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
