// Lane segment-sum: out[s, l] = sum of rows[i, l] over the rows i with
// ids[i] == s, for s in [0, S) and l < L <= 7 f32 lanes.  Ids arrive
// ascending, so each segment's rows form one contiguous run; ids outside
// [0, S) (the sort's sentinel tail) add nothing.  Every output element is
// written by one thread; empty segments are exact zeros.  Accumulation is
// f32 in ascending row order, so the result is deterministic.
//
// Replaces: deflow_tpu/ops/pallas_scatter.py::segment_sum_lanes_pallas (the
// Pallas kernel _make_lane_kernel), reached from ops/chamfer.py
// _scatter_lanes_flat by the chamfer VJPs' mirror terms.
//
// Bound on the H100: bytes.  One pass reads the [N, L] rows and the [N] ids
// and writes the [S, L] table, one add per element.  On the SSL path
// (N = 393,216 rows of L = 4 lanes into S = 196,608 segments) that is
// ~11 MB, a few microseconds at 3.35 TB/s.
//
// Design: the output is zeroed, then one thread per row looks at the id of
// the row before it; the first row of each run (a "run head") walks its run
// in row order with all L lanes in registers and writes the segment once.
// No float atomics and no search (the ids are consumed as they come).  The
// pillar segment-sum (csrc/segment_sum.cu) gives one thread to each (row,
// lane) element after a marking pass, which suits 33- to 128-wide rows; here
// a row is at most 28 bytes, so one thread takes the whole row.  The Pallas
// [8, CHUNK] coordinate-major slab, its one-hot MXU contraction and the
// 3-slot DMA rotation are TPU devices and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LANES = 7;

__global__ void __launch_bounds__(THREADS)
lane_runs_kernel(const float* __restrict__ rows, const int* __restrict__ ids,
                 int n, int lanes, int s, float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int id = ids[i];
  if (id < 0 || id >= s) return;
  if (i > 0 && ids[i - 1] == id) return;      // not the head of its run
  float acc[MAX_LANES];
#pragma unroll
  for (int l = 0; l < MAX_LANES; ++l) acc[l] = 0.f;
  for (int j = i; j < n && ids[j] == id; ++j) {
    const float* r = rows + (long long)j * lanes;
#pragma unroll
    for (int l = 0; l < MAX_LANES; ++l)
      if (l < lanes) acc[l] += r[l];
  }
  float* o = out + (long long)id * lanes;
#pragma unroll
  for (int l = 0; l < MAX_LANES; ++l)
    if (l < lanes) o[l] = acc[l];
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// rows [n, lanes] f32, ids [n] int32 ascending, out [s, lanes] f32 (zeroed
// here); 1 <= lanes <= 7, n < 2^31.
int segment_sum_lanes(const float* rows, const int* ids, int n, int lanes,
                      int s, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (lanes < 1 || lanes > MAX_LANES) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)s * lanes * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  if (n > 0)
    lane_runs_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        rows, ids, n, lanes, s, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
