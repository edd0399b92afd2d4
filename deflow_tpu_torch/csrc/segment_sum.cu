// Sorted segment-sum: out[s, :] = sum of feats[i, :] over the points i with
// ids[i] == s, for s in [0, S).  Ids arrive ascending except for sentinel
// values (>= S, anywhere in the stream) that add nothing.  Every output row
// is written exactly once; empty rows are exact zeros.  Accumulation is f32
// in a fixed order (ascending point index); the output is in the input dtype.
//
// Replaces: deflow_tpu/ops/pallas_scatter.py::_sorted_scatter (the Pallas
// kernel _make_kernel), reached from pillar_sum_scatter_pallas /
// _planned_scatter by the embedder's pillar mean-scatter.
//
// Bound on the H100: bytes.  One pass reads the [N, C] features and the [N]
// ids and writes the [S, C] table, a few FLOPs per byte.  On the main path
// (N = 393,216 rows of C = 33 bf16 lanes, S = 1,048,608) that is ~97 MB.
//
// Design: no atomics and no search.  The presorted plan leaves sentinel runs
// between samples, so the id stream is not globally ascending and a binary
// search for a row's span can land on the wrong boundary.  Instead a marking
// pass beside the sum writes each row's run [begin, end) into a zeroed
// [2, S] table: a row's points are contiguous, so the first and the last
// point of the run are its only writers.  The sum kernel then gives one
// thread to each (row, channel) pair, channel fastest, so reads within a
// row and the output writes are contiguous across threads and the ragged
// channel count (33) needs no padding; each thread adds its run in point
// order and writes its element once.  The Pallas one-hot matmuls, 3-slot
// DMA rotation and 128-lane slab are TPU-only and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even
}

// One thread per point: the first (last) point of a run records the run's
// begin (end) for its row.
__global__ void mark_runs(const int* __restrict__ ids, int n, int s,
                          int* __restrict__ row_begin, int* __restrict__ row_end) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int id = ids[i];
  if (id < 0 || id >= s) return;
  if (i == 0 || ids[i - 1] != id) row_begin[id] = i;
  if (i == n - 1 || ids[i + 1] != id) row_end[id] = i + 1;
}

// Output elements in a grid-stride loop over a bounded grid (MAX_BLOCKS):
// one block per element group of 256 made 135k tiny blocks on the main
// path.  32-bit indexing: the caller keeps S·C and N·C below 2^31.
constexpr int MAX_BLOCKS = 4096;

template <typename T>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const T* __restrict__ feats, int c, int total,
                   const int* __restrict__ row_begin,
                   const int* __restrict__ row_end, T* __restrict__ out) {
  for (int k = blockIdx.x * THREADS + threadIdx.x; k < total;
       k += gridDim.x * THREADS) {
    const int r = k / c;
    const int ch = k - r * c;
    float acc = 0.f;
    for (int j = row_begin[r]; j < row_end[r]; ++j)
      acc += to_f32(feats[j * c + ch]);
    out[k] = from_f32<T>(acc);
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// feats [n, c] (f32 or bf16 per is_bf16), ids [n] int32, out [s, c] same
// dtype as feats, scratch [2 * s] int32 (zeroed here); n·c, s·c < 2^31.
int segment_sum(const void* feats, const int* ids, int n, int c, int s,
                int* scratch, void* out, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int* row_begin = scratch;
  int* row_end = scratch + s;
  cudaError_t e = cudaMemsetAsync(scratch, 0, 2 * (size_t)s * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if (n > 0)
    mark_runs<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        ids, n, s, row_begin, row_end);
  const int total = s * c;
  if (total == 0) return (int)cudaGetLastError();
  const int blocks = min((total + THREADS - 1) / THREADS, MAX_BLOCKS);
  if (is_bf16)
    segment_sum_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        (const __nv_bfloat16*)feats, c, total, row_begin, row_end,
        (__nv_bfloat16*)out);
  else
    segment_sum_kernel<float><<<blocks, THREADS, 0, st>>>(
        (const float*)feats, c, total, row_begin, row_end, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
