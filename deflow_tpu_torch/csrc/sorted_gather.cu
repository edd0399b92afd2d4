// Sorted row gather: out[i, :] = table[ids[i], :] for ids[i] in
// [0, num_rows), exact zeros otherwise (the 2**30 sentinel, padding).  A
// bit-exact copy in any dtype: rows move as raw bytes.
//
// Replaces: deflow_tpu/ops/pallas_gather.py::_sorted_gather (the Pallas
// kernel _make_kernel), reached from sorted_rows_gather_pallas by the
// decoder's unpillar gather (ops/voxel.py::_gather_planned).
//
// Bound on the H100: bytes.  It reads the ids and each referenced table row
// and writes the [M, C] output; no arithmetic.  On the main path (M = 393,216
// rows of 128 bf16 lanes = 256 B) the output alone is ~100 MB.
//
// Design: one thread per 16-byte (or narrower, whatever divides the row)
// vector of an output row, so a 256-byte row is one half-warp of 16-byte
// loads and stores, neighbouring threads on neighbouring addresses.  The
// ascending ids give the table reads L2 locality on their own; the Pallas
// window sweep (one-hot MXU matmuls over [W, C] table slabs with a 3-slot
// DMA rotation) is a TPU device for a machine without a fast row gather and
// is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename V>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const V* __restrict__ table, const int* __restrict__ ids,
              long long m, int vec_per_row, long long num_rows,
              V* __restrict__ out) {
  const long long total = m * vec_per_row;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long k = (long long)blockIdx.x * THREADS + threadIdx.x; k < total;
       k += stride) {
    const long long row = k / vec_per_row;
    const int j = (int)(k - row * vec_per_row);
    const int id = ids[row];
    V v{};
    if (id >= 0 && id < num_rows) v = table[(long long)id * vec_per_row + j];
    out[k] = v;
  }
}

template <typename V>
int launch(const void* table, const int* ids, long long m, long long row_bytes,
           long long num_rows, void* out, cudaStream_t st) {
  const int vec_per_row = (int)(row_bytes / sizeof(V));
  const long long total = m * vec_per_row;
  if (total == 0) return (int)cudaGetLastError();
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;   // grid-stride beyond this
  gather_kernel<V><<<(unsigned)blocks, THREADS, 0, st>>>(
      (const V*)table, ids, m, vec_per_row, num_rows, (V*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// table [num_rows, row_bytes] raw bytes, ids [m] int32, out [m, row_bytes].
// vec_bytes (16, 8, 4 or 2) divides row_bytes and both base addresses.
int sorted_gather(const void* table, const int* ids, long long m,
                  long long row_bytes, long long num_rows, void* out,
                  int vec_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (vec_bytes) {
    case 16: return launch<uint4>(table, ids, m, row_bytes, num_rows, out, st);
    case 8: return launch<uint2>(table, ids, m, row_bytes, num_rows, out, st);
    case 4: return launch<uint32_t>(table, ids, m, row_bytes, num_rows, out, st);
    case 2: return launch<uint16_t>(table, ids, m, row_bytes, num_rows, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
