// Sorted row gather: out[i, :] = table[ids[i], :] for ids[i] in
// [0, num_rows), exact zeros otherwise (the 2**30 sentinel, padding).  A
// bit-exact copy in any dtype: elements move as raw bits.
//
// Replaces: deflow_tpu/ops/pallas_gather.py::_sorted_gather (the Pallas
// kernel _make_kernel), reached from sorted_rows_gather_pallas by the
// decoder's unpillar gather (ops/voxel.py::_gather_planned) and by the
// embedder scatter's backward (ops/voxel.py::_SegmentSum).
//
// Bound on the H100: bytes.  It reads the ids and each referenced table row
// and writes the [M, C] output; no arithmetic.  On the main path the
// decoder's output (M = 393,216 rows of 128 bf16 lanes = 256 B) is ~100 MB,
// the scatter's backward (M = 196,608 rows of 33 bf16 lanes = 66 B) ~13 MB.
//
// Design: two kernels, chosen by the row's width.
//  - rows_kernel, for rows that are whole 16-byte vectors (the decoder's 128
//    lanes): one thread per 16-byte vector of an output row, so a 256-byte
//    row is one half-warp of 16-byte loads and stores.
//  - chunk_kernel, for any other row (the scatter's 33 lanes: 32 features
//    and the count): one thread per 16-byte chunk of the flat [M * C]
//    output, so every store is 16 bytes and a warp's stores are one
//    contiguous 512-byte run whatever C is.  The thread finds its first row
//    with a 32-bit multiply-high by a reciprocal of C made on the host, then
//    walks its 8 (bf16) or 4 (f32) elements, moving to the next row (and its
//    id, loaded ahead) when the column reaches C; it reads the table element
//    by element, which any row alignment allows.  Sizes are held below 2^31
//    elements by the wrapper.
// The ascending ids give the table reads L2 locality on their own; the
// Pallas window sweep (one-hot MXU matmuls over [W, C] table slabs with a
// 3-slot DMA rotation) is a TPU device for a machine without a fast row
// gather and is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int_div.cuh"

namespace {

using int_div::Divisor;
using int_div::div_by;
using int_div::divisor;

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1LL << 20;   // grid-stride beyond this

__global__ void __launch_bounds__(THREADS)
rows_kernel(const uint4* __restrict__ table, const int* __restrict__ ids,
            long long m, int vec_per_row, long long num_rows,
            uint4* __restrict__ out) {
  const long long total = m * vec_per_row;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long k = (long long)blockIdx.x * THREADS + threadIdx.x; k < total;
       k += stride) {
    const long long row = k / vec_per_row;
    const int j = (int)(k - row * vec_per_row);
    const int id = ids[row];
    uint4 v{};
    if (id >= 0 && id < num_rows) v = table[(long long)id * vec_per_row + j];
    out[k] = v;
  }
}

// E: the element as raw bits (uint16_t for bf16, uint32_t for f32).
template <typename E>
__global__ void __launch_bounds__(THREADS)
chunk_kernel(const E* __restrict__ table, const int* __restrict__ ids, unsigned m,
             Divisor c, unsigned num_rows, E* __restrict__ out) {
  constexpr int V = 16 / sizeof(E);
  const unsigned total = m * c.d;
  const unsigned chunks = (total + V - 1) / V;
  for (unsigned k = blockIdx.x * THREADS + threadIdx.x; k < chunks;
       k += gridDim.x * THREADS) {
    const unsigned e0 = k * V;
    unsigned row = div_by(e0, c);
    unsigned col = e0 - row * c.d;
    int id = ids[row];
    // the next row's id, in flight with this one's (a chunk spans at most
    // two rows when C >= V; narrower rows load the rest as they go)
    int next = row + 1 < m ? ids[row + 1] : -1;
    uint32_t w[4] = {0u, 0u, 0u, 0u};        // the chunk, packed
#pragma unroll
    for (int q = 0; q < V; ++q) {
      if (col == c.d) {
        ++row;
        col = 0;
        id = next;
        next = row + 1 < m ? ids[row + 1] : -1;
      }
      const uint32_t bits = (unsigned)id < num_rows && e0 + q < total
                                ? (uint32_t)table[(unsigned)id * c.d + col] : 0u;
      w[V == 8 ? q / 2 : q] |= V == 8 ? bits << (q % 2 * 16) : bits;
      ++col;
    }
    if (e0 + V <= total) {
      *reinterpret_cast<uint4*>(out + e0) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q)
        if (e0 + q < total) out[e0 + q] = (E)(V == 8 ? w[q / 2] >> (q % 2 * 16) : w[q]);
    }
  }
}

int grid_for(long long work) {
  const long long blocks = (work + THREADS - 1) / THREADS;
  return (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

template <typename E>
int launch_chunks(const void* table, const int* ids, long long m, long long cols,
                  long long num_rows, void* out, cudaStream_t st) {
  constexpr int V = 16 / sizeof(E);
  const long long chunks = (m * cols + V - 1) / V;
  if (chunks == 0) return (int)cudaGetLastError();
  chunk_kernel<E><<<grid_for(chunks), THREADS, 0, st>>>(
      (const E*)table, ids, (unsigned)m, divisor((unsigned)cols), (unsigned)num_rows,
      (E*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// table [num_rows, cols] of elem_bytes (2 or 4) elements, ids [m] int32,
// out [m, cols], 16-byte aligned.  Whole 16-byte rows (row bytes and the
// table's base 16-byte aligned) take rows_kernel, every other row
// chunk_kernel; the latter needs m * cols and num_rows * cols below 2^31.
int sorted_gather(const void* table, const int* ids, long long m, long long cols,
                  long long num_rows, void* out, int elem_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const long long row_bytes = cols * elem_bytes;
  if (row_bytes % 16 == 0 && (uintptr_t)table % 16 == 0) {
    const long long vec = row_bytes / 16;
    if (m * vec == 0) return (int)cudaGetLastError();
    rows_kernel<<<grid_for(m * vec), THREADS, 0, st>>>(
        (const uint4*)table, ids, m, (int)vec, num_rows, (uint4*)out);
    return (int)cudaGetLastError();
  }
  if (m * cols >= (1LL << 31) || num_rows * cols >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return elem_bytes == 2
             ? launch_chunks<uint16_t>(table, ids, m, cols, num_rows, out, st)
             : launch_chunks<uint32_t>(table, ids, m, cols, num_rows, out, st);
}

}  // extern "C"
