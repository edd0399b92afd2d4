// Warp-level 16x16 tile products on the tensor cores, for the CBG
// backward's bf16 route: Acc<bf16> runs WMMA (16x16x16 bf16, f32
// accumulate).  The f32 routes have their own register-blocked FFMA tiles
// (cbg.cu's forward and backward, fused_gru_bwd.cu's dW kernel, and
// gru_tile.cuh's f32_mm); there is no FFMA Acc<float>.
//
// acc.mma<A_ROW, B_ROW>(a, lda, b, ldb) adds the 16x16 product of one
// 16-deep step: A(m, k) = a[m*lda + k] when A_ROW, a[k*lda + m] otherwise;
// B(k, n) = b[k*ldb + n] when B_ROW, b[n*ldb + k] otherwise.  The pointers
// must be 32-byte aligned and lda/ldb multiples of 8 (WMMA's rule);
// acc.store writes the f32 tile row-major with ldc a multiple of 4.
// reduce_partials sums per-slice partials in a fixed order.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

#include <type_traits>

namespace tile {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> struct Acc;

template <> struct Acc<bf16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f;
  __device__ __forceinline__ void zero() { nvcuda::wmma::fill_fragment(f, 0.f); }
  template <bool A_ROW, bool B_ROW>
  __device__ __forceinline__ void mma(const bf16* a, int lda, const bf16* b, int ldb) {
    using namespace nvcuda::wmma;
    using LA = typename std::conditional<A_ROW, row_major, col_major>::type;
    using LB = typename std::conditional<B_ROW, row_major, col_major>::type;
    fragment<matrix_a, 16, 16, 16, bf16, LA> fa;
    fragment<matrix_b, 16, 16, 16, bf16, LB> fb;
    load_matrix_sync(fa, a, lda);
    load_matrix_sync(fb, b, ldb);
    mma_sync(f, fa, fb, f);
  }
  __device__ __forceinline__ void store(float* c, int ldc) {
    nvcuda::wmma::store_matrix_sync(c, f, ldc, nvcuda::wmma::mem_row_major);
  }
};

// out[i] = sum_s part[s * stride + i] for i < n, summed in slice order (so
// the result does not depend on scheduling), rounded once to T.
template <typename T>
__global__ void reduce_partials(const float* __restrict__ part, int slices,
                                long long stride, long long n, T* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < slices; ++k) s += part[k * stride + i];
    out[i] = from_f<T>(s);
  }
}

template <typename T>
cudaError_t launch_reduce(const float* part, int slices, long long stride,
                          long long n, T* out, cudaStream_t st) {
  if (n <= 0) return cudaSuccess;
  long long blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  reduce_partials<T><<<(int)blocks, 256, 0, st>>>(part, slices, stride, n, out);
  return cudaGetLastError();
}

}  // namespace tile
