// Fused iterative ConvGRU forward (the DeFlow decoder's hot loop):
//   repeat num_iters:  zr = sigmoid([h | x] @ w_zr + b_zr),  z, r = split(zr)
//                      q  = tanh([r*h | x] @ w_q + b_q)
//                      h  = (1 - z) * h + z * q
// with hidden H = 128 and input width xdim (64 on DeFlow).  Matmul operands
// are in the compute dtype (bf16 or f32) with f32 accumulation; gates and
// the state h stay f32 across all iterations and round once at the end.
//
// Replaces: deflow_tpu/ops/pallas_gru.py::_fused_fwd_impl (the Pallas kernel
// _make_fwd_kernel), reached from fused_gru by ConvGRUDecoder.
//
// Bound on the H100: operations.  4 iterations over M = 393,216 points cost
// 2·M·(192·256 + 192·128)·4 ≈ 232 GFLOP against ~252 MB of h0/x/out traffic,
// far above the bf16 tensor-core ridge (~295 FLOP/B).
//
// Design (bf16, the main path): a persistent block per SM holds both merged
// weight matrices in shared memory as bf16 (150 KB at xdim 64 with rows
// padded against bank conflicts; the f32 weights, 295 KB, would not fit),
// loaded once.  It walks 32-point tiles:
// h (f32), the bf16 operand rows [h | x] and [r*h | x], and z stay in shared
// memory for all iterations, so the point buffer crosses device memory once.
// Both products run on the tensor cores through WMMA (16x16x16 bf16, f32
// accumulate); each warp keeps one A fragment per k-step and reuses it over
// 4 (zr) or 2 (q) output tiles, and applies the gate epilogue through a
// per-warp 16x16 f32 staging tile, since accumulator fragments have no fixed
// element layout.  f32 inputs (parity runs) take a plain FFMA kernel: one
// thread per hidden column, 16 points per block, weights read through the
// cache.  The Pallas 128-lane padding of x is TPU-only and is not carried.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int H = 128;

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.f / (1.f + expf(-v)); }

// ----------------------------------------------------------------- f32 FFMA
constexpr int F32_ROWS = 16;
constexpr int F32_MAX_X = 128;

__global__ void __launch_bounds__(H)
gru_f32_kernel(const float* __restrict__ h0, const float* __restrict__ x,
               const float* __restrict__ w_zr, const float* __restrict__ b_zr,
               const float* __restrict__ w_q, const float* __restrict__ b_q,
               int m, int xdim, int iters, float* __restrict__ out) {
  __shared__ float hx[F32_ROWS][H + F32_MAX_X];   // [h | x]
  __shared__ float u[F32_ROWS][H + F32_MAX_X];    // [r*h | x]
  const int j = threadIdx.x;                      // hidden column
  const int k_in = H + xdim;
  const long long row0 = (long long)blockIdx.x * F32_ROWS;
  float h[F32_ROWS], z[F32_ROWS];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    const long long row = row0 + r;
    const float hv = row < m ? h0[row * H + j] : 0.f;
    h[r] = hv;
    hx[r][j] = hv;
    for (int k = j; k < xdim; k += H) {
      const float xv = row < m ? x[row * xdim + k] : 0.f;
      hx[r][H + k] = xv;
      u[r][H + k] = xv;
    }
  }
  const float bz = b_zr[j], br = b_zr[H + j], bq = b_q[j];
  for (int it = 0; it < iters; ++it) {
    __syncthreads();                              // hx complete
    float sz[F32_ROWS], sr[F32_ROWS];
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) sz[r] = sr[r] = 0.f;
    for (int k = 0; k < k_in; ++k) {
      const float wz = w_zr[k * 2 * H + j];
      const float wr = w_zr[k * 2 * H + H + j];
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) {
        sz[r] = fmaf(hx[r][k], wz, sz[r]);
        sr[r] = fmaf(hx[r][k], wr, sr[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) {
      z[r] = sigmoid_f32(sz[r] + bz);
      u[r][j] = sigmoid_f32(sr[r] + br) * h[r];
    }
    __syncthreads();                              // u complete
    float sq[F32_ROWS];
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) sq[r] = 0.f;
    for (int k = 0; k < k_in; ++k) {
      const float wq = w_q[k * H + j];
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) sq[r] = fmaf(u[r][k], wq, sq[r]);
    }
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) {
      const float q = tanhf(sq[r] + bq);
      h[r] = (1.f - z[r]) * h[r] + z[r] * q;
      hx[r][j] = h[r];
    }
  }
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    const long long row = row0 + r;
    if (row < m) out[row * H + j] = h[r];
  }
}

// ------------------------------------------------------------ bf16 WMMA
constexpr int TM = 32;                    // points per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROW_TILES = TM / 16;        // 2
constexpr int WARPS_PER_ROW_TILE = WARPS / ROW_TILES;   // 4
constexpr int ZR_COLS = 2 * H / 16 / WARPS_PER_ROW_TILE; // 4 col tiles / warp
constexpr int Q_COLS = H / 16 / WARPS_PER_ROW_TILE;      // 2 col tiles / warp
// Shared-memory rows are padded by 8 bf16 (16 bytes): with the bare 512-,
// 256- and 384-byte strides every row of a 16x16 fragment starts on the same
// bank, and the fragment loads serialise 8-16 ways.
constexpr int PAD = 8;
constexpr int LDZR = 2 * H + PAD;
constexpr int LDQ = H + PAD;

size_t bf16_smem_bytes(int k) {
  return (size_t)k * LDZR * 2 + (size_t)k * LDQ * 2   // weights
         + 2 * (size_t)TM * (k + PAD) * 2              // hx, u operands
         + 2 * (size_t)TM * H * 4                      // h, z
         + 3 * (size_t)H * 4                           // biases
         + (size_t)WARPS * 256 * 4;                    // staging tiles
}

// [rows, cols] bf16 from global memory into shared rows of stride ld, in
// 16-byte vectors (cols % 8 == 0).
__device__ __forceinline__ void copy_rows(bf16* dst, int ld, const bf16* src,
                                          int rows, int cols, int tid) {
  const int vecs = cols / 8;
  for (int i = tid; i < rows * vecs; i += THREADS) {
    const int r = i / vecs, v = i % vecs;
    *(uint4*)(dst + r * ld + v * 8) = *(const uint4*)(src + r * cols + v * 8);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
gru_bf16_kernel(const bf16* __restrict__ h0, const bf16* __restrict__ x,
                const bf16* __restrict__ w_zr, const bf16* __restrict__ b_zr,
                const bf16* __restrict__ w_q, const bf16* __restrict__ b_q,
                int m, int xdim, int iters, bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = H + xdim;
  const int LDA = K + PAD;
  bf16* s_wzr = (bf16*)smem;              // [K][LDZR]
  bf16* s_wq = s_wzr + K * LDZR;          // [K][LDQ]
  bf16* s_hx = s_wq + K * LDQ;            // [TM][LDA]  = [h | x]
  bf16* s_u = s_hx + TM * LDA;            // [TM][LDA]  = [r*h | x]
  float* s_h = (float*)(s_u + TM * LDA);  // [TM][H]
  float* s_z = s_h + TM * H;              // [TM][H]
  float* s_bzr = s_z + TM * H;            // [2H]
  float* s_bq = s_bzr + 2 * H;            // [H]
  float* s_stage = s_bq + H;              // [WARPS][16*16]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* stage = s_stage + warp * 256;
  const int rt = warp % ROW_TILES;        // this warp's 16-row tile
  const int cg = warp / ROW_TILES;        // and its group of column tiles

  copy_rows(s_wzr, LDZR, w_zr, K, 2 * H, tid);
  copy_rows(s_wq, LDQ, w_q, K, H, tid);
  for (int i = tid; i < 2 * H; i += THREADS) s_bzr[i] = __bfloat162float(b_zr[i]);
  for (int i = tid; i < H; i += THREADS) s_bq[i] = __bfloat162float(b_q[i]);

  const int num_tiles = (m + TM - 1) / TM;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * TM;
    __syncthreads();                      // weights in; last tile finished
    for (int i = tid; i < TM * H; i += THREADS) {
      const int r = i / H, c = i % H;
      const long long row = row0 + r;
      const bf16 v = row < m ? h0[row * H + c] : __float2bfloat16(0.f);
      s_h[i] = __bfloat162float(v);
      s_hx[r * LDA + c] = v;
    }
    for (int i = tid; i < TM * xdim; i += THREADS) {
      const int r = i / xdim, c = i % xdim;
      const long long row = row0 + r;
      const bf16 v = row < m ? x[row * xdim + c] : __float2bfloat16(0.f);
      s_hx[r * LDA + H + c] = v;
      s_u[r * LDA + H + c] = v;
    }
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
      // ---- zr = sigmoid([h | x] @ w_zr + b_zr): z kept, r*h → u
      {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[ZR_COLS];
#pragma unroll
        for (int c = 0; c < ZR_COLS; ++c) wmma::fill_fragment(acc[c], 0.f);
        for (int kk = 0; kk < K / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, s_hx + rt * 16 * LDA + kk * 16, LDA);
#pragma unroll
          for (int c = 0; c < ZR_COLS; ++c) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
            wmma::load_matrix_sync(
                b, s_wzr + kk * 16 * LDZR + (cg * ZR_COLS + c) * 16, LDZR);
            wmma::mma_sync(acc[c], a, b, acc[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < ZR_COLS; ++c) {
          wmma::store_matrix_sync(stage, acc[c], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int row = rt * 16 + e / 16;
            const int col = (cg * ZR_COLS + c) * 16 + e % 16;
            const float g = sigmoid_f32(stage[e] + s_bzr[col]);
            if (col < H) {
              s_z[row * H + col] = g;
            } else {
              const int hc = col - H;
              s_u[row * LDA + hc] = __float2bfloat16(g * s_h[row * H + hc]);
            }
          }
          __syncwarp();
        }
      }
      __syncthreads();
      // ---- q = tanh([r*h | x] @ w_q + b_q); h = (1 - z) h + z q
      {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[Q_COLS];
#pragma unroll
        for (int c = 0; c < Q_COLS; ++c) wmma::fill_fragment(acc[c], 0.f);
        for (int kk = 0; kk < K / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, s_u + rt * 16 * LDA + kk * 16, LDA);
#pragma unroll
          for (int c = 0; c < Q_COLS; ++c) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
            wmma::load_matrix_sync(
                b, s_wq + kk * 16 * LDQ + (cg * Q_COLS + c) * 16, LDQ);
            wmma::mma_sync(acc[c], a, b, acc[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < Q_COLS; ++c) {
          wmma::store_matrix_sync(stage, acc[c], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int row = rt * 16 + e / 16;
            const int col = (cg * Q_COLS + c) * 16 + e % 16;
            const float q = tanhf(stage[e] + s_bq[col]);
            const float z = s_z[row * H + col];
            const float hn = (1.f - z) * s_h[row * H + col] + z * q;
            s_h[row * H + col] = hn;
            s_hx[row * LDA + col] = __float2bfloat16(hn);
          }
          __syncwarp();
        }
      }
      __syncthreads();
    }

    for (int i = tid; i < TM * H; i += THREADS) {
      const long long row = row0 + i / H;
      if (row < m) out[row * H + i % H] = __float2bfloat16(s_h[i]);
    }
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// h0 [m, 128], x [m, xdim], w_zr [128 + xdim, 256], b_zr [256],
// w_q [128 + xdim, 128], b_q [128], out [m, 128]; all f32 or all bf16.
// bf16 needs xdim % 16 == 0 and xdim <= 64 (shared-memory budget);
// f32 needs xdim <= 128.  grid_blocks: persistent bf16 blocks (one per SM).
int fused_gru(const void* h0, const void* x, const void* w_zr, const void* b_zr,
              const void* w_q, const void* b_q, int m, int xdim, int iters,
              void* out, int is_bf16, int grid_blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m == 0) return (int)cudaGetLastError();
  if (!is_bf16) {
    if (xdim > F32_MAX_X) return (int)cudaErrorInvalidValue;
    gru_f32_kernel<<<(m + F32_ROWS - 1) / F32_ROWS, H, 0, st>>>(
        (const float*)h0, (const float*)x, (const float*)w_zr,
        (const float*)b_zr, (const float*)w_q, (const float*)b_q, m, xdim,
        iters, (float*)out);
    return (int)cudaGetLastError();
  }
  if (xdim % 16 != 0 || xdim > 64) return (int)cudaErrorInvalidValue;
  const size_t smem = bf16_smem_bytes(H + xdim);
  cudaError_t e = cudaFuncSetAttribute(
      gru_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (m + TM - 1) / TM;
  const int blocks = tiles < grid_blocks ? tiles : grid_blocks;
  gru_bf16_kernel<<<blocks, THREADS, smem, st>>>(
      (const bf16*)h0, (const bf16*)x, (const bf16*)w_zr, (const bf16*)b_zr,
      (const bf16*)w_q, (const bf16*)b_q, m, xdim, iters, (bf16*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
