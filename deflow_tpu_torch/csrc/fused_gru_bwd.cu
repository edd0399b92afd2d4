// Fused iterative ConvGRU backward (the DeFlow decoder's training hot loop).
// Given the forward of fused_gru.cu (H = 128, input width xdim) and the
// cotangent g of its output, computes dh0, dx, dW_zr, db_zr, dW_q, db_q with
// matmul operands in the compute dtype (bf16 or f32) and f32 accumulation,
// each gradient rounded once to its operand's dtype.
//
// Replaces: deflow_tpu/ops/pallas_gru.py::_fused_bwd (the Pallas kernel
// _make_bwd_kernel), reached through fused_gru's custom VJP.
//
// Bound on the H100: operations.  Over M points and 4 iterations the
// backward does the forward once more plus two products per gate matrix,
// 3 x 2·M·192·384·4 FLOP (348 GFLOP at M = 196,608) against ~200 MB of
// h0/x/g/dh0/dx traffic.
//
// Design.  The Pallas kernel keeps all iterations' (h, z, r, q) of a
// 512-row tile in VMEM (4 MB); a Hopper block has 227 KB, of which the bf16
// weights take 150 KB.  So:
//  1. main kernel, a persistent block per SM walking 16-point tiles with the
//     bf16 weights resident in shared memory (f32 reads them through the
//     cache).  Per tile it runs the forward, spilling each iteration's input
//     state h (f32) to a global scratch (written and read back by the same
//     block, so it mostly stays in L2), then walks the iterations in
//     reverse: it recomputes z, r, q from the spilled h with two products,
//     forms the gate gradients in f32, and back-propagates through W_q^T and
//     W_zr^T with two more.  dh and dx stay in shared memory; db is summed
//     per block.  The operands of the weight gradients ([h|x], [r*h|x],
//     ds_zr, ds_q, rounded to the compute dtype exactly as the products use
//     them) are written to global memory, since dW (295 KB in f32) fits in
//     neither registers nor shared memory;
//  2. a split-K product dW = A^T·B over all M·iters rows of those operands,
//     each block summing one 64x64 output tile over one slice of rows into
//     its own f32 partial;
//  3. a reduction of the partials (and of the per-block db) in slice order.
// No float atomics: the result does not depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

using tile::Acc;
using tile::bf16;
using tile::from_f;
using tile::to_f;

constexpr int H = 128;
constexpr int TM = 16;                   // points per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;                   // row padding against bank conflicts
constexpr int LDZR = 2 * H + PAD;        // shared-memory row strides (elements)
constexpr int LDQ = H + PAD;
constexpr int XMAX = 64;

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.f / (1.f + expf(-v)); }

__host__ __device__ inline size_t align256(size_t v) { return (v + 255) & ~(size_t)255; }

// Region reused by the operand tiles [h|x], [r*h|x] and then by ds_q, ds_zr.
__host__ __device__ inline int region_elems(int lda) {
  const int a = 2 * lda, b = LDQ + LDZR;
  return TM * (a > b ? a : b);
}

template <typename T>
size_t main_smem_bytes(int k) {
  const int lda = k + PAD;
  const bool w_smem = sizeof(T) == 2;
  size_t s = 0;
  if (w_smem) s += (size_t)k * (LDZR + LDQ) * sizeof(T);
  s += (size_t)region_elems(lda) * sizeof(T);
  s += (size_t)5 * TM * H * 4 + (size_t)TM * XMAX * 4;  // h z r q dh, dx
  s += (size_t)WARPS * 256 * 4 + 2 * 3 * H * 4;          // staging, b, db
  return s;
}

// Scratch layout (each piece 256-byte aligned).
struct Scratch {
  size_t hsave, sp_hx, sp_u, sp_dszr, sp_dsq, db_part, part_zr, part_q, total;
  int slices, kpad;
};

__host__ inline Scratch scratch_layout(int m, int xdim, int iters, int esz, int grid) {
  Scratch s;
  const size_t rows = (size_t)iters * m;
  const int k = H + xdim;
  s.kpad = (k + 63) / 64 * 64;
  long long sl = ((long long)rows + 2047) / 2048;
  s.slices = (int)(sl < 1 ? 1 : (sl > 64 ? 64 : sl));
  size_t o = 0;
  s.hsave = o;   o += align256(rows * H * 4);
  s.sp_hx = o;   o += align256(rows * k * esz);
  s.sp_u = o;    o += align256(rows * k * esz);
  s.sp_dszr = o; o += align256(rows * 2 * H * esz);
  s.sp_dsq = o;  o += align256(rows * H * esz);
  s.db_part = o; o += align256((size_t)grid * 3 * H * 4);
  s.part_zr = o; o += align256((size_t)s.slices * s.kpad * 2 * H * 4);
  s.part_q = o;  o += align256((size_t)s.slices * s.kpad * H * 4);
  s.total = o;
  return s;
}

// One warp's 16 x (16·ncols) slice of a [TM, *] product, the epilogue
// applied per element through a 16x16 f32 staging tile.
template <typename T, bool B_ROW, typename Epi>
__device__ __forceinline__ void gemm_tile(const T* a, int lda, const T* b, int ldb,
                                          int ksteps, int ct, float* stage, Epi epi) {
  Acc<T> acc;
  acc.zero();
  for (int kk = 0; kk < ksteps; ++kk) {
    const T* bp = B_ROW ? b + kk * 16 * ldb + ct * 16 : b + ct * 16 * ldb + kk * 16;
    acc.template mma<true, B_ROW>(a + kk * 16, lda, bp, ldb);
  }
  acc.store(stage, 16);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < 256; e += 32) epi(e / 16, ct * 16 + e % 16, stage[e]);
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
gru_bwd_kernel(const T* __restrict__ h0, const T* __restrict__ x,
               const T* __restrict__ w_zr, const T* __restrict__ b_zr,
               const T* __restrict__ w_q, const T* __restrict__ b_q,
               const T* __restrict__ g, int m, int xdim, int iters,
               T* __restrict__ dh0, T* __restrict__ dx_out,
               float* __restrict__ hsave, T* __restrict__ sp_hx, T* __restrict__ sp_u,
               T* __restrict__ sp_dszr, T* __restrict__ sp_dsq,
               float* __restrict__ db_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool W_SMEM = sizeof(T) == 2;
  const int K = H + xdim;
  const int LDA = K + PAD;
  const int KS = K / 16;
  unsigned char* p = smem;
  const T* wzr = w_zr;
  const T* wq = w_q;
  int ldzr = 2 * H, ldq = H;
  if (W_SMEM) {
    T* s_wzr = (T*)p; p += (size_t)K * LDZR * sizeof(T);
    T* s_wq = (T*)p;  p += (size_t)K * LDQ * sizeof(T);
    for (int i = threadIdx.x; i < K * 2 * H; i += THREADS)
      s_wzr[(i / (2 * H)) * LDZR + i % (2 * H)] = w_zr[i];
    for (int i = threadIdx.x; i < K * H; i += THREADS)
      s_wq[(i / H) * LDQ + i % H] = w_q[i];
    wzr = s_wzr; wq = s_wq; ldzr = LDZR; ldq = LDQ;
  }
  T* s_hx = (T*)p;                         // [TM][LDA]  [h | x]
  T* s_u = s_hx + TM * LDA;                // [TM][LDA]  [r*h | x]
  T* s_dsq = s_hx;                         // [TM][LDQ]  reuses the region
  T* s_dszr = s_hx + TM * LDQ;             // [TM][LDZR]
  p += (size_t)region_elems(LDA) * sizeof(T);
  float* s_h = (float*)p;                  // [TM][H]  h, then h_in
  float* s_z = s_h + TM * H;               // z, then ds_z
  float* s_r = s_z + TM * H;               // r, then ds_r
  float* s_q = s_r + TM * H;               // q, then ds_q
  float* s_dh = s_q + TM * H;
  float* s_dx = s_dh + TM * H;             // [TM][xdim]
  float* s_stage = s_dx + TM * XMAX;       // [WARPS][256]
  float* s_b = s_stage + WARPS * 256;      // [3H] b_zr | b_q
  float* s_db = s_b + 3 * H;               // [3H] db_zr | db_q

  const int tid = threadIdx.x, warp = tid / 32;
  float* stage = s_stage + warp * 256;
  for (int i = tid; i < 2 * H; i += THREADS) s_b[i] = to_f(b_zr[i]);
  for (int i = tid; i < H; i += THREADS) s_b[2 * H + i] = to_f(b_q[i]);
  for (int i = tid; i < 3 * H; i += THREADS) s_db[i] = 0.f;
  const T zero = from_f<T>(0.f);

  const int tiles = (m + TM - 1) / TM;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = (long long)t * TM;
    __syncthreads();
    for (int i = tid; i < TM * H; i += THREADS) {
      const long long row = row0 + i / H;
      const int c = i % H;
      s_h[i] = row < m ? to_f(h0[row * H + c]) : 0.f;
      s_dh[i] = row < m ? to_f(g[row * H + c]) : 0.f;
    }
    for (int i = tid; i < TM * xdim; i += THREADS) s_dx[i] = 0.f;

    // x into the operand tiles (the ds tiles overwrite them in the backward)
    auto load_x = [&]() {
      for (int i = tid; i < TM * xdim; i += THREADS) {
        const int r = i / xdim, c = i % xdim;
        const long long row = row0 + r;
        const T v = row < m ? x[row * xdim + c] : zero;
        s_hx[r * LDA + H + c] = v;
        s_u[r * LDA + H + c] = v;
      }
    };
    auto spill = [&](T* dst, const T* src, int lds, int cols, int it) {
      for (int i = tid; i < TM * cols; i += THREADS) {
        const int r = i / cols, c = i % cols;
        const long long row = row0 + r;
        if (row < m) dst[((long long)it * m + row) * cols + c] = src[r * lds + c];
      }
    };
    // zr = sigmoid([h | x] @ W_zr + b_zr) into s_z, s_r (from s_hx)
    auto gate_zr = [&]() {
      for (int ct = warp; ct < 2 * H / 16; ct += WARPS)
        gemm_tile<T, true>(s_hx, LDA, wzr, ldzr, KS, ct, stage,
                           [&](int r, int c, float v) {
          const float s = sigmoid_f32(v + s_b[c]);
          if (c < H) s_z[r * H + c] = s; else s_r[r * H + c - H] = s;
        });
    };
    auto make_u = [&]() {
      for (int i = tid; i < TM * H; i += THREADS)
        s_u[(i / H) * LDA + i % H] = from_f<T>(s_r[i] * s_h[i]);
    };

    load_x();
    // ---- forward, spilling each iteration's input state
    for (int it = 0; it < iters; ++it) {
      for (int i = tid; i < TM * H; i += THREADS) {
        const int r = i / H, c = i % H;
        const long long row = row0 + r;
        if (row < m) hsave[((long long)it * m + row) * H + c] = s_h[i];
        s_hx[r * LDA + c] = from_f<T>(s_h[i]);
      }
      __syncthreads();
      gate_zr();
      __syncthreads();
      make_u();
      __syncthreads();
      for (int ct = warp; ct < H / 16; ct += WARPS)
        gemm_tile<T, true>(s_u, LDA, wq, ldq, KS, ct, stage,
                           [&](int r, int c, float v) {
          const float q = tanhf(v + s_b[2 * H + c]);
          const float z = s_z[r * H + c];
          s_h[r * H + c] = (1.f - z) * s_h[r * H + c] + z * q;
        });
      __syncthreads();
    }

    // ---- backward, iterations in reverse
    for (int it = iters - 1; it >= 0; --it) {
      load_x();
      for (int i = tid; i < TM * H; i += THREADS) {
        const int r = i / H, c = i % H;
        const long long row = row0 + r;
        const float hv = row < m ? hsave[((long long)it * m + row) * H + c] : 0.f;
        s_h[i] = hv;
        s_hx[r * LDA + c] = from_f<T>(hv);
      }
      __syncthreads();
      spill(sp_hx, s_hx, LDA, K, it);
      gate_zr();
      __syncthreads();
      make_u();
      __syncthreads();
      spill(sp_u, s_u, LDA, K, it);
      for (int ct = warp; ct < H / 16; ct += WARPS)
        gemm_tile<T, true>(s_u, LDA, wq, ldq, KS, ct, stage,
                           [&](int r, int c, float v) {
          s_q[r * H + c] = tanhf(v + s_b[2 * H + c]);
        });
      __syncthreads();                     // the operand region is free now
      for (int i = tid; i < TM * H; i += THREADS) {
        const int r = i / H, c = i % H;
        const float z = s_z[i], q = s_q[i], dh = s_dh[i];
        const float dsz = dh * (q - s_h[i]) * z * (1.f - z);
        const float dsq = dh * z * (1.f - q * q);
        s_dh[i] = dh * (1.f - z);
        s_z[i] = dsz;
        s_q[i] = dsq;
        s_dszr[r * LDZR + c] = from_f<T>(dsz);
        s_dsq[r * LDQ + c] = from_f<T>(dsq);
      }
      __syncthreads();
      spill(sp_dsq, s_dsq, LDQ, H, it);
      // du = ds_q @ W_q^T: [TM, K]
      for (int ct = warp; ct < KS; ct += WARPS)
        gemm_tile<T, false>(s_dsq, LDQ, wq, ldq, H / 16, ct, stage,
                            [&](int r, int c, float v) {
          if (c < H) {
            const float rr = s_r[r * H + c];
            s_dh[r * H + c] += v * rr;
            const float dsr = v * s_h[r * H + c] * rr * (1.f - rr);
            s_r[r * H + c] = dsr;
            s_dszr[r * LDZR + H + c] = from_f<T>(dsr);
          } else {
            s_dx[r * xdim + c - H] += v;
          }
        });
      __syncthreads();
      spill(sp_dszr, s_dszr, LDZR, 2 * H, it);
      for (int c = tid; c < 3 * H; c += THREADS) {
        const float* src = c < H ? s_z + c : (c < 2 * H ? s_r + c - H : s_q + c - 2 * H);
        float s = 0.f;
        for (int r = 0; r < TM; ++r) s += src[r * H];
        s_db[c] += s;
      }
      // dhx = ds_zr @ W_zr^T: [TM, K]
      for (int ct = warp; ct < KS; ct += WARPS)
        gemm_tile<T, false>(s_dszr, LDZR, wzr, ldzr, 2 * H / 16, ct, stage,
                            [&](int r, int c, float v) {
          if (c < H) s_dh[r * H + c] += v;
          else s_dx[r * xdim + c - H] += v;
        });
      __syncthreads();
    }

    for (int i = tid; i < TM * H; i += THREADS) {
      const long long row = row0 + i / H;
      if (row < m) dh0[row * H + i % H] = from_f<T>(s_dh[i]);
    }
    for (int i = tid; i < TM * xdim; i += THREADS) {
      const long long row = row0 + i / xdim;
      if (row < m) dx_out[row * xdim + i % xdim] = from_f<T>(s_dx[i]);
    }
  }
  __syncthreads();
  for (int i = tid; i < 3 * H; i += THREADS) db_part[blockIdx.x * 3 * H + i] = s_db[i];
}

// part[slice][m][n] = sum over the slice's rows r of A[r][m] · B[r][n] for one
// 64x64 output tile (A [rows, mo], B [rows, no], row-major; part rows padded
// to a multiple of 64).
constexpr int AT_ROWS = 32;
constexpr int AT_LD = 64 + PAD;

template <typename T>
__global__ void __launch_bounds__(THREADS)
atb_kernel(const T* __restrict__ a, const T* __restrict__ b, long long rows,
           int mo, int no, int slices, float* __restrict__ part) {
  __shared__ __align__(128) T s_a[AT_ROWS * AT_LD];
  __shared__ __align__(128) T s_b[AT_ROWS * AT_LD];
  const int tiles_n = no / 64;
  const int m0 = (blockIdx.x / tiles_n) * 64, n0 = (blockIdx.x % tiles_n) * 64;
  const int slice = blockIdx.y;
  const long long per = (rows + slices - 1) / slices;
  const long long r_begin = slice * per;
  const long long r_end = r_begin + per < rows ? r_begin + per : rows;
  const int tid = threadIdx.x, warp = tid / 32;
  const int rt = warp % 4, ct0 = (warp / 4) * 2;
  Acc<T> acc[2];
  acc[0].zero();
  acc[1].zero();
  const T zero = from_f<T>(0.f);
  for (long long r0 = r_begin; r0 < r_end; r0 += AT_ROWS) {
    __syncthreads();
    for (int i = tid; i < AT_ROWS * 64; i += THREADS) {
      const int r = i / 64, c = i % 64;
      const long long row = r0 + r;
      const bool ok = row < r_end;
      s_a[r * AT_LD + c] = ok && m0 + c < mo ? a[row * mo + m0 + c] : zero;
      s_b[r * AT_LD + c] = ok ? b[row * no + n0 + c] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < AT_ROWS / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        acc[j].template mma<false, true>(s_a + kk * 16 * AT_LD + rt * 16, AT_LD,
                                         s_b + kk * 16 * AT_LD + (ct0 + j) * 16, AT_LD);
  }
  const int kpad = (mo + 63) / 64 * 64;
  float* out = part + (long long)slice * kpad * no;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    acc[j].store(out + (long long)(m0 + rt * 16) * no + n0 + (ct0 + j) * 16, no);
}

template <typename T>
int run(const void* h0, const void* x, const void* w_zr, const void* b_zr,
        const void* w_q, const void* b_q, const void* g, int m, int xdim, int iters,
        void* dh0, void* dx, void* dwzr, void* dbzr, void* dwq, void* dbq,
        void* scratch, int grid_blocks, cudaStream_t st) {
  const int k = H + xdim;
  const int tiles = (m + TM - 1) / TM;
  const int grid = tiles < grid_blocks ? (tiles > 0 ? tiles : 1) : grid_blocks;
  const Scratch sc = scratch_layout(m, xdim, iters, sizeof(T), grid_blocks);
  unsigned char* s = (unsigned char*)scratch;
  float* db_part = (float*)(s + sc.db_part);
  float* part_zr = (float*)(s + sc.part_zr);
  float* part_q = (float*)(s + sc.part_q);
  T* sp_hx = (T*)(s + sc.sp_hx);
  T* sp_u = (T*)(s + sc.sp_u);
  T* sp_dszr = (T*)(s + sc.sp_dszr);
  T* sp_dsq = (T*)(s + sc.sp_dsq);
  cudaError_t e;
  if (m > 0) {
    const size_t smem = main_smem_bytes<T>(k);
    e = cudaFuncSetAttribute(gru_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    gru_bwd_kernel<T><<<grid, THREADS, smem, st>>>(
        (const T*)h0, (const T*)x, (const T*)w_zr, (const T*)b_zr, (const T*)w_q,
        (const T*)b_q, (const T*)g, m, xdim, iters, (T*)dh0, (T*)dx,
        (float*)(s + sc.hsave), sp_hx, sp_u, sp_dszr, sp_dsq, db_part);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const long long rows = (long long)iters * m;
  const int mt = sc.kpad / 64;
  atb_kernel<T><<<dim3(mt * 4, sc.slices), THREADS, 0, st>>>(
      sp_hx, sp_dszr, rows, k, 2 * H, sc.slices, part_zr);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  atb_kernel<T><<<dim3(mt * 2, sc.slices), THREADS, 0, st>>>(
      sp_u, sp_dsq, rows, k, H, sc.slices, part_q);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int db_slices = m > 0 ? grid : 0;
  if (db_slices == 0) {
    if ((e = cudaMemsetAsync(db_part, 0, 3 * H * 4, st)) != cudaSuccess) return (int)e;
  }
  const int dbn = db_slices > 0 ? db_slices : 1;
  if ((e = tile::launch_reduce<T>(part_zr, sc.slices, (long long)sc.kpad * 2 * H,
                                  (long long)k * 2 * H, (T*)dwzr, st)) != cudaSuccess) return (int)e;
  if ((e = tile::launch_reduce<T>(part_q, sc.slices, (long long)sc.kpad * H,
                                  (long long)k * H, (T*)dwq, st)) != cudaSuccess) return (int)e;
  if ((e = tile::launch_reduce<T>(db_part, dbn, 3 * H, 2 * H, (T*)dbzr, st)) != cudaSuccess) return (int)e;
  return (int)tile::launch_reduce<T>(db_part + 2 * H, dbn, 3 * H, H, (T*)dbq, st);
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// Bytes of device scratch fused_gru_bwd needs (spilled states and operands,
// per-block and per-slice partials).
long long fused_gru_bwd_scratch_bytes(int m, int xdim, int iters, int is_bf16,
                                      int grid_blocks) {
  return (long long)scratch_layout(m, xdim, iters, is_bf16 ? 2 : 4, grid_blocks).total;
}

// h0, g [m, 128]; x [m, xdim]; w_zr [128 + xdim, 256], b_zr [256];
// w_q [128 + xdim, 128], b_q [128]; all f32 or all bf16, gradients in the
// same shapes and dtype.  xdim % 16 == 0 and xdim <= 64.  grid_blocks:
// persistent blocks of the main kernel (one per SM).
int fused_gru_bwd(const void* h0, const void* x, const void* w_zr, const void* b_zr,
                  const void* w_q, const void* b_q, const void* g, int m, int xdim,
                  int iters, void* dh0, void* dx, void* dwzr, void* dbzr, void* dwq,
                  void* dbq, void* scratch, int is_bf16, int grid_blocks, void* stream) {
  if (xdim % 16 != 0 || xdim > XMAX || xdim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return run<bf16>(h0, x, w_zr, b_zr, w_q, b_q, g, m, xdim, iters, dh0, dx, dwzr,
                     dbzr, dwq, dbq, scratch, grid_blocks, st);
  return run<float>(h0, x, w_zr, b_zr, w_q, b_q, g, m, xdim, iters, dh0, dx, dwzr,
                    dbzr, dwq, dbq, scratch, grid_blocks, st);
}

}  // extern "C"
