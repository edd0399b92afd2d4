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
// Bound on the H100: operations.  4 iterations over M = 393,216 points need
// 2·M·384·(64 + 128·4) ≈ 174 GFLOP (x·W_x once, the h part every iteration)
// against ~252 MB of h0/x/out traffic, far above the bf16 tensor-core ridge
// (~295 FLOP/B).
//
// Design (bf16, the main path), the forward half of fused_gru_bwd.cu's main
// kernel: a persistent block per SM holds both merged weight matrices in
// shared memory as bf16 (150 KB at xdim 64, rows at strides 2H + 8 and
// H + 8), loaded once, and walks tiles of TM = 16·RT points.  Warp w owns
// hidden columns [16w, 16w + 16) of z, r and q: h and z stay f32 in
// mma.sync m16n8k16 accumulator registers, and bias, sigmoid, tanh, r·h and
// the state update run on the accumulators.  Only the bf16 operand tiles
// [h | x] and [r*h] change hands, at a stride of width + 8 (16 bytes past
// a multiple of 128: ldmatrix reads them without bank conflicts), so an
// iteration has 2 block barriers.  What the forward does not carry (the
// backward's dh, dx, db) pays for three things, each of which read faster
// than going without it (PERF.md):
//  - each warp holds RT = 4 16-row tiles, so each B fragment it loads serves
//    4 products (255 registers, no spills);
//  - the x part of both products is the same in every iteration, so
//    x·W_x + b is computed once per tile and starts the accumulators; the
//    iterations' products run over h's 128 columns only (K 192 → 128);
//  - the next tile's [h0 | x] rows arrive by 16-byte cp.async copies into
//    the other of two buffers under this tile's iterations.
// A tile's buffer is its [h | x] operand: after the last iteration its first
// H columns hold bf16(h), the output rounded once, written out 16 bytes a
// store.  f32 inputs take gru_fwd_f32_kernel (below): true f32 on FFMA, as
// the plain version computes, bound by operations at 67 TFLOP/s (2.60 ms at
// 4 x 98,304 points and 4 iterations); register-blocked 8 x 4 and 8 x 8
// micro-tiles fed by float4 loads (11 or 16 FMAs a load) with the weights
// streamed from L2, as fused_gru_bwd.cu's f32 route: 5.03-5.09 ms there
// on an NVIDIA H100 80GB HBM3 at 700 W (51-52% of the bound; 2.64-2.66 ms
// at 2 x 98,304; the f32 cuBLAS loop 14.7 / 7.6 ms; chip_smoke.py).  The Pallas 128-lane padding of x
// is TPU-only and is not carried.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gru_tile.cuh"

namespace {

using gru_tile::bf16;
using gru_tile::cp_async16;
using gru_tile::cp_async_commit;
using gru_tile::cp_async_wait;
using gru_tile::F_THREADS;
using gru_tile::F_WST;
using gru_tile::f32_fetch;
using gru_tile::f32_mm;
using gru_tile::ld2;
using gru_tile::spill;
using gru_tile::st2;
using gru_tile::warp_mma;
using gru_tile::WSrc;

constexpr int H = 128;

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.f / (1.f + expf(-v)); }

// The f32 route's gates: expf as above, the reciprocal by __fdividef (2 ulp
// over the divisor's range [1, inf], 0 at inf) in place of IEEE division,
// and tanh(v) = 2·sigmoid(2v) − 1 in place of tanhf and its branches
// (absolute error below 1e-6).  On the H100 the IEEE forms read 12%
// slower at 4 x 98,304 points (tools/kernel_variants.py), and their
// output's largest error against the plain version was higher (7.0e-7 of
// the largest element against 6.5e-7).
__device__ __forceinline__ float sigmoid_rcp(float v) { return __fdividef(1.f, 1.f + expf(-v)); }
__device__ __forceinline__ float tanh_rcp(float v) { return 2.f * sigmoid_rcp(2.f * v) - 1.f; }

// ----------------------------------------------------------------- f32 FFMA
// The f32 route: the forward half of fused_gru_bwd.cu's f32 main kernel.  A
// persistent block per SM walks tiles of 8·F32_RI points; thread (rg, cg)
// owns rows rg + 8i (i < F32_RI) and hidden columns 4cg .. +4 of h and z in
// registers.  Every product is gru_tile.cuh's f32_mm, the weights streamed
// from L2 through two 32 KB cp.async stages (the next product's first
// stage, and the next tile's, copied under the current one's last); x·W_x
// + b is computed once a tile and kept in shared memory, where each thread
// reads back only what it wrote, so the iterations' products run over h's
// 128 columns only.  x arrives zero-padded to a multiple of 4 columns (any
// xdim <= 128).  Only [h] and [r*h] change hands, so an iteration has the
// products' barriers (one a weight stage) and no other.  On the H100
// (tools/kernel_variants.py), 8 rows a thread (231 KB of shared memory,
// 243 registers) read 21% faster than the backward's 4; 16 KB weight
// stages 8% slower; 2 unrolled steps 3% slower than 4; without the weight
// copies (a probe: wrong results) it reads 10% faster.
constexpr int F32_RI = 8;                 // rows a thread (a tile of 8·F32_RI points)
constexpr int F32_UNROLL = 4;             // 4-deep steps of f32_mm unrolled
constexpr int F32_MAX_X = 128;
constexpr int F32_LDX = F32_MAX_X + 4;    // shared row strides (floats), 4 mod 32
constexpr int F32_LDH = H + 4;

// x·W_x + b, [h], [x] then [r*h], two weight stages
constexpr size_t F32_SMEM =
    ((size_t)8 * F32_RI * (3 * H + F32_LDH + F32_LDX) + 2 * F_WST) * sizeof(float);

__global__ void __launch_bounds__(F_THREADS, 1)
gru_fwd_f32_kernel(const float* __restrict__ h0, const float* __restrict__ x,
                   const float* __restrict__ w_zr, const float* __restrict__ b_zr,
                   const float* __restrict__ w_q, const float* __restrict__ b_q,
                   int m, int xdim, int iters, float* __restrict__ out) {
  constexpr int RI = F32_RI, TMF = 8 * RI;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_xw = reinterpret_cast<float*>(smem);  // [TMF][3H]  x·W_x + b
  float* s_h = s_xw + TMF * 3 * H;               // [TMF][F32_LDH]  h
  float* s_u = s_h + TMF * F32_LDH;              // [TMF][F32_LDX]  x, then r*h
  float* wst = s_u + TMF * F32_LDX;              // 2 weight stages of F_WST floats
  const int tid = threadIdx.x, warp = tid >> 5, l = tid & 31;
  const int rg = 4 * (warp & 1) + (l >> 3), c4 = 4 * (8 * (warp >> 1) + (l & 7));
  const WSrc zrx{w_zr + H * 2 * H, 2 * H, xdim, 2 * H}, qx{w_q + H * H, H, xdim, H};
  const WSrc zrh{w_zr, 2 * H, H, 2 * H}, qh{w_q, H, H, H};
  const WSrc& first = xdim > 0 ? zrx : zrh;
  const int tiles = (m + TMF - 1) / TMF, xr = (xdim + 3) / 4 * 4;
  float bias[3][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bias[0][j] = b_zr[c4 + j];
    bias[1][j] = b_zr[H + c4 + j];
    bias[2][j] = b_q[c4 + j];
  }
  // this thread's 4 columns of x·W_x + b at row i, part g (z, r, q)
  const auto xw = [&](int i, int g) {
    return reinterpret_cast<float4*>(s_xw + (rg + 8 * i) * 3 * H + g * H + c4);
  };
  // v (this thread's RI x 4) into a shared tile
  const auto put = [&](float* dst, int ld, const float (&v)[RI][4]) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
      *reinterpret_cast<float4*>(dst + (rg + 8 * i) * ld + c4) =
          *reinterpret_cast<const float4*>(v[i]);
  };
  int cur = 0;
  if (iters > 0 && (int)blockIdx.x < tiles) f32_fetch(first, 0, wst);

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * TMF;
    const int nrows = m - row0 < TMF ? m - row0 : TMF;
    const WSrc* tail = t + (int)gridDim.x < tiles ? &first : nullptr;
    float hs[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (rg + 8 * i < nrows)
        v = *reinterpret_cast<const float4*>(h0 + (size_t)(row0 + rg + 8 * i) * H + c4);
      *reinterpret_cast<float4*>(hs[i]) = v;
    }
    if (iters > 0) {
      put(s_h, F32_LDH, hs);
      // x (zero past xdim and m) into s_u, xr columns
      if (xdim % 4 == 0) {
        const int xc = xdim / 4;
        for (int i = tid; i < TMF * xc; i += F_THREADS) {
          const int rr = i / xc, cc = (i - rr * xc) * 4;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (rr < nrows) v = *reinterpret_cast<const float4*>(x + (size_t)(row0 + rr) * xdim + cc);
          *reinterpret_cast<float4*>(s_u + rr * F32_LDX + cc) = v;
        }
      } else {
        for (int i = tid; i < TMF * xr; i += F_THREADS) {
          const int rr = i / xr, cc = i - rr * xr;
          s_u[rr * F32_LDX + cc] =
              rr < nrows && cc < xdim ? x[(size_t)(row0 + rr) * xdim + cc] : 0.f;
        }
      }
      {
        // x·W_x + b once a tile, the starting values of every gate product
        float az[RI][8] = {}, aq[RI][4] = {};
        if (xdim > 0) {
          f32_mm<2, RI, F32_UNROLL>(az, s_u, F32_LDX, zrx, &qx, wst, cur, rg, c4);
          f32_mm<1, RI, F32_UNROLL>(aq, s_u, F32_LDX, qx, &zrh, wst, cur, rg, c4);
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          *xw(i, 0) = make_float4(az[i][0] + bias[0][0], az[i][1] + bias[0][1],
                                  az[i][2] + bias[0][2], az[i][3] + bias[0][3]);
          *xw(i, 1) = make_float4(az[i][4] + bias[1][0], az[i][5] + bias[1][1],
                                  az[i][6] + bias[1][2], az[i][7] + bias[1][3]);
          *xw(i, 2) = make_float4(aq[i][0] + bias[2][0], aq[i][1] + bias[2][1],
                                  aq[i][2] + bias[2][2], aq[i][3] + bias[2][3]);
        }
      }
      for (int it = 0; it < iters; ++it) {
        float z[RI][4];
        {
          // z, r = sigmoid(h W_h,zr + x W_x,zr + b_zr); r*h into s_u
          float acc[RI][8], rh[RI][4];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            *reinterpret_cast<float4*>(acc[i]) = *xw(i, 0);
            *reinterpret_cast<float4*>(acc[i] + 4) = *xw(i, 1);
          }
          f32_mm<2, RI, F32_UNROLL>(acc, s_h, F32_LDH, zrh, &qh, wst, cur, rg, c4);
#pragma unroll
          for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              z[i][j] = sigmoid_rcp(acc[i][j]);
              rh[i][j] = sigmoid_rcp(acc[i][4 + j]) * hs[i][j];
            }
          put(s_u, F32_LDX, rh);
        }
        {
          // q = tanh((r*h) W_h,q + x W_x,q + b_q); h = (1 - z) h + z q
          float acc[RI][4];
#pragma unroll
          for (int i = 0; i < RI; ++i) *reinterpret_cast<float4*>(acc[i]) = *xw(i, 2);
          f32_mm<1, RI, F32_UNROLL>(acc, s_u, F32_LDX, qh, it + 1 < iters ? &zrh : tail, wst,
                                    cur, rg, c4);
#pragma unroll
          for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              hs[i][j] = (1.f - z[i][j]) * hs[i][j] + z[i][j] * tanh_rcp(acc[i][j]);
          put(s_h, F32_LDH, hs);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
      if (rg + 8 * i < nrows)
        *reinterpret_cast<float4*>(out + (size_t)(row0 + rg + 8 * i) * H + c4) =
            *reinterpret_cast<const float4*>(hs[i]);
    __syncthreads();                       // this tile's products read before the next one's x, h
  }
}

// ------------------------------------------------------------ bf16 mma.sync
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;                   // row padding against bank conflicts
constexpr int LDZR = 2 * H + PAD;        // shared-memory row strides (elements)
constexpr int LDQ = H + PAD;
constexpr int XMAX = 64;
constexpr int RT = 4;                    // 16-row tiles a warp
constexpr int TM = 16 * RT;              // points of a tile

// weights, two [h0 | x] buffers and the [r*h] tile
size_t bf16_smem_bytes(int k) {
  return ((size_t)k * (LDZR + LDQ) + TM * (2 * (k + PAD) + LDQ)) * sizeof(bf16);
}

__global__ void __launch_bounds__(THREADS, 1)
gru_fwd_kernel(const bf16* __restrict__ h0, const bf16* __restrict__ x,
               const bf16* __restrict__ w_zr, const bf16* __restrict__ b_zr,
               const bf16* __restrict__ w_q, const bf16* __restrict__ b_q,
               int m, int xdim, int iters, bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = H + xdim, LDA = K + PAD;
  constexpr int KS = H / 16;               // 16-deep steps of an iteration's products
  const int tid = threadIdx.x, warp = tid >> 5, l = tid & 31;
  const int gr = l >> 2, c2 = (l & 3) * 2, cw = 16 * warp;
  bf16* s_wzr = reinterpret_cast<bf16*>(smem);   // [K][LDZR]
  bf16* s_wq = s_wzr + K * LDZR;                 // [K][LDQ]
  bf16* s_in = s_wq + K * LDQ;                   // 2 x [TM][LDA]  [h0 | x], then [bf16(h) | x]
  bf16* s_u = s_in + 2 * TM * LDA;               // [TM][LDQ]  bf16(r*h)

  // [h0 | x] of tile t into dst, 16 bytes a copy; rows past m zero-filled
  const int hv = H / 8, rv = hv + xdim / 8;
  auto fetch = [&](int t, bf16* dst) {
    const int row0 = t * TM;
    for (int i = tid; i < TM * rv; i += THREADS) {
      const int r = i / rv, c = i - r * rv;
      const bool ok = row0 + r < m;
      const size_t row = ok ? (size_t)(row0 + r) : 0;
      cp_async16(dst + r * LDA + c * 8,
                 c < hv ? h0 + row * H + c * 8 : x + row * xdim + (c - hv) * 8, ok);
    }
  };
  for (int i = tid; i < K * (2 * H / 8); i += THREADS) {
    const int r = i / (2 * H / 8), c = i % (2 * H / 8) * 8;
    cp_async16(s_wzr + r * LDZR + c, w_zr + r * 2 * H + c, true);
  }
  for (int i = tid; i < K * (H / 8); i += THREADS) {
    const int r = i / (H / 8), c = i % (H / 8) * 8;
    cp_async16(s_wq + r * LDQ + c, w_q + r * H + c, true);
  }
  const int tiles = (m + TM - 1) / TM;
  fetch(blockIdx.x, s_in);                 // the grid is at most the tiles
  cp_async_commit();

  // This lane's columns of a warp tile: cw + 8h + c2 + (e & 1), rows
  // 16·rt + gr + 8·(e >> 1), for h in {0, 1}, e in 0..3.
  float bz[2][2], br[2][2], bq[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = cw + 8 * h + c2 + e;
      bz[h][e] = __bfloat162float(b_zr[c]);
      br[h][e] = __bfloat162float(b_zr[H + c]);
      bq[h][e] = __bfloat162float(b_q[c]);
    }
  const int nzr[2] = {cw, H + cw}, nw[1] = {cw};
  float none[RT][4];
  // v (this warp's columns) into a shared tile, as bf16
  auto put = [&](bf16* dst, int ld, const float (&v)[RT][2][4]) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          st2(dst + (16 * rt + gr + 8 * e) * ld + cw + 8 * h + c2, v[rt][h][2 * e],
              v[rt][h][2 * e + 1]);
  };

  int buf = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * TM;
    const int nrows = m - row0 < TM ? m - row0 : TM;
    bf16* s_hx = s_in + buf * TM * LDA;
    cp_async_wait<0>();
    __syncthreads();                       // [h0 | x] (and the weights) landed; the last tile written out
    if (t + (int)gridDim.x < tiles) fetch(t + gridDim.x, s_in + (buf ^ 1) * TM * LDA);
    cp_async_commit();
    buf ^= 1;

    // this warp's columns of h0, and the accumulators' starting values:
    // x·W_x + b
    float hs[RT][2][4], szr[RT][2][2][4], sq[RT][1][2][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 v = ld2(s_hx + (16 * rt + gr + 8 * e) * LDA + cw + 8 * h + c2);
          hs[rt][h][2 * e] = v.x;
          hs[rt][h][2 * e + 1] = v.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          szr[rt][0][h][e] = bz[h][e & 1];
          szr[rt][1][h][e] = br[h][e & 1];
          sq[rt][0][h][e] = bq[h][e & 1];
        }
      }
    warp_mma<bf16, 2, true>(szr, none, false, s_hx + H, LDA, s_wzr + H * LDZR, LDZR,
                            xdim / 16, nzr, 0);
    warp_mma<bf16, 1, true>(sq, none, false, s_hx + H, LDA, s_wq + H * LDQ, LDQ, xdim / 16,
                            nw, 0);

    for (int it = 0; it < iters; ++it) {
      float z[RT][2][4];
      {
        // z, r = sigmoid(h W_h,zr + (x W_x,zr + b_zr)); bf16(r * h) into s_u
        float acc[RT][2][2][4], rh[RT][2][4];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[rt][j][h][e] = szr[rt][j][h][e];
        warp_mma<bf16, 2, true>(acc, none, false, s_hx, LDA, s_wzr, LDZR, KS, nzr, 0);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              z[rt][h][e] = sigmoid_f32(acc[rt][0][h][e]);
              rh[rt][h][e] = sigmoid_f32(acc[rt][1][h][e]) * hs[rt][h][e];
            }
        put(s_u, LDQ, rh);
      }
      __syncthreads();                     // s_u complete, s_hx read
      {
        // q = tanh((r*h) W_h,q + (x W_x,q + b_q)); h = (1 - z) h + z q; bf16(h) into s_hx
        float acc[RT][1][2][4];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[rt][0][h][e] = sq[rt][0][h][e];
        warp_mma<bf16, 1, true>(acc, none, false, s_u, LDQ, s_wq, LDQ, KS, nw, 0);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              hs[rt][h][e] = (1.f - z[rt][h][e]) * hs[rt][h][e] +
                             z[rt][h][e] * tanhf(acc[rt][0][h][e]);
        put(s_hx, LDA, hs);
      }
      __syncthreads();                     // s_hx complete, s_u read
    }
    // s_hx[:, :H] holds bf16(h): the output, rounded once
    spill<bf16, H, TM, THREADS>(out, s_hx, LDA, row0, nrows);
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// h0 [m, 128], x [m, xdim], w_zr [128 + xdim, 256], b_zr [256],
// w_q [128 + xdim, 128], b_q [128], out [m, 128]; all f32 or all bf16.
// bf16 needs xdim % 16 == 0, xdim <= 64 (shared-memory budget), f32
// xdim <= 128; both need h0, x, the weights and out 16-byte aligned.
// grid_blocks: persistent blocks (one per SM).
int fused_gru(const void* h0, const void* x, const void* w_zr, const void* b_zr,
              const void* w_q, const void* b_q, int m, int xdim, int iters,
              void* out, int is_bf16, int grid_blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m == 0) return (int)cudaGetLastError();
  if (!is_bf16) {
    if (xdim > F32_MAX_X) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        gru_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
    if (e != cudaSuccess) return (int)e;
    const int tiles = (m + 8 * F32_RI - 1) / (8 * F32_RI);
    const int blocks = tiles < grid_blocks ? tiles : grid_blocks;
    gru_fwd_f32_kernel<<<blocks, F_THREADS, F32_SMEM, st>>>(
        (const float*)h0, (const float*)x, (const float*)w_zr, (const float*)b_zr,
        (const float*)w_q, (const float*)b_q, m, xdim, iters, (float*)out);
    return (int)cudaGetLastError();
  }
  if (xdim % 16 != 0 || xdim > XMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = bf16_smem_bytes(H + xdim);
  cudaError_t e = cudaFuncSetAttribute(
      gru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (m + TM - 1) / TM;
  const int blocks = tiles < grid_blocks ? tiles : grid_blocks;
  gru_fwd_kernel<<<blocks, THREADS, smem, st>>>(
      (const bf16*)h0, (const bf16*)x, (const bf16*)w_zr, (const bf16*)b_zr,
      (const bf16*)w_q, (const bf16*)b_q, m, xdim, iters, (bf16*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
