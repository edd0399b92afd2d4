// Fused iterative ConvGRU backward (the DeFlow decoder's training hot loop).
// Given the forward of fused_gru.cu (H = 128, input width xdim) and the
// cotangent g of its output, computes dh0, dx, dW_zr, db_zr, dW_q, db_q with
// matmul operands in the compute dtype (bf16 or f32) and f32 accumulation;
// gates, state and gate gradients in f32; each operand rounded to the
// compute dtype where the plain version rounds it; each gradient rounded
// once, after its f32 sum.
//
// Replaces: deflow_tpu/ops/pallas_gru.py::_fused_bwd (the Pallas kernel
// _make_bwd_kernel), reached through fused_gru's custom VJP.
//
// Bound on the H100: operations.  Over M points and 4 iterations the
// backward does the forward once more plus two products per gate matrix,
// 3 x 2·M·192·384·4 FLOP (348 GFLOP at M = 196,608) against ~200 MB of
// h0/x/g/dh0/dx traffic.  This design runs 4·iters - 1 such 2·M·192·384
// products (the main kernel: iters - 1 forward, iters replayed in the
// backward walk, iters through W^T; the dW kernel: iters) and moves ~1.0 GB
// of bf16 dW operands through device memory (written once, read at most
// twice).
//
// Design.  The Pallas kernel keeps all iterations' (h, z, r, q) of a
// 512-row tile in VMEM (4 MB); a Hopper block has 227 KB, of which the bf16
// weights take 150 KB.  So:
//  1. gru_bwd_kernel: a constant wave of WAVE blocks (one an SM), each
//     walking 32-point tiles with the bf16 weights resident in shared
//     memory.  Warp w owns hidden columns [16w, 16w + 16): its z, r, q, h
//     and dh stay in registers, in mma.sync's accumulator layout, and every
//     epilogue (bias, sigmoid/tanh, the gate gradients) runs on the
//     accumulators.  The products are mma.sync m16n8k16 on ldmatrix
//     operands, rows padded to a stride of width + 8 (16 bytes past a
//     multiple of 128: conflict-free).  Only the operand tiles [h|x],
//     [r*h|x], ds_q and ds_zr pass through shared memory, so a block barrier
//     falls only where one changes hands: 2 per forward iteration, 4 per
//     backward one.  A tile runs the forward over iters - 1 iterations,
//     keeping each iteration's input state h (f32) in a per-block scratch
//     laid out as the fragments (each thread reads back what it wrote; the
//     next iteration's is loaded under the current one's products), then
//     walks the iterations in reverse: it recomputes z, r, q, forms the gate
//     gradients in f32 and back-propagates through W_q^T and W_zr^T; dh, dx
//     and the lane's share of db stay in registers.  The dW operands
//     (rounded exactly as the products use them; x left out, since it is the
//     same in every iteration) are written from their shared tiles with
//     16-byte stores, since dW (295 KB in f32) fits in neither registers nor
//     shared memory;
//  2. gru_bwd_dw_kernel: dW = A^T·B over all iters·M rows in slices of rows,
//     a block owning one slice and 128 output columns (dW_zr's two halves,
//     dW_q), A = [h | x] or [r*h | x] with x read at row mod M; stages of
//     64 rows (32 in f32) stream through a 4-stage ring of 16-byte cp.async
//     copies into mma.sync on ldmatrix.trans operands.  A crosses device memory at most
//     twice (once per dW_zr half), B once;
//  3. reduce_partials (mma_tile.cuh) sums the slices' dW and the blocks' db
//     in order.
// Every partial is sized from the shape alone (the wave is a constant, not
// the card's SM count), and no float atomics are used: the gradients are
// bit-identical from launch to launch and from card to card.
//
// The f32 route computes in true f32 (FFMA), as the plain version does, and
// is bound by operations: 3.89 ms at M = 196,608 at 67 TFLOP/s (FFMA
// outside the tensor cores).  Its f32 weights (288 KB) fit no block's
// shared memory, and a lane that reloads both operands for every one or
// two FMAs is capped by shared-memory loads.  So it has its own main
// kernel, gru_bwd_f32_kernel: register-blocked micro-tiles (a lane's 4
// points x 8 columns for z|r, 4 x 4 for q and the W^T products, 8 to 11
// FMAs a 16-byte load), the weights streamed from L2 through two stages of
// 16-byte cp.async copies (the next product's first stage under the
// current one's last; W's h rows transposed once a launch by gru_wt_f32
// for the W^T products), x·W_x + b once a tile as the gate products'
// starting values, and dx once a tile from the iterations' summed gate
// gradients (W_x is the same in every iteration).  Its forward recompute,
// per-iteration h scratch, dW operands and fixed-wave partials are the bf16
// route's; the dW kernel gives each lane a 12 x 8 micro-tile (96 FMAs per
// five 16-byte loads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "gru_tile.cuh"
#include "mma_tile.cuh"

namespace {

using gru_tile::cp_async16;
using gru_tile::F_WST;
using gru_tile::f32_fetch;
using gru_tile::f32_mm;
using gru_tile::WSrc;
using gru_tile::cp_async_commit;
using gru_tile::cp_async_wait;
using gru_tile::ld2;
using gru_tile::ldsm4;
using gru_tile::mma16816;
using gru_tile::spill;
using gru_tile::st2;
using gru_tile::warp_mma;
using tile::bf16;
using tile::from_f;
using tile::to_f;

constexpr int H = 128;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;                   // row padding against bank conflicts
constexpr int LDZR = 2 * H + PAD;        // shared-memory row strides (elements)
constexpr int LDQ = H + PAD;
constexpr int XMAX = 64;
constexpr int KMAX = H + XMAX;
// Blocks of the main kernel and of the dW product: one wave on an H100 SXM
// (one block an SM).  A constant, so that the partials depend on the shape
// alone.
constexpr int WAVE = 132;
// Points of a main-kernel tile: each warp holds RT 16-row tiles, so that
// each B fragment it loads serves RT products (238 registers in bf16, no
// spills; one 16-row tile read slower on the H100).
constexpr int RT = 2;
constexpr int TM = 16 * RT;

// Rows of a dW stage: 64 in bf16 (172 KB for 4 stages; 32 read 24% slower
// on the H100), 32 in f32.
template <typename T> __host__ __device__ constexpr int dw_rows() {
  return 128 / (int)sizeof(T);
}
constexpr int DW_STAGES = 4;
constexpr int DW_N = 128;                // output columns of a dW block
constexpr int DW_LDA = KMAX + PAD;       // stage strides (elements)
constexpr int DW_LDB = DW_N + PAD;
template <typename T> __host__ __device__ constexpr int dw_stage() {
  return dw_rows<T>() * (DW_LDA + DW_LDB);
}

__device__ __forceinline__ float sigmoid_f32(float v) { return 1.f / (1.f + expf(-v)); }

__host__ __device__ inline size_t align256(size_t v) { return (v + 255) & ~(size_t)255; }

// ------------------------------------------------------- main kernel
__host__ __device__ inline size_t main_smem_bytes(int k) {
  const size_t lda = k + PAD;
  return ((size_t)k * (LDZR + LDQ) + TM * (2 * lda + LDQ + LDZR)) * sizeof(bf16);
}

__global__ void __launch_bounds__(THREADS, 1)
gru_bwd_kernel(const bf16* __restrict__ h0, const bf16* __restrict__ x,
               const bf16* __restrict__ w_zr, const bf16* __restrict__ b_zr,
               const bf16* __restrict__ w_q, const bf16* __restrict__ b_q,
               const bf16* __restrict__ g, int m, int xdim, int iters,
               bf16* __restrict__ dh0, bf16* __restrict__ dx_out, float* __restrict__ hsave,
               bf16* __restrict__ sp_h, bf16* __restrict__ sp_u, bf16* __restrict__ sp_dszr,
               bf16* __restrict__ sp_dsq, float* __restrict__ db_part) {
  constexpr int V = 16 / (int)sizeof(bf16);        // elements a 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = H + xdim, LDA = K + PAD, KS = K / 16;
  const int tid = threadIdx.x, warp = tid >> 5, l = tid & 31;
  const int gr = l >> 2, c2 = (l & 3) * 2, cw = 16 * warp;
  bf16* s_wzr = reinterpret_cast<bf16*>(smem);
  bf16* s_wq = s_wzr + K * LDZR;
  bf16* s = s_wq + K * LDQ;
  for (int i = tid; i < K * (2 * H / V); i += THREADS) {
    const int r = i / (2 * H / V), c = i % (2 * H / V) * V;
    *reinterpret_cast<uint4*>(s_wzr + r * LDZR + c) =
        *reinterpret_cast<const uint4*>(w_zr + r * 2 * H + c);
  }
  for (int i = tid; i < K * (H / V); i += THREADS) {
    const int r = i / (H / V), c = i % (H / V) * V;
    *reinterpret_cast<uint4*>(s_wq + r * LDQ + c) =
        *reinterpret_cast<const uint4*>(w_q + r * H + c);
  }
  const bf16* wzr = s_wzr;
  const bf16* wq = s_wq;
  constexpr int ldzr = LDZR, ldq = LDQ;
  bf16* s_hx = s;                          // [TM][LDA]   [bf16(h) | x]
  bf16* s_u = s_hx + TM * LDA;             // [TM][LDA]   [bf16(r*h) | x]
  bf16* s_dsq = s_u + TM * LDA;            // [TM][LDQ]
  bf16* s_dszr = s_dsq + TM * LDQ;         // [TM][LDZR]  [ds_z | ds_r]

  // This lane's columns of a warp tile: cw + 8h + c2 + (e & 1), rows
  // 16·rt + gr + 8·(e >> 1), for h in {0, 1}, e in 0..3.
  float bz[2][2], br[2][2], bq[2][2];
  float dbz[2][2] = {}, dbr[2][2] = {}, dbq[2][2] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = cw + 8 * h + c2 + e;
      bz[h][e] = to_f(b_zr[c]);
      br[h][e] = to_f(b_zr[H + c]);
      bq[h][e] = to_f(b_q[c]);
    }
  const bool x8 = 8 * warp < xdim;         // this warp's 8 columns of x
  const int nzr[2] = {cw, H + cw}, nw[1] = {cw};
  const int slots = iters > 1 ? iters - 1 : 0;
  float4* hslots = reinterpret_cast<float4*>(hsave) + (size_t)blockIdx.x * slots * 2 * RT * THREADS;

  float hs[RT][2][4], dh[RT][2][4], z[RT][2][4], r[RT][2][4], q[RT][2][4], hn[RT][2][4];
  float dx[RT][4];

  // v (this warp's columns) into a shared tile at column offset coff, as bf16
  auto put = [&](bf16* dst, int ld, const float (&v)[RT][2][4], int coff) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          st2(dst + (16 * rt + gr + 8 * e) * ld + coff + 8 * h + c2, v[rt][h][2 * e],
              v[rt][h][2 * e + 1]);
  };
  // z, r = sigmoid([h | x] W_zr + b_zr) from s_hx; bf16(r * h) into s_u
  auto gates_zr = [&]() {
    float acc[RT][2][2][4] = {}, none[RT][4];
    warp_mma<bf16, 2, true>(acc, none, false, s_hx, LDA, wzr, ldzr, KS, nzr, 0);
    float rh[RT][2][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          z[rt][h][e] = sigmoid_f32(acc[rt][0][h][e] + bz[h][e & 1]);
          r[rt][h][e] = sigmoid_f32(acc[rt][1][h][e] + br[h][e & 1]);
          rh[rt][h][e] = r[rt][h][e] * hs[rt][h][e];
        }
    put(s_u, LDA, rh, cw);
  };
  // q = tanh([r*h | x] W_q + b_q) from s_u
  auto gate_q = [&]() {
    float acc[RT][1][2][4] = {}, none[RT][4];
    warp_mma<bf16, 1, true>(acc, none, false, s_u, LDA, wq, ldq, KS, nw, 0);
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) q[rt][h][e] = tanhf(acc[rt][0][h][e] + bq[h][e & 1]);
  };
  auto slot = [&](int it) { return hslots + (size_t)it * 2 * RT * THREADS + tid; };

  const int tiles = (m + TM - 1) / TM;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * TM;
    const int nrows = m - row0 < TM ? m - row0 : TM;
    // x into both operand tiles; this warp's columns of h0 and g
    const int xc = xdim / V;
    for (int i = tid; i < TM * xc; i += THREADS) {
      const int rr = i / xc, c = (i - rr * xc) * V;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (rr < nrows) v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + rr) * xdim + c);
      *reinterpret_cast<uint4*>(s_hx + rr * LDA + H + c) = v;
      *reinterpret_cast<uint4*>(s_u + rr * LDA + H + c) = v;
    }
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rr = 16 * rt + gr + 8 * e;
          float2 hv = make_float2(0.f, 0.f), gv = hv;
          if (rr < nrows) {
            const size_t o = (size_t)(row0 + rr) * H + cw + 8 * h + c2;
            hv = ld2(h0 + o);
            gv = ld2(g + o);
          }
          hs[rt][h][2 * e] = hv.x;
          hs[rt][h][2 * e + 1] = hv.y;
          dh[rt][h][2 * e] = gv.x;
          dh[rt][h][2 * e + 1] = gv.y;
        }
#pragma unroll
      for (int e = 0; e < 4; ++e) dx[rt][e] = 0.f;
    }
    put(s_hx, LDA, hs, cw);
    __syncthreads();

    // ---- forward over iters - 1 iterations, keeping each input state
    for (int it = 0; it + 1 < iters; ++it) {
      float4* sl = slot(it);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sl[(rt * 2 + h) * THREADS] =
              make_float4(hs[rt][h][0], hs[rt][h][1], hs[rt][h][2], hs[rt][h][3]);
      gates_zr();
      __syncthreads();                     // s_u complete, s_hx read
      gate_q();
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            hs[rt][h][e] = (1.f - z[rt][h][e]) * hs[rt][h][e] + z[rt][h][e] * q[rt][h][e];
      put(s_hx, LDA, hs, cw);
      __syncthreads();                     // s_hx complete, s_u read
    }

    // ---- backward, iterations in reverse; hs is this iteration's input
    for (int it = iters - 1; it >= 0; --it) {
      if (it > 0) {                        // the next input state, under this iteration
        const float4* sl = slot(it - 1);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 v = sl[(rt * 2 + h) * THREADS];
            hn[rt][h][0] = v.x;
            hn[rt][h][1] = v.y;
            hn[rt][h][2] = v.z;
            hn[rt][h][3] = v.w;
          }
      }
      const long long base = (long long)it * m + row0;
      gates_zr();
      __syncthreads();                     // s_u complete
      spill<bf16, H, TM, THREADS>(sp_h, s_hx, LDA, base, nrows);
      spill<bf16, H, TM, THREADS>(sp_u, s_u, LDA, base, nrows);
      gate_q();
      {
        float dsz[RT][2][4], dsq[RT][2][4];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float zv = z[rt][h][e], qv = q[rt][h][e], d = dh[rt][h][e];
              dsz[rt][h][e] = d * (qv - hs[rt][h][e]) * zv * (1.f - zv);
              dsq[rt][h][e] = d * zv * (1.f - qv * qv);
              dh[rt][h][e] = d * (1.f - zv);
              dbz[h][e & 1] += dsz[rt][h][e];
              dbq[h][e & 1] += dsq[rt][h][e];
            }
        put(s_dszr, LDZR, dsz, cw);
        put(s_dsq, LDQ, dsq, cw);
      }
      __syncthreads();                     // ds_q, ds_z complete
      spill<bf16, H, TM, THREADS>(sp_dsq, s_dsq, LDQ, base, nrows);
      {
        // du = ds_q W_q^T: h columns (ds_r, dh) and x columns (dx)
        float acc[RT][1][2][4] = {}, acc8[RT][4] = {};
        warp_mma<bf16, 1, false>(acc, acc8, x8, s_dsq, LDQ, wq, ldq, H / 16, nw, H + 8 * warp);
        float dsr[RT][2][4];
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float drh = acc[rt][0][h][e], rv = r[rt][h][e];
              dh[rt][h][e] += drh * rv;
              dsr[rt][h][e] = drh * hs[rt][h][e] * rv * (1.f - rv);
              dbr[h][e & 1] += dsr[rt][h][e];
            }
#pragma unroll
          for (int e = 0; e < 4; ++e) dx[rt][e] += acc8[rt][e];
        }
        put(s_dszr, LDZR, dsr, H + cw);
      }
      __syncthreads();                     // ds_zr complete
      spill<bf16, 2 * H, TM, THREADS>(sp_dszr, s_dszr, LDZR, base, nrows);
      {
        // dhx = ds_zr W_zr^T
        float acc[RT][1][2][4] = {}, acc8[RT][4] = {};
        warp_mma<bf16, 1, false>(acc, acc8, x8, s_dszr, LDZR, wzr, ldzr, 2 * H / 16, nw,
                                 H + 8 * warp);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) dh[rt][h][e] += acc[rt][0][h][e];
#pragma unroll
          for (int e = 0; e < 4; ++e) dx[rt][e] += acc8[rt][e];
        }
      }
      if (it > 0) {
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) hs[rt][h][e] = hn[rt][h][e];
        put(s_hx, LDA, hs, cw);
      }
      __syncthreads();                     // s_hx complete; every tile read
    }

#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rr = 16 * rt + gr + 8 * e;
        if (rr >= nrows) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          st2(dh0 + (size_t)(row0 + rr) * H + cw + 8 * h + c2, dh[rt][h][2 * e],
              dh[rt][h][2 * e + 1]);
        if (x8)
          st2(dx_out + (size_t)(row0 + rr) * xdim + 8 * warp + c2, dx[rt][2 * e],
              dx[rt][2 * e + 1]);
      }
  }

  // db: the lanes of a column (l % 4) summed in a fixed order, one row of
  // partials a block
  float* out = db_part + (size_t)blockIdx.x * 3 * H;
  auto put_db = [&](float (&v)[2][2], int off) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = v[h][e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (l < 4) out[off + cw + 8 * h + c2 + e] = s;
      }
  };
  put_db(dbz, 0);
  put_db(dbr, H);
  put_db(dbq, 2 * H);
}

// ------------------------------------------------------- f32 main kernel
// The f32 route of the main kernel: a tile of F_TM = 32 points; thread (rg,
// cg) owns rows rg + 8i (i < 4) and hidden columns 4cg .. 4cg + 4 of h, dh,
// z, r and q, in registers.  Every product is gru_tile.cuh's f32_mm (the
// forward's f32 kernel runs the same routine): C[32, N] += A[32, K] ·
// B[K, N], A a shared tile and B a weight matrix streamed from L2 through
// two cp.async stages.  The thread's 4 rows x 4 (q, W^T) or 8 (z|r)
// columns are fed per 4-deep step by 4 A float4 loads and 4 or 8 B float4
// loads: 8 or 11 FMAs a load.
constexpr int F_TM = 32;
constexpr int F_LDX = XMAX + 4;          // shared row strides (floats), 4 mod 32
constexpr int F_LDH = H + 4;
constexpr int F_LDZR = 2 * H + 4;
constexpr int F_LDS = 3 * H + 4;

constexpr size_t f32_smem_bytes() {
  return ((size_t)F_TM * (F_LDX + 3 * F_LDH + F_LDZR + F_LDS) + 2 * F_WST) * sizeof(float);
}

// The weights transposed for the backward's products through W^T, each
// [3H][H]: wt_h[k][n] = [W_zr | W_q][n][k] (n < H: the h rows), wt_x[k][n]
// = [W_zr | W_q][H + n][k] for n < xdim, zero beyond (the x rows).
__global__ void gru_wt_f32(const float* __restrict__ w_zr, const float* __restrict__ w_q,
                           int xdim, float* __restrict__ wt_h, float* __restrict__ wt_x) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < 3 * H * H; i += gridDim.x * blockDim.x) {
    const int k = i / H, n = i % H;
    const auto w = [&](int row) { return k < 2 * H ? w_zr[row * 2 * H + k] : w_q[row * H + k - 2 * H]; };
    wt_h[i] = w(n);
    wt_x[i] = n < xdim ? w(H + n) : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
gru_bwd_f32_kernel(const float* __restrict__ h0, const float* __restrict__ x,
                   const float* __restrict__ w_zr, const float* __restrict__ b_zr,
                   const float* __restrict__ w_q, const float* __restrict__ b_q,
                   const float* __restrict__ wt_h, const float* __restrict__ wt_x,
                   const float* __restrict__ g, int m, int xdim, int iters,
                   float* __restrict__ dh0, float* __restrict__ dx_out,
                   float* __restrict__ hsave, float* __restrict__ sp_h,
                   float* __restrict__ sp_u, float* __restrict__ sp_dszr,
                   float* __restrict__ sp_dsq, float* __restrict__ db_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_x = reinterpret_cast<float*>(smem);   // [TM][F_LDX]  x
  float* s_h = s_x + F_TM * F_LDX;               // [TM][F_LDH]  h
  float* s_u = s_h + F_TM * F_LDH;               // [TM][F_LDH]  r*h
  float* s_dsq = s_u + F_TM * F_LDH;             // [TM][F_LDH]  ds_q
  float* s_dszr = s_dsq + F_TM * F_LDH;          // [TM][F_LDZR] [ds_z | ds_r]
  float* s_sum = s_dszr + F_TM * F_LDZR;         // [TM][F_LDS]  Σ over iterations of [ds_z | ds_r | ds_q]
  float* wst = s_sum + F_TM * F_LDS;             // 2 weight stages of F_WST floats
  const int tid = threadIdx.x, warp = tid >> 5, l = tid & 31;
  const int rg = 4 * (warp & 1) + (l >> 3), cg = 8 * (warp >> 1) + (l & 7), c4 = 4 * cg;
  const WSrc zrx{w_zr + H * 2 * H, 2 * H, xdim, 2 * H}, qx{w_q + H * H, H, xdim, H};
  const WSrc zrh{w_zr, 2 * H, H, 2 * H}, qh{w_q, H, H, H};
  const WSrc wtzr{wt_h, H, 2 * H, H}, wtq{wt_h + 2 * H * H, H, H, H}, wtx{wt_x, H, 3 * H, H};
  float dbz[4] = {}, dbr[4] = {}, dbq[4] = {};
  const int slots = iters > 1 ? iters - 1 : 0;
  float4* hslots = reinterpret_cast<float4*>(hsave) + (size_t)blockIdx.x * slots * 4 * THREADS;
  auto slot = [&](int it, int i) { return hslots + ((size_t)it * 4 + i) * THREADS + tid; };
  int cur = 0;

  // v (this thread's 4 x 4) into a shared tile at column offset coff
  auto put = [&](float* dst, int ld, const float (&v)[4][4], int coff) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(dst + (rg + 8 * i) * ld + coff + c4) =
          *reinterpret_cast<const float4*>(v[i]);
  };
  // v's rows below nrows to device memory [row base + r][ld] at column coff
  auto spill = [&](float* dst, int ld, const float (&v)[4][4], long long base, int coff,
                   int nrows) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (rg + 8 * i < nrows)
        *reinterpret_cast<float4*>(dst + (base + rg + 8 * i) * ld + coff + c4) =
            *reinterpret_cast<const float4*>(v[i]);
  };
  auto add_sum = [&](const float (&v)[4][4], int coff) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4* p = reinterpret_cast<float4*>(s_sum + (rg + 8 * i) * F_LDS + coff + c4);
      const float4 a = *p;
      *p = make_float4(a.x + v[i][0], a.y + v[i][1], a.z + v[i][2], a.w + v[i][3]);
    }
  };

  const int tiles = (m + F_TM - 1) / F_TM;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * F_TM;
    const int nrows = m - row0 < F_TM ? m - row0 : F_TM;
    f32_fetch(zrx, 0, wst + cur * F_WST);
    // x (zero past m) into s_x; this thread's h0 and g; Σds = 0
    const int xc = xdim / 4;
    for (int i = tid; i < F_TM * xc; i += THREADS) {
      const int rr = i / xc, c = (i - rr * xc) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (rr < nrows) v = *reinterpret_cast<const float4*>(x + (size_t)(row0 + rr) * xdim + c);
      *reinterpret_cast<float4*>(s_x + rr * F_LDX + c) = v;
    }
    float hs[4][4], dh[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = rg + 8 * i;
      float4 hv = make_float4(0.f, 0.f, 0.f, 0.f), gv = hv;
      if (rr < nrows) {
        const size_t o = (size_t)(row0 + rr) * H + c4;
        hv = *reinterpret_cast<const float4*>(h0 + o);
        gv = *reinterpret_cast<const float4*>(g + o);
      }
      *reinterpret_cast<float4*>(hs[i]) = hv;
      *reinterpret_cast<float4*>(dh[i]) = gv;
#pragma unroll
      for (int part = 0; part < 3; ++part)
        *reinterpret_cast<float4*>(s_sum + rr * F_LDS + part * H + c4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    put(s_h, F_LDH, hs, 0);

    // x·W_x + b once a tile: the starting values of every gate product
    float xzr[4][8] = {}, xq[4][4] = {};
    f32_mm<2>(xzr, s_x, F_LDX, zrx, &qx, wst, cur, rg, c4);
    f32_mm<1>(xq, s_x, F_LDX, qx, iters > 0 ? &zrh : &wtx, wst, cur, rg, c4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bz = b_zr[c4 + j], br = b_zr[H + c4 + j], bq = b_q[c4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xzr[i][j] += bz;
        xzr[i][4 + j] += br;
        xq[i][j] += bq;
      }
    }

    float z[4][4], r[4][4], q[4][4], rh[4][4];
    // z, r = sigmoid(h W_h,zr + x W_x,zr + b_zr); r*h into s_u
    auto gate_zr = [&]() {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = xzr[i][j];
      f32_mm<2>(acc, s_h, F_LDH, zrh, &qh, wst, cur, rg, c4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          z[i][j] = sigmoid_f32(acc[i][j]);
          r[i][j] = sigmoid_f32(acc[i][4 + j]);
          rh[i][j] = r[i][j] * hs[i][j];
        }
      put(s_u, F_LDH, rh, 0);
    };
    // q = tanh((r*h) W_h,q + x W_x,q + b_q)
    auto gate_q = [&](const WSrc* nxt) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = xq[i][j];
      f32_mm<1>(acc, s_u, F_LDH, qh, nxt, wst, cur, rg, c4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) q[i][j] = tanhf(acc[i][j]);
    };

    // ---- forward over iters - 1 iterations, keeping each input state
    for (int it = 0; it + 1 < iters; ++it) {
#pragma unroll
      for (int i = 0; i < 4; ++i) *slot(it, i) = *reinterpret_cast<const float4*>(hs[i]);
      gate_zr();
      gate_q(&zrh);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) hs[i][j] = (1.f - z[i][j]) * hs[i][j] + z[i][j] * q[i][j];
      put(s_h, F_LDH, hs, 0);
    }

    // ---- backward, iterations in reverse; hs is this iteration's input
    for (int it = iters - 1; it >= 0; --it) {
      float hn[4][4];
      if (it > 0) {                        // the next input state, under this iteration
#pragma unroll
        for (int i = 0; i < 4; ++i) *reinterpret_cast<float4*>(hn[i]) = *slot(it - 1, i);
      }
      const long long base = (long long)it * m + row0;
      gate_zr();
      spill(sp_h, H, hs, base, 0, nrows);
      spill(sp_u, H, rh, base, 0, nrows);
      gate_q(&wtq);
      {
        float dsz[4][4], dsq[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float zv = z[i][j], qv = q[i][j], d = dh[i][j];
            dsz[i][j] = d * (qv - hs[i][j]) * zv * (1.f - zv);
            dsq[i][j] = d * zv * (1.f - qv * qv);
            dh[i][j] = d * (1.f - zv);
            dbz[j] += dsz[i][j];
            dbq[j] += dsq[i][j];
          }
        put(s_dsq, F_LDH, dsq, 0);
        put(s_dszr, F_LDZR, dsz, 0);
        add_sum(dsz, 0);
        add_sum(dsq, 2 * H);
        spill(sp_dsq, H, dsq, base, 0, nrows);
        spill(sp_dszr, 2 * H, dsz, base, 0, nrows);
      }
      {
        // drh = ds_q W_h,q^T
        float acc[4][4] = {}, dsr[4][4];
        f32_mm<1>(acc, s_dsq, F_LDH, wtq, &wtzr, wst, cur, rg, c4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float drh = acc[i][j], rv = r[i][j];
            dh[i][j] += drh * rv;
            dsr[i][j] = drh * hs[i][j] * rv * (1.f - rv);
            dbr[j] += dsr[i][j];
          }
        put(s_dszr, F_LDZR, dsr, H);
        add_sum(dsr, H);
        spill(sp_dszr, 2 * H, dsr, base, H, nrows);
      }
      {
        // dh += ds_zr W_h,zr^T
        float acc[4][4] = {};
        f32_mm<1>(acc, s_dszr, F_LDZR, wtzr, it > 0 ? &zrh : &wtx, wst, cur, rg, c4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dh[i][j] += acc[i][j];
      }
      if (it > 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) hs[i][j] = hn[i][j];
        put(s_h, F_LDH, hs, 0);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (rg + 8 * i < nrows)
        *reinterpret_cast<float4*>(dh0 + (size_t)(row0 + rg + 8 * i) * H + c4) =
            *reinterpret_cast<const float4*>(dh[i]);
    {
      // dx = Σ_it ds · W_x^T = Σds [32, 3H] · wt_x, once a tile (its columns
      // past xdim are zero and not stored)
      float acc[4][4] = {};
      f32_mm<1>(acc, s_sum, F_LDS, wtx, nullptr, wst, cur, rg, c4);
      if (c4 < xdim) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (rg + 8 * i < nrows)
            *reinterpret_cast<float4*>(dx_out + (size_t)(row0 + rg + 8 * i) * xdim + c4) =
                *reinterpret_cast<const float4*>(acc[i]);
      }
    }
    __syncthreads();                       // s_x and Σds read before the next tile
  }

  // db: a column's 8 row groups summed in a fixed order (lanes l ^ 8, l ^ 16
  // by shuffles, then the warp pair), one row of partials a block
  float v[12];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = dbz[j];
    v[4 + j] = dbr[j];
    v[8 + j] = dbq[j];
  }
#pragma unroll
  for (int e = 0; e < 12; ++e) {
    v[e] += __shfl_xor_sync(0xffffffffu, v[e], 8);
    v[e] += __shfl_xor_sync(0xffffffffu, v[e], 16);
  }
  float* red = s_dsq;                      // [2][32 column groups][12]
  if (l < 8) {
#pragma unroll
    for (int e = 0; e < 12; ++e) red[((warp & 1) * 32 + cg) * 12 + e] = v[e];
  }
  __syncthreads();
  for (int e = tid; e < 3 * H; e += THREADS) {
    const int part = e / H, col = e % H, k = (col / 4) * 12 + part * 4 + col % 4;
    db_part[(size_t)blockIdx.x * 3 * H + e] = red[k] + red[32 * 12 + k];
  }
}

// ------------------------------------------------------- dW product
// dW[k][n] = Σ_rows A[row][k] · B[row][n] for one slice of rows and 128
// output columns cb: cb 0, 1 the two halves of dW_zr (A = [h | x], B =
// ds_zr), cb 2 dW_q (A = [r*h | x], B = ds_q); x at row mod m.  Warp
// (wm, wn) owns dW rows 48·wm .. +48 and columns 64·wn .. +64 of the block.
template <typename T>
__device__ __forceinline__ void dw_step(float (&acc)[3][8][4], const T* sa, const T* sb,
                                        int wm, int wn, int ks) {
  const int l = threadIdx.x & 31;
  if constexpr (std::is_same<T, bf16>::value) {
    unsigned fa[3][4], fb[4][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (3 * wm + i < ks)
        ldsm4<true>(fa[i], sa + ((l >> 4) * 8 + (l & 7)) * DW_LDA + (3 * wm + i) * 16 +
                               (l >> 3 & 1) * 8);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ldsm4<true>(fb[j], sb + (l & 15) * DW_LDB + wn * 64 + j * 16 + (l >> 4) * 8);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (3 * wm + i < ks)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma16816(acc[i][2 * j], fa[i], fb[j][0], fb[j][1]);
          mma16816(acc[i][2 * j + 1], fa[i], fb[j][2], fb[j][3]);
        }
  } else {
    // f32: thread (kg, ng) = (t / 16, t % 16) owns dW rows 64i + 4kg + kk
    // (i < 3, kk < 4) x columns 64nh + 4ng + e (nh < 2, e < 4) of the block,
    // as acc[i][2kk + nh][e]; per stage row 3 + 2 float4 loads feed 96 FMAs
    // (rows past K are computed from the stage's padding and not stored).
    const int kg = threadIdx.x >> 4, ng = threadIdx.x & 15;
#pragma unroll 2
    for (int rr = 0; rr < 16; ++rr) {
      float av[3][4], bv[2][4];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        *reinterpret_cast<float4*>(av[i]) =
            *reinterpret_cast<const float4*>(sa + rr * DW_LDA + 64 * i + 4 * kg);
#pragma unroll
      for (int nh = 0; nh < 2; ++nh)
        *reinterpret_cast<float4*>(bv[nh]) =
            *reinterpret_cast<const float4*>(sb + rr * DW_LDB + 64 * nh + 4 * ng);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int nh = 0; nh < 2; ++nh)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][2 * kk + nh][e] = fmaf(av[i][kk], bv[nh][e], acc[i][2 * kk + nh][e]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
gru_bwd_dw_kernel(const T* __restrict__ sp_h, const T* __restrict__ sp_u,
                  const T* __restrict__ sp_dszr, const T* __restrict__ sp_dsq,
                  const T* __restrict__ x, int m, int xdim, long long rows, int slices,
                  float* __restrict__ part_zr, float* __restrict__ part_q) {
  constexpr int V = 16 / (int)sizeof(T), ROWS = dw_rows<T>(), STAGE = dw_stage<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* stages = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, l = tid & 31;
  const int cb = blockIdx.x % 3, slice = blockIdx.x / 3;
  const T* a = cb < 2 ? sp_h : sp_u;
  const T* b = cb < 2 ? sp_dszr + cb * DW_N : sp_dsq;
  const int ldb = cb < 2 ? 2 * H : H;
  const int K = H + xdim, KS = K / 16, xc = xdim / V;
  const long long per = ((rows + slices - 1) / slices + ROWS - 1) / ROWS * ROWS;
  const long long r_begin = slice * per;
  const long long r_end = r_begin + per < rows ? r_begin + per : rows;
  const int steps = r_end > r_begin ? (int)((r_end - r_begin + ROWS - 1) / ROWS) : 0;

  auto load = [&](int step) {
    T* sa = stages + (step % DW_STAGES) * STAGE;
    T* sb = sa + ROWS * DW_LDA;
    const long long r0 = r_begin + (long long)step * ROWS;
    for (int i = tid; i < ROWS * (H / V); i += THREADS) {
      const int rr = i / (H / V), c = i % (H / V) * V;
      const bool ok = r0 + rr < r_end;
      cp_async16(sa + rr * DW_LDA + c, ok ? a + (r0 + rr) * H + c : a, ok);
    }
    for (int i = tid; i < ROWS * xc; i += THREADS) {
      const int rr = i / xc, c = (i - rr * xc) * V;
      const bool ok = r0 + rr < r_end;
      const unsigned xr = ok ? (unsigned)(r0 + rr) % (unsigned)m : 0u;
      cp_async16(sa + rr * DW_LDA + H + c, x + (size_t)xr * xdim + c, ok);
    }
    for (int i = tid; i < ROWS * (DW_N / V); i += THREADS) {
      const int rr = i / (DW_N / V), c = i % (DW_N / V) * V;
      const bool ok = r0 + rr < r_end;
      cp_async16(sb + rr * DW_LDB + c, ok ? b + (r0 + rr) * ldb + c : b, ok);
    }
  };

  float acc[3][8][4] = {};
  const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();                       // this stage landed; the oldest is free
    if (step + DW_STAGES - 1 < steps) load(step + DW_STAGES - 1);
    cp_async_commit();
    const T* sa = stages + (step % DW_STAGES) * STAGE;
    const T* sb = sa + ROWS * DW_LDA;
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
      dw_step<T>(acc, sa + kk * 16 * DW_LDA, sb + kk * 16 * DW_LDB, wm, wn, KS);
  }
  cp_async_wait<0>();

  float* part = cb < 2 ? part_zr + (size_t)slice * K * 2 * H + cb * DW_N
                       : part_q + (size_t)slice * K * H;
  const int ldp = cb < 2 ? 2 * H : H;
  if constexpr (std::is_same<T, bf16>::value) {
    const int gr = l >> 2, c2 = (l & 3) * 2;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (3 * wm + i < KS)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<float2*>(part + (size_t)((3 * wm + i) * 16 + gr + 8 * e) * ldp +
                                       wn * 64 + j * 8 + c2) =
                make_float2(acc[i][j][2 * e], acc[i][j][2 * e + 1]);
  } else {
    const int kg = tid >> 4, ng = tid & 15;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (64 * i + 4 * kg + kk < K)
#pragma unroll
          for (int nh = 0; nh < 2; ++nh)
            *reinterpret_cast<float4*>(part + (size_t)(64 * i + 4 * kg + kk) * ldp + 64 * nh +
                                       4 * ng) =
                *reinterpret_cast<const float4*>(acc[i][2 * kk + nh]);
  }
}

// ------------------------------------------------------- host side
// Scratch layout (each piece 256-byte aligned) and the launch shapes, all
// from (m, xdim, iters) alone.
struct Scratch {
  size_t hsave, sp_h, sp_u, sp_dszr, sp_dsq, db_part, part_zr, part_q, wt, total;
  int grid, slices;
};

template <typename T>
Scratch scratch_layout(int m, int xdim, int iters) {
  const size_t esz = sizeof(T), rows = (size_t)iters * m;
  const int k = H + xdim, tiles = (m + TM - 1) / TM;
  Scratch s;
  s.grid = tiles < WAVE ? (tiles > 0 ? tiles : 1) : WAVE;
  // slices of at least 8 stages, at most a wave of blocks over the 3 column
  // blocks
  const long long sl = ((long long)rows + 8 * dw_rows<T>() - 1) / (8 * dw_rows<T>());
  s.slices = (int)(sl < 1 ? 1 : (sl > WAVE / 3 ? WAVE / 3 : sl));
  size_t o = 0;
  s.hsave = o;   o += align256((size_t)s.grid * (iters > 1 ? iters - 1 : 0) * TM * H * 4);
  s.sp_h = o;    o += align256(rows * H * esz);
  s.sp_u = o;    o += align256(rows * H * esz);
  s.sp_dszr = o; o += align256(rows * 2 * H * esz);
  s.sp_dsq = o;  o += align256(rows * H * esz);
  s.db_part = o; o += align256((size_t)s.grid * 3 * H * 4);
  s.part_zr = o; o += align256((size_t)s.slices * k * 2 * H * 4);
  s.part_q = o;  o += align256((size_t)s.slices * k * H * 4);
  s.wt = o;      o += sizeof(T) == 4 ? align256((size_t)2 * 3 * H * H * 4) : 0;
  s.total = o;
  return s;
}

template <typename T>
int run(const void* h0, const void* x, const void* w_zr, const void* b_zr,
        const void* w_q, const void* b_q, const void* g, int m, int xdim, int iters,
        void* dh0, void* dx, void* dwzr, void* dbzr, void* dwq, void* dbq,
        void* scratch, cudaStream_t st) {
  const int k = H + xdim;
  const Scratch sc = scratch_layout<T>(m, xdim, iters);
  unsigned char* s = (unsigned char*)scratch;
  float* db_part = (float*)(s + sc.db_part);
  float* part_zr = (float*)(s + sc.part_zr);
  float* part_q = (float*)(s + sc.part_q);
  T* sp_h = (T*)(s + sc.sp_h);
  T* sp_u = (T*)(s + sc.sp_u);
  T* sp_dszr = (T*)(s + sc.sp_dszr);
  T* sp_dsq = (T*)(s + sc.sp_dsq);
  cudaError_t e;
  if (m == 0) {
    if ((e = cudaMemsetAsync(db_part, 0, 3 * H * 4, st)) != cudaSuccess) return (int)e;
  } else if constexpr (sizeof(T) == 4) {
    float* wt = (float*)(s + sc.wt);
    gru_wt_f32<<<48, 256, 0, st>>>((const float*)w_zr, (const float*)w_q, xdim, wt,
                                   wt + 3 * H * H);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(gru_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)f32_smem_bytes());
    if (e != cudaSuccess) return (int)e;
    gru_bwd_f32_kernel<<<sc.grid, THREADS, f32_smem_bytes(), st>>>(
        (const float*)h0, (const float*)x, (const float*)w_zr, (const float*)b_zr,
        (const float*)w_q, (const float*)b_q, wt, wt + 3 * H * H, (const float*)g, m, xdim,
        iters, (float*)dh0, (float*)dx, (float*)(s + sc.hsave), (float*)sp_h, (float*)sp_u,
        (float*)sp_dszr, (float*)sp_dsq, db_part);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  } else {
    const size_t smem = main_smem_bytes(k);
    e = cudaFuncSetAttribute(gru_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    gru_bwd_kernel<<<sc.grid, THREADS, smem, st>>>(
        (const T*)h0, (const T*)x, (const T*)w_zr, (const T*)b_zr, (const T*)w_q,
        (const T*)b_q, (const T*)g, m, xdim, iters, (T*)dh0, (T*)dx,
        (float*)(s + sc.hsave), sp_h, sp_u, sp_dszr, sp_dsq, db_part);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const size_t dw_smem = (size_t)DW_STAGES * dw_stage<T>() * sizeof(T);
  e = cudaFuncSetAttribute(gru_bwd_dw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dw_smem);
  if (e != cudaSuccess) return (int)e;
  gru_bwd_dw_kernel<T><<<3 * sc.slices, THREADS, dw_smem, st>>>(
      sp_h, sp_u, sp_dszr, sp_dsq, (const T*)x, m, xdim, (long long)iters * m, sc.slices,
      part_zr, part_q);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int dbn = m > 0 ? sc.grid : 1;
  if ((e = tile::launch_reduce<T>(part_zr, sc.slices, (long long)k * 2 * H,
                                  (long long)k * 2 * H, (T*)dwzr, st)) != cudaSuccess) return (int)e;
  if ((e = tile::launch_reduce<T>(part_q, sc.slices, (long long)k * H, (long long)k * H,
                                  (T*)dwq, st)) != cudaSuccess) return (int)e;
  if ((e = tile::launch_reduce<T>(db_part, dbn, 3 * H, 2 * H, (T*)dbzr, st)) != cudaSuccess) return (int)e;
  return (int)tile::launch_reduce<T>(db_part + 2 * H, dbn, 3 * H, H, (T*)dbq, st);
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// Bytes of device scratch fused_gru_bwd needs (kept input states, dW
// operands, per-block and per-slice partials).
long long fused_gru_bwd_scratch_bytes(int m, int xdim, int iters, int is_bf16) {
  return (long long)(is_bf16 ? scratch_layout<bf16>(m, xdim, iters).total
                             : scratch_layout<float>(m, xdim, iters).total);
}

// h0, g [m, 128]; x [m, xdim]; w_zr [128 + xdim, 256], b_zr [256];
// w_q [128 + xdim, 128], b_q [128]; all f32 or all bf16, 16-byte aligned,
// gradients in the same shapes and dtype.  xdim % 16 == 0, xdim <= 64,
// iters * m < 2^31.
int fused_gru_bwd(const void* h0, const void* x, const void* w_zr, const void* b_zr,
                  const void* w_q, const void* b_q, const void* g, int m, int xdim,
                  int iters, void* dh0, void* dx, void* dwzr, void* dbzr, void* dwq,
                  void* dbq, void* scratch, int is_bf16, void* stream) {
  if (xdim % 16 != 0 || xdim > XMAX || xdim <= 0 || iters < 0 || m < 0 ||
      (long long)iters * m >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return run<bf16>(h0, x, w_zr, b_zr, w_q, b_q, g, m, xdim, iters, dh0, dx, dwzr,
                     dbzr, dwq, dbq, scratch, st);
  return run<float>(h0, x, w_zr, b_zr, w_q, b_q, g, m, xdim, iters, dh0, dx, dwzr,
                    dbzr, dwq, dbq, scratch, st);
}

}  // extern "C"
