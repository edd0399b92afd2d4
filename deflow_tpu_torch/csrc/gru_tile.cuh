// Pieces shared by the GRU forward (fused_gru.cu) and backward
// (fused_gru_bwd.cu): ldmatrix operand loads, mma.sync m16n8k16, the
// RT x 16-row bf16 warp product over a shared A tile,
// pair loads and stores, cp.async, the f32 routes' FFMA product with its
// weights streamed from L2, and the 16-byte copy of a shared tile to
// device memory.  ldsm4 and mma16816 are copies of cbg.cu's (that file
// stays as it is).  stem.cu takes ldsm4, mma16816 and cp.async from here.
//
// mma.sync's accumulator layout (a 16 x 8 tile): lane l holds rows l/4 and
// l/4 + 8, columns 2(l%4) and 2(l%4) + 1, as d[0..1] and d[2..3].
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

namespace gru_tile {

using bf16 = __nv_bfloat16;

// Four 8x8 bf16 matrices from shared memory; lane l gives the row address
// of matrix l/8.  With trans, each is read transposed.
template <bool TRANS>
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Two 8x8 bf16 matrices; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm2(unsigned (&r)[2], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[rt][j] (16 x 16: rows 16·rt.., columns n0[j]..) and, when x8,
// acc8[rt] (16 x 8 at column n8; B(k, n) = b[n * ldb + k] only) += A · B
// over ks 16-deep steps, in bf16.  A [16·RT][lda] row-major in shared
// memory; B(k, n) = b[k * ldb + n] (KN) or b[n * ldb + k].  Each A fragment
// serves every column tile, each B fragment every row tile.
template <typename T, int NJ, bool KN, int RT>
__device__ __forceinline__ void warp_mma(float (&acc)[RT][NJ][2][4], float (&acc8)[RT][4],
                                         bool x8, const T* a, int lda, const T* b, int ldb,
                                         int ks, const int (&n0)[NJ], int n8) {
  static_assert(std::is_same<T, bf16>::value, "warp_mma: bf16 operands");
  const int l = threadIdx.x & 31;
  for (int kk = 0; kk < ks; ++kk) {
    unsigned fa[RT][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
      ldsm4<false>(fa[rt], a + (rt * 16 + (l & 15)) * lda + kk * 16 + (l >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      unsigned fb[4];
      if constexpr (KN)
        ldsm4<true>(fb, b + (kk * 16 + (l & 15)) * ldb + n0[j] + (l >> 4) * 8);
      else
        ldsm4<false>(fb, b + (n0[j] + (l >> 4) * 8 + (l & 7)) * ldb + kk * 16 + (l >> 3 & 1) * 8);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) {
        mma16816(acc[rt][j][0], fa[rt], fb[0], fb[1]);
        mma16816(acc[rt][j][1], fa[rt], fb[2], fb[3]);
      }
    }
    if (x8) {
      unsigned fb[2];
      ldsm2(fb, b + (n8 + (l & 7)) * ldb + kk * 16 + (l >> 3 & 1) * 8);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) mma16816(acc8[rt], fa[rt], fb[0], fb[1]);
    }
  }
}

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16 bytes from global to shared memory; zero-filled (nothing read) when
// !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------------- f32 products
// The f32 (FFMA) product of the GRU forward's and backward's f32 kernels
// (blocks of F_THREADS threads, hidden width F_H): C[8·RI, N] += A[8·RI, K]
// · B[K, N], A a shared tile (row stride 4 mod 32 floats: the 4 rows a
// warp's load reads fall in distinct banks) and B a weight matrix streamed
// from device memory (held in L2) in stages of F_WST floats (32 rows of
// 2·F_H, 64 of F_H) by 16-byte cp.async into two stage buffers; the next
// product's first stage is copied under the current product's last.
// Thread (rg, cg) owns rows rg + 8i (i < RI) and columns g·F_H + 4cg .. +4
// (g < NG): per 4-deep step RI A float4 and 4·NG B float4 loads feed
// 16·RI·NG FMAs.  UNROLL: 4-deep steps unrolled (the forward reads faster
// at 4, the backward, at 255 registers, at 2).
constexpr int F_H = 128;
constexpr int F_THREADS = 256;
constexpr int F_WST = 32 * 2 * F_H;      // one weight stage (floats)

// rows [0, rows) x columns [0, cols) of a row-major matrix of row stride ld
struct WSrc {
  const float* p;
  int ld, rows, cols;
};

// Stage ch (F_WST / b.cols rows; b.cols is F_H or 2·F_H) of b into dst, 16
// bytes a copy, rows past b.rows zero.
__device__ __forceinline__ void f32_fetch(const WSrc& b, int ch, float* dst) {
  const int sh = b.cols == 2 * F_H ? 6 : 5, kc = F_WST / b.cols, k0 = ch * kc;
  const int c = (threadIdx.x & ((1 << sh) - 1)) * 4;
#pragma unroll
  for (int i = threadIdx.x; i < F_WST / 4; i += F_THREADS) {
    const int r = i >> sh;
    const bool ok = k0 + r < b.rows;
    cp_async16(dst + r * b.cols + c, ok ? b.p + (size_t)(k0 + r) * b.ld + c : b.p, ok);
  }
  cp_async_commit();
}

// acc[i][4g + j] += Σ_k A[rg + 8i][k] · B[k][g·F_H + c4 + j] over k < b.rows
// (A's columns up to b.rows rounded to 4 are read: zero them).  Stage 0 of
// b is in (or on its way to) stage buffer cur; the copy of nxt's stage 0
// (null: none) starts under b's last stage.  One barrier a stage, before
// its products: it publishes the A tile and the landed stage, and frees the
// other buffer for the next copy.  A thread may return while others still
// read A, so the callers write a shared tile only after a product that
// reads another one (the next barrier orders the rest).
template <int NG, int RI, int UNROLL = 2>
__device__ __forceinline__ void f32_mm(float (&acc)[RI][4 * NG], const float* sa, int lda,
                                       const WSrc& b, const WSrc* nxt, float* wst, int& cur,
                                       int rg, int c4) {
  const int kc = F_WST / b.cols, nch = (b.rows + kc - 1) / kc;
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<0>();
    __syncthreads();                       // stage ch landed; the A tile is complete
    if (ch + 1 < nch)
      f32_fetch(b, ch + 1, wst + (cur ^ 1) * F_WST);
    else if (nxt)
      f32_fetch(*nxt, 0, wst + (cur ^ 1) * F_WST);
    const float* st = wst + cur * F_WST + c4;
    const float* a = sa + rg * lda + ch * kc;
    const int kn = b.rows - ch * kc < kc ? b.rows - ch * kc : kc;
#pragma unroll UNROLL
    for (int k = 0; k < kn; k += 4) {
      float av[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        *reinterpret_cast<float4*>(av[i]) = *reinterpret_cast<const float4*>(a + 8 * i * lda + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[NG][4];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          *reinterpret_cast<float4*>(bv[g]) =
              *reinterpret_cast<const float4*>(st + (k + q) * b.cols + g * F_H);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int g = 0; g < NG; ++g)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][4 * g + j] = fmaf(av[i][q], bv[g][j], acc[i][4 * g + j]);
      }
    }
    cur ^= 1;
  }
}

// The first nrows rows of a shared [ROWS][ld] tile, COLS columns, to
// dst[(row_base + r) * COLS ..], 16 bytes a thread, by a block of NTHREADS.
template <typename T, int COLS, int ROWS, int NTHREADS>
__device__ __forceinline__ void spill(T* __restrict__ dst, const T* src, int ld,
                                      long long row_base, int nrows) {
  constexpr int CPR = COLS * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR * (16 / (int)sizeof(T));
    if (r < nrows)
      *reinterpret_cast<uint4*>(dst + (row_base + r) * COLS + c) =
          *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

}  // namespace gru_tile
