// Fused conv3x3 (stride 1, pad 1) + train-mode BatchNorm + exact GELU
// blocks of the U-Net encoder, forward and backward, on channels-last (NHWC)
// activations in the compute dtype (bf16 or f32).
//
//   forward  block:  s = conv3x3(u) + bias,  u = gelu(bn_prev(x)) applied on
//                    load (or u = x at a chain head without input BN);
//                    s rounded to the compute dtype; per-block partial Σs and
//                    Σs² of the ROUNDED s (f32), for the batch statistics.
//   backward block:  ds = γ·istd·(dz − A − ẑ·B) on load (the BN backward,
//                    A = Σdz/n, B = Σdz·ẑ/n);  dgrad through the flipped taps,
//                    times gelu'(z_prev) when the input had a BN;  wgrad over
//                    the 9 taps;  per-block partial db, Σdz_prev, Σdz_prev·ẑ_prev.
//
// Replaces: deflow_tpu/ops/pallas_cbg.py::cbg_block_fwd and ::cbg_block_bwd
// (the Pallas kernels _make_fwd_kernel and _make_bwd_kernel), chained by
// cbg_chain.  The TPU kernels' guard-padded flat layout, lane padding,
// roll-based taps and polynomial erf are Mosaic workarounds and are not
// carried over: image borders are zero by masking on load, and GELU uses erff.
//
// Bound on the H100: at 2B = 4, 256²x64→64 and 128²x128→128 each cost
// 19.3 GFLOP per forward (two such products per backward) against 67 MB
// (256²) and 34 MB (128²) of activations: operations and bytes are about even.
//
// Design.  Forward and dgrad: one block per 64-pixel row segment and all
// output channels (<= 128).  The block builds its input window (3 rows x 66
// pixels x all channels) in shared memory once, with the prologue (input BN
// and GELU, or the BN backward for ds) applied in f32 and rounded to the
// compute dtype exactly as the products consume it, then sums the 9 taps as
// 16x16 tile products (WMMA on bf16, FFMA on f32) from shifted views of the
// window, staging one tap's weights at a time in shared memory.  The
// epilogue runs through an f32 staging tile: bias, rounding, the column sums
// of the block.  wgrad ([9, C, O] f32 is 590 KB at 128 channels, beyond any
// block) runs as a second kernel: each block sums one 64x64 (c, o) tile of
// one tap over one slice of the pixels into its own f32 partial, from the
// dgrad kernel's rounded ds and input activations; a third kernel reduces
// the partials in slice order.  No float atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

using tile::Acc;
using tile::bf16;
using tile::from_f;
using tile::to_f;

constexpr int TP = 64;                   // output pixels per block (one row segment)
constexpr int WIN = TP + 2;              // window pixels per row
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAXC = 128;
constexpr float SQRT1_2 = 0.7071067811865476f;
constexpr float SQRT1_2PI = 0.3989422804014327f;

enum { S_MEAN, S_ISTD, S_GAMMA, S_BETA, S_A, S_B, N_SCAL };

__device__ __forceinline__ float gelu(float x) { return x * 0.5f * (1.f + erff(x * SQRT1_2)); }
__device__ __forceinline__ float gelu_grad(float x) {
  return 0.5f * (1.f + erff(x * SQRT1_2)) + x * expf(-0.5f * x * x) * SQRT1_2PI;
}

__host__ __device__ inline int r16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int r64(int v) { return (v + 63) / 64 * 64; }
__host__ inline size_t align256(size_t v) { return (v + 255) & ~(size_t)255; }

// Shared memory of the forward (DGRAD false) and dgrad (true) kernels:
// window [3][WIN][win_c + 16], one tap's weights [C16][O16 + 8] (the f32
// epilogue staging [TP][out_c + 4] reuses it).
template <typename T>
size_t conv_smem_bytes(int c, int o, bool dgrad) {
  const int win_c = dgrad ? r16(o) : r16(c), out_c = dgrad ? r16(c) : r16(o);
  const size_t win = (size_t)3 * WIN * (win_c + 16) * sizeof(T);
  const size_t w = (size_t)r16(c) * (r16(o) + 8) * sizeof(T);
  const size_t stage = (size_t)TP * (out_c + 4) * 4;
  return win + (w > stage ? w : stage);
}

// Sum of the 9 taps over the window for this warp's output tiles.
// Forward: out[p][o] += Σ_c win[ky][p + kx][c] · W[ky][kx][c][o].
// Dgrad:   out[p][c] += Σ_o win[2 - ky][p + 2 - kx][o] · W[ky][kx][c][o].
template <typename T, bool DGRAD>
__device__ void conv_taps(const T* win, int ldw, const T* __restrict__ wmat,
                          int c, int o, T* s_w, Acc<T>* acc, int nacc) {
  const int c16 = r16(c), o16 = r16(o), ldo = o16 + 8;
  const int warp = threadIdx.x / 32, rt = warp % 4, cg = warp / 4;
  const int ksteps = (DGRAD ? o16 : c16) / 16;
  const T zero = from_f<T>(0.f);
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    __syncthreads();
    const T* wt = wmat + (size_t)tap * c * o;
    for (int i = threadIdx.x; i < c16 * o16; i += THREADS) {
      const int ci = i / o16, oi = i % o16;
      s_w[ci * ldo + oi] = ci < c && oi < o ? wt[ci * o + oi] : zero;
    }
    __syncthreads();
    const int wy = DGRAD ? 2 - ky : ky, wx = DGRAD ? 2 - kx : kx;
    const T* a0 = win + ((size_t)wy * WIN + wx + rt * 16) * ldw;
    for (int kk = 0; kk < ksteps; ++kk) {
      for (int j = 0; j < nacc; ++j) {
        const int ct = cg + 2 * j;
        if (DGRAD)
          acc[j].template mma<true, false>(a0 + kk * 16, ldw,
                                           s_w + ct * 16 * ldo + kk * 16, ldo);
        else
          acc[j].template mma<true, true>(a0 + kk * 16, ldw,
                                          s_w + kk * 16 * ldo + ct * 16, ldo);
      }
    }
  }
  __syncthreads();
}

// Store this warp's accumulators into the f32 staging tile [TP][lds].
template <typename T>
__device__ void stage_out(Acc<T>* acc, int nacc, float* stage, int lds) {
  const int warp = threadIdx.x / 32, rt = warp % 4, cg = warp / 4;
  for (int j = 0; j < nacc; ++j) acc[j].store(stage + rt * 16 * lds + (cg + 2 * j) * 16, lds);
  __syncthreads();
}

__device__ __forceinline__ int warp_tiles(int ncols16) {
  const int cg = (threadIdx.x / 32) / 4;
  return cg < ncols16 ? (ncols16 - cg + 1) / 2 : 0;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cbg_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wmat,
               const T* __restrict__ bias, const float* __restrict__ scal,
               int h, int w, int c, int o, T* __restrict__ s, float* __restrict__ ps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c16 = r16(c), o16 = r16(o), ldw = c16 + 16, lds = o16 + 4;
  T* win = (T*)smem;
  T* s_w = win + 3 * WIN * ldw;
  float* stage = (float*)s_w;
  const int segs = (w + TP - 1) / TP;
  const int blk = blockIdx.x;
  const int seg = blk % segs, y = (blk / segs) % h, b = blk / (segs * h);
  const int x0 = seg * TP;
  const T zero = from_f<T>(0.f);

  for (int i = threadIdx.x; i < 3 * WIN * c16; i += THREADS) {
    const int ci = i % c16, j = (i / c16) % WIN, ky = i / (c16 * WIN);
    const int yy = y + ky - 1, xx = x0 + j - 1;
    T v = zero;
    if (ci < c && yy >= 0 && yy < h && xx >= 0 && xx < w) {
      v = x[(((size_t)b * h + yy) * w + xx) * c + ci];
      if (scal) {
        const float z = (to_f(v) - scal[S_MEAN * c + ci]) * scal[S_ISTD * c + ci]
                        * scal[S_GAMMA * c + ci] + scal[S_BETA * c + ci];
        v = from_f<T>(gelu(z));
      }
    }
    win[(ky * WIN + j) * ldw + ci] = v;
  }
  Acc<T> acc[MAXC / 32];
  const int nacc = warp_tiles(o16 / 16);
  for (int j = 0; j < nacc; ++j) acc[j].zero();
  conv_taps<T, false>(win, ldw, wmat, c, o, s_w, acc, nacc);
  stage_out(acc, nacc, stage, lds);

  const int np = w - x0 < TP ? w - x0 : TP;
  const size_t pix0 = ((size_t)b * h + y) * w + x0;
  for (int i = threadIdx.x; i < np * o; i += THREADS) {
    const int p = i / o, oi = i % o;
    const T sv = from_f<T>(stage[p * lds + oi] + to_f(bias[oi]));
    s[(pix0 + p) * o + oi] = sv;
    stage[p * lds + oi] = to_f(sv);
  }
  __syncthreads();
  for (int oi = threadIdx.x; oi < o; oi += THREADS) {
    float s1 = 0.f, s2 = 0.f;
    for (int p = 0; p < np; ++p) {
      const float v = stage[p * lds + oi];
      s1 += v;
      s2 += v * v;
    }
    ps[((size_t)blk * 2) * o + oi] = s1;
    ps[((size_t)blk * 2 + 1) * o + oi] = s2;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cbg_dgrad_kernel(const T* __restrict__ dz, const T* __restrict__ si,
                 const T* __restrict__ sp, const T* __restrict__ wmat,
                 const float* __restrict__ scal_in, const float* __restrict__ scal_out,
                 int h, int w, int c, int o, T* __restrict__ dzp, T* __restrict__ ds_out,
                 T* __restrict__ x_out, float* __restrict__ db_part,
                 float* __restrict__ psp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c16 = r16(c), o16 = r16(o), ldw = o16 + 16, lds = c16 + 4;
  T* win = (T*)smem;
  T* s_w = win + 3 * WIN * ldw;
  float* stage = (float*)s_w;
  const int segs = (w + TP - 1) / TP;
  const int blk = blockIdx.x;
  const int seg = blk % segs, y = (blk / segs) % h, b = blk / (segs * h);
  const int x0 = seg * TP;
  const int np = w - x0 < TP ? w - x0 : TP;
  const size_t pix0 = ((size_t)b * h + y) * w + x0;
  const T zero = from_f<T>(0.f);

  // ds = γ·istd·(dz − A − ẑ·B) on the window; the centre row is also this
  // block's share of ds for the wgrad kernel
  for (int i = threadIdx.x; i < 3 * WIN * o16; i += THREADS) {
    const int oi = i % o16, j = (i / o16) % WIN, ky = i / (o16 * WIN);
    const int yy = y + ky - 1, xx = x0 + j - 1;
    T v = zero;
    if (oi < o && yy >= 0 && yy < h && xx >= 0 && xx < w) {
      const size_t e = (((size_t)b * h + yy) * w + xx) * o + oi;
      const float zh = (to_f(si[e]) - scal_in[S_MEAN * o + oi]) * scal_in[S_ISTD * o + oi];
      v = from_f<T>(scal_in[S_GAMMA * o + oi] * scal_in[S_ISTD * o + oi]
                    * (to_f(dz[e]) - scal_in[S_A * o + oi] - zh * scal_in[S_B * o + oi]));
      if (ky == 1 && j >= 1 && j <= TP) ds_out[e] = v;
    }
    win[(ky * WIN + j) * ldw + oi] = v;
  }
  __syncthreads();
  for (int oi = threadIdx.x; oi < o; oi += THREADS) {
    float s1 = 0.f;
    for (int p = 0; p < np; ++p) s1 += to_f(win[(WIN + 1 + p) * ldw + oi]);
    db_part[(size_t)blk * o + oi] = s1;
  }
  Acc<T> acc[MAXC / 32];
  const int nacc = warp_tiles(c16 / 16);
  for (int j = 0; j < nacc; ++j) acc[j].zero();
  conv_taps<T, true>(win, ldw, wmat, c, o, s_w, acc, nacc);
  stage_out(acc, nacc, stage, lds);

  for (int i = threadIdx.x; i < np * c; i += THREADS) {
    const int p = i / c, ci = i % c;
    const size_t e = (pix0 + p) * c + ci;
    float d = stage[p * lds + ci];
    if (scal_out) {
      const float z = (to_f(sp[e]) - scal_out[S_MEAN * c + ci]) * scal_out[S_ISTD * c + ci]
                      * scal_out[S_GAMMA * c + ci] + scal_out[S_BETA * c + ci];
      d *= gelu_grad(z);
      x_out[e] = from_f<T>(gelu(z));
      stage[p * lds + ci] = d;
    }
    dzp[e] = from_f<T>(d);
  }
  __syncthreads();
  for (int ci = threadIdx.x; ci < c; ci += THREADS) {
    float s1 = 0.f, s2 = 0.f;
    if (scal_out) {
      const float mean = scal_out[S_MEAN * c + ci], istd = scal_out[S_ISTD * c + ci];
      for (int p = 0; p < np; ++p) {
        const float d = stage[p * lds + ci];
        s1 += d;
        s2 += d * ((to_f(sp[(pix0 + p) * c + ci]) - mean) * istd);
      }
    }
    psp[((size_t)blk * 2) * c + ci] = s1;
    psp[((size_t)blk * 2 + 1) * c + ci] = s2;
  }
}

// part[slice][tap][c][o] (c, o padded to 64) = Σ over the slice's pixels of
// xa(pixel shifted by the tap)[c] · ds(pixel)[o], zero outside the image.
constexpr int WG_ROWS = 32;
constexpr int WG_LD = 64 + 8;

template <typename T>
__global__ void __launch_bounds__(THREADS)
cbg_wgrad_kernel(const T* __restrict__ xa, const T* __restrict__ ds, int bsz, int h,
                 int w, int c, int o, int slices, float* __restrict__ part) {
  __shared__ __align__(128) T s_a[WG_ROWS * WG_LD];
  __shared__ __align__(128) T s_b[WG_ROWS * WG_LD];
  const int ct_n = (c + 63) / 64, ot_n = (o + 63) / 64, cp = ct_n * 64, op = ot_n * 64;
  const int tile = blockIdx.x;
  const int tap = tile / (ct_n * ot_n), c0 = (tile / ot_n) % ct_n * 64, o0 = tile % ot_n * 64;
  const int ky = tap / 3, kx = tap % 3;
  const long long npix = (long long)bsz * h * w;
  const long long per = (npix + slices - 1) / slices;
  const long long q_begin = blockIdx.y * per;
  const long long q_end = q_begin + per < npix ? q_begin + per : npix;
  const int tid = threadIdx.x, warp = tid / 32, rt = warp % 4, cg = warp / 4;
  const T zero = from_f<T>(0.f);
  Acc<T> acc[2];
  acc[0].zero();
  acc[1].zero();
  for (long long q0 = q_begin; q0 < q_end; q0 += WG_ROWS) {
    __syncthreads();
    for (int i = tid; i < WG_ROWS * 64; i += THREADS) {
      const int r = i / 64, k = i % 64;
      const long long q = q0 + r;
      T av = zero, bv = zero;
      if (q < q_end) {
        const int xx = (int)(q % w) + kx - 1;
        const int yy = (int)((q / w) % h) + ky - 1;
        if (c0 + k < c && xx >= 0 && xx < w && yy >= 0 && yy < h)
          av = xa[(q + (long long)(ky - 1) * w + (kx - 1)) * c + c0 + k];
        if (o0 + k < o) bv = ds[q * o + o0 + k];
      }
      s_a[r * WG_LD + k] = av;
      s_b[r * WG_LD + k] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WG_ROWS / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        acc[j].template mma<false, true>(s_a + kk * 16 * WG_LD + rt * 16, WG_LD,
                                         s_b + kk * 16 * WG_LD + (cg * 2 + j) * 16, WG_LD);
  }
  float* out = part + (((size_t)blockIdx.y * 9 + tap) * cp + c0 + rt * 16) * op + o0;
#pragma unroll
  for (int j = 0; j < 2; ++j) acc[j].store(out + (cg * 2 + j) * 16, op);
}

// dw[tap][c][o] = Σ_slice part[slice][tap][c][o], in slice order.
__global__ void wgrad_reduce(const float* __restrict__ part, int slices, int c, int o,
                             float* __restrict__ dw) {
  const int cp = r64(c), op = r64(o);
  const int n = 9 * c * o;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int tap = i / (c * o), ci = (i / o) % c, oi = i % o;
    const size_t k = ((size_t)tap * cp + ci) * op + oi;
    float s = 0.f;
    for (int sl = 0; sl < slices; ++sl) s += part[(size_t)sl * 9 * cp * op + k];
    dw[i] = s;
  }
}

int wgrad_slices(long long npix, int c, int o) {
  const int tiles = 9 * ((c + 63) / 64) * ((o + 63) / 64);
  long long s = (528 + tiles - 1) / tiles;
  const long long most = (npix + 255) / 256;
  if (s > most) s = most;
  return s < 1 ? 1 : (int)s;
}

struct BwdScratch {
  size_t ds, xa, part, total;
  int slices;
};

BwdScratch bwd_layout(int bsz, int h, int w, int c, int o, int esz) {
  BwdScratch s;
  const long long npix = (long long)bsz * h * w;
  s.slices = wgrad_slices(npix, c, o);
  size_t off = 0;
  s.ds = off;   off += align256((size_t)npix * o * esz);
  s.xa = off;   off += align256((size_t)npix * c * esz);
  s.part = off; off += align256((size_t)s.slices * 9 * r64(c) * r64(o) * 4);
  s.total = off;
  return s;
}

template <typename T>
int fwd(const void* x, const void* wmat, const void* bias, const float* scal, int bsz,
        int h, int w, int c, int o, void* s, float* ps, cudaStream_t st) {
  const int blocks = bsz * h * ((w + TP - 1) / TP);
  if (blocks == 0) return (int)cudaGetLastError();
  const size_t smem = conv_smem_bytes<T>(c, o, false);
  cudaError_t e = cudaFuncSetAttribute(cbg_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cbg_fwd_kernel<T><<<blocks, THREADS, smem, st>>>((const T*)x, (const T*)wmat,
                                                   (const T*)bias, scal, h, w, c, o,
                                                   (T*)s, ps);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* dz, const void* si, const void* sp, const void* wmat,
        const float* scal_in, const float* scal_out, int bsz, int h, int w, int c, int o,
        void* dzp, float* dw, float* db_part, float* psp, void* scratch, cudaStream_t st) {
  const BwdScratch sc = bwd_layout(bsz, h, w, c, o, sizeof(T));
  unsigned char* base = (unsigned char*)scratch;
  T* ds = (T*)(base + sc.ds);
  T* xa = scal_out ? (T*)(base + sc.xa) : (T*)sp;
  float* part = (float*)(base + sc.part);
  const int blocks = bsz * h * ((w + TP - 1) / TP);
  cudaError_t e;
  if (blocks > 0) {
    const size_t smem = conv_smem_bytes<T>(c, o, true);
    e = cudaFuncSetAttribute(cbg_dgrad_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cbg_dgrad_kernel<T><<<blocks, THREADS, smem, st>>>(
        (const T*)dz, (const T*)si, (const T*)sp, (const T*)wmat, scal_in, scal_out, h,
        w, c, o, (T*)dzp, ds, xa, db_part, psp);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const int tiles = 9 * ((c + 63) / 64) * ((o + 63) / 64);
  cbg_wgrad_kernel<T><<<dim3(tiles, sc.slices), THREADS, 0, st>>>(
      xa, ds, bsz, h, w, c, o, sc.slices, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  int rblocks = (9 * c * o + 255) / 256;
  wgrad_reduce<<<rblocks, 256, 0, st>>>(part, sc.slices, c, o, dw);
  return (int)cudaGetLastError();
}

bool shapes_ok(int c, int o) { return c > 0 && o > 0 && c <= MAXC && o <= MAXC; }

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// Row segments (= partial-sum rows) of one block call.
int cbg_blocks(int bsz, int h, int w) { return bsz * h * ((w + TP - 1) / TP); }

long long cbg_bwd_scratch_bytes(int bsz, int h, int w, int c, int o, int is_bf16) {
  return (long long)bwd_layout(bsz, h, w, c, o, is_bf16 ? 2 : 4).total;
}

// x [B, H, W, C], wmat [3, 3, C, O], bias [O] in the compute dtype; scal
// [6, C] f32 (mean, istd, gamma, beta, -, -) or null; s [B, H, W, O];
// ps [cbg_blocks, 2, O] f32.  C, O <= 128.
int cbg_fwd(const void* x, const void* wmat, const void* bias, const void* scal, int bsz,
            int h, int w, int c, int o, void* s, void* ps, int is_bf16, void* stream) {
  if (!shapes_ok(c, o)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return fwd<bf16>(x, wmat, bias, (const float*)scal, bsz, h, w, c, o, s, (float*)ps, st);
  return fwd<float>(x, wmat, bias, (const float*)scal, bsz, h, w, c, o, s, (float*)ps, st);
}

// dz, si [B, H, W, O]; sp [B, H, W, C]; wmat [3, 3, C, O]; scal_in [6, O]
// f32 (with A, B); scal_out [6, C] f32 or null.  Out: dzp [B, H, W, C] in
// the compute dtype; dw [3, 3, C, O], db_part [cbg_blocks, O] and
// psp [cbg_blocks, 2, C] f32.
int cbg_bwd(const void* dz, const void* si, const void* sp, const void* wmat,
            const void* scal_in, const void* scal_out, int bsz, int h, int w, int c, int o,
            void* dzp, void* dw, void* db_part, void* psp, void* scratch, int is_bf16,
            void* stream) {
  if (!shapes_ok(c, o)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return bwd<bf16>(dz, si, sp, wmat, (const float*)scal_in, (const float*)scal_out, bsz,
                     h, w, c, o, dzp, (float*)dw, (float*)db_part, (float*)psp, scratch, st);
  return bwd<float>(dz, si, sp, wmat, (const float*)scal_in, (const float*)scal_out, bsz, h,
                    w, c, o, dzp, (float*)dw, (float*)db_part, (float*)psp, scratch, st);
}

}  // extern "C"
