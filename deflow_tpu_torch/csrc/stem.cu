// The U-Net encoder's k8/s2/p3 stem convolutions in bf16 on the tensor
// cores: forward, input gradient (dgrad) and weight + bias gradient (wgrad),
// on channels-last (NHWC) activations.
//
// Replaces no Pallas kernel: the JAX package leaves these convolutions to
// XLA.  Added because cuDNN runs them, in bf16 at the model's shapes, on its
// CUDA-core kernels (precomputed_convolve_sgemm, implicit_convolve_sgemm,
// wgrad_alg1_engine), whose FFMA peak (67 TFLOP/s) is 6.8% of the bf16
// tensor-core peak.
//
// The algebra.  Pad X [N, H, W, C] by 3 and write the taps as u = 2a + p,
// v = 2b + q (a, b in 0..3; p, q in {0, 1}).  The stem is then a valid 4x4
// stride-1 convolution of the space-to-depth view S = s2d(Xp), [N, (H+6)/2,
// (W+6)/2, 4C] with channel e = (p, q, c), by W'[o, e, a, b] = W[o, c, u, v].
// S is never stored: its pixel (i, j) is X's rows 2i+p-3, columns 2j+q-3,
// so a 16-byte run of e is 8 contiguous channels of one X pixel.
// - forward: Y = conv4x4(S, W') + bias, an implicit GEMM (M = N·H/2·W/2,
//   N = O, K = 16·4C).
// - dgrad:   the gradient of a valid 4x4 correlation is a full one: dS =
//   conv4x4(pad(dY, 3), W' flipped and transposed), over a grid of
//   (H/2 + 1) x (W/2 + 1) pixels (the rows and columns of dS that reach X);
//   the store writes dS's (p, q, c) to X's pixel (2i+p-1, 2j+q-1) when that
//   lies inside X (the d2s and the crop).  The same kernel template as the
//   forward: only the gather and the store differ.
// - wgrad:   dW'[a, b, e, o] = Σ over pixels S(pixel + (a, b))[e]·dY(pixel)[o]
//   and db = Σ dY, split over the SMs into f32 partials that a second kernel
//   sums in slab order: no atomics, so launches agree bit for bit.
//
// Bound on the H100: each stem is 17.2 GFLOP an image (32->64 at 512², 64->128
// at 256², 128->256 at 128²), 550 GFLOP a product at 2B = 32, against 0.8,
// 0.4 and 0.2 GB of activations: operations bound all three, 0.556 ms a
// product at 989 TFLOP/s.
//
// Design.  mma.sync m16n8k16 (bf16 in, f32 accumulate) with ldmatrix
// operands; every warp holds a 64x64 f32 tile.  A product's operand that is
// read 16 times over (once per tap) is staged once: the forward and dgrad
// stage a window of Z (S or padded dY) over their output tile, (TR + 3) x 19
// pixels x 32 channels, double-buffered, and read every tap as a constant
// offset into it; the weights, read once per tile, stream through a ring of
// three 16-byte cp.async stages of [BN][32] per tap (four read 0-4% slower on
// an H100).  A block owns TR x 16
// output pixels x BN output channels (TR = 8, BN = 128 with 4 warps; TR = 16,
// BN = 64 for 64 output channels); two blocks share an SM, one's loads under
// the other's products.  The wgrad block owns all 16 taps of one 32-wide e
// slice and one 64-wide o slice (each of its 8 warps two taps), so each
// staged window and dY tile serves 16 taps; it streams 8 x 16-pixel units
// through three stages.  Window pixels are 80 bytes apart, so the 8 rows an
// ldmatrix reads fall in 8 distinct bank groups.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gru_tile.cuh"

namespace {

using gru_tile::bf16;
using gru_tile::cp_async16;
using gru_tile::cp_async_commit;
using gru_tile::cp_async_wait;
using gru_tile::ldsm4;
using gru_tile::mma16816;

constexpr int TW = 16;                   // output pixels of a tile row
constexpr int ZW = TW + 3;               // window pixels of a row
constexpr int KCH = 32;                  // channels of a window chunk (one k step a tap)
constexpr int ZP = KCH + 8;              // window pixel pitch (elements)
constexpr int WP = KCH + 8;              // weight row pitch (elements)
constexpr int NST = 3;                   // weight stages
constexpr long long MAX_SCRATCH = 64ll << 20;

// ------------------------------------------------------- forward and dgrad
// out-grid pixel (i, j) = Σ over taps (a, b) and Z channels k of
// Z(i + a, j + b)[k] · B[a, b][n][k], Z gathered from src [N, SH, SW, SC]:
//   forward: Z = S, Z(i, j)[(p, q, c)] = X(2i + p - 3, 2j + q - 3)[c];
//   dgrad:   Z = dY padded by 2, Z(i, j)[o] = dY(i - 2, j - 2)[o].
struct ConvArgs {
  const bf16* src;
  const bf16* wt;      // B [16][NO][KC], k contiguous
  const float* bias;   // forward: [NO]
  bf16* out;           // forward: Y [N, GH, GW, NO]; dgrad: dX [N, OH, OW, OC]
  int sh, sw, sc;      // source dims
  int gh, gw;          // output grid
  int kc, no;          // Z channels, output channels
  int oh, ow, oc;      // dgrad: X's dims
  int tiles_h, tiles_w, nsl;
};

template <int WM, int WN> struct ConvShape {
  static constexpr int THREADS = 32 * WM * WN, TR = 4 * WM, ZR = TR + 3, BN = 64 * WN;
  static constexpr int ZELEMS = ZR * ZW * ZP, WELEMS = BN * WP;
  static constexpr size_t SMEM = (2 * ZELEMS + NST * WELEMS) * sizeof(bf16);
};

template <bool FWD, int WM, int WN>
__global__ void __launch_bounds__(ConvShape<WM, WN>::THREADS, 2)
stem_conv_kernel(const ConvArgs p) {
  using S = ConvShape<WM, WN>;
  constexpr int THREADS = S::THREADS, TR = S::TR, ZR = S::ZR, BN = S::BN;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* zbuf = reinterpret_cast<bf16*>(smem);            // [2][ZR][ZW][ZP]
  bf16* wbuf = zbuf + 2 * S::ZELEMS;                       // [NST][BN][WP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  int bid = blockIdx.x;
  const int sl = bid % p.nsl;
  bid /= p.nsl;
  const int tj0 = (bid % p.tiles_w) * TW;
  bid /= p.tiles_w;
  const int ti0 = (bid % p.tiles_h) * TR;
  const int img = bid / p.tiles_h;
  const int n0 = sl * BN;
  const int nsteps = 16 * (p.kc / KCH);

  // a thread copies the same 16-byte vector v of every window pixel it loads
  const int v = tid & 3;
  auto load_window = [&](int ch) {
    bf16* dst = zbuf + (ch & 1) * S::ZELEMS + v * 8;
    const int e = ch * KCH + v * 8;
    int roff, coff, c, sr;
    if constexpr (FWD) {
      roff = e / (2 * p.sc) - 3;
      coff = (e / p.sc & 1) - 3;
      c = e % p.sc;
      sr = 2;
    } else {
      roff = coff = -2;
      c = e;
      sr = 1;
    }
    for (int idx = tid >> 2; idx < ZR * ZW; idx += THREADS / 4) {
      const int zr = idx / ZW, zc = idx - zr * ZW;
      const int row = sr * (ti0 + zr) + roff, col = sr * (tj0 + zc) + coff;
      const bool ok = row >= 0 && row < p.sh && col >= 0 && col < p.sw;
      const bf16* src =
          ok ? p.src + (((long long)img * p.sh + row) * p.sw + col) * p.sc + c : p.src;
      cp_async16(dst + idx * ZP, src, ok);
    }
  };
  auto load_weights = [&](int s) {
    bf16* dst = wbuf + (s % NST) * S::WELEMS;
    const bf16* src = p.wt + ((long long)(s & 15) * p.no + n0) * p.kc + (s >> 4) * KCH;
    for (int idx = tid; idx < BN * 4; idx += THREADS) {
      const int r = idx >> 2, vv = idx & 3;
      cp_async16(dst + r * WP + vv * 8, src + (long long)r * p.kc + vv * 8, true);
    }
  };
  auto issue = [&](int s) {
    if (s < nsteps) {
      if ((s & 15) == 0) load_window(s >> 4);
      load_weights(s);
    }
    cp_async_commit();
  };

  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) issue(s);

  // A (non-trans): lane gives pixel column l%16 of the m tile, k offset 8·(l/16);
  // B (non-trans, [n][k] rows): n (l%8) + 8·(l/16), k offset 8·((l/8)%2)
  const bf16* za0 = zbuf + ((4 * wm) * ZW + (lane & 15)) * ZP + (lane >> 4) * 8;
  const bf16* wb0 = wbuf + (64 * wn + (lane & 7) + ((lane >> 4) << 3)) * WP + ((lane >> 3) & 1) * 8;
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    issue(s + NST - 1);
    const int tap = s & 15;
    const bf16* za = za0 + ((s >> 4) & 1) * S::ZELEMS + ((tap >> 2) * ZW + (tap & 3)) * ZP;
    const bf16* wb = wb0 + (s % NST) * S::WELEMS;
#pragma unroll
    for (int kk = 0; kk < KCH; kk += 16) {
      unsigned fa[4][4], fb[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldsm4<false>(fa[mt], za + mt * ZW * ZP + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) ldsm4<false>(fb[j], wb + j * 16 * WP + kk);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma16816(acc[mt][2 * j], fa[mt], fb[j][0], fb[j][1]);
          mma16816(acc[mt][2 * j + 1], fa[mt], fb[j][2], fb[j][3]);
        }
    }
  }
  cp_async_wait<0>();

  // lane holds rows l/4 and l/4 + 8 of each m tile, columns 2(l%4), +1 of each n8 tile
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = n0 + 64 * wn + 8 * nt + t2;
    float b0 = 0.f, b1 = 0.f;
    int c = 0, dy = 0, dx = 0;
    if constexpr (FWD) {
      b0 = p.bias[n];
      b1 = p.bias[n + 1];
    } else {
      c = n % p.oc;
      dx = (n / p.oc & 1) - 1;
      dy = n / (2 * p.oc) - 1;
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int ti = ti0 + 4 * wm + mt;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tj = tj0 + g + 8 * h;
        if (ti >= p.gh || tj >= p.gw) continue;
        const __nv_bfloat162 val =
            __floats2bfloat162_rn(acc[mt][nt][2 * h] + b0, acc[mt][nt][2 * h + 1] + b1);
        if constexpr (FWD) {
          *reinterpret_cast<__nv_bfloat162*>(
              p.out + (((long long)img * p.gh + ti) * p.gw + tj) * p.no + n) = val;
        } else {
          const int y = 2 * ti + dy, x = 2 * tj + dx;
          if (y >= 0 && y < p.oh && x >= 0 && x < p.ow)
            *reinterpret_cast<__nv_bfloat162*>(
                p.out + (((long long)img * p.oh + y) * p.ow + x) * p.oc + c) = val;
        }
      }
    }
  }
}

template <bool FWD, int WM, int WN>
cudaError_t launch_conv(ConvArgs a, int n, cudaStream_t st) {
  using S = ConvShape<WM, WN>;
  a.tiles_h = (a.gh + S::TR - 1) / S::TR;
  a.tiles_w = (a.gw + TW - 1) / TW;
  a.nsl = a.no / S::BN;
  const long long blocks = (long long)n * a.tiles_h * a.tiles_w * a.nsl;
  if (blocks <= 0) return cudaSuccess;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(stem_conv_kernel<FWD, WM, WN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (e != cudaSuccess) return e;
  stem_conv_kernel<FWD, WM, WN><<<(unsigned)blocks, S::THREADS, S::SMEM, st>>>(a);
  return cudaGetLastError();
}

// -------------------------------------------------------------------- wgrad
// part[slab][(a, b)][e][o] = Σ over the slab's pixels of S(pixel + (a, b))[e]
// · dY(pixel)[o]; part[slab][16·4C·O + o] = Σ dY(pixel)[o].
//
// A unit is 8 x 16 output pixels of one image.  Its stage holds the window
// of S over it (11 x 19 pixels x the block's 32 e) and dY at its pixels (128
// x the block's 64 o), zero outside the image; every tap is a constant
// offset into the window.  Warp w owns taps (w/2, 2(w%2)) and (w/2,
// 2(w%2) + 1), all 32 e and 64 o of the block: per 16-pixel step 4 A and 4
// B fragments feed 32 products.  A block owns one (e, o) slice pair and a
// slab of consecutive units.
constexpr int WG_THREADS = 256;
constexpr int WG_TR = 8, WG_ZR = WG_TR + 3;
constexpr int WG_DYP = 64 + 8;           // dY pixel pitch (elements)
constexpr int WG_Z = WG_ZR * ZW * ZP, WG_D = WG_TR * TW * WG_DYP;
constexpr int WG_STAGE = WG_Z + WG_D;
constexpr int WG_NST = 3;
constexpr size_t WG_SMEM = WG_NST * WG_STAGE * sizeof(bf16) + 4 * 64 * sizeof(float);

struct WgradArgs {
  const bf16* x;       // [N, H, W, C]
  const bf16* dy;      // [N, HO, WO, O]
  float* part;         // [slabs][rec]
  int h, w, c, ho, wo, o;
  int types_e, slabs, units, tiles_h, tiles_w;
  long long rec;
};

__global__ void __launch_bounds__(WG_THREADS, 1) stem_wgrad_kernel(const WgradArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  float* dbred = reinterpret_cast<float*>(smem + WG_NST * WG_STAGE * sizeof(bf16));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int types = p.types_e * (p.o / 64);
  const int type = blockIdx.x % types, slab = blockIdx.x / types;
  const int es = type % p.types_e, os = type / p.types_e;
  const int u0 = (int)((long long)slab * p.units / p.slabs);
  const int nun = (int)((long long)(slab + 1) * p.units / p.slabs) - u0;
  const int kc = 4 * p.c;

  const int v = tid & 3, e = es * KCH + v * 8;
  const int roff = e / (2 * p.c) - 3, coff = (e / p.c & 1) - 3, cc = e % p.c;
  auto issue = [&](int i) {
    if (i < nun) {
      bf16* z = stages + (i % WG_NST) * WG_STAGE;
      bf16* d = z + WG_Z;
      int u = u0 + i;
      const int tj0 = (u % p.tiles_w) * TW;
      u /= p.tiles_w;
      const int ti0 = (u % p.tiles_h) * WG_TR;
      const int img = u / p.tiles_h;
      for (int idx = tid >> 2; idx < WG_ZR * ZW; idx += WG_THREADS / 4) {
        const int zr = idx / ZW, zc = idx - zr * ZW;
        const int row = 2 * (ti0 + zr) + roff, col = 2 * (tj0 + zc) + coff;
        const bool ok = row >= 0 && row < p.h && col >= 0 && col < p.w;
        const bf16* src =
            ok ? p.x + (((long long)img * p.h + row) * p.w + col) * p.c + cc : p.x;
        cp_async16(z + idx * ZP + v * 8, src, ok);
      }
      for (int idx = tid; idx < WG_TR * TW * 8; idx += WG_THREADS) {
        const int px = idx >> 3, vv = idx & 7;
        const int ti = ti0 + px / TW, tj = tj0 + px % TW;
        const bool ok = ti < p.ho && tj < p.wo;
        const bf16* src =
            ok ? p.dy + (((long long)img * p.ho + ti) * p.wo + tj) * p.o + os * 64 + vv * 8
               : p.dy;
        cp_async16(d + px * WG_DYP + vv * 8, src, ok);
      }
    }
    cp_async_commit();
  };

  float acc[2][2][8][4];
#pragma unroll
  for (int tp = 0; tp < 2; ++tp)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[tp][mi][nt][q] = 0.f;
  float dbsum = 0.f;

#pragma unroll
  for (int i = 0; i < WG_NST - 1; ++i) issue(i);

  const int ta = warp >> 1, tb0 = 2 * (warp & 1);
  // A (trans, window [pixel][e] rows): pixel (l%8) + 8·(l/16), e offset 8·((l/8)%2)
  const int a_off = ((ta * ZW + tb0 + (lane & 7) + ((lane >> 4) << 3)) * ZP) + ((lane >> 3) & 1) * 8;
  // B (trans, dY [pixel][o] rows): pixel l%16, o offset 8·(l/16)
  const int b_off = (lane & 15) * WG_DYP + (lane >> 4) * 8;
  for (int i = 0; i < nun; ++i) {
    cp_async_wait<WG_NST - 2>();
    __syncthreads();
    issue(i + WG_NST - 1);
    const bf16* z = stages + (i % WG_NST) * WG_STAGE;
    const bf16* d = z + WG_Z;
    if (es == 0) {
      const int oo = tid & 63, px0 = (tid >> 6) * 32;
#pragma unroll 8
      for (int px = px0; px < px0 + 32; ++px) dbsum += __bfloat162float(d[px * WG_DYP + oo]);
    }
#pragma unroll 2
    for (int r = 0; r < WG_TR; ++r) {
      unsigned fa[2][2][4], fb[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) ldsm4<true>(fb[j], d + r * TW * WG_DYP + b_off + 16 * j);
#pragma unroll
      for (int tp = 0; tp < 2; ++tp)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm4<true>(fa[tp][mi], z + a_off + (r * ZW + tp) * ZP + 16 * mi);
#pragma unroll
      for (int tp = 0; tp < 2; ++tp)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma16816(acc[tp][mi][2 * j], fa[tp][mi], fb[j][0], fb[j][1]);
            mma16816(acc[tp][mi][2 * j + 1], fa[tp][mi], fb[j][2], fb[j][3]);
          }
    }
  }
  cp_async_wait<0>();

  float* out = p.part + slab * p.rec;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int tp = 0; tp < 2; ++tp) {
    const int tap = 4 * ta + tb0 + tp;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = out + ((long long)tap * kc + es * KCH + 16 * mi + g + 8 * h) * p.o + os * 64 + t2;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          *reinterpret_cast<float2*>(row + 8 * nt) =
              make_float2(acc[tp][mi][nt][2 * h], acc[tp][mi][nt][2 * h + 1]);
      }
  }
  if (es == 0) {
    dbred[tid] = dbsum;
    __syncthreads();
    if (tid < 64)
      out[16ll * kc * p.o + os * 64 + tid] =
          ((dbred[tid] + dbred[64 + tid]) + dbred[128 + tid]) + dbred[192 + tid];
  }
}

// out[i] = Σ_s part[s·rec + i], in slab order.
__global__ void stem_wsum_kernel(const float* __restrict__ part, int slabs, long long rec,
                                 float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < rec;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < slabs; ++k) s += part[k * rec + i];
    out[i] = s;
  }
}

struct WgradPlan {
  int types, slabs, units, tiles_h, tiles_w;
  long long rec;
};

// Slabs: as many as fill the SMs once with one block each, at most one per
// unit and at most MAX_SCRATCH bytes of partials.
cudaError_t wgrad_plan(int n, int h, int w, int c, int o, WgradPlan* pl) {
  int dev = 0, sms = 132;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  pl->types = (4 * c / KCH) * (o / 64);
  pl->tiles_h = (h / 2 + WG_TR - 1) / WG_TR;
  pl->tiles_w = (w / 2 + TW - 1) / TW;
  pl->units = n * pl->tiles_h * pl->tiles_w;
  pl->rec = 16ll * 4 * c * o + o;
  long long slabs = sms / pl->types;
  const long long cap = MAX_SCRATCH / (pl->rec * 4);
  if (slabs > cap) slabs = cap;
  if (slabs > pl->units) slabs = pl->units;
  pl->slabs = slabs < 1 ? 1 : (int)slabs;
  return cudaSuccess;
}

bool shapes_ok(int n, int h, int w, int c, int o) {
  return n > 0 && h > 0 && w > 0 && h % 2 == 0 && w % 2 == 0 && c % 16 == 0 && o % 64 == 0;
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// x [N, H, W, C] bf16; wt [16][O][4C] bf16 (tap (a, b), o, e = (p, q, c));
// bias [O] f32; y [N, H/2, W/2, O] bf16.  H, W even; C % 16 == 0; O % 64 == 0.
int stem_fwd(const void* x, const void* wt, const void* bias, int n, int h, int w, int c,
             int o, void* y, void* stream) {
  if (!shapes_ok(n, h, w, c, o)) return (int)cudaErrorInvalidValue;
  ConvArgs a{};
  a.src = (const bf16*)x;
  a.wt = (const bf16*)wt;
  a.bias = (const float*)bias;
  a.out = (bf16*)y;
  a.sh = h, a.sw = w, a.sc = c;
  a.gh = h / 2, a.gw = w / 2;
  a.kc = 4 * c, a.no = o;
  cudaStream_t st = (cudaStream_t)stream;
  if (o % 128 == 0) return (int)launch_conv<true, 2, 2>(a, n, st);
  return (int)launch_conv<true, 4, 1>(a, n, st);
}

// dy [N, H/2, W/2, O] bf16; wt [16][4C][O] bf16 (tap (a', b') = (3 - a, 3 - b),
// e, o); dx [N, H, W, C] bf16, every element written.
int stem_dgrad(const void* dy, const void* wt, int n, int h, int w, int c, int o, void* dx,
               void* stream) {
  if (!shapes_ok(n, h, w, c, o)) return (int)cudaErrorInvalidValue;
  ConvArgs a{};
  a.src = (const bf16*)dy;
  a.wt = (const bf16*)wt;
  a.out = (bf16*)dx;
  a.sh = h / 2, a.sw = w / 2, a.sc = o;
  a.gh = h / 2 + 1, a.gw = w / 2 + 1;
  a.kc = o, a.no = 4 * c;
  a.oh = h, a.ow = w, a.oc = c;
  cudaStream_t st = (cudaStream_t)stream;
  if ((4 * c) % 128 == 0) return (int)launch_conv<false, 2, 2>(a, n, st);
  return (int)launch_conv<false, 4, 1>(a, n, st);
}

long long stem_wgrad_scratch_bytes(int n, int h, int w, int c, int o) {
  if (!shapes_ok(n, h, w, c, o)) return -1;
  WgradPlan pl;
  if (wgrad_plan(n, h, w, c, o, &pl) != cudaSuccess) return -1;
  return pl.slabs * pl.rec * 4;
}

// x [N, H, W, C], dy [N, H/2, W/2, O] bf16; scratch of
// stem_wgrad_scratch_bytes; out [16·4C·O + O] f32: dW'[(a, b)][e][o], then db.
int stem_wgrad(const void* x, const void* dy, int n, int h, int w, int c, int o, void* scratch,
               void* out, void* stream) {
  if (!shapes_ok(n, h, w, c, o)) return (int)cudaErrorInvalidValue;
  WgradPlan pl;
  cudaError_t e = wgrad_plan(n, h, w, c, o, &pl);
  if (e != cudaSuccess) return (int)e;
  WgradArgs a{};
  a.x = (const bf16*)x;
  a.dy = (const bf16*)dy;
  a.part = (float*)scratch;
  a.h = h, a.w = w, a.c = c, a.ho = h / 2, a.wo = w / 2, a.o = o;
  a.types_e = 4 * c / KCH;
  a.slabs = pl.slabs, a.units = pl.units, a.tiles_h = pl.tiles_h, a.tiles_w = pl.tiles_w;
  a.rec = pl.rec;
  cudaStream_t st = (cudaStream_t)stream;
  e = cudaFuncSetAttribute(stem_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  stem_wgrad_kernel<<<pl.types * pl.slabs, WG_THREADS, WG_SMEM, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long long blocks = (pl.rec + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  stem_wsum_kernel<<<(int)blocks, 256, 0, st>>>((const float*)scratch, pl.slabs, pl.rec,
                                                (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
