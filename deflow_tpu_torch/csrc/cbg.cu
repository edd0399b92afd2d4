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
// Bound on the H100: at 2B = 4, 256²x64→64, 128²x128→128 and 64²x256→256
// each cost 19.3 GFLOP per forward (two such products per backward) against
// 67 MB (256²), 34 MB (128²) and 17 MB (64²) of activations: operations and
// bytes are about even at 256², operations bound the narrower maps.  In f32
// (FFMA outside the tensor cores, 67 TFLOP/s) operations bound every shape:
// 0.288 ms a forward, 0.577 ms a backward.
//
// Design.  bf16 products run on the tensor cores (WMMA in the backward,
// mma.sync with ldmatrix operands in the forward).  f32 products run in
// true f32 on FFMA, as the plain versions do, in kernels of their own
// (templates and `if constexpr` arms that the bf16 instantiations do not
// see) with register-blocked micro-tiles: a 16x16 FFMA tile that reloads
// an operand for every FMA or two is capped by its shared-memory loads
// near a quarter of the FFMA rate.  The forward's f32 route gives each lane
// an 8 x 8 outer product (8 pixels x 8 output channels), fed by float2
// window and float4 weight loads: a quarter of a float an FMA.  The
// backward's dgrad takes the same 8 x 8 tile (8 pixels x 8 input channels,
// float2 loads of both operands), its wgrad a 3 x 4 x 8 tile (3 taps x 4
// input x 8 output channels) that slides along a row of pixels: 12 floats
// for 96 FMAs (see "f32 backward" below).
// Prologues (input BN and GELU, or the BN backward for ds) run in f32 and
// round to the compute dtype exactly as the products consume them.  No
// float atomics: partials are reduced in an order fixed by the shape alone,
// so results are bit-identical from launch to launch and from card to card.
//
// Forward: a one-row block per 64 pixels would restage 9·C·O weights for
// every 64 pixels (~151 M element loads at both path widths) and run the
// input's BN+GELU on each input row three times, so a block owns R image
// rows of one sample (4 at <= 64 input channels, else 2) x 64 pixels x one
// slice of up to CHUNK = 128 output channels (all O up to 128; at 256
// output channels a second row of blocks takes the second slice; f32:
// slices of 256 / R, so that 8 warps of 64 pixels x 32 channels cover the
// block).  Input channels beyond 128 (f32: beyond 32) stream through the
// window in chunks: the window holds one chunk at a time, and the
// accumulators carry over the chunks.  Its window (rows y0-1 ..
// y0+R, pixels x0-1 .. x0+64) and its weights arrive by 16-byte cp.async
// copies, all in flight at once; the BN+GELU then runs in place once per
// window element (each input row in 1.5-2 windows), from scalars a thread
// holds in registers for its channel chunk.  Two blocks share an SM (one
// block's loads and BN+GELU run under the other's products), holding two
// taps of weights at 64 channels and one at 128 (f32: two at every width),
// the next tap copied after or under the current tap's products.  The
// epilogue adds the bias, rounds, stores s 16 bytes a thread and sums Σs,
// Σs² with every thread, the partials combined in a fixed order.
//
// Backward: dgrad, then wgrad, then an ordered reduction of the wgrad's
// partials.  Both are bound by operand loads and integer work, not FLOPs,
// unless each staged element serves many products: a wgrad block per
// (tap, c tile, o tile) with its own tap-shifted staging reads xa and ds
// 9·⌈C/64⌉·⌈O/64⌉ times (~302 M element loads at both path widths), and a
// dgrad block per 64 pixels restages 9·C·O weights (~151 M) and rebuilds
// each ds row, with its BN backward, three times.  So:
// - wgrad: a block owns one 64x64 (c, o) tile pair and a slab of work units
//   (4 image rows of one sample x 64 pixels in bf16, 2 in f32).  Each unit is staged
//   once, xa with a one-pixel halo, with 16-byte cp.async copies into two
//   stages (the next unit's copy runs under the current unit's products);
//   every tap is a constant offset into the stage, and the block's warps
//   hold all 9 taps' accumulators, so xa and ds are read about once per
//   tile pair (xa 1.5 times: the halo rows).
// - dgrad: a block owns 2 image rows (4 at <= 64 input channels) x 64
//   pixels x one slice of up to 128 input channels (a second row of blocks
//   at 256), so each staged tap of weights serves 2-4x the pixels; at <= 64
//   channels all 9 taps stay in shared memory, at 128 the next tap is copied
//   with cp.async under the current tap's products.  Output channels beyond
//   128 stream through the ds window in chunks of 128 (f32: of 32, two taps
//   double-buffered at every width, two blocks an SM), as the forward's
//   input channels do.  Each ds row lands in
//   1.5-2 windows, not 3; the window's BN backward reads its scalars from
//   shared memory and moves 16 bytes a load and store, as does the epilogue.
// The dgrad writes ds (and xa when the input had a BN) once for the wgrad.

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
constexpr int MAXC = 256;
constexpr int CHUNK = 128;               // channels of a window chunk and of a block's slice
constexpr float SQRT1_2 = 0.7071067811865476f;
constexpr float SQRT1_2PI = 0.3989422804014327f;

enum { S_MEAN, S_ISTD, S_GAMMA, S_BETA, S_A, S_B, N_SCAL };

__device__ __forceinline__ float gelu(float x) { return x * 0.5f * (1.f + erff(x * SQRT1_2)); }
__device__ __forceinline__ float gelu_grad(float x) {
  return 0.5f * (1.f + erff(x * SQRT1_2)) + x * expf(-0.5f * x * x) * SQRT1_2PI;
}

__host__ __device__ inline int r16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline int r32(int v) { return (v + 31) / 32 * 32; }
__host__ __device__ inline int r64(int v) { return (v + 63) / 64 * 64; }
__host__ __device__ inline int chunk16(int v) { return r16(v) < CHUNK ? r16(v) : CHUNK; }
__host__ inline size_t align256(size_t v) { return (v + 255) & ~(size_t)255; }

// ---------------------------------------------------------------- wgrad
// part[slab][tap][c][o] (c, o padded to 64) = Σ over the slab's pixels of
// xa(pixel shifted by the tap)[c] · ds(pixel)[o], zero outside the image.
//
// A work unit is R = wg_rows<T>() = 4 image rows of one sample (bf16; the
// f32 route's kernel is below) x one 64-pixel segment.
// Its stage holds xa for those rows with a one-pixel halo ((R + 2) rows x 66
// pixels x 64 channels) and ds for the unit's own pixels (R x 64 x 64),
// so a tap is a constant offset into shared memory.  Warp (ky, rt) owns the
// three taps of kernel row ky for c rows rt*16..+16 and all four 16-wide o
// tiles: 12 accumulators, fed per 16-pixel step by 3 A and 4 B fragments.
// A block owns one (c, o) tile pair and a slab of consecutive units, which
// it streams through two stages with cp.async (16 bytes a thread).
constexpr int WG_WARPS = 12;             // 3 kernel rows x 4 c-row tiles
constexpr int WG_THREADS = WG_WARPS * 32;
constexpr int WG_LDX = 64 + 16;          // xa pixel stride: 32-byte aligned at every pixel (WMMA)
constexpr int WG_LDS = 64 + 8;           // ds pixel stride

template <typename T> __host__ __device__ constexpr int wg_rows() {
  static_assert(sizeof(T) == 2, "wg_rows: bf16 units");
  return 4;
}

template <typename T> __host__ __device__ constexpr int wg_stage_elems() {
  return (wg_rows<T>() + 2) * WIN * WG_LDX + wg_rows<T>() * TP * WG_LDS;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [y0 - 1, y0 + R] x pixels [x0 - 1, x0 + 64] of xa (channels
// c0..+64) and rows [y0, y0 + R) x pixels [x0, x0 + 64) of ds (o0..+64) of
// sample b into one stage, zero outside the image and the channels.  With
// vec, as 16-byte cp.async copies (C and O multiples of 16 bytes);
// otherwise element by element.
template <typename T>
__device__ void wg_load(const T* __restrict__ xa, const T* __restrict__ ds, int h, int w,
                        int c, int o, int c0, int o0, int b, int y0, int x0, T* sx, T* sd,
                        bool vec) {
  constexpr int R = wg_rows<T>(), V = 16 / sizeof(T), CH = 64 / V;
  const T zero = from_f<T>(0.f);
  const size_t row0 = (size_t)b * h;
  for (int i = threadIdx.x; i < (R + 2) * WIN * CH; i += WG_THREADS) {
    const int k = i % CH, j = (i / CH) % WIN, r = i / (CH * WIN);
    const int yy = y0 + r - 1, xx = x0 + j - 1, ci = c0 + k * V;
    const bool ok = yy >= 0 && yy < h && xx >= 0 && xx < w && ci < c;
    const T* src = ok ? xa + ((row0 + yy) * w + xx) * c + ci : xa;
    T* dst = sx + (r * WIN + j) * WG_LDX + k * V;
    if (vec) {
      cp_async16(dst, src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = ok && ci + e < c ? src[e] : zero;
    }
  }
  for (int i = threadIdx.x; i < R * TP * CH; i += WG_THREADS) {
    const int k = i % CH, j = (i / CH) % TP, r = i / (CH * TP);
    const int yy = y0 + r, xx = x0 + j, oi = o0 + k * V;
    const bool ok = yy < h && xx < w && oi < o;
    const T* src = ok ? ds + ((row0 + yy) * w + xx) * o + oi : ds;
    T* dst = sd + (r * TP + j) * WG_LDS + k * V;
    if (vec) {
      cp_async16(dst, src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = ok && oi + e < o ? src[e] : zero;
    }
  }
}

// One 16-pixel step of warp (ky, rt): acc[kx][ct] += A_kx^T · B_ct, with
// A_kx = xa at the pixels shifted by kx (a + kx·WG_LDX) and B_ct = ds's o
// tile ct, each fragment loaded once (bf16; the f32 route has its own
// kernel below).
template <typename T>
__device__ __forceinline__ void wg_step(Acc<T> (&acc)[3][4], const T* a, const T* bm) {
  static_assert(std::is_same<T, bf16>::value, "wg_step: bf16 operands");
  using namespace nvcuda::wmma;
  fragment<matrix_a, 16, 16, 16, bf16, col_major> fa[3];
  fragment<matrix_b, 16, 16, 16, bf16, row_major> fb[4];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) load_matrix_sync(fa[kx], a + kx * WG_LDX, WG_LDX);
#pragma unroll
  for (int ct = 0; ct < 4; ++ct) load_matrix_sync(fb[ct], bm + ct * 16, WG_LDS);
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int ct = 0; ct < 4; ++ct) mma_sync(acc[kx][ct].f, fa[kx], fb[ct], acc[kx][ct].f);
}

template <typename T>
__global__ void __launch_bounds__(WG_THREADS, 1)
cbg_wgrad_kernel(const T* __restrict__ xa, const T* __restrict__ ds, int bsz, int h,
                 int w, int c, int o, int slabs, int vec, float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = wg_rows<T>();
  T* stage[2] = {(T*)smem, (T*)smem + wg_stage_elems<T>()};
  const int ot_n = (o + 63) / 64, cp = r64(c), op = r64(o);
  const int c0 = blockIdx.x / ot_n * 64, o0 = blockIdx.x % ot_n * 64;
  const int segs = (w + TP - 1) / TP, grps = (h + R - 1) / R;
  const long long units = (long long)bsz * grps * segs;
  const long long u0 = units * blockIdx.y / slabs, u1 = units * (blockIdx.y + 1) / slabs;
  const int warp = threadIdx.x / 32, ky = warp / 4, rt = warp % 4;
  const bool busy = c0 + rt * 16 < c;      // this warp's c rows exist

  auto load = [&](long long u, T* st) {
    const int seg = (int)(u % segs);
    const long long g = u / segs;
    wg_load<T>(xa, ds, h, w, c, o, c0, o0, (int)(g / grps), (int)(g % grps) * R, seg * TP,
               st, st + (R + 2) * WIN * WG_LDX, vec);
    cp_async_commit();
  };

  Acc<T> acc[3][4];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int ct = 0; ct < 4; ++ct) acc[kx][ct].zero();
  if (u0 < u1) load(u0, stage[0]);
  for (long long u = u0; u < u1; ++u) {
    const int cur = (int)((u - u0) & 1);
    if (u + 1 < u1) {
      load(u + 1, stage[cur ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sx = stage[cur];
    const T* sd = sx + (R + 2) * WIN * WG_LDX;
    if (busy) {
#pragma unroll 1
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int kk = 0; kk < TP / 16; ++kk)
          wg_step<T>(acc, sx + ((r + ky) * WIN + kk * 16) * WG_LDX + rt * 16,
                     sd + (r * TP + kk * 16) * WG_LDS);
    }
    __syncthreads();
  }
  float* out = part + ((size_t)blockIdx.y * 9 * cp + c0 + rt * 16) * op + o0;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int ct = 0; ct < 4; ++ct)
      acc[kx][ct].store(out + (size_t)(ky * 3 + kx) * cp * op + ct * 16, op);
}

// dw[tap][c][o] = Σ_slab part[slab][tap][c][o], in slab order.
__global__ void wgrad_reduce(const float* __restrict__ part, int slabs, int c, int o,
                             float* __restrict__ dw) {
  const int cp = r64(c), op = r64(o);
  const int n = 9 * c * o;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int tap = i / (c * o), ci = (i / o) % c, oi = i % o;
    const size_t k = ((size_t)tap * cp + ci) * op + oi;
    float s = 0.f;
    for (int sl = 0; sl < slabs; ++sl) s += part[(size_t)sl * 9 * cp * op + k];
    dw[i] = s;
  }
}

// ---------------------------------------------------------------- dgrad
// A block owns R image rows of one sample x one 64-pixel segment x one slice
// of up to CHUNK output channels c (blockIdx.y).  Its window holds ds for
// rows y0-1 .. y0+R and pixels x0-1 .. x0+64 and one chunk of up to CHUNK
// channels o (the BN backward applied once per element, from the BN scalars
// staged in shared memory, with 16-byte loads); the chunks follow one
// another through the window, the accumulators carrying over.  Its weights
// are all 9 taps when they fit beside the window (64 channels in bf16, one
// chunk), else one tap at a time, the next one copied with cp.async while the
// current one's products run (double-buffered in bf16).  Warp (pw, cw) owns
// pixel tile pw of each of the R rows and c tiles cw, cw + 2, ... of the
// slice: per 16-deep step R A and up to NC B fragments feed R x NC products.
constexpr int SMEM_MAX = 232448;          // dynamic shared memory of one H100 block

struct DgLayout {
  int win, w, total;                      // byte offsets of the window, the weights; the size
  bool resident;                          // all 9 taps of weights stay in shared memory
};

// Shared memory of the dgrad kernel: BN scalars [6][O16] and [6][C16] f32;
// the window [R + 2][WIN][OK + 16]; weights [9 or NBUF][CS][OK + 8]; the
// f32 epilogue staging 2 x [R * TP][CS + 4] reuses the window and weights
// (OK: the o chunk, CS: the c slice, each min(16-rounded width, CHUNK)).
template <typename T, int R>
__host__ __device__ inline DgLayout dg_layout(int c, int o) {
  constexpr int NBUF = sizeof(T) == 2 ? 2 : 1;
  const int c16 = r16(c), o16 = r16(o), cs = chunk16(c), ok = chunk16(o);
  const int sz = (int)sizeof(T);
  const int scal = (6 * (c16 + o16) * 4 + 127) / 128 * 128;
  const int win = ((R + 2) * WIN * (ok + 16) * sz + 127) / 128 * 128;
  const int tap = cs * (ok + 8) * sz;
  const int stage = 2 * R * TP * (cs + 4) * 4;
  DgLayout L;
  L.win = scal;
  L.w = scal + win;
  L.resident = o16 <= CHUNK &&
               scal + (win + 9 * tap > stage ? win + 9 * tap : stage) <= SMEM_MAX;
  const int body = win + (L.resident ? 9 : NBUF) * tap;
  L.total = scal + (body > stage ? body : stage);
  return L;
}

// Rows per dgrad block, in bf16 and in f32: 4 when C <= 64, else 2 (128 and 256).
inline int dg_rows(int c) { return r16(c) <= 64 ? 4 : 2; }

// V consecutive elements from global memory: one 16-byte load with vec,
// else element by element (n of them, zero beyond).
template <typename T, int V>
__device__ __forceinline__ void ld_vec(T (&v)[V], const T* p, int n, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) v[q] = q < n ? p[q] : from_f<T>(0.f);
  }
}

template <typename T, int V>
__device__ __forceinline__ void st_vec(T* p, const T (&v)[V], int n, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q)
      if (q < n) p[q] = v[q];
  }
}

// One 16-deep step (16 output channels o) of warp (pw, cw):
// acc[r][j] += A_r · B_j, A_r the window at row r's pixel tile (a + r·WIN·lda,
// row-major over o), B_j tile ct = cw + 2j of this tap's W[c][o] (col-major).
template <typename T, int R, int NC>
__device__ __forceinline__ void dg_step(Acc<T> (&acc)[R][NC], const T* a, int lda,
                                        const T* bm, int ldb, int cw, int ct_n) {
  static_assert(std::is_same<T, bf16>::value, "dg_step: bf16 operands");
  using namespace nvcuda::wmma;
  fragment<matrix_a, 16, 16, 16, bf16, row_major> fa[R];
  fragment<matrix_b, 16, 16, 16, bf16, col_major> fb[NC];
#pragma unroll
  for (int r = 0; r < R; ++r) load_matrix_sync(fa[r], a + r * WIN * lda, lda);
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (cw + 2 * j < ct_n) load_matrix_sync(fb[j], bm + (cw + 2 * j) * 16 * ldb, ldb);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (cw + 2 * j < ct_n) mma_sync(acc[r][j].f, fa[r], fb[j], acc[r][j].f);
}

template <typename T, int R>
__global__ void __launch_bounds__(THREADS, 1)
cbg_dgrad_kernel(const T* __restrict__ dz, const T* __restrict__ si,
                 const T* __restrict__ sp, const T* __restrict__ wmat,
                 const float* __restrict__ scal_in, const float* __restrict__ scal_out,
                 int h, int w, int c, int o, int vec, T* __restrict__ dzp,
                 T* __restrict__ ds_out, T* __restrict__ x_out, float* __restrict__ db_part,
                 float* __restrict__ psp) {
  constexpr int V = 16 / sizeof(T), NC = R >= 4 ? 2 : 4, NBUF = sizeof(T) == 2 ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const DgLayout L = dg_layout<T, R>(c, o);
  const int c16 = r16(c), o16 = r16(o), cs = chunk16(c), ok = chunk16(o);
  const int ldw = ok + 16, ldo = ok + 8, lds = cs + 4;
  float* s_in = (float*)smem;                  // scal_in  [6][O16]
  float* s_out = s_in + 6 * o16;               // scal_out [6][C16]
  T* win = (T*)(smem + L.win);
  T* s_w = (T*)(smem + L.w);
  float* stage = (float*)(smem + L.win);       // d [R * TP][lds], after the products
  float* stage2 = stage + R * TP * lds;        // d · ẑ_prev
  const int tap_elems = cs * ldo;
  const int segs = (w + TP - 1) / TP, grps = (h + R - 1) / R;
  const int blk = blockIdx.x;
  const int seg = blk % segs, grp = (blk / segs) % grps, b = blk / (segs * grps);
  const int x0 = seg * TP, y0 = grp * R;
  const int np = w - x0 < TP ? w - x0 : TP, nr = h - y0 < R ? h - y0 : R;
  const int c0 = blockIdx.y * CHUNK;           // this block's slice of c
  const bool first = blockIdx.y == 0;          // the slice that writes ds and db
  const size_t row0 = (size_t)b * h;
  const T zero = from_f<T>(0.f);

  // weights of one tap for the slice's c and the o chunk from o0
  auto load_tap = [&](int tap, int o0, T* dst) {
    const int chunks = ok / V;
    for (int i = threadIdx.x; i < cs * chunks; i += THREADS) {
      const int ci = i / chunks, oi = (i % chunks) * V;
      const bool in = c0 + ci < c && o0 + oi < o;
      const T* src = in ? wmat + ((size_t)tap * c + c0 + ci) * o + o0 + oi : wmat;
      T* d = dst + ci * ldo + oi;
      if (vec) {
        cp_async16(d, src, in);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) d[q] = in && o0 + oi + q < o ? src[q] : zero;
      }
    }
  };

  for (int i = threadIdx.x; i < 6 * o16; i += THREADS) {
    const int k = i / o16, oi = i % o16;
    s_in[i] = oi < o ? scal_in[k * o + oi] : 0.f;
  }
  if (scal_out) {
    for (int i = threadIdx.x; i < 6 * c16; i += THREADS) {
      const int k = i / c16, ci = i % c16;
      s_out[i] = ci < c ? scal_out[k * c + ci] : 0.f;
    }
  }

  const int warp = threadIdx.x / 32, pw = warp % 4, cw = warp / 4, ct_n = cs / 16;
  Acc<T> acc[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j].zero();

  for (int o0 = 0; o0 < o; o0 += CHUNK) {
    // the previous chunk's products ended with a barrier: the window and the
    // weights are free
    if (L.resident) {
      for (int tap = 0; tap < 9; ++tap) load_tap(tap, o0, s_w + tap * tap_elems);
    } else if (NBUF == 2) {
      load_tap(0, o0, s_w);
    }
    cp_async_commit();
    __syncthreads();

    // ds = γ·istd·(dz − A − ẑ·B) on the window, once per element; the centre
    // rows are also this block's share of ds for the wgrad kernel
    const int och = ok / V;
    for (int i = threadIdx.x; i < (R + 2) * WIN * och; i += THREADS) {
      const int k = i % och, j = (i / och) % WIN, r = i / (och * WIN);
      const int yy = y0 + r - 1, xx = x0 + j - 1, oi = o0 + k * V;
      alignas(16) T v[V];
      if (yy >= 0 && yy < h && xx >= 0 && xx < w && oi < o) {
        const size_t e = ((row0 + yy) * w + xx) * o + oi;
        alignas(16) T dv[V], sv[V];
        ld_vec(dv, dz + e, o - oi, vec);
        ld_vec(sv, si + e, o - oi, vec);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float* sc = s_in + oi + q;
          const float zh = (to_f(sv[q]) - sc[S_MEAN * o16]) * sc[S_ISTD * o16];
          v[q] = from_f<T>(sc[S_GAMMA * o16] * sc[S_ISTD * o16]
                           * (to_f(dv[q]) - sc[S_A * o16] - zh * sc[S_B * o16]));
        }
        if (first && r >= 1 && r <= R && j >= 1 && j <= TP) st_vec(ds_out + e, v, o - oi, vec);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) v[q] = zero;
      }
      st_vec(win + (r * WIN + j) * ldw + k * V, v, V, true);
    }
    __syncthreads();
    if (first) {
      for (int oi = threadIdx.x; oi < ok && o0 + oi < o; oi += THREADS) {
        float s1 = 0.f;
        for (int r = 1; r <= nr; ++r)
          for (int p = 0; p < np; ++p) s1 += to_f(win[(r * WIN + 1 + p) * ldw + oi]);
        db_part[(size_t)blk * o + o0 + oi] = s1;
      }
    }

    // dx[p][c] += Σ_tap Σ_o win[r + 2 - ky][p + 2 - kx][o] · W[ky][kx][c][o]
    for (int tap = 0; tap < 9; ++tap) {
      const T* wt = s_w;
      if (L.resident) {
        wt += tap * tap_elems;
        cp_async_wait<0>();
      } else if (NBUF == 2) {
        if (tap + 1 < 9) {
          load_tap(tap + 1, o0, s_w + ((tap + 1) & 1) * tap_elems);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        wt += (tap & 1) * tap_elems;
      } else {
        load_tap(tap, o0, s_w);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
      const int ky = tap / 3, kx = tap % 3;
      const T* a0 = win + ((2 - ky) * WIN + pw * 16 + 2 - kx) * ldw;
      for (int kk = 0; kk < ok / 16; ++kk)
        dg_step<T, R, NC>(acc, a0 + kk * 16, ldw, wt + kk * 16, ldo, cw, ct_n);
      __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (cw + 2 * j < ct_n)
        acc[r][j].store(stage + (r * TP + pw * 16) * lds + (cw + 2 * j) * 16, lds);
  __syncthreads();

  // dz_prev = dx · gelu'(z_prev) and xa = gelu(z_prev) when the input had a
  // BN, in f32; the column sums of the block in fixed order
  const int cch = cs / V;
  for (int i = threadIdx.x; i < nr * np * cch; i += THREADS) {
    const int k = i % cch, pp = i / cch, p = pp % np, r = pp / np, cl = k * V, ci = c0 + cl;
    if (ci >= c) continue;
    float* st = stage + (r * TP + p) * lds + cl;
    float* st2 = stage2 + (r * TP + p) * lds + cl;
    const size_t e = ((row0 + y0 + r) * w + x0 + p) * c + ci;
    alignas(16) T dv[V];
    if (scal_out) {
      alignas(16) T sv[V], xv[V];
      ld_vec(sv, sp + e, c - ci, vec);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float* sc = s_out + ci + q;
        const float zh = (to_f(sv[q]) - sc[S_MEAN * c16]) * sc[S_ISTD * c16];
        const float z = zh * sc[S_GAMMA * c16] + sc[S_BETA * c16];
        const float d = st[q] * gelu_grad(z);
        xv[q] = from_f<T>(gelu(z));
        dv[q] = from_f<T>(d);
        st[q] = d;
        st2[q] = d * zh;
      }
      st_vec(x_out + e, xv, c - ci, vec);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) dv[q] = from_f<T>(st[q]);
    }
    st_vec(dzp + e, dv, c - ci, vec);
  }
  __syncthreads();
  for (int cl = threadIdx.x; cl < cs && c0 + cl < c; cl += THREADS) {
    float s1 = 0.f, s2 = 0.f;
    if (scal_out) {
      for (int r = 0; r < nr; ++r)
        for (int p = 0; p < np; ++p) {
          s1 += stage[(r * TP + p) * lds + cl];
          s2 += stage2[(r * TP + p) * lds + cl];
        }
    }
    psp[((size_t)blk * 2) * c + c0 + cl] = s1;
    psp[((size_t)blk * 2 + 1) * c + c0 + cl] = s2;
  }
}

template <typename T, int R>
cudaError_t launch_dgrad(const T* dz, const T* si, const T* sp, const T* wmat,
                         const float* scal_in, const float* scal_out, int bsz, int h, int w,
                         int c, int o, int vec, T* dzp, T* ds, T* xa, float* db_part,
                         float* psp, cudaStream_t st) {
  const int blocks = bsz * ((h + R - 1) / R) * ((w + TP - 1) / TP);
  if (blocks == 0) return cudaSuccess;
  const DgLayout L = dg_layout<T, R>(c, o);
  cudaError_t e = cudaFuncSetAttribute(cbg_dgrad_kernel<T, R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks, (c + CHUNK - 1) / CHUNK);
  cbg_dgrad_kernel<T, R><<<grid, THREADS, L.total, st>>>(
      dz, si, sp, wmat, scal_in, scal_out, h, w, c, o, vec, dzp, ds, xa, db_part, psp);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- f32 backward
// The f32 route of the backward: its own dgrad and wgrad kernels in true f32
// (FFMA), register-blocked as the forward's f32 route, so that a lane issues
// few shared-memory loads per FMA.
//
// dgrad: a block owns R = dg_rows() image rows of one sample (4 at <= 64
// input channels, else 2) x 64 pixels x a slice of 256 / R input channels
// c (blockIdx.y; a second slice at 256).  Output channels o stream through
// the window in chunks of 32: the BN backward fills the window with ds once
// per element (each ds row in 1.5-2 windows) while tap 0's weights arrive
// by cp.async, then two taps of weights double-buffer under the products,
// and two blocks share an SM.  Warp (f_row, tc) = (warp % R, warp / R) owns
// the 64 pixels of row f_row and c = tc·32 .. +32 of the slice; lane (lp,
// lc) = (l / 4, l % 4) accumulates pixels lp + 8i x channels lc + 4j (i, j
// < 8).  Per 2 output channels, 8 window float2 (the pixels) and 8 weight
// float2 (the channels, each a row of the tap's [c][o] tile, so that the
// tap arrives by 16-byte copies of W as it lies) feed 128 FMAs; each load's
// lanes read distinct banks (pixel and weight row strides of 36 floats, 20
// below 32 output channels).  The epilogue stages the sums in shared memory and runs the
// bf16 route's element pass (dz_prev = dx·gelu'(z_prev), xa = gelu(z_prev),
// 16 bytes a load and store) with the column sums per thread, combined in
// thread order: every partial has a fixed order.
//
// On an NVIDIA H100 80GB HBM3 at 700 W, 2B = 4, at 256²x64, 128²x128 and
// 64²x256 (chip_smoke.py): the dgrad 0.71 / 0.67 / 0.63-0.65 ms, the wgrad
// 0.44-0.46 ms, the backward 1.11-1.19 ms, 49-52% of its 0.577 ms bound
// (cuDNN's f32 sequence, TF32 off: 2.60-3.30 ms).  Without its products
// (tools/kernel_variants.py) the dgrad reads 0.14-0.24 ms, the wgrad
// 0.05-0.08 ms: the products run at about 60% and 75% of the FFMA rate.
template <int R> __host__ __device__ constexpr int dg32_slice() { return 2 * CHUNK / R; }
__host__ __device__ inline int dg32_ok(int o) { return r16(o) < 32 ? r16(o) : 32; }
template <int R> __host__ __device__ inline int dg32_cs(int c) {
  return r32(c) < dg32_slice<R>() ? r32(c) : dg32_slice<R>();
}

struct Dg32Layout {
  int win, w, dbred;                      // byte offsets of the window, the weights, the db partials
  int total;                              // bytes
};

// BN scalars [6][O16] and [6][C16]; the window [R + 2][WIN][OK + 4]; two
// taps [CS][OK + 4]; the threads' db partials [THREADS][4]; after the
// products the staging [R * TP][CS + 4], then the column sums' partials,
// reuse the window onwards (OK: the o chunk, CS: the c slice).
template <int R> __host__ __device__ inline Dg32Layout dg32_layout(int c, int o) {
  const int ok = dg32_ok(o), cs = dg32_cs<R>(c);
  const int scal = (6 * (r16(c) + r16(o)) * 4 + 127) / 128 * 128;
  const int win = ((R + 2) * WIN * (ok + 4) * 4 + 127) / 128 * 128;
  const int taps = 2 * cs * (ok + 4) * 4, dbred = THREADS * 4 * 4;
  const int stage = R * TP * (cs + 4) * 4, body = win + taps + dbred;
  Dg32Layout L;
  L.win = scal;
  L.w = scal + win;
  L.dbred = L.w + taps;
  L.total = scal + (body > stage ? body : stage);
  return L;
}

// The f32 products of one tap and o chunk (k_n channels): acc[i][j] +=
// Σ_k a[8i·lda + k] · b[4j·ldb + k], a the window at the lane's first pixel,
// b the tap's weight row of its first channel.
__device__ __forceinline__ void dg32_step(float (&acc)[8][8], const float* a, int lda,
                                          const float* b, int ldb, int k_n) {
  for (int k = 0; k < k_n; k += 2) {
    float2 bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = *reinterpret_cast<const float2*>(b + 4 * j * ldb + k);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 av = *reinterpret_cast<const float2*>(a + 8 * i * lda + k);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av.y, bv[j].y, fmaf(av.x, bv[j].x, acc[i][j]));
    }
  }
}

template <int R>
__global__ void __launch_bounds__(THREADS, 2)
cbg_dgrad_f32_kernel(const float* __restrict__ dz, const float* __restrict__ si,
                     const float* __restrict__ sp, const float* __restrict__ wmat,
                     const float* __restrict__ scal_in, const float* __restrict__ scal_out,
                     int h, int w, int c, int o, int vec, float* __restrict__ dzp,
                     float* __restrict__ ds_out, float* __restrict__ x_out,
                     float* __restrict__ db_part, float* __restrict__ psp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Dg32Layout L = dg32_layout<R>(c, o);
  const int c16 = r16(c), o16 = r16(o), ok = dg32_ok(o), cs = dg32_cs<R>(c);
  const int ld = ok + 4, lds = cs + 4, tap_elems = cs * ld, och = ok / 4;
  float* s_in = (float*)smem;                  // scal_in  [6][O16]
  float* s_out = s_in + 6 * o16;               // scal_out [6][C16]
  float* win = (float*)(smem + L.win);
  float* s_w = (float*)(smem + L.w);
  float* dbred = (float*)(smem + L.dbred);
  float* stage = win;                          // [R * TP][lds], after the products
  const int segs = (w + TP - 1) / TP, grps = (h + R - 1) / R;
  const int blk = blockIdx.x, tid = threadIdx.x;
  const int seg = blk % segs, grp = (blk / segs) % grps, b = blk / (segs * grps);
  const int x0 = seg * TP, y0 = grp * R;
  const int np = w - x0 < TP ? w - x0 : TP, nr = h - y0 < R ? h - y0 : R;
  const int c0 = blockIdx.y * dg32_slice<R>();  // this block's slice of c
  const bool first = blockIdx.y == 0;          // the slice that writes ds and db
  const size_t row0 = (size_t)b * h;

  // weights of one tap for the slice's c and the o chunk from o0
  auto load_tap = [&](int tap, int o0, float* dst) {
    for (int i = tid; i < cs * och; i += THREADS) {
      const int ci = i / och, oi = (i % och) * 4;
      const bool in = c0 + ci < c && o0 + oi < o;
      const float* src = in ? wmat + ((size_t)tap * c + c0 + ci) * o + o0 + oi : wmat;
      float* d = dst + ci * ld + oi;
      if (vec) {
        cp_async16(d, src, in);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) d[q] = in && o0 + oi + q < o ? src[q] : 0.f;
      }
    }
  };

  for (int i = tid; i < 6 * o16; i += THREADS) {
    const int k = i / o16, oi = i % o16;
    s_in[i] = oi < o ? scal_in[k * o + oi] : 0.f;
  }
  if (scal_out) {
    for (int i = tid; i < 6 * c16; i += THREADS) {
      const int k = i / c16, ci = i % c16;
      s_out[i] = ci < c ? scal_out[k * c + ci] : 0.f;
    }
  }
  __syncthreads();

  const int warp = tid / 32, l = tid & 31, f_row = warp % R, tc = warp / R;
  const int lp = l >> 2, lc = l & 3;
  const bool busy = tc * 32 < cs;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int o0 = 0; o0 < o; o0 += ok) {
    // (the previous chunk's products ended with a barrier) tap 0's copy runs
    // under the window's BN backward
    load_tap(0, o0, s_w);
    cp_async_commit();

    // ds = γ·istd·(dz − A − ẑ·B) on the window, once per element; the centre
    // rows are also this block's share of ds for the wgrad kernel and of
    // db.  A thread keeps to one chunk of 4 channels (och divides THREADS).
    alignas(16) float db4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < (R + 2) * WIN * och; i += THREADS) {
      const int k = i % och, j = (i / och) % WIN, r = i / (och * WIN);
      const int yy = y0 + r - 1, xx = x0 + j - 1, oi = o0 + k * 4;
      alignas(16) float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (yy >= 0 && yy < h && xx >= 0 && xx < w && oi < o) {
        const size_t e = ((row0 + yy) * w + xx) * o + oi;
        alignas(16) float dv[4], sv[4];
        ld_vec(dv, dz + e, o - oi, vec);
        ld_vec(sv, si + e, o - oi, vec);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* sc = s_in + oi + q;
          const float zh = (sv[q] - sc[S_MEAN * o16]) * sc[S_ISTD * o16];
          v[q] = sc[S_GAMMA * o16] * sc[S_ISTD * o16] *
                 (dv[q] - sc[S_A * o16] - zh * sc[S_B * o16]);
        }
        if (first && r >= 1 && r <= R && j >= 1 && j <= TP) {
          st_vec(ds_out + e, v, o - oi, vec);
#pragma unroll
          for (int q = 0; q < 4; ++q) db4[q] += v[q];
        }
      }
      *reinterpret_cast<float4*>(win + (r * WIN + j) * ld + k * 4) =
          *reinterpret_cast<const float4*>(v);
    }
    if (first) *reinterpret_cast<float4*>(dbred + tid * 4) = *reinterpret_cast<const float4*>(db4);
    __syncthreads();
    if (first) {
      // a channel's partials from the threads that kept to its chunk, in
      // thread order
      for (int oi = tid; oi < ok && o0 + oi < o; oi += THREADS) {
        float s1 = 0.f;
        for (int t = oi / 4; t < THREADS; t += och) s1 += dbred[t * 4 + oi % 4];
        db_part[(size_t)blk * o + o0 + oi] = s1;
      }
    }

    // dx[p][c] += Σ_tap Σ_o win[r + 2 - ky][p + 2 - kx][o] · W[ky][kx][c][o]
    for (int tap = 0; tap < 9; ++tap) {
      if (tap + 1 < 9) {
        load_tap(tap + 1, o0, s_w + ((tap + 1) & 1) * tap_elems);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int ky = tap / 3, kx = tap % 3;
      if (busy)
        dg32_step(acc, win + ((f_row + 2 - ky) * WIN + lp + 2 - kx) * ld, ld,
                  s_w + (tap & 1) * tap_elems + (tc * 32 + lc) * ld, ld, ok);
      __syncthreads();
    }
  }
  if (busy) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        stage[(f_row * TP + lp + 8 * i) * lds + tc * 32 + lc + 4 * j] = acc[i][j];
  }
  __syncthreads();

  // dz_prev = dx · gelu'(z_prev) and xa = gelu(z_prev) when the input had a
  // BN; a thread keeps to one chunk of 4 channels and sums d and d·ẑ_prev
  // over its pixels (in ascending order); the threads' sums are then
  // combined in thread order
  const int cch = cs / 4, used = THREADS / cch * cch, parts = used / cch;
  const int cl = tid % cch * 4, ci = c0 + cl;
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  if (tid < used && ci < c) {
    for (int i = tid; i < nr * np * cch; i += used) {
      const int pp = i / cch, p = pp % np, r = pp / np;
      alignas(16) float d[4];
      *reinterpret_cast<float4*>(d) =
          *reinterpret_cast<const float4*>(stage + (r * TP + p) * lds + cl);
      const size_t e = ((row0 + y0 + r) * w + x0 + p) * c + ci;
      if (scal_out) {
        alignas(16) float sv[4], xv[4];
        ld_vec(sv, sp + e, c - ci, vec);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* sc = s_out + ci + q;
          const float zh = (sv[q] - sc[S_MEAN * c16]) * sc[S_ISTD * c16];
          const float z = zh * sc[S_GAMMA * c16] + sc[S_BETA * c16];
          d[q] *= gelu_grad(z);
          xv[q] = gelu(z);
          s1[q] += d[q];
          s2[q] += d[q] * zh;
        }
        st_vec(x_out + e, xv, c - ci, vec);
      }
      st_vec(dzp + e, d, c - ci, vec);
    }
  }
  __syncthreads();
  float* red = stage;                          // [2][parts][CS]: Σd, then Σd·ẑ_prev
  if (tid < used) {
    const int part = tid / cch;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      red[part * cs + cl + q] = s1[q];
      red[(parts + part) * cs + cl + q] = s2[q];
    }
  }
  __syncthreads();
  for (int cc = tid; cc < cs && c0 + cc < c; cc += THREADS) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < parts; ++k) {
      t1 += red[k * cs + cc];
      t2 += red[(parts + k) * cs + cc];
    }
    psp[((size_t)blk * 2) * c + c0 + cc] = t1;
    psp[((size_t)blk * 2 + 1) * c + c0 + cc] = t2;
  }
}

template <int R>
cudaError_t launch_dgrad32(const float* dz, const float* si, const float* sp, const float* wmat,
                           const float* scal_in, const float* scal_out, int bsz, int h, int w,
                           int c, int o, int vec, float* dzp, float* ds, float* xa,
                           float* db_part, float* psp, cudaStream_t st) {
  const int blocks = bsz * ((h + R - 1) / R) * ((w + TP - 1) / TP);
  if (blocks == 0) return cudaSuccess;
  const Dg32Layout L = dg32_layout<R>(c, o);
  cudaError_t e = cudaFuncSetAttribute(cbg_dgrad_f32_kernel<R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks, (c + dg32_slice<R>() - 1) / dg32_slice<R>());
  cbg_dgrad_f32_kernel<R><<<grid, THREADS, L.total, st>>>(
      dz, si, sp, wmat, scal_in, scal_out, h, w, c, o, vec, dzp, ds, xa, db_part, psp);
  return cudaGetLastError();
}

// wgrad: as the bf16 kernel, a block owns one 64x64 (c, o) tile pair and a
// slab of work units (WG32_R = 2 image rows of one sample x 64 pixels),
// staged by cp.async into two stages (xa with its one-pixel halo: read 2
// times, not 3), but the reduction over pixels runs on FFMA: warp (ky, wq)
// owns kernel row ky and c = wq·16 .. +16 of the tile, and lane (cg, og) =
// (l % 4, l / 4) the 3 taps of its row x 4 channels c x 8 channels o (96
// accumulators).  A lane walks each row's 64 pixels in order, keeping the
// three xa vectors its taps need in registers and sliding them by one
// pixel: per pixel one float4 of xa and two of ds feed 96 FMAs.
constexpr int WG32_R = 2;
constexpr int WG32_STAGE = (WG32_R + 2) * WIN * 64 + WG32_R * TP * 64;  // floats: xa, then ds
static_assert(TP == 64, "wg32_row walks 64 pixels");

// Copy rows [y0 - 1, y0 + R] x pixels [x0 - 1, x0 + 64] of xa (channels
// c0..+64) and rows [y0, y0 + R) x pixels [x0, x0 + 64) of ds (o0..+64) of
// sample b into one stage (pixel stride 64 floats), zero outside the image
// and the channels.
__device__ void wg32_load(const float* __restrict__ xa, const float* __restrict__ ds, int h,
                          int w, int c, int o, int c0, int o0, int b, int y0, int x0, float* sx,
                          float* sd, bool vec) {
  constexpr int R = WG32_R;
  const size_t row0 = (size_t)b * h;
  for (int i = threadIdx.x; i < (R + 2) * WIN * 16; i += WG_THREADS) {
    const int k = i % 16, j = (i / 16) % WIN, r = i / (16 * WIN);
    const int yy = y0 + r - 1, xx = x0 + j - 1, ci = c0 + k * 4;
    const bool ok = yy >= 0 && yy < h && xx >= 0 && xx < w && ci < c;
    const float* src = ok ? xa + ((row0 + yy) * w + xx) * c + ci : xa;
    float* dst = sx + (r * WIN + j) * 64 + k * 4;
    if (vec) {
      cp_async16(dst, src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = ok && ci + e < c ? src[e] : 0.f;
    }
  }
  for (int i = threadIdx.x; i < R * TP * 16; i += WG_THREADS) {
    const int k = i % 16, j = (i / 16) % TP, r = i / (16 * TP);
    const int yy = y0 + r, xx = x0 + j, oi = o0 + k * 4;
    const bool ok = yy < h && xx < w && oi < o;
    const float* src = ok ? ds + ((row0 + yy) * w + xx) * o + oi : ds;
    float* dst = sd + (r * TP + j) * 64 + k * 4;
    if (vec) {
      cp_async16(dst, src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = ok && oi + e < o ? src[e] : 0.f;
    }
  }
}

// One pixel: acc[kx][i][j] += x_kx[i] · ds[j], the lane's 8 ds values at d
// and d + 32.
__device__ __forceinline__ void wg32_px(float (&acc)[3][4][8], const float4 x0, const float4 x1,
                                        const float4 x2, const float* d) {
  alignas(16) float dv[8];
  *reinterpret_cast<float4*>(dv) = *reinterpret_cast<const float4*>(d);
  *reinterpret_cast<float4*>(dv + 4) = *reinterpret_cast<const float4*>(d + 32);
  const float xv[3][4] = {{x0.x, x0.y, x0.z, x0.w}, {x1.x, x1.y, x1.z, x1.w},
                          {x2.x, x2.y, x2.z, x2.w}};
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[kx][i][j] = fmaf(xv[kx][i], dv[j], acc[kx][i][j]);
}

// One image row: xr the lane's xa at stage pixel 0 of its tap row, dr its
// ds at pixel 0 (pixel stride 64 floats).  Pixel p takes xa pixels p, p + 1,
// p + 2 (taps kx = 0, 1, 2), held in three registers that rotate.
__device__ __forceinline__ void wg32_row(float (&acc)[3][4][8], const float* xr, const float* dr) {
  const auto ld = [&](int j) { return *reinterpret_cast<const float4*>(xr + j * 64); };
  float4 a = ld(0), b = ld(1), c = ld(2);
  for (int p = 0; p < TP - 1; p += 3) {
    wg32_px(acc, a, b, c, dr + p * 64);
    a = ld(p + 3);
    wg32_px(acc, b, c, a, dr + (p + 1) * 64);
    b = ld(p + 4);
    wg32_px(acc, c, a, b, dr + (p + 2) * 64);
    c = ld(p + 5);
  }
  wg32_px(acc, a, b, c, dr + (TP - 1) * 64);
}

__global__ void __launch_bounds__(WG_THREADS, 1)
cbg_wgrad_f32_kernel(const float* __restrict__ xa, const float* __restrict__ ds, int bsz, int h,
                     int w, int c, int o, int slabs, int vec, float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = WG32_R;
  float* stage[2] = {(float*)smem, (float*)smem + WG32_STAGE};
  const int ot_n = (o + 63) / 64, cp = r64(c), op = r64(o);
  const int c0 = blockIdx.x / ot_n * 64, o0 = blockIdx.x % ot_n * 64;
  const int segs = (w + TP - 1) / TP, grps = (h + R - 1) / R;
  const long long units = (long long)bsz * grps * segs;
  const long long u0 = units * blockIdx.y / slabs, u1 = units * (blockIdx.y + 1) / slabs;
  const int warp = threadIdx.x / 32, l = threadIdx.x & 31, ky = warp / 4, wq = warp % 4;
  const int cl = wq * 16 + (l & 3) * 4, ol = (l >> 2) * 4;
  const bool busy = c0 + wq * 16 < c;      // this warp's c rows exist

  auto load = [&](long long u, float* st) {
    const int seg = (int)(u % segs);
    const long long g = u / segs;
    wg32_load(xa, ds, h, w, c, o, c0, o0, (int)(g / grps), (int)(g % grps) * R, seg * TP, st,
              st + (R + 2) * WIN * 64, vec);
    cp_async_commit();
  };

  alignas(16) float acc[3][4][8];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[kx][i][j] = 0.f;
  if (u0 < u1) load(u0, stage[0]);
  for (long long u = u0; u < u1; ++u) {
    const int cur = (int)((u - u0) & 1);
    if (u + 1 < u1) {
      load(u + 1, stage[cur ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sx = stage[cur];
    const float* sd = sx + (R + 2) * WIN * 64;
    if (busy) {
#pragma unroll 1
      for (int r = 0; r < R; ++r)
        wg32_row(acc, sx + (r + ky) * WIN * 64 + cl, sd + r * TP * 64 + ol);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * 9 * cp * op + o0 + ol;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = out + ((size_t)(ky * 3 + kx) * cp + c0 + cl + i) * op;
      *reinterpret_cast<float4*>(row) = *reinterpret_cast<const float4*>(&acc[kx][i][0]);
      *reinterpret_cast<float4*>(row + 32) = *reinterpret_cast<const float4*>(&acc[kx][i][4]);
    }
}

// Slabs per (c, o) tile pair: one wave of blocks (one block per SM of an
// H100 SXM), at most one slab per work unit: bf16 rounds the wave up over
// the tile pairs, f32 down (144 blocks at 16 tile pairs would leave 12 for
// a second wave).  The wave is a constant, not the card's SM count, so the
// slabs, and the order in which wgrad_reduce sums them, depend on the shape
// alone: dW is bit-identical on every card.
constexpr int WG_WAVE = 132;

int wgrad_slabs(int bsz, int h, int w, int c, int o, int esz) {
  const int rows = esz == 2 ? wg_rows<bf16>() : WG32_R;
  const int tiles = ((c + 63) / 64) * ((o + 63) / 64);
  const long long units = (long long)bsz * ((h + rows - 1) / rows) * ((w + TP - 1) / TP);
  long long s = esz == 2 ? (WG_WAVE + tiles - 1) / tiles : WG_WAVE / tiles;
  if (s > units) s = units;
  return s < 1 ? 1 : (int)s;
}

struct BwdScratch {
  size_t ds, xa, part, total;
  int slabs;
};

BwdScratch bwd_layout(int bsz, int h, int w, int c, int o, int esz) {
  BwdScratch s;
  const long long npix = (long long)bsz * h * w;
  s.slabs = wgrad_slabs(bsz, h, w, c, o, esz);
  size_t off = 0;
  s.ds = off;   off += align256((size_t)npix * o * esz);
  s.xa = off;   off += align256((size_t)npix * c * esz);
  s.part = off; off += align256((size_t)s.slabs * 9 * r64(c) * r64(o) * 4);
  s.total = off;
  return s;
}

// ---------------------------------------------------------------- forward
// A block owns R = fw_rows() image rows of one sample x one 64-pixel segment
// x one slice of up to CHUNK output channels (blockIdx.y).  Warp (pw, ow)
// owns pixel tile pw of each of the R rows and o tiles ow, ow + 2, ... of
// the slice: per 16-deep step R A and up to NC B fragments feed R x NC
// products.  The input channels pass through the window in chunks of up to
// CHUNK, the accumulators carrying over.
struct FwLayout {
  int w, total;                           // byte offset of the weights (the window is at 0); the size
  int nbuf;                               // taps of weights held: 2 (double-buffered) or 1
};

// The f32 route gives a block an o slice of 256 / R channels (R rows as in
// bf16), so that its 8 warps of 64 pixels x 32 output channels cover the R
// rows x 64 pixels x slice, and streams input channels in chunks of 32,
// small enough for two taps of weights (double-buffered) and two blocks an
// SM; its window and weight rows are padded by one 16-byte unit (bf16:
// ck + 8 and os + 8 elements).
template <typename T, int R> __host__ __device__ constexpr int fw_slice() {
  return sizeof(T) == 2 ? CHUNK : 2 * CHUNK / R;
}
template <typename T> __host__ __device__ constexpr int fw_pad() { return sizeof(T) == 2 ? 8 : 4; }
template <typename T> __host__ __device__ inline int fw_ck(int c) {
  return sizeof(T) == 2 ? chunk16(c) : (r16(c) < 32 ? r16(c) : 32);
}
template <typename T, int R> __host__ __device__ inline int fw_os(int o) {
  if (sizeof(T) == 2) return chunk16(o);
  return r32(o) < fw_slice<T, R>() ? r32(o) : fw_slice<T, R>();
}

constexpr int SMEM_HALF = 233472 / 2 - 1024;  // a block's share when two share an SM (228 KB, 1 KB reserved each)

__host__ __device__ inline int fw_bytes(int win, int tap, int stage, int nbuf) {
  return win + nbuf * tap > stage ? win + nbuf * tap : stage;
}

// Shared memory of the forward kernel: the window [R + 2][WIN][CK + 8]
// (a pixel stride of 16 bytes more than the channels: ldmatrix reads its 8
// rows from 8 distinct bank groups), then the weights [nbuf][CK][OS + 8]
// (CK: the c chunk, OS: the o slice, each min(16-rounded width, CHUNK);
// f32: CK + 4, OS + 4, CK the 16-rounded width up to 32, and OS the
// 32-rounded width up to 256 / R).
// After the products the f32 staging [R * TP][OS + 4], then the column
// sums' partials (<= 16 KB), reuse both.  Two taps of weights are held
// (the next copied under the current one's products) when that keeps two
// blocks an SM, so that one block's loads and BN+GELU run under the other's
// products: 76 KB at 64 channels; else one tap (107 KB at 128 and 256
// channels, still two blocks an SM).
template <typename T, int R>
__host__ __device__ inline FwLayout fw_layout(int c, int o) {
  const int ck = fw_ck<T>(c), os = fw_os<T, R>(o), sz = (int)sizeof(T);
  const int win = ((R + 2) * WIN * (ck + fw_pad<T>()) * sz + 127) / 128 * 128;
  const int tap = ck * (os + fw_pad<T>()) * sz;
  const int stage = R * TP * (os + 4) * 4;
  FwLayout L;
  L.w = win;
  L.nbuf = fw_bytes(win, tap, stage, 2) <= SMEM_HALF ? 2 : 1;
  L.total = fw_bytes(win, tap, stage, L.nbuf);
  return L;
}

// Rows per forward block: 4 when C <= 64, else 2 (128 and 256).
inline int fw_rows(int c) { return r16(c) <= 64 ? 4 : 2; }

// A 16x16 f32 tile of bf16 products by mma.sync m16n8k16, its operands
// read by ldmatrix, which needs 16-byte aligned rows only (WMMA wants
// 32-byte aligned tiles, so a tap-shifted window would need a pixel stride
// of C16 + 16, whose rows meet in the same banks).  Two n8 halves; lane l
// holds rows l/4 and l/4 + 8, columns 2(l%4) and 2(l%4) + 1 of each.
struct MmaTile {
  float d[2][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) d[h][q] = 0.f;
  }
  __device__ __forceinline__ void store(float* c, int ldc) const {
    const int l = threadIdx.x & 31, r = l >> 2, cc = (l & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(c + r * ldc + h * 8 + cc) = make_float2(d[h][0], d[h][1]);
      *reinterpret_cast<float2*>(c + (r + 8) * ldc + h * 8 + cc) = make_float2(d[h][2], d[h][3]);
    }
  }
};

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

__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-deep step (16 input channels c) of warp (pw, ow):
// acc[r][j] += A_r · B_j, A_r the window at row r's pixel tile (a + r·WIN·lda,
// row-major over c), B_j o tile ow + 2j of this tap's W[c][o] (row-major,
// read transposed: mma's B is column-major).
template <int R, int NC>
__device__ __forceinline__ void fw_step(MmaTile (&acc)[R][NC], const bf16* a, int lda,
                                        const bf16* bm, int ldb, int ow, int ot_n) {
  const int l = threadIdx.x & 31, row = l & 15, col = (l >> 4) * 8;
  unsigned fa[R][4], fb[NC][4];
#pragma unroll
  for (int r = 0; r < R; ++r) ldsm4<false>(fa[r], a + (r * WIN + row) * lda + col);
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (ow + 2 * j < ot_n) ldsm4<true>(fb[j], bm + row * ldb + (ow + 2 * j) * 16 + col);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (ow + 2 * j < ot_n) {
        mma16816(acc[r][j].d[0], fa[r], fb[j][0], fb[j][1]);
        mma16816(acc[r][j].d[1], fa[r], fb[j][2], fb[j][3]);
      }
}

// The f32 products of one tap and input-channel chunk (k_n channels), in
// true f32 (FFMA): lane (lp, lc) = (l / 4, l % 4) of a warp tile (64
// pixels x 32 output channels) accumulates 8 pixels (a + 8i·lda: lp + 8i)
// x 8 output channels (b + 4lc and b + 16 + 4lc).  Per 2 channels, 8
// window float2 and 4 weight float4 loads feed 128 FMAs (a quarter of a
// float of shared memory an FMA, what the SM serves at the FFMA rate, in
// few enough registers for two blocks an SM); the window's pixel stride
// (an odd number of 16-byte units) puts a load's pixels in distinct banks,
// and a weight load's 4 lanes read 64 contiguous bytes.
__device__ __forceinline__ void fw32_step(float (&acc)[8][8], const float* a, int lda,
                                          const float* b, int ldb, int k_n) {
  for (int k = 0; k < k_n; k += 2) {
    float bv[2][8];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      *reinterpret_cast<float4*>(bv[q]) = *reinterpret_cast<const float4*>(b + (k + q) * ldb);
      *reinterpret_cast<float4*>(bv[q] + 4) =
          *reinterpret_cast<const float4*>(b + (k + q) * ldb + 16);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 av = *reinterpret_cast<const float2*>(a + 8 * i * lda + k);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av.y, bv[1][j], fmaf(av.x, bv[0][j], acc[i][j]));
    }
  }
}

// Two blocks an SM cap a thread at 128 registers, enough for the path's
// R x NC = 8 tiles a warp (64 -> 64, and a 128-wide slice at 128 and 256)
// and for the f32 route's 8 x 8 micro-tile.
template <typename T, int R, int NC>
__global__ void __launch_bounds__(THREADS, 2)
cbg_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wmat,
               const T* __restrict__ bias, const float* __restrict__ scal, int h, int w,
               int c, int o, int vec, T* __restrict__ s, float* __restrict__ ps) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const FwLayout L = fw_layout<T, R>(c, o);
  constexpr bool BF = std::is_same<T, bf16>::value;
  const int ck = fw_ck<T>(c), os = fw_os<T, R>(o), lds = os + 4;
  const int ldw = ck + fw_pad<T>(), ldo = os + fw_pad<T>();
  T* win = (T*)smem;
  T* s_w = (T*)(smem + L.w);
  float* stage = (float*)smem;                 // [R * TP][lds], after the products
  const int tap_elems = ck * ldo;
  const int segs = (w + TP - 1) / TP, grps = (h + R - 1) / R;
  const int blk = blockIdx.x, tid = threadIdx.x;
  const int seg = blk % segs, grp = (blk / segs) % grps, b = blk / (segs * grps);
  const int x0 = seg * TP, y0 = grp * R;
  const int np = w - x0 < TP ? w - x0 : TP, nr = h - y0 < R ? h - y0 : R;
  const int o0 = blockIdx.y * fw_slice<T, R>();  // this block's slice of o
  const size_t row0 = (size_t)b * h;
  const T zero = from_f<T>(0.f);

  // weights of one tap for the c chunk from c0 and the slice's o
  auto load_tap = [&](int tap, int c0, T* dst) {
    const int chunks = os / V;
    for (int i = threadIdx.x; i < ck * chunks; i += THREADS) {
      const int ci = i / chunks, oi = (i % chunks) * V;
      const bool ok = c0 + ci < c && o0 + oi < o;
      const T* src = ok ? wmat + ((size_t)tap * c + c0 + ci) * o + o0 + oi : wmat;
      T* d = dst + ci * ldo + oi;
      if (vec) {
        cp_async16(d, src, ok);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) d[q] = ok && o0 + oi + q < o ? src[q] : zero;
      }
    }
  };

  const int warp = tid / 32, pw = warp % 4, ow = warp / 4, ot_n = os / 16;
  [[maybe_unused]] MmaTile acc[BF ? R : 1][BF ? NC : 1];  // bf16: the mma.sync tiles
  [[maybe_unused]] float facc[BF ? 1 : 8][8];             // f32: the 8 x 8 micro-tile
  // f32: warp (f_row, tc) = (warp % R, warp / R) owns the 64 pixels of row
  // f_row and output channels tc·32 .. +32 of the slice
  const int tc = warp / R, l = tid & 31;
  [[maybe_unused]] const int f_row = warp % R, f_px = l >> 2, f_oc = tc * 32 + (l & 3) * 4;
  [[maybe_unused]] const bool f_busy = tc * 32 < os;
  if constexpr (BF) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j].zero();
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) facc[i][j] = 0.f;
  }

  const int cch = ck / V, nwin = (R + 2) * WIN * cch;
  for (int c0 = 0; c0 < c; c0 += BF ? CHUNK : ck) {
    // (the previous chunk's products ended with a barrier) the raw window of
    // this chunk, zero outside the image and the channels; then the weights,
    // whose copy may still run under the BN+GELU pass
    for (int i = tid; i < nwin; i += THREADS) {
      const int k = i % cch, j = (i / cch) % WIN, r = i / (cch * WIN);
      const int yy = y0 + r - 1, xx = x0 + j - 1, ci = c0 + k * V;
      const bool ok = yy >= 0 && yy < h && xx >= 0 && xx < w && ci < c;
      const T* src = ok ? x + ((row0 + yy) * w + xx) * c + ci : x;
      T* dst = win + (r * WIN + j) * ldw + k * V;
      if (vec) {
        cp_async16(dst, src, ok);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) dst[q] = ok && ci + q < c ? src[q] : zero;
      }
    }
    cp_async_commit();
    load_tap(0, c0, s_w);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // u = gelu(bn(x)) in place on the window's pixels inside the image, once
    // per element.  A thread keeps to one chunk of V channels and holds their
    // BN scalars in registers (zero beyond C, so that u stays 0 there).
    if (scal) {
      const int used = THREADS / cch * cch;
      if (tid < used) {
        const int ci = c0 + tid % cch * V;
        float sc[4][V];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int q = 0; q < V; ++q) sc[k][q] = ci + q < c ? scal[k * c + ci + q] : 0.f;
        for (int i = tid; i < nwin; i += used) {
          const int j = (i / cch) % WIN, r = i / (cch * WIN);
          const int yy = y0 + r - 1, xx = x0 + j - 1;
          if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
          uint4* p = reinterpret_cast<uint4*>(win + (r * WIN + j) * ldw + (ci - c0));
          alignas(16) T v[V];
          *reinterpret_cast<uint4*>(v) = *p;
#pragma unroll
          for (int q = 0; q < V; ++q)
            v[q] = from_f<T>(gelu((to_f(v[q]) - sc[S_MEAN][q]) * sc[S_ISTD][q] * sc[S_GAMMA][q]
                                  + sc[S_BETA][q]));
          *p = *reinterpret_cast<const uint4*>(v);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // s[p][o] += Σ_tap Σ_c win[r + ky][p + kx][c] · W[ky][kx][c][o]
    for (int tap = 0; tap < 9; ++tap) {
      const T* wt = s_w;
      if (L.nbuf == 2) {
        if (tap + 1 < 9) {
          load_tap(tap + 1, c0, s_w + ((tap + 1) & 1) * tap_elems);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        wt += (tap & 1) * tap_elems;
      } else if (tap > 0) {
        load_tap(tap, c0, s_w);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
      const int ky = tap / 3, kx = tap % 3;
      if constexpr (BF) {
        const T* a0 = win + (ky * WIN + pw * 16 + kx) * ldw;
        for (int kk = 0; kk < ck / 16; ++kk)
          fw_step<R, NC>(acc, a0 + kk * 16, ldw, wt + kk * 16 * ldo, ldo, ow, ot_n);
      } else if (f_busy) {
        fw32_step(facc, win + ((f_row + ky) * WIN + f_px + kx) * ldw, ldw, wt + f_oc, ldo, ck);
      }
      __syncthreads();
    }
  }
  if constexpr (BF) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if (ow + 2 * j < ot_n)
          acc[r][j].store(stage + (r * TP + pw * 16) * lds + (ow + 2 * j) * 16, lds);
  } else if (f_busy) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float4*>(stage + (f_row * TP + f_px + 8 * i) * lds + f_oc + 16 * hh) =
            *reinterpret_cast<const float4*>(&facc[i][4 * hh]);
  }
  __syncthreads();

  // s = acc + bias, rounded to T, 16 bytes a store.  A thread keeps to one
  // chunk of V output channels and sums the rounded s and s² over its pixels
  // (in ascending order); the threads' partials are then combined in thread
  // order, one [2, O] row per block (this block's slice of it).
  const int och = os / V, oused = THREADS / och * och, parts = oused / och;
  const int oi = tid % och * V, og = o0 + oi;
  float s1[V], s2[V];
#pragma unroll
  for (int q = 0; q < V; ++q) s1[q] = s2[q] = 0.f;
  if (tid < oused) {
    float bv[V];
#pragma unroll
    for (int q = 0; q < V; ++q) bv[q] = og + q < o ? to_f(bias[og + q]) : 0.f;
    for (int i = tid; i < nr * np * och; i += oused) {
      const int pp = i / och, p = pp % np, r = pp / np;
      const float* st = stage + (r * TP + p) * lds + oi;
      alignas(16) float f[V];
#pragma unroll
      for (int q = 0; q < V; q += 4)
        *reinterpret_cast<float4*>(f + q) = *reinterpret_cast<const float4*>(st + q);
      alignas(16) T v[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        v[q] = from_f<T>(f[q] + bv[q]);
        const float u = to_f(v[q]);
        s1[q] += u;
        s2[q] += u * u;
      }
      if (og < o) st_vec(s + ((row0 + y0 + r) * w + x0 + p) * o + og, v, o - og, vec);
    }
  }
  __syncthreads();
  float* red = stage;                          // [2][parts][OS]: Σs, then Σs²
  if (tid < oused) {
    const int part = tid / och;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      red[part * os + oi + q] = s1[q];
      red[(parts + part) * os + oi + q] = s2[q];
    }
  }
  __syncthreads();
  for (int oc = tid; oc < os && o0 + oc < o; oc += THREADS) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < parts; ++k) {
      t1 += red[k * os + oc];
      t2 += red[(parts + k) * os + oc];
    }
    ps[((size_t)blk * 2) * o + o0 + oc] = t1;
    ps[((size_t)blk * 2 + 1) * o + o0 + oc] = t2;
  }
}

template <typename T, int R, int NC>
cudaError_t launch_fwd(const T* x, const T* wmat, const T* bias, const float* scal, int bsz,
                       int h, int w, int c, int o, int vec, T* s, float* ps, cudaStream_t st) {
  const int blocks = bsz * ((h + R - 1) / R) * ((w + TP - 1) / TP);
  if (blocks == 0) return cudaSuccess;
  const FwLayout L = fw_layout<T, R>(c, o);
  cudaError_t e = cudaFuncSetAttribute(cbg_fwd_kernel<T, R, NC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks, (o + fw_slice<T, R>() - 1) / fw_slice<T, R>());
  cbg_fwd_kernel<T, R, NC><<<grid, THREADS, L.total, st>>>(x, wmat, bias, scal, h, w, c, o,
                                                            vec, s, ps);
  return cudaGetLastError();
}

// NC: o tiles per warp (bf16), 2 up to 64 output channels, else 4 (a slice
// of 128); f32 takes its micro-tile instead.
template <typename T, int R>
cudaError_t launch_fwd_nc(const T* x, const T* wmat, const T* bias, const float* scal, int bsz,
                          int h, int w, int c, int o, int vec, T* s, float* ps, cudaStream_t st) {
  if constexpr (sizeof(T) == 4) {
    return launch_fwd<T, R, 2>(x, wmat, bias, scal, bsz, h, w, c, o, vec, s, ps, st);
  } else {
    if (chunk16(o) <= 64) return launch_fwd<T, R, 2>(x, wmat, bias, scal, bsz, h, w, c, o, vec, s, ps, st);
    return launch_fwd<T, R, 4>(x, wmat, bias, scal, bsz, h, w, c, o, vec, s, ps, st);
  }
}

template <typename T>
int fwd(const void* x, const void* wmat, const void* bias, const float* scal, int bsz,
        int h, int w, int c, int o, void* s, float* ps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const auto al = [](const void* p) { return (size_t)p % 16 == 0; };
  const int vec = c % V == 0 && o % V == 0 && al(x) && al(wmat) && al(s);
  const T *xt = (const T*)x, *wt = (const T*)wmat, *bt = (const T*)bias;
  cudaError_t e;
  if (fw_rows(c) == 4) {
    e = launch_fwd_nc<T, 4>(xt, wt, bt, scal, bsz, h, w, c, o, vec, (T*)s, ps, st);
  } else {
    e = launch_fwd_nc<T, 2>(xt, wt, bt, scal, bsz, h, w, c, o, vec, (T*)s, ps, st);
  }
  return (int)e;
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
  constexpr int V = 16 / sizeof(T);
  const auto al = [](const void* p) { return (size_t)p % 16 == 0; };
  const int vec = c % V == 0 && o % V == 0 && al(dz) && al(si) && al(sp) && al(wmat) &&
                  al(dzp) && al(ds) && al(xa);
  const T *dzt = (const T*)dz, *sit = (const T*)si, *spt = (const T*)sp, *wt = (const T*)wmat;
  const int tiles = ((c + 63) / 64) * ((o + 63) / 64);
  cudaError_t e;
  if constexpr (sizeof(T) == 4) {
    e = dg_rows(c) == 4
            ? launch_dgrad32<4>(dzt, sit, spt, wt, scal_in, scal_out, bsz, h, w, c, o, vec,
                                (T*)dzp, ds, xa, db_part, psp, st)
            : launch_dgrad32<2>(dzt, sit, spt, wt, scal_in, scal_out, bsz, h, w, c, o, vec,
                                (T*)dzp, ds, xa, db_part, psp, st);
    if (e != cudaSuccess) return (int)e;
    const size_t wg_smem = 2 * (size_t)WG32_STAGE * sizeof(float);
    e = cudaFuncSetAttribute(cbg_wgrad_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wg_smem);
    if (e != cudaSuccess) return (int)e;
    cbg_wgrad_f32_kernel<<<dim3(tiles, sc.slabs), WG_THREADS, wg_smem, st>>>(
        xa, ds, bsz, h, w, c, o, sc.slabs, vec, part);
  } else {
    e = dg_rows(c) == 4
            ? launch_dgrad<T, 4>(dzt, sit, spt, wt, scal_in, scal_out, bsz, h, w, c, o, vec,
                                 (T*)dzp, ds, xa, db_part, psp, st)
            : launch_dgrad<T, 2>(dzt, sit, spt, wt, scal_in, scal_out, bsz, h, w, c, o, vec,
                                 (T*)dzp, ds, xa, db_part, psp, st);
    if (e != cudaSuccess) return (int)e;
    const size_t wg_smem = 2 * (size_t)wg_stage_elems<T>() * sizeof(T);
    e = cudaFuncSetAttribute(cbg_wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wg_smem);
    if (e != cudaSuccess) return (int)e;
    cbg_wgrad_kernel<T><<<dim3(tiles, sc.slabs), WG_THREADS, wg_smem, st>>>(
        xa, ds, bsz, h, w, c, o, sc.slabs, vec, part);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  int rblocks = (9 * c * o + 255) / 256;
  wgrad_reduce<<<rblocks, 256, 0, st>>>(part, sc.slabs, c, o, dw);
  return (int)cudaGetLastError();
}

bool shapes_ok(int c, int o) { return c > 0 && o > 0 && c <= MAXC && o <= MAXC; }

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// Row groups x segments (= partial-sum rows) of one forward call (the same
// for both compute types).
int cbg_fwd_blocks(int bsz, int h, int w, int c, int is_bf16) {
  const int r = fw_rows(c);
  return bsz * ((h + r - 1) / r) * ((w + TP - 1) / TP);
}

// Row groups x segments (= partial-sum rows) of one backward call.
int cbg_bwd_blocks(int bsz, int h, int w, int c, int is_bf16) {
  const int r = dg_rows(c);
  return bsz * ((h + r - 1) / r) * ((w + TP - 1) / TP);
}

long long cbg_bwd_scratch_bytes(int bsz, int h, int w, int c, int o, int is_bf16) {
  return (long long)bwd_layout(bsz, h, w, c, o, is_bf16 ? 2 : 4).total;
}

// x [B, H, W, C], wmat [3, 3, C, O], bias [O] in the compute dtype; scal
// [6, C] f32 (mean, istd, gamma, beta, -, -) or null; s [B, H, W, O];
// ps [cbg_fwd_blocks, 2, O] f32.  C, O <= 256.
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
// the compute dtype; dw [3, 3, C, O], db_part [cbg_bwd_blocks, O] and
// psp [cbg_bwd_blocks, 2, C] f32.
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

