// Sorted segment-sum: out[r, :] = sum of feats[i, :] over the points i with
// ids[i] == r, for r in [0, S).  The stream is cut into `samples` equal
// parts (positions [b·N/samples, (b+1)·N/samples) and rows [b·S/samples,
// (b+1)·S/samples) for sample b); within each part the ids ascend, those
// at or beyond S (the sentinel) last, and every id below S lies in the
// part's own rows.  Ids outside [0, S) add nothing.  Every output row is
// written exactly once; empty rows are exact zeros.  Accumulation is f32,
// from 0, in ascending point order, rounded once to the input dtype, so the
// result is deterministic.
//
// Replaces: deflow_tpu/ops/pallas_scatter.py::_sorted_scatter (the Pallas
// kernel _make_kernel), reached from pillar_sum_scatter_pallas /
// _planned_scatter by the embedder's pillar mean-scatter, and here also the
// gather's backward (ops/voxel.py::_Gather).
//
// Bound on the H100: bytes.  One pass reads the [N, C] features of the
// points with an id below S and the [N] ids and writes the [S, C] table, a
// few flops per byte.  On the eval path (N = 393,216 points of C = 33 bf16
// lanes, S = 1,048,608) that is ~94 MB, of which the output is 69 MB; on the
// gather's backward (196,608 x 128 bf16 -> 524,304 rows) ~179 MB.  Most rows
// are empty (about 72% on the uniform clouds), so the kernel is mostly a
// stream of 16-byte stores.
//
// Design: one launch, no scratch table, no memset.  The output is cut into
// tiles of consecutive rows of one sample, at most TILE_BYTES and
// MAX_TILE_ROWS rows each (rows never split; a longer tile would hold more
// points in a dense near field), each composed in shared memory.
//  - A persistent CTA (one wave, MIN_BLOCKS an SM) takes every
//    gridDim.x-th tile.  Its two search warps find the next tile's first
//    and last point, each with a 32-way lower bound over the sample's own
//    positions (4 rounds of one load a lane for 98,304 positions), while
//    its six worker warps write the current tile: the search's dependent
//    loads are off the workers' path.  Within a sample "id < row" holds on
//    a prefix, which a search over the whole stream would not give, as the
//    presorted plan leaves each sample's sentinel tail between the samples.
//  - The tile's points are one contiguous range of feats.  One pass over
//    their ids writes each occupied row's run [begin, end) and a list of
//    the occupied rows into shared memory, while the first piece of their
//    features moves into shared memory as the 16-byte vectors that cover
//    its bytes (STAGE_BYTES).
//  - The work is the occupied rows' elements only: threads take (occupied
//    row, 16 bytes of columns) items, found by a multiply-high by a
//    host-made reciprocal of the groups a row (no division per element),
//    add the row's run in point order in f32 from the stage (a 16-byte
//    vector a point where C·size is a whole number of vectors, as at 128
//    bf16 lanes), round once and write the elements into the tile.  Empty
//    rows (72% on the uniform clouds) are the zeros already there.
//  - The tile goes out as 16-byte vectors, whatever C is (the tile in
//    shared memory starts at its output's 16-byte boundary); only the two
//    end vectors, which neighbouring tiles share, go element by element.
//  - A tile with more points than the stage holds is done in pieces of
//    whole rows.  A row with more points than the stage holds (a dense
//    pillar, tens to thousands of points) is a piece of its own: each
//    worker owns up to 6 of its columns and adds the run's sub-pieces in
//    order in registers.
// The Pallas one-hot matmuls, 3-slot DMA rotation and 128-lane slab are TPU
// devices and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int_div.cuh"

namespace {

using int_div::Divisor;
using int_div::div_by;
using int_div::divisor;

constexpr int THREADS = 256;
constexpr int SEARCH_WARPS = 2;           // warps 0 and 1: the next tile's bounds
constexpr int WORKERS = THREADS - 32 * SEARCH_WARPS;   // the rest write the tile
constexpr int TILE_BYTES = 24576;         // a tile's output, composed in shared memory
constexpr int MAX_TILE_ROWS = 256;
constexpr int STAGE_BYTES = 12288;        // features staged at a time
constexpr int MIN_BLOCKS = 5;             // CTAs an SM: at most 48 registers
// the widest row: each worker owns up to 6 columns of a dense row
constexpr int MAX_COLS = 1024;
constexpr int COLS_PER_WORKER = (MAX_COLS + WORKERS - 1) / WORKERS;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even
}

// The first j in [lo, hi) with ids[j] >= key, or hi: a 32-way search by one
// warp, for ids on which "ids[j] < key" holds on a prefix of [lo, hi).  Lane
// l probes q_l = lo + (l+1)·len/32 − 1 (q_31 = hi − 1; probes below lo count
// as "< key"); the answer lies in (q_{c−1}, q_c] for the c lanes that see
// "< key".  Each round cuts the range 32-fold; every lane ends with it.
__device__ int warp_lower_bound(const int* __restrict__ ids, int lo, int hi, int key,
                                int lane) {
  while (lo < hi) {
    const long long len = hi - lo;
    const int q = lo + (int)((lane + 1) * len / 32) - 1;
    const bool below = q < lo || __ldg(ids + q) < key;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    if (c == 32) return hi;
    const int next_lo = lo + (int)(c * len / 32);
    hi = lo + (int)((c + 1) * len / 32) - 1;
    lo = next_lo;
  }
  return lo;
}

// a[e] += the e-th element of a 16-byte vector of T
__device__ __forceinline__ void add_vector(float (&a)[4], uint4 x) {
  a[0] += __uint_as_float(x.x);
  a[1] += __uint_as_float(x.y);
  a[2] += __uint_as_float(x.z);
  a[3] += __uint_as_float(x.w);
}
__device__ __forceinline__ void add_vector(float (&a)[8], uint4 x) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a[2 * q] += __uint_as_float(w[q] << 16);          // bf16 → f32: the high half
    a[2 * q + 1] += __uint_as_float(w[q] & 0xffff0000u);
  }
}
template <typename T> __device__ __forceinline__ uint4 pack_vector(const float (&a)[16 / sizeof(T)]);
template <> __device__ __forceinline__ uint4 pack_vector<float>(const float (&a)[4]) {
  return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]),
                    __float_as_uint(a[3]));
}
template <> __device__ __forceinline__ uint4 pack_vector<__nv_bfloat16>(const float (&a)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(a[2 * q])) |
           (uint32_t)__bfloat16_as_ushort(__float2bfloat16(a[2 * q + 1])) << 16;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Copy points [q0, q1) of the tile (starting at point p0) into the stage
// as the 16-byte vectors that cover their bytes, with the worker threads;
// returns where point q0 lies in the stage.
template <typename T>
__device__ __forceinline__ const T* stage_points(const T* __restrict__ feats, unsigned cols,
                                                 int p0, int q0, int q1,
                                                 unsigned char* stage, int wt) {
  const uintptr_t a0 = (uintptr_t)(feats + (size_t)(p0 + q0) * cols);
  const uintptr_t a1 = (uintptr_t)(feats + (size_t)(p0 + q1) * cols);
  const uint4* src = reinterpret_cast<const uint4*>(a0 & ~(uintptr_t)15);
  const int nvec = (int)((((a1 + 15) & ~(uintptr_t)15) - (a0 & ~(uintptr_t)15)) / 16);
  for (int v = wt; v < nvec; v += WORKERS)
    reinterpret_cast<uint4*>(stage)[v] = __ldg(src + v);
  return reinterpret_cast<const T*>(stage + (a0 & 15));
}

// The worker warps' own barrier (the search warps go on meanwhile).
__device__ __forceinline__ void workers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(WORKERS) : "memory");
}

struct Tile {
  int b, r0, r1;      // its sample and rows [r0, r1)
};

__device__ __forceinline__ Tile tile_at(int t, int s_per, int tiles_per, int tile_rows) {
  const int b = t / tiles_per;
  const int r0 = b * s_per + (t - b * tiles_per) * tile_rows;
  return {b, r0, min(r0 + tile_rows, (b + 1) * s_per)};
}

// Shared memory of one CTA.
struct Smem {
  int run_begin[MAX_TILE_ROWS], run_end[MAX_TILE_ROWS], runs[MAX_TILE_ROWS];
  int span[2][2], num_runs;
  __align__(16) unsigned char stage[STAGE_BYTES];
  __align__(16) unsigned char tile[TILE_BYTES];
};

// The worker threads (wt in [0, WORKERS)) write tile `tl`, whose points
// are [p0, p1).
template <typename T>
__device__ void write_tile(Smem& sm, const T* __restrict__ feats, const int* __restrict__ ids,
                           Tile tl, int p0, int p1, int piece_pts, unsigned cols,
                           Divisor groups, T* __restrict__ out, int wt) {
  constexpr int G = 16 / sizeof(T);               // the elements of a 16-byte vector
  // rows of whole vectors keep every row 16-byte aligned in the stage and
  // the tile (feats and out are 16-byte aligned)
  const bool whole_vectors = cols % G == 0;
  const int r0 = tl.r0, r1 = tl.r1, np = max(p1 - p0, 0);
  // the tile's output bytes [o_lo, o_hi), counted from `base`, the 16-byte
  // boundary of out at or below row r0 (a 64-bit address: the table may
  // pass 2^31 bytes), and held in `tile` from there
  const size_t r0_byte = (size_t)r0 * cols * sizeof(T);
  unsigned char* base = reinterpret_cast<unsigned char*>(out) + (r0_byte & ~(size_t)15);
  const unsigned o_lo = (unsigned)(r0_byte & 15);
  const unsigned o_hi = o_lo + (unsigned)(r1 - r0) * cols * sizeof(T);
  T* tile_out = reinterpret_cast<T*>(sm.tile + o_lo);               // row r0's first element
  for (int r = wt; r < r1 - r0; r += WORKERS) sm.run_begin[r] = sm.run_end[r] = 0;
  for (unsigned v = wt; v < (o_hi + 15) / 16; v += WORKERS)
    reinterpret_cast<uint4*>(sm.tile)[v] = make_uint4(0u, 0u, 0u, 0u);
  if (wt == 0) sm.num_runs = 0;
  workers_sync();

  // each occupied row's run, relative to p0 (the first and the last point
  // of a run are its only writers), and the list of occupied rows (in any
  // order: each row's sum is its own), beside the first piece's staging
  for (int j = wt; j < np; j += WORKERS) {
    const int id = __ldg(ids + p0 + j);
    const int r = id - r0;
    if (r < 0 || r >= r1 - r0) continue;        // never, for a plan as above
    if (j == 0 || __ldg(ids + p0 + j - 1) != id) {
      sm.run_begin[r] = j;
      sm.runs[atomicAdd(&sm.num_runs, 1)] = r;
    }
    if (j == np - 1 || __ldg(ids + p0 + j + 1) != id) sm.run_end[r] = j + 1;
  }
  const T* staged =
      np > 0 ? stage_points(feats, cols, p0, 0, min(np, piece_pts), sm.stage, wt) : nullptr;
  workers_sync();

  // Pieces of whole rows [ra, rb) whose points [q0, q1) fit the stage, cut
  // at the first row that does not fit.  A row with more points than the
  // stage holds is a piece of its own, summed by column owners over
  // sub-pieces of its run.
  int q0 = 0, ra = r0;
  while (q0 < np) {
    if (q0 > 0) {
      workers_sync();                             // the last piece is read
      staged = stage_points(feats, cols, p0, q0, min(np, q0 + piece_pts), sm.stage, wt);
      workers_sync();
    }
    int q1 = np, rb = r1;
    if (q0 + piece_pts < np) {
      const int row = __ldg(ids + p0 + q0 + piece_pts) - r0;   // the first that does not fit
      q1 = sm.run_begin[row];
      rb = r0 + row;
      if (q1 == q0) {                             // one row past the stage
        q1 = sm.run_end[row];
        rb = q1 == np ? r1 : __ldg(ids + p0 + q1);
        float acc[COLS_PER_WORKER];
#pragma unroll
        for (int m = 0; m < COLS_PER_WORKER; ++m) acc[m] = 0.f;
        for (int sq = q0; sq < q1; sq += piece_pts) {
          const int sq1 = min(q1, sq + piece_pts);
          if (sq > q0) {
            workers_sync();
            staged = stage_points(feats, cols, p0, sq, sq1, sm.stage, wt);
            workers_sync();
          }
#pragma unroll
          for (int m = 0; m < COLS_PER_WORKER; ++m) {
            const unsigned col = wt + m * WORKERS;
            if (col < cols)
              for (int j = 0; j < sq1 - sq; ++j) acc[m] += to_f32(staged[j * cols + col]);
          }
        }
#pragma unroll
        for (int m = 0; m < COLS_PER_WORKER; ++m)
          if (wt + m * WORKERS < cols)
            tile_out[row * cols + wt + m * WORKERS] = from_f32<T>(acc[m]);
        q0 = q1;
        ra = rb;
        continue;
      }
    }
    // every (occupied row of the piece, group of G columns): its run in
    // point order, one 16-byte vector a point where rows are whole vectors
    const unsigned items = (unsigned)sm.num_runs * groups.d;
    for (unsigned k = wt; k < items; k += WORKERS) {
      const unsigned i = div_by(k, groups), col = (k - i * groups.d) * G;
      const int r = sm.runs[i];
      if (r0 + r < ra || r0 + r >= rb) continue;
      const int jb = sm.run_begin[r], je = sm.run_end[r];
      float a[G];
#pragma unroll
      for (int e = 0; e < G; ++e) a[e] = 0.f;
      if (whole_vectors) {
        for (int j = jb; j < je; ++j)
          add_vector(a, *reinterpret_cast<const uint4*>(staged + (j - q0) * cols + col));
        *reinterpret_cast<uint4*>(tile_out + r * cols + col) = pack_vector<T>(a);
      } else {
        for (int j = jb; j < je; ++j)
#pragma unroll
          for (int e = 0; e < G; ++e)
            if (col + e < cols) a[e] += to_f32(staged[(j - q0) * cols + col + e]);
#pragma unroll
        for (int e = 0; e < G; ++e)
          if (col + e < cols) tile_out[r * cols + col + e] = from_f32<T>(a[e]);
      }
    }
    q0 = q1;
    ra = rb;
  }
  workers_sync();

  // the tile to out, 16 bytes at a time; the end vectors, which rows of
  // the neighbouring tiles share, element by element
  for (unsigned v = wt; v * 16 < o_hi; v += WORKERS) {
    const unsigned o = v * 16;
    if (o >= o_lo && o + 16 <= o_hi) {
      *reinterpret_cast<uint4*>(base + o) = reinterpret_cast<const uint4*>(sm.tile)[v];
    } else {
      for (unsigned e = max(o, o_lo); e < min(o + 16, o_hi); e += sizeof(T))
        *reinterpret_cast<T*>(base + e) = *reinterpret_cast<const T*>(sm.tile + e);
    }
  }
}

// A persistent CTA takes tiles blockIdx.x, + gridDim.x, ...: the search
// warps find the next tile's points while the workers write this one.
// Byte offsets within a tile are 32-bit, its base and the features' rows
// 64-bit; N and S are below 2^31 (int), C at most MAX_COLS.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
segment_sum_kernel(const T* __restrict__ feats, const int* __restrict__ ids,
                   int n_per, int s_per, int tiles_per, int num_tiles, int tile_rows,
                   int piece_pts, unsigned cols, Divisor groups, T* __restrict__ out) {
  __shared__ Smem sm;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto search = [&](int t, int slot) {             // by the search warps
    const Tile tl = tile_at(t, s_per, tiles_per, tile_rows);
    const int x = warp_lower_bound(ids, tl.b * n_per, (tl.b + 1) * n_per,
                                   warp ? tl.r1 : tl.r0, lane);
    if (lane == 0) sm.span[slot][warp] = x;
  };
  int t = blockIdx.x;
  if (warp < SEARCH_WARPS) search(t, 0);
  __syncthreads();
  for (int it = 0; t < num_tiles; ++it, t += gridDim.x) {
    const int slot = it & 1;
    if (warp < SEARCH_WARPS) {
      if (t + (int)gridDim.x < num_tiles) search(t + gridDim.x, slot ^ 1);
    } else {
      write_tile(sm, feats, ids, tile_at(t, s_per, tiles_per, tile_rows), sm.span[slot][0],
                 sm.span[slot][1], piece_pts, cols, groups, out,
                 (int)threadIdx.x - 32 * SEARCH_WARPS);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// The widest row (columns) the kernel takes.
int segment_sum_max_cols() { return MAX_COLS; }

// feats [n, c] (f32 or bf16 per is_bf16, 16-byte aligned), ids [n] int32,
// out [s, c] same dtype, 16-byte aligned; `samples` divides n and s; c at
// most segment_sum_max_cols().
int segment_sum(const void* feats, const int* ids, int n, int c, int s, int samples,
                void* out, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int row_bytes = c * (is_bf16 ? 2 : 4);
  if (samples < 1 || n < 0 || s < 0 || n % samples || s % samples || c < 0 || c > MAX_COLS)
    return (int)cudaErrorInvalidValue;
  if (s == 0 || c == 0) return (int)cudaGetLastError();
  // a tile's (a piece's) bytes leave room for the 16-byte vectors at its
  // ends that are only partly its own
  const int tile_rows = min(MAX_TILE_ROWS, (TILE_BYTES - 32) / row_bytes);
  const int piece_pts = (STAGE_BYTES - 32) / row_bytes;
  const int s_per = s / samples, n_per = n / samples;
  const int tiles_per = (s_per + tile_rows - 1) / tile_rows;
  const int num_tiles = samples * tiles_per;   // at most s
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int blocks = min(num_tiles, sms * MIN_BLOCKS);   // persistent: one wave
  if (is_bf16)
    segment_sum_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        (const __nv_bfloat16*)feats, ids, n_per, s_per, tiles_per, num_tiles, tile_rows,
        piece_pts, (unsigned)c, divisor((unsigned)(c + 7) / 8), (__nv_bfloat16*)out);
  else
    segment_sum_kernel<float><<<blocks, THREADS, 0, st>>>(
        (const float*)feats, ids, n_per, s_per, tiles_per, num_tiles, tile_rows, piece_pts,
        (unsigned)c, divisor((unsigned)(c + 3) / 4), (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
