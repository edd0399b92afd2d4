// Lane segment-sum: out[s, l] = sum of rows[i, l] over the rows i with
// ids[i] == s, for s in [0, S) and l < L <= 7 f32 lanes.  Ids arrive
// ascending, so each segment's rows form one contiguous run; ids outside
// [0, S) (the sort's sentinel tail) add nothing.  Every output element is
// written once; empty segments are exact zeros.  Each segment is summed in
// f32 in row order, from its first row, so the result is deterministic and
// bit-identical to a serial sum (the plain version's on the CPU).
//
// Replaces: deflow_tpu/ops/pallas_scatter.py::segment_sum_lanes_pallas (the
// Pallas kernel _make_lane_kernel), reached from ops/chamfer.py
// _scatter_lanes_flat by the chamfer VJPs' mirror terms.
//
// Bound on the H100: bytes.  One pass reads the [N, L] rows and the [N] ids
// and writes the [S, L] table, one add per element.  On the SSL path
// (N = 393,216 rows of L = 4 lanes into S = 196,608 segments) that is
// ~11 MB, a few microseconds at 3.35 TB/s.
//
// Design: one launch, no memset, no atomics, no search.  One thread per row
// (a float4 when L = 4, coalesced across the warp), plus one virtual
// position N that closes the table; a warp takes SPANS spans of 32 rows,
// all their loads in flight together (one wave of CTAs on the SSL path).
//  - A warp sums its runs in row order: the run heads come from a ballot,
//    each lane's run start is the highest head at or below it, and in step
//    m the lane m rows past its head adds its row to its left neighbour's
//    partial (one shuffle a lane each step; as many steps as the warp's
//    longest run, none where every run is one row).  The last lane of a
//    run writes it.  A warp whose ids all lie outside [0, S) (the sort's
//    sentinel tail) stops after its gaps.  (A shuffle tree takes 5 steps,
//    but in another order, and one f32 ulp of a large sum shows in the
//    chamfer's gradient held against the CPU's.)
//  - A run that crosses a span's end is finished by the warp that holds
//    its head: it reads on past the span, from the registers of its next
//    span, then 32 rows a round (each lane's id and row in flight
//    together), adding the run's rows in order.  A span whose first rows
//    continue an earlier span's run leaves them alone.
//  - The thread at each position i zeroes the empty segments between the
//    previous id and its own (ids[i−1], ids[i]), the head gap before the
//    first id and, at position N, the tail gap up to S; gaps longer than
//    SMALL_GAP rows are zeroed by the whole warp with 16-byte stores.
// The Pallas [8, CHUNK] coordinate-major slab, its one-hot MXU contraction
// and the 3-slot DMA rotation are TPU devices and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMALL_GAP = 8;         // rows a thread zeroes on its own
constexpr int SPANS = 2;             // 32-row spans a warp takes
constexpr unsigned FULL = 0xffffffffu;

template <int L, bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ rows, long long i,
                                         float (&v)[L]) {
  if constexpr (VEC) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(rows) + i);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) v[l] = __ldg(rows + i * L + l);
  }
}

template <int L, bool VEC>
__device__ __forceinline__ void store_row(float* __restrict__ out, long long r,
                                          const float (&v)[L]) {
  if constexpr (VEC) {
    reinterpret_cast<float4*>(out)[r] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) out[r * L + l] = v[l];
  }
}

// Zero out[f0, f1) (floats) with the warp's 32 lanes: scalars up to the
// first 16-byte boundary and after the last, float4s between.
__device__ __forceinline__ void warp_zero(float* __restrict__ out, long long f0,
                                          long long f1, int lane) {
  const long long v0 = (f0 + 3) / 4, v1 = f1 / 4;
  if (v0 >= v1) {
    for (long long f = f0 + lane; f < f1; f += 32) out[f] = 0.f;
    return;
  }
  if (f0 + lane < v0 * 4) out[f0 + lane] = 0.f;
  if (v1 * 4 + lane < f1) out[v1 * 4 + lane] = 0.f;
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long k = v0 + lane; k < v1; k += 32) o4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// One warp's 32 positions from `base` (lane's position i = base + lane),
// their ids, rows and neighbouring ids loaded, and (`has_after`) the next
// 32 positions' ids and rows.
template <int L, bool VEC>
__device__ __forceinline__ void sum_span(const float* __restrict__ rows,
                                         const int* __restrict__ ids, int n, int s,
                                         float* __restrict__ out, long long base, int lane,
                                         int id, float (&v)[L], int prev, int next,
                                         bool has_after, int id_after,
                                         const float (&v_after)[L]) {
  const long long i = base + lane;
  // the empty segments (prev, id), clamped to [0, s)
  const int g0 = min(max(prev, -1), s - 1) + 1, g1 = min(id, s);
  const bool gap = i <= n && g0 < g1;
  const bool big = gap && g1 - g0 > SMALL_GAP;
  if (gap && !big)
    for (int r = g0; r < g1; ++r) {
      const float z[L] = {};
      store_row<L, VEC>(out, r, z);
    }
  for (unsigned m = __ballot_sync(FULL, big); m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    const long long f0 = (long long)__shfl_sync(FULL, g0, src) * L;
    const long long f1 = (long long)__shfl_sync(FULL, g1, src) * L;
    warp_zero(out, f0, f1, lane);
  }

  const bool valid = id >= 0 && id < s;
  if (!__any_sync(FULL, valid)) return;           // the sentinel tail: nothing to sum
  // each run summed in row order, as a serial sum: the lane at offset m
  // from its run's head adds its row to the partial of the lane before it,
  // in step m (as many steps as the warp's longest run has rows past its head)
  const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != id);
  const int start = 31 - __clz(heads & (FULL >> (31 - lane)));
  const int offset = lane - start;
  const int steps = __reduce_max_sync(FULL, (unsigned)offset);
  for (int m = 1; m <= steps; ++m) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float t = __shfl_up_sync(FULL, v[l], 1);
      if (offset == m) v[l] = t + v[l];
    }
  }
  // the run at lane 0 began in an earlier warp: that warp sums it
  const bool lane0_continues = __shfl_sync(FULL, i > 0 && prev == id && valid, 0);
  const bool inherited = start == 0 && lane0_continues;
  // the run at lane 31 goes on past the warp: read on (warp-uniform)
  const bool read_on = __shfl_sync(FULL, valid && next == id && !inherited, 31);
  if (read_on) {
    const int run = __shfl_sync(FULL, id, 31);
    float acc[L];
#pragma unroll
    for (int l = 0; l < L; ++l) acc[l] = __shfl_sync(FULL, v[l], 31);
    long long pos = base + 32;
    if (has_after) {                              // the next span is in registers
      const int count = __popc(__ballot_sync(FULL, id_after == run));
      for (int u = 0; u < count; ++u)
#pragma unroll
        for (int l = 0; l < L; ++l) acc[l] += __shfl_sync(FULL, v_after[l], u);
      pos = count < 32 ? n : pos + 32;
    }
    for (; pos < n; pos += 32) {
      // the row loads beside its id (one round trip); the run's rows, a
      // prefix of the 32, are added in order
      const long long j = pos + lane;
      float part[L];
      bool in = j < n;
      if (in) {
        load_row<L, VEC>(rows, j, part);
        in = __ldg(ids + j) == run;
      }
      const int count = __popc(__ballot_sync(FULL, in));
      for (int u = 0; u < count; ++u)
#pragma unroll
        for (int l = 0; l < L; ++l) acc[l] += __shfl_sync(FULL, part[l], u);
      if (count < 32) break;
    }
    if (lane == 31)
#pragma unroll
      for (int l = 0; l < L; ++l) v[l] = acc[l];
  }
  if (valid && !inherited && (lane == 31 || next != id)) store_row<L, VEC>(out, id, v);
}

// Each warp takes SPANS consecutive spans of 32 positions (0..n, position
// n a virtual sentinel at s closing the table, later ones inert), all its
// loads in flight together.
template <int L, bool VEC>
__global__ void __launch_bounds__(THREADS)
lane_sum_kernel(const float* __restrict__ rows, const int* __restrict__ ids, int n, int s,
                float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const long long first = ((long long)blockIdx.x * THREADS + threadIdx.x - lane) * SPANS;
  int id[SPANS];
  float v[SPANS][L];
#pragma unroll
  for (int h = 0; h < SPANS; ++h) {
    const long long i = first + 32 * h + lane;
    id[h] = i < n ? __ldg(ids + i) : s;
    if (i < n) {
      load_row<L, VEC>(rows, i, v[h]);
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l) v[h][l] = 0.f;
    }
  }
  // the ids before the first and after the last position; between spans
  // they are the neighbouring span's end lanes
  const int id_before = first > 0 && first <= n ? __ldg(ids + first - 1) : -1;
  const long long last = first + 32 * SPANS - 1;
  const int id_beyond = last + 1 < n ? __ldg(ids + last + 1) : s;
#pragma unroll
  for (int h = 0; h < SPANS; ++h) {
    const int hb = h > 0 ? h - 1 : 0, ha = h + 1 < SPANS ? h + 1 : h;
    const int up = __shfl_up_sync(FULL, id[h], 1);
    const int down = __shfl_down_sync(FULL, id[h], 1);
    const int last_of_before = __shfl_sync(FULL, id[hb], 31);
    const int first_of_after = __shfl_sync(FULL, id[ha], 0);
    const int prev = lane > 0 ? up : h > 0 ? last_of_before : id_before;
    const int next = lane < 31 ? down : h + 1 < SPANS ? first_of_after : id_beyond;
    sum_span<L, VEC>(rows, ids, n, s, out, first + 32 * h, lane, id[h], v[h], prev, next,
                     h + 1 < SPANS, id[ha], v[ha]);
  }
}

template <int L>
int launch(const float* rows, const int* ids, int n, int s, float* out, cudaStream_t st) {
  // positions 0..n
  const int blocks = (int)(((long long)n + THREADS * SPANS) / (THREADS * SPANS));
  if (L == 4 && (uintptr_t)rows % 16 == 0 && (uintptr_t)out % 16 == 0)
    lane_sum_kernel<L, L == 4><<<blocks, THREADS, 0, st>>>(rows, ids, n, s, out);
  else
    lane_sum_kernel<L, false><<<blocks, THREADS, 0, st>>>(rows, ids, n, s, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// rows [n, lanes] f32, ids [n] int32 ascending, out [s, lanes] f32, 16-byte
// aligned; 1 <= lanes <= 7, n·lanes and s·lanes < 2^31.
int segment_sum_lanes(const float* rows, const int* ids, int n, int lanes, int s,
                      float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (s == 0) return (int)cudaGetLastError();
  switch (lanes) {
    case 1: return launch<1>(rows, ids, n, s, out, st);
    case 2: return launch<2>(rows, ids, n, s, out, st);
    case 3: return launch<3>(rows, ids, n, s, out, st);
    case 4: return launch<4>(rows, ids, n, s, out, st);
    case 5: return launch<5>(rows, ids, n, s, out, st);
    case 6: return launch<6>(rows, ids, n, s, out, st);
    case 7: return launch<7>(rows, ids, n, s, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
