// Cell sweep: grid nearest neighbour over two cell-sorted clouds.  For each
// sorted query row r (chunk k = r / CHUNK_Q) it scans the candidate blocks
// of the chunk's three ring-row windows, window 0 first, blocks ascending,
// and keeps the running (min d, its candidate's orig row) over all
// candidates and, with `dual`, over the flagged candidates only:
//   d = (dx*dx + dy*dy) + dz*dz  (+ dw*dw on dirty chunks),
//   d_flag = d + fpen, fpen in {0, 3e38}.
// Within one block, among the rows whose d equals the block minimum, the
// largest orig row wins; a later block replaces the carried pair only when
// its minimum is strictly smaller.  No candidate: (3e38, -1).
//
// Replaces: deflow_tpu/ops/pallas_sweep.py::cell_sweep_pallas (the Pallas
// kernel _make_kernel), reached from ops/chamfer.py _sweep_call by the SSL
// chamfer (both directions, dual) and the grid chamfer (dual off).
//
// Layout (the Pallas contract): q_slab [NQ_pad, 8] lanes (x, y, z, w, ...);
// c_slab [NCC, 8, CHUNK_C] coordinate-major planes (x, y, z, w, fpen, orig,
// 0, 0); cs, cn [NQ_pad / CHUNK_Q, 3] window block starts and counts; dirty
// [NQ_pad / CHUNK_Q]; out [NQ_pad, 8] lanes (d_all, i_all, d_flag, i_flag,
// 0, 0, 0, 0).
//
// Bound on the H100: f32 operations (not tensor cores), issued one per
// instruction: the contract rounds once per operation, so no FMA may fuse
// a product and a sum.  Every pair of a chunk's query and a visited
// candidate costs 8 operations for d (11 on dirty chunks) and a compare; a
// flagged candidate one more add and compare.  The slabs are a few MB.
//
// Design.  The rule across blocks is an ordered, associative merge: the
// result is the lexicographic minimum of (block minimum, position of the
// block in the chunk's list) over the chunk's blocks, with the orig row of
// that block, or (3e38, -1) when that minimum is not below 3e38.  So a
// chunk's block list can be cut anywhere at block boundaries and the pieces
// swept by different CTAs in any order:
// - cell_sweep_plan (one CTA) counts each chunk's valid blocks, cuts the
//   list into pieces of at most piece_blocks blocks (one empty piece for a
//   chunk with none), writes the exclusive prefix of the piece counts, and zeroes
//   the work counter and the per-chunk arrival counters and locks.
// - cell_sweep_main runs as many CTAs as fit on the card.  Each takes the
//   next piece from the work counter (atomicAdd), finds its chunk by binary
//   search in the prefix, and sweeps the piece's blocks for the chunk's
//   256 queries.  Its 256 threads hold two queries each (rows t and t + 128
//   of the chunk) and split every staged block in two halves of candidates
//   (warps 0-3 and 4-7), so each shared-memory read serves two queries.
//   Each half carries its own (min, block position, orig) through the
//   piece; the halves merge at the end (same block: the larger orig).
// - The piece's partial then merges into the chunk's rows of `out` under
//   the chunk's lock, lexicographically on (d, block position); lanes 4 and
//   5 carry the positions meanwhile.  The last piece of a chunk to arrive
//   applies the (3e38, -1) rule, zeroes lanes 4-7 and resets the chunk's
//   arrival counter, so a replayed CUDA graph finds it at zero again.
// The straddling chunk of a hosted two-sample cloud (29 blocks) and the
// long chunks of a skewed cloud are spread over many CTAs instead of
// setting the launch's length.
//
// Each staged block is held in shared memory as float4 (x, y, z, w) and a
// rank of each orig row.  The all lane keeps its block minimum as one
// 64-bit key, d's bits above the rank, so the in-block rule (least d, then
// largest orig) is one unsigned compare and two selects a pair.  With
// `dual` the flagged rows (fpen below 3e38) are also packed into a second
// list (warp ballots), and the flag lane visits only those:
// d + fpen on any other row is at least 3e38, never strictly below the
// carried 3e38, so such a row never decides an output.  Clean chunks (the
// caller proved every window row is the query's own sample or carries the
// +-2e19 sentinel coordinates) skip the w term, as the Pallas kernel does.
// The distance is spelled out with __fsub_rn / __fmul_rn / __fadd_rn so that
// nvcc does not contract it into FMAs: the kernel then rounds exactly as
// the plain PyTorch version and the output is bit-identical to it.  The
// Pallas 3-slot DMA rotation and scalar-prefetched window tables are TPU
// devices and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK_Q = 256;   // queries per chunk
constexpr int CHUNK_C = 512;   // candidate rows per staged block
constexpr int LANES = 8;
constexpr int THREADS = 256;   // 2 queries x 2 candidate halves a thread pair
constexpr int HALF = CHUNK_Q / 2;
constexpr int PLAN_THREADS = 1024;
constexpr float BIG = 3.0e38f;
constexpr float NO_POS = 3.0e38f;   // block position of an empty partial

// Workspace (int32): [0] work counter, [1, nchunks + 2) piece prefix,
// then nchunks arrival counters and nchunks locks.
__host__ __device__ inline int* ws_off(int* ws) { return ws + 1; }
__host__ __device__ inline int* ws_cnt(int* ws, int nchunks) { return ws + nchunks + 2; }
__host__ __device__ inline int* ws_lock(int* ws, int nchunks) { return ws + 2 * nchunks + 2; }

// The valid part [lo, lo + len) of window j of chunk k.
__device__ __forceinline__ void window(const int* cs, const int* cn, int k, int j,
                                       int ncc, int& lo, int& len) {
  const long long c0 = cs[3 * k + j];
  const long long c1 = c0 + cn[3 * k + j];
  const long long a = c0 < 0 ? 0 : c0;
  const long long b = c1 > ncc ? ncc : c1;
  lo = (int)a;
  len = b > a ? (int)(b - a) : 0;
}

// The in-block rule, branch-free: a smaller d takes its orig row, an equal
// d the larger one (orig rows are >= -1, so fmaxf(-1, orig) = orig).
__device__ __forceinline__ void keep_min(float d, float orig, float& m, float& i) {
  const float base = d < m ? -1.f : i;
  i = d <= m ? fmaxf(base, orig) : i;
  m = fminf(m, d);
}

// The same rule on one 64-bit key: d's bits above (d >= 0, so they order
// as d does) and a rank that falls as the orig row grows; the all lane's
// minimum is then one unsigned compare and two selects a pair.
__device__ __forceinline__ unsigned rank_of(float orig) {
  return 0x7fffffffu - (unsigned)(int)orig;
}
__device__ __forceinline__ unsigned long long pack(float d, unsigned rank) {
  return ((unsigned long long)__float_as_uint(d) << 32) | rank;
}
__device__ __forceinline__ float unpack_d(unsigned long long key) {
  return __uint_as_float((unsigned)(key >> 32));
}
__device__ __forceinline__ float unpack_orig(unsigned long long key) {
  return (float)(int)(0x7fffffffu - (unsigned)key);
}

// (m, p, i) <- the lexicographic minimum of itself and (m2, p2, i2) on
// (d, block position); the same block: the larger orig row.
__device__ __forceinline__ void lex_merge(float& m, float& p, float& i,
                                          float m2, float p2, float i2) {
  if (m2 < m || (m2 == m && (p2 < p || (p2 == p && i2 > i)))) {
    m = m2;
    p = p2;
    i = i2;
  }
}

__global__ void __launch_bounds__(PLAN_THREADS)
cell_sweep_plan(const int* __restrict__ cs, const int* __restrict__ cn,
                int nchunks, int ncc, int piece_blocks, int* __restrict__ ws) {
  __shared__ int s_warp[PLAN_THREADS / 32];
  __shared__ int s_carry;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  int* off = ws_off(ws);
  int* cnt = ws_cnt(ws, nchunks);
  int* lock = ws_lock(ws, nchunks);
  if (t == 0) {
    s_carry = 0;
    ws[0] = 0;
  }
  __syncthreads();
  for (int base = 0; base < nchunks; base += PLAN_THREADS) {
    const int k = base + t;
    int pieces = 0;
    if (k < nchunks) {
      int nb = 0;
      for (int j = 0; j < 3; ++j) {
        int lo, len;
        window(cs, cn, k, j, ncc, lo, len);
        nb += len;
      }
      pieces = nb > 0 ? (nb + piece_blocks - 1) / piece_blocks : 1;
      cnt[k] = 0;
      lock[k] = 0;
    }
    int incl = pieces;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_warp[w] = incl;
    __syncthreads();
    if (w == 0) {
      int x = s_warp[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += v;
      }
      s_warp[lane] = x;   // inclusive prefix of the warp totals
    }
    __syncthreads();
    const int carry = s_carry;
    const int before = (w > 0 ? s_warp[w - 1] : 0) + incl - pieces;
    if (k < nchunks) off[k] = carry + before;
    __syncthreads();
    if (t == PLAN_THREADS - 1) s_carry = carry + s_warp[PLAN_THREADS / 32 - 1];
    __syncthreads();
  }
  if (t == 0) off[nchunks] = s_carry;
}

struct Query {
  float x, y, z, w;
};

template <bool WITH_W>
__device__ __forceinline__ float dist(const Query& q, const float4& v) {
  const float dx = __fsub_rn(q.x, v.x);
  const float dy = __fsub_rn(q.y, v.y);
  const float dz = __fsub_rn(q.z, v.z);
  float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                      __fmul_rn(dz, dz));
  if (WITH_W) {
    const float dw = __fsub_rn(q.w, v.w);
    d = __fadd_rn(d, __fmul_rn(dw, dw));
  }
  return d;
}

struct Shared {
  float4 xyzw[CHUNK_C];    // the staged block, all rows
  unsigned rank[CHUNK_C];  // rank_of(orig)
  float4 fxyzw[CHUNK_C];   // its flagged rows, packed
  float2 ffo[CHUNK_C];     // (fpen, orig) of the flagged rows
  int nflag;
};

// One staged block for this thread's two queries and candidate half h:
// block minima (all lane, and flag lane when dual) with the in-block tie rule.
template <bool WITH_W>
__device__ __forceinline__ void sweep_block(const Shared& s, const Query (&q)[2],
                                            int h, bool dual, int nflag,
                                            unsigned long long (&ka)[2],
                                            float (&mf)[2], float (&jf)[2]) {
  const int c0 = h * (CHUNK_C / 2);
#pragma unroll 4
  for (int c = c0; c < c0 + CHUNK_C / 2; ++c) {
    const float4 v = s.xyzw[c];
    const unsigned rk = s.rank[c];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const unsigned long long key = pack(dist<WITH_W>(q[r], v), rk);
      ka[r] = key < ka[r] ? key : ka[r];
    }
  }
  if (!dual) return;
  const int mid = (nflag + 1) / 2;
  const int f0 = h ? mid : 0, f1 = h ? nflag : mid;
#pragma unroll 2
  for (int c = f0; c < f1; ++c) {
    const float4 v = s.fxyzw[c];
    const float2 fo = s.ffo[c];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      keep_min(__fadd_rn(dist<WITH_W>(q[r], v), fo.x), fo.y, mf[r], jf[r]);
  }
}

__global__ void __launch_bounds__(THREADS)
cell_sweep_main(const float* __restrict__ q_slab, const float* __restrict__ c_slab,
                const int* __restrict__ cs, const int* __restrict__ cn,
                const int* __restrict__ dirty, int nchunks, int ncc, int dual,
                int piece_blocks, int* __restrict__ ws, float* __restrict__ out) {
  __shared__ Shared s;
  __shared__ float s_part[2][3][CHUNK_Q];   // lane (all, flag) x (m, pos, orig)
  __shared__ int s_piece, s_chunk, s_arrived, s_last;
  const int t = threadIdx.x;
  const int h = t / HALF;           // candidate half: warps 0-3, 4-7
  const int qi = t % HALF;          // queries qi and qi + HALF of the chunk
  const int* off = ws_off(ws);
  int* cnt = ws_cnt(ws, nchunks);
  int* lock = ws_lock(ws, nchunks);
  const int total = off[nchunks];
  const float inf = __int_as_float(0x7f800000);
  const unsigned long long empty = pack(inf, rank_of(-1.f));

  while (true) {
    if (t == 0) {
      const int g = atomicAdd(ws, 1);
      int k = 0;
      if (g < total) {      // the last chunk whose first piece is <= g
        int lo = 0, hi = nchunks - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (off[mid] <= g) lo = mid; else hi = mid - 1;
        }
        k = lo;
      }
      s_piece = g;
      s_chunk = k;
    }
    __syncthreads();
    const int g = s_piece, k = s_chunk;
    if (g >= total) break;
    const int first = (g - off[k]) * piece_blocks;   // list position
    const bool with_w = dirty[k] > 0;
    Query q[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(
          q_slab + ((long long)k * CHUNK_Q + qi + r * HALF) * LANES);
      q[r] = {v.x, v.y, v.z, v.w};
    }
    // carried through the piece by this half: (min, block position, orig)
    float cma[2] = {inf, inf}, cpa[2] = {NO_POS, NO_POS}, cia[2] = {-1.f, -1.f};
    float cmf[2] = {inf, inf}, cpf[2] = {NO_POS, NO_POS}, cif[2] = {-1.f, -1.f};

    int pos = 0;
    for (int j = 0; j < 3; ++j) {
      int lo, len;
      window(cs, cn, k, j, ncc, lo, len);
      const int a = max(first - pos, 0);
      const int b = min(first + piece_blocks - pos, len);
      for (int e = a; e < b; ++e) {
        const long long blk = (long long)lo + e;
        const float* cb = c_slab + blk * LANES * CHUNK_C;
        __syncthreads();                       // the last block is consumed
        if (t == 0) s.nflag = 0;
        __syncthreads();
        for (int r = t; r < CHUNK_C; r += THREADS) {
          const float4 v = make_float4(cb[r], cb[CHUNK_C + r], cb[2 * CHUNK_C + r],
                                       cb[3 * CHUNK_C + r]);
          const float fpen = cb[4 * CHUNK_C + r], o = cb[5 * CHUNK_C + r];
          s.xyzw[r] = v;
          s.rank[r] = rank_of(o);
          if (dual) {
            const bool flagged = fpen < BIG;
            const unsigned ball = __ballot_sync(0xffffffffu, flagged);
            int base = 0;
            if ((t & 31) == 0 && ball) base = atomicAdd(&s.nflag, __popc(ball));
            base = __shfl_sync(0xffffffffu, base, 0);
            if (flagged) {
              const int slot = base + __popc(ball & ((1u << (t & 31)) - 1u));
              s.fxyzw[slot] = v;
              s.ffo[slot] = make_float2(fpen, o);
            }
          }
        }
        __syncthreads();
        const int nflag = s.nflag;
        unsigned long long ka[2] = {empty, empty};
        float mf[2] = {inf, inf}, jf[2] = {-1.f, -1.f};
        if (with_w)
          sweep_block<true>(s, q, h, dual, nflag, ka, mf, jf);
        else
          sweep_block<false>(s, q, h, dual, nflag, ka, mf, jf);
        const float p = (float)(pos + e);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float ma = unpack_d(ka[r]);
          if (ma < cma[r]) { cma[r] = ma; cpa[r] = p; cia[r] = unpack_orig(ka[r]); }
          if (mf[r] < cmf[r]) { cmf[r] = mf[r]; cpf[r] = p; cif[r] = jf[r]; }
        }
      }
      pos += len;
    }

    // the two halves merge: half 1 hands its partials to half 0
    if (h == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qi + r * HALF;
        s_part[0][0][row] = cma[r]; s_part[0][1][row] = cpa[r]; s_part[0][2][row] = cia[r];
        s_part[1][0][row] = cmf[r]; s_part[1][1][row] = cpf[r]; s_part[1][2][row] = cif[r];
      }
    }
    __syncthreads();
    if (h == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qi + r * HALF;
        lex_merge(cma[r], cpa[r], cia[r], s_part[0][0][row], s_part[0][1][row],
                  s_part[0][2][row]);
        lex_merge(cmf[r], cpf[r], cif[r], s_part[1][0][row], s_part[1][1][row],
                  s_part[1][2][row]);
        s_part[0][0][row] = cma[r]; s_part[0][1][row] = cpa[r]; s_part[0][2][row] = cia[r];
        s_part[1][0][row] = cmf[r]; s_part[1][1][row] = cpf[r]; s_part[1][2][row] = cif[r];
      }
    }

    // the piece's partial into the chunk's rows, under the chunk's lock
    if (t == 0) {
      while (atomicCAS(lock + k, 0, 1) != 0) __nanosleep(32);
      __threadfence();
      const int a = *(volatile int*)(cnt + k);
      const int pieces = off[k + 1] - off[k];
      const bool last = a + 1 == pieces;
      *(volatile int*)(cnt + k) = last ? 0 : a + 1;
      s_arrived = a;
      s_last = last;
    }
    __syncthreads();
    {
      float m0 = s_part[0][0][t], p0 = s_part[0][1][t], i0 = s_part[0][2][t];
      float m1 = s_part[1][0][t], p1 = s_part[1][1][t], i1 = s_part[1][2][t];
      float4* o = reinterpret_cast<float4*>(out + ((long long)k * CHUNK_Q + t) * LANES);
      if (s_arrived > 0) {
        const float4 v = __ldcg(o), w = __ldcg(o + 1);
        lex_merge(m0, p0, i0, v.x, w.x, v.y);
        lex_merge(m1, p1, i1, v.z, w.y, v.w);
      }
      if (s_last) {
        if (!(m0 < BIG)) { m0 = BIG; i0 = -1.f; }
        if (!(m1 < BIG)) { m1 = BIG; i1 = -1.f; }
        __stcg(o, make_float4(m0, i0, m1, i1));
        __stcg(o + 1, make_float4(0.f, 0.f, 0.f, 0.f));
      } else {
        __stcg(o, make_float4(m0, i0, m1, i1));
        __stcg(o + 1, make_float4(p0, p1, 0.f, 0.f));
      }
    }
    __threadfence();
    __syncthreads();
    if (t == 0) atomicExch(lock + k, 0);
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// Int32 workspace entries the caller allocates for nq_chunks chunks.
int cell_sweep_workspace(int nq_chunks) { return 3 * nq_chunks + 2; }

// q_slab [nq_chunks * 256, 8] f32, c_slab [ncc, 8, 512] f32, cs/cn
// [nq_chunks, 3] int32, dirty [nq_chunks] int32, ws [cell_sweep_workspace]
// int32 (any contents), out [nq_chunks * 256, 8].  Two launches, no host
// synchronisation.
int cell_sweep(const float* q_slab, const float* c_slab, const int* cs,
               const int* cn, const int* dirty, int nq_chunks, int ncc,
               int dual, int piece_blocks, int* ws, float* out, void* stream) {
  if (nq_chunks == 0) return (int)cudaGetLastError();
  if (piece_blocks < 1) return (int)cudaErrorInvalidValue;
  static int grid[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cell_sweep_main,
                                                        THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    grid[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const cudaStream_t st = (cudaStream_t)stream;
  cell_sweep_plan<<<1, PLAN_THREADS, 0, st>>>(cs, cn, nq_chunks, ncc, piece_blocks, ws);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // at most one CTA a piece: a chunk has at most ncc blocks
  const long long most = (long long)nq_chunks * ((ncc + piece_blocks - 1) / piece_blocks + 1);
  const int g = (int)(most < grid[dev] ? most : grid[dev]);
  cell_sweep_main<<<g, THREADS, 0, st>>>(q_slab, c_slab, cs, cn, dirty, nq_chunks,
                                         ncc, dual, piece_blocks, ws, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
