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
// Bound on the H100: f32 operations (not tensor cores).  Every pair of a
// chunk's query and a visited candidate costs 8 flops for d, one add for
// the flag lane and a compare per reduced lane; the slabs themselves are a
// few MB.  On the SSL path (196,608 queries per direction) the windows visit
// a few blocks per chunk, some 10^9 pairs per launch.
//
// Design: one block per 256-query chunk, one thread per query.  Each
// 512-row candidate block is staged in shared memory as float4 (x, y, z, w)
// and float2 (fpen, orig), loaded plane by plane with neighbouring threads
// on neighbouring addresses; every thread then reads each candidate as a
// broadcast.  Clean chunks (the caller proved every window row is the
// query's own sample or carries the +-2e19 sentinel coordinates) skip the
// w term, as the Pallas kernel does.  The distance is spelled out with
// __fmul_rn / __fadd_rn so that nvcc does not contract it into FMAs: the
// kernel then rounds exactly as the plain PyTorch version (one rounding per
// operation) and the matched indices agree exactly.  The Pallas 3-slot DMA
// rotation and scalar-prefetched window tables are TPU devices and are not
// carried over: a block reads its own three windows.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK_Q = 256;   // queries per block (= threads)
constexpr int CHUNK_C = 512;   // candidate rows per staged block
constexpr int LANES = 8;
constexpr float BIG = 3.0e38f;

__device__ __forceinline__ void keep_min(float d, float orig, float& m, float& i) {
  if (d < m) {
    m = d;
    i = orig;
  } else if (d == m) {
    i = fmaxf(i, orig);
  }
}

__global__ void __launch_bounds__(CHUNK_Q)
cell_sweep_kernel(const float* __restrict__ q_slab, const float* __restrict__ c_slab,
                  const int* __restrict__ cs, const int* __restrict__ cn,
                  const int* __restrict__ dirty, int ncc, int dual,
                  float* __restrict__ out) {
  __shared__ float4 s_xyzw[CHUNK_C];
  __shared__ float2 s_fo[CHUNK_C];
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  const long long row = (long long)k * CHUNK_Q + t;
  const float* q = q_slab + row * LANES;
  const float qx = q[0], qy = q[1], qz = q[2], qw = q[3];
  const bool with_w = dirty[k] > 0;
  float ba = BIG, bia = -1.f, bf = BIG, bif = -1.f;

  for (int j = 0; j < 3; ++j) {
    const int c0 = cs[3 * k + j];
    const int nb = cn[3 * k + j];
    for (int blk = c0; blk < c0 + nb; ++blk) {
      if (blk < 0 || blk >= ncc) continue;       // uniform across the block
      const float* cb = c_slab + (long long)blk * LANES * CHUNK_C;
      __syncthreads();                           // the last block is consumed
      for (int e = t; e < CHUNK_C; e += CHUNK_Q) {
        s_xyzw[e] = make_float4(cb[e], cb[CHUNK_C + e], cb[2 * CHUNK_C + e],
                                cb[3 * CHUNK_C + e]);
        s_fo[e] = make_float2(cb[4 * CHUNK_C + e], cb[5 * CHUNK_C + e]);
      }
      __syncthreads();
      float ma = __int_as_float(0x7f800000), ia = -1.f;   // +inf
      float mf = ma, iff = -1.f;
      for (int c = 0; c < CHUNK_C; ++c) {
        const float4 v = s_xyzw[c];
        const float dx = __fsub_rn(qx, v.x);
        const float dy = __fsub_rn(qy, v.y);
        const float dz = __fsub_rn(qz, v.z);
        float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
        if (with_w) {
          const float dw = __fsub_rn(qw, v.w);
          d = __fadd_rn(d, __fmul_rn(dw, dw));
        }
        const float2 fo = s_fo[c];
        keep_min(d, fo.y, ma, ia);
        if (dual) keep_min(__fadd_rn(d, fo.x), fo.y, mf, iff);
      }
      if (ma < ba) { ba = ma; bia = ia; }
      if (dual && mf < bf) { bf = mf; bif = iff; }
    }
  }
  float* o = out + row * LANES;
  reinterpret_cast<float4*>(o)[0] = make_float4(ba, bia, bf, bif);
  reinterpret_cast<float4*>(o)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// q_slab [nq_chunks * 256, 8] f32, c_slab [ncc, 8, 512] f32, cs/cn
// [nq_chunks, 3] int32, dirty [nq_chunks] int32, out [nq_chunks * 256, 8].
int cell_sweep(const float* q_slab, const float* c_slab, const int* cs,
               const int* cn, const int* dirty, int nq_chunks, int ncc,
               int dual, float* out, void* stream) {
  if (nq_chunks == 0) return (int)cudaGetLastError();
  cell_sweep_kernel<<<nq_chunks, CHUNK_Q, 0, (cudaStream_t)stream>>>(
      q_slab, c_slab, cs, cn, dirty, ncc, dual, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
