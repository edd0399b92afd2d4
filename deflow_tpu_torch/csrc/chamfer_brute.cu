// Brute nearest neighbour: for each p row of each sample, the squared
// distance to the nearest q row of the same sample and its index,
//   d = (|p|^2 + |q|^2) - 2 * ((px*qx + py*qy) + pz*qz),
// with |v|^2 = (x*x + y*y) + z*z, masked q rows folded to the far sentinel
// (1e6, 1e6, 1e6), a strict < scan in q order from (3e38, 0) (ties go to
// the lower index) and the result clamped with max(d, 0).  With no q row at
// all: (3e38, 0).
//
// Replaces: deflow_tpu/ops/pallas_chamfer.py::_chamfer_min_single (the
// Pallas kernel _chamfer_kernel), reached from chamfer_min_pallas by the
// brute chamfer (ops/chamfer.py _nn_search, method "brute" and "auto" up
// to 16384^2 pairs).
//
// Bound on the H100: f32 operations (not tensor cores), issued one per
// instruction: the contract rounds once per operation, so no FMA may fuse
// a product and a sum.  Each (p, q) pair costs 9: 5 for the dot, the
// |p|^2 + |q|^2 add, the doubling, the subtract and the compare.  At
// 16,384 x 16,384 per sample that is 2.4 G operations.
//
// Design: q is cut into pieces of PIECE_Q rows, and p into tiles of
// THREADS * ROWS rows; one CTA sweeps one (p tile, sample, q piece), so
// 2 x 16,384 points give 256 CTAs, one wave of two an SM (16 warps), where
// one CTA per p tile gave 8 warps an SM.  The CTA stages its q piece once in shared
// memory as float4 (x, y, z, |q|^2), the mask folded in; each thread holds
// ROWS p rows, so each shared-memory read (a broadcast) serves ROWS pairs
// and each row's compare chain is independent of the others.  The piece's
// partial (unclamped d, index) goes to a scratch array; chamfer_brute_merge
// then takes the pieces of each row in q order with a strict <, which is the
// unsplit scan exactly (ties go to the lower piece, hence the lower index),
// and applies max(d, 0) once: clamping the partials first would turn two
// negative d's (the expanded formula cancels) into a tie that the lower
// piece wins.  The arithmetic is spelled out with __fmul_rn / __fadd_rn so
// that nvcc does not contract it into FMAs: the kernel then rounds exactly
// as the plain PyTorch version and the output is bit-identical to it.  The
// Pallas kernel keeps all of q resident in VMEM as an [8, M] slab and pads
// it to its 1024-row chunk with |q|^2 = 3e38; here a piece ends at M.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 8;               // p rows a thread
constexpr int TILE_P = THREADS * ROWS;
constexpr int PIECE_Q = 1024;         // q rows a CTA
constexpr int MERGE_THREADS = 256;
constexpr float FAR = 1.0e6f;
constexpr float BIG = 3.0e38f;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__global__ void __launch_bounds__(THREADS)
chamfer_brute_kernel(const float* __restrict__ p, const float* __restrict__ q,
                     const uint8_t* __restrict__ q_mask, int n, int m,
                     float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float4 tile[PIECE_Q];
  const long long b = blockIdx.y;
  const int piece = blockIdx.z;
  const int q0 = piece * PIECE_Q;
  const int cnt = min(PIECE_Q, m - q0);
  p += b * n * 3;
  q += b * m * 3;
  q_mask += b * m;
  for (int e = threadIdx.x; e < cnt; e += THREADS) {
    const long long r = q0 + e;
    float x = FAR, y = FAR, z = FAR;
    if (q_mask[r]) {
      x = q[r * 3];
      y = q[r * 3 + 1];
      z = q[r * 3 + 2];
    }
    tile[e] = make_float4(x, y, z, sq3(x, y, z));
  }
  float px[ROWS], py[ROWS], pz[ROWS], p2[ROWS], best[ROWS];
  int best_i[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = blockIdx.x * TILE_P + k * THREADS + threadIdx.x;
    px[k] = py[k] = pz[k] = 0.f;
    if (i < n) {
      px[k] = p[(long long)i * 3];
      py[k] = p[(long long)i * 3 + 1];
      pz[k] = p[(long long)i * 3 + 2];
    }
    p2[k] = sq3(px[k], py[k], pz[k]);
    best[k] = BIG;
    best_i[k] = 0;
  }
  __syncthreads();
#pragma unroll 2
  for (int e = 0; e < cnt; ++e) {
    const float4 c = tile[e];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(px[k], c.x), __fmul_rn(py[k], c.y)),
                                  __fmul_rn(pz[k], c.z));
      const float d = __fsub_rn(__fadd_rn(p2[k], c.w), __fmul_rn(2.f, dot));
      if (d < best[k]) {
        best[k] = d;
        best_i[k] = q0 + e;
      }
    }
  }
  const long long out0 = ((long long)piece * gridDim.y + b) * n;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = blockIdx.x * TILE_P + k * THREADS + threadIdx.x;
    if (i < n) {
      part_d[out0 + i] = best[k];
      part_i[out0 + i] = best_i[k];
    }
  }
}

// dist/idx [rows] from the pieces' partials [pieces, rows], in piece order.
__global__ void __launch_bounds__(MERGE_THREADS)
chamfer_brute_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
                    long long rows, int pieces, float* __restrict__ dist,
                    int* __restrict__ idx) {
  const long long r = (long long)blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (r >= rows) return;
  float best = BIG;
  int best_i = 0;
  for (int s = 0; s < pieces; ++s) {
    const float d = part_d[s * rows + r];
    if (d < best) {
      best = d;
      best_i = part_i[s * rows + r];
    }
  }
  dist[r] = fmaxf(best, 0.f);
  idx[r] = best_i;
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// The q pieces for m rows: the scratch holds pieces * b * n entries each of
// part_d (f32) and part_i (int32).
int chamfer_brute_pieces(int m) { return (m + PIECE_Q - 1) / PIECE_Q; }

// p [b, n, 3] f32, q [b, m, 3] f32, q_mask [b, m] uint8 (0/1), part_d /
// part_i [chamfer_brute_pieces(m), b, n] scratch, dist [b, n] f32, idx
// [b, n] int32; b < 65,536.  Two launches, no host synchronisation.
int chamfer_brute(const float* p, const float* q, const uint8_t* q_mask,
                  int b, int n, int m, float* part_d, int* part_i, float* dist,
                  int* idx, void* stream) {
  if (b == 0 || n == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const int pieces = chamfer_brute_pieces(m);
  if (pieces > 0) {
    const dim3 grid((n + TILE_P - 1) / TILE_P, b, pieces);
    chamfer_brute_kernel<<<grid, THREADS, 0, st>>>(p, q, q_mask, n, m, part_d, part_i);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long rows = (long long)b * n;
  chamfer_brute_merge<<<(unsigned)((rows + MERGE_THREADS - 1) / MERGE_THREADS),
                        MERGE_THREADS, 0, st>>>(part_d, part_i, rows, pieces, dist, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
