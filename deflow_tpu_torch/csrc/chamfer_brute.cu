// Brute nearest neighbour: for each p row of each sample, the squared
// distance to the nearest q row of the same sample and its index,
//   d = (|p|^2 + |q|^2) - 2 * ((px*qx + py*qy) + pz*qz),
// with |v|^2 = (x*x + y*y) + z*z, masked q rows folded to the far sentinel
// (1e6, 1e6, 1e6), a strict < scan in q order (ties go to the lower index)
// and the result clamped with max(d, 0).  With no q row at all: (3e38, 0).
//
// Replaces: deflow_tpu/ops/pallas_chamfer.py::_chamfer_min_single (the
// Pallas kernel _chamfer_kernel), reached from chamfer_min_pallas by the
// brute chamfer (ops/chamfer.py _nn_search, method "brute" and "auto" up
// to 16384^2 pairs).
//
// Bound on the H100: f32 operations (not tensor cores).  Each (p, q) pair
// costs 9: 5 for the dot, the |p|^2 + |q|^2 add, the doubling, the subtract
// and the compare.  At 16,384 x 16,384 per sample that is 2.4 GFLOP.
//
// Design: one thread per p row, B samples in one launch (blockIdx.y).  q
// is staged through shared memory in tiles of 1024 rows as float4 (x, y,
// z, |q|^2), the mask folded in while staging; every thread reads each
// staged row as a broadcast.  The arithmetic is spelled out with __fmul_rn
// / __fadd_rn so that nvcc does not contract it into FMAs: the kernel then
// rounds exactly as the plain PyTorch version and the indices agree
// exactly.  The Pallas kernel keeps all of q resident in VMEM as an
// [8, M] slab and pads it to its 1024-row chunk with |q|^2 = 3e38; here the
// loop simply ends at M.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_Q = 1024;
constexpr float FAR = 1.0e6f;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__global__ void __launch_bounds__(THREADS)
chamfer_brute_kernel(const float* __restrict__ p, const float* __restrict__ q,
                     const uint8_t* __restrict__ q_mask, int n, int m,
                     float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float4 tile[TILE_Q];
  const long long b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  p += b * n * 3;
  q += b * m * 3;
  q_mask += b * m;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (i < n) {
    px = p[(long long)i * 3];
    py = p[(long long)i * 3 + 1];
    pz = p[(long long)i * 3 + 2];
  }
  const float p2 = sq3(px, py, pz);
  float best = 3.0e38f;
  int best_i = 0;
  for (int t0 = 0; t0 < m; t0 += TILE_Q) {
    const int cnt = min(TILE_Q, m - t0);
    __syncthreads();                 // the previous tile is consumed
    for (int e = threadIdx.x; e < cnt; e += THREADS) {
      const long long r = t0 + e;
      float x = FAR, y = FAR, z = FAR;
      if (q_mask[r]) {
        x = q[r * 3];
        y = q[r * 3 + 1];
        z = q[r * 3 + 2];
      }
      tile[e] = make_float4(x, y, z, sq3(x, y, z));
    }
    __syncthreads();
    for (int e = 0; e < cnt; ++e) {
      const float4 c = tile[e];
      const float dot = __fadd_rn(__fadd_rn(__fmul_rn(px, c.x), __fmul_rn(py, c.y)),
                                  __fmul_rn(pz, c.z));
      const float d = __fsub_rn(__fadd_rn(p2, c.w), __fmul_rn(2.f, dot));
      if (d < best) {
        best = d;
        best_i = t0 + e;
      }
    }
  }
  if (i < n) {
    dist[b * n + i] = fmaxf(best, 0.f);
    idx[b * n + i] = best_i;
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// p [b, n, 3] f32, q [b, m, 3] f32, q_mask [b, m] uint8 (0/1), dist [b, n]
// f32, idx [b, n] int32; b < 65,536.
int chamfer_brute(const float* p, const float* q, const uint8_t* q_mask,
                  int b, int n, int m, float* dist, int* idx, void* stream) {
  if (b == 0 || n == 0) return (int)cudaGetLastError();
  const dim3 grid((n + THREADS - 1) / THREADS, b);
  chamfer_brute_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      p, q, q_mask, n, m, dist, idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
