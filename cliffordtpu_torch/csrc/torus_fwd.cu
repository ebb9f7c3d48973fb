// Clifford-torus embedding, forward, for sm_90a.
//
// Replaces cliffordtpu/kernels/torus_pallas.py::_fwd_kernel (the pallas_call
// in _torus_fused_fwd_impl, reached through angles_to_torus_fused).  For
// every row r of R latents with free angles theta[r, k], k = 1..d-1 (angle 0
// is pinned to phase 0), and every output column col of n = 2d:
//
//   x[r, col] = c[col] + sum_k cos(theta[r, k]) C[k, col]
//                              + sin(theta[r, k]) S[k, col]
//
// with the real-DFT basis C, S, c of torus_basis.cuh.  No basis and no
// cos / sin intermediate exists in device memory, and x is written at
// (R, 2d) exactly: no padded rows or columns.
//
// What bounds it: at R = 64, d = 4096 the function moves 3.1 MB (about a
// microsecond of HBM time) and does 4 R (d-1) 2d = 8.6 GFLOP of float32
// multiply-adds (0.13 ms at the CUDA cores' peak), so it is bound by
// operations; the basis, 268 MB if it were materialised, is what the design
// keeps out of memory.  One block owns 64 rows x 64 columns, looks the basis
// up in the shared-memory table (one address per warp per lookup, shared by
// the 64 rows), and walks the angles in chunks of 64 whose cos and sin it
// computes once into shared memory.  The products run on the CUDA cores in
// float32 (one lookup and its index arithmetic per four multiply-adds); a
// tensor-core form with the basis tile synthesised in shared memory is the
// next step.

#include <cuda_runtime.h>

#include "torus_basis.cuh"

namespace {

__global__ void __launch_bounds__(kTorusThreads)
    torus_fwd_kernel(const float* __restrict__ theta, float* __restrict__ x,
                     int R, int d) {
  extern __shared__ __align__(16) float smem[];
  const int m = d - 1;
  torus_embed_tile(
      [&](int k0, int kc, int row0, float* cs, float* sn) {
        for (int e = threadIdx.x; e < kTorusRows * kTorusChunk;
             e += blockDim.x) {
          const int kk = e % kTorusChunk;
          const int lr = e / kTorusChunk;
          const int r = row0 + lr;
          float c = 0.0f, s = 0.0f;
          if (kk < kc && r < R)
            sincosf(theta[(size_t)r * m + (k0 - 1 + kk)], &s, &c);
          cs[kk * kTorusPitch + lr] = c;
          sn[kk * kTorusPitch + lr] = s;
        }
      },
      x, R, d, smem);
}

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/torus.py.
// theta (R, d-1) and x (R, 2d) float32 and contiguous, 2 <= d.  Returns the
// CUDA error of the shared-memory attribute call or of the launch.
extern "C" int torus_fwd(const float* theta, float* x, int R, int d,
                         void* stream) {
  const size_t smem = torus_embed_smem_bytes(d);
  cudaError_t err = torus_allow_smem(torus_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kTorusRows - 1) / kTorusRows,
                  (2 * d + kTorusCols - 1) / kTorusCols);
  torus_fwd_kernel<<<grid, kTorusThreads, smem, (cudaStream_t)stream>>>(
      theta, x, R, d);
  return (int)cudaGetLastError();
}
