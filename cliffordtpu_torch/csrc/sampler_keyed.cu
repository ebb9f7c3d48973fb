// Keyed fused Clifford-torus sampler + embedding, forward, for sm_90a.
//
// Replaces cliffordtpu/kernels/sampler_pallas.py::_keyed_sample_embed_kernel
// (the pallas_call in _keyed_sample_embed_call).  The sampler, the
// embedding and the tiling are those of circle_sampler.cuh; this file
// supplies the uniforms:
//
//   u, v   threefry-2x32 on jax's partitionable counters (hi = 0,
//          lo = (row0 + r)*d + k), one word x0 ^ x1 per draw, keyed by the two
//          halves of jax.random.split(key); u = max(1e-12, f*1 + 1e-12)
//          and v = f with f the mantissa float of the word, exactly as
//          jax.random.uniform computes them
//
// u and v are bit-identical to cliffordtpu_torch/random.py, which is
// bit-identical to jax.random; theta and x agree to transcendental
// tolerance.  row0 is the first row of this launch in a global draw (a
// rank of a data-parallel step draws its rows of the global batch); it
// adds row0*d to every counter, in uint32 arithmetic, exact while the
// global draw stays below 2**32 counters (the wrapper checks it).
//
// What bounds it: operations.  At the flagship shape (R = 4096, d = 16) it
// moves about 1.5 MB, under half a microsecond of HBM time, against two
// threefry draws per angle; at R = 64, d = 4096 it moves 5.2 MB against
// 8.6 GFLOP of embedding (0.13 ms at the CUDA cores' float32 peak) and the
// draws repeated per column tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "circle_sampler.cuh"

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds with key injection every 4, as jax's
// threefry2x32_p (and cliffordtpu_torch/random.py::threefry2x32).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__global__ void __launch_bounds__(kTorusThreads) keyed_sample_embed_kernel(
    const float* __restrict__ loc, const float* __restrict__ kappa,
    int kap_row_stride, int kap_col_stride, float* __restrict__ x,
    float* __restrict__ theta, float* __restrict__ u_out,
    float* __restrict__ v_out, int R, int d, int row0, uint32_t ku0,
    uint32_t ku1, uint32_t kv0, uint32_t kv1) {
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = (uint32_t)row0 * (uint32_t)d;
  sample_embed_tile(
      [&](uint32_t ctr, float* u, float* v) {
        uint32_t a0 = 0u, a1 = base + ctr, b0 = 0u, b1 = base + ctr;
        threefry2x32(ku0, ku1, a0, a1);
        threefry2x32(kv0, kv1, b0, b1);
        // jax: max(minval, f * (maxval - minval) + minval), (1 - 1e-12f) == 1
        *u = fmaxf(1e-12f, __fadd_rn(__fmul_rn(unit_float(a0 ^ a1),
                                               1.0f - 1e-12f),
                                     1e-12f));
        *v = unit_float(b0 ^ b1);
      },
      loc, kappa, kap_row_stride, kap_col_stride, x, theta, u_out, v_out, R,
      d, smem);
}

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/sampler.py.
// loc (R, d), kappa read at r*kap_row_stride + k*kap_col_stride, outputs
// x (R, 2d) and theta/u/v (R, d-1), all float32 and contiguous; the rows
// are rows row0.. of the global draw.  The wrapper keeps the global R*d
// below 2**32.  Returns the CUDA error of the
// shared-memory attribute call or of the launch.
extern "C" int keyed_sample_embed(const float* loc, const float* kappa,
                                  int kap_row_stride, int kap_col_stride,
                                  float* x, float* theta, float* u, float* v,
                                  int R, int d, int row0, uint32_t ku0,
                                  uint32_t ku1, uint32_t kv0, uint32_t kv1,
                                  void* stream) {
  const size_t smem = torus_embed_smem_bytes(d);
  cudaError_t err = torus_allow_smem(keyed_sample_embed_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kTorusRows - 1) / kTorusRows,
                  (2 * d + kTorusCols - 1) / kTorusCols);
  keyed_sample_embed_kernel<<<grid, kTorusThreads, smem,
                              (cudaStream_t)stream>>>(
      loc, kappa, kap_row_stride, kap_col_stride, x, theta, u, v, R, d, row0,
      ku0, ku1, kv0, kv1);
  return (int)cudaGetLastError();
}
