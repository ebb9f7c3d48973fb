// Keyed fused Clifford-torus sampler + embedding, forward, for sm_90a.
//
// Replaces cliffordtpu/kernels/sampler_pallas.py::_keyed_sample_embed_kernel
// (the pallas_call in _keyed_sample_embed_call).  For every row r of R
// latents with d angles and every angle k = 1..d-1 (angle 0 is pinned):
//
//   u, v   threefry-2x32 on jax's partitionable counters (hi = 0,
//          lo = r*d + k), one word x0 ^ x1 per draw, keyed by the two
//          halves of jax.random.split(key); u = max(1e-12, f*1 + 1e-12)
//          and v = f with f the mantissa float of the word, exactly as
//          jax.random.uniform computes them
//   theta  loc + 2 atan(cos(2 pi v) sqrt(expm1(-(2/nu) ln u))),
//          nu = 2 (kappa + 1e-7) + 1
//   x      the real-DFT torus embedding of theta (torus_basis.cuh)
//
// and it also writes theta, u and v (the residuals a backward pass needs).
// u and v are bit-identical to cliffordtpu_torch/random.py, which is
// bit-identical to jax.random; theta and x agree to transcendental
// tolerance.  That needs IEEE division and square root and the accurate
// logf/expm1f/atanf/sincosf, so this file is built without fast math.
//
// What bounds it: at the flagship shape (R = 4096, d = 16) the kernel
// moves about 1.5 MB, under half a microsecond of HBM time, so the kernel
// is bound by its instructions (two threefry draws per angle, and a
// sincosf per basis term) and its launch.  The design keeps everything in
// one launch, with no intermediate in HBM: phase 1
// (one thread per (row, angle)) draws, samples and stores, and leaves
// cos theta / sin theta in shared memory; phase 2 (one thread per (row,
// output column)) sums the d-1 basis terms, building each basis value in
// registers from the int32 phase (no basis in HBM).  Phase 2 is
// O(R d 2d) scalar work with a sincosf per term: fine at d = 16, but the
// large-latent (cnn4096) slice needs a tensor-core GEMM whose basis
// operand is synthesised tile by tile in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "torus_basis.cuh"

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

// mantissa trick: a float in [1, 2) from the top 23 bits, minus 1
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__global__ void keyed_sample_embed_kernel(
    const float* __restrict__ loc, const float* __restrict__ kappa,
    int kap_row_stride, int kap_col_stride, float* __restrict__ x,
    float* __restrict__ theta, float* __restrict__ u_out,
    float* __restrict__ v_out, int R, int d, int rows_per_block,
    uint32_t ku0, uint32_t ku1, uint32_t kv0, uint32_t kv1) {
  extern __shared__ float smem[];
  const int m = d - 1;  // free angles 1..d-1
  const int n = 2 * d;  // output width
  float* cos_th = smem;
  float* sin_th = smem + rows_per_block * m;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, R - row0);

  // phase 1: draw, sample, store; cos/sin theta to shared memory
  for (int e = threadIdx.x; e < rows * m; e += blockDim.x) {
    const int lr = e / m;
    const int k = e % m + 1;
    const int r = row0 + lr;
    const uint32_t ctr = (uint32_t)r * (uint32_t)d + (uint32_t)k;
    uint32_t a0 = 0u, a1 = ctr, b0 = 0u, b1 = ctr;
    threefry2x32(ku0, ku1, a0, a1);
    threefry2x32(kv0, kv1, b0, b1);
    // jax: max(minval, f * (maxval - minval) + minval), (1 - 1e-12f) == 1
    const float u = fmaxf(1e-12f, __fadd_rn(__fmul_rn(unit_float(a0 ^ a1),
                                                      1.0f - 1e-12f),
                                            1e-12f));
    const float v = unit_float(b0 ^ b1);
    const float kap =
        kappa[(size_t)r * kap_row_stride + (size_t)k * kap_col_stride];
    const float nu = 2.0f * (kap + 1e-7f) + 1.0f;
    const float w = expm1f((-2.0f / nu) * logf(u));
    const float two_pi_v = (float)6.283185307179586476925 * v;
    const float t = loc[(size_t)r * d + k] +
                    2.0f * atanf(cosf(two_pi_v) * sqrtf(w));
    const size_t o = (size_t)r * m + (k - 1);
    theta[o] = t;
    u_out[o] = u;
    v_out[o] = v;
    float s, c;
    sincosf(t, &s, &c);
    cos_th[lr * m + k - 1] = c;
    sin_th[lr * m + k - 1] = s;
  }
  __syncthreads();

  // phase 2: x[r, col] = c[col] + sum_k (cos th_k C[k, col]
  //                                        + sin th_k S[k, col])
  const float step = torus_phase_step(d);
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int lr = e / n;
    const int col = e % n;
    const float* cr = cos_th + lr * m;
    const float* sr = sin_th + lr * m;
    float acc = 0.0f;
    for (int k = 1; k <= m; ++k) {
      float cb, sb;
      torus_basis(k, col, d, step, &cb, &sb);
      acc = fmaf(cr[k - 1], cb, acc);
      acc = fmaf(sr[k - 1], sb, acc);
    }
    x[(size_t)(row0 + lr) * n + col] = acc + torus_const(col, d);
  }
}

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/sampler.py.
// loc (R, d), kappa read at r*kap_row_stride + k*kap_col_stride, outputs
// x (R, 2d) and theta/u/v (R, d-1), all float32 and contiguous.  The
// wrapper keeps 2*rows_per_block*(d-1) floats within 48 KB of shared
// memory and R*d below 2**32.  Returns cudaGetLastError() after the launch.
extern "C" int keyed_sample_embed(const float* loc, const float* kappa,
                                  int kap_row_stride, int kap_col_stride,
                                  float* x, float* theta, float* u, float* v,
                                  int R, int d, int rows_per_block,
                                  uint32_t ku0, uint32_t ku1, uint32_t kv0,
                                  uint32_t kv1, void* stream) {
  const size_t smem = 2 * (size_t)rows_per_block * (d - 1) * sizeof(float);
  const int blocks = (R + rows_per_block - 1) / rows_per_block;
  keyed_sample_embed_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(
      loc, kappa, kap_row_stride, kap_col_stride, x, theta, u, v, R, d,
      rows_per_block, ku0, ku1, kv0, kv1);
  return (int)cudaGetLastError();
}
