// Keyed fused Clifford-torus sampler + embedding, forward, for sm_90a.
//
// Replaces cliffordtpu/kernels/sampler_pallas.py::_keyed_sample_embed_kernel
// (the pallas_call in _keyed_sample_embed_call).  The sampler, the
// embedding and both forms are those of circle_sampler.cuh; this file
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
// Two forms, chosen by d (kernels/torus.py::form says which ran):
//
// * FFT form, d a power of two (circle_sampler.cuh::
//   sample_embed_fft_kernel, as sampler_rng.cu): a row's threads draw,
//   sample and pack the angle pairs (k, d - k), each angle once per
//   launch, then the inverse real FFT of torus_fft.cuh gives x, stored as
//   float4.  An angle is two threefry calls (40 rounds) and the sampler's
//   accurate logf / expm1f / atanf / cosf / sincosf, some 400 dependent
//   instructions, spread over up to 1024 threads a row
//   (torus_fft.cuh::fft_wide_threads).  What bounds the
//   function is its bytes (loc read; x, theta, u, v written: 25 MB at R =
//   256, d = 4096, 7.5 us at 3.35 TB/s); at these sizes a thread's
//   dependent chain and the launch bound the kernel.
//
// * Table form, any other d (5 and 40 in the MNIST sweeps, 513 in the
//   checks): the tiled dense product of circle_sampler.cuh, whose blocks
//   each draw their rows' angles again, one per column tile.

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

// The generator of this file: element ctr of the launch is element
// base + ctr of the global draw; u from the first key, v from the second.
struct KeyedDraw {
  uint32_t base, ku0, ku1, kv0, kv1;
  __device__ __forceinline__ void operator()(uint32_t ctr, float* u,
                                             float* v) const {
    uint32_t a0 = 0u, a1 = base + ctr, b0 = 0u, b1 = base + ctr;
    threefry2x32(ku0, ku1, a0, a1);
    threefry2x32(kv0, kv1, b0, b1);
    // jax: max(minval, f * (maxval - minval) + minval), (1 - 1e-12f) == 1
    *u = fmaxf(1e-12f, __fadd_rn(__fmul_rn(unit_float(a0 ^ a1),
                                           1.0f - 1e-12f),
                                 1e-12f));
    *v = unit_float(b0 ^ b1);
  }
};

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/sampler.py.
// loc (R, d), kappa read at r*kap_row_stride + k*kap_col_stride, outputs
// x (R, 2d) and theta/u/v (R, d-1), all float32 and contiguous, x 16-byte
// aligned; the rows are rows row0.. of the global draw.  The wrapper keeps
// the global R*d below 2**32.  The FFT form for d a power of two, else the
// table form (sample_embed_launch).  Returns the CUDA error of the
// shared-memory attribute call or of the launch.
extern "C" int keyed_sample_embed(const float* loc, const float* kappa,
                                  int kap_row_stride, int kap_col_stride,
                                  float* x, float* theta, float* u, float* v,
                                  int R, int d, int row0, uint32_t ku0,
                                  uint32_t ku1, uint32_t kv0, uint32_t kv1,
                                  void* stream) {
  return sample_embed_launch(
      KeyedDraw{(uint32_t)row0 * (uint32_t)d, ku0, ku1, kv0, kv1}, loc, kappa,
      kap_row_stride, kap_col_stride, x, theta, u, v, R, d, stream);
}
