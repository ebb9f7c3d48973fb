// Fused Clifford-torus sampler + embedding with an in-kernel counter-based
// generator, forward, for sm_90a.
//
// Replaces cliffordtpu/kernels/sampler_pallas.py::_sample_embed_kernel (the
// pallas_call in _sample_embed_call, reached through sample_torus_fused),
// which draws from the TPU core's hardware generator.  Here the uniforms
// come from Philox-4x32-10:
//
//   words  philox4x32_10(counter = (r*d + k, 0, 0, 0), key = (s0, s1)),
//          s0, s1 the wrapper's two seed words (the caller's key folded
//          with 0x7A11A5, as the TPU package seeds its generator)
//   u      max(f(word 0), 1e-12),  v = f(word 1),  f the mantissa float
//
// so the stream is a pure function of the key and the element, and does not
// depend on how the launch is tiled.  It is a different stream from
// jax.random's by design; cliffordtpu_torch/random.py computes the same
// words in integer tensor operations, and the kernel is held to it bit for
// bit.  The sampler, the embedding and the tiling are those of
// circle_sampler.cuh.
//
// What bounds it: operations, as the keyed kernel: one Philox call per angle
// (ten rounds of two 32 x 32 -> 64 bit multiplies) is about a third of the
// two threefry calls it replaces; the embedding is the same 8.6 GFLOP at
// R = 64, d = 4096.

#include <cuda_runtime.h>
#include <stdint.h>

#include "circle_sampler.cuh"

namespace {

// Philox-4x32 with 10 rounds (Salmon et al., SC'11): words 0 and 1 of the
// output block for counter (ctr, 0, 0, 0).
__device__ __forceinline__ void philox4x32_10(uint32_t ctr, uint32_t k0,
                                              uint32_t k1, uint32_t* w0,
                                              uint32_t* w1) {
  uint32_t c0 = ctr, c1 = 0u, c2 = 0u, c3 = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  *w0 = c0;
  *w1 = c1;
}

__global__ void __launch_bounds__(kTorusThreads) rng_sample_embed_kernel(
    const float* __restrict__ loc, const float* __restrict__ kappa,
    int kap_row_stride, int kap_col_stride, float* __restrict__ x,
    float* __restrict__ theta, float* __restrict__ u_out,
    float* __restrict__ v_out, int R, int d, uint32_t s0, uint32_t s1) {
  extern __shared__ __align__(16) float smem[];
  sample_embed_tile(
      [&](uint32_t ctr, float* u, float* v) {
        uint32_t w0, w1;
        philox4x32_10(ctr, s0, s1, &w0, &w1);
        *u = fmaxf(unit_float(w0), 1e-12f);
        *v = unit_float(w1);
      },
      loc, kappa, kap_row_stride, kap_col_stride, x, theta, u_out, v_out, R,
      d, smem);
}

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/sampler.py.
// Arguments as keyed_sample_embed, with the two seed words in place of the
// four key words.  Returns the CUDA error of the shared-memory attribute
// call or of the launch.
extern "C" int rng_sample_embed(const float* loc, const float* kappa,
                                int kap_row_stride, int kap_col_stride,
                                float* x, float* theta, float* u, float* v,
                                int R, int d, uint32_t s0, uint32_t s1,
                                void* stream) {
  const size_t smem = torus_embed_smem_bytes(d);
  cudaError_t err = torus_allow_smem(rng_sample_embed_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kTorusRows - 1) / kTorusRows,
                  (2 * d + kTorusCols - 1) / kTorusCols);
  rng_sample_embed_kernel<<<grid, kTorusThreads, smem,
                            (cudaStream_t)stream>>>(
      loc, kappa, kap_row_stride, kap_col_stride, x, theta, u, v, R, d, s0,
      s1);
  return (int)cudaGetLastError();
}
