// Fused Clifford-torus sampler + embedding with an in-kernel counter-based
// generator, forward, for sm_90a.
//
// Replaces cliffordtpu/kernels/sampler_pallas.py::_sample_embed_kernel (the
// pallas_call in _sample_embed_call, reached through sample_torus_fused),
// which draws from the TPU core's hardware generator.  Here the uniforms
// come from Philox-4x32-10:
//
//   words  philox4x32_10(counter = ((row0 + r)*d + k, 0, 0, 0),
//          key = (s0, s1)), row0 the launch's first row in the global
//          draw (0 but for a rank's rows of a data-parallel batch),
//          s0, s1 the wrapper's two seed words (the caller's key folded
//          with 0x7A11A5, as the TPU package seeds its generator)
//   u      max(f(word 0), 1e-12),  v = f(word 1),  f the mantissa float
//
// so the stream is a pure function of the key and the element, and does not
// depend on how the launch is tiled.  It is a different stream from
// jax.random's by design; cliffordtpu_torch/random.py computes the same
// words in integer tensor operations, and the kernel is held to it bit for
// bit.  The sampler is circle_sampler.cuh's.
//
// Two forms, chosen by d (kernels/torus.py::form says which ran):
//
// * FFT form, d a power of two (circle_sampler.cuh::
//   sample_embed_fft_kernel, shared with sampler_keyed.cu): draw, then the
//   inverse real FFT of torus_fwd.cu's FFT form (torus_fft.cuh).  A row's
//   threads take the angle pairs (k, d - k), k = 1..d/2: each draws,
//   samples and writes its two angles (sample_pack_pair) and packs them
//   into the row's spectrum in shared memory; then d/16 of them run the
//   radix-16 passes and all store x as float4.  Each angle is drawn once
//   per launch.  The draw (one Philox call and the accurate logf / expm1f
//   / atanf / cosf / sincosf per angle, some 300 dependent instructions)
//   costs a thread about as much as the three passes at d = 4096, so the
//   draw is spread over more threads than the FFT uses (torus_fft.cuh::
//   fft_wide_threads: one a pair, up to 1024 a row, halved where R rows
//   of them would not all be resident), and the rest of the row's threads
//   only meet the passes' barriers.  What bounds the function is its bytes (loc read; x,
//   theta, u, v written: 6.3 MB at R = 64, d = 4096, about 2 us at 3.35
//   TB/s); at these sizes the launch and a thread's dependent chain bound
//   the kernel.
//
// * Table form, any other d: the tiled dense product of circle_sampler.cuh
//   (8.6 GFLOP at R = 64, d = 4096), whose blocks each draw their rows'
//   angles again, one per column tile.

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

// The words of element ctr under the seed (s0, s1), as the two uniforms.
__device__ __forceinline__ void philox_uniforms(uint32_t ctr, uint32_t s0,
                                                uint32_t s1, float* u,
                                                float* v) {
  uint32_t w0, w1;
  philox4x32_10(ctr, s0, s1, &w0, &w1);
  *u = fmaxf(unit_float(w0), 1e-12f);
  *v = unit_float(w1);
}

// The generator of this file: element ctr of the launch is element
// base + ctr of the global draw.
struct PhiloxDraw {
  uint32_t base, s0, s1;
  __device__ __forceinline__ void operator()(uint32_t ctr, float* u,
                                             float* v) const {
    philox_uniforms(base + ctr, s0, s1, u, v);
  }
};

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/sampler.py.
// Arguments as keyed_sample_embed (row0 included), with the two seed words
// in place of the four key words; x 16-byte aligned.  The FFT form for d
// a power of two, else the table form (sample_embed_launch).  Returns the
// CUDA error of the shared-memory attribute call or of the launch.
extern "C" int rng_sample_embed(const float* loc, const float* kappa,
                                int kap_row_stride, int kap_col_stride,
                                float* x, float* theta, float* u, float* v,
                                int R, int d, int row0, uint32_t s0,
                                uint32_t s1, void* stream) {
  return sample_embed_launch(
      PhiloxDraw{(uint32_t)row0 * (uint32_t)d, s0, s1}, loc, kappa,
      kap_row_stride, kap_col_stride, x, theta, u, v, R, d, stream);
}
