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
// bit.  The sampler is circle_sampler.cuh's.
//
// Two forms, chosen by d (kernels/sampler.py::rng_form says which ran):
//
// * FFT form, d a power of two: draw, then the inverse real FFT of
//   torus_fwd.cu's FFT form (torus_fft.cuh).  A row's threads take the
//   angle pairs (k, d - k), k = 1..d/2: each draws, samples and writes its
//   two angles (sample_pack_pair) and packs them into the row's spectrum
//   in shared memory; then d/16 of them run the radix-16 passes and all
//   store x as float4.  Each angle is drawn once per launch.  The draw (one
//   Philox call and the accurate logf / expm1f / atanf / cosf / sincosf per
//   angle, some 300 dependent instructions) costs a thread about as much as
//   the three passes at d = 4096, so the draw is spread over more threads
//   than the FFT uses: up to kRngRowThreads a row (1024 at d = 4096, one
//   row per block, two or three pairs a thread), and the rest of the row's
//   threads only meet the passes' barriers.  What bounds the function is
//   its bytes (loc read; x, theta, u, v written: 6.3 MB at R = 64, d =
//   4096, about 2 us at 3.35 TB/s); at these sizes the launch and a
//   thread's dependent chain bound the kernel.
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

constexpr int kRngRowThreads = 1024;  // the most threads drawing one row
constexpr int kRngMinBlock = 256;

// Threads drawing one row of the FFT form: one per angle pair up to
// kRngRowThreads (at least d/16, the FFT's own).
__host__ __device__ constexpr int rng_row_threads(int d) {
  return d / 2 < 1 ? 1 : d / 2 < kRngRowThreads ? d / 2 : kRngRowThreads;
}
constexpr int rng_block_threads(int d) {
  return rng_row_threads(d) > kRngMinBlock ? rng_row_threads(d)
                                           : kRngMinBlock;
}
constexpr size_t rng_fft_smem_bytes(int d) {
  return sizeof(float2) * 2 * (size_t)(rng_block_threads(d) /
                                       rng_row_threads(d)) *
         (size_t)fft_pitch(d);
}
static_assert(fft_row_threads(kTorusMaxDim) <= rng_row_threads(kTorusMaxDim),
              "a row's FFT threads must be among its drawing threads");
static_assert(rng_fft_smem_bytes(kTorusMaxDim) <= kTorusMaxSmem,
              "a row's two buffers must fit a block at the largest d");

__global__ void __launch_bounds__(kRngRowThreads) rng_sample_embed_fft_kernel(
    const float* __restrict__ loc, const float* __restrict__ kappa,
    int kap_row_stride, int kap_col_stride, float* __restrict__ x,
    float* __restrict__ theta, float* __restrict__ u_out,
    float* __restrict__ v_out, int R, int d, uint32_t s0, uint32_t s1) {
  extern __shared__ __align__(16) float2 buf[];
  const int DT = rng_row_threads(d);
  const int T = fft_row_threads(d);
  const int rows = blockDim.x / DT;
  const int pitch = fft_pitch(d);
  const int lr = threadIdx.x / DT;
  const int t = threadIdx.x % DT;
  const int row = blockIdx.x * rows + lr;
  const bool live = row < R;
  float2* a = buf + lr * pitch;
  float2* b = buf + (rows + lr) * pitch;
  if (live) {
    for (int k = t; k <= d / 2; k += DT) {
      if (k == 0) {
        a[0] = make_float2(2.0f, 0.0f);  // Z_0: X_0 = X_d = 1
        continue;
      }
      sample_pack_pair(
          [&](uint32_t ctr, float* u, float* v) {
            philox_uniforms(ctr, s0, s1, u, v);
          },
          loc, kappa, kap_row_stride, kap_col_stride, theta, u_out, v_out,
          row, k, d, a);
    }
  }
  const float2* z = fft_inverse(a, b, d, t, T, live && t < T);
  if (!live) return;
  const float inv_n = 1.0f / (float)(2 * d);  // a power of two: exact
  float4* xr = reinterpret_cast<float4*>(x + (size_t)row * 2 * d);
  for (int e = t; e < d / 2; e += DT) {
    const float2 z0 = z[fft_pad(2 * e)];
    const float2 z1 = z[fft_pad(2 * e + 1)];
    xr[e] = make_float4(z0.x * inv_n, z0.y * inv_n, z1.x * inv_n,
                        z1.y * inv_n);
  }
}

__global__ void __launch_bounds__(kTorusThreads) rng_sample_embed_kernel(
    const float* __restrict__ loc, const float* __restrict__ kappa,
    int kap_row_stride, int kap_col_stride, float* __restrict__ x,
    float* __restrict__ theta, float* __restrict__ u_out,
    float* __restrict__ v_out, int R, int d, uint32_t s0, uint32_t s1) {
  extern __shared__ __align__(16) float smem[];
  sample_embed_tile(
      [&](uint32_t ctr, float* u, float* v) {
        philox_uniforms(ctr, s0, s1, u, v);
      },
      loc, kappa, kap_row_stride, kap_col_stride, x, theta, u_out, v_out, R,
      d, smem);
}

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/sampler.py.
// Arguments as keyed_sample_embed, with the two seed words in place of the
// four key words, and x 16-byte aligned; the FFT form for d a power of
// two, else the table form.  Returns the CUDA error of the shared-memory
// attribute call or of the launch.
extern "C" int rng_sample_embed(const float* loc, const float* kappa,
                                int kap_row_stride, int kap_col_stride,
                                float* x, float* theta, float* u, float* v,
                                int R, int d, uint32_t s0, uint32_t s1,
                                void* stream) {
  if (d >= 2 && (d & (d - 1)) == 0) {
    const int threads = rng_block_threads(d);
    const int rows = threads / rng_row_threads(d);
    const size_t smem = rng_fft_smem_bytes(d);
    cudaError_t err = torus_allow_smem(rng_sample_embed_fft_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    rng_sample_embed_fft_kernel<<<(R + rows - 1) / rows, threads, smem,
                                  (cudaStream_t)stream>>>(
        loc, kappa, kap_row_stride, kap_col_stride, x, theta, u, v, R, d, s0,
        s1);
    return (int)cudaGetLastError();
  }
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
