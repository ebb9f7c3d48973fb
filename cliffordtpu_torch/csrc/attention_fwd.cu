// Fused half-split RoPE + non-causal attention, forward, for sm_90a.
//
// Replaces cliffordtpu/kernels/attention_pallas.py::_fwd_kernel (the
// pallas_call in _attn_fwd_call, public entry fused_attention):
//
//   out = softmax(rot(q) rot(k)^T / sqrt(hd)) v
//   rot(x) = [x0 cos - x1 sin | x0 sin + x1 cos],  x = [x0 | x1]
//
// with q, k, v, out in (B, S, H, hd) and cos, sin in (S, hd/2) float32
// (null for no rotation).  All arithmetic is float32; out is written in
// the input type (float32 or bfloat16).
//
// Design: one block per (batch, head).  It reads its q, k, v slices
// straight from the (B, S, H, hd) strides (no transpose or pad in HBM),
// rotates q and k while loading them into shared memory, forms the S x S
// scores in shared memory, takes each row's softmax over the S real keys
// (a loop bound, where the TPU kernel padded S and masked keys to -1e30),
// and forms P v with float32 accumulation.  Scores never touch HBM.  At
// the flagship shape (S = 68, hd = 64) q, k (rows padded to hd+1 floats
// against bank conflicts), v and the scores take 70,992 bytes of shared
// memory, above the 48 KB default, so the launcher raises the kernel's
// dynamic shared memory limit, once per device.
//
// What bounds it: at B = 64, H = 8 the function moves 17.8 MB in bfloat16
// (35.7 MB in float32) and does 0.6 GFLOP, so HBM bandwidth bounds the
// function (about 5.3 us in bfloat16 at 3.35 TB/s).  This first version is
// simple scalar float32 code on the CUDA cores, and what bounds the kernel
// is its shared-memory traffic: the score and P v loops issue two
// shared-memory loads per fused multiply-add, so it runs at about 20x the
// bound (PERF.md).  Register tiles, and wgmma tiles fed by TMA loads for
// bfloat16, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void attention_fwd_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const float* __restrict__ cos_t,
                                     const float* __restrict__ sin_t,
                                     T* __restrict__ out, int S, int H, int hd,
                                     float scale) {
  extern __shared__ float smem[];
  const int half = hd / 2;
  const int kstride = hd + 1;  // padded K rows: conflict-free score loop
  float* qs = smem;            // S x hd, rotated
  float* ks = qs + S * hd;     // S x (hd + 1), rotated
  float* vs = ks + S * kstride;  // S x hd
  float* p = vs + S * hd;      // S x S scores, then probabilities

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t tok = (size_t)H * hd;  // stride between tokens
  const size_t base = (size_t)b * S * tok + (size_t)h * hd;

  // 1. load, rotating the pairs (i, i + hd/2) of q and k
  for (int e = threadIdx.x; e < S * half; e += blockDim.x) {
    const int s = e / half;
    const int i = e % half;
    const size_t g = base + s * tok + i;
    float c = 1.0f, sn = 0.0f;
    if (cos_t != nullptr) {
      c = cos_t[s * half + i];
      sn = sin_t[s * half + i];
    }
    const float q0 = to_f32(q[g]), q1 = to_f32(q[g + half]);
    qs[s * hd + i] = q0 * c - q1 * sn;
    qs[s * hd + i + half] = q0 * sn + q1 * c;
    const float k0 = to_f32(k[g]), k1 = to_f32(k[g + half]);
    ks[s * kstride + i] = k0 * c - k1 * sn;
    ks[s * kstride + i + half] = k0 * sn + k1 * c;
    vs[s * hd + i] = to_f32(v[g]);
    vs[s * hd + i + half] = to_f32(v[g + half]);
  }
  __syncthreads();

  // 2. scores
  for (int e = threadIdx.x; e < S * S; e += blockDim.x) {
    const int i = e / S;
    const int j = e % S;
    const float* qi = qs + i * hd;
    const float* kj = ks + j * kstride;
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d) acc = fmaf(qi[d], kj[d], acc);
    p[i * S + j] = scale * acc;
  }
  __syncthreads();

  // 3. row softmax over the S real keys, one warp per row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int i = warp; i < S; i += nwarps) {
    float* row = p + i * S;
    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) mx = fmaxf(mx, row[j]);
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float ex = expf(row[j] - mx);
      row[j] = ex;
      sum += ex;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < S; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  // 4. out = P v
  for (int e = threadIdx.x; e < S * hd; e += blockDim.x) {
    const int i = e / hd;
    const int d = e % hd;
    const float* pi = p + i * S;
    float acc = 0.0f;
    for (int j = 0; j < S; ++j) acc = fmaf(pi[j], vs[j * hd + d], acc);
    store(out + base + i * tok + d, acc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* cos_t,
           const float* sin_t, void* out, int B, int S, int H, int hd,
           void* stream) {
  const int smem = (int)(sizeof(float) * ((size_t)S * hd * 2 +
                                          (size_t)S * (hd + 1) +
                                          (size_t)S * S));
  // The block's dynamic shared-memory limit is raised to the device's
  // opt-in maximum once per (type, device), not on every launch; the
  // wrapper refuses shapes above that maximum.
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!raised[dev].load()) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(attention_fwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return (int)err;
    raised[dev].store(true);
  }
  const float scale = 1.0f / sqrtf((float)hd);
  attention_fwd_kernel<T><<<B * H, 256, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, cos_t, sin_t, (T*)out, S, H, hd,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/attention.py.
// q, k, v, out contiguous (B, S, H, hd); cos, sin contiguous (S, hd/2)
// float32 or both null.  The wrapper checks shapes, types and the shared
// memory size.  Returns the CUDA error of the attribute call or launch.
extern "C" int attention_fwd_f32(const void* q, const void* k, const void* v,
                                 const float* cos_t, const float* sin_t,
                                 void* out, int B, int S, int H, int hd,
                                 void* stream) {
  return launch<float>(q, k, v, cos_t, sin_t, out, B, S, H, hd, stream);
}

extern "C" int attention_fwd_bf16(const void* q, const void* k, const void* v,
                                  const float* cos_t, const float* sin_t,
                                  void* out, int B, int S, int H, int hd,
                                  void* stream) {
  return launch<__nv_bfloat16>(q, k, v, cos_t, sin_t, out, B, S, H, hd,
                               stream);
}
