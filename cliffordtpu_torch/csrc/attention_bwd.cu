// Fused half-split RoPE + non-causal attention, backward, for sm_90a.
//
// Replaces cliffordtpu/kernels/attention_pallas.py::_bwd_kernel (the
// pallas_call in _attn_bwd, the custom VJP of fused_attention).  Given
// q, k, v and the output gradient dO, all (B, S, H, hd):
//
//   Qr = rot(q), Kr = rot(k)            rot as in attention_fwd.cu
//   P  = softmax(scale Qr Kr^T)          recomputed, never read from HBM
//   dV = P^T dO
//   dP = dO V^T
//   dS = P o (dP - rowsum(dP o P)) scale
//   dQr = dS Kr,  dKr = dS^T Qr
//   dq = rot^-1(dQr), dk = rot^-1(dKr)   rot^-1(x) = [x0 c + x1 s | x1 c - x0 s]
//
// dq, dk, dv are written in the input type at the (B, S, H, hd) strides.
// One block per (batch, head), as in the forward, so each block owns its
// dq, dk, dv slices and needs no atomics; it reads its rows with 16-byte
// loads, rotates q and k in float32 as it stages them in shared memory,
// and takes the softmax over the S real keys.  No log-sum-exp is saved by
// the forward, so P is recomputed here.
//
// What bounds it: at B = 64, H = 8, S = 68, hd = 64 the function moves
// seven tensors, 31.2 MB in bfloat16 (62.4 MB in float32), and does five
// S x S x hd products, 1.5 GFLOP: HBM bandwidth bounds the bfloat16
// function (9.3 us at 3.35 TB/s), the CUDA cores' float32 rate the float32
// one (22.6 us at 67 TFLOP/s).
//
// bfloat16 (attention_bwd_mma): the products run on the tensor cores as
// mma.sync.m16n8k16 (bfloat16 operands, float32 accumulators), 16-row
// tiles as in the forward (S = 68 pads to 80: five warps).  Shared memory
// holds Qr, Kr, v and dO in rows of hd + 8 bfloat16, and P and dS in rows
// of Sk + 8 (every ldmatrix conflict-free): 74 KB at the flagship shape,
// three blocks per SM.
//   Phase 1, warp w owns query rows 16w..16w+15 with Qr and dO as A
//   fragments in registers, and walks the keys 16 at a time three times:
//   (a) the row max and sum of the softmax; (b) delta = rowsum(P o dP),
//   with dP = dO V^T on the tensor cores; (c) P and dS again, written to
//   shared memory as bfloat16, and dQr += dS Kr, where dS's accumulators
//   are its A fragment (it never leaves registers) and Kr comes in through
//   ldmatrix.trans.  Recomputing the scores costs three small products per
//   tile and keeps no S x S array in registers, so any S that fits shared
//   memory runs.  Column i and column i + hd/2 of an m16n8 accumulator lie
//   in n-tiles j and j + hd/16 of one thread, so the inverse rotation of
//   dQr is done in registers.
//   Phase 2, warp w owns key rows: dV = P^T dO and dKr = dS^T Qr, P^T and
//   dS^T read with ldmatrix.trans from what phase 1 wrote (FlashAttention
//   2 recomputes S^T instead; here the tiles are already in shared memory
//   and phase 2 needs no exponentials).  dk and dv are staged through the
//   warp's own rows of Kr and v, which phase 2 no longer reads, and leave
//   16 bytes a lane.
//   Padded query rows (S <= i < Sk) have Qr = 0, so their scores are 0 and
//   their softmax would be uniform: their P and dS are set to 0, as are the
//   padded key columns (score -inf).  The zero rows of dO would keep them
//   out of dV and dK too; the mask keeps that from resting on what the
//   padded rows hold.  Only the product operands are rounded to bfloat16
//   (Qr, Kr, P, dS); scores, softmax, delta and every sum stay float32.
//
// float32 (attention_bwd_simt): float32 on the CUDA cores (the 1e-5 bar
// against the plain version rules out TF32), with register tiles over
// float4 reads from shared memory padded against bank conflicts: scores
// and dP take 4 query rows x 4 keys a thread (rows and keys strided by
// S/4), dQ 4 rows x 8 columns, dV and dK 4 consecutive keys x 8 columns
// (an outer product over the queries, so that P and dS are read as float4
// along their rows).  The 8 columns of a thread are c..c+3 and
// c + hd/2..c + hd/2 + 3, so the inverse rotation needs no exchange.  P
// and dS stay float32 in shared memory: 113 KB at the flagship shape, two
// blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMmaMaxWarps = 8;  // a warp loops over 16-row tiles
constexpr int kSimtMaxThreads = 320;  // two blocks per SM at 96 registers

// ---------------------------------------------------------------- bf16 --
// The fragment helpers are those of attention_fwd.cu.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a b, a 16 x 16 (row), b 16 x 8 (col), bfloat16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bfloat16 x 2 (round to nearest even), the first in the
// low half, as an mma fragment register holds them
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// a, b: two bfloat16 of the first and the second half of a row, rotated
// in float32 by their angles' cos c0, c1 and sin s0, s1, rounded back.
__device__ __forceinline__ void rotate2(uint32_t& a, uint32_t& b, float c0,
                                        float c1, float s0, float s1) {
  const float a0 = bf16_lo(a), a1 = bf16_hi(a);
  const float b0 = bf16_lo(b), b1 = bf16_hi(b);
  a = pack_bf16(a0 * c0 - b0 * s0, a1 * c1 - b1 * s1);
  b = pack_bf16(a0 * s0 + b0 * c0, a1 * s1 + b1 * c1);
}

__device__ __forceinline__ void rotate8(uint4& x0, uint4& x1, float4 c0,
                                        float4 c1, float4 s0, float4 s1) {
  rotate2(x0.x, x1.x, c0.x, c0.y, s0.x, s0.y);
  rotate2(x0.y, x1.y, c0.z, c0.w, s0.z, s0.w);
  rotate2(x0.z, x1.z, c1.x, c1.y, s1.x, s1.y);
  rotate2(x0.w, x1.w, c1.z, c1.w, s1.z, s1.w);
}

// Rows of q, k, v, dO: hd + 8 bfloat16; rows of P and dS: Sk + 8, Sk = S
// rounded up to 16.  Both make ldmatrix's eight 16-byte row reads land on
// eight different 4-bank groups.
template <int HD>
__host__ __device__ constexpr int mma_pitch() {
  return HD + 8;
}
__host__ __device__ constexpr int mma_rows(int S) { return (S + 15) & ~15; }

// 16 rows x 16 keys of a b^T, a's rows as A fragments (hd/16 of them), b's
// rows n0..n0+15 read from shared memory: two m16n8 tiles.
template <int HD>
__device__ __forceinline__ void row_products(float (&c)[2][4],
                                             const uint32_t (&a)[HD / 16][4],
                                             const __nv_bfloat16* bs, int n0,
                                             int lane) {
  constexpr int P = mma_pitch<HD>();
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, bs + (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                   ((lane >> 3) & 1) * 8);
    mma_bf16(c[0], a[kk], b[0], b[1]);
    mma_bf16(c[1], a[kk], b[2], b[3]);
  }
}

// acc (16 x hd) += a (16 x 16, A fragment) times rows r0..r0+15 of bs
// (16 x hd, row-major), bs read with ldmatrix.trans.
template <int HD>
__device__ __forceinline__ void times_rows(float (&acc)[HD / 8][4],
                                           const uint32_t (&a)[4],
                                           const __nv_bfloat16* bs, int r0,
                                           int lane) {
  constexpr int P = mma_pitch<HD>();
#pragma unroll
  for (int dp = 0; dp < HD / 16; ++dp) {
    uint32_t b[4];
    ldsm_x4_trans(b, bs + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                         dp * 16 + (lane >> 4) * 8);
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// The inverse rotation of a 16-row accumulator tile in place: column i of
// n-tile j pairs with column i + hd/2 of n-tile j + hd/16, same element.
// Row r of the tile is token r0 + r; rows past S are left alone.
template <int HD>
__device__ __forceinline__ void unrotate(float (&acc)[HD / 8][4],
                                         const float* __restrict__ cos_t,
                                         const float* __restrict__ sin_t,
                                         int r0, int g, int t, int S) {
  if (cos_t == nullptr) return;
  constexpr int HALF = HD / 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      const int col = n * 8 + 2 * t;
      const float2 c = *reinterpret_cast<const float2*>(cos_t + row * HALF +
                                                        col);
      const float2 s = *reinterpret_cast<const float2*>(sin_t + row * HALF +
                                                        col);
      float& a0 = acc[n][2 * half];
      float& a1 = acc[n][2 * half + 1];
      float& b0 = acc[n + HD / 16][2 * half];
      float& b1 = acc[n + HD / 16][2 * half + 1];
      const float x0 = a0, x1 = a1, y0 = b0, y1 = b1;
      a0 = x0 * c.x + y0 * s.x;
      b0 = y0 * c.x - x0 * s.x;
      a1 = x1 * c.y + y1 * s.y;
      b1 = y1 * c.y - x1 * s.y;
    }
  }
}

// Write a 16-row accumulator tile as bfloat16 into rows r0.. of `stage`
// (the warp's own rows), then copy its rows below S to `out` 16 bytes a
// lane.
template <int HD>
__device__ __forceinline__ void store_tile(const float (&acc)[HD / 8][4],
                                           __nv_bfloat16* stage,
                                           __nv_bfloat16* __restrict__ out,
                                           size_t base, size_t tok, int r0,
                                           int S, int g, int t, int lane) {
  constexpr int P = mma_pitch<HD>();
  __nv_bfloat16* st = stage + r0 * P;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(st + g * P + col) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(st + (g + 8) * P + col) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  for (int e = lane; e < 16 * (HD / 8); e += 32) {
    const int r = e / (HD / 8);
    const int col = (e % (HD / 8)) * 8;
    if (r0 + r < S)
      *reinterpret_cast<uint4*>(out + base + (size_t)(r0 + r) * tok + col) =
          *reinterpret_cast<const uint4*>(st + r * P + col);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaMaxWarps * 32)
    attention_bwd_mma(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ cos_t,
                      const float* __restrict__ sin_t,
                      const __nv_bfloat16* __restrict__ d_out,
                      __nv_bfloat16* __restrict__ dq,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, int H,
                      float scale_log2, float scale) {
  constexpr int P = mma_pitch<HD>();
  constexpr int HALF = HD / 2;
  constexpr int CH = HALF / 8;  // 16-byte chunks in half a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Sk = mma_rows(S);
  const int PP = Sk + 8;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + Sk * P;
  __nv_bfloat16* vs = ks + Sk * P;
  __nv_bfloat16* os = vs + Sk * P;  // dO
  __nv_bfloat16* ps = os + Sk * P;  // P, Sk x PP
  __nv_bfloat16* dss = ps + Sk * PP;  // dS, Sk x PP

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t tok = (size_t)H * HD;
  const size_t base = (size_t)b * S * tok + (size_t)h * HD;

  // 1. stage q, k (rotated), v and dO; rows S..Sk-1 zero
  for (int e = threadIdx.x; e < Sk * CH; e += blockDim.x) {
    const int s = e / CH;
    const int col = (e % CH) * 8;
    uint4 q0 = make_uint4(0, 0, 0, 0), q1 = q0, k0 = q0, k1 = q0, v0 = q0,
          v1 = q0, o0 = q0, o1 = q0;
    if (s < S) {
      const size_t g = base + (size_t)s * tok + col;
      q0 = *reinterpret_cast<const uint4*>(q + g);
      q1 = *reinterpret_cast<const uint4*>(q + g + HALF);
      k0 = *reinterpret_cast<const uint4*>(k + g);
      k1 = *reinterpret_cast<const uint4*>(k + g + HALF);
      v0 = *reinterpret_cast<const uint4*>(v + g);
      v1 = *reinterpret_cast<const uint4*>(v + g + HALF);
      o0 = *reinterpret_cast<const uint4*>(d_out + g);
      o1 = *reinterpret_cast<const uint4*>(d_out + g + HALF);
      if (cos_t != nullptr) {
        const float4* cp =
            reinterpret_cast<const float4*>(cos_t + s * HALF + col);
        const float4* sp =
            reinterpret_cast<const float4*>(sin_t + s * HALF + col);
        const float4 c0 = cp[0], c1 = cp[1], s0 = sp[0], s1 = sp[1];
        rotate8(q0, q1, c0, c1, s0, s1);
        rotate8(k0, k1, c0, c1, s0, s1);
      }
    }
    const int o = s * P + col;
    *reinterpret_cast<uint4*>(qs + o) = q0;
    *reinterpret_cast<uint4*>(qs + o + HALF) = q1;
    *reinterpret_cast<uint4*>(ks + o) = k0;
    *reinterpret_cast<uint4*>(ks + o + HALF) = k1;
    *reinterpret_cast<uint4*>(vs + o) = v0;
    *reinterpret_cast<uint4*>(vs + o + HALF) = v1;
    *reinterpret_cast<uint4*>(os + o) = o0;
    *reinterpret_cast<uint4*>(os + o + HALF) = o1;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int step = (blockDim.x >> 5) * 16;

  // 2. phase 1: query rows m0..m0+15
  for (int m0 = warp * 16; m0 < Sk; m0 += step) {
    uint32_t qa[HD / 16][4], oa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int o = (m0 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(qa[kk], qs + o);
      ldsm_x4(oa[kk], os + o);
    }
    // (a) row max and sum of the softmax, base 2, online over the keys
    float mx[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};  // this thread's part of the sums
    for (int n0 = 0; n0 < Sk; n0 += 16) {
      float sc[2][4];
      row_products<HD>(sc, qa, ks, n0, lane);
      float rmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + nt * 8 + 2 * t + (e & 1);
          sc[nt][e] = key < S ? sc[nt][e] * scale_log2 : -INFINITY;
          rmax[e >> 1] = fmaxf(rmax[e >> 1], sc[nt][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
        rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
        const float m_new = fmaxf(mx[r], rmax[r]);  // finite: key 0 is real
        l[r] *= exp2f(mx[r] - m_new);
        mx[r] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(sc[nt][e] - mx[e >> 1]);
    }
    // 1 / row sum, or 0 for a padded row: its P and dS are 0
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = m0 + g + 8 * r < S ? 1.0f / l[r] : 0.0f;
    }
    // P of the tile at keys n0..n0+15, from its scores, in place
    auto probabilities = [&](float (&sc)[2][4], int n0) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + nt * 8 + 2 * t + (e & 1);
          sc[nt][e] = key < S ? exp2f(sc[nt][e] * scale_log2 - mx[e >> 1]) *
                                    inv[e >> 1]
                              : 0.0f;
        }
    };
    // (b) delta = rowsum(P o dP), dP = dO V^T
    float delta[2] = {0.0f, 0.0f};
    for (int n0 = 0; n0 < Sk; n0 += 16) {
      float sc[2][4], dp[2][4];
      row_products<HD>(sc, qa, ks, n0, lane);
      row_products<HD>(dp, oa, vs, n0, lane);
      probabilities(sc, n0);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) delta[e >> 1] += sc[nt][e] * dp[nt][e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    }
    // (c) P and dS to shared memory; dQr = dS Kr
    float acc[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    for (int n0 = 0; n0 < Sk; n0 += 16) {
      float sc[2][4], dp[2][4];
      row_products<HD>(sc, qa, ks, n0, lane);
      row_products<HD>(dp, oa, vs, n0, lane);
      probabilities(sc, n0);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[nt][e] = sc[nt][e] * (dp[nt][e] - delta[e >> 1]) * scale;
        const int o = (m0 + g) * PP + n0 + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(ps + o) = pack_bf16(sc[nt][0], sc[nt][1]);
        *reinterpret_cast<uint32_t*>(ps + o + 8 * PP) =
            pack_bf16(sc[nt][2], sc[nt][3]);
        *reinterpret_cast<uint32_t*>(dss + o) = pack_bf16(dp[nt][0], dp[nt][1]);
        *reinterpret_cast<uint32_t*>(dss + o + 8 * PP) =
            pack_bf16(dp[nt][2], dp[nt][3]);
      }
      // dS's accumulators are its A fragment
      const uint32_t da[4] = {pack_bf16(dp[0][0], dp[0][1]),
                              pack_bf16(dp[0][2], dp[0][3]),
                              pack_bf16(dp[1][0], dp[1][1]),
                              pack_bf16(dp[1][2], dp[1][3])};
      times_rows<HD>(acc, da, ks, n0, lane);
    }
    // dq = rot^-1(dQr), stored from the fragments (4 bytes a lane: the
    // warp's staging rows are still read by the other warps)
    unrotate<HD>(acc, cos_t, sin_t, m0, g, t, S);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + g + 8 * half;
      if (row >= S) continue;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(dq + base + (size_t)row * tok + n * 8 +
                                     2 * t) =
            pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
  __syncthreads();

  // 3. phase 2: key rows n0..n0+15; dV = P^T dO, dKr = dS^T Qr
  for (int n0 = warp * 16; n0 < Sk; n0 += step) {
    float av[HD / 8][4], ak[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      av[n][0] = av[n][1] = av[n][2] = av[n][3] = 0.0f;
      ak[n][0] = ak[n][1] = ak[n][2] = ak[n][3] = 0.0f;
    }
    for (int i0 = 0; i0 < Sk; i0 += 16) {
      // A fragments of P^T and dS^T (rows = keys, depth = queries i0..)
      uint32_t pa[4], da[4];
      const int o = (i0 + ((lane >> 4) << 3) + (lane & 7)) * PP + n0 +
                    ((lane >> 3) & 1) * 8;
      ldsm_x4_trans(pa, ps + o);
      ldsm_x4_trans(da, dss + o);
      times_rows<HD>(av, pa, os, i0, lane);
      times_rows<HD>(ak, da, qs, i0, lane);
    }
    unrotate<HD>(ak, cos_t, sin_t, n0, g, t, S);
    // Kr and v are no longer read: the warp's own rows stage dk and dv
    store_tile<HD>(ak, ks, dk, base, tok, n0, S, g, t, lane);
    store_tile<HD>(av, vs, dv, base, tok, n0, S, g, t, lane);
  }
}

// ---------------------------------------------------------------- f32 --

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc += p * v, componentwise over v's four columns
__device__ __forceinline__ void axpy4(float p, float4 v, float4& acc) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

__device__ __forceinline__ float4 rotate_back0(float4 x0, float4 x1, float4 c,
                                               float4 s) {
  return make_float4(x0.x * c.x + x1.x * s.x, x0.y * c.y + x1.y * s.y,
                     x0.z * c.z + x1.z * s.z, x0.w * c.w + x1.w * s.w);
}
__device__ __forceinline__ float4 rotate_back1(float4 x0, float4 x1, float4 c,
                                               float4 s) {
  return make_float4(x1.x * c.x - x0.x * s.x, x1.y * c.y - x0.y * s.y,
                     x1.z * c.z - x0.z * s.z, x1.w * c.w - x0.w * s.w);
}

// Shared-memory layout of the float32 kernel, in floats: q, k, v and dO
// rows of hd + 4, P and dS rows of Sp + 4, Sp = S rounded up to 4.
struct SimtLayout {
  int Sp, qp, pp;
  __host__ __device__ SimtLayout(int S, int hd)
      : Sp((S + 3) & ~3), qp(hd + 4), pp(((S + 3) & ~3) + 4) {}
  __host__ __device__ size_t floats() const {
    return (size_t)Sp * (4 * qp + 2 * pp);
  }
};

// Register-tile items of the two product stages: scores and dP (4 x 4
// each), then dQ, dV and dK (4 x 8 each).
__host__ __device__ inline int simt_items(int S, int hd) {
  const int Ni = ((S + 3) & ~3) / 4;
  const int a = 2 * Ni * Ni, b = 3 * Ni * (hd / 8);
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kSimtMaxThreads, 2)
    attention_bwd_simt(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ cos_t,
                       const float* __restrict__ sin_t,
                       const float* __restrict__ d_out, float* __restrict__ dq,
                       float* __restrict__ dk, float* __restrict__ dv, int S,
                       int H, int hd, float scale) {
  extern __shared__ __align__(16) float smem[];
  const SimtLayout L(S, hd);
  const int Sp = L.Sp, QP = L.qp, PP = L.pp;
  const int Ni = Sp / 4;  // a thread's rows (and keys) are Ni apart
  float* qs = smem;
  float* ks = qs + Sp * QP;
  float* vs = ks + Sp * QP;
  float* os = vs + Sp * QP;  // dO
  float* p = os + Sp * QP;   // scores, then P
  float* ds = p + Sp * PP;   // dP, then dS

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t tok = (size_t)H * hd;
  const size_t base = (size_t)b * S * tok + (size_t)h * hd;
  const int half = hd / 2;
  const int CH = half / 4;

  // 1. stage q, k (rotated), v and dO, 16 bytes at a time; rows S..Sp-1 zero
  for (int e = threadIdx.x; e < Sp * CH; e += blockDim.x) {
    const int s = e / CH;
    const int col = (e % CH) * 4;
    const float4 zero = make_float4(0, 0, 0, 0);
    float4 q0 = zero, q1 = zero, k0 = zero, k1 = zero, v0 = zero, v1 = zero,
           o0 = zero, o1 = zero;
    if (s < S) {
      const size_t g = base + (size_t)s * tok + col;
      q0 = ld4(q + g);
      q1 = ld4(q + g + half);
      k0 = ld4(k + g);
      k1 = ld4(k + g + half);
      v0 = ld4(v + g);
      v1 = ld4(v + g + half);
      o0 = ld4(d_out + g);
      o1 = ld4(d_out + g + half);
      if (cos_t != nullptr) {
        const float4 c = ld4(cos_t + s * half + col);
        const float4 sn = ld4(sin_t + s * half + col);
        const float4 a = q0, bq = q1, ka = k0, kb = k1;
        q0 = make_float4(a.x * c.x - bq.x * sn.x, a.y * c.y - bq.y * sn.y,
                         a.z * c.z - bq.z * sn.z, a.w * c.w - bq.w * sn.w);
        q1 = make_float4(a.x * sn.x + bq.x * c.x, a.y * sn.y + bq.y * c.y,
                         a.z * sn.z + bq.z * c.z, a.w * sn.w + bq.w * c.w);
        k0 = make_float4(ka.x * c.x - kb.x * sn.x, ka.y * c.y - kb.y * sn.y,
                         ka.z * c.z - kb.z * sn.z, ka.w * c.w - kb.w * sn.w);
        k1 = make_float4(ka.x * sn.x + kb.x * c.x, ka.y * sn.y + kb.y * c.y,
                         ka.z * sn.z + kb.z * c.z, ka.w * sn.w + kb.w * c.w);
      }
    }
    const int o = s * QP + col;
    *reinterpret_cast<float4*>(qs + o) = q0;
    *reinterpret_cast<float4*>(qs + o + half) = q1;
    *reinterpret_cast<float4*>(ks + o) = k0;
    *reinterpret_cast<float4*>(ks + o + half) = k1;
    *reinterpret_cast<float4*>(vs + o) = v0;
    *reinterpret_cast<float4*>(vs + o + half) = v1;
    *reinterpret_cast<float4*>(os + o) = o0;
    *reinterpret_cast<float4*>(os + o + half) = o1;
  }
  __syncthreads();

  // 2. scores = scale Qr Kr^T into p, dP = dO V^T into ds: rows ti + a Ni
  //    and keys tj + c Ni, a, c < 4
  for (int e = threadIdx.x; e < 2 * Ni * Ni; e += blockDim.x) {
    const bool is_dp = e >= Ni * Ni;
    const int e2 = is_dp ? e - Ni * Ni : e;
    const int ti = e2 / Ni;
    const int tj = e2 % Ni;
    const float* A = is_dp ? os : qs;
    const float* Bm = is_dp ? vs : ks;
    float acc[4][4] = {};
    for (int d = 0; d < hd; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qa[a] = ld4(A + (ti + a * Ni) * QP + d);
        kb[a] = ld4(Bm + (tj + a * Ni) * QP + d);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = dot4(qa[a], kb[c], acc[a][c]);
    }
    float* out = is_dp ? ds : p;
    const float mul = is_dp ? 1.0f : scale;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        out[(ti + a * Ni) * PP + tj + c * Ni] = mul * acc[a][c];
  }
  __syncthreads();

  // 3. per row, one warp: softmax over the S real keys, then dS = P (dP -
  //    sum_j dP P) scale; keys S..Sp-1 get P = dS = 0.  Rows past S are
  //    never read.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int i = warp; i < S; i += nwarps) {
    float* row = p + i * PP;
    float* drow = ds + i * PP;
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
    float delta = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float pj = row[j] / sum;
      row[j] = pj;
      delta = fmaf(drow[j], pj, delta);
    }
    for (int o = 16; o > 0; o >>= 1)
      delta += __shfl_xor_sync(0xffffffffu, delta, o);
    for (int j = lane; j < Sp; j += 32) {
      if (j < S) {
        drow[j] = row[j] * (drow[j] - delta) * scale;
      } else {
        row[j] = 0.0f;
        drow[j] = 0.0f;
      }
    }
  }
  __syncthreads();

  // 4. dQ (rows ti + a Ni), dV and dK (keys 4 tj + a), each at columns
  //    c0..c0+3 and c0 + hd/2..c0 + hd/2 + 3, c0 = 4 tc
  const int C8 = hd / 8;
  const int n1 = Ni * C8;
  for (int e = threadIdx.x; e < 3 * n1; e += blockDim.x) {
    const int kind = e / n1;  // 0 dQ, 1 dV, 2 dK
    const int e2 = e - kind * n1;
    const int tr = e2 / C8;
    const int c0 = 4 * (e2 % C8);
    float4 a0[4], a1[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) a0[a] = a1[a] = make_float4(0, 0, 0, 0);
    if (kind == 0) {
      // dQr = dS Kr, over the keys 4 at a time
      for (int j = 0; j < Sp; j += 4) {
        float4 da[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) da[a] = ld4(ds + (tr + a * Ni) * PP + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 k0 = ld4(ks + (j + jj) * QP + c0);
          const float4 k1 = ld4(ks + (j + jj) * QP + c0 + half);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float w = jj == 0   ? da[a].x
                            : jj == 1 ? da[a].y
                            : jj == 2 ? da[a].z
                                      : da[a].w;
            axpy4(w, k0, a0[a]);
            axpy4(w, k1, a1[a]);
          }
        }
      }
    } else {
      // dV = P^T dO or dKr = dS^T Qr, an outer product over the queries
      const float* A = kind == 1 ? p : ds;
      const float* Bm = kind == 1 ? os : qs;
      for (int i = 0; i < S; ++i) {
        const float4 w = ld4(A + i * PP + 4 * tr);
        const float4 b0 = ld4(Bm + i * QP + c0);
        const float4 b1 = ld4(Bm + i * QP + c0 + half);
        axpy4(w.x, b0, a0[0]);
        axpy4(w.x, b1, a1[0]);
        axpy4(w.y, b0, a0[1]);
        axpy4(w.y, b1, a1[1]);
        axpy4(w.z, b0, a0[2]);
        axpy4(w.z, b1, a1[2]);
        axpy4(w.w, b0, a0[3]);
        axpy4(w.w, b1, a1[3]);
      }
    }
    float* out = kind == 0 ? dq : kind == 1 ? dv : dk;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int s = kind == 0 ? tr + a * Ni : 4 * tr + a;
      if (s >= S) continue;
      float4 x0 = a0[a], x1 = a1[a];
      if (kind != 1 && cos_t != nullptr) {
        const float4 c = ld4(cos_t + s * half + c0);
        const float4 sn = ld4(sin_t + s * half + c0);
        x0 = rotate_back0(a0[a], a1[a], c, sn);
        x1 = rotate_back1(a0[a], a1[a], c, sn);
      }
      float* dst = out + base + (size_t)s * tok + c0;
      *reinterpret_cast<float4*>(dst) = x0;
      *reinterpret_cast<float4*>(dst + half) = x1;
    }
  }
}

// --------------------------------------------------------------- launch --

// A kernel's dynamic shared-memory limit is raised to the device's opt-in
// maximum once per (kernel, device), not on every launch; the wrapper
// refuses shapes above that maximum.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<bool> (&raised)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (raised[dev].load()) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  raised[dev].store(true);
  return cudaSuccess;
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const float* cos_t,
               const float* sin_t, const void* d_out, void* dq, void* dk,
               void* dv, int B, int S, int H, void* stream) {
  static std::atomic<bool> raised[kMaxDevices];
  cudaError_t err = allow_smem(attention_bwd_mma<HD>, raised);
  if (err != cudaSuccess) return (int)err;
  const int Sk = mma_rows(S);
  const size_t smem = sizeof(__nv_bfloat16) *
                      (4 * (size_t)Sk * mma_pitch<HD>() +
                       2 * (size_t)Sk * (Sk + 8));
  const int warps = Sk / 16 < kMmaMaxWarps ? Sk / 16 : kMmaMaxWarps;
  const float scale = 1.0f / sqrtf((float)HD);
  attention_bwd_mma<HD><<<B * H, warps * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, cos_t, sin_t, (const __nv_bfloat16*)d_out,
      (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, H,
      1.4426950408889634f * scale, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/attention.py.
// q, k, v, d_out, dq, dk, dv contiguous (B, S, H, hd) and 16-byte aligned;
// cos, sin contiguous (S, hd/2) float32, 16-byte aligned, or both null.
// float32 takes hd a multiple of 8, bfloat16 hd 16, 32, 64 or 128.  The
// wrapper checks shapes, types, alignment and the shared memory size.
// Returns the CUDA error of the attribute call or launch.
extern "C" int attention_bwd_f32(const void* q, const void* k, const void* v,
                                 const float* cos_t, const float* sin_t,
                                 const void* d_out, void* dq, void* dk,
                                 void* dv, int B, int S, int H, int hd,
                                 void* stream) {
  static std::atomic<bool> raised[kMaxDevices];
  cudaError_t err = allow_smem(attention_bwd_simt, raised);
  if (err != cudaSuccess) return (int)err;
  const int items = simt_items(S, hd);
  const int threads = items >= kSimtMaxThreads ? kSimtMaxThreads
                                               : (items + 31) / 32 * 32;
  attention_bwd_simt<<<B * H, threads,
                       sizeof(float) * SimtLayout(S, hd).floats(),
                       (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, cos_t, sin_t,
      (const float*)d_out, (float*)dq, (float*)dk, (float*)dv, S, H, hd,
      1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

extern "C" int attention_bwd_bf16(const void* q, const void* k, const void* v,
                                  const float* cos_t, const float* sin_t,
                                  const void* d_out, void* dq, void* dk,
                                  void* dv, int B, int S, int H, int hd,
                                  void* stream) {
  switch (hd) {
    case 16:
      return launch_mma<16>(q, k, v, cos_t, sin_t, d_out, dq, dk, dv, B, S, H,
                            stream);
    case 32:
      return launch_mma<32>(q, k, v, cos_t, sin_t, d_out, dq, dk, dv, B, S, H,
                            stream);
    case 64:
      return launch_mma<64>(q, k, v, cos_t, sin_t, d_out, dq, dk, dv, B, S, H,
                            stream);
    case 128:
      return launch_mma<128>(q, k, v, cos_t, sin_t, d_out, dq, dk, dv, B, S,
                             H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
