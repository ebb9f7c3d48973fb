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
// dq, dk, dv are written in the input type at the strides q, k, v are
// read at: a token stride ld_tok and a head stride ld_head (elements; H hd
// and hd for contiguous (B, S, H, hd) tensors, 3 H hd and 3 hd for the
// views of one packed (B, S, H, 3, hd) projection, fused_proj's wqkv
// product, whose gradient is then one packed dqkv tensor and one product
// in the projection's backward).  dO is contiguous (B, S, H, hd).
// One block per (batch, head), as in the forward, so each block owns its
// dq, dk, dv slices and needs no atomics; it reads its rows with 16-byte
// loads, rotates q and k in float32 as it stages them in shared memory,
// and takes the softmax over the S real keys.  No log-sum-exp is saved by
// the whole-sequence forward, so P is recomputed here.  The key-tiled
// forms (section "tiled" below) take the sequences that fit no block.
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

#include "attention_tiles.cuh"

namespace {

constexpr int kMmaMaxWarps = 8;  // a warp loops over 16-row tiles
constexpr int kSimtMaxThreads = 320;  // two blocks per SM at 96 registers

// ---------------------------------------------------------------- bf16 --
// The fragment helpers, rotate8 and mma_pitch are attention_tiles.cuh's.
// Rows of q, k, v, dO: hd + 8 bfloat16; rows of P and dS: Sk + 8, Sk = S
// rounded up to 16.  Both make ldmatrix's eight 16-byte row reads land on
// eight different 4-bank groups.
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

// The two products of a warp's 16 rows against the first nc 16-row chunks
// of a walked tile, all chunks at once (4 NC independent m16n8 sums): c =
// a (16 x hd, A fragments) times rows of bs transposed, d = b times rows
// of ds transposed; chunks past nc are left 0.
template <int HD, int NC>
__device__ __forceinline__ void tile_products(
    float (&c)[2 * NC][4], float (&d)[2 * NC][4],
    const uint32_t (&a)[HD / 16][4], const uint32_t (&b)[HD / 16][4],
    const __nv_bfloat16* bs, const __nv_bfloat16* ds, int nc, int lane) {
  constexpr int P = mma_pitch<HD>();
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = d[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int ch = 0; ch < NC; ++ch)
      if (ch < nc) {
        const int off = (16 * ch + (lane & 7) + ((lane >> 4) << 3)) * P +
                        kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t x[4], y[4];
        ldsm_x4(x, bs + off);
        ldsm_x4(y, ds + off);
        mma_bf16(c[2 * ch], a[kk], x[0], x[1]);
        mma_bf16(c[2 * ch + 1], a[kk], x[2], x[3]);
        mma_bf16(d[2 * ch], b[kk], y[0], y[1]);
        mma_bf16(d[2 * ch + 1], b[kk], y[2], y[3]);
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
                      int ld_tok, int ld_head, float scale_log2,
                      float scale) {
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
  const size_t ibase = (size_t)b * S * ld_tok + (size_t)h * ld_head;

  // 1. stage q, k (rotated), v and dO; rows S..Sk-1 zero
  for (int e = threadIdx.x; e < Sk * CH; e += blockDim.x) {
    const int s = e / CH;
    const int col = (e % CH) * 8;
    uint4 q0 = make_uint4(0, 0, 0, 0), q1 = q0, k0 = q0, k1 = q0, v0 = q0,
          v1 = q0, o0 = q0, o1 = q0;
    if (s < S) {
      const size_t g = ibase + (size_t)s * ld_tok + col;
      const size_t go = base + (size_t)s * tok + col;
      q0 = *reinterpret_cast<const uint4*>(q + g);
      q1 = *reinterpret_cast<const uint4*>(q + g + HALF);
      k0 = *reinterpret_cast<const uint4*>(k + g);
      k1 = *reinterpret_cast<const uint4*>(k + g + HALF);
      v0 = *reinterpret_cast<const uint4*>(v + g);
      v1 = *reinterpret_cast<const uint4*>(v + g + HALF);
      o0 = *reinterpret_cast<const uint4*>(d_out + go);
      o1 = *reinterpret_cast<const uint4*>(d_out + go + HALF);
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
        *reinterpret_cast<uint32_t*>(dq + ibase + (size_t)row * ld_tok + n * 8 +
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
    store_tile<HD>(ak, ks, dk, ibase, ld_tok, n0, S, g, t, lane);
    store_tile<HD>(av, vs, dv, ibase, ld_tok, n0, S, g, t, lane);
  }
}

// ---------------------------------------------------------------- f32 --
// ld4, dot4 and axpy4 are attention_tiles.cuh's.

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
                       int H, int hd, int ld_tok, int ld_head, float scale) {
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
  const size_t ibase = (size_t)b * S * ld_tok + (size_t)h * ld_head;
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
      const size_t g = ibase + (size_t)s * ld_tok + col;
      const size_t go = base + (size_t)s * tok + col;
      q0 = ld4(q + g);
      q1 = ld4(q + g + half);
      k0 = ld4(k + g);
      k1 = ld4(k + g + half);
      v0 = ld4(v + g);
      v1 = ld4(v + g + half);
      o0 = ld4(d_out + go);
      o1 = ld4(d_out + go + half);
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
      float* dst = out + ibase + (size_t)s * ld_tok + c0;
      *reinterpret_cast<float4*>(dst) = x0;
      *reinterpret_cast<float4*>(dst + half) = x1;
    }
  }
}

// -------------------------------------------------------------- tiled --
//
// The key-tiled forms (attention_bwd_tiled_f32, attention_bwd_tiled_bf16)
// replace the same pallas_call (_attn_bwd) at the shapes the route gives
// the tiled forward (S 260 at image 256: 832,000 bytes in float32, 461,312
// in bfloat16 above).  They compute what _bwd_kernel computes, with P
// recomputed tile by tile from the forward's log-sum-exp (attention_fwd.cu,
// tiled section) and the softmax's row term taken as delta = rowsum(dO o
// O), which equals rowsum(dP o P):
//
//   P = exp(scale Qr Kr^T - lse),  dS = P o (dO V^T - delta) scale
//   dV = P^T dO,  dKr = dS^T Qr,  dQr = dS Kr,  then rot(-theta)
//
// One launch, two kinds of block, no atomics: grid (batch x head, 2 nb).
// The first nb blocks of a (batch, head) own key units and walk the query
// tiles, summing dKr and dV; the last nb own query units and walk the key
// tiles, summing dQr, each in a fixed order.  Each gradient row is written
// by one block, so the gradients are the same bits on every run (the
// port's bit-equal resume rests on it).  The key blocks come first in the
// grid: they do four products a pair of tiles against the query blocks'
// three, and start first.  Units, ring and preparation as in
// attention_tiles.cuh: the walked tiles (K and V; or Qr, dO and lse) come
// through a ring of shared-memory stages, the tables and the key blocks'
// tile of O through one buffer for each tile in flight.  delta is
// recomputed where it is needed, from O and dO: a query block for its own
// rows once, a key block for each query tile by the threads that copied
// its O and dO, so no second launch and no scratch tensor.  Keys and
// queries past S get P = dS = 0.  Shared memory does not depend on S.
//
// What bounds it: at image 256's shape (B 4, S 260, H 8, hd 64) the
// function moves seven (B, S, H, hd) tensors and the tables, 15.0 MB in
// float32 (7.5 MB in bfloat16), and does five S x S x hd products, 10 B H
// S^2 hd = 1.4 GFLOP: the float32 form is bound by the CUDA cores' rate
// (20.7 us at 67 TFLOP/s; its bytes take 4.5 us), the bfloat16 form by HBM
// bandwidth (2.2 us; the tensor cores need 1.4 us).  The two kinds
// recompute the scores and dP each, seven products where the fused form
// does five, and each block walks the whole other side of its (batch,
// head).  The float32 form is held by shared-memory reads and by its
// registers (about 220 a thread: its two sets of accumulators), which cap
// the warps an SM holds; the bfloat16 one by each walk's chain of
// dependent steps, a tile's copies, rotation and row term, then its four
// products.  The design: blocks of 9 units (2 a kind and (batch, head),
// 128 blocks, one wave, one block an SM); for bfloat16, two producer warps
// copy each walked tile into a ring four deep, rotate it and (key blocks)
// sum its row term, while the unit warps run the products of the tiles
// before it.
//
// float32 (attention_bwd_tiled_simt, head_dim <= 128): walked tiles of
// 32; scores and dP (or their transposes) in 4 x 4 register tiles, P and
// dS (or P^T and dS^T) through the warp's scratch rows, and dQr, or dKr
// and dV, in registers for the whole walk, at the columns c..c+3 and
// c + hd/2..c + hd/2 + 3 of a thread, so that the inverse rotation needs
// no exchange.  Up to head_dim 64 9 units a block, 173 KB of shared
// memory at hd 64 (the key blocks'); up to 128 4 units.  Wider head_dims
// (up to 280) keep the shared-memory form (attention_bwd_tiled_simt_wide).
//
// bfloat16 (attention_bwd_tiled_mma): 9 unit warps and 2 producer warps a
// block, walked tiles of 32 in four stages (three at hd 128); a stage's
// full and free states are named barriers (bar_arrive by the side that
// hands it over, bar_wait by the other).  Products on mma.sync as in the
// whole-sequence form.  A
// query warp holds its Qr and dO rows as A fragments, computes the scores
// and dP of a landed key tile at once (eight independent m16n8 sums) and
// sums dQr += dS Kr with dS's accumulators as its A fragment.  A key warp
// holds its Kr and v rows as A fragments and computes the transposed tiles
// S^T = Kr Qr^T and dP^T = V dO^T of a landed query tile at once, so that
// P^T and dS^T come out as A fragments for dV += P^T dO and dKr += dS^T Qr
// (dO and Qr read with ldmatrix.trans).
// Gradients leave from the fragments, 4 bytes a lane.  128 KB at hd 64.

// units a block of the float32 tiled backward: above head_dim 64 four,
// what fits beside its wider rows
__host__ __device__ constexpr int simt_bwd_units(int hd) {
  return hd <= 64 ? kSimtBwdUnits : 4;
}

// floats of shared memory of the float32 tiled backward, the key block's
// (the query block's fits in it): its key and value rows; a ring of two
// query and output-gradient tiles with their lse and delta; one tile of
// the forward's output and its tables; each warp's P^T and dS^T

__host__ __device__ inline size_t tiled_simt_floats(int hd) {
  const int U = simt_bwd_units(hd);
  return (size_t)(32 * U + 5 * kSimtWalk) * (hd + 4) +
         4 * kSimtWalk + (size_t)kSimtWalk * hd +
         (size_t)U * 2 * 16 * kSimtScratch;
}

// floats of the wide form: six row tiles of hd + 4, P and dS in rows of
// 36, the tile's lse and delta
__host__ __device__ inline size_t tiled_simt_wide_floats(int hd) {
  return (size_t)6 * kTileF32 * (hd + 4) + 2 * kTileF32 * (kTileF32 + 4) +
         2 * kTileF32;
}

// bytes of the bfloat16 tiled backward, the key block's: its key and value
// rows, a ring of query and output-gradient tiles in rows of hd + 8 with
// their lse and delta, and for each stage its tile's O and tables
// stages of the bfloat16 tiled backward's ring: three at head_dim 128,
// what fits beside its wider rows
template <int HD>
__host__ __device__ constexpr int mma_bwd_stages() {
  return HD <= 64 ? kMmaBwdStages : 3;
}

template <int HD>
constexpr size_t tiled_mma_bytes() {
  constexpr size_t TW = kMmaBwdWalk, P = mma_pitch<HD>();
  return 2 * 32 * kMmaBwdUnits * P +
         mma_bwd_stages<HD>() * (2 * 2 * TW * P + 2 * 4 * TW) +
         mma_bwd_stages<HD>() * (2 * TW * P + 4 * TW * HD);
}

// delta = rowsum(dO o O) of the rows whose chunks this thread's quad
// copied (async_quads), into delta_s; four lanes a row, summed by shuffles
// (the loop's trip count is uniform in a warp)
__device__ __forceinline__ void row_delta_f32(float* delta_s, const float* gs,
                                              const float* os, int pitch,
                                              int rows, int cols, int tid,
                                              int nthreads) {
  for (int e = tid; e < 4 * rows; e += nthreads) {
    const int r = e >> 2;
    float d = 0.0f;
    for (int c = (e & 3) * 4; c < cols; c += 16)
      d = dot4(ld4(gs + r * pitch + c), ld4(os + r * pitch + c), d);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if ((e & 3) == 0) delta_s[r] = d;
  }
}

// The bfloat16 counterpart: float32 sums of the bfloat16 values.
template <int HD>
__device__ __forceinline__ void row_delta_mma(float* delta_s,
                                              const __nv_bfloat16* gs,
                                              const __nv_bfloat16* os,
                                              int rows, int tid,
                                              int nthreads) {
  constexpr int P = mma_pitch<HD>();
  for (int e = tid; e < 4 * rows; e += nthreads) {
    const int r = e >> 2;
    float d = 0.0f;
    for (int c = (e & 3) * 8; c < HD; c += 32) {
      const uint4 a = *reinterpret_cast<const uint4*>(os + r * P + c);
      const uint4 w = *reinterpret_cast<const uint4*>(gs + r * P + c);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w};
      const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        d = fmaf(bf16_lo(av[i]), bf16_lo(wv[i]), d);
        d = fmaf(bf16_hi(av[i]), bf16_hi(wv[i]), d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if ((e & 3) == 0) delta_s[r] = d;
  }
}

template <int NP, int U>
__global__ void __launch_bounds__(U * 32)
    attention_bwd_tiled_simt(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ cos_t,
        const float* __restrict__ sin_t, const float* __restrict__ o,
        const float* __restrict__ lse, const float* __restrict__ d_out,
        float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
        int S, int H, int hd, int ld_tok, int ld_head, float scale) {
  constexpr int TW = kSimtWalk;
  constexpr int PP = kSimtScratch;
  extern __shared__ __align__(16) float smem[];
  const int QP = hd + 4;
  const int half = hd / 2;
  const int stage = 2 * TW * QP + 2 * TW;  // floats of a ring stage
  float* xs = smem;                        // own rows: Qr (key block: Kr)
  float* ys = xs + 16 * U * QP;   // own rows: dO (key block: V)
  float* ring = ys + 16 * U * QP;
  float* obuf = ring + 2 * stage;          // key block: the next tile's O
  float* cs = obuf + TW * QP;              // the next walked tile's tables
  float* sn = cs + TW * half;
  float* scratch = sn + TW * half;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int nb = blocks_per_head(S, U);
  const bool key_kind = (int)blockIdx.y < nb;
  const UnitSpan span = unit_span((S + 15) / 16, nb,
                                  key_kind ? blockIdx.y : blockIdx.y - nb);
  const int warp = threadIdx.x >> 5;
  if (warp >= span.n) return;  // no unit: leave before any barrier
  const int tid = threadIdx.x;
  const int nthreads = span.n * 32;
  const int lane = tid & 31;
  const int rg = lane >> 3;  // own rows rg + 4 a of the warp's unit
  const int cg = lane & 7;   // walked rows cg + 8 c; columns 4 cg + 32 i
  const int t0 = span.u0 * 16;
  const int r0 = t0 + warp * 16;  // the warp's first own row
  const size_t tok = (size_t)H * hd;
  const size_t base = (size_t)b * S * tok + (size_t)h * hd;
  const size_t ibase = (size_t)b * S * ld_tok + (size_t)h * ld_head;
  const size_t lbase = (size_t)bh * S;
  const bool rope = cos_t != nullptr;
  const int ntiles = (S + TW - 1) / TW;
  const float* xw = xs + warp * 16 * QP;
  const float* yw = ys + warp * 16 * QP;

  // own accumulators at columns 4 cg + 32 i and + hd/2: dQr (query block),
  // or dKr and dV (key block)
  float4 a0[4][NP], a1[4][NP], b0[4][NP], b1[4][NP];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < NP; ++i)
      a0[a][i] = a1[a][i] = b0[a][i] = b1[a][i] = make_float4(0, 0, 0, 0);

  if (!key_kind) {
    auto issue = [&](int j) {  // K (with its tables) and V of key tile j
      float* st = ring + (j & 1) * stage;
      async_pairs(st, QP, cs, sn, k, ibase, ld_tok, cos_t, sin_t, j * TW, TW,
                  S, half, tid, nthreads);
      async_rows(st + TW * QP, QP, v, ibase, ld_tok, j * TW, TW, S, hd, tid,
                 nthreads);
      cp_async_commit();
    };
    issue(0);
    stage_rows_f32(xs, QP, q, ibase, ld_tok, t0, span.n * 16, S, hd, cos_t,
                   sin_t, tid, nthreads);
    stage_rows_f32(ys, QP, d_out, base, tok, t0, span.n * 16, S, hd,
                   nullptr, nullptr, tid, nthreads);
    // the own rows' lse and delta = rowsum(dO o O): a row's 8 lanes split
    // its columns
    float lr[4], dr[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = r0 + rg + 4 * a;
      float d = 0.0f;
      lr[a] = 0.0f;
      if (row < S) {
        for (int c = 4 * cg; c < hd; c += 32)
          d = dot4(ld4(o + base + (size_t)row * tok + c),
                   ld4(d_out + base + (size_t)row * tok + c), d);
        lr[a] = lse[lbase + row];
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 4);
      dr[a] = d;
    }
    float* dsw = scratch + warp * 16 * PP;
    for (int j = 0; j < ntiles; ++j) {
      cp_async_wait<0>();  // this thread's copies of tile j
      float* ks = ring + (j & 1) * stage;
      const float* vs = ks + TW * QP;
      if (rope) rotate_pairs_f32(ks, QP, cs, sn, TW, half, tid, nthreads);
      bar_sync(nthreads);  // tile j ready; tile j - 1, the tables unread
      if (j + 1 < ntiles) issue(j + 1);
      // scores and dP of own rows rg + 4 a and keys cg + 8 c
      float s[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < hd; d += 4) {
        float4 xa[4], wb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xa[a] = ld4(xw + (rg + 4 * a) * QP + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) wb[c] = ld4(ks + (cg + 8 * c) * QP + d);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] = dot4(xa[a], wb[c], s[a][c]);
      }
#pragma unroll 4
      for (int d = 0; d < hd; d += 4) {
        float4 xa[4], wb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xa[a] = ld4(yw + (rg + 4 * a) * QP + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) wb[c] = ld4(vs + (cg + 8 * c) * QP + d);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) dp[a][c] = dot4(xa[a], wb[c], dp[a][c]);
      }
      // dS = P (dP - delta) scale, P from the lse; masked entries 0
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool ok = r0 + rg + 4 * a < S && j * TW + cg + 8 * c < S;
          const float p = ok ? expf(scale * s[a][c] - lr[a]) : 0.0f;
          dsw[(rg + 4 * a) * PP + cg + 8 * c] = p * (dp[a][c] - dr[a]) * scale;
        }
      __syncwarp();
      // dQr += dS Kr
#pragma unroll 2
      for (int jj = 0; jj < TW; jj += 4) {
        float4 da[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) da[a] = ld4(dsw + (rg + 4 * a) * PP + jj);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* kr = ks + (jj + u) * QP;
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            const int c = 4 * cg + 32 * i;
            if (c >= half) continue;
            const float4 k0v = ld4(kr + c), k1v = ld4(kr + c + half);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const float w = comp(da[a], u);
              axpy4(w, k0v, a0[a][i]);
              axpy4(w, k1v, a1[a][i]);
            }
          }
        }
      }
      __syncwarp();  // dS is rewritten by the next tile
    }
    // dq = rot^-1(dQr)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = r0 + rg + 4 * a;
      if (row >= S) continue;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int c = 4 * cg + 32 * i;
        if (c >= half) continue;
        float4 x0 = a0[a][i], x1 = a1[a][i];
        if (rope)
          rotate4_back(x0, x1, ld4(cos_t + row * half + c),
                       ld4(sin_t + row * half + c));
        float* dst = dq + ibase + (size_t)row * ld_tok + c;
        st4(dst, x0);
        st4(dst + half, x1);
      }
    }
    return;
  }

  // key block: walks the query tiles
  auto issue = [&](int j) {  // Q (with its tables), dO and O, lse of tile j
    float* st = ring + (j & 1) * stage;
    async_pairs(st, QP, cs, sn, q, ibase, ld_tok, cos_t, sin_t, j * TW, TW,
                S, half, tid, nthreads);
    async_quads(st + TW * QP, obuf, QP, d_out, o, base, tok, j * TW, TW, S,
                hd, tid, nthreads);
    async_values(st + 2 * TW * QP, lse, lbase, j * TW, TW, S, tid, nthreads);
    cp_async_commit();
  };
  issue(0);
  stage_rows_f32(xs, QP, k, ibase, ld_tok, t0, span.n * 16, S, hd, cos_t,
                 sin_t, tid, nthreads);
  stage_rows_f32(ys, QP, v, ibase, ld_tok, t0, span.n * 16, S, hd, nullptr,
                 nullptr, tid, nthreads);
  float* ptw = scratch + warp * 2 * 16 * PP;  // P^T, then dS^T
  float* dtw = ptw + 16 * PP;
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();  // this thread's copies of tile j
    float* qs = ring + (j & 1) * stage;
    const float* gs = qs + TW * QP;  // dO
    const float* lse_s = gs + TW * QP;
    float* delta_s = const_cast<float*>(lse_s) + TW;
    if (rope) rotate_pairs_f32(qs, QP, cs, sn, TW, half, tid, nthreads);
    row_delta_f32(delta_s, gs, obuf, QP, TW, hd, tid, nthreads);
    bar_sync(nthreads);  // tile j ready; tile j - 1, O, the tables unread
    if (j + 1 < ntiles) issue(j + 1);
    // S^T and dP^T of own keys rg + 4 a and queries cg + 8 c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < hd; d += 4) {
      float4 xa[4], wb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xa[a] = ld4(xw + (rg + 4 * a) * QP + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) wb[c] = ld4(qs + (cg + 8 * c) * QP + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = dot4(xa[a], wb[c], s[a][c]);
    }
#pragma unroll 4
    for (int d = 0; d < hd; d += 4) {
      float4 xa[4], wb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xa[a] = ld4(yw + (rg + 4 * a) * QP + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) wb[c] = ld4(gs + (cg + 8 * c) * QP + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) dp[a][c] = dot4(xa[a], wb[c], dp[a][c]);
    }
    // P^T from the lse, dS^T = P^T (dP^T - delta) scale; masked entries 0
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qi = cg + 8 * c;
      const float lq = lse_s[qi];
      const float dl = delta_s[qi];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const bool ok = r0 + rg + 4 * a < S && j * TW + qi < S;
        const float p = ok ? expf(scale * s[a][c] - lq) : 0.0f;
        ptw[(rg + 4 * a) * PP + qi] = p;
        dtw[(rg + 4 * a) * PP + qi] = p * (dp[a][c] - dl) * scale;
      }
    }
    __syncwarp();
    // dV += P^T dO, dKr += dS^T Qr
#pragma unroll 2
    for (int jj = 0; jj < TW; jj += 4) {
      float4 pa[4], da[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pa[a] = ld4(ptw + (rg + 4 * a) * PP + jj);
        da[a] = ld4(dtw + (rg + 4 * a) * PP + jj);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* gr = gs + (jj + u) * QP;
        const float* qr = qs + (jj + u) * QP;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int c = 4 * cg + 32 * i;
          if (c >= half) continue;
          const float4 g0 = ld4(gr + c), g1 = ld4(gr + c + half);
          const float4 x0 = ld4(qr + c), x1 = ld4(qr + c + half);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float w = comp(pa[a], u), z = comp(da[a], u);
            axpy4(w, g0, b0[a][i]);
            axpy4(w, g1, b1[a][i]);
            axpy4(z, x0, a0[a][i]);
            axpy4(z, x1, a1[a][i]);
          }
        }
      }
    }
    __syncwarp();  // P^T and dS^T are rewritten by the next tile
  }
  // dv, and dk = rot^-1(dKr)
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + rg + 4 * a;
    if (row >= S) continue;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int c = 4 * cg + 32 * i;
      if (c >= half) continue;
      float4 x0 = a0[a][i], x1 = a1[a][i];
      if (rope)
        rotate4_back(x0, x1, ld4(cos_t + row * half + c),
                     ld4(sin_t + row * half + c));
      float* dst = dk + ibase + (size_t)row * ld_tok + c;
      st4(dst, x0);
      st4(dst + half, x1);
      dst = dv + ibase + (size_t)row * ld_tok + c;
      st4(dst, b0[a][i]);
      st4(dst + half, b1[a][i]);
    }
  }
}

// lse and delta = rowsum(dO o O) of rows t0..t0+31, a warp a row; rows
// past S get 0
__device__ __forceinline__ void stage_rows_lse_delta_f32(
    float* lse_s, float* delta_s, const float* __restrict__ lse,
    const float* __restrict__ o, const float* __restrict__ d_out, size_t base,
    size_t tok, size_t lbase, int t0, int S, int hd) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < kTileF32; i += blockDim.x / 32) {
    const int s = t0 + i;
    float d = 0.0f;
    if (s < S)
      for (int c = 4 * lane; c < hd; c += 128)
        d = dot4(ld4(o + base + (size_t)s * tok + c),
                 ld4(d_out + base + (size_t)s * tok + c), d);
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    if (lane == 0) {
      delta_s[i] = d;
      lse_s[i] = s < S ? lse[lbase + s] : 0.0f;
    }
  }
}

// P and dS of query rows i = ti + 16 a and keys j = tj + 8 c of the staged
// tiles (qs, os: queries from token q0; ks, vs: keys from token k0), the
// masked ones 0; P to ps (when given) and dS to ds, rows of 36
__device__ __forceinline__ void probabilities_f32(
    float* ps, float* ds, const float* qs, const float* os, const float* ks,
    const float* vs, const float* lse_s, const float* delta_s, int q0, int k0,
    int S, int hd, float scale) {
  constexpr int PP = kTileF32 + 4;
  const int QP = hd + 4;
  for (int e = threadIdx.x; e < 16 * 8; e += blockDim.x) {
    const int ti = e / 8;
    const int tj = e % 8;
    float sc[2][4] = {}, dp[2][4] = {};
    for (int d = 0; d < hd; d += 4) {
      float4 qa[2], oa[2], kb[4], vb[4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        qa[a] = ld4(qs + (ti + 16 * a) * QP + d);
        oa[a] = ld4(os + (ti + 16 * a) * QP + d);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kb[c] = ld4(ks + (tj + 8 * c) * QP + d);
        vb[c] = ld4(vs + (tj + 8 * c) * QP + d);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sc[a][c] = dot4(qa[a], kb[c], sc[a][c]);
          dp[a][c] = dot4(oa[a], vb[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ti + 16 * a;
        const int j = tj + 8 * c;
        const float p = q0 + i < S && k0 + j < S
                            ? expf(scale * sc[a][c] - lse_s[i])
                            : 0.0f;
        if (ps != nullptr) ps[i * PP + j] = p;
        ds[i * PP + j] = p * (dp[a][c] - delta_s[i]) * scale;
      }
  }
}

// The shared-memory float32 tiled backward, for head_dims above kSimtMaxHd (no
// model of the repo has one): tiles of 32, 128 threads; a thread computes
// 2 query rows x 4 keys of the scores and of dP, then P and dS in place;
// dQr, dV and dKr sum in shared memory.
__global__ void __launch_bounds__(kTiledF32Threads)
    attention_bwd_tiled_simt_wide(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ cos_t,
        const float* __restrict__ sin_t, const float* __restrict__ o,
        const float* __restrict__ lse, const float* __restrict__ d_out,
        float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
        int S, int H, int hd, int ld_tok, int ld_head, float scale) {
  constexpr int T = kTileF32;
  constexpr int PP = T + 4;
  extern __shared__ __align__(16) float smem[];
  const int QP = hd + 4;
  const int R = T * QP;  // floats of a row tile; six of them first
  float* ps = smem + 6 * R;
  float* ds = ps + T * PP;
  float* lse_s = ds + T * PP;
  float* delta_s = lse_s + T;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const size_t tok = (size_t)H * hd;
  const size_t base = (size_t)b * S * tok + (size_t)h * hd;
  const size_t ibase = (size_t)b * S * ld_tok + (size_t)h * ld_head;
  const size_t lbase = (size_t)bh * S;
  const int half = hd / 2;
  const int C8 = hd / 8;
  const int ntiles = (S + T - 1) / T;
  const bool dq_kind = (int)blockIdx.y < ntiles;
  const int t0 = (dq_kind ? blockIdx.y : blockIdx.y - ntiles) * T;

  if (dq_kind) {
    float *qs = smem, *os = smem + R, *ks = smem + 2 * R, *vs = smem + 3 * R,
          *acc = smem + 4 * R;
    stage_rows_f32(qs, QP, q, ibase, ld_tok, t0, T, S, hd, cos_t,
                   sin_t, threadIdx.x, blockDim.x);
    stage_rows_f32(os, QP, d_out, base, tok, t0, T, S, hd, nullptr,
                   nullptr, threadIdx.x, blockDim.x);
    stage_rows_lse_delta_f32(lse_s, delta_s, lse, o, d_out, base, tok, lbase,
                             t0, S, hd);
    for (int e = threadIdx.x; e < T * QP; e += blockDim.x) acc[e] = 0.0f;
    for (int k0 = 0; k0 < S; k0 += T) {
      __syncthreads();  // the last key tile and dS are no longer read
      stage_rows_f32(ks, QP, k, ibase, ld_tok, k0, T, S, hd, cos_t,
                     sin_t, threadIdx.x, blockDim.x);
      stage_rows_f32(vs, QP, v, ibase, ld_tok, k0, T, S, hd, nullptr,
                     nullptr, threadIdx.x, blockDim.x);
      __syncthreads();
      probabilities_f32(nullptr, ds, qs, os, ks, vs, lse_s, delta_s, t0, k0,
                        S, hd, scale);
      __syncthreads();
      // dQr += dS Kr: rows ti + 16 a, columns c0..c0+3, c0+half..+3
      for (int e = threadIdx.x; e < 16 * C8; e += blockDim.x) {
        const int ti = e / C8;
        const int c0 = 4 * (e % C8);
        float4 a0[2], a1[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          a0[a] = ld4(acc + (ti + 16 * a) * QP + c0);
          a1[a] = ld4(acc + (ti + 16 * a) * QP + c0 + half);
        }
        for (int j = 0; j < T; j += 4) {
          float4 da[2];
#pragma unroll
          for (int a = 0; a < 2; ++a) da[a] = ld4(ds + (ti + 16 * a) * PP + j);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float4 k0v = ld4(ks + (j + jj) * QP + c0);
            const float4 k1v = ld4(ks + (j + jj) * QP + c0 + half);
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              const float w = jj == 0   ? da[a].x
                              : jj == 1 ? da[a].y
                              : jj == 2 ? da[a].z
                                        : da[a].w;
              axpy4(w, k0v, a0[a]);
              axpy4(w, k1v, a1[a]);
            }
          }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          *reinterpret_cast<float4*>(acc + (ti + 16 * a) * QP + c0) = a0[a];
          *reinterpret_cast<float4*>(acc + (ti + 16 * a) * QP + c0 + half) =
              a1[a];
        }
      }
    }
    __syncthreads();
    // dq = rot^-1(dQr)
    for (int e = threadIdx.x; e < T * C8; e += blockDim.x) {
      const int r = e / C8;
      const int c0 = 4 * (e % C8);
      const int s = t0 + r;
      if (s >= S) continue;
      float4 x0 = ld4(acc + r * QP + c0), x1 = ld4(acc + r * QP + c0 + half);
      if (cos_t != nullptr) {
        const float4 c = ld4(cos_t + s * half + c0);
        const float4 sn = ld4(sin_t + s * half + c0);
        const float4 y0 = rotate_back0(x0, x1, c, sn);
        x1 = rotate_back1(x0, x1, c, sn);
        x0 = y0;
      }
      float* dst = dq + ibase + (size_t)s * ld_tok + c0;
      *reinterpret_cast<float4*>(dst) = x0;
      *reinterpret_cast<float4*>(dst + half) = x1;
    }
    return;
  }

  float *ks = smem, *vs = smem + R, *dk_acc = smem + 2 * R,
        *dv_acc = smem + 3 * R, *qs = smem + 4 * R, *os = smem + 5 * R;
  stage_rows_f32(ks, QP, k, ibase, ld_tok, t0, T, S, hd, cos_t,
                 sin_t, threadIdx.x, blockDim.x);
  stage_rows_f32(vs, QP, v, ibase, ld_tok, t0, T, S, hd, nullptr,
                 nullptr, threadIdx.x, blockDim.x);
  for (int e = threadIdx.x; e < T * QP; e += blockDim.x)
    dk_acc[e] = dv_acc[e] = 0.0f;
  const int n1 = (T / 4) * C8;
  for (int q0 = 0; q0 < S; q0 += T) {
    __syncthreads();  // the last query tile, P and dS are no longer read
    stage_rows_f32(qs, QP, q, ibase, ld_tok, q0, T, S, hd, cos_t,
                   sin_t, threadIdx.x, blockDim.x);
    stage_rows_f32(os, QP, d_out, base, tok, q0, T, S, hd, nullptr,
                   nullptr, threadIdx.x, blockDim.x);
    stage_rows_lse_delta_f32(lse_s, delta_s, lse, o, d_out, base, tok, lbase,
                             q0, S, hd);
    __syncthreads();
    probabilities_f32(ps, ds, qs, os, ks, vs, lse_s, delta_s, q0, t0, S, hd,
                      scale);
    __syncthreads();
    // dV += P^T dO, dKr += dS^T Qr: keys 4 tr + a, columns c0.., c0+half..
    for (int e = threadIdx.x; e < 2 * n1; e += blockDim.x) {
      const int kind = e / n1;  // 0 dV, 1 dK
      const int e2 = e - kind * n1;
      const int tr = e2 / C8;
      const int c0 = 4 * (e2 % C8);
      const float* A = kind == 0 ? ps : ds;
      const float* Bm = kind == 0 ? os : qs;
      float* accp = kind == 0 ? dv_acc : dk_acc;
      float4 a0[4], a1[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        a0[a] = ld4(accp + (4 * tr + a) * QP + c0);
        a1[a] = ld4(accp + (4 * tr + a) * QP + c0 + half);
      }
      for (int i = 0; i < T; ++i) {
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
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        *reinterpret_cast<float4*>(accp + (4 * tr + a) * QP + c0) = a0[a];
        *reinterpret_cast<float4*>(accp + (4 * tr + a) * QP + c0 + half) =
            a1[a];
      }
    }
  }
  __syncthreads();
  // dv, and dk = rot^-1(dKr)
  for (int e = threadIdx.x; e < 2 * T * C8; e += blockDim.x) {
    const int kind = e / (T * C8);  // 0 dV, 1 dK
    const int e2 = e - kind * T * C8;
    const int r = e2 / C8;
    const int c0 = 4 * (e2 % C8);
    const int s = t0 + r;
    if (s >= S) continue;
    const float* accp = kind == 0 ? dv_acc : dk_acc;
    float4 x0 = ld4(accp + r * QP + c0), x1 = ld4(accp + r * QP + c0 + half);
    if (kind == 1 && cos_t != nullptr) {
      const float4 c = ld4(cos_t + s * half + c0);
      const float4 sn = ld4(sin_t + s * half + c0);
      const float4 y0 = rotate_back0(x0, x1, c, sn);
      x1 = rotate_back1(x0, x1, c, sn);
      x0 = y0;
    }
    float* dst = (kind == 0 ? dv : dk) + ibase + (size_t)s * ld_tok + c0;
    *reinterpret_cast<float4*>(dst) = x0;
    *reinterpret_cast<float4*>(dst + half) = x1;
  }
}

// A fragments (hd/16 of them) of rows r0..r0+15 of xs
template <int HD>
__device__ __forceinline__ void load_rows(uint32_t (&a)[HD / 16][4],
                                          const __nv_bfloat16* xs, int r0,
                                          int lane) {
  constexpr int P = mma_pitch<HD>();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldsm_x4(a[kk], xs + (r0 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
}

// A 16-row accumulator tile of tokens r0.. to `out` (at stride ld from
// obase) as bfloat16, 4 bytes a lane; rows past S are not written
template <int HD>
__device__ __forceinline__ void store_fragments(
    const float (&acc)[HD / 8][4], __nv_bfloat16* __restrict__ out,
    size_t obase, size_t ld, int r0, int S, int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + obase + (size_t)row * ld + n * 8 +
                                   2 * t) =
          pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

template <int HD>
__global__ void __launch_bounds__((kMmaBwdUnits + kMmaBwdProducers) * 32)
    attention_bwd_tiled_mma(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t,
                            const __nv_bfloat16* __restrict__ o,
                            const float* __restrict__ lse,
                            const __nv_bfloat16* __restrict__ d_out,
                            __nv_bfloat16* __restrict__ dq,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int S, int H,
                            int ld_tok, int ld_head, float scale_log2,
                            float scale) {
  constexpr int P = mma_pitch<HD>();
  constexpr int HALF = HD / 2;
  constexpr int TW = kMmaBwdWalk;
  constexpr int NC = TW / 16;  // 16-row chunks of a walked tile
  constexpr int STAGES = mma_bwd_stages<HD>();
  // bytes of a ring stage: two row tiles, then the tile's lse and delta;
  // of its side slot: the key block's tile of O, then the walked tile's
  // tables
  constexpr int STAGE = 2 * TW * P * 2 + 2 * TW * 4;
  constexpr int SIDE = TW * P * 2 + TW * HD * 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // Qr / Kr
  __nv_bfloat16* ys = xs + 16 * kMmaBwdUnits * P;                     // dO / V
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(ys + 16 * kMmaBwdUnits * P);
  unsigned char* sides = ring + STAGES * STAGE;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int nb = blocks_per_head(S, kMmaBwdUnits);
  const bool key_kind = (int)blockIdx.y < nb;
  const UnitSpan span = unit_span((S + 15) / 16, nb,
                                  key_kind ? blockIdx.y : blockIdx.y - nb);
  const int warp = threadIdx.x >> 5;
  constexpr int PW = kMmaBwdProducers;
  const bool producer = warp >= kMmaBwdUnits;  // the last PW warps
  if (warp >= span.n && !producer) return;  // leave before any barrier
  const int ring_threads = (span.n + PW) * 32;  // the ring's barriers
  constexpr int FULL = 2, EMPTY = 2 + STAGES;  // ids, a stage each
  const int tid = threadIdx.x;
  const int nthreads = span.n * 32;
  const int ptid = tid - kMmaBwdUnits * 32;  // a producer's thread
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int t0 = span.u0 * 16;
  const int m0 = warp * 16;  // the warp's rows of the block's own rows
  const size_t tok = (size_t)H * HD;
  const size_t base = (size_t)b * S * tok + (size_t)h * HD;
  const size_t ibase = (size_t)b * S * ld_tok + (size_t)h * ld_head;
  const size_t lbase = (size_t)bh * S;
  const bool rope = cos_t != nullptr;
  const int ntiles = (S + TW - 1) / TW;

  auto tile = [&](int j) {  // the first row tile of stage j % STAGES
    return reinterpret_cast<__nv_bfloat16*>(ring + (j % STAGES) * STAGE);
  };
  auto obuf = [&](int j) {  // tile j's O (key block)
    return reinterpret_cast<__nv_bfloat16*>(sides + (j % STAGES) * SIDE);
  };
  // the producers: copy each walked tile into its stage, prepare it
  // (rotate, and in the key block sum the row term), signal it
  auto produce = [&](auto issue, auto prepare) {
    for (int j = 0; j < ntiles; ++j) {
      if (j >= STAGES) bar_wait(EMPTY + j % STAGES, ring_threads);
      issue(j);
      if (j > 0) {
        cp_async_wait<1>();  // tile j - 1 landed; tile j in flight
        prepare(j - 1);
        bar_arrive(FULL + (j - 1) % STAGES, ring_threads);
      }
    }
    cp_async_wait<0>();
    prepare(ntiles - 1);
    bar_arrive(FULL + (ntiles - 1) % STAGES, ring_threads);
  };
  auto tables = [&](int j) {  // tile j's cos, then its sin
    return reinterpret_cast<float*>(obuf(j) + TW * P);
  };

  if (!key_kind) {
    if (producer) {
      produce(
          [&](int j) {  // K (with its tables) and V of key tile j
            async_pairs(tile(j), P, tables(j), tables(j) + TW * HALF, k,
                        ibase, ld_tok, cos_t, sin_t, j * TW, TW, S, HALF,
                        ptid, PW * 32);
            async_rows(tile(j) + TW * P, P, v, ibase, ld_tok, j * TW, TW, S,
                       HD, ptid, PW * 32);
            cp_async_commit();
          },
          [&](int j) {
            if (rope)
              rotate_pairs_mma<HD>(tile(j), tables(j),
                                   tables(j) + TW * HALF, TW, ptid, PW * 32);
          });
      return;
    }
    stage_rows_mma<HD>(xs, q, ibase, ld_tok, t0, span.n * 16, S, cos_t,
                       sin_t, tid, nthreads);
    stage_rows_mma<HD>(ys, d_out, base, tok, t0, span.n * 16, S, nullptr,
                       nullptr, tid, nthreads);
    // the own rows' lse in base 2 and delta = rowsum(dO o O), float32 sums
    // of the bfloat16 values: a row's 4 lanes split its columns
    float lr[2], dr[2];
    bool row_ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t0 + m0 + g + 8 * r;
      row_ok[r] = row < S;
      float d = 0.0f;
      lr[r] = 0.0f;
      if (row_ok[r]) {
        for (int c = 8 * t; c < HD; c += 32) {
          const uint4 a = *reinterpret_cast<const uint4*>(
              o + base + (size_t)row * tok + c);
          const uint4 w = *reinterpret_cast<const uint4*>(
              d_out + base + (size_t)row * tok + c);
          const uint32_t av[4] = {a.x, a.y, a.z, a.w};
          const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            d = fmaf(bf16_lo(av[i]), bf16_lo(wv[i]), d);
            d = fmaf(bf16_hi(av[i]), bf16_hi(wv[i]), d);
          }
        }
        lr[r] = lse[lbase + row] * kLog2e;
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      dr[r] = d;
    }
    bar_sync(nthreads);  // the own rows are staged
    uint32_t qa[HD / 16][4], oa[HD / 16][4];
    load_rows<HD>(qa, xs, m0, lane);
    load_rows<HD>(oa, ys, m0, lane);
    float acc[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    for (int j = 0; j < ntiles; ++j) {
      bar_wait(FULL + j % STAGES, ring_threads);  // tile j landed, rotated
      __nv_bfloat16* ks = tile(j);
      const int k0 = j * TW;
      const int nc = min(NC, (S - k0 + 15) >> 4);  // chunks with a real key
      // scores and dP of the whole tile at once: 4 NC independent sums
      float sc[2 * NC][4], dp[2 * NC][4];
      tile_products<HD, NC>(sc, dp, qa, oa, ks, ks + TW * P, nc, lane);
#pragma unroll
      for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const float p = key < S && row_ok[r]
                              ? exp2f(sc[n][e] * scale_log2 - lr[r])
                              : 0.0f;
          dp[n][e] = p * (dp[n][e] - dr[r]) * scale;
        }
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (c < nc) {
          const uint32_t da[4] = {
              pack_bf16(dp[2 * c][0], dp[2 * c][1]),
              pack_bf16(dp[2 * c][2], dp[2 * c][3]),
              pack_bf16(dp[2 * c + 1][0], dp[2 * c + 1][1]),
              pack_bf16(dp[2 * c + 1][2], dp[2 * c + 1][3])};
          times_rows<HD>(acc, da, ks, 16 * c, lane);
        }
      if (j + STAGES < ntiles) bar_arrive(EMPTY + j % STAGES, ring_threads);
    }
    unrotate<HD>(acc, cos_t, sin_t, t0 + m0, g, t, S);
    store_fragments<HD>(acc, dq, ibase, ld_tok, t0 + m0, S, g, t);
    return;
  }

  // key block: walks the query tiles
  if (producer) {
    produce(
        [&](int j) {  // Q (with its tables), dO and O, lse of tile j
          async_pairs(tile(j), P, tables(j), tables(j) + TW * HALF, q, ibase,
                      ld_tok, cos_t, sin_t, j * TW, TW, S, HALF, ptid,
                      PW * 32);
          async_quads(tile(j) + TW * P, obuf(j), P, d_out, o, base, tok,
                      j * TW, TW, S, HD, ptid, PW * 32);
          async_values(reinterpret_cast<float*>(tile(j) + 2 * TW * P), lse,
                       lbase, j * TW, TW, S, ptid, PW * 32);
          cp_async_commit();
        },
        [&](int j) {
          __nv_bfloat16* qs = tile(j);
          const __nv_bfloat16* gs = qs + TW * P;
          float* delta_s = reinterpret_cast<float*>(qs + 2 * TW * P) + TW;
          if (rope)
            rotate_pairs_mma<HD>(qs, tables(j), tables(j) + TW * HALF, TW,
                                 ptid, PW * 32);
          row_delta_mma<HD>(delta_s, gs, obuf(j), TW, ptid, PW * 32);
        });
    return;
  }
  stage_rows_mma<HD>(xs, k, ibase, ld_tok, t0, span.n * 16, S, cos_t, sin_t,
                     tid, nthreads);
  stage_rows_mma<HD>(ys, v, ibase, ld_tok, t0, span.n * 16, S, nullptr,
                     nullptr, tid, nthreads);
  bar_sync(nthreads);  // the own rows are staged
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  load_rows<HD>(ka, xs, m0, lane);
  load_rows<HD>(va, ys, m0, lane);
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key_ok[r] = t0 + m0 + g + 8 * r < S;
  float av[HD / 8][4], ak[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    av[n][0] = av[n][1] = av[n][2] = av[n][3] = 0.0f;
    ak[n][0] = ak[n][1] = ak[n][2] = ak[n][3] = 0.0f;
  }
  for (int j = 0; j < ntiles; ++j) {
    bar_wait(FULL + j % STAGES, ring_threads);  // tile j landed, prepared
    __nv_bfloat16* qs = tile(j);
    const __nv_bfloat16* gs = qs + TW * P;  // dO
    const float* lse_s = reinterpret_cast<const float*>(gs + TW * P);
    const float* delta_s = lse_s + TW;
    const int q0 = j * TW;
    const int nc = min(NC, (S - q0 + 15) >> 4);  // chunks with a real query
    // S^T and dP^T of the whole tile at once: rows the warp's keys,
    // columns the tile's queries
    float sc[2 * NC][4], dp[2 * NC][4];
    tile_products<HD, NC>(sc, dp, ka, va, qs, gs, nc, lane);
#pragma unroll
    for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + 2 * t + (e & 1);
        const float p =
            q0 + qi < S && key_ok[e >> 1]
                ? exp2f(sc[n][e] * scale_log2 - lse_s[qi] * kLog2e)
                : 0.0f;
        sc[n][e] = p;
        dp[n][e] = p * (dp[n][e] - delta_s[qi]) * scale;
      }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * c][0], sc[2 * c][1]),
                                pack_bf16(sc[2 * c][2], sc[2 * c][3]),
                                pack_bf16(sc[2 * c + 1][0], sc[2 * c + 1][1]),
                                pack_bf16(sc[2 * c + 1][2], sc[2 * c + 1][3])};
        const uint32_t da[4] = {pack_bf16(dp[2 * c][0], dp[2 * c][1]),
                                pack_bf16(dp[2 * c][2], dp[2 * c][3]),
                                pack_bf16(dp[2 * c + 1][0], dp[2 * c + 1][1]),
                                pack_bf16(dp[2 * c + 1][2], dp[2 * c + 1][3])};
        times_rows<HD>(av, pa, gs, 16 * c, lane);
        times_rows<HD>(ak, da, qs, 16 * c, lane);
      }
    if (j + STAGES < ntiles) bar_arrive(EMPTY + j % STAGES, ring_threads);
  }
  unrotate<HD>(ak, cos_t, sin_t, t0 + m0, g, t, S);
  store_fragments<HD>(ak, dk, ibase, ld_tok, t0 + m0, S, g, t);
  store_fragments<HD>(av, dv, ibase, ld_tok, t0 + m0, S, g, t);
}

// --------------------------------------------------------------- launch --

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const float* cos_t,
               const float* sin_t, const void* d_out, void* dq, void* dk,
               void* dv, int B, int S, int H, int ld_tok, int ld_head,
               void* stream) {
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
      ld_tok, ld_head, 1.4426950408889634f * scale, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tiled_mma(const void* q, const void* k, const void* v,
                     const float* cos_t, const float* sin_t, const void* o,
                     const float* lse, const void* d_out, void* dq, void* dk,
                     void* dv, int B, int S, int H, int ld_tok, int ld_head,
                     void* stream) {
  static std::atomic<bool> raised[kMaxDevices];
  cudaError_t err = allow_smem(attention_bwd_tiled_mma<HD>, raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, 2 * blocks_per_head(S, kMmaBwdUnits));
  const float scale = 1.0f / sqrtf((float)HD);
  attention_bwd_tiled_mma<HD>
      <<<grid, (kMmaBwdUnits + kMmaBwdProducers) * 32, tiled_mma_bytes<HD>(),
        (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
          (const __nv_bfloat16*)v, cos_t, sin_t, (const __nv_bfloat16*)o,
          lse, (const __nv_bfloat16*)d_out, (__nv_bfloat16*)dq,
          (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, H, ld_tok, ld_head,
          kLog2e * scale, scale);
  return (int)cudaGetLastError();
}

template <int NP, int U>
int launch_tiled_simt(const void* q, const void* k, const void* v,
                      const float* cos_t, const float* sin_t, const void* o,
                      const float* lse, const void* d_out, void* dq, void* dk,
                      void* dv, int B, int S, int H, int hd, int ld_tok,
                      int ld_head, void* stream) {
  static std::atomic<bool> raised[kMaxDevices];
  cudaError_t err = allow_smem(attention_bwd_tiled_simt<NP, U>, raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, 2 * blocks_per_head(S, U));
  attention_bwd_tiled_simt<NP, U><<<grid, U * 32,
                                 sizeof(float) * tiled_simt_floats(hd),
                                 (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, cos_t, sin_t,
      (const float*)o, lse, (const float*)d_out, (float*)dq, (float*)dk,
      (float*)dv, S, H, hd, ld_tok, ld_head, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

int launch_tiled_simt_wide(const void* q, const void* k, const void* v,
                           const float* cos_t, const float* sin_t,
                           const void* o, const float* lse, const void* d_out,
                           void* dq, void* dk, void* dv, int B, int S, int H,
                           int hd, int ld_tok, int ld_head, void* stream) {
  static std::atomic<bool> raised[kMaxDevices];
  cudaError_t err = allow_smem(attention_bwd_tiled_simt_wide, raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, 2 * ((S + kTileF32 - 1) / kTileF32));
  attention_bwd_tiled_simt_wide<<<grid, kTiledF32Threads,
                                  sizeof(float) * tiled_simt_wide_floats(hd),
                                  (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, cos_t, sin_t,
      (const float*)o, lse, (const float*)d_out, (float*)dq, (float*)dk,
      (float*)dv, S, H, hd, ld_tok, ld_head, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

}  // namespace

// C ABI, bound with ctypes by cliffordtpu_torch/kernels/attention.py.
// q, k, v and dq, dk, dv at token stride ld_tok and head stride ld_head
// (elements, each a multiple of 8), d_out contiguous (B, S, H, hd), all
// 16-byte aligned;
// cos, sin contiguous (S, hd/2) float32, 16-byte aligned, or both null.
// float32 takes hd a multiple of 8, bfloat16 hd 16, 32, 64 or 128.  The
// wrapper checks shapes, types, alignment and the shared memory size.
// Returns the CUDA error of the attribute call or launch.
extern "C" int attention_bwd_f32(const void* q, const void* k, const void* v,
                                 const float* cos_t, const float* sin_t,
                                 const void* d_out, void* dq, void* dk,
                                 void* dv, int B, int S, int H, int hd,
                                 int ld_tok, int ld_head, void* stream) {
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
      ld_tok, ld_head, 1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

extern "C" int attention_bwd_bf16(const void* q, const void* k, const void* v,
                                  const float* cos_t, const float* sin_t,
                                  const void* d_out, void* dq, void* dk,
                                  void* dv, int B, int S, int H, int hd,
                                  int ld_tok, int ld_head, void* stream) {
  switch (hd) {
    case 16:
      return launch_mma<16>(q, k, v, cos_t, sin_t, d_out, dq, dk, dv, B, S, H,
                            ld_tok, ld_head, stream);
    case 32:
      return launch_mma<32>(q, k, v, cos_t, sin_t, d_out, dq, dk, dv, B, S, H,
                            ld_tok, ld_head, stream);
    case 64:
      return launch_mma<64>(q, k, v, cos_t, sin_t, d_out, dq, dk, dv, B, S, H,
                            ld_tok, ld_head, stream);
    case 128:
      return launch_mma<128>(q, k, v, cos_t, sin_t, d_out, dq, dk, dv, B, S,
                             H, ld_tok, ld_head, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The key-tiled forms (the "tiled" section above), with the same layout
// rules; o is the forward's output (contiguous (B, S, H, hd)) and lse its
// float32 (B, H, S) log-sum-exp (attention_fwd_tiled_*).  float32 takes hd
// a multiple of 8 whose tiles fit the shared memory (kernels/attention.py::
// tiled_smem_bytes), bfloat16 hd 16, 32, 64 or 128.
extern "C" int attention_bwd_tiled_f32(const void* q, const void* k,
                                       const void* v, const float* cos_t,
                                       const float* sin_t, const void* o,
                                       const float* lse, const void* d_out,
                                       void* dq, void* dk, void* dv, int B,
                                       int S, int H, int hd, int ld_tok,
                                       int ld_head, void* stream) {
  if (hd > kSimtMaxHd)
    return launch_tiled_simt_wide(q, k, v, cos_t, sin_t, o, lse, d_out, dq,
                                  dk, dv, B, S, H, hd, ld_tok, ld_head,
                                  stream);
  if (hd > 64)
    return launch_tiled_simt<2, simt_bwd_units(128)>(
        q, k, v, cos_t, sin_t, o, lse, d_out, dq, dk, dv, B, S, H, hd, ld_tok,
        ld_head, stream);
  return launch_tiled_simt<1, simt_bwd_units(64)>(
      q, k, v, cos_t, sin_t, o, lse, d_out, dq, dk, dv, B, S, H, hd, ld_tok,
      ld_head, stream);
}

extern "C" int attention_bwd_tiled_bf16(const void* q, const void* k,
                                        const void* v, const float* cos_t,
                                        const float* sin_t, const void* o,
                                        const float* lse, const void* d_out,
                                        void* dq, void* dk, void* dv, int B,
                                        int S, int H, int hd, int ld_tok,
                                        int ld_head, void* stream) {
  switch (hd) {
    case 16:
      return launch_tiled_mma<16>(q, k, v, cos_t, sin_t, o, lse, d_out, dq,
                                  dk, dv, B, S, H, ld_tok, ld_head, stream);
    case 32:
      return launch_tiled_mma<32>(q, k, v, cos_t, sin_t, o, lse, d_out, dq,
                                  dk, dv, B, S, H, ld_tok, ld_head, stream);
    case 64:
      return launch_tiled_mma<64>(q, k, v, cos_t, sin_t, o, lse, d_out, dq,
                                  dk, dv, B, S, H, ld_tok, ld_head, stream);
    case 128:
      return launch_tiled_mma<128>(q, k, v, cos_t, sin_t, o, lse, d_out, dq,
                                   dk, dv, B, S, H, ld_tok, ld_head, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
