// Real-DFT Clifford-torus basis as a shared-memory table, and the tiled
// embedding product built on it (shared by the kernels that embed angles
// on the torus or differentiate that embedding).
//
// Port of cliffordtpu/kernels/torus_pallas.py::basis_tiles / const_cols.
// For n = 2d, angle index k in 1..d-1 and output column col in 0..n-1:
//
//   C[k, col] =  (2/n) cos(2 pi ((k*col) mod n) / n)
//   S[k, col] = -(2/n) sin(2 pi ((k*col) mod n) / n)
//   c[col]    =  2/n on even columns, 0 on odd ones
//
// Both bases depend on (k, col) only through m = (k*col) mod n, so a block
// keeps the n pairs (C, S)(m) in shared memory (8n bytes: 64 KB at
// d = 4096), filled once with the accurate sincosf (the port builds without
// --use_fast_math), and looks a basis value up instead of computing it.
// The phase is reduced mod n in int32: k*col reaches 33.5M at d = 4096,
// beyond float32's exact integers, while m < 2d is always exact.  Walking
// col (or k) by one adds k (or col) to m, so the inner loops keep m with an
// add and a conditional subtract, without a division.
//
// Tiling, the same in every kernel here: a block of 512 threads owns 64
// rows; lane l of every warp owns rows l and l + 32, so a table lookup is
// one address per warp (a broadcast, no bank conflict whatever k or col is)
// and the per-row operand is read at consecutive addresses.  The reduction
// axis is staged through shared memory 64 values at a time, transposed to
// [value][row] with a pitch of 65 floats so that both the coalesced fill
// (consecutive threads, consecutive values) and the lane-per-row reads are
// free of bank conflicts.  The loops wait on shared-memory latency more
// than on instruction slots, so a block is sixteen warps of few columns (or
// angles) each, and the loop over a staged chunk is unrolled.
#pragma once

#include <cuda_runtime.h>

constexpr int kTorusThreads = 512;  // 16 warps
constexpr int kTorusRows = 64;      // rows of a block: lanes l and l + 32
constexpr int kTorusCpw = 4;        // embedding: output columns per warp
constexpr int kTorusCols = 16 * kTorusCpw;
constexpr int kTorusApw = 2;        // backward: angles per warp
constexpr int kTorusAngles = 16 * kTorusApw;
constexpr int kTorusChunk = 64;     // reduction values staged per step
constexpr int kTorusUnroll = 4;     // of the loop over a staged chunk
constexpr int kTorusPitch = kTorusRows + 1;
constexpr int kTorusMaxDim = 4096;  // the largest d the wrappers pass on
constexpr int kTorusMaxSmem = 227 * 1024;  // a block's opt-in limit, sm_90

__host__ __device__ __forceinline__ float torus_phase_step(int d) {
  return (float)(6.283185307179586476925 / (double)(2 * d));
}

__device__ __forceinline__ float torus_const(int col, int d) {
  const int n = 2 * d;
  return (col % 2 == 0 && col < n) ? 2.0f / (float)n : 0.0f;
}

// tab[m] = (C, S) at phase m, m = 0..n-1; all threads of the block.  The
// caller synchronises before the first lookup.
__device__ __forceinline__ void torus_table_fill(float2* tab, int d) {
  const int n = 2 * d;
  const float step = torus_phase_step(d);
  const float scale = 2.0f / (float)n;
  for (int m = threadIdx.x; m < n; m += blockDim.x) {
    float sn, cs;
    sincosf((float)m * step, &sn, &cs);
    tab[m] = make_float2(scale * cs, -scale * sn);
  }
}

// Dynamic shared memory of a block: the table, and `staged` arrays of one
// chunk of the reduction axis for the block's rows (cos and sin of the
// angles in an embedding block, the output gradient in a backward block).
constexpr size_t torus_smem_bytes(int d, int staged) {
  return sizeof(float2) * 2 * (size_t)d +
         sizeof(float) * staged * kTorusChunk * kTorusPitch;
}
constexpr size_t torus_embed_smem_bytes(int d) {
  return torus_smem_bytes(d, 2);
}
static_assert(torus_embed_smem_bytes(kTorusMaxDim) <= kTorusMaxSmem,
              "the table and a staged chunk must fit a block at the "
              "largest d");

// Above 48 KB a kernel must be allowed its dynamic shared memory first.
template <typename Kernel>
inline cudaError_t torus_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// x[r, col] = c[col] + sum_k cos(th[r, k]) C[k, col] + sin(th[r, k]) S[k, col]
// for the block's 64 rows (blockIdx.x) and 64 columns (blockIdx.y), x (R, 2d)
// written exactly.  `fill(k0, kc, row0, cs, sn)` is run by all threads for
// every chunk of angles k0..k0+kc-1 and leaves cos th and sin th of
// row row0 + lr at cs[kk * kTorusPitch + lr] and sn[...] (zero for rows
// beyond R).  Two multiply-adds per (row, k, col), float32 on the CUDA cores.
template <typename Fill>
__device__ __forceinline__ void torus_embed_tile(Fill fill,
                                                 float* __restrict__ x, int R,
                                                 int d, float* smem) {
  const int n = 2 * d;
  const int m = d - 1;
  float2* tab = reinterpret_cast<float2*>(smem);
  float* cs = smem + 2 * n;
  float* sn = cs + kTorusChunk * kTorusPitch;
  const int row0 = blockIdx.x * kTorusRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.y * kTorusCols + warp * kTorusCpw;
  const char* tab_bytes = reinterpret_cast<const char*>(tab);
  const int n8 = n * (int)sizeof(float2);
  torus_table_fill(tab, d);
  // the phase m of column j at the current k, and its step per k, both in
  // bytes of the table
  int cj[kTorusCpw], idx[kTorusCpw];
  float acc0[kTorusCpw], acc1[kTorusCpw];
#pragma unroll
  for (int j = 0; j < kTorusCpw; ++j) {
    cj[j] = col0 + j < n ? col0 + j : 0;  // a column past the end adds 0
    acc0[j] = 0.0f;
    acc1[j] = 0.0f;
  }
  for (int k0 = 1; k0 <= m; k0 += kTorusChunk) {
    const int kc = min(kTorusChunk, m - k0 + 1);
    __syncthreads();  // the table is filled; the last chunk is consumed
    fill(k0, kc, row0, cs, sn);
    __syncthreads();
    if (col0 >= n) continue;
#pragma unroll
    for (int j = 0; j < kTorusCpw; ++j)
      idx[j] = ((k0 * cj[j]) % n) * (int)sizeof(float2);
#pragma unroll kTorusUnroll
    for (int kk = 0; kk < kc; ++kk) {
      const float a0 = cs[kk * kTorusPitch + lane];
      const float a1 = cs[kk * kTorusPitch + lane + 32];
      const float b0 = sn[kk * kTorusPitch + lane];
      const float b1 = sn[kk * kTorusPitch + lane + 32];
#pragma unroll
      for (int j = 0; j < kTorusCpw; ++j) {
        const float2 t = *reinterpret_cast<const float2*>(tab_bytes + idx[j]);
        acc0[j] = fmaf(a0, t.x, acc0[j]);
        acc0[j] = fmaf(b0, t.y, acc0[j]);
        acc1[j] = fmaf(a1, t.x, acc1[j]);
        acc1[j] = fmaf(b1, t.y, acc1[j]);
        idx[j] += cj[j] * (int)sizeof(float2);  // k + 1
        if (idx[j] >= n8) idx[j] -= n8;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTorusCpw; ++j) {
    const int col = col0 + j;
    if (col >= n) continue;
    const float c = torus_const(col, d);
    const int r0 = row0 + lane;
    if (r0 < R) x[(size_t)r0 * n + col] = acc0[j] + c;
    if (r0 + 32 < R) x[(size_t)(r0 + 32) * n + col] = acc1[j] + c;
  }
}
