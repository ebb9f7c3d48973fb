// Real-DFT Clifford-torus basis, made on the device (shared by the kernels
// that embed angles on the torus).
//
// Port of cliffordtpu/kernels/torus_pallas.py::basis_tiles / const_cols.
// For n = 2d, angle index k in 1..d-1 and output column col in 0..n-1:
//
//   C[k, col] =  (2/n) cos(2 pi ((k*col) mod n) / n)
//   S[k, col] = -(2/n) sin(2 pi ((k*col) mod n) / n)
//   c[col]    =  2/n on even columns, 0 on odd ones
//
// The phase is reduced mod n in int32 BEFORE the float multiply: k*col
// reaches 33.5M at d = 4096, beyond float32's exact integers, while
// (k*col) mod n < 2d is always exact.  Rows k > d-1 and columns col >= n
// are zero, so a caller's padding never leaks into the sum.  sincosf is
// the accurate version (the port builds without --use_fast_math).
#pragma once

// step = (float)(2 pi / n), computed once by the caller as
// torus_phase_step(d).
__host__ __device__ __forceinline__ float torus_phase_step(int d) {
  return (float)(6.283185307179586476925 / (double)(2 * d));
}

__device__ __forceinline__ void torus_basis(int k, int col, int d,
                                            float step, float* c, float* s) {
  const int n = 2 * d;
  if (k < 1 || k > d - 1 || col < 0 || col >= n) {
    *c = 0.0f;
    *s = 0.0f;
    return;
  }
  const float phase = (float)((k * col) % n) * step;
  float sn, cs;
  sincosf(phase, &sn, &cs);
  const float scale = 2.0f / (float)n;
  *c = scale * cs;
  *s = -scale * sn;
}

__device__ __forceinline__ float torus_const(int col, int d) {
  const int n = 2 * d;
  return (col % 2 == 0 && col < n) ? 2.0f / (float)n : 0.0f;
}
