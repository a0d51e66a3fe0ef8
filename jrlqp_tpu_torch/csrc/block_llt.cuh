// Block Cholesky helpers on one (s, s) f32 block in shared memory, run by
// all threads of a block (K2).
//
// Replaces the Pallas device helpers jrlqp_tpu/ops/pallas/block_llt.py::
// _chol_b (:89) and _tri_inv_b (:121), which the fused GI kernel's prologue
// (K1) and the structured-layer kernels call. Same arithmetic: a masked
// right-looking Cholesky whose pivots are clamped at 1e-30 before 1/sqrt
// (so a non-SPD block yields collapsed or huge pivots, never a NaN from a
// negative square root), and a row-wise forward-substitution inverse of
// the factor.
//
// What bounds it here: a chain of s dependent steps with a barrier each
// (s = 56 at n = 50), each step a few thousand FLOPs -- latency, not
// arithmetic or bytes. The design keeps the block in shared memory for the
// whole chain, factors in place (the trailing update and the column scale
// of a step touch disjoint entries, so one barrier per step suffices), and
// spreads each step's elements over the block's threads. Products are
// rounded separately (__fmul_rn) so that nvcc does not contract them into
// FMAs that the plain PyTorch version would not make.
#pragma once

#include <cuda_runtime.h>

namespace jrlqp {

// 1/sqrt(max(piv, 1e-30)), NaN-propagating like jnp.maximum / torch.maximum.
__device__ __forceinline__ float clamped_rsqrt(float piv) {
  float pc = (piv != piv) ? piv : fmaxf(piv, 1e-30f);
  return 1.0f / sqrtf(pc);
}

// In-place Cholesky of the s x s block A (row stride ld): on return the
// lower triangle holds L and the strict upper triangle is zero.
__device__ inline void chol_block(float* A, int s, int ld) {
  const int tid = threadIdx.x, nt = blockDim.x;
  __syncthreads();
  for (int j = 0; j < s; ++j) {
    const float isq = clamped_rsqrt(A[j * ld + j]);
    const int t = s - j - 1;
    // trailing update A[i][c] -= (A[i][j] isq)(A[j][c] isq), i, c > j
    for (int e = tid; e < t * t; e += nt) {
      const int i = j + 1 + e / t, c = j + 1 + e % t;
      const float li = __fmul_rn(A[i * ld + j], isq);
      const float lc = __fmul_rn(A[j * ld + c], isq);
      A[i * ld + c] = __fsub_rn(A[i * ld + c], __fmul_rn(li, lc));
    }
    __syncthreads();
    // column j of L; disjoint from what step j + 1 reads or writes
    for (int i = j + tid; i < s; i += nt)
      A[i * ld + j] = __fmul_rn(A[i * ld + j], isq);
  }
  __syncthreads();
  for (int e = tid; e < s * s; e += nt) {
    const int i = e / s, c = e % s;
    if (c > i) A[i * ld + c] = 0.0f;
  }
  __syncthreads();
}

// X = L^-1 for lower-triangular L (stride ldl) into X (stride ldx), by rows:
// row i uses only rows < i of X, which are final.
__device__ inline void tri_inv_block(const float* L, int ldl, float* X,
                                     int ldx, int s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = 0; i < s; ++i) {
    const float lii = L[i * ldl + i];
    for (int c = tid; c < s; c += nt) {
      float v = 0.0f;
      if (c <= i) {
        float acc = 0.0f;
        for (int k = c; k < i; ++k)
          acc = __fadd_rn(acc, __fmul_rn(L[i * ldl + k], X[k * ldx + c]));
        v = __fdiv_rn(__fsub_rn(c == i ? 1.0f : 0.0f, acc), lii);
      }
      X[i * ldx + c] = v;
    }
    __syncthreads();
  }
}

// Non-SPD detection on diag(L): posdef iff no NaN and
// min(diag) > 1e-6 max(diag). Every thread returns the same value.
__device__ inline bool posdef_from_diag(const float* L, int ld, int s) {
  float mn = L[0], mx = L[0];
  bool nan = false;
  for (int j = 0; j < s; ++j) {
    const float d = L[j * ld + j];
    nan = nan || (d != d);
    mn = fminf(mn, d);
    mx = fmaxf(mx, d);
  }
  return !nan && (mn > __fmul_rn(1e-6f, mx));
}

}  // namespace jrlqp
