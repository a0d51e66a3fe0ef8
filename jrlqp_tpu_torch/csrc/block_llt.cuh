// Block Cholesky and inverse on one (s, s) f32 block in shared memory, run
// by all threads of a block (K2).
//
// Replaces the Pallas device helpers jrlqp_tpu/ops/pallas/block_llt.py::
// _chol_b (:89) and _tri_inv_b (:121), which the fused GI kernel's prologue
// (K1) and the structured-layer factorizations (K5, K7) call. Same
// arithmetic: a masked right-looking Cholesky whose pivots are clamped at
// 1e-30 before 1/sqrt (so a non-SPD block yields collapsed or huge pivots,
// never a NaN from a negative square root), and a forward-substitution
// inverse of the factor. Every sum keeps the order of the row-wise version
// (k ascending, each product and sum rounded apart with __fmul_rn /
// __fadd_rn, so nvcc contracts nothing into an FMA that the plain PyTorch
// version would not make): the outputs are those of that version bit for
// bit.
//
// What bounds it here: at the batches K1 runs (one block per problem, four
// per SM), the instructions each SM issues; on its own, a chain of s
// dependent steps with a barrier each. The design cuts both:
// - one loop of s steps for the factor and the inverse, with one barrier per
//   step. The inverse is right-looking (at step k, row k of X = L^-1 is
//   final and every later row takes its term k), which needs only column k
//   of L, so it runs in the factor's loop one step behind;
// - each step's pivot work is one warp's lookahead for the next step: it
//   updates the next row and column, forms the pivot's 1/sqrt once, scales
//   L's column and the row in place, and finalises the inverse's next row;
// - the other warps update the trailing block and the inverse's later rows
//   with a fixed 2-D map (warps take rows, lanes take columns, no index
//   division), one load of L's column entry per row, the scaled row in
//   registers. The s - 1 columns of a step (the inverse's j + 1 and the
//   factor's s - j - 2) are one range over the lanes, two per lane at
//   s <= 65, so no step leaves half a warp idle.
#pragma once

#include <cuda_runtime.h>

namespace jrlqp {

// 1/sqrt(max(piv, 1e-30)), NaN-propagating like jnp.maximum / torch.maximum.
__device__ __forceinline__ float clamped_rsqrt(float piv) {
  float pc = (piv != piv) ? piv : fmaxf(piv, 1e-30f);
  return 1.0f / sqrtf(pc);
}

// Warp 0's lookahead for step j of chol_inv_block: row j and column j of
// the factor take step j - 1's update (j > 0; row j - 1 is scaled in place
// and column j - 1 is L's), the pivot's 1/sqrt is formed once, column j
// becomes L's column j and row j is scaled in place for step j's update;
// then row j of the inverse takes its last term (k = j - 1) and is final.
__device__ __forceinline__ void chol_inv_pivot(float* A, int lda, float* X,
                                               int ldx, int s, int j) {
  const int lane = threadIdx.x & 31;
  float* Aj = A + j * lda;
  const float* Ap = A + (j > 0 ? j - 1 : 0) * lda;  // row j - 1, scaled
  float piv = 0.0f;
  for (int c = j + lane; c < s; c += 32) {
    float v = Aj[c];
    if (j > 0) v = __fsub_rn(v, __fmul_rn(Aj[j - 1], Ap[c]));
    if (c == j) piv = v;
    else Aj[c] = v;
  }
  piv = __shfl_sync(0xffffffffu, piv, 0);
  const float isq = clamped_rsqrt(piv);
  const float ljj = __fmul_rn(piv, isq);
  for (int c = j + 1 + lane; c < s; c += 32) Aj[c] = __fmul_rn(Aj[c], isq);
  if (lane == 0) Aj[j] = ljj;
  for (int i = j + 1 + lane; i < s; i += 32) {
    float v = A[i * lda + j];
    if (j > 0) v = __fsub_rn(v, __fmul_rn(A[i * lda + j - 1], Ap[j]));
    A[i * lda + j] = __fmul_rn(v, isq);
  }
  float* Xj = X + j * ldx;
  for (int c = lane; c <= j; c += 32) {
    float acc = Xj[c];
    if (c < j) acc = __fadd_rn(acc, __fmul_rn(Aj[j - 1], Xj[c - ldx]));
    Xj[c] = __fdiv_rn(__fsub_rn(c == j ? 1.0f : 0.0f, acc), ljj);
  }
}

// The Cholesky factor of the s x s block A (row stride lda), in place: on
// return its lower triangle holds L and its strict upper triangle is zero;
// and X = L^-1 (row stride ldx, lower triangular, zero above). X's rows hold
// the inverse's running sums until they are final. Starts and ends with a
// barrier; needs whole warps.
__device__ inline void chol_inv_block(float* A, int lda, float* X, int ldx,
                                      int s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  // warp 0 runs the lookahead; the others (or warp 0 alone) the bulk
  const int nbulk = nw > 1 ? nw - 1 : 1;
  const int bw = nw > 1 ? warp - 1 : 0;
  for (int i = warp; i < s; i += nw)
    for (int c = lane; c < s; c += 32) X[i * ldx + c] = 0.0f;
  __syncthreads();
  if (warp == 0) chol_inv_pivot(A, lda, X, ldx, s, 0);
  __syncthreads();
  for (int j = 0; j + 1 < s; ++j) {
    if (warp == 0) chol_inv_pivot(A, lda, X, ldx, s, j + 1);
    if (bw >= 0) {
      // rows i >= j + 2 take step j: the inverse's columns c <= j
      // (X[i][c] += L[i][j] X[j][c]) and the factor's c >= j + 2
      // (A[i][c] -= L[i][j] r[c], added as the negated product, which has
      // the same bits), as virtual columns v < s - 1: c = v, or v + 1
      const float* Aj = A + j * lda;
      const float* Xj = X + j * ldx;
      for (int vb = 0; vb < s - 1; vb += 64) {
        float* p[2];
        float r[2];
        int ld[2];
        bool has[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int v = vb + lane + 32 * h;
          has[h] = v < s - 1;
          const bool inv = v <= j;
          p[h] = inv ? X + v : A + v + 1;
          ld[h] = inv ? ldx : lda;
          r[h] = !has[h] ? 0.0f : (inv ? Xj[v] : -Aj[v + 1]);
        }
        for (int i = j + 2 + bw; i < s; i += nbulk) {
          const float li = A[i * lda + j];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (has[h]) {
              float* q = p[h] + i * ld[h];
              *q = __fadd_rn(*q, __fmul_rn(li, r[h]));
            }
        }
      }
    }
    __syncthreads();
  }
  for (int i = warp; i < s; i += nw)
    for (int c = i + 1 + lane; c < s; c += 32) A[i * lda + c] = 0.0f;
  __syncthreads();
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
