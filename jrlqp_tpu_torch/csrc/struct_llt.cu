// The structured block-LLT kernels K5-K8: the block-tridiagonal and the
// block-arrow Cholesky chains with per-block inverses, and the blocked
// multi-rhs solves y = G^-1 r, on f32 problems of nb blocks of size s.
//
// Replace the Pallas kernels of jrlqp_tpu/ops/pallas/block_llt.py:
//   K5 tri_llt_kernel     <- _tri_llt_kernel (:225, tri_block_llt_pallas :246)
//   K6 tri_solve_kernel   <- _tri_solve_kernel (:283, tri_block_solve_pallas :314)
//   K7 arrow_llt_kernel   <- _arrow_llt_kernel (:350, block_arrow_llt_pallas :372)
//   K8 arrow_solve_kernel <- _arrow_solve_kernel (:405, block_arrow_solve_pallas :429)
// The TPU's problem packing, folding into 3-D refs and padding of s to 8
// are not carried over; the block chain, unrolled statically there, is a
// loop inside one thread block here.
//
// What bounds them on an H100: the serial chains. A factorization (K5, K7)
// is nb Cholesky and inverse steps of s dependent rows each, with a barrier
// per row -- latency, not FLOPs or bytes (a problem's blocks are ~100 KB).
// So K5 and K7 run one problem per thread block with every working block
// (the block being factored, its inverse, the coupling block and the
// running Schur term) in shared memory: 4-5 s x s floats, ~30-37 KB at
// s = 43, so several problems share an SM and hide each other's barriers.
// They reuse K2's device functions chol_block and tri_inv_block.
// A solve (K6, K8) runs 2 nb dependent block gemms, but its rhs columns are
// independent and, on the structured path, the rhs is the identity
// (k = n = 387): one problem's rhs is 600 KB, too much for one block. So
// the grid is (problem, tile of kTile rhs columns); each block runs the
// forward and the backward chain on its tile with the factor blocks staged
// in shared memory, and keeps the forward results in the output buffer in
// device memory, which only that block reads back. Nothing crosses blocks.
//
// Up arrows: the Pallas wrappers roll the diagonal blocks (and the rhs) by
// -1 before the kernel and the solution by +1 after it; here the kernels
// read block (j + 1) % nb in place of block j instead, so no copy is made.
// Sums run in another order than in the plain PyTorch versions, so kernel
// and plain agree to a tolerance, not bitwise.
#include <cuda_runtime.h>

#include "block_llt.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // rhs columns per thread block in K6 and K8

// Y[r][c] = sum_{k < kend} P[r][k] Q[c][k] (+ Y[r][c] when accumulate),
// for s x s blocks; kend = c + 1 when Q is lower triangular, else s.
__device__ void mm_nt(const float* P, const float* Q, float* Y, int s,
                      bool q_lower, bool accumulate) {
  for (int e = threadIdx.x; e < s * s; e += blockDim.x) {
    const int r = e / s, c = e % s;
    const int kend = q_lower ? c + 1 : s;
    float acc = 0.0f;
    for (int k = 0; k < kend; ++k) acc = fmaf(P[r * s + k], Q[c * s + k], acc);
    Y[e] = accumulate ? Y[e] + acc : acc;
  }
}

// Y = R + alpha op(A) X for an s x s lower-triangular block A and s x tk
// tiles X, R, Y of row stride kTile; op(A) is A or A^T. The zero half of A
// is skipped. R may be Y; X may not.
__device__ void tri_mm(const float* A, bool trans, const float* X,
                       const float* R, float alpha, float* Y, int s, int tk) {
  for (int e = threadIdx.x; e < s * tk; e += blockDim.x) {
    const int r = e / tk, c = e % tk;
    float acc = 0.0f;
    if (trans) {
      for (int k = r; k < s; ++k) acc = fmaf(A[k * s + r], X[k * kTile + c], acc);
    } else {
      for (int k = 0; k <= r; ++k) acc = fmaf(A[r * s + k], X[k * kTile + c], acc);
    }
    const float base = R ? R[r * kTile + c] : 0.0f;
    Y[r * kTile + c] = base + alpha * acc;
  }
}

// Y = R - op(A) X for a full s x s block A (as tri_mm without the skip).
__device__ void full_mm_sub(const float* A, bool trans, const float* X,
                            const float* R, float* Y, int s, int tk) {
  for (int e = threadIdx.x; e < s * tk; e += blockDim.x) {
    const int r = e / tk, c = e % tk;
    float acc = 0.0f;
    for (int k = 0; k < s; ++k) {
      const float a = trans ? A[k * s + r] : A[r * s + k];
      acc = fmaf(a, X[k * kTile + c], acc);
    }
    Y[r * kTile + c] = R[r * kTile + c] - acc;
  }
}

__device__ void load_block(const float* src, float* dst, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// rhs tile (rows of block i, columns c0 .. c0 + tk) <-> shared s x kTile
__device__ void load_tile(const float* src, float* dst, int s, int k, int tk) {
  for (int e = threadIdx.x; e < s * tk; e += blockDim.x) {
    const int r = e / tk, c = e % tk;
    dst[r * kTile + c] = src[(long)r * k + c];
  }
}

__device__ void store_tile(const float* src, float* dst, int s, int k,
                           int tk) {
  for (int e = threadIdx.x; e < s * tk; e += blockDim.x) {
    const int r = e / tk, c = e % tk;
    dst[(long)r * k + c] = src[r * kTile + c];
  }
}

// K5: L_i = chol(D_i - S'_{i-1} S'_{i-1}^T), S'_i = S_i L_i^-T, and L_i^-1.
__global__ void __launch_bounds__(kThreads)
tri_llt_kernel(const float* __restrict__ diag, const float* __restrict__ off,
               float* __restrict__ Ld, float* __restrict__ Lo,
               float* __restrict__ Li, int nb, int s) {
  extern __shared__ float smem[];
  const int ss = s * s;
  float* a = smem;       // the block being factored, then L_i
  float* x = a + ss;     // L_i^-1
  float* sp = x + ss;    // S'_i
  float* m = sp + ss;    // S'_{i-1} S'_{i-1}^T, and S_i while S'_i is formed
  const long b = blockIdx.x;
  const float* D = diag + b * nb * ss;
  const float* S = off + b * (nb - 1) * ss;
  float* LD = Ld + b * nb * ss;
  float* LO = Lo + b * (nb - 1) * ss;
  float* LI = Li + b * nb * ss;
  for (int e = threadIdx.x; e < ss; e += blockDim.x) m[e] = 0.0f;
  for (int i = 0; i < nb; ++i) {
    __syncthreads();
    for (int e = threadIdx.x; e < ss; e += blockDim.x)
      a[e] = D[(long)i * ss + e] - m[e];
    jrlqp::chol_block(a, s, s);
    jrlqp::tri_inv_block(a, s, x, s, s);
    for (int e = threadIdx.x; e < ss; e += blockDim.x) {
      LD[(long)i * ss + e] = a[e];
      LI[(long)i * ss + e] = x[e];
    }
    if (i < nb - 1) {
      load_block(S + (long)i * ss, m, ss);
      __syncthreads();
      mm_nt(m, x, sp, s, true, false);             // S_i L_i^-T
      __syncthreads();
      for (int e = threadIdx.x; e < ss; e += blockDim.x)
        LO[(long)i * ss + e] = sp[e];
      mm_nt(sp, sp, m, s, false, false);           // S'_i S'_i^T
    }
  }
}

// K7: chol of each head block, B_i = S_i L_i^-T, the Schur complement
// D_last - sum B_i B_i^T factored last, and every L_i^-1. With up, block j
// of the (rolled) matrix is diag block (j + 1) % nb.
__global__ void __launch_bounds__(kThreads)
arrow_llt_kernel(const float* __restrict__ diag, const float* __restrict__ side,
                 float* __restrict__ Ld, float* __restrict__ Lo,
                 float* __restrict__ Li, int nb, int s, int up) {
  extern __shared__ float smem[];
  const int ss = s * s;
  float* a = smem;       // the block being factored, then L_i
  float* x = a + ss;     // L_i^-1
  float* sb = x + ss;    // S_i
  float* bb = sb + ss;   // B_i
  float* acc = bb + ss;  // sum of B_i B_i^T
  const long b = blockIdx.x;
  const float* D = diag + b * nb * ss;
  const float* S = side + b * (nb - 1) * ss;
  float* LD = Ld + b * nb * ss;
  float* LO = Lo + b * (nb - 1) * ss;
  float* LI = Li + b * nb * ss;
  for (int e = threadIdx.x; e < ss; e += blockDim.x) acc[e] = 0.0f;
  for (int i = 0; i < nb; ++i) {
    const int p = up ? (i + 1) % nb : i;
    const bool last = i == nb - 1;
    __syncthreads();
    for (int e = threadIdx.x; e < ss; e += blockDim.x)
      a[e] = last ? D[(long)p * ss + e] - acc[e] : D[(long)p * ss + e];
    jrlqp::chol_block(a, s, s);
    jrlqp::tri_inv_block(a, s, x, s, s);
    for (int e = threadIdx.x; e < ss; e += blockDim.x) {
      LD[(long)i * ss + e] = a[e];
      LI[(long)i * ss + e] = x[e];
    }
    if (!last) {
      load_block(S + (long)i * ss, sb, ss);
      __syncthreads();
      mm_nt(sb, x, bb, s, true, false);            // S_i L_i^-T
      __syncthreads();
      for (int e = threadIdx.x; e < ss; e += blockDim.x)
        LO[(long)i * ss + e] = bb[e];
      mm_nt(bb, bb, acc, s, false, true);          // += B_i B_i^T
    }
  }
}

// K6: y = G^-1 r by the forward chain y_i = L_i^-1 (r_i - S'_{i-1} y_{i-1})
// and the backward chain w_i = L_i^-T (y_i - S'_i^T w_{i+1}); with
// lower_only, y = L^-1 r (the forward chain alone). One thread block per
// (problem, tile of kTile rhs columns).
__global__ void __launch_bounds__(kThreads)
tri_solve_kernel(const float* __restrict__ Lo, const float* __restrict__ Li,
                 const float* __restrict__ r, float* y, int nb, int s, int k,
                 int lower_only) {
  extern __shared__ float smem[];
  const int ss = s * s;
  float* li = smem;        // L_i^-1
  float* lo = li + ss;     // S'_{i-1} (forward) or S'_i (backward)
  float* t1 = lo + ss;     // rhs tile
  float* t2 = t1 + s * kTile;  // y_{i-1} (forward) or w_{i+1} (backward)
  const long b = blockIdx.x;
  const int c0 = blockIdx.y * kTile;
  const int tk = min(kTile, k - c0);
  const float* LO = Lo + b * (nb - 1) * ss;
  const float* LI = Li + b * nb * ss;
  const long bs = (long)s * k;  // one block row of the rhs
  const float* R = r + b * nb * bs + c0;
  float* Y = y + b * nb * bs + c0;
  for (int i = 0; i < nb; ++i) {
    __syncthreads();
    load_block(LI + (long)i * ss, li, ss);
    if (i > 0) load_block(LO + (long)(i - 1) * ss, lo, ss);
    load_tile(R + i * bs, t1, s, k, tk);
    __syncthreads();
    if (i > 0) {
      full_mm_sub(lo, false, t2, t1, t1, s, tk);
      __syncthreads();
    }
    tri_mm(li, false, t1, nullptr, 1.0f, t2, s, tk);
    __syncthreads();
    store_tile(t2, Y + i * bs, s, k, tk);
  }
  if (lower_only) return;
  for (int i = nb - 1; i >= 0; --i) {
    __syncthreads();
    load_block(LI + (long)i * ss, li, ss);
    if (i < nb - 1) load_block(LO + (long)i * ss, lo, ss);
    load_tile(Y + i * bs, t1, s, k, tk);  // this block's forward y_i
    __syncthreads();
    if (i < nb - 1) {
      full_mm_sub(lo, true, t2, t1, t1, s, tk);
      __syncthreads();
    }
    tri_mm(li, true, t1, nullptr, 1.0f, t2, s, tk);
    __syncthreads();
    store_tile(t2, Y + i * bs, s, k, tk);
  }
}

// K8: the arrow solve. Forward: independent heads y_i = L_i^-1 r_i, whose
// coupling B_i y_i gathers into the last block, y_last = L_last^-1 (r_last
// - sum B_i y_i); backward: w_last = L_last^-T y_last, then each head
// w_i = L_i^-T (y_i - B_i^T w_last). With up, rhs and solution block j of
// the rolled system are block (j + 1) % nb.
__global__ void __launch_bounds__(kThreads)
arrow_solve_kernel(const float* __restrict__ Lo, const float* __restrict__ Li,
                   const float* __restrict__ r, float* y, int nb, int s,
                   int k, int up) {
  extern __shared__ float smem[];
  const int ss = s * s;
  float* li = smem;             // L_i^-1
  float* lo = li + ss;          // B_i
  float* t1 = lo + ss;          // rhs tile
  float* t2 = t1 + s * kTile;   // y_i
  float* t3 = t2 + s * kTile;   // sum B_i y_i, then w_last
  const long b = blockIdx.x;
  const int c0 = blockIdx.y * kTile;
  const int tk = min(kTile, k - c0);
  const float* LO = Lo + b * (nb - 1) * ss;
  const float* LI = Li + b * nb * ss;
  const long bs = (long)s * k;
  const float* R = r + b * nb * bs + c0;
  float* Y = y + b * nb * bs + c0;
  for (int e = threadIdx.x; e < s * kTile; e += blockDim.x) t3[e] = 0.0f;
  for (int i = 0; i < nb - 1; ++i) {
    const int p = up ? (i + 1) % nb : i;
    __syncthreads();
    load_block(LI + (long)i * ss, li, ss);
    load_block(LO + (long)i * ss, lo, ss);
    load_tile(R + p * bs, t1, s, k, tk);
    __syncthreads();
    tri_mm(li, false, t1, nullptr, 1.0f, t2, s, tk);
    __syncthreads();
    store_tile(t2, Y + p * bs, s, k, tk);
    full_mm_sub(lo, false, t2, t3, t3, s, tk);  // t3 -= B_i y_i
  }
  const int pl = up ? 0 : nb - 1;  // (nb - 1 + 1) % nb when up
  __syncthreads();
  load_block(LI + (long)(nb - 1) * ss, li, ss);
  load_tile(R + pl * bs, t1, s, k, tk);
  __syncthreads();
  // t3 holds -sum B_i y_i, so r_last - sum B_i y_i = r_last + t3
  for (int e = threadIdx.x; e < s * tk; e += blockDim.x) {
    const int rr = e / tk, c = e % tk;
    t1[rr * kTile + c] += t3[rr * kTile + c];
  }
  __syncthreads();
  tri_mm(li, false, t1, nullptr, 1.0f, t2, s, tk);   // y_last
  __syncthreads();
  tri_mm(li, true, t2, nullptr, 1.0f, t3, s, tk);    // w_last
  __syncthreads();
  store_tile(t3, Y + pl * bs, s, k, tk);
  for (int i = 0; i < nb - 1; ++i) {
    const int p = up ? (i + 1) % nb : i;
    __syncthreads();
    load_block(LI + (long)i * ss, li, ss);
    load_block(LO + (long)i * ss, lo, ss);
    load_tile(Y + p * bs, t1, s, k, tk);  // this block's head y_i
    __syncthreads();
    full_mm_sub(lo, true, t3, t1, t1, s, tk);
    __syncthreads();
    tri_mm(li, true, t1, nullptr, 1.0f, t2, s, tk);
    __syncthreads();
    store_tile(t2, Y + p * bs, s, k, tk);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int jrlqp_tri_block_llt(const void* diag, const void* off,
                                   void* Ld, void* Lo, void* Li, int B,
                                   int nb, int s, void* stream) {
  const size_t smem = 4 * (size_t)s * s * sizeof(float);
  cudaError_t err = set_smem(tri_llt_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    tri_llt_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)diag, (const float*)off, (float*)Ld, (float*)Lo,
        (float*)Li, nb, s);
  return (int)cudaGetLastError();
}

extern "C" int jrlqp_block_arrow_llt(const void* diag, const void* side,
                                     void* Ld, void* Lo, void* Li, int B,
                                     int nb, int s, int up, void* stream) {
  const size_t smem = 5 * (size_t)s * s * sizeof(float);
  cudaError_t err = set_smem(arrow_llt_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    arrow_llt_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)diag, (const float*)side, (float*)Ld, (float*)Lo,
        (float*)Li, nb, s, up);
  return (int)cudaGetLastError();
}

extern "C" int jrlqp_tri_block_solve(const void* Lo, const void* Li,
                                     const void* r, void* y, int B, int nb,
                                     int s, int k, int lower_only,
                                     void* stream) {
  const size_t smem = (2 * (size_t)s * s + 2 * (size_t)s * kTile)
                      * sizeof(float);
  cudaError_t err = set_smem(tri_solve_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && k > 0) {
    const dim3 grid(B, (k + kTile - 1) / kTile);
    tri_solve_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)Lo, (const float*)Li, (const float*)r, (float*)y, nb, s,
        k, lower_only);
  }
  return (int)cudaGetLastError();
}

extern "C" int jrlqp_block_arrow_solve(const void* Lo, const void* Li,
                                       const void* r, void* y, int B, int nb,
                                       int s, int k, int up, void* stream) {
  const size_t smem = (2 * (size_t)s * s + 3 * (size_t)s * kTile)
                      * sizeof(float);
  cudaError_t err = set_smem(arrow_solve_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && k > 0) {
    const dim3 grid(B, (k + kTile - 1) / kTile);
    arrow_solve_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)Lo, (const float*)Li, (const float*)r, (float*)y, nb, s,
        k, up);
  }
  return (int)cudaGetLastError();
}
