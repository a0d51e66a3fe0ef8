// The structured refinement's kernels K13 and K14: the f64 products of the
// iterative refinement of a structured batch (jrlqp_tpu_torch/structured/
// solver.py, _BlockProducts) on G's blocks and C's rows.
//
// The JAX package refines with XLA ops on the dense G and C
// (jrlqp_tpu/solver/fast.py:397, _refine_batch); it has no Pallas kernel
// here. On the structure each step's products are small: G is nb blocks of
// s x s on the diagonal and nb - 1 off it, and an active normal is a row of
// C or a unit vector. Written as PyTorch ops they are some seventy launches
// a refinement, and the host takes longer to launch them than the card to
// run them. So each step runs them as two launches, beside the three f32
// gemvs with the loop's H and N* (cuBLAS, through torch):
//
//   K13 struct_gmul_kernel: t = f32(G u) - r and g = G v in f64, u and v
//       f32 (B, n). One thread block per lane. Each s x s block of G is
//       staged in shared memory once (a coalesced copy) and used for both
//       columns, an off-diagonal block also for its transpose, so a pass
//       reads G's blocks once: 257 MB at the IK shape (B = 1024, nb = 9,
//       s = 43). Thread t owns row r of column c wherever c s + r is t
//       plus a multiple of the block's 256 threads, so every s whose block
//       and columns fit in shared memory runs.
//   K14 struct_update_kernel: the step's update of the tracked f64
//       quantities and the next residuals, one thread block per lane:
//         x += dx, lam = valid ? lam + dlam : 0, y += dy,
//         ntx += N^T dx (slot k: sgn_k C[idx_k] . dx, or sgn_k dx[idx_k - m]),
//         w += N dlam = C^T mu_c + mu_b (each multiplier alone in its row),
//         r1 = f32(w - y - a), r2 = valid ? f32(b - ntx) : 0.
//       C is (B, m, width) f64 with mc rows per block of width columns:
//       a StructuredC's blocks (width s, mc) or a dense C (width n, mc m).
//
// Sums run in another order than in the plain PyTorch versions
// (jrlqp_tpu_torch/ops/cuda/struct_refine.py), so kernel and plain agree
// to rounding, not bitwise.
#include <cuda_runtime.h>

namespace {

constexpr int kTri = 0;        // GType.TRI_BLOCK_DIAGONAL
constexpr int kArrowUp = 1;    // GType.BLOCK_ARROW_UP
// K13: all threads stage a block, 8 loads each in flight at s = 43; the
// 2 s rows of the two columns are dealt over them
constexpr int kGmulThreads = 256;
constexpr int kUpdateThreads = 128;

size_t gmul_smem_bytes(int nb, int s) {
  // the staged block, the two columns of x and of y
  return ((size_t)s * s + 4 * (size_t)nb * s) * sizeof(double);
}

size_t update_smem_bytes(int n, int m) {
  return (2 * (size_t)n + m) * sizeof(double);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Stage the s x s block M (row-major) in shared memory.
__device__ __forceinline__ void stage(double* tile, const double* M, int ss) {
  __syncthreads();  // the previous block's products are done
#pragma unroll 8
  for (int e = threadIdx.x; e < ss; e += blockDim.x) tile[e] = M[e];
  __syncthreads();
}

// y[dst] += M x[src] (or M^T x[src]) for this thread's row and column.
__device__ __forceinline__ void block_product(const double* tile,
                                              const double* xc, double* yc,
                                              int s, int row, int src,
                                              int dst, bool trans) {
  const double* xs = xc + src * s;
  double acc = 0.0;
  if (trans) {
    for (int c = 0; c < s; ++c) acc = fma(tile[c * s + row], xs[c], acc);
  } else {
    for (int c = 0; c < s; ++c) acc = fma(tile[row * s + c], xs[c], acc);
  }
  yc[dst * s + row] += acc;
}

__global__ void struct_gmul_kernel(const double* __restrict__ diag,
                                   const double* __restrict__ off,
                                   const float* __restrict__ u,
                                   const float* __restrict__ v,
                                   const float* __restrict__ r,
                                   float* __restrict__ t,
                                   double* __restrict__ g, int nb, int s,
                                   int gtype) {
  extern __shared__ double smem[];
  const int n = nb * s;
  const int ss = s * s;
  const size_t lane = blockIdx.x;
  double* tile = smem;
  double* x = smem + ss;        // u then v
  double* y = x + 2 * n;        // G u then G v
  const bool has_u = u != nullptr;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    x[e] = has_u ? (double)u[lane * n + e] : 0.0;
    x[n + e] = (double)v[lane * n + e];
    y[e] = 0.0;
    y[n + e] = 0.0;
  }
  // the rows t = c s + r this thread owns (column 0, u, only with u)
  const int first = has_u ? 0 : s;
  const double* D = diag + lane * nb * ss;
  for (int i = 0; i < nb; ++i) {
    stage(tile, D + (size_t)i * ss, ss);
    for (int t = first + threadIdx.x; t < 2 * s; t += blockDim.x) {
      const int col = t / s;
      block_product(tile, x + col * n, y + col * n, s, t - col * s, i, i,
                    false);
    }
  }
  // off block k at block (rb, cb), rb != cb: rows rb take M x[cb], rows cb
  // take M^T x[rb]; a thread adds to its own rows of each
  const double* O = off + lane * (nb - 1) * ss;
  for (int k = 0; k < nb - 1; ++k) {
    const int rb = gtype == kTri ? k + 1 : (gtype == kArrowUp ? 0 : nb - 1);
    const int cb = gtype == kArrowUp ? k + 1 : k;
    stage(tile, O + (size_t)k * ss, ss);
    for (int t = first + threadIdx.x; t < 2 * s; t += blockDim.x) {
      const int col = t / s;
      const int row = t - col * s;
      block_product(tile, x + col * n, y + col * n, s, row, cb, rb, false);
      block_product(tile, x + col * n, y + col * n, s, row, rb, cb, true);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    if (has_u) t[lane * n + e] = (float)y[e] - r[lane * n + e];
    g[lane * n + e] = y[n + e];
  }
}

__global__ void struct_update_kernel(
    const double* __restrict__ C, const int* __restrict__ idx,
    const double* __restrict__ sgn, const double* __restrict__ a,
    const double* __restrict__ bnd, const float* __restrict__ dx,
    const float* __restrict__ dlam, const double* __restrict__ dy,
    double* __restrict__ x, double* __restrict__ lam, double* __restrict__ y,
    double* __restrict__ ntx, double* __restrict__ w, float* __restrict__ r1,
    float* __restrict__ r2, int n, int m, int mc, int width) {
  extern __shared__ double smem[];
  double* dxs = smem;           // n
  double* mu = smem + n;        // m + n: mu_c then mu_b
  const size_t o = (size_t)blockIdx.x * n;
  const double* Cb = C + (size_t)blockIdx.x * m * width;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const double d = (double)dx[o + j];
    dxs[j] = d;
    x[o + j] += d;
    y[o + j] += dy[o + j];
  }
  for (int e = threadIdx.x; e < m + n; e += blockDim.x) mu[e] = 0.0;
  __syncthreads();
  // a constraint is active in one slot at most: no two slots write one mu
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const double sk = sgn[o + k];
    const double dl = (double)dlam[o + k];
    if (sk != 0.0) mu[idx[o + k]] = sk * dl;
    lam[o + k] = sk != 0.0 ? lam[o + k] + dl : 0.0;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const double sk = sgn[o + k];
    double v = 0.0;
    if (sk != 0.0) {
      const int id = idx[o + k];
      if (id >= m) {
        v = dxs[id - m];
      } else {
        const double* crow = Cb + (size_t)id * width;
        const double* xs = dxs + (id / mc) * width;
        for (int c = 0; c < width; ++c) v = fma(crow[c], xs[c], v);
      }
    }
    const double nt = ntx[o + k] + sk * v;
    ntx[o + k] = nt;
    r2[o + k] = sk != 0.0 ? (float)(bnd[o + k] - nt) : 0.0f;
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int blk = j / width;
    const int c = j - blk * width;
    const int r_end = min(blk * mc + mc, m);
    double v = 0.0;
    for (int rr = blk * mc; rr < r_end; ++rr)
      v = fma(Cb[(size_t)rr * width + c], mu[rr], v);
    const double wj = w[o + j] + (v + mu[m + j]);
    w[o + j] = wj;
    r1[o + j] = (float)((wj - y[o + j]) - a[o + j]);
  }
}

}  // namespace

// K13: diag (B, nb, s, s), off (B, nb-1, s, s) f64, any s whose block and
// four (B, n) columns fit in a thread block's shared memory (else the
// attribute's error); u (may be null), v, r (null with u) f32 (B, n); t f32
// (unwritten without u), g f64 (B, n).
extern "C" int jrlqp_struct_gmul(const void* diag, const void* off,
                                 const void* u, const void* v, const void* r,
                                 void* t, void* g, int B, int nb, int s,
                                 int gtype, void* stream) {
  const size_t smem = gmul_smem_bytes(nb, s);
  cudaError_t err = set_smem(struct_gmul_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    struct_gmul_kernel<<<B, kGmulThreads, smem, (cudaStream_t)stream>>>(
        (const double*)diag, (const double*)off, (const float*)u,
        (const float*)v, (const float*)r, (float*)t, (double*)g, nb, s,
        gtype);
  return (int)cudaGetLastError();
}

// K14: C (B, m, width) f64, idx int32 (B, n), sgn, a, b f64 (B, n); dx,
// dlam f32, dy f64 (B, n); x, lam, y, ntx, w f64 (B, n) in place; r1, r2
// f32 (B, n).
extern "C" int jrlqp_struct_update(const void* C, const void* idx,
                                   const void* sgn, const void* a,
                                   const void* b, const void* dx,
                                   const void* dlam, const void* dy, void* x,
                                   void* lam, void* y, void* ntx, void* w,
                                   void* r1, void* r2, int B, int n, int m,
                                   int mc, int width, void* stream) {
  const size_t smem = update_smem_bytes(n, m);
  cudaError_t err = set_smem(struct_update_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    struct_update_kernel<<<B, kUpdateThreads, smem, (cudaStream_t)stream>>>(
        (const double*)C, (const int*)idx, (const double*)sgn,
        (const double*)a, (const double*)b, (const float*)dx,
        (const float*)dlam, (const double*)dy, (double*)x, (double*)lam,
        (double*)y, (double*)ntx, (double*)w, (float*)r1, (float*)r2, n, m,
        mc, width);
  return (int)cudaGetLastError();
}
