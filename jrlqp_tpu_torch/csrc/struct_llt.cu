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
// They reuse K2's device function chol_inv_block.
// A solve (K6, K8) runs 2 nb dependent block products, but its rhs columns
// are independent and, on the structured path, the rhs is the identity
// (k = n = 387): one problem's rhs is 600 KB, too much for one block. So
// the grid is (problem, tile of T rhs columns); each block runs the forward
// and the backward chain on its tile and keeps the forward results in the
// output buffer in device memory, which only that block reads back.
// Nothing crosses blocks. By the count, a solve is bound by its operations:
// (6 nb - 4) s^2 f32 FMAs per rhs column, 36.6 GFLOP at the IK shape, to
// the bytes' 1.3 GB. The products are IEEE f32 (the port keeps TF32 off,
// and wgmma has no IEEE f32 mode), so the unit to fill is the FMA pipe, and
// the design feeds it from registers: each thread owns a 4 x 4 unit of a
// product and does 16 FMAs per two 16-byte shared loads (the tile products
// below); T is chosen from k so that the tiles are few and even (387 =
// 3 x 129 in tiles of 132, no tile of 3 columns that would stage every
// block and pass every barrier, and each block staged 3 times, not 7);
// the next step's operand blocks and rhs tile arrive by cp.async while
// this step's products run; and a tile that is exactly zero, with nothing
// coupled into it, is not multiplied (its result is zero for finite
// factors): with the identity as rhs that is most of K8's forward heads
// and K6's forward chain above the tile's own block row.
// What bounds K8 now, measured on an H100 (PERF.md, section 6): of its
// 2.4 ms at the IK shape the FMAs are ~0.5, and ~1 ms is the staging: an
// s x s block of odd s starts at no 16-byte boundary, so operands and
// tiles come in by 4-byte cp.async, the forward operands transposed on the
// way. The rest is barriers, the zero tests and the stores. K6 takes its
// operands in a padded layout instead (K5 writes its factor with rows of
// round4(s) floats; rhs and output rows are round4(k) floats), so its
// blocks and tiles arrive by TMA copies that do not hold their issuer
// (tri_solve_kernel).
//
// Up arrows: the Pallas wrappers roll the diagonal blocks (and the rhs) by
// -1 before the kernel and the solution by +1 after it; here the kernels
// read block (j + 1) % nb in place of block j instead, so no copy is made.
// Sums run in another order than in the plain PyTorch versions, so kernel
// and plain agree to a tolerance, not bitwise.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>

#include "block_llt.cuh"

namespace {

constexpr int kThreads = 256;  // K5 and K7

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

__device__ void load_block(const float* src, float* dst, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// ---------------------------------------------------------------------------
// The solves' tile products (K6, K8). A thread block owns a tile of T rhs
// columns of one problem; a thread owns a 4 x 4 unit of each s x T product:
// rows r0 .. r0 + 3, columns c0 .. c0 + 3. The left operand op(A) is staged
// k-major (At[k][r] = op(A)[r][k], row pitch sp = s rounded up to 4), so one
// float4 holds op(A) for the unit's four rows at depth k, broadcast to the
// lanes that share the rows, and one float4 of the tile holds its four
// columns: 16 FMAs per two 16-byte shared loads. The zero half of a
// triangular block is skipped as a range of k per row group.
// ---------------------------------------------------------------------------

// The widest rhs tile. Every tile of a problem stages all of its operand
// blocks, so wide tiles stage less: at the IK shape 3 tiles of 132 columns
// in one block of 384 threads per SM were 12-14% faster than 7 tiles of 56
// in three blocks of 160 (PERF.md, section 6), and 2 tiles do not fit.
// K6's zero pass and its tensor copies' boxes take it to be under 256.
constexpr int kSolveTileMax = 132;
// A solve block has at most this many threads; __launch_bounds__ of it
// holds the kernels to 128 registers.
constexpr int kSolveBoundThreads = 512;
constexpr int kSmemLimit = 232448;    // dynamic shared memory per block

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

// Floats of shared memory of a solve block (K8): two stages of two s x sp
// operand blocks, two staged tiles and two working tiles of s x T.
__host__ __device__ inline size_t solve_smem_floats(int s, int T) {
  return 4 * (size_t)s * round4(s) + 4 * (size_t)s * T;
}

// The tile width for k rhs columns when a tile of width T needs bytes(T)
// of shared memory: the fewest tiles no wider than kSolveTileMax (or than
// shared memory and the thread bound allow at this s), made even (387 ->
// 3 x 132, not 2 x 132 + 123), rounded up to a multiple of 4.
template <typename Bytes>
__host__ __device__ inline int tile_width(int k, int s, Bytes bytes) {
  int tmax = kSolveTileMax;
  while (tmax > 4 && (bytes(tmax) > (size_t)kSmemLimit ||
                      (round4(s) / 4) * (tmax / 4) > kSolveBoundThreads))
    tmax -= 4;
  const int nt = (k + tmax - 1) / tmax;
  return round4((k + nt - 1) / nt);
}

// K8's tile width.
__host__ __device__ inline int solve_tile(int k, int s) {
  return tile_width(k, s, [s](int T) { return solve_smem_floats(s, T) * 4; });
}

// Threads of a solve block: one per unit, a whole number of warps.
__host__ __device__ inline int solve_threads(int s, int T) {
  return ((round4(s) / 4) * (T / 4) + 31) / 32 * 32;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage the s x s row-major block A of device memory k-major for
// op(A) = A (At[k][r] = A[r][k], a transposing copy) or, with trans,
// op(A) = A^T (At[k][r] = A[k][r], a straight copy), by 4-byte cp.async (a
// block of odd s starts at no 16-byte boundary). With lower, what lies
// above A's diagonal is staged as zero whatever the source holds. Warps
// take rows of A, lanes its columns.
__device__ __forceinline__ void stage_block(float* At, const float* A, int s,
                                            int sp, bool trans, bool lower) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < s; i += nwarps)
    for (int j = lane; j < s; j += 32) {
      float* dst = trans ? At + i * sp + j : At + j * sp + i;
      if (lower && j > i) *dst = 0.0f;
      else cp_async4(dst, A + i * s + j);
    }
}

// Stage s rows of tk columns of the rhs (row stride k in device memory)
// into a tile of row pitch T.
__device__ __forceinline__ void stage_tile(float* tile, const float* src,
                                           int s, int k, int tk, int T) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < s; r += nwarps)
    for (int c = lane; c < tk; c += 32)
      cp_async4(tile + r * T + c, src + (long)r * k + c);
}

// Block-uniform: does the staged tile hold a nonzero (or NaN) entry? A
// barrier.
__device__ __forceinline__ bool tile_nonzero(const float* tile, int s, int tk,
                                             int T) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int nz = 0;
  for (int r = warp; r < s; r += nwarps)
    for (int c = lane; c < tk; c += 32) nz |= !(tile[r * T + c] == 0.0f);
  return __syncthreads_or(nz) != 0;
}

struct Unit {
  float v[4][4];
};

__device__ __forceinline__ void unit_zero(Unit& u) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) u.v[i][j] = 0.0f;
}

// acc += sum over k in [k0, k1) of At[k][r0 ..] X[k][c0 ..]^T.
__device__ __forceinline__ void unit_mac(Unit& acc, const float* At, int sp,
                                         const float* X, int T, int r0,
                                         int c0, int k0, int k1) {
  const float* ap = At + k0 * sp + r0;
  const float* xp = X + k0 * T + c0;
#pragma unroll 4
  for (int k = k0; k < k1; ++k, ap += sp, xp += T) {
    const float4 a = *reinterpret_cast<const float4*>(ap);
    const float4 x = *reinterpret_cast<const float4*>(xp);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.v[i][j] = fmaf(av[i], xv[j], acc.v[i][j]);
  }
}

// The unit's rows of a shared tile; rows at or beyond s are not touched.
__device__ __forceinline__ void unit_get(Unit& u, const float* tile, int T,
                                         int r0, int c0, int s) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + i < s) t = *reinterpret_cast<const float4*>(tile + (r0 + i) * T + c0);
    u.v[i][0] = t.x;
    u.v[i][1] = t.y;
    u.v[i][2] = t.z;
    u.v[i][3] = t.w;
  }
}

__device__ __forceinline__ void unit_put(const Unit& u, float* tile, int T,
                                         int r0, int c0, int s) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (r0 + i < s)
      *reinterpret_cast<float4*>(tile + (r0 + i) * T + c0) =
          make_float4(u.v[i][0], u.v[i][1], u.v[i][2], u.v[i][3]);
}

// The unit's valid entries to the output in device memory (row stride k).
__device__ __forceinline__ void unit_store(const Unit& u, float* dst, int k,
                                           int r0, int c0, int s, int tk) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (r0 + i < s && c0 + j < tk) dst[(long)(r0 + i) * k + c0 + j] = u.v[i][j];
}

// a := b - a
__device__ __forceinline__ void unit_rsub(Unit& a, const Unit& b) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a.v[i][j] = b.v[i][j] - a.v[i][j];
}

// The shared memory of a solve block and this thread's unit.
struct SolveCtx {
  float* A0;       // operand blocks, k-major, s x sp each: see A()
  float* X0;       // the staged rhs (or forward-result) tiles: see X()
  float *U, *V;    // working tiles
  int s, sp, T, tk, k;
  int r0, c0;      // this thread's unit
  bool live;       // the unit lies inside the tile
  // k ranges of the unit's products with a staged lower block L: [0, kn)
  // for L, [kt, s) for L^T
  int kn, kt;
  // stage st (0 or 1), slot sl (0 or 1); computed, not looked up, so the
  // struct stays in registers
  __device__ __forceinline__ float* A(int st, int sl) const {
    return A0 + (2 * st + sl) * s * sp;
  }
  __device__ __forceinline__ float* X(int st) const {
    return X0 + st * s * T;
  }
};

__device__ __forceinline__ SolveCtx solve_ctx(float* smem, int s, int k) {
  SolveCtx c;
  c.s = s;
  c.sp = round4(s);
  c.k = k;
  c.T = solve_tile(k, s);
  c.tk = min(c.T, k - (int)blockIdx.y * c.T);
  c.A0 = smem;
  c.X0 = smem + 4 * s * c.sp;
  c.U = c.X0 + 2 * s * c.T;
  c.V = c.U + s * c.T;
  const int cgs = c.T / 4;
  c.r0 = 4 * ((int)threadIdx.x / cgs);
  c.c0 = 4 * ((int)threadIdx.x % cgs);
  c.live = c.r0 < s;
  c.kn = min(c.r0 + 4, s);
  c.kt = min(c.r0, s);
  return c;
}

// The s x s block src (shared memory, row pitch s) to dst (device memory,
// row pitch ld): warps take rows, lanes columns.
__device__ __forceinline__ void store_block(float* dst, int ld,
                                            const float* src, int s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = warp; row < s; row += blockDim.x >> 5)
    for (int c = lane; c < s; c += 32) dst[(long)row * ld + c] = src[row * s + c];
}

// K5: L_i = chol(D_i - S'_{i-1} S'_{i-1}^T), S'_i = S_i L_i^-T, and L_i^-1.
// The three outputs leave with rows of ld = round4(s) floats, the layout in
// which K6 copies them (the pad columns are not written).
__global__ void __launch_bounds__(kThreads)
tri_llt_kernel(const float* __restrict__ diag, const float* __restrict__ off,
               float* __restrict__ Ld, float* __restrict__ Lo,
               float* __restrict__ Li, int nb, int s) {
  extern __shared__ __align__(16) float smem[];
  const int ss = s * s, ld = round4(s), so = s * ld;
  float* a = smem;       // the block being factored, then L_i
  float* x = a + ss;     // L_i^-1
  float* sp = x + ss;    // S'_i
  float* m = sp + ss;    // S'_{i-1} S'_{i-1}^T, and S_i while S'_i is formed
  const long b = blockIdx.x;
  const float* D = diag + b * nb * ss;
  const float* S = off + b * (nb - 1) * ss;
  float* LD = Ld + b * nb * so;
  float* LO = Lo + b * (nb - 1) * so;
  float* LI = Li + b * nb * so;
  for (int e = threadIdx.x; e < ss; e += blockDim.x) m[e] = 0.0f;
  for (int i = 0; i < nb; ++i) {
    __syncthreads();
    for (int e = threadIdx.x; e < ss; e += blockDim.x)
      a[e] = D[(long)i * ss + e] - m[e];
    jrlqp::chol_inv_block(a, s, x, s, s);
    store_block(LD + (long)i * so, ld, a, s);
    store_block(LI + (long)i * so, ld, x, s);
    if (i < nb - 1) {
      load_block(S + (long)i * ss, m, ss);
      __syncthreads();
      mm_nt(m, x, sp, s, true, false);             // S_i L_i^-T
      __syncthreads();
      store_block(LO + (long)i * so, ld, sp, s);
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
  extern __shared__ __align__(16) float smem[];
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
    jrlqp::chol_inv_block(a, s, x, s, s);
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

// ---------------------------------------------------------------------------
// K6's copies: TMA copies into shared memory, each completing its bytes on
// the stage's mbarrier: an operand block as one bulk copy (cp.async.bulk),
// a tile of the rhs or of the forward results as one 2-D box of a tensor
// map. The issuing thread does not wait on them, where a step's 9,400
// 4-byte cp.async held their issuers for a third of the step, and one bulk
// copy per tile row still cost a sixth (PERF.md, section 6). Sources and
// row pitches are multiples of 16 bytes: the blocks and rows come padded
// (row pitch sp = round4(s) and kp = round4(k)).
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// The one arrival of the phase, which also expects `bytes` of copies.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A copy that never
// lands (a fault of the caller's layout) ends the kernel with a trap after
// about a second of polling, rather than hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  for (long polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1l << 22)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The box at (x, y, z) of the 3-D tensor map `map` (rows of floats: the
// rhs or the output) into shared memory at dst (128-byte aligned, rows of
// the box's width), completing on bar.
__device__ __forceinline__ void tile_copy(float* dst, const CUtensorMap* map,
                                          int x, int y, int z,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(z),
      "r"(smem_u32(bar))
      : "memory");
}

// acc += sum over k in [0, k1) of A[r][k] X[k][c]: the unit's rows of a
// row-major s x sp block as its bulk copy lands (op(A) = A), k1 a multiple
// of 4 no larger than sp, four k at a time (4 float4 loads of A, 4 of X, 64
// FMAs, each sum still in k order). In the last quad A's columns from s on
// (the pad, whatever it holds) are taken as zero, and X's rows there are
// zero pad rows; with lower, that quad (k1 = r0 + 4) holds the diagonal,
// and what lies above it is taken as zero too.
__device__ __forceinline__ void unit_mac_rows(Unit& acc, const float* A, int sp,
                                              const float* X, int T, int r0,
                                              int c0, int k1, int s,
                                              bool lower) {
  for (int k = 0; k < k1; k += 4) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(A + (r0 + i) * sp + k);
      a[i][0] = v.x;
      a[i][1] = v.y;
      a[i][2] = v.z;
      a[i][3] = v.w;
    }
    if (k + 4 == k1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if ((lower && kk > i) || k + kk >= s) a[i][kk] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 x = *reinterpret_cast<const float4*>(X + (k + kk) * T + c0);
      const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc.v[i][j] = fmaf(a[i][kk], xv[j], acc.v[i][j]);
    }
  }
}

// acc += sum over k in [r0, s) of L[k][r] X[k][c] (op(A) = L^T for a
// row-major lower L): unit_mac from k = r0 + 4 on; the first quad masks
// L's entries above its diagonal (k < r) and any k beyond s.
__device__ __forceinline__ void unit_mac_upper(Unit& acc, const float* L,
                                               int sp, const float* X, int T,
                                               int r0, int c0, int s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = r0 + kk;
    if (k < s) {
      const float4 a = *reinterpret_cast<const float4*>(L + k * sp + r0);
      const float4 x = *reinterpret_cast<const float4*>(X + k * T + c0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc.v[i][j] = fmaf(i <= kk ? av[i] : 0.0f, xv[j], acc.v[i][j]);
    }
  }
  unit_mac(acc, L, sp, X, T, r0, c0, r0 + 4, s);
}

// K6's copies run two steps ahead of its products: three stages.
constexpr int kTriStages = 3;

// Floats of one of K6's tiles (sp rows of T), rounded up to 128 bytes: the
// tiles come first in shared memory, each on a 128-byte boundary, as a
// tensor copy's destination must be.
__host__ __device__ inline int tri_tile_floats(int s, int T) {
  return (round4(s) * T + 31) / 32 * 32;
}

// Bytes of K6's shared memory at tile width T: the staged tiles and the two
// working tiles, the stages' operand blocks (each s x sp, in room for sp
// rows: a unit's rows at and beyond s read its own room), then the stages'
// mbarriers and the zero mask's two words.
__host__ __device__ inline size_t tri_solve_smem_bytes(int s, int T) {
  const size_t sp = round4(s);
  return ((size_t)(kTriStages + 2) * tri_tile_floats(s, T) +
          2 * kTriStages * sp * sp) * sizeof(float) + 32;
}

// K6's tile width.
__host__ __device__ inline int tri_solve_tile(int k, int s) {
  return tile_width(k, s, [s](int T) { return tri_solve_smem_bytes(s, T); });
}

// The unit's rows below s to the output in device memory (row stride k), as
// float4 stores, for a unit that starts inside the tile's tk columns: K6's
// output rows have room up to round4(k), so a unit that ends in the pad
// stores there too (no one reads it).
__device__ __forceinline__ void unit_store4(const Unit& u, float* dst, int k,
                                            int r0, int c0, int s, int tk) {
  if (c0 >= tk) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (r0 + i < s)
      *reinterpret_cast<float4*>(dst + (long)(r0 + i) * k + c0) =
          make_float4(u.v[i][0], u.v[i][1], u.v[i][2], u.v[i][3]);
}

// K6: y = G^-1 r by the forward chain y_i = L_i^-1 (r_i - S'_{i-1} y_{i-1})
// and the backward chain w_i = L_i^-T (y_i - S'_i^T w_{i+1}); with
// lower_only, y = L^-1 r (the forward chain alone). One thread block per
// (problem, tile of T rhs columns). The factor's blocks come with rows of
// sp floats (what the pad holds never reaches a result), the rhs with rows
// of kp floats (problem b at r + b * rbs; rbs = 0 shares one rhs, such as
// the identity, across the batch), the output with rows of kp.
// First, one pass over the rhs tile finds its block rows that are exactly
// zero (any NaN counts as nonzero; blocks 0..63). The forward chain then
// starts at the first nonzero block f, whose coupling is zero: blocks above
// it are never staged, and a zero block row's tile is never copied. Each
// executed step's blocks and tile arrive by TMA bulk copies issued by warp
// 0 two steps ahead (three stages), onto the stage's mbarrier; the forward
// products read the blocks as they land, row-major (unit_mac_rows), the
// backward ones as k-major transposes (unit_mac, unit_mac_upper). Results
// leave as float4 stores. The forward results come back for the backward
// chain (a proxy fence orders those stores before the bulk copies read
// them); only this block reads them.
__global__ void __launch_bounds__(kSolveBoundThreads)
tri_solve_kernel(const float* __restrict__ Lo, const float* __restrict__ Li,
                 const float* __restrict__ r, long rbs, float* y,
                 const __grid_constant__ CUtensorMap rmap,
                 const __grid_constant__ CUtensorMap ymap, int nb, int s,
                 int k, int lower_only) {
  extern __shared__ __align__(128) float tri_smem[];
  const int sp = round4(s), kp = round4(k);
  const int T = tri_solve_tile(k, s);
  const int tk = min(T, k - (int)blockIdx.y * T);
  const int ss = s * sp;                    // a padded block
  const int ts = tri_tile_floats(s, T);
  float* X0 = tri_smem;                     // stage st's tile: X0 + st ts
  float* U = X0 + kTriStages * ts;          // the chain tile
  float* V = U + ts;
  float* A0 = V + ts;                       // stage st's blocks: A0 + 2 st sp sp
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(A0 + 2 * kTriStages * sp * sp);
  unsigned* zw = reinterpret_cast<unsigned*>(bar + kTriStages);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int cgs = T / 4, r0 = 4 * (tid / cgs), c0 = 4 * (tid % cgs);
  const bool live = r0 < s;
  const long b = blockIdx.x;
  const long col0 = (long)blockIdx.y * T;
  const float* LO = Lo + b * (nb - 1) * ss;
  const float* LI = Li + b * nb * ss;
  const long bs = (long)s * kp;             // one block row of rhs and output
  const float* R = r + b * rbs + col0;
  float* Y = y + b * nb * bs + col0;

  // the tiles' pad rows are zero for good; the mbarriers; the mask's words
  for (int c = tid; c < T; c += blockDim.x)
    for (int row = s; row < sp; ++row) {
      for (int st = 0; st < kTriStages; ++st) X0[st * ts + row * T + c] = 0.0f;
      U[row * T + c] = 0.0f;
      V[row * T + c] = 0.0f;
    }
  if (tid == 0) {
    for (int st = 0; st < kTriStages; ++st) mbar_init(&bar[st]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    zw[0] = zw[1] = 0u;
  }
  __syncthreads();
  // which block rows of the rhs tile hold a nonzero (or NaN) entry: the
  // tile's rows q = i s + row lie at q kp; warps take rows, each lane two
  // float4 groups (T <= kSolveTileMax < 256). Eight rows' loads are issued
  // before any is tested, with no branch between them: each load's column
  // is clamped into the tile (a lane past it reads a column it then
  // ignores), its row into the rhs.
  const int nmask = min(nb, 64), nq = nmask * s;
  unsigned long long nz = 0;
  auto nonzero = [&](const float4& v, int c) {
    return (c < tk && !(v.x == 0.0f)) || (c + 1 < tk && !(v.y == 0.0f)) ||
           (c + 2 < tk && !(v.z == 0.0f)) || (c + 3 < tk && !(v.w == 0.0f));
  };
  const int ca = 4 * lane, cb = ca + 128, clast = (tk - 1) / 4 * 4;
  const float* Ra = R + min(ca, clast);
  const float* Rb = R + min(cb, clast);
  constexpr int kRows = 8;
  for (int q0 = warp; q0 < nq; q0 += kRows * nwarps) {
    float4 va[kRows], vb[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long q = min(q0 + u * nwarps, nq - 1);
      va[u] = *reinterpret_cast<const float4*>(Ra + q * kp);
      vb[u] = *reinterpret_cast<const float4*>(Rb + q * kp);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int q = q0 + u * nwarps;
      if (q < nq && (nonzero(va[u], ca) || nonzero(vb[u], cb)))
        nz |= 1ull << (q / s);
    }
  }
  const unsigned lo32 = __reduce_or_sync(0xffffffffu, (unsigned)nz);
  const unsigned hi32 = __reduce_or_sync(0xffffffffu, (unsigned)(nz >> 32));
  if (lane == 0) {
    if (lo32) atomicOr(&zw[0], lo32);
    if (hi32) atomicOr(&zw[1], hi32);
  }
  __syncthreads();
  const unsigned long long mask = zw[0] | ((unsigned long long)zw[1] << 32);
  // the first block whose rhs is nonzero; blocks from 64 on count as nonzero
  const int f = mask ? __ffsll((long long)mask) - 1 : nmask;
  auto is_zero = [&](int i) { return i < 64 && !((mask >> i) & 1ull); };
  Unit acc;
  unit_zero(acc);
  if (f == nb || lower_only) {
    // results known to be zero: all of y, or L^-1 r above block f
    for (int i = 0; i < (f == nb ? nb : f); ++i)
      if (live) unit_store4(acc, Y + i * bs, kp, r0, c0, s, tk);
    if (f == nb) return;
  }
  const int nfwd = nb - f;
  const int nsteps = nfwd + (lower_only ? 0 : nb);
  // executed step e: forward block f + e, then backward block nb-1 .. 0
  auto block_of = [&](int e) { return e < nfwd ? f + e : nb - 1 - (e - nfwd); };
  // step e's copies, issued by one thread: L_i, the coupling block and
  // the tile (a box of the rhs or of y_i, columns past kp read as zero)
  auto prefetch = [&](int e) {
    if (tid != 0) return;
    const int st = e % kTriStages, i = block_of(e);
    const float* blk1 = nullptr;        // the coupling block
    const CUtensorMap* map = nullptr;   // the tile's tensor
    int z = (int)b;
    if (e < nfwd) {
      if (i > f) blk1 = LO + (long)(i - 1) * ss;
      if (!is_zero(i)) {
        map = &rmap;
        if (rbs == 0) z = 0;
      }
    } else if (i < nb - 1) {
      blk1 = LO + (long)i * ss;
      if (i >= f) map = &ymap;
    }
    const unsigned blk_bytes = 4u * ss;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(&bar[st], blk_bytes * (blk1 ? 2 : 1) +
                              (map ? 4u * T * s : 0u));
    float* As = A0 + 2 * st * sp * sp;
    bulk_copy(As, LI + (long)i * ss, blk_bytes, &bar[st]);
    if (blk1) bulk_copy(As + sp * sp, blk1, blk_bytes, &bar[st]);
    if (map) tile_copy(X0 + st * ts, map, (int)col0, i * s, z, &bar[st]);
  };
  for (int e = 0; e < min(nsteps, kTriStages - 1); ++e) prefetch(e);
  for (int e = 0; e < nsteps; ++e) {
    const int st = e % kTriStages, i = block_of(e);
    const float* As = A0 + 2 * st * sp * sp;  // L_i, the coupling at + sp sp
    const float* Xs = X0 + st * ts;
    // the forward results that the backward chain reads back are stored by
    // now: order them before the bulk copies that read them
    if (e == nfwd - 1) asm volatile("fence.proxy.async;\n" ::: "memory");
    __syncthreads();  // step e - 1 is done with its stage and the tiles
    if (e + kTriStages - 1 < nsteps) prefetch(e + kTriStages - 1);
    mbar_wait(&bar[st], (e / kTriStages) & 1);
    if (e < nfwd) {
      // V = r_i - S'_{i-1} y_{i-1} (no coupling into block f)
      if (live) {
        unit_zero(acc);
        if (i > f) unit_mac_rows(acc, As + sp * sp, sp, U, T, r0, c0, sp, s, false);
        Unit own;
        if (is_zero(i)) unit_zero(own);
        else unit_get(own, Xs, T, r0, c0, s);
        unit_rsub(acc, own);
        unit_put(acc, V, T, r0, c0, s);
      }
      __syncthreads();
      // U = y_i = L_i^-1 V: the new chain tile, and the result
      if (live) {
        unit_zero(acc);
        unit_mac_rows(acc, As, sp, V, T, r0, c0, r0 + 4, s, true);
        unit_put(acc, U, T, r0, c0, s);
        unit_store4(acc, Y + i * bs, kp, r0, c0, s, tk);
      }
    } else {
      // V = y_i - S'_i^T w_{i+1} (y_{nb-1} is still in U)
      if (live) {
        unit_zero(acc);
        Unit own;
        if (i == nb - 1) {
          unit_get(own, U, T, r0, c0, s);
        } else {
          unit_mac(acc, As + sp * sp, sp, U, T, r0, c0, 0, s);
          if (i < f) unit_zero(own);
          else unit_get(own, Xs, T, r0, c0, s);
        }
        unit_rsub(acc, own);
        unit_put(acc, V, T, r0, c0, s);
      }
      __syncthreads();
      // U = w_i = L_i^-T V
      if (live) {
        unit_zero(acc);
        unit_mac_upper(acc, As, sp, V, T, r0, c0, s);
        unit_put(acc, U, T, r0, c0, s);
        unit_store4(acc, Y + i * bs, kp, r0, c0, s, tk);
      }
    }
  }
}

// K8: the arrow solve. Forward: independent heads y_i = L_i^-1 r_i, whose
// coupling B_i y_i gathers into the last block, y_last = L_last^-1 (r_last
// - sum B_i y_i); backward: w_last = L_last^-T y_last, then each head
// w_i = L_i^-T (y_i - B_i^T w_last). With up, rhs and solution block j of
// the rolled system are block (j + 1) % nb. Tiling, staging and the skip of
// exactly-zero tiles as in K6: a head whose rhs tile is zero has y_i = 0,
// so its two forward products are skipped and its y_i is neither written
// nor read back (with the identity as rhs, all heads but the two or three
// that meet the tile's columns). The sum of B_i y_i stays in each thread's
// registers across the heads.
__global__ void __launch_bounds__(kSolveBoundThreads)
arrow_solve_kernel(const float* __restrict__ Lo, const float* __restrict__ Li,
                   const float* __restrict__ r, float* y, int nb, int s,
                   int k, int up) {
  extern __shared__ __align__(16) float smem[];
  const SolveCtx c = solve_ctx(smem, s, k);
  const int ss = s * s;
  const long b = blockIdx.x;
  const long col0 = (long)blockIdx.y * c.T;
  const float* LO = Lo + b * (nb - 1) * ss;
  const float* LI = Li + b * nb * ss;
  const long bs = (long)s * k;
  const float* R = r + b * nb * bs + col0;
  float* Y = y + b * nb * bs + col0;
  const int nh = nb - 1;           // heads
  const int nsteps = 2 * nh + 1;   // heads forward, the last block, heads back
  const int pl = up ? 0 : nb - 1;  // (nb - 1 + 1) % nb when up
  auto place = [&](int i) { return up ? (i + 1) % nb : i; };
  unsigned long long zero = 0;     // heads whose y_i is zero (i < 64)
  auto is_zero = [&](int i) { return i < 64 && ((zero >> i) & 1ull); };
  auto prefetch = [&](int t) {
    const int st = t & 1;
    if (t < nh) {
      stage_block(c.A(st, 0), LI + (long)t * ss, s, c.sp, false, true);
      stage_block(c.A(st, 1), LO + (long)t * ss, s, c.sp, false, false);
      stage_tile(c.X(st), R + place(t) * bs, s, k, c.tk, c.T);
    } else if (t == nh) {
      // L_last^-1 both ways: for y_last and for w_last
      stage_block(c.A(st, 0), LI + (long)nh * ss, s, c.sp, false, true);
      stage_block(c.A(st, 1), LI + (long)nh * ss, s, c.sp, true, true);
      stage_tile(c.X(st), R + pl * bs, s, k, c.tk, c.T);
    } else {
      const int i = t - nb;
      stage_block(c.A(st, 0), LI + (long)i * ss, s, c.sp, true, true);
      stage_block(c.A(st, 1), LO + (long)i * ss, s, c.sp, true, false);
      if (!is_zero(i))
        stage_tile(c.X(st), Y + place(i) * bs, s, k, c.tk, c.T);
    }
    cp_async_commit();
  };
  prefetch(0);
  Unit sum, acc;  // sum: this unit of sum B_i y_i
  unit_zero(sum);
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait();
    __syncthreads();
    if (t + 1 < nsteps) prefetch(t + 1);
    const int st = t & 1;
    if (t < nh) {
      // head t forward: y = L^-1 r into U and the output, sum += B y
      // (a head beyond the mask's 64 is computed and stored whatever its
      // tile holds, so its backward step always finds y_i in Y)
      if (t < 64 && !tile_nonzero(c.X(st), s, c.tk, c.T)) {
        zero |= 1ull << t;
        continue;
      }
      if (c.live) {
        unit_zero(acc);
        unit_mac(acc, c.A(st, 0), c.sp, c.X(st), c.T, c.r0, c.c0, 0, c.kn);
        unit_put(acc, c.U, c.T, c.r0, c.c0, s);
        unit_store(acc, Y + place(t) * bs, k, c.r0, c.c0, s, c.tk);
      }
      __syncthreads();
      if (c.live)
        unit_mac(sum, c.A(st, 1), c.sp, c.U, c.T, c.r0, c.c0, 0, s);
    } else if (t == nh) {
      // V = r_last - sum; U = y_last = L^-1 V; V = w_last = L^-T U
      if (c.live) {
        unit_get(acc, c.X(st), c.T, c.r0, c.c0, s);
        unit_rsub(sum, acc);
        unit_put(sum, c.V, c.T, c.r0, c.c0, s);
      }
      __syncthreads();
      if (c.live) {
        unit_zero(acc);
        unit_mac(acc, c.A(st, 0), c.sp, c.V, c.T, c.r0, c.c0, 0, c.kn);
        unit_put(acc, c.U, c.T, c.r0, c.c0, s);
      }
      __syncthreads();
      if (c.live) {
        unit_zero(acc);
        unit_mac(acc, c.A(st, 1), c.sp, c.U, c.T, c.r0, c.c0, c.kt, s);
        unit_put(acc, c.V, c.T, c.r0, c.c0, s);
        unit_store(acc, Y + pl * bs, k, c.r0, c.c0, s, c.tk);
      }
    } else {
      // head i backward: U = y_i - B_i^T w_last, w_i = L_i^-T U
      const int i = t - nb;
      if (c.live) {
        unit_zero(acc);
        unit_mac(acc, c.A(st, 1), c.sp, c.V, c.T, c.r0, c.c0, 0, s);
        Unit own;
        if (is_zero(i)) unit_zero(own);
        else unit_get(own, c.X(st), c.T, c.r0, c.c0, s);
        unit_rsub(acc, own);
        unit_put(acc, c.U, c.T, c.r0, c.c0, s);
      }
      __syncthreads();
      if (c.live) {
        unit_zero(acc);
        unit_mac(acc, c.A(st, 0), c.sp, c.U, c.T, c.r0, c.c0, c.kt, s);
        unit_store(acc, Y + place(i) * bs, k, c.r0, c.c0, s, c.tk);
      }
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// K5: diag, off unpadded; Ld, Lo, Li with rows of round4(s) floats.
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

namespace {

template <typename Kernel>
int launch_solve(Kernel kernel, const void* Lo, const void* Li, const void* r,
                 void* y, int B, int nb, int s, int k, int flag,
                 void* stream) {
  if (B <= 0 || k <= 0) return (int)cudaGetLastError();
  const int T = solve_tile(k, s);
  const size_t smem = solve_smem_floats(s, T) * sizeof(float);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, (k + T - 1) / T);
  const int threads = solve_threads(s, T);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)Lo, (const float*)Li, (const float*)r, (float*)y, nb, s,
      k, flag);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (the library links no -lcuda); null if the driver does not offer it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of `batch` matrices of `rows` rows of kp floats (row pitch
// kp, batch pitch bstride floats, both multiples of 4) read in boxes of T
// columns by s rows; columns past kp read as zero.
bool rows_map(CUtensorMap* map, const void* base, int kp, int rows,
              int batch, long long bstride, int T, int s) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)kp, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)kp * 4, (cuuint64_t)bstride * 4};
  const cuuint32_t box[3] = {(cuuint32_t)T, (cuuint32_t)s, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<void*>(base), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// K6 on the padded layout: Lo (B, nb-1, s, sp) and Li (B, nb, s, sp) with
// sp = round4(s); r's problem b at r + b * rbs (rbs a multiple of 4, 0 to
// share one rhs), rows of kp = round4(k) floats; y (B, nb, s, kp). Every
// pointer 16-byte aligned. The rhs tiles and the forward results come back
// through two tensor maps encoded here.
extern "C" int jrlqp_tri_block_solve(const void* Lo, const void* Li,
                                     const void* r, long long rbs, void* y,
                                     int B, int nb, int s, int k,
                                     int lower_only, void* stream) {
  if (B <= 0 || k <= 0) return (int)cudaGetLastError();
  const int kp = round4(k), rows = nb * s;
  const int T = tri_solve_tile(k, s);
  CUtensorMap rmap, ymap;
  if (!rows_map(&rmap, r, kp, rows, rbs ? B : 1,
                rbs ? rbs : (long long)rows * kp, T, s) ||
      !rows_map(&ymap, y, kp, rows, B, (long long)rows * kp, T, s))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tri_solve_smem_bytes(s, T);
  cudaError_t err = set_smem(tri_solve_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, (k + T - 1) / T);
  tri_solve_kernel<<<grid, solve_threads(s, T), smem, (cudaStream_t)stream>>>(
      (const float*)Lo, (const float*)Li, (const float*)r, (long)rbs,
      (float*)y, rmap, ymap, nb, s, k, lower_only);
  return (int)cudaGetLastError();
}

extern "C" int jrlqp_block_arrow_solve(const void* Lo, const void* Li,
                                       const void* r, void* y, int B, int nb,
                                       int s, int k, int up, void* stream) {
  return launch_solve(arrow_solve_kernel, Lo, Li, r, y, B, nb, s, k, up,
                      stream);
}

// The launch configuration of the solve kernel `which` (0 K6, 1 K8) at
// block size s and k rhs columns: out[0] the tile width, out[1] the threads
// per block, out[2] the shared memory bytes per block, out[3] the resident
// blocks per SM. Returns a CUDA error code.
extern "C" int jrlqp_struct_solve_config(int which, int s, int k, int* out) {
  const int T = which == 0 ? tri_solve_tile(k, s) : solve_tile(k, s);
  const int threads = solve_threads(s, T);
  const size_t smem = which == 0 ? tri_solve_smem_bytes(s, T)
                                 : solve_smem_floats(s, T) * sizeof(float);
  int blocks = 0;
  cudaError_t err;
  if (which == 0) {
    err = set_smem(tri_solve_kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tri_solve_kernel, threads, smem);
  } else {
    err = set_smem(arrow_solve_kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, arrow_solve_kernel, threads, smem);
  }
  out[0] = T;
  out[1] = threads;
  out[2] = (int)smem;
  out[3] = blocks;
  return (int)err;
}
