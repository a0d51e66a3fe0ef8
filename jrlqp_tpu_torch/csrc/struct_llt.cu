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
// So K5 and K7 run one problem per thread block, every working block in
// shared memory, as many problems per SM as fit (section "K5 and K7"
// below); they reuse K2's device function chol_inv_block.
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

// ---------------------------------------------------------------------------
// K5 and K7, the factorizations: one problem per thread block of
// kFactorThreads = 128 threads, in three s x sp blocks of shared memory
// (row pitch sp = round4(s), the pad columns zero for good) and, for K7,
// the lower units of its running Schur sum: 22,704 and 26,752 bytes at the
// IK shape (s = 43). So kFactorBlocks = 8 blocks fit an SM by shared memory
// and (at <= 64 registers) registers, and a batch of 1024 is resident in
// one wave on 132 SMs. What bounds them (clock64() stamps, PERF.md section
// 6): K2's step chain, about 78% of a block's cycles, then the block
// products and the loads and stores on the chain. So:
// - K2 runs through a call (factor_block), and 4 warps a block: with 8
//   warps at the 32-register bound its step loop spilled, and 8 blocks of
//   4 warps finish the IK batch 1.2x sooner than 8 of 8 (PERF.md);
// - the products run on 4-wide register units with no index division, each
//   output one fmaf chain in k ascending order (the plain product's bits):
//   a thread owns row r and columns c0 .. c0 + 3 and reads P's row r and
//   Q's four rows as float4 along k (lanes on consecutive rows: a pitch of
//   44 floats puts 8 of them on distinct banks; Q's rows are broadcast);
//   S L^-T stops each chain at k = c (no term of L^-T's zero half), and a
//   symmetric product P P^T is computed on and below the diagonal only (it
//   is bitwise symmetric) and read mirrored where it is subtracted;
// - inputs arrive by 4-byte cp.async (an unpadded s x s block starts at no
//   16-byte boundary, so bulk and tensor copies cannot take them), issued a
//   stage ahead: S_i while K2 runs, D_{i+1} before the Schur product;
// - K5's padded outputs leave by one cp.async.bulk store per block, which
//   does not hold its issuer; K7's unpadded ones by coalesced stores.
// K7's heads are independent, but a cluster of thread blocks per problem,
// one per head, is no faster at the IK batch (the same K2 work in the same
// resident blocks, and the last block waits for every head); it gains only
// on batches that leave SMs idle, so K7 runs its heads in series like K5
// (PERF.md section 6).
// ---------------------------------------------------------------------------

constexpr int kFactorThreads = 128;
constexpr int kFactorBlocks = 8;

// K2 on the factor block A and its inverse X, called rather than inlined:
// inlined, its step loop shares the registers that the bound of 8 blocks
// per SM leaves with K5's and K7's own state and spills inside the loop;
// called, it has them to itself and the caller's state is saved once per
// step around the call (K5 and K7 4-7% faster at the IK batch).
__device__ __noinline__ void factor_block(float* A, float* X, int ld, int s) {
  jrlqp::chol_inv_block(A, ld, X, ld, s);
}

#ifdef JRLQP_STAMPS
// A build with -DJRLQP_STAMPS times K5's and K7's stages by clock64(): at
// each stamp a barrier, then thread 0 adds the cycles since the last stamp
// to its stage's total in factor_stamps (read back by
// cudaMemcpyFromSymbol).
__device__ unsigned long long factor_stamps[8];
#define FACTOR_STAMP_INIT long long stamp_t = clock64()
#define FACTOR_STAMP(k)                                              \
  do {                                                               \
    __syncthreads();                                                 \
    if (threadIdx.x == 0) {                                          \
      const long long t_ = clock64();                                \
      atomicAdd(&factor_stamps[k], (unsigned long long)(t_ - stamp_t)); \
      stamp_t = t_;                                                  \
    }                                                                \
  } while (0)
#else
#define FACTOR_STAMP_INIT
#define FACTOR_STAMP(k)
#endif

// The lower units of a symmetric s x s product, (column group g, row r)
// with r >= 4 g: sum over g of s - 4 g.
__host__ __device__ inline int sym_units(int s) {
  const int G = (s + 3) / 4;
  return G * s - 2 * G * (G - 1);
}

// Bytes of shared memory of K5 (three blocks) and K7 (and its sum).
__host__ __device__ inline size_t factor_smem_bytes(int s, bool arrow) {
  return (3 * (size_t)s * round4(s) + (arrow ? 4 * (size_t)sym_units(s) : 0)) *
         sizeof(float);
}

// Start 4-byte cp.async copies of the s x s row-major block src (device
// memory) into dst (row pitch sp): consecutive threads on consecutive
// elements, row and column advanced without a division per element.
__device__ __forceinline__ void stage_rows(float* dst, int sp,
                                           const float* src, int s) {
  const int nt = blockDim.x, dr = nt / s, dc = nt % s;
  int r = (int)threadIdx.x / s, c = (int)threadIdx.x % s;
  for (int e = threadIdx.x; e < s * s; e += nt) {
    cp_async4(dst + r * sp + c, src + e);
    r += dr;
    c += dc;
    if (c >= s) {
      c -= s;
      ++r;
    }
  }
}

// The s x s block src (row pitch sp) to dst (device memory, unpadded), as
// stage_rows walks it.
__device__ __forceinline__ void store_rows(float* dst, const float* src,
                                           int sp, int s) {
  const int nt = blockDim.x, dr = nt / s, dc = nt % s;
  int r = (int)threadIdx.x / s, c = (int)threadIdx.x % s;
  for (int e = threadIdx.x; e < s * s; e += nt) {
    dst[e] = src[r * sp + c];
    r += dr;
    c += dc;
    if (c >= s) {
      c -= s;
      ++r;
    }
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The shared block src (s x sp, 16-byte aligned) to dst by one bulk copy
// of the async proxy, as one bulk group of the issuing thread. Every thread
// that wrote src runs bulk_fence() and a barrier first.
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"((unsigned)__cvta_generic_to_shared(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The issuer's bulk groups but the newest N have read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// ... and have written their destination.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

struct Four {
  float v[4];
};

// Row r of P Q^T at columns c0 .. c0 + 3 (row-major blocks of row pitch sp),
// one fmaf chain per column from 0, k ascending: with q_lower (Q lower
// triangular) column c takes k <= c, else k < s. Q's rows past s - 1 are
// read as row s - 1; their outputs are not used.
__device__ __forceinline__ Four unit_nt(const float* P, const float* Q,
                                        int sp, int s, int r, int c0,
                                        bool q_lower) {
  Four acc;
  int qo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc.v[j] = 0.0f;
    qo[j] = min(c0 + j, s - 1) * sp;
  }
  const float* p = P + r * sp;
  // whole quads of k: below c0 (lower Q) or below s rounded down
  const int kq = q_lower ? c0 : s / 4 * 4;
  for (int k = 0; k < kq; k += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 q = *reinterpret_cast<const float4*>(Q + qo[j] + k);
      acc.v[j] = fmaf(a.x, q.x, acc.v[j]);
      acc.v[j] = fmaf(a.y, q.y, acc.v[j]);
      acc.v[j] = fmaf(a.z, q.z, acc.v[j]);
      acc.v[j] = fmaf(a.w, q.w, acc.v[j]);
    }
  }
  // the last quad: column c0 + j takes k <= c0 + j (lower Q), or k < s
  const int kn = q_lower ? 4 : s - kq;
  if (kn > 0) {
    const float4 a = *reinterpret_cast<const float4*>(p + kq);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 q = *reinterpret_cast<const float4*>(Q + qo[j] + kq);
      const int n = q_lower ? j + 1 : kn;
      acc.v[j] = fmaf(a.x, q.x, acc.v[j]);
      if (n > 1) acc.v[j] = fmaf(a.y, q.y, acc.v[j]);
      if (n > 2) acc.v[j] = fmaf(a.z, q.z, acc.v[j]);
      if (n > 3) acc.v[j] = fmaf(a.w, q.w, acc.v[j]);
    }
  }
  return acc;
}

// Y = P L^-T (L^-T's zero half not multiplied) into Y (pitch sp; the pad
// columns written zero): the units (column group g, row r) over the block's
// threads, u = g s + r.
__device__ __forceinline__ void product_lower_t(float* Y, const float* P,
                                                const float* X, int sp,
                                                int s) {
  const int nt = blockDim.x, nu = sp / 4 * s;
  const int dg = nt / s, dr = nt % s;
  int g = (int)threadIdx.x / s, r = (int)threadIdx.x % s;
  for (int u = threadIdx.x; u < nu; u += nt) {
    const int c0 = 4 * g;
    const Four y = unit_nt(P, X, sp, s, r, c0, true);
    *reinterpret_cast<float4*>(Y + r * sp + c0) =
        make_float4(y.v[0], c0 + 1 < s ? y.v[1] : 0.0f,
                    c0 + 2 < s ? y.v[2] : 0.0f, c0 + 3 < s ? y.v[3] : 0.0f);
    g += dg;
    r += dr;
    if (r >= s) {
      r -= s;
      ++g;
    }
  }
}

// The lower units of a symmetric product: (column group g, row r) with
// r >= 4 g, enumerated group by group; (g, r) of the unit `rem` places on
// from the first of group g (false when past the last unit).
__device__ __forceinline__ bool sym_unit(int& g, int& r, int rem, int s) {
  while (g < (s + 3) / 4 && rem >= s - 4 * g) {
    rem -= s - 4 * g;
    ++g;
  }
  r = 4 * g + rem;
  return g < (s + 3) / 4;
}

// A[r][c] -= M[r][c] and A[c][r] -= M[r][c] for the unit's entries on and
// below the diagonal (M's row r, columns c0 ..), the diagonal once.
__device__ __forceinline__ void sub_mirrored(float* A, int sp, int s, int r,
                                            int c0, const Four& m) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + j;
    if (c <= r && c < s) {
      A[r * sp + c] = A[r * sp + c] - m.v[j];
      if (c < r) A[c * sp + r] = A[c * sp + r] - m.v[j];
    }
  }
}

// K5: L_i = chol(D_i - S'_{i-1} S'_{i-1}^T), S'_i = S_i L_i^-T and L_i^-1,
// one problem per thread block, three blocks of shared memory in turn:
// step i factors a_i in A with L_i^-1 in X while S_i lands in W; L_i and
// L_i^-1 leave by bulk stores; S'_i = W X^T is formed in A once L_i has
// been read out, and leaves; D_{i+1} lands in W and S_{i+1} in X while
// S'_i S'_i^T is formed on and below the diagonal and subtracted from
// D_{i+1} in place (the first unit of each thread held in registers until
// D_{i+1} has landed); then (A, X, W) -> (W, A, X). The outputs have rows of
// sp = round4(s) floats, the layout in which K6 copies them (their pad
// columns zero).
__global__ void __launch_bounds__(kFactorThreads, kFactorBlocks)
tri_llt_kernel(const float* __restrict__ diag, const float* __restrict__ off,
               float* __restrict__ Ld, float* __restrict__ Lo,
               float* __restrict__ Li, int nb, int s) {
  extern __shared__ __align__(16) float smem[];
  FACTOR_STAMP_INIT;
  const int ss = s * s, sp = round4(s), so = s * sp;
  const unsigned so_bytes = 4u * so;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long b = blockIdx.x;
  const float* D = diag + b * nb * ss;
  const float* S = off + b * (nb - 1) * ss;
  float* LD = Ld + b * nb * so;
  float* LO = Lo + b * (nb - 1) * so;
  float* LI = Li + b * nb * so;
  float *A = smem, *X = smem + so, *W = smem + 2 * so;
  for (int e = tid; e < 3 * so; e += nt) smem[e] = 0.0f;
  __syncthreads();
  stage_rows(A, sp, D, s);
  cp_async_commit();
  if (nb > 1) stage_rows(W, sp, S, s);
  cp_async_commit();
  cp_async_wait_group<1>();
  __syncthreads();
  FACTOR_STAMP(0);
  // this thread's first lower unit of the Schur product
  int g0 = 0, r0 = 0;
  const bool has0 = sym_unit(g0, r0, tid, s);
  for (int i = 0;; ++i) {
    factor_block(A, X, sp, s);
    FACTOR_STAMP(1);
    bulk_fence();
    __syncthreads();
    if (tid == 0) {
      bulk_store(LD + (long)i * so, A, so_bytes);
      bulk_store(LI + (long)i * so, X, so_bytes);
    }
    if (i == nb - 1) break;
    cp_async_wait_group<0>();         // S_i
    if (tid == 0) bulk_wait_read<1>();  // L_i is read out of A
    __syncthreads();
    FACTOR_STAMP(2);
    product_lower_t(A, W, X, sp, s);  // S'_i
    bulk_fence();
    __syncthreads();
    if (tid == 0) {
      bulk_store(LO + (long)i * so, A, so_bytes);
      bulk_wait_read<1>();            // L_i^-1 is read out of X
    }
    __syncthreads();
    FACTOR_STAMP(3);
    stage_rows(W, sp, D + (long)(i + 1) * ss, s);
    cp_async_commit();
    if (i + 1 < nb - 1) stage_rows(X, sp, S + (long)(i + 1) * ss, s);
    cp_async_commit();
    Four m0;
    if (has0) m0 = unit_nt(A, A, sp, s, r0, 4 * g0, false);
    cp_async_wait_group<1>();         // D_{i+1}
    __syncthreads();
    if (has0) sub_mirrored(W, sp, s, r0, 4 * g0, m0);
    for (int u = tid + nt;; u += nt) {
      int g = 0, r = 0;
      if (!sym_unit(g, r, u, s)) break;
      sub_mirrored(W, sp, s, r, 4 * g, unit_nt(A, A, sp, s, r, 4 * g, false));
    }
    FACTOR_STAMP(4);
    if (tid == 0) bulk_wait_read<0>();  // S'_i is read out of A
    __syncthreads();
    FACTOR_STAMP(5);
    float* t = A;
    A = W;
    W = X;
    X = t;
  }
  if (tid == 0) bulk_wait_all();
  FACTOR_STAMP(6);
}

// K7: chol of each head block, B_i = S_i L_i^-T, the Schur complement
// D_last - sum B_i B_i^T factored last, and every L_i^-1, one problem per
// thread block: K5's three blocks of shared memory and the running sum,
// which is symmetric, as its lower units only (4 sym_units(s) floats, 4,048
// bytes at s = 43: still 8 blocks per SM). Head i factors D_i in A with
// L_i^-1 in X while S_i lands in W; B_i = W X^T is formed in A once L_i has
// left; the next head's D (or D_last) lands in W and S_{i+1} in X while B_i
// leaves and P_i = B_i B_i^T is added to the sum unit by unit, acc =
// (((0 + P_0) + P_1) + ...), the plain order; then (A, X, W) -> (W, A, X).
// Last, D_last - acc (read mirrored) is factored in A. With up, block j of
// the rolled matrix is diag block (j + 1) % nb. The outputs are unpadded,
// the layout K8 reads, and leave by coalesced stores.
__global__ void __launch_bounds__(kFactorThreads, kFactorBlocks)
arrow_llt_kernel(const float* __restrict__ diag, const float* __restrict__ side,
                 float* __restrict__ Ld, float* __restrict__ Lo,
                 float* __restrict__ Li, int nb, int s, int up) {
  extern __shared__ __align__(16) float smem[];
  FACTOR_STAMP_INIT;
  const int ss = s * s, sp = round4(s), so = s * sp;
  const int tid = threadIdx.x, nt = blockDim.x, nh = nb - 1;
  const long b = blockIdx.x;
  const float* D = diag + b * nb * ss;
  const float* S = side + b * nh * ss;
  float* LD = Ld + b * nb * ss;
  float* LO = Lo + b * nh * ss;
  float* LI = Li + b * nb * ss;
  float *A = smem, *X = smem + so, *W = smem + 2 * so;
  float4* acc = reinterpret_cast<float4*>(smem + 3 * so);
  auto place = [&](int i) { return up ? (i + 1) % nb : i; };
  for (int e = tid; e < 3 * so + 4 * sym_units(s); e += nt) smem[e] = 0.0f;
  __syncthreads();
  stage_rows(A, sp, D + (long)place(0) * ss, s);
  cp_async_commit();
  if (nh > 0) stage_rows(W, sp, S, s);
  cp_async_commit();
  cp_async_wait_group<1>();
  __syncthreads();
  FACTOR_STAMP(0);
  for (int i = 0; i < nh; ++i) {
    factor_block(A, X, sp, s);
    FACTOR_STAMP(1);
    store_rows(LD + (long)i * ss, A, sp, s);
    store_rows(LI + (long)i * ss, X, sp, s);
    cp_async_wait_group<0>();         // S_i
    __syncthreads();
    FACTOR_STAMP(2);
    product_lower_t(A, W, X, sp, s);  // B_i
    __syncthreads();
    FACTOR_STAMP(3);
    stage_rows(W, sp, D + (long)place(i + 1) * ss, s);
    cp_async_commit();
    if (i + 1 < nh) stage_rows(X, sp, S + (long)(i + 1) * ss, s);
    cp_async_commit();
    store_rows(LO + (long)i * ss, A, sp, s);
    for (int u = tid;; u += nt) {
      int g = 0, r = 0;
      if (!sym_unit(g, r, u, s)) break;
      const Four p = unit_nt(A, A, sp, s, r, 4 * g, false);
      float4 a = acc[u];
      a.x = a.x + p.v[0];
      a.y = a.y + p.v[1];
      a.z = a.z + p.v[2];
      a.w = a.w + p.v[3];
      acc[u] = a;
    }
    cp_async_wait_group<1>();         // the next D
    __syncthreads();
    FACTOR_STAMP(4);
    float* t = A;
    A = W;
    W = X;
    X = t;
  }
  if (nh > 0)
    for (int u = tid;; u += nt) {
      int g = 0, r = 0;
      if (!sym_unit(g, r, u, s)) break;
      const float4 a = acc[u];
      sub_mirrored(A, sp, s, r, 4 * g, Four{{a.x, a.y, a.z, a.w}});
    }
  __syncthreads();
  FACTOR_STAMP(5);
  factor_block(A, X, sp, s);
  FACTOR_STAMP(1);
  store_rows(LD + (long)nh * ss, A, sp, s);
  store_rows(LI + (long)nh * ss, X, sp, s);
  FACTOR_STAMP(6);
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
  const size_t smem = factor_smem_bytes(s, false);
  cudaError_t err = set_smem(tri_llt_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    tri_llt_kernel<<<B, kFactorThreads, smem, (cudaStream_t)stream>>>(
        (const float*)diag, (const float*)off, (float*)Ld, (float*)Lo,
        (float*)Li, nb, s);
  return (int)cudaGetLastError();
}

// K7: every tensor unpadded.
extern "C" int jrlqp_block_arrow_llt(const void* diag, const void* side,
                                     void* Ld, void* Lo, void* Li, int B,
                                     int nb, int s, int up, void* stream) {
  const size_t smem = factor_smem_bytes(s, true);
  cudaError_t err = set_smem(arrow_llt_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    arrow_llt_kernel<<<B, kFactorThreads, smem, (cudaStream_t)stream>>>(
        (const float*)diag, (const float*)side, (float*)Ld, (float*)Lo,
        (float*)Li, nb, s, up);
  return (int)cudaGetLastError();
}

// The launch configuration of the factorization `which` (0 K5, 1 K7) at
// block size s: out[0] the threads per block, out[1] the shared memory
// bytes per block, out[2] the resident blocks (problems) per SM. Returns a
// CUDA error code.
extern "C" int jrlqp_struct_factor_config(int which, int s, int* out) {
  const size_t smem = factor_smem_bytes(s, which == 1);
  int blocks = 0;
  cudaError_t err;
  if (which == 0) {
    err = set_smem(tri_llt_kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tri_llt_kernel, kFactorThreads, smem);
  } else {
    err = set_smem(arrow_llt_kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, arrow_llt_kernel, kFactorThreads, smem);
  }
  out[0] = kFactorThreads;
  out[1] = (int)smem;
  out[2] = blocks;
  return (int)err;
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

#ifdef JRLQP_STAMPS
// The stamps' totals since the last reset (8 stages), then reset them.
extern "C" int jrlqp_factor_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, factor_stamps, 8 * 8);
  const unsigned long long zero[8] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(factor_stamps, zero, 8 * 8);
  return (int)err;
}
#endif
