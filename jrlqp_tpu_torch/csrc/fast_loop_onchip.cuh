// K11's on-chip instance: fast_loop_kernel_onchip, the loop of fast_loop.cu's
// head with each lane's H kept in shared memory, for f32 from n = 256 on
// where H fits a thread-block cluster of at most 8 blocks (fast_loop.cu's
// jrlqp_fast_loop_onchip_f32; ops/cuda/fast_loop.py's fast_loop_plan). It is
// compiled for NC columns a lane in fast_loop_onchip_<NC>.cu, a source each,
// so that the four build at once.
//
// What bounds it: the streamed instance moves H through device memory three
// times an add (1.8 MB at n = 387); here a lane's H is read once and written
// once, and each iteration's work is on chip, so the bound is the latency of
// its dependent phases and the shared-memory bandwidth of the pass over H.
// The design:
// - a lane runs on a cluster of c blocks of 256 threads, one an SM; block k
//   holds rows [k R, k R + R) of H (R = ceil(n / c)) from the lane's first
//   step (a lane that ends at its first selection reads none of H, cp.async
//   brings the band in) to its end, when the band goes back if the lane
//   stepped;
// - every block keeps its own copy of the vectors and scalars of the
//   streamed instance, and the bounds, and takes the same selection, sums,
//   steps and branches from the same values, so every branch is uniform
//   across the cluster; the rows of C x, z = H n+, r = N* n+, G n_l and w
//   are split over the blocks and each row's sum is stored into every
//   block's copy through distributed shared memory, then a cluster barrier;
// - an add selects the next candidate before its updates (x and the status
//   are already stepped) and forms the next pass's z and r inside them: each
//   new row of the band is dotted with the next n+ as it is written, and so
//   is each new row of N*, whose rows this block owns (k = rank + c t); an
//   add costs two cluster barriers. A removal updates N*'s columns of the
//   band and runs the streamed order;
// - N*, C and G stay in device memory; N*'s q active rows stay in L2;
// - each row's dot product is the same warp's sum in the same order (the
//   lane's terms j = lane, lane + 32, ..., each an FMA, then the xor
//   butterfly), each block sum and argmin the same 256-thread tree, each
//   update the same rounded operations: both instances return the same bits.
#pragma once

#include <cooperative_groups.h>

#include "fast_loop.cuh"

namespace {

namespace cg = cooperative_groups;

// block_sum4 and block_argmin at once; one barrier
template <typename T, int Warps>
__device__ void block_sum4_argmin(T (&v)[4], Scratch<T, Warps>& shs, T& av,
                                  int& ai, int& as, Scratch<T, Warps>& sha) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = warp_sum(v[k]);
  warp_argmin(av, ai, as);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    for (int k = 0; k < 4; ++k) shs.sum[warp][k] = v[k];
    sha.av[warp] = av;
    sha.ai[warp] = ai;
    sha.as[warp] = as;
  }
  __syncthreads();
  for (int k = 0; k < 4; ++k) {
    T acc = shs.sum[0][k];
    for (int w = 1; w < Warps; ++w) acc += shs.sum[w][k];
    v[k] = acc;
  }
  av = sha.av[0];
  ai = sha.ai[0];
  as = sha.as[0];
  for (int w = 1; w < Warps; ++w)
    if (before(sha.av[w], sha.ai[w], av, ai)) {
      av = sha.av[w];
      ai = sha.ai[w];
      as = sha.as[w];
    }
}

constexpr int kOnchipThreads = 256;
// a warp lane's columns j = lane + 32 k, k < NC, in registers; the kernel is
// compiled for NC = 10, 13, 16 and 20 (n <= 640)
constexpr int kMaxCols = 20;
constexpr int kMaxCluster = 8;

// rows of H in each block's band
__host__ __device__ inline int band_rows(int n, int c) {
  return (n + c - 1) / c;
}

// the vectors' shared bytes: the streamed instance's, then l, u, xl, xu
// and the next pass's z and r
template <typename T>
__host__ __device__ size_t onchip_vec_bytes(int n, int m) {
  return smem_bytes<T>(n, m) +
         ((2 * (size_t)m + 4 * (size_t)n) * sizeof(T) + 15) / 16 * 16;
}

// dynamic shared memory of one block: the vectors, then the band of H
template <typename T>
__host__ __device__ size_t onchip_smem_bytes(int n, int m, int c) {
  return onchip_vec_bytes<T>(n, m) + (size_t)band_rows(n, c) * n * sizeof(T);
}

// The lane's columns j = lane + 32 k of a row, clamped into the row: every
// load is safe, so all of a row's loads are in flight at once and the code
// has no branch. A term past n adds +0 x -0 = -0 to a sum, which leaves
// every sum as it is (-0 + -0 = -0, x + -0 = x); a store past n goes to
// the thread's own sink. With Ex (n > 32 (NC - 1)), every group of
// columns but the last lies in the row on every lane, and only the last
// needs the clamp.
template <int NC, bool Ex>
__device__ __forceinline__ bool in_row(int k, int n) {
  return (Ex && k < NC - 1) || (threadIdx.x & 31) + 32 * k < n;
}

template <int NC, bool Ex>
__device__ __forceinline__ int col(int k, int n) {
  const int j = (threadIdx.x & 31) + 32 * k;
  return Ex && k < NC - 1 ? j : min(j, n - 1);
}

// the lane's columns of v, v[lane + 32 k]; -0 past n for a dot product's
// vector (dot), v[n - 1] for an update's
template <typename T, int NC, bool Ex>
__device__ __forceinline__ void lane_cols(const T* v, int n, T (&r)[NC],
                                          bool dot) {
#pragma unroll
  for (int k = 0; k < NC; ++k)
    r[k] = dot && !in_row<NC, Ex>(k, n) ? T(-0.0) : v[col<NC, Ex>(k, n)];
}

// R rows' lane columns, all the loads in flight at once
template <typename T, int NC, bool Ex, int R>
__device__ __forceinline__ void load_rows(const T* const (&M)[R], int n,
                                          T (&mv)[R][NC]) {
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int r = 0; r < R; ++r) mv[r][k] = M[r][col<NC, Ex>(k, n)];
}

// the lane's terms of R rows in order, each lane's own partial sum
template <typename T, int NC, bool Ex, int R>
__device__ __forceinline__ void lane_dots(const T (&mv)[R][NC],
                                          const T (&vr)[NC], int n,
                                          T (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const bool in = in_row<NC, Ex>(k, n);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] += (in ? mv[r][k] : T(0)) * vr[k];
  }
}

// the butterfly of R partial sums at once, every lane left with the sums
template <typename T, int R>
__device__ __forceinline__ void butterfly(T (&acc)[R]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] += __shfl_xor_sync(kFull, acc[r], o);
  }
}

// acc[r] = M[r] . v over n columns, on every lane of the warp, as
// warp_rows_dot sums one row: the lane's terms in order, then the
// butterfly; R rows at once; vr from lane_cols for a dot product
template <typename T, int NC, bool Ex, int R>
__device__ __forceinline__ void dot_loaded(const T (&mv)[R][NC],
                                           const T (&vr)[NC], int n,
                                           T (&acc)[R]) {
  lane_dots<T, NC, Ex, R>(mv, vr, n, acc);
  butterfly<T, R>(acc);
}

// dot_loaded on rows M[r], loaded here
template <typename T, int NC, bool Ex, int R>
__device__ __forceinline__ void dot_rows(const T* const (&M)[R],
                                         const T (&vr)[NC], int n,
                                         T (&acc)[R]) {
  T mv[R][NC];
  load_rows<T, NC, Ex, R>(M, n, mv);
  dot_loaded<T, NC, Ex, R>(mv, vr, n, acc);
}

// cnt row sums of this block, R to a warp at a time: row(t, M, dst) gives
// the t-th row and the shared address of its sum, which lane p stores into
// block p's copy
template <typename T, int NC, bool Ex, int R, typename Row>
__device__ __forceinline__ void cluster_dots(const T (&vr)[NC], int cnt,
                                             int n, int c, Row row) {
  constexpr int W = kOnchipThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cg::cluster_group cl = cg::this_cluster();
#pragma unroll 1
  for (int t0 = warp * R; t0 < cnt; t0 += W * R) {
    const T* M[R];
    T* dst[R];
#pragma unroll
    for (int r = 0; r < R; ++r) row(min(t0 + r, cnt - 1), M[r], dst[r]);
    T acc[R];
    dot_rows<T, NC, Ex, R>(M, vr, n, acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (t0 + r < cnt && lane < c) *cl.map_shared_rank(dst[r], lane) = acc[r];
  }
}

// a warp's two new rows m0 and m1 dotted with vn (lane_cols for a dot), as
// dot_rows sums a row; lane p stores the sums into block p's dst0 and, with
// two, dst1
template <typename T, int NC, bool Ex>
__device__ __forceinline__ void store_dots(const T (&m0)[NC],
                                           const T (&m1)[NC],
                                           const T (&vn)[NC], int n, int c,
                                           T* dst0, T* dst1, bool two) {
  const int lane = threadIdx.x & 31;
  T acc0 = 0, acc1 = 0;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const bool in = in_row<NC, Ex>(k, n);
    acc0 += (in ? m0[k] : T(0)) * vn[k];
    acc1 += (in ? m1[k] : T(0)) * vn[k];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc0 += __shfl_xor_sync(kFull, acc0, o);
    acc1 += __shfl_xor_sync(kFull, acc1, o);
  }
  if (lane < c) {
    cg::cluster_group cl = cg::this_cluster();
    *cl.map_shared_rank(dst0, lane) = acc0;
    if (two) *cl.map_shared_rank(dst1, lane) = acc1;
  }
}

// The band's M[i][j] -= a[r0 + i] b[j] (kAdd false) or += (true), the
// product rounded apart, b in registers, each row read whole before it is
// written; sink is the thread's shared slot for the stores past n. A warp
// takes its rows four at a time, two by two. With vnext, also the next
// pass's z: each new row dotted with vnext (the four rows' butterflies
// together), into every block's znext.
template <typename T, int NC, bool Ex, bool kAdd>
__device__ __forceinline__ void band_pass(T* Hs, const T* a, const T* b,
                                          int r0, int nr, int n, T* sink,
                                          const T* vnext, T* znext, int c) {
  constexpr int W = kOnchipThreads / 32;
  using A = Ar<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto upd = [&](T m, T ai, T bj) -> T {
    const T p = A::mul(ai, bj);
    return kAdd ? A::add(m, p) : A::sub(m, p);
  };
  T br[NC], vn[NC];
  lane_cols<T, NC, Ex>(b, n, br, false);
  if (vnext) lane_cols<T, NC, Ex>(vnext, n, vn, true);
  cg::cluster_group cl = cg::this_cluster();
#pragma unroll 1
  for (int i0 = warp; i0 < nr; i0 += 4 * W) {  // rows i0 + W t, t < 4
    T acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int ia = i0 + 2 * p * W, ib = ia + W;
      if (ia >= nr) break;
      const bool vb = ib < nr;
      const int rb = vb ? ib : ia;  // a row past nr: ia again
      T* const M[2] = {Hs + (size_t)ia * n, Hs + (size_t)rb * n};
      const T* const Mr[2] = {M[0], M[1]};
      const T ar[2] = {a[r0 + ia], a[r0 + rb]};
      T mv[2][NC];
      load_rows<T, NC, Ex, 2>(Mr, n, mv);
#pragma unroll
      for (int k = 0; k < NC; ++k)
#pragma unroll
        for (int r = 0; r < 2; ++r) mv[r][k] = upd(mv[r][k], ar[r], br[k]);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (r == 0 || vb) {
#pragma unroll
          for (int k = 0; k < NC; ++k)
            *(in_row<NC, Ex>(k, n) ? M[r] + col<NC, Ex>(k, n) : sink) = mv[r][k];
        }
      if (vnext) {
        T pr[2];
        lane_dots<T, NC, Ex, 2>(mv, vn, n, pr);
        acc[2 * p] = pr[0];
        acc[2 * p + 1] = pr[1];
      }
    }
    if (vnext) {
      butterfly<T, 4>(acc);
      if (lane < c) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (i0 + t * W < nr)
            *cl.map_shared_rank(znext + r0 + i0 + t * W, lane) = acc[t];
      }
    }
  }
}

// An add's rows of N* that this block owns, k = rank + c t below rows: row
// qa takes s, every other row k loses r[k] s; a warp two rows at a time, in
// device memory (sink as band_pass's). With vnext, also the next pass's r:
// each new row dotted with vnext, into every block's rnext.
template <typename T, int NC, bool Ex>
__device__ __forceinline__ void ns_add_rows(T* Ns, const T* r, const T* s,
                                            int rank, int c, int rows,
                                            int qa, int n, T* sink,
                                            const T* vnext, T* rnext) {
  constexpr int W = kOnchipThreads / 32;
  using A = Ar<T>;
  const int warp = W - 1 - (threadIdx.x >> 5);  // the band's first rows: warp 0
  const int cnt = rows > rank ? (rows - rank + c - 1) / c : 0;
  T bs[NC], vn[NC];
  lane_cols<T, NC, Ex>(s, n, bs, false);
  if (vnext) lane_cols<T, NC, Ex>(vnext, n, vn, true);
  T* dst[NC];
#pragma unroll 1
  for (int t = warp; t < cnt; t += 2 * W) {
    const bool two = t + W < cnt;
    const int k0 = rank + c * t, k1 = rank + c * (two ? t + W : t);
    T* M0 = Ns + (size_t)k0 * n;
    T* M1 = Ns + (size_t)k1 * n;
    const T a0 = r[k0], a1 = r[k1];
    T m0[NC], m1[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      m0[k] = M0[col<NC, Ex>(k, n)];
      m1[k] = M1[col<NC, Ex>(k, n)];
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      m0[k] = k0 == qa ? bs[k] : A::sub(m0[k], A::mul(a0, bs[k]));
      m1[k] = k1 == qa ? bs[k] : A::sub(m1[k], A::mul(a1, bs[k]));
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      dst[k] = in_row<NC, Ex>(k, n) ? M0 + col<NC, Ex>(k, n) : sink;
      *dst[k] = m0[k];
    }
    if (two) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        dst[k] = in_row<NC, Ex>(k, n) ? M1 + col<NC, Ex>(k, n) : sink;
        *dst[k] = m1[k];
      }
    }
    if (vnext) store_dots<T, NC, Ex>(m0, m1, vn, n, c, rnext + k0, rnext + k1, two);
  }
}

// dst[k] = src[k] for k < count, from device memory into shared memory, the
// block's threads a stride each, every copy in flight at once (cp.async);
// returns when the thread's own copies have landed
template <typename T>
__device__ __forceinline__ void copy_in(T* dst, const T* src, int count) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async of 4 or 8 B");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  for (int k = threadIdx.x; k < count; k += kOnchipThreads)
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     d + (unsigned)(k * sizeof(T))),
                 "l"(src + k), "n"(sizeof(T))
                 : "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The streamed kernel's loop with H on chip (fast_loop.cu's head); the same
// arguments, one cluster of c blocks a lane, c the cluster's size, NC >=
// ceil(n / 32), Ex as col's
template <typename T, int NC, bool Ex>
__global__ void __launch_bounds__(kOnchipThreads, 1)
    fast_loop_kernel_onchip(const T* __restrict__ G_, const T* __restrict__ C_,
                            const T* __restrict__ lo_,
                            const T* __restrict__ up_,
                            const T* __restrict__ xl_,
                            const T* __restrict__ xu_,
                            const T* __restrict__ hscale_, T* x_, T* f_,
                            T* H_, T* Ns_, int* status_, int* aorder_, T* u_,
                            int* scal_, int n, int m, int max_iter,
                            double big_bnd, double zero_z, double dep_eps) {
  constexpr int Threads = kOnchipThreads, W = Threads / 32;
  using A = Ar<T>;
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Scratch<T, W> sh_sel, sh_sum, sh_t1;
  __shared__ T sh_sink[Threads];
  T* x = reinterpret_cast<T*>(smem_raw);  // n
  T* u = x + n;                           // n + 1
  T* un = u + n + 1;                      // n + 1: the stepped u
  T* np = un + n + 1;                     // n: n+ (an add), n_l (a removal)
  T* z = np + n;                          // n: H n+
  T* r = z + n;                           // n: N* n+, then w = N* G n_l
  T* v = r + n;                           // n: G n_l, then w / w_l
  T* s = v + n;                           // n: z / delta, or n_l / w_l
  T* cx = s + n;                          // m: C x
  int* status = reinterpret_cast<int*>(cx + m);  // m + n
  int* aorder = status + m + n;                  // n
  int* aon = aorder + n;                         // n: a removal's aorder
  // the bounds, read every pass: copied in once
  T* lo = reinterpret_cast<T*>(smem_raw + smem_bytes<T>(n, m));  // m
  T* up = lo + m;                                                  // m
  T* xl = up + m;                                                  // n
  T* xu = xl + n;                                                  // n
  T* z2 = xu + n;  // n: the next pass's z, made by an add's pass over H
  T* r2 = z2 + n;  // n: the next pass's r, by its pass over N*
  T* Hs = reinterpret_cast<T*>(smem_raw + onchip_vec_bytes<T>(n, m));  // band

  const int b = blockIdx.x / c, tid = threadIdx.x;
  const int r0 = min(rank * band_rows(n, c), n);
  const int r1 = min(r0 + band_rows(n, c), n), nr = r1 - r0;
  const int mt = m + n;
  const size_t nn = (size_t)n * n;
  const T* G = G_ + b * nn;
  const T* C = C_ + (size_t)b * m * n;
  T* H = H_ + b * nn;
  T* Ns = Ns_ + b * nn;
  const T big = (T)big_bnd, inf = (T)INFINITY;
  const T h0 = hscale_[b];
  const T hs = h0 < (T)1e-30 ? (T)1e-30 : h0;
  const T zthr = A::mul((T)zero_z, A::div(hs, (T)n));
  const T zthr2 = A::mul(zthr, zthr);
  const T dep = A::mul((T)dep_eps, hs);

  for (int k = tid; k < n; k += Threads) {
    x[k] = x_[(size_t)b * n + k];
    aorder[k] = aorder_[(size_t)b * n + k];
  }
  for (int k = tid; k <= n; k += Threads) u[k] = u_[(size_t)b * (n + 1) + k];
  for (int k = tid; k < mt; k += Threads)
    status[k] = status_[(size_t)b * mt + k];
  for (int k = tid; k < m; k += Threads) {
    lo[k] = lo_[(size_t)b * m + k];
    up[k] = up_[(size_t)b * m + k];
  }
  for (int k = tid; k < n; k += Threads) {
    xl[k] = xl_[(size_t)b * n + k];
    xu[k] = xu_[(size_t)b * n + k];
  }
  const int* sc = scal_ + (size_t)b * kScal;
  int q = sc[kQ], it = sc[kIt], term = sc[kTerm], skip1 = sc[kSkip1];
  int sc_idx = sc[kScIdx], sc_st = sc[kScSt];
  T f = f_[b];
  const int it0 = it;
  bool loaded = false;
  T vr[NC];
  // the candidate's normal n+ in np: its kind, sign, column and row of C
  struct Cand {
    bool bnd;
    T sign;
    int bi, ci;
  };
  auto cand = [&](int idx_, int st_) {
    Cand k;
    k.bnd = st_ >= LOWER_BOUND;
    k.sign = (st_ == UPPER || st_ == UPPER_BOUND) ? T(-1) : T(1);
    k.bi = min(max(idx_ - m, 0), n - 1);
    k.ci = m > 0 ? min(max(idx_, 0), m - 1) : 0;
    return k;
  };
  auto fill_np = [&](const Cand& k) {
    for (int j = tid; j < n; j += Threads)
      np[j] = k.bnd ? A::mul(k.sign, j == k.bi ? T(1) : T(0))
                    : A::mul(k.sign, m > 0 ? C[(size_t)k.ci * n + j] : T(0));
  };
  // this block's rows rank, rank + c, ... of C x, into every block, a warp
  // two at a time; a warp's first two rows may come loaded (pre, cpre:
  // loaded while an add's step lengths are formed)
  const int ncx = m > rank ? (m - rank + c - 1) / c : 0;
  const int lane = tid & 31, warp = tid >> 5;
  auto cx_load = [&](T (&mv)[2][NC], int t0) {
    const T* M[2];
    for (int r = 0; r < 2; ++r)
      M[r] = C + (size_t)(rank + c * min(t0 + r, ncx - 1)) * n;
    load_rows<T, NC, Ex, 2>(M, n, mv);
  };
  T cpre[2][NC];
  auto cx_rows = [&](bool pre) {
    lane_cols<T, NC, Ex>(x, n, vr, true);
#pragma unroll 1
    for (int t0 = warp * 2; t0 < ncx; t0 += W * 2) {
      T mv[2][NC];
      if (pre && t0 == warp * 2) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int k = 0; k < NC; ++k) mv[r][k] = cpre[r][k];
      } else {
        cx_load(mv, t0);
      }
      T acc[2];
      dot_loaded<T, NC, Ex, 2>(mv, vr, n, acc);
      for (int r = 0; r < 2; ++r)
        if (t0 + r < ncx && lane < c)
          *cl.map_shared_rank(cx + rank + c * (t0 + r), lane) = acc[r];
    }
  };
  // the most violated inactive row (dense.py:80) over C x and x: its
  // violation, index and status, on every thread
  auto select = [&](T& bv, int& bi, int& bs) {
    bv = inf;
    bi = INT_MAX;
    bs = 0;
    for (int i = tid; i < mt; i += Threads) {
      T c_;
      int sti;
      if (i < m) {
        const T sl = A::sub(cx[i], lo[i]), su = A::sub(up[i], cx[i]);
        c_ = status[i] != INACTIVE ? inf : tmin(sl, su);
        sti = sl <= su ? LOWER : UPPER;
      } else {
        const int k = i - m;
        const T sl = A::sub(x[k], xl[k]), su = A::sub(xu[k], x[k]);
        c_ = status[i] != INACTIVE ? inf : tmin(sl, su);
        sti = sl <= su ? LOWER_BOUND : UPPER_BOUND;
      }
      if (before(c_, i, bv, bi)) {
        bv = c_;
        bi = i;
        bs = sti;
      }
    }
    block_argmin<T, W>(bv, bi, bs, sh_sel);
  };
  // z and r of this pass, and of the next one an add makes: swapped after
  T *zc = z, *zn = z2, *rc = r, *rn = r2;
  bool ready = false;    // n+, z and r of this pass came with the last add
  int nidx = 0, nst = 0;  // the candidate the last add chose
  // every block of the cluster runs before any stores into its copies
  cl.sync();

  while (true) {
    __syncthreads();  // the last pass's writes (or the load) are visible
    if (term == RUNNING && it >= max_iter) term = MAX_ITER_REACHED;
    if (term != RUNNING) break;
    const int qc = min(max(q, 0), n);
    const bool do_select = skip1 == 0;
    int idx = ready ? nidx : sc_idx, st = ready ? nst : sc_st;
    const int qn = min(max(q, 0), n);

    if (!ready) {
      // ---- the most violated inactive row ----
      if (do_select) cx_rows(false);
      // C x whole; the last pass's rows of N* and its stores all done
      cl.sync();
      if (do_select) {
        T bv;
        select(bv, idx, st);
        if (bv >= T(0)) {  // nothing violated: SUCCESS, the pass discarded
          term = SUCCESS;
          sc_idx = idx;
          sc_st = st;
          break;
        }
      }
      if (!loaded) {  // the lane's first step: its band of H comes on chip
        copy_in(Hs, H + (size_t)r0 * n, nr * n);
        loaded = true;
      }

      // ---- n+, z = H n+ and r = N* n+ over the active rows ----
      const Cand k = cand(idx, st);
      // this block's rows of N*: rank, rank + c, ... below qn
      const int nrk = qn > rank ? (qn - rank + c - 1) / c : 0;
      fill_np(k);
      __syncthreads();  // np and the band complete
      if (k.bnd) {
        // the one nonzero term of each row's sum: column bi
        for (int i = tid; i < nr; i += Threads) {
          const T zi = A::mul(Hs[(size_t)i * n + k.bi], k.sign);
          for (int p = 0; p < c; ++p) *cl.map_shared_rank(zc + r0 + i, p) = zi;
        }
        for (int t = tid; t < nrk; t += Threads) {
          const int kk = rank + c * t;
          const T rk = A::mul(Ns[(size_t)kk * n + k.bi], k.sign);
          for (int p = 0; p < c; ++p) *cl.map_shared_rank(rc + kk, p) = rk;
        }
      } else {
        lane_cols<T, NC, Ex>(np, n, vr, true);
        cluster_dots<T, NC, Ex, 4>(vr, nr + nrk, n, c,
                               [&](int t, const T*& M, T*& dst) {
                                 if (t < nr) {
                                   M = Hs + (size_t)t * n;
                                   dst = zc + r0 + t;
                                 } else {
                                   const int kk = rank + c * (t - nr);
                                   M = Ns + (size_t)kk * n;
                                   dst = rc + kk;
                                 }
                               });
      }
      cl.sync();  // z and r whole in every block
    }
    ready = false;
    const Cand k = cand(idx, st);
    if (warp * 2 < ncx) cx_load(cpre, warp * 2);  // for an add's selection
    const T* zr = zc;
    const T* rr = rc;

    // ---- the step lengths (fast.py:563-584) ----
    T part[4] = {0, 0, 0, 0};  // n+ . z, n+ . x, |z|^2, |n+|^2
    for (int j = tid; j < n; j += Threads) {
      part[0] += np[j] * zr[j];
      part[1] += np[j] * x[j];
      part[2] += zr[j] * zr[j];
      part[3] += np[j] * np[j];
    }
    T bv = inf;
    int bl = INT_MAX, unused = 0;
    for (int j = tid; j < n; j += Threads) {
      const bool valid = j < q;
      const int stk = status[min(max(valid ? aorder[j] : 0, 0), mt - 1)];
      const bool elig =
          valid && stk != EQUALITY && stk != FIXED && rr[j] > T(0);
      const T u0k = do_select && j == qc ? T(0) : u[j];
      const T tk = elig ? A::div(u0k, rr[j]) : big;
      if (before(tk, j, bv, bl)) {
        bv = tk;
        bl = j;
      }
    }
    block_sum4_argmin<T, W>(part, sh_sum, bv, bl, unused, sh_t1);
    const T nz = part[0], nx = part[1], zz = part[2], nn2 = part[3];
    const int l = bl;
    const T t1 = tmin(bv, big);
    T bval = 0;
    if (k.bnd)
      bval = st == UPPER_BOUND ? xu[k.bi] : xl[k.bi];
    else if (m > 0)
      bval = st == UPPER ? up[k.ci] : lo[k.ci];
    const T t2 = zz > A::mul(zthr2, nn2)
                     ? A::div(A::sub(A::mul(k.sign, bval), nx),
                              nz != T(0) ? nz : T(1))
                     : big;
    const T t = tmin(t1, t2);
    const bool infeasible = t >= big;
    const bool dual = t2 >= big && !infeasible;
    const bool full = !infeasible && !dual && t2 <= t1;
    if (infeasible) {  // no step: INFEASIBLE, the pass discarded
      term = INFEASIBLE;
      sc_idx = idx;
      sc_st = st;
      break;
    }
    sc_idx = idx;
    sc_st = st;

    // ---- u stepped, x and f moved on a primal step (fast.py:586-595) ----
    const T uq = do_select ? T(0) : u[qc];
    for (int j = tid; j <= n; j += Threads) {
      const T u0k = do_select && j == qc ? T(0) : u[j];
      const T rk = j < q && j < n ? rr[j] : T(0);
      un[j] = A::add(A::sub(u0k, A::mul(t, rk)), j == qc ? t : T(0));
    }
    if (!dual) {
      for (int j = tid; j < n; j += Threads)
        x[j] = A::add(x[j], A::mul(t, zr[j]));
      f = A::add(f, A::mul(A::mul(t, nz), A::add(A::mul(T(0.5), t), uq)));
    }

    if (full) {
      // ---- the add of the candidate at slot q (fast.py:266-288) ----
      const bool dependent = nz <= A::mul(dep, nn2);
      const T dsafe = dependent ? T(1) : nz;
      const int qa = min(max(q, 0), n - 1);
      for (int j = tid; j < n; j += Threads) s[j] = A::div(zr[j], dsafe);
      __syncthreads();  // s, un and x complete; u and aorder no longer read
      for (int j = tid; j <= n; j += Threads) u[j] = un[j];
      if (tid == 0) {
        status[min(max(idx, 0), mt - 1)] = st;
        aorder[qa] = idx;
      }
      if (dependent) term = LINEAR_DEPENDENCY_DETECTED;
      q += 1;
      it += 1;
      skip1 = 0;
      // ---- the next pass's selection, before this pass's updates: its z
      // and r come out of them ----
      const bool next = term == RUNNING && it < max_iter;
      bool found = false;
      Cand kn = cand(0, 0);
      if (next) {
        cx_rows(true);
        cl.sync();  // C x whole; x and status of this pass in every block
        T nv;
        select(nv, nidx, nst);
        found = nv < T(0);
        if (found) {
          kn = cand(nidx, nst);
          fill_np(kn);  // n+ of this pass is no longer read
          __syncthreads();
        }
      }
      const bool fuse = found && !kn.bnd;
      band_pass<T, NC, Ex, false>(Hs, zr, s, r0, nr, n, sh_sink + tid,
                              fuse ? np : nullptr, zn, c);
      // N*: rows < q lose r_k (z / delta), row q takes z / delta
      ns_add_rows<T, NC, Ex>(Ns, rr, s, rank, c, min(q, n), qa, n, sh_sink + tid,
                         fuse ? np : nullptr, rn);
      if (found && kn.bnd) {
        __syncthreads();  // the band and this block's rows of N* written
        for (int i = tid; i < nr; i += Threads) {
          const T zi = A::mul(Hs[(size_t)i * n + kn.bi], kn.sign);
          for (int p = 0; p < c; ++p) *cl.map_shared_rank(zn + r0 + i, p) = zi;
        }
        const int rows = min(q, n);
        const int nrk = rows > rank ? (rows - rank + c - 1) / c : 0;
        for (int t = tid; t < nrk; t += Threads) {
          const int kk = rank + c * t;
          const T rk = A::mul(Ns[(size_t)kk * n + kn.bi], kn.sign);
          for (int p = 0; p < c; ++p) *cl.map_shared_rank(rn + kk, p) = rk;
        }
      }
      if (found) {
        cl.sync();  // the next pass's z and r whole; the rows of N* done
        ready = true;
        T* tz = zc;
        zc = zn;
        zn = tz;
        T* tr = rc;
        rc = rn;
        rn = tr;
      } else if (next) {  // nothing violated: SUCCESS, the pass discarded
        term = SUCCESS;
        sc_idx = nidx;
        sc_st = nst;
        break;
      }
    } else {
      // ---- the removal of slot l (fast.py:291-323) ----
      const int q_old = q, q_new = q - 1;
      const int lc = min(max(l, 0), n - 1);
      const int rem = min(max(aorder[lc], 0), mt - 1);
      for (int j = tid; j < n; j += Threads) np[j] = Ns[(size_t)lc * n + j];
      __syncthreads();  // n_l complete
      lane_cols<T, NC, Ex>(np, n, vr, true);
      cluster_dots<T, NC, Ex, 2>(vr, nr, n, c, [&](int t, const T*& M, T*& dst) {
        M = G + (size_t)(r0 + t) * n;
        dst = v + r0 + t;
      });
      cl.sync();  // v = G n_l whole
      // w = N* v over the active rows (the rows below are zero)
      const int qo = min(max(q_old, 0), n);
      lane_cols<T, NC, Ex>(v, n, vr, true);
      cluster_dots<T, NC, Ex, 2>(vr, qo > rank ? (qo - rank + c - 1) / c : 0, n,
                             c, [&](int t, const T*& M, T*& dst) {
                               const int kk = rank + c * t;
                               M = Ns + (size_t)kk * n;
                               dst = rc + kk;
                             });
      cl.sync();  // w whole; N* no longer read this pass
      const T wl = lc < q_old ? rr[lc] : T(0);
      const T wls = (wl > T(0) || wl < T(0)) ? wl : T(1);
      for (int j = tid; j < n; j += Threads) s[j] = A::div(np[j], wls);
      for (int j = tid; j < n; j += Threads)
        v[j] = j < q_old && j != l ? A::div(rr[j], wls) : T(0);
      const int uz = min(max(q_old, 0), n), az = min(max(q_new, 0), n - 1);
      for (int j = tid; j <= n; j += Threads) {
        const int src = j >= l && j < q_old ? j + 1 : j;
        u[j] = j == uz ? T(0) : un[min(src, n)];
      }
      for (int j = tid; j < n; j += Threads) {
        const int src = j >= l && j < q_new ? j + 1 : j;
        aon[j] = j == az ? -1 : aorder[min(src, n - 1)];
      }
      __syncthreads();  // s, v and aon complete
      for (int j = tid; j < n; j += Threads) aorder[j] = aon[j];
      if (tid == 0) status[rem] = INACTIVE;
      band_pass<T, NC, Ex, true>(Hs, np, s, r0, nr, n, sh_sink + tid, nullptr,
                             nullptr, c);
      // N*'s columns of the band, as the streamed kernel shifts them
      const int rows = min(q_new, n);
      for (int j = r0 + tid; j < r1; j += Threads) {
        const T nlj = np[j];
        for (int kk = 0; kk < rows; ++kk) {
          const int src = min(kk >= l ? kk + 1 : kk, n - 1);
          Ns[(size_t)kk * n + j] =
              A::sub(Ns[(size_t)src * n + j], A::mul(v[src], nlj));
        }
        if (q_new >= 0 && q_new < n) Ns[(size_t)q_new * n + j] = T(0);
      }
      q = q_new;
      it += 1;
      skip1 = 1;
    }
  }

  if (it != it0) {  // the lane stepped: its band goes back
    __syncthreads();
#pragma unroll 4
    for (int k = tid; k < nr * n; k += Threads)
      H[(size_t)r0 * n + k] = Hs[k];
  }
  if (rank == 0) {
    for (int k = tid; k < n; k += Threads) {
      x_[(size_t)b * n + k] = x[k];
      aorder_[(size_t)b * n + k] = aorder[k];
    }
    for (int k = tid; k <= n; k += Threads)
      u_[(size_t)b * (n + 1) + k] = u[k];
    for (int k = tid; k < mt; k += Threads)
      status_[(size_t)b * mt + k] = status[k];
    if (tid == 0) {
      f_[b] = f;
      int* so = scal_ + (size_t)b * kScal;
      so[kQ] = q;
      so[kIt] = it;
      so[kTerm] = term;
      so[kSkip1] = skip1;
      so[kScIdx] = sc_idx;
      so[kScSt] = sc_st;
    }
  }
  // no block leaves while a peer may still store into its shared memory
  cl.sync();
}

// the kernel compiled for NC columns a lane, at n
template <typename T, int NC>
auto onchip_kernel(int n) {
  return n > 32 * (NC - 1) ? fast_loop_kernel_onchip<T, NC, true>
                           : fast_loop_kernel_onchip<T, NC, false>;
}

// the on-chip instance's launch configuration: c blocks of 256 threads a
// lane, one cluster of c a lane
template <typename T>
cudaLaunchConfig_t onchip_launch(int B, int n, int m, int c,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * c);
  cfg.blockDim = dim3(kOnchipThreads);
  cfg.dynamicSmemBytes = onchip_smem_bytes<T>(n, m, c);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// a cluster of 1 to kMaxCluster blocks, n <= 32 kMaxCols; the shared-memory
// limit set for the instance
template <typename T, int NC>
cudaError_t onchip_prepare(int n, int m, int c) {
  if (c < 1 || c > kMaxCluster || n < 1 || n > 32 * NC || m < 0)
    return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(onchip_kernel<T, NC>(n),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)onchip_smem_bytes<T>(n, m, c));
}

template <typename T, int NC>
int launch_onchip(const void* G, const void* C, const void* l, const void* u,
                  const void* xl, const void* xu, const void* hscale, void* x,
                  void* f, void* H, void* Ns, void* status, void* aorder,
                  void* uu, void* scal, int B, int n, int m, int c,
                  int max_iter, double big_bnd, double zero_z, double dep_eps,
                  void* stream) {
  cudaError_t err = onchip_prepare<T, NC>(n, m, c);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        onchip_launch<T>(B, n, m, c, (cudaStream_t)stream, &attr);
    err = cudaLaunchKernelEx(
        &cfg, onchip_kernel<T, NC>(n), (const T*)G, (const T*)C, (const T*)l,
        (const T*)u, (const T*)xl, (const T*)xu, (const T*)hscale, (T*)x,
        (T*)f, (T*)H, (T*)Ns, (int*)status, (int*)aorder, (T*)uu, (int*)scal,
        n, m, max_iter, big_bnd, zero_z, dep_eps);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// threads, dynamic shared bytes a block, cluster size, clusters resident at
// once on the card, registers and local (spilled) bytes per thread of the
// on-chip instance at (n, m) in clusters of c
template <typename T, int NC>
int onchip_config_t(int n, int m, int c, int* out) {
  cudaError_t err = onchip_prepare<T, NC>(n, m, c);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = onchip_launch<T>(1, n, m, c, 0, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, onchip_kernel<T, NC>(n),
                                       &cfg);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, onchip_kernel<T, NC>(n));
  if (err != cudaSuccess) return (int)err;
  out[0] = kOnchipThreads;
  out[1] = (int)cfg.dynamicSmemBytes;
  out[2] = c;
  out[3] = clusters;
  out[4] = fa.numRegs;
  out[5] = (int)fa.localSizeBytes;
  return 0;
}

// the columns a lane the instance is compiled for at n
inline int onchip_cols(int n) {
  const int k = (n + 31) / 32;
  return k <= 10 ? 10 : k <= 13 ? 13 : k <= 16 ? 16 : kMaxCols;
}

}  // namespace

// The C entries of the instance compiled for NC columns a lane (a source
// each): the launch, with jrlqp_fast_loop_onchip_f32's arguments, and the
// configuration, with jrlqp_fast_loop_onchip_config's
#define JRLQP_FAST_LOOP_ONCHIP_PARAMS                                        \
  const void *G, const void *C, const void *l, const void *u,               \
      const void *xl, const void *xu, const void *hscale, void *x, void *f, \
      void *H, void *Ns, void *status, void *aorder, void *uu, void *scal,  \
      int B, int n, int m, int cluster, int max_iter, double big_bnd,       \
      double zero_z, double dep_eps, void *stream
#define JRLQP_FAST_LOOP_ONCHIP_DECLARE(NC)                                   \
  extern "C" int jrlqp_fast_loop_onchip_nc##NC(JRLQP_FAST_LOOP_ONCHIP_PARAMS); \
  extern "C" int jrlqp_fast_loop_onchip_config_nc##NC(int n, int m, int c,   \
                                                      int* out);
#define JRLQP_FAST_LOOP_ONCHIP_DEFINE(NC)                                    \
  extern "C" int jrlqp_fast_loop_onchip_nc##NC(                              \
      JRLQP_FAST_LOOP_ONCHIP_PARAMS) {                                       \
    return launch_onchip<float, NC>(G, C, l, u, xl, xu, hscale, x, f, H, Ns, \
                                    status, aorder, uu, scal, B, n, m,       \
                                    cluster, max_iter, big_bnd, zero_z,      \
                                    dep_eps, stream);                        \
  }                                                                          \
  extern "C" int jrlqp_fast_loop_onchip_config_nc##NC(int n, int m, int c,   \
                                                      int* out) {            \
    return onchip_config_t<float, NC>(n, m, c, out);                         \
  }
