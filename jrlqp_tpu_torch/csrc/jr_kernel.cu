// K10: the J/R engine's Goldfarb-Idnani loop, one thread block per problem,
// in f64 (jrlqp_jr_loop_f64) and in f32 (jrlqp_jr_loop_f32, the first stage
// of solve_mixed).
//
// It replaces the loop that jrlqp_tpu/solver/dense.py:392-410 (run_loop)
// compiles into one lax.while_loop, with the masked primitives of
// jrlqp_tpu/ops/linalg.py:95-141 inside it (the Householder add and the
// Givens sweep's fori_loop): an XLA loop, with no Pallas kernel behind it.
// Its plain version is jr_loop_plain in jrlqp_tpu_torch/solver/dense.py, a
// host loop of masked passes over the whole batch.
//
// Per problem, from the GIState passed in and until the problem is not
// RUNNING: the cap (it >= max_iter ends MAX_ITER_REACHED); the most violated
// inactive row of Cx - l, u - Cx, x - xl, xu - x (skipped after a removal);
// d = J^T n+, z = J2 d2 and r = R^-1 d1 over the first q slots; the dual
// step t1 (with its slot l) and the primal step t2; then the full step
// (a Householder reflector adds the constraint), the partial or dual step
// (column l of R deleted, the Givens sweep) or the stop (SUCCESS,
// INFEASIBLE), which discards the pass as the plain version's masked pass
// does. The whole state is written back. A problem that stops passes no
// further iteration, which is what a stopped lane of the plain version's
// masked passes gets, so the per-problem sequence is the same.
//
// What bounds it: each problem is a chain of ~35-90 dependent iterations
// (the headline set, n = 50, m = 100) of ~2mn + 2n^2 + 6n(n - q) + q^2 FLOPs,
// under 1% of the card's f64 rate over 1024 problems; its bytes (the
// problem and the state in, the state out) are fewer still. What is left is
// latency: the barriers between the steps of an iteration, the q dependent
// steps of the triangular solve, the two barriers of each Givens rotation,
// and the L1/L2 round trips of J, R and C^T, which stay in device memory
// (each problem's own slab). The design keeps those chains short and the
// result a function of the problem alone:
// - the state's vectors (x, u, status, aorder) and d, z, r live in shared
//   memory; J and R are updated in place in the problem's slab (at n = 128,
//   f64 J and R take 256 KB, more than a block's 227 KB);
// - the per-problem scalars (q, it, term, skip1, the candidate, f) stay in
//   registers, computed alike by every thread from the same shared values,
//   so every branch is uniform and needs no broadcast;
// - every dot product is one thread's chain in index order (C x and d by
//   columns of C^T and J, coalesced; z and J w by rows); every reduction is
//   one shuffle pass and one barrier in a fixed tree; the selection and
//   t1's argmin take the first minimum (NaN first, as torch.argmin does);
//   no atomics: a problem's result depends neither on the batch size nor on
//   its place in the batch;
// - the triangular solve runs in warp 0 by columns (LAPACK's trsv order)
//   with warp barriers only, while warps 1-3 form z; the elementwise
//   updates round each product and sum apart (no FMA contraction), as the
//   plain version does.
#include <climits>
#include <cmath>

#include "loop_common.cuh"

namespace {

using namespace jrlqp;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Scratch {
  T sum[kWarps][4];
  T av[kWarps];
  int ai[kWarps], as[kWarps];
  T tmin;
  int l;
};

// The block's first minimum, on every thread; one barrier
template <typename T>
__device__ void block_argmin(T& v, int& i, int& s, Scratch<T>& sh) {
  warp_argmin(v, i, s);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh.av[warp] = v;
    sh.ai[warp] = i;
    sh.as[warp] = s;
  }
  __syncthreads();
  v = sh.av[0];
  i = sh.ai[0];
  s = sh.as[0];
  for (int w = 1; w < kWarps; ++w)
    if (before(sh.av[w], sh.ai[w], v, i)) {
      v = sh.av[w];
      i = sh.ai[w];
      s = sh.as[w];
    }
}

// Four block sums, on every thread, in a fixed tree; one barrier
template <typename T>
__device__ void block_sum4(T (&v)[4], Scratch<T>& sh) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = warp_sum(v[k]);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
    for (int k = 0; k < 4; ++k) sh.sum[warp][k] = v[k];
  __syncthreads();
  for (int k = 0; k < 4; ++k) {
    T acc = sh.sum[0][k];
    for (int w = 1; w < kWarps; ++w) acc += sh.sum[w][k];
    v[k] = acc;
  }
}

template <typename T>
size_t smem_bytes(int n, int m) {
  const size_t b = (6 * (size_t)n + 2) * sizeof(T) + (m + 3 * (size_t)n) * 4;
  return (b + 15) / 16 * 16;
}

// The state lies in the wrapper's fresh contiguous tensors and is updated
// in place: x (B, n), f (B), J and R (B, n, n), status (B, m + n), aorder
// (B, n), u (B, n + 1), scal (B, 6). The problem: C^T (B, n, m), l and u
// (B, m), xl and xu (B, n).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    jr_loop_kernel(const T* __restrict__ Ct_, const T* __restrict__ lo_,
                   const T* __restrict__ up_, const T* __restrict__ xl_,
                   const T* __restrict__ xu_, T* x_, T* f_, T* J_, T* R_,
                   int* status_, int* aorder_, T* u_, int* scal_, int n,
                   int m, int max_iter, double big_bnd, double zero_z) {
  using A = Ar<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Scratch<T> sh;
  T* x = reinterpret_cast<T*>(smem_raw);  // n
  T* u = x + n;                           // n + 1
  T* d = u + n + 1;                       // n
  T* z = d + n;                           // n
  T* r = z + n;                           // n
  T* un = r + n;                          // n + 1: a removal's new u
  int* status = reinterpret_cast<int*>(un + n + 1);  // m + n
  int* aorder = status + m + n;                      // n
  int* aon = aorder + n;                             // n: its new aorder

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int mt = m + n;
  const size_t nn = (size_t)n * n;
  const T* Ct = Ct_ + (size_t)b * n * m;
  const T* lo = lo_ + (size_t)b * m;
  const T* up = up_ + (size_t)b * m;
  const T* xl = xl_ + (size_t)b * n;
  const T* xu = xu_ + (size_t)b * n;
  T* J = J_ + b * nn;
  T* R = R_ + b * nn;
  // the thresholds in the state's type, as torch casts a Python float
  const T big = (T)big_bnd, zz_thr = (T)zero_z, dep_thr = (T)1e-300;
  const T inf = (T)INFINITY;

  for (int k = tid; k < n; k += kThreads) {
    x[k] = x_[(size_t)b * n + k];
    aorder[k] = aorder_[(size_t)b * n + k];
  }
  for (int k = tid; k <= n; k += kThreads) u[k] = u_[(size_t)b * (n + 1) + k];
  for (int k = tid; k < mt; k += kThreads)
    status[k] = status_[(size_t)b * mt + k];
  const int* sc = scal_ + (size_t)b * kScal;
  int q = sc[kQ], it = sc[kIt], term = sc[kTerm], skip1 = sc[kSkip1];
  int sc_idx = sc[kScIdx], sc_st = sc[kScSt];
  T f = f_[b];

  while (true) {
    __syncthreads();  // the last pass's writes (or the load) are visible
    if (term == RUNNING && it >= max_iter) term = MAX_ITER_REACHED;
    if (term != RUNNING) break;
    const int qc = min(max(q, 0), n);
    const bool do_select = skip1 == 0;

    // ---- step 1: the most violated inactive row (dense.py:75-97) ----
    if (do_select) {
      T bv = inf;
      int bi = INT_MAX, bs = 0;
      for (int i = tid; i < mt; i += kThreads) {
        T c;
        int st;
        if (i < m) {
          T cx = 0;
          for (int j = 0; j < n; ++j) cx += Ct[(size_t)j * m + i] * x[j];
          const T sl = A::sub(cx, lo[i]), su = A::sub(up[i], cx);
          c = status[i] != INACTIVE ? inf : tmin(sl, su);
          st = sl <= su ? LOWER : UPPER;
        } else {
          const int k = i - m;
          const T sl = A::sub(x[k], xl[k]), su = A::sub(xu[k], x[k]);
          c = status[i] != INACTIVE ? inf : tmin(sl, su);
          st = sl <= su ? LOWER_BOUND : UPPER_BOUND;
        }
        if (before(c, i, bv, bi)) {
          bv = c;
          bi = i;
          bs = st;
        }
      }
      block_argmin(bv, bi, bs, sh);
      sc_idx = bi;
      sc_st = bs;
      // SUCCESS stops the problem with the pass discarded
      if (!(bv < 0)) {
        term = SUCCESS;
        break;
      }
    }

    // ---- step 2a: d = J^T n+, z = J2 d2, r = R^-1 d1 (dense.py:141-148)
    const bool bnd = sc_st >= LOWER_BOUND;
    const T sign = (sc_st == UPPER || sc_st == UPPER_BOUND) ? T(-1) : T(1);
    const int bi = min(max(sc_idx - m, 0), n - 1);
    const int ci = m > 0 ? min(max(sc_idx, 0), m - 1) : 0;
    auto nplus = [&](int i) -> T {
      if (bnd) return A::mul(sign, i == bi ? T(1) : T(0));
      return A::mul(sign, m > 0 ? Ct[(size_t)i * m + ci] : T(0));
    };
    for (int j = tid; j < n; j += kThreads) {
      T acc;
      if (bnd) {
        acc = A::mul(J[(size_t)bi * n + j], sign);  // the one nonzero term
      } else {
        acc = 0;
        for (int i = 0; i < n; ++i) acc += J[(size_t)i * n + j] * nplus(i);
      }
      d[j] = acc;
    }
    __syncthreads();
    if (warp == 0) {
      // r by columns: r_j = r_j / R_jj, then r_k -= r_j R_kj for k < j
      for (int k = lane; k < n; k += 32) r[k] = k < q ? d[k] : T(0);
      __syncwarp();
      for (int j = min(q, n) - 1; j >= 0; --j) {
        const T rj = A::div(r[j], R[(size_t)j * n + j]);
        __syncwarp();
        for (int k = lane; k <= j; k += 32)
          r[k] = k == j ? rj : r[k] - rj * R[(size_t)k * n + j];
        __syncwarp();
      }
      // t1's slot: u_k / r_k on the eligible slots, big elsewhere, the
      // first minimum (dense.py:151-166)
      T bv = inf;
      int bl = INT_MAX, unused = 0;
      for (int k = lane; k < n; k += 32) {
        const bool valid = k < q;
        const int stk = status[min(max(valid ? aorder[k] : 0, 0), mt - 1)];
        const bool elig =
            valid && stk != EQUALITY && stk != FIXED && r[k] > T(0);
        const T tk = elig ? A::div(u[k], r[k]) : big;
        if (before(tk, k, bv, bl)) {
          bv = tk;
          bl = k;
        }
      }
      warp_argmin(bv, bl, unused);
      if (lane == 0) {
        sh.tmin = bv;
        sh.l = bl;
      }
    } else {
      for (int i = tid - 32; i < n; i += kThreads - 32) {
        T acc = 0;
        for (int j = q; j < n; ++j) acc += J[(size_t)i * n + j] * d[j];
        z[i] = acc;
      }
    }
    __syncthreads();
    // the candidate's multiplier: zeroed by a selection, carried by a
    // partial step (read before the barrier: a full step writes slot q)
    const T uq = do_select ? T(0) : u[qc];
    // n+ . z, n+ . x, |z|^2 and |d[q:]|^2
    T part[4] = {0, 0, 0, 0};
    for (int k = tid; k < n; k += kThreads) {
      const T p = nplus(k);
      part[0] += p * z[k];
      part[1] += p * x[k];
      part[2] += z[k] * z[k];
      if (k >= q) part[3] += d[k] * d[k];
    }
    block_sum4(part, sh);
    const T nz = part[0], nx = part[1];
    const T znorm = A::sqrt(part[2]), vnorm = A::sqrt(part[3]);

    // ---- step 2b: the step lengths and the branch (dense.py:151-176,
    // :265-300) ----
    const int l = sh.l;
    const T t1 = tmin(sh.tmin, big);
    T bval = 0;
    if (bnd)
      bval = sc_st == UPPER_BOUND ? xu[bi] : xl[bi];
    else if (m > 0)
      bval = sc_st == UPPER ? up[ci] : lo[ci];
    const T t2 = znorm > zz_thr
                     ? A::div(A::sub(A::mul(sign, bval), nx),
                              nz != T(0) ? nz : T(1))
                     : big;
    const T t = tmin(t1, t2);
    const bool infeasible = t >= big;
    const bool dual = t2 >= big && !infeasible;
    const bool full = !infeasible && !dual && t2 <= t1;
    // INFEASIBLE stops the problem with the pass discarded
    if (infeasible) {
      term = INFEASIBLE;
      break;
    }
    // u - t [r; 0] with t added at slot q (_stepped_u)
    auto stepped = [&](int k) -> T {
      if (k < q) return A::sub(u[k], A::mul(t, r[k]));
      if (k == qc) return A::add(uq, t);
      return u[k];
    };
    if (!dual) {  // full and partial steps move x and f
      for (int k = tid; k < n; k += kThreads)
        x[k] = A::add(x[k], A::mul(t, z[k]));
      f = A::add(f, A::mul(A::mul(t, nz), A::add(A::mul(T(0.5), t), uq)));
    }

    if (full) {
      // ---- the Householder add (linalg.py:31-55, _apply_add) ----
      for (int k = tid; k <= n; k += kThreads) u[k] = stepped(k);
      const T dq = d[min(q, n - 1)];
      const T alpha = dq >= T(0) ? -vnorm : vnorm;
      auto w = [&](int j) -> T { return j == q ? A::sub(d[j], alpha) : d[j]; };
      T ww = 0;
      for (int j = q; j < n; ++j) ww += w(j) * w(j);
      const T beta = ww > T(0) ? A::div(T(2), ww) : T(0);
      // J <- J - beta (J w) w^T, each thread its rows
      for (int i = tid; i < n; i += kThreads) {
        T* Ji = J + (size_t)i * n;
        T jw = 0;
        for (int j = q; j < n; ++j) jw += Ji[j] * w(j);
        for (int j = q; j < n; ++j)
          Ji[j] = A::sub(Ji[j], A::mul(beta, A::mul(jw, w(j))));
      }
      // column q of R takes the reflected d; a problem with q = n keeps R
      if (q < n)
        for (int k = tid; k < n; k += kThreads)
          R[(size_t)k * n + q] = k < q ? d[k] : (k == q ? alpha : T(0));
      if (tid == 0) {
        status[sc_idx] = sc_st;
        if (q < n) aorder[q] = sc_idx;
      }
      if (vnorm <= dep_thr) term = LINEAR_DEPENDENCY_DETECTED;
      q += 1;
    } else {
      // ---- the removal of slot l (linalg.py:67-109, _apply_remove) ----
      const int q_old = q, q_new = q - 1;
      const int rem = aorder[min(max(l, 0), n - 1)];
      // the new u and aorder, formed apart and copied after the barrier:
      // u shifted over q_old + 1 slots, slot q_old zeroed; aorder shifted
      // over q_new slots, slot q_new -1
      for (int k = tid; k <= n; k += kThreads)
        un[k] = k == q_old ? T(0) : stepped(l <= k && k < q_old ? k + 1 : k);
      for (int k = tid; k < n; k += kThreads)
        aon[k] = k == q_new ? -1 : aorder[l <= k && k < q_new ? k + 1 : k];
      // column l of R deleted: columns l..q_new-1 take their right
      // neighbour, each thread its rows
      for (int i = tid; i < n; i += kThreads)
        for (int j = l; j < q_new; ++j)
          R[(size_t)i * n + j] = R[(size_t)i * n + j + 1];
      __syncthreads();
      for (int k = tid; k <= n; k += kThreads) u[k] = un[k];
      for (int k = tid; k < n; k += kThreads) aorder[k] = aon[k];
      if (tid == 0) status[min(max(rem, 0), mt - 1)] = INACTIVE;
      // the sweep: rotations of rows (i, i + 1) of R and columns (i, i + 1)
      // of J for l <= i < q_new; columns of R from q_new on become the
      // identity below, so the rotation stops there
      for (int i = l; i < q_new; ++i) {
        const T a = R[(size_t)i * n + i], bb = R[(size_t)(i + 1) * n + i];
        const T rad = A::sqrt(A::add(A::mul(a, a), A::mul(bb, bb)));
        const bool pos = rad > T(0);
        const T rs = pos ? rad : T(1);
        const T c = pos ? A::div(a, rs) : T(1);
        const T s = pos ? A::div(bb, rs) : T(0);
        __syncthreads();  // every thread has read a and b
        for (int j = i + tid; j < q_new; j += kThreads) {
          const T ri = R[(size_t)i * n + j], ri1 = R[(size_t)(i + 1) * n + j];
          R[(size_t)i * n + j] = A::add(A::mul(c, ri), A::mul(s, ri1));
          R[(size_t)(i + 1) * n + j] = A::add(A::mul(-s, ri), A::mul(c, ri1));
        }
        for (int k = tid; k < n; k += kThreads) {
          T* Jk = J + (size_t)k * n;
          const T ji = Jk[i], ji1 = Jk[i + 1];
          Jk[i] = A::add(A::mul(c, ji), A::mul(s, ji1));
          Jk[i + 1] = A::add(A::mul(-s, ji), A::mul(c, ji1));
        }
        __syncthreads();
      }
      // triu(R), and identity columns from q_new on
      for (int i = warp; i < n; i += kWarps)
        for (int j = lane; j < n; j += 32) {
          if (j >= q_new)
            R[(size_t)i * n + j] = i == j ? T(1) : T(0);
          else if (i > j)
            R[(size_t)i * n + j] = T(0);
        }
      q = q_new;
    }
    it += 1;
    skip1 = full ? 0 : 1;
  }

  for (int k = tid; k < n; k += kThreads) {
    x_[(size_t)b * n + k] = x[k];
    aorder_[(size_t)b * n + k] = aorder[k];
  }
  for (int k = tid; k <= n; k += kThreads) u_[(size_t)b * (n + 1) + k] = u[k];
  for (int k = tid; k < mt; k += kThreads)
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

template <typename T>
int launch(const void* Ct, const void* l, const void* u, const void* xl,
           const void* xu, void* x, void* f, void* J, void* R, void* status,
           void* aorder, void* uu, void* scal, int B, int n, int m,
           int max_iter, double big_bnd, double zero_z, void* stream) {
  const size_t smem = smem_bytes<T>(n, m);
  cudaError_t err = cudaFuncSetAttribute(
      jr_loop_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    jr_loop_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const T*)Ct, (const T*)l, (const T*)u, (const T*)xl, (const T*)xu,
        (T*)x, (T*)f, (T*)J, (T*)R, (int*)status, (int*)aorder, (T*)uu,
        (int*)scal, n, m, max_iter, big_bnd, zero_z);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jrlqp_jr_loop_f64(const void* Ct, const void* l, const void* u,
                                 const void* xl, const void* xu, void* x,
                                 void* f, void* J, void* R, void* status,
                                 void* aorder, void* uu, void* scal, int B,
                                 int n, int m, int max_iter, double big_bnd,
                                 double zero_z, void* stream) {
  return launch<double>(Ct, l, u, xl, xu, x, f, J, R, status, aorder, uu,
                        scal, B, n, m, max_iter, big_bnd, zero_z, stream);
}

extern "C" int jrlqp_jr_loop_f32(const void* Ct, const void* l, const void* u,
                                 const void* xl, const void* xu, void* x,
                                 void* f, void* J, void* R, void* status,
                                 void* aorder, void* uu, void* scal, int B,
                                 int n, int m, int max_iter, double big_bnd,
                                 double zero_z, void* stream) {
  return launch<float>(Ct, l, u, xl, xu, x, f, J, R, status, aorder, uu,
                       scal, B, n, m, max_iter, big_bnd, zero_z, stream);
}
