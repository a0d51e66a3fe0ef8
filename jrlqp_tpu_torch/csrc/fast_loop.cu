// K11: the explicit-form engine's Goldfarb-Idnani loop, one thread block per
// problem, in f32 (jrlqp_fast_loop_f32: solve_refined and the structured IK
// path) and in f64 (jrlqp_fast_loop_f64: solve_fast in f64).
//
// It replaces the loop that the JAX package compiles into one
// lax.while_loop of fast_iteration (jrlqp_tpu/solver/fast.py:167-246):
// _run_fast (fast.py:349: solve_fast, solve_refined), solve_fast_warm
// (fast.py:911) and the structured solver's (jrlqp_tpu/structured/
// solver.py:322, :440, :506). XLA compiles that loop; there is no Pallas
// kernel behind it. Its plain version is fast_loop_plain in
// jrlqp_tpu_torch/solver/fast.py, a host loop of masked passes over the
// whole batch.
//
// Per problem, from the FastState passed in and until the problem is not
// RUNNING: the cap (it >= max_iter ends MAX_ITER_REACHED); the most violated
// inactive row of Cx - l, u - Cx, x - xl, xu - x (skipped after a partial
// step, which keeps its candidate; none violated ends SUCCESS); z = H n+ and
// r = N* n+ over the first q slots; the dual step t1 (with its slot l) and
// the primal step t2 (none ends INFEASIBLE); u stepped, x and f moved on a
// primal step; then the full step (the rank-one add of the candidate at
// slot q, H -= z z^T / delta) or the partial or dual step (the rank-one
// removal of slot l, H += n_l n_l^T / w_l with w = N* G n_l, and the slots
// after l shifted down). A problem that stops keeps x, u, H and N* and takes
// the new status and candidate, as a stopped lane of the plain version's
// masked passes does, so the per-problem sequence is the same.
//
// What bounds it: bytes. H does not fit a block's shared memory at the IK
// width (n = 387: 599 KB in f32, against 227 KB), so every iteration
// streams it from device memory: an add reads and writes H once, a removal
// reads G once and reads and writes H once. That is ~1.2-1.8 MB per
// problem-iteration at the IK width against ~0.6 MFLOP. The design keeps
// the rest small and the result a function of the problem alone:
// - x, u, status, aorder, n+ (or n_l), z, r (then w), G n_l, the scaled
//   update vector and C x live in shared memory (17 KB at n = 387, m = 36 in
//   f32), so 8 blocks fit an SM: an IK batch of 1024 is resident at once;
//   H, N* and G stay in the problem's slab of device memory;
// - the rank-one update of H streams it by rows, a warp per row, four loads
//   of each thread in flight; z = H n+ for a bound's normal +-e_i is column i
//   of H as it stands (H is symmetric only up to rounding), and r is column
//   i of the q active rows of N*; the N* update touches those q rows only
//   (rows >= q are zero, as every init leaves them and every update keeps
//   them);
// - the removal's row shift of N* runs by columns, each thread its own, so
//   a row is read before the row above it is overwritten;
// - every dot product is one warp's: the lanes stride the row and a
//   butterfly sums them; block sums and argmins go through a fixed tree;
//   the selection and t1's argmin take the first minimum (NaN first, as
//   torch.argmin does); no atomics: a problem's result depends neither on
//   the batch size nor on its place in the batch;
// - the per-problem scalars (q, it, term, skip1, the candidate, f, the
//   steps) are computed alike by every thread from the same shared values,
//   so every branch is uniform and needs no broadcast;
// - the elementwise updates round each product and sum apart (no FMA
//   contraction), as the plain version's tensors do; only the order of the
//   dot products' sums differs from it.
//
// Its on-chip instance, for f32 where a lane's H fits a thread-block
// cluster's shared memory, is fast_loop_onchip.cuh, compiled in
// fast_loop_onchip_<NC>.cu; jrlqp_fast_loop_onchip_f32 below picks the
// source compiled for n.
#include "fast_loop.cuh"
#include "fast_loop_onchip.cuh"

namespace {

// Blocks per SM that the registers must allow (__launch_bounds__): 8 of
// 256 threads at n >= 256 (32 registers a thread), 8 of 128 below (64)
constexpr int kMinBlocks = 8;

// out[row] = M[row, :] . v for rows [0, rows), a warp per row (lane 0
// writes)
template <typename T, int Warps>
__device__ void warp_rows_dot(const T* M, const T* v, T* out, int rows,
                              int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int i = warp; i < rows; i += Warps) {
    const T* Mi = M + (size_t)i * n;
    T acc = 0;
    for (int j = lane; j < n; j += 32) acc += Mi[j] * v[j];
    acc = warp_sum(acc);
    if (lane == 0) out[i] = acc;
  }
}

// M[i][j] = M[i][j] - a[i] b[j] (kAdd false) or + a[i] b[j] (true) over the
// n x n slab, a warp per row, the product rounded apart
template <typename T, int Warps, bool kAdd>
__device__ void rank_one(T* M, const T* a, const T* b, int n) {
  using A = Ar<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto upd = [&](T m, T ai, T bj) -> T {
    const T p = A::mul(ai, bj);
    return kAdd ? A::add(m, p) : A::sub(m, p);
  };
#pragma unroll 1
  for (int i = warp; i < n; i += Warps) {
    T* Mi = M + (size_t)i * n;
    const T ai = a[i];
    int j = lane;
#pragma unroll 1
    for (; j + 96 < n; j += 128) {
      const T m0 = Mi[j], m1 = Mi[j + 32], m2 = Mi[j + 64], m3 = Mi[j + 96];
      Mi[j] = upd(m0, ai, b[j]);
      Mi[j + 32] = upd(m1, ai, b[j + 32]);
      Mi[j + 64] = upd(m2, ai, b[j + 64]);
      Mi[j + 96] = upd(m3, ai, b[j + 96]);
    }
#pragma unroll 1
    for (; j < n; j += 32) Mi[j] = upd(Mi[j], ai, b[j]);
  }
}

// The state lies in the wrapper's fresh contiguous tensors and is updated
// in place: x (B, n), f (B), H and Ns (B, n, n), status (B, m + n), aorder
// (B, n), u (B, n + 1), scal (B, 6). The problem: G (B, n, n), C (B, m, n),
// l and u (B, m), xl and xu (B, n); hscale (B) is the state's init-time
// trace, read only.
template <typename T, int Threads>
__global__ void __launch_bounds__(Threads, kMinBlocks)
    fast_loop_kernel(const T* __restrict__ G_, const T* __restrict__ C_,
                     const T* __restrict__ lo_, const T* __restrict__ up_,
                     const T* __restrict__ xl_, const T* __restrict__ xu_,
                     const T* __restrict__ hscale_, T* x_, T* f_, T* H_,
                     T* Ns_, int* status_, int* aorder_, T* u_, int* scal_,
                     int n, int m, int max_iter, double big_bnd,
                     double zero_z, double dep_eps) {
  constexpr int W = Threads / 32;
  using A = Ar<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Scratch<T, W> sh_sel, sh_sum, sh_t1;
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

  const int b = blockIdx.x, tid = threadIdx.x;
  const int mt = m + n;
  const size_t nn = (size_t)n * n;
  const T* G = G_ + b * nn;
  const T* C = C_ + (size_t)b * m * n;
  const T* lo = lo_ + (size_t)b * m;
  const T* up = up_ + (size_t)b * m;
  const T* xl = xl_ + (size_t)b * n;
  const T* xu = xu_ + (size_t)b * n;
  T* H = H_ + b * nn;
  T* Ns = Ns_ + b * nn;
  // the thresholds in the state's type, as torch casts a Python float:
  // zthr = zero_z (max(hscale, 1e-30) / n), the dependence test's
  // dep_eps max(hscale, 1e-30)
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
    int idx = sc_idx, st = sc_st;

    // ---- the most violated inactive row (dense.py:80) ----
    if (do_select) {
      warp_rows_dot<T, W>(C, x, cx, m, n);
      __syncthreads();
      T bv = inf;
      int bi = INT_MAX, bs = 0;
      for (int i = tid; i < mt; i += Threads) {
        T c;
        int sti;
        if (i < m) {
          const T sl = A::sub(cx[i], lo[i]), su = A::sub(up[i], cx[i]);
          c = status[i] != INACTIVE ? inf : tmin(sl, su);
          sti = sl <= su ? LOWER : UPPER;
        } else {
          const int k = i - m;
          const T sl = A::sub(x[k], xl[k]), su = A::sub(xu[k], x[k]);
          c = status[i] != INACTIVE ? inf : tmin(sl, su);
          sti = sl <= su ? LOWER_BOUND : UPPER_BOUND;
        }
        if (before(c, i, bv, bi)) {
          bv = c;
          bi = i;
          bs = sti;
        }
      }
      block_argmin<T, W>(bv, bi, bs, sh_sel);
      idx = bi;
      st = bs;
      if (bv >= T(0)) {  // nothing violated: SUCCESS, the pass discarded
        term = SUCCESS;
        sc_idx = idx;
        sc_st = st;
        break;
      }
    }

    // ---- n+, z = H n+ and r = N* n+ over the active rows ----
    const bool bnd = st >= LOWER_BOUND;
    const T sign = (st == UPPER || st == UPPER_BOUND) ? T(-1) : T(1);
    const int bi = min(max(idx - m, 0), n - 1);
    const int ci = m > 0 ? min(max(idx, 0), m - 1) : 0;
    const int qn = min(max(q, 0), n);
    for (int j = tid; j < n; j += Threads)
      np[j] = bnd ? A::mul(sign, j == bi ? T(1) : T(0))
                  : A::mul(sign, m > 0 ? C[(size_t)ci * n + j] : T(0));
    if (bnd) {
      // the one nonzero term of each row's sum: column bi
      for (int i = tid; i < n; i += Threads)
        z[i] = A::mul(H[(size_t)i * n + bi], sign);
      for (int k = tid; k < qn; k += Threads)
        r[k] = A::mul(Ns[(size_t)k * n + bi], sign);
      __syncthreads();
    } else {
      __syncthreads();
      warp_rows_dot<T, W>(H, np, z, n, n);
      warp_rows_dot<T, W>(Ns, np, r, qn, n);
      __syncthreads();
    }

    // ---- the step lengths (fast.py:563-584) ----
    T part[4] = {0, 0, 0, 0};  // n+ . z, n+ . x, |z|^2, |n+|^2
    for (int k = tid; k < n; k += Threads) {
      part[0] += np[k] * z[k];
      part[1] += np[k] * x[k];
      part[2] += z[k] * z[k];
      part[3] += np[k] * np[k];
    }
    block_sum4<T, W>(part, sh_sum);
    const T nz = part[0], nx = part[1], zz = part[2], nn2 = part[3];
    // t1: u0_k / r_k on the removable active slots, big elsewhere, the
    // first minimum; u0 is u with slot q zeroed by a selection
    T bv = inf;
    int bl = INT_MAX, unused = 0;
    for (int k = tid; k < n; k += Threads) {
      const bool valid = k < q;
      const int stk = status[min(max(valid ? aorder[k] : 0, 0), mt - 1)];
      const bool elig =
          valid && stk != EQUALITY && stk != FIXED && r[k] > T(0);
      const T u0k = do_select && k == qc ? T(0) : u[k];
      const T tk = elig ? A::div(u0k, r[k]) : big;
      if (before(tk, k, bv, bl)) {
        bv = tk;
        bl = k;
      }
    }
    block_argmin<T, W>(bv, bl, unused, sh_t1);
    const int l = bl;
    const T t1 = tmin(bv, big);
    T bval = 0;
    if (bnd)
      bval = st == UPPER_BOUND ? xu[bi] : xl[bi];
    else if (m > 0)
      bval = st == UPPER ? up[ci] : lo[ci];
    const T t2 = zz > A::mul(zthr2, nn2)
                     ? A::div(A::sub(A::mul(sign, bval), nx),
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
    for (int k = tid; k <= n; k += Threads) {
      const T u0k = do_select && k == qc ? T(0) : u[k];
      const T rk = k < q && k < n ? r[k] : T(0);
      un[k] = A::add(A::sub(u0k, A::mul(t, rk)), k == qc ? t : T(0));
    }
    if (!dual) {
      for (int k = tid; k < n; k += Threads)
        x[k] = A::add(x[k], A::mul(t, z[k]));
      f = A::add(f, A::mul(A::mul(t, nz), A::add(A::mul(T(0.5), t), uq)));
    }

    if (full) {
      // ---- the add of the candidate at slot q (fast.py:266-288) ----
      const bool dependent = nz <= A::mul(dep, nn2);
      const T dsafe = dependent ? T(1) : nz;
      const int qa = min(max(q, 0), n - 1);
      for (int j = tid; j < n; j += Threads) s[j] = A::div(z[j], dsafe);
      __syncthreads();  // s and un complete; u and aorder no longer read
      for (int k = tid; k <= n; k += Threads) u[k] = un[k];
      rank_one<T, W, false>(H, z, s, n);
      // N* rows < q lose r_k (z / delta); row q takes z / delta
      for (int j = tid; j < n; j += Threads) {
        const T sj = s[j];
        for (int k = 0; k < qn; ++k)
          if (k != qa)
            Ns[(size_t)k * n + j] =
                A::sub(Ns[(size_t)k * n + j], A::mul(r[k], sj));
        Ns[(size_t)qa * n + j] = sj;
      }
      if (tid == 0) {
        status[min(max(idx, 0), mt - 1)] = st;
        aorder[qa] = idx;
      }
      if (dependent) term = LINEAR_DEPENDENCY_DETECTED;
      q += 1;
    } else {
      // ---- the removal of slot l (fast.py:291-323) ----
      const int q_old = q, q_new = q - 1;
      const int lc = min(max(l, 0), n - 1);
      const int rem = min(max(aorder[lc], 0), mt - 1);
      for (int j = tid; j < n; j += Threads) np[j] = Ns[(size_t)lc * n + j];
      __syncthreads();  // n_l complete
      warp_rows_dot<T, W>(G, np, v, n, n);  // v = G n_l
      __syncthreads();
      // w = N* v over the active rows (the rows below are zero)
      warp_rows_dot<T, W>(Ns, v, r, min(max(q_old, 0), n), n);
      __syncthreads();
      const T wl = lc < q_old ? r[lc] : T(0);
      const T wls = (wl > T(0) || wl < T(0)) ? wl : T(1);
      for (int j = tid; j < n; j += Threads) s[j] = A::div(np[j], wls);
      for (int k = tid; k < n; k += Threads)
        v[k] = k < q_old && k != l ? A::div(r[k], wls) : T(0);
      // u over q_old + 1 slots and aorder over q_new slots shift down from
      // l; the freed slots are cleared
      const int uz = min(max(q_old, 0), n), az = min(max(q_new, 0), n - 1);
      for (int k = tid; k <= n; k += Threads) {
        const int src = k >= l && k < q_old ? k + 1 : k;
        u[k] = k == uz ? T(0) : un[min(src, n)];
      }
      for (int k = tid; k < n; k += Threads) {
        const int src = k >= l && k < q_new ? k + 1 : k;
        aon[k] = k == az ? -1 : aorder[min(src, n - 1)];
      }
      __syncthreads();  // s, v and aon complete
      for (int k = tid; k < n; k += Threads) aorder[k] = aon[k];
      if (tid == 0) status[rem] = INACTIVE;
      rank_one<T, W, true>(H, np, s, n);
      // N*: row k of the new rows < q_new is old row src (k, or k + 1 from
      // l on) less (w_src / w_l) n_l; row q_new is cleared. Each thread
      // runs down its columns, reading a row before writing the one above
      const int rows = min(q_new, n);
      for (int j = tid; j < n; j += Threads) {
        const T nlj = np[j];
        for (int k = 0; k < rows; ++k) {
          const int src = min(k >= l ? k + 1 : k, n - 1);
          Ns[(size_t)k * n + j] =
              A::sub(Ns[(size_t)src * n + j], A::mul(v[src], nlj));
        }
        if (q_new >= 0 && q_new < n) Ns[(size_t)q_new * n + j] = T(0);
      }
      q = q_new;
    }
    it += 1;
    skip1 = full ? 0 : 1;
  }

  for (int k = tid; k < n; k += Threads) {
    x_[(size_t)b * n + k] = x[k];
    aorder_[(size_t)b * n + k] = aorder[k];
  }
  for (int k = tid; k <= n; k += Threads) u_[(size_t)b * (n + 1) + k] = u[k];
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

// 256 threads from n = 256 on (the IK width), 128 below
template <typename T, int Threads>
int launch_t(const void* G, const void* C, const void* l, const void* u,
             const void* xl, const void* xu, const void* hscale, void* x,
             void* f, void* H, void* Ns, void* status, void* aorder, void* uu,
             void* scal, int B, int n, int m, int max_iter, double big_bnd,
             double zero_z, double dep_eps, void* stream) {
  const size_t smem = smem_bytes<T>(n, m);
  cudaError_t err = cudaFuncSetAttribute(
      fast_loop_kernel<T, Threads>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    fast_loop_kernel<T, Threads><<<B, Threads, smem, (cudaStream_t)stream>>>(
        (const T*)G, (const T*)C, (const T*)l, (const T*)u, (const T*)xl,
        (const T*)xu, (const T*)hscale, (T*)x, (T*)f, (T*)H, (T*)Ns,
        (int*)status, (int*)aorder, (T*)uu, (int*)scal, n, m, max_iter,
        big_bnd, zero_z, dep_eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* G, const void* C, const void* l, const void* u,
           const void* xl, const void* xu, const void* hscale, void* x,
           void* f, void* H, void* Ns, void* status, void* aorder, void* uu,
           void* scal, int B, int n, int m, int max_iter, double big_bnd,
           double zero_z, double dep_eps, void* stream) {
  return (n >= 256 ? launch_t<T, 256> : launch_t<T, 128>)(
      G, C, l, u, xl, xu, hscale, x, f, H, Ns, status, aorder, uu, scal, B,
      n, m, max_iter, big_bnd, zero_z, dep_eps, stream);
}

// threads, dynamic shared bytes, resident blocks per SM, registers and
// local (spilled) bytes per thread of the instance that (n, m) launches
template <typename T, int Threads>
int config_t(int n, int m, int* out) {
  const size_t smem = smem_bytes<T>(n, m);
  cudaError_t err = cudaFuncSetAttribute(
      fast_loop_kernel<T, Threads>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fast_loop_kernel<T, Threads>, Threads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fast_loop_kernel<T, Threads>);
  if (err != cudaSuccess) return (int)err;
  out[0] = Threads;
  out[1] = (int)smem;
  out[2] = blocks;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return 0;
}

}  // namespace

extern "C" int jrlqp_fast_loop_f64(const void* G, const void* C,
                                   const void* l, const void* u,
                                   const void* xl, const void* xu,
                                   const void* hscale, void* x, void* f,
                                   void* H, void* Ns, void* status,
                                   void* aorder, void* uu, void* scal, int B,
                                   int n, int m, int max_iter, double big_bnd,
                                   double zero_z, double dep_eps,
                                   void* stream) {
  return launch<double>(G, C, l, u, xl, xu, hscale, x, f, H, Ns, status,
                        aorder, uu, scal, B, n, m, max_iter, big_bnd, zero_z,
                        dep_eps, stream);
}

extern "C" int jrlqp_fast_loop_f32(const void* G, const void* C,
                                   const void* l, const void* u,
                                   const void* xl, const void* xu,
                                   const void* hscale, void* x, void* f,
                                   void* H, void* Ns, void* status,
                                   void* aorder, void* uu, void* scal, int B,
                                   int n, int m, int max_iter, double big_bnd,
                                   double zero_z, double dep_eps,
                                   void* stream) {
  return launch<float>(G, C, l, u, xl, xu, hscale, x, f, H, Ns, status,
                       aorder, uu, scal, B, n, m, max_iter, big_bnd, zero_z,
                       dep_eps, stream);
}

extern "C" int jrlqp_fast_loop_config(int n, int m, int dbl, int* out) {
  if (dbl)
    return n >= 256 ? config_t<double, 256>(n, m, out)
                    : config_t<double, 128>(n, m, out);
  return n >= 256 ? config_t<float, 256>(n, m, out)
                  : config_t<float, 128>(n, m, out);
}

JRLQP_FAST_LOOP_ONCHIP_DECLARE(10)
JRLQP_FAST_LOOP_ONCHIP_DECLARE(13)
JRLQP_FAST_LOOP_ONCHIP_DECLARE(16)
JRLQP_FAST_LOOP_ONCHIP_DECLARE(20)

// the on-chip instance in f32: the streamed entry's arguments and the
// cluster size; the source compiled for n's columns a lane
extern "C" int jrlqp_fast_loop_onchip_f32(const void* G, const void* C,
                                          const void* l, const void* u,
                                          const void* xl, const void* xu,
                                          const void* hscale, void* x,
                                          void* f, void* H, void* Ns,
                                          void* status, void* aorder,
                                          void* uu, void* scal, int B, int n,
                                          int m, int cluster, int max_iter,
                                          double big_bnd, double zero_z,
                                          double dep_eps, void* stream) {
#define JRLQP_ONCHIP_NC(NC)                                                 \
  case NC:                                                                  \
    return jrlqp_fast_loop_onchip_nc##NC(G, C, l, u, xl, xu, hscale, x, f,  \
                                         H, Ns, status, aorder, uu, scal, B, \
                                         n, m, cluster, max_iter, big_bnd,   \
                                         zero_z, dep_eps, stream);
  switch (onchip_cols(n)) {
    JRLQP_ONCHIP_NC(10)
    JRLQP_ONCHIP_NC(13)
    JRLQP_ONCHIP_NC(16)
    JRLQP_ONCHIP_NC(20)
  }
#undef JRLQP_ONCHIP_NC
  return (int)cudaErrorInvalidValue;
}

extern "C" int jrlqp_fast_loop_onchip_config(int n, int m, int cluster,
                                             int* out) {
  switch (onchip_cols(n)) {
    case 10:
      return jrlqp_fast_loop_onchip_config_nc10(n, m, cluster, out);
    case 13:
      return jrlqp_fast_loop_onchip_config_nc13(n, m, cluster, out);
    case 16:
      return jrlqp_fast_loop_onchip_config_nc16(n, m, cluster, out);
    case 20:
      return jrlqp_fast_loop_onchip_config_nc20(n, m, cluster, out);
  }
  return (int)cudaErrorInvalidValue;
}
