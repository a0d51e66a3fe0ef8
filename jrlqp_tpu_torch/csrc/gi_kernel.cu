// Goldfarb-Idnani kernels in f32, one thread block per problem: the fused
// whole solve (K1), the loop from a given state (K3), the loop from a
// carried operator (K4) and K3's loop with compact slots (K9). All four run
// the same loop, gi_loop below: K1, K3 and K4 with hole-based slots, K9
// with compact ones.
//
// They replace the Pallas kernels of jrlqp_tpu/ops/pallas/gi_kernel.py,
// which share the loop _packed_iterate (:364):
//   K1 gi_fused_kernel <- _kernel_packed_fused (:674, launched by _run_fused
//      :1281). Prologue: Cholesky of the identity-padded G (block_llt.cuh,
//      K2), L^-1, H0 = L^-T L^-1, x0 = -H0 a, the non-SPD flag,
//      tr0 = trace(H0), then the ascending equality/fixed replay and
//      OVERCONSTRAINED when #eq > n.
//   K3 gi_loop_kernel <- _kernel_packed (:628, launched by run_loop_pallas,
//      pallas_call :1172). The state comes in: K0 = [H | N*^T], x, u,
//      status, aorder, statk, seven scalars and tr0. A pending candidate
//      (skip1 = 1) gets its normal rebuilt from (sc_idx, sc_status), as
//      fast.fast_iteration does (fast.py:175-183); the Pallas kernel starts
//      it at zero (:648-653), which ends such a lane INFEASIBLE.
//   K4 gi_warm_kernel <- _kernel_packed_warm (:836, launched by
//      run_warm_loop_pallas, pallas_call :1456). The carried K, status,
//      aorder, statk and the new a and signed active bounds b_act come in.
//      Prologue: tr0 = trace of the carried H, the closed form
//      x = K [-a; b_act], u = ((a + G x)^T K)[np:] on active slots, then
//      the one-at-a-time deactivation of u < -1e-5 (lowest slot on ties),
//      each a removal followed by a new closed form, counted as an
//      iteration.
//   K9 gi_compact_kernel <- _kernel (:104, the pack-1 branch of
//      run_loop_pallas, pallas_call :1215). K3's entry and loop, with
//      compact slots: slots 0..q-1 active, the candidate at slot q; a
//      removal deletes slot l and shifts N* columns np+l+1..np+q-1, aorder,
//      statk and u one slot down (u up to the candidate's slot q), where
//      the hole layout zeroes slot l's column and moves the candidate's
//      multiplier into it. The w mask is "slot < q and slot != l". The
//      shifts overlap source and destination, so each thread moves whole
//      rows of K in order, and the vectors are read into registers, a
//      barrier passes, then they are written. A pending candidate's normal
//      is rebuilt at entry as in K3; the Pallas kernel starts it at zero
//      (:336-339). Like K3 it is latency-bound: its bound is K3's
//      per-iteration work, about 1% of its time.
//   The loop: most-violated selection (skipped after a removal),
//   [z | r] = n+ K with K = [H | N*^T], step lengths, one rank-one update
//   of K per iteration (add or remove), hole-based active slots.
// The index layout is the Pallas kernels': padded sizes np = round_up(n+1,
// 8) and mp = round_up(m, 8), constraints in [0, mp), bounds in [mp, mp+np).
// Padded constraint rows and variables are never candidates, so the order
// of the real ones (constraints first, then bounds) and every
// lowest-index tie break are those of the reference.
//
// What bounds them here: each problem is a latency-bound chain of
// dependent iterations (~60-100 cold at n = 50, m = 100; a few warm), each
// doing ~n * 2n FMAs between block-wide barriers; the device's FLOP rate
// and bandwidth are far from the limit. The design keeps the whole state
// (G, C^T, K and the row vectors, ~66 KB at the headline) in shared memory
// for the entire solve, so nothing leaves the SM between iterations;
// spreads each matvec and the rank-one update over 128 threads (one column
// or element per thread); does every reduction (argmin with lowest-index
// ties, the four dot products) as one warp-shuffle pass plus one barrier;
// and keeps the per-problem scalars in registers, computed identically by
// every thread, so branches are uniform and need no broadcast. A problem
// stops on its own when its term leaves RUNNING, which gives each lane the
// result a frozen lane of the TPU's packs gets. Several problems share an
// SM (3 blocks at the headline), which hides part of the barrier latency.
#include <cuda_runtime.h>

#include "block_llt.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float BIG = 1e30f;
constexpr int kNone = 0x7fffffff;

// ActivationStatus / TerminationStatus (jrlqp_tpu_torch/types.py)
constexpr int LOWER = 1, UPPER = 2, EQUALITY = 3, LOWER_BOUND = 4,
              UPPER_BOUND = 5, FIXED = 6;
constexpr int RUNNING = -1, SUCCESS = 0, NON_POS_HESSIAN = 2, INFEASIBLE = 3,
              MAX_ITER_REACHED = 4, LINEAR_DEPENDENCY_DETECTED = 5,
              OVERCONSTRAINED_PROBLEM = 6;

// One block-wide reduction: (min, argmin) with ties to the lowest index,
// a min over a second index, and four sums.
struct Red {
  float v;
  int i, i2;
  float s0, s1, s2, s3;
};

__device__ __forceinline__ Red red_identity() {
  Red r;
  r.v = __int_as_float(0x7f800000);  // +inf
  r.i = kNone;
  r.i2 = kNone;
  r.s0 = r.s1 = r.s2 = r.s3 = 0.0f;
  return r;
}

__device__ __forceinline__ void red_min(Red& a, float v, int i) {
  if (v < a.v || (v == a.v && i < a.i)) {
    a.v = v;
    a.i = i;
  }
}

__device__ __forceinline__ void red_combine(Red& a, const Red& b) {
  red_min(a, b.v, b.i);
  a.i2 = min(a.i2, b.i2);
  a.s0 += b.s0;
  a.s1 += b.s1;
  a.s2 += b.s2;
  a.s3 += b.s3;
}

// Every thread returns the same value. `scratch` holds 2 * kWarps entries
// used alternately, so back-to-back reductions need one barrier each.
__device__ __forceinline__ Red block_reduce(Red r, Red* scratch, int& parity) {
  const unsigned full = 0xffffffffu;
  for (int o = 16; o > 0; o >>= 1) {
    Red b;
    b.v = __shfl_xor_sync(full, r.v, o);
    b.i = __shfl_xor_sync(full, r.i, o);
    b.i2 = __shfl_xor_sync(full, r.i2, o);
    b.s0 = __shfl_xor_sync(full, r.s0, o);
    b.s1 = __shfl_xor_sync(full, r.s1, o);
    b.s2 = __shfl_xor_sync(full, r.s2, o);
    b.s3 = __shfl_xor_sync(full, r.s3, o);
    red_combine(r, b);
  }
  Red* buf = scratch + parity * kWarps;
  parity ^= 1;
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = r;
  __syncthreads();
  Red out = buf[0];
  for (int w = 1; w < kWarps; ++w) red_combine(out, buf[w]);
  return out;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// a - b * c with the product rounded first (no FMA contraction), as the
// plain version's separate multiply and subtract do.
__device__ __forceinline__ float sub_mul(float a, float b, float c) {
  return __fsub_rn(a, __fmul_rn(b, c));
}

struct Smem {
  Red* red;
  float *G, *C, *K, *x, *u, *npl, *nl, *v, *w, *xlo, *xup, *zr, *lo, *up,
      *a, *bact;
  int *statk, *aorder, *status, *sts;
};

// One layout for the three kernels; `a` and `bact` are K4's alone.
__host__ __device__ inline size_t smem_layout(int np, int mp, char* base,
                                              Smem* s) {
  const int np2 = 2 * np, mtp = mp + np;
  const size_t cwords = (size_t)np * (mp > np ? mp : np);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base + off;
    off += (bytes + 15) / 16 * 16;
    return p;
  };
  Red* red = (Red*)take(2 * kWarps * sizeof(Red));
  float* G = (float*)take((size_t)np * (np + 1) * 4);
  float* C = (float*)take(cwords * 4);
  float* K = (float*)take((size_t)np * np2 * 4);
  float* x = (float*)take(np * 4);
  float* u = (float*)take(np * 4);
  float* npl = (float*)take(np * 4);
  float* nl = (float*)take(np * 4);
  float* v = (float*)take(np * 4);
  float* w = (float*)take(np * 4);
  float* xlo = (float*)take(np * 4);
  float* xup = (float*)take(np * 4);
  float* zr = (float*)take(np2 * 4);
  float* lo = (float*)take(mp * 4);
  float* up = (float*)take(mp * 4);
  float* a = (float*)take(np * 4);
  float* bact = (float*)take(np * 4);
  int* statk = (int*)take(np * 4);
  int* aorder = (int*)take(np * 4);
  int* status = (int*)take(mtp * 4);
  int* sts = (int*)take(mtp * 4);
  if (s) *s = Smem{red, G, C, K, x, u, npl, nl, v, w, xlo, xup, zr, lo, up,
                   a, bact, statk, aorder, status, sts};
  return off;
}

// The loop's per-problem scalars, in registers, equal in every thread.
struct Scal {
  int q, it, term, skip1, sc_idx, sc_st, sc_slot;
};

// G (row stride np + 1), C^T and the four bound rows of problem b.
__device__ __forceinline__ void load_problem(
    const Smem& S, long b, const float* G_in, const float* Ct_in,
    const float* l_in, const float* u_in, const float* xl_in,
    const float* xu_in, int np, int mp) {
  const int tid = threadIdx.x, nt = blockDim.x, ldg = np + 1;
  const float* Gb = G_in + b * np * np;
  const float* Cb = Ct_in + b * np * mp;
  for (int e = tid; e < np * np; e += nt) S.G[(e / np) * ldg + e % np] = Gb[e];
  for (int e = tid; e < np * mp; e += nt) S.C[e] = Cb[e];
  for (int i = tid; i < mp; i += nt) {
    S.lo[i] = l_in[b * mp + i];
    S.up[i] = u_in[b * mp + i];
  }
  for (int k = tid; k < np; k += nt) {
    S.xlo[k] = xl_in[b * np + k];
    S.xup[k] = xu_in[b * np + k];
  }
}

// n+ = sign (e_j | C[sc_idx]) of the candidate (sc_idx, sc_st) into npl.
__device__ __forceinline__ void candidate_normal(const Smem& S, int sc_idx,
                                                 int sc_st, int np, int mp) {
  const float sgn = (sc_st == UPPER || sc_st == UPPER_BOUND) ? -1.0f : 1.0f;
  const bool bnd = sc_st >= LOWER_BOUND;
  const int cidx = clampi(sc_idx, 0, mp - 1);
  for (int k = threadIdx.x; k < np; k += blockDim.x)
    S.npl[k] = sgn * (bnd ? (k == sc_idx - mp ? 1.0f : 0.0f)
                          : S.C[k * mp + cidx]);
}

// Removal of active slot lpos, hole-based: n_l* = K[:, np + lpos],
// v = G n_l*, w = N* v, K -= n_l* [-n_l* | w_masked]^T / w_l, the slot's
// N* column := 0, then the slot's status, aorder and statk cleared. The
// loop's remove step and K4's deactivations both run it. Returns after the
// barrier that publishes K, with the bookkeeping written by thread 0 and
// not yet published.
// The removal's vectors for active slot lpos: n_l* = K[:, np + lpos] into
// nl, v = G n_l*, w = N* v. Returns w_l made safe (1 where it is 0), after
// the barrier that publishes w.
__device__ __forceinline__ float removal_vectors(const Smem& S, int lpos,
                                                 int np) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int np2 = 2 * np, ldg = np + 1;
  const float* K = S.K;
  for (int i = tid; i < np; i += nt) S.nl[i] = K[i * np2 + np + lpos];
  __syncthreads();
  for (int i = tid; i < np; i += nt) {
    float acc = 0.0f;
    for (int j = 0; j < np; ++j) acc += S.G[i * ldg + j] * S.nl[j];
    S.v[i] = acc;
  }
  __syncthreads();
  for (int k = tid; k < np; k += nt) {
    float acc = 0.0f;
    for (int i = 0; i < np; ++i) acc += S.v[i] * K[i * np2 + np + k];
    S.w[k] = acc;
  }
  __syncthreads();
  const float wl = S.w[lpos];
  return fabsf(wl) > 0.0f ? wl : 1.0f;
}

__device__ __forceinline__ void remove_slot(const Smem& S, int lpos, int np,
                                            int mtp) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int np2 = 2 * np;
  float* K = S.K;
  const float wl_safe = removal_vectors(S, lpos, np);
  for (int e = tid; e < np * np2; e += nt) {
    const int i = e / np2, j = e % np2;
    if (j == np + lpos) {
      K[e] = 0.0f;
    } else {
      const int k = j - np;
      const float vj =
          j < np ? -S.nl[j]
                 : ((S.statk[k] != 0 && k != lpos) ? S.w[k] : 0.0f);
      K[e] = sub_mul(K[e], S.nl[i], __fdiv_rn(vj, wl_safe));
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int rem_idx = clampi(S.aorder[lpos], 0, mtp - 1);
    S.status[rem_idx] = 0;
    S.aorder[lpos] = -1;
    S.statk[lpos] = 0;
  }
}

// K9's removal of active slot lpos with compact slots (_kernel :276-318):
// the rank-one update K -= n_l* [-n_l* | w_masked]^T / w_l with w masked to
// slots < q other than lpos (slot lpos's column is left as it is), the step
// u -= t r (t added at the candidate's slot q) and x += t z unless
// dual_step, then the deletion of slot lpos: N* columns np+lpos.. take their
// right neighbour below np+q-1 and are zeroed from there, aorder and statk
// likewise (-1 and 0), u takes its right neighbour below q and is zeroed
// from q, and the removed constraint's status is cleared. The caller's
// closing barrier publishes the result.
__device__ __forceinline__ void compact_remove(const Smem& S, int lpos, int q,
                                               float t, bool dual_step,
                                               int np, int mtp) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int np2 = 2 * np;
  float* K = S.K;
  const int rem_idx = clampi(S.aorder[lpos], 0, mtp - 1);
  const float wl_safe = removal_vectors(S, lpos, np);
  for (int e = tid; e < np * np2; e += nt) {
    const int i = e / np2, j = e % np2;
    const int k = j - np;
    const float vj =
        j < np ? -S.nl[j] : ((k < q && k != lpos) ? S.w[k] : 0.0f);
    K[e] = sub_mul(K[e], S.nl[i], __fdiv_rn(vj, wl_safe));
  }
  for (int k = tid; k < np; k += nt) {
    float uk = sub_mul(S.u[k], t, S.zr[np + k]);
    if (k == q) uk = __fadd_rn(uk, t);
    S.u[k] = uk;
    if (!dual_step) S.x[k] = __fadd_rn(S.x[k], __fmul_rn(t, S.zr[k]));
  }
  __syncthreads();
  // N* columns: each thread shifts whole rows, in order, so no element is
  // read after another thread has overwritten it
  for (int i = tid; i < np; i += nt) {
    float* row = K + i * np2 + np;
    for (int k = lpos; k < np; ++k) row[k] = k < q - 1 ? row[k + 1] : 0.0f;
  }
  // the slot vectors: read into registers, barrier, write
  for (int base = 0; base < np; base += nt) {
    const int k = base + tid;
    float uk = 0.0f;
    int ak = -1, sk = 0;
    if (k < np) {
      const int src = k >= lpos ? k + 1 : k;
      if (k < q) uk = S.u[src];
      if (k < q - 1) {
        ak = S.aorder[src];
        sk = S.statk[src];
      }
    }
    __syncthreads();
    if (k < np) {
      S.u[k] = uk;
      S.aorder[k] = ak;
      S.statk[k] = sk;
    }
  }
  if (tid == 0) S.status[rem_idx] = 0;
}

// The GI loop (_packed_iterate) on the state in shared memory, until the
// problem leaves RUNNING or has run max_iter iterations; RUNNING then
// becomes MAX_ITER_REACHED. Enters and returns with the state published.
// tr0 sets the dependence and zero-z thresholds. kCompact selects K9's
// compact slots (the candidate's slot is q, the active mask slot < q, the
// compact removal); K1, K3 and K4 take the hole-based version.
template <bool kCompact>
__device__ __forceinline__ void gi_loop(const Smem& S, int n, int m, int np,
                                        int mp, int max_iter, float tr0,
                                        Scal& sc, int& parity) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int np2 = 2 * np, mtp = mp + np;
  const float* C = S.C;
  float* K = S.K;
  const float dep_thr = __fmul_rn(2e-7f, tr0);
  const float inv_n = (float)(1.0 / (double)n);
  const float zs = __fmul_rn(__fmul_rn(1e-6f, tr0), inv_n);
  int q = sc.q, it = sc.it, term = sc.term, skip1 = sc.skip1;
  int sc_idx = sc.sc_idx, sc_st = sc.sc_st, sc_slot = sc.sc_slot;
  while (term == RUNNING && it < max_iter) {
    bool success = false;
    if (skip1 == 0) {
      // step 1: most-violated inactive constraint or bound
      Red r = red_identity();
      for (int idx = tid; idx < mtp; idx += nt) {
        float val;
        int st;
        if (idx < mp) {
          float cx = 0.0f;
          for (int k = 0; k < np; ++k) cx += C[k * mp + idx] * S.x[k];
          const float sl = __fsub_rn(cx, S.lo[idx]);
          const float su = __fsub_rn(S.up[idx], cx);
          val = (S.status[idx] != 0 || idx >= m) ? BIG : fminf(sl, su);
          st = sl <= su ? LOWER : UPPER;
        } else {
          const int j = idx - mp;
          const float sl = __fsub_rn(S.x[j], S.xlo[j]);
          const float su = __fsub_rn(S.xup[j], S.x[j]);
          val = (S.status[idx] != 0 || j >= n) ? BIG : fminf(sl, su);
          st = sl <= su ? LOWER_BOUND : UPPER_BOUND;
        }
        S.sts[idx] = st;
        red_min(r, val, idx);
      }
      // the candidate's slot: the first free one, pinned while it lives
      if (!kCompact)
        for (int k = tid; k < np; k += nt)
          if (S.statk[k] == 0) r.i2 = min(r.i2, k);
      r = block_reduce(r, S.red, parity);
      success = r.v >= 0.0f;
      sc_idx = r.i;
      sc_st = S.sts[r.i];
      sc_slot = r.i2 == kNone ? 0 : r.i2;
      candidate_normal(S, sc_idx, sc_st, np, mp);
      __syncthreads();
    }
    const float sign = (sc_st == UPPER || sc_st == UPPER_BOUND) ? -1.0f : 1.0f;
    const bool is_bnd = sc_st >= LOWER_BOUND;
    const int slot = kCompact ? q : sc_slot;  // the candidate's slot

    // directions [z | r] = n+ K; r kept on active slots only (r_head)
    for (int j = tid; j < np2; j += nt) {
      float acc = 0.0f;
      for (int k = 0; k < np; ++k) acc += S.npl[k] * K[k * np2 + j];
      S.zr[j] = (j >= np && (kCompact ? j - np >= q : S.statk[j - np] == 0))
                    ? 0.0f
                    : acc;
    }
    __syncthreads();

    // step lengths: t1 over eligible slots, and the four dot products
    Red s = red_identity();
    for (int k = tid; k < np; k += nt) {
      const float r = S.zr[np + k];
      const int sk = S.statk[k];
      const bool act = kCompact ? k < q : sk != 0;
      const bool elig =
          act && sk != EQUALITY && sk != FIXED && r > 0.0f;
      red_min(s, elig ? __fdiv_rn(S.u[k], r) : BIG, k);
      const float z = S.zr[k], p = S.npl[k];
      s.s0 += z * z;
      s.s1 += p * z;
      s.s2 += p * S.x[k];
      s.s3 += p * p;
    }
    s = block_reduce(s, S.red, parity);
    const float t1 = fminf(s.v, BIG);
    const int lpos = clampi(s.i, 0, np - 1);
    const float znorm2 = s.s0, nz = s.s1, nx = s.s2, nn = s.s3;
    float bsel;
    if (is_bnd) {
      const int bidx = clampi(sc_idx - mp, 0, np - 1);
      bsel = sc_st == UPPER_BOUND ? S.xup[bidx] : S.xlo[bidx];
    } else {
      const int cidx = clampi(sc_idx, 0, mp - 1);
      bsel = sc_st == UPPER ? S.up[cidx] : S.lo[cidx];
    }
    const float nz_safe = nz != 0.0f ? nz : 1.0f;
    const float t2 = znorm2 > __fmul_rn(__fmul_rn(zs, zs), nn)
                         ? __fdiv_rn(__fsub_rn(sign * bsel, nx), nz_safe)
                         : BIG;
    const float t = fminf(t1, t2);
    const bool infeasible = (t >= BIG) && !success;
    const bool dual_step = (t2 >= BIG) && !infeasible;
    const bool full_step = !infeasible && !dual_step && (t2 <= t1);
    if (success || infeasible) {
      term = success ? SUCCESS : INFEASIBLE;
      break;
    }

    if (full_step) {
      // add: K -= z [z | r_head]^T / delta; slot column := z / delta
      const bool dependent = nz <= __fmul_rn(dep_thr, nn);
      const float dsafe = dependent ? 1.0f : nz;
      for (int k = tid; k < np; k += nt) {
        float uk = sub_mul(S.u[k], t, S.zr[np + k]);
        if (k == slot) uk = __fadd_rn(uk, t);
        S.u[k] = uk;
        S.x[k] = __fadd_rn(S.x[k], __fmul_rn(t, S.zr[k]));
      }
      for (int e = tid; e < np * np2; e += nt) {
        const int i = e / np2, j = e % np2;
        K[e] = (j == np + slot)
                   ? __fdiv_rn(S.zr[i], dsafe)
                   : sub_mul(K[e], S.zr[i], __fdiv_rn(S.zr[j], dsafe));
      }
      __syncthreads();
      if (tid == 0) {
        S.status[sc_idx] = sc_st;
        S.aorder[slot] = sc_idx;
        S.statk[slot] = sc_st;
      }
      ++q;
      if (dependent) term = LINEAR_DEPENDENCY_DETECTED;
      skip1 = 0;
    } else if (kCompact) {
      compact_remove(S, lpos, q, t, dual_step, np, mtp);
      --q;
      skip1 = 1;
    } else {
      // remove slot lpos; the pending candidate's multiplier moves into it
      const float cand_val = __fadd_rn(
          sub_mul(S.u[sc_slot], t, S.zr[np + sc_slot]), t);
      remove_slot(S, lpos, np, mtp);
      for (int k = tid; k < np; k += nt) {
        float uk = sub_mul(S.u[k], t, S.zr[np + k]);
        if (k == sc_slot) uk = __fadd_rn(uk, t);
        S.u[k] = (k == lpos) ? cand_val : (k == sc_slot ? 0.0f : uk);
        if (!dual_step) S.x[k] = __fadd_rn(S.x[k], __fmul_rn(t, S.zr[k]));
      }
      --q;
      skip1 = 1;
      sc_slot = lpos;
    }
    ++it;
    __syncthreads();
  }
  if (term == RUNNING) term = MAX_ITER_REACHED;
  sc = Scal{q, it, term, skip1, sc_idx, sc_st, kCompact ? 0 : sc_slot};
  __syncthreads();
}

__device__ __forceinline__ void write_out(
    const Smem& S, long b, int np, int mp, const Scal& sc, float hscale,
    float* x_out, float* u_out, int* status_out, int* aorder_out,
    int* scal_out, float* K_out, float* hscale_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int np2 = 2 * np, mtp = mp + np;
  for (int k = tid; k < np; k += nt) {
    x_out[b * np + k] = S.x[k];
    u_out[b * np + k] = S.u[k];
    aorder_out[b * np + k] = S.aorder[k];
  }
  for (int i = tid; i < mtp; i += nt) status_out[b * mtp + i] = S.status[i];
  for (int e = tid; e < np * np2; e += nt) K_out[b * np * np2 + e] = S.K[e];
  if (tid == 0) {
    int* o = scal_out + b * 8;
    o[0] = sc.q;
    o[1] = sc.it;
    o[2] = sc.term;
    o[3] = sc.skip1;
    o[4] = sc.sc_idx;
    o[5] = sc.sc_st;
    o[6] = sc.sc_slot;
    o[7] = 0;
    hscale_out[b] = hscale;
  }
}

// K4's closed form through the carried operator: x = K [-a; b_act],
// u = ((a + G x)^T K)[np:] on active slots, 0 elsewhere (v is scratch).
// Returns with x and u published.
__device__ __forceinline__ void closed_form(const Smem& S, int np) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int np2 = 2 * np, ldg = np + 1;
  const float* K = S.K;
  for (int i = tid; i < np; i += nt) {
    float acc = 0.0f;
    for (int j = 0; j < np; ++j) acc += K[i * np2 + j] * -S.a[j];
    for (int j = 0; j < np; ++j) acc += K[i * np2 + np + j] * S.bact[j];
    S.x[i] = acc;
  }
  __syncthreads();
  for (int i = tid; i < np; i += nt) {
    float acc = 0.0f;
    for (int j = 0; j < np; ++j) acc += S.G[i * ldg + j] * S.x[j];
    S.v[i] = S.a[i] + acc;
  }
  __syncthreads();
  for (int k = tid; k < np; k += nt) {
    float acc = 0.0f;
    for (int i = 0; i < np; ++i) acc += S.v[i] * K[i * np2 + np + k];
    S.u[k] = S.statk[k] != 0 ? acc : 0.0f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
gi_fused_kernel(const float* __restrict__ G_in, const float* __restrict__ Ct_in,
                const float* __restrict__ l_in, const float* __restrict__ u_in,
                const float* __restrict__ xl_in,
                const float* __restrict__ xu_in,
                const float* __restrict__ a_in, float* __restrict__ x_out,
                float* __restrict__ u_out, int* __restrict__ status_out,
                int* __restrict__ aorder_out, int* __restrict__ scal_out,
                float* __restrict__ K_out, float* __restrict__ hscale_out,
                int n, int m, int np, int mp, int max_iter) {
  extern __shared__ __align__(16) char smem_raw[];
  Smem S;
  smem_layout(np, mp, smem_raw, &S);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int np2 = 2 * np, mtp = mp + np, ldg = np + 1;
  const long b = blockIdx.x;
  const float* Gb = G_in + b * np * np;
  float* G = S.G;
  float* C = S.C;
  float* K = S.K;
  int parity = 0;

  // ---------------- prologue: H0 = G^-1, x0, tr0, non-SPD flag ----------
  for (int e = tid; e < np * np; e += nt) G[(e / np) * ldg + e % np] = Gb[e];
  jrlqp::chol_block(G, np, ldg);            // G := L (lower)
  float* Li = C;                            // C^T's room is scratch here
  jrlqp::tri_inv_block(G, ldg, Li, np, np);
  const bool posdef = jrlqp::posdef_from_diag(G, ldg, np);
  for (int e = tid; e < np * np2; e += nt) {
    const int i = e / np2, j = e % np2;
    float h = 0.0f;
    if (j < np) {
      if (posdef) {
        for (int k = max(i, j); k < np; ++k)
          h = __fadd_rn(h, __fmul_rn(Li[k * np + i], Li[k * np + j]));
      } else {
        h = (i == j) ? 1.0f : 0.0f;
      }
    }
    K[e] = h;
  }
  __syncthreads();
  float tr = 0.0f;
  for (int k = 0; k < np; ++k) tr += K[k * np2 + k];
  const float tr0 = fmaxf(tr, 1e-30f);
  const float dep_thr = __fmul_rn(2e-7f, tr0);
  for (int i = tid; i < np; i += nt) {
    float acc = 0.0f;
    for (int j = 0; j < np; ++j) acc += K[i * np2 + j] * a_in[b * np + j];
    S.x[i] = posdef ? -acc : 0.0f;
    S.u[i] = 0.0f;
    S.npl[i] = 0.0f;
    S.statk[i] = 0;
    S.aorder[i] = -1;
  }
  for (int i = tid; i < mtp; i += nt) S.status[i] = 0;
  // G and C^T from device memory again (the factor and L^-1 are done),
  // and the bounds
  load_problem(S, b, G_in, Ct_in, l_in, u_in, xl_in, xu_in, np, mp);
  __syncthreads();

  // ---------------- equality / fixed replay, ascending -----------------
  auto is_eq = [&](int idx) {
    return idx < mp ? (idx < m && S.lo[idx] == S.up[idx])
                    : (idx - mp < n && S.xlo[idx - mp] == S.xup[idx - mp]);
  };
  int term = posdef ? RUNNING : NON_POS_HESSIAN;
  int q = 0;
  {
    Red r = red_identity();
    for (int idx = tid; idx < mtp; idx += nt)
      if (is_eq(idx)) r.s0 += 1.0f;
    r = block_reduce(r, S.red, parity);
    const bool over = r.s0 > (float)n;
    int prev = -1;
    while (term == RUNNING) {
      Red f = red_identity();
      for (int idx = tid; idx < mtp; idx += nt)
        if (idx > prev && is_eq(idx)) f.i2 = min(f.i2, idx);
      f = block_reduce(f, S.red, parity);
      const int idx = f.i2;
      if (idx == kNone) break;
      const bool is_bnd = idx >= mp;
      const int st = is_bnd ? FIXED : EQUALITY;
      const int cidx = clampi(idx, 0, mp - 1);
      for (int k = tid; k < np; k += nt)
        S.npl[k] = is_bnd ? (k == idx - mp ? 1.0f : 0.0f) : C[k * mp + cidx];
      __syncthreads();
      for (int j = tid; j < np2; j += nt) {
        float acc = 0.0f;
        for (int k = 0; k < np; ++k) acc += S.npl[k] * K[k * np2 + j];
        S.zr[j] = (j >= np && j - np >= q) ? 0.0f : acc;  // r_head
      }
      __syncthreads();
      Red s = red_identity();
      for (int k = tid; k < np; k += nt) {
        const float z = S.zr[k], p = S.npl[k];
        s.s0 += p * z;
        s.s1 += p * p;
        s.s2 += p * S.x[k];
        s.s3 += z * z;
      }
      s = block_reduce(s, S.red, parity);
      const float nz = s.s0, nn = s.s1, nx = s.s2, zz = s.s3;
      const float bsel = is_bnd ? S.xlo[idx - mp] : S.lo[cidx];
      const float nz_safe = nz != 0.0f ? nz : 1.0f;
      const float t =
          zz > 0.0f ? __fdiv_rn(__fsub_rn(bsel, nx), nz_safe) : 0.0f;
      const bool dependent = nz <= __fmul_rn(dep_thr, nn);
      const float dsafe = dependent ? 1.0f : nz;
      for (int k = tid; k < np; k += nt) {
        float uk = sub_mul(S.u[k], t, S.zr[np + k]);
        if (k == q) uk = __fadd_rn(uk, t);
        S.u[k] = uk;
        S.x[k] = __fadd_rn(S.x[k], __fmul_rn(t, S.zr[k]));
      }
      for (int e = tid; e < np * np2; e += nt) {
        const int i = e / np2, j = e % np2;
        K[e] = (j == np + q) ? __fdiv_rn(S.zr[i], dsafe)
                             : sub_mul(K[e], S.zr[i],
                                       __fdiv_rn(S.zr[j], dsafe));
      }
      __syncthreads();
      if (tid == 0) {
        S.status[idx] = st;
        if (q < np) {
          S.aorder[q] = idx;
          S.statk[q] = st;
        }
      }
      __syncthreads();
      if (dependent) term = LINEAR_DEPENDENCY_DETECTED;
      ++q;
      prev = idx;
    }
    if (over && term == RUNNING) term = OVERCONSTRAINED_PROBLEM;
  }

  Scal sc{q, 0, term, 0, -1, 0, q};
  gi_loop<false>(S, n, m, np, mp, max_iter, tr0, sc, parity);
  write_out(S, b, np, mp, sc, tr0, x_out, u_out, status_out, aorder_out,
            scal_out, K_out, hscale_out);
}

// K3 (kCompact = false) and K9 (kCompact = true): the loop from the state
// passed in. Each has a kernel of its own below, so a trace names it.
template <bool kCompact>
__device__ __forceinline__ void
state_loop(const float* __restrict__ G_in, const float* __restrict__ Ct_in,
           const float* __restrict__ l_in, const float* __restrict__ u_in,
           const float* __restrict__ xl_in,
           const float* __restrict__ xu_in,
           const float* __restrict__ K0_in,
           const float* __restrict__ x0_in,
           const float* __restrict__ u0_in,
           const int* __restrict__ status0_in,
           const int* __restrict__ aorder0_in,
           const int* __restrict__ statk0_in,
           const int* __restrict__ scal0_in,
           const float* __restrict__ hscale0_in,
           float* __restrict__ x_out, float* __restrict__ u_out,
           int* __restrict__ status_out, int* __restrict__ aorder_out,
           int* __restrict__ scal_out, float* __restrict__ K_out,
           float* __restrict__ hscale_out, int n, int m, int np, int mp,
           int max_iter) {
  extern __shared__ __align__(16) char smem_raw[];
  Smem S;
  smem_layout(np, mp, smem_raw, &S);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int np2 = 2 * np, mtp = mp + np;
  const long b = blockIdx.x;
  load_problem(S, b, G_in, Ct_in, l_in, u_in, xl_in, xu_in, np, mp);
  for (int e = tid; e < np * np2; e += nt) S.K[e] = K0_in[b * np * np2 + e];
  for (int k = tid; k < np; k += nt) {
    S.x[k] = x0_in[b * np + k];
    S.u[k] = u0_in[b * np + k];
    S.aorder[k] = aorder0_in[b * np + k];
    S.statk[k] = statk0_in[b * np + k];
  }
  for (int i = tid; i < mtp; i += nt) S.status[i] = status0_in[b * mtp + i];
  const int* s0 = scal0_in + b * 8;
  Scal sc{s0[0], s0[1], s0[2], s0[3], s0[4], s0[5], s0[6]};
  const float hscale = hscale0_in[b];
  __syncthreads();
  if (sc.skip1 != 0) {  // the pending candidate's normal, not zero
    candidate_normal(S, sc.sc_idx, sc.sc_st, np, mp);
    __syncthreads();
  }
  int parity = 0;
  gi_loop<kCompact>(S, n, m, np, mp, max_iter, fmaxf(hscale, 1e-30f), sc,
                    parity);
  write_out(S, b, np, mp, sc, hscale, x_out, u_out, status_out, aorder_out,
            scal_out, K_out, hscale_out);
}

// K3: hole slots.
__global__ void __launch_bounds__(kThreads)
gi_loop_kernel(const float* __restrict__ G_in, const float* __restrict__ Ct_in,
               const float* __restrict__ l_in, const float* __restrict__ u_in,
               const float* __restrict__ xl_in,
               const float* __restrict__ xu_in,
               const float* __restrict__ K0_in,
               const float* __restrict__ x0_in,
               const float* __restrict__ u0_in,
               const int* __restrict__ status0_in,
               const int* __restrict__ aorder0_in,
               const int* __restrict__ statk0_in,
               const int* __restrict__ scal0_in,
               const float* __restrict__ hscale0_in,
               float* __restrict__ x_out, float* __restrict__ u_out,
               int* __restrict__ status_out, int* __restrict__ aorder_out,
               int* __restrict__ scal_out, float* __restrict__ K_out,
               float* __restrict__ hscale_out, int n, int m, int np, int mp,
               int max_iter) {
  state_loop<false>(G_in, Ct_in, l_in, u_in, xl_in, xu_in, K0_in, x0_in,
                    u0_in, status0_in, aorder0_in, statk0_in, scal0_in,
                    hscale0_in, x_out, u_out, status_out, aorder_out,
                    scal_out, K_out, hscale_out, n, m, np, mp, max_iter);
}

// K9: compact slots.
__global__ void __launch_bounds__(kThreads)
gi_compact_kernel(const float* __restrict__ G_in,
                  const float* __restrict__ Ct_in,
                  const float* __restrict__ l_in,
                  const float* __restrict__ u_in,
                  const float* __restrict__ xl_in,
                  const float* __restrict__ xu_in,
                  const float* __restrict__ K0_in,
                  const float* __restrict__ x0_in,
                  const float* __restrict__ u0_in,
                  const int* __restrict__ status0_in,
                  const int* __restrict__ aorder0_in,
                  const int* __restrict__ statk0_in,
                  const int* __restrict__ scal0_in,
                  const float* __restrict__ hscale0_in,
                  float* __restrict__ x_out, float* __restrict__ u_out,
                  int* __restrict__ status_out, int* __restrict__ aorder_out,
                  int* __restrict__ scal_out, float* __restrict__ K_out,
                  float* __restrict__ hscale_out, int n, int m, int np,
                  int mp, int max_iter) {
  state_loop<true>(G_in, Ct_in, l_in, u_in, xl_in, xu_in, K0_in, x0_in,
                    u0_in, status0_in, aorder0_in, statk0_in, scal0_in,
                    hscale0_in, x_out, u_out, status_out, aorder_out,
                    scal_out, K_out, hscale_out, n, m, np, mp, max_iter);
}

__global__ void __launch_bounds__(kThreads)
gi_warm_kernel(const float* __restrict__ G_in, const float* __restrict__ Ct_in,
               const float* __restrict__ l_in, const float* __restrict__ u_in,
               const float* __restrict__ xl_in,
               const float* __restrict__ xu_in,
               const float* __restrict__ a_in,
               const float* __restrict__ K0_in,
               const int* __restrict__ status0_in,
               const int* __restrict__ aorder0_in,
               const int* __restrict__ statk0_in,
               const float* __restrict__ b0_in,
               const int* __restrict__ q0_in, float* __restrict__ x_out,
               float* __restrict__ u_out, int* __restrict__ status_out,
               int* __restrict__ aorder_out, int* __restrict__ scal_out,
               float* __restrict__ K_out, float* __restrict__ hscale_out,
               int n, int m, int np, int mp, int max_iter) {
  extern __shared__ __align__(16) char smem_raw[];
  Smem S;
  smem_layout(np, mp, smem_raw, &S);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int np2 = 2 * np, mtp = mp + np;
  const long b = blockIdx.x;
  load_problem(S, b, G_in, Ct_in, l_in, u_in, xl_in, xu_in, np, mp);
  for (int e = tid; e < np * np2; e += nt) S.K[e] = K0_in[b * np * np2 + e];
  for (int k = tid; k < np; k += nt) {
    S.a[k] = a_in[b * np + k];
    S.bact[k] = b0_in[b * np + k];
    S.aorder[k] = aorder0_in[b * np + k];
    S.statk[k] = statk0_in[b * np + k];
  }
  for (int i = tid; i < mtp; i += nt) S.status[i] = status0_in[b * mtp + i];
  int q = q0_in[b];
  __syncthreads();
  // tr0 from the carried H, not from trace(G^-1)
  float tr = 0.0f;
  for (int k = 0; k < np; ++k) tr += S.K[k * np2 + k];
  const float tr0 = fmaxf(tr, 1e-30f);
  closed_form(S, np);

  // u < -1e-5 deactivations, one slot at a time, lowest slot on ties
  int it = 0, parity = 0;
  while (true) {
    Red r = red_identity();
    for (int k = tid; k < np; k += nt) {
      const int sk = S.statk[k];
      const bool elig = sk != 0 && sk != EQUALITY && sk != FIXED;
      red_min(r, elig ? S.u[k] : 0.0f, k);
    }
    r = block_reduce(r, S.red, parity);
    if (!(r.v < -1e-5f)) break;
    const int lpos = r.i;
    remove_slot(S, lpos, np, mtp);
    if (tid == 0) S.bact[lpos] = 0.0f;
    __syncthreads();
    closed_form(S, np);
    --q;
    ++it;
  }

  Scal sc{q, it, RUNNING, 0, -1, 0, q};
  gi_loop<false>(S, n, m, np, mp, max_iter, tr0, sc, parity);
  write_out(S, b, np, mp, sc, tr0, x_out, u_out, status_out, aorder_out,
            scal_out, K_out, hscale_out);
}

// Raises the kernel's dynamic shared-memory limit to the layout's size.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int jrlqp_gi_fused(const void* G, const void* Ct, const void* l,
                              const void* u, const void* xl, const void* xu,
                              const void* a, void* x_out, void* u_out,
                              void* status_out, void* aorder_out,
                              void* scal_out, void* K_out, void* hscale_out,
                              int B, int n, int m, int np, int mp,
                              int max_iter, void* stream) {
  const size_t smem = smem_layout(np, mp, nullptr, nullptr);
  cudaError_t err = set_smem(gi_fused_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    gi_fused_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)G, (const float*)Ct, (const float*)l, (const float*)u,
        (const float*)xl, (const float*)xu, (const float*)a, (float*)x_out,
        (float*)u_out, (int*)status_out, (int*)aorder_out, (int*)scal_out,
        (float*)K_out, (float*)hscale_out, n, m, np, mp, max_iter);
  return (int)cudaGetLastError();
}

namespace {

template <typename Kernel>
int launch_state_loop(Kernel kernel, const void* G, const void* Ct,
                      const void* l, const void* u, const void* xl,
                      const void* xu, const void* K0, const void* x0,
                      const void* u0, const void* status0, const void* aorder0,
                      const void* statk0, const void* scal0,
                      const void* hscale0, void* x_out, void* u_out,
                      void* status_out, void* aorder_out, void* scal_out,
                      void* K_out, void* hscale_out, int B, int n, int m,
                      int np, int mp, int max_iter, void* stream) {
  const size_t smem = smem_layout(np, mp, nullptr, nullptr);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)G, (const float*)Ct, (const float*)l, (const float*)u,
        (const float*)xl, (const float*)xu, (const float*)K0,
        (const float*)x0, (const float*)u0, (const int*)status0,
        (const int*)aorder0, (const int*)statk0, (const int*)scal0,
        (const float*)hscale0, (float*)x_out, (float*)u_out,
        (int*)status_out, (int*)aorder_out, (int*)scal_out, (float*)K_out,
        (float*)hscale_out, n, m, np, mp, max_iter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int jrlqp_gi_loop(const void* G, const void* Ct, const void* l,
                             const void* u, const void* xl, const void* xu,
                             const void* K0, const void* x0, const void* u0,
                             const void* status0, const void* aorder0,
                             const void* statk0, const void* scal0,
                             const void* hscale0, void* x_out, void* u_out,
                             void* status_out, void* aorder_out,
                             void* scal_out, void* K_out, void* hscale_out,
                             int B, int n, int m, int np, int mp,
                             int max_iter, void* stream) {
  return launch_state_loop(
      gi_loop_kernel, G, Ct, l, u, xl, xu, K0, x0, u0, status0, aorder0, statk0,
      scal0, hscale0, x_out, u_out, status_out, aorder_out, scal_out, K_out,
      hscale_out, B, n, m, np, mp, max_iter, stream);
}

// K9: the same inputs and outputs as K3, compact slots.
extern "C" int jrlqp_gi_compact(const void* G, const void* Ct, const void* l,
                                const void* u, const void* xl, const void* xu,
                                const void* K0, const void* x0,
                                const void* u0, const void* status0,
                                const void* aorder0, const void* statk0,
                                const void* scal0, const void* hscale0,
                                void* x_out, void* u_out, void* status_out,
                                void* aorder_out, void* scal_out, void* K_out,
                                void* hscale_out, int B, int n, int m, int np,
                                int mp, int max_iter, void* stream) {
  return launch_state_loop(
      gi_compact_kernel, G, Ct, l, u, xl, xu, K0, x0, u0, status0, aorder0,
      statk0, scal0, hscale0, x_out, u_out, status_out, aorder_out,
      scal_out, K_out, hscale_out, B, n, m, np, mp, max_iter, stream);
}

extern "C" int jrlqp_gi_warm(const void* G, const void* Ct, const void* l,
                             const void* u, const void* xl, const void* xu,
                             const void* a, const void* K0,
                             const void* status0, const void* aorder0,
                             const void* statk0, const void* b0,
                             const void* q0, void* x_out, void* u_out,
                             void* status_out, void* aorder_out,
                             void* scal_out, void* K_out, void* hscale_out,
                             int B, int n, int m, int np, int mp,
                             int max_iter, void* stream) {
  const size_t smem = smem_layout(np, mp, nullptr, nullptr);
  cudaError_t err = set_smem(gi_warm_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    gi_warm_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)G, (const float*)Ct, (const float*)l, (const float*)u,
        (const float*)xl, (const float*)xu, (const float*)a,
        (const float*)K0, (const int*)status0, (const int*)aorder0,
        (const int*)statk0, (const float*)b0, (const int*)q0, (float*)x_out,
        (float*)u_out, (int*)status_out, (int*)aorder_out, (int*)scal_out,
        (float*)K_out, (float*)hscale_out, n, m, np, mp, max_iter);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of each of the four GI kernels.
extern "C" size_t jrlqp_gi_smem_bytes(int np, int mp) {
  return smem_layout(np, mp, nullptr, nullptr);
}
