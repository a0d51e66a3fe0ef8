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
//      aorder, statk and the new a and signed active bounds b_act come in
//      (a problem flagged for reset takes a second state's K, status,
//      aorder and q: the cold step's).
//      Prologue: a padded slot left occupied is freed, tr0 = trace of the
//      carried H, the closed form x = K [-a; b_act], u = ((a + G x)^T
//      K)[np:] on active slots, then the one-at-a-time deactivation of
//      u < 0 (lowest slot on ties; the Pallas kernel's u < -1e-5 keeps a
//      slot whose multiplier lies in [-1e-5, 0), which the f64 refinement
//      then gives the wrong sign),
//      each a removal followed by a new closed form, counted as an
//      iteration.
//   K9 gi_compact_kernel <- _kernel (:104, the pack-1 branch of
//      run_loop_pallas, pallas_call :1215). K3's entry and loop, with
//      compact slots: slots 0..q-1 active, the candidate at slot q; a
//      removal deletes slot l and shifts N* columns np+l+1..np+q-1, aorder,
//      statk and u one slot down (u up to the candidate's slot q), where
//      the hole layout zeroes slot l's column and moves the candidate's
//      multiplier into it. The w mask is "slot < q and slot != l". A
//      pending candidate's normal is rebuilt at entry as in K3; the Pallas
//      kernel starts it at zero (:336-339).
//   The loop: most-violated selection (skipped after a removal),
//   [z | r] = n+ K with K = [H | N*^T], step lengths, one rank-one update
//   of K per iteration (add or remove), hole-based active slots.
// The index layout is the Pallas kernels': padded sizes np = round_up(n+1,
// 8) and mp = round_up(m, 8), constraints in [0, mp), bounds in [mp, mp+np).
// Padded constraint rows and variables are never candidates, so the order
// of the real ones (constraints first, then bounds) and every
// lowest-index tie break are those of the reference.
//
// What bounds them here: each problem is a chain of ~60-100 dependent
// iterations (cold, n = 50, m = 100; a few warm) of ~2mn + 4n^2 + 4nq
// FLOPs between block-wide barriers, about 1% of the card's f32 rate; the
// bytes (the problem in, K out) are under 1% of the time. What is left is
// the instructions the loop issues around the arithmetic, the length of
// its serial chains, and how many warps each SM has to hide them. The
// state (C^T, K and the row vectors) stays in shared memory for the
// entire solve; G, read only by removals and K4's closed form, is read
// from device memory (it stays in L2), which leaves room for a fourth
// block per SM. The design cuts each of the three:
// - the rank-one update of K (add, removal, equality replay) walks K with
//   a fixed 2-D map, warps over rows and lanes over float4 column groups,
//   with no index division; the update's row is divided by the pivot once,
//   one column per thread, into shared memory (vq), so the per-element work
//   is a rounded multiply and subtract (no FMA contraction, as the plain
//   version rounds) and no division can reach the row loop;
// - every dot product (C x, n+ K, G n_l*, N*^T v) is one thread's chain in
//   k order, one output per thread, the order of the plain version's
//   matrix products; the directions of a candidate selected in the same
//   iteration read its normal from C directly, so no barrier waits for
//   n+ to be written. Dot products split over warps were slower on the
//   H100, and their other rounding flipped a near-tie that the plain
//   version's order does not (PERF.md, section 6). Each chain is unrolled
//   so that 8 (col_dot) or 16 (row_dot) steps of shared-memory loads are in
//   flight ahead of their FMAs: the chains are bound by that latency;
// - K3's, K4's and K9's state and every problem arrive by 16-byte
//   cp.async; K's rows lie at a pitch of 2 np + 4 floats in shared memory
//   (kPad), which spreads a warp's float4 row reads over the banks;
// - the reductions carry only what they reduce (an argmin with ties to
//   the lowest index, an integer min, up to four sums), each one shuffle
//   pass and one barrier;
// - K9's compaction shifts each row of N* in warp-wide chunks, left to
//   right, with no block barrier; the slot vectors are read into
//   registers, a barrier passes, then they are written;
// - K1's prologue factors G in K's left half and inverts the factor into
//   the right half while C^T, the bounds and a arrive by cp.async.
// The launch configuration is 128 threads per block with __launch_bounds__
// asking for 4 resident blocks per SM, and G read from device memory: on
// an H100 at n = 50, m = 100 it was faster than 256 threads, 3 blocks, or
// G in shared memory (PERF.md, section 6). The per-problem scalars stay in
// registers, computed alike by every thread, so branches are uniform and
// need no broadcast. A problem stops on its own when its term leaves
// RUNNING, which gives each lane the result a frozen lane of the TPU's
// packs gets.
#include <cuda_runtime.h>

#include "block_llt.cuh"

namespace {

// 4 blocks of 128 threads fill the SM's registers at 128 per thread; the
// layout without G leaves room for them in shared memory.
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;
constexpr int kWarps = kThreads / 32;
// Row pitch of K in shared memory is 2 np + kPad floats: np is a multiple
// of 8, so the pitch is an odd number of float4 groups, and the float4 row
// reads of a warp (thread i reads row i: the closed form, K1's x0) fall on
// distinct bank groups where a pitch of 2 np puts them on two. Reads by
// column (thread j reads column j) and the rank-one update's float4 row
// walk are conflict-free at any pitch.
constexpr int kPad = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float BIG = 1e30f;
constexpr int kNone = 0x7fffffff;

// ActivationStatus / TerminationStatus (jrlqp_tpu_torch/types.py)
constexpr int LOWER = 1, UPPER = 2, EQUALITY = 3, LOWER_BOUND = 4,
              UPPER_BOUND = 5, FIXED = 6;
constexpr int RUNNING = -1, SUCCESS = 0, NON_POS_HESSIAN = 2, INFEASIBLE = 3,
              MAX_ITER_REACHED = 4, LINEAR_DEPENDENCY_DETECTED = 5,
              OVERCONSTRAINED_PROBLEM = 6;

__host__ __device__ constexpr int k_pitch(int np) { return 2 * np + kPad; }

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// A block-wide reduction's operands and result: (min v, argmin i) with ties
// to the lowest i, a min over j, and sums s. Each reduction names the
// fields it carries; the others are neither shuffled nor posted.
struct Red {
  float v;
  int i, j;
  float s[4];
};

__device__ __forceinline__ Red red_identity() {
  Red r;
  r.v = __int_as_float(0x7f800000);  // +inf
  r.i = kNone;
  r.j = kNone;
  r.s[0] = r.s[1] = r.s[2] = r.s[3] = 0.0f;
  return r;
}

__device__ __forceinline__ void argmin_in(float& v, int& i, float v2,
                                          int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// kArg: the argmin over (v, i); kMin: the min over j; kSums: sums s[0..).
// Every thread returns the same value. Each warp reduces with shuffles and
// its lane 0 posts to `scratch`, which holds 2 * kWarps slots used
// alternately, so back-to-back reductions need one barrier each; then
// every thread combines the slots in warp order.
template <bool kArg, bool kMin, int kSums>
__device__ __forceinline__ Red block_reduce(Red r, Red* scratch,
                                            int& parity) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if constexpr (kArg) {
      const float v2 = __shfl_xor_sync(kFull, r.v, o);
      const int i2 = __shfl_xor_sync(kFull, r.i, o);
      argmin_in(r.v, r.i, v2, i2);
    }
#pragma unroll
    for (int q = 0; q < kSums; ++q)
      r.s[q] += __shfl_xor_sync(kFull, r.s[q], o);
  }
  if constexpr (kMin) r.j = __reduce_min_sync(kFull, r.j);
  Red* buf = scratch + parity * kWarps;
  parity ^= 1;
  if (lane_id() == 0) {
    Red& p = buf[warp_id()];
    if constexpr (kArg) {
      p.v = r.v;
      p.i = r.i;
    }
    if constexpr (kMin) p.j = r.j;
#pragma unroll
    for (int q = 0; q < kSums; ++q) p.s[q] = r.s[q];
  }
  __syncthreads();
  Red out = red_identity();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const Red& p = buf[w];
    if constexpr (kArg) argmin_in(out.v, out.i, p.v, p.i);
    if constexpr (kMin) out.j = min(out.j, p.j);
#pragma unroll
    for (int q = 0; q < kSums; ++q) out.s[q] = w == 0 ? p.s[q]
                                                      : out.s[q] + p.s[q];
  }
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

// cp.async of nwords floats (a multiple of 4; both ends 16-byte aligned)
// by the whole block, 16 bytes a thread at a time. The caller commits,
// waits and passes a barrier before reading.
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int nwords) {
  static_assert(sizeof(T) == 4, "copy_async moves 4-byte words");
  for (int e = 4 * threadIdx.x; e < nwords; e += 4 * kThreads)
    copy_async16(dst + e, src + e);
}

// cp.async of the np x np G (row pitch np in device memory) to row pitch
// ldd: half a warp per row, lanes 16-byte groups.
__device__ __forceinline__ void copy_async_G(float* dst, int ldd,
                                             const float* src, int np) {
  const int lane = lane_id();
  for (int i = 2 * warp_id() + (lane >> 4); i < np; i += 2 * kWarps)
    for (int c4 = lane & 15; c4 < (np >> 2); c4 += 16)
      copy_async16(dst + i * ldd + 4 * c4, src + i * np + 4 * c4);
}

// cp.async of the np x 2np operator K from device memory (row pitch 2np)
// into shared memory (row pitch k_pitch(np)): warps take rows, lanes
// 16-byte groups.
__device__ __forceinline__ void copy_async_K(float* K, const float* src,
                                             int np) {
  const int np2 = 2 * np, ldk = k_pitch(np);
  for (int i = warp_id(); i < np; i += kWarps)
    for (int c4 = lane_id(); c4 < (np2 >> 2); c4 += 32)
      copy_async16(K + i * ldk + 4 * c4, src + i * np2 + 4 * c4);
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Waits until at most kPending of this thread's committed groups are
// still in flight.
template <int kPending>
__device__ __forceinline__ void copy_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct Smem {
  Red* red;
  // the problem's G and its row pitch: in device memory (pitch np), or,
  // during K4's prologue, staged in C^T's room
  const float* G;
  int ldg;
  float *C, *K, *x, *u, *npl, *nl, *v, *w, *xlo, *xup, *zr, *vq,
      *lo, *up, *a, *bact;
  int *statk, *aorder, *status;
};

// One layout for the four kernels; `a` and `bact` are K1's and K4's alone.
// S.G is not in it: each kernel points it at its problem's G (row pitch
// S.ldg, np in device memory).
__host__ __device__ inline size_t smem_layout(int np, int mp, char* base,
                                              Smem* s) {
  const int mtp = mp + np;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base + off;
    off += (bytes + 15) / 16 * 16;
    return p;
  };
  Red* red = (Red*)take(2 * kWarps * sizeof(Red));
  float* C = (float*)take((size_t)np * mp * 4);
  float* K = (float*)take((size_t)np * k_pitch(np) * 4);
  float* x = (float*)take(np * 4);
  float* u = (float*)take(np * 4);
  float* npl = (float*)take(np * 4);
  float* nl = (float*)take(np * 4);
  float* v = (float*)take(np * 4);
  float* w = (float*)take(np * 4);
  float* xlo = (float*)take(np * 4);
  float* xup = (float*)take(np * 4);
  float* zr = (float*)take(2 * np * 4);
  float* vq = (float*)take(2 * np * 4);
  float* lo = (float*)take(mp * 4);
  float* up = (float*)take(mp * 4);
  float* a = (float*)take(np * 4);
  float* bact = (float*)take(np * 4);
  int* statk = (int*)take(np * 4);
  int* aorder = (int*)take(np * 4);
  int* status = (int*)take(mtp * 4);
  if (s) *s = Smem{red, nullptr, np, C, K, x, u, npl, nl, v, w, xlo, xup,
                   zr, vq, lo, up, a, bact, statk, aorder, status};
  return off;
}

// The loop's per-problem scalars, in registers, equal in every thread.
struct Scal {
  int q, it, term, skip1, sc_idx, sc_st, sc_slot;
};

// cp.async of C^T of problem b; the caller commits and waits.
__device__ __forceinline__ void load_C_async(const Smem& S, long b,
                                             const float* Ct_in, int np,
                                             int mp) {
  copy_async(S.C, Ct_in + b * np * mp, np * mp);
}

// cp.async of the four bound rows of problem b.
__device__ __forceinline__ void load_bounds_async(
    const Smem& S, long b, const float* l_in, const float* u_in,
    const float* xl_in, const float* xu_in, int np, int mp) {
  copy_async(S.lo, l_in + b * mp, mp);
  copy_async(S.up, u_in + b * mp, mp);
  copy_async(S.xlo, xl_in + b * np, np);
  copy_async(S.xup, xu_in + b * np, np);
}

// A[:nk, j] . vec, k ascending, one chain (the plain version's order);
// vec(k) gives the vector's entries. Unrolled by 8 so that the loads of
// eight steps are in flight ahead of their chained FMAs: the chain waits
// for shared memory once per eight steps, not once per four.
template <typename Vec>
__device__ __forceinline__ float col_dot(Vec vec, const float* A, int lda,
                                         int nk, int j) {
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < nk; ++k) acc += vec(k) * A[k * lda + j];
  return acc;
}

// acc + A[i, :ncols] . vec, j ascending, one chain. Row i and vec are read
// four floats at a time: lda and ncols are multiples of 4 and both start
// 16-byte aligned. Unrolled by 4 (16 steps of loads in flight), as col_dot.
__device__ __forceinline__ float row_dot(const float* A, int lda,
                                         const float* vec, int ncols, int i,
                                         float acc = 0.0f) {
  const float4* row = reinterpret_cast<const float4*>(A + (size_t)i * lda);
  const float4* v4 = reinterpret_cast<const float4*>(vec);
#pragma unroll 4
  for (int j4 = 0; j4 < (ncols >> 2); ++j4) {
    const float4 r = row[j4], v = v4[j4];
    acc += r.x * v.x;
    acc += r.y * v.y;
    acc += r.z * v.z;
    acc += r.w * v.w;
  }
  return acc;
}

// K -= ucol vq^T on the np x 2np operator, except column spec (none when
// spec < 0 or >= 2np), which becomes sval(i). vq is the update's row
// already divided by the pivot, in shared memory, written by the whole
// block one column per thread (scaled_row, and the removals) with a barrier
// before this: one IEEE division per column and update. Quotients formed in
// registers ahead of the row loop were recomputed inside it by ptxas, four
// divisions per row and lane, most through the slow path of a zero
// numerator: 20,000 cycles of a removal (PERF.md, section 6). Warps take
// rows, lanes take float4 column groups.
template <typename SVal>
__device__ __forceinline__ void rank_one(float* K, const float* ucol,
                                         const float* vq, int np, int spec,
                                         SVal sval) {
  const int lane = lane_id(), warp = warp_id(), np2 = 2 * np;
  const int ldk = k_pitch(np);
  for (int c4 = lane; c4 < (np2 >> 2); c4 += 32) {
    const int j0 = 4 * c4;
    const float4 v = *reinterpret_cast<const float4*>(vq + j0);
    const int sq = (spec >= j0 && spec < j0 + 4) ? spec - j0 : -1;
    for (int i = warp; i < np; i += kWarps) {
      float4* p = reinterpret_cast<float4*>(K + i * ldk + j0);
      float4 k = *p;
      const float ui = ucol[i];
      k.x = sub_mul(k.x, ui, v.x);
      k.y = sub_mul(k.y, ui, v.y);
      k.z = sub_mul(k.z, ui, v.z);
      k.w = sub_mul(k.w, ui, v.w);
      if (sq >= 0) {
        const float s = sval(i);
        if (sq == 0) k.x = s;
        else if (sq == 1) k.y = s;
        else if (sq == 2) k.z = s;
        else k.w = s;
      }
      *p = k;
    }
  }
}

// vq = [z | r] / dsafe: the row of an add's (or an equality replay's)
// rank-one update, and, in its first half, the new N* column z / dsafe.
// Returns after the barrier that publishes it.
__device__ __forceinline__ void scaled_row(const Smem& S, int np,
                                           float dsafe) {
  for (int j = threadIdx.x; j < 2 * np; j += kThreads)
    S.vq[j] = __fdiv_rn(S.zr[j], dsafe);
  __syncthreads();
}

// vq = [-n_l* | w masked to the slots `keep`(k)] / wl: the row of a
// removal's rank-one update. Returns after the barrier that publishes it.
template <typename Keep>
__device__ __forceinline__ void removal_row(const Smem& S, int np, float wl,
                                            Keep keep) {
  for (int j = threadIdx.x; j < 2 * np; j += kThreads) {
    const int k = j - np;
    const float vj = j < np ? -S.nl[j] : (keep(k) ? S.w[k] : 0.0f);
    S.vq[j] = __fdiv_rn(vj, wl);
  }
  __syncthreads();
}

// n+ = sign (e_j | C[sc_idx]) of the candidate (sc_idx, sc_st) into npl.
__device__ __forceinline__ void candidate_normal(const Smem& S, int sc_idx,
                                                 int sc_st, int np, int mp) {
  const float sgn = (sc_st == UPPER || sc_st == UPPER_BOUND) ? -1.0f : 1.0f;
  const bool bnd = sc_st >= LOWER_BOUND;
  const int cidx = clampi(sc_idx, 0, mp - 1);
  for (int k = threadIdx.x; k < np; k += kThreads)
    S.npl[k] = sgn * (bnd ? (k == sc_idx - mp ? 1.0f : 0.0f)
                          : S.C[k * mp + cidx]);
}

// The removal's vectors for active slot lpos: n_l* = K[:, np + lpos] into
// nl, v = G n_l* and w = N* v. Returns w_l made safe (1 where it is 0),
// after the barrier that publishes w.
__device__ __forceinline__ float removal_vectors(const Smem& S, int lpos,
                                                 int np) {
  const int ldk = k_pitch(np);
  for (int i = threadIdx.x; i < np; i += kThreads)
    S.nl[i] = S.K[i * ldk + np + lpos];
  __syncthreads();
  for (int i = threadIdx.x; i < np; i += kThreads)
    S.v[i] = row_dot(S.G, S.ldg, S.nl, np, i);
  __syncthreads();
  for (int k = threadIdx.x; k < np; k += kThreads)
    S.w[k] = col_dot([&](int i) { return S.v[i]; }, S.K + np, ldk, np, k);
  __syncthreads();
  const float wl = S.w[lpos];
  return fabsf(wl) > 0.0f ? wl : 1.0f;
}

// Removal of active slot lpos, hole-based: K -= n_l* [-n_l* | w_masked]^T
// / w_l with w masked to active slots other than lpos, the slot's N*
// column := 0, then the slot's status, aorder and statk cleared. The
// loop's remove step and K4's deactivations both run it. Returns after the
// barrier that publishes K, with the bookkeeping written by thread 0 and
// not yet published.
__device__ __forceinline__ void remove_slot(const Smem& S, int lpos, int np,
                                            int mtp) {
  const float wl = removal_vectors(S, lpos, np);
  removal_row(S, np, wl,
              [&](int k) { return S.statk[k] != 0 && k != lpos; });
  rank_one(S.K, S.nl, S.vq, np, np + lpos, [](int) { return 0.0f; });
  __syncthreads();
  if (threadIdx.x == 0) {
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
  const int tid = threadIdx.x, lane = lane_id(), warp = warp_id();
  const int ldk = k_pitch(np);
  float* K = S.K;
  const int rem_idx = clampi(S.aorder[lpos], 0, mtp - 1);
  const float wl = removal_vectors(S, lpos, np);
  removal_row(S, np, wl, [&](int k) { return k < q && k != lpos; });
  rank_one(K, S.nl, S.vq, np, -1, [](int) { return 0.0f; });
  for (int k = tid; k < np; k += kThreads) {
    float uk = sub_mul(S.u[k], t, S.zr[np + k]);
    if (k == q) uk = __fadd_rn(uk, t);
    S.u[k] = uk;
    if (!dual_step) S.x[k] = __fadd_rn(S.x[k], __fmul_rn(t, S.zr[k]));
  }
  __syncthreads();
  // N* columns: each warp shifts its rows in chunks of 32 columns, left to
  // right, each chunk read into registers before it is written, so no
  // element is read after it was overwritten
  for (int i = warp; i < np; i += kWarps) {
    float* row = K + i * ldk + np;
    for (int k0 = lpos; k0 < np; k0 += 32) {
      const int k = k0 + lane;
      const float val = (k < np && k < q - 1) ? row[k + 1] : 0.0f;
      __syncwarp();
      if (k < np) row[k] = val;
      __syncwarp();
    }
  }
  // the slot vectors: read into registers, barrier, write
  for (int base = 0; base < np; base += kThreads) {
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

// Directions [z | r] = n+ K into zr, one column per thread in k order. A
// candidate cand_idx >= 0 of status cand_st, whose npl is being written in
// the same phase, is read from its own normal instead (C's column or e_j,
// unsigned; the sign is applied to the sum, which is exact).
// finish_directions masks r.
__device__ __forceinline__ void directions(const Smem& S, int np, int mp,
                                           int cand_idx, int cand_st) {
  const int np2 = 2 * np, ldk = k_pitch(np);
  const bool neg =
      cand_idx >= 0 && (cand_st == UPPER || cand_st == UPPER_BOUND);
  const int c = clampi(cand_idx, 0, mp - 1), e = cand_idx - mp;
  for (int j = threadIdx.x; j < np2; j += kThreads) {
    float z;
    if (cand_idx < 0)
      z = col_dot([&](int k) { return S.npl[k]; }, S.K, ldk, np, j);
    else if (cand_st < LOWER_BOUND)
      z = col_dot([&](int k) { return S.C[k * mp + c]; }, S.K, ldk, np, j);
    else
      z = col_dot([&](int k) { return k == e ? 1.0f : 0.0f; }, S.K, ldk, np,
                  j);
    S.zr[j] = neg ? -z : z;
  }
}

// Slot k's part of the directions, by thread k: r_k := 0 off the active
// slots (`act`), and the four dot products z.z, n+.z, n+.x, n+.n+
// accumulate into s. Returns r_k.
__device__ __forceinline__ float finish_directions(const Smem& S, int k,
                                                   int np, bool act, Red& s) {
  const float z = S.zr[k];
  const float r = act ? S.zr[np + k] : 0.0f;
  S.zr[np + k] = r;
  const float p = S.npl[k];
  s.s[0] += z * z;
  s.s[1] += p * z;
  s.s[2] += p * S.x[k];
  s.s[3] += p * p;
  return r;
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
  const int tid = threadIdx.x;
  const int mtp = mp + np;
  float* K = S.K;
  const float dep_thr = __fmul_rn(2e-7f, tr0);
  const float inv_n = (float)(1.0 / (double)n);
  const float zs = __fmul_rn(__fmul_rn(1e-6f, tr0), inv_n);
  int q = sc.q, it = sc.it, term = sc.term, skip1 = sc.skip1;
  int sc_idx = sc.sc_idx, sc_st = sc.sc_st, sc_slot = sc.sc_slot;
  while (term == RUNNING && it < max_iter) {
    bool success = false;
    const bool fresh = skip1 == 0;  // a candidate is selected here
    if (fresh) {
      // step 1: most-violated inactive constraint or bound; the argmin's
      // index carries the side (8 idx + st)
      Red r = red_identity();
      for (int idx = tid; idx < mtp; idx += kThreads) {
        float val;
        int st;
        if (idx < mp) {
          const float cx =
              col_dot([&](int k) { return S.x[k]; }, S.C, mp, np, idx);
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
        argmin_in(r.v, r.i, val, 8 * idx + st);
      }
      // the candidate's slot: the first free one, pinned while it lives
      if (!kCompact)
        for (int k = tid; k < np; k += kThreads)
          if (S.statk[k] == 0) r.j = min(r.j, k);
      r = block_reduce<true, !kCompact, 0>(r, S.red, parity);
      success = r.v >= 0.0f;
      sc_idx = r.i >> 3;
      sc_st = r.i & 7;
      sc_slot = r.j == kNone ? 0 : r.j;
      candidate_normal(S, sc_idx, sc_st, np, mp);
    }
    const float sign = (sc_st == UPPER || sc_st == UPPER_BOUND) ? -1.0f : 1.0f;
    const bool is_bnd = sc_st >= LOWER_BOUND;
    const int slot = kCompact ? q : sc_slot;  // the candidate's slot

    // directions [z | r] = n+ K, then the step lengths: t1 over eligible
    // slots, and the four dot products
    directions(S, np, mp, fresh ? sc_idx : -1, sc_st);
    __syncthreads();
    Red s = red_identity();
    for (int k = tid; k < np; k += kThreads) {
      const int sk = S.statk[k];
      const bool act = kCompact ? k < q : sk != 0;
      const float r = finish_directions(S, k, np, act, s);
      const bool elig = act && sk != EQUALITY && sk != FIXED && r > 0.0f;
      argmin_in(s.v, s.i, elig ? __fdiv_rn(S.u[k], r) : BIG, k);
    }
    s = block_reduce<true, false, 4>(s, S.red, parity);
    const float t1 = fminf(s.v, BIG);
    const int lpos = clampi(s.i, 0, np - 1);
    const float znorm2 = s.s[0], nz = s.s[1], nx = s.s[2], nn = s.s[3];
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
      for (int k = tid; k < np; k += kThreads) {
        float uk = sub_mul(S.u[k], t, S.zr[np + k]);
        if (k == slot) uk = __fadd_rn(uk, t);
        S.u[k] = uk;
        S.x[k] = __fadd_rn(S.x[k], __fmul_rn(t, S.zr[k]));
      }
      scaled_row(S, np, dsafe);
      rank_one(K, S.zr, S.vq, np, np + slot,
               [&](int i) { return S.vq[i]; });
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
      for (int k = tid; k < np; k += kThreads) {
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
  const int tid = threadIdx.x;
  const int np2 = 2 * np, ldk = k_pitch(np), mtp = mp + np;
  for (int k = tid; k < np; k += kThreads) {
    x_out[b * np + k] = S.x[k];
    u_out[b * np + k] = S.u[k];
    aorder_out[b * np + k] = S.aorder[k];
  }
  for (int i = tid; i < mtp; i += kThreads)
    status_out[b * mtp + i] = S.status[i];
  // K leaves its pitched rows as 16-byte stores: warps take rows, lanes
  // float4 groups
  float* Kb = K_out + b * np * np2;
  for (int i = warp_id(); i < np; i += kWarps)
    for (int c4 = lane_id(); c4 < (np2 >> 2); c4 += 32)
      *reinterpret_cast<float4*>(Kb + i * np2 + 4 * c4) =
          *reinterpret_cast<const float4*>(S.K + i * ldk + 4 * c4);
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
// Thread i owns output i, one chain in j order. Rows of K (pitch
// k_pitch(np), conflict-free as float4) and of G (S.G at pitch S.ldg:
// staged in shared memory by K4's prologue when it fits, else device
// memory) are read four floats at a time; the last pass reads K by column.
// The negated first half is exact: -(sum K a) has the bits of sum K (-a).
// With wait_g, G is the second of three cp.async groups still in flight: it
// is awaited behind the first pass, which does not read it. Returns with x
// and u published.
__device__ __forceinline__ void closed_form(const Smem& S, int np,
                                            bool wait_g = false) {
  const int tid = threadIdx.x;
  const int ldk = k_pitch(np);
  const float* K = S.K;
  for (int i = tid; i < np; i += kThreads)
    S.x[i] = row_dot(K + np, ldk, S.bact, np, i,
                     -row_dot(K, ldk, S.a, np, i));
  if (wait_g) copy_async_wait_group<1>();
  __syncthreads();
  for (int i = tid; i < np; i += kThreads)
    S.v[i] = S.a[i] + row_dot(S.G, S.ldg, S.x, np, i);
  __syncthreads();
  for (int k = tid; k < np; k += kThreads) {
    const float acc =
        col_dot([&](int i) { return S.v[i]; }, K + np, ldk, np, k);
    S.u[k] = S.statk[k] != 0 ? acc : 0.0f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
  const long b = blockIdx.x;
  const int tid = threadIdx.x, lane = lane_id(), warp = warp_id();
  const int ldk = k_pitch(np), mtp = mp + np;
  const float* Gb = G_in + b * np * np;
  S.G = Gb;
  float* K = S.K;
  int parity = 0;

  // ---------------- prologue: H0 = G^-1, x0, tr0, non-SPD flag ----------
  // C^T, the bounds and a are in flight while G is factored in K's left
  // half and L^-1 formed in its right half
  copy_async(S.C, Ct_in + b * np * mp, np * mp);
  copy_async(S.lo, l_in + b * mp, mp);
  copy_async(S.up, u_in + b * mp, mp);
  copy_async(S.xlo, xl_in + b * np, np);
  copy_async(S.xup, xu_in + b * np, np);
  copy_async(S.a, a_in + b * np, np);
  copy_async_commit();
  for (int i = warp; i < np; i += kWarps)
    for (int c4 = lane; c4 < (np >> 2); c4 += 32)
      *reinterpret_cast<float4*>(K + i * ldk + 4 * c4) =
          *reinterpret_cast<const float4*>(Gb + i * np + 4 * c4);
  // K's left half := L, its right half := L^-1
  jrlqp::chol_inv_block(K, ldk, K + np, ldk, np);
  const float* Li = K + np;
  const bool posdef = jrlqp::posdef_from_diag(K, ldk, np);
  __syncthreads();  // diag(L) is read before H0 overwrites it
  // H0 = L^-T L^-1 into the left half, each thread its (row, column) pairs
  for (int i = warp; i < np; i += kWarps)
    for (int j = lane; j < np; j += 32) {
      float h = (i == j) ? 1.0f : 0.0f;
      if (posdef) {
        h = 0.0f;
        for (int k = max(i, j); k < np; ++k)
          h = __fadd_rn(h, __fmul_rn(Li[k * ldk + i], Li[k * ldk + j]));
      }
      K[i * ldk + j] = h;
    }
  copy_async_wait();
  __syncthreads();
  for (int i = warp; i < np; i += kWarps)
    for (int c4 = lane; c4 < (np >> 2); c4 += 32)
      *reinterpret_cast<float4*>(K + i * ldk + np + 4 * c4) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = tid; i < np; i += kThreads) {
    S.x[i] = posdef ? -row_dot(K, ldk, S.a, np, i) : 0.0f;
    S.u[i] = 0.0f;
    S.npl[i] = 0.0f;
    S.statk[i] = 0;
    S.aorder[i] = -1;
  }
  for (int i = tid; i < mtp; i += kThreads) S.status[i] = 0;
  float tr = 0.0f;
  for (int k = 0; k < np; ++k) tr += K[k * ldk + k];
  const float tr0 = fmaxf(tr, 1e-30f);
  const float dep_thr = __fmul_rn(2e-7f, tr0);
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
    for (int idx = tid; idx < mtp; idx += kThreads)
      if (is_eq(idx)) r.s[0] += 1.0f;
    r = block_reduce<false, false, 1>(r, S.red, parity);
    const bool over = r.s[0] > (float)n;
    int prev = -1;
    while (term == RUNNING) {
      Red f = red_identity();
      for (int idx = tid; idx < mtp; idx += kThreads)
        if (idx > prev && is_eq(idx)) f.j = min(f.j, idx);
      f = block_reduce<false, true, 0>(f, S.red, parity);
      const int idx = f.j;
      if (idx == kNone) break;
      const bool is_bnd = idx >= mp;
      const int st = is_bnd ? FIXED : EQUALITY;
      const int cidx = clampi(idx, 0, mp - 1);
      for (int k = tid; k < np; k += kThreads)
        S.npl[k] = is_bnd ? (k == idx - mp ? 1.0f : 0.0f)
                          : S.C[k * mp + cidx];
      directions(S, np, mp, idx, st);
      __syncthreads();
      Red s = red_identity();
      for (int k = tid; k < np; k += kThreads)
        finish_directions(S, k, np, k < q, s);  // r_head
      s = block_reduce<false, false, 4>(s, S.red, parity);
      const float zz = s.s[0], nz = s.s[1], nx = s.s[2], nn = s.s[3];
      const float bsel = is_bnd ? S.xlo[idx - mp] : S.lo[cidx];
      const float nz_safe = nz != 0.0f ? nz : 1.0f;
      const float t =
          zz > 0.0f ? __fdiv_rn(__fsub_rn(bsel, nx), nz_safe) : 0.0f;
      const bool dependent = nz <= __fmul_rn(dep_thr, nn);
      const float dsafe = dependent ? 1.0f : nz;
      for (int k = tid; k < np; k += kThreads) {
        float uk = sub_mul(S.u[k], t, S.zr[np + k]);
        if (k == q) uk = __fadd_rn(uk, t);
        S.u[k] = uk;
        S.x[k] = __fadd_rn(S.x[k], __fmul_rn(t, S.zr[k]));
      }
      scaled_row(S, np, dsafe);
      rank_one(K, S.zr, S.vq, np, np + q, [&](int i) { return S.vq[i]; });
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
  const int mtp = mp + np;
  const long b = blockIdx.x;
  S.G = G_in + b * np * np;
  // the whole state arrives by 16-byte cp.async (the loop's first step
  // reads all of it); K takes its pitched rows (k_pitch)
  load_C_async(S, b, Ct_in, np, mp);
  load_bounds_async(S, b, l_in, u_in, xl_in, xu_in, np, mp);
  copy_async_K(S.K, K0_in + b * np * 2 * np, np);
  copy_async(S.x, x0_in + b * np, np);
  copy_async(S.u, u0_in + b * np, np);
  copy_async(S.aorder, aorder0_in + b * np, np);
  copy_async(S.statk, statk0_in + b * np, np);
  copy_async(S.status, status0_in + b * mtp, mtp);
  copy_async_commit();
  const int* s0 = scal0_in + b * 8;
  Scal sc{s0[0], s0[1], s0[2], s0[3], s0[4], s0[5], s0[6]};
  const float hscale = hscale0_in[b];
  copy_async_wait();
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
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
__global__ void __launch_bounds__(kThreads, kMinBlocks)
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

// K4. What bounds it: a warm step runs one or two loop iterations, so the
// kernel is its entry and exit: 85 KB per problem through the SM (K in and
// out, C^T, G) and a prologue of chained matrix-vector passes, each bound
// by the latency of what it reads. Stamped with clock64 (PERF.md, section
// 6), the first design spent a third of its life in the deactivations'
// rank-one updates (divisions recomputed per row: see rank_one), a quarter
// waiting for its inputs through scalar loads, and the rest in the chains.
// The design: the inputs arrive by 16-byte cp.async in three groups -- K,
// a, the bounds and the carried status and aorder, which the slots and the
// closed form's first pass read; then G, into C^T's room at a pitch of
// np + 4 (conflict-free float4 rows) when that room holds it (mp >= np +
// 4), so the closed form and every deactivation read it from shared
// memory; then the part of C^T behind that room. The head of C^T, which
// only the loop reads, follows when the deactivations are done (where G
// stays in device memory, all of C^T is the third group). The per-slot
// statuses and signed active bounds are formed here from status, aorder
// and the new bounds, so the host packs nothing; the closed form reads its
// rows as conflict-free float4 with 16 steps of loads in flight
// (closed_form, row_dot); one thread sums tr0 while the others run the
// closed form; K leaves as float4 stores (write_out).
// K0 may be K1's output, whose H carries the identity on its padded
// diagonal: tr0 sums the n real entries (adding the zeros of a zero-padded
// H changes no bit), and every other read of the padding meets a zero.
// A problem whose reset flag is set starts from the second state that comes
// in (Kr, statusr, aorderr, qr: the trajectory's cold step) in place of K0,
// status0, aorder0 and q0.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gi_warm_kernel(const float* __restrict__ G_in, const float* __restrict__ Ct_in,
               const float* __restrict__ l_in, const float* __restrict__ u_in,
               const float* __restrict__ xl_in,
               const float* __restrict__ xu_in,
               const float* __restrict__ a_in,
               const float* __restrict__ K0_in,
               const int* __restrict__ status0_in,
               const int* __restrict__ aorder0_in,
               const int* __restrict__ q0_in,
               const int* __restrict__ reset_in,
               const float* __restrict__ Kr_in,
               const int* __restrict__ statusr_in,
               const int* __restrict__ aorderr_in,
               const int* __restrict__ qr_in, float* __restrict__ x_out,
               float* __restrict__ u_out, int* __restrict__ status_out,
               int* __restrict__ aorder_out, int* __restrict__ scal_out,
               float* __restrict__ K_out, float* __restrict__ hscale_out,
               int n, int m, int np, int mp, int max_iter) {
  extern __shared__ __align__(16) char smem_raw[];
  Smem S;
  smem_layout(np, mp, smem_raw, &S);
  const int tid = threadIdx.x;
  const int ldk = k_pitch(np), mtp = mp + np;
  const long b = blockIdx.x;
  const float* Gb = G_in + b * np * np;
  const bool stage_g = mp >= np + 4;  // G fits C^T's room at pitch np + 4
  // three groups: what the slots and the closed form's first pass read;
  // G; and C^T, or the part of it behind the staged G's room
  const int g_room = stage_g ? np * (np + 4) : 0;
  const float* Ctb = Ct_in + b * np * mp;
  const bool reset = reset_in[b] != 0;
  copy_async_K(S.K, (reset ? Kr_in : K0_in) + b * np * 2 * np, np);
  copy_async(S.a, a_in + b * np, np);
  load_bounds_async(S, b, l_in, u_in, xl_in, xu_in, np, mp);
  copy_async(S.aorder, (reset ? aorderr_in : aorder0_in) + b * np, np);
  copy_async(S.status, (reset ? statusr_in : status0_in) + b * mtp, mtp);
  copy_async_commit();
  if (stage_g) copy_async_G(S.C, np + 4, Gb, np);
  copy_async_commit();
  copy_async(S.C + g_room, Ctb + g_room, np * mp - g_room);
  copy_async_commit();
  S.G = stage_g ? S.C : Gb;
  S.ldg = stage_g ? np + 4 : np;
  int q = reset ? qr_in[b] : q0_in[b];
  copy_async_wait_group<2>();  // K, a, the bounds, status and aorder
  __syncthreads();
  // The carry holds n slots, as the library's does: a padded slot that the
  // last kernel left occupied (a lane that ended LINEAR_DEPENDENCY_DETECTED
  // at q > n) comes in free, its N* column zero, its constraint inactive
  // and no longer counted in q (the Pallas kernel keeps the constraint
  // active in status, where no slot holds it: it is never tested again).
  for (int k = n; k < np; ++k) {
    const int idx = S.aorder[k];
    if (idx >= 0) {
      --q;
      if (tid == 0) S.status[idx] = 0;
    }
  }
  for (int e = tid; e < np * (np - n); e += kThreads)
    S.K[(e / (np - n)) * ldk + np + n + e % (np - n)] = 0.0f;
  __syncthreads();
  // slot k: its status, and its signed active bound from the new bounds
  // (LOWER / EQUALITY -> l, UPPER -> -u, LOWER_BOUND / FIXED -> xl,
  // UPPER_BOUND -> -xu, clamped to +/-1e30; 0 on a free slot)
  for (int k = tid; k < np; k += kThreads) {
    int idx = S.aorder[k];
    if (k >= n) S.aorder[k] = idx = -1;
    int st = 0;
    float bk = 0.0f;
    if (idx >= 0) {
      st = S.status[idx];
      const float v = idx < mp ? (st == UPPER ? -S.up[idx] : S.lo[idx])
                               : (st == UPPER_BOUND ? -S.xup[idx - mp]
                                                    : S.xlo[idx - mp]);
      bk = fminf(fmaxf(v, -BIG), BIG);
    }
    S.statk[k] = st;
    S.bact[k] = bk;
  }
  __syncthreads();
  // tr0 from the carried H, not from trace(G^-1): one chain in k order,
  // by a thread that is idle in the closed form when np < kThreads; the
  // closed form's barriers publish it
  if (tid == kThreads - 1) {
    float tr = 0.0f;
    for (int k = 0; k < n; ++k) tr += S.K[k * ldk + k];
    S.zr[0] = tr;
  }
  closed_form(S, np, true);
  const float tr0 = fmaxf(S.zr[0], 1e-30f);

  // u < 0 deactivations, one slot at a time, lowest slot on ties
  int it = 0, parity = 0;
  while (true) {
    Red r = red_identity();
    for (int k = tid; k < np; k += kThreads) {
      const int sk = S.statk[k];
      const bool elig = sk != 0 && sk != EQUALITY && sk != FIXED;
      argmin_in(r.v, r.i, elig ? S.u[k] : 0.0f, k);
    }
    r = block_reduce<true, false, 0>(r, S.red, parity);
    if (!(r.v < 0.0f)) break;
    const int lpos = r.i;
    remove_slot(S, lpos, np, mtp);
    if (tid == 0) S.bact[lpos] = 0.0f;
    __syncthreads();
    closed_form(S, np);
    --q;
    ++it;
  }

  if (stage_g) {
    // every read of the staged G lies before the last barrier: the head of
    // C^T takes its room
    copy_async(S.C, Ctb, g_room);
    copy_async_commit();
    S.G = Gb;
    S.ldg = np;
  }
  copy_async_wait();  // C^T
  __syncthreads();
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

template <typename Kernel>
int blocks_per_sm(Kernel kernel, size_t smem) {
  cudaError_t err = set_smem(kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
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
                             const void* q0, const void* reset,
                             const void* Kr, const void* statusr,
                             const void* aorderr, const void* qr,
                             void* x_out, void* u_out,
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
        (const int*)q0, (const int*)reset, (const float*)Kr,
        (const int*)statusr, (const int*)aorderr, (const int*)qr,
        (float*)x_out,
        (float*)u_out, (int*)status_out, (int*)aorder_out, (int*)scal_out,
        (float*)K_out, (float*)hscale_out, n, m, np, mp, max_iter);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block of each of the four GI kernels.
extern "C" size_t jrlqp_gi_smem_bytes(int np, int mp) {
  return smem_layout(np, mp, nullptr, nullptr);
}

// Threads per block of the four GI kernels.
extern "C" int jrlqp_gi_threads(void) { return kThreads; }

// Resident blocks per SM of GI kernel `which` (0 K1, 1 K3, 2 K4, 3 K9) at
// the padded sizes (np, mp), or minus the CUDA error code.
extern "C" int jrlqp_gi_blocks_per_sm(int which, int np, int mp) {
  const size_t smem = smem_layout(np, mp, nullptr, nullptr);
  switch (which) {
    case 0: return blocks_per_sm(gi_fused_kernel, smem);
    case 1: return blocks_per_sm(gi_loop_kernel, smem);
    case 2: return blocks_per_sm(gi_warm_kernel, smem);
    case 3: return blocks_per_sm(gi_compact_kernel, smem);
    default: return -(int)cudaErrorInvalidValue;
  }
}
