// K12: the carry init of the explicit-form engine's warm step, one thread
// block per problem, in f32 (jrlqp_carry_init): the structured trajectory's
// warm step (solve_structured_fast_carry) starts its loop (K11) from it.
//
// It replaces the JAX package's warm init from a carried operator,
// _init_fast_from_carry (jrlqp_tpu/solver/fast.py:971-1009), and the
// lax.while_loop of its deactivations, _deactivate_negative_u (:851-895).
// XLA compiles both; there is no Pallas kernel behind them. Its plain
// version is _init_fast_from_carry in jrlqp_tpu_torch/solver/fast.py, which
// runs a round of masked torch ops over the whole batch per deactivation,
// each ending in a host read, and rewrites the (B, n, n) H and N* in every
// round, whether or not a lane deactivates in it.
//
// Per problem, from the carried H, N*, status, aorder and q (the previous
// step's final state) and the new problem's a and bounds:
// - the carried slots compacted: a stable sort of the slots with the holes
//   (aorder -1) last, over aorder and the rows of N*;
// - the closed form through the carried operators: b_act the signed bounds
//   of the slots k < q, x = N*^T b_act - H a, u = N* (a + G x) on the
//   slots k < q, f = x^T G x / 2 + a^T x, hscale = trace(H);
// - the deactivations: while the most negative multiplier of the removable
//   slots (not EQUALITY, not FIXED; the first minimum, NaN first, as
//   torch.argmin) is below zero, the rank-one removal of its slot l
//   (w = N* G n_l, H += n_l n_l^T / w_l, the rows of N* after l less
//   (w_k / w_l) n_l and shifted down, aorder, status and b_act with them),
//   then the closed form on the reduced set, nb = N*^T b_act, x = nb - H a,
//   u = N* (a + G nb), and one iteration counted. Every negative
//   multiplier goes, where the JAX init keeps those in [-1e-5, 0): see
//   _CARRY_UTOL in solver/fast.py. Only a lane that deactivates pays for a
//   round; the others leave the loop at once.
//
// What bounds it: bytes. At the IK width (n = 387, f32) H, G and N* are
// 599 KB each a problem, beyond a block's shared memory. Each input is
// needed once and each output written once: H read and written (the state
// takes its own copy: the carry may be stepped from again), G read for G x,
// the q valid rows of N* read and all n rows of the state's N* written
// (rows from q on zero, which K11 relies on): 4 n^2 + q n words, 2.44 MB a
// problem at q = 31, 2.50 GB at the batch of 1,024 of the benchmark cell
// ik9x43-track, 0.75 ms at 3.35 TB/s (carry_init_bytes in
// ops/cuda/carry_init.py). A round of a deactivating lane streams G twice
// (G n_l, then G nb and G x in one pass) and reads and writes H once more:
// 4 n^2 words, 2.4 MB (carry_init_stream_bytes). The design:
// - G is read dense, as the plain version reads it and as K11 reads it,
//   not by the structured batch's blocks (126 KB a problem in f32 at
//   9 x 43): the kernel then takes any carried problem, and the blocks
//   would save one pass of 0.47 MB a problem, about 0.15 ms a step;
// - the copy of H and the removal's rank-one update run a warp per row,
//   eight loads of each thread in flight, and H a is summed from the row
//   just written, so x needs no further pass over H;
// - the first R rows of N* (R from the shared memory of two blocks an SM:
//   60 at n = 387, where q <= m = 36), x, u, b_act, a, the products with G
//   and the removal's vectors live in shared memory; a row k >= R (a
//   problem with more active constraints than that) stays in the state's
//   N* in device memory, read and written in place;
// - every dot product is one warp's: the lanes stride the row and a
//   butterfly sums them; block sums and the argmin go through a fixed
//   tree; no atomics, so a problem's result depends neither on the batch
//   size nor on its place in the batch;
// - the elementwise updates (H, N*) round each product and sum apart, as
//   the plain version's tensors do; only the order of the dot products'
//   sums differs from it, so the two agree to rounding.
#include <climits>
#include <cmath>

#include "loop_common.cuh"

namespace {

using namespace jrlqp;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// the dynamic shared memory of one block, so that two fit an SM
constexpr int kSmemTarget = 114688;

struct Scratch {
  float sum[kWarps][2];
  float av[kWarps];
  int ai[kWarps];
  int count;
};

// Two block sums, on every thread, in a fixed tree
__device__ void block_sum2(float& v0, float& v1, Scratch& sh) {
  v0 = warp_sum(v0);
  v1 = warp_sum(v1);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh.sum[warp][0] = v0;
    sh.sum[warp][1] = v1;
  }
  __syncthreads();
  v0 = sh.sum[0][0];
  v1 = sh.sum[0][1];
  for (int w = 1; w < kWarps; ++w) {
    v0 += sh.sum[w][0];
    v1 += sh.sum[w][1];
  }
  __syncthreads();  // sh may be written again
}

// The block's first minimum (NaN first), on every thread
__device__ void block_argmin(float& v, int& i, Scratch& sh) {
  int unused = 0;
  warp_argmin(v, i, unused);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh.av[warp] = v;
    sh.ai[warp] = i;
  }
  __syncthreads();
  v = sh.av[0];
  i = sh.ai[0];
  for (int w = 1; w < kWarps; ++w)
    if (before(sh.av[w], sh.ai[w], v, i)) {
      v = sh.av[w];
      i = sh.ai[w];
    }
  __syncthreads();
}

// o0[i] = M_i . v0 (and o1[i] = M_i . v1 with kTwo) for rows [0, rows),
// a warp per row, row i at row(i); lane 0 writes
template <bool kTwo, typename Row>
__device__ void rows_dot(Row row, const float* v0, const float* v1,
                         float* o0, float* o1, int rows, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int i = warp; i < rows; i += kWarps) {
    const float* Mi = row(i);
    float acc0 = 0.f, acc1 = 0.f;
    int j = lane;
#pragma unroll 1
    for (; j + 224 < n; j += 256) {
      float r[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) r[t] = Mi[j + 32 * t];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        acc0 = fmaf(r[t], v0[j + 32 * t], acc0);
        if (kTwo) acc1 = fmaf(r[t], v1[j + 32 * t], acc1);
      }
    }
#pragma unroll 4
    for (; j < n; j += 32) {
      const float r = Mi[j];
      acc0 = fmaf(r, v0[j], acc0);
      if (kTwo) acc1 = fmaf(r, v1[j], acc1);
    }
    acc0 = warp_sum(acc0);
    if (kTwo) acc1 = warp_sum(acc1);
    if (lane == 0) {
      o0[i] = acc0;
      if (kTwo) o1[i] = acc1;
    }
  }
}

// out_ij = op(i, j, in_ij) over the n x n slab, a warp per row, and
// ha_i = out_i . a; in and out may be the same slab
template <typename Op>
__device__ void stream_rows(const float* in, float* out, const float* a,
                            float* ha, int n, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int i = warp; i < n; i += kWarps) {
    const float* Ii = in + (size_t)i * n;
    float* Oi = out + (size_t)i * n;
    float acc = 0.f;
    int j = lane;
#pragma unroll 1
    for (; j + 224 < n; j += 256) {
      float r[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) r[t] = Ii[j + 32 * t];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int c = j + 32 * t;
        const float y = op(i, c, r[t]);
        Oi[c] = y;
        acc = fmaf(y, a[c], acc);
      }
    }
#pragma unroll 4
    for (; j < n; j += 32) {
      const float y = op(i, j, Ii[j]);
      Oi[j] = y;
      acc = fmaf(y, a[j], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) ha[i] = acc;
  }
}

size_t smem_bytes(int n, int m, int rows) {
  // a, x, H a, b_act, u (n + 1), two products, n_l, w; the rows of N*;
  // status (m + n), aorder and two int scratch vectors
  const size_t b = (9 * (size_t)n + 1 + (size_t)rows * n) * sizeof(float) +
                   (m + 4 * (size_t)n) * sizeof(int);
  return (b + 15) / 16 * 16;
}

int smem_rows(int n, int m) {
  const long base = (long)smem_bytes(n, m, 0);
  const long rows = ((long)kSmemTarget - base) / (4L * n);
  return (int)(rows < 0 ? 0 : (rows > n ? n : rows));
}

// The problem: G (B, n, n), l and u (B, m), xl and xu (B, n), a (B, n); the
// carry: H and Ns (B, n, n), status (B, m + n), aorder (B, n), q (B), read
// only. The state, in the wrapper's fresh tensors: x (B, n), f (B), H and
// Ns (B, n, n), status (B, m + n), aorder (B, n), u (B, n + 1), scal (B, 6),
// hscale (B). R rows of N* in shared memory.
__global__ void __launch_bounds__(kThreads, 2)
    carry_init_kernel(const float* __restrict__ G_,
                      const float* __restrict__ lo_,
                      const float* __restrict__ up_,
                      const float* __restrict__ xl_,
                      const float* __restrict__ xu_,
                      const float* __restrict__ a_,
                      const float* __restrict__ Hin_,
                      const float* __restrict__ Nsin_,
                      const int* __restrict__ status_in_,
                      const int* __restrict__ aorder_in_,
                      const int* __restrict__ q_in_, float* __restrict__ x_,
                      float* __restrict__ f_, float* __restrict__ H_,
                      float* __restrict__ Ns_, int* __restrict__ status_,
                      int* __restrict__ aorder_, float* __restrict__ u_,
                      int* __restrict__ scal_, float* __restrict__ hscale_,
                      int n, int m, int R) {
  using A = Ar<float>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Scratch sh;
  float* a = reinterpret_cast<float*>(smem_raw);  // n
  float* x = a + n;                               // n
  float* ha = x + n;                              // n: H a
  float* bb = ha + n;                             // n: b_act by slot
  float* u = bb + n;                              // n + 1
  float* g0 = u + n + 1;                          // n: a product with G
  float* g1 = g0 + n;                             // n: a + G x; n_l / w_l
  float* nl = g1 + n;                             // n: n_l
  float* w = nl + n;                              // n: w, then w / w_l
  float* Nsm = w + n;                             // R rows of N*
  int* status = reinterpret_cast<int*>(Nsm + (size_t)R * n);  // m + n
  int* aorder = status + m + n;                               // n
  int* t0 = aorder + n;                                       // n
  int* t1 = t0 + n;                                           // n

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int mt = m + n;
  const size_t nn = (size_t)n * n;
  const float* G = G_ + b * nn;
  const float* Hin = Hin_ + b * nn;
  const float* Nsin = Nsin_ + b * nn;
  const float* lo = lo_ + (size_t)b * m;
  const float* up = up_ + (size_t)b * m;
  const float* xl = xl_ + (size_t)b * n;
  const float* xu = xu_ + (size_t)b * n;
  float* H = H_ + b * nn;
  float* Nso = Ns_ + b * nn;
  auto row = [&](int k) -> float* {
    return k < R ? Nsm + (size_t)k * n : Nso + (size_t)k * n;
  };

  for (int k = tid; k < n; k += kThreads) {
    a[k] = a_[(size_t)b * n + k];
    t0[k] = aorder_in_[(size_t)b * n + k];
  }
  for (int i = tid; i < mt; i += kThreads)
    status[i] = status_in_[(size_t)b * mt + i];
  int q = q_in_[b];
  __syncthreads();

  // ---- the slots compacted: a stable sort, the holes last ----
  if (warp == 0) {
    int run = 0;  // valid slots before this chunk
    for (int base = 0; base < n; base += 32) {
      const int k = base + lane;
      const bool valid = k < n && t0[k] >= 0;
      const unsigned bal = __ballot_sync(kFull, valid);
      if (k < n) t1[k] = run + __popc(bal & ((1u << lane) - 1u));
      run += __popc(bal);
    }
    if (lane == 0) sh.count = run;
  }
  __syncthreads();
  const int nvalid = sh.count;
  for (int k = tid; k < n; k += kThreads) {
    const int p = t1[k];
    aorder[t0[k] >= 0 ? p : nvalid + k - p] = k;  // the order
  }
  __syncthreads();
  for (int k = tid; k < n; k += kThreads) t1[k] = aorder[k];
  __syncthreads();
  for (int k = tid; k < n; k += kThreads) aorder[k] = t0[t1[k]];
  const int qc = min(max(q, 0), n);
  // the valid rows of N* in their new order
#pragma unroll 1
  for (int k = warp; k < qc; k += kWarps) {
    const float* src = Nsin + (size_t)t1[k] * n;
    float* dst = row(k);
    for (int j = lane; j < n; j += 32) dst[j] = src[j];
  }
  __syncthreads();  // aorder compacted

  // ---- b_act: the signed bound of each slot ----
  for (int k = tid; k < n; k += kThreads) {
    float bk = 0.f;
    if (k < q) {
      const int idx = aorder[k];
      const int st = status[min(max(idx, 0), mt - 1)];
      float bound = 0.f;
      if (st >= LOWER_BOUND) {
        const int bi = min(max(idx - m, 0), n - 1);
        bound = st == UPPER_BOUND ? xu[bi] : xl[bi];
      } else if (m > 0) {
        const int ci = min(max(idx, 0), m - 1);
        bound = st == UPPER ? up[ci] : lo[ci];
      }
      bk = (st == UPPER || st == UPPER_BOUND) ? -bound : bound;
    }
    bb[k] = bk;
  }

  // ---- the state's H: a copy of the carried one, H a, trace(H) ----
  stream_rows(Hin, H, a, ha, n,
              [](int, int, float h) -> float { return h; });
  float tr = 0.f, unused = 0.f;
  for (int i = tid; i < n; i += kThreads) tr += Hin[(size_t)i * n + i];
  block_sum2(tr, unused, sh);  // its barrier: H a and b_act complete
  const float hscale = tr;

  // ---- the closed form: x = N*^T b - H a, u = N* (a + G x) ----
  for (int j = tid; j < n; j += kThreads) {
    float s = 0.f;
    for (int k = 0; k < qc; ++k) s = fmaf(bb[k], row(k)[j], s);
    x[j] = A::sub(s, ha[j]);
  }
  __syncthreads();
  auto grow = [&](int i) -> const float* { return G + (size_t)i * n; };
  rows_dot<false>(grow, x, nullptr, g0, nullptr, n, n);
  __syncthreads();
  float fx = 0.f, fa = 0.f;
  for (int j = tid; j < n; j += kThreads) {
    g1[j] = A::add(a[j], g0[j]);
    fx = fmaf(x[j], g0[j], fx);
    fa = fmaf(a[j], x[j], fa);
  }
  block_sum2(fx, fa, sh);
  float f = A::add(A::mul(0.5f, fx), fa);
  rows_dot<false>(row, g1, nullptr, u, nullptr, qc, n);
  for (int k = qc + tid; k <= n; k += kThreads) u[k] = 0.f;
  __syncthreads();

  // ---- the deactivations, the most negative multiplier first ----
  int it = 0;
  while (true) {
    float bv = INFINITY;
    int bl = INT_MAX;
    for (int k = tid; k < n; k += kThreads) {
      const bool valid = k < q;
      const int st = status[min(max(valid ? aorder[k] : 0, 0), mt - 1)];
      const bool elig = valid && st != EQUALITY && st != FIXED;
      const float v = elig ? u[k] : 0.f;
      if (before(v, k, bv, bl)) {
        bv = v;
        bl = k;
      }
    }
    block_argmin(bv, bl, sh);
    if (!(bv < 0.f)) break;
    const int l = bl, q_old = q, q_new = q - 1;
    for (int j = tid; j < n; j += kThreads) nl[j] = row(l)[j];
    __syncthreads();
    rows_dot<false>(grow, nl, nullptr, g0, nullptr, n, n);  // G n_l
    __syncthreads();
    rows_dot<false>(row, g0, nullptr, w, nullptr, q_old, n);  // w = N* G n_l
    __syncthreads();
    const float wl = w[l];
    const float wls = (wl > 0.f || wl < 0.f) ? wl : 1.f;
    const int rem = min(max(aorder[l], 0), mt - 1);
    __syncthreads();  // w_l and aorder[l] read by every thread
    for (int j = tid; j < n; j += kThreads) {
      g1[j] = A::div(nl[j], wls);
      w[j] = j < q_old && j != l ? A::div(w[j], wls) : 0.f;
      const int src = j >= l && j < q_new ? j + 1 : j;
      t0[j] = j == min(max(q_new, 0), n - 1) ? -1 : aorder[min(src, n - 1)];
      x[j] = j >= q_new ? 0.f : bb[min(src, n - 1)];  // b_act shifted
    }
    __syncthreads();
    // H += n_l (n_l / w_l)^T and H a
    stream_rows(H, H, a, ha, n, [&](int i, int j, float h) -> float {
      return A::add(h, A::mul(nl[i], g1[j]));
    });
    // N*: row k < q_new is old row src (k, or k + 1 from l on) less
    // (w_src / w_l) n_l; row q_new is cleared. Each thread runs down its
    // columns, reading a row before writing the one above
    for (int j = tid; j < n; j += kThreads) {
      const float nlj = nl[j];
      for (int k = 0; k < q_new; ++k) {
        const int src = k >= l ? k + 1 : k;
        row(k)[j] = A::sub(row(src)[j], A::mul(w[src], nlj));
      }
      if (q_new >= 0 && q_new < n) row(q_new)[j] = 0.f;
      aorder[j] = t0[j];
      bb[j] = x[j];
    }
    if (tid == 0) status[rem] = INACTIVE;
    q = q_new;
    __syncthreads();
    // the closed form on the reduced set: nb = N*^T b, x = nb - H a,
    // u = N* (a + G nb), f from G x
    for (int j = tid; j < n; j += kThreads) {
      float s = 0.f;
      for (int k = 0; k < q; ++k) s = fmaf(bb[k], row(k)[j], s);
      g1[j] = s;
      x[j] = A::sub(s, ha[j]);
    }
    __syncthreads();
    rows_dot<true>(grow, g1, x, g0, w, n, n);  // G nb, G x
    __syncthreads();
    fx = 0.f;
    fa = 0.f;
    for (int j = tid; j < n; j += kThreads) {
      g1[j] = A::add(a[j], g0[j]);
      fx = fmaf(x[j], w[j], fx);
      fa = fmaf(a[j], x[j], fa);
    }
    block_sum2(fx, fa, sh);
    f = A::add(A::mul(0.5f, fx), fa);
    rows_dot<false>(row, g1, nullptr, u, nullptr, q, n);
    if (tid == 0 && q >= 0 && q < n) u[q] = 0.f;
    it += 1;
    __syncthreads();
  }

  // ---- the state ----
  for (int k = tid; k < n; k += kThreads) {
    x_[(size_t)b * n + k] = x[k];
    aorder_[(size_t)b * n + k] = aorder[k];
  }
  for (int k = tid; k <= n; k += kThreads) u_[(size_t)b * (n + 1) + k] = u[k];
  for (int i = tid; i < mt; i += kThreads)
    status_[(size_t)b * mt + i] = status[i];
  const int qs = min(max(q, 0), n);
#pragma unroll 1
  for (int k = warp; k < n; k += kWarps) {
    float* dst = Nso + (size_t)k * n;
    if (k < qs && k < R) {
      const float* src = Nsm + (size_t)k * n;
      for (int j = lane; j < n; j += 32) dst[j] = src[j];
    } else if (k >= qs) {
      for (int j = lane; j < n; j += 32) dst[j] = 0.f;
    }
  }
  if (tid == 0) {
    f_[b] = f;
    hscale_[b] = hscale;
    int* so = scal_ + (size_t)b * kScal;
    so[kQ] = q;
    so[kIt] = it;
    so[kTerm] = RUNNING;
    so[kSkip1] = 0;
    so[kScIdx] = -1;
    so[kScSt] = 0;
  }
}

}  // namespace

// K12: f32 throughout; see carry_init_kernel for the layout.
extern "C" int jrlqp_carry_init(const void* G, const void* l, const void* u,
                                const void* xl, const void* xu,
                                const void* a, const void* H, const void* Ns,
                                const void* status, const void* aorder,
                                const void* q, void* x_out, void* f_out,
                                void* H_out, void* Ns_out, void* status_out,
                                void* aorder_out, void* u_out, void* scal,
                                void* hscale, int B, int n, int m,
                                void* stream) {
  const int rows = smem_rows(n, m);
  const size_t smem = smem_bytes(n, m, rows);
  cudaError_t err = cudaFuncSetAttribute(
      carry_init_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    carry_init_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)G, (const float*)l, (const float*)u, (const float*)xl,
        (const float*)xu, (const float*)a, (const float*)H, (const float*)Ns,
        (const int*)status, (const int*)aorder, (const int*)q, (float*)x_out,
        (float*)f_out, (float*)H_out, (float*)Ns_out, (int*)status_out,
        (int*)aorder_out, (float*)u_out, (int*)scal, (float*)hscale, n, m,
        rows);
  return (int)cudaGetLastError();
}

// threads, dynamic shared bytes, rows of N* in shared memory, resident
// blocks per SM, registers and local (spilled) bytes per thread at (n, m)
extern "C" int jrlqp_carry_init_config(int n, int m, int* out) {
  const int rows = smem_rows(n, m);
  const size_t smem = smem_bytes(n, m, rows);
  cudaError_t err = cudaFuncSetAttribute(
      carry_init_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, carry_init_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, carry_init_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = (int)smem;
  out[2] = rows;
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return 0;
}
