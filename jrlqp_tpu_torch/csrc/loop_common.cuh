// What the two GI loop kernels share: K10 (jr_kernel.cu, the J/R engine)
// and K11 (fast_loop.cu, the explicit-form engine). The status codes, the
// one-rounding-per-operation arithmetic of the plain versions' tensors, and
// the order of torch.minimum and torch.argmin, in warp reductions.
#pragma once

#include <cuda_runtime.h>

namespace jrlqp {

constexpr unsigned kFull = 0xffffffffu;

// ActivationStatus / TerminationStatus (jrlqp_tpu_torch/types.py)
constexpr int INACTIVE = 0, LOWER = 1, UPPER = 2, EQUALITY = 3,
              LOWER_BOUND = 4, UPPER_BOUND = 5, FIXED = 6;
constexpr int RUNNING = -1, SUCCESS = 0, INFEASIBLE = 3,
              MAX_ITER_REACHED = 4, LINEAR_DEPENDENCY_DETECTED = 5;

// the per-problem scalars, in the order of the wrappers' (B, 6) int32 rows
enum { kQ, kIt, kTerm, kSkip1, kScIdx, kScSt, kScal };

// One rounding per elementwise operation, as the plain versions' tensors
template <typename T>
struct Ar;
template <>
struct Ar<double> {
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double sqrt(double a) { return __dsqrt_rn(a); }
};
template <>
struct Ar<float> {
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float sqrt(float a) { return __fsqrt_rn(a); }
};

// torch.minimum: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a <= b ? a : b;
}

// torch.argmin's order: NaN first, then the smaller value, ties (and two
// NaNs) to the lower index
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a < b || (a == b && ia < ib);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// (v, i, s) of the warp's first minimum, on every lane
template <typename T>
__device__ __forceinline__ void warp_argmin(T& v, int& i, int& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    const int os = __shfl_xor_sync(kFull, s, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
      s = os;
    }
  }
}

}  // namespace jrlqp
