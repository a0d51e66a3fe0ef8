// What K11's two instances share: the streamed one (fast_loop.cu) and the
// on-chip one (fast_loop_onchip.cuh). The block reductions' scratch and
// fixed trees, and the shared bytes of the vectors each block keeps.
#pragma once

#include <climits>
#include <cmath>

#include "loop_common.cuh"

namespace {

using namespace jrlqp;

template <typename T, int Warps>
struct Scratch {
  T sum[Warps][4];
  T av[Warps];
  int ai[Warps], as[Warps];
};

// The block's first minimum, on every thread; one barrier
template <typename T, int Warps>
__device__ void block_argmin(T& v, int& i, int& s, Scratch<T, Warps>& sh) {
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
  for (int w = 1; w < Warps; ++w)
    if (before(sh.av[w], sh.ai[w], v, i)) {
      v = sh.av[w];
      i = sh.ai[w];
      s = sh.as[w];
    }
}

// Four block sums, on every thread, in a fixed tree; one barrier
template <typename T, int Warps>
__device__ void block_sum4(T (&v)[4], Scratch<T, Warps>& sh) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = warp_sum(v[k]);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
    for (int k = 0; k < 4; ++k) sh.sum[warp][k] = v[k];
  __syncthreads();
  for (int k = 0; k < 4; ++k) {
    T acc = sh.sum[0][k];
    for (int w = 1; w < Warps; ++w) acc += sh.sum[w][k];
    v[k] = acc;
  }
}

// dynamic shared bytes of the streamed instance's vectors (the file head of
// fast_loop.cu)
template <typename T>
__host__ __device__ size_t smem_bytes(int n, int m) {
  const size_t b = (8 * (size_t)n + 2 + m) * sizeof(T) +
                   (m + 3 * (size_t)n) * 4;
  return (b + 15) / 16 * 16;
}

}  // namespace
