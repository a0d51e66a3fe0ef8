// chol_inv_b: the block helpers of block_llt.cuh (K2) on a batch of
// (s, s) f32 blocks, one thread block per block. Exposes the device
// functions that the fused GI kernel uses, so they can be checked alone.
#include <cuda_runtime.h>

#include "block_llt.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
chol_inv_b_kernel(const float* __restrict__ A, float* __restrict__ L,
                  float* __restrict__ Li, int* __restrict__ posdef, int s) {
  extern __shared__ float smem[];
  float* a = smem;          // s x s, factored in place into L
  float* x = smem + s * s;  // s x s, L^-1
  const long off = (long)blockIdx.x * s * s;
  for (int e = threadIdx.x; e < s * s; e += blockDim.x) a[e] = A[off + e];
  jrlqp::chol_inv_block(a, s, x, s, s);
  for (int e = threadIdx.x; e < s * s; e += blockDim.x) {
    L[off + e] = a[e];
    Li[off + e] = x[e];
  }
  const bool pd = jrlqp::posdef_from_diag(a, s, s);
  if (threadIdx.x == 0) posdef[blockIdx.x] = pd ? 1 : 0;
}

}  // namespace

extern "C" int jrlqp_chol_inv_b(const void* A, void* L, void* Li,
                                void* posdef, int B, int s, void* stream) {
  const size_t smem = 2 * (size_t)s * s * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chol_inv_b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    chol_inv_b_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)A, (float*)L, (float*)Li, (int*)posdef, s);
  return (int)cudaGetLastError();
}

extern "C" const char* jrlqp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
