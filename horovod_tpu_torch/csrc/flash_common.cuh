// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): tile sizes, the thread layout, the
// masking rule and the shared-memory tile loaders.
//
// Layout of every kernel: a block of 256 threads works on one 64 x 64 score
// tile at a time. Thread (ty, tx) = (tid / 16, tid % 16) owns score rows
// ty + 16 i and score columns tx + 16 j, i, j < 4, so the 16 threads that
// share a row are one half-warp and reduce over the row with shuffles.
// Tiles live in shared memory as float with a row stride of D + 1, which
// keeps the 16 row reads of a half-warp on 16 different banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hvdflash {

constexpr float NEG_INF = -1e30f;  // the JAX package's sentinel, not -inf
constexpr int BQ = 64;             // query rows per tile
constexpr int BK = 64;             // key rows per tile
constexpr int NT = 256;            // threads per block
constexpr int PLD = BK + 1;        // row stride of a shared score tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The value of x after a cast to T and back (the Pallas kernels cast p and
// ds to the input dtype before their second product).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows [row0, row0 + ROWS) of a row-major (n, D) matrix into a shared tile
// of stride D + 1, as float; rows at or past n read as zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
    const int r = idx / D, c = idx - r * D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < n ? to_f(src[(size_t)g * D + c]) : 0.f;
  }
}

// s[i][j] = sum_k A[ty + 16 i][k] * B[tx + 16 j][k] over two shared tiles of
// stride D + 1: one 64 x 64 block of A . B^T, 16 entries per thread.
template <int D>
__device__ __forceinline__ void dot_nt(const float* A, const float* B,
                                       float s[4][4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int k = 0; k < D; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// THE masking rule of all three kernels (the twin of the JAX package's
// _tile_causal_mask and _tile_pad_mask): query row qr of sq and key row kc
// of sk take part unless either lies past its length or, when causal, the
// key's global position lies after the query's. Positions are int32
// offsets plus row indices, compared in 64 bits.
__device__ __forceinline__ bool keep(int qr, int kc, int sq, int sk,
                                     int qpos0, int kpos0, int causal) {
  return qr < sq && kc < sk &&
         (!causal || (long long)qpos0 + qr >= (long long)kpos0 + kc);
}

// Reductions over the 16 threads (one half-warp) that share a score row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory, then launch.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, NT, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace hvdflash

extern "C" const char* hvd_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
