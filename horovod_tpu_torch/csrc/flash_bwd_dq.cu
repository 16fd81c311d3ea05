// Flash-attention backward, query gradient, for Hopper (sm_90a).
//
// Replaces: horovod_tpu/ops/flash.py `_flash_bwd_dq_kernel` (flash.py:268),
// launched by `flash_block_grads` (flash.py:390). For one K/V block against
// the full saved log-sum-exp:
//   p = exp(s - lse) with the forward's masks, dp = dO . v^T,
//   ds = p (dp - D), dq = sum over keys of ds . k,
// with D = rowsum(dO * O) computed by the caller.
//
// What bounds it on the H100: three products (s, dp, dq), 6 d flops per
// unmasked (query, key) pair; at the training shape 51 GFLOP against
// 118 MB, so arithmetic bounds it (52 us at the bf16 tensor-core peak).
// With fp32 FMAs, as here, the ceiling is the fp32 peak (0.8 ms).
//
// Design: one block owns one (bh, 64-row query tile) and loops over the key
// tiles, holding its slice of dq in registers until the end: each dq row
// has one owner, so there are no atomics and the result is deterministic.
// Key tiles past the causal diagonal are skipped; ragged edges are masked
// by bounds. ds is rounded to the input dtype before the dq product, as
// the Pallas kernel casts it. fp32 FMAs from shared memory, as in
// flash_fwd.cu.
#include "flash_common.cuh"

namespace hvdflash {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        const float* __restrict__ dout, float* __restrict__ dq,
                        int sq, int sk, int qpos0, int kpos0, int causal) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x LD
  float* Os = Qs + BQ * LD;    // BQ x LD  (dout)
  float* Ks = Os + BQ * LD;    // BK x LD
  float* Vs = Ks + BK * LD;    // BK x LD
  float* Ss = Vs + BK * LD;    // BQ x PLD (ds)
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  const size_t rows = (size_t)bh * sq;

  load_tile<T, D, BQ>(Qs, q, q0, sq);
  load_tile<float, D, BQ>(Os, dout, q0, sq);
  float lse_r[4], d_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < sq ? lse[rows + r] : 0.f;
    d_r[i] = r < sq ? dsum[rows + r] : 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }
  const int q_last = min(q0 + BQ, sq) - 1;
  for (int k0 = 0; k0 < sk; k0 += BK) {
    if (causal && (long long)kpos0 + k0 > (long long)qpos0 + q_last) break;
    __syncthreads();
    load_tile<T, D, BK>(Ks, k, k0, sk);
    load_tile<T, D, BK>(Vs, v, k0, sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_nt<D>(Qs, Ks, s, ty, tx);
    dot_nt<D>(Os, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool on = keep(r, k0 + tx + 16 * j, sq, sk, qpos0, kpos0, causal);
        const float p = on ? expf(s[i][j] - lse_r[i]) : 0.f;
        Ss[(ty + 16 * i) * PLD + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - d_r[i]));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[4], b[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ss[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) b[jj] = Ks[c * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      dq[(rows + r) * D + tx + 16 * jj] = acc[i][jj];
  }
}

// Dynamic shared memory of one block: Qs, Os, Ks, Vs and Ss.
template <int D>
constexpr int smem_bytes() {
  return (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * PLD) * (int)sizeof(float);
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, const float* lse,
                const float* dsum, const float* dout, float* dq, int bh,
                int sq, int sk, int qpos0, int kpos0, int causal,
                cudaStream_t stream) {
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  return launch(flash_bwd_dq_kernel<T, D>, grid, NT, smem_bytes<D>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), lse, dsum, dout, dq, sq, sk, qpos0,
                kpos0, causal);
}

}  // namespace hvdflash

// Threads and dynamic shared memory per block at head dim d (0: not built
// for d); one design for both dtypes.
extern "C" void hvd_flash_bwd_dq_config(int d, int is_bf16, int* threads,
                                        int* smem) {
  using namespace hvdflash;
  *threads = NT;
  *smem = d == 64 ? smem_bytes<64>() : d == 128 ? smem_bytes<128>() : 0;
}

// q (bh, sq, d), k/v (bh, sk, d), all bf16 (is_bf16) or fp32; lse and
// dsum = rowsum(dout * out) (bh, sq) fp32; dout (bh, sq, d) fp32;
// dq (bh, sq, d) fp32 out.
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const float* lse, const float* dsum,
                                const float* dout, float* dq, int bh, int sq,
                                int sk, int d, int qpos0, int kpos0,
                                int causal, int is_bf16, void* stream) {
  using namespace hvdflash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || sq < 1 || sk < 1 || (sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (d == 64 && is_bf16)
    return (int)run<__nv_bfloat16, 64>(q, k, v, lse, dsum, dout, dq, bh, sq,
                                       sk, qpos0, kpos0, causal, s);
  if (d == 64)
    return (int)run<float, 64>(q, k, v, lse, dsum, dout, dq, bh, sq, sk,
                               qpos0, kpos0, causal, s);
  if (d == 128 && is_bf16)
    return (int)run<__nv_bfloat16, 128>(q, k, v, lse, dsum, dout, dq, bh, sq,
                                        sk, qpos0, kpos0, causal, s);
  if (d == 128)
    return (int)run<float, 128>(q, k, v, lse, dsum, dout, dq, bh, sq, sk,
                                qpos0, kpos0, causal, s);
  return (int)cudaErrorInvalidValue;
}
