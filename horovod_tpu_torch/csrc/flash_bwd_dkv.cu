// Flash-attention backward, key and value gradients, for Hopper (sm_90a).
//
// Replaces: horovod_tpu/ops/flash.py `_flash_bwd_dkv_kernel` (flash.py:294),
// launched by `flash_block_grads` (flash.py:406). For one K/V block against
// the full saved log-sum-exp:
//   p = exp(s - lse) with the forward's masks, dv = sum over queries p^T . dO,
//   ds = p (dO . v^T - D), dk = sum over queries ds^T . q.
//
// What bounds it on the H100: four products (s, dp, dv, dk), 8 d flops per
// unmasked (query, key) pair; at the training shape 69 GFLOP against
// 152 MB, so arithmetic bounds it (70 us at the bf16 tensor-core peak).
// With fp32 FMAs, as here, the ceiling is the fp32 peak (1.0 ms).
//
// Design: the transpose of flash_bwd_dq.cu. One block owns one (bh, 64-row
// key tile), keeps its K and V tiles in shared memory and its slices of dk
// and dv in registers, and loops over the query tiles, skipping those that
// lie wholly before the tile on the causal diagonal. Each dk/dv row has one
// owner: no atomics, deterministic results. p enters the dv product in
// fp32 (dO is fp32, as the Pallas kernel casts p to dO's dtype) and ds
// enters the dk product rounded to the input dtype. fp32 FMAs from shared
// memory, as in flash_fwd.cu.
#include "flash_common.cuh"

namespace hvdflash {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         const float* __restrict__ dout,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int sq, int sk, int qpos0, int kpos0, int causal) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;            // BK x LD
  float* Vs = Ks + BK * LD;    // BK x LD
  float* Qs = Vs + BK * LD;    // BQ x LD
  float* Os = Qs + BQ * LD;    // BQ x LD  (dout)
  float* Ps = Os + BQ * LD;    // BQ x PLD (p)
  float* Ss = Ps + BQ * PLD;   // BQ x PLD (ds)
  const int bh = blockIdx.x, k0 = blockIdx.y * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  const size_t qrows = (size_t)bh * sq, krows = (size_t)bh * sk;

  load_tile<T, D, BK>(Ks, k, k0, sk);
  load_tile<T, D, BK>(Vs, v, k0, sk);
  // this thread's accumulators: key rows ty + 16 i, columns tx + 16 jj
  float gk[4][DJ], gv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) gk[i][jj] = gv[i][jj] = 0.f;
  for (int q0 = 0; q0 < sq; q0 += BQ) {
    const int q_last = min(q0 + BQ, sq) - 1;
    // every query of this tile is before every key of the key tile
    if (causal && (long long)qpos0 + q_last < (long long)kpos0 + k0) continue;
    __syncthreads();
    load_tile<T, D, BQ>(Qs, q, q0, sq);
    load_tile<float, D, BQ>(Os, dout, q0, sq);
    __syncthreads();
    // score layout: query rows ty + 16 i, key columns tx + 16 j
    float s[4][4], dp[4][4];
    dot_nt<D>(Qs, Ks, s, ty, tx);
    dot_nt<D>(Os, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      const float lse_r = r < sq ? lse[qrows + r] : 0.f;
      const float d_r = r < sq ? dsum[qrows + r] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool on = keep(r, k0 + tx + 16 * j, sq, sk, qpos0, kpos0, causal);
        const float p = on ? expf(s[i][j] - lse_r) : 0.f;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
        Ss[(ty + 16 * i) * PLD + tx + 16 * j] = round_to<T>(p * (dp[i][j] - d_r));
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pr[4], sr[4], o[DJ], x[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = Ps[r * PLD + ty + 16 * i];
        sr[i] = Ss[r * PLD + ty + 16 * i];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        o[jj] = Os[r * LD + tx + 16 * jj];
        x[jj] = Qs[r * LD + tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          gv[i][jj] = fmaf(pr[i], o[jj], gv[i][jj]);
          gk[i][jj] = fmaf(sr[i], x[jj], gk[i][jj]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= sk) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      dk[(krows + c) * D + tx + 16 * jj] = gk[i][jj];
      dv[(krows + c) * D + tx + 16 * jj] = gv[i][jj];
    }
  }
}

// Dynamic shared memory of one block: Ks, Vs, Qs, Os, Ps and Ss.
template <int D>
constexpr int smem_bytes() {
  return (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * PLD) *
         (int)sizeof(float);
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, const float* lse,
                const float* dsum, const float* dout, float* dk, float* dv,
                int bh, int sq, int sk, int qpos0, int kpos0, int causal,
                cudaStream_t stream) {
  const dim3 grid(bh, (sk + BK - 1) / BK);
  return launch(flash_bwd_dkv_kernel<T, D>, grid, smem_bytes<D>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), lse, dsum, dout, dk, dv, sq, sk,
                qpos0, kpos0, causal);
}

}  // namespace hvdflash

// Dynamic shared memory per block at head dim d (-1: not built for d).
extern "C" int hvd_flash_bwd_dkv_smem_bytes(int d) {
  using namespace hvdflash;
  return d == 64 ? smem_bytes<64>() : d == 128 ? smem_bytes<128>() : -1;
}

// Arguments as hvd_flash_bwd_dq; dk and dv (bh, sk, d) fp32 out.
extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const float* lse, const float* dsum,
                                 const float* dout, float* dk, float* dv,
                                 int bh, int sq, int sk, int d, int qpos0,
                                 int kpos0, int causal, int is_bf16,
                                 void* stream) {
  using namespace hvdflash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || sq < 1 || sk < 1 || (sk + BK - 1) / BK > 65535)
    return (int)cudaErrorInvalidValue;
  if (d == 64 && is_bf16)
    return (int)run<__nv_bfloat16, 64>(q, k, v, lse, dsum, dout, dk, dv, bh,
                                       sq, sk, qpos0, kpos0, causal, s);
  if (d == 64)
    return (int)run<float, 64>(q, k, v, lse, dsum, dout, dk, dv, bh, sq, sk,
                               qpos0, kpos0, causal, s);
  if (d == 128 && is_bf16)
    return (int)run<__nv_bfloat16, 128>(q, k, v, lse, dsum, dout, dk, dv, bh,
                                        sq, sk, qpos0, kpos0, causal, s);
  if (d == 128)
    return (int)run<float, 128>(q, k, v, lse, dsum, dout, dk, dv, bh, sq, sk,
                                qpos0, kpos0, causal, s);
  return (int)cudaErrorInvalidValue;
}
