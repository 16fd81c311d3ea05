// Flash-attention forward block update for Hopper (sm_90a).
//
// Replaces: horovod_tpu/ops/flash.py `_flash_kernel` (flash.py:97), launched
// by `_flash_call` (flash.py:204) under `block_attend`. One online-softmax
// update of the carries (m, l, acc) by one K/V block:
//   s = q . k^T (causal and length masked to -1e30), m' = max(m, rowmax s),
//   p = exp(s - m') with masked entries zeroed, l' = l e^(m - m') + sum p,
//   acc' = acc e^(m - m') + p . v.
//
// What bounds it on the H100: the two products, 4 d flops per unmasked
// (query, key) pair, and the fp32 carries, read and written once. At the
// training shape (bh 64, s 2048, d 64, bf16, causal) that is 34 GFLOP and
// 120 MB: 35 us at the bf16 tensor-core peak against 36 us at 3.35 TB/s,
// a near tie. This version does its products with fp32 FMAs, so its own
// ceiling is the 67 TFLOP/s fp32 peak (0.5 ms), and one shared-memory
// load per two FMAs in its inner loops keeps it below that.
//
// Design: the Pallas grid carried its scratch from one kv grid step to the
// next on one core; here one block owns one (bh, 64-row query tile) and
// loops over the 64-row key tiles itself, keeping m, l and its slice of acc
// in registers, so nothing crosses blocks and no atomics are needed. Tiles
// past the causal diagonal are skipped (the update they would make is the
// identity). Ragged edges are masked by bounds (flash_common.cuh `keep`),
// not padded. This first version multiplies with fp32 FMAs from shared
// memory, not tensor cores: right and simple before fast (wgmma and TMA
// are later work).
#include "flash_common.cuh"

namespace hvdflash {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ m_in,
                     const float* __restrict__ l_in,
                     const float* __restrict__ acc_in,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     float* __restrict__ acc_out, int sq, int sk, int qpos0,
                     int kpos0, int causal) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x LD
  float* Ks = Qs + BQ * LD;    // BK x LD
  float* Vs = Ks + BK * LD;    // BK x LD
  float* Ps = Vs + BK * LD;    // BQ x PLD
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  q += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  const size_t rows = (size_t)bh * sq;  // first (bh, row) index of this bh

  load_tile<T, D, BQ>(Qs, q, q0, sq);
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const bool ok = r < sq;
    m[i] = ok ? m_in[rows + r] : NEG_INF;
    l[i] = ok ? l_in[rows + r] : 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      acc[i][jj] = ok ? acc_in[(rows + r) * D + tx + 16 * jj] : 0.f;
  }
  const int q_last = min(q0 + BQ, sq) - 1;
  for (int k0 = 0; k0 < sk; k0 += BK) {
    // every key of this tile and the later ones is after every query
    if (causal && (long long)kpos0 + k0 > (long long)qpos0 + q_last) break;
    __syncthreads();  // the last tile's Ks/Vs/Ps are no longer read
    load_tile<T, D, BK>(Ks, k, k0, sk);
    load_tile<T, D, BK>(Vs, v, k0, sk);
    __syncthreads();
    float s[4][4];
    dot_nt<D>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!keep(r, k0 + tx + 16 * j, sq, sk, qpos0, kpos0, causal))
          s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // masked entries stay 0 even while m_new is still the sentinel
        const float p = s[i][j] > NEG_INF * 0.5f ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vv[jj] = Vs[c * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
          acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    if (tx == 0) {
      m_out[rows + r] = m[i];
      l_out[rows + r] = l[i];
    }
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      acc_out[(rows + r) * D + tx + 16 * jj] = acc[i][jj];
  }
}

// Dynamic shared memory of one block: Qs, Ks, Vs and Ps.
template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * PLD) * (int)sizeof(float);
}

template <typename T, int D>
cudaError_t run(const void* q, const void* k, const void* v, const float* m,
                const float* l, const float* acc, float* mo, float* lo,
                float* acco, int bh, int sq, int sk, int qpos0, int kpos0,
                int causal, cudaStream_t stream) {
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  return launch(flash_fwd_kernel<T, D>, grid, smem_bytes<D>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), m, l, acc, mo, lo, acco, sq, sk,
                qpos0, kpos0, causal);
}

}  // namespace hvdflash

// Dynamic shared memory per block at head dim d (-1: not built for d).
extern "C" int hvd_flash_fwd_smem_bytes(int d) {
  using namespace hvdflash;
  return d == 64 ? smem_bytes<64>() : d == 128 ? smem_bytes<128>() : -1;
}

// q (bh, sq, d) pre-scaled, k/v (bh, sk, d), all bf16 (is_bf16) or fp32;
// m/l (bh, sq) and acc (bh, sq, d) fp32 in; mo/lo/acco the same shapes out.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             const float* m, const float* l, const float* acc,
                             float* mo, float* lo, float* acco, int bh, int sq,
                             int sk, int d, int qpos0, int kpos0, int causal,
                             int is_bf16, void* stream) {
  using namespace hvdflash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || sq < 1 || sk < 1 || (sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (d == 64 && is_bf16)
    return (int)run<__nv_bfloat16, 64>(q, k, v, m, l, acc, mo, lo, acco, bh,
                                       sq, sk, qpos0, kpos0, causal, s);
  if (d == 64)
    return (int)run<float, 64>(q, k, v, m, l, acc, mo, lo, acco, bh, sq, sk,
                               qpos0, kpos0, causal, s);
  if (d == 128 && is_bf16)
    return (int)run<__nv_bfloat16, 128>(q, k, v, m, l, acc, mo, lo, acco, bh,
                                        sq, sk, qpos0, kpos0, causal, s);
  if (d == 128)
    return (int)run<float, 128>(q, k, v, m, l, acc, mo, lo, acco, bh, sq, sk,
                                qpos0, kpos0, causal, s);
  return (int)cudaErrorInvalidValue;
}
