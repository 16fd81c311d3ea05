// Flash-attention forward block update for Hopper (sm_90a).
//
// Replaces: horovod_tpu/ops/flash.py `_flash_kernel` (flash.py:97), launched
// by `_flash_call` (flash.py:204) under `block_attend`. One online-softmax
// update of the carries (m, l, acc) by one K/V block:
//   s = q . k^T (causal and length masked to -1e30), m' = max(m, rowmax s),
//   p = exp(s - m') with masked entries zeroed, l' = l e^(m - m') + sum p,
//   acc' = acc e^(m - m') + p . v, p rounded to the input dtype for p . v.
//
// What bounds it on the H100: the two products, 4 d flops per unmasked
// (query, key) pair, and the fp32 carries, read and written once. At the
// training shape (bh 64, s 2048, d 64, bf16, causal) that is 34 GFLOP and
// 120 MB: 35 us at the bf16 tensor-core peak against 36 us at 3.35 TB/s,
// a near tie, so both the products and the carry traffic must run near
// their rates.
//
// bf16 design (flash_fwd_tc_kernel): the first version multiplied with
// fp32 FMAs from shared memory, one shared load per two FMAs, about 2.5 %
// of the tensor-core peak. Here both products are warpgroup tensor-core
// products (wgmma, flash_tc.cuh), fed by TMA:
// - one block per (bh, 128-row query tile), the latest (heaviest, under
//   causal masking) tiles launched first; two consumer warpgroups of 64
//   query rows each and one producer warp;
// - the producer loads the Q tile once and the K and V tiles (128 keys at
//   d = 64, 64 at d = 128) into a two-stage ring of 128-byte-swizzled
//   shared tiles (TMA, mbarriers), so loads run ahead of the products;
// - s = q . k^T is wgmma with both operands K-major in shared memory; the
//   online softmax works on the accumulator fragments in registers, a row
//   on the four threads of a quad, its exponentials one ex2.approx each;
//   p is rounded to bf16 and packed in
//   registers as the A operand of acc += p . v (V N-major, the transpose
//   bit), so p never touches shared memory;
// - the carries are read from and written to global memory straight in the
//   accumulator layout; only tiles on the causal diagonal or a ragged edge
//   evaluate the masking rule `keep`, and the loop stops at the diagonal.
// The fp32 instantiation (flash_fwd_kernel) keeps the first version's
// design: fp32 FMAs from shared memory, 64 x 64 tiles, 256 threads.
// Multi-head latent attention (q and k 192 wide, v 128; bf16 only): the
// same design, the Q and K tiles three 64-column panels wide and V two, 64
// keys a ring tile; s takes 12 k16 steps and p . v 4, acc 64 registers a
// thread as at d = 128. 131 KB of shared memory a block.
#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace hvdflash {

// ---- fp32: the first version ------------------------------------------------

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

template <int D>
cudaError_t run_f32(const void* q, const void* k, const void* v,
                    const float* m, const float* l, const float* acc,
                    float* mo, float* lo, float* acco, int bh, int sq, int sk,
                    int qpos0, int kpos0, int causal, cudaStream_t stream) {
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  return launch(flash_fwd_kernel<float, D>, grid, NT, smem_bytes<D>(), stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), m, l, acc, mo, lo, acco, sq, sk,
                qpos0, kpos0, causal);
}

// ---- bf16: warpgroup tensor-core products fed by TMA ------------------------

namespace fwd_tc {

constexpr int NWG = 2;             // consumer warpgroups, 64 query rows each
constexpr int TQ = NWG * 64;       // query rows per block
constexpr int THREADS = NWG * 128 + 32;  // + one producer warp

// Shared memory, in bytes from a 1024-aligned base: the Q tile, the K and V
// rings, then the barriers (q_full, full[STAGES], empty[STAGES]). DQK is
// the head width of q and k, DV that of v (equal, or 192 / 128 for
// multi-head latent attention).
template <int DQK, int DV = DQK>
struct Smem {
  // keys a ring tile: 128 at d = 64 (fewer barrier and product round trips
  // a key); 64 at d = 128 and 192, where acc takes 64 registers a thread
  static constexpr int TK = DQK == 64 ? 128 : 64;
  static constexpr int STAGES = 2;  // K/V ring depth
  static constexpr int Q_BYTES = TQ * DQK * 2;
  static constexpr int K_BYTES = TK * DQK * 2;  // one K tile
  static constexpr int V_BYTES = TK * DV * 2;   // one V tile
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;
  static constexpr int V = K + STAGES * K_BYTES;
  static constexpr int BAR = V + STAGES * V_BYTES;
  static constexpr int TOTAL = BAR + (1 + 2 * STAGES) * 8 + 1024;  // + align
};

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const float* __restrict__ m_in,
    const float* __restrict__ l_in, const float* __restrict__ acc_in,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ acc_out, int sq, int sk, int qpos0, int kpos0,
    int causal) {
  using namespace tc;
  using S = Smem<DQK, DV>;
  constexpr int TK = S::TK, STAGES = S::STAGES;
  constexpr int QK_PANELS = DQK / 64, V_PANELS = DV / 64, KSTEPS = DQK / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;  // heaviest tiles first
  const int q_last = min(q0 + TQ, sq) - 1;
  // key tiles up to the causal diagonal of the block's last query
  int n_tiles = (sk + TK - 1) / TK;
  if (causal) {
    const long long lim = (long long)qpos0 + q_last - kpos0;
    n_tiles = lim < 0 ? 0 : (int)min((long long)n_tiles, lim / TK + 1);
  }
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= NWG * 128) {  // the producer warp: one thread issues the TMA
    if (tid == NWG * 128 && n_tiles > 0) {
      mbar_arrive_expect_tx(q_full, S::Q_BYTES);
      for (int p = 0; p < QK_PANELS; ++p)
        tma_load_3d(smem + S::Q + p * TQ * 128, &qmap, q_full, p * 64, q0,
                    bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], S::K_BYTES + S::V_BYTES);
        for (int p = 0; p < QK_PANELS; ++p)
          tma_load_3d(smem + S::K + s * S::K_BYTES + p * TK * 128, &kmap,
                      &full[s], p * 64, t * TK, bh);
        for (int p = 0; p < V_PANELS; ++p)
          tma_load_3d(smem + S::V + s * S::V_BYTES + p * TK * 128, &vmap,
                      &full[s], p * 64, t * TK, bh);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; this thread
  // rows r0 and r0 + 8 of them (the accumulator layout)
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
  const size_t rows = (size_t)bh * sq;
  float m[2], l[2], o[DV / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const bool ok = r < sq;
    m[h] = ok ? m_in[rows + r] : NEG_INF;
    // l is summed over the quad at the end: its first thread carries l_in
    l[h] = ok && t4 == 0 ? l_in[rows + r] : 0.f;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const float2 a =
          ok ? *reinterpret_cast<const float2*>(acc_in + (rows + r) * DV +
                                                8 * j + 2 * t4)
             : make_float2(0.f, 0.f);
      o[4 * j + 2 * h] = a.x;
      o[4 * j + 2 * h + 1] = a.y;
    }
  }

  if (n_tiles > 0) mbar_wait(q_full, 0);
  const uint32_t q_tile = smem_u32(smem + S::Q);
  const long long qpos_first = (long long)qpos0 + q0 + wg * 64;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES, k0 = t * TK;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint32_t k_tile = smem_u32(smem + S::K + s * S::K_BYTES);
    const uint32_t v_tile = smem_u32(smem + S::V + s * S::V_BYTES);
    uint32_t qt = q_tile;
    // at 192 / 128, opaque to the compiler, so that it builds Q's twelve
    // descriptors in each iteration rather than holding them across the
    // loop (they spill past the 168 registers a thread has otherwise)
    if constexpr (DQK != DV) asm volatile("" : "+r"(qt));

    float sc[TK / 2];
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss(sc, desc_k(qt, TQ, wg * 64, kk), desc_k(k_tile, TK, 0, kk),
               kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sc);

    // only the diagonal and ragged-edge tiles evaluate the masking rule
    const bool masked = k0 + TK > sk ||
                        (causal && (long long)kpos0 + k0 + TK - 1 > qpos_first);
    if (masked) {
#pragma unroll
      for (int e = 0; e < TK / 2; ++e) {
        const int r = r0 + 8 * ((e % 4) / 2);
        const int c = k0 + 8 * (e / 4) + 2 * t4 + (e % 2);
        if (!keep(r, c, sq, sk, qpos0, kpos0, causal)) sc[e] = NEG_INF;
      }
    }
    float mx[2] = {m[0], m[1]}, corr[2], ms[2];
#pragma unroll
    for (int e = 0; e < TK / 2; ++e) {
      const int h = (e % 4) / 2;
      mx[h] = fmaxf(mx[h], sc[e]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = ex2((m[h] - mx[h]) * LOG2E);
      m[h] = mx[h];
      ms[h] = mx[h] * LOG2E;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < TK / 2; ++e) {
      const int h = (e % 4) / 2;
      // masked entries stay 0 even while m is still the sentinel
      float p = ex2(fmaf(sc[e], LOG2E, -ms[h]));
      if (masked && sc[e] <= NEG_INF * 0.5f) p = 0.f;
      sc[e] = p;
      rs[h] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) o[e] *= corr[(e % 4) / 2];

    uint32_t a[TK / 16][4];  // p in bf16, the A operand of p . v
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) pack_a(sc, kk, a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs(o, a[kk], desc_n(v_tile, TK, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(o);
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= sq) continue;
    if (t4 == 0) {
      m_out[rows + r] = m[h];
      l_out[rows + r] = l[h];
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<float2*>(acc_out + (rows + r) * DV + 8 * j + 2 * t4) =
          make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
  }
}

template <int DQK, int DV = DQK>
cudaError_t run(const void* q, const void* k, const void* v, const float* m,
                const float* l, const float* acc, float* mo, float* lo,
                float* acco, int bh, int sq, int sk, int qpos0, int kpos0,
                int causal, cudaStream_t stream) {
  using S = Smem<DQK, DV>;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t e;
  if ((e = tc::make_map(&qmap, q, true, DQK, sq, bh, 64, TQ, true)) ||
      (e = tc::make_map(&kmap, k, true, DQK, sk, bh, 64, S::TK, true)) ||
      (e = tc::make_map(&vmap, v, true, DV, sk, bh, 64, S::TK, true)))
    return e;
  const dim3 grid(bh, (sq + TQ - 1) / TQ);
  return launch(flash_fwd_tc_kernel<DQK, DV>, grid, THREADS, S::TOTAL,
                stream, qmap, kmap, vmap, m, l, acc, mo, lo, acco, sq,
                sk, qpos0, kpos0, causal);
}

}  // namespace fwd_tc
}  // namespace hvdflash

// Threads and dynamic shared memory per block at q/k head width d (0: not
// built for d); d = 192 is the multi-head latent attention pair, v 128,
// built for bf16 only.
extern "C" void hvd_flash_fwd_config(int d, int is_bf16, int* threads,
                                     int* smem) {
  using namespace hvdflash;
  const bool bf = is_bf16 != 0;
  *threads = bf ? fwd_tc::THREADS : NT;
  *smem = d == 64    ? (bf ? fwd_tc::Smem<64>::TOTAL : smem_bytes<64>())
          : d == 128 ? (bf ? fwd_tc::Smem<128>::TOTAL : smem_bytes<128>())
          : d == 192 && bf ? fwd_tc::Smem<192, 128>::TOTAL
                           : 0;
}

// q (bh, sq, d) pre-scaled, k (bh, sk, d), v (bh, sk, dv), all bf16
// (is_bf16) or fp32; m/l (bh, sq) and acc (bh, sq, dv) fp32 in; mo/lo/acco
// the same shapes out. (d, dv): (64, 64) and (128, 128), bf16 or fp32;
// (192, 128) bf16.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             const float* m, const float* l, const float* acc,
                             float* mo, float* lo, float* acco, int bh, int sq,
                             int sk, int d, int dv, int qpos0, int kpos0,
                             int causal, int is_bf16, void* stream) {
  using namespace hvdflash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || sq < 1 || sk < 1 || (sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (d == 192 && dv == 128 && is_bf16)
    return (int)fwd_tc::run<192, 128>(q, k, v, m, l, acc, mo, lo, acco, bh,
                                      sq, sk, qpos0, kpos0, causal, s);
  if (dv != d) return (int)cudaErrorInvalidValue;
  if (d == 64 && is_bf16)
    return (int)fwd_tc::run<64>(q, k, v, m, l, acc, mo, lo, acco, bh, sq, sk,
                                qpos0, kpos0, causal, s);
  if (d == 64)
    return (int)run_f32<64>(q, k, v, m, l, acc, mo, lo, acco, bh, sq, sk,
                            qpos0, kpos0, causal, s);
  if (d == 128 && is_bf16)
    return (int)fwd_tc::run<128>(q, k, v, m, l, acc, mo, lo, acco, bh, sq,
                                 sk, qpos0, kpos0, causal, s);
  if (d == 128)
    return (int)run_f32<128>(q, k, v, m, l, acc, mo, lo, acco, bh, sq, sk,
                             qpos0, kpos0, causal, s);
  return (int)cudaErrorInvalidValue;
}
