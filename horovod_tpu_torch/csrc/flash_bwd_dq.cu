// Flash-attention backward, query gradient, for Hopper (sm_90a).
//
// Replaces: horovod_tpu/ops/flash.py `_flash_bwd_dq_kernel` (flash.py:268),
// launched by `flash_block_grads` (flash.py:390). For one K/V block against
// the full saved log-sum-exp:
//   p = exp(s - lse) with the forward's masks, dp = dO . v^T,
//   ds = p (dp - D), dq = sum over keys of ds . k,
// with D = rowsum(dO * O) computed by the caller, and ds rounded to the
// input dtype before the dq product, as the Pallas kernel casts it.
//
// What bounds it on the H100: three products (s, dp, dq), 6 d flops per
// unmasked (query, key) pair; at the training shape (bh 64, s 2048, d 64,
// bf16, causal) 52 GFLOP against 118 MB, so arithmetic bounds it (52 us at
// the bf16 tensor-core peak).
//
// bf16 design (flash_bwd_dq_tc_kernel): the first version ran all three
// products as fp32 FMAs from shared memory, about 2 % of the tensor-core
// peak. Here they are warpgroup tensor-core products (wgmma, flash_tc.cuh)
// with the queries as the M dimension, the K and V tiles fed by TMA:
// - one block per (bh, query tile), the latest (heaviest, under causal
//   masking) tiles launched first: 64 query rows per consumer warpgroup
//   (two at d = 64; one at d = 128, whose dq takes 64 registers a thread)
//   and one producer warp. dq accumulates in registers and each query row
//   has one owner, so no atomics and a deterministic result;
// - resident, loaded once per block: the Q tile (TMA), and dO, which each
//   consumer warpgroup reads from global memory and splits into three bf16
//   parts, dO = hi + mid + lo, written straight into the swizzled layout
//   (no fp32 staging tile); lse and D of each thread's two rows sit in
//   registers;
// - streamed: the producer warp loads the K and V tiles (64 keys) into a
//   ring (three stages at d = 64, two at d = 128; TMA, mbarriers) up to the
//   causal diagonal of the block's last query; a warpgroup whose rows end
//   earlier skips the products of the tiles past its own diagonal;
// - the products: s = Q . K^T and dp = dO . V^T = hi . V^T + mid . V^T +
//   lo . V^T (all operands K-major in shared memory; three parts keep
//   about 24 bits of dO, as the plain version's fp32 product does, so that
//   bf16(ds) lands on the other bf16 neighbour no more often than two fp32
//   sums in different orders make it), then dq += bf16(ds) . K with ds
//   from registers in the accumulator layout and K N-major through the
//   transpose bit (one K tile serves s and dq);
// - s and dp are committed as separate groups: p = exp(s - lse) (one
//   ex2.approx each) is computed while dp runs; only the diagonal and
//   ragged-edge tiles of each warpgroup evaluate the masking rule;
// - every row is written: rows of a block (or a warpgroup) that sees no
//   live key get zeros.
// The fp32 instantiation (flash_bwd_dq_kernel) keeps the first version's
// design: fp32 FMAs from shared memory, 64 x 64 tiles, 256 threads.
#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace hvdflash {

// ---- fp32: the first version ------------------------------------------------

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

template <int D>
cudaError_t run_f32(const void* q, const void* k, const void* v,
                    const float* lse, const float* dsum, const float* dout,
                    float* dq, int bh, int sq, int sk, int qpos0, int kpos0,
                    int causal, cudaStream_t stream) {
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  return launch(flash_bwd_dq_kernel<float, D>, grid, NT, smem_bytes<D>(),
                stream, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                lse, dsum, dout, dq, sq, sk, qpos0, kpos0, causal);
}

// ---- bf16: warpgroup tensor-core products fed by TMA ------------------------

namespace dq_tc {

// Shared memory, in bytes from a 1024-aligned base: the Q tile, the three
// bf16 parts of dO (each laid out as the Q tile), the K and V rings, then
// the barriers (q_full, full[STAGES], empty[STAGES]).
template <int D>
struct Cfg {
  static constexpr int NWG = D == 64 ? 2 : 1;     // consumer warpgroups
  static constexpr int TQ = NWG * 64;             // query rows per block
  static constexpr int TK = 64;                   // keys per ring tile
  static constexpr int STAGES = D == 64 ? 3 : 2;  // K/V ring depth
  static constexpr int THREADS = NWG * 128 + 32;  // + one producer warp
  static constexpr int PARTS = 3;                 // dO = hi + mid + lo, bf16
  static constexpr int Q_BYTES = TQ * D * 2;      // also each part of dO
  static constexpr int KV_BYTES = TK * D * 2;     // one K or V tile
  static constexpr int Q = 0;
  static constexpr int HI = Q_BYTES;              // then mid and lo
  static constexpr int K = HI + PARTS * Q_BYTES;
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int BAR = V + STAGES * KV_BYTES;
  static constexpr int TOTAL = BAR + (1 + 2 * STAGES) * 8 + 1024;  // + align
};

// Split dO rows qw .. qw + 63 (of the bh's (sq, D) matrix; rows at or past
// sq read as zeros) into bf16 parts (x = the sum of the parts), written
// into rows row0 .. row0 + 63 of the part tiles in the swizzled layout, one
// 16-byte chunk of each part (8 columns) at a time; thread t of 128.
template <int D>
__device__ __forceinline__ void split_dout(uint8_t* parts,
                                           const float* __restrict__ dout,
                                           int qw, int sq, int row0, int t) {
  using C = Cfg<D>;
#pragma unroll 1
  for (int c = t; c < 64 * D / 8; c += 128) {
    const int r = c / (D / 8), ch = c % (D / 8);
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    if (qw + r < sq) {
      const float4* src =
          reinterpret_cast<const float4*>(dout + (size_t)(qw + r) * D + 8 * ch);
      x0 = __ldg(src);
      x1 = __ldg(src + 1);
    }
    const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    uint32_t part[C::PARTS][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float r0 = x[2 * e], r1 = x[2 * e + 1];
#pragma unroll
      for (int k = 0; k < C::PARTS; ++k) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(r0, r1);
        part[k][e] = *reinterpret_cast<const uint32_t*>(&h);
        r0 -= __low2float(h);
        r1 -= __high2float(h);
      }
    }
    const int off = (ch / 8) * C::TQ * 128 + tc::swizzled(row0 + r, ch % 8);
#pragma unroll
    for (int k = 0; k < C::PARTS; ++k)
      *reinterpret_cast<uint4*>(parts + k * C::Q_BYTES + off) =
          make_uint4(part[k][0], part[k][1], part[k][2], part[k][3]);
  }
}

// Key tiles of TK keys up to the causal diagonal of query row `last`.
__device__ __forceinline__ int live_tiles(int last, int sk, int qpos0,
                                          int kpos0, int causal, int tk) {
  const int n = (sk + tk - 1) / tk;
  if (!causal) return n;
  const long long lim = (long long)qpos0 + last - kpos0;
  return lim < 0 ? 0 : (int)min((long long)n, lim / tk + 1);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1) flash_bwd_dq_tc_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const float* __restrict__ lse,
    const float* __restrict__ dsum, const float* __restrict__ dout,
    float* __restrict__ dq, int sq, int sk, int qpos0, int kpos0,
    int causal) {
  using namespace tc;
  using C = Cfg<D>;
  constexpr int NWG = C::NWG, TQ = C::TQ, TK = C::TK, STAGES = C::STAGES;
  constexpr int PANELS = D / 64, KSTEPS = D / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;  // heaviest tiles first
  const int n_tiles =
      live_tiles(min(q0 + TQ, sq) - 1, sk, qpos0, kpos0, causal, TK);
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
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int p = 0; p < PANELS; ++p)
        tma_load_3d(smem + C::Q + p * TQ * 128, &qmap, q_full, p * 64, q0,
                    bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
        for (int p = 0; p < PANELS; ++p) {
          tma_load_3d(smem + C::K + s * C::KV_BYTES + p * TK * 128, &kmap,
                      &full[s], p * 64, t * TK, bh);
          tma_load_3d(smem + C::V + s * C::KV_BYTES + p * TK * 128, &vmap,
                      &full[s], p * 64, t * TK, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows qw .. qw + 63; this thread rows
  // r0 and r0 + 8 of them (the accumulator layout)
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int qw = q0 + wg * 64;
  const int r0 = qw + warp * 16 + lane / 4;
  const size_t rows = (size_t)bh * sq;
  // the key tiles this warpgroup's rows reach (a prefix of the block's)
  const int n_wg = qw >= sq ? 0
                            : live_tiles(min(qw + 64, sq) - 1, sk, qpos0,
                                         kpos0, causal, TK);
  float lse_r[2], d_r[2], acc[D / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    lse_r[h] = r < sq ? lse[rows + r] : 0.f;
    d_r[h] = r < sq ? dsum[rows + r] : 0.f;
  }
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

  if (n_wg > 0) {
    split_dout<D>(smem + C::HI, dout + rows * D, qw, sq, wg * 64, tid % 128);
    fence_proxy_async();               // the threads' writes, seen by wgmma
    named_barrier_sync(1 + wg, 128);   // the warpgroup's parts are all in
    mbar_wait(q_full, 0);
  }
  const uint32_t q_tile = smem_u32(smem + C::Q);
  const uint32_t hi_tile = smem_u32(smem + C::HI);
  const long long qpos_first = (long long)qpos0 + qw;
  for (int t = 0; t < n_wg; ++t) {
    const int s = t % STAGES, k0 = t * TK;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint32_t k_tile = smem_u32(smem + C::K + s * C::KV_BYTES);
    const uint32_t v_tile = smem_u32(smem + C::V + s * C::KV_BYTES);
    // only the diagonal and ragged-edge tiles evaluate the masking rule
    const bool masked =
        qw + 64 > sq || k0 + TK > sk ||
        (causal && (long long)kpos0 + k0 + TK - 1 > qpos_first);

    // s and dp as two groups, so that p is computed while dp runs
    float sc[TK / 2], dp[TK / 2];  // queries x keys
#pragma unroll
    for (int e = 0; e < TK / 2; ++e) sc[e] = dp[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma_ss(sc, desc_k(q_tile, TQ, wg * 64, kk), desc_k(k_tile, TK, 0, kk),
               kk > 0);
    wgmma_commit();
#pragma unroll
    for (int part = 0; part < C::PARTS; ++part)
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_ss(dp, desc_k(hi_tile + part * C::Q_BYTES, TQ, wg * 64, kk),
                 desc_k(v_tile, TK, 0, kk), part + kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // s
    fence_operand(sc);

    // p = exp(s - lse), masked; a fully masked row (lse = -1e30) is masked
    // on every tile it meets, so its inf never survives
#pragma unroll
    for (int e = 0; e < TK / 2; ++e) {
      const int h = (e % 4) / 2;
      float p = ex2((sc[e] - lse_r[h]) * LOG2E);
      if (masked && !keep(r0 + 8 * h, k0 + 8 * (e / 4) + 2 * t4 + (e % 2),
                          sq, sk, qpos0, kpos0, causal))
        p = 0.f;
      sc[e] = p;
    }
    wgmma_wait<0>();  // dp
    fence_operand(dp);

    // ds = p (dp - D), rounded to bf16 as in the Pallas kernel; dq += ds . K
    uint32_t a[TK / 16][4];
#pragma unroll
    for (int e = 0; e < TK / 2; ++e)
      dp[e] = sc[e] * (dp[e] - d_r[(e % 4) / 2]);
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) pack_a(dp, kk, a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs(acc, a[kk], desc_n(k_tile, TK, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }
  // the block's tiles past this warpgroup's diagonal: released unread
  for (int t = n_wg; t < n_tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dq + (rows + r) * D + 8 * j + 2 * t4) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

template <int D>
cudaError_t run(const void* q, const void* k, const void* v, const float* lse,
                const float* dsum, const float* dout, float* dq, int bh,
                int sq, int sk, int qpos0, int kpos0, int causal,
                cudaStream_t stream) {
  using C = Cfg<D>;
  // dO is read as float4, as TMA reads the other operands: 16-byte aligned
  if (reinterpret_cast<uintptr_t>(dout) % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t e;
  if ((e = tc::make_map(&qmap, q, true, D, sq, bh, 64, C::TQ, true)) ||
      (e = tc::make_map(&kmap, k, true, D, sk, bh, 64, C::TK, true)) ||
      (e = tc::make_map(&vmap, v, true, D, sk, bh, 64, C::TK, true)))
    return e;
  const dim3 grid(bh, (sq + C::TQ - 1) / C::TQ);
  return launch(flash_bwd_dq_tc_kernel<D>, grid, C::THREADS, C::TOTAL,
                stream, qmap, kmap, vmap, lse, dsum, dout, dq, sq, sk, qpos0,
                kpos0, causal);
}

}  // namespace dq_tc
}  // namespace hvdflash

// Threads and dynamic shared memory per block at head dim d (0: not built
// for d).
extern "C" void hvd_flash_bwd_dq_config(int d, int is_bf16, int* threads,
                                        int* smem) {
  using namespace hvdflash;
  const bool bf = is_bf16 != 0;
  *threads = !bf ? NT
             : d == 128 ? dq_tc::Cfg<128>::THREADS
                        : dq_tc::Cfg<64>::THREADS;
  *smem = d == 64    ? (bf ? dq_tc::Cfg<64>::TOTAL : smem_bytes<64>())
          : d == 128 ? (bf ? dq_tc::Cfg<128>::TOTAL : smem_bytes<128>())
                     : 0;
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
  // query rows per block of the design that runs: the grid's y extent
  const int rows = !is_bf16 ? BQ
                   : d == 128 ? dq_tc::Cfg<128>::TQ
                              : dq_tc::Cfg<64>::TQ;
  if (bh < 1 || sq < 1 || sk < 1 || (sq + rows - 1) / rows > 65535)
    return (int)cudaErrorInvalidValue;
  if (d == 64 && is_bf16)
    return (int)dq_tc::run<64>(q, k, v, lse, dsum, dout, dq, bh, sq, sk,
                               qpos0, kpos0, causal, s);
  if (d == 64)
    return (int)run_f32<64>(q, k, v, lse, dsum, dout, dq, bh, sq, sk, qpos0,
                            kpos0, causal, s);
  if (d == 128 && is_bf16)
    return (int)dq_tc::run<128>(q, k, v, lse, dsum, dout, dq, bh, sq, sk,
                                qpos0, kpos0, causal, s);
  if (d == 128)
    return (int)run_f32<128>(q, k, v, lse, dsum, dout, dq, bh, sq, sk, qpos0,
                             kpos0, causal, s);
  return (int)cudaErrorInvalidValue;
}
