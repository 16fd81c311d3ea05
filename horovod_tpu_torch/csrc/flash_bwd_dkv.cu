// Flash-attention backward, key and value gradients, for Hopper (sm_90a).
//
// Replaces: horovod_tpu/ops/flash.py `_flash_bwd_dkv_kernel` (flash.py:294),
// launched by `flash_block_grads` (flash.py:406). For one K/V block against
// the full saved log-sum-exp:
//   p = exp(s - lse) with the forward's masks, dv = sum over queries p^T . dO,
//   ds = p (dO . v^T - D), dk = sum over queries ds^T . q,
// with p unrounded and dO in fp32 for dv, and ds rounded to the input dtype
// for dk, as the Pallas kernel does.
//
// What bounds it on the H100: four products (s, dp, dv, dk), 8 d flops per
// unmasked (query, key) pair; at the training shape (bh 64, s 2048, d 64,
// bf16, causal) 69 GFLOP against 152 MB, so arithmetic bounds it (70 us at
// the bf16 tensor-core peak).
//
// bf16 design (flash_bwd_dkv_tc_kernel): the first version ran all four
// products as fp32 FMAs from shared memory, about 2.5 % of the tensor-core
// peak. Here they are warpgroup tensor-core products (wgmma, flash_tc.cuh)
// with the keys as the M dimension, fed by TMA:
// - one block per (bh, key tile), the earliest (heaviest, under causal
//   masking) tiles launched first: 64 key rows per consumer warpgroup (two
//   at d = 64; one at d = 128, whose dk and dv take 128 registers a thread)
//   and a producer warpgroup. dk and dv accumulate in registers and each
//   key row has one owner, so no atomics and deterministic results;
// - producer warp 0 loads K and V once, then for each query tile from the
//   causal diagonal on the Q tile (bf16) and the dO tile (fp32) into a ring
//   (three stages at d = 64, two at d = 128; TMA, mbarriers), and lse and D
//   of the tile's queries; warps 1-3 split each dO tile into bf16 parts in
//   the swizzled layout, off the consumers' path. With two consumer
//   warpgroups (384 threads, 168 registers a thread at launch) the producer
//   warpgroup gives registers to the consumers (setmaxnreg, 40 / 232);
// - the products: s^T = K . Q^T and dp^T = V . dO^T (both operands K-major
//   in shared memory), dv += p^T . dO and dk += ds^T . Q (p^T and ds^T from
//   registers in the accumulator layout, dO and Q N-major through the
//   transpose bit: one Q tile serves both ways);
// - fp32 operands as bf16 parts: dO = hi + mid + lo and p = hi + lo, each
//   part bf16, the products of the parts summed in fp32:
//   dp^T = V . (hi + mid + lo)^T and
//   dv += p_hi^T . hi + p_hi^T . mid + p_lo^T . hi. dv keeps about 16
//   mantissa bits of each operand (2^-16 relative, against 2^-11 in TF32);
//   dp keeps about 24, as the plain version's fp32 product does, so that
//   ds, rounded to bf16 before dk as in the Pallas kernel, lands on the
//   other bf16 neighbour than the plain version's no more often than two
//   fp32 sums in different orders make it. 8 bf16 products a tile, not 4;
// - each tile's products run in four groups, each waited for only where its
//   result is read: p = exp(s - lse) (one ex2.approx each) is computed
//   while dp^T runs, and ds while dv runs; only the diagonal and
//   ragged-edge tiles evaluate the masking rule.
// The fp32 instantiation (flash_bwd_dkv_kernel) keeps the first version's
// design: fp32 FMAs from shared memory, 64 x 64 tiles, 256 threads.
// Multi-head latent attention (q and k 192 wide, v and dO 128; bf16 only):
// the d = 128 design (one consumer warpgroup) with dk an m64n192
// accumulator (96 registers a thread) beside dv's 64. At 64 queries a tile
// the score tiles s^T and dp^T (32 registers each) and p's and ds's bf16
// parts spilled past 255 registers, so a tile holds 32 queries (m64n32
// score products, 16 registers each). A stage holding dO in fp32 as well
// would leave room for fewer stages, so the splitting warps read dO from
// global memory (the way K2 reads it) once the stage is free; a stage
// holds Q and the parts, 36 KB, four of them. ds is made before p's bf16
// parts, so that dp is dead when they are.
#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace hvdflash {

// ---- fp32: the first version ------------------------------------------------

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

template <int D>
cudaError_t run_f32(const void* q, const void* k, const void* v,
                    const float* lse, const float* dsum, const float* dout,
                    float* dk, float* dv, int bh, int sq, int sk, int qpos0,
                    int kpos0, int causal, cudaStream_t stream) {
  const dim3 grid(bh, (sk + BK - 1) / BK);
  return launch(flash_bwd_dkv_kernel<float, D>, grid, NT, smem_bytes<D>(),
                stream, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                lse, dsum, dout, dk, dv, sq, sk, qpos0, kpos0, causal);
}

// ---- bf16: warpgroup tensor-core products fed by TMA ------------------------

namespace dkv_tc {

constexpr int round1024(int x) { return (x + 1023) / 1024 * 1024; }

// Shared memory, in bytes from a 1024-aligned base: the K and V tiles, the
// ring stages (Q, the bf16 parts of dO and, where STAGED_DO, dO in fp32),
// lse and D of each stage, then the barriers (kv_full, full[STAGES],
// ready[STAGES], empty[STAGES]). DQK is the head width of q and k, DV that
// of v and dO.
template <int DQK, int DV = DQK>
struct Cfg {
  // query rows per ring tile: 32 at 192 / 128, where dk's 96 accumulator
  // registers and dv's 64 leave no room for 64-query score tiles
  static constexpr int TQ = DQK == DV ? 64 : 32;
  static constexpr int NWG = DQK == 64 ? 2 : 1;     // consumer warpgroups
  static constexpr int STAGES = DQK == 64 ? 3 : DQK == DV ? 2 : 4;  // ring
  static constexpr int TK = NWG * 64;          // key rows per block
  static constexpr int CT = NWG * 128;         // consumer threads
  static constexpr int THREADS = CT + 128;     // + the producer warpgroup
  // registers a thread after setmaxnreg (two consumer warpgroups only: at
  // 384 threads a block starts at 168 a thread)
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  // dO reaches the splitting warps as an fp32 tile in the stage (TMA), or,
  // at 192 / 128, where two such stages do not fit beside the rest, from
  // global memory
  static constexpr bool STAGED_DO = DQK == DV;
  static constexpr int K_BYTES = TK * DQK * 2;
  static constexpr int V_BYTES = TK * DV * 2;
  static constexpr int K = 0;
  static constexpr int V = K_BYTES;
  static constexpr int RING = K_BYTES + V_BYTES;
  // offsets inside a stage
  static constexpr int PARTS = 3;               // dO = hi + mid + lo, bf16
  static constexpr int Q_BYTES = TQ * DQK * 2;
  static constexpr int PART_BYTES = TQ * DV * 2;  // each bf16 part of dO
  static constexpr int DO_BYTES = STAGED_DO ? TQ * DV * 4 : 0;
  static constexpr int Q = 0, HI = Q_BYTES;     // then the other dO parts
  static constexpr int DO = HI + PARTS * PART_BYTES;
  static constexpr int STAGE = round1024(DO + DO_BYTES);
  static constexpr int LSE = RING + STAGES * STAGE;  // lse[TQ], D[TQ] a stage
  static constexpr int BAR = LSE + STAGES * 2 * TQ * 4;
  static constexpr int TOTAL = BAR + (1 + 3 * STAGES) * 8 + 1024;  // + align
};

// Split dO rows q0 .. q0 + TQ - 1 into the bf16 parts of a stage (x = the
// sum of the parts), written in the swizzled layout one 16-byte chunk of
// each part (8 columns) at a time; thread t of nt. The rows come from the
// staged fp32 tile, or, without one, from the bh's (sq, DV) matrix in
// global memory (rows at or past sq read as zeros).
template <int DQK, int DV>
__device__ __forceinline__ void split_dout(uint8_t* st,
                                           const float* __restrict__ dout,
                                           int q0, int sq, int t, int nt) {
  using C = Cfg<DQK, DV>;
  constexpr int TQ = C::TQ;
  const float* d32 = reinterpret_cast<const float*>(st + C::DO);
#pragma unroll 1
  for (int c = t; c < TQ * DV / 8; c += nt) {
    const int r = c / (DV / 8), ch = c % (DV / 8);
    float4 x0, x1;
    if constexpr (C::STAGED_DO) {
      x0 = *reinterpret_cast<const float4*>(d32 + r * DV + 8 * ch);
      x1 = *reinterpret_cast<const float4*>(d32 + r * DV + 8 * ch + 4);
    } else {
      x0 = x1 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < sq) {
        const float4* src = reinterpret_cast<const float4*>(
            dout + (size_t)(q0 + r) * DV + 8 * ch);
        x0 = __ldg(src);
        x1 = __ldg(src + 1);
      }
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
    const int off = (ch / 8) * TQ * 128 + tc::swizzled(r, ch % 8);
#pragma unroll
    for (int k = 0; k < C::PARTS; ++k)
      *reinterpret_cast<uint4*>(st + C::HI + k * C::PART_BYTES + off) =
          make_uint4(part[k][0], part[k][1], part[k][2], part[k][3]);
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(Cfg<DQK, DV>::THREADS, 1)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __grid_constant__ CUtensorMap domap,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dsum,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int sq, int sk, int qpos0, int kpos0,
                            int causal) {
  using namespace tc;
  using C = Cfg<DQK, DV>;
  constexpr int NWG = C::NWG, TK = C::TK, CT = C::CT, STAGES = C::STAGES;
  constexpr int TQ = C::TQ;
  constexpr int QK_PANELS = DQK / 64, V_PANELS = DV / 64;
  constexpr int QK_STEPS = DQK / 16, V_STEPS = DV / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* ready = full + STAGES;
  uint64_t* empty = ready + STAGES;

  const int bh = blockIdx.x, k0 = blockIdx.y * TK;  // heaviest tiles first
  // query tiles from the first that reaches the block's first key on
  const int n_qt = (sq + TQ - 1) / TQ;
  int t0 = 0, n_live = n_qt;
  if (causal) {
    const long long x = (long long)kpos0 + k0 - qpos0;
    if ((long long)sq - 1 < x) n_live = 0;  // every query before every key
    else if (x > 0) t0 = (int)(x / TQ);
    n_live -= t0;
  }
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);        // the producer warp's lanes
      mbar_init(&ready[s], 96);       // the splitting warps' threads
      mbar_init(&empty[s], NWG * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CT) {  // the producer warpgroup
    if constexpr (NWG == 2) setmaxnreg_dec<C::PRODUCER_REGS>();
    if (tid >= CT + 32) {  // warps 1-3 split each dO tile into bf16 parts
      const float* dout_bh = dout + (size_t)bh * sq * DV;
      for (int i = 0; i < n_live; ++i) {
        const int s = i % STAGES;
        uint8_t* st = smem + C::RING + s * C::STAGE;
        if constexpr (C::STAGED_DO)
          mbar_wait(&full[s], (i / STAGES) & 1);  // the fp32 tile is in
        else
          mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);  // the stage is free
        split_dout<DQK, DV>(st, dout_bh, (t0 + i) * TQ, sq, tid - CT - 32,
                            96);
        fence_proxy_async();  // the threads' writes, seen by wgmma
        mbar_arrive(&ready[s]);
      }
      return;
    }
    // warp 0 loads
    const int lane = tid % 32;
    if (n_live > 0 && lane == 0) {
      mbar_arrive_expect_tx(kv_full, C::K_BYTES + C::V_BYTES);
      for (int p = 0; p < QK_PANELS; ++p)
        tma_load_3d(smem + C::K + p * TK * 128, &kmap, kv_full, p * 64, k0,
                    bh);
      for (int p = 0; p < V_PANELS; ++p)
        tma_load_3d(smem + C::V + p * TK * 128, &vmap, kv_full, p * 64, k0,
                    bh);
    }
    for (int i = 0; i < n_live; ++i) {
      const int s = i % STAGES, q0 = (t0 + i) * TQ;
      uint8_t* st = smem + C::RING + s * C::STAGE;
      mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      float* lse_s = reinterpret_cast<float*>(smem + C::LSE) + s * 2 * TQ;
      float* d_s = lse_s + TQ;
      for (int c = lane; c < TQ; c += 32) {
        const int r = q0 + c;
        lse_s[c] = r < sq ? lse[(size_t)bh * sq + r] : 0.f;
        d_s[c] = r < sq ? dsum[(size_t)bh * sq + r] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], C::Q_BYTES + C::DO_BYTES);
        for (int p = 0; p < QK_PANELS; ++p)
          tma_load_3d(st + C::Q + p * TQ * 128, &qmap, &full[s], p * 64, q0,
                      bh);
        if constexpr (C::STAGED_DO)
          tma_load_3d(st + C::DO, &domap, &full[s], 0, q0, bh);
      } else {
        mbar_arrive(&full[s]);  // releases this lane's lse and D
      }
    }
    return;
  }

  if constexpr (NWG == 2) setmaxnreg_inc<C::CONSUMER_REGS>();
  // consumers: warpgroup wg owns key rows k0 + 64 wg .. + 63; this thread
  // rows kr and kr + 8 of them (the accumulator layout)
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int kw = k0 + wg * 64;
  const int kr = kw + warp * 16 + lane / 4;
  float gk[DQK / 2], gv[DV / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) gk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) gv[i] = 0.f;
  if (n_live > 0) mbar_wait(kv_full, 0);
  const uint32_t k_tile0 = smem_u32(smem + C::K);
  const uint32_t v_tile0 = smem_u32(smem + C::V);

  for (int i = 0; i < n_live; ++i) {
    const int s = i % STAGES, q0 = (t0 + i) * TQ;
    uint8_t* st = smem + C::RING + s * C::STAGE;
    // opaque to the compiler, so that it builds the descriptors in each
    // iteration rather than holding them in registers across the loop
    uint32_t k_tile = k_tile0, v_tile = v_tile0;
    asm volatile("" : "+r"(k_tile), "+r"(v_tile));
    mbar_wait(&full[s], (i / STAGES) & 1);   // Q, lse and D
    mbar_wait(&ready[s], (i / STAGES) & 1);  // the parts of dO

    const uint32_t q_tile = smem_u32(st + C::Q);
    const uint32_t hi_tile = smem_u32(st + C::HI);
    const uint32_t mid_tile = hi_tile + C::PART_BYTES;
    const float* lse_s =
        reinterpret_cast<const float*>(smem + C::LSE) + s * 2 * TQ;
    const float* d_s = lse_s + TQ;
    const bool masked =
        q0 + TQ > sq || kw + 64 > sk ||
        (causal && (long long)kpos0 + kw + 63 > (long long)qpos0 + q0);
    // four groups of products, each waited for only where its result is
    // read, so that p is computed while dp^T runs and, at equal widths, ds
    // while dv runs
    float sc[TQ / 2], dp[TQ / 2];  // s^T and dp^T: keys x queries
#pragma unroll
    for (int e = 0; e < TQ / 2; ++e) sc[e] = dp[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QK_STEPS; ++kk)
      wgmma_ss(sc, desc_k(k_tile, TK, wg * 64, kk), desc_k(q_tile, TQ, 0, kk),
               kk > 0);
    wgmma_commit();
#pragma unroll
    for (int t = 0; t < C::PARTS; ++t)
#pragma unroll
      for (int kk = 0; kk < V_STEPS; ++kk)
        wgmma_ss(dp, desc_k(v_tile, TK, wg * 64, kk),
                 desc_k(hi_tile + t * C::PART_BYTES, TQ, 0, kk), t + kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // s^T
    fence_operand(sc);

    // p = exp(s - lse), masked; columns are queries
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j) {
      const float2 lj =
          *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t4);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int e = 4 * j + h;
        const int c = 8 * j + 2 * t4 + (h % 2);
        float p = ex2((sc[e] - (h % 2 ? lj.y : lj.x)) * LOG2E);
        if (masked && !keep(q0 + c, kr + 8 * (h / 2), sq, sk, qpos0, kpos0,
                            causal))
          p = 0.f;
        sc[e] = p;
      }
    }
    uint32_t ph[TQ / 16][4], pl[TQ / 16][4], ds[TQ / 16][4];
    // p^T as bf16 hi + lo, the A operands of dv += p^T . dO
    auto split_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float x0 = sc[8 * kk + 2 * a], x1 = sc[8 * kk + 2 * a + 1];
          const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
          ph[kk][a] = *reinterpret_cast<const uint32_t*>(&h);
          pl[kk][a] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
        }
      }
    };
    auto issue_dv = [&]() {
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) {
        const uint64_t bhi = desc_n(hi_tile, TQ, kk);
        wgmma_rs(gv, ph[kk], bhi, 1);
        wgmma_rs(gv, ph[kk], desc_n(mid_tile, TQ, kk), 1);
        wgmma_rs(gv, pl[kk], bhi, 1);
      }
    };
    // ds = p (dp - D), rounded to bf16 as in the Pallas kernel, the A
    // operand of dk += ds^T . q
    auto make_ds = [&]() {
#pragma unroll
      for (int j = 0; j < TQ / 8; ++j) {
        const float2 dj =
            *reinterpret_cast<const float2*>(d_s + 8 * j + 2 * t4);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int e = 4 * j + h;
          dp[e] = sc[e] * (dp[e] - (h % 2 ? dj.y : dj.x));
        }
      }
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) pack_a(dp, kk, ds[kk]);
    };
    auto issue_dk = [&]() {
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk)
        wgmma_rs(gk, ds[kk], desc_n(q_tile, TQ, kk), 1);
    };
    if constexpr (DQK == DV) {
      split_p();
      wgmma_fence();
      issue_dv();
      wgmma_commit();
      wgmma_wait<1>();  // dp^T
      fence_operand(dp);
      make_ds();
      wgmma_fence();
      issue_dk();
      wgmma_commit();
    } else {
      // dk's 96 accumulator registers beside dv's 64: ds first, so that dp
      // and sc die before p's bf16 parts are made
      wgmma_wait<0>();  // dp^T
      fence_operand(dp);
      make_ds();
      wgmma_fence();
      issue_dk();
      wgmma_commit();
      split_p();
      wgmma_fence();
      issue_dv();
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_operand(gk);
    fence_operand(gv);
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = kr + 8 * h;
    if (r >= sk) continue;
    const size_t row = (size_t)bh * sk + r;
#pragma unroll
    for (int j = 0; j < DQK / 8; ++j) {
      const int e = 4 * j + 2 * h;
      *reinterpret_cast<float2*>(dk + row * DQK + 8 * j + 2 * t4) =
          make_float2(gk[e], gk[e + 1]);
    }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int e = 4 * j + 2 * h;
      *reinterpret_cast<float2*>(dv + row * DV + 8 * j + 2 * t4) =
          make_float2(gv[e], gv[e + 1]);
    }
  }
}

template <int DQK, int DV = DQK>
cudaError_t run(const void* q, const void* k, const void* v, const float* lse,
                const float* dsum, const float* dout, float* dk, float* dv,
                int bh, int sq, int sk, int qpos0, int kpos0, int causal,
                cudaStream_t stream) {
  using C = Cfg<DQK, DV>;
  CUtensorMap qmap, kmap, vmap, domap = {};
  cudaError_t e;
  if ((e = tc::make_map(&qmap, q, true, DQK, sq, bh, 64, C::TQ, true)) ||
      (e = tc::make_map(&kmap, k, true, DQK, sk, bh, 64, C::TK, true)) ||
      (e = tc::make_map(&vmap, v, true, DV, sk, bh, 64, C::TK, true)))
    return e;
  if constexpr (C::STAGED_DO) {
    if ((e = tc::make_map(&domap, dout, false, DV, sq, bh, DV, C::TQ,
                          false)))
      return e;
  } else if (reinterpret_cast<uintptr_t>(dout) % 16 != 0) {
    return cudaErrorInvalidValue;  // dO is read as float4
  }
  const dim3 grid(bh, (sk + C::TK - 1) / C::TK);
  return launch(flash_bwd_dkv_tc_kernel<DQK, DV>, grid, C::THREADS, C::TOTAL,
                stream, qmap, kmap, vmap, domap, dout, lse, dsum, dk, dv, sq,
                sk, qpos0, kpos0, causal);
}

}  // namespace dkv_tc
}  // namespace hvdflash

// Threads and dynamic shared memory per block at q/k head width d (0: not
// built for d); d = 192 is the multi-head latent attention pair, v 128,
// built for bf16 only.
extern "C" void hvd_flash_bwd_dkv_config(int d, int is_bf16, int* threads,
                                         int* smem) {
  using namespace hvdflash;
  const bool bf = is_bf16 != 0;
  *threads = !bf ? NT
             : d == 192 ? dkv_tc::Cfg<192, 128>::THREADS
             : d == 128 ? dkv_tc::Cfg<128>::THREADS
                        : dkv_tc::Cfg<64>::THREADS;
  *smem = d == 64    ? (bf ? dkv_tc::Cfg<64>::TOTAL : smem_bytes<64>())
          : d == 128 ? (bf ? dkv_tc::Cfg<128>::TOTAL : smem_bytes<128>())
          : d == 192 && bf ? dkv_tc::Cfg<192, 128>::TOTAL
                           : 0;
}

// Arguments as hvd_flash_bwd_dq; dk (bh, sk, d) and dv (bh, sk, dv) fp32
// out.
extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const float* lse, const float* dsum,
                                 const float* dout, float* dk, float* dv,
                                 int bh, int sq, int sk, int d, int dvw,
                                 int qpos0, int kpos0, int causal,
                                 int is_bf16, void* stream) {
  using namespace hvdflash;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || sq < 1 || sk < 1 || (sk + BK - 1) / BK > 65535)
    return (int)cudaErrorInvalidValue;
  if (d == 192 && dvw == 128 && is_bf16)
    return (int)dkv_tc::run<192, 128>(q, k, v, lse, dsum, dout, dk, dv, bh,
                                      sq, sk, qpos0, kpos0, causal, s);
  if (dvw != d) return (int)cudaErrorInvalidValue;
  if (d == 64 && is_bf16)
    return (int)dkv_tc::run<64>(q, k, v, lse, dsum, dout, dk, dv, bh, sq, sk,
                                qpos0, kpos0, causal, s);
  if (d == 64)
    return (int)run_f32<64>(q, k, v, lse, dsum, dout, dk, dv, bh, sq, sk,
                            qpos0, kpos0, causal, s);
  if (d == 128 && is_bf16)
    return (int)dkv_tc::run<128>(q, k, v, lse, dsum, dout, dk, dv, bh, sq,
                                 sk, qpos0, kpos0, causal, s);
  if (d == 128)
    return (int)run_f32<128>(q, k, v, lse, dsum, dout, dk, dv, bh, sq, sk,
                             qpos0, kpos0, causal, s);
  return (int)cudaErrorInvalidValue;
}
