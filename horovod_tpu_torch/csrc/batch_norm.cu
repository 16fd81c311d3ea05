// BatchNorm with flax's semantics, training and eval mode, forward and
// backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's BatchNorm is plain jnp
// (horovod_tpu/models/sync_batch_norm.py), which XLA fused on the TPU. The
// port's plain version is the torch ops of
// horovod_tpu_torch/models/sync_batch_norm.py, about 15 float32 passes a
// norm forward and backward. Here each direction makes two passes over the
// activation:
//   stats      (E[x], E[x^2]) per channel, summed in float64 and rounded
//              once to float32 (float64 for float64 x);
//   norm       y = cast((x - E[x]) * mul + bias),
//              mul = rsqrt(max(E[x^2] - E[x]^2, 0) + eps) * weight, and
//              in training mode the running averages moved in place;
//   bwd_reduce sum dy and sum dy (x - E[x]) per channel, then dweight,
//              dbias and the cotangents of the two moments, through the
//              clamp of the variance as torch's autograd takes it (the
//              gradient passes where E[x^2] - E[x]^2 >= 0);
//   bwd_dx     dx = cast(dy * mul + c + b (x - E[x])), with
//              b = 2 dE[x^2] / n and c = (dE[x] + 2 E[x] dE[x^2]) / n, the
//              closed form of dE[x] / n + 2 x dE[x^2] / n.
// Between stats and norm the caller may average the moments over ranks
// (SyncBatchNorm), and between bwd_reduce and bwd_dx their cotangents.
//
// What bounds it on the H100: bytes. A norm moves at least 10 B an element
// of bf16 (x and y forward; x, dy and dx backward); two passes each way
// move 16 B. ResNet-50 at batch 256 has 2.845 G normalized elements a
// step: 28.5 GB compulsory (8.5 ms at 3.35 TB/s), 45.5 GB in two passes
// (13.6 ms).
//
// Design: channels innermost (a channels-last or (n, C) tensor: rows of C
// contiguous values). A thread owns one group of VEC neighbouring channels
// (16 B of x) for its whole life, so the per-channel coefficients are
// computed once a thread, and walks rows, UNROLL of them loaded before any
// is used, so that enough bytes are in flight. A block holds NT threads:
// up to SLAB channel groups side by side and NT / groups rows at a time;
// wider rows split into slabs along grid.y, and grid.x cuts the rows into
// chunks: one wave of the blocks the card holds at once for a reduction, two
// for an elementwise pass. The reductions never
// use float atomics: each chunk's block sums its rows in a fixed order
// (a thread's rows in order, then a fixed tree over the block's rows) into
// a scratch row, and a second small kernel sums the scratch rows in a
// fixed order, so a result is the same from run to run. They sum in
// float64 (the card's float64 rate is far above what the bytes need), so a
// moment or a gradient sum is rounded to float32 once, from a sum whose own
// error is far below that rounding: a float32 sum's error, a chain of up to
// a few hundred roundings, moves every later activation, and one that lies
// near a ReLU's kink can cross it. The elementwise steps round as the
// plain version does (no fused multiply-add across a rounding the torch
// ops make), so norm's only difference from it is in the moments' sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hvdbn {

constexpr int NT = 256;       // threads of a row-pass block
constexpr int SLAB = 64;      // most channel groups one block covers
constexpr int UNROLL = 4;     // rows a thread loads before it uses them
constexpr long long MIN_CHUNK_ROWS = 64;  // keeps the scratch rows small
constexpr int FIN_C = 32, FIN_L = 32;  // finalize block: channels x lanes

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename A> __device__ __forceinline__ A up(__nv_bfloat16 v) {
  return static_cast<A>(__bfloat162float(v));
}
template <typename A> __device__ __forceinline__ A up(float v) {
  return static_cast<A>(v);
}
template <typename A> __device__ __forceinline__ A up(double v) {
  return static_cast<A>(v);
}
__device__ __forceinline__ void down(float v, __nv_bfloat16& o) {
  o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void down(float v, float& o) { o = v; }
__device__ __forceinline__ void down(double v, double& o) { o = v; }

// Roundings as torch's separate ops make them: no contraction into an FMA.
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float rsqrt_(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_(double v) { return rsqrt(v); }

// The variance a norm divides by: the clamped E[x^2] - E[x]^2 of the
// moments, or in eval mode the running variance as it is.
template <typename A>
__device__ __forceinline__ A variance(const A* stats, int C, int c,
                                      int from_moments, A* raw = nullptr) {
  const A v = stats[C + c];
  if (!from_moments) return v;
  const A m = stats[c];
  const A d = sub_rn(v, mul_rn(m, m));
  if (raw) *raw = d;
  return d < A(0) ? A(0) : d;  // a NaN stays NaN, as clamp_min keeps it
}

// Launch geometry, the same for every kernel of one (rows, C, VEC).
struct Geometry {
  int G, Gs, S, P;           // groups a row, a slab; slabs; rows a pass
  long long K, rows;         // chunks; rows a chunk
  dim3 grid() const { return dim3((unsigned)K, (unsigned)S); }
};

// `target` blocks in all: for a reduction as many as the card holds at once
// (one wave), for an elementwise pass two waves.
Geometry geometry(long long R, int C, int vec, bool reduce, long long target,
                  long long cap) {
  Geometry g;
  g.G = C / vec;
  g.Gs = g.G < SLAB ? g.G : SLAB;
  g.S = (g.G + g.Gs - 1) / g.Gs;
  g.P = NT / g.Gs;
  long long min_rows = (long long)g.P * UNROLL;
  if (reduce && min_rows < MIN_CHUNK_ROWS) min_rows = MIN_CHUNK_ROWS;
  long long k = (target + g.S - 1) / g.S;
  const long long by_rows = (R + min_rows - 1) / min_rows;
  if (by_rows < k) k = by_rows;
  if (cap > 0 && cap < k) k = cap;
  if (k < 1) k = 1;
  g.rows = (R + k - 1) / k;
  g.K = g.rows > 0 ? (R + g.rows - 1) / g.rows : 1;
  return g;
}

// The blocks of `kernel` the card holds at once (NT threads and `smem`
// bytes each): its SMs times the blocks an SM takes.
template <typename Kernel>
long long resident(Kernel kernel, int smem) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, NT, smem);
  return (long long)(sms > 0 ? sms : 1) * (per > 0 ? per : 1);
}

template <typename T>
bool aligned(const void* p, int vec) {
  return reinterpret_cast<uintptr_t>(p) % (sizeof(T) * vec) == 0;
}

// Sum the block's rows of partial sums `mine` (2V values a thread, laid out
// [p][gl][2V] in shared memory) into p == 0 by a fixed tree over p.
template <typename A, int V>
__device__ __forceinline__ void tree_over_rows(A* sm, int p, int gl, int Gs,
                                               int P) {
  A* mine = sm + ((size_t)p * Gs + gl) * 2 * V;
  int half = 1;
  while (half < P) half <<= 1;
  for (half >>= 1; half > 0; half >>= 1) {
    if (p < half && p + half < P) {
      const A* other = mine + (size_t)half * Gs * 2 * V;
#pragma unroll
      for (int i = 0; i < 2 * V; ++i) mine[i] += other[i];
    }
    __syncthreads();
  }
}

// ---- forward pass 1: per-chunk sums of x and x^2 ---------------------------

template <typename Tin, int V>
__global__ void __launch_bounds__(NT)
    stats_partial(const Tin* __restrict__ x, long long R, int C, int Gs,
                  int P, long long rows,
                  double* __restrict__ part) {
  using A = typename AccOf<Tin>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sm = reinterpret_cast<double*>(smem_raw);
  const int gl = threadIdx.x % Gs, p = threadIdx.x / Gs;
  const int g = blockIdx.y * Gs + gl;
  const bool active = p < P && g < C / V;
  const long long r0 = blockIdx.x * rows;
  const long long r1 = r0 + rows < R ? r0 + rows : R;
  double s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.0;
  if (active) {
    const Tin* base = x + (size_t)g * V;
    for (long long r = r0 + p; r < r1; r += (long long)P * UNROLL) {
      Vec<Tin, V> v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long rr = r + (long long)u * P;
        if (rr < r1)
          v[u] = *reinterpret_cast<const Vec<Tin, V>*>(base + rr * C);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + (long long)u * P < r1) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const double a = up<double>(v[u].v[i]);
            s[i] += a;
            q[i] = fma_(a, a, q[i]);
          }
        }
      }
    }
  }
  if (p < P) {
    double* mine = sm + ((size_t)p * Gs + gl) * 2 * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mine[i] = s[i];
      mine[V + i] = q[i];
    }
  }
  __syncthreads();
  tree_over_rows<double, V>(sm, p, gl, Gs, P);
  if (p == 0 && active) {
    const double* mine = sm + (size_t)gl * 2 * V;
    double* out = part + (size_t)blockIdx.x * 2 * C + (size_t)g * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      out[i] = mine[i];
      out[C + i] = mine[V + i];
    }
  }
}

// Sum the K scratch rows of (sum a, sum b) per channel in a fixed order:
// lane l takes rows l, l + FIN_L, ..., then a fixed tree over the lanes.
__device__ __forceinline__ bool sum_chunks(const double* __restrict__ part,
                                           int K, int C, double& sa,
                                           double& sb) {
  __shared__ double sm[FIN_L][FIN_C][2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * FIN_C + tx;
  double a = 0.0, b = 0.0;
  if (c < C) {
    for (int k = ty; k < K; k += FIN_L) {
      a += part[(size_t)k * 2 * C + c];
      b += part[(size_t)k * 2 * C + C + c];
    }
  }
  sm[ty][tx][0] = a;
  sm[ty][tx][1] = b;
  __syncthreads();
#pragma unroll
  for (int h = FIN_L / 2; h > 0; h >>= 1) {
    if (ty < h) {
      sm[ty][tx][0] += sm[ty + h][tx][0];
      sm[ty][tx][1] += sm[ty + h][tx][1];
    }
    __syncthreads();
  }
  sa = sm[0][tx][0];
  sb = sm[0][tx][1];
  return ty == 0 && c < C;
}

template <typename A>
__global__ void __launch_bounds__(FIN_C* FIN_L)
    stats_final(const double* __restrict__ part, int K, int C, long long n,
                A* __restrict__ moments) {
  double s, q;
  if (sum_chunks(part, K, C, s, q)) {
    const int c = blockIdx.x * FIN_C + threadIdx.x;
    moments[c] = A(s / double(n));
    moments[C + c] = A(q / double(n));
  }
}

// ---- forward pass 2: normalize ---------------------------------------------

template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(NT)
    norm_kernel(const Tin* __restrict__ x, Tout* __restrict__ y, long long R,
                int C, int Gs, int P, long long rows,
                const typename AccOf<Tin>::type* __restrict__ stats,
                int from_moments,
                const typename AccOf<Tin>::type* __restrict__ weight,
                const typename AccOf<Tin>::type* __restrict__ bias, double eps,
                typename AccOf<Tin>::type* __restrict__ running_mean,
                typename AccOf<Tin>::type* __restrict__ running_var,
                double momentum) {
  using A = typename AccOf<Tin>::type;
  const int gl = threadIdx.x % Gs, p = threadIdx.x / Gs;
  const int g = blockIdx.y * Gs + gl;
  if (p >= P || g >= C / V) return;
  // the first chunk's first row of threads moves the running averages:
  // ra = momentum ra + (1 - momentum) batch, rounded as torch's ops round
  const bool moves = running_mean != nullptr && blockIdx.x == 0 && p == 0;
  const A keep = A(momentum), take = A(1.0 - momentum);
  A mean[V], mul[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = g * V + i;
    const A var = variance(stats, C, c, from_moments);
    mean[i] = stats[c];
    mul[i] = mul_rn(rsqrt_(add_rn(var, A(eps))), weight[c]);
    b[i] = bias[c];
    if (moves) {
      running_mean[c] = add_rn(mul_rn(keep, running_mean[c]),
                               mul_rn(take, mean[i]));
      running_var[c] = add_rn(mul_rn(keep, running_var[c]),
                              mul_rn(take, var));
    }
  }
  const long long r0 = blockIdx.x * rows;
  const long long r1 = r0 + rows < R ? r0 + rows : R;
  const Tin* xb = x + (size_t)g * V;
  Tout* yb = y + (size_t)g * V;
  for (long long r = r0 + p; r < r1; r += (long long)P * UNROLL) {
    Vec<Tin, V> v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long rr = r + (long long)u * P;
      if (rr < r1) v[u] = *reinterpret_cast<const Vec<Tin, V>*>(xb + rr * C);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long rr = r + (long long)u * P;
      if (rr < r1) {
        Vec<Tout, V> o;
#pragma unroll
        for (int i = 0; i < V; ++i)
          down(add_rn(mul_rn(sub_rn(up<A>(v[u].v[i]), mean[i]), mul[i]),
                      b[i]),
               o.v[i]);
        *reinterpret_cast<Vec<Tout, V>*>(yb + rr * C) = o;
      }
    }
  }
}

// ---- backward pass 1: per-chunk sums of dy and dy (x - mean) ---------------

template <typename Tin, typename Tdy, int V>
__global__ void __launch_bounds__(NT)
    bwd_partial(const Tdy* __restrict__ dy, const Tin* __restrict__ x,
                long long R, int C, int Gs, int P, long long rows,
                const typename AccOf<Tin>::type* __restrict__ stats,
                double* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sm = reinterpret_cast<double*>(smem_raw);
  const int gl = threadIdx.x % Gs, p = threadIdx.x / Gs;
  const int g = blockIdx.y * Gs + gl;
  const bool active = p < P && g < C / V;
  const long long r0 = blockIdx.x * rows;
  const long long r1 = r0 + rows < R ? r0 + rows : R;
  double s1[V], s2[V], mean[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s1[i] = s2[i] = 0.0;
    mean[i] = active ? double(stats[g * V + i]) : 0.0;
  }
  if (active) {
    const Tin* xb = x + (size_t)g * V;
    const Tdy* db = dy + (size_t)g * V;
    for (long long r = r0 + p; r < r1; r += (long long)P * UNROLL) {
      Vec<Tin, V> v[UNROLL];
      Vec<Tdy, V> d[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long rr = r + (long long)u * P;
        if (rr < r1) {
          v[u] = *reinterpret_cast<const Vec<Tin, V>*>(xb + rr * C);
          d[u] = *reinterpret_cast<const Vec<Tdy, V>*>(db + rr * C);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + (long long)u * P < r1) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const double gy = up<double>(d[u].v[i]);
            s1[i] += gy;
            s2[i] = fma_(gy, up<double>(v[u].v[i]) - mean[i], s2[i]);
          }
        }
      }
    }
  }
  if (p < P) {
    double* mine = sm + ((size_t)p * Gs + gl) * 2 * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mine[i] = s1[i];
      mine[V + i] = s2[i];
    }
  }
  __syncthreads();
  tree_over_rows<double, V>(sm, p, gl, Gs, P);
  if (p == 0 && active) {
    const double* mine = sm + (size_t)gl * 2 * V;
    double* out = part + (size_t)blockIdx.x * 2 * C + (size_t)g * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      out[i] = mine[i];
      out[C + i] = mine[V + i];
    }
  }
}

// dweight = r sum dy (x - mean), dbias = sum dy; in training mode the
// cotangents of (E[x], E[x^2]) through var = clamp_min(E[x^2] - E[x]^2, 0)
// and mul = rsqrt(var + eps) weight.
template <typename A>
__global__ void __launch_bounds__(FIN_C* FIN_L)
    bwd_final(const double* __restrict__ part, int K, int C,
              const A* __restrict__ stats, int from_moments,
              const A* __restrict__ weight, double eps, A* __restrict__ dweight,
              A* __restrict__ dbias, A* __restrict__ dstats) {
  double s1, s2;
  if (!sum_chunks(part, K, C, s1, s2)) return;
  const int c = blockIdx.x * FIN_C + threadIdx.x;
  A d = A(0);
  const A var = variance(stats, C, c, from_moments, &d);
  // r and mul as the norm kernel rounds them; the rest in float64
  const double r = rsqrt_(add_rn(var, A(eps)));
  const double w = weight[c], mul = mul_rn(A(r), A(w));
  dbias[c] = A(s1);
  dweight[c] = A(s2 * r);
  if (from_moments) {
    const double dd = d >= A(0) ? -0.5 * (s2 * w) * (r * r * r) : 0.0;
    dstats[c] = A(-mul * s1 - 2.0 * double(stats[c]) * dd);
    dstats[C + c] = A(dd);
  }
}

// ---- backward pass 2: dx ---------------------------------------------------

template <typename Tin, typename Tdy, int V>
__global__ void __launch_bounds__(NT)
    bwd_dx(const Tdy* __restrict__ dy, const Tin* __restrict__ x,
           Tin* __restrict__ dx, long long R, int C, int Gs, int P,
           long long rows, const typename AccOf<Tin>::type* __restrict__ stats,
           int from_moments,
           const typename AccOf<Tin>::type* __restrict__ weight, double eps,
           const typename AccOf<Tin>::type* __restrict__ dstats) {
  using A = typename AccOf<Tin>::type;
  const int gl = threadIdx.x % Gs, p = threadIdx.x / Gs;
  const int g = blockIdx.y * Gs + gl;
  if (p >= P || g >= C / V) return;
  A mean[V], mul[V], cc[V], bb[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = g * V + i;
    const A var = variance(stats, C, c, from_moments);
    mean[i] = stats[c];
    mul[i] = mul_rn(rsqrt_(add_rn(var, A(eps))), weight[c]);
    cc[i] = bb[i] = A(0);
    if (dstats) {
      bb[i] = A(2) * dstats[C + c] / A(R);
      cc[i] = (dstats[c] + A(2) * mean[i] * dstats[C + c]) / A(R);
    }
  }
  const long long r0 = blockIdx.x * rows;
  const long long r1 = r0 + rows < R ? r0 + rows : R;
  const Tin* xb = x + (size_t)g * V;
  const Tdy* db = dy + (size_t)g * V;
  Tin* ob = dx + (size_t)g * V;
  for (long long r = r0 + p; r < r1; r += (long long)P * UNROLL) {
    Vec<Tin, V> v[UNROLL];
    Vec<Tdy, V> d[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long rr = r + (long long)u * P;
      if (rr < r1) {
        v[u] = *reinterpret_cast<const Vec<Tin, V>*>(xb + rr * C);
        d[u] = *reinterpret_cast<const Vec<Tdy, V>*>(db + rr * C);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long rr = r + (long long)u * P;
      if (rr < r1) {
        Vec<Tin, V> o;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const A t = fma_(bb[i], sub_rn(up<A>(v[u].v[i]), mean[i]), cc[i]);
          down(fma_(up<A>(d[u].v[i]), mul[i], t), o.v[i]);
        }
        *reinterpret_cast<Vec<Tin, V>*>(ob + rr * C) = o;
      }
    }
  }
}

// ---- host side ---------------------------------------------------------------

template <typename T> constexpr int vec_of() { return 16 / (int)sizeof(T); }

template <typename Tin>
cudaError_t run_stats(const void* x, long long R, int C, void* part, int cap,
                      void* moments, cudaStream_t s) {
  using A = typename AccOf<Tin>::type;
  constexpr int V = vec_of<Tin>();
  const bool vec = C % V == 0 && aligned<Tin>(x, V);
  const int smem = NT * 2 * (vec ? V : 1) * (int)sizeof(double);
  static const long long wave[2] = {
      resident(stats_partial<Tin, 1>, NT * 2 * (int)sizeof(double)),
      resident(stats_partial<Tin, V>, NT * 2 * V * (int)sizeof(double))};
  const Geometry g = geometry(R, C, vec ? V : 1, true, wave[vec], cap);
  if (vec)
    stats_partial<Tin, V><<<g.grid(), NT, smem, s>>>(
        (const Tin*)x, R, C, g.Gs, g.P, g.rows, (double*)part);
  else
    stats_partial<Tin, 1><<<g.grid(), NT, smem, s>>>(
        (const Tin*)x, R, C, g.Gs, g.P, g.rows, (double*)part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  stats_final<A><<<(C + FIN_C - 1) / FIN_C, dim3(FIN_C, FIN_L), 0, s>>>(
      (const double*)part, (int)g.K, C, R, (A*)moments);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t run_norm(const void* x, void* y, long long R, int C,
                     const void* stats, int from_moments, const void* weight,
                     const void* bias, double eps, void* running_mean,
                     void* running_var, double momentum, cudaStream_t s) {
  using A = typename AccOf<Tin>::type;
  constexpr int V = vec_of<Tin>();
  const bool vec = C % V == 0 && aligned<Tin>(x, V) && aligned<Tout>(y, V);
  static const long long wave[2] = {resident(norm_kernel<Tin, Tout, 1>, 0),
                                    resident(norm_kernel<Tin, Tout, V>, 0)};
  const Geometry g = geometry(R, C, vec ? V : 1, false, 2 * wave[vec], 0);
  if (vec)
    norm_kernel<Tin, Tout, V><<<g.grid(), NT, 0, s>>>(
        (const Tin*)x, (Tout*)y, R, C, g.Gs, g.P, g.rows, (const A*)stats,
        from_moments, (const A*)weight, (const A*)bias, eps,
        (A*)running_mean, (A*)running_var, momentum);
  else
    norm_kernel<Tin, Tout, 1><<<g.grid(), NT, 0, s>>>(
        (const Tin*)x, (Tout*)y, R, C, g.Gs, g.P, g.rows, (const A*)stats,
        from_moments, (const A*)weight, (const A*)bias, eps,
        (A*)running_mean, (A*)running_var, momentum);
  return cudaGetLastError();
}

template <typename Tin, typename Tdy>
cudaError_t run_bwd_reduce(const void* dy, const void* x, long long R, int C,
                           void* part, int cap, const void* stats,
                           int from_moments, const void* weight, double eps,
                           void* dweight, void* dbias, void* dstats,
                           cudaStream_t s) {
  using A = typename AccOf<Tin>::type;
  constexpr int V = vec_of<Tin>();
  const bool vec = C % V == 0 && aligned<Tin>(x, V) && aligned<Tdy>(dy, V);
  const int smem = NT * 2 * (vec ? V : 1) * (int)sizeof(double);
  static const long long wave[2] = {
      resident(bwd_partial<Tin, Tdy, 1>, NT * 2 * (int)sizeof(double)),
      resident(bwd_partial<Tin, Tdy, V>, NT * 2 * V * (int)sizeof(double))};
  const Geometry g = geometry(R, C, vec ? V : 1, true, wave[vec], cap);
  if (vec)
    bwd_partial<Tin, Tdy, V><<<g.grid(), NT, smem, s>>>(
        (const Tdy*)dy, (const Tin*)x, R, C, g.Gs, g.P, g.rows,
        (const A*)stats, (double*)part);
  else
    bwd_partial<Tin, Tdy, 1><<<g.grid(), NT, smem, s>>>(
        (const Tdy*)dy, (const Tin*)x, R, C, g.Gs, g.P, g.rows,
        (const A*)stats, (double*)part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_final<A><<<(C + FIN_C - 1) / FIN_C, dim3(FIN_C, FIN_L), 0, s>>>(
      (const double*)part, (int)g.K, C, (const A*)stats, from_moments,
      (const A*)weight, eps, (A*)dweight, (A*)dbias, (A*)dstats);
  return cudaGetLastError();
}

template <typename Tin, typename Tdy>
cudaError_t run_bwd_dx(const void* dy, const void* x, void* dx, long long R,
                       int C, const void* stats, int from_moments,
                       const void* weight, double eps, const void* dstats,
                       cudaStream_t s) {
  using A = typename AccOf<Tin>::type;
  constexpr int V = vec_of<Tin>();
  if (R == 0) return cudaSuccess;
  const bool vec = C % V == 0 && aligned<Tin>(x, V) &&
                   aligned<Tin>(dx, V) && aligned<Tdy>(dy, V);
  static const long long wave[2] = {resident(bwd_dx<Tin, Tdy, 1>, 0),
                                    resident(bwd_dx<Tin, Tdy, V>, 0)};
  const Geometry g = geometry(R, C, vec ? V : 1, false, 2 * wave[vec], 0);
  if (vec)
    bwd_dx<Tin, Tdy, V><<<g.grid(), NT, 0, s>>>(
        (const Tdy*)dy, (const Tin*)x, (Tin*)dx, R, C, g.Gs, g.P, g.rows,
        (const A*)stats, from_moments, (const A*)weight, eps,
        (const A*)dstats);
  else
    bwd_dx<Tin, Tdy, 1><<<g.grid(), NT, 0, s>>>(
        (const Tdy*)dy, (const Tin*)x, (Tin*)dx, R, C, g.Gs, g.P, g.rows,
        (const A*)stats, from_moments, (const A*)weight, eps,
        (const A*)dstats);
  return cudaGetLastError();
}

// dtype codes of the C entries: 0 bf16, 1 float32, 2 float64. The pairs of
// (x, y) dtypes the kernels are built for; dy has y's dtype, dx x's.
#define HVDBN_PAIRS(F)                         \
  F(0, 0, __nv_bfloat16, __nv_bfloat16)        \
  F(0, 1, __nv_bfloat16, float)                \
  F(1, 1, float, float)                        \
  F(1, 0, float, __nv_bfloat16)                \
  F(2, 2, double, double)

}  // namespace hvdbn

using namespace hvdbn;

extern "C" const char* hvd_cuda_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// The most blocks of NT threads the current device holds at once: no
// reduction cuts its rows into more chunks, so a scratch of this many rows
// (or of R, where that is fewer) always suffices.
extern "C" int hvd_bn_max_chunks() {
  int dev = 0, sms = 0, threads = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor,
                         dev);
  const int per = threads / NT;
  return (sms > 0 ? sms : 1) * (per > 0 ? per : 1);
}

// x: rows x C, channels innermost, dtype xk. part: cap x 2 x C scratch
// (the rows are cut into at most cap chunks); moments: (2, C) out.
// Accumulators float32, float64 for float64 x.
extern "C" int hvd_bn_stats(const void* x, int xk, long long R, int C,
                            void* part, int cap, void* moments, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || R < 0 || cap < 1) return (int)cudaErrorInvalidValue;
  switch (xk) {
    case 0: return (int)run_stats<__nv_bfloat16>(x, R, C, part, cap, moments, s);
    case 1: return (int)run_stats<float>(x, R, C, part, cap, moments, s);
    case 2: return (int)run_stats<double>(x, R, C, part, cap, moments, s);
  }
  return (int)cudaErrorInvalidValue;
}

// stats: (2, C) moments (from_moments) or (mean, var) of eval mode; weight
// and bias (C,), all in the accumulator dtype; y: rows x C of dtype yk.
// running_mean and running_var (C,), in the accumulator dtype, move by
// the batch's moments in place, or are null.
extern "C" int hvd_bn_norm(const void* x, int xk, void* y, int yk,
                           long long R, int C, const void* stats,
                           int from_moments, const void* weight,
                           const void* bias, double eps, void* running_mean,
                           void* running_var, double momentum,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || R < 0) return (int)cudaErrorInvalidValue;
#define HVDBN_NORM(XK, YK, TX, TY)                                          \
  if (xk == XK && yk == YK)                                                 \
    return (int)run_norm<TX, TY>(x, y, R, C, stats, from_moments, weight,   \
                                 bias, eps, running_mean, running_var,      \
                                 momentum, s);
  HVDBN_PAIRS(HVDBN_NORM)
#undef HVDBN_NORM
  return (int)cudaErrorInvalidValue;
}

// dy: rows x C of dtype yk; dweight, dbias (C,) and, with from_moments,
// dstats (2, C) out, in the accumulator dtype.
extern "C" int hvd_bn_bwd_reduce(const void* dy, int yk, const void* x,
                                 int xk, long long R, int C, void* part,
                                 int cap, const void* stats, int from_moments,
                                 const void* weight, double eps,
                                 void* dweight, void* dbias, void* dstats,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || R < 0 || cap < 1) return (int)cudaErrorInvalidValue;
#define HVDBN_REDUCE(XK, YK, TX, TY)                                          \
  if (xk == XK && yk == YK)                                                   \
    return (int)run_bwd_reduce<TX, TY>(dy, x, R, C, part, cap, stats,         \
                                       from_moments, weight, eps, dweight,    \
                                       dbias, dstats, s);
  HVDBN_PAIRS(HVDBN_REDUCE)
#undef HVDBN_REDUCE
  return (int)cudaErrorInvalidValue;
}

// dx: rows x C of x's dtype out. dstats: the (2, C) cotangents of the
// moments (training mode), or null (eval mode: dx = dy mul).
extern "C" int hvd_bn_bwd_dx(const void* dy, int yk, const void* x, int xk,
                             void* dx, long long R, int C, const void* stats,
                             int from_moments, const void* weight, double eps,
                             const void* dstats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || R < 0) return (int)cudaErrorInvalidValue;
#define HVDBN_DX(XK, YK, TX, TY)                                            \
  if (xk == XK && yk == YK)                                                 \
    return (int)run_bwd_dx<TX, TY>(dy, x, dx, R, C, stats, from_moments,    \
                                   weight, eps, dstats, s);
  HVDBN_PAIRS(HVDBN_DX)
#undef HVDBN_DX
  return (int)cudaErrorInvalidValue;
}
