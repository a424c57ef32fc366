// K6: GroupNorm for serving, with the ReLU and the next conv's activation
// quantizer fused in, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package has no GroupNorm.  The port
// added it for SegResNet (MONAI; Myronenko, BraTS 2018), whose ResBlocks
// put GN -> ReLU before every quantized conv; a GroupNorm's statistics
// depend on the data, so unlike a BatchNorm it cannot be folded into the
// conv at deployment (kernels/groupnorm.py, routed by
// ptq/deploy.py::group_norm_serving).
//
//   x:     (N, S, C) = (N, D, H, W, C), NDHWC, float32 or bfloat16
//   gamma, beta: (C,) float32
//   out:   int8 codes round(clip(y / alpha, 0, 1) * (qlvl - 1)) of the
//          consuming conv (qlvl > 0; the clip at 0 is the ReLU), or y
//          (ReLU'd with relu) in x's type
//   y = ((x - mean_g) * a_c) + beta_c, each step rounded in float32, with
//   mean_g = float32(mean), a_c = float32(gamma_c / sqrt(var + eps)) taken
//   from float64 statistics of (sample, group g): C / G channels x S
//   voxels, the biased variance.
//
// Arithmetic.  The statistics are reduced in float64: per block a local
// two-pass (count, mean, M2) from the values it holds in registers, then
// Chan's combination of the blocks' triples in a fixed order.  Rounded
// once to float32, they equal the plain version's (two float64 passes in
// PyTorch) but where the float64 values sit within their own rounding
// error of a float32 rounding boundary.  A full-resolution SegResNet
// group is 4 channels x 3.93 M voxels = 15.7 M elements, so a float32
// running sum, or E[x^2] - E[x]^2, would be off in its last bits.  The
// elementwise steps use the _rn intrinsics (the build passes -fmad=false),
// rintf rounds half to even: the plain version's roundings, step by step.
//
// What bounds it on an H100 (3.35 TB/s): bytes.  A call must read x once
// and write its output once, 5 bytes an element with codes; it reads x
// twice (statistics, then the apply), 9 bytes, since a patch's group does
// not fit on chip (8 patches of 128 x 192 x 160 x 32 float32 are 4 GB).
// The float64 work, about 4 operations an element, stays under the
// memory's time.  Folding the statistics into the producing K1's epilogue
// would save the first read.
//
// Design.  Three launches on the caller's stream:
//  - stats: a block of 256 threads holds 8 vectors of V channels a thread
//    (V = 4, 2 or 1: the most that divides the group's C / G channels, so a
//    vector lies in one group), 2048 V contiguous elements of one sample.
//    256 V is a multiple of C, so each thread stays on one group.  The
//    group sums of the block are warp butterflies over the lanes that share
//    a group, then a sum over the 8 warps in order: deterministic.
//  - finalize: one block per (group, sample) combines the blocks' triples,
//    a strided share a thread, then a tree in shared memory, and writes
//    float32 mean_g and the group's channel scales a_c.
//  - apply: one vector a thread, 16-byte loads of float32 x, 4-byte stores
//    of codes.
// C and C / G are powers of two, G <= 32 and C <= 256 V (the wrapper
// checks); offsets are 64-bit.
//
// One channel a group (InstanceNorm, G = C: SwinUNETR's, 48 to 768
// channels, not powers of two) takes a stats kernel of its own
// (effq_group_norm_launch_ch): a block of R x L threads, L = C / V lanes
// one voxel's channels span, R = 256 / L voxel rows, holds 8 rows a thread
// and reduces each channel over the block's rows in shared memory, in
// order; finalize is the same, and apply indexes channels by a remainder
// instead of a mask.  C <= 1024 and C / V <= 256 (the wrapper checks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;    // vectors a thread holds in the stats pass
constexpr int GMAX = 32;    // groups a call may have
constexpr int CMAX = 1024;  // channels of a one-channel-a-group call

struct Part {
  double n, mean, m2;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* d) { *d = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* d) {
  *d = __float2bfloat16_rn(v);
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, long long e, float (&v)[V]) {
  const Pack<T, V> k = *reinterpret_cast<const Pack<T, V>*>(p + e);
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = to_f(k.v[j]);
}

// Sums over the lanes of a warp that share this lane's group: lanes
// `lpg` apart-or-less within a group of consecutive lanes, and lanes a
// multiple of `row` apart (the same channels one voxel on).
template <typename U>
__device__ __forceinline__ U group_sum(U s, int lpg, int row) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o < lpg || o >= row) s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  return s;
}

// Chan's parallel combination of (n, mean, M2) triples, in float64.
__device__ __forceinline__ void combine(double& n, double& m, double& m2,
                                        double nb, double mb, double m2b) {
  if (nb == 0.0) return;
  if (n == 0.0) {
    n = nb;
    m = mb;
    m2 = m2b;
    return;
  }
  const double t = n + nb;
  const double d = mb - m;
  m = m + d * (nb / t);
  m2 = m2 + m2b + d * d * (n * nb / t);
  n = t;
}

// Block b of sample n: elements [b * span, (b + 1) * span) of the sample,
// span = THREADS * V * ITEMS; writes the block's (n, mean, M2) of each
// group to part[(n * blocks + b) * G + g].
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    effq_group_norm_stats_kernel(const T* __restrict__ x,
                                 Part* __restrict__ part,
                                 long long per_sample, int C, int cg, int G) {
  __shared__ double wsum[WARPS][GMAX];
  __shared__ int wcnt[WARPS][GMAX];
  __shared__ double gmean[GMAX];
  const int n = blockIdx.y, b = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int lpg = cg / V;   // lanes a group spans in one voxel
  const int row = C / V;    // lanes one voxel's channels span
  const int g = ((t * V) & (C - 1)) / cg;
  const bool leader = lane < row && (lane & (lpg - 1)) == 0;
  const T* xs = x + static_cast<long long>(n) * per_sample;
  const long long base =
      static_cast<long long>(b) * THREADS * V * ITEMS +
      static_cast<long long>(t) * V;

  float v[ITEMS][V];
  int cnt = 0;
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long e = base + static_cast<long long>(i) * THREADS * V;
    if (e < per_sample) {
      load<T, V>(xs, e, v[i]);
      cnt += V;
#pragma unroll
      for (int j = 0; j < V; ++j) s += static_cast<double>(v[i][j]);
    }
  }
  // pass 1: the block's count and sum of each group
  s = group_sum(s, lpg, row);
  cnt = group_sum(cnt, lpg, row);
  if (lane < G) {
    wsum[warp][lane] = 0.0;
    wcnt[warp][lane] = 0;
  }
  __syncwarp();
  if (leader) {
    wsum[warp][g] = s;
    wcnt[warp][g] = cnt;
  }
  __syncthreads();
  if (t < G) {
    double tot = 0.0;
    int k = 0;
    for (int w = 0; w < WARPS; ++w) {
      tot += wsum[w][t];
      k += wcnt[w][t];
    }
    gmean[t] = k ? tot / static_cast<double>(k) : 0.0;
  }
  __syncthreads();
  // pass 2: the sum of squared deviations from the block's group mean
  const double m = gmean[g];
  double q = 0.0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long e = base + static_cast<long long>(i) * THREADS * V;
    if (e < per_sample) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const double d = static_cast<double>(v[i][j]) - m;
        q += d * d;
      }
    }
  }
  q = group_sum(q, lpg, row);
  __syncthreads();  // every warp has read gmean and wsum of pass 1
  if (lane < G) wsum[warp][lane] = 0.0;
  __syncwarp();
  if (leader) wsum[warp][g] = q;
  __syncthreads();
  if (t < G) {
    double m2 = 0.0;
    int k = 0;
    for (int w = 0; w < WARPS; ++w) {
      m2 += wsum[w][t];
      k += wcnt[w][t];
    }
    Part p;
    p.n = static_cast<double>(k);
    p.mean = gmean[t];
    p.m2 = m2;
    part[(static_cast<long long>(n) * gridDim.x + b) * G + t] = p;
  }
}

// One block per (group g, sample n): the group's statistics from the
// blocks' triples, as float32 mean_g and channel scales a_c.
__global__ void __launch_bounds__(THREADS)
    effq_group_norm_finalize_kernel(const Part* __restrict__ part,
                                    const float* __restrict__ gamma,
                                    float* __restrict__ mean_out,
                                    float* __restrict__ scale_out,
                                    int blocks, int C, int cg, int G,
                                    double eps) {
  __shared__ double sn[THREADS], sm[THREADS], s2[THREADS];
  __shared__ double rstd;
  const int g = blockIdx.x, n = blockIdx.y, t = threadIdx.x;
  double cn = 0.0, cm = 0.0, c2 = 0.0;
  for (int b = t; b < blocks; b += THREADS) {
    const Part p = part[(static_cast<long long>(n) * blocks + b) * G + g];
    combine(cn, cm, c2, p.n, p.mean, p.m2);
  }
  sn[t] = cn;
  sm[t] = cm;
  s2[t] = c2;
  __syncthreads();
  for (int h = THREADS / 2; h > 0; h >>= 1) {
    if (t < h) {
      double a = sn[t], am = sm[t], a2 = s2[t];
      combine(a, am, a2, sn[t + h], sm[t + h], s2[t + h]);
      sn[t] = a;
      sm[t] = am;
      s2[t] = a2;
    }
    __syncthreads();
  }
  if (t == 0) {
    const double var = sn[0] > 0.0 ? s2[0] / sn[0] : 0.0;
    rstd = 1.0 / sqrt(var + eps);
    mean_out[static_cast<long long>(n) * G + g] = static_cast<float>(sm[0]);
  }
  __syncthreads();
  for (int j = t; j < cg; j += THREADS) {
    const int c = g * cg + j;
    scale_out[static_cast<long long>(n) * C + c] =
        static_cast<float>(static_cast<double>(gamma[c]) * rstd);
  }
}

// One vector of V channels a thread: y = ((x - mean) * a) + beta, then the
// codes of relu(y) (CODES) or y, relu'd with relu, in T.
template <typename T, int V, bool CODES, bool POW2 = true>
__global__ void __launch_bounds__(THREADS)
    effq_group_norm_apply_kernel(const T* __restrict__ x,
                                 void* __restrict__ out,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ beta,
                                 const float* __restrict__ qalpha,
                                 long long per_sample, int C, int cg, int G,
                                 float qmax, int relu) {
  const int n = blockIdx.y;
  const long long i =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * V;
  if (i >= per_sample) return;
  const int c = POW2 ? static_cast<int>(i & (C - 1))
                     : static_cast<int>(i % C);
  // a vector lies in one group where the group's channels are a power
  // of two; one channel a group takes each channel's own mean
  const float* gm = mean + static_cast<long long>(n) * G;
  const float m = __ldg(gm + c / cg);
  const float* a = scale + static_cast<long long>(n) * C + c;
  const long long e = static_cast<long long>(n) * per_sample + i;
  float v[V];
  load<T, V>(x, e, v);
  float y[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float mj = POW2 ? m : __ldg(gm + (c + j) / cg);
    y[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[j], mj), __ldg(a + j)),
                     __ldg(beta + c + j));
  }
  if (CODES) {
    const float alpha = __ldg(qalpha);
    Pack<int8_t, V> k;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float u = fminf(fmaxf(__fdiv_rn(y[j], alpha), 0.0f), 1.0f);
      k.v[j] = static_cast<int8_t>(rintf(__fmul_rn(u, qmax)));
    }
    *reinterpret_cast<Pack<int8_t, V>*>(static_cast<int8_t*>(out) + e) = k;
  } else {
    Pack<T, V> k;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      from_f(relu ? fmaxf(y[j], 0.0f) : y[j], &k.v[j]);
    }
    *reinterpret_cast<Pack<T, V>*>(static_cast<T*>(out) + e) = k;
  }
}

// One channel a group: block b of sample n holds voxels [b * R * ITEMS,
// (b + 1) * R * ITEMS) of the sample, thread t < R L the channels
// [(t % L) V, (t % L + 1) V) of rows t / L + R i; writes the block's (n,
// mean, M2) of each channel to part[(n * blocks + b) * C + c].
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    effq_group_norm_stats_ch_kernel(const T* __restrict__ x,
                                    Part* __restrict__ part,
                                    long long voxels, int C) {
  __shared__ double rows[THREADS * V];
  __shared__ double cmean[CMAX];
  const int L = C / V, R = THREADS / L;
  const int n = blockIdx.y, b = blockIdx.x, t = threadIdx.x;
  const bool active = t < R * L;
  const int cv = t % L, r0 = t / L;
  const long long v0 = static_cast<long long>(b) * R * ITEMS;
  const long long left = voxels - v0;
  const int count = static_cast<int>(left < R * ITEMS ? left : R * ITEMS);
  const T* xs = x + static_cast<long long>(n) * voxels * C;
  float v[ITEMS][V];
  double s[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = 0.0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int r = r0 + i * R;
    if (active && r < count) {
      load<T, V>(xs, (v0 + r) * C + cv * V, v[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] += static_cast<double>(v[i][j]);
    }
  }
  // pass 1: each channel's sum over the block's rows, in row order
  if (active) {
#pragma unroll
    for (int j = 0; j < V; ++j) rows[t * V + j] = s[j];
  }
  __syncthreads();
  for (int c = t; c < C; c += THREADS) {
    double tot = 0.0;
    for (int r = 0; r < R; ++r) tot += rows[(r * L + c / V) * V + c % V];
    cmean[c] = tot / static_cast<double>(count);
  }
  __syncthreads();
  // pass 2: the sums of squared deviations from the block's channel means
  double q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) q[j] = 0.0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int r = r0 + i * R;
    if (active && r < count) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const double d = static_cast<double>(v[i][j]) - cmean[cv * V + j];
        q[j] += d * d;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < V; ++j) rows[t * V + j] = q[j];
  }
  __syncthreads();
  for (int c = t; c < C; c += THREADS) {
    double m2 = 0.0;
    for (int r = 0; r < R; ++r) m2 += rows[(r * L + c / V) * V + c % V];
    Part p;
    p.n = static_cast<double>(count);
    p.mean = cmean[c];
    p.m2 = m2;
    part[(static_cast<long long>(n) * gridDim.x + b) * C + c] = p;
  }
}

template <typename T, int V>
int launch(const void* x, void* out, const float* gamma, const float* beta,
           const float* qalpha, void* part, float* mean, float* scale,
           long long N, long long per_sample, int C, int G, double eps,
           int relu, int qlvl, cudaStream_t stream) {
  const int cg = C / G;
  const long long span = static_cast<long long>(THREADS) * V * ITEMS;
  const long long blocks = (per_sample + span - 1) / span;
  const long long vecs = per_sample / V;
  const long long apply_blocks = (vecs + THREADS - 1) / THREADS;
  const T* xt = static_cast<const T*>(x);
  Part* p = static_cast<Part*>(part);
  effq_group_norm_stats_kernel<T, V>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(N)),
         THREADS, 0, stream>>>(xt, p, per_sample, C, cg, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  effq_group_norm_finalize_kernel<<<dim3(G, static_cast<unsigned>(N)),
                                    THREADS, 0, stream>>>(
      p, gamma, mean, scale, static_cast<int>(blocks), C, cg, G, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(apply_blocks),
                  static_cast<unsigned>(N));
  const float qmax = static_cast<float>(qlvl - 1);
  if (qlvl) {
    effq_group_norm_apply_kernel<T, V, true><<<grid, THREADS, 0, stream>>>(
        xt, out, mean, scale, beta, qalpha, per_sample, C, cg, G, qmax, 0);
  } else {
    effq_group_norm_apply_kernel<T, V, false><<<grid, THREADS, 0, stream>>>(
        xt, out, mean, scale, beta, qalpha, per_sample, C, cg, G, qmax,
        relu);
  }
  return static_cast<int>(cudaGetLastError());
}

// One channel a group: the channel stats, the same finalize (G = C, one
// channel a group) and the apply with channels by remainder.
template <typename T, int V>
int launch_ch(const void* x, void* out, const float* gamma, const float* beta,
              const float* qalpha, void* part, float* mean, float* scale,
              long long N, long long per_sample, int C, double eps, int relu,
              int qlvl, cudaStream_t stream) {
  const long long voxels = per_sample / C;
  const int rows = THREADS / (C / V) * ITEMS;
  const long long blocks = (voxels + rows - 1) / rows;
  const long long vecs = per_sample / V;
  const long long apply_blocks = (vecs + THREADS - 1) / THREADS;
  const T* xt = static_cast<const T*>(x);
  Part* p = static_cast<Part*>(part);
  effq_group_norm_stats_ch_kernel<T, V>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(N)),
         THREADS, 0, stream>>>(xt, p, voxels, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  effq_group_norm_finalize_kernel<<<dim3(C, static_cast<unsigned>(N)),
                                    THREADS, 0, stream>>>(
      p, gamma, mean, scale, static_cast<int>(blocks), C, 1, C, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(apply_blocks),
                  static_cast<unsigned>(N));
  const float qmax = static_cast<float>(qlvl - 1);
  if (qlvl) {
    effq_group_norm_apply_kernel<T, V, true, false>
        <<<grid, THREADS, 0, stream>>>(xt, out, mean, scale, beta, qalpha,
                                       per_sample, C, 1, C, qmax, 0);
  } else {
    effq_group_norm_apply_kernel<T, V, false, false>
        <<<grid, THREADS, 0, stream>>>(xt, out, mean, scale, beta, qalpha,
                                       per_sample, C, 1, C, qmax, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vec(int vec, const void* x, void* out, const float* gamma,
               const float* beta, const float* qalpha, void* part,
               float* mean, float* scale, long long N, long long per_sample,
               int C, int G, double eps, int relu, int qlvl,
               cudaStream_t stream) {
  switch (vec) {
    case 4:
      return launch<T, 4>(x, out, gamma, beta, qalpha, part, mean, scale, N,
                          per_sample, C, G, eps, relu, qlvl, stream);
    case 2:
      return launch<T, 2>(x, out, gamma, beta, qalpha, part, mean, scale, N,
                          per_sample, C, G, eps, relu, qlvl, stream);
    case 1:
      return launch<T, 1>(x, out, gamma, beta, qalpha, part, mean, scale, N,
                          per_sample, C, G, eps, relu, qlvl, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The wrapper (kernels/groupnorm.py) allocates out, the blocks' triples
// part ((N, blocks, G) x 3 float64, blocks = ceil(per_sample / (2048
// vec))), mean (N, G) and scale (N, C) float32, and checks the shapes.
extern "C" int effq_group_norm_launch(const void* x, void* out,
                                      const float* gamma, const float* beta,
                                      const float* qalpha, void* part,
                                      float* mean, float* scale, long long N,
                                      long long per_sample, int C, int G,
                                      double eps, int relu, int qlvl,
                                      int x_bf16, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return launch_vec<__nv_bfloat16>(vec, x, out, gamma, beta, qalpha, part,
                                     mean, scale, N, per_sample, C, G, eps,
                                     relu, qlvl, s);
  }
  return launch_vec<float>(vec, x, out, gamma, beta, qalpha, part, mean,
                           scale, N, per_sample, C, G, eps, relu, qlvl, s);
}

// One channel a group (G = C), any C <= 1024 with C / vec <= 256: the
// same buffers, part (N, blocks, C) x 3 float64 with blocks = ceil(voxels
// / (256 / (C / vec) * 8)), mean (N, C).
extern "C" int effq_group_norm_ch_launch(const void* x, void* out,
                                         const float* gamma,
                                         const float* beta,
                                         const float* qalpha, void* part,
                                         float* mean, float* scale,
                                         long long N, long long per_sample,
                                         int C, double eps, int relu,
                                         int qlvl, int x_bf16, int vec,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || C > CMAX || vec < 1 || C % vec || C / vec > THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
#define GN_CH(T, V)                                                         \
  return launch_ch<T, V>(x, out, gamma, beta, qalpha, part, mean, scale, N, \
                         per_sample, C, eps, relu, qlvl, s);
  if (x_bf16) {
    if (vec == 4) GN_CH(__nv_bfloat16, 4)
    if (vec == 2) GN_CH(__nv_bfloat16, 2)
    GN_CH(__nv_bfloat16, 1)
  }
  if (vec == 4) GN_CH(float, 4)
  if (vec == 2) GN_CH(float, 2)
  GN_CH(float, 1)
#undef GN_CH
}
