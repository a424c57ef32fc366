// K4: the fused fake-quant float32 1x1 matmul, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// pallas/qmatmul.py::fused_qact_matmul (body _qact_matmul_kernel), which
// qconv1x1_ndhwc runs for the activation-quantized 1x1x1 convs that are not
// on the int8 path (the mixed deployment, fq mode).
//
//   x:      (M, K) float32 or bfloat16 activations (bf16 promoted to float32)
//   w:      (K, N) float32 weights
//   bias:   (N,) float32, or null for none
//   alpha:  the activation clip, a (1,) float32 on the device, or (alpha_p
//           null) the value alpha_v
//   delta:  float32(1 / (qlvl - 1)), rounded once on the host
//
//   fq(v) = rint(clip(v / alpha, 0, 1) / delta) * delta * alpha
//   y[m, n] = sum_k fq(x[m, k]) * w[k, n] + bias[n]
//
// fq rounds as the Pallas kernel's prologue does, step by step (_rn
// intrinsics; the build passes -fmad=false).  The product is full float32:
// the Pallas kernel asks for Precision.HIGHEST, so TF32 is not allowed.  The
// sum is a chain of __fmaf_rn over k in order, one rounding per term; it
// differs from another float32 sum order (the plain version's cuBLAS GEMM)
// at the level of float32 rounding.
//
// What bounds it.  At the flagship's widest 1x1s (B = 8 patches, M =
// 262144) the bytes: 16.8-33.6 MB of bf16 x in and 33.6-67.1 MB of float32 y
// out; at the others (M = 4096-32768, K and N of 64-256) the float32
// operations at the card's 67 TFLOP/s peak off the tensor cores.  So x is
// read and fake-quantized once, the sums stay in registers, and y is
// written once with 16-byte stores.
//
// Design.  A block of 256 threads owns a column chunk of nc <= 256 columns
// (all of N where it fits; blockIdx.y numbers the chunks) and walks row
// tiles of bm rows: block x takes tiles x, x + gridDim.x, ... (persistent
// blocks).  Its chunk's weights (K rounded up to 32 rows, zero filled)
// arrive in shared memory with its first tile's x and stay for every later
// tile.  Each step is one (tile, 32-wide K slice) of x.  Two raw slices,
// loaded with cp.async (16 bytes, zero fill past M and K), keep the next
// slice in flight (a deeper ring measured slower at the flagship's widest
// shapes), and slice s + 1 is fake-quantized, once per element, into the
// second of two k-major fq(x) tiles between the FMAs of step s, so a step
// takes one barrier.  With at most 4 levels the fake-quant takes no divide
// (convert_piece): a code is the count of thresholds that x reaches, each
// threshold found once per warp with fq_code itself.  A thread owns a
// 4 x (4 RN) tile of y in registers, a row quad and RN column quads strided
// by the block's width, and warps are 8-wide tiles of that thread grid, so
// a warp's float4 operand reads touch one shared-memory wavefront each and
// its float4 stores of y are contiguous 128-byte row segments.  RN, nc and
// the grid come from
// kernels/qmatmul.py::_k4_plan.  Rows of x that are not 16-byte aligned
// (K * element size not a multiple of 16, or a misaligned x) are staged
// with plain element loads instead of cp.async.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 32;             // K per step
constexpr int SMEM_MAX = 232448;   // opt-in shared memory of one block

struct Args {
  const void* x;
  const float* w;
  const float* bias;
  const float* alpha_p;
  float* y;
  float alpha_v, delta;
  int M, K, N;
  int nc;         // columns per block
  int tx_n;       // threads along the columns: nc / (4 RN)
  int bm;         // rows per tile: (256 / tx_n) * 4, a power of 2
  int bm_log2;
  int tiles;      // ceil(M / bm)
  int kp;         // K rounded up to BK
  int raw_row;    // bytes of one staged raw row: BK elements + 16
  int raw_bytes;  // one raw slice, a multiple of 128
};

// the code of v, rint(clip(v / alpha, 0, 1) / delta), as a float
__device__ __forceinline__ float fq_code(float v, float alpha, float delta) {
  const float q = fminf(fmaxf(__fdiv_rn(v, alpha), 0.0f), 1.0f);
  return rintf(__fdiv_rn(q, delta));
}

// the value of code c, c * delta * alpha rounded step by step
__device__ __forceinline__ float fq_value(float c, float alpha, float delta) {
  return __fmul_rn(__fmul_rn(c, delta), alpha);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the float values of one 16-byte piece of raw x
__device__ __forceinline__ void unpack(const uint4 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4 v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);            // low bf16
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);  // high bf16
  }
}

// Stage step (tile t, K slice k0) of raw x into `raw`: rows of BK elements
// at raw_row bytes apart, zero past M and K.
template <typename T, bool VEC>
__device__ __forceinline__ void load_raw(const Args& a, char* raw, int t,
                                         int k0) {
  using Bits = typename std::conditional<sizeof(T) == 2, uint16_t,
                                         uint32_t>::type;
  const long long m0 = static_cast<long long>(t) * a.bm;
  if (VEC) {
    constexpr int EPP = 16 / sizeof(T);  // elements per 16-byte piece
    constexpr int P = BK / EPP;          // pieces per row
    const char* xb = static_cast<const char*>(a.x);
    for (int e = threadIdx.x; e < a.bm * P; e += THREADS) {
      const int r = e / P, j = e % P;
      const long long m = m0 + r;
      const int k = k0 + j * EPP;
      const bool valid = m < a.M && k < a.K;
      const char* src =
          valid ? xb + (m * a.K + k) * static_cast<long long>(sizeof(T)) : xb;
      cp_async16(smem_u32(raw + r * a.raw_row + j * 16), src, valid);
    }
  } else {
    const Bits* xb = static_cast<const Bits*>(a.x);
    for (int e = threadIdx.x; e < a.bm * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      const long long m = m0 + r;
      const int k = k0 + kk;
      reinterpret_cast<Bits*>(raw + r * a.raw_row)[kk] =
          (m < a.M && k < a.K) ? xb[m * a.K + k] : Bits(0);
    }
  }
}

// The fake-quant of one call: with `thresh`, t[c - 1] is the least x whose
// code is c or more (NaN past the last code: no x reaches it)
struct Fq {
  float alpha, delta;
  float t[3];
  bool thresh;
};

// The least float x with fq_code(x) >= c, for alpha in [2^-60, 2^60]: fq_code
// is monotone in x, so of the 32 consecutive floats around alpha * delta *
// (c - 0.5), one per lane, the first that reaches c is it, when the first
// lane's does not.  All 32 lanes call it; `found` is false when the window
// misses.
__device__ __forceinline__ float fq_threshold(float c, float alpha,
                                              float delta, bool& found) {
  const float mid = __fmul_rn(__fmul_rn(c - 0.5f, delta), alpha);
  const float x =
      __uint_as_float(__float_as_uint(mid) + (threadIdx.x & 31u) - 16u);
  const unsigned hit =
      __ballot_sync(0xffffffffu, fq_code(x, alpha, delta) >= c);
  found = hit != 0 && (hit & 1u) == 0;
  return __shfl_sync(0xffffffffu, x, found ? __ffs(hit) - 1 : 0);
}

// The fake-quant parameters of one call, the same in every warp: thresholds
// for at most 4 levels and alpha in [2^-60, 2^60], where the window finds
// them all; else every element takes fq_code's divides.
__device__ Fq fq_setup(float alpha, float delta) {
  Fq q;
  q.alpha = alpha;
  q.delta = delta;
  const float cmax = fq_code(__uint_as_float(0x7f800000u), alpha, delta);
  q.thresh = alpha >= 0x1p-60f && alpha <= 0x1p60f && cmax <= 3.0f;
  const bool few = q.thresh;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q.t[c] = __int_as_float(0x7fffffff);
    if (few && c + 1 <= cmax) {  // uniform over the warp
      bool found;
      q.t[c] = fq_threshold(c + 1.0f, alpha, delta, found);
      q.thresh = q.thresh && found;
    }
  }
  return q;
}

// Fake-quantize piece e of one raw slice (16 bytes of a row: rows r
// fastest, so the stores to the k-major dst[k][r] are consecutive words).
// With thresholds a code is the count of thresholds x reaches: the code
// fq_code gives, by monotony, with no divide (NaN reaches none: code 0, as
// the clip takes it).  Else fq_code's divides.
template <typename T>
__device__ __forceinline__ void convert_piece(const Args& a, int e,
                                              const char* raw, float* dst,
                                              const Fq& q) {
  constexpr int EPP = 16 / sizeof(T);
  const int r = e & (a.bm - 1), j = e >> a.bm_log2;
  float f[EPP];
  unpack(*reinterpret_cast<const uint4*>(raw + r * a.raw_row + j * 16), f);
  float* out = dst + j * EPP * a.bm + r;
  if (q.thresh) {
#pragma unroll
    for (int i = 0; i < EPP; ++i) {
      const float c = __fadd_rn(__fadd_rn(f[i] >= q.t[0] ? 1.0f : 0.0f,
                                          f[i] >= q.t[1] ? 1.0f : 0.0f),
                                f[i] >= q.t[2] ? 1.0f : 0.0f);
      out[i * a.bm] = fq_value(c, q.alpha, q.delta);
    }
  } else {
#pragma unroll
    for (int i = 0; i < EPP; ++i)
      out[i * a.bm] = fq_value(fq_code(f[i], q.alpha, q.delta), q.alpha,
                               q.delta);
  }
}

template <typename T, int RN, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) qmatmul_f32_kernel(Args a) {
  extern __shared__ __align__(128) char smem[];
  constexpr int EPP = 16 / sizeof(T);
  constexpr int P = BK / EPP;  // 16-byte pieces per raw row
  // pieces a thread converts per step (bm <= 128 RN), one after every
  // EVERY steps of the FMA loop
  constexpr int PIECES = 128 * RN * P / THREADS;
  constexpr int EVERY = BK / PIECES;
  float* Ws = reinterpret_cast<float*>(smem);  // [kp][nc]
  float* As = Ws + a.kp * a.nc;                // 2 x [BK][bm], fq(x)
  char* raw0 = reinterpret_cast<char*>(As + 2 * BK * a.bm);  // 2 raw x slices
  // threads on the (ty, tx) grid in warp tiles of (32 / lx) x lx, lx =
  // min(8, tx_n): a warp's float4 operand reads then touch at most 8
  // distinct quads of w and 4 of fq(x), one shared-memory wavefront each
  const int tid = threadIdx.x;
  const int lx = a.tx_n < 8 ? a.tx_n : 8, wx_n = a.tx_n / lx;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = (warp % wx_n) * lx + lane % lx;
  const int ty = (warp / wx_n) * (32 / lx) + lane / lx;
  const int n0 = blockIdx.y * a.nc;
  const float alpha = a.alpha_p != nullptr ? *a.alpha_p : a.alpha_v;
  const int nkc = a.kp / BK;
  const int my_tiles = (a.tiles - 1 - blockIdx.x) / gridDim.x + 1;
  const int nsteps = my_tiles * nkc;
  const int pieces = a.bm * P;  // per raw slice
  // Slice q (step q's x) is (tile, K slice) (x + (q / nkc) gridDim.x, q %
  // nkc), staged in raw slot q % 2.  The chunk's weights arrive with the
  // first tile's slices: slice q < nkc also brings weight rows [32 q,
  // 32 q + 32) (16-byte pieces where the rows of w allow, else plain
  // loads), which stay for every later tile.
  const bool wvec = a.N % 4 == 0 && reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  auto load_slice = [&](int q) {
    load_raw<T, VEC>(a, raw0 + (q & 1) * a.raw_bytes,
                     blockIdx.x + (q / nkc) * gridDim.x, (q % nkc) * BK);
    if (q >= nkc) return;
    if (wvec) {
      const int qn = a.nc / 4;
      for (int e = tid; e < BK * qn; e += THREADS) {
        const int k = q * BK + e / qn, n = n0 + (e % qn) * 4;
        const bool valid = k < a.K && n < a.N;
        cp_async16(smem_u32(Ws + k * a.nc + (n - n0)),
                   valid ? a.w + static_cast<long long>(k) * a.N + n : a.w,
                   valid);
      }
    } else {
      for (int e = tid; e < BK * a.nc; e += THREADS) {
        const int k = q * BK + e / a.nc, n = n0 + e % a.nc;
        Ws[k * a.nc + e % a.nc] =
            (k < a.K && n < a.N) ? a.w[static_cast<long long>(k) * a.N + n]
                                 : 0.0f;
      }
    }
  };

  // slices 0 and 1 in one cp.async group each
  for (int q = 0; q < 2; ++q) {
    if (q < nsteps) load_slice(q);
    cp_async_commit();
  }
  float bias[4 * RN];
  const bool quads = (a.N % 4) == 0;
#pragma unroll
  for (int p = 0; p < RN; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + p * a.tx_n * 4 + tx * 4 + j;
      bias[p * 4 + j] = (a.bias != nullptr && n < a.N) ? a.bias[n] : 0.0f;
    }
  const Fq fq = fq_setup(alpha, a.delta);

  cp_async_wait<1>();  // slice 0 has landed
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PIECES; ++i)
    if (i * THREADS < pieces) {
      convert_piece<T>(a, min(tid + i * THREADS, pieces - 1), raw0, As, fq);
    }

  float acc[4][4 * RN];
  for (int s = 0; s < nsteps; ++s) {
    // slice s + 1 has landed; step s's fq(x) is complete; the slot of
    // slice s (converted during step s - 1) takes slice s + 2
    cp_async_wait<0>();
    __syncthreads();
    if (s + 2 < nsteps) load_slice(s + 2);
    cp_async_commit();
    const int kc = s % nkc;
    const int t = blockIdx.x + (s / nkc) * gridDim.x;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4 * RN; ++j) acc[i][j] = 0.0f;
    }
    const float* Wk = Ws + kc * BK * a.nc + tx * 4;
    const float* Ak = As + (s & 1) * BK * a.bm + ty * 4;
    // step s + 1's slice (stale past the last step: unused) fake-quantized
    // into the other fq(x) buffer between the FMAs
    const char* raw_next = raw0 + ((s + 1) & 1) * a.raw_bytes;
    float* A_next = As + ((s + 1) & 1) * BK * a.bm;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 u = *reinterpret_cast<const float4*>(Ak + kk * a.bm);
      const float av[4] = {u.x, u.y, u.z, u.w};
      float bv[4 * RN];
#pragma unroll
      for (int p = 0; p < RN; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(
            Wk + kk * a.nc + p * a.tx_n * 4);
        bv[4 * p] = v.x; bv[4 * p + 1] = v.y;
        bv[4 * p + 2] = v.z; bv[4 * p + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4 * RN; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      if (kk % EVERY == EVERY - 1) {
        const int i = kk / EVERY;
        if (i * THREADS < pieces)
          convert_piece<T>(a, min(tid + i * THREADS, pieces - 1), raw_next,
                           A_next, fq);
      }
    }
    if (kc == nkc - 1) {  // the tile is summed: bias, 16-byte stores
      const long long m0 = static_cast<long long>(t) * a.bm + ty * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long m = m0 + e;
        if (m >= a.M) continue;
        float* row = a.y + m * a.N;
#pragma unroll
        for (int p = 0; p < RN; ++p) {
          const int n = n0 + p * a.tx_n * 4 + tx * 4;
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = acc[e][p * 4 + j];
            if (a.bias != nullptr) v[j] = __fadd_rn(v[j], bias[p * 4 + j]);
          }
          if (quads && n + 3 < a.N) {
            *reinterpret_cast<float4*>(row + n) =
                make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n + j < a.N) row[n + j] = v[j];
          }
        }
      }
    }
  }
}

template <typename T, int RN, bool VEC>
int launch(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  auto kernel = qmatmul_f32_kernel<T, RN, VEC>;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RN>
int launch_vec(const Args& a, bool vec, dim3 grid, int smem, cudaStream_t s) {
  return vec ? launch<T, RN, true>(a, grid, smem, s)
             : launch<T, RN, false>(a, grid, smem, s);
}

template <typename T>
int launch_tile(const Args& a, int rn, bool vec, dim3 grid, int smem,
                cudaStream_t s) {
  return rn == 2 ? launch_vec<T, 2>(a, vec, grid, smem, s)
                 : launch_vec<T, 1>(a, vec, grid, smem, s);
}

}  // namespace

// One call's shape and plan, as kernels/qmatmul.py::_K4Call lays it out:
// (nc columns per block, RN column quads per thread, grid_x persistent
// blocks per column chunk) from _k4_plan
struct K4Call {
  int M, K, N;
  float delta;
  int x_bf16, nc, rn, grid_x;
};

// Plain C entry point for ctypes.  x is bfloat16 with call->x_bf16, else
// float32; bias is null for none; alpha is null to take alpha_v; y is (M, N)
// float32, 16-byte aligned.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), the error of cudaFuncSetAttribute, or
// cudaErrorInvalidValue for a plan it does not take; it does not
// synchronise and allocates nothing.
extern "C" int qmatmul_f32_launch(const void* x, const void* w,
                                  const void* bias, const void* alpha,
                                  float alpha_v, void* y, const K4Call* call,
                                  void* stream) {
  const int M = call->M, K = call->K, N = call->N, nc = call->nc;
  const int rn = call->rn, grid_x = call->grid_x;
  const int elt = call->x_bf16 ? 2 : 4;
  if (M < 1 || K < 1 || N < 1 || (rn != 1 && rn != 2) || nc < 32 ||
      nc % (4 * rn) != 0 || THREADS % (nc / (4 * rn)) != 0 || grid_x < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.alpha_p = static_cast<const float*>(alpha);
  a.y = static_cast<float*>(y);
  a.alpha_v = alpha_v;
  a.delta = call->delta;
  a.M = M; a.K = K; a.N = N;
  a.nc = nc;
  a.tx_n = nc / (4 * rn);
  a.bm = (THREADS / a.tx_n) * 4;
  a.bm_log2 = 0;
  while ((1 << a.bm_log2) < a.bm) ++a.bm_log2;
  a.tiles = (M + a.bm - 1) / a.bm;
  a.kp = (K + BK - 1) / BK * BK;
  a.raw_row = BK * elt + 16;
  a.raw_bytes = (a.bm * a.raw_row + 127) / 128 * 128;
  const long long smem =
      4LL * a.kp * nc + 8LL * BK * a.bm + 2LL * a.raw_bytes;
  if (smem > SMEM_MAX || grid_x > a.tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (static_cast<long long>(K) * elt) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>((N + nc - 1) / nc));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return call->x_bf16 ? launch_tile<__nv_bfloat16>(a, rn, vec, grid,
                                                   static_cast<int>(smem), s)
                      : launch_tile<float>(a, rn, vec, grid,
                                           static_cast<int>(smem), s);
}
