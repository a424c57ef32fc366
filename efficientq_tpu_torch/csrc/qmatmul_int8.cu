// K3: the fused int8 1x1 matmul, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// pallas/qmatmul.py::fused_int8_matmul (body _int8_qact_matmul_kernel): an
// int8 1x1x1 conv of the deployed graph, as a matmul of activation codes
// and weight codes.
//
//   x:      (M, K) float32 or bfloat16 activations (bf16 promoted to float32)
//   w:      (K, N) int8 weight codes, read as they are (no packed layout)
//   scale:  (N,) float32 epilogue scale (a per-tensor scale expanded)
//   bias:   (N,) float32, or null for none
//   alpha:  (1,) float32 activation clip; qlvl its number of levels
//
//   codes[m, k] = rint(clip(x[m, k] / alpha, 0, 1) * (qlvl - 1))
//   y[m, n] = float(sum_k codes[m, k] * w[k, n]) * scale[n] + bias[n]
//
// The divide is a true float32 divide (__fdiv_rn), the sums are int32, and
// the epilogue rounds after the multiply and after the add (the _rn
// intrinsics make each step one rounding; the build passes -fmad=false), so
// y equals the plain version bit for bit.  rintf rounds half to even, as
// jnp.round and torch.round do.
//
// Design.  int8 tensor cores through mma.sync.m16n8k32 (s8 x s8 -> s32).  A
// block of 4 warps owns 64 rows x 64 columns of y and walks K in passes of
// up to 256: per pass it stages the activation codes (quantized on the way
// in, four codes per 32-bit word) and the weight codes transposed to [n][k],
// both zero-padded to a multiple of the mma depth 32, so an A or B fragment
// register is one 32-bit shared-memory load.  Rows are padded by 16 bytes
// so the fragment loads of a warp hit 32 distinct banks.  Each warp
// computes 32 x 32 of y as 2 x 4 mma tiles per k-step.
//
// What bounds it: the bytes.  At the flagship's widest 1x1 (B = 8 patches,
// M = 262144 voxels, K = 32 -> N = 64) it reads 16.8 MB of bf16 x and
// writes 67.1 MB of float32 y: 0.025 ms at 3.35 TB/s, against 0.0005 ms
// for the 1.07 G int8 operations at the 1,979 TOP/s int8 peak.  This first
// form re-quantizes x once per 64-column tile of y, stores the output with
// 8-byte stores, and overlaps no loads with the mma steps inside a block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows of y per block
constexpr int BN = 64;        // columns of y per block
constexpr int KC = 256;       // K per staged pass
constexpr int RS = KC + 16;   // shared-memory row stride, bytes
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive elements of a row as float32 (16-byte or 8-byte aligned)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(h[j]);
}

// the activation code of v as a byte
__device__ __forceinline__ uint32_t act_code(float v, float alpha,
                                             float qmax) {
  float q = fminf(fmaxf(__fdiv_rn(v, alpha), 0.0f), 1.0f);
  q = __fmul_rn(q, qmax);
  return static_cast<uint32_t>(static_cast<int>(rintf(q))) & 0xffu;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
qmatmul_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ alpha_p, float* __restrict__ y,
                    int M, int K, int N, int qlvl) {
  __shared__ __align__(16) uint8_t As[BM * RS];  // [row][k] codes
  __shared__ __align__(16) uint8_t Bs[BN * RS];  // [n][k] codes

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const float alpha = *alpha_p;
  const float qmax = static_cast<float>(qlvl - 1);
  const bool vec = (K % 4) == 0;  // rows start aligned for 4-wide loads

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    const int words = ((kc + 31) & ~31) / 4;  // 32-bit words per staged row
    if (k0) __syncthreads();  // the previous pass is consumed
    for (int e = tid; e < BM * words; e += THREADS) {
      const int r = e / words, kw = (e % words) * 4;
      const long long m = m0 + r;
      uint32_t packed = 0u;
      if (m < M && kw < kc) {
        const T* src = x + m * K + k0 + kw;
        if (vec && kw + 4 <= kc) {
          float v[4];
          load4(src, v);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            packed |= act_code(v[j], alpha, qmax) << (8 * j);
        } else {
          for (int j = 0; j < 4 && kw + j < kc; ++j)
            packed |= act_code(to_f32(src[j]), alpha, qmax) << (8 * j);
        }
      }
      *reinterpret_cast<uint32_t*>(As + r * RS + kw) = packed;
    }
    for (int e = tid; e < BN * words; e += THREADS) {
      const int n = e % BN, kw = (e / BN) * 4;
      uint32_t packed = 0u;
      if (n0 + n < N) {
        const int8_t* src = w + static_cast<long long>(k0 + kw) * N + n0 + n;
        for (int j = 0; j < 4 && kw + j < kc; ++j)
          packed |= static_cast<uint32_t>(static_cast<uint8_t>(
                        src[static_cast<long long>(j) * N]))
                    << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(Bs + n * RS + kw) = packed;
    }
    __syncthreads();
    for (int ks = 0; ks < words * 4; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint8_t* r0 = As + (wm + mt * 16 + g) * RS + ks + 4 * t;
        const uint8_t* r1 = r0 + 8 * RS;
        a[mt][0] = ld32(r0);
        a[mt][1] = ld32(r1);
        a[mt][2] = ld32(r0 + 16);
        a[mt][3] = ld32(r1 + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint8_t* c = Bs + (wn + nt * 8 + g) * RS + ks + 4 * t;
        b[nt][0] = ld32(c);
        b[nt][1] = ld32(c + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
  }

  // epilogue: the accumulator of (row g [+8], columns 2t, 2t+1) per tile
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm + mt * 16 + g + 8 * half;
      if (m >= M) continue;
      float* row = y + m * N;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn + nt * 8 + 2 * t;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (n + j >= N) continue;
          v[j] = __fmul_rn(__int2float_rn(acc[mt][nt][2 * half + j]),
                           scale[n + j]);
          if (bias != nullptr) v[j] = __fadd_rn(v[j], bias[n + j]);
        }
        if (pairs && n + 1 < N) {
          *reinterpret_cast<float2*>(row + n) = make_float2(v[0], v[1]);
        } else {
          if (n < N) row[n] = v[0];
          if (n + 1 < N) row[n + 1] = v[1];
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  x is bfloat16 with x_bf16, else float32,
// and 16-byte aligned; y is (M, N) float32.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int qmatmul_int8_launch(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   const void* alpha, void* y, int M, int K,
                                   int N, int qlvl, int x_bf16,
                                   void* stream) {
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wc = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* al = static_cast<const float*>(alpha);
  float* out = static_cast<float*>(y);
  if (x_bf16) {
    qmatmul_int8_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wc, sc, bi, al, out, M, K, N,
        qlvl);
  } else {
    qmatmul_int8_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), wc, sc, bi, al, out, M, K, N, qlvl);
  }
  return static_cast<int>(cudaGetLastError());
}
