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
//   alpha:  (1,) float32 activation clip
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
// Design.  A register-tiled shared-memory SGEMM on the CUDA cores: a block
// of 256 threads owns 64 rows x 64 columns of y and walks K in steps of 16,
// staging a 64 x 16 tile of fq(x) (fake-quantized on the way in, stored
// k-major) and a 16 x 64 tile of w; each thread keeps a 4 x 4 tile of y in
// registers and reads its operands as float4 rows of shared memory.
//
// What bounds it: the bytes.  At the flagship's widest 1x1 (B = 8 patches,
// M = 262144, K = 32 -> N = 64) it reads 16.8 MB of bf16 x and writes 67.1
// MB of float32 y, 0.025 ms at 3.35 TB/s, against 0.016 ms for the 1.07 G
// float32 operations at the card's 67 TFLOP/s non-tensor peak.  This first
// form re-reads x once per 64-column tile of y and overlaps no loads with
// the arithmetic inside a block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows of y per block
constexpr int BN = 64;   // columns of y per block
constexpr int BK = 16;   // K per step
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float fake_quant(float v, float alpha,
                                            float delta) {
  float q = fminf(fmaxf(__fdiv_rn(v, alpha), 0.0f), 1.0f);
  q = rintf(__fdiv_rn(q, delta));
  return __fmul_rn(__fmul_rn(q, delta), alpha);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
qmatmul_f32_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ alpha_p, float* __restrict__ y,
                   int M, int K, int N, float delta) {
  __shared__ __align__(16) float As[BK][BM + 4];  // fq(x), k-major
  __shared__ __align__(16) float Ws[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const float alpha = *alpha_p;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK, kk = e % BK;
      const long long m = m0 + r;
      const int k = k0 + kk;
      As[kk][r] = (m < M && k < K)
                      ? fake_quant(to_f32(x[m * K + k]), alpha, delta)
                      : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / BN, n = e % BN;
      const int k = k0 + kk;
      Ws[kk][n] = (k < K && n0 + n < N)
                      ? w[static_cast<long long>(k) * N + n0 + n]
                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const bool quads = (N % 4) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
    float* row = y + m * N;
    const int n = n0 + tx * 4;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[i][j];
      if (bias != nullptr && n + j < N) v[j] = __fadd_rn(v[j], bias[n + j]);
    }
    if (quads && n + 3 < N) {
      *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) row[n + j] = v[j];
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  x is bfloat16 with x_bf16, else float32;
// y is (M, N) float32, 16-byte aligned.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int qmatmul_f32_launch(const void* x, const void* w,
                                  const void* bias, const void* alpha,
                                  void* y, int M, int K, int N, float delta,
                                  int x_bf16, void* stream) {
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bi = static_cast<const float*>(bias);
  const float* al = static_cast<const float*>(alpha);
  float* out = static_cast<float*>(y);
  if (x_bf16) {
    qmatmul_f32_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wf, bi, al, out, M, K, N,
        delta);
  } else {
    qmatmul_f32_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), wf, bi, al, out, M, K, N, delta);
  }
  return static_cast<int>(cudaGetLastError());
}
