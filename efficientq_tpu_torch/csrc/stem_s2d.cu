// K2: the space-to-depth stem conv, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// pallas/stem.py::stem_s2d_conv (bodies _stem_kernel, _stem_ring_kernel):
// the network's stride-2 3x3x3 init conv, computed as a stride-1 2x2x2 conv
// on space-to-depth patches.
//
//   x:      (B, D+1, H, W, C8) bfloat16 s2d patches, C8 = 8 C; planes t and
//           t+1 are the two z-taps of output plane t
//   par:    (B,) int32 z-start parity of each patch: w_odd if nonzero
//   w_even, w_odd: (2, 4 C8, O) bfloat16, rows (kh2, kw2, c8) per kd2 tap
//   bias:   (O,) float32; qalpha, qlvl: the consumer conv's act quantizer
//
//   acc[b,z,h,w,o] = sum over kd2, kh2, kw2, c8 of
//       x[b, z+kd2, h+kh2-1, w+kw2-1, c8] * w[kd2][(kh2*2+kw2)*C8 + c8][o]
//   with zeros where h+kh2-1 or w+kw2-1 is -1, and, for odd patches, zeros
//   on the kd2 = 0 tap at z = 0 for c8 < C8/2: that z phase is the conv's
//   zero padding in the volume, but the s2d plane holds real data there
//   (even patches carry a physical zero plane instead).  Products of bf16
//   values are exact in float32; sums accumulate in float32.
//
// Epilogue, in this order (the Pallas kernel's): + bias; relu; round to
// the output dtype (float32, or bfloat16 to nearest even); the next conv's
// int8 codes of that ROUNDED value, rint(clip(yd / qalpha, 0, 1) *
// (qlvl - 1)).  The _rn intrinsics keep each step one rounding (the build
// passes -fmad=false); rintf rounds half to even as jnp.round does.
//
// Design.  An implicit GEMM on the tensor cores: M = output voxels of one
// patch, N = O, K = 8 taps x C8 (each tap's C8 zero-padded to a multiple of
// the mma depth, 16).  A block of 4 warps owns 128 consecutive voxels x 32
// output channels; each warp 32 voxels x 32 channels as 2 x 4
// mma.sync.m16n8k16 bf16 tiles with float32 accumulators.  The block
// stages its patch parity's weights in shared memory once, transposed to
// [o][k] so a B fragment is one 32-bit load, then walks TPB voxel tiles of
// its patch; per tile and tap it stages the 128 voxels' C8 channels with
// 16-byte loads (zeros at the padding and under the odd-parity mask) and
// runs C8p / 16 k-steps.  Rows are padded by 8 bf16 so fragment loads hit
// 32 distinct banks.  One block serves one patch, so the parity and the
// mask are per block and per row: no block reads another's output.
//
// What bounds it: at the flagship (B = 8, 64^3 outputs, C8 = O = 32) the
// bytes: 136 MB of bf16 patches read and 201 MB of bf16 + int8 outputs
// written take 0.10 ms at 3.35 TB/s, while the 17.2 G multiply-adds take
// 0.035 ms at the bf16 tensor-core peak.  This first form re-reads each
// input voxel for the 8 taps through L1/L2, does not overlap loads with
// the mma steps inside a block and stores scalars; TMA, wgmma and a plane
// ring that reads each plane once are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;     // voxels per tile
constexpr int BN = 32;      // output channels per block
constexpr int THREADS = 128;
constexpr int TPB = 4;      // voxel tiles per block (amortises the weights)

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__host__ __device__ __forceinline__ int padded_c8(int C8) {
  return (C8 + 15) & ~15;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int C8) {
  const int C8p = padded_c8(C8);
  return (static_cast<size_t>(BN) * (8 * C8p + 8) +
          static_cast<size_t>(BM) * (C8p + 8)) * sizeof(__nv_bfloat16);
}

__global__ void __launch_bounds__(THREADS)
stem_s2d_kernel(const __nv_bfloat16* __restrict__ x,
                const int* __restrict__ par,
                const __nv_bfloat16* __restrict__ w_even,
                const __nv_bfloat16* __restrict__ w_odd,
                const float* __restrict__ bias,
                const float* __restrict__ qalpha,
                void* __restrict__ out_y, int8_t* __restrict__ out_q,
                int D, int H, int W, int C8, int O, int qlvl, int out_bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C8p = padded_c8(C8);
  const int KP = 8 * C8p;
  const int WS = KP + 8;   // weight row stride (bf16)
  const int AS = C8p + 8;  // activation row stride (bf16)
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [BN][WS]
  __nv_bfloat16* As = Ws + BN * WS;                            // [BM][AS]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int o0 = blockIdx.z * BN;
  const bool odd = par[b] != 0;
  const __nv_bfloat16* w = odd ? w_odd : w_even;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  // weights of this parity, transposed: Ws[n][tap * C8p + c] with
  // tap = kd2 * 4 + kh2 * 2 + kw2 (the global row is tap * C8 + c)
  for (int e = tid; e < BN * KP; e += THREADS) {
    const int n = e % BN;
    const int kk = e / BN;
    const int tap = kk / C8p, c = kk % C8p;
    const int o = o0 + n;
    Ws[n * WS + kk] = (c < C8 && o < O)
                          ? w[static_cast<long long>(tap * C8 + c) * O + o]
                          : zero;
  }

  const int HW = H * W;
  const long long Mp = static_cast<long long>(D) * HW;  // voxels per patch
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float alpha = *qalpha;
  const float qmax = static_cast<float>(qlvl - 1);
  const int CH = C8p / 8;  // 16-byte chunks per staged row

  for (int ti = 0; ti < TPB; ++ti) {
    const long long m0 =
        (static_cast<long long>(blockIdx.x) * TPB + ti) * BM;
    if (m0 >= Mp) break;
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.0f;

    for (int tap = 0; tap < 8; ++tap) {
      const int kd2 = tap >> 2, kh2 = (tap >> 1) & 1, kw2 = tap & 1;
      __syncthreads();  // the weights are staged / the last tap is consumed
      for (int e = tid; e < BM * CH; e += THREADS) {
        const int r = e / CH, ch = e % CH;
        const long long m = m0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m < Mp && ch * 8 < C8) {
          const int z = static_cast<int>(m / HW);
          const int rem = static_cast<int>(m % HW);
          const int hh = rem / W + kh2 - 1, ww = rem % W + kw2 - 1;
          if (hh >= 0 && ww >= 0) {
            v = *reinterpret_cast<const uint4*>(
                x + (((static_cast<long long>(b) * (D + 1) + z + kd2) * H +
                      hh) * W + ww) * C8 + ch * 8);
            if (odd && kd2 == 0 && z == 0) {
              uint16_t* lanes = reinterpret_cast<uint16_t*>(&v);
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                if (ch * 8 + j < C8 / 2) lanes[j] = 0;
              }
            }
          }
        }
        *reinterpret_cast<uint4*>(As + r * AS + ch * 8) = v;
      }
      __syncthreads();
      for (int ks = 0; ks < C8p; ks += 16) {
        const int kw0 = tap * C8p + ks;
        uint32_t a[2][4], bf[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* r0 = As + (warp * 32 + mt * 16 + g) * AS + ks;
          const __nv_bfloat16* r1 = r0 + 8 * AS;
          a[mt][0] = ld32(r0 + 2 * t);
          a[mt][1] = ld32(r1 + 2 * t);
          a[mt][2] = ld32(r0 + 8 + 2 * t);
          a[mt][3] = ld32(r1 + 8 + 2 * t);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const __nv_bfloat16* col = Ws + (nt * 8 + g) * WS + kw0;
          bf[nt][0] = ld32(col + 2 * t);
          bf[nt][1] = ld32(col + 8 + 2 * t);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], bf[nt]);
      }
    }

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + warp * 32 + mt * 16 + g + 8 * half;
        if (m >= Mp) continue;
        const long long row = (static_cast<long long>(b) * Mp + m) * O;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int o = o0 + nt * 8 + 2 * t + j;
            if (o >= O) continue;
            float y = __fadd_rn(acc[mt][nt][2 * half + j], bias[o]);
            y = y < 0.0f ? 0.0f : y;  // relu; a NaN passes, as in jnp.maximum
            if (out_bf16) {
              const __nv_bfloat16 yb = __float2bfloat16_rn(y);
              static_cast<__nv_bfloat16*>(out_y)[row + o] = yb;
              y = __bfloat162float(yb);
            } else {
              static_cast<float*>(out_y)[row + o] = y;
            }
            float q = fminf(fmaxf(__fdiv_rn(y, alpha), 0.0f), 1.0f);
            q = __fmul_rn(q, qmax);
            out_q[row + o] = static_cast<int8_t>(static_cast<int>(rintf(q)));
          }
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  out_y is bfloat16 with out_bf16, else
// float32; out_q is int8; both (B, D, H, W, O).  x must be 16-byte aligned
// and C8 a multiple of 8.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int stem_s2d_launch(const void* x, const void* par,
                               const void* w_even, const void* w_odd,
                               const void* bias, const void* qalpha,
                               void* out_y, void* out_q, int B, int D, int H,
                               int W, int C8, int O, int qlvl, int out_bf16,
                               void* stream) {
  const size_t smem = smem_bytes(C8);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stem_s2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long Mp = static_cast<long long>(D) * H * W;
  const long long tiles = (Mp + BM - 1) / BM;
  const dim3 grid(static_cast<unsigned>((tiles + TPB - 1) / TPB),
                  static_cast<unsigned>(B),
                  static_cast<unsigned>((O + BN - 1) / BN));
  stem_s2d_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(par),
      static_cast<const __nv_bfloat16*>(w_even),
      static_cast<const __nv_bfloat16*>(w_odd),
      static_cast<const float*>(bias), static_cast<const float*>(qalpha),
      out_y, static_cast<int8_t*>(out_q), D, H, W, C8, O, qlvl, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
