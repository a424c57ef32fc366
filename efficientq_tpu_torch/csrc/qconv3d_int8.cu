// K1: int8 3x3x3 convolution with fused epilogues, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// pallas/qconv3d.py::qconv3x3_int8_ndhwc (bodies
// _qconv3d_kernel, _qconv3d_ring_kernel, _qconv3d_ring_tz_kernel):
//
//   y = conv3d(qa, w) * scale + bias        stride 1, padding = dilation
//   qa: (N, D, H, W, C) int8 activation codes (NDHWC)
//   w:  (27, C4, O) int32, four int8 input-channel codes packed per word
//       (C4 = ceil(C / 4), zero-padded), made once at deploy time
//   scale, bias: (O,) float32
//   accumulation in int32 with __dp4a, so the sum is exact.
//
// Epilogues, applied to the float32 y in this order (the Pallas kernel's):
//   residual      y += residual            (float32 or bfloat16, converted
//                                           to float32; relu'd first with
//                                           res_relu)
//   quant         out = int8(rint(clip(y / qalpha, 0, 1) * (qlvl - 1)))
//                 from the float32 y
//   out dtype     y is stored as float32, or rounded to bfloat16 (nearest
//                 even) with out_bf16
//   pool          pool = maxpool_2x2x2 of the stored (rounded) y, VALID
//                 (odd trailing planes drop)
// Float steps use the _rn intrinsics so nothing is contracted into an FMA:
// the reference rounds after the multiply and after the add.  rintf rounds
// half to even, as jnp.round and torch.round do.
//
// Design.  An implicit GEMM: M = output voxels, N = O, K = 27 taps x C.
// A block of 256 threads owns a 64-voxel x 64-channel output tile; each
// thread accumulates 4 voxels x 4 channels.  The K loop walks the 27 taps
// and, within a tap, 32 input channels (8 packed words) at a time, staging
// activation words and weight words in shared memory.  A tap that falls in
// the zero padding loads zeros.
// Voxels are numbered cell-major: 8 consecutive voxels form one 2x2x2 cell
// (cells span ceil(D/2) x ceil(H/2) x ceil(W/2); sub-voxels past an odd
// edge are masked).  A tile therefore holds 8 whole cells, and the pool
// epilogue takes each cell's max from a shared-memory copy of the tile: no
// block reads another block's output, so no grid order is needed (the TPU
// kernel merged pooled rows across consecutive programs of its sequential
// grid).
//
// What bounds it: the int8 dot-product throughput (__dp4a, 4 MACs per
// instruction) at the flagship widths C = O = 32..256, plus the
// shared-memory round trips of a simple single-buffered tile.  Tensor
// cores (mma/wgmma s8), TMA and a deeper pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;      // voxels per tile (8 cells)
constexpr int BN = 64;      // output channels per tile
constexpr int BK4 = 8;      // packed input-channel words per K step (32 ch)
constexpr int THREADS = 256;

struct Vox {
  int n, z, y, x;
  bool inside;  // a real voxel (not past the grid end or an odd edge)
};

__device__ __forceinline__ Vox decode(long long m, long long M, int D, int H,
                                      int W) {
  const int Dc = (D + 1) / 2, Hc = (H + 1) / 2, Wc = (W + 1) / 2;
  const long long cell = m >> 3;
  const int sub = static_cast<int>(m & 7);
  Vox v;
  const int xc = static_cast<int>(cell % Wc);
  long long t = cell / Wc;
  const int yc = static_cast<int>(t % Hc);
  t /= Hc;
  const int zc = static_cast<int>(t % Dc);
  v.n = static_cast<int>(t / Dc);
  v.z = 2 * zc + (sub >> 2);
  v.y = 2 * yc + ((sub >> 1) & 1);
  v.x = 2 * xc + (sub & 1);
  v.inside = m < M && v.z < D && v.y < H && v.x < W;
  return v;
}

__device__ __forceinline__ int load_act_word(const int8_t* __restrict__ qa,
                                             long long vox, int c4, int C,
                                             bool vec) {
  if (vec) {  // C % 4 == 0: one aligned 32-bit load
    return reinterpret_cast<const int*>(qa + vox * C)[c4];
  }
  int v = 0;  // scalar tail: pack the channels that exist, zeros after
  const int c0 = 4 * c4;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (c0 + b < C) {
      v |= static_cast<int>(static_cast<uint8_t>(qa[vox * C + c0 + b]))
           << (8 * b);
    }
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
qconv3d_int8_kernel(const int8_t* __restrict__ qa,
                    const int* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const void* __restrict__ residual,
                    const float* __restrict__ qalpha,
                    void* __restrict__ out_y,
                    int8_t* __restrict__ out_i8,
                    void* __restrict__ out_pool,
                    int N, int D, int H, int W, int C, int O, int dil,
                    int res_relu, int quant_qlvl, int res_bf16,
                    int out_bf16) {
  __shared__ int As[BK4][BM + 4];   // +4: conflict-free stores
  __shared__ int Bs[BK4][BN];
  __shared__ float Ys[BM][BN + 1];  // the tile's y, for the pool epilogue

  const int tid = threadIdx.x;
  const long long cells = static_cast<long long>(N) * ((D + 1) / 2) *
                          ((H + 1) / 2) * ((W + 1) / 2);
  const long long M = cells * 8;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int o0 = blockIdx.y * BN;
  const int C4 = (C + 3) / 4;
  const bool vec = (C % 4) == 0;

  // loader roles: 8 threads read the 8 words of one voxel; 2 voxels each
  const int lk = tid & 7;
  Vox lv[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) lv[s] = decode(m0 + (tid >> 3) + 32 * s, M, D, H, W);
  const int bk = tid >> 5;  // weight loader: word row, 2 channels each

  // compute roles: voxels tm + 16 i, channels tn + 16 j
  const int tm = tid >> 4, tn = tid & 15;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int tap = 0; tap < 27; ++tap) {
    const int dz = (tap / 9 - 1) * dil;
    const int dy = ((tap / 3) % 3 - 1) * dil;
    const int dx = (tap % 3 - 1) * dil;
    long long nv[2];
    bool ok[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int zz = lv[s].z + dz, yy = lv[s].y + dy, xx = lv[s].x + dx;
      ok[s] = lv[s].inside && zz >= 0 && zz < D && yy >= 0 && yy < H &&
              xx >= 0 && xx < W;
      nv[s] = ((static_cast<long long>(lv[s].n) * D + zz) * H + yy) * W + xx;
    }
    for (int c40 = 0; c40 < C4; c40 += BK4) {
      const int c4 = c40 + lk;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        As[lk][(tid >> 3) + 32 * s] =
            (ok[s] && c4 < C4) ? load_act_word(qa, nv[s], c4, C, vec) : 0;
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int ol = (tid & 31) + 32 * s;
        const int o = o0 + ol;
        Bs[bk][ol] = (c40 + bk < C4 && o < O)
                         ? w[(static_cast<long long>(tap) * C4 + c40 + bk) * O + o]
                         : 0;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK4; ++k) {
        int a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][tm + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k][tn + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const float qa_alpha = quant_qlvl ? *qalpha : 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Vox v = decode(m0 + tm + 16 * i, M, D, H, W);
    const long long vox =
        ((static_cast<long long>(v.n) * D + v.z) * H + v.y) * W + v.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tn + 16 * j;
      float y = 0.0f;
      if (v.inside && o < O) {
        y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), scale[o]), bias[o]);
        if (residual) {
          float r = res_bf16
                        ? __bfloat162float(static_cast<const __nv_bfloat16*>(
                              residual)[vox * O + o])
                        : static_cast<const float*>(residual)[vox * O + o];
          if (res_relu) r = fmaxf(r, 0.0f);
          y = __fadd_rn(y, r);
        }
        if (quant_qlvl) {
          float q = fminf(fmaxf(__fdiv_rn(y, qa_alpha), 0.0f), 1.0f);
          q = __fmul_rn(q, static_cast<float>(quant_qlvl - 1));
          out_i8[vox * O + o] = static_cast<int8_t>(static_cast<int>(rintf(q)));
        } else if (out_bf16) {
          const __nv_bfloat16 yb = __float2bfloat16_rn(y);
          static_cast<__nv_bfloat16*>(out_y)[vox * O + o] = yb;
          y = __bfloat162float(yb);  // the pool takes the rounded value
        } else {
          static_cast<float*>(out_y)[vox * O + o] = y;
        }
      }
      if (out_pool) Ys[tm + 16 * i][tn + 16 * j] = y;
    }
  }

  if (out_pool) {
    __syncthreads();
    const int Dp = D / 2, Hp = H / 2, Wp = W / 2;
    const int Dc = (D + 1) / 2, Hc = (H + 1) / 2, Wc = (W + 1) / 2;
#pragma unroll
    for (int e = tid; e < (BM / 8) * BN; e += THREADS) {
      const int cl = e / BN, ol = e % BN;
      const int o = o0 + ol;
      const long long cell = (m0 >> 3) + cl;
      if (cell >= cells || o >= O) continue;
      const int xc = static_cast<int>(cell % Wc);
      long long t = cell / Wc;
      const int yc = static_cast<int>(t % Hc);
      t /= Hc;
      const int zc = static_cast<int>(t % Dc);
      const long long n = t / Dc;
      if (zc >= Dp || yc >= Hp || xc >= Wp) continue;  // VALID: partial cell
      float mx = Ys[cl * 8][ol];
#pragma unroll
      for (int s = 1; s < 8; ++s) mx = fmaxf(mx, Ys[cl * 8 + s][ol]);
      const long long p = (((n * Dp + zc) * Hp + yc) * Wp + xc) * O + o;
      if (out_bf16) {  // exact: mx is one of the rounded values
        static_cast<__nv_bfloat16*>(out_pool)[p] = __float2bfloat16_rn(mx);
      } else {
        static_cast<float*>(out_pool)[p] = mx;
      }
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  Pointers that do not apply are null:
// residual (no residual epilogue), qalpha and out_i8 (quant_qlvl == 0),
// out_y (quant_qlvl > 0), out_pool (no pool epilogue).  residual is
// bfloat16 with res_bf16, else float32; out_y and out_pool are bfloat16
// with out_bf16, else float32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int qconv3d_int8_launch(const void* qa, const void* w,
                                   const void* scale, const void* bias,
                                   const void* residual, const void* qalpha,
                                   void* out_y, void* out_i8, void* out_pool,
                                   int N, int D, int H, int W, int C, int O,
                                   int dil, int res_relu, int quant_qlvl,
                                   int res_bf16, int out_bf16,
                                   void* stream) {
  const long long cells = static_cast<long long>(N) * ((D + 1) / 2) *
                          ((H + 1) / 2) * ((W + 1) / 2);
  const dim3 grid(static_cast<unsigned>((cells * 8 + BM - 1) / BM),
                  static_cast<unsigned>((O + BN - 1) / BN));
  qconv3d_int8_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qa), static_cast<const int*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      residual, static_cast<const float*>(qalpha), out_y,
      static_cast<int8_t*>(out_i8), out_pool, N, D, H, W, C, O, dil, res_relu,
      quant_qlvl, res_bf16, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
