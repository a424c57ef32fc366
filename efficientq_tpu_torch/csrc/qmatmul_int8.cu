// K3: the fused int8 1x1 matmul, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// pallas/qmatmul.py::fused_int8_matmul (body _int8_qact_matmul_kernel): an
// int8 1x1x1 conv of the deployed graph, as a matmul of activation codes
// and weight codes.
//
//   x:      (M, K) float32 or bfloat16 activations (bf16 promoted to float32)
//   w:      the weight codes packed [N][Kp] int8 (kernels/qmatmul.py::
//           pack_weights_1x1: k contiguous, Kp = K rounded up to 32, zero
//           filled), made once at deploy time
//   scale:  float32, read at scale[n * scale_stride] (stride 0: per tensor),
//           or (scale null) the value scale_v
//   bias:   (N,) float32, or null for none
//   alpha:  the activation clip, a (1,) float32 on the device, or (alpha_p
//           null) the value alpha_v; qlvl its number of levels
//
//   codes[m, k] = rint(clip(x[m, k] / alpha, 0, 1) * (qlvl - 1)), or on
//                 the offset grid of shift act_k > 0 the signed codes
//                 clip(rint(x[m, k] / alpha * (qlvl - 1)), -act_k,
//                 qlvl - 1 - act_k)
//   y[m, n] = float(sum_k codes[m, k] * w[k, n]) * scale[n] + bias[n]
//
// The codes are those of a true float32 divide (act_code, __fdiv_rn), the
// sums are int32, and the epilogue rounds after the multiply and after the
// add (the _rn intrinsics make each step one rounding; the build passes
// -fmad=false), so y equals the plain version bit for bit.  rintf rounds
// half to even, as jnp.round and torch.round do.
//
// What bounds it: the bytes.  At B = 8 bf16 patches of the flagship the
// six transition convs move x once and y once: TransDown1 (M = 262144,
// K = 32, N = 64) 16.8 MB of x and 67.1 MB of y, 0.0250 ms at 3.35 TB/s;
// TransUp6 (262144, 64, 32) 33.6 + 33.6 MB, 0.0200 ms; TransDown2 (32768,
// 64, 128) 0.0063 ms; TransUp5 (32768, 128, 64) 0.0050 ms; TransDown3
// (4096, 128, 256) 0.0016 ms; TransUp4 (4096, 256, 128) 0.0013 ms.  The
// int8 operations take under 0.0006 ms everywhere at 1,979 TOP/s.
//
// Design.  int8 tensor cores through mma.sync.m16n8k32 (s8 x s8 -> s32).
// A block of 8 warps owns a column chunk of nc <= 256 columns (all of N at
// the flagship; blockIdx.y numbers the chunks) and walks row tiles of bm
// rows: block x takes tiles x, x + gridDim.x, ... (persistent blocks), so
// x is read and quantized once per element for all of the chunk's columns.
// The chunk's packed weights arrive once per block with 16-byte cp.async
// loads, together with its first tile of x, and stay in shared memory for
// every later tile.  Each tile's raw x (rows of Kp elements, zero filled
// past M and K) is staged by cp.async in a ring of 2-4 slices, so the next
// tiles' rows are in flight under this tile's codes, mma and epilogue (a
// deeper ring pays where only two blocks fit an SM).  Up to three blocks
// share an SM.  Rows of x that are not 16-byte aligned (K * element size
// not a multiple of 16, or a misaligned x) take plain element loads
// instead.  The codes
// go to a [row][k] tile, four per 32-bit word; rows of codes and weights
// are padded by 16 bytes so a warp's fragment loads hit 32 distinct banks.
// With at most 4 levels a code takes no divide: act_code is monotone in x,
// so a code is the count of thresholds x reaches, each threshold found once
// per warp by running act_code itself on 32 consecutive floats (a miss, a
// non-positive or extreme alpha, or more levels take the divide).  The 8
// warps split the block tile as wm (rows of 16 mt) x wn (columns of 8 nt),
// each walking all of K (splitting K across warps, with the int32 sums
// added through shared memory, was never faster in the tuning sweeps).
// The epilogue stores float2 pairs: a quad's 32 contiguous bytes fill a
// sector (staging y through shared memory for 16-byte row stores, and
// streaming stores, measured no faster).  A K whose rows of x do not fit
// the ring (the 1536 and 3072 of SwinUNETR's widest linears and merges)
// is walked in chunks of kc: the ring then stages (tile, chunk) slices of
// bm x kc, each quantized into a bm x kc code tile and added to the same
// int32 sums, the epilogue running after a tile's last chunk; the weights
// of all of K stay in shared memory.  bm, nc, mt, nt, wn, kc, the ring's
// depth and the grid come from kernels/qmatmul.py::_k3_plan.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "act_code.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BK = 32;            // mma depth: K per step
constexpr int TILES = 8;          // mma tiles per warp: mt x nt <= 8
constexpr int SMEM_MAX = 232448;  // opt-in shared memory of one block

struct Args {
  const void* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  const float* alpha_p;
  float* y;
  float scale_v, alpha_v;
  int scale_stride;
  int M, K, N, qlvl, act_k;
  int kp;          // K rounded up to BK
  int kc;          // K per chunk, a multiple of BK (kp: one chunk)
  int nch;         // chunks of K: ceil(kp / kc)
  int rw;          // row stride of the weight tile: kp + 16 bytes
  int rc;          // row stride of the code tile: kc + 16 bytes
  int bm, nc, nt, wn;
  int stages;      // raw x slices in the ring
  int tiles;       // ceil(M / bm)
  int pieces_row;  // 16-byte pieces per raw row: kc * elt / 16
  uint32_t row_magic;  // ceil(2^32 / pieces_row): e / pieces_row by umulhi
  int raw_row;     // bytes of one staged raw row: kc * elt + 16
  int raw_bytes;   // one raw slice, a multiple of 128
  int off_codes, off_raw, off_sb;  // shared-memory offsets
};

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Quantize piece e of one raw slice (16 bytes of a row, pieces of a row
// consecutive) into the [row][k] code tile (code_of, act_code.cuh).
template <typename T>
__device__ __forceinline__ void quantize_piece(const Args& a, int e,
                                               const char* raw,
                                               uint8_t* codes,
                                               const Quant& q) {
  constexpr int EPP = 16 / sizeof(T);
  const int r = __umulhi(e, a.row_magic), j = e - r * a.pieces_row;
  float f[EPP];
  unpack(*reinterpret_cast<const uint4*>(raw + r * a.raw_row + j * 16), f);
  uint8_t* dst = codes + r * a.rc + j * EPP;
  uint32_t word[EPP / 4];
#pragma unroll
  for (int i = 0; i < EPP / 4; ++i) word[i] = 0u;
#pragma unroll
  for (int i = 0; i < EPP; ++i) {
    word[i / 4] |= (static_cast<uint32_t>(code_of(f[i], q)) & 0xffu)
                   << (8 * (i % 4));
  }
  if (EPP == 4) {
    *reinterpret_cast<uint32_t*>(dst) = word[0];
  } else {
    *reinterpret_cast<uint2*>(dst) = make_uint2(word[0], word[EPP / 4 - 1]);
  }
}

// Stage chunk c of tile t of raw x into `raw`: bm rows of kc elements,
// from column c * kc, at raw_row bytes apart, zero past M and K.
template <typename T, bool VEC>
__device__ __forceinline__ void load_raw(const Args& a, char* raw, int t,
                                         int c) {
  using Bits = typename std::conditional<sizeof(T) == 2, uint16_t,
                                         uint32_t>::type;
  const long long m0 = static_cast<long long>(t) * a.bm;
  const int k0 = c * a.kc;
  if (VEC) {
    constexpr int EPP = 16 / sizeof(T);
    const char* xb = static_cast<const char*>(a.x);
    for (int e = threadIdx.x; e < a.bm * a.pieces_row; e += THREADS) {
      const int r = __umulhi(e, a.row_magic), j = e - r * a.pieces_row;
      const long long m = m0 + r;
      const int k = k0 + j * EPP;
      const bool valid = m < a.M && k < a.K;
      const char* src =
          valid ? xb + (m * a.K + k) * static_cast<long long>(sizeof(T)) : xb;
      cp_async16(smem_u32(raw + r * a.raw_row + j * 16), src, valid);
    }
  } else {
    const Bits* xb = static_cast<const Bits*>(a.x);
    for (int e = threadIdx.x; e < a.bm * a.kc; e += THREADS) {
      const int r = e / a.kc, j = e - r * a.kc, k = k0 + j;
      const long long m = m0 + r;
      reinterpret_cast<Bits*>(raw + r * a.raw_row)[j] =
          (m < a.M && k < a.K) ? xb[m * a.K + k] : Bits(0);
    }
  }
}

// wait until at most stages - 1 cp.async groups are pending
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages == 2) cp_async_wait<1>();
  else if (stages == 3) cp_async_wait<2>();
  else cp_async_wait<3>();
}

// CHUNKS: K in a.nch chunks of a.kc; else all of K at once (nch 1).  The
// one-chunk loop is compiled apart: with nch a run-time value every
// one-chunk shape ran slower on an H100 (PERF.md section 6)
template <typename T, bool VEC, int MT, bool CHUNKS>
__global__ void __launch_bounds__(THREADS, 3) qmatmul_int8_kernel(Args a) {
  constexpr int NT_MAX = TILES / MT;
  const int nch = CHUNKS ? a.nch : 1;
  extern __shared__ __align__(128) char smem[];
  uint8_t* Ws = reinterpret_cast<uint8_t*>(smem);  // [nc][rw] weight codes
  uint8_t* Cs = reinterpret_cast<uint8_t*>(smem + a.off_codes);  // [bm][rc]
  char* raw0 = smem + a.off_raw;                   // raw x slices
  float* sc = reinterpret_cast<float*>(smem + a.off_sb);  // [nc] scale
  float* bi = sc + a.nc;                                  // [nc] bias

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp / a.wn) * 16 * MT;
  const int col0 = (warp % a.wn) * 8 * a.nt;
  const int n0 = blockIdx.y * a.nc;
  const int my_tiles = (a.tiles - 1 - static_cast<int>(blockIdx.x)) /
                           static_cast<int>(gridDim.x) + 1;
  // a step is one chunk of K of one tile: step s is chunk s % nch of
  // the block's tile s / nch
  const int my_steps = my_tiles * nch;

  // group 0: the column chunk's weights and the first step; group j <
  // stages: step j
  const int wp = a.kp / 16;  // 16-byte pieces per packed weight row
  for (int e = tid; e < a.nc * wp; e += THREADS) {
    const int nn = e / wp, j = e - nn * wp;
    const int n = n0 + nn;
    const bool valid = n < a.N;
    cp_async16(smem_u32(Ws + nn * a.rw + j * 16),
               valid ? a.w + static_cast<long long>(n) * a.kp + j * 16 : a.w,
               valid);
  }
  for (int j = 0; j < a.stages; ++j) {
    if (j < my_steps)
      load_raw<T, VEC>(a, raw0 + j * a.raw_bytes,
                       blockIdx.x + (j / nch) * gridDim.x, j % nch);
    cp_async_commit();
  }
  for (int i = tid; i < a.nc; i += THREADS) {
    const int n = n0 + i;
    sc[i] = n < a.N ? (a.scale != nullptr ? a.scale[n * a.scale_stride]
                                          : a.scale_v)
                    : 0.0f;
    bi[i] = (a.bias != nullptr && n < a.N) ? a.bias[n] : 0.0f;
  }
  const float alpha = a.alpha_p != nullptr ? *a.alpha_p : a.alpha_v;
  const Quant q = quant_setup(alpha, a.qlvl, a.act_k);
  const int pieces = a.bm * a.pieces_row;

  const int nks_all = a.kp / BK;
  const int rc = CHUNKS ? a.rc : a.rw;  // one stride without chunks

  for (int i = 0; i < my_tiles; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    int acc[MT][NT_MAX][4];
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int v = 0; v < NT_MAX; ++v)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[u][v][j] = 0;
    for (int c = 0; c < nch; ++c) {
      const int step = i * nch + c;
      // the step's raw x has landed (and, at step 0, the weights); the
      // code tile of the step before is consumed
      cp_async_wait_ring(a.stages);
      __syncthreads();
      char* raw = raw0 + (step % a.stages) * a.raw_bytes;
#pragma unroll 4
      for (int e = tid; e < pieces; e += THREADS)
        quantize_piece<T>(a, e, raw, Cs, q);
      __syncthreads();
      // the slice of this step is consumed: it takes step + stages
      const int next = step + a.stages;
      if (next < my_steps)
        load_raw<T, VEC>(a, raw, blockIdx.x + (next / nch) * gridDim.x,
                         next % nch);
      cp_async_commit();

      const int nks = CHUNKS ? min(a.kc, a.kp - c * a.kc) / BK : nks_all;
      const uint8_t* Wc = CHUNKS ? Ws + c * a.kc : Ws;  // chunk c's columns
      for (int s = 0; s < nks; ++s) {
        const int kb = s * BK + 4 * t;
        uint32_t af[MT][4];
#pragma unroll
        for (int u = 0; u < MT; ++u) {
          const uint8_t* r0 = Cs + (row0 + u * 16 + g) * rc + kb;
          const uint8_t* r1 = r0 + 8 * rc;
          af[u][0] = ld32(r0);
          af[u][1] = ld32(r1);
          af[u][2] = ld32(r0 + 16);
          af[u][3] = ld32(r1 + 16);
        }
#pragma unroll
        for (int v = 0; v < NT_MAX; ++v) {
          if (v < a.nt) {
            const uint8_t* wr = Wc + (col0 + v * 8 + g) * a.rw + kb;
            const uint32_t b0 = ld32(wr), b1 = ld32(wr + 16);
#pragma unroll
            for (int u = 0; u < MT; ++u) mma_s8(acc[u][v], af[u], b0, b1);
          }
        }
      }
    }
    // epilogue: the sums of (row g [+8], columns 2t, 2t+1) per mma tile,
    // * scale, + bias, float2 stores
    const bool pairs = (a.N % 2) == 0;
    const long long m0 = static_cast<long long>(tile) * a.bm + row0;
#pragma unroll
    for (int u = 0; u < MT; ++u) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + u * 16 + g + 8 * half;
        if (m >= a.M) continue;
        float* row = a.y + m * a.N;
#pragma unroll
        for (int v = 0; v < NT_MAX; ++v) {
          if (v >= a.nt) continue;
          const int nl = col0 + v * 8 + 2 * t;
          const int n = n0 + nl;
          float val[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            val[j] = __fmul_rn(__int2float_rn(acc[u][v][2 * half + j]),
                               sc[nl + j]);
            if (a.bias != nullptr) val[j] = __fadd_rn(val[j], bi[nl + j]);
          }
          if (pairs && n + 1 < a.N) {
            *reinterpret_cast<float2*>(row + n) = make_float2(val[0], val[1]);
          } else {
            if (n < a.N) row[n] = val[0];
            if (n + 1 < a.N) row[n + 1] = val[1];
          }
        }
      }
    }
  }
}

template <typename T, bool VEC, int MT, bool CHUNKS>
int launch(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  auto kernel = qmatmul_int8_kernel<T, VEC, MT, CHUNKS>;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MT, bool CHUNKS>
int launch_vec(const Args& a, bool vec, dim3 grid, int smem, cudaStream_t s) {
  return vec ? launch<T, true, MT, CHUNKS>(a, grid, smem, s)
             : launch<T, false, MT, CHUNKS>(a, grid, smem, s);
}

template <typename T, int MT>
int launch_chunks(const Args& a, bool vec, dim3 grid, int smem,
                  cudaStream_t s) {
  return a.nch > 1 ? launch_vec<T, MT, true>(a, vec, grid, smem, s)
                   : launch_vec<T, MT, false>(a, vec, grid, smem, s);
}

template <typename T>
int launch_mt(const Args& a, int mt, bool vec, dim3 grid, int smem,
              cudaStream_t s) {
  return mt == 2 ? launch_chunks<T, 2>(a, vec, grid, smem, s)
                 : launch_chunks<T, 1>(a, vec, grid, smem, s);
}

int align(int v, int to) { return (v + to - 1) / to * to; }

}  // namespace

// One call's shape and plan, as kernels/qmatmul.py::_K3Call lays it out:
// (bm rows per tile, nc columns per block, wn column groups of warps, mt x
// nt mma tiles per warp, raw x slices in the ring, grid_x persistent blocks
// per column chunk) from _k3_plan.
struct K3Call {
  int M, K, N, qlvl, x_bf16;
  int bm, nc, mt, nt, wn, stages, grid_x;
  int act_k;  // the offset grid's shift of x's codes, 0: unsigned
  int kc;     // K per chunk, a multiple of 32, or 0: all of K at once
};

// Plain C entry point for ctypes.  x is bfloat16 with call->x_bf16, else
// float32; w is pack_weights_1x1's [N][Kp] int8, 16-byte aligned; scale is
// null to take scale_v; bias is null for none; alpha is null to take
// alpha_v; y is (M, N) float32, 16-byte aligned.  Launches on `stream` and
// returns cudaGetLastError() (0 on success), the error of
// cudaFuncSetAttribute, or cudaErrorInvalidValue for a plan it does not
// take; it does not synchronise and allocates nothing.
extern "C" int qmatmul_int8_launch(const void* x, const void* w,
                                   const void* scale, float scale_v,
                                   int scale_stride, const void* bias,
                                   const void* alpha, float alpha_v, void* y,
                                   const K3Call* call, void* stream) {
  const int M = call->M, K = call->K, N = call->N;
  const int wn = call->wn, mt = call->mt, nt = call->nt;
  const int elt = call->x_bf16 ? 2 : 4;
  if (M < 1 || K < 1 || N < 1 || call->qlvl < 2 || call->act_k < 0 ||
      call->act_k > 128 || call->qlvl - 1 - call->act_k > 127 ||
      wn < 1 || WARPS % wn != 0 || (mt != 1 && mt != 2) ||
      (nt != 1 && nt != 2 && nt != 4 && nt != 8) || mt * nt > TILES ||
      call->stages < 2 || call->stages > 4 ||
      call->nc != wn * 8 * nt || call->nc > 256 ||
      call->bm != WARPS / wn * 16 * mt || call->grid_x < 1 ||
      call->kc < 0 || call->kc % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.alpha_p = static_cast<const float*>(alpha);
  a.y = static_cast<float*>(y);
  a.scale_v = scale_v;
  a.alpha_v = alpha_v;
  a.scale_stride = scale_stride;
  a.M = M; a.K = K; a.N = N;
  a.qlvl = call->qlvl;
  a.act_k = call->act_k;
  a.kp = align(K, BK);
  a.kc = (call->kc == 0 || call->kc > a.kp) ? a.kp : call->kc;
  a.nch = (a.kp + a.kc - 1) / a.kc;
  a.rw = a.kp + 16;
  a.rc = a.kc + 16;
  a.bm = call->bm; a.nc = call->nc;
  a.nt = nt; a.wn = wn;
  a.stages = call->stages;
  a.tiles = (M + a.bm - 1) / a.bm;
  a.pieces_row = a.kc * elt / 16;
  // exact for every piece index e < 2^32 / pieces_row (e < 16 K here)
  a.row_magic = static_cast<uint32_t>((0x100000000ULL + a.pieces_row - 1) /
                                      a.pieces_row);
  a.raw_row = a.kc * elt + 16;
  a.raw_bytes = align(a.bm * a.raw_row, 128);
  // shared memory: weights, codes, the raw slices, scale and bias
  // (kernels/qmatmul.py::_k3_smem computes the same)
  a.off_codes = a.nc * a.rw;
  a.off_raw = align(a.off_codes + a.bm * a.rc, 128);
  a.off_sb = a.off_raw + a.stages * a.raw_bytes;
  const long long smem = a.off_sb + 8LL * a.nc;
  if (smem > SMEM_MAX || call->grid_x > a.tiles ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (static_cast<long long>(K) * elt) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(call->grid_x),
                  static_cast<unsigned>((N + a.nc - 1) / a.nc));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return call->x_bf16
             ? launch_mt<__nv_bfloat16>(a, mt, vec, grid,
                                        static_cast<int>(smem), s)
             : launch_mt<float>(a, mt, vec, grid, static_cast<int>(smem), s);
}
