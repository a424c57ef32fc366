// K2: the space-to-depth stem conv, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// pallas/stem.py::stem_s2d_conv (bodies _stem_kernel, _stem_ring_kernel):
// the network's stride-2 3x3x3 init conv, computed as a stride-1 2x2x2 conv
// on space-to-depth patches.
//
//   x:      (B, D+1, H, W, C8) bfloat16 s2d patches, C8 = 8 C; planes t and
//           t+1 are the two z-taps of output plane t
//   par:    (B,) int32 z-start parity of each patch: the odd weights if
//           nonzero
//   w:      the weights packed [parity][O][8 C8p] bfloat16 (kernels/stem.py::
//           pack_stem_weights: k = tap * C8p + c8 contiguous, tap = (kd2,
//           kh2, kw2), C8p = C8 rounded up to 16, zero filled), made once at
//           deploy time
//   bias:   (O,) float32; alpha, qlvl: the consumer conv's act quantizer
//
//   acc[b,z,h,w,o] = sum over kd2, kh2, kw2, c8 of
//       x[b, z+kd2, h+kh2-1, w+kw2-1, c8] * w[parity][o][tap * C8p + c8]
//   with zeros where h+kh2-1 or w+kw2-1 is -1, and, for odd patches, zeros
//   on plane 0 for c8 < C8/2: only output plane 0's kd2 = 0 tap reads it,
//   and that z phase is the conv's zero padding in the volume, but the s2d
//   plane holds real data there (even patches carry a physical zero plane
//   instead).  Products of bf16 values are exact in float32; the sums run
//   per output voxel over the taps in (kd2, kh2, kw2) order and, inside a
//   tap, over k-steps of 16 in ascending order, each one mma.sync m16n8k16
//   into one float32 accumulator that starts at 0.
//
// Epilogue, in this order (the Pallas kernel's): + bias; relu; round to
// the output dtype (float32, or bfloat16 to nearest even); the next conv's
// int8 codes of that ROUNDED value, rint(clip(yd / alpha, 0, 1) *
// (qlvl - 1)).  The _rn intrinsics keep each step one rounding (the build
// passes -fmad=false); rintf rounds half to even as jnp.round does.  With
// at most 4 levels a code is the count of thresholds yd reaches, found once
// per warp by the divide itself (code_threshold), so no divide is left
// per output; NaN reaches none: code 0, as the clip takes it.
//
// What bounds it: the bytes.  At the flagship (B = 8, 64^3 outputs, C8 =
// O = 32) 136 MB of bf16 patches read and 201 MB of bf16 + int8 outputs
// written take 0.1008 ms at 3.35 TB/s; the 17.2 G multiply-adds take
// 0.035 ms at the bf16 tensor-core peak.
//
// Design.  A block of 8 warps owns one patch, a band of `rows` output rows
// by all W columns, a chunk of `zc` output planes and all of O; it walks its
// planes in order (the TPU's sequential grid axis becomes a loop).  A ring
// of three shared-memory slots holds input plane tiles of (rows+1) x (W+1)
// voxels: one zero halo row above (read from the band above, or zero at
// h = 0) and one zero column on the left, since the taps read rows and
// columns -1 and 0 relative to the output.  Output plane z takes kd2 = 0
// from one slot and kd2 = 1 from the next while plane z+2 arrives in the
// third by 16-byte cp.async (zero filled past H): each plane leaves device
// memory once per band, the halo row once more through L2, and a z chunk
// re-reads only its first plane.  The block stages its patch parity's
// packed weights once, with 16-byte cp.async, with the first plane.  Plane
// addressing takes two multiply-high divisions per 16-byte piece and no
// 64-bit divide.  Voxel rows are padded to C8p + 8 bf16 and weight rows to
// 8 C8p + 8, so ldmatrix's eight row addresses of a phase hit distinct
// banks.  Each warp takes 32-voxel groups of the band (2 x 4 mma tiles per
// 32 output channels), its ldmatrix.x4 fragments loaded one (tap, k-step)
// ahead of the mma steps.  The block stages the weight rows in a column
// order (column_channel) that leaves each lane's accumulators holding 8
// consecutive channels of a voxel, so the epilogue stores them as one
// 16-byte bf16 vector (two for float32) and one 8-byte vector of codes,
// with no shuffle: a warp writes 512 contiguous bytes of bf16 and 256 of
// codes per store.  Two blocks share an SM, so one's epilogue overlaps the
// other's loads.  rows, zc and the grid come
// from kernels/stem.py::_k2_plan.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_code.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = 3;          // planes in the shared-memory ring
constexpr int BN = 32;            // output channels per chunk of O
constexpr int SMEM_MAX = 232448;  // opt-in shared memory of one block
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const __nv_bfloat16* x;
  const int* par;
  const __nv_bfloat16* w;
  const float* bias;
  const float* alpha_p;
  void* y;
  int8_t* q;
  float alpha_v;
  int D, H, W, C8, O, qlvl, out_bf16;
  int rows, zc, bands;  // the plan: band height, planes per chunk, bands
  int c8p;              // C8 rounded up to 16, the mma depth
  int kp;               // 8 * c8p: K of one parity's weights
  int cs;               // bf16 per staged voxel: c8p + 8
  int ws;               // bf16 per staged weight row: kp + 8
  int op;               // O rounded up to BN
  int ch8;              // 16-byte pieces per voxel of x: C8 / 8
  int row_pieces;       // pieces per input row: W * ch8
  uint32_t ch8_magic;   // for j / ch8 by div_magic
  int slot_bytes, off_bias, off_ring;
  int vec;              // O % 8 == 0: 16-byte (bf16, float32) and 8-byte
                        // (int8) stores of 8 channels
};

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

// wait until at most one cp.async group is pending
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The output channel of mma column n: in each chunk of BN columns, column
// nt * 8 + 2 t + j (the accumulator of quad lane t, tile nt, pair j) holds
// channel 8 t + 2 nt + j, so each lane's accumulators are 8 consecutive
// channels.  Only the weights' rows move; each channel's sum is the same.
__host__ __device__ __forceinline__ int column_channel(int n) {
  const int c = n & (BN - 1);
  return (n - c) + ((c >> 1) & 3) * 8 + (c >> 3) * 2 + (c & 1);
}

// e / d for e * d < 2^32, magic = ceil(2^32 / d) (0 for d = 1)
__device__ __forceinline__ int div_magic(int e, int d, uint32_t magic) {
  return d == 1 ? e : static_cast<int>(__umulhi(e, magic));
}

// Stage a plane tile into a ring slot: input rows h0 - 1 .. h0 + rows - 1
// (zero outside 0..H-1) at slot rows 0..rows, columns 0..W-1 at slot
// columns 1..W.  Thread piece j of a row (16 bytes: column j / ch8,
// channels 8 (j % ch8) on) is the same piece of every row, so the column
// takes one division per piece and each row an add.
__device__ __forceinline__ void load_plane(const Args& a, char* slot,
                                           const __nv_bfloat16* xp, int h0) {
  const long long row_elems = static_cast<long long>(a.W) * a.C8;
  const int slot_row = (a.W + 1) * a.cs * 2;
  for (int j = threadIdx.x; j < a.row_pieces; j += THREADS) {
    const int w = div_magic(j, a.ch8, a.ch8_magic);
    const int ch = j - w * a.ch8;
    uint32_t dst = smem_u32(slot + ((w + 1) * a.cs + ch * 8) * 2);
    const __nv_bfloat16* src = xp + (h0 - 1) * row_elems + j * 8;
    for (int r = 0; r <= a.rows; ++r, dst += slot_row, src += row_elems) {
      const bool valid =
          static_cast<unsigned>(h0 - 1 + r) < static_cast<unsigned>(a.H);
      cp_async16(dst, valid ? src : xp, valid);
    }
  }
}

// KS: k-steps per tap, c8p / 16, at compile time (0: at run time, from
// a.c8p); BF16: bfloat16 output, else float32
template <int KS, bool BF16>
__global__ void __launch_bounds__(THREADS, 2) stem_s2d_kernel(Args a) {
  extern __shared__ __align__(128) char smem[];
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [op][ws]
  float* bs = reinterpret_cast<float*>(smem + a.off_bias);    // [op]
  char* ring = smem + a.off_ring;                              // SLOTS slots

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int chunk = blockIdx.x / a.bands;
  const int h0 = (blockIdx.x - chunk * a.bands) * a.rows;
  const int z0 = chunk * a.zc;
  const int nz = min(a.D - z0, a.zc);
  const bool odd = a.par[b] != 0;
  const long long plane = static_cast<long long>(a.H) * a.W * a.C8;
  const __nv_bfloat16* xb =
      a.x + (static_cast<long long>(b) * (a.D + 1) + z0) * plane;
  const int W1 = a.W + 1;

  // group 0: the parity's packed weights and plane 0; group 1: plane 1
  {
    const __nv_bfloat16* wp = a.w + (odd ? static_cast<long long>(a.O) * a.kp
                                         : 0LL);
    const int pieces = a.kp / 8;
    for (int e = tid; e < a.op * pieces; e += THREADS) {
      const int n = e / pieces, j = e - n * pieces;
      const int o = column_channel(n);
      const bool valid = o < a.O;
      cp_async16(smem_u32(Ws + n * a.ws + j * 8),
                 valid ? wp + static_cast<long long>(o) * a.kp + j * 8 : wp,
                 valid);
    }
  }
  load_plane(a, ring, xb, h0);
  cp_async_commit();
  load_plane(a, ring + a.slot_bytes, xb + plane, h0);
  cp_async_commit();
  // zeros that no copy writes: each slot's halo column, and the channels
  // C8..C8p-1 of every voxel
  {
    const int cp8 = a.c8p / 8;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int e = tid; e < SLOTS * (a.rows + 1) * cp8; e += THREADS) {
      const int j = e % cp8, sr = e / cp8;
      const int s = sr / (a.rows + 1), r = sr - s * (a.rows + 1);
      *reinterpret_cast<uint4*>(ring + s * a.slot_bytes +
                                (r * W1 * a.cs + j * 8) * 2) = zero;
    }
    const int padp = cp8 - a.ch8;
    if (padp > 0) {
      for (int e = tid; e < SLOTS * (a.rows + 1) * a.W * padp;
           e += THREADS) {
        const int j = e % padp, v = e / padp;
        const int s = v / ((a.rows + 1) * a.W);
        const int rw = v - s * (a.rows + 1) * a.W;
        const int r = rw / a.W, w = rw - r * a.W;
        *reinterpret_cast<uint4*>(
            ring + s * a.slot_bytes +
            ((r * W1 + w + 1) * a.cs + (a.ch8 + j) * 8) * 2) = zero;
      }
    }
  }
  for (int i = tid; i < a.op; i += THREADS) bs[i] = i < a.O ? a.bias[i] : 0.0f;
  const Quant q = quant_setup(a.alpha_p != nullptr ? *a.alpha_p : a.alpha_v,
                              a.qlvl);

  const int band_vox = a.rows * a.W;
  const int store_vox = min(a.rows, a.H - h0) * a.W;  // voxels inside H
  const int groups = (band_vox + 31) / 32;
  const int c8p = KS > 0 ? 16 * KS : a.c8p;
  const int steps = 8 * (c8p / 16);  // (tap, k-step) pairs per voxel
  const long long plane_out = static_cast<long long>(a.H) * a.W;
  // this lane's ldmatrix rows: A, for its voxel of each 16-row tile (slot
  // offsets in bytes, tap (0, 0), before the group's base); B, its weight
  // row of each pair of 8-column tiles
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_k = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_k = ((lane >> 3) & 1) * 8;
  const uint32_t ws_base = smem_u32(Ws) + (b_row * a.ws + b_k) * 2;
  const uint32_t ring_base = smem_u32(ring);

  for (int i = 0; i < nz; ++i) {
    __syncthreads();  // the slot of plane i - 1 is consumed
    if (i + 2 <= nz)
      load_plane(a, ring + ((i + 2) % SLOTS) * a.slot_bytes,
                 xb + (i + 2) * plane, h0);
    cp_async_commit();
    cp_async_wait1();  // planes i and i + 1 (and the weights) have landed
    __syncthreads();
    if (i == 0 && z0 == 0 && odd) {
      // plane 0 of an odd patch: its pz = 0 phase lanes are the conv's
      // zero padding
      const int half = a.C8 / 2;
      for (int e = tid; e < (a.rows + 1) * a.W * half; e += THREADS) {
        const int c = e % half, v = e / half;
        const int r = v / a.W, w = v - r * a.W;
        reinterpret_cast<uint16_t*>(ring)[(r * W1 + w + 1) * a.cs + c] = 0;
      }
      __syncthreads();
    }
    const uint32_t s0 = ring_base + (i % SLOTS) * a.slot_bytes;
    const uint32_t s1 = ring_base + ((i + 1) % SLOTS) * a.slot_bytes;
    const long long out_plane =
        (static_cast<long long>(b) * a.D + z0 + i) * plane_out +
        static_cast<long long>(h0) * a.W;

    for (int grp = warp; grp < groups; grp += WARPS) {
      uint32_t a_off[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m = min(grp * 32 + mt * 16 + a_row, band_vox - 1);
        const int r = m / a.W, w = m - r * a.W;
        a_off[mt] = ((r * W1 + w) * a.cs + a_k) * 2;
      }
      for (int oc = 0; oc < a.op; oc += BN) {
        float acc[2][4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;
        // the fragments of step (tap, ks), one step ahead of the mma
        const uint32_t wchunk = ws_base + oc * a.ws * 2;
        int tap = 0, ks = 0;
        auto load = [&](uint32_t (&af)[2][4], uint32_t (&bf)[2][4]) {
          const uint32_t src = ((tap >> 2) ? s1 : s0) +
                               (((tap >> 1) & 1) * W1 + (tap & 1)) * a.cs * 2 +
                               ks * 2;
          const uint32_t wsrc = wchunk + (tap * c8p + ks) * 2;
          ldsm_x4(af[0], src + a_off[0]);
          ldsm_x4(af[1], src + a_off[1]);
          ldsm_x4(bf[0], wsrc);
          ldsm_x4(bf[1], wsrc + 16 * a.ws * 2);
          ks += 16;
          if (ks == c8p) {
            ks = 0;
            ++tap;
          }
        };
        auto mma = [&](const uint32_t (&af)[2][4],
                       const uint32_t (&bf)[2][4]) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2],
                       bf[nt >> 1][(nt & 1) * 2 + 1]);
        };
        uint32_t af0[2][4], bf0[2][4], af1[2][4], bf1[2][4];
        load(af0, bf0);
        for (int st = 0; st < steps; st += 2) {  // steps is even
          load(af1, bf1);
          mma(af0, bf0);
          if (st + 2 < steps) load(af0, bf0);
          mma(af1, bf1);
        }
        // epilogue: lane (g, t) holds voxel rows g and g + 8 of each 16-row
        // tile, channels oc + 8t + 2 nt + j (column_channel)
        const int o0 = oc + 8 * t;
        if (o0 >= a.O) continue;
        float bias8[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) bias8[k] = bs[o0 + k];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = grp * 32 + mt * 16 + g + 8 * half;
            if (m >= store_vox) continue;
            float v[8];
            uint32_t bits[4], codes[2] = {0u, 0u};
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              float y = __fadd_rn(acc[mt][k >> 1][2 * half + (k & 1)],
                                  bias8[k]);
              y = y < 0.0f ? 0.0f : y;  // relu; a NaN passes, as in
                                        // jnp.maximum
              if (BF16) {
                const uint32_t hb =
                    __bfloat16_as_ushort(__float2bfloat16_rn(y));
                y = __uint_as_float(hb << 16);
                bits[k >> 1] = (k & 1) ? bits[k >> 1] | (hb << 16) : hb;
              }
              v[k] = y;
              codes[k >> 2] |= static_cast<uint32_t>(code_of(y, q))
                               << (8 * (k & 3));
            }
            const long long e0 = (out_plane + m) * a.O + o0;
            if (a.vec) {
              if (BF16) {
                *reinterpret_cast<uint4*>(
                    static_cast<__nv_bfloat16*>(a.y) + e0) =
                    make_uint4(bits[0], bits[1], bits[2], bits[3]);
              } else {
                float4* yp = reinterpret_cast<float4*>(
                    static_cast<float*>(a.y) + e0);
                yp[0] = make_float4(v[0], v[1], v[2], v[3]);
                yp[1] = make_float4(v[4], v[5], v[6], v[7]);
              }
              *reinterpret_cast<uint2*>(a.q + e0) =
                  make_uint2(codes[0], codes[1]);
            } else {
#pragma unroll
              for (int k = 0; k < 8; ++k) {
                if (o0 + k >= a.O) break;
                if (BF16) {
                  static_cast<uint16_t*>(a.y)[e0 + k] =
                      static_cast<uint16_t>(bits[k >> 1] >> (16 * (k & 1)));
                } else {
                  static_cast<float*>(a.y)[e0 + k] = v[k];
                }
                a.q[e0 + k] =
                    static_cast<int8_t>(codes[k >> 2] >> (8 * (k & 3)));
              }
            }
          }
        }
      }
    }
  }
}

int align(int v, int to) { return (v + to - 1) / to * to; }

template <int KS, bool BF16>
int launch(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  auto kernel = stem_s2d_kernel<KS, BF16>;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One call's shape and plan, as kernels/stem.py::_K2Call lays it out:
// rows per band and planes per z chunk from _k2_plan.
struct K2Call {
  int B, D, H, W, C8, O, qlvl, out_bf16;
  int rows, zc;
};

// Plain C entry point for ctypes.  x is (B, D+1, H, W, C8) bfloat16 and
// w pack_stem_weights' (2, O, 8 C8p) bfloat16, both 16-byte aligned; par
// (B,) int32; bias (O,) float32; alpha null to take alpha_v; out_y is
// bfloat16 with call->out_bf16, else float32, and out_q int8, both
// (B, D, H, W, O).  Launches on `stream` and returns cudaGetLastError() (0
// on success), the error of cudaFuncSetAttribute, or cudaErrorInvalidValue
// for a shape or plan it does not take; it does not synchronise and
// allocates nothing.
extern "C" int stem_s2d_launch(const void* x, const void* par, const void* w,
                               const void* bias, const void* alpha,
                               float alpha_v, void* out_y, void* out_q,
                               const K2Call* call, void* stream) {
  const int B = call->B, D = call->D, H = call->H, W = call->W;
  const int C8 = call->C8, O = call->O;
  if (B < 1 || D < 1 || H < 1 || W < 1 || C8 < 8 || C8 % 8 != 0 || O < 1 ||
      call->qlvl < 2 || call->qlvl > 128 || call->rows < 1 ||
      call->rows > H || call->zc < 1 || call->zc > D ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.par = static_cast<const int*>(par);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.alpha_p = static_cast<const float*>(alpha);
  a.y = out_y;
  a.q = static_cast<int8_t*>(out_q);
  a.alpha_v = alpha_v;
  a.D = D; a.H = H; a.W = W; a.C8 = C8; a.O = O;
  a.qlvl = call->qlvl;
  a.out_bf16 = call->out_bf16;
  a.rows = call->rows;
  a.zc = call->zc;
  a.bands = (H + a.rows - 1) / a.rows;
  a.c8p = align(C8, 16);
  a.kp = 8 * a.c8p;
  a.cs = a.c8p + 8;
  a.ws = a.kp + 8;
  a.op = align(O, BN);
  a.ch8 = C8 / 8;
  a.row_pieces = W * a.ch8;
  // umulhi(j, ceil(2^32 / d)) == j / d for j * d < 2^32 and d > 1 (the
  // magic of d = 1, 2^32, does not fit: div_magic takes j itself)
  if (static_cast<long long>(a.row_pieces) * a.ch8 >= (1LL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  a.ch8_magic =
      static_cast<uint32_t>((0x100000000ULL + a.ch8 - 1) / a.ch8);
  // shared memory: weights, bias, the ring (kernels/stem.py::_k2_smem
  // computes the same)
  a.off_bias = align(a.op * a.ws * 2, 128);
  a.off_ring = align(a.off_bias + a.op * 4, 128);
  a.slot_bytes = align((a.rows + 1) * (W + 1) * a.cs * 2, 128);
  const long long smem = a.off_ring + static_cast<long long>(SLOTS) *
                                          a.slot_bytes;
  const bool aligned = reinterpret_cast<uintptr_t>(out_y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out_q) % 16 == 0;
  a.vec = O % 8 == 0 && aligned;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (D + a.zc - 1) / a.zc;
  const dim3 grid(static_cast<unsigned>(a.bands * chunks),
                  static_cast<unsigned>(B));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ks = a.c8p / 16 <= 4 ? a.c8p / 16 : 0;
  const int sm = static_cast<int>(smem);
  if (a.out_bf16) {
    switch (ks) {
      case 1: return launch<1, true>(a, grid, sm, st);
      case 2: return launch<2, true>(a, grid, sm, st);
      case 3: return launch<3, true>(a, grid, sm, st);
      case 4: return launch<4, true>(a, grid, sm, st);
      default: return launch<0, true>(a, grid, sm, st);
    }
  }
  switch (ks) {
    case 1: return launch<1, false>(a, grid, sm, st);
    case 2: return launch<2, false>(a, grid, sm, st);
    case 3: return launch<3, false>(a, grid, sm, st);
    case 4: return launch<4, false>(a, grid, sm, st);
    default: return launch<0, false>(a, grid, sm, st);
  }
}
