// K1: int8 3x3x3 convolution with fused epilogues, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// pallas/qconv3d.py::qconv3x3_int8_ndhwc (bodies
// _qconv3d_kernel, _qconv3d_ring_kernel, _qconv3d_ring_tz_kernel):
//
//   y = conv3d(qa, w) * scale + bias        stride 1, padding = dilation
//   qa: (N, D, H, W, C) int8 activation codes (NDHWC), or the codes of
//       float32 or bfloat16 activations x that K1 quantizes itself (below)
//   w:  (27, O, Cp) int8 weight codes, k contiguous: w[tap][o][c], input
//       channels zero-padded to Cp = 32 * ceil(C / 32), made once at
//       deploy time (kernels/qconv3d.py::pack_weights)
//   scale, bias: (O,) float32
//   accumulation in int32 on the int8 tensor cores, so the sum is exact.
//
// Prologue, for float input: qa = int8(rint(clip(x / alpha, 0, 1) *
// (qlvl - 1))), or on the offset grid of shift x_k > 0 the signed codes
// int8(clip(rint(x / alpha * (qlvl - 1)), -x_k, qlvl - 1 - x_k)) (zero stays
// code 0, so the zero halo needs nothing), x widened exactly to float32
// first, the quant epilogue's arithmetic below.  The JAX package quantizes outside its kernel, in one
// XLA fusion; in eager PyTorch that is five full-size passes (37 bytes an
// element).  Here a pass of K1's own reads x once and writes the codes
// once (5 bytes an element for float32), and the convolution reads the
// codes as it reads any codes.
//
// Epilogues, applied to the float32 y in this order (the Pallas kernel's):
//   residual      y += residual            (float32 or bfloat16, converted
//                                           to float32; relu'd first with
//                                           res_relu)
//   quant         out = int8(rint(clip(y / qalpha, 0, 1) * (qlvl - 1)))
//                 from the float32 y (on the offset grid of quant_k > 0,
//                 the prologue's signed codes)
//   out dtype     y is stored as float32, or rounded to bfloat16 (nearest
//                 even) with out_bf16
//   pool          pool = maxpool_2x2x2 of the stored (rounded) y, VALID
//                 (odd trailing planes drop)
// Float steps use the _rn intrinsics so nothing is contracted into an FMA:
// the reference rounds after the multiply and after the add.  rintf rounds
// half to even, as jnp.round and torch.round do.
//
// What bounds it on an H100 (published peaks: 1,979 int8 TOP/s, 3.35 TB/s):
// at the flagship widths (C = O = 32..256) the bound is the int8
// operations at stages 2-6 and at stage 1's quant conv, and the bytes at
// the block2 convs of stages 1 and 7 (64^3 x 32: codes in, a bf16
// residual in, bf16 y and pool out, about 0.10 ms per conv at B = 8
// against 0.06 ms of operations).  So the multiply-adds run on the tensor
// cores and each activation byte comes from device memory about once.
// Where a block walks many bricks, the epilogue of one brick runs on warps
// of its own while the next brick's taps run (the overlapped pipeline
// below), so the kernel takes about the longer of the two phases, not
// their sum.  What bounds it then (scripts/k1_ablation.py): the tap loop,
// whose every warp reloads its B fragments from shared memory at every
// tap, and the 4 epilogue warps, about even; the int8 tensor cores and
// device memory are far from busy.
//
// Design.  An implicit GEMM, M = output voxels, N = O, K = 27 taps x C.
//  - Tensor cores: mma.sync.m16n8k32 s8 x s8 -> s32, fragments loaded with
//    ldmatrix from shared memory, the next tap's fragments loading while
//    this tap's mma run.
//  - A block owns a brick of BZ x BY x 8 output voxels (BZ, BY even, the
//    brick origin a multiple of the brick, so every 2x2x2 pool cell lies in
//    one brick) and BN = 32 output channels; one warp per 2 x 2 x 8
//    sub-brick, 32 x 32 of y per warp as 2 x 4 mma tiles (rows of a tile:
//    x = 0..7 at (z, y) and at (z, y + 1)).
//  - Halo tile: per 32-channel chunk the block stages the brick's halo
//    once, (BZ + 2s) x (BY + 2s) x (8 + 2s) voxels, s = min(dilation,
//    extent) per axis (a dilation larger than the brick stages three
//    separate slabs instead of the span between them, so any dilation
//    fits).  Every tap's A fragments come from that one buffer: ldmatrix
//    takes a row address per lane, so a tap is a row offset.  Rows are 32
//    bytes of codes padded to 48: any 8 consecutive rows (one ldmatrix
//    phase) then fall on 8 distinct bank groups, and a tap's offset stays a
//    plain add.  Halo voxels outside the volume, and channels past C, are
//    zero-filled (cp.async with src-size 0).  The weight tile (27 x BN rows
//    of 32 bytes, [tap][o][c]) is XOR-swizzled in 16-byte halves by bit 2
//    of the row instead, which keeps a tap's offset a compile-time one.
//  - Pipeline: blocks are persistent over bricks (block x takes bricks x,
//    x + gridDim.x, ...; the grid and brick come from _tile_plan in
//    kernels/qconv3d.py) and walk (brick, chunk) steps with two stages of
//    cp.async (16 bytes, .cg): step s + 1's halo, and its weights when
//    C > 32, load while step s's 27 taps run.  With C <= 32 the weights
//    stay resident for all of the block's bricks.  A thread's halo rows
//    step by a fixed count, walked with carries rather than divides.
//  - Channel counts that are not a multiple of 16 (C = 3 in the tests)
//    stage their halo with plain byte loads instead of cp.async.
//  - Float input: qconv3d_int8_kernel_quantize, launched just before the
//    convolution on the same stream, writes the codes to a scratch tensor
//    with 16-byte loads and 8-byte stores, blocks persistent over the
//    tensor (named with the convolution's prefix, so a trace counts its
//    time as K1's).  With at most 4 levels a code takes no divide
//    (act_code.cuh: a code is the count of thresholds x reaches).
//    Quantizing while staging the halo instead converts each element once
//    per column tile and about 2.3 times per tile (the halo), and its
//    loads wait in the tap loop's registers or in 4x the halo's shared
//    memory (one block an SM instead of two): measured on an H100 at the
//    LiTS block1 convs, 1.5 times the pass and the convolution together
//    (PERF.md section 6).
//  - Epilogue: the int32 sums of a brick go to shared memory, and the
//    epilogue runs over them element-wise, 4 channels a thread (the same 4
//    for all of a thread's rows, so it reads their scale and bias once), so
//    the residual, y and the int8 codes move in coalesced 4- to 16-byte
//    vectors; the next conv's codes come from act_code.cuh's quantizer
//    (thresholds at up to 4 levels, the same bits as the divide).  The
//    pool then takes the max of the stored values of each cell from the
//    same tile.  Its row loop is not unrolled: a fully unrolled epilogue
//    outgrew the instruction cache and its warps waited on instruction
//    fetch (2.2-2.6 times slower on an H100, PERF.md section 6).
//  - Two pipelines, chosen by the tile plan (kernels/qconv3d.py, from the
//    bricks a block walks): taking turns (above), the block's warps load,
//    run the taps, store the sums into the spent stage and run the
//    epilogue themselves between barriers; overlapped (the 4 x 8 brick,
//    where every block walks two or more bricks), one block an SM has 16
//    warps in three roles.  8 MMA warps wait for a step's stage (an
//    mbarrier, FULL), run its 27 taps, release it (EMPTY) and, at a
//    brick's last step, store its sums into one of one or two sums buffers
//    of their own; 4 producer warps issue every cp.async (the weights, the
//    halo of each step, and after a brick's last step its residual into a
//    tile beside its sums buffer, RFULL / REMPTY); 4 epilogue warps take a
//    full sums buffer and its residual tile and run the epilogue, so brick
//    b's epilogue runs while brick b + 1's taps do.  The MMA and epilogue
//    warps hand the sums buffers over with named barriers (bar.arrive /
//    bar.sync, FULL and EMPTY per buffer); the roles share no barrier but
//    the one after the mbarriers are set.  Waiting warps sleep in
//    mbarrier.try_wait rather than poll.  Fewer producer warps left the MMA
//    warps waiting for their loads; a 17th warp would cut every warp's
//    registers to 96 (PERF.md, the warp splits measured).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act_code.cuh"

namespace {

constexpr int BX = 8;                   // brick extent in x: one ldmatrix
constexpr int BN = 32;                  // output channels per block
constexpr int CK = 32;                  // input channels per staged chunk
constexpr int WBYTES = 27 * BN * CK;    // one chunk of weights (27,648 B)
constexpr int HS = 48;                  // halo row stride: 32 bytes + 16
constexpr int SR = BN + 4;              // staged sums row stride, words
constexpr int SMEM_MAX = 232448;        // a block's opt-in shared memory
constexpr int QUANT_BLOCKS = 132 * 8;   // the prologue pass: 8 an SM
// named barriers of the overlapped pipeline (0 is __syncthreads): the
// epilogue warps' pool, and per sums buffer k FULL + k (its sums are
// stored) and EMPTY + k (its epilogue is done)
constexpr int BAR_EPI = 2, BAR_FULL = 3, BAR_EMPTY = 5;
constexpr int MBAR_BYTES = 128;  // the overlapped pipeline's 8 mbarriers
// the overlapped pipeline's epilogue and producer warps, beside its 8 MMA
// warps (the 4 x 8 brick): 16 warps, so 4 a scheduler at 128 registers
constexpr int EPI_WARPS = 4, LOAD_WARPS = 4;

// threads of a block of the kernel below: the MMA threads, one warp per
// 2 x 2 x 8 sub-brick, and the overlapped pipeline's epilogue and producer
// warps
template <int BZ, int BY, bool OVERLAP>
__host__ __device__ constexpr int block_threads() {
  return BZ * BY * 8 + (OVERLAP ? 32 * (EPI_WARPS + LOAD_WARPS) : 0);
}

struct Args {
  const int8_t* qa;
  const int8_t* w;
  const float* scale;  // (O,), or one value with scale_stride 0
  const float* bias;   // (O,), or null for none
  const void* residual;
  const float* qalpha;
  void* out_y;
  int8_t* out_i8;
  void* out_pool;
  int N, D, H, W, C, O, dil;
  int res_relu, quant_qlvl, quant_k, res_bf16, out_bf16, scale_stride;
  int Cp, nchunks;
  int sz, sy, sx;     // tap stride in halo rows per axis: min(dil, extent)
  int EZ, EY, EX;     // halo extents
  int nbz, nby, nbx;  // bricks per axis
  int bricks;         // N * nbz * nby * nbx
  int halo_bytes;     // one halo buffer, a multiple of 128
  int stage_bytes;    // one pipeline stage, a multiple of 128
  int nsums;          // sums buffers of the overlapped pipeline (1 or 2)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// named barrier `id` of `count` threads: wait for it, or arrive without
// waiting
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// byte offset of 16-byte half j of 32-byte weight row r, swizzled so that
// the 8 consecutive rows of one ldmatrix phase hit 8 distinct bank groups
__device__ __forceinline__ uint32_t wslot(int r, int j) {
  return static_cast<uint32_t>(r * 32 + ((j ^ ((r >> 2) & 1)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// mbarriers in shared memory (the overlapped pipeline's stage ring):
// `count` arrivals complete a phase; a wait for parity p returns once the
// phase of parity p has completed (at once for parity 1 on a fresh one)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrives on bar once every cp.async the thread has issued has landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The waiting thread sleeps until the phase completes (or 1 ms passes),
// rather than polling: a polling warp would take issue slots and shared
// memory accesses from the warps at work beside it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        " .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity), "r"(1000000)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// input coordinate of halo index h along an axis whose brick starts at o0
// and spans B, with tap stride s = min(dil, B): one span (s == dil) or
// three slabs of B (dil > B)
__device__ __forceinline__ int halo_coord(int o0, int h, int s, int B,
                                          int dil) {
  return s == dil ? o0 - dil + h : o0 + (h / B - 1) * dil + h % B;
}

template <int BZ, int BY>
__device__ __forceinline__ void brick_origin(const Args& a, int b, int& n,
                                             int& z0, int& y0, int& x0) {
  x0 = (b % a.nbx) * BX;
  int t = b / a.nbx;
  y0 = (t % a.nby) * BY;
  t /= a.nby;
  z0 = (t % a.nbz) * BZ;
  n = t / a.nbz;
}

// n (<= 4) consecutive elements at p + e of a float32 or bfloat16 tensor
// as float32 (zeros after n); `vec`: n == 4 and the group is aligned, one
// 8- or 16-byte access
__device__ __forceinline__ void load4(const void* p, long long e, bool bf16,
                                      bool vec, int n, float (&v)[4]) {
  if (bf16) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p) + e;
    if (vec) {
      const uint2 u = *reinterpret_cast<const uint2*>(q);
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = j < n ? __bfloat162float(q[j]) : 0.0f;
    }
  } else {
    const float* q = static_cast<const float*>(p) + e;
    if (vec) {
      const float4 f = *reinterpret_cast<const float4*>(q);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = j < n ? q[j] : 0.0f;
    }
  }
}

// stores n (<= 4) values at p + e as float32, or as bfloat16 rounded to
// nearest even (the rounded values are handed back in v)
__device__ __forceinline__ void store4(void* p, long long e, bool bf16,
                                       bool vec, int n, float (&v)[4]) {
  if (bf16) {
    __nv_bfloat16* q = static_cast<__nv_bfloat16*>(p) + e;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    if (vec) {
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(q) = u;
    } else {
      const __nv_bfloat16 b[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n) q[j] = b[j];
    }
    v[0] = __low2float(lo);
    v[1] = __high2float(lo);
    v[2] = __low2float(hi);
    v[3] = __high2float(hi);
  } else {
    float* q = static_cast<float*>(p) + e;
    if (vec) {
      *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n) q[j] = v[j];
    }
  }
}

// The epilogue's threads: thread et of ET takes output channels o .. o + 3
// (o = n0 + 4 * (et % 8), nv of them below O) at the brick's rows m = et /
// 8 + i * ET / 8, i < M * (BN / 4) / ET.
struct Group {
  int c, o, nv;     // channel offset in the block's tile, channel, count
  bool vec;         // nv == 4 and the group is aligned: vector accesses
  float scale[4];   // the channels' scale and bias (0 past nv)
  float bias[4];
};

__device__ __forceinline__ Group channel_group(const Args& a, int n0,
                                               int et) {
  Group gr;
  gr.c = 4 * (et & 7);
  gr.o = n0 + gr.c;
  gr.nv = min(4, a.O - gr.o);
  gr.vec = (a.O & 3) == 0 && gr.nv == 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    gr.scale[j] = j < gr.nv ? __ldg(a.scale + (gr.o + j) * a.scale_stride)
                            : 0.0f;
    gr.bias[j] = j < gr.nv && a.bias ? __ldg(a.bias + gr.o + j) : 0.0f;
  }
  return gr;
}

// row m of the thread's i-th group and its element offset in y (NDHWC,
// channel o), or -1 where the voxel lies past the volume or no channel of
// the group exists
template <int BZ, int BY, int ET>
__device__ __forceinline__ long long group_at(const Args& a, const Group& gr,
                                              int et, int i, int n, int z0,
                                              int y0, int x0, int& m) {
  m = (et >> 3) + i * (ET / 8);
  const int z = z0 + m / (BY * BX), y = y0 + (m / BX) % BY, x = x0 + m % BX;
  if (gr.nv <= 0 || z >= a.D || y >= a.H || x >= a.W) return -1;
  return (((static_cast<long long>(n) * a.D + z) * a.H + y) * a.W + x) *
             a.O + gr.o;
}

// The residual of each group loaded as the epilogue reaches it.
struct Inline {
  __device__ __forceinline__ void get(const Args& a, const Group& gr, int,
                                      long long at, float (&v)[4]) const {
    load4(a.residual, at, a.res_bf16, gr.vec, gr.nv, v);
  }
};

// The residual of the brick's rows from the tile the producer warps staged
// in shared memory: row m, the block's BN channels (float32, or bfloat16
// with res_bf16), widened to float32.
struct Staged {
  const uint8_t* tile;

  __device__ __forceinline__ void get(const Args& a, const Group& gr, int m,
                                      long long, float (&v)[4]) const {
    if (a.res_bf16) {
      const uint2 u =
          *reinterpret_cast<const uint2*>(tile + (m * BN + gr.c) * 2);
      v[0] = __uint_as_float(u.x << 16);
      v[1] = __uint_as_float(u.x & 0xffff0000u);
      v[2] = __uint_as_float(u.y << 16);
      v[3] = __uint_as_float(u.y & 0xffff0000u);
    } else {
      const float4 f =
          *reinterpret_cast<const float4*>(tile + (m * BN + gr.c) * 4);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    }
  }
};

// Whether the producer stages the residual (16-byte rows of channels, so
// O * its element size is a multiple of 16).
__device__ __forceinline__ bool residual_staged(const Args& a) {
  return a.residual && a.O % (a.res_bf16 ? 8 : 4) == 0;
}

// The residual of brick b into tile (M rows of BN channels), thread t of
// T: 16-byte chunks of a row, zeros past the volume and past O.  A
// thread's chunk q of a row is fixed and its rows step by RS (T / chunks a
// row, a multiple of 8), so x stays and y and z advance with one carry.
template <int BZ, int BY, int T>
__device__ __forceinline__ void load_residual_tile(const Args& a,
                                                   uint8_t* tile, int b,
                                                   int n0, int t) {
  static_assert(T % 64 == 0, "a thread's rows step by a multiple of 8");
  constexpr int M = BZ * BY * BX;
  int n, z0, y0, x0;
  brick_origin<BZ, BY>(a, b, n, z0, y0, x0);
  const int esize = a.res_bf16 ? 2 : 4, per_row = BN * esize / 16;
  const int rs = T / per_row;  // rows a step: 16 (float32) or 32 (bf16)
  const int ch = n0 + (t % per_row) * (16 / esize);
  int m = t / per_row;
  const int dx = m % BX;
  int dy = (m / BX) % BY, dz = m / (BY * BX);
  const long long sy = static_cast<long long>(a.W) * a.O,
                  sz = static_cast<long long>(a.H) * sy;
  long long at =
      (((static_cast<long long>(n) * a.D + z0 + dz) * a.H + y0 + dy) * a.W +
       x0 + dx) * a.O + ch;
  const bool in_x = x0 + dx < a.W && ch < a.O;
  const uint32_t base = smem_u32(tile);
  const uint8_t* const res = static_cast<const uint8_t*>(a.residual);
  for (; m < M; m += rs) {
    const bool ok = in_x && z0 + dz < a.D && y0 + dy < a.H;
    cp_async16(base + (m * per_row + t % per_row) * 16,
               ok ? res + at * esize : res, ok);
    dy += rs / BX;  // rs / BX < BY: one carry at most
    at += (rs / BX) * sy;
    if (dy >= BY) {
      dy -= BY;
      ++dz;
      at += sz - BY * sy;
    }
  }
}

// The quant epilogue's quantizer, the next conv's act_code of y: by
// thresholds at up to 4 levels (act_code.cuh); the whole warp calls it.
__device__ __forceinline__ Quant next_quant(const Args& a) {
  return quant_setup(a.quant_qlvl ? *a.qalpha : 1.0f,
                     a.quant_qlvl ? a.quant_qlvl : 2, a.quant_k);
}

// The epilogue of one brick for thread et of ET: y = sums * scale + bias,
// + the residual (from `res`, relu'd with res_relu), then the next conv's
// codes (act_code of y by `q`) or y stored, then (sync_pool() first, a barrier of the ET
// threads) the VALID 2x2x2 max of the stored values.  sums: the brick's
// int32 sums, row m at m * SR words, which the pool overwrites with the
// stored values.
template <int BZ, int BY, int ET, typename Res, typename SyncPool>
__device__ __forceinline__ void epilogue_brick(
    const Args& a, int* sums, const Group& gr, int et, int n, int z0, int y0,
    int x0, const Res& res, const Quant& q, SyncPool sync_pool) {
  constexpr int M = BZ * BY * BX, ROWS = M * (BN / 4) / ET;
  static_assert(M * (BN / 4) % ET == 0, "every thread takes ROWS rows");
  // a row at a time: the code of an unrolled epilogue outgrows the
  // instruction cache that its warps share with the MMA and producer warps
  // running other code (unrolled twice or four times it is no faster)
#pragma unroll 1
  for (int i = 0; i < ROWS; ++i) {
    int m;
    const long long at =
        group_at<BZ, BY, ET>(a, gr, et, i, n, z0, y0, x0, m);
    const int4 acc4 = *reinterpret_cast<const int4*>(sums + m * SR + gr.c);
    const int iv[4] = {acc4.x, acc4.y, acc4.z, acc4.w};
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = j < gr.nv ? __fadd_rn(__fmul_rn(__int2float_rn(iv[j]),
                                             gr.scale[j]),
                                   gr.bias[j])
                       : 0.0f;
    if (at >= 0) {
      if (a.residual) {
        float r[4];
        res.get(a, gr, m, at, r);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = __fadd_rn(v[j], a.res_relu ? fmaxf(r[j], 0.0f) : r[j]);
      }
      if (a.quant_qlvl) {
        uint32_t packed = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          packed |= (static_cast<uint32_t>(code_of(v[j], q)) & 0xffu)
                    << (8 * j);
        int8_t* dst = a.out_i8 + at;
        if (gr.vec) {
          *reinterpret_cast<uint32_t*>(dst) = packed;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < gr.nv) dst[j] = static_cast<int8_t>(packed >> (8 * j));
        }
      } else {
        store4(a.out_y, at, a.out_bf16, gr.vec, gr.nv, v);
      }
    } else if (a.out_bf16) {  // a voxel past the edge: round as stored
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = __bfloat162float(__float2bfloat16_rn(v[j]));
    }
    if (a.out_pool)  // the stored values, for the pool
      *reinterpret_cast<float4*>(sums + m * SR + gr.c) =
          make_float4(v[0], v[1], v[2], v[3]);
  }
  if (!a.out_pool) return;
  sync_pool();
  const float* const ys = reinterpret_cast<const float*>(sums);
  const int Dp = a.D / 2, Hp = a.H / 2, Wp = a.W / 2;
  constexpr int CY = BY / 2, CX = BX / 2;
  for (int e = et; e < (M / 8) * (BN / 4); e += ET) {
    const int cell = e / (BN / 4), c = 4 * (e % (BN / 4)), o = gr.o - gr.c + c;
    const int cz = cell / (CY * CX), cy = (cell / CX) % CY, cx = cell % CX;
    const int zc = z0 / 2 + cz, yc = y0 / 2 + cy, xc = x0 / 2 + cx;
    const int nv = min(4, a.O - o);
    if (nv <= 0 || zc >= Dp || yc >= Hp || xc >= Wp) continue;
    float mx[4];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int m = ((2 * cz + (k >> 2)) * BY + 2 * cy + ((k >> 1) & 1)) *
                        BX + 2 * cx + (k & 1);
      const float4 f = *reinterpret_cast<const float4*>(ys + m * SR + c);
      const float w4[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) mx[j] = k ? fmaxf(mx[j], w4[j]) : w4[j];
    }
    const long long at =
        (((static_cast<long long>(n) * Dp + zc) * Hp + yc) * Wp + xc) *
            a.O + o;
    // exact: each max is one of the stored values
    store4(a.out_pool, at, a.out_bf16, (a.O & 3) == 0 && nv == 4, nv, mx);
  }
}

// The codes of a float input x of n elements, act_code(x[i]): 8 elements
// a thread and step (two 16-byte loads of float32 or one of bfloat16, one
// 8-byte store), the blocks persistent over the tensor so each warp finds
// its thresholds once; the last n % 8 elements one a thread.  x is
// 16-byte aligned, qa 8-byte aligned.
template <bool BF16>
__global__ void __launch_bounds__(256)
qconv3d_int8_kernel_quantize(const void* x, const float* alpha, int qlvl,
                             int k, int8_t* qa, long long n) {
  const Quant q = quant_setup(*alpha, qlvl, k);
  const long long groups = n / 8;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    float v[8];
    if (BF16) {
      const uint4 u = __ldg(static_cast<const uint4*>(x) + g);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);              // low bf16
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // high bf16
      }
    } else {
      const float4 lo = __ldg(static_cast<const float4*>(x) + 2 * g);
      const float4 hi = __ldg(static_cast<const float4*>(x) + 2 * g + 1);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    }
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      word[i / 4] |= (static_cast<uint32_t>(code_of(v[i], q)) & 0xffu)
                     << (8 * (i % 4));
    reinterpret_cast<uint2*>(qa)[g] = make_uint2(word[0], word[1]);
  }
  const long long i = groups * 8 + threadIdx.x;
  if (blockIdx.x == 0 && i < n) {
    const float v =
        BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i])
             : static_cast<const float*>(x)[i];
    qa[i] = static_cast<int8_t>(code_of(v, q));
  }
}

// The weights of input-channel chunk `chunk` into dst (27 x BN rows of 32
// bytes, swizzled), thread t of T: cp.async, zeros past O.
template <int T>
__device__ __forceinline__ void load_weights(const Args& a, uint8_t* dst,
                                             int n0, int chunk, int t) {
  const uint32_t base = smem_u32(dst);
  const int c0 = chunk * CK;
  for (int e = t; e < 27 * BN * 2; e += T) {
    const int j = e & 1, row = e >> 1;  // row = tap * BN + n
    const int tap = row / BN, o = n0 + row % BN;
    const bool ok = o < a.O;
    const int8_t* src =
        ok ? a.w + (static_cast<long long>(tap) * a.O + o) * a.Cp + c0 +
                 16 * j
           : a.w;
    cp_async16(base + wslot(row, j), src, ok);
  }
}

// The halo of brick b, chunk `chunk`, into dst (rows of HS bytes, zeros
// outside the volume and past C), thread t of T: its 16-byte halves are
// t, t + T, ...  With T even its half j = t & 1 is fixed and its rows step
// by T / 2, whose (z, y, x) it walks with carries, not a divide a row.
// C % 16 == 0 (VEC): cp.async, else byte loads and a 16-byte store.
template <int BZ, int BY, bool VEC, int T>
__device__ __forceinline__ void load_halo(const Args& a, uint8_t* dst, int b,
                                          int chunk, int t) {
  static_assert(T % 2 == 0, "a thread's half of a row is fixed");
  constexpr int STEP = T / 2;
  int n, z0, y0, x0;
  brick_origin<BZ, BY>(a, b, n, z0, y0, x0);
  const uint32_t base = smem_u32(dst);
  const int j = t & 1, c = chunk * CK + 16 * j;
  const int plane = a.EY * a.EX, rows = a.EZ * plane;
  int row = t >> 1;
  int hx = row % a.EX, hy = (row / a.EX) % a.EY, hz = row / plane;
  const int dx = STEP % a.EX, dy = (STEP / a.EX) % a.EY, dz = STEP / plane;
  for (; row < rows; row += STEP) {
    const int z = halo_coord(z0, hz, a.sz, BZ, a.dil);
    const int y = halo_coord(y0, hy, a.sy, BY, a.dil);
    const int x = halo_coord(x0, hx, a.sx, BX, a.dil);
    const bool in = z >= 0 && z < a.D && y >= 0 && y < a.H && x >= 0 &&
                    x < a.W;
    const long long vox =
        ((static_cast<long long>(n) * a.D + z) * a.H + y) * a.W + x;
    const uint32_t at = row * HS + 16 * j;
    if (VEC) {  // C % 16 == 0: 16-byte halves are all in or all out
      const bool ok = in && c < a.C;
      cp_async16(base + at, ok ? a.qa + vox * a.C + c : a.qa, ok);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (in) {
        const int8_t* src = a.qa + vox * a.C;
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (c + k < a.C)
            v[k >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                             src[c + k]))
                         << (8 * (k & 3));
      }
      *reinterpret_cast<uint4*>(dst + at) = make_uint4(v[0], v[1], v[2],
                                                       v[3]);
    }
    hx += dx;  // the next row: dx < EX and dy < EY, so one carry each
    const bool cx = hx >= a.EX;
    if (cx) hx -= a.EX;
    hy += dy + cx;
    const bool cy = hy >= a.EY;
    if (cy) hy -= a.EY;
    hz += dz + cy;
  }
}

// The overlapped pipeline's producer warps (thread t of T): the resident
// weights (C <= 32) first, then for each (brick, chunk) step s its halo
// and (C > 32) its weights into stage s & 1 once the MMA warps have
// released it (EMPTY), announced on FULL when they have landed; after a
// brick's last step, its residual into tile j % nsums once the epilogue
// warps have released it (REMPTY), announced on RFULL: the MMA warps'
// next loads are out before it waits.
template <int BZ, int BY, bool VEC, int T>
__device__ __forceinline__ void producer_warps(const Args& a, uint8_t* smem,
                                               uint8_t* wres, uint8_t* tiles,
                                               uint64_t* bars, int n0,
                                               int steps, int t) {
  uint64_t *full = bars, *empty = bars + 2, *rfull = bars + 4,
           *rempty = bars + 6;
  const bool staged = residual_staged(a);
  if (a.nchunks == 1) load_weights<T>(a, wres, n0, 0, t);
  for (int s = 0; s < steps; ++s) {
    const int k = s & 1, b = blockIdx.x + (s / a.nchunks) * gridDim.x;
    mbar_wait(empty + k, ((s >> 1) & 1) ^ 1);  // step s - 2 is done
    uint8_t* const stage = smem + k * a.stage_bytes;
    load_halo<BZ, BY, VEC, T>(a, stage, b, s % a.nchunks, t);
    if (a.nchunks > 1)
      load_weights<T>(a, stage + a.halo_bytes, n0, s % a.nchunks, t);
    if (VEC) {
      mbar_arrive_on_copies(full + k);
    } else {  // the byte loads' stores are ordered by the arrive itself
      cp_async_wait_all();
      mbar_arrive(full + k);
    }
    if (staged && s % a.nchunks == a.nchunks - 1) {
      const int j = s / a.nchunks, r = j % a.nsums;
      mbar_wait(rempty + r, ((j / a.nsums) & 1) ^ 1);  // brick j - nsums
      load_residual_tile<BZ, BY, T>(a, tiles + r * (BZ * BY * BX * BN * 4),
                                    b, n0, t);
      mbar_arrive_on_copies(rfull + r);
    }
  }
  cp_async_wait_all();
}

// The overlapped pipeline's epilogue warps (thread et of ET, beside the
// M MMA threads): for each of the block's bricks, (FULL) its sums from
// buffer j % nsums and (RFULL) its staged residual, the epilogue, and
// (EMPTY, REMPTY) the buffers handed back.  EMPTY is arrived at once per
// brick the MMA warps store (first for the buffers' first bricks), so both
// roles pass each barrier the same number of times.
template <int BZ, int BY, int ET>
__device__ __forceinline__ void epilogue_warps(const Args& a, int* sums,
                                               const uint8_t* tiles,
                                               uint64_t* bars, int et, int n0,
                                               int bricks_here) {
  constexpr int M = BZ * BY * BX, ALL = M + ET;
  uint64_t *rfull = bars + 4, *rempty = bars + 6;
  const Group gr = channel_group(a, n0, et);
  const Quant q = next_quant(a);
  const bool staged = residual_staged(a);
  for (int k = 0; k < a.nsums && k < bricks_here; ++k)
    bar_arrive(BAR_EMPTY + k, ALL);
  for (int j = 0; j < bricks_here; ++j) {
    int n, z0, y0, x0;
    brick_origin<BZ, BY>(a, blockIdx.x + j * gridDim.x, n, z0, y0, x0);
    const int k = j % a.nsums;
    bar_sync(BAR_FULL + k, ALL);
    auto sync_pool = [] { bar_sync(BAR_EPI, ET); };
    if (staged) {
      mbar_wait(rfull + k, (j / a.nsums) & 1);
      epilogue_brick<BZ, BY, ET>(a, sums + k * (M * SR), gr, et, n, z0, y0,
                                 x0, Staged{tiles + k * (M * BN * 4)}, q,
                                 sync_pool);
      mbar_arrive(rempty + k);
    } else {
      epilogue_brick<BZ, BY, ET>(a, sums + k * (M * SR), gr, et, n, z0, y0,
                                 x0, Inline(), q, sync_pool);
    }
    if (j + a.nsums < bricks_here) bar_arrive(BAR_EMPTY + k, ALL);
  }
}

// OVERLAP: the overlapped pipeline (8 MMA, EPI_WARPS epilogue and
// LOAD_WARPS producer warps), else the one whose warps take turns at
// loads, taps and epilogue
template <int BZ, int BY, bool VEC, bool OVERLAP>
__global__ void __launch_bounds__(
    BZ * BY * 8 + (OVERLAP ? 32 * (EPI_WARPS + LOAD_WARPS) : 0),
    OVERLAP ? 1 : 512 / (BZ * BY * 8))
qconv3d_int8_kernel(const Args a) {
  constexpr int THREADS = BZ * BY * 8;  // one warp per 2 x 2 x 8 sub-brick
  constexpr int M = BZ * BY * BX;       // output voxels per brick
  extern __shared__ __align__(128) uint8_t smem[];
  // stage k (k = 0, 1) at smem + k * stage_bytes: the halo, then (C > 32)
  // the chunk's weights; with C <= 32 the weights sit after both stages;
  // then, overlapped, the sums buffers (M rows of SR words each), as many
  // residual tiles (M rows of BN float32) and the 8 mbarriers
  uint8_t* const wres = smem + 2 * a.stage_bytes;
  int* const sums_buf =
      reinterpret_cast<int*>(wres + (a.nchunks > 1 ? 0 : WBYTES));
  uint8_t* const tiles = reinterpret_cast<uint8_t*>(sums_buf +
                                                    a.nsums * (M * SR));
  uint64_t* const bars =  // FULL, EMPTY, RFULL, REMPTY: 2 each
      reinterpret_cast<uint64_t*>(tiles + a.nsums * (M * BN * 4));
  uint64_t *const full = bars, *const empty = bars + 2;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const int bricks_here =
      (a.bricks - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int steps = bricks_here * a.nchunks;
  if constexpr (OVERLAP) {
    constexpr int LOADER = THREADS + 32 * EPI_WARPS;  // its first thread
    if (tid == LOADER) {
      for (int k = 0; k < 2; ++k) {
        mbar_init(bars + k, 32 * LOAD_WARPS);          // FULL
        mbar_init(bars + 2 + k, THREADS);              // EMPTY
        mbar_init(bars + 4 + k, 32 * LOAD_WARPS);      // RFULL
        mbar_init(bars + 6 + k, 32 * EPI_WARPS);       // REMPTY
      }
    }
    // the mbarriers are set before any warp uses them: the one barrier of
    // all the block's warps, before their roles part
    __syncthreads();
    if (tid >= THREADS && tid < LOADER) {
      epilogue_warps<BZ, BY, 32 * EPI_WARPS>(a, sums_buf, tiles, bars,
                                             tid - THREADS, n0, bricks_here);
      return;
    }
    if (tid >= LOADER) {
      producer_warps<BZ, BY, VEC, 32 * LOAD_WARPS>(a, smem, wres, tiles,
                                                    bars, n0, steps,
                                                    tid - LOADER);
      return;
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wz = warp / (BY / 2), wy = warp % (BY / 2);

  // ldmatrix roles.  A (m-tile mt): lanes 0-7 rows (2wz+mt, 2wy, x) bytes
  // 0-15, lanes 8-15 rows (.., 2wy+1, x), lanes 16-31 the same at bytes
  // 16-31; a tap adds its row offset.  B (n-tile pair np): lanes 0-7 /
  // 8-15 channels 0-7 at bytes 0-15 / 16-31, lanes 16-31 channels 8-15; a
  // tap adds tap * BN rows, a compile-time offset.
  uint32_t a_off[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    a_off[mt] = (((2 * wz + mt) * a.EY + 2 * wy + ((lane >> 3) & 1)) * a.EX +
                 (lane & 7)) * HS + ((lane >> 4) << 4);
  uint32_t b_off[2];
#pragma unroll
  for (int np = 0; np < 2; ++np)
    b_off[np] = wslot(np * 16 + ((lane >> 4) << 3) + (lane & 7),
                      (lane >> 3) & 1);
  // a tap's row offset in the halo, in bytes, per axis
  const int tz = a.sz * a.EY * a.EX * HS, ty = a.sy * a.EX * HS,
            tx = a.sx * HS;

  auto issue = [&](int s) {  // taking turns: the loads of step s
    uint8_t* const stage = smem + (s & 1) * a.stage_bytes;
    load_halo<BZ, BY, VEC, THREADS>(
        a, stage, blockIdx.x + (s / a.nchunks) * gridDim.x, s % a.nchunks,
        tid);
    if (a.nchunks > 1)
      load_weights<THREADS>(a, stage + a.halo_bytes, n0, s % a.nchunks, tid);
  };

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0;

  if constexpr (!OVERLAP) {
    if (a.nchunks == 1)  // resident for every brick
      load_weights<THREADS>(a, wres, n0, 0, tid);
    issue(0);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    if constexpr (OVERLAP) {
      mbar_wait(full + (s & 1), (s >> 1) & 1);  // step s's loads landed
    } else {
      if (s + 1 < steps) issue(s + 1);
      cp_async_commit();
      cp_async_wait_1();  // step s's group has landed
      __syncthreads();
    }

    uint8_t* const stage = smem + (s & 1) * a.stage_bytes;
    const uint32_t hs = smem_u32(stage);
    const uint32_t ws = smem_u32(a.nchunks > 1 ? stage + a.halo_bytes : wres);
    // the 27 taps, software-pipelined: tap + 1's fragments load while
    // tap's mma run (ldmatrix and mma are volatile asm, issued in order)
    uint32_t af[2][2][4], bf[2][4][2];
    auto fragments = [&](int tap, uint32_t (&fa)[2][4],
                         uint32_t (&fb)[4][2]) {
      const uint32_t off = hs + (tap / 9) * tz + ((tap / 3) % 3) * ty +
                           (tap % 3) * tx;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(fa[mt], off + a_off[mt]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t q[4];
        ldmatrix_x4(q, ws + tap * (BN * CK) + b_off[np]);
        fb[2 * np][0] = q[0];
        fb[2 * np][1] = q[1];
        fb[2 * np + 1][0] = q[2];
        fb[2 * np + 1][1] = q[3];
      }
    };
    fragments(0, af[0], bf[0]);
#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      if (tap + 1 < 27)
        fragments(tap + 1, af[(tap + 1) & 1], bf[(tap + 1) & 1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], af[tap & 1][mt], bf[tap & 1][nt]);
    }
    if constexpr (OVERLAP) mbar_arrive(empty + (s & 1));  // stage read

    if (s % a.nchunks == a.nchunks - 1) {  // the brick is summed: epilogue
      const int j = s / a.nchunks;  // the block's j-th brick
      // the int32 sums go to row m of the brick, BN + 4 words: overlapped
      // to sums buffer j % nsums once its last epilogue is done, else to
      // the spent stage's halo and weights
      int* const sums = OVERLAP ? sums_buf + (j % a.nsums) * (M * SR)
                                : reinterpret_cast<int*>(stage);
      if constexpr (OVERLAP)
        bar_sync(BAR_EMPTY + j % a.nsums, THREADS + 32 * EPI_WARPS);
      else
        __syncthreads();
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int m = ((2 * wz + mt) * BY + 2 * wy + half) * BX + g;
            *reinterpret_cast<int2*>(sums + m * SR + nt * 8 + 2 * t) =
                make_int2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
          }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0;
      if constexpr (OVERLAP) {  // the epilogue warps take it from here
        __threadfence_block();
        bar_arrive(BAR_FULL + j % a.nsums, THREADS + 32 * EPI_WARPS);
      } else {  // the block runs the epilogue itself
        __syncthreads();
        int n, z0, y0, x0;
        brick_origin<BZ, BY>(a, blockIdx.x + j * gridDim.x, n, z0, y0, x0);
        epilogue_brick<BZ, BY, THREADS>(
            a, sums, channel_group(a, n0, tid), tid, n, z0, y0, x0, Inline(),
            next_quant(a), [] { __syncthreads(); });
      }
    }
    if constexpr (!OVERLAP) __syncthreads();  // stage s & 1 is free
  }
}

template <int BZ, int BY, bool VEC, bool OVERLAP>
int launch(const Args& a, dim3 grid, int smem, cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  auto kernel = qconv3d_int8_kernel<BZ, BY, VEC, OVERLAP>;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  constexpr int threads = block_threads<BZ, BY, OVERLAP>();
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  Pointers that do not apply are null:
// x_alpha and qa (x_qlvl == 0), bias (none), residual (no residual
// epilogue), qalpha and out_i8 (quant_qlvl == 0), out_y (quant_qlvl > 0),
// out_pool (no pool epilogue).  x is int8 codes with x_qlvl == 0, else
// float32 (bfloat16 with x_bf16) activations, quantized to x_qlvl levels
// of x_alpha into qa (int8, x's shape) first; residual is bfloat16 with
// res_bf16, else float32; x_k and quant_k are the offset-grid shifts of
// the prologue's and the quant epilogue's codes (0: the unsigned grid);
// out_y and out_pool are bfloat16 with out_bf16,
// else float32.  scale is (O,) with scale_per_channel, else one value.  x
// (codes when C % 16 == 0; floats always), qa and w are 16-byte aligned,
// residual 8-byte aligned.  The tile plan (brick_z x brick_y x 8 voxels,
// grid_x x grid_y blocks, and sums_buffers: 0 for the pipeline that takes
// turns, 1 or 2 for the overlapped one, 4 x 8 bricks only) is
// kernels/qconv3d.py::_tile_plan's.  Launches
// on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plan it does not take; it does not
// synchronise.
extern "C" int qconv3d_int8_launch(const void* x, const void* x_alpha,
                                   void* qa, const void* w,
                                   const void* scale, const void* bias,
                                   const void* residual, const void* qalpha,
                                   void* out_y, void* out_i8, void* out_pool,
                                   int N, int D, int H, int W, int C, int O,
                                   int dil, int x_qlvl, int x_bf16,
                                   int res_relu, int quant_qlvl,
                                   int res_bf16, int out_bf16,
                                   int scale_per_channel, int brick_z,
                                   int brick_y, int grid_x, int grid_y,
                                   int sums_buffers, int x_k, int quant_k,
                                   void* stream) {
  Args a;
  a.qa = static_cast<const int8_t*>(x_qlvl ? qa : x);
  a.w = static_cast<const int8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.residual = residual;
  a.qalpha = static_cast<const float*>(qalpha);
  a.out_y = out_y;
  a.out_i8 = static_cast<int8_t*>(out_i8);
  a.out_pool = out_pool;
  a.N = N; a.D = D; a.H = H; a.W = W; a.C = C; a.O = O; a.dil = dil;
  a.res_relu = res_relu;
  a.quant_qlvl = quant_qlvl;
  a.quant_k = quant_k;
  a.res_bf16 = res_bf16;
  a.out_bf16 = out_bf16;
  a.scale_stride = scale_per_channel ? 1 : 0;
  a.nchunks = (C + CK - 1) / CK;
  a.Cp = a.nchunks * CK;
  a.sz = dil < brick_z ? dil : brick_z;
  a.sy = dil < brick_y ? dil : brick_y;
  a.sx = dil < BX ? dil : BX;
  a.EZ = brick_z + 2 * a.sz;
  a.EY = brick_y + 2 * a.sy;
  a.EX = BX + 2 * a.sx;
  a.nbz = (D + brick_z - 1) / brick_z;
  a.nby = (H + brick_y - 1) / brick_y;
  a.nbx = (W + BX - 1) / BX;
  const long long bricks = static_cast<long long>(N) * a.nbz * a.nby * a.nbx;
  a.halo_bytes = (a.EZ * a.EY * a.EX * HS + 127) / 128 * 128;
  // a stage holds the halo and the chunk's weights (C > 32), and, taking
  // turns, at the epilogue the brick's sums or y (rows of BN * 4 + 16
  // bytes), which the overlapped pipeline keeps in buffers of their own
  const int staged = brick_z * brick_y * BX * SR * 4;
  // overlapped, a sums buffer's brick also has a residual tile (float32)
  const int tile = brick_z * brick_y * BX * BN * 4;
  const int loads = a.halo_bytes + (a.nchunks > 1 ? WBYTES : 0);
  const int stage = sums_buffers || loads > staged ? loads : staged;
  a.stage_bytes = (stage + 127) / 128 * 128;
  a.nsums = sums_buffers;
  const int smem = 2 * a.stage_bytes + (a.nchunks > 1 ? 0 : WBYTES) +
                   sums_buffers * (staged + tile) +
                   (sums_buffers ? MBAR_BYTES : 0);
  const bool overlap = sums_buffers > 0;
  if (bricks > 0x7fffffffLL || grid_x < 1 || grid_x > bricks ||
      grid_y != (O + BN - 1) / BN || smem > SMEM_MAX || dil < 1 ||
      x_qlvl < 0 || (x_qlvl && !(x_alpha && qa)) || sums_buffers < 0 ||
      x_k < 0 || (x_k && x_k >= x_qlvl) || quant_k < 0 ||
      (quant_k && quant_k >= quant_qlvl) ||
      sums_buffers > 2 || (overlap && !(brick_z == 4 && brick_y == 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.bricks = static_cast<int>(bricks);
  const dim3 grid(static_cast<unsigned>(grid_x),
                  static_cast<unsigned>(grid_y));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_qlvl) {  // the prologue: x's codes into qa
    const long long n = static_cast<long long>(N) * D * H * W * C;
    const long long blocks = (n / 8 + 255) / 256;
    const unsigned qgrid = static_cast<unsigned>(
        blocks < QUANT_BLOCKS ? (blocks > 0 ? blocks : 1) : QUANT_BLOCKS);
    const float* alpha = static_cast<const float*>(x_alpha);
    int8_t* codes = static_cast<int8_t*>(qa);
    if (x_bf16)
      qconv3d_int8_kernel_quantize<true>
          <<<qgrid, 256, 0, s>>>(x, alpha, x_qlvl, x_k, codes, n);
    else
      qconv3d_int8_kernel_quantize<false>
          <<<qgrid, 256, 0, s>>>(x, alpha, x_qlvl, x_k, codes, n);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec = C % 16 == 0;
  if (overlap)
    return vec ? launch<4, 8, true, true>(a, grid, smem, s)
               : launch<4, 8, false, true>(a, grid, smem, s);
#define K1_CASE(BZ, BY)                                          \
  if (brick_z == BZ && brick_y == BY)                            \
    return vec ? launch<BZ, BY, true, false>(a, grid, smem, s)   \
               : launch<BZ, BY, false, false>(a, grid, smem, s);
  K1_CASE(4, 8)
  K1_CASE(4, 4)
  K1_CASE(2, 4)
  K1_CASE(2, 2)
#undef K1_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
