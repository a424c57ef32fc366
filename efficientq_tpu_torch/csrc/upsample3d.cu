// K5: trilinear upsampling by integer factors, half-pixel centres, with an
// optional skip tensor added in the epilogue, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package upsamples with
// jax.image.resize (efficientq_tpu/ops.py::upsample3d), which XLA fuses on
// the TPU.  In the port the same function ran as aten's
// upsample_trilinear3d on the NCDHW view of an NDHWC tensor: one thread per
// output voxel walking N * C serially, neighbouring threads C elements
// apart, so small grids and uncoalesced access.  K5 serves the decoder's
// TransUp upsamples (with the TransUp add of the skip fused in) and the
// heads' upsamples of the serving graph (kernels/upsample.py, routed by
// ptq/deploy.py::upsample_serving).
//
//   x:     (N, D, H, W, C) (NDHWC) or (N, C, D, H, W) (NCDHW, the
//          channels-first head), float32 or bfloat16
//   skip:  null, or a tensor of the output's shape and layout, float32 or
//          bfloat16
//   y:     (N, D*fd, H*fh, W*fw, C) in x's layout; its type is x's, or
//          float32 where the skip is float32 (PyTorch's promotion)
//
// Arithmetic, per axis as aten's area_pixel_compute_source_index with
// align_corners=False: scale = in / out (float32, from the host),
// src = max(scale * (dst + 0.5) - 0.5, 0), i0 = (int)src, i1 = i0 + 1
// clamped at the edge, l1 = src - i0, l0 = 1 - l1.  The eight terms are
// nested as aten nests them, t then h then w, in float32, and contracted
// as PyTorch's builds contract aten's expression: src as one FMA, each
// l0 * a + l1 * b as fma(l0, a, l1 * b) (explicit intrinsics; the build
// passes -fmad=false, so nothing else contracts).  The result is rounded
// once to x's type.  The skip is added after that rounding, in float32,
// and the sum rounded to the output type: the unfused pair
// F.interpolate(x) + skip, operation for operation, so the two agree bit
// for bit.  With every factor 1 the input is copied, as aten copies it.
//
// What bounds it.  Bytes: about 1 flop per byte moved.  At the LiTS
// decoder's widest call (32 channels, 32^3 -> 64^3, 8 patches) a call
// reads 33.6 MB of x and 268 MB of skip and writes 268 MB.  So each output
// element is written once with wide stores, the skip is read once in the
// same pass (the unfused add read the upsampled tensor back and wrote the
// sum again), and the sources, one eighth of the output's bytes at a
// factor of 2, are reused from L1 and L2 rather than device memory.
//
// Design.  No thread walks N * C.  The grid's x covers one output plane
// (H_out * W_out * channel groups for NDHWC, H_out * W groups for NCDHW),
// its y the planes (N * D_out, or N * C * D_out), with a stride loop where
// they pass 65535; offsets across planes are 64-bit, divisions by the
// call's extents a multiply-high and a shift.  NDHWC: a thread owns V
// consecutive channels of one output voxel: V = 16 bytes / element where C
// allows (one 16-byte load per source voxel and one 16-byte store), else 3
// or 2 where C is a multiple (the head's 3 classes), else 1, so threads
// share their index arithmetic over V channels.  Neighbouring threads take
// neighbouring channel groups, then neighbouring voxels along W, so a
// warp's stores are contiguous and the eight source voxels of neighbouring
// outputs are the same or adjacent lines.  NCDHW: a thread owns V
// consecutive outputs along W (one store of V elements), loading its
// sources element by element along the same rows.  The per-axis indices
// and weights of H and W are computed once per thread, those of D once per
// plane.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Division by a divisor fixed for the call, as a multiply-high and a shift
// (magic and shift from the host, kernels/upsample.py::_divider; exact for
// n and d below 2^31).
struct Div {
  unsigned magic, shift, d;
};

// The shape of one call, laid out as kernels/upsample.py::_K5Call.  The
// host checks that planes, each input plane and each output plane hold
// fewer than 2^31 elements; offsets across planes are 64-bit.
struct K5Call {
  unsigned planes;   // N * D_out (NDHWC) or N * C * D_out (NCDHW)
  unsigned plane;    // threads a plane: H_out * W_out * groups, H_out * groups
  int di, hi, wi;    // input extents
  int ho, wo;        // output extents
  int c;             // channels (NDHWC; 1 for NCDHW)
  float sd, sh, sw;  // in / out per axis, float32
  int copy;          // every factor 1
  Div groups;        // C / V (NDHWC) or W_out / V (NCDHW)
  Div wout;          // W_out (NDHWC)
  Div dout;          // D_out
};

namespace {

typedef __nv_bfloat16 bf16;

// no skip tensor
struct NoSkip {};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements, aligned as one access where that is 2, 4, 8 or 16 bytes
template <typename T, int V>
struct alignas((sizeof(T) * V) & (sizeof(T) * V - 1) ? sizeof(T)
                                                     : sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ void divmod(unsigned n, const Div& v, unsigned& q,
                                       unsigned& r) {
  q = (__umulhi(n, v.magic) + n) >> v.shift;
  r = n - q * v.d;
}

// One axis's source indices and weights (aten's
// area_pixel_compute_source_index, align_corners=False, not cubic).
struct Axis {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ Axis axis(int dst, float scale, int in_size) {
  float src =
      __fmaf_rn(scale, __fadd_rn(static_cast<float>(dst), 0.5f), -0.5f);
  if (src < 0.f) src = 0.f;
  Axis a;
  a.i0 = static_cast<int>(src);
  a.i1 = a.i0 + ((a.i0 < in_size - 1) ? 1 : 0);
  a.l1 = __fsub_rn(src, static_cast<float>(a.i0));
  a.l0 = __fsub_rn(1.f, a.l1);
  return a;
}

// l0 * a + l1 * b as aten's build computes it
__device__ __forceinline__ float lerp(float l0, float a, float l1, float b) {
  return __fmaf_rn(l0, a, __fmul_rn(l1, b));
}

// x[t][h][w] of the eight sources, indexed by (dt, dh, dw) bits, nested as
// aten's kernel nests them.
__device__ __forceinline__ float lerp8(const Axis& t, const Axis& h,
                                       const Axis& w, const float (&v)[8]) {
  const float b0 = lerp(h.l0, lerp(w.l0, v[0], w.l1, v[1]), h.l1,
                        lerp(w.l0, v[2], w.l1, v[3]));
  const float b1 = lerp(h.l0, lerp(w.l0, v[4], w.l1, v[5]), h.l1,
                        lerp(w.l0, v[6], w.l1, v[7]));
  return lerp(t.l0, b0, t.l1, b1);
}

// The output element from the interpolated float32 value: rounded to x's
// type (the upsample's own output), then, with a skip, the skip added in
// float32 and the sum rounded to the output type.
template <typename TX, typename TS, typename TO>
__device__ __forceinline__ TO finish(float v, TS s) {
  const TX r = from_f<TX>(v);
  if constexpr (std::is_same<TS, NoSkip>::value) {
    return r;
  } else {
    return from_f<TO>(__fadd_rn(to_f(r), to_f(s)));
  }
}

// V elements in one access of 16, 8 or 4 bytes (the caller aligns p), or
// element by element (a single element, or 3 channels).
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  Vec<T, V> r;
  constexpr int B = sizeof(T) * V;
  if constexpr (B == 16) {
    *reinterpret_cast<uint4*>(&r) = *reinterpret_cast<const uint4*>(p);
  } else if constexpr (B == 8) {
    *reinterpret_cast<uint2*>(&r) = *reinterpret_cast<const uint2*>(p);
  } else if constexpr (B == 4 && V > 1) {
    *reinterpret_cast<unsigned*>(&r) = *reinterpret_cast<const unsigned*>(p);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) r.v[j] = p[j];
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Vec<T, V>& r) {
  constexpr int B = sizeof(T) * V;
  if constexpr (B == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&r);
  } else if constexpr (B == 8) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(&r);
  } else if constexpr (B == 4 && V > 1) {
    *reinterpret_cast<unsigned*>(p) = *reinterpret_cast<const unsigned*>(&r);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = r.v[j];
  }
}

template <typename TS, int V>
__device__ __forceinline__ Vec<TS, V> load_skip(const TS* skip, long long o) {
  if constexpr (std::is_same<TS, NoSkip>::value) {
    return Vec<TS, V>{};
  } else {
    return load<TS, V>(skip + o);
  }
}

template <typename TX, typename TS, typename TO, int V>
__global__ void __launch_bounds__(256)
    effq_upsample_trilinear3d_ndhwc(const TX* __restrict__ x,
                                    const TS* __restrict__ skip,
                                    TO* __restrict__ y, const K5Call g) {
  const unsigned p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.plane) return;
  unsigned q, cg, ho, wo;
  divmod(p, g.groups, q, cg);  // q: the output voxel in its plane
  divmod(q, g.wout, ho, wo);
  const Axis ah = axis(ho, g.sh, g.hi), aw = axis(wo, g.sw, g.wi);
  const unsigned c0 = cg * V, row = g.wi * g.c;
  // the four sources' offsets inside an input plane, (dh, dw) as bits
  const unsigned off[4] = {ah.i0 * row + aw.i0 * g.c + c0,
                           ah.i0 * row + aw.i1 * g.c + c0,
                           ah.i1 * row + aw.i0 * g.c + c0,
                           ah.i1 * row + aw.i1 * g.c + c0};
  const long long plane_in = static_cast<long long>(g.hi) * row;
  const unsigned o_in_plane = q * g.c + c0;
  for (unsigned pl = blockIdx.y; pl < g.planes; pl += gridDim.y) {
    unsigned n, dd;
    divmod(pl, g.dout, n, dd);
    const long long o =
        static_cast<long long>(pl) * g.ho * g.wo * g.c + o_in_plane;
    Vec<TO, V> out;
    const Vec<TS, V> s = load_skip<TS, V>(skip, o);
    if (g.copy) {
      const Vec<TX, V> v = load<TX, V>(
          x + (static_cast<long long>(n) * g.di + dd) * plane_in + off[0]);
#pragma unroll
      for (int j = 0; j < V; ++j)
        out.v[j] = finish<TX, TS, TO>(to_f(v.v[j]), s.v[j]);
    } else {
      const Axis at = axis(dd, g.sd, g.di);
      const TX* b[2] = {
          x + (static_cast<long long>(n) * g.di + at.i0) * plane_in,
          x + (static_cast<long long>(n) * g.di + at.i1) * plane_in};
      Vec<TX, V> src[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) src[k] = load<TX, V>(b[k >> 2] + off[k & 3]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = to_f(src[k].v[j]);
        out.v[j] = finish<TX, TS, TO>(lerp8(at, ah, aw, v), s.v[j]);
      }
    }
    store<TO, V>(y + o, out);
  }
}

template <typename TX, typename TS, typename TO, int V>
__global__ void __launch_bounds__(256)
    effq_upsample_trilinear3d_ncdhw(const TX* __restrict__ x,
                                    const TS* __restrict__ skip,
                                    TO* __restrict__ y, const K5Call g) {
  const unsigned p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.plane) return;
  unsigned ho, wg;
  divmod(p, g.groups, ho, wg);
  const unsigned w0 = wg * V;
  const Axis ah = axis(ho, g.sh, g.hi);
  Axis aw[V];
#pragma unroll
  for (int j = 0; j < V; ++j) aw[j] = axis(w0 + j, g.sw, g.wi);
  const long long plane_in = static_cast<long long>(g.hi) * g.wi;
  const unsigned rows[4] = {ah.i0 * g.wi, ah.i1 * g.wi, ah.i0 * g.wi,
                            ah.i1 * g.wi};
  const unsigned o_in_plane = ho * g.wo + w0;
  for (unsigned pl = blockIdx.y; pl < g.planes; pl += gridDim.y) {
    unsigned nc, dd;  // nc: n * C + c
    divmod(pl, g.dout, nc, dd);
    const long long o =
        static_cast<long long>(pl) * g.ho * g.wo + o_in_plane;
    Vec<TO, V> out;
    const Vec<TS, V> s = load_skip<TS, V>(skip, o);
    if (g.copy) {
      const TX* row =
          x + (static_cast<long long>(nc) * g.di + dd) * plane_in + rows[0];
#pragma unroll
      for (int j = 0; j < V; ++j)
        out.v[j] = finish<TX, TS, TO>(to_f(row[w0 + j]), s.v[j]);
    } else {
      const Axis at = axis(dd, g.sd, g.di);
      const TX* b[2] = {
          x + (static_cast<long long>(nc) * g.di + at.i0) * plane_in,
          x + (static_cast<long long>(nc) * g.di + at.i1) * plane_in};
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const TX* src = b[r >> 1] + rows[r];
          v[2 * r] = to_f(src[aw[j].i0]);
          v[2 * r + 1] = to_f(src[aw[j].i1]);
        }
        out.v[j] = finish<TX, TS, TO>(lerp8(at, ah, aw[j], v), s.v[j]);
      }
    }
    store<TO, V>(y + o, out);
  }
}

constexpr int THREADS = 256;
constexpr unsigned MAX_GRID_Y = 65535;

template <typename TX, typename TS, typename TO, int V>
int launch(const void* x, const void* skip, void* y, const K5Call& g, int cf,
           cudaStream_t stream) {
  const dim3 grid((g.plane + THREADS - 1) / THREADS,
                  g.planes < MAX_GRID_Y ? g.planes : MAX_GRID_Y);
  const TX* xp = static_cast<const TX*>(x);
  const TS* sp = static_cast<const TS*>(skip);
  TO* yp = static_cast<TO*>(y);
  if (cf)
    effq_upsample_trilinear3d_ncdhw<TX, TS, TO, V>
        <<<grid, THREADS, 0, stream>>>(xp, sp, yp, g);
  else
    effq_upsample_trilinear3d_ndhwc<TX, TS, TO, V>
        <<<grid, THREADS, 0, stream>>>(xp, sp, yp, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TS, typename TO>
int by_vec(const void* x, const void* skip, void* y, const K5Call& g, int cf,
           int vec, cudaStream_t stream) {
  switch (vec) {
    case 1: return launch<TX, TS, TO, 1>(x, skip, y, g, cf, stream);
    case 2:
      if (!cf) return launch<TX, TS, TO, 2>(x, skip, y, g, cf, stream);
      break;
    case 3:
      if (!cf) return launch<TX, TS, TO, 3>(x, skip, y, g, cf, stream);
      break;
    case 4: return launch<TX, TS, TO, 4>(x, skip, y, g, cf, stream);
    case 8:
      if constexpr (std::is_same<TX, bf16>::value &&
                    std::is_same<TO, bf16>::value)
        return launch<TX, TS, TO, 8>(x, skip, y, g, cf, stream);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x_bf16: x is bfloat16; skip_kind: 0 none, 1 float32, 2 bfloat16; the
// output is bfloat16 where x is and the skip is not float32, else float32.
// vec: elements per thread along C (NDHWC) or W (NCDHW): 1, 4 or 8 (8 for
// bfloat16 outputs only), and 2 or 3 along C; the caller checks that it
// divides C or W_out and that every pointer is 16-byte aligned.  Returns
// the launch's cudaError_t.
extern "C" int upsample3d_launch(const void* x, const void* skip, void* y,
                                 const K5Call* call, int cf, int x_bf16,
                                 int skip_kind, int vec, void* stream) {
  const K5Call& g = *call;
  if (g.planes < 1 || g.plane < 1 || g.planes > 0x7fffffffu ||
      g.plane > 0x7fffffffu || g.di < 1 || g.hi < 1 || g.wi < 1 || g.c < 1 ||
      (skip_kind != 0) != (skip != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    switch (skip_kind) {
      case 0: return by_vec<bf16, NoSkip, bf16>(x, skip, y, g, cf, vec, s);
      case 1: return by_vec<bf16, float, float>(x, skip, y, g, cf, vec, s);
      case 2: return by_vec<bf16, bf16, bf16>(x, skip, y, g, cf, vec, s);
    }
  } else {
    switch (skip_kind) {
      case 0: return by_vec<float, NoSkip, float>(x, skip, y, g, cf, vec, s);
      case 1: return by_vec<float, float, float>(x, skip, y, g, cf, vec, s);
      case 2: return by_vec<float, bf16, float>(x, skip, y, g, cf, vec, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
