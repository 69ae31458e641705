// upsample_concat: nearest 2x of x, concatenated with skip on channels, NHWC.
//
// Replaces the TPU kernel scenedepthestimation_tpu/ops/pallas/
// upsample_concat.py::upsample_concat_pallas (the decoder's skip join).
//
// What bounds it on an H100: it is pure data movement, so device-memory
// bytes: x and skip read once, the output (4|x| + |skip|) written once.
//
// Design (upsample_concat_kernel): a block takes one input row r = b*H + h
// of x, or a segment of wb of its pixels, and writes the same pixels of
// output rows 2r and 2r + 1. It first copies the segment of x's row into
// shared memory (each x vector is read from device memory once), then
// walks the segment's output in order: neighbouring threads store
// neighbouring 16-byte vectors, so each warp writes 512 contiguous bytes,
// taking each vector from the staged x (read four times, from shared
// memory) or from skip's rows 2r and 2r + 1 (read once, in order); each
// thread has kUnroll independent loads in flight before its stores, and
// its first skip loads wait together with the staging of x. The
// block computes its row bases once in 64 bits; every in-segment index and
// offset is 32-bit (upsample_concat_plan in ops/cuda/upsample_concat.py
// keeps 4 * wb * (v1 + v2) below 2^31), and the one division an output
// index needs, by the pixel's width in vectors v1 + v2 (not a power of
// two: the mono decoder's /2 join has 4 + 8 bf16 vectors a pixel), is a
// multiply-high by a constant that the plan computes on the host
// (FastDiv). A segment holds about one pass of the block's threads (512
// units). Rows beyond the grid's 65,535 are walked by a stride. The
// unit of the copy is the widest of 16, 8, 4 or 2 bytes that divides both
// channel widths and all three pointers, so a width off 16 bytes or a
// pointer off 16-byte alignment takes narrower vectors on the same
// scheme. A pixel of x wider than the plan's staging limit (16 KB: more
// than 4,096 fp32 channels) is read from device memory where the output
// needs it instead. The kernel only copies bits, so one instantiation per
// unit serves fp32 and bf16.
//
// The backward (sde_upsample_concat_bwd), fp32 or bf16: with g the
// gradient of the output, dx is the sum of g's 2x2 block over x's channels
// and dskip is g's last C2 channels:
//   dx[b, i, j, c] = ((g[2i, 2j] + g[2i, 2j+1]) + g[2i+1, 2j]) + g[2i+1, 2j+1]
// at channel c < C1, added in fp32 in that fixed order and rounded once to
// the gradient's type (the plain version adds in the same order, so the
// two agree bit for bit); dskip is a copy of the bits. It replaces what XLA
// derives for the JAX package's upsample_concat (scenedepthestimation_tpu/
// ops/upsample.py, a broadcast and a concatenate, whose autodiff the JAX
// train steps run; the Pallas kernel is off there). Bytes bound it: g read
// once, dx and dskip written once. One thread a 16-byte vector of dx or
// dskip (4 floats or 8 bf16; single elements where a width is not whole
// vectors), grid-stride.
#include "common.cuh"

namespace sde {
namespace {

constexpr int kUpThreads = 256;  // threads a block of the forward
constexpr int kUnroll = 2;       // loads a thread has in flight before its stores

// n / d for a 32-bit n and a divisor d >= 1, by Granlund and Montgomery's
// round-up multiplier: with l = ceil(log2 d) and m = floor(2^32 (2^l - d)
// / d) + 1 (upsample_concat_plan computes both on the host), t =
// umulhi(n, m) and n / d = (t + ((n - t) >> min(l, 1))) >> max(l - 1, 0).
// A power of two has m = 1, so t = 0 and the quotient is n >> l.
struct FastDiv {
  unsigned m;
  int s1, s2;
  __device__ __forceinline__ FastDiv(unsigned mul, int l)
      : m(mul), s1(l > 0 ? 1 : 0), s2(l > 0 ? l - 1 : 0) {}
  __device__ __forceinline__ unsigned operator()(unsigned n) const {
    const unsigned t = __umulhi(n, m);
    return (t + ((n - t) >> s1)) >> s2;
  }
};

// out (B, 2H, 2W, v1 + v2), x (B, H, W, v1) and skip (B, 2H, 2W, v2) in
// units of V; rows = B * H. Block (s, y) takes pixels [s * wb, s * wb +
// wn) of x's rows y, y + gridDim.y, ...; kStaged: through wn * v1 units of
// dynamic shared memory.
template <typename V, bool kStaged>
__global__ void __launch_bounds__(kUpThreads)
    upsample_concat_kernel(const V* __restrict__ x, const V* __restrict__ skip,
                           V* __restrict__ out, long long rows, int W, int wb, int v1, int v2,
                           unsigned mul, int shift) {
  extern __shared__ __align__(16) unsigned char staged[];
  V* xs = reinterpret_cast<V*>(staged);
  const FastDiv div(mul, shift);  // by vt
  const unsigned vt = v1 + v2;
  const int w0 = blockIdx.x * wb;
  const unsigned wn = min(wb, W - w0);
  const unsigned nx = wn * v1;       // x units of the segment
  const unsigned row = 2 * wn * vt;  // output units of the segment in one row
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    // The row bases: x's row r from pixel w0, and output rows 2r and 2r + 1
    // (skip's too) from pixel 2 * w0.
    const long long pix = 2 * (2 * r * W + w0);
    const V* xr = x + (r * W + w0) * v1;
    const V* s0 = skip + pix * v2;
    V* o0 = out + pix * vt;
    const long long skip_step = 2LL * W * v2, out_step = 2LL * W * vt;
    // Each thread takes outputs i0 + u * kUpThreads (u < kUnroll), then the
    // next kUnroll * kUpThreads. locate() finds where an output's unit comes
    // from: x at xr + off (staged: xs[off]) or skip at row 2r or 2r + 1, +
    // off. The first outputs' skip loads are issued before x is staged, so
    // that the two waits overlap.
    V val[kUnroll];
    unsigned at[kUnroll], off[kUnroll];
    bool odd[kUnroll], from_x[kUnroll];
    unsigned i0 = threadIdx.x;
    const auto locate = [&](int u) {
      const unsigned i = i0 + u * kUpThreads;
      odd[u] = i >= row;
      at[u] = odd[u] ? i - row : i;
      const unsigned p = div(at[u]);
      const unsigned c = at[u] - p * vt;
      from_x[u] = c < static_cast<unsigned>(v1);
      off[u] = from_x[u] ? (p >> 1) * v1 + c : p * v2 + (c - v1);
    };
    const auto live = [&](int u) { return i0 + u * kUpThreads < 2 * row; };
    const auto load = [&]() {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!live(u)) continue;
        locate(u);
        if (!from_x[u])
          val[u] = __ldg(s0 + (odd[u] ? skip_step : 0) + off[u]);
        else if (!kStaged)
          val[u] = __ldg(xr + off[u]);
      }
    };
    load();
    if (kStaged) {
      if (r != blockIdx.y) __syncthreads();  // the last row's reads of xs are done
#pragma unroll 4
      for (unsigned j = threadIdx.x; j < nx; j += kUpThreads) xs[j] = __ldg(xr + j);
      __syncthreads();
    }
    while (true) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!live(u)) continue;
        if (kStaged && from_x[u]) val[u] = xs[off[u]];
        o0[(odd[u] ? out_step : 0) + at[u]] = val[u];
      }
      i0 += kUnroll * kUpThreads;
      if (i0 >= 2 * row) break;
      load();
    }
  }
}

template <typename V>
cudaError_t launch(const void* x, const void* skip, void* out, long long rows, int W, int wb,
                   int nseg, int grid_y, int v1, int v2, unsigned mul, int shift, int staged,
                   cudaStream_t stream) {
  const dim3 grid(nseg, grid_y);
  if (staged > 0)
    upsample_concat_kernel<V, true><<<grid, kUpThreads, staged, stream>>>(
        static_cast<const V*>(x), static_cast<const V*>(skip), static_cast<V*>(out), rows, W, wb,
        v1, v2, mul, shift);
  else
    upsample_concat_kernel<V, false><<<grid, kUpThreads, 0, stream>>>(
        static_cast<const V*>(x), static_cast<const V*>(skip), static_cast<V*>(out), rows, W, wb,
        v1, v2, mul, shift);
  return cudaGetLastError();
}

// The host's FastDiv, to check a plan's constants before a launch.
unsigned host_div(unsigned n, unsigned m, int l) {
  const unsigned t = static_cast<unsigned>((static_cast<unsigned long long>(n) * m) >> 32);
  return (t + ((n - t) >> (l > 0 ? 1 : 0))) >> (l > 0 ? l - 1 : 0);
}

// Whether (m, l) divides by d over [0, n_max]: checked at d - 1, d, the
// largest multiple of d up to n_max and n_max.
bool divisor_ok(unsigned d, unsigned m, int l, unsigned n_max) {
  if (d == 0 || l < 0 || l > 31) return false;
  const unsigned top = n_max / d * d;
  for (unsigned n : {d - 1, d, top, top - 1, n_max})
    if (n <= n_max && host_div(n, m, l) != n / d) return false;
  return true;
}

// N elements of T moved as one E: widen() to fp32, narrow() rounds once.
template <typename T, int N>
struct GradVec;
template <>
struct GradVec<float, 1> {
  using E = float;
  static __device__ __forceinline__ void widen(const E& v, float (&f)[1]) { f[0] = v; }
  static __device__ __forceinline__ E narrow(const float (&f)[1]) { return f[0]; }
};
template <>
struct GradVec<float, 4> {
  using E = float4;
  static __device__ __forceinline__ void widen(const E& v, float (&f)[4]) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ E narrow(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct GradVec<__nv_bfloat16, 1> {
  using E = __nv_bfloat16;
  static __device__ __forceinline__ void widen(const E& v, float (&f)[1]) {
    f[0] = __bfloat162float(v);
  }
  static __device__ __forceinline__ E narrow(const float (&f)[1]) {
    return from_float<__nv_bfloat16>(f[0]);
  }
};
template <>
struct GradVec<__nv_bfloat16, 8> {
  using E = uint4;
  static __device__ __forceinline__ void widen(const E& v, float (&f)[8]) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(u[k] << 16);
      f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ E narrow(const float (&f)[8]) {
    return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                      pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  }
};

template <typename T, int N>
__device__ __forceinline__ void add_into(float (&s)[N], const typename GradVec<T, N>::E& v) {
  float f[N];
  GradVec<T, N>::widen(v, f);
#pragma unroll
  for (int k = 0; k < N; ++k) s[k] += f[k];
}

// g (B, 2H, 2W, c1 + c2), dx (B, H, W, c1), dskip (B, 2H, 2W, c2), widths
// in units of N elements of T; the first nx indices are dx's, the rest
// dskip's.
template <typename T, int N>
__global__ void upsample_concat_bwd_kernel(const typename GradVec<T, N>::E* __restrict__ g,
                                           typename GradVec<T, N>::E* __restrict__ dx,
                                           typename GradVec<T, N>::E* __restrict__ dskip, int H,
                                           int W, int c1, int c2, long long nx,
                                           long long total) {
  using V = GradVec<T, N>;
  const int ct = c1 + c2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    if (i < nx) {
      const int c = static_cast<int>(i % c1);
      const long long pix = i / c1;
      const int w = static_cast<int>(pix % W);
      const long long t = pix / W;
      const int h = static_cast<int>(t % H);
      const long long b = t / H;
      const long long row = (long long)2 * W * ct;  // one output row
      const long long base = ((b * 2 * H + 2 * h) * 2 * W + 2 * w) * ct + c;
      float s[N];
      V::widen(g[base], s);
      add_into<T, N>(s, g[base + ct]);
      add_into<T, N>(s, g[base + row]);
      add_into<T, N>(s, g[base + row + ct]);
      dx[i] = V::narrow(s);
    } else {
      const long long j = i - nx;
      dskip[j] = g[(j / c2) * ct + c1 + j % c2];
    }
  }
}

template <typename T, int N>
cudaError_t launch_bwd(const void* g, void* dx, void* dskip, int B, int H, int W, int C1, int C2,
                       cudaStream_t s) {
  using E = typename GradVec<T, N>::E;
  const long long nx = (long long)B * H * W * (C1 / N);
  const long long total = nx + (long long)B * 4 * H * W * (C2 / N);
  if (total == 0) return cudaGetLastError();
  constexpr int kThreads = 256;
  const unsigned blocks =
      static_cast<unsigned>(std::min<long long>((total + kThreads - 1) / kThreads, 1 << 20));
  upsample_concat_bwd_kernel<T, N><<<blocks, kThreads, 0, s>>>(
      static_cast<const E*>(g), static_cast<E*>(dx), static_cast<E*>(dskip), H, W, C1 / N,
      C2 / N, nx, total);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

}  // namespace
}  // namespace sde

// x (B, H, W, C1), skip (B, 2H, 2W, C2), out (B, 2H, 2W, C1 + C2), all
// contiguous and of one dtype, launched as plan[0..12] says, the fields of
// upsample_concat_plan (ops/cuda/upsample_concat.py) in its order: the unit
// of the copy in bytes (16, 8, 4 or 2; every pointer aligned to it), v1 =
// C1 and v2 = C2 in units, rows = B * H, W, segments of wb pixels (nseg =
// ceil(W / wb) of them a row), grid_y row strides, the kernel's
// compile-time threads and unroll (refused unless they match), the
// multiplier and shift of the division by v1 + v2, and the shared memory
// that stages a segment of x (wb * v1 units, or 0: x read where needed).
extern "C" int sde_upsample_concat(const void* x, const void* skip, void* out,
                                   const long long* plan, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long unit = plan[0], v1 = plan[1], v2 = plan[2], rows = plan[3], W = plan[4],
                  wb = plan[5], nseg = plan[6], grid_y = plan[7], mul = plan[10],
                  shift = plan[11], staged = plan[12];
  const auto aligned = [unit](const void* p) {
    return (reinterpret_cast<std::uintptr_t>(p) & (unit - 1)) == 0;
  };
  const long long seg = 4 * wb * (v1 + v2);
  const bool ok = (unit == 16 || unit == 8 || unit == 4 || unit == 2) && aligned(x) &&
                  aligned(skip) && aligned(out) && rows > 0 && W > 0 && W < (1LL << 31) &&
                  v1 >= 0 && v2 >= 0 && v1 + v2 > 0 && wb > 0 && nseg > 0 &&
                  (nseg - 1) * wb < W && nseg * wb >= W && grid_y > 0 && grid_y <= 65535 &&
                  grid_y <= rows && seg < (1LL << 31) && (staged == 0 || staged == wb * v1 * unit) &&
                  staged <= 48 * 1024 && plan[8] == sde::kUpThreads && plan[9] == sde::kUnroll &&
                  mul > 0 && mul < (1LL << 32) &&
                  sde::divisor_ok(static_cast<unsigned>(v1 + v2), static_cast<unsigned>(mul),
                                  static_cast<int>(shift), static_cast<unsigned>(seg));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int a[] = {static_cast<int>(W), static_cast<int>(wb), static_cast<int>(nseg),
                   static_cast<int>(grid_y), static_cast<int>(v1), static_cast<int>(v2),
                   static_cast<int>(shift), static_cast<int>(staged)};
  const unsigned m = static_cast<unsigned>(mul);
  switch (unit) {
    case 16:
      return static_cast<int>(sde::launch<uint4>(x, skip, out, rows, a[0], a[1], a[2], a[3], a[4],
                                                 a[5], m, a[6], a[7], s));
    case 8:
      return static_cast<int>(sde::launch<uint2>(x, skip, out, rows, a[0], a[1], a[2], a[3], a[4],
                                                 a[5], m, a[6], a[7], s));
    case 4:
      return static_cast<int>(sde::launch<std::uint32_t>(x, skip, out, rows, a[0], a[1], a[2],
                                                         a[3], a[4], a[5], m, a[6], a[7], s));
    default:
      return static_cast<int>(sde::launch<std::uint16_t>(x, skip, out, rows, a[0], a[1], a[2],
                                                         a[3], a[4], a[5], m, a[6], a[7], s));
  }
}

// g (B, 2H, 2W, C1 + C2), dx (B, H, W, C1), dskip (B, 2H, 2W, C2), all
// contiguous, all float32 (dtype 0) or all bf16 (dtype 1); dx and dskip
// are written whole.
extern "C" int sde_upsample_concat_bwd(const void* g, void* dx, void* dskip, int B, int H, int W,
                                       int C1, int C2, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C1 < 1 || C2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = sde::aligned16(g) && sde::aligned16(dx) && sde::aligned16(dskip);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (C1 % 4 == 0 && C2 % 4 == 0 && aligned)
      err = sde::launch_bwd<float, 4>(g, dx, dskip, B, H, W, C1, C2, s);
    else
      err = sde::launch_bwd<float, 1>(g, dx, dskip, B, H, W, C1, C2, s);
  } else if (dtype == 1) {
    if (C1 % 8 == 0 && C2 % 8 == 0 && aligned)
      err = sde::launch_bwd<__nv_bfloat16, 8>(g, dx, dskip, B, H, W, C1, C2, s);
    else
      err = sde::launch_bwd<__nv_bfloat16, 1>(g, dx, dskip, B, H, W, C1, C2, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
