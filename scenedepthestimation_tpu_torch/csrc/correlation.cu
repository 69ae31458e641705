// correlation: the 1-D stereo cost volume, NHWC with the disparity minor.
//
//   cost[r, w, d] = (1/C) * sum_c FL[r, w, c] * FR[r, w - d, c]
//
// for every row r = b*H + h, with FR[r, w - d, :] = 0 where w - d < 0.
//
// Replaces the TPU kernel scenedepthestimation_tpu/ops/pallas/
// correlation.py::_correlation_pallas_impl (public correlation_pallas).
//
// What bounds it on an H100: bytes. At stereo_256x512_b4 it reads 2 x 8.4
// MB and writes 6.3 MB (6.9 us at 3.35 TB/s) for 0.2 GFLOP (3 us at the
// CUDA cores' 67 TFLOP/s). The sums are plain fp32 FMAs (no TF32: the
// kernel is held to its plain version at atol 1e-5 + rtol 1e-5), so the
// products must run near the CUDA cores' rate, and shared memory must
// feed them: one shared load per FMA would take five times the bound.
//
// Design. The features are read where the stereo tower left them: FL and
// FR are (B, H, W, C) views with contiguous (W, C) rows and a batch
// stride of their own (2*H*W*C for the halves of the tower's interleaved
// output), so no copy of either view is made.
//   * One block per (row, 64-column W segment, D tile): config 4's 256
//     rows give 512 blocks, about 4 a SM. All of D (up to 64) is one tile,
//     so the right window is staged once for every disparity; D is
//     covered in groups of 8 (D = 48: six, no idle lane).
//   * Thread (p, q), p in [0, 16), q in [0, TD/8), owns the 4 x 8 register
//     tile of pixels 4p .. 4p+3 and disparities 8q .. 8q+7. Pixel i and
//     disparity j read right-view column 4p - 8q + (i - j), so a thread
//     reads its 4 left columns and the 11 right columns it shears over:
//     15 float4 loads for 128 FMAs, 4 channels at a time. Lanes p fastest:
//     the two q of a warp share their left reads (a broadcast).
//   * Channel-minor shared layout, 32 channels (8 float4) a column, 128
//     bytes, with the float4 slot XORed by (column / 4) % 8: the 16 left
//     columns and the 18 right columns a warp reads at once fall in
//     distinct 16-byte bank groups, 8 to a wavefront.
//   * Staging: 32 channels a step by 16-byte cp.async (zero-filled outside
//     [0, W) and past C), two steps in flight (all of C = 64 at once).
//   * Each thread writes its pixels' 8 disparities as two 16-byte stores
//     (192 B a pixel at D = 48 in 32-byte sectors written whole).
// bf16 inputs (a bf16 volume out, fp32 sums), C not a multiple of 4 and
// views whose rows are not 16-byte aligned are staged by scalar loads
// instead of cp.async, into the same layout.
#include "common.cuh"

namespace sde {
namespace {

constexpr int kTW = 64;              // output columns per block (W segment)
constexpr int kPX = 4;               // pixels a thread
constexpr int kDX = 8;               // disparities a thread
constexpr int kPG = kTW / kPX;       // pixel groups (threads along W)
constexpr int kKC = 32;              // channels staged per step
constexpr int kTDMax = 64;           // disparities per block
constexpr int kMaxThreads = kPG * kTDMax / kDX;

__host__ __device__ constexpr int win_cols(int td) { return kTW + td - 1; }

__host__ __device__ constexpr int stage_floats(int td) { return (kTW + win_cols(td)) * kKC; }

// Float offset of channels [4g, 4g + 4) of staged column j.
__device__ __forceinline__ int slot(int j, int g) { return j * kKC + 4 * (g ^ ((j >> 2) & 7)); }

__device__ __forceinline__ float4 lds128(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Stages channels [c0, c0 + kKC) of the columns [col0, col0 + ncols) of
// one row's (W, C) features into dst (fp32, swizzled), zeros outside
// [0, W) x [0, C). `vec`: fp32, C % 4 == 0 and 16-byte aligned rows.
template <typename T>
__device__ __forceinline__ void stage_cols(float* __restrict__ dst, const T* __restrict__ src,
                                           int col0, int ncols, int W, int C, int c0,
                                           bool vec) {
  if (vec) {
    // A thread keeps one vector slot g (blockDim.x is a multiple of kV).
    constexpr int kV = kKC / 4;  // 16-byte vectors a column
    const int g = threadIdx.x % kV, c = c0 + 4 * g;
    const T* sc = src + c;
    for (int j = threadIdx.x / kV; j < ncols; j += blockDim.x / kV) {
      const int col = col0 + j;
      const bool ok = col >= 0 && col < W && c < C;
      cp_async16(dst + slot(j, g), ok ? sc + (long long)col * C : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ncols * kKC; i += blockDim.x) {
      const int j = i / kKC, k = i % kKC, c = c0 + k, col = col0 + j;
      dst[slot(j, k >> 2) + (k & 3)] =
          (col >= 0 && col < W && c < C) ? to_float(src[(long long)col * C + c]) : 0.f;
    }
  }
}

__device__ __forceinline__ void fma4(float& s, const float4& a, const float4& b) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  s = fmaf(a.w, b.w, s);
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float* v, int n, bool vec);

// Up to 8 fp32 values; two 16-byte stores when all 8 are in range and
// `vec` (D % 4 == 0).
template <>
__device__ __forceinline__ void store8<float>(float* dst, const float* v, int n, bool vec) {
  if (vec && n >= 8) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) dst[j] = v[j];
  }
}

// Up to 8 bf16 values; one 16-byte store when all 8 are in range and `vec`
// (D % 8 == 0).
template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* dst, const float* v, int n,
                                                      bool vec) {
  if (vec && n >= 8) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                                pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) dst[j] = __float2bfloat16(v[j]);
  }
}

template <typename T>
struct Args {
  const T* fl;
  const T* fr;
  T* out;
  long long sbl, sbr;  // batch strides of FL and FR, in elements
  int H, W, C, D, TD, nseg, nd;
  bool vec_in, vec_out;
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    correlation_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int stage = stage_floats(a.TD);
  int unit = blockIdx.x;  // 32-bit: 64-bit divisions cost hundreds of issue slots
  const int dt = unit % a.nd;
  unit /= a.nd;
  const int w0 = (unit % a.nseg) * kTW;
  const int row = unit / a.nseg;
  const int d0 = dt * a.TD;
  const int b = row / a.H, h = row - b * a.H;
  const long long rowoff = (long long)h * a.W * a.C;
  const T* lrow = a.fl + b * a.sbl + rowoff;
  const T* rrow = a.fr + b * a.sbr + rowoff;
  // Staged right column j holds right-view column r0 + j.
  const int r0 = w0 - d0 - (a.TD - 1);
  const int p = threadIdx.x % kPG, q = threadIdx.x / kPG;
  // Thread (p, q)'s pixel i, disparity j reads staged right column
  // jb + (i - j + 7).
  const int jb = kPX * p - kDX * q + a.TD - kDX;
  const int nch = (a.C + kKC - 1) / kKC;

  auto issue = [&](int ch) {
    float* st = smem + (ch & 1) * stage;
    stage_cols(st, lrow, w0, kTW, a.W, a.C, ch * kKC, a.vec_in);
    stage_cols(st + kTW * kKC, rrow, r0, win_cols(a.TD), a.W, a.C, ch * kKC, a.vec_in);
  };

  float acc[kPX][kDX];
#pragma unroll
  for (int i = 0; i < kPX; ++i)
#pragma unroll
    for (int j = 0; j < kDX; ++j) acc[i][j] = 0.f;

  issue(0);
  cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) issue(ch + 1);  // the other stage, consumed at ch - 1
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* sl = smem + (ch & 1) * stage;
    const float* sr = sl + kTW * kKC;
    const int ng = (min(kKC, a.C - ch * kKC) + 3) / 4;
#pragma unroll 2
    for (int g = 0; g < ng; ++g) {
      float4 l[kPX];
#pragma unroll
      for (int i = 0; i < kPX; ++i) l[i] = lds128(sl + slot(kPX * p + i, g));
#pragma unroll
      for (int k = 0; k < kPX + kDX - 1; ++k) {
        const float4 r = lds128(sr + slot(jb + k, g));
#pragma unroll
        for (int i = 0; i < kPX; ++i) {
          const int j = i + kDX - 1 - k;
          if (j >= 0 && j < kDX) fma4(acc[i][j], l[i], r);
        }
      }
    }
    __syncthreads();  // this stage is consumed before ch + 2 refills it
  }

  const float inv_c = 1.f / static_cast<float>(a.C);
  const int d = d0 + kDX * q;
  if (d >= a.D) return;
#pragma unroll
  for (int i = 0; i < kPX; ++i) {
    const int w = w0 + kPX * p + i;
    if (w >= a.W) break;
    float v[kDX];
#pragma unroll
    for (int j = 0; j < kDX; ++j) v[j] = acc[i][j] * inv_c;
    store8<T>(a.out + ((long long)row * a.W + w) * a.D + d, v, a.D - d, a.vec_out);
  }
}

template <typename T>
cudaError_t launch(const void* fl, long long sbl, const void* fr, long long sbr, void* out,
                   int B, int H, int W, int C, int D, int td, int device, cudaStream_t stream) {
  static int attr_bytes[kMaxDevices];
  Args<T> a;
  a.fl = static_cast<const T*>(fl);
  a.fr = static_cast<const T*>(fr);
  a.out = static_cast<T*>(out);
  a.sbl = sbl;
  a.sbr = sbr;
  a.H = H;
  a.W = W;
  a.C = C;
  a.D = D;
  a.TD = td;
  a.nseg = (W + kTW - 1) / kTW;
  a.nd = (D + td - 1) / td;
  const bool f32 = sizeof(T) == 4;
  a.vec_in = f32 && C % 4 == 0 && reinterpret_cast<std::uintptr_t>(fl) % 16 == 0 &&
             reinterpret_cast<std::uintptr_t>(fr) % 16 == 0 && sbl % 4 == 0 && sbr % 4 == 0;
  a.vec_out = D % (16 / static_cast<int>(sizeof(T))) == 0 &&
              reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const long long blocks = (long long)B * H * a.nseg * a.nd;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int bytes = 2 * stage_floats(td) * static_cast<int>(sizeof(float));
  if (attr_bytes[device] < bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        correlation_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_bytes[device] = bytes;
  }
  correlation_kernel<T><<<static_cast<unsigned>(blocks), kPG * (td / kDX), bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sde

// fl, fr: (B, H, W, C) views of `dtype` (0 float32, 1 bfloat16) with
// contiguous (W, C) rows (C stride 1, W stride C, H stride W*C) and batch
// strides sbl, sbr (in elements); out (B, H, W, D) contiguous, of the same
// dtype. td: disparities per block, a multiple of 8 up to 64 with
// ceil(D / td) tiles.
extern "C" int sde_correlation(const void* fl, long long sbl, const void* fr, long long sbr,
                               void* out, int B, int H, int W, int C, int D, int td,
                               int dtype, int device, void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || H < 1 || W < 1 || C < 1 || D < 1 || td < sde::kDX || td > sde::kTDMax ||
      td % sde::kDX != 0 || device < 0 || device >= sde::kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sde::kFloat32)
    err = sde::launch<float>(fl, sbl, fr, sbr, out, B, H, W, C, D, td, device, s);
  else if (dtype == sde::kBFloat16)
    err = sde::launch<__nv_bfloat16>(fl, sbl, fr, sbr, out, B, H, W, C, D, td, device, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
