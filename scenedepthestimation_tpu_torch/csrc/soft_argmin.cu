// soft_argmin: the expected disparity under softmax(-cost) over D.
//
//   disp[p] = scale * sum_d d * exp(-cost[p, d] - m) / sum_d exp(-cost[p, d] - m)
//
// with m = max_d(-cost[p, d]) for every pixel p of a (N, D) volume, and,
// with the depth epilogue, fb / max(disp, 1e-6) in its place.
//
// Replaces the TPU kernel scenedepthestimation_tpu/ops/pallas/
// soft_argmin.py::soft_argmin_pallas.
//
// What bounds it on an H100: bytes. It reads the volume once and writes 4
// bytes a pixel (86.7 MB, 25.9 us at stereo_kitti2015_b16_bf16_v5e8's
// (16, 96, 288, 48) fp32 cost; 6.3 MB at stereo_256x512_b4's), with about 6
// operations and one exponential an element.
//
// Design: a group of K lanes (a power of two) shares a pixel, so a warp
// reads 32 / K whole rows. Each lane issues all its 16-byte loads (NV of
// them: 4 fp32 or 8 bf16 values each, lane j of a group taking the row's
// vectors j, j + K, j + 2K, ...) before any arithmetic, and keeps the
// values in registers, so the row is read from memory once. The group
// takes the max, then the two sums, with log2(K) shuffles each; the
// group's first lane writes, adjacent pixels adjacent words. The wrapper
// picks K and NV (ops/cuda/soft_argmin.py lane_plan: the least K whose NV
// is at most 4; D = 48 fp32 is K = 4, NV = 3). The grid covers about one
// wave of resident blocks and strides over the pixels. Rows that are not
// 16-byte aligned (fp32 with D % 4 != 0, bf16 with D % 8 != 0) or longer
// than 32 lanes x 4 vectors take the looped path: one warp a pixel, 4-byte
// loads, the row read twice. A bf16 cost is upcast on load, as on the TPU;
// the output is fp32.
//
// The backward (sde_soft_argmin_bwd), the gradient of the readout for an
// fp32 cost and no epilogue, replaces what XLA derives for the JAX
// package's readout (scenedepthestimation_tpu/ops/soft_argmin.py::
// _soft_argmin_jnp, whose autodiff the JAX train steps run): with
// p = softmax(-cost) over D and E = sum_d d p_d,
//   dcost[p, k] = -g[p] * scale * p_k * (k - E).
// It recomputes the row's max, sum and E from the cost rather than keeping
// p from the forward. Bytes bound it too: the cost read once, the gradient
// written once (12.6 MB at stereo_256x512_b4's (4, 64, 128, 48), 3.8 us).
// It runs on the forward's lane groups, with the wrapper's lane_plan and
// the forward's device functions for the loads, the max and the sums
// (load_lane_row, lane_row_max, lane_row_sums): a lane issues its 16-byte
// loads of the row and g[p] before any arithmetic, keeps exp(-cost - m) of
// its values in registers (one expf an element, the row read once), and
// writes its vectors of dcost as 16-byte stores. The grid is the
// forward's, about one wave striding over the pixels. Rows without a
// plan keep a looped path, one warp a pixel, the row read three times.
#include <cmath>

#include "common.cuh"

namespace sde {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxVecs = 4;  // 16-byte vectors a lane holds

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float finish(float num, float den, float scale, int depth,
                                        float fb) {
  const float v = num / den * scale;
  return depth ? fb / fmaxf(v, 1e-6f) : v;
}

// The values of a 16-byte vector: 4 fp32 or 8 bf16.
__device__ __forceinline__ void vec_to_float(const uint4 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void vec_to_float(const uint4 v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// ---- a group of K = 2^lanes_log2 lanes a pixel (the forward's and the
// backward's fast path) -----------------------------------------------------
//
// Lane j of a group holds the row's 16-byte vectors j, j + K, ..., j + (NV
// - 1) K; vector vi is held when the pixel is live (< n) and vi is inside
// the row.
__device__ __forceinline__ bool held(bool live, int vi, int nvec) { return live && vi < nvec; }

// Issues all of the lane's 16-byte loads of the row before any arithmetic.
template <typename T, int NV>
__device__ __forceinline__ void load_lane_row(const T* __restrict__ row, bool live, int j, int K,
                                              int nvec, uint4 (&v)[NV]) {
  const uint4* r = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < NV; ++i)
    v[i] = held(live, j + i * K, nvec) ? __ldg(r + j + i * K) : make_uint4(0u, 0u, 0u, 0u);
}

// m = max_d(-cost[p, d]) over the group, log2(K) shuffles.
template <typename T, int NV>
__device__ __forceinline__ float lane_row_max(const uint4 (&v)[NV], bool live, int j, int K,
                                              int nvec) {
  constexpr int VE = 16 / sizeof(T);
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (!held(live, j + i * K, nvec)) continue;
    float f[VE];
    vec_to_float(v[i], f);
#pragma unroll
    for (int e = 0; e < VE; ++e) m = fmaxf(m, -f[e]);
  }
  for (int o = K >> 1; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// ex = exp(-cost - m) for the lane's values (0 where not held), one expf
// an element, and over the group den = sum_d ex and num = sum_d d ex, with
// log2(K) shuffles each.
template <typename T, int NV>
__device__ __forceinline__ void lane_row_sums(const uint4 (&v)[NV], float m, bool live, int j,
                                              int K, int nvec,
                                              float (&ex)[NV][16 / sizeof(T)], float& den,
                                              float& num) {
  constexpr int VE = 16 / sizeof(T);
  den = 0.f;
  num = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = j + i * K;
    if (!held(live, vi, nvec)) {
#pragma unroll
      for (int e = 0; e < VE; ++e) ex[i][e] = 0.f;
      continue;
    }
    float f[VE];
    vec_to_float(v[i], f);
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      ex[i][e] = expf(-f[e] - m);
      den += ex[i][e];
      num += ex[i][e] * static_cast<float>(vi * VE + e);
    }
  }
  for (int o = K >> 1; o > 0; o >>= 1) {
    den += __shfl_xor_sync(0xffffffffu, den, o);
    num += __shfl_xor_sync(0xffffffffu, num, o);
  }
}

// The warp's pixels are p0 .. p0 + 32 / K - 1, all its lanes stepping
// together so that every shuffle has the full warp; lanes past n load
// nothing.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    soft_argmin_lanes_kernel(const T* __restrict__ cost, float* __restrict__ out, long long n,
                             int D, int lanes_log2, float scale, int depth, float fb) {
  constexpr int VE = 16 / sizeof(T);  // values a vector
  const int K = 1 << lanes_log2;
  const int lane = threadIdx.x & 31, j = lane & (K - 1);
  const int nvec = D / VE;
  const long long per_warp = 32 >> lanes_log2;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long p0 = ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * per_warp;
       p0 < n; p0 += warps * per_warp) {
    const long long p = p0 + (lane >> lanes_log2);
    const bool live = p < n;
    uint4 v[NV];
    load_lane_row<T, NV>(cost + (live ? p : 0) * D, live, j, K, nvec, v);
    const float m = lane_row_max<T, NV>(v, live, j, K, nvec);
    float ex[NV][VE], den, num;
    lane_row_sums<T, NV>(v, m, live, j, K, nvec, ex, den, num);
    if (live && j == 0) out[p] = finish(num, den, scale, depth, fb);
  }
}

// The looped path: one warp a pixel in a grid-stride loop; the lanes read
// the pixel's D values (coalesced), take the max, then the sums, each
// reduced across the warp; lane 0 writes. Any D >= 1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    soft_argmin_kernel(const T* __restrict__ cost, float* __restrict__ out,
                       long long n, int D, float scale, int depth, float fb) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long p = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       p < n; p += warps) {
    const T* row = cost + p * D;
    float m = -INFINITY;
    for (int d = lane; d < D; d += 32) m = fmaxf(m, -to_float(row[d]));
    m = warp_max(m);
    float den = 0.f, num = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float e = expf(-to_float(row[d]) - m);
      den += e;
      num += e * static_cast<float>(d);
    }
    den = warp_sum(den);
    num = warp_sum(num);
    if (lane == 0) out[p] = finish(num, den, scale, depth, fb);
  }
}

// The backward's looped path, for rows lane_plan gives no plan (D % 4 !=
// 0, or longer than 32 lanes x 4 vectors): one warp a pixel, the max, the
// two sums, then the row written; the second and third reads of a row hit
// L1.
__global__ void __launch_bounds__(kThreads)
    soft_argmin_bwd_looped_kernel(const float* __restrict__ grad, const float* __restrict__ cost,
                                  float* __restrict__ dcost, long long n, int D, float scale) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long p = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       p < n; p += warps) {
    const float* row = cost + p * D;
    float m = -INFINITY;
    for (int d = lane; d < D; d += 32) m = fmaxf(m, -__ldg(row + d));
    m = warp_max(m);
    float den = 0.f, num = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float e = expf(-__ldg(row + d) - m);
      den += e;
      num += e * static_cast<float>(d);
    }
    den = warp_sum(den);
    num = warp_sum(num);
    const float mean = num / den;
    const float gs = -__ldg(grad + p) * scale / den;
    float* out = dcost + p * D;
    for (int d = lane; d < D; d += 32)
      out[d] = gs * expf(-__ldg(row + d) - m) * (static_cast<float>(d) - mean);
  }
}

// A 16-byte vector of the gradient, in the cost's type (fp32 only: the bf16
// training path is not written).
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[16 / sizeof(T)]);
template <>
__device__ __forceinline__ void store_vec<float>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The backward's fast path, on the forward's lane groups: the row's loads
// and grad[p] issued first, the max and the sums by the forward's code,
// exp(-cost - m) kept in registers (one expf an element, one read of the
// row), then dcost[p, k] = -g scale / den * ex_k * (k - num / den) written
// as 16-byte stores.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    soft_argmin_bwd_lanes_kernel(const float* __restrict__ grad, const T* __restrict__ cost,
                                 T* __restrict__ dcost, long long n, int D, int lanes_log2,
                                 float scale) {
  constexpr int VE = 16 / sizeof(T);
  const int K = 1 << lanes_log2;
  const int lane = threadIdx.x & 31, j = lane & (K - 1);
  const int nvec = D / VE;
  const long long per_warp = 32 >> lanes_log2;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long p0 = ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * per_warp;
       p0 < n; p0 += warps * per_warp) {
    const long long p = p0 + (lane >> lanes_log2);
    const bool live = p < n;
    const long long base = (live ? p : 0) * D;
    uint4 v[NV];
    load_lane_row<T, NV>(cost + base, live, j, K, nvec, v);
    const float g = live ? __ldg(grad + p) : 0.f;
    const float m = lane_row_max<T, NV>(v, live, j, K, nvec);
    float ex[NV][VE], den, num;
    lane_row_sums<T, NV>(v, m, live, j, K, nvec, ex, den, num);
    const float mean = num / den;
    const float gs = -g * scale / den;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = j + i * K;
      if (!held(live, vi, nvec)) continue;
      float o[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) o[e] = gs * ex[i][e] * (static_cast<float>(vi * VE + e) - mean);
      store_vec<T>(dcost + base + vi * VE, o);
    }
  }
}

// Blocks for `pixels_per_block`: enough for every pixel, at most about one
// wave of resident blocks (2048 threads an SM); the kernels stride.
cudaError_t grid_for(long long n, long long pixels_per_block, int device, unsigned* blocks) {
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const long long wave = (long long)sms * (2048 / kThreads);
  *blocks = static_cast<unsigned>(
      std::min<long long>((n + pixels_per_block - 1) / pixels_per_block, wave));
  return cudaSuccess;
}

// The fast path's contract: a power of two of lanes, up to 4 vectors a lane
// covering the row, 16-byte aligned rows; sets lanes_log2.
template <typename T>
bool lane_contract(int lanes, int vecs, int D, const void* cost, int* lanes_log2) {
  constexpr int VE = 16 / sizeof(T);
  *lanes_log2 = 0;
  while ((1 << *lanes_log2) < lanes) ++*lanes_log2;
  return (1 << *lanes_log2) == lanes && lanes <= 32 && vecs >= 1 && vecs <= kMaxVecs &&
         D % VE == 0 && (long long)lanes * vecs * VE >= D &&
         (reinterpret_cast<uintptr_t>(cost) & 15) == 0;
}

template <typename T>
cudaError_t launch(const void* cost, float* out, long long n, int D, int lanes, int vecs,
                   float scale, int depth, float fb, int device, cudaStream_t stream) {
  const T* c = static_cast<const T*>(cost);
  unsigned blocks = 0;
  if (lanes == 0) {
    const cudaError_t err = grid_for(n, kThreads / 32, device, &blocks);
    if (err != cudaSuccess) return err;
    soft_argmin_kernel<T><<<blocks, kThreads, 0, stream>>>(c, out, n, D, scale, depth, fb);
    return cudaGetLastError();
  }
  int lanes_log2 = 0;
  if (!lane_contract<T>(lanes, vecs, D, cost, &lanes_log2)) return cudaErrorInvalidValue;
  const cudaError_t err = grid_for(n, kThreads / lanes, device, &blocks);
  if (err != cudaSuccess) return err;
  switch (vecs) {
    case 1:
      soft_argmin_lanes_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(c, out, n, D, lanes_log2,
                                                                      scale, depth, fb);
      break;
    case 2:
      soft_argmin_lanes_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(c, out, n, D, lanes_log2,
                                                                      scale, depth, fb);
      break;
    case 3:
      soft_argmin_lanes_kernel<T, 3><<<blocks, kThreads, 0, stream>>>(c, out, n, D, lanes_log2,
                                                                      scale, depth, fb);
      break;
    default:
      soft_argmin_lanes_kernel<T, 4><<<blocks, kThreads, 0, stream>>>(c, out, n, D, lanes_log2,
                                                                      scale, depth, fb);
      break;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace sde

// cost (n, D) contiguous in `dtype` (0 float32, 1 bfloat16); out (n)
// float32. depth: 0 writes disp * scale, 1 writes fb / max(disp * scale,
// 1e-6). lanes, vecs: the fast path's lanes a pixel and 16-byte vectors a
// lane (lane_plan in ops/cuda/soft_argmin.py), or lanes = 0 for the looped
// path. Needs n, D >= 1.
extern "C" int sde_soft_argmin(const void* cost, void* out, long long n, int D, int dtype,
                               float scale, int depth, float fb, int lanes, int vecs,
                               int device, void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == sde::kFloat32)
    err = sde::launch<float>(cost, o, n, D, lanes, vecs, scale, depth, fb, device, s);
  else if (dtype == sde::kBFloat16)
    err = sde::launch<__nv_bfloat16>(cost, o, n, D, lanes, vecs, scale, depth, fb, device, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// grad (n) float32, cost (n, D) float32, both contiguous; dcost (n, D)
// float32: the gradient of scale * E[d] under softmax(-cost) (no epilogue).
// lanes, vecs: the forward's lane plan for the row (lane_plan in
// ops/cuda/soft_argmin.py), or lanes = 0 for the looped path. Needs n, D >= 1.
extern "C" int sde_soft_argmin_bwd(const void* grad, const void* cost, void* dcost, long long n,
                                   int D, float scale, int lanes, int vecs, int device,
                                   void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(grad);
  const float* c = static_cast<const float*>(cost);
  float* dc = static_cast<float*>(dcost);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned blocks = 0;
  if (lanes == 0) {
    err = sde::grid_for(n, sde::kThreads / 32, device, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    sde::soft_argmin_bwd_looped_kernel<<<blocks, sde::kThreads, 0, s>>>(g, c, dc, n, D, scale);
    return static_cast<int>(cudaGetLastError());
  }
  int lanes_log2 = 0;
  if (!sde::lane_contract<float>(lanes, vecs, D, cost, &lanes_log2) ||
      (reinterpret_cast<uintptr_t>(dcost) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  err = sde::grid_for(n, sde::kThreads / lanes, device, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (vecs) {
    case 1:
      sde::soft_argmin_bwd_lanes_kernel<float, 1><<<blocks, sde::kThreads, 0, s>>>(
          g, c, dc, n, D, lanes_log2, scale);
      break;
    case 2:
      sde::soft_argmin_bwd_lanes_kernel<float, 2><<<blocks, sde::kThreads, 0, s>>>(
          g, c, dc, n, D, lanes_log2, scale);
      break;
    case 3:
      sde::soft_argmin_bwd_lanes_kernel<float, 3><<<blocks, sde::kThreads, 0, s>>>(
          g, c, dc, n, D, lanes_log2, scale);
      break;
    default:
      sde::soft_argmin_bwd_lanes_kernel<float, 4><<<blocks, sde::kThreads, 0, s>>>(
          g, c, dc, n, D, lanes_log2, scale);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
