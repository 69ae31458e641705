// correlation_bwd: the gradient of the 1-D correlation cost volume
//   cost[b, h, w, d] = 1/C sum_c fl[b, h, w, c] fr[b, h, w - d, c]
// with respect to both feature maps, given g = dL/dcost:
//   d_fl[w, c] = 1/C sum_d g[w, d] fr[w - d, c]          (w - d >= 0)
//   d_fr[w, c] = 1/C sum_d g[w + d, d] fl[w + d, c]      (w + d < W)
// (every term inside one (b, h) row), in fp32. (The banded Gram's bf16
// backward is correlation_gram_bwd.cu, on the tensor cores.)
//
// It replaces the TPU kernel's analytic VJP, scenedepthestimation_tpu/
// ops/correlation.py::_corr_bwd (registered on _correlation_pallas_op with
// jax.custom_vjp), which XLA runs as D shifted multiply-adds.
//
// What bounds it on an H100: bytes. It reads g, fl and fr once and writes
// d_fl and d_fr once (40 MB at stereo_256x512_b4's (4, 64, 128, 64) D = 48,
// 12 us at 3.35 TB/s); its 0.4 GFLOP take 6 us on the CUDA cores, so the
// products must run near the CUDA cores' rate, fed from shared memory at
// well under one shared load per 4 FMAs.
//
// Design: units of a row's 64-column W segment, both outputs in a unit; no
// atomics, the same bits on every run.
//   * Staging (16-byte cp.async, zero-filled outside [0, W) and past C
//     or D): fr's columns [w0 - d0 - DT + 1, w0 + 64 -
//     d0) and fl's [w0 + d0, w0 + 63 + d0 + DT), 64 channels a column,
//     channel-minor; g's rows [w0 + d0, w0 + 63 + d0 + DT) for the D chunk
//     [d0, d0 + DT), read through its strides (the aggregation's concat
//     hands back the slice [..., :D] of a (D + C)-wide gradient, W stride
//     D + C): staged once for both outputs, since d_fl's rows [w0, w0 + 64)
//     are its first 64 when d0 = 0. g's rows keep their 16-byte slots
//     XORed by (row / 8) % 2, so a warp's two pixel groups, 8 rows apart,
//     read distinct banks.
//   * Persistent: as many blocks an SM as fit (one, whose two stages take
//     153 KB) walk the units (blockIdx.x, + gridDim.x, ...) with two
//     stages, the next unit's staging in flight while they sum the current
//     one (config 4: 512 units on 132 SMs).
//   * Threads 0-127 sum d_fl, 128-255 d_fr. Thread (p, q) owns the 8 x 4
//     register tile of pixels 8p .. 8p+7 and channels 4q .. 4q+3 (lanes q
//     fastest: a warp's g reads are two broadcast addresses). Pixel i at
//     disparity d reads view column w + i - d (d_fr: w + i + d), so each
//     step of d shifts the tile's 8 columns by one: a ring of 8 float4 in
//     registers takes one new column a step. g comes as 4 values over 4
//     consecutive d: for d_fl a row a pixel, for d_fr the 11 rows that the
//     4 steps' diagonals g[w + i + d, d] cross. 3 (d_fr 3.75) shared
//     loads for 32 FMAs a step, and no pass over g in shared memory (a
//     d-major copy of g for both outputs cost a fifth of the time).
//   * d ascends for every output element, across D chunks too, and the
//     1/C comes last, as in the JAX VJP; sums are plain fp32 FMAs (no TF32).
//   * D larger than 48 runs in chunks of DT (a multiple of 8, so that g's
//     16-byte slots pair up for the XOR; at most 48; D = 48 is one), each
//     restaging the windows and g (d_fl's g rows then
//     apart); C larger than 64 in 64-channel chunks, each with its outputs.
// C not a multiple of a 16-byte vector, views whose rows are not 16-byte
// aligned and a gradient whose rows are not take scalar staging into the
// same layout; outputs off 16 bytes take scalar stores.
#include "common.cuh"

namespace sde {
namespace {

constexpr int kSeg = 64;                // output columns per block (W segment)
constexpr int kPX = 8;                  // pixels a thread (the register ring)
constexpr int kKC = 64;                 // channels staged per chunk
constexpr int kCG = kKC / 4;            // channel groups of 4
constexpr int kHalf = kSeg / kPX * kCG; // threads per output
constexpr int kThreads = 2 * kHalf;
constexpr int kDTMax = 48;              // disparities per D chunk

// T: the inputs' and the outputs' type (float); a 16-byte copy moves
// vec_elems<T>() of them.
template <typename T>
struct CorrBwdArgs {
  const T* g;
  long long sgb, sgh, sgw;  // g's strides; its D stride is 1
  const T* fl;
  long long sbl;            // batch strides; (W, C) rows contiguous
  const T* fr;
  long long sbr;
  T* dfl;                   // (B, H, W, C) contiguous
  T* dfr;
  int H, W, C, D, DT, nd, nseg, nunits;
  bool vec_f, vec_g, vec_out;
};

template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

__host__ __device__ constexpr int win_cols(int dt) { return kSeg + dt - 1; }

// Elements of one stage (the two windows, g's rows and, with more than one
// D chunk, d_fl's own rows of g); shared memory holds two.
__host__ __device__ constexpr int stage_elems(int dt, int nd) {
  return 2 * win_cols(dt) * kKC + win_cols(dt) * dt + (nd > 1 ? kSeg * dt : 0);
}

// Offset of g's value at staged row r, chunk disparity k (DT values a row,
// DT a whole number of 16-byte slot pairs): the 16-byte slot XORed by
// (r / 8) % 2, so the two pixel groups of a warp, 8 rows apart, read
// distinct banks.
template <typename T>
__device__ __forceinline__ int gslot(int r, int k, int dt) {
  constexpr int v = vec_elems<T>();
  return r * dt + (((k / v) ^ ((r >> 3) & 1)) * v) + (k % v);
}

// Four consecutive values from shared memory.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four values to device memory.
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Channels [c0, c0 + kKC) of the columns [col0, col0 + ncols) of one row's
// (W, C) features into dst (column j at j * kKC), zeros outside [0, W) x
// [0, C). `vec`: C a whole number of 16-byte vectors and 16-byte aligned
// rows.
template <typename T>
__device__ __forceinline__ void stage_win(T* __restrict__ dst, const T* __restrict__ src,
                                          int col0, int ncols, int W, int C, int c0, bool vec) {
  if (vec) {
    constexpr int ve = vec_elems<T>(), nv = kKC / ve;
    const int v = threadIdx.x % nv, c = c0 + ve * v;
    for (int j = threadIdx.x / nv; j < ncols; j += kThreads / nv) {
      const int col = col0 + j;
      const bool ok = col >= 0 && col < W && c < C;
      cp_async16(dst + j * kKC + ve * v, ok ? src + (long long)col * C + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ncols * kKC; i += kThreads) {
      const int j = i / kKC, k = i % kKC, c = c0 + k, col = col0 + j;
      dst[j * kKC + k] = (col >= 0 && col < W && c < C) ? src[(long long)col * C + c]
                                                          : from_float<T>(0.f);
    }
  }
}

// g's rows [r0, r0 + nrows) (columns w of the row), disparities [d0, d0 +
// DT), into dst (gslot), zeros past W and D. `vec`: D a whole number of
// 16-byte vectors and 16-byte aligned rows.
template <typename T>
__device__ __forceinline__ void stage_g(T* __restrict__ dst, const T* __restrict__ grow,
                                        long long sgw, int r0, int nrows, int W, int D, int d0,
                                        int dt, bool vec) {
  if (vec) {
    constexpr int ve = vec_elems<T>();
    const int nv = dt / ve;
    for (int i = threadIdx.x; i < nrows * nv; i += kThreads) {
      const int r = i / nv, k = ve * (i % nv), w = r0 + r, d = d0 + k;
      const bool ok = w < W && d < D;
      cp_async16(dst + gslot<T>(r, k, dt), ok ? grow + w * sgw + d : grow, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * dt; i += kThreads) {
      const int r = i / dt, k = i % dt, w = r0 + r, d = d0 + k;
      dst[gslot<T>(r, k, dt)] = (w < W && d < D) ? grow[w * sgw + d] : from_float<T>(0.f);
    }
  }
}

// One D chunk's sums of a thread's 8 x 4 tile: d_fl (kRight false) from
// fr's window (pixel i at chunk disparity k reads column 8p + i + DT - 1 -
// k) and g[8p + i, k] from g's rows (gslot), or d_fr from fl's window
// (column 8p + i + k) and g[8p + i + k, k] from g's rows. The ring holds
// pixel i's column at slot (i - k) % 8 (d_fr: (i + k) % 8), so every step
// loads the one column that enters; g comes as 4 values over 4 consecutive
// k: a row for each of the 8 pixels (d_fl) or the 11 rows the 4 steps'
// diagonals cross (d_fr).
template <bool kRight, typename T>
__device__ __forceinline__ void tile_sums(float (&acc)[kPX][4], const T* __restrict__ win,
                                          const T* __restrict__ g, int p, int q, int dt) {
  constexpr int kGV = kRight ? kPX + 3 : kPX;  // g vectors for 4 steps
  const int jb = kPX * p + (kRight ? 0 : dt - 1);
  const T* wq = win + 4 * q;
  float4 ring[kPX];
#pragma unroll
  for (int i = 0; i < kPX; ++i)
    if (i != (kRight ? kPX - 1 : 0)) ring[i] = ld4(wq + (jb + i) * kKC);
  for (int k8 = 0; k8 < dt; k8 += 8) {
    float4 gv[kGV];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int k = k8 + s;
      if ((s & 3) == 0) {
#pragma unroll
        for (int j = 0; j < kGV; ++j)
          gv[j] = ld4(g + gslot<T>(kPX * p + (kRight ? k : 0) + j, k, dt));
      }
      if (kRight)
        ring[(kPX - 1 + s) % kPX] = ld4(wq + (jb + kPX - 1 + k) * kKC);
      else
        ring[(kPX - s % kPX) % kPX] = ld4(wq + (jb - k) * kKC);
#pragma unroll
      for (int i = 0; i < kPX; ++i) {
        const float4 f = ring[kRight ? (i + s) % kPX : (i - s % kPX + kPX) % kPX];
        const float gg = lane4(gv[kRight ? i + (s & 3) : i], s & 3);
        acc[i][0] = fmaf(gg, f.x, acc[i][0]);
        acc[i][1] = fmaf(gg, f.y, acc[i][1]);
        acc[i][2] = fmaf(gg, f.z, acc[i][2]);
        acc[i][3] = fmaf(gg, f.w, acc[i][3]);
      }
    }
  }
}

// A task is one (unit, channel chunk, D chunk) of a block's units (rows'
// W segments blockIdx.x, blockIdx.x + gridDim.x, ...), in that order.
struct Task {
  int w0, row, c0, d0, dc;
};

template <typename T>
__device__ __forceinline__ Task task_of(const CorrBwdArgs<T>& a, int t) {
  const int per_unit = ((a.C + kKC - 1) / kKC) * a.nd;
  const int unit = blockIdx.x + (t / per_unit) * gridDim.x, r = t % per_unit;
  Task k;
  k.w0 = (unit % a.nseg) * kSeg;
  k.row = unit / a.nseg;
  k.c0 = (r / a.nd) * kKC;
  k.dc = r % a.nd;
  k.d0 = k.dc * a.DT;
  return k;
}

// Stages task k's g rows and windows into stage st (cp.async, uncommitted).
template <typename T>
__device__ __forceinline__ void stage_task(const CorrBwdArgs<T>& a, const Task& k, T* st) {
  const int DT = a.DT, ncols = win_cols(DT);
  const int b = k.row / a.H, h = k.row - b * a.H;
  const long long rowoff = (long long)h * a.W * a.C;
  const T* grow = a.g + b * a.sgb + h * a.sgh;
  T* win_r = st;
  T* win_l = win_r + ncols * kKC;
  T* graw = win_l + ncols * kKC;
  stage_g(graw, grow, a.sgw, k.w0 + k.d0, ncols, a.W, a.D, k.d0, DT, a.vec_g);
  if (k.d0 > 0) stage_g(graw + ncols * DT, grow, a.sgw, k.w0, kSeg, a.W, a.D, k.d0, DT, a.vec_g);
  stage_win(win_r, a.fr + b * a.sbr + rowoff, k.w0 - k.d0 - DT + 1, ncols, a.W, a.C, k.c0,
            a.vec_f);
  stage_win(win_l, a.fl + b * a.sbl + rowoff, k.w0 + k.d0, ncols, a.W, a.C, k.c0, a.vec_f);
}

// Persistent: each block walks its tasks with the next task's staging in
// flight while it sums the current one.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) correlation_bwd_kernel(const CorrBwdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int DT = a.DT;
  const int ncols = win_cols(DT);
  const int sf = stage_elems(DT, a.nd);

  const int units = (a.nunits - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int ntasks = units * ((a.C + kKC - 1) / kKC) * a.nd;
  const bool right = threadIdx.x >= kHalf;  // warp-uniform
  const int t_ = threadIdx.x % kHalf, q = t_ % kCG, p = t_ / kCG;
  const float inv_c = 1.f / static_cast<float>(a.C);

  float acc[kPX][4];
  if (ntasks > 0) stage_task(a, task_of(a, 0), smem);
  cp_async_commit();
  for (int t = 0; t < ntasks; ++t) {
    const Task k = task_of(a, t);
    T* st = smem + (t & 1) * sf;
    // The other stage was consumed by task t - 1 (the barrier that ended it).
    if (t + 1 < ntasks) stage_task(a, task_of(a, t + 1), smem + ((t + 1) & 1) * sf);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* win_r = st;
    const T* win_l = win_r + ncols * kKC;
    const T* graw = win_l + ncols * kKC;
    if (k.dc == 0) {
#pragma unroll
      for (int i = 0; i < kPX; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    }
    if (right)
      tile_sums<true>(acc, win_l, graw, p, q, DT);
    else  // d_fl's rows of g: the first 64 of graw, or their own past D chunk 0
      tile_sums<false>(acc, win_r, k.d0 > 0 ? graw + ncols * DT : graw, p, q, DT);
    const int c = k.c0 + 4 * q;
    if (k.dc == a.nd - 1 && c < a.C) {
      T* out = (right ? a.dfr : a.dfl) + ((long long)k.row * a.W) * a.C;
#pragma unroll
      for (int i = 0; i < kPX; ++i) {
        const int w = k.w0 + kPX * p + i;
        if (w >= a.W) break;
        T* o = out + (long long)w * a.C + c;
        if (a.vec_out) {
          st4(o, acc[i][0] * inv_c, acc[i][1] * inv_c, acc[i][2] * inv_c, acc[i][3] * inv_c);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < a.C) o[e] = from_float<T>(acc[i][e] * inv_c);
        }
      }
    }
    __syncthreads();  // stage t consumed before task t + 2 refills it
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

// The D chunk: the fewest chunks of at most kDTMax disparities, each
// ceil(D / chunks) rounded up to a multiple of two 16-byte vectors (8 fp32).
template <typename T>
int d_chunk(int D) {
  const int chunks = (D + kDTMax - 1) / kDTMax, m = 2 * vec_elems<T>();
  return ((D + chunks - 1) / chunks + m - 1) / m * m;
}

template <typename T>
cudaError_t launch_bwd(const void* g, long long sgb, long long sgh, long long sgw,
                       const void* fl, long long sbl, const void* fr, long long sbr, void* dfl,
                       void* dfr, int B, int H, int W, int C, int D, int device,
                       cudaStream_t stream) {
  static int attr_bytes[kMaxDevices], per_sm[kMaxDevices];
  constexpr int v = vec_elems<T>();
  CorrBwdArgs<T> a;
  a.g = static_cast<const T*>(g);
  a.sgb = sgb;
  a.sgh = sgh;
  a.sgw = sgw;
  a.fl = static_cast<const T*>(fl);
  a.sbl = sbl;
  a.fr = static_cast<const T*>(fr);
  a.sbr = sbr;
  a.dfl = static_cast<T*>(dfl);
  a.dfr = static_cast<T*>(dfr);
  a.H = H;
  a.W = W;
  a.C = C;
  a.D = D;
  a.DT = d_chunk<T>(D);
  a.nd = (D + a.DT - 1) / a.DT;
  a.nseg = (W + kSeg - 1) / kSeg;
  a.vec_f = C % v == 0 && sbl % v == 0 && sbr % v == 0 && aligned16(fl) && aligned16(fr);
  a.vec_g = D % v == 0 && sgb % v == 0 && sgh % v == 0 && sgw % v == 0 && aligned16(g);
  a.vec_out = C % 4 == 0 && aligned16(dfl) && aligned16(dfr);
  const long long units = (long long)B * H * a.nseg;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.nunits = static_cast<int>(units);
  int sms = 0;
  cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const int bytes = 2 * stage_elems(a.DT, a.nd) * static_cast<int>(sizeof(T));
  if (attr_bytes[device] != bytes) {
    err = cudaFuncSetAttribute(correlation_bwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[device],
                                                        correlation_bwd_kernel<T>, kThreads, bytes);
    if (err != cudaSuccess) return err;
    attr_bytes[device] = bytes;
  }
  const long long blocks = std::min<long long>(units, (long long)sms * std::max(per_sm[device], 1));
  correlation_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sde

// g (B, H, W, D) with strides sgb, sgh, sgw (elements) and D stride 1;
// fl, fr (B, H, W, C) views with contiguous (W, C) rows and batch strides
// sbl, sbr; d_fl, d_fr (B, H, W, C) contiguous, written whole; all fp32.
// The D chunk is the fewest chunks of at most 48 disparities, each
// ceil(D / chunks) rounded up to a multiple of 8 (ops/cuda/correlation.py
// backward_plan); as many blocks an SM as fit.
extern "C" int sde_correlation_bwd(const void* g, long long sgb, long long sgh, long long sgw,
                                   const void* fl, long long sbl, const void* fr, long long sbr,
                                   void* dfl, void* dfr, int B, int H, int W, int C, int D,
                                   int device, void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || H < 1 || W < 1 || C < 1 || D < 1 || device < 0 || device >= sde::kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  err = sde::launch_bwd<float>(g, sgb, sgh, sgw, fl, sbl, fr, sbr, dfl, dfr, B, H, W, C, D,
                               device, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
