// fused_tail: the mono decoder's level-0 tail in one pass, NHWC.
//
//   z  = T( ELU(conv3x3_reflect(y1, W00) + b00) )          (B, h, w, C0)
//   y0 = T( ELU(conv3x3_reflect(up2_nearest(z), W01) + b01) )
//                                                        (B, 2h, 2w, C0o)
//
// with fp32 sums, T the input's dtype (fp32 or bf16) and z rounded to T
// between the stages, as the unfused chain conv3x3 -> upsample2x ->
// conv3x3 rounds it. z never reaches device memory.
//
// Replaces the TPU kernels scenedepthestimation_tpu/ops/pallas/
// fused_tail.py::fused_tail_pallas and fused_tail_v2.py::
// fused_tail_pallas_v2. Both compute this function on the TPU's packed
// lane layouts (space-to-depth planes, a collapsed upsample kernel,
// channel-group-duplicated halos); those layouts are TPU devices and are
// not carried over. One kernel covers both.
//
// What bounds it on an H100: bytes. At mono_kitti_384x1152_bench (b128,
// bf16, y1 (128, 192, 576, 32) -> y0 (128, 384, 1152, 16)) it reads 906 MB
// and writes 1812 MB: 0.81 ms at 3.35 TB/s, against 0.40 ms for its 391
// GFLOP on the bf16 tensor cores. In fp32 (config 1, b1) the same work on
// the CUDA cores is bound by its FMAs.
//
// Two kernels, one per dtype. fp32: one block of 256 threads per (image,
// 8 x 32 tile of z), i.e. a 16 x 64 tile of y0. The block
// stages the (8+4) x (32+4) haloed tile of y1 in shared memory, with the
// reflect border taken from indices at load time (no padded copy in device
// memory), computes z on the (8+2) x (32+2) tile around its own into
// shared memory (bias, ELU, rounding to T), then computes its y0 tile
// from that and writes it once. z rows and columns of the tile that lie
// outside the image are computed from clamped indices and never read:
// stage 2 clamps its indices to the image first. Nearest 2x followed by a
// reflect-bordered 3x3 conv reads, for output row r, z rows
// floor((r - 1 + ky) / 2) clamped to [0, h): full-res row -1 is z row 0,
// row 2h is z row h-1.
// * fp32 (fused_tail_kernel, CUDA cores): 16 input and 16 z channels at a
//   time, each thread holding 2 neighbouring pixels x 4 channels of 3
//   pixel pairs in registers. Stage 2 folds the nearest upsample into the
//   weights: per output phase (a, b) = (row % 2, col % 2) it is a 2x2 conv
//   over z whose taps are fp32 sums of the 3x3 taps (the per-phase form of
//   fused_tail_pallas_v2), 4 instead of 9 taps per output pixel.
// * bf16 (fused_tail_tc_kernel, tensor cores): persistent blocks over 16 x
//   32 z tiles, both stages as implicit GEMMs on mma.sync.m16n8k16 with
//   fp32 sums, weights arranged once per call, the next tile's halo in
//   flight during stage 2, y0 written as whole 16-byte vectors (see the
//   comment above it).
//
// Later work: TMA loads of the halo; wgmma if the products, not the
// bytes, set the pace.
#include "common.cuh"

namespace sde {
namespace {

constexpr int kThreads = 256;
constexpr int kZH = 8;                   // z rows per block
constexpr int kZW = 32;                  // z columns per block
constexpr int kZHH = kZH + 2;            // with the halo stage 2 reads
constexpr int kZWW = kZW + 2;
constexpr int kYH = kZH + 4;             // y1 rows stage 1 reads
constexpr int kYW = kZW + 4;
constexpr int kCK = 16;                  // input channels staged per step
constexpr int kCZ = 16;                  // z channels per stage-1 pass
constexpr int kCO = 16;                  // y0 channels per stage-2 pass
constexpr int kCX = 4;                   // channels per thread
constexpr int kNCG = kCZ / kCX;          // channel groups
constexpr int kNPG = kThreads / kNCG;    // pixel groups
constexpr int kPairs1 = kZHH * (kZWW / 2);             // stage-1 pixel pairs
constexpr int kIter1 = (kPairs1 + kNPG - 1) / kNPG;    // 3
constexpr int kPairs2 = kZH * (kZW / 2);               // stage-2 z pairs
constexpr int kIter2 = kPairs2 / kNPG;                 // 2
static_assert(kCO / kCX == kNCG, "both stages use the same channel groups");
static_assert(kZWW % 2 == 0 && kZW % 2 == 0, "pairs tile the rows");
static_assert(kPairs2 % kNPG == 0, "stage-2 pairs fill the pixel groups");

// Shared memory, in floats: stage-1 weights, then the y1 tile (whose room
// the stage-2 phase weights reuse), then z.
constexpr int kW1Floats = 9 * kCK * kCZ;
constexpr int kYFloats = kCK * kYH * kYW;
constexpr int kW2Floats = 16 * kCK * kCO;
constexpr int kRegionFloats = kYFloats > kW2Floats ? kYFloats : kW2Floats;

size_t smem_bytes(int C0) {
  return sizeof(float) *
         (size_t(kW1Floats) + kRegionFloats + size_t(C0) * kZHH * kZWW);
}

// Reflect index for i in [-2, n+1] (-1 -> 1, n -> n-2), clamped into
// [0, n): the clamp only touches rows and columns whose results are never
// read.
__device__ __forceinline__ int reflect_index(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

// Which of the 3x3 taps along one axis fold into tap t (0: z index - 1
// for phase 0, z index for phase 1; 1: z index for phase 0, z index + 1
// for phase 1) of output phase p: a bit mask over k = 0, 1, 2.
__device__ __forceinline__ int phase_taps(int p, int t) {
  return p == 0 ? (t == 0 ? 0b001 : 0b110) : (t == 0 ? 0b011 : 0b100);
}

// grid: (B * tiles_h * tiles_w). y1 (B, h, w, C1); w00 (C0, C1, 3, 3);
// w01 (C0o, C0, 3, 3); y0 (B, 2h, 2w, C0o); all fp32.
__global__ void __launch_bounds__(kThreads, 2)
    fused_tail_kernel(const float* __restrict__ y1, const float* __restrict__ w00,
                      const float* __restrict__ b00, const float* __restrict__ w01,
                      const float* __restrict__ b01, float* __restrict__ y0, int h,
                      int w, int C1, int C0, int C0o, int tiles_h,
                      int tiles_w) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  float* smem = reinterpret_cast<float*>(dyn_smem);
  float* ws1 = smem;                      // [9][kCK][kCZ]
  float* ys = smem + kW1Floats;           // [kCK][kYH][kYW]
  float* ws2 = ys;                        // [4 phases][4 taps][kCK][kCO]
  float* zs = ys + kRegionFloats;         // [C0][kZHH][kZWW]

  const int tid = threadIdx.x;
  const int cg = tid % kNCG;
  const int pg = tid / kNCG;
  const long long tile = blockIdx.x;
  const int tw = static_cast<int>(tile % tiles_w);
  const int th = static_cast<int>((tile / tiles_w) % tiles_h);
  const long long b = tile / ((long long)tiles_w * tiles_h);
  const int zr0 = th * kZH;  // first z row and column of the tile
  const int zc0 = tw * kZW;
  const float* y1b = y1 + (size_t)b * h * w * C1;

  // ---- stage 1: z on the haloed tile, rows zr0-1 .. zr0+kZH ----------
  for (int cz0 = 0; cz0 < C0; cz0 += kCZ) {
    float acc[kIter1][2][kCX];
#pragma unroll
    for (int k = 0; k < kIter1; ++k)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int m = 0; m < kCX; ++m) acc[k][j][m] = 0.f;

    for (int ci0 = 0; ci0 < C1; ci0 += kCK) {
      __syncthreads();  // the previous chunk's readers are done
      // y1 rows zr0-2 .. zr0+kZH+1 and columns zc0-2 .. zc0+kZW+1;
      // channels fastest, so neighbouring threads read one NHWC pixel.
      for (int e = tid; e < kYFloats; e += kThreads) {
        const int c = e % kCK;
        const int pix = e / kCK;
        const int r = pix / kYW;
        const int q = pix % kYW;
        float v = 0.f;
        if (ci0 + c < C1) {
          const int hs = reflect_index(zr0 - 2 + r, h);
          const int wsrc = reflect_index(zc0 - 2 + q, w);
          v = y1b[((size_t)hs * w + wsrc) * C1 + ci0 + c];
        }
        ys[(c * kYH + r) * kYW + q] = v;
      }
      // W00 (C0, C1, 3, 3): tap fastest, so the reads are contiguous.
      for (int e = tid; e < kW1Floats; e += kThreads) {
        const int tap = e % 9;
        const int c = (e / 9) % kCK;
        const int o = e / (9 * kCK);
        float v = 0.f;
        if (cz0 + o < C0 && ci0 + c < C1)
          v = w00[((size_t)(cz0 + o) * C1 + ci0 + c) * 9 + tap];
        ws1[(tap * kCK + c) * kCZ + o] = v;
      }
      __syncthreads();

      for (int c = 0; c < kCK; ++c) {
#pragma unroll
        for (int k = 0; k < kIter1; ++k) {
          // Pairs past the tile recompute the last pair; never stored.
          const int pair = min(pg + k * kNPG, kPairs1 - 1);
          const int r = pair / (kZWW / 2);
          const int q = (pair % (kZWW / 2)) * 2;
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            const float* row = ys + (c * kYH + r + ky) * kYW + q;
            float xv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) xv[j] = row[j];
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              const float4 w4 = *reinterpret_cast<const float4*>(
                  &ws1[((ky * 3 + kx) * kCK + c) * kCZ + cg * kCX]);
              const float wv[kCX] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
              for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int m = 0; m < kCX; ++m)
                  acc[k][j][m] = fmaf(xv[j + kx], wv[m], acc[k][j][m]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int m = 0; m < kCX; ++m) {
      const int co = cz0 + cg * kCX + m;
      if (co >= C0) continue;
      const float bv = b00[co];
#pragma unroll
      for (int k = 0; k < kIter1; ++k) {
        const int pair = pg + k * kNPG;
        if (pair >= kPairs1) continue;
        const int r = pair / (kZWW / 2);
        const int q = (pair % (kZWW / 2)) * 2;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          zs[(co * kZHH + r) * kZWW + q + j] = elu(acc[k][j][m] + bv);
      }
    }
  }

  // ---- stage 2: per-phase 2x2 convs over z -> y0 ----------------------
  // Local z rows and columns each position pair reads, clamped to the
  // image first; local index = global - (zr0 - 1).
  int rl[kIter2][3], cl[kIter2][4], gi[kIter2], gj[kIter2];
#pragma unroll
  for (int k = 0; k < kIter2; ++k) {
    const int pair = pg + k * kNPG;
    gi[k] = zr0 + pair / (kZW / 2);
    gj[k] = zc0 + (pair % (kZW / 2)) * 2;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      rl[k][d] = min(max(gi[k] - 1 + d, 0), h - 1) - (zr0 - 1);
#pragma unroll
    for (int d = 0; d < 4; ++d)
      cl[k][d] = min(max(gj[k] - 1 + d, 0), w - 1) - (zc0 - 1);
  }
  const int H2 = 2 * h, W2 = 2 * w;

  for (int co0 = 0; co0 < C0o; co0 += kCO) {
    float acc[kIter2][2][4][kCX];
#pragma unroll
    for (int k = 0; k < kIter2; ++k)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int m = 0; m < kCX; ++m) acc[k][j][p][m] = 0.f;

    for (int c0 = 0; c0 < C0; c0 += kCK) {
      __syncthreads();  // z is complete; the previous weights are read
      // Phase weights: ws2[ph][t][c][o] = sum of W01[o][c][ky][kx] over
      // the taps that fold into 2x2 tap t = (ta, tb) of phase (a, b).
      for (int e = tid; e < kW2Floats; e += kThreads) {
        const int o = e % kCO;
        const int c = (e / kCO) % kCK;
        const int pt = e / (kCO * kCK);
        const int ph = pt / 4, t = pt % 4;
        float v = 0.f;
        if (co0 + o < C0o && c0 + c < C0) {
          const float* wk = w01 + ((size_t)(co0 + o) * C0 + c0 + c) * 9;
          const int rows = phase_taps(ph >> 1, t >> 1);
          const int cols = phase_taps(ph & 1, t & 1);
          for (int ky = 0; ky < 3; ++ky)
            for (int kx = 0; kx < 3; ++kx)
              if (((rows >> ky) & 1) && ((cols >> kx) & 1))
                v += wk[ky * 3 + kx];
        }
        ws2[((ph * 4 + t) * kCK + c) * kCO + o] = v;
      }
      __syncthreads();

      const int cn = min(kCK, C0 - c0);
      for (int c = 0; c < cn; ++c) {
        const float* zc = zs + (c0 + c) * kZHH * kZWW;
        float zv[kIter2][3][4];
#pragma unroll
        for (int k = 0; k < kIter2; ++k)
#pragma unroll
          for (int d = 0; d < 3; ++d)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              zv[k][d][e] = zc[rl[k][d] * kZWW + cl[k][e]];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int a = p >> 1, bb = p & 1;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int ta = t >> 1, tb = t & 1;
            const float4 w4 = *reinterpret_cast<const float4*>(
                &ws2[((p * 4 + t) * kCK + c) * kCO + cg * kCX]);
            const float wv[kCX] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int k = 0; k < kIter2; ++k)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                // z offset a-1+ta rows and j+bb-1+tb columns from the pair.
                const float v = zv[k][a + ta][j + bb + tb];
#pragma unroll
                for (int m = 0; m < kCX; ++m)
                  acc[k][j][p][m] = fmaf(v, wv[m], acc[k][j][p][m]);
              }
          }
        }
      }
    }

    const int cb = co0 + cg * kCX;
    if (cb >= C0o) continue;
    const int n = min(kCX, C0o - cb);
    float bv[kCX];
#pragma unroll
    for (int m = 0; m < kCX; ++m) bv[m] = m < n ? b01[cb + m] : 0.f;
    // A whole aligned 4-channel group stores as one vector.
    const bool vec = n == kCX && C0o % kCX == 0;
#pragma unroll
    for (int k = 0; k < kIter2; ++k) {
      if (gi[k] >= h) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (gj[k] + j >= w) continue;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int orow = 2 * gi[k] + (p >> 1);
          const int ocol = 2 * (gj[k] + j) + (p & 1);
          float v[kCX];
#pragma unroll
          for (int m = 0; m < kCX; ++m) v[m] = elu(acc[k][j][p][m] + bv[m]);
          float* dst = y0 + (((size_t)b * H2 + orow) * W2 + ocol) * C0o + cb;
          if (vec) {
            *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
            for (int m = 0; m < n; ++m) dst[m] = v[m];
          }
        }
      }
    }
  }
}

cudaError_t launch(const void* y1, const void* w00, const void* b00,
                   const void* w01, const void* b01, void* y0, int B, int h,
                   int w, int C1, int C0, int C0o, cudaStream_t stream) {
  const int tiles_h = (h + kZH - 1) / kZH;
  const int tiles_w = (w + kZW - 1) / kZW;
  const long long blocks = (long long)B * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(C0);
  cudaError_t err = cudaFuncSetAttribute(
      fused_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_tail_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(y1), static_cast<const float*>(w00),
      static_cast<const float*>(b00), static_cast<const float*>(w01),
      static_cast<const float*>(b01), static_cast<float*>(y0), h, w, C1, C0, C0o,
      tiles_h, tiles_w);
  return cudaGetLastError();
}

// ---- bf16: both stages as implicit GEMMs on the tensor cores ----------
//
// Persistent blocks of 16 warps, one an SM, each walking over z tiles of
// ZH x 32 (ZH = 16, or 8 where the channels leave too little shared
// memory), so a y0 tile of 2ZH x 64. The halo the block reads is (ZH+4) x
// 36 pixels of y1 for ZH x 32 of its own: 1.41x at ZH = 16 (1.69x at 8).
// Operands are staged in bf16, channels innermost with a row pitch of
// (channels rounded up to 16) + 8, so the 8 rows of an ldmatrix fall in
// distinct banks: the haloed y1 tile, the z tile, and both weights, which
// sde_fused_tail_arrange laid out once per call as [tap][n][k] and each
// block copies in with 16-byte cp.async once in its lifetime.
// * Stage 1: M = the (ZH+2) x 34 haloed z positions (up to 3 m16 tiles a
//   warp), N = 16 z channels a pass, K = 9 taps x C1; A and B through
//   ldmatrix, mma.sync.m16n8k16 with fp32 sums. z = bf16(ELU(acc + b00)).
// * Then the next tile's y1 halo is requested (16-byte cp.async) into the
//   y1 buffer stage 1 has finished with, and lands while stage 2 computes.
// * Stage 2: M = the ZH x 32 z positions (m16 tiles of 16 along a row), for
//   each of the 4 output phases; N = 16 output channels a pass; K = 9 taps
//   x C0 with the 3x3 taps kept apart (summed phase taps would round in
//   bf16): tap (ky, kx) of phase (a, b) reads z at row offset floor((a +
//   ky - 1) / 2) and column offset floor((b + kx - 1) / 2), indices clamped
//   to the image. Only 9 distinct (row, column) offsets occur, so each A
//   fragment is loaded once and feeds the 36 (phase, tap) products that
//   read it; the 9 taps' B fragments stay in registers.
// * Each warp stages its 2 x 32 y0 pixels (16 channels) in shared memory
//   and writes them as 16-byte vectors, neighbouring lanes on neighbouring
//   addresses: whole pixels, whole rows. Where the 48 KB of staging do not
//   fit beside the wider channels' tiles (C1 from 129 to 160 at C0 = C0o =
//   16), the 8-row tile writes channel pairs straight from the fragments
//   (STAGED = false), so the kernel takes every shape it took before.
constexpr int kTcThreads = 512;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTZW = 32;             // z columns a tile
constexpr int kTYW = kTZW + 4;       // y1 halo columns
constexpr int kTZWW = kTZW + 2;      // z columns with stage 2's halo
constexpr int kStgPitch = 16 + 8;    // y0 staging pitch (bf16)
constexpr int kStgElems = 2 * 32 * kStgPitch;      // a warp: 2 y0 rows x 32 pixels

template <int ZH>
struct TailTile {
  static constexpr int YH = ZH + 4, ZHH = ZH + 2;
  static constexpr int YPOS = YH * kTYW;
  static constexpr int ZPOS = ZHH * kTZWW;
  static constexpr int M1 = (ZPOS + 15) / 16;                    // stage-1 m16 tiles
  static constexpr int M1W = (M1 + kTcWarps - 1) / kTcWarps;     // a warp, at most
  static constexpr int M2 = ZH * kTZW / 16;                      // stage-2 m16 tiles
  static constexpr int M2W = M2 / kTcWarps;
  static_assert(M2 % kTcWarps == 0, "stage-2 m16 tiles fill the warps");
};

// Offsets (bf16 elements) into the dynamic shared memory, and row pitches.
struct TcLayout {
  int zh;              // z rows a tile: 16 or 8
  bool staged;         // y0 staged in shared memory for 16-byte stores
  int c1p, c0p, c0op;  // C1, C0 rounded up to 16 (K); C0o rounded up to 16 (N)
  int p1, p0;          // row pitches: c1p + 8, c0p + 8
  int zs, w1, w2, stg; // offsets of z, W00, W01, the y0 staging (y1 at 0)
  long long bytes;
};

TcLayout tc_layout_for(int C1, int C0, int C0o, int zh, bool staged = true) {
  TcLayout L;
  L.zh = zh;
  L.staged = staged;
  L.c1p = (C1 + 15) / 16 * 16;
  L.c0p = (C0 + 15) / 16 * 16;
  L.c0op = (C0o + 15) / 16 * 16;
  L.p1 = L.c1p + 8;
  L.p0 = L.c0p + 8;
  L.zs = (zh + 4) * kTYW * L.p1;
  L.w1 = L.zs + (zh + 2) * kTZWW * L.p0;
  L.w2 = L.w1 + 9 * L.c0p * L.p1;
  L.stg = L.w2 + 9 * L.c0op * L.p0;
  L.bytes = 2LL * (L.stg + (staged ? kTcWarps * kStgElems : 0));
  return L;
}

// The first of 16 rows staged, 8 rows staged, 8 rows unstaged that fits
// the card's 227 KB a block.
TcLayout tc_layout(int C1, int C0, int C0o) {
  TcLayout L = tc_layout_for(C1, C0, C0o, 16);
  if (L.bytes > 232448) L = tc_layout_for(C1, C0, C0o, 8);
  if (L.bytes > 232448) L = tc_layout_for(C1, C0, C0o, 8, false);
  return L;
}

// ELU of an fp32 sum headed for one bf16 rounding, without branches:
// expm1 by its Taylor polynomial on [-0.5, 0] (error below 3e-7 relative)
// and by __expf - 1 below (about 1e-6). expm1f, whose branches diverge
// within a warp, was the kernel's largest single cost.
__device__ __forceinline__ float elu_fast(float v) {
  const float x = fminf(v, 0.f);
  const float p =
      x * fmaf(x, fmaf(x, fmaf(x, fmaf(x, fmaf(x, fmaf(x, 1.f / 5040, 1.f / 720), 1.f / 120),
                                             1.f / 24), 1.f / 6), 0.5f), 1.f);
  const float e = __expf(x) - 1.f;
  return v > 0.f ? v : (x > -0.5f ? p : e);
}

// grid: min(tiles, SMs), persistent. y1 (B, h, w, C1) bf16; wslab from
// sde_fused_tail_arrange; y0 (B, 2h, 2w, C0o). `vec`: C1 % 8 == 0 and y1
// 16-byte aligned (16-byte halo copies); `vec_out`: C0o % 8 == 0 and y0
// 16-byte aligned (16-byte stores).
template <int ZH, bool STAGED>
__global__ void __launch_bounds__(kTcThreads, 1)
    fused_tail_tc_kernel(const uint16_t* __restrict__ y1, const uint16_t* __restrict__ wslab,
                         const __nv_bfloat16* __restrict__ b00,
                         const __nv_bfloat16* __restrict__ b01,
                         __nv_bfloat16* __restrict__ y0, int h, int w, int C1, int C0, int C0o,
                         int tiles_h, int tiles_w, long long ntiles, TcLayout L, bool vec,
                         bool vec_out) {
  using T = TailTile<ZH>;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  uint16_t* sm = reinterpret_cast<uint16_t*>(dyn_smem);
  uint16_t* ys = sm;          // [YPOS][p1]
  uint16_t* zs = sm + L.zs;   // [ZPOS][p0]
  uint16_t* w1s = sm + L.w1;  // [9][c0p][p1]
  uint16_t* w2s = sm + L.w2;  // [9][c0op][p0]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  uint16_t* stg = sm + L.stg + warp * kStgElems;  // [2][2 * kTZW][kStgPitch]
  // ldmatrix lane roles: A rows lane & 15 at channels (lane >> 4) * 8; B
  // (non-transposed, rows n) rows (lane & 7) + 8 (lane >> 4) at channels
  // ((lane >> 3) & 1) * 8.
  const int a_k = (lane >> 4) * 8;
  const int b_n = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;

  // Both weights, once: 16-byte rows of the slab into the padded rows.
  {
    const int v1 = L.c1p / 8, v0 = L.c0p / 8;
    const int n1 = 9 * L.c0p * v1, n2 = 9 * L.c0op * v0;
    for (int i = tid; i < n1 + n2; i += kTcThreads) {
      if (i < n1) {
        cp_async16(w1s + (i / v1) * L.p1 + (i % v1) * 8, wslab + (long long)i * 8, true);
      } else {
        const int j = i - n1;
        cp_async16(w2s + (j / v0) * L.p0 + (j % v0) * 8, wslab + ((long long)n1 + j) * 8, true);
      }
    }
  }

  // y1 rows zr0-2 .. zr0+ZH+1, columns zc0-2 .. zc0+33 of tile t, reflected.
  auto load_y1 = [&](long long t) {
    const int tw = static_cast<int>(t % tiles_w);
    const int th = static_cast<int>((t / tiles_w) % tiles_h);
    const long long b = t / ((long long)tiles_w * tiles_h);
    const int zr0 = th * ZH, zc0 = tw * kTZW;
    const uint16_t* y1b = y1 + (size_t)b * h * w * C1;
    if (vec) {
      const int nv = L.c1p / 8;
      for (int i = tid; i < T::YPOS * nv; i += kTcThreads) {
        const int pos = i / nv, c = (i - pos * nv) * 8;
        const int hs = reflect_index(zr0 - 2 + pos / kTYW, h);
        const int wsrc = reflect_index(zc0 - 2 + pos % kTYW, w);
        const bool ok = c < C1;
        cp_async16(ys + pos * L.p1 + c, ok ? y1b + ((size_t)hs * w + wsrc) * C1 + c : y1, ok);
      }
    } else {
      for (int i = tid; i < T::YPOS * L.c1p; i += kTcThreads) {
        const int pos = i / L.c1p, c = i - pos * L.c1p;
        uint16_t v = 0;
        if (c < C1) {
          const int hs = reflect_index(zr0 - 2 + pos / kTYW, h);
          const int wsrc = reflect_index(zc0 - 2 + pos % kTYW, w);
          v = y1b[((size_t)hs * w + wsrc) * C1 + c];
        }
        ys[pos * L.p1 + c] = v;
      }
    }
  };

  if (blockIdx.x < ntiles) load_y1(blockIdx.x);
  cp_async_commit();
  const int H2 = 2 * h, W2 = 2 * w;

  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();  // tile t's y1 (and the weights) landed; stage 2 of t - grid is done
    const int tw = static_cast<int>(t % tiles_w);
    const int th = static_cast<int>((t / tiles_w) % tiles_h);
    const long long b = t / ((long long)tiles_w * tiles_h);
    const int zr0 = th * ZH, zc0 = tw * kTZW;

    // ---- stage 1: z on the haloed tile -------------------------------
    int abase[T::M1W];
#pragma unroll
    for (int j = 0; j < T::M1W; ++j) {
      const int p = min((warp + kTcWarps * j) * 16 + (lane & 15), T::ZPOS - 1);
      abase[j] = ((p / kTZWW) * kTYW + p % kTZWW) * L.p1 + a_k;
    }
    for (int nz0 = 0; nz0 < L.c0p; nz0 += 16) {
      float acc[T::M1W][2][4];
#pragma unroll
      for (int j = 0; j < T::M1W; ++j)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          acc[j][nt][0] = acc[j][nt][1] = acc[j][nt][2] = acc[j][nt][3] = 0.f;
      for (int k0 = 0; k0 < L.c1p; k0 += 16) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          uint32_t bf[4];
          ldsm_x4(bf, w1s + (tap * L.c0p + nz0 + b_n) * L.p1 + k0 + b_k);
          const int toff = ((tap / 3) * kTYW + tap % 3) * L.p1 + k0;
#pragma unroll
          for (int j = 0; j < T::M1W; ++j) {
            if (warp + kTcWarps * j >= T::M1) continue;  // warp-uniform
            uint32_t a[4];
            ldsm_x4(a, ys + abase[j] + toff);
            mma_bf16(acc[j][0], a, bf[0], bf[1]);
            mma_bf16(acc[j][1], a, bf[2], bf[3]);
          }
        }
      }
      // Channels past C0 have zero weights and bias: their z is ELU(0) = 0.
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = nz0 + nt * 8 + 2 * q;
        const float bv0 = n < C0 ? __bfloat162float(b00[n]) : 0.f;
        const float bv1 = n + 1 < C0 ? __bfloat162float(b00[n + 1]) : 0.f;
#pragma unroll
        for (int j = 0; j < T::M1W; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int p = (warp + kTcWarps * j) * 16 + g + 8 * hh;
            if (p >= T::ZPOS) continue;
            *reinterpret_cast<uint32_t*>(zs + p * L.p0 + n) =
                pack_bf16x2(elu_fast(acc[j][nt][2 * hh] + bv0), elu_fast(acc[j][nt][2 * hh + 1] + bv1));
          }
      }
    }
    __syncthreads();  // z is complete; the y1 buffer is free
    if (t + gridDim.x < ntiles) load_y1(t + gridDim.x);
    cp_async_commit();

    // ---- stage 2: per output phase, a 9-tap conv over z -> y0 ---------
    // m16 tile s = warp + 16j covers z row zr0 + s / 2, columns zc0 +
    // (s % 2) * 16 + [0, 16). Local z rows (x 34) and this lane's A row's
    // columns for offsets -1, 0, +1, clamped to the image first; local
    // index = global - (zr0 - 1).
#pragma unroll
    for (int j = 0; j < T::M2W; ++j) {
      const int s = warp + kTcWarps * j;
      const int gi = zr0 + s / (kTZW / 16);
      const int gj0 = zc0 + (s % (kTZW / 16)) * 16;
      int zrow[3], zcol[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        zrow[d] = (min(max(gi - 1 + d, 0), h - 1) - (zr0 - 1)) * kTZWW;
        zcol[d] = min(max(gj0 + (lane & 15) - 1 + d, 0), w - 1) - (zc0 - 1);
      }
      for (int n0 = 0; n0 < L.c0op; n0 += 16) {
        float acc[4][2][4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            acc[p][nt][0] = acc[p][nt][1] = acc[p][nt][2] = acc[p][nt][3] = 0.f;
        for (int k0 = 0; k0 < L.c0p; k0 += 16) {
          uint32_t bw[9][4];
#pragma unroll
          for (int tap = 0; tap < 9; ++tap)
            ldsm_x4(bw[tap], w2s + (tap * L.c0op + n0 + b_n) * L.p0 + k0 + b_k);
#pragma unroll
          for (int dr = 0; dr < 3; ++dr)
#pragma unroll
            for (int dc = 0; dc < 3; ++dc) {
              uint32_t a[4];
              ldsm_x4(a, zs + (zrow[dr] + zcol[dc]) * L.p0 + k0 + a_k);
#pragma unroll
              for (int p = 0; p < 4; ++p)
#pragma unroll
                for (int ky = 0; ky < 3; ++ky)
#pragma unroll
                  for (int kx = 0; kx < 3; ++kx) {
                    if ((((p >> 1) + ky + 1) >> 1) != dr || (((p & 1) + kx + 1) >> 1) != dc)
                      continue;  // resolved at compile time
                    mma_bf16(acc[p][0], a, bw[ky * 3 + kx][0], bw[ky * 3 + kx][1]);
                    mma_bf16(acc[p][1], a, bw[ky * 3 + kx][2], bw[ky * 3 + kx][3]);
                  }
            }
        }
        if constexpr (!STAGED) {
          // ELU(acc + b01), one rounding, channel pairs straight to y0.
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int n = n0 + nt * 8 + 2 * q;
            if (gi >= h || n >= C0o) continue;
            const float bv0 = __bfloat162float(b01[n]);
            const float bv1 = n + 1 < C0o ? __bfloat162float(b01[n + 1]) : 0.f;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              if (gj0 + g + 8 * hh >= w) continue;
#pragma unroll
              for (int p = 0; p < 4; ++p) {
                const int px = 2 * (g + 8 * hh) + (p & 1);
                __nv_bfloat16* dst =
                    y0 + (((size_t)b * H2 + 2 * gi + (p >> 1)) * W2 + 2 * gj0 + px) * C0o + n;
                const uint32_t v = pack_bf16x2(elu_fast(acc[p][nt][2 * hh] + bv0),
                                               elu_fast(acc[p][nt][2 * hh + 1] + bv1));
                dst[0] = *reinterpret_cast<const __nv_bfloat16*>(&v);
                if (n + 1 < C0o) dst[1] = reinterpret_cast<const __nv_bfloat16*>(&v)[1];
              }
            }
          }
          continue;
        }
        // ELU(acc + b01), one rounding, staged as [row][pixel][channel].
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int n = n0 + nt * 8 + 2 * q;
          const float bv0 = n < C0o ? __bfloat162float(b01[n]) : 0.f;
          const float bv1 = n + 1 < C0o ? __bfloat162float(b01[n + 1]) : 0.f;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const int px = 2 * (g + 8 * hh) + (p & 1);
              *reinterpret_cast<uint32_t*>(stg + ((p >> 1) * 32 + px) * kStgPitch + nt * 8 + 2 * q) =
                  pack_bf16x2(elu_fast(acc[p][nt][2 * hh] + bv0), elu_fast(acc[p][nt][2 * hh + 1] + bv1));
            }
        }
        __syncwarp();
        // 2 rows x 32 pixels x 16 channels: 128 vectors of 8 channels.
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int item = lane + 32 * r;
          const int row = item >> 6, px = (item >> 1) & 31, half = item & 1;
          const int n = n0 + half * 8;
          if (gi >= h || gj0 + (px >> 1) >= w || n >= C0o) continue;
          const uint16_t* from = stg + (row * 32 + px) * kStgPitch + half * 8;
          __nv_bfloat16* dst =
              y0 + (((size_t)b * H2 + 2 * gi + row) * W2 + 2 * gj0 + px) * C0o + n;
          if (vec_out) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(from);
          } else {
            for (int e = 0; e < 8 && n + e < C0o; ++e)
              dst[e] = *reinterpret_cast<const __nv_bfloat16*>(from + e);
          }
        }
        __syncwarp();
      }
    }
  }
}

// W00 (C0, C1, 3, 3) and W01 (C0o, C0, 3, 3), bf16 -> slab: W00 as [tap][n
// < c0p][k < c1p], then W01 as [tap][n < c0op][k < c0p], zero past the
// channels.
__global__ void fused_tail_arrange_kernel(const uint16_t* __restrict__ w00,
                                          const uint16_t* __restrict__ w01,
                                          uint16_t* __restrict__ slab, int C1, int C0, int C0o,
                                          int c1p, int c0p, int c0op) {
  const int n1 = 9 * c0p * c1p, n2 = 9 * c0op * c0p;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n1 + n2; e += gridDim.x * blockDim.x) {
    const bool first = e < n1;
    const int i = first ? e : e - n1;
    const int kp = first ? c1p : c0p, np = first ? c0p : c0op;
    const int N = first ? C0 : C0o, K = first ? C1 : C0;
    const int k = i % kp, n = (i / kp) % np, tap = i / (kp * np);
    const uint16_t* wk = first ? w00 : w01;
    slab[e] = (n < N && k < K) ? wk[((size_t)n * K + k) * 9 + tap] : uint16_t(0);
  }
}

template <int ZH, bool STAGED>
cudaError_t launch_tc_zh(const void* y1, const void* wslab, const void* b00, const void* b01,
                         void* y0, int B, int h, int w, int C1, int C0, int C0o,
                         const TcLayout& L, int device, cudaStream_t stream) {
  const int tiles_h = (h + ZH - 1) / ZH;
  const int tiles_w = (w + kTZW - 1) / kTZW;
  const long long ntiles = (long long)B * tiles_h * tiles_w;
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long blocks = std::min<long long>(ntiles, sms);
  auto kernel = &fused_tail_tc_kernel<ZH, STAGED>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L.bytes));
  if (err != cudaSuccess) return err;
  const bool vec = C1 % 8 == 0 && reinterpret_cast<std::uintptr_t>(y1) % 16 == 0;
  const bool vec_out = C0o % 8 == 0 && reinterpret_cast<std::uintptr_t>(y0) % 16 == 0;
  kernel<<<static_cast<unsigned>(blocks), kTcThreads, L.bytes, stream>>>(
      static_cast<const uint16_t*>(y1), static_cast<const uint16_t*>(wslab),
      static_cast<const __nv_bfloat16*>(b00), static_cast<const __nv_bfloat16*>(b01),
      static_cast<__nv_bfloat16*>(y0), h, w, C1, C0, C0o, tiles_h, tiles_w, ntiles, L, vec,
      vec_out);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* y1, const void* wslab, const void* b00, const void* b01,
                      void* y0, int B, int h, int w, int C1, int C0, int C0o, int device,
                      cudaStream_t stream) {
  const TcLayout L = tc_layout(C1, C0, C0o);
  if (L.zh == 16)
    return launch_tc_zh<16, true>(y1, wslab, b00, b01, y0, B, h, w, C1, C0, C0o, L, device, stream);
  if (L.staged)
    return launch_tc_zh<8, true>(y1, wslab, b00, b01, y0, B, h, w, C1, C0, C0o, L, device, stream);
  return launch_tc_zh<8, false>(y1, wslab, b00, b01, y0, B, h, w, C1, C0, C0o, L, device, stream);
}

}  // namespace
}  // namespace sde

// Shared memory one block of sde_fused_tail needs at these channel counts
// and dtype.
extern "C" long long sde_fused_tail_smem(int C1, int C0, int C0o, int dtype) {
  if (dtype == sde::kFloat32) return static_cast<long long>(sde::smem_bytes(C0));
  return sde::tc_layout(C1, C0, C0o).bytes;
}

// Elements of the bf16 weight slab sde_fused_tail_arrange writes.
extern "C" long long sde_fused_tail_slab_elems(int C1, int C0, int C0o) {
  const sde::TcLayout L = sde::tc_layout_for(C1, C0, C0o, 16);
  return 9LL * L.c0p * L.c1p + 9LL * L.c0op * L.c0p;
}

// w00 (C0, C1, 3, 3), w01 (C0o, C0, 3, 3) contiguous bf16 -> the slab the
// bf16 kernel copies (sde_fused_tail_slab_elems elements).
extern "C" int sde_fused_tail_arrange(const void* w00, const void* w01, void* slab, int C1,
                                      int C0, int C0o, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const sde::TcLayout L = sde::tc_layout_for(C1, C0, C0o, 16);
  const long long n = sde_fused_tail_slab_elems(C1, C0, C0o);
  const int blocks = static_cast<int>(std::min<long long>((n + 255) / 256, 1024));
  sde::fused_tail_arrange_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(w00), static_cast<const uint16_t*>(w01),
      static_cast<uint16_t*>(slab), C1, C0, C0o, L.c1p, L.c0p, L.c0op);
  return static_cast<int>(cudaGetLastError());
}

// y1 (B, h, w, C1), w00 (C0, C1, 3, 3), b00 (C0), w01 (C0o, C0, 3, 3),
// b01 (C0o) in `dtype`, all contiguous; y0 (B, 2h, 2w, C0o) in `dtype`;
// wslab (bf16 only) from sde_fused_tail_arrange, 16-byte aligned. h, w >=
// 2 (the reflect border). Channels whose tiles do not fit the device's
// shared memory (sde_fused_tail_smem) are refused at launch.
extern "C" int sde_fused_tail(const void* y1, const void* w00, const void* b00,
                              const void* w01, const void* b01, const void* wslab, void* y0,
                              int B, int h, int w, int C1, int C0, int C0o,
                              int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h < 2 || w < 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sde::kFloat32) {
    err = sde::launch(y1, w00, b00, w01, b01, y0, B, h, w, C1, C0, C0o, s);
  } else {
    if (wslab == nullptr || reinterpret_cast<std::uintptr_t>(wslab) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    err = sde::launch_tc(y1, wslab, b00, b01, y0, B, h, w, C1, C0, C0o, device, s);
  }
  return static_cast<int>(err);
}
