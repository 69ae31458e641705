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
// Two kernels, one per dtype, on the same tiling: one block of 256 threads
// per (image, 8 x 32 tile of z), i.e. a 16 x 64 tile of y0. The block
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
// * bf16 (fused_tail_tc_kernel, tensor cores): both stages as implicit
//   GEMMs on mma.sync.m16n8k16 with fp32 sums (see the comment above it).
//
// Later work: wgmma and TMA loads of the y1 tile; the weights arranged
// once per call instead of by every block; stores of whole 16-byte pixels
// through shared memory.
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
// The same tile and halo as above, 8 warps. Every operand is staged once,
// in bf16, channels innermost with a row pitch of (channels rounded up to
// 16) + 8, so the 8 rows g of a fragment load fall in distinct banks: the
// haloed y1 tile, the z tile, W00 as [tap][n][k] and W01 as
// [tap][n][k], zero-padded past C1, C0 and C0o.
// * Stage 1: M = the 340 haloed z positions (22 m16 tiles, up to 3 a
//   warp), N = 16 z channels a pass, K = 9 taps x C1: one
//   mma.sync.m16n8k16 per (m16 tile, n8 tile, tap, 16 channels), A rows
//   read at the tap's offset in the y1 tile. z = bf16(ELU(acc + b00)).
// * Stage 2: M = the 256 z positions of the block (16 m16 tiles of 16
//   positions along a row, 2 a warp), for each of the 4 output phases;
//   N = 16 output channels a pass; K = 9 taps x C0 with the 3x3 taps kept
//   apart (summed phase taps would round in bf16): tap (ky, kx) of phase
//   (a, b) reads z at row offset floor((a + ky - 1) / 2) and column offset
//   floor((b + kx - 1) / 2), indices clamped to the image.
constexpr int kTcWarps = kThreads / 32;
constexpr int kZPos = kZHH * kZWW;                                  // 340
constexpr int kYPos = kYH * kYW;                                    // 432
constexpr int kM1Tiles = (kZPos + 15) / 16;                         // 22
constexpr int kM1PerWarp = (kM1Tiles + kTcWarps - 1) / kTcWarps;    // 3
constexpr int kM2Tiles = kZH * kZW / 16;                            // 16
constexpr int kM2PerWarp = kM2Tiles / kTcWarps;                     // 2
static_assert(kZW % 16 == 0 && kM2Tiles % kTcWarps == 0, "stage-2 m16 tiles");

// Offsets (bf16 elements) into the dynamic shared memory, and row pitches.
struct TcLayout {
  int c1p, c0p, c0op;  // C1, C0 rounded up to 16 (K); C0o rounded up to 16 (N)
  int p1, p0;          // row pitches: c1p + 8, c0p + 8
  int zs, w1, w2;      // offsets of z, W00, W01 (y1 at 0)
  long long bytes;
};

TcLayout tc_layout(int C1, int C0, int C0o) {
  TcLayout L;
  L.c1p = (C1 + 15) / 16 * 16;
  L.c0p = (C0 + 15) / 16 * 16;
  L.c0op = (C0o + 15) / 16 * 16;
  L.p1 = L.c1p + 8;
  L.p0 = L.c0p + 8;
  L.zs = kYPos * L.p1;
  L.w1 = L.zs + kZPos * L.p0;
  L.w2 = L.w1 + 9 * L.c0p * L.p1;
  L.bytes = 2LL * (L.w2 + 9 * L.c0op * L.p0);
  return L;
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += A (16x16, row-major) * B (16x8, column-major), bf16 in, fp32 sums.
// Not volatile: it only reads and writes registers, so the compiler may
// schedule it around the fragment loads.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows `lo` (row g) and `hi` (row g + 8), each already
// at this thread's channel offset 2q: a0..a3 of mma.m16n8k16.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* lo,
                                       const uint16_t* hi) {
  a[0] = lds32(lo);
  a[1] = lds32(hi);
  a[2] = lds32(lo + 8);
  a[3] = lds32(hi + 8);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// W (N, K, 3, 3) -> dst[tap][n][k] with row pitch `pitch`, zero for n >= N
// or k >= K, over np x kp. A thread copies the 9 contiguous taps of one
// (n, k).
__device__ __forceinline__ void stage_weights(uint16_t* dst,
                                              const uint16_t* __restrict__ w,
                                              int N, int K, int np, int kp,
                                              int pitch) {
  for (int i = threadIdx.x; i < np * kp; i += kThreads) {
    const int n = i / kp, k = i - n * kp;
    const bool valid = n < N && k < K;
    const uint16_t* src = w + ((size_t)n * K + k) * 9;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      dst[(tap * np + n) * pitch + k] = valid ? src[tap] : uint16_t(0);
  }
}

// grid: (B * tiles_h * tiles_w). Same tensors as fused_tail_kernel, bf16.
// `vec`: C1 % 8 == 0 and y1 16-byte aligned, so 8 channels load as one
// 16-byte vector. Three blocks an SM (80 registers, a few spilled) ran
// the bench shape 8% faster than two without spills: the block's
// staging and barriers then overlap other blocks' products.
__global__ void __launch_bounds__(kThreads, 3)
    fused_tail_tc_kernel(const uint16_t* __restrict__ y1,
                         const uint16_t* __restrict__ w00,
                         const __nv_bfloat16* __restrict__ b00,
                         const uint16_t* __restrict__ w01,
                         const __nv_bfloat16* __restrict__ b01,
                         __nv_bfloat16* __restrict__ y0, int h, int w, int C1,
                         int C0, int C0o, int tiles_h, int tiles_w,
                         TcLayout L, bool vec) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  uint16_t* sm = reinterpret_cast<uint16_t*>(dyn_smem);
  uint16_t* ys = sm;          // [kYPos][p1]
  uint16_t* zs = sm + L.zs;   // [kZPos][p0]
  uint16_t* w1s = sm + L.w1;  // [9][c0p][p1]
  uint16_t* w2s = sm + L.w2;  // [9][c0op][p0]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;  // mma group and thread in group
  const long long tile = blockIdx.x;
  const int tw = static_cast<int>(tile % tiles_w);
  const int th = static_cast<int>((tile / tiles_w) % tiles_h);
  const long long b = tile / ((long long)tiles_w * tiles_h);
  const int zr0 = th * kZH;
  const int zc0 = tw * kZW;
  const uint16_t* y1b = y1 + (size_t)b * h * w * C1;

  // y1 rows zr0-2 .. zr0+kZH+1, columns zc0-2 .. zc0+kZW+1, reflected.
  if (vec) {
    const int nv = L.c1p / 8;
    for (int i = tid; i < kYPos * nv; i += kThreads) {
      const int pos = i / nv, c = (i % nv) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c < C1) {
        const int hs = reflect_index(zr0 - 2 + pos / kYW, h);
        const int wsrc = reflect_index(zc0 - 2 + pos % kYW, w);
        val = *reinterpret_cast<const uint4*>(y1b + ((size_t)hs * w + wsrc) * C1 + c);
      }
      *reinterpret_cast<uint4*>(ys + pos * L.p1 + c) = val;
    }
  } else {
    for (int i = tid; i < kYPos * L.c1p; i += kThreads) {
      const int pos = i / L.c1p, c = i % L.c1p;
      uint16_t v = 0;
      if (c < C1) {
        const int hs = reflect_index(zr0 - 2 + pos / kYW, h);
        const int wsrc = reflect_index(zc0 - 2 + pos % kYW, w);
        v = y1b[((size_t)hs * w + wsrc) * C1 + c];
      }
      ys[pos * L.p1 + c] = v;
    }
  }
  stage_weights(w1s, w00, C0, C1, L.c0p, L.c1p, L.p1);
  stage_weights(w2s, w01, C0o, C0, L.c0op, L.c0p, L.p0);
  __syncthreads();

  // ---- stage 1: z on the haloed tile ---------------------------------
  // Rows g and g+8 of this warp's m16 tiles: their (tap 0, 0) position in
  // the y1 tile; positions past the tile recompute the last one.
  int ybase[kM1PerWarp][2];
#pragma unroll
  for (int j = 0; j < kM1PerWarp; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = min((warp + kTcWarps * j) * 16 + g + 8 * hh, kZPos - 1);
      ybase[j][hh] = ((p / kZWW) * kYW + p % kZWW) * L.p1 + 2 * q;
    }
  for (int nz0 = 0; nz0 < L.c0p; nz0 += 16) {
    float acc[kM1PerWarp][2][4];
#pragma unroll
    for (int j = 0; j < kM1PerWarp; ++j)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        acc[j][nt][0] = acc[j][nt][1] = acc[j][nt][2] = acc[j][nt][3] = 0.f;
    for (int k0 = 0; k0 < L.c1p; k0 += 16) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = ((tap / 3) * kYW + tap % 3) * L.p1 + k0;
        uint32_t bf[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint16_t* bp = w1s + (tap * L.c0p + nz0 + nt * 8 + g) * L.p1 + k0 + 2 * q;
          bf[nt][0] = lds32(bp);
          bf[nt][1] = lds32(bp + 8);
        }
#pragma unroll
        for (int j = 0; j < kM1PerWarp; ++j) {
          if (warp + kTcWarps * j >= kM1Tiles) continue;  // warp-uniform
          uint32_t a[4];
          load_a(a, ys + ybase[j][0] + toff, ys + ybase[j][1] + toff);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[j][nt], a, bf[nt][0], bf[nt][1]);
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
      for (int j = 0; j < kM1PerWarp; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = (warp + kTcWarps * j) * 16 + g + 8 * hh;
          if (p >= kZPos) continue;
          *reinterpret_cast<uint32_t*>(zs + p * L.p0 + n) =
              pack_bf16x2(elu(acc[j][nt][2 * hh] + bv0),
                          elu(acc[j][nt][2 * hh + 1] + bv1));
        }
    }
  }
  __syncthreads();

  // ---- stage 2: per output phase, a 9-tap conv over z -> y0 ------------
  // m16 tile t = warp + 8j covers z row zr0 + t/2, columns zc0 + (t%2)*16
  // + [0, 16); the warp takes its tiles one after the other. Local z rows
  // (x kZWW) and columns for offsets -1, 0, +1, clamped to the image
  // first; local index = global - (zr0 - 1).
  const int H2 = 2 * h, W2 = 2 * w;
  const bool even = (C0o & 1) == 0;
  for (int j = 0; j < kM2PerWarp; ++j) {
    const int t = warp + kTcWarps * j;
    const int gi = zr0 + t / (kZW / 16);
    const int gj0 = zc0 + (t % (kZW / 16)) * 16;  // first z column of the tile
    int zrow[3], zcol[2][3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      zrow[d] = (min(max(gi - 1 + d, 0), h - 1) - (zr0 - 1)) * kZWW;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        zcol[hh][d] = min(max(gj0 + g + 8 * hh - 1 + d, 0), w - 1) - (zc0 - 1);
    }
    for (int n0 = 0; n0 < L.c0op; n0 += 16) {
      float acc[4][2][4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          acc[p][nt][0] = acc[p][nt][1] = acc[p][nt][2] = acc[p][nt][3] = 0.f;
      for (int k0 = 0; k0 < L.c0p; k0 += 16) {
        const uint16_t* zk = zs + k0 + 2 * q;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int tap = ky * 3 + kx;
            uint32_t bf[2][2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const uint16_t* bp = w2s + (tap * L.c0op + n0 + nt * 8 + g) * L.p0 + k0 + 2 * q;
              bf[nt][0] = lds32(bp);
              bf[nt][1] = lds32(bp + 8);
            }
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              // z offsets floor((a + ky - 1) / 2), floor((b + kx - 1) / 2),
              // as indices 0..2 into the -1, 0, +1 tables.
              const int dr = ((p >> 1) + ky + 1) >> 1;
              const int dc = ((p & 1) + kx + 1) >> 1;
              uint32_t a[4];
              load_a(a, zk + (zrow[dr] + zcol[0][dc]) * L.p0,
                     zk + (zrow[dr] + zcol[1][dc]) * L.p0);
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[p][nt], a, bf[nt][0], bf[nt][1]);
            }
          }
      }
      if (gi >= h) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = n0 + nt * 8 + 2 * q;
        if (n >= C0o) continue;
        const float bv0 = __bfloat162float(b01[n]);
        const float bv1 = n + 1 < C0o ? __bfloat162float(b01[n + 1]) : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int gj = gj0 + g + 8 * hh;
          if (gj >= w) continue;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int orow = 2 * gi + (p >> 1);
            const int ocol = 2 * gj + (p & 1);
            const float v0 = elu(acc[p][nt][2 * hh] + bv0);
            const float v1 = elu(acc[p][nt][2 * hh + 1] + bv1);
            __nv_bfloat16* dst = y0 + (((size_t)b * H2 + orow) * W2 + ocol) * C0o + n;
            if (even) {
              *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(v0, v1);
            } else {
              dst[0] = __float2bfloat16(v0);
              if (n + 1 < C0o) dst[1] = __float2bfloat16(v1);
            }
          }
        }
      }
    }
  }
}

cudaError_t launch_tc(const void* y1, const void* w00, const void* b00,
                      const void* w01, const void* b01, void* y0, int B, int h,
                      int w, int C1, int C0, int C0o, cudaStream_t stream) {
  const int tiles_h = (h + kZH - 1) / kZH;
  const int tiles_w = (w + kZW - 1) / kZW;
  const long long blocks = (long long)B * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const TcLayout L = tc_layout(C1, C0, C0o);
  cudaError_t err = cudaFuncSetAttribute(
      fused_tail_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.bytes));
  if (err != cudaSuccess) return err;
  const bool vec = C1 % 8 == 0 && reinterpret_cast<std::uintptr_t>(y1) % 16 == 0;
  fused_tail_tc_kernel<<<static_cast<unsigned>(blocks), kThreads, L.bytes,
                         stream>>>(
      static_cast<const uint16_t*>(y1), static_cast<const uint16_t*>(w00),
      static_cast<const __nv_bfloat16*>(b00), static_cast<const uint16_t*>(w01),
      static_cast<const __nv_bfloat16*>(b01), static_cast<__nv_bfloat16*>(y0), h,
      w, C1, C0, C0o, tiles_h, tiles_w, L, vec);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sde

// Shared memory one block of sde_fused_tail needs at these channel counts
// and dtype.
extern "C" long long sde_fused_tail_smem(int C1, int C0, int C0o, int dtype) {
  if (dtype == sde::kFloat32) return static_cast<long long>(sde::smem_bytes(C0));
  return sde::tc_layout(C1, C0, C0o).bytes;
}

// y1 (B, h, w, C1), w00 (C0, C1, 3, 3), b00 (C0), w01 (C0o, C0, 3, 3),
// b01 (C0o) in `dtype`, all contiguous; y0 (B, 2h, 2w, C0o) in `dtype`.
// h, w >= 2 (the reflect border). A C0 whose z tile does not fit the
// device's shared memory (sde_fused_tail_smem) is refused at launch.
extern "C" int sde_fused_tail(const void* y1, const void* w00, const void* b00,
                              const void* w01, const void* b01, void* y0,
                              int B, int h, int w, int C1, int C0, int C0o,
                              int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (h < 2 || w < 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sde::kFloat32)
    err = sde::launch(y1, w00, b00, w01, b01, y0, B, h, w, C1, C0, C0o, s);
  else
    err = sde::launch_tc(y1, w00, b00, w01, b01, y0, B, h, w, C1, C0, C0o, s);
  return static_cast<int>(err);
}
