// correlation_gram: the 1-D stereo cost volume of bf16 features, computed
// as a banded Gram on the tensor cores.
//
//   cost[r, x, d] = bf16( (1/C) * sum_c FL[r, x, c] * FR[r, x - d, c] )
//
// for every row r = b*H + h, with FR[r, x - d, :] = 0 where x - d < 0;
// bf16 products, fp32 sums, one rounding to bf16 at the end.
//
// Replaces the TPU kernels scenedepthestimation_tpu/ops/pallas/
// correlation_v2.py::correlation_pallas_v2 (full per-row Gram + log-shear)
// and correlation_v3.py::correlation_pallas_v3 (W-tiled Gram + in-tile
// shear), and the XLA form they share, ops/correlation.py::
// _correlation_gram, which the JAX package runs for bf16 features. All
// three compute this function; one kernel covers them.
//
// What bounds it on an H100: bytes. At stereo_kitti2015_b16_bf16_v5e8,
// (16, 96, 288, 64) with D = 48, it reads 2 x 56.6 MB and writes 42.5 MB
// (46 us at 3.35 TB/s) for 2.7 GFLOP of useful products (3 us at the
// bf16 tensor-core peak). The band wastes products (a 16-row tile spans
// 16 + D - 1 window columns for D useful ones), but products are cheap
// here: the design spends them to keep every load and store dense.
//
// Design (simple first version): one block of 4 warps per (row r, 64-wide
// tile of W starting at x0, tile of up to 64 disparities starting at d0).
// The block stages in shared memory, in bf16, 64 channels at a time:
//   * the tile's 64 left columns FL[x0 .. x0+63];
//   * the right window FR[x0 - d0 - (TD-1) .. ], 128 columns, of which the
//     band reads the first 64 + TD - 1;
// writing zeros outside [0, W) and past C itself (no padded copy in
// device memory; a C that is not a multiple of 16 gets a zero K tail).
// Warp i owns the left rows [16i, 16i+16) and runs
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 against the window, only on
// the n8 tiles its band reads: window columns [16i, 16i + 15 + TD - 1],
// 8 of the 14 tiles at D = 48. Row pitch 72 bf16 (144 bytes) puts the 32
// fragment loads of a warp in 32 banks. The epilogue writes the fp32 band
// block to shared memory (aliasing the operands) and reads
// cost[u, d] = G[u, u + TD - 1 - d] with consecutive lanes on consecutive
// d, so the D-minor stores of 16 consecutive pixels are one contiguous
// run; 1/C is applied before the single rounding to bf16.
//
// Later work: wgmma from shared memory, TMA loads of the tiles, a
// persistent grid that overlaps one tile's epilogue with the next tile's
// loads, and stores of bf16 pairs.
#include "common.cuh"

namespace sde {
namespace {

constexpr int kT = 64;              // left columns per block (the W tile)
constexpr int kTDMax = 64;          // disparities per block
constexpr int kKC = 64;             // channels staged per step
constexpr int kWarps = kT / 16;     // one m16 row tile per warp
constexpr int kPitch = kKC + 8;     // shared row pitch in bf16 (144 bytes)
constexpr int kWinRows = 128;       // >= the n8 tiles' reach, 48 + 8*9 + 8
constexpr int kNTMax = (kTDMax + 14) / 8 + 1;  // n8 tiles of a band: 10
constexpr int kGPitch = kNTMax * 8 + 4;        // fp32 pitch of the band block
constexpr int kStageBytes = (kT + kWinRows) * kPitch * 2;
constexpr int kBandBytes = kWarps * 16 * kGPitch * 4;
constexpr int kSmemBytes = kStageBytes > kBandBytes ? kStageBytes : kBandBytes;

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += A (16x16, row-major) * B (16x8, column-major), bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Copies channels [c0, c0 + kKC) of the columns [col0, col0 + ncols) of one
// row's (W, C) features into dst[ncols][kPitch], with zeros outside
// [0, W) x [0, C). `vec`: C % 8 == 0 and 16-byte aligned rows, so 8
// channels move as one 16-byte load.
__device__ __forceinline__ void stage(uint16_t* dst, const uint16_t* src,
                                      int col0, int ncols, int W, int C,
                                      int c0, bool vec) {
  if (vec) {
    constexpr int kV = kKC / 8;
    for (int i = threadIdx.x; i < ncols * kV; i += blockDim.x) {
      const int j = i / kV, v = i % kV, col = col0 + j, c = c0 + v * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (col >= 0 && col < W && c < C)
        val = *reinterpret_cast<const uint4*>(src + (long long)col * C + c);
      *reinterpret_cast<uint4*>(dst + j * kPitch + v * 8) = val;
    }
  } else {
    for (int i = threadIdx.x; i < ncols * kKC; i += blockDim.x) {
      const int j = i / kKC, k = i % kKC, col = col0 + j, c = c0 + k;
      dst[j * kPitch + k] = (col >= 0 && col < W && c < C)
                                ? src[(long long)col * C + c]
                                : static_cast<uint16_t>(0);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    correlation_gram_kernel(const uint16_t* __restrict__ fl,
                            const uint16_t* __restrict__ fr,
                            __nv_bfloat16* __restrict__ out, int W, int C,
                            int D, int TD, bool vec) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  uint16_t* sl = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sw = sl + kT * kPitch;
  const long long row = blockIdx.x;
  const int x0 = blockIdx.y * kT;
  const int d0 = blockIdx.z * TD;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;  // mma group and thread in group
  // Window row j holds right-view column r0 + j, so that
  // cost[x0 + u, d0 + dl] = G[u, u + TD - 1 - dl].
  const int r0 = x0 - d0 - (TD - 1);
  const int nt = (TD + 14) / 8 + 1;  // n8 tiles over [16i, 16i + 15 + TD - 1]
  const uint16_t* lrow = fl + row * W * C;
  const uint16_t* rrow = fr + row * W * C;

  float acc[kNTMax][4];
#pragma unroll
  for (int t = 0; t < kNTMax; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kKC) {
    __syncthreads();  // the previous chunk is consumed
    stage(sl, lrow, x0, kT, W, C, c0, vec);
    stage(sw, rrow, r0, kWinRows, W, C, c0, vec);
    __syncthreads();
    const int ksteps = (min(kKC, C - c0) + 15) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int k = ks * 16 + 2 * q;
      const uint16_t* a = sl + (warp * 16 + g) * kPitch + k;
      const uint32_t a0 = lds32(a), a1 = lds32(a + 8 * kPitch);
      const uint32_t a2 = lds32(a + 8), a3 = lds32(a + 8 * kPitch + 8);
#pragma unroll
      for (int t = 0; t < kNTMax; ++t) {
        if (t < nt) {
          const uint16_t* b = sw + (warp * 16 + t * 8 + g) * kPitch + k;
          mma_bf16(acc[t], a0, a1, a2, a3, lds32(b), lds32(b + 8));
        }
      }
    }
  }

  __syncthreads();  // every warp is done with the operands the band aliases
  float* band = reinterpret_cast<float*>(smem) + warp * 16 * kGPitch;
#pragma unroll
  for (int t = 0; t < kNTMax; ++t) {
    if (t < nt) {
      const int col = t * 8 + 2 * q;
      band[g * kGPitch + col] = acc[t][0];
      band[g * kGPitch + col + 1] = acc[t][1];
      band[(g + 8) * kGPitch + col] = acc[t][2];
      band[(g + 8) * kGPitch + col + 1] = acc[t][3];
    }
  }
  __syncwarp();
  const float inv_c = 1.f / static_cast<float>(C);
  const int td = min(TD, D - d0);  // disparities of this block
  const int xw = x0 + warp * 16;
  for (int i = lane; i < 16 * td; i += 32) {
    const int r = i / td, dl = i - r * td, x = xw + r;
    if (x < W)
      out[(row * W + x) * D + d0 + dl] =
          __float2bfloat16(band[r * kGPitch + r + TD - 1 - dl] * inv_c);
  }
}

}  // namespace
}  // namespace sde

// fl, fr (rows, W, C) and out (rows, W, D), all contiguous bfloat16;
// rows = B*H. Needs rows, W, C, D >= 1.
extern "C" int sde_correlation_gram(const void* fl, const void* fr, void* out,
                                    int rows, int W, int C, int D, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int td = std::min(D, sde::kTDMax);
  if (rows < 1 || W < 1 || C < 1 || D < 1 ||
      (W + sde::kT - 1) / sde::kT > 65535 || (D + td - 1) / td > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = C % 8 == 0 &&
                   reinterpret_cast<std::uintptr_t>(fl) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(fr) % 16 == 0;
  const dim3 grid(rows, (W + sde::kT - 1) / sde::kT, (D + td - 1) / td);
  sde::correlation_gram_kernel<<<grid, sde::kWarps * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(fl), static_cast<const uint16_t*>(fr),
      static_cast<__nv_bfloat16*>(out), W, C, D, td, vec);
  return static_cast<int>(cudaGetLastError());
}
