// conv3x3: border pad -> 3x3 stride-1 conv -> +bias -> activation, NHWC.
//
// Replaces the TPU kernel scenedepthestimation_tpu/ops/pallas/conv_block.py
// ::conv3x3_elu_pallas (the decoder ConvBlock and, with the sigmoid
// epilogue and an fp32 output, the disparity head). Borders: reflect (the
// reference's), edge, and zero (the JAX package's fast-border serving
// mode). A 1-pixel axis repeats its pixel under reflect, as jnp.pad does.
//
// What bounds it on an H100, per call of the bf16 b128 bench forward
// (mono_kitti_384x1152_bench; operations 2*9*B*H*W*Cin*Cout at 989 TFLOP/s,
// bytes = input + weights + output once at 3.35 TB/s):
//
//   call          input (H x W x Cin)  Cout  GFLOP   GB    bound ms
//   upconv_4_0      12 x   36 x 512     256    130  0.09   0.132 ops
//   upconv_4_1      24 x   72 x 512     256    522  0.34   0.528 ops
//   upconv_3_0      24 x   72 x 256     128    130  0.17   0.132 ops
//   upconv_3_1      48 x  144 x 256     128    522  0.68   0.528 ops
//   upconv_2_0      48 x  144 x 128      64    130  0.34   0.132 ops
//   upconv_2_1      96 x  288 x 128      64    522  1.36   0.528 ops
//   upconv_1_0      96 x  288 x  64      32    130  0.68   0.203 bytes
//   upconv_1_1     192 x  576 x  96      32    783  3.62   1.082 bytes
//   dispconv_0     384 x 1152 x  16       1     16  2.04   0.608 bytes
//
// and per call of the fp32 b1 decoder (mono_kitti_192x640_fp32; fp32
// operations at 67 TFLOP/s on the CUDA cores):
//
//   call          input (H x W x Cin)  Cout  GFLOP   MB    bound us
//   upconv_4_0       6 x  20 x 512     256   0.28   5.1    4.23 ops
//   upconv_4_1      12 x  40 x 512     256   1.13   6.2   16.9  ops
//   upconv_3_0      12 x  40 x 256     128   0.28   1.9    4.23 ops
//   upconv_3_1      24 x  80 x 256     128   1.13   4.1   16.9  ops
//   upconv_2_0      24 x  80 x 128      64   0.28   1.8    4.23 ops
//   upconv_2_1      48 x 160 x 128      64   1.13   6.2   16.9  ops
//   upconv_1_0      48 x 160 x  64      32   0.28   3.0    4.23 ops
//   upconv_1_1      96 x 320 x  96      32   1.70  15.8   25.4  ops
//   upconv_0_0      96 x 320 x  32      16   0.28   5.9    4.23 ops
//   upconv_0_1     192 x 640 x  16      16   0.57  15.7    8.45 ops
//   dispconv_0     192 x 640 x  16       1   0.04   8.4    2.49 bytes
//
// So the ELU levels need the bf16 tensor cores, the fp32 levels every CUDA
// core of the card although a b1 level holds few output tiles, and the
// heads nothing but the bytes moved once. Four kernels:
//
// * bf16, Cout > 1 (conv3x3_tc_kernel): an implicit GEMM on the tensor
//   cores, wgmma.mma_async m64nNk16 (bf16 in, fp32 sums) issued by two
//   warpgroups. M = a TH x 16 tile of output pixels (one tile row of 16
//   pixels is one warp's 16 rows of an m64 tile), N = a tile of TN output
//   channels (TN = 128, 64, 32 or 16 by Cout, so Cout = 32 is one tile and
//   level 1 reads its input once), K = 9 taps x Cin in chunks of 16
//   channels. Per chunk the block stages the (TH+2) x 18 halo tile of the
//   input in bf16 shared memory, its border taken from indices at load
//   time (no padded copy exists in device memory), and the chunk's 9 B
//   tiles (TN x 16 each) from a slab arranged once per module, already in
//   the core-matrix order wgmma reads (see arrange_kernel). Loads are
//   16-byte cp.async into two stages, so the next chunk is in flight while
//   the tensor cores work on this one, with one barrier per chunk. The A
//   operand comes from registers: each warp loads its 16 pixels at the
//   tap's offset in the halo tile through ldmatrix (the same tile serves
//   all 9 taps; the pixel pitch is padded by 8 bf16 so the 8 rows of an
//   ldmatrix fall in distinct banks), while the previous tap's product is
//   in flight; B is read from shared memory by the wgmma through a
//   descriptor. The epilogue adds the bias and applies the activation to
//   the fp32 sums, rounds once, stages the tile in shared memory and
//   writes it with 16-byte stores. A Cin that is not a multiple of 8
//   stages the halo with scalar loads (same tile, same sums).
// * Cout = 1 (conv3x3_head_kernel, CUDA cores, bf16 or fp32 input): 16 x 64
//   output pixels a block; the halo rows of two 16-byte channel groups
//   (16 bf16 or 8 fp32 channels) are staged once with 16-byte loads, the 9
//   taps' weights sit in shared memory as fp32, and each thread sums 4
//   neighbouring pixels of a row, reading each staged pixel once per
//   kernel row.
// * fp32, Cout > 1 (conv3x3_f32_kernel, CUDA cores, plain fp32 products,
//   no TF32, so that fp32 parity with the reference holds): an implicit
//   GEMM with 40 or 80 sums a thread (1 or 2 rows of 5 pixels by 8
//   channels), tiles of TH x 20 pixels by 128, 64, 32 or 16 channels by Cout, chunks of 8
//   input channels by cp.async into two stages, and the weights read from
//   a K-major slab arranged once per module.
//
// When the output tiles leave most of the card idle (the b1 and b2
// shapes), the input channels are split over more blocks. The bf16 kernel
// writes fp32 partial sums to a workspace and a second pass
// (conv3x3_reduce) adds the slices in a fixed order and applies the bias
// and the activation. The fp32 kernel does it in its one launch: the
// slices of a tile are resident together (a cooperative launch), write
// their partial sums, meet on the tile's counter, and each adds a share of
// the tile over all slices in slice order, so the result does not depend
// on the run. The workspace and the counters are the caller's, kept from
// call to call.
//
// Later work: TMA loads of the halo and B tiles with a warp-specialised
// producer and more stages; B in a swizzled layout; persistent blocks so
// that one tile's epilogue overlaps the next tile's loads.
#include "common.cuh"

namespace sde {
namespace {

enum Act : int { kNone = 0, kElu = 1, kRelu = 2, kSigmoid = 3 };
enum Border : int { kEdge = 0, kReflect = 1, kZero = 2 };

constexpr int kChunk = 16;  // input channels staged per step (CK)

// Source index for a padded index i in [-1, n]: reflect maps -1 -> 1 and
// n -> n-2 (for n = 1 both are 0, the pixel repeated), edge maps -1 -> 0
// and n -> n-1; zero returns -1 outside [0, n), where the tap reads 0.
// Indices further out (a ragged tile's unused halo) are clamped; their
// outputs are never stored.
__device__ __forceinline__ int border_index(int i, int n, int border) {
  if (i < 0 || i >= n) {
    if (border == kZero) return -1;
    if (border == kReflect) i = i < 0 ? -i : 2 * n - 2 - i;
    else i = i < 0 ? 0 : n - 1;
  }
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kElu) return v > 0.f ? v : expm1f(v);
  if (act == kRelu) return fmaxf(v, 0.f);
  if (act == kSigmoid) return 1.f / (1.f + expf(-v));
  return v;
}

int split_for(long long blocks, int Cin, int num_sms) {
  const int chunks = (Cin + kChunk - 1) / kChunk;
  int splits = 1;
  while (2 * splits <= chunks / 2 && blocks * splits < 2LL * num_sms) splits *= 2;
  return splits;
}

// Input channels of one slice: whole chunks, so every slice but the last
// stages full chunks.
int channels_per_split(int Cin, int splits) {
  const int chunks = (Cin + kChunk - 1) / kChunk;
  return ((chunks + splits - 1) / splits) * kChunk;
}

// out[i] = act(sum_s partial[s][i] + bias[i % Cout]), slices added in order.
template <typename T, typename OutT>
__global__ void conv3x3_reduce(const float* __restrict__ partial,
                               const T* __restrict__ bias,
                               OutT* __restrict__ out, long long n, int Cout,
                               int splits, int act) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[s * n + i];
    out[i] = from_float<OutT>(activate(v + to_float(bias[i % Cout]), act));
  }
}

template <typename T, typename OutT>
cudaError_t launch_reduce(const float* partial, const void* bias, void* out,
                          long long n, int Cout, int splits, int act,
                          cudaStream_t stream) {
  const long long blocks = std::min<long long>((n + 255) / 256, 1 << 16);
  conv3x3_reduce<T, OutT><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      partial, static_cast<const T*>(bias), static_cast<OutT*>(out), n, Cout,
      splits, act);
  return cudaGetLastError();
}

// ---- fp32, Cout > 1: implicit GEMM on the CUDA cores --------------------
//
// M = output pixels, N = Cout, K = 9 taps x Cin, as plain fp32 products (no
// TF32). A block owns a TH x 20 pixel tile by TN output channels, one
// thread a pixel group and channel group. Each thread sums PR rows (1 or 2)
// of 5 neighbouring pixels by 8 channels (cg * 4 .. +3 and TN / 2 + cg * 4
// .. +3, so that neighbouring threads read neighbouring 16-byte weight
// rows): 40 or 80 fp32 sums. Per input channel a thread reads its PR + 2
// staged rows of 7 pixels once and uses each pixel for the 3 taps of every
// kernel row that meets it: (PR + 2) x 7 words and 18 16-byte weight reads
// of shared memory for PR x 360 FMAs. Chunks of 8 input channels move by cp.async into one of two stages,
// the next chunk in flight while this one is summed, one barrier a chunk:
// the halo as 4-byte copies into one plane per channel (so any Cin works;
// the border taken from indices once per pixel), the weight rows as
// 16-byte copies from the K-major slab that each module arranges once
// (arrange_f32_kernel).

constexpr int kFPX = 5;               // pixels of a row a thread
constexpr int kFTW = 20;              // tile width: 4 pixel groups a row
constexpr int kFPG = kFTW / kFPX;     // pixel groups a row
constexpr int kFHW = kFTW + 2;        // halo width
constexpr int kFXP = 24;              // halo row pitch (floats)
constexpr int kFCK = 8;               // input channels a chunk
constexpr int kFCX = 8;               // output channels a thread

// TH x 20 pixels by TN channels a tile; PR rows of 5 pixels by 8 channels a
// thread.
template <int TN_, int TH_, int PR_>
struct FCfg {
  static constexpr int TN = TN_, TH = TH_, PR = PR_;
  static_assert(TH % PR == 0, "whole thread rows");
  static constexpr int NCG = TN / kFCX;            // channel groups
  static constexpr int NT = NCG * (TH / PR) * kFPG;  // threads
  static constexpr int J = PR * kFPX * kFCX / 4;   // 16-byte units of a thread's sums
  // One channel's halo plane, (TH + 2) rows of kFXP, and 4 floats more so
  // that the 8 planes of a pixel fall in distinct banks.
  static constexpr int PLANE = (TH + 2) * kFXP + 4;
  static constexpr int HALO = kFCK * PLANE;     // floats
  static constexpr int WT = 9 * kFCK * TN;      // floats, [tap][c][TN]
  static constexpr int STAGE = HALO + WT;
  static constexpr int SMEM = 2 * STAGE * 4;    // bytes: two stages
  static constexpr int UNITS = J * NT;  // 16-byte units of a tile's sums
};
// By Cout: > 64, (32, 64], (16, 32], <= 16: 192, 128, 128 and 128 threads.
// The heights divide the b1 levels' (6, 12, 24 at Cout > 64; 24, 48 at 64;
// 48, 96 at 32; 96, 192 at 16). Two rows a thread (80 sums) read each
// weight vector for twice the FMAs; in probe calls on an NVIDIA H100 that
// paid at each b1 shape with Cout > 64 and cost time at the narrower ones,
// whose tiles it doubles.
using FWide = FCfg<128, 6, 2>;
using FMid = FCfg<64, 4, 1>;
using FNarrow = FCfg<32, 8, 1>;
using FSlim = FCfg<16, 16, 1>;

struct FArgs {
  const float* x;     // (B, H, W, Cin)
  const float* slab;  // (9, cin_pad, cout_pad): arrange_f32_kernel's slab
  const float* bias;  // (Cout)
  float* out;         // (B, H, W, Cout)
  float* partial;     // (tiles, splits, UNITS) 16-byte units, or nullptr
  int* counters;      // one a tile, 0 between calls, or nullptr
  int B, H, W, Cin, Cout, cin_pad, cout_pad;
  int tiles_h, tiles_w, ntiles, splits, chunks_per_split, act, border;
};

// 4 bytes from device memory to shared memory without passing through
// registers; with `valid` false the word is zero-filled and nothing read.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// act(v + bias) into channels n .. n + 3 of output pixel `pix` (those below Cout).
__device__ __forceinline__ void f32_store4(const FArgs& a, size_t pix, int n, float4 v) {
  if (n >= a.Cout) return;
  float r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    r[k] = activate(r[k] + (n + k < a.Cout ? a.bias[n + k] : 0.f), a.act);
  float* d = a.out + pix * a.Cout + n;
  if (a.Cout % 4 == 0) {
    *reinterpret_cast<float4*>(d) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    for (int k = 0; k < 4 && n + k < a.Cout; ++k) d[k] = r[k];
  }
}

// grid: tiles * splits blocks, the slices of one tile adjacent; a tile is
// (b, tile row, tile column, Cout tile) with the Cout tile fastest. With one
// slice a block writes act(sums + bias). With more, each block writes its
// slice's sums to `partial`, and the slices of a tile (co-resident: the
// launch is cooperative) wait for each other on the tile's counter; then
// slice s adds the s-th share of the tile's units over all slices, in slice
// order 0 .. S-1, so the result does not depend on the run, and writes the
// output. The last block to leave resets the counter to 0.
template <class Cfg>
__global__ void __launch_bounds__(Cfg::NT) conv3x3_f32_kernel(const FArgs a) {
  constexpr int TH = Cfg::TH, TN = Cfg::TN, NCG = Cfg::NCG, NT = Cfg::NT, PR = Cfg::PR;
  extern __shared__ __align__(16) float fsmem[];

  const int tid = threadIdx.x;
  const int cg = tid % NCG, pg = tid / NCG;
  const int py = (pg / kFPG) * PR, px = (pg % kFPG) * kFPX;
  const int split = static_cast<int>(blockIdx.x % a.splits);
  const long long tile = blockIdx.x / a.splits;
  long long t = tile;
  const int nt = static_cast<int>(t % a.ntiles);
  t /= a.ntiles;
  const int tw = static_cast<int>(t % a.tiles_w);
  t /= a.tiles_w;
  const int th = static_cast<int>(t % a.tiles_h);
  const int b = static_cast<int>(t / a.tiles_h);
  const int h0 = th * TH, w0 = tw * kFTW, n0 = nt * TN;
  const int kc_lo = split * a.chunks_per_split;
  const int nk = min(a.cin_pad / kFCK, kc_lo + a.chunks_per_split) - kc_lo;
  const float* xb = a.x + (size_t)b * a.H * a.W * a.Cin;

  // Chunk kc into a stage: the halo, a thread a pixel and its 8 channels
  // (zero past Cin and where the zero border reads outside the image); then
  // the 9 x 8 weight rows, columns n0 .. n0 + TN of the slab (zero past
  // cout_pad).
  auto load_chunk = [&](int kc, float* xs) {
    const int ci0 = kc * kFCK;
    for (int pos = tid; pos < (TH + 2) * kFHW; pos += NT) {
      const int r = pos / kFHW, q = pos - r * kFHW;
      const int hs = border_index(h0 - 1 + r, a.H, a.border);
      const int wsrc = border_index(w0 - 1 + q, a.W, a.border);
      const bool inside = hs >= 0 && wsrc >= 0;
      const float* src = inside ? xb + ((size_t)hs * a.W + wsrc) * a.Cin + ci0 : a.x;
#pragma unroll
      for (int c = 0; c < kFCK; ++c) {
        const bool ok = inside && ci0 + c < a.Cin;
        cp_async4(xs + c * Cfg::PLANE + r * kFXP + q, ok ? src + c : a.x, ok);
      }
    }
    float* ws = xs + Cfg::HALO;
    constexpr int NV = TN / 4;  // 16-byte vectors of a weight row
    for (int i = tid; i < 9 * kFCK * NV; i += NT) {
      const int v = i % NV, row = i / NV;
      const int tap = row / kFCK, c = row - tap * kFCK;
      const int n = n0 + v * 4;
      const bool ok = n < a.cout_pad;
      const float* src =
          ok ? a.slab + ((size_t)tap * a.cin_pad + ci0 + c) * a.cout_pad + n : a.slab;
      cp_async16(ws + row * TN + v * 4, src, ok);
    }
  };

  float acc[PR][kFPX][kFCX];
#pragma unroll
  for (int r = 0; r < PR; ++r)
#pragma unroll
    for (int p = 0; p < kFPX; ++p)
#pragma unroll
      for (int e = 0; e < kFCX; ++e) acc[r][p][e] = 0.f;

  if (nk > 0) {
    load_chunk(kc_lo, fsmem);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<0>();
    // Chunk k has landed for every thread, and every thread is done with
    // chunk k - 1, whose stage the next load overwrites.
    __syncthreads();
    if (k + 1 < nk) {
      load_chunk(kc_lo + k + 1, fsmem + ((k + 1) & 1) * Cfg::STAGE);
      cp_async_commit();
    }
    const float* xs = fsmem + (k & 1) * Cfg::STAGE;
    const float* ws = xs + Cfg::HALO;
#pragma unroll 2
    for (int c = 0; c < kFCK; ++c) {
      const float* xc = xs + c * Cfg::PLANE + py * kFXP + px;
      // The PR staged rows that kernel row ky meets (py + ky .. py + ky +
      // PR - 1), kept as a window that moves down one row a step.
      float xv[PR][kFPX + 2];
#pragma unroll
      for (int i = 0; i < PR - 1; ++i)
#pragma unroll
        for (int j = 0; j < kFPX + 2; ++j) xv[i + 1][j] = xc[i * kFXP + j];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int i = 0; i < PR - 1; ++i)
#pragma unroll
          for (int j = 0; j < kFPX + 2; ++j) xv[i][j] = xv[i + 1][j];
#pragma unroll
        for (int j = 0; j < kFPX + 2; ++j) xv[PR - 1][j] = xc[(ky + PR - 1) * kFXP + j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wr = ws + ((ky * 3 + kx) * kFCK + c) * TN + cg * 4;
          const float4 wa = *reinterpret_cast<const float4*>(wr);
          const float4 wb = *reinterpret_cast<const float4*>(wr + TN / 2);
          const float wv[kFCX] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int r = 0; r < PR; ++r)
#pragma unroll
            for (int p = 0; p < kFPX; ++p)
#pragma unroll
              for (int e = 0; e < kFCX; ++e)
                acc[r][p][e] = fmaf(xv[r][p + kx], wv[e], acc[r][p][e]);
        }
      }
    }
  }

  // A thread's unit j holds row j / (2 * kFPX), pixel (j / 2) % kFPX of it,
  // and channels (j % 2) * TN / 2 + cg * 4 .. +3.
  if (a.splits == 1) {
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      const int h = h0 + py + r;
      if (h >= a.H) break;
#pragma unroll
      for (int p = 0; p < kFPX; ++p) {
        const int w = w0 + px + p;
        if (w >= a.W) continue;
        const size_t pix = ((size_t)b * a.H + h) * a.W + w;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          f32_store4(a, pix, n0 + half * (TN / 2) + cg * 4,
                     make_float4(acc[r][p][4 * half], acc[r][p][4 * half + 1],
                                 acc[r][p][4 * half + 2], acc[r][p][4 * half + 3]));
      }
    }
    return;
  }

  float4* slices = reinterpret_cast<float4*>(a.partial) + (size_t)tile * a.splits * Cfg::UNITS;
  float4* mine = slices + (size_t)split * Cfg::UNITS;
#pragma unroll
  for (int j = 0; j < Cfg::J; ++j) {
    const int r = j / (2 * kFPX), p = (j / 2) % kFPX, e = 4 * (j % 2);
    mine[j * NT + tid] =
        make_float4(acc[r][p][e], acc[r][p][e + 1], acc[r][p][e + 2], acc[r][p][e + 3]);
  }
  __threadfence();
  __syncthreads();
  int* cnt = a.counters + tile;
  if (tid == 0) {
    atomicAdd(cnt, 1);
    long long spins = 0;
    while (ld_acquire(cnt) < a.splits) {
      __nanosleep(64);
      if (++spins > (1LL << 27)) __trap();  // a slice never came: fail, do not hang
    }
  }
  __syncthreads();
  const int lo = static_cast<int>((long long)Cfg::UNITS * split / a.splits);
  const int hi = static_cast<int>((long long)Cfg::UNITS * (split + 1) / a.splits);
  for (int u = lo + tid; u < hi; u += NT) {
    float4 s = __ldcg(slices + u);
    for (int q = 1; q < a.splits; ++q) {
      const float4 v = __ldcg(slices + (size_t)q * Cfg::UNITS + u);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int j = u / NT, ut = u - j * NT;
    const int upg = ut / NCG, ucg = ut - upg * NCG;
    const int h = h0 + (upg / kFPG) * PR + j / (2 * kFPX);
    const int w = w0 + (upg % kFPG) * kFPX + (j / 2) % kFPX;
    if (h >= a.H || w >= a.W) continue;
    f32_store4(a, ((size_t)b * a.H + h) * a.W + w, n0 + (j % 2) * (TN / 2) + ucg * 4, s);
  }
  // Every slice has arrived (2 * splits - 1 increments before this one):
  // the counter goes back to 0 for the next call.
  if (tid == 0 && atomicAdd(cnt, 1) == 2 * a.splits - 1) *cnt = 0;
}

// The fp32 slab, K-major: slab[(tap * cin_pad + k) * cout_pad + n] =
// w[n][k][tap], zero past Cin and Cout.
__global__ void arrange_f32_kernel(const float* __restrict__ w, float* __restrict__ slab,
                                   int Cin, int Cout, int cin_pad, int cout_pad) {
  const long long n = 9LL * cin_pad * cout_pad;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int o = static_cast<int>(i % cout_pad);
    const int k = static_cast<int>((i / cout_pad) % cin_pad);
    const int tap = static_cast<int>(i / ((long long)cout_pad * cin_pad));
    slab[i] = (o < Cout && k < Cin) ? w[((size_t)o * Cin + k) * 9 + tap] : 0.f;
  }
}

// How an fp32 call runs: the tiles and the input-channel slices.
struct FPlan {
  int tiles_h, tiles_w, ntiles, splits, chunks_per_split;
  long long tiles;
};

// Co-resident blocks of conv3x3_f32_kernel<Cfg> on `device` (the current
// one), asked of the runtime once per device.
template <class Cfg>
cudaError_t f32_capacity(int device, int* cap) {
  static int cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    const auto kernel = &conv3x3_f32_kernel<Cfg>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Cfg::NT, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[device] = per_sm * sms;
  }
  *cap = cached[device];
  return cudaSuccess;
}

// The input channels are split when the tiles would leave at least half of
// the co-resident blocks idle. The slice count is the one whose busiest SM
// takes the least time, fewer slices on a tie, with the blocks never more
// than the co-resident ones. An SM's time is counted as its blocks' chunks
// (a block of S > 1 slices also adds a share of its tile, about half a
// chunk's time) over their rate, taken as full from 8 warps on and in
// proportion below (the FMAs wait on shared-memory loads that fewer warps
// do not hide).
template <class Cfg>
FPlan f32_plan(int B, int H, int W, int Cin, int Cout, int cap, int sms) {
  FPlan p{};
  p.tiles_h = (H + Cfg::TH - 1) / Cfg::TH;
  p.tiles_w = (W + kFTW - 1) / kFTW;
  p.ntiles = (Cout + Cfg::TN - 1) / Cfg::TN;
  p.tiles = (long long)B * p.tiles_h * p.tiles_w * p.ntiles;
  const int chunks = (Cin + kFCK - 1) / kFCK;
  // Half-chunks of time on the busiest SM, x 8 warps.
  auto cost = [&](int s, int cps) {
    const long long per_sm = (p.tiles * s + sms - 1) / sms;
    const long long warps = std::min<long long>(8, per_sm * Cfg::NT / 32);
    return per_sm * (2 * cps + (s > 1 ? 1 : 0)) * 8 / warps;
  };
  p.splits = 1;
  p.chunks_per_split = chunks;
  if (2 * p.tiles <= cap) {
    long long best = cost(1, chunks);
    for (int cps = chunks - 1; cps >= 1; --cps) {
      const int s = (chunks + cps - 1) / cps;
      if (p.tiles * s > cap) break;
      const long long c = cost(s, cps);
      if (c < best) {
        best = c;
        p.splits = s;
        p.chunks_per_split = cps;
      }
    }
  }
  return p;
}

// Calls f with the fp32 tile configuration for Cout.
template <typename F>
auto with_f32_cfg(int Cout, F f) {
  if (Cout <= 16) return f(FSlim{});
  if (Cout <= 32) return f(FNarrow{});
  if (Cout <= 64) return f(FMid{});
  return f(FWide{});
}

// plan: {splits, workspace floats, counters} of an fp32 call with Cout > 1.
cudaError_t f32_plan_for(int B, int H, int W, int Cin, int Cout, int device, FPlan* fp,
                         long long* plan) {
  return with_f32_cfg(Cout, [&](auto cfg) {
    using Cfg = decltype(cfg);
    int cap = 0, sms = 0;
    cudaError_t err = f32_capacity<Cfg>(device, &cap);
    if (err != cudaSuccess) return err;
    err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    *fp = f32_plan<Cfg>(B, H, W, Cin, Cout, cap, sms);
    const bool split = fp->splits > 1;
    plan[0] = fp->splits;
    plan[1] = split ? fp->tiles * fp->splits * Cfg::UNITS * 4 : 0;
    plan[2] = split ? fp->tiles : 0;
    return cudaSuccess;
  });
}

// One launch: cooperative when the input channels are split, so that the
// slices of a tile are resident together.
cudaError_t launch_f32(FArgs a, const FPlan& fp, cudaStream_t stream) {
  return with_f32_cfg(a.Cout, [&](auto cfg) {
    using Cfg = decltype(cfg);
    a.tiles_h = fp.tiles_h;
    a.tiles_w = fp.tiles_w;
    a.ntiles = fp.ntiles;
    a.splits = fp.splits;
    a.chunks_per_split = fp.chunks_per_split;
    const long long blocks = fp.tiles * fp.splits;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    cudaLaunchConfig_t cfg_ = {};
    cfg_.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg_.blockDim = dim3(Cfg::NT);
    cfg_.dynamicSmemBytes = Cfg::SMEM;
    cfg_.stream = stream;
    cudaLaunchAttribute coop;
    coop.id = cudaLaunchAttributeCooperative;
    coop.val.cooperative = 1;
    cfg_.attrs = &coop;
    cfg_.numAttrs = fp.splits > 1 ? 1 : 0;
    return cudaLaunchKernelEx(&cfg_, conv3x3_f32_kernel<Cfg>, a);
  });
}

// ---- bf16, Cout > 1: implicit GEMM on the tensor cores ------------------

constexpr int kTcThreads = 256;    // two warpgroups
constexpr int kTW = 16;            // tile width: one m16 fragment is one tile row
constexpr int kHW = kTW + 2;       // halo width
constexpr int kXP = kChunk + 8;    // halo pixel pitch (bf16): ldmatrix rows in distinct banks

// Two warpgroups, each MT m64 tiles (4 tile rows of 16 pixels each) by TN
// output channels: TH = 8 * MT tile rows a block.
template <int MT_, int TN_>
struct TcCfg {
  static constexpr int MT = MT_, TN = TN_;
  static constexpr int TH = 8 * MT;
  // Blocks an SM: two while a thread's sums fit in 64 registers.
  static constexpr int MINB = MT * TN / 2 > 64 ? 1 : 2;
  static constexpr int HALO = (TH + 2) * kHW * kXP;  // halo stage (bf16)
  static constexpr int BTAP = TN * kChunk;           // one tap's B tile (bf16)
  static constexpr int STAGE = HALO + 9 * BTAP;
  static constexpr int PIPE_BYTES = 2 * STAGE * 2;   // two stages
  static constexpr int OUT_BYTES = TH * kTW * (TN + 4) * 4;  // fp32 staging
  static constexpr int SMEM = PIPE_BYTES > OUT_BYTES ? PIPE_BYTES : OUT_BYTES;
};
// By Cout: > 64, (32, 64], (16, 32], <= 16. Each thread holds 64 fp32 sums
// (32 for the last); two blocks an SM. On the bench's calls neither twice
// the rows a block at one block an SM nor three taps' fragments in flight
// instead of two ran faster (probe calls on an NVIDIA H100).
using TcWide = TcCfg<1, 128>;
using TcMid = TcCfg<2, 64>;
using TcNarrow = TcCfg<4, 32>;
using TcSlim = TcCfg<4, 16>;

struct TcArgs {
  const uint16_t* x;     // (B, H, W, Cin) bf16
  const uint16_t* slab;  // sde_conv3x3_arrange's slab, bf16
  const __nv_bfloat16* bias;
  void* out;             // (B, H, W, Cout) bf16 or fp32
  float* partial;        // (splits, B, H, W, Cout) fp32, or nullptr
  int B, H, W, Cin, Cout, cin_pad, cout_pad;
  int tiles_h, tiles_w, ntiles, splits, ci_per_split, act, border;
};

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Bias + activation on the fp32 sums (skipped for a partial sum), one
// rounding to E, the tile staged in shared memory, then 16-byte stores of
// the pixels inside the image. acc[i] holds tile row rows[i]'s 16 pixels
// by the block's TN channels; `dst` is the (B, H, W, Cout) tensor of E.
template <class Cfg, typename E, int NI, int R>
__device__ __forceinline__ void tc_epilogue(const float (&acc)[NI][R],
                                            const int (&rows)[NI],
                                            unsigned char* smem, const TcArgs& a,
                                            E* dst, bool raw, int b, int h0,
                                            int w0, int n0) {
  constexpr int P = Cfg::TN + (sizeof(E) == 4 ? 4 : 8);  // staging pitch
  E* st = reinterpret_cast<E*>(smem);
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int col = j * 8 + 2 * q;
    const int n = n0 + col;
    float b0 = 0.f, b1 = 0.f;
    if (!raw) {
      b0 = n < a.Cout ? __bfloat162float(a.bias[n]) : 0.f;
      b1 = n + 1 < a.Cout ? __bfloat162float(a.bias[n + 1]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = rows[i] * kTW + g + 8 * hh;
        float v0 = acc[i][4 * j + 2 * hh] + b0, v1 = acc[i][4 * j + 2 * hh + 1] + b1;
        if (!raw) {
          v0 = activate(v0, a.act);
          v1 = activate(v1, a.act);
        }
        if constexpr (sizeof(E) == 4) {
          *reinterpret_cast<float2*>(st + m * P + col) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<uint32_t*>(st + m * P + col) = pack_bf16x2(v0, v1);
        }
      }
  }
  __syncthreads();
  constexpr int VE = 16 / sizeof(E);  // elements a 16-byte vector
  constexpr int NV = Cfg::TN / VE;
  const bool vec = a.Cout % VE == 0;
  for (int i = threadIdx.x; i < Cfg::TH * kTW * NV; i += kTcThreads) {
    const int m = i / NV, v = i - (i / NV) * NV;
    const int h = h0 + m / kTW, w = w0 + m % kTW, n = n0 + v * VE;
    if (h >= a.H || w >= a.W || n >= a.Cout) continue;
    E* d = dst + (((size_t)b * a.H + h) * a.W + w) * a.Cout + n;
    const E* s = st + m * P + v * VE;
    if (vec) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = 0; e < VE && n + e < a.Cout; ++e) d[e] = s[e];
    }
  }
}

// grid: B * splits * tiles_h * tiles_w * ntiles blocks, the Cout tiles of
// one pixel tile adjacent (they read the same halo). kVec: Cin % 8 == 0 and
// x 16-byte aligned, so the halo moves as 16-byte cp.async.
template <class Cfg, typename OutT, bool kVec>
__global__ void __launch_bounds__(kTcThreads, Cfg::MINB) conv3x3_tc_kernel(const TcArgs a) {
  constexpr int TH = Cfg::TH, TN = Cfg::TN, MT = Cfg::MT;
  constexpr int NPOS = (TH + 2) * kHW;  // halo pixels
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  uint16_t* smem = reinterpret_cast<uint16_t*>(dyn_smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long blk = blockIdx.x;
  const int nt = static_cast<int>(blk % a.ntiles);
  blk /= a.ntiles;
  const int ntile = a.tiles_h * a.tiles_w;
  const int tile = static_cast<int>(blk % ntile);
  blk /= ntile;
  const int split = static_cast<int>(blk % a.splits);
  const int b = static_cast<int>(blk / a.splits);
  const int h0 = (tile / a.tiles_w) * TH, w0 = (tile % a.tiles_w) * kTW;
  const int n0 = nt * TN;
  const int ci_lo = split * a.ci_per_split;
  const int ci_hi = min(a.Cin, ci_lo + a.ci_per_split);
  const int nchunks = (ci_hi - ci_lo + kChunk - 1) / kChunk;
  const uint16_t* xb = a.x + (size_t)b * a.H * a.W * a.Cin;
  const int ngroups = a.cout_pad / 8;  // column groups of the slab

  // Chunk [ci0, ci0 + 16) into a stage: the halo tile (zero past ci_hi and
  // where the zero border reads outside the image), then the 9 taps' B
  // tiles, each TN x 16 and contiguous in the slab (zero past cout_pad).
  auto load_chunk = [&](int ci0, uint16_t* hs) {
    if constexpr (kVec) {
      for (int i = tid; i < NPOS * 2; i += kTcThreads) {
        const int pos = i >> 1, half = i & 1;
        const int r = pos / kHW, c = pos - (pos / kHW) * kHW;
        const int hsrc = border_index(h0 - 1 + r, a.H, a.border);
        const int wsrc = border_index(w0 - 1 + c, a.W, a.border);
        const int ch = ci0 + half * 8;
        const bool ok = hsrc >= 0 && wsrc >= 0 && ch < ci_hi;
        const uint16_t* src = ok ? xb + ((size_t)hsrc * a.W + wsrc) * a.Cin + ch : a.x;
        cp_async16(hs + pos * kXP + half * 8, src, ok);
      }
    } else {
      for (int i = tid; i < NPOS * kChunk; i += kTcThreads) {
        const int pos = i / kChunk, cc = i - (i / kChunk) * kChunk;
        const int r = pos / kHW, c = pos - (pos / kHW) * kHW;
        const int hsrc = border_index(h0 - 1 + r, a.H, a.border);
        const int wsrc = border_index(w0 - 1 + c, a.W, a.border);
        uint16_t v = 0;
        if (hsrc >= 0 && wsrc >= 0 && ci0 + cc < ci_hi)
          v = xb[((size_t)hsrc * a.W + wsrc) * a.Cin + ci0 + cc];
        hs[pos * kXP + cc] = v;
      }
    }
    uint16_t* bs = hs + Cfg::HALO;
    constexpr int NV = Cfg::BTAP / 8;  // 16-byte vectors of one tap
    const int kc = ci0 / kChunk;
    for (int i = tid; i < 9 * NV; i += kTcThreads) {
      const int tap = i / NV, v = i - (i / NV) * NV;
      const int group = n0 / 8 + v / 16;  // 16 vectors a column group
      const bool ok = group < ngroups;
      const uint16_t* src =
          ok ? a.slab + (((size_t)tap * (a.cin_pad / kChunk) + kc) * ngroups + n0 / 8) * 128 + v * 8
             : a.slab;
      cp_async16(bs + tap * Cfg::BTAP + v * 8, src, ok);
    }
  };

  // Warp wq of warpgroup wg takes tile row wg * 4 * MT + 4 * i + wq of its
  // m64 tile i.
  const int wg = warp >> 2, wq = warp & 3;
  int rows[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) rows[i] = wg * 4 * MT + 4 * i + wq;

  float acc[MT][TN / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < TN / 2; ++e) acc[i][e] = 0.f;

  if (nchunks > 0) {
    load_chunk(ci_lo, smem);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<0>();
    // The B tiles are read by wgmma through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // Chunk c has landed for every thread, and every warpgroup is done
    // with chunk c - 1, whose stage the next load overwrites.
    __syncthreads();
    if (c + 1 < nchunks) {
      load_chunk(ci_lo + (c + 1) * kChunk, smem + ((c + 1) & 1) * Cfg::STAGE);
      cp_async_commit();
    }
    const uint16_t* hs = smem + (c & 1) * Cfg::STAGE;
    const uint64_t desc0 = b_desc(hs + Cfg::HALO);
    // A fragments of kABuf taps: kABuf - 1 taps' products in flight while
    // the next tap's fragments load.
    constexpr int kABuf = 2;
    uint32_t af[kABuf][MT][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[tap % kABuf][i],
                hs + ((rows[i] + ky) * kHW + kx + (lane & 15)) * kXP + (lane >> 4) * 8);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < MT; ++i)
        wgmma_rs<TN>(acc[i], af[tap % kABuf][i], desc0 + ((tap * Cfg::BTAP * 2) >> 4));
      wgmma_commit();
      // The oldest tap's products are done: only now may its fragment
      // registers take the next tap's loads. (wgmma reads them after the
      // instruction issues, which the compiler does not know.)
      wgmma_wait<kABuf - 1>();
      if (tap >= kABuf - 1) {
#pragma unroll
        for (int i = 0; i < MT; ++i) keep_live(af[(tap - (kABuf - 1)) % kABuf][i]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < kABuf; ++t)
#pragma unroll
      for (int i = 0; i < MT; ++i) keep_live(af[t][i]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) fence_operand(acc[i]);
  __syncthreads();  // the staging below reuses the stages

  if (a.partial != nullptr) {
    tc_epilogue<Cfg, float>(acc, rows, dyn_smem, a,
                            a.partial + (size_t)split * a.B * a.H * a.W * a.Cout,
                            true, b, h0, w0, n0);
  } else {
    tc_epilogue<Cfg, OutT>(acc, rows, dyn_smem, a, static_cast<OutT*>(a.out), false,
                           b, h0, w0, n0);
  }
}

template <class Cfg>
void tc_tiles(TcArgs& a) {
  a.tiles_h = (a.H + Cfg::TH - 1) / Cfg::TH;
  a.tiles_w = (a.W + kTW - 1) / kTW;
  a.ntiles = (a.Cout + Cfg::TN - 1) / Cfg::TN;
}

// Calls f with the tile configuration for Cout.
template <typename F>
auto with_tc_cfg(int Cout, F f) {
  if (Cout <= 16) return f(TcSlim{});
  if (Cout <= 32) return f(TcNarrow{});
  if (Cout <= 64) return f(TcMid{});
  return f(TcWide{});
}

template <class Cfg, typename OutT>
cudaError_t launch_tc(TcArgs a, cudaStream_t stream) {
  tc_tiles<Cfg>(a);
  a.ci_per_split = channels_per_split(a.Cin, a.splits);
  const long long blocks =
      (long long)a.B * a.splits * a.tiles_h * a.tiles_w * a.ntiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const bool vec = a.Cin % 8 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  auto kernel = vec ? &conv3x3_tc_kernel<Cfg, OutT, true> : &conv3x3_tc_kernel<Cfg, OutT, false>;
  // Above 48 KB of dynamic shared memory a kernel needs this, per device.
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kTcThreads, Cfg::SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return launch_reduce<__nv_bfloat16, OutT>(a.partial, a.bias, a.out,
                                            (long long)a.B * a.H * a.W * a.Cout,
                                            a.Cout, a.splits, a.act, stream);
}

template <typename OutT>
cudaError_t dispatch_tc(const TcArgs& a, cudaStream_t stream) {
  return with_tc_cfg(a.Cout, [&](auto cfg) {
    return launch_tc<decltype(cfg), OutT>(a, stream);
  });
}

// Output blocks of the tensor-core kernel for this shape (splits not counted).
long long tc_blocks(int B, int H, int W, int Cout) {
  TcArgs a{};
  a.H = H;
  a.W = W;
  a.Cout = Cout;
  with_tc_cfg(Cout, [&](auto cfg) { tc_tiles<decltype(cfg)>(a); return 0; });
  return (long long)B * a.tiles_h * a.tiles_w * a.ntiles;
}

// The slab in the B tiles' order: for each tap, chunk of 16 input channels
// kc and group of 8 output channels nb, the 16 x 8 block as two 8 x 8 core
// matrices (k 0-7, then 8-15), each 8 rows n of 8 k values:
// slab[(((tap * KC + kc) * NB + nb) * 2 + kb) * 64 + n8 * 8 + k8] =
// w[nb * 8 + n8][kc * 16 + kb * 8 + k8][tap], zero past Cin and Cout.
__global__ void arrange_kernel(const uint16_t* __restrict__ w,
                               uint16_t* __restrict__ slab, int Cin, int Cout,
                               int cin_pad, int cout_pad) {
  const long long n = 9LL * cin_pad * cout_pad;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int groups = cout_pad / 8, chunks = cin_pad / kChunk;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int k8 = static_cast<int>(i % 8), n8 = static_cast<int>((i / 8) % 8);
    const int kb = static_cast<int>((i / 64) % 2);
    const long long blk = i / 128;  // (tap, kc, nb)
    const int nb = static_cast<int>(blk % groups);
    const int kc = static_cast<int>((blk / groups) % chunks);
    const int tap = static_cast<int>(blk / ((long long)groups * chunks));
    const int o = nb * 8 + n8, k = kc * kChunk + kb * 8 + k8;
    slab[i] = (o < Cout && k < Cin) ? w[((size_t)o * Cin + k) * 9 + tap] : uint16_t(0);
  }
}

// ---- Cout = 1: the disparity head on the CUDA cores ---------------------

constexpr int kHdTH = 16;  // output rows a block
constexpr int kHdTW = 64;  // output columns a block
constexpr int kHdPX = 4;   // neighbouring pixels of a row a thread
// Halo row pitch in 16-byte channel groups: odd, so the 8 threads of a
// quarter warp (8 consecutive rows, one column) hit distinct banks.
constexpr int kHdPitch = kHdTW + 3;
static_assert(kHdTH * (kHdTW / kHdPX) == 256, "one thread per 4 pixels");

// The values of a staged 16-byte channel group: 8 bf16 or 4 fp32.
__device__ __forceinline__ void group_to_float(const uint4 v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void group_to_float(const uint4 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

// The storage word of an element.
template <typename T> struct Bits;
template <> struct Bits<float> { using type = uint32_t; };
template <> struct Bits<__nv_bfloat16> { using type = uint16_t; };

// grid: B * tiles_h * tiles_w. x, w and bias in T (bf16 or fp32); chunks of
// two 16-byte channel groups (16 bf16 or 8 fp32 channels). kVec: Cin a
// multiple of a group and x 16-byte aligned.
template <typename T, typename OutT, bool kVec>
__global__ void __launch_bounds__(256) conv3x3_head_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    OutT* __restrict__ out, int H, int W, int Cin, int tiles_h, int tiles_w, int act,
    int border) {
  using Word = typename Bits<T>::type;
  constexpr int VG = 16 / sizeof(T);  // channels a group
  constexpr int CH = 2 * VG;          // channels a chunk
  __shared__ uint4 xs[2][kHdTH + 2][kHdPitch];  // [channel group][row][column]
  __shared__ float ws[9][CH];

  const int tid = threadIdx.x;
  const int r = tid % kHdTH, cx = (tid / kHdTH) * kHdPX;
  const long long blk = blockIdx.x;
  const int tw = static_cast<int>(blk % tiles_w);
  const int th = static_cast<int>((blk / tiles_w) % tiles_h);
  const long long b = blk / ((long long)tiles_w * tiles_h);
  const int h0 = th * kHdTH, w0 = tw * kHdTW;
  const Word* xb = reinterpret_cast<const Word*>(x) + (size_t)b * H * W * Cin;

  float acc[kHdPX] = {0.f, 0.f, 0.f, 0.f};
  for (int ci0 = 0; ci0 < Cin; ci0 += CH) {
    __syncthreads();  // the previous chunk's reads are done
    constexpr int NPOS = (kHdTH + 2) * (kHdTW + 2);
    for (int i = tid; i < NPOS * 2; i += 256) {
      const int grp = i & 1, pos = i >> 1;
      const int rr = pos / (kHdTW + 2), cc = pos - rr * (kHdTW + 2);
      const int hsrc = border_index(h0 - 1 + rr, H, border);
      const int wsrc = border_index(w0 - 1 + cc, W, border);
      const int ch = ci0 + grp * VG;
      union {
        uint4 v;
        Word e[VG];
      } g;
      g.v = make_uint4(0u, 0u, 0u, 0u);
      if (hsrc >= 0 && wsrc >= 0 && ch < Cin) {
        const Word* p = xb + ((size_t)hsrc * W + wsrc) * Cin + ch;
        if constexpr (kVec) {
          g.v = *reinterpret_cast<const uint4*>(p);
        } else {
#pragma unroll
          for (int k = 0; k < VG; ++k) g.e[k] = ch + k < Cin ? p[k] : Word(0);
        }
      }
      xs[grp][rr][cc] = g.v;
    }
    for (int i = tid; i < 9 * CH; i += 256) {
      const int tap = i / CH, c = i % CH;
      ws[tap][c] = ci0 + c < Cin ? to_float(w[(size_t)(ci0 + c) * 9 + tap]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int grp = 0; grp < 2; ++grp)
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float xv[kHdPX + 2][VG];
#pragma unroll
        for (int j = 0; j < kHdPX + 2; ++j) group_to_float(xs[grp][r + ky][cx + j], xv[j]);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int c = 0; c < VG; ++c) {
            const float wv = ws[ky * 3 + kx][grp * VG + c];
#pragma unroll
            for (int p = 0; p < kHdPX; ++p) acc[p] = fmaf(xv[p + kx][c], wv, acc[p]);
          }
      }
  }

  const int h = h0 + r;
  if (h >= H) return;
  const float bv = to_float(bias[0]);
  OutT* dst = out + ((size_t)b * H + h) * W + w0 + cx;
  float v[kHdPX];
#pragma unroll
  for (int p = 0; p < kHdPX; ++p) v[p] = activate(acc[p] + bv, act);
  if constexpr (sizeof(OutT) == 4) {
    if (W % 4 == 0 && w0 + cx + kHdPX <= W) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
#pragma unroll
  for (int p = 0; p < kHdPX; ++p)
    if (w0 + cx + p < W) dst[p] = from_float<OutT>(v[p]);
}

template <typename T, typename OutT>
cudaError_t launch_head(const void* x, const void* w, const void* bias, void* out,
                        int B, int H, int W, int Cin, int act, int border,
                        cudaStream_t stream) {
  const int tiles_h = (H + kHdTH - 1) / kHdTH;
  const int tiles_w = (W + kHdTW - 1) / kHdTW;
  const long long blocks = (long long)B * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const bool vec = Cin % (16 / sizeof(T)) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto kernel = vec ? &conv3x3_head_kernel<T, OutT, true> : &conv3x3_head_kernel<T, OutT, false>;
  kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<OutT*>(out), H, W, Cin, tiles_h, tiles_w, act, border);
  return cudaGetLastError();
}

// plan: {input-channel slices, fp32 workspace elements, int32 counters} of
// a call on `device` (the current one); fp: the fp32 body's tiling.
cudaError_t plan_call(int B, int H, int W, int Cin, int Cout, int dtype, int device,
                      long long* plan, FPlan* fp) {
  plan[0] = 1;
  plan[1] = 0;
  plan[2] = 0;
  if (Cout == 1) return cudaSuccess;  // the head kernel does not split
  if (dtype == kFloat32) return f32_plan_for(B, H, W, Cin, Cout, device, fp, plan);
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  plan[0] = split_for(tc_blocks(B, H, W, Cout), Cin, sms);
  plan[1] = plan[0] > 1 ? plan[0] * B * H * W * (long long)Cout : 0;
  return cudaSuccess;
}

}  // namespace
}  // namespace sde

// How sde_conv3x3 runs this shape on `device`: plan[0] the input-channel
// slices, plan[1] the fp32 workspace it needs (elements), plan[2] the
// counters it needs (int32, zero before the first call; each call leaves
// them zero). The SM count and the kernels' occupancy are asked of the
// runtime once per device.
extern "C" int sde_conv3x3_plan(int B, int H, int W, int Cin, int Cout, int dtype, int device,
                                long long* plan) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  sde::FPlan fp{};
  return static_cast<int>(sde::plan_call(B, H, W, Cin, Cout, dtype, device, plan, &fp));
}

// The weight slab of the kernels with Cout > 1, in one launch; the wrapper
// makes it once per weight. bf16: w (Cout, Cin, 3, 3) -> (9, round_up(Cin,
// 16), round_up(Cout, 8)) in the tensor-core path's core-matrix order
// (arrange_kernel). fp32: -> (9, round_up(Cin, 8), round_up(Cout, 4)),
// K-major (arrange_f32_kernel). Zero-padded.
extern "C" int sde_conv3x3_arrange(const void* w, void* slab, int Cin, int Cout, int dtype,
                                   int device, void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool f32 = dtype == sde::kFloat32;
  const int cin_pad = sde::round_up(Cin, f32 ? sde::kFCK : sde::kChunk);
  const int cout_pad = sde::round_up(Cout, f32 ? 4 : 8);
  const long long n = 9LL * cin_pad * cout_pad;
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((n + 255) / 256, 1 << 16));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    sde::arrange_f32_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(w),
                                                    static_cast<float*>(slab), Cin, Cout,
                                                    cin_pad, cout_pad);
  } else {
    sde::arrange_kernel<<<blocks, 256, 0, s>>>(static_cast<const uint16_t*>(w),
                                               static_cast<uint16_t*>(slab), Cin, Cout,
                                               cin_pad, cout_pad);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (B, H, W, Cin), w (Cout, Cin, 3, 3) and bias (Cout) in `dtype`; out
// (B, H, W, Cout) in `dtype`, or float32 when out_f32 is set. All
// contiguous. slab: sde_conv3x3_arrange's slab of w, read when Cout > 1
// (unused otherwise). act: 0 none, 1 elu, 2 relu, 3 sigmoid. border: 0
// edge, 1 reflect, 2 zero. workspace (ws_elems fp32) and counters
// (n_counters int32, all 0) at least the sizes sde_conv3x3_plan names;
// they are the caller's, reused from call to call: calls that share them
// must run one after another (on one stream).
extern "C" int sde_conv3x3(const void* x, const void* w, const void* slab, const void* bias,
                           void* out, void* workspace, long long ws_elems, void* counters,
                           long long n_counters, int B, int H, int W, int Cin, int Cout,
                           int dtype, int out_f32, int act, int border, int device,
                           void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long plan[3];
  sde::FPlan fp{};
  err = sde::plan_call(B, H, W, Cin, Cout, dtype, device, plan, &fp);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ws_elems < plan[1] || n_counters < plan[2] || (plan[1] > 0 && workspace == nullptr) ||
      (plan[2] > 0 && counters == nullptr) || (Cout > 1 && slab == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = static_cast<int>(plan[0]);
  float* ws = static_cast<float*>(workspace);
  if (Cout == 1) {
    if (dtype == sde::kFloat32)
      err = sde::launch_head<float, float>(x, w, bias, out, B, H, W, Cin, act, border, s);
    else if (out_f32)
      err = sde::launch_head<__nv_bfloat16, float>(x, w, bias, out, B, H, W, Cin, act, border, s);
    else
      err = sde::launch_head<__nv_bfloat16, __nv_bfloat16>(x, w, bias, out, B, H, W, Cin, act,
                                                           border, s);
  } else if (dtype == sde::kFloat32) {
    sde::FArgs a{};
    a.x = static_cast<const float*>(x);
    a.slab = static_cast<const float*>(slab);
    a.bias = static_cast<const float*>(bias);
    a.out = static_cast<float*>(out);
    a.partial = splits > 1 ? ws : nullptr;
    a.counters = splits > 1 ? static_cast<int*>(counters) : nullptr;
    a.B = B;
    a.H = H;
    a.W = W;
    a.Cin = Cin;
    a.Cout = Cout;
    a.cin_pad = sde::round_up(Cin, sde::kFCK);
    a.cout_pad = sde::round_up(Cout, 4);
    a.act = act;
    a.border = border;
    err = sde::launch_f32(a, fp, s);
  } else {
    sde::TcArgs a{};
    a.x = static_cast<const uint16_t*>(x);
    a.slab = static_cast<const uint16_t*>(slab);
    a.bias = static_cast<const __nv_bfloat16*>(bias);
    a.out = out;
    a.partial = splits > 1 ? ws : nullptr;
    a.B = B;
    a.H = H;
    a.W = W;
    a.Cin = Cin;
    a.Cout = Cout;
    a.cin_pad = sde::round_up(Cin, sde::kChunk);
    a.cout_pad = sde::round_up(Cout, 8);
    a.splits = splits;
    a.act = act;
    a.border = border;
    err = out_f32 ? sde::dispatch_tc<float>(a, s) : sde::dispatch_tc<__nv_bfloat16>(a, s);
  }
  return static_cast<int>(err);
}
