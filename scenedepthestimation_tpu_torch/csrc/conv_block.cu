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
// So the ELU levels need the bf16 tensor cores and the head needs nothing
// but the bytes moved once. Three kernels:
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
// * bf16, Cout = 1 (conv3x3_head_kernel, CUDA cores): 16 x 64 output
//   pixels a block; the halo rows of 16 channels are staged once with
//   16-byte loads, the 9 x 16 weights sit in shared memory as fp32, and
//   each thread sums 4 neighbouring pixels of a row, reading each staged
//   pixel once per kernel row.
// * fp32 (conv3x3_kernel, CUDA cores, no TF32, so that fp32 parity with
//   the reference holds): each thread keeps PX pixels x CX channels in
//   fp32 registers over chunks of 16 staged input channels.
//
// When the output tiles are fewer than two waves of blocks (b1 and b2
// shapes), the input channels are split over more blocks: each writes an
// fp32 partial sum to a workspace the wrapper allocates, and a second pass
// adds the slices in a fixed order (results do not depend on the run) and
// applies the bias and the activation.
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

// ---- fp32: CUDA cores ---------------------------------------------------

// Tile shape by output width: every choice uses 256 threads and stays under
// the 48 KB of static shared memory.
struct Tile {
  int th, tw, tc;
};

Tile tile_for(int cout) {
  if (cout == 1) return {16, 32, 1};
  if (cout <= 16) return {16, 16, 16};
  if (cout <= 32) return {8, 16, 32};
  return {4, 16, 64};
}

// grid: (tiles, Cout tiles, B * splits). With partial == nullptr the block
// owns all input channels and writes act(acc + bias) to out; otherwise it
// writes its slice's raw sum to partial (splits, B, H, W, Cout).
template <int TH, int TW, int TC, int CX, int PX>
__global__ void __launch_bounds__((TC / CX) * (TH * TW / PX))
    conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   float* __restrict__ partial, int B, int H, int W, int Cin,
                   int Cout, int tiles_w, int splits, int ci_per_split,
                   int act, int border) {
  constexpr int CK = kChunk;
  constexpr int NCG = TC / CX;        // channel groups
  constexpr int NPG = TH * TW / PX;   // pixel groups
  constexpr int NT = NCG * NPG;       // threads
  constexpr int HH = TH + 2;
  constexpr int WW = TW + 2;
  static_assert(TW % PX == 0, "a thread's pixels lie in one row");
  static_assert(TC % CX == 0, "channel groups tile TC");

  __shared__ float xs[CK][HH][WW];
  __shared__ __align__(16) float ws[9][CK][TC];

  const int tid = threadIdx.x;
  const int cg = tid % NCG;
  const int pg = tid / NCG;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TC;
  const int split = blockIdx.z % splits;
  const int b = blockIdx.z / splits;
  const int ci_lo = split * ci_per_split;
  const int ci_hi = min(Cin, ci_lo + ci_per_split);
  const int py = (pg * PX) / TW;
  const int px = (pg * PX) % TW;

  float acc[PX][CX];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int k = 0; k < CX; ++k) acc[j][k] = 0.f;

  const float* xb = x + (size_t)b * H * W * Cin;

  for (int ci0 = ci_lo; ci0 < ci_hi; ci0 += CK) {
    // Halo tile of this channel chunk; channels fastest so neighbouring
    // threads read neighbouring addresses of one NHWC pixel.
    for (int e = tid; e < HH * WW * CK; e += NT) {
      const int c = e % CK;
      const int pix = e / CK;
      const int r = pix / WW;
      const int q = pix % WW;
      const int hs = border_index(h0 - 1 + r, H, border);
      const int wsrc = border_index(w0 - 1 + q, W, border);
      float v = 0.f;
      if (ci0 + c < ci_hi && hs >= 0 && wsrc >= 0)
        v = xb[((size_t)hs * W + wsrc) * Cin + ci0 + c];
      xs[c][r][q] = v;
    }
    // Weights (Cout, Cin, 3, 3): tap fastest, so the reads are contiguous.
    for (int e = tid; e < TC * CK * 9; e += NT) {
      const int tap = e % 9;
      const int c = (e / 9) % CK;
      const int o = e / (9 * CK);
      float v = 0.f;
      if (co0 + o < Cout && ci0 + c < ci_hi)
        v = w[((size_t)(co0 + o) * Cin + ci0 + c) * 9 + tap];
      ws[tap][c][o] = v;
    }
    __syncthreads();

    for (int c = 0; c < CK; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float xv[PX + 2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) xv[j] = xs[c][py + ky][px + j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float wv[CX];
          if constexpr (CX == 4) {
            const float4 w4 =
                *reinterpret_cast<const float4*>(&ws[ky * 3 + kx][c][cg * 4]);
            wv[0] = w4.x;
            wv[1] = w4.y;
            wv[2] = w4.z;
            wv[3] = w4.w;
          } else {
#pragma unroll
            for (int k = 0; k < CX; ++k) wv[k] = ws[ky * 3 + kx][c][cg * CX + k];
          }
#pragma unroll
          for (int j = 0; j < PX; ++j)
#pragma unroll
            for (int k = 0; k < CX; ++k)
              acc[j][k] = fmaf(xv[j + kx], wv[k], acc[j][k]);
        }
      }
    }
    __syncthreads();
  }

  const int h = h0 + py;
  if (h >= H) return;
  float bv[CX];
#pragma unroll
  for (int k = 0; k < CX; ++k) {
    const int co = co0 + cg * CX + k;
    bv[k] = (partial == nullptr && co < Cout) ? bias[co] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int wc = w0 + px + j;
    if (wc >= W) continue;
    const size_t pix = ((size_t)b * H + h) * W + wc;
#pragma unroll
    for (int k = 0; k < CX; ++k) {
      const int co = co0 + cg * CX + k;
      if (co >= Cout) continue;
      if (partial != nullptr) {
        partial[((size_t)split * B * H * W + pix) * Cout + co] = acc[j][k];
      } else {
        out[pix * Cout + co] = activate(acc[j][k] + bv[k], act);
      }
    }
  }
}

template <int TH, int TW, int TC, int CX, int PX>
cudaError_t launch_fp32(const void* x, const void* w, const void* bias,
                        void* out, float* partial, int splits, int B, int H,
                        int W, int Cin, int Cout, int act, int border,
                        cudaStream_t stream) {
  constexpr int NT = (TC / CX) * (TH * TW / PX);
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const dim3 grid(tiles_h * tiles_w, (Cout + TC - 1) / TC, B * splits);
  conv3x3_kernel<TH, TW, TC, CX, PX><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out),
      splits > 1 ? partial : nullptr, B, H, W, Cin, Cout, tiles_w, splits,
      channels_per_split(Cin, splits), act, border);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_reduce<float, float>(partial, bias, out, (long long)B * H * W * Cout,
                                     Cout, splits, act, stream);
}

cudaError_t dispatch_fp32(const void* x, const void* w, const void* bias,
                          void* out, float* partial, int splits, int B, int H,
                          int W, int Cin, int Cout, int act, int border,
                          cudaStream_t stream) {
  if (Cout == 1)
    return launch_fp32<16, 32, 1, 1, 2>(x, w, bias, out, partial, splits, B, H,
                                        W, Cin, Cout, act, border, stream);
  if (Cout <= 16)
    return launch_fp32<16, 16, 16, 4, 4>(x, w, bias, out, partial, splits, B,
                                         H, W, Cin, Cout, act, border, stream);
  if (Cout <= 32)
    return launch_fp32<8, 16, 32, 4, 4>(x, w, bias, out, partial, splits, B, H,
                                        W, Cin, Cout, act, border, stream);
  return launch_fp32<4, 16, 64, 4, 4>(x, w, bias, out, partial, splits, B, H,
                                      W, Cin, Cout, act, border, stream);
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

// ---- bf16, Cout = 1: the disparity head on the CUDA cores ---------------

constexpr int kHdTH = 16;  // output rows a block
constexpr int kHdTW = 64;  // output columns a block
constexpr int kHdPX = 4;   // neighbouring pixels of a row a thread
// Halo row pitch in 16-byte channel groups: odd, so the 8 threads of a
// quarter warp (8 consecutive rows, one column) hit distinct banks.
constexpr int kHdPitch = kHdTW + 3;
static_assert(kHdTH * (kHdTW / kHdPX) == 256, "one thread per 4 pixels");

__device__ __forceinline__ void bf16x8_to_float(const uint4 v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// grid: B * tiles_h * tiles_w. kVec: Cin % 8 == 0 and x 16-byte aligned.
template <typename OutT, bool kVec>
__global__ void __launch_bounds__(256) conv3x3_head_kernel(
    const uint16_t* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, OutT* __restrict__ out, int H, int W,
    int Cin, int tiles_h, int tiles_w, int act, int border) {
  __shared__ uint4 xs[2][kHdTH + 2][kHdPitch];  // [channel group][row][column]
  __shared__ float ws[9][kChunk];

  const int tid = threadIdx.x;
  const int r = tid % kHdTH, cx = (tid / kHdTH) * kHdPX;
  const long long blk = blockIdx.x;
  const int tw = static_cast<int>(blk % tiles_w);
  const int th = static_cast<int>((blk / tiles_w) % tiles_h);
  const long long b = blk / ((long long)tiles_w * tiles_h);
  const int h0 = th * kHdTH, w0 = tw * kHdTW;
  const uint16_t* xb = x + (size_t)b * H * W * Cin;

  float acc[kHdPX] = {0.f, 0.f, 0.f, 0.f};
  for (int ci0 = 0; ci0 < Cin; ci0 += kChunk) {
    __syncthreads();  // the previous chunk's reads are done
    constexpr int NPOS = (kHdTH + 2) * (kHdTW + 2);
    for (int i = tid; i < NPOS * 2; i += 256) {
      const int grp = i & 1, pos = i >> 1;
      const int rr = pos / (kHdTW + 2), cc = pos - rr * (kHdTW + 2);
      const int hsrc = border_index(h0 - 1 + rr, H, border);
      const int wsrc = border_index(w0 - 1 + cc, W, border);
      const int ch = ci0 + grp * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (hsrc >= 0 && wsrc >= 0 && ch < Cin) {
        const uint16_t* p = xb + ((size_t)hsrc * W + wsrc) * Cin + ch;
        if constexpr (kVec) {
          v = *reinterpret_cast<const uint4*>(p);
        } else {
          uint16_t e[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) e[k] = ch + k < Cin ? p[k] : uint16_t(0);
          v = make_uint4(e[0] | (uint32_t(e[1]) << 16), e[2] | (uint32_t(e[3]) << 16),
                         e[4] | (uint32_t(e[5]) << 16), e[6] | (uint32_t(e[7]) << 16));
        }
      }
      xs[grp][rr][cc] = v;
    }
    for (int i = tid; i < 9 * kChunk; i += 256) {
      const int tap = i / kChunk, c = i % kChunk;
      ws[tap][c] = ci0 + c < Cin ? __bfloat162float(w[(size_t)(ci0 + c) * 9 + tap]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int grp = 0; grp < 2; ++grp)
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float xv[kHdPX + 2][8];
#pragma unroll
        for (int j = 0; j < kHdPX + 2; ++j) bf16x8_to_float(xs[grp][r + ky][cx + j], xv[j]);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float wv = ws[ky * 3 + kx][grp * 8 + c];
#pragma unroll
            for (int p = 0; p < kHdPX; ++p) acc[p] = fmaf(xv[p + kx][c], wv, acc[p]);
          }
      }
  }

  const int h = h0 + r;
  if (h >= H) return;
  const float bv = __bfloat162float(bias[0]);
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

template <typename OutT>
cudaError_t launch_head(const void* x, const void* w, const void* bias, void* out,
                        int B, int H, int W, int Cin, int act, int border,
                        cudaStream_t stream) {
  const int tiles_h = (H + kHdTH - 1) / kHdTH;
  const int tiles_w = (W + kHdTW - 1) / kHdTW;
  const long long blocks = (long long)B * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const bool vec = Cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  auto kernel = vec ? &conv3x3_head_kernel<OutT, true> : &conv3x3_head_kernel<OutT, false>;
  kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<OutT*>(out), H, W, Cin,
      tiles_h, tiles_w, act, border);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sde

// How many input-channel slices sde_conv3x3 uses for this shape and dtype
// on a card with num_sms SMs. Above 1 it needs an fp32 workspace of
// splits * B * H * W * Cout elements.
extern "C" int sde_conv3x3_splits(int B, int H, int W, int Cin, int Cout,
                                  int dtype, int num_sms) {
  long long blocks;
  if (dtype == sde::kFloat32) {
    const sde::Tile t = sde::tile_for(Cout);
    blocks = (long long)B * ((H + t.th - 1) / t.th) * ((W + t.tw - 1) / t.tw) *
             ((Cout + t.tc - 1) / t.tc);
  } else if (Cout == 1) {
    return 1;  // the head kernel does not split
  } else {
    blocks = sde::tc_blocks(B, H, W, Cout);
  }
  return sde::split_for(blocks, Cin, num_sms);
}

// The bf16 weight slab of the tensor-core path: w (Cout, Cin, 3, 3) bf16 ->
// slab (9, round_up(Cin, 16), round_up(Cout, 8)) bf16, zero-padded, in one
// launch. The wrapper makes it once per weight.
extern "C" int sde_conv3x3_arrange(const void* w, void* slab, int Cin, int Cout,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cin_pad = sde::round_up(Cin, sde::kChunk), cout_pad = sde::round_up(Cout, 8);
  const long long n = 9LL * cin_pad * cout_pad;
  const long long blocks = std::min<long long>((n + 255) / 256, 1 << 16);
  sde::arrange_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(w), static_cast<uint16_t*>(slab), Cin, Cout,
      cin_pad, cout_pad);
  return static_cast<int>(cudaGetLastError());
}

// x (B, H, W, Cin), w (Cout, Cin, 3, 3) and bias (Cout) in `dtype`; out
// (B, H, W, Cout) in `dtype`, or float32 when out_f32 is set. All
// contiguous. slab: sde_conv3x3_arrange's slab of w, needed by the bf16
// path when Cout > 1 (unused otherwise). act: 0 none, 1 elu, 2 relu, 3
// sigmoid. border: 0 edge, 1 reflect, 2 zero. splits: sde_conv3x3_splits
// for this shape, with `workspace` of the size it names (unused when
// splits is 1).
extern "C" int sde_conv3x3(const void* x, const void* w, const void* slab,
                           const void* bias, void* out, void* workspace,
                           int splits, int B, int H, int W, int Cin, int Cout,
                           int dtype, int out_f32, int act, int border,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits < 1 || (splits > 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  if (dtype == sde::kFloat32) {
    err = sde::dispatch_fp32(x, w, bias, out, ws, splits, B, H, W, Cin, Cout, act,
                             border, s);
  } else if (Cout == 1) {
    if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    err = out_f32 ? sde::launch_head<float>(x, w, bias, out, B, H, W, Cin, act, border, s)
                  : sde::launch_head<__nv_bfloat16>(x, w, bias, out, B, H, W, Cin, act,
                                                    border, s);
  } else {
    if (slab == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
