// conv3x3_bwd: the gradient of conv3x3 (border pad -> 3x3 stride-1 conv ->
// + bias -> activation, NHWC fp32) with respect to its input, weight and
// bias, given g = dL/dout and the forward's OUTPUT:
//   dpre = g * act'(out)     (ELU: 1 where out > 0, else out + 1; ReLU: 1
//                             where out > 0; sigmoid: out (1 - out); none: 1)
//   dx[y, x, ci]  = sum over the padded positions (py, px) whose border map
//                   lands on (y, x), of sum_{ky, kx, co}
//                   dpre[py - ky, px - kx, co] w[co, ci, ky, kx]
//   dW[co, ci, ky, kx] = sum_{b, oy, ox} dpre[oy, ox, co] xp[oy + ky, ox + kx, ci]
//   db[co]        = sum_{b, oy, ox} dpre[oy, ox, co]
// (xp the border-padded input: reflect maps -1 -> 1 and n -> n - 2, the
// pixel itself on a 1-pixel axis; edge clamps; zero reads 0).
//
// Replaces the backward of the TPU kernel's custom VJP,
// scenedepthestimation_tpu/ops/pallas/conv_block.py::_fused_bwd (jax.vjp
// of conv3x3_xla, which XLA runs as two convolutions), and of the JAX
// decoder's DispHead (nn.Conv + nn.sigmoid).
//
// What bounds it on an H100: operations. At config 1's decoder at b12 each
// of dx and dW is an implicit GEMM of the forward's 85.7 GFLOP, 1.28 ms at
// 67 TFLOP/s on the CUDA cores (plain fp32 FMAs, no TF32: fp32 parity with
// the JAX package); the heads (Cout = 1) move bytes.
//
// Design. Every sum is taken in a fixed order with no atomics, so two calls
// give the same bits.
// - dpre once (conv3x3_dpre_kernel): one elementwise pass writes dpre to a
//   scratch tensor that dx and dW both read.
// - dx = a zero-bordered 3x3 conv of dpre with the flipped, transposed
//   weight w'[ci, co, ky, kx] = w[co, ci, 2 - ky, 2 - kx], plus a border
//   fold. The interior is the fp32 forward's own implicit GEMM
//   (conv_block.cu's conv3x3_f32_kernel: halo tiles by 16-byte cp.async
//   into two stages, the weight from a K-major slab, 40-80 sums a thread),
//   run on dpre with activation none, a zero bias, the zero border and the
//   slab of w' that conv3x3_dx_slab_kernel arranges from w each call (the
//   weight changes every step). The heads' dx (forward Cout = 1: one input
//   channel) has a byte-bound kernel of its own (conv3x3_dx_head_kernel:
//   a dpre halo tile and the 9 x Cin weights in shared memory, 4 channels
//   a thread, 16-byte stores). Reflect and edge borders then add the
//   gradients of the padded rows -1 and H and columns -1 and W onto the
//   rows and columns they map to (conv3x3_dx_fold_kernel): a small GEMM
//   over the border pixels alone, whose A operand sums the at most 3 extra
//   dpre terms a tap carries back to a border pixel, and whose B is the w'
//   slab; it adds its sum to the interior's in one fixed order.
// - dW and db (conv3x3_dw_kernel + conv3x3_dw_reduce_kernel): a block owns
//   a BM x BN tile of (Cout, Cin) for all 9 taps and walks the pixels as
//   strips of TH x 20 output pixels. Per strip it stages, by cp.async into
//   two stages, the dpre tile (TH x 20 x BM) and the input's (TH + 2) x 22
//   x BN halo, its border taken from indices at load time. A thread keeps
//   its 2 x 4 (co, ci) micro-tile for the 9 taps in registers (72 sums) and
//   walks a strip row keeping a 3 x 3 window of 4-channel input vectors, so
//   each pixel step reads 3 halo vectors and 2 dpre values of shared memory
//   for 72 FMAs: x is read once a strip, not once a tap, and dpre once a
//   Cin tile. The heads (Cout = 1) take the same kernel with one output
//   channel and 16 strip rows walked by 16 groups of threads. Narrow tiles
//   also split a strip's rows over groups of threads; the groups add their
//   sums in group order in shared memory. The strips are split into a fixed
//   number of slices (split-K); each slice writes its tile's sums to a
//   workspace and the reduce adds the slices in slice order.
#include "common.cuh"

namespace sde {
namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float act_grad(float out, int act) {
  if (act == 1) return out > 0.f ? 1.f : out + 1.f;  // ELU
  if (act == 2) return out > 0.f ? 1.f : 0.f;        // ReLU
  if (act == 3) return out * (1.f - out);            // sigmoid
  return 1.f;
}

// Source index of padded index p of an axis of n pixels (p = -1 and n are
// the border): reflect maps -1 -> 1 and n -> n - 2 (the pixel itself when
// n = 1), edge clamps, zero gives -1 outside [0, n). Indices further out (a
// ragged strip's unused halo) are clamped; their products meet a zero dpre.
__host__ __device__ __forceinline__ int src_index(int p, int n, int border) {
  if (p < 0 || p >= n) {
    if (border == 2) return -1;
    if (border == 1) p = p < 0 ? -p : 2 * n - 2 - p;
    else p = p < 0 ? 0 : n - 1;
  }
  return p < 0 ? 0 : (p >= n ? n - 1 : p);
}

// 4 bytes from device memory to shared memory; with `valid` false the word
// is zero-filled and nothing read.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

int round_to(int v, int m) { return (v + m - 1) / m * m; }

// ---- dpre -----------------------------------------------------------------

// dpre = g * act'(out) over n elements; vec: all three 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
    conv3x3_dpre_kernel(const float* __restrict__ g, const float* __restrict__ out,
                        float* __restrict__ dpre, long long n, int act, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nv = vec ? n / 4 : 0;
  for (long long i = i0; i < nv; i += stride) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(g) + i);
    const float4 o = __ldg(reinterpret_cast<const float4*>(out) + i);
    reinterpret_cast<float4*>(dpre)[i] =
        make_float4(a.x * act_grad(o.x, act), a.y * act_grad(o.y, act),
                    a.z * act_grad(o.z, act), a.w * act_grad(o.w, act));
  }
  for (long long i = nv * 4 + i0; i < n; i += stride) dpre[i] = g[i] * act_grad(out[i], act);
}

// ---- dx ---------------------------------------------------------------------

// The slab of w' in the fp32 forward's K-major layout: slab[(t * kp + co) *
// np + ci] = w[co][ci][8 - t], kp = Cout rounded up to 8 (the forward's
// input-channel chunk), np = Cin rounded up to 4; zero past Cout and Cin.
__global__ void __launch_bounds__(kThreads)
    conv3x3_dx_slab_kernel(const float* __restrict__ w, float* __restrict__ slab, int Cin,
                           int Cout, int kp, int np) {
  const long long n = 9LL * kp * np;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int ci = static_cast<int>(i % np);
    const int co = static_cast<int>((i / np) % kp);
    const int t = static_cast<int>(i / ((long long)np * kp));
    slab[i] = (co < Cout && ci < Cin) ? w[((long long)co * Cin + ci) * 9 + 8 - t] : 0.f;
  }
}

constexpr int kHxTH = 8;   // output rows a block
constexpr int kHxTW = 32;  // output columns a block
constexpr int kHxC = 64;   // input channels a block

// The heads' dx interior (forward Cout = 1): dx[y, x, ci] = sum_{ky, kx}
// dpre[y + 1 - ky, x + 1 - kx] w[0, ci, ky, kx], zero outside the image.
// grid (B * tiles_h * tiles_w, ceil(Cin / 64)); V channels a thread: 4 when
// Cin % 4 == 0 and dx is 16-byte aligned, else 1.
template <int V>
__global__ void __launch_bounds__(kThreads)
    conv3x3_dx_head_kernel(const float* __restrict__ dpre, const float* __restrict__ w,
                           float* __restrict__ dx, int H, int W, int Cin, int tiles_h,
                           int tiles_w) {
  __shared__ float ds[kHxTH + 2][kHxTW + 2];
  __shared__ __align__(16) float ws[9][kHxC];
  const int tid = threadIdx.x;
  const long long blk = blockIdx.x;
  const int tw = static_cast<int>(blk % tiles_w);
  const int th = static_cast<int>((blk / tiles_w) % tiles_h);
  const long long b = blk / ((long long)tiles_w * tiles_h);
  const int h0 = th * kHxTH, w0 = tw * kHxTW, c0 = blockIdx.y * kHxC;
  const int nc = min(kHxC, Cin - c0);
  const float* dp = dpre + b * H * W;
  for (int i = tid; i < (kHxTH + 2) * (kHxTW + 2); i += kThreads) {
    const int r = i / (kHxTW + 2), c = i - r * (kHxTW + 2);
    const int y = h0 - 1 + r, x = w0 - 1 + c;
    ds[r][c] = (y >= 0 && y < H && x >= 0 && x < W) ? dp[(long long)y * W + x] : 0.f;
  }
  for (int i = tid; i < 9 * kHxC; i += kThreads) {
    const int t = i / kHxC, c = i - t * kHxC;
    ws[t][c] = c < nc ? w[(long long)(c0 + c) * 9 + t] : 0.f;
  }
  __syncthreads();
  const int groups = (nc + V - 1) / V;
  for (int i = tid; i < kHxTH * kHxTW * groups; i += kThreads) {
    const int gi = i % groups, p = i / groups;
    const int ry = p / kHxTW, cx = p - ry * kHxTW;
    const int y = h0 + ry, x = w0 + cx;
    if (y >= H || x >= W) continue;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float d = ds[ry + 2 - ky][cx + 2 - kx];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(d, ws[ky * 3 + kx][gi * V + v], acc[v]);
      }
    float* dst = dx + ((b * H + y) * W + x) * Cin + c0 + gi * V;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      dst[0] = acc[0];
    }
  }
}

constexpr int kFoldP = 32;  // border pixels a block
constexpr int kFoldN = 64;  // input channels a block
constexpr int kFoldK = 32;  // output channels a step
constexpr int kFoldSeg = 8;

// The border fold. Destinations (the pixels the border maps onto) in
// segments that each start a tile: for each row r in R = {top, bot}, its
// pixels outside the columns C = {left, right}; for each column c in C, its
// pixels outside R; for each corner (r, c), its B pixels; each across the
// batch. A segment's pixels carry the same taps (3 on a row or a column, 6
// where one row or column is both borders' destination, 5-9 at a corner),
// so a tile's K walk skips the others.
struct FoldArgs {
  const float* dpre;  // (B, H, W, Cout)
  const float* slab;  // (9, kp, np): conv3x3_dx_slab_kernel's
  float* dx;          // (B, H, W, Cin), the interior in it
  int B, H, W, Cin, Cout, kp, np;
  int top, bot, left, right;  // where the padded rows -1 and H, columns -1 and W land
  int rows[2], nr;            // R ascending
  int cols[2], nc;            // C ascending
  int nseg;
  int seg_kind[kFoldSeg];        // 0 a row, 1 a column, 2 a corner
  int seg_y[kFoldSeg], seg_x[kFoldSeg];  // the segment's row (0, 2) and column (1, 2)
  int seg_tile[kFoldSeg + 1];    // each segment's first tile, then the tiles
};

// The j-th index of an axis that is not in the ascending set s[0 .. ns).
__device__ __forceinline__ int skip_set(int j, const int (&s)[2], int ns) {
  for (int k = 0; k < ns; ++k)
    if (j >= s[k]) ++j;
  return j;
}

// Destination p of tile `base` of a segment (kind, sy, sx): (b, y, x), b =
// -1 past the segment's end.
__device__ __forceinline__ void fold_dest(const FoldArgs& a, int kind, int sy, int sx, int base,
                                          int p, int& b, int& y, int& x) {
  const int d = base * kFoldP + p;
  b = -1;
  if (kind == 0) {
    const int per = a.W - a.nc;
    if (d >= a.B * per) return;
    b = d / per;
    y = sy;
    x = skip_set(d - b * per, a.cols, a.nc);
  } else if (kind == 1) {
    const int per = a.H - a.nr;
    if (d >= a.B * per) return;
    b = d / per;
    y = skip_set(d - b * per, a.rows, a.nr);
    x = sx;
  } else {
    if (d >= a.B) return;
    b = d;
    y = sy;
    x = sx;
  }
}

// The dpre row (column) that kernel row (column) k carries back to y of an
// axis of n from inside the image, y + 1 - k (*in: whether it lies there),
// and the one it carries from the border (*ex: whether there is one): 0
// where the padded -1 lands (lo, k = 0), n - 1 where n lands (hi, k = 2).
__device__ __forceinline__ void fold_lines(int y, int k, int n, int lo, int hi, int* id,
                                           bool* in, int* ex, bool* has) {
  *id = y + 1 - k;
  *in = *id >= 0 && *id < n;
  *has = (k == 0 && y == lo) || (k == 2 && y == hi);
  *ex = k == 0 ? 0 : n - 1;
}

// The pixel offsets (b, r, c) of the extra dpre terms tap (ky, kx) carries
// to (b, y, x): every (row, column) pair but the interior one, in row then
// column order: (inside row, border column), (border row, inside column),
// (border row, border column); -1 where a pair does not exist. Fixed
// indices only, so the offsets stay in registers.
__device__ __forceinline__ bool fold_terms(const FoldArgs& a, int b, int y, int x, int ky, int kx,
                                           int (&off)[3]) {
  int ri, re, ci, ce;
  bool vi, ve, wi, we;
  fold_lines(y, ky, a.H, a.top, a.bot, &ri, &vi, &re, &ve);
  fold_lines(x, kx, a.W, a.left, a.right, &ci, &wi, &ce, &we);
  const int row = b * a.H;
  off[0] = vi && we ? (row + ri) * a.W + ce : -1;
  off[1] = ve && wi ? (row + re) * a.W + ci : -1;
  off[2] = ve && we ? (row + re) * a.W + ce : -1;
  return off[0] >= 0 || off[1] >= 0 || off[2] >= 0;
}

// grid (the segments' tiles, ceil(Cin / 64)); 256 threads, each summing 2
// destinations x 4 input channels. The K walk is a list of steps, (tap of
// the tile's mask, 32 output channels): per step A (32 x 32, the extra dpre
// sums) and B (32 x 64, the slab rows of tap 8 - t) sit in one of two
// shared-memory stages, and the next step's A (in registers) and B (by
// cp.async) are in flight while this one is summed, one barrier a step.
// dx += the sums at the end: each (pixel, channel) belongs to one thread of
// the grid.
__global__ void __launch_bounds__(kThreads) conv3x3_dx_fold_kernel(const FoldArgs a) {
  __shared__ float As[2][kFoldK][kFoldP + 1];  // +1: the co-major stores hit distinct banks
  __shared__ __align__(16) float Bs[2][kFoldK][kFoldN];
  __shared__ int mask_s;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x, n0 = blockIdx.y * kFoldN;
  int kind = 0, sy = 0, sx = 0, first = 0;
#pragma unroll
  for (int k = 0; k < kFoldSeg; ++k)
    if (k < a.nseg && tile >= a.seg_tile[k]) {
      kind = a.seg_kind[k];
      sy = a.seg_y[k];
      sx = a.seg_x[k];
      first = a.seg_tile[k];
    }
  const int base = tile - first;
  if (tid == 0) mask_s = 0;
  __syncthreads();
  if (tid < kFoldP) {
    int b, y, x;
    fold_dest(a, kind, sy, sx, base, tid, b, y, x);
    if (b >= 0) {
      int m = 0, off[3];
#pragma unroll
      for (int t = 0; t < 9; ++t)
        if (fold_terms(a, b, y, x, t / 3, t % 3, off)) m |= 1 << t;
      atomicOr(&mask_s, m);
    }
  }
  __syncthreads();
  const int mask = mask_s;
  const int chunks = (a.Cout + kFoldK - 1) / kFoldK;
  const int steps = __popc(mask) * chunks;
  // Step s: the (s / chunks)-th tap of the mask, output channels from
  // (s % chunks) * 64.
  auto tap_of = [&](int s) {
    int m = mask;
    for (int k = s / chunks; k > 0; --k) m &= m - 1;
    return __ffs(m) - 1;
  };

  // A: element (co = tid % 32, pixel tid / 32 + 8 j), j < 4; the pixels'
  // extra terms are found once a tap. load_a starts a step's loads (every
  // slot, a missing term reading a dummy word, so that none waits on
  // another), store_a adds each element's terms in slot order into a stage.
  constexpr int kRows = kThreads / kFoldK;
  constexpr int kPer = kFoldP / kRows;
  const int cl = tid % kFoldK;
  int sb[kPer], syy[kPer], sxx[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    fold_dest(a, kind, sy, sx, base, tid / kFoldK + kRows * j, sb[j], syy[j], sxx[j]);
  int off[kPer][3];
  int cur_tap = -1, ok = 0;
  float raw[kPer][3];
  auto load_a = [&](int s) {
    const int tap = tap_of(s), co = (s % chunks) * kFoldK + cl;
    if (tap != cur_tap) {
      cur_tap = tap;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        off[j][0] = off[j][1] = off[j][2] = -1;
        if (sb[j] >= 0) fold_terms(a, sb[j], syy[j], sxx[j], tap / 3, tap % 3, off[j]);
      }
    }
    ok = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const bool v = co < a.Cout && off[j][k] >= 0;
        ok |= v << (j * 3 + k);
        raw[j][k] = __ldg(a.dpre + (v ? (long long)off[j][k] * a.Cout + co : 0));
      }
  };
  auto store_a = [&](int st) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if ((ok >> (j * 3 + k)) & 1) v += raw[j][k];
      As[st][cl][tid / kFoldK + kRows * j] = v;
    }
  };
  auto load_b = [&](int s, int st) {
    const float* brow = a.slab + (long long)(8 - tap_of(s)) * a.kp * a.np;
    const int co0 = (s % chunks) * kFoldK;
    for (int i = tid; i < kFoldK * kFoldN / 4; i += kThreads) {
      const int row = i / (kFoldN / 4), v4 = i % (kFoldN / 4);
      const int c = co0 + row, n = n0 + v4 * 4;
      const bool ok = c < a.kp && n < a.np;
      cp_async16(&Bs[st][row][v4 * 4], ok ? brow + (long long)c * a.np + n : a.slab, ok);
    }
    cp_async_commit();
  };

  const int ng = tid % (kFoldN / 4), pg = tid / (kFoldN / 4);
  float acc[2][4] = {};
  if (steps > 0) {
    load_a(0);
    load_b(0, 0);
  }
  for (int s = 0; s < steps; ++s) {
    const int st = s & 1;
    store_a(st);
    cp_async_wait<0>();
    // Step s's A and B are in place for every thread, and every thread is
    // done with step s - 1, whose stage the next loads overwrite.
    __syncthreads();
    if (s + 1 < steps) {
      load_a(s + 1);
      load_b(s + 1, st ^ 1);
    }
#pragma unroll
    for (int kk = 0; kk < kFoldK; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[st][kk][ng * 4]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float av0 = As[st][kk][pg * 2 + i];
        acc[i][0] = fmaf(av0, bv.x, acc[i][0]);
        acc[i][1] = fmaf(av0, bv.y, acc[i][1]);
        acc[i][2] = fmaf(av0, bv.z, acc[i][2]);
        acc[i][3] = fmaf(av0, bv.w, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int b, y, x;
    fold_dest(a, kind, sy, sx, base, pg * 2 + i, b, y, x);
    if (b < 0) continue;
    float* dst = a.dx + (((long long)b * a.H + y) * a.W + x) * a.Cin;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = n0 + ng * 4 + j;
      if (ci < a.Cin) dst[ci] += acc[i][j];
    }
  }
}

// ---- dW ---------------------------------------------------------------------

// A block: BM output channels x BN input channels x 9 taps; PW groups of
// threads ("lanes") share a strip's rows; MT x 4 (co, ci) a thread. Strips
// of TH x 20 output pixels.
template <int BM_, int BN_, int PW_>
struct WCfg {
  static constexpr int BM = BM_, BN = BN_, PW = PW_;
  static constexpr int MT = BM > 1 ? 2 : 1;
  static constexpr int NT = 4;
  static constexpr int MG = BM / MT, NG = BN / NT;
  static constexpr int THREADS = MG * NG * PW;
  static constexpr int TH = PW > 4 ? PW : 4;
  static constexpr int TW = 20;
  // dpre row pitch: one value a pixel for the heads, padded so that the
  // lanes of a warp (different rows) fall in distinct banks.
  static constexpr int DP = BM == 1 ? TW + 1 : TW * BM;
  static constexpr int XP = (TW + 2) * BN;  // halo row pitch
  static constexpr int DPRE = (TH * DP + 3) / 4 * 4;
  static constexpr int STAGE = DPRE + (TH + 2) * XP;
  static constexpr int SMEM = 2 * STAGE * 4;
  static constexpr int TILE = BM * BN * 9 + BM;  // a block's sums, dW then db
  static_assert(TILE <= 2 * STAGE, "the lanes' sum fits in the stages");
  static_assert(THREADS <= 256 && THREADS % 32 == 0, "whole warps");
};

struct WArgs {
  const float* dpre;  // (B, H, W, Cout)
  const float* x;     // (B, H, W, Cin)
  float* ws;          // (splits, Cout, N) partial sums
  int B, H, W, Cin, Cout, border;
  int strips_h, strips_w;
  long long strips;   // B * strips_h * strips_w
  int per_split;      // strips a slice
  int tiles_n;        // Cin tiles
  int N;              // 9 * Cin + 1: (ci, tap) columns, then db's
  int vec_d, vec_x;   // 16-byte copies of dpre / x
};

// grid (Cout tiles x Cin tiles, splits), the Cin tile fastest.
template <class Cfg>
__global__ void __launch_bounds__(Cfg::THREADS) conv3x3_dw_kernel(const WArgs a) {
  constexpr int BM = Cfg::BM, BN = Cfg::BN, PW = Cfg::PW, MT = Cfg::MT, NG = Cfg::NG;
  constexpr int MG = Cfg::MG, NT_ = Cfg::THREADS, TH = Cfg::TH, TW = Cfg::TW;
  constexpr int DP = Cfg::DP, XP = Cfg::XP;
  extern __shared__ __align__(16) float wsmem[];

  const int tid = threadIdx.x;
  const int ng = tid % NG, mg = (tid / NG) % MG, lane = tid / (NG * MG);
  const int nt = blockIdx.x % a.tiles_n, mt = blockIdx.x / a.tiles_n;
  const int co0 = mt * BM, ci0 = nt * BN;
  const int split = blockIdx.y;
  const long long s_lo = (long long)split * a.per_split;
  const int ns = static_cast<int>(min((long long)a.per_split, a.strips - s_lo));

  auto strip_at = [&](long long s, int& b, int& oy0, int& ox0) {
    ox0 = static_cast<int>(s % a.strips_w) * TW;
    const long long t = s / a.strips_w;
    oy0 = static_cast<int>(t % a.strips_h) * TH;
    b = static_cast<int>(t / a.strips_h);
  };

  auto load = [&](long long s, float* st) {
    int b, oy0, ox0;
    strip_at(s, b, oy0, ox0);
    float* ds = st;
    if (a.vec_d) {
      constexpr int V = BM >= 4 ? BM / 4 : 1;
      for (int i = tid; i < TH * TW * V; i += NT_) {
        const int v = i % V, p = i / V;
        const int r = p / TW, c = p - r * TW;
        const int oy = oy0 + r, ox = ox0 + c, co = co0 + v * 4;
        const bool ok = oy < a.H && ox < a.W && co < a.Cout;
        const float* src = ok ? a.dpre + (((long long)b * a.H + oy) * a.W + ox) * a.Cout + co
                              : a.dpre;
        cp_async16(ds + r * DP + c * BM + v * 4, src, ok);
      }
    } else {
      for (int i = tid; i < TH * TW * BM; i += NT_) {
        const int m = i % BM, p = i / BM;
        const int r = p / TW, c = p - r * TW;
        const int oy = oy0 + r, ox = ox0 + c, co = co0 + m;
        const bool ok = oy < a.H && ox < a.W && co < a.Cout;
        const float* src = ok ? a.dpre + (((long long)b * a.H + oy) * a.W + ox) * a.Cout + co
                              : a.dpre;
        cp_async4(ds + r * DP + c * BM + m, src, ok);
      }
    }
    float* xs = st + Cfg::DPRE;
    const float* xb = a.x + (long long)b * a.H * a.W * a.Cin;
    if (a.vec_x) {
      constexpr int V = BN / 4;
      for (int i = tid; i < (TH + 2) * (TW + 2) * V; i += NT_) {
        const int v = i % V, pos = i / V;
        const int r = pos / (TW + 2), c = pos - r * (TW + 2);
        const int hs = src_index(oy0 - 1 + r, a.H, a.border);
        const int wsrc = src_index(ox0 - 1 + c, a.W, a.border);
        const int ci = ci0 + v * 4;
        const bool ok = hs >= 0 && wsrc >= 0 && ci < a.Cin;
        const float* src = ok ? xb + ((long long)hs * a.W + wsrc) * a.Cin + ci : a.x;
        cp_async16(xs + r * XP + c * BN + v * 4, src, ok);
      }
    } else {
      for (int i = tid; i < (TH + 2) * (TW + 2) * BN; i += NT_) {
        const int n = i % BN, pos = i / BN;
        const int r = pos / (TW + 2), c = pos - r * (TW + 2);
        const int hs = src_index(oy0 - 1 + r, a.H, a.border);
        const int wsrc = src_index(ox0 - 1 + c, a.W, a.border);
        const int ci = ci0 + n;
        const bool ok = hs >= 0 && wsrc >= 0 && ci < a.Cin;
        const float* src = ok ? xb + ((long long)hs * a.W + wsrc) * a.Cin + ci : a.x;
        cp_async4(xs + r * XP + c * BN + n, src, ok);
      }
    }
  };

  float acc[9][MT][4];
  float dbacc[MT];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[t][m][n] = 0.f;
#pragma unroll
  for (int m = 0; m < MT; ++m) dbacc[m] = 0.f;

  if (ns > 0) {
    load(s_lo, wsmem);
    cp_async_commit();
  }
  for (int k = 0; k < ns; ++k) {
    cp_async_wait<0>();
    // Strip k has landed for every thread, and every thread is done with
    // strip k - 1, whose stage the next load overwrites.
    __syncthreads();
    if (k + 1 < ns) {
      load(s_lo + k + 1, wsmem + ((k + 1) & 1) * Cfg::STAGE);
      cp_async_commit();
    }
    const float* ds = wsmem + (k & 1) * Cfg::STAGE;
    const float* xs = ds + Cfg::DPRE;
    int b, oy0, ox0;
    strip_at(s_lo + k, b, oy0, ox0);
    for (int rr = lane; rr < TH && oy0 + rr < a.H; rr += PW) {
      const float* xr = xs + rr * XP + ng * 4;
      const float* dr = ds + rr * DP + mg * MT;
      float4 xw[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        xw[i][1] = *reinterpret_cast<const float4*>(xr + i * XP);
        xw[i][2] = *reinterpret_cast<const float4*>(xr + i * XP + BN);
      }
#pragma unroll
      for (int c = 0; c < TW; ++c) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          xw[i][0] = xw[i][1];
          xw[i][1] = xw[i][2];
          xw[i][2] = *reinterpret_cast<const float4*>(xr + i * XP + (c + 2) * BN);
        }
        float d[MT];
        if constexpr (MT == 2) {
          const float2 dv = *reinterpret_cast<const float2*>(dr + c * BM);
          d[0] = dv.x;
          d[1] = dv.y;
        } else {
          d[0] = dr[c];
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) dbacc[m] += d[m];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              float* s = acc[ky * 3 + kx][m];
              s[0] = fmaf(d[m], xw[ky][kx].x, s[0]);
              s[1] = fmaf(d[m], xw[ky][kx].y, s[1]);
              s[2] = fmaf(d[m], xw[ky][kx].z, s[2]);
              s[3] = fmaf(d[m], xw[ky][kx].w, s[3]);
            }
      }
    }
  }

  // The lanes' sums meet in shared memory in lane order: red[(m * BN + n) *
  // 9 + t], then db's BM values; then the tile goes out as contiguous runs.
  float* red = wsmem;
  __syncthreads();  // every lane is done with the stages
  for (int l = 0; l < PW; ++l) {
    if (lane == l) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            float* r = red + ((mg * MT + m) * BN + ng * 4 + n) * 9 + t;
            *r = l == 0 ? acc[t][m][n] : *r + acc[t][m][n];
          }
        if (ng == 0) {
          float* r = red + BM * BN * 9 + mg * MT + m;
          *r = l == 0 ? dbacc[m] : *r + dbacc[m];
        }
      }
    }
    __syncthreads();
  }
  float* out = a.ws + (long long)split * a.Cout * a.N;
  for (int i = tid; i < BM * BN * 9; i += NT_) {
    const int m = i / (BN * 9), rest = i - m * BN * 9;
    const int co = co0 + m, ci = ci0 + rest / 9;
    if (co < a.Cout && ci < a.Cin) out[(long long)co * a.N + ci0 * 9 + rest] = red[i];
  }
  if (nt == 0)
    for (int m = tid; m < BM; m += NT_)
      if (co0 + m < a.Cout) out[(long long)(co0 + m) * a.N + 9 * a.Cin] = red[BM * BN * 9 + m];
}

// dW (Cout, Cin, 3, 3) and db from the slices' partial sums, added in slice
// order by groups: a block is 256 / E groups of E elements; group q adds
// slices q, q + G, ... in order, and the groups' sums meet in group order.
template <int E>
__global__ void __launch_bounds__(kThreads)
    conv3x3_dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                             float* __restrict__ db, int slices, int Cin, long long total) {
  constexpr int G = kThreads / E;
  __shared__ float part[G][E];
  const int e = threadIdx.x % E, q = threadIdx.x / E;
  const long long i = (long long)blockIdx.x * E + e;
  float s = 0.f;
  if (i < total)
    for (int sl = q; sl < slices; sl += G) s += ws[(long long)sl * total + i];
  part[q][e] = s;
  __syncthreads();
  if (q != 0 || i >= total) return;
  for (int k = 1; k < G; ++k) s += part[k][e];
  const long long N = 9LL * Cin + 1;
  const long long co = i / N, n = i - co * N;
  if (n == 9LL * Cin) db[co] = s;
  else dw[co * 9LL * Cin + n] = s;
}

// Calls f with the dW tile configuration for (Cin, Cout).
template <typename F>
auto with_dw_cfg(int Cin, int Cout, F f) {
  const int bn = Cin <= 16 ? 16 : ((Cin <= 32 || (Cin % 64 != 0 && Cin % 32 == 0)) ? 32 : 64);
  if (Cout == 1) {
    // 16 input channels take the 32-channel tile (zero-filled past Cin):
    // ptxas spilled registers in a 16-channel one.
    if (bn <= 32) return f(WCfg<1, 32, 16>{});
    return f(WCfg<1, 64, 16>{});
  }
  if (Cout <= 16) {
    if (bn == 16) return f(WCfg<16, 16, 8>{});
    if (bn == 32) return f(WCfg<16, 32, 4>{});
    return f(WCfg<16, 64, 2>{});
  }
  if (bn == 16) return f(WCfg<32, 16, 4>{});
  if (bn == 32) return f(WCfg<32, 32, 2>{});
  return f(WCfg<32, 64, 1>{});
}

// Co-resident blocks of conv3x3_dw_kernel<Cfg> on `device`, asked of the
// runtime once per device (which also lifts the kernel's shared-memory
// limit).
template <class Cfg>
cudaError_t dw_capacity(int device, int* cap) {
  static int cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    const auto kernel = &conv3x3_dw_kernel<Cfg>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Cfg::THREADS, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[device] = per_sm * sms;
  }
  *cap = cached[device];
  return cudaSuccess;
}

// The slices of the strips: the count whose busiest block walks the fewest
// strips, taking blocks beyond the co-resident ones as further waves; fewer
// slices on a tie. plan: {slices, workspace floats, strips a slice}.
cudaError_t dw_plan(int B, int H, int W, int Cin, int Cout, int device, long long* plan) {
  return with_dw_cfg(Cin, Cout, [&](auto cfg) {
    using Cfg = decltype(cfg);
    int cap = 0;
    const cudaError_t err = dw_capacity<Cfg>(device, &cap);
    if (err != cudaSuccess) return err;
    const long long strips = (long long)B * ((H + Cfg::TH - 1) / Cfg::TH) *
                             ((W + Cfg::TW - 1) / Cfg::TW);
    const long long tiles =
        (long long)((Cout + Cfg::BM - 1) / Cfg::BM) * ((Cin + Cfg::BN - 1) / Cfg::BN);
    long long best = -1, best_s = 1, best_per = strips;
    // Beyond two waves of one slice a tile, a slice saves no time.
    const long long most = std::min<long long>({strips, 2 * ((cap + tiles - 1) / tiles), 65535LL});
    for (long long s = 1; s <= most; ++s) {
      const long long per = (strips + s - 1) / s;
      if (s > 1 && per == (strips + s - 2) / (s - 1)) continue;  // same walk as s - 1
      const long long used = (strips + per - 1) / per;
      const long long cost = ((tiles * used + cap - 1) / cap) * per;
      if (best < 0 || cost < best) {
        best = cost;
        best_s = used;
        best_per = per;
      }
    }
    plan[0] = best_s;
    plan[1] = best_s * Cout * (9LL * Cin + 1);
    plan[2] = best_per;
    return cudaSuccess;
  });
}

bool shape_ok(int B, int H, int W, int Cin, int Cout) {
  return B > 0 && H > 0 && W > 0 && Cin > 0 && Cout > 0 &&
         (long long)B * H * W < (1LL << 31) && 9LL * Cin + 1 < (1LL << 31) &&
         9LL * Cout < (1LL << 31);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

unsigned grid_for(long long n) {
  return static_cast<unsigned>(std::max<long long>(1, std::min<long long>((n + kThreads - 1) / kThreads, 1 << 16)));
}

}  // namespace
}  // namespace sde

// dpre (n fp32) = g * act'(out); act: 0 none, 1 elu, 2 relu, 3 sigmoid.
extern "C" int sde_conv3x3_bwd_dpre(const void* g, const void* out, void* dpre, long long n,
                                    int act, int device, void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = sde::aligned16(g) && sde::aligned16(out) && sde::aligned16(dpre);
  sde::conv3x3_dpre_kernel<<<sde::grid_for(vec ? n / 4 : n), sde::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(out), static_cast<float*>(dpre),
      n, act, vec);
  return static_cast<int>(cudaGetLastError());
}

// The slab of w' (the fp32 forward's layout, sde_conv3x3_arrange's for a
// weight (Cin, Cout, 3, 3)) from w (Cout, Cin, 3, 3): (9, round_up(Cout,
// 8), round_up(Cin, 4)) fp32.
extern "C" int sde_conv3x3_bwd_slab(const void* w, void* slab, int Cin, int Cout, int device,
                                    void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Cin <= 0 || Cout <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int kp = sde::round_to(Cout, 8), np = sde::round_to(Cin, 4);
  sde::conv3x3_dx_slab_kernel<<<sde::grid_for(9LL * kp * np), sde::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(slab), Cin, Cout, kp, np);
  return static_cast<int>(cudaGetLastError());
}

// The heads' dx interior: dx (B, H, W, Cin) from dpre (B, H, W, 1) and w
// (1, Cin, 3, 3), the zero-bordered transposed conv; fp32, contiguous.
extern "C" int sde_conv3x3_bwd_dx_head(const void* dpre, const void* w, void* dx, int B, int H,
                                       int W, int Cin, int device, void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!sde::shape_ok(B, H, W, Cin, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (H + sde::kHxTH - 1) / sde::kHxTH;
  const int tiles_w = (W + sde::kHxTW - 1) / sde::kHxTW;
  const long long blocks = (long long)B * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), (Cin + sde::kHxC - 1) / sde::kHxC);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = (Cin % 4 == 0 && sde::aligned16(dx)) ? &sde::conv3x3_dx_head_kernel<4>
                                                     : &sde::conv3x3_dx_head_kernel<1>;
  kernel<<<grid, sde::kThreads, 0, s>>>(static_cast<const float*>(dpre),
                                        static_cast<const float*>(w), static_cast<float*>(dx), H,
                                        W, Cin, tiles_h, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

// Adds the border's gradient to dx (B, H, W, Cin), which holds the interior:
// from dpre (B, H, W, Cout) and the slab of sde_conv3x3_bwd_slab. border: 0
// edge, 1 reflect (2, zero, has none: nothing is launched).
extern "C" int sde_conv3x3_bwd_fold(const void* dpre, const void* slab, void* dx, int B, int H,
                                    int W, int Cin, int Cout, int border, int device,
                                    void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!sde::shape_ok(B, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  if (border == 2) return static_cast<int>(cudaSuccess);
  sde::FoldArgs a{};
  a.dpre = static_cast<const float*>(dpre);
  a.slab = static_cast<const float*>(slab);
  a.dx = static_cast<float*>(dx);
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.kp = sde::round_to(Cout, 8);
  a.np = sde::round_to(Cin, 4);
  a.top = sde::src_index(-1, H, border);
  a.bot = sde::src_index(H, H, border);
  a.left = sde::src_index(-1, W, border);
  a.right = sde::src_index(W, W, border);
  a.rows[0] = std::min(a.top, a.bot);
  a.rows[1] = std::max(a.top, a.bot);
  a.nr = a.top == a.bot ? 1 : 2;
  a.cols[0] = std::min(a.left, a.right);
  a.cols[1] = std::max(a.left, a.right);
  a.nc = a.left == a.right ? 1 : 2;
  int tiles = 0;
  auto add = [&](int kind, int y, int x, int count) {
    if (count <= 0) return;
    a.seg_kind[a.nseg] = kind;
    a.seg_y[a.nseg] = y;
    a.seg_x[a.nseg] = x;
    a.seg_tile[a.nseg++] = tiles;
    tiles += (count + sde::kFoldP - 1) / sde::kFoldP;
  };
  for (int i = 0; i < a.nr; ++i) add(0, a.rows[i], 0, B * (W - a.nc));
  for (int j = 0; j < a.nc; ++j) add(1, 0, a.cols[j], B * (H - a.nr));
  for (int i = 0; i < a.nr; ++i)
    for (int j = 0; j < a.nc; ++j) add(2, a.rows[i], a.cols[j], B);
  a.seg_tile[a.nseg] = tiles;
  const dim3 grid(tiles, (Cin + sde::kFoldN - 1) / sde::kFoldN);
  sde::conv3x3_dx_fold_kernel<<<grid, sde::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// How sde_conv3x3_bwd_dw runs this shape on `device`: plan[0] the slices of
// its strips, plan[1] the fp32 workspace it needs (elements), plan[2] the
// strips a slice.
extern "C" int sde_conv3x3_bwd_plan(int B, int H, int W, int Cin, int Cout, int device,
                                    long long* plan) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!sde::shape_ok(B, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sde::dw_plan(B, H, W, Cin, Cout, device, plan));
}

// dw (Cout, Cin, 3, 3) and db (Cout) from dpre (B, H, W, Cout) and x (B, H,
// W, Cin); all float32, contiguous. border: 0 edge, 1 reflect, 2 zero. ws:
// at least plan[1] fp32 elements of sde_conv3x3_bwd_plan, the caller's
// scratch (written whole before it is read). Two launches: the slices'
// partial sums, then their sum in slice order.
extern "C" int sde_conv3x3_bwd_dw(const void* dpre, const void* x, void* dw, void* db, void* ws,
                                  long long ws_elems, int B, int H, int W, int Cin, int Cout,
                                  int border, int device, void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!sde::shape_ok(B, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  long long plan[3];
  err = sde::dw_plan(B, H, W, Cin, Cout, device, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ws == nullptr || ws_elems < plan[1] || plan[0] > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = static_cast<int>(plan[0]);
  err = sde::with_dw_cfg(Cin, Cout, [&](auto cfg) {
    using Cfg = decltype(cfg);
    sde::WArgs a{};
    a.dpre = static_cast<const float*>(dpre);
    a.x = static_cast<const float*>(x);
    a.ws = static_cast<float*>(ws);
    a.B = B;
    a.H = H;
    a.W = W;
    a.Cin = Cin;
    a.Cout = Cout;
    a.border = border;
    a.strips_h = (H + Cfg::TH - 1) / Cfg::TH;
    a.strips_w = (W + Cfg::TW - 1) / Cfg::TW;
    a.strips = (long long)B * a.strips_h * a.strips_w;
    a.per_split = static_cast<int>(plan[2]);
    a.tiles_n = (Cin + Cfg::BN - 1) / Cfg::BN;
    a.N = 9 * Cin + 1;
    a.vec_d = Cfg::BM >= 4 && Cout % 4 == 0 && sde::aligned16(dpre);
    a.vec_x = Cin % 4 == 0 && sde::aligned16(x);
    const dim3 grid(((Cout + Cfg::BM - 1) / Cfg::BM) * a.tiles_n, splits);
    sde::conv3x3_dw_kernel<Cfg><<<grid, Cfg::THREADS, Cfg::SMEM, s>>>(a);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = (long long)Cout * (9LL * Cin + 1);
  float* dwp = static_cast<float*>(dw);
  float* dbp = static_cast<float*>(db);
  const float* wsp = static_cast<const float*>(ws);
  if (splits >= 64) {
    const unsigned blocks = static_cast<unsigned>((total + 7) / 8);
    sde::conv3x3_dw_reduce_kernel<8><<<blocks, sde::kThreads, 0, s>>>(wsp, dwp, dbp, splits, Cin,
                                                                       total);
  } else {
    const unsigned blocks = static_cast<unsigned>((total + 31) / 32);
    sde::conv3x3_dw_reduce_kernel<32><<<blocks, sde::kThreads, 0, s>>>(wsp, dwp, dbp, splits,
                                                                        Cin, total);
  }
  return static_cast<int>(cudaGetLastError());
}
