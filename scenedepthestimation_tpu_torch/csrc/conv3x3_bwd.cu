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
//
// bf16 (the bench preset's decoder, mono_kitti_384x1152_bench at b128; the
// TPU side is the same _fused_bwd, XLA's VJP of conv3x3_xla in bf16, and
// the bf16 DispHead's conv VJP). The same decomposition on the bf16 tensor
// cores, with the rounding points of the JAX program: dpre is rounded to
// bf16 once (JAX's cotangent of a bf16 conv is bf16), dx's interior once,
// and the fold adds in fp32 to it and rounds again (the pad's VJP adds in
// bf16); dW and db are fp32 sums rounded once. At b128 each of dx and dW is
// an implicit GEMM of 3.29 TFLOP over the 14 calls of a step (0.13-0.53 ms
// a call at 989 TFLOP/s; the levels of 64 channels and less move bytes),
// which the CUDA cores' 67 TFLOP/s of fp32 FMAs would take 49 ms for.
// - dpre: conv3x3_dpre_kernel<bf16, bf16> (the ELU layers) and <float,
//   bf16> (the heads, whose g and sigmoid output are fp32).
// - dx: the slab of w' in wgmma's core-matrix order
//   (conv3x3_dx_slab_bf16_kernel, each call: the weight changes every
//   step), which both the interior and the fold read; the interior on conv3x3_dx_wgmma.cu's kernel (see its notes;
//   the heads on conv3x3_dx_head_kernel<bf16>); then the fold on the
//   tensor cores, conv3x3_dx_fold_tc_kernel: the GEMM of the fold pixels by
//   Cin over (tap, extra dpre term, 16 channels), each term a K entry of
//   its own, from the same slab, its fragments read straight from device
//   memory. On CUDA cores in fp32 the fold had cost as much as the interior
//   at the 512-channel levels (its tiles re-read w' for 32 pixels).
// - dW and db for Cout > 16 (conv3x3_dw_wgmma_kernel + the reduce):
//   dW[co, (tap, ci)] = sum over pixels p of dpre[p, co] xp[p + tap, ci],
//   a GEMM with M = Cout, N = 9 Cin and K = the pixels, on wgmma
//   m64nBNk16. A block owns 64 output by BN (64, 48, 32 or 16) input channels
//   for the 9 taps, in three warpgroups of one kernel row each (3 x BN / 2
//   sums a thread), and walks strips of 8 x 16 output pixels through a
//   5-stage cp.async ring (3 strips in flight): per strip the dpre tile
//   (pixel-major) and the input's 10 x 18 halo (border from indices) are
//   staged once for all 9 taps and all three warpgroups (dpre's first 32
//   channels alone where Cout <= 32: the rows past them stay zero). The
//   halo lies as [BN / 8][pixel][8 channels], wgmma's MN-major B: a tap's
//   shift is a 16-byte step of the descriptor's start. Per strip row each warp reads
//   its A fragment (dpre transposed) by ldmatrix.trans once for its
//   warpgroup's three taps and db's product against ones; a row's products
//   go out as one group, waited one row later. No instruction but the
//   products writes the sums (the first product writes them fresh,
//   scale-d 0) and no product sits on a branch: either makes ptxas
//   serialize the products (its warning C7515), at about a third of their
//   rate. On mma.sync (conv3x3_dw_tc_kernel) these shapes are bound by its
//   issue: a warp's 5 ldmatrix and 9 x WMT mma.sync a k16 step, the dpre
//   tile staged again for every 32 input channels, one barrier and a full
//   drain of two stages a strip.
// - The heads' dW (Cout = 1: conv3x3_dw_head_kernel + the reduce) moves
//   bytes: at dispconv_0 the 1.8 GB input against 8 GFMA. On the CUDA
//   cores: a thread a channel pair of a pixel lane, the lane walking a
//   strip row's columns with the pair's 3 x 3 window of the halo in
//   registers, slid one column a pixel (3 halo words and one dpre value a
//   pixel for 18 FMAs); two cp.async stages of 8-row strips 64, 32 or 16
//   columns wide by Cin (16, 32, 64; 128 channels a block above), three
//   blocks an SM. The mma.sync kernel's 16-row A tiles were 1/16 used
//   there.
// - Cout 2-16 (upconv_0_x) stay on conv3x3_dw_tc_kernel: mma.sync
//   m16n8k16 over the same strips, whose 16-row tiles waste no rows there
//   (the wgmma kernel's m64 wastes three quarters: 1.5-1.7 x its time).
// All of them write slices of the strips to a workspace that the reduce
// adds in slice order and rounds once: no atomics, the same bits each
// call.
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

__host__ __device__ __forceinline__ int round_to(int v, int m) { return (v + m - 1) / m * m; }

// ---- dpre -----------------------------------------------------------------

// Four elements at p as floats, and four floats stored at p: float4 for
// fp32, two 32-bit words for bf16 (rounded to nearest even).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(a.x << 16);
  v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16);
  v[3] = __uint_as_float(a.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

// dpre = g * act'(out) over n elements, in fp32, stored as TD; g and out in
// TG. vec: all three aligned to 4 elements.
template <typename TG, typename TD>
__global__ void __launch_bounds__(kThreads)
    conv3x3_dpre_kernel(const TG* __restrict__ g, const TG* __restrict__ out,
                        TD* __restrict__ dpre, long long n, int act, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nv = vec ? n / 4 : 0;
  for (long long i = i0; i < nv; i += stride) {
    float a[4], o[4], d[4];
    load4(g + 4 * i, a);
    load4(out + 4 * i, o);
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = a[k] * act_grad(o[k], act);
    store4(dpre + 4 * i, d);
  }
  for (long long i = nv * 4 + i0; i < n; i += stride)
    dpre[i] = from_float<TD>(to_float(g[i]) * act_grad(to_float(out[i]), act));
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

// The tensor-core slab of w' from a bf16 w (Cout, Cin, 3, 3), which the dx
// interior's wgmma and the fold's mma.sync read: sde_conv3x3_arrange's
// core-matrix order for a weight (Cin, Cout, 3, 3), (9, Cout rounded up to
// 16, Cin rounded up to 8), tc[(((t * KC + kc) * NB + nb) * 2 + kb) * 64 +
// n8 * 8 + k8] = w[kc * 16 + kb * 8 + k8][nb * 8 + n8][8 - t]; zero past
// Cout and Cin.
__global__ void __launch_bounds__(kThreads)
    conv3x3_dx_slab_bf16_kernel(const uint16_t* __restrict__ w, uint16_t* __restrict__ tc,
                                int Cin, int Cout) {
  const int chunks = round_to(Cout, 16) / 16, groups = round_to(Cin, 8) / 8;
  const long long n = 9LL * chunks * 16 * groups * 8;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int k8 = static_cast<int>(i % 8), n8 = static_cast<int>((i / 8) % 8);
    const int kb = static_cast<int>((i / 64) % 2);
    const long long blk = i / 128;  // (tap, kc, nb)
    const int nb = static_cast<int>(blk % groups);
    const int kc = static_cast<int>((blk / groups) % chunks);
    const int t = static_cast<int>(blk / ((long long)groups * chunks));
    const int ci = nb * 8 + n8, co = kc * 16 + kb * 8 + k8;
    tc[i] = (ci < Cin && co < Cout) ? w[((long long)co * Cin + ci) * 9 + 8 - t] : uint16_t(0);
  }
}

constexpr int kHxTH = 8;   // output rows a block
constexpr int kHxTW = 32;  // output columns a block
constexpr int kHxC = 64;   // input channels a block

// The heads' dx interior (forward Cout = 1): dx[y, x, ci] = sum_{ky, kx}
// dpre[y + 1 - ky, x + 1 - kx] w[0, ci, ky, kx], zero outside the image.
// grid (B * tiles_h * tiles_w, ceil(Cin / 64)); V channels a thread: 4 when
// Cin % 4 == 0 and dx is 16-byte aligned, else 1. T: fp32 or bf16 (fp32
// sums, one rounding).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    conv3x3_dx_head_kernel(const T* __restrict__ dpre, const T* __restrict__ w,
                           T* __restrict__ dx, int H, int W, int Cin, int tiles_h,
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
  const T* dp = dpre + b * H * W;
  for (int i = tid; i < (kHxTH + 2) * (kHxTW + 2); i += kThreads) {
    const int r = i / (kHxTW + 2), c = i - r * (kHxTW + 2);
    const int y = h0 - 1 + r, x = w0 - 1 + c;
    ds[r][c] = (y >= 0 && y < H && x >= 0 && x < W) ? to_float(dp[(long long)y * W + x]) : 0.f;
  }
  for (int i = tid; i < 9 * kHxC; i += kThreads) {
    const int t = i / kHxC, c = i - t * kHxC;
    ws[t][c] = c < nc ? to_float(w[(long long)(c0 + c) * 9 + t]) : 0.f;
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
    T* dst = dx + ((b * H + y) * W + x) * Cin + c0 + gi * V;
    if constexpr (V == 4) {
      store4(dst, acc);
    } else {
      dst[0] = from_float<T>(acc[0]);
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
  const void* dpre;   // (B, H, W, Cout), fp32 or bf16
  const float* slab;  // (9, kp, np): conv3x3_dx_slab_kernel's
  void* dx;           // (B, H, W, Cin) in dpre's dtype, the interior in it
  int B, H, W, Cin, Cout, kp, np;
  int top, bot, left, right;  // where the padded rows -1 and H, columns -1 and W land
  int rows[2], nr;            // R ascending
  int cols[2], nc;            // C ascending
  int nseg, tile;              // segments; destinations a tile
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
  const int d = base * a.tile + p;
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
// the grid. fp32 (the bf16 fold runs on the tensor cores:
// conv3x3_dx_fold_tc_kernel).
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
        raw[j][k] = __ldg(static_cast<const float*>(a.dpre) +
                              (v ? (long long)off[j][k] * a.Cout + co : 0));
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
    float* dst = static_cast<float*>(a.dx) + (((long long)b * a.H + y) * a.W + x) * a.Cin;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = n0 + ng * 4 + j;
      if (ci < a.Cin) dst[ci] += acc[i][j];
    }
  }
}

constexpr int kFoldTcP = 64;  // border pixels a block: four warps of 16
constexpr int kFoldTcN = 64;  // input channels a block: eight n8 tiles a warp

__device__ __forceinline__ uint32_t ldg32(const uint16_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// The bf16 border fold on mma.sync m16n8k16 (bf16 in, fp32 sums): the GEMM
// of the fold pixels (M) by Cin (N) over K = (tap of the tile's mask, extra
// term, 16 dpre channels), each extra dpre term a K entry of its own (its
// bf16 value, not a sum of terms), against the tap's w' tile of the
// tensor-core slab (conv3x3_dx_slab_bf16_kernel's: tap 8 - t holds w[.., t]).
// A row segment's pixels carry one term a tap (the border row's), a column
// segment's one (the border column's), a corner's up to three. grid (the
// segments' tiles of 64, ceil(Cin / 64)); 128 threads, warp w the tile's
// pixels 16w .. 16w + 15 by the block's 64 channels; the A and B fragments
// are read straight from device memory (32-bit loads, the slab in the L2
// and L1). Each (pixel, channel) belongs to one lane of the grid: dx +=
// the sum in fp32, rounded once more.
__global__ void __launch_bounds__(128) conv3x3_dx_fold_tc_kernel(const FoldArgs a,
                                                                 const uint16_t* __restrict__ slab,
                                                                 int KC, int NB, int vec_a) {
  __shared__ int mask_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int tile = blockIdx.x, n0 = blockIdx.y * kFoldTcN;
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
  if (tid < kFoldTcP) {
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
  // The term slots a segment's pixels can carry (fold_terms' order: inside
  // row with border column, border row with inside column, both borders).
  const int slots = kind == 0 ? 2 : kind == 1 ? 1 : 7;
  int rb[2], ry[2], rx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    fold_dest(a, kind, sy, sx, base, warp * 16 + g + 8 * h, rb[h], ry[h], rx[h]);
  const uint16_t* dp = static_cast<const uint16_t*>(a.dpre);
  // Two dpre values (channels co, co + 1) of pixel offset `off`, zero past
  // Cout and where the term does not exist.
  auto pair = [&](int off, int co) -> uint32_t {
    if (off < 0 || co >= a.Cout) return 0u;
    const uint16_t* p = dp + (long long)off * a.Cout + co;
    if (vec_a) return ldg32(p);
    return uint32_t(__ldg(p)) | (co + 1 < a.Cout ? uint32_t(__ldg(p + 1)) << 16 : 0u);
  };
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int m = mask; m != 0; m &= m - 1) {
    const int t = __ffs(m) - 1;
    int off[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      off[h][0] = off[h][1] = off[h][2] = -1;
      if (rb[h] >= 0) fold_terms(a, rb[h], ry[h], rx[h], t / 3, t % 3, off[h]);
    }
    const uint16_t* bt = slab + (long long)(8 - t) * KC * NB * 128;
#pragma unroll
    for (int sl = 0; sl < 3; ++sl) {
      if (!((slots >> sl) & 1)) continue;
      for (int kc = 0; kc < KC; ++kc) {
        const int co = kc * 16 + 2 * q;
        uint32_t af[4];
        af[0] = pair(off[0][sl], co);
        af[1] = pair(off[1][sl], co);
        af[2] = pair(off[0][sl], co + 8);
        af[3] = pair(off[1][sl], co + 8);
        const uint16_t* bk = bt + (long long)kc * NB * 128 + g * 8 + 2 * q;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int nb = n0 / 8 + j;
          if (nb < NB) mma_bf16(acc[j], af, ldg32(bk + nb * 128), ldg32(bk + nb * 128 + 64));
        }
      }
    }
  }
  // A fragment holds (row g, channels 2q, 2q + 1) and (row g + 8, the same)
  // of each 8 channels.
  __nv_bfloat16* dx = static_cast<__nv_bfloat16*>(a.dx);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rb[h] < 0) continue;
    __nv_bfloat16* dst = dx + (((long long)rb[h] * a.H + ry[h]) * a.W + rx[h]) * a.Cin;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ci = n0 + j * 8 + 2 * q + e;
        if (ci < a.Cin) dst[ci] = __float2bfloat16(__bfloat162float(dst[ci]) + acc[j][2 * h + e]);
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
// slices q, q + G, ... in order, and the groups' sums meet in group order;
// one rounding to OutT (fp32 or bf16).
template <int E, typename OutT>
__global__ void __launch_bounds__(kThreads)
    conv3x3_dw_reduce_kernel(const float* __restrict__ ws, OutT* __restrict__ dw,
                             OutT* __restrict__ db, int slices, int Cin, long long total) {
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
  if (n == 9LL * Cin) db[co] = from_float<OutT>(s);
  else dw[co * 9LL * Cin + n] = from_float<OutT>(s);
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

// The slices of `strips` strips over `tiles` output tiles: the count whose
// busiest block walks the fewest strips, taking blocks beyond the `cap`
// co-resident ones as further waves; fewer slices on a tie. plan: {slices,
// workspace floats, strips a slice}.
void split_strips(long long strips, long long tiles, int cap, int Cin, int Cout,
                  long long* plan) {
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
}

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
    split_strips(strips, tiles, cap, Cin, Cout, plan);
    return cudaSuccess;
  });
}

// ---- dW in bf16 on the tensor cores ------------------------------------------

constexpr int kTcTH = 8;   // strip rows
constexpr int kTcTW = 16;  // strip columns: a strip row is one k16 step
constexpr uint32_t kOnes = 0x3F803F80u;  // two bf16 1.0: db's B fragment

// Eight warps: WM x WN over (co, ci), each warp WMT m16 tiles of output
// channels by one n8 tile of input channels for the 9 taps (9 x WMT x 4
// sums); WK = 8 / (WM x WN) groups of warps split a strip's rows. Pitches
// padded by 8 bf16 so that the 8 rows of an ldmatrix fall in distinct
// banks. The stages hold the dpre tile (kTcTH x kTcTW pixels x BM) and the
// halo (kTcTH + 2 rows x kTcTW + 2 x BN); after the walk the same memory
// holds the tile's sums in fp32. Two blocks an SM where a thread's 36 sums
// leave room in 128 registers; one (up to 255 registers) for 72 sums, which
// ptxas spilled at 128.
template <int WMT_, int WM_, int WN_>
struct TCfg {
  static constexpr int WMT = WMT_, WM = WM_, WN = WN_;
  static constexpr int MINB = WMT == 1 ? 2 : 1;
  static constexpr int WK = 8 / (WM * WN);
  static_assert(WM * WN * WK == 8, "eight warps");
  static constexpr int BM = 16 * WMT * WM, BN = 8 * WN;
  static constexpr int TH = kTcTH, TW = kTcTW;
  static constexpr int DP = BM + 8;  // dpre pixel pitch (bf16)
  static constexpr int XP = BN + 8;  // halo pixel pitch (bf16)
  static constexpr int DPRE = TH * TW * DP;
  static constexpr int HALO = (TH + 2) * (TW + 2) * XP;
  static constexpr int STAGE = DPRE + HALO;  // bf16 elements, a multiple of 8
  static constexpr int PIPE_BYTES = 2 * STAGE * 2;
  static constexpr int RED_BYTES = (BM * BN * 9 + BM) * 4;
  static constexpr int SMEM = PIPE_BYTES > RED_BYTES ? PIPE_BYTES : RED_BYTES;
};

struct TArgs {
  const uint16_t* dpre;  // (B, H, W, Cout) bf16
  const uint16_t* x;     // (B, H, W, Cin) bf16
  float* ws;             // (splits, Cout, N) partial sums
  int B, H, W, Cin, Cout, border;
  int strips_h, strips_w;
  long long strips;      // B * strips_h * strips_w
  int per_split;         // strips a slice
  int tiles_n;           // Cin tiles
  int N;                 // 9 * Cin + 1: (ci, tap) columns, then db's
  int vec_d, vec_x;      // 16-byte copies of dpre / x
};

// Two 8x8 bf16 matrices, transposed: lanes 0-15 point at rows k = 0..15 of
// a row-major (k, n) block at columns n0..n0+7; r is the B fragment (b0,
// b1) of mma.m16n8k16 for those columns.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const uint16_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// grid (Cout tiles x Cin tiles, splits), the Cin tile fastest.
template <class Cfg>
__global__ void __launch_bounds__(256, Cfg::MINB) conv3x3_dw_tc_kernel(const TArgs a) {
  constexpr int WMT = Cfg::WMT, WM = Cfg::WM, WN = Cfg::WN, WK = Cfg::WK;
  constexpr int BM = Cfg::BM, BN = Cfg::BN, TH = Cfg::TH, TW = Cfg::TW;
  constexpr int DP = Cfg::DP, XP = Cfg::XP;
  extern __shared__ __align__(128) unsigned char dw_smem[];
  uint16_t* smem = reinterpret_cast<uint16_t*>(dw_smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % WN, wm = (warp / WN) % WM, wk = warp / (WN * WM);
  const int nt = blockIdx.x % a.tiles_n, mt = blockIdx.x / a.tiles_n;
  const int co0 = mt * BM, ci0 = nt * BN;
  const int split = blockIdx.y;
  const long long s_lo = (long long)split * a.per_split;
  const int ns = static_cast<int>(min((long long)a.per_split, a.strips - s_lo));
  const int cw = min(BM, a.Cout - co0);  // the tile's output channels
  if (!a.vec_d) {
    // The scalar staging writes the tile's channels alone: the rest of both
    // stages' dpre tiles stays zero.
    for (int i = tid; i < 2 * Cfg::STAGE; i += 256) smem[i] = 0;
    __syncthreads();
  }

  auto strip_at = [&](long long s, int& b, int& oy0, int& ox0) {
    ox0 = static_cast<int>(s % a.strips_w) * TW;
    const long long t = s / a.strips_w;
    oy0 = static_cast<int>(t % a.strips_h) * TH;
    b = static_cast<int>(t / a.strips_h);
  };

  // Strip s into a stage: the dpre tile (zero past the image and Cout),
  // then the input's halo (border from indices; zero past Cin and where
  // the zero border reads outside the image).
  auto load = [&](long long s, uint16_t* st) {
    int b, oy0, ox0;
    strip_at(s, b, oy0, ox0);
    if (a.vec_d) {
      constexpr int V = BM / 8;
      for (int i = tid; i < TH * TW * V; i += 256) {
        const int v = i % V, p = i / V;
        const int oy = oy0 + p / TW, ox = ox0 + p % TW, co = co0 + v * 8;
        const bool ok = oy < a.H && ox < a.W && co < a.Cout;
        const uint16_t* src =
            ok ? a.dpre + (((long long)b * a.H + oy) * a.W + ox) * a.Cout + co : a.dpre;
        cp_async16(st + p * DP + v * 8, src, ok);
      }
    } else {
      // The tile's channels past Cout stay zero from the start.
      for (int i = tid; i < TH * TW * cw; i += 256) {
        const int m = i % cw, p = i / cw;
        const int oy = oy0 + p / TW, ox = ox0 + p % TW;
        const bool ok = oy < a.H && ox < a.W;
        st[p * DP + m] =
            ok ? a.dpre[(((long long)b * a.H + oy) * a.W + ox) * a.Cout + co0 + m] : uint16_t(0);
      }
    }
    uint16_t* xs = st + Cfg::DPRE;
    const uint16_t* xb = a.x + (long long)b * a.H * a.W * a.Cin;
    if (a.vec_x) {
      constexpr int V = BN / 8;
      for (int i = tid; i < (TH + 2) * (TW + 2) * V; i += 256) {
        const int v = i % V, pos = i / V;
        const int r = pos / (TW + 2), c = pos - r * (TW + 2);
        const int hs = src_index(oy0 - 1 + r, a.H, a.border);
        const int wsrc = src_index(ox0 - 1 + c, a.W, a.border);
        const int ci = ci0 + v * 8;
        const bool ok = hs >= 0 && wsrc >= 0 && ci < a.Cin;
        const uint16_t* src = ok ? xb + ((long long)hs * a.W + wsrc) * a.Cin + ci : a.x;
        cp_async16(xs + pos * XP + v * 8, src, ok);
      }
    } else {
      for (int i = tid; i < (TH + 2) * (TW + 2) * BN; i += 256) {
        const int n = i % BN, pos = i / BN;
        const int r = pos / (TW + 2), c = pos - r * (TW + 2);
        const int hs = src_index(oy0 - 1 + r, a.H, a.border);
        const int wsrc = src_index(ox0 - 1 + c, a.W, a.border);
        const int ci = ci0 + n;
        const bool ok = hs >= 0 && wsrc >= 0 && ci < a.Cin;
        xs[pos * XP + n] = ok ? xb[((long long)hs * a.W + wsrc) * a.Cin + ci] : uint16_t(0);
      }
    }
  };

  float acc[9][WMT][4];
  float dacc[WMT][4];
#pragma unroll
  for (int i = 0; i < WMT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dacc[i][e] = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) acc[t][i][e] = 0.f;
    }

  // A: lanes 8j .. 8j + 7 point at pixels (j / 2) * 8 + 0..7 of the row, at
  // output channels (j % 2) * 8 of the m16 tile: matrices (k 0-7, m 0-7),
  // (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15) transposed are a0-a3.
  const int a_pix = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int a_col = wm * WMT * 16 + ((lane >> 3) & 1) * 8;
  // B: lanes 0-15 point at the 16 pixels of the row for one tap, lanes
  // 16-31 for the next.
  const int b_pix = lane & 15, b_second = lane >> 4;

  if (ns > 0) {
    load(s_lo, smem);
    cp_async_commit();
  }
  for (int k = 0; k < ns; ++k) {
    cp_async_wait<0>();
    // Strip k has landed for every thread, and every warp is done with
    // strip k - 1, whose stage the next load overwrites.
    __syncthreads();
    if (k + 1 < ns) {
      load(s_lo + k + 1, smem + ((k + 1) & 1) * Cfg::STAGE);
      cp_async_commit();
    }
    const uint16_t* ds = smem + (k & 1) * Cfg::STAGE;
    const uint16_t* xs = ds + Cfg::DPRE;
    int b, oy0, ox0;
    strip_at(s_lo + k, b, oy0, ox0);
    for (int rr = wk; rr < TH && oy0 + rr < a.H; rr += WK) {
      uint32_t af[WMT][4];
#pragma unroll
      for (int i = 0; i < WMT; ++i)
        ldsm_x4_trans(af[i], ds + (rr * TW + a_pix) * DP + a_col + i * 16);
#pragma unroll
      for (int t = 0; t < 8; t += 2) {
        const int tap = t + b_second;
        uint32_t bf[4];
        ldsm_x4_trans(bf, xs + ((rr + tap / 3) * (TW + 2) + b_pix + tap % 3) * XP + wn * 8);
#pragma unroll
        for (int i = 0; i < WMT; ++i) {
          mma_bf16(acc[t][i], af[i], bf[0], bf[1]);
          mma_bf16(acc[t + 1][i], af[i], bf[2], bf[3]);
        }
      }
      uint32_t bl[2];
      ldsm_x2_trans(bl, xs + ((rr + 2) * (TW + 2) + b_pix + 2) * XP + wn * 8);
#pragma unroll
      for (int i = 0; i < WMT; ++i) mma_bf16(acc[8][i], af[i], bl[0], bl[1]);
      if (wn == 0) {
#pragma unroll
        for (int i = 0; i < WMT; ++i) mma_bf16(dacc[i], af[i], kOnes, kOnes);
      }
    }
  }

  // The groups' sums meet in shared memory in group order: red[(m * BN + n)
  // * 9 + t], then db's BM values (every column of a db fragment holds its
  // row's sum); then the tile goes out as contiguous runs. A fragment holds
  // (row g, columns 2q, 2q + 1) and (row g + 8, the same columns).
  float* red = reinterpret_cast<float*>(dw_smem);
  __syncthreads();  // every warp is done with the stages
  const int g = lane >> 2, q = lane & 3;
  for (int l = 0; l < WK; ++l) {
    if (wk == l) {
#pragma unroll
      for (int i = 0; i < WMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = wm * WMT * 16 + i * 16 + g + 8 * h;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = wn * 8 + 2 * q + e;
#pragma unroll
            for (int t = 0; t < 9; ++t) {
              float* r = red + (m * BN + n) * 9 + t;
              *r = l == 0 ? acc[t][i][2 * h + e] : *r + acc[t][i][2 * h + e];
            }
          }
          if (wn == 0 && q == 0) {
            float* r = red + BM * BN * 9 + m;
            *r = l == 0 ? dacc[i][2 * h] : *r + dacc[i][2 * h];
          }
        }
    }
    __syncthreads();
  }
  float* out = a.ws + (long long)split * a.Cout * a.N;
  for (int i = tid; i < BM * BN * 9; i += 256) {
    const int m = i / (BN * 9), rest = i - m * BN * 9;
    const int co = co0 + m, ci = ci0 + rest / 9;
    if (co < a.Cout && ci < a.Cin) out[(long long)co * a.N + ci0 * 9 + rest] = red[i];
  }
  if (nt == 0)
    for (int m = tid; m < BM; m += 256)
      if (co0 + m < a.Cout) out[(long long)(co0 + m) * a.N + 9 * a.Cin] = red[BM * BN * 9 + m];
}

// Calls f with the mma.sync dW configuration for Cin (dw_bf16_route gives
// it Cout 2-16): 16 or 32 input channels a tile, 16 output channels.
template <typename F>
auto with_dw_tc_cfg(int Cin, int Cout, F f) {
  if (Cin <= 16) return f(TCfg<1, 1, 2>{});
  return f(TCfg<1, 1, 4>{});
}

template <class Cfg>
cudaError_t dw_tc_capacity(int device, int* cap) {
  static int cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    const auto kernel = &conv3x3_dw_tc_kernel<Cfg>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[device] = per_sm * sms;
  }
  *cap = cached[device];
  return cudaSuccess;
}

cudaError_t dw_tc_plan(int B, int H, int W, int Cin, int Cout, int device, long long* plan) {
  return with_dw_tc_cfg(Cin, Cout, [&](auto cfg) {
    using Cfg = decltype(cfg);
    int cap = 0;
    const cudaError_t err = dw_tc_capacity<Cfg>(device, &cap);
    if (err != cudaSuccess) return err;
    const long long strips = (long long)B * ((H + Cfg::TH - 1) / Cfg::TH) *
                             ((W + Cfg::TW - 1) / Cfg::TW);
    const long long tiles =
        (long long)((Cout + Cfg::BM - 1) / Cfg::BM) * ((Cin + Cfg::BN - 1) / Cfg::BN);
    split_strips(strips, tiles, cap, Cin, Cout, plan);
    return cudaSuccess;
  });
}

// ---- dW in bf16 on wgmma -----------------------------------------------------

constexpr int kWgThreads = 384;                 // three warpgroups, one kernel row each
constexpr int kWgBM = 64;                       // output channels a block: one m64 tile
constexpr int kWgTH = kTcTH, kWgTW = kTcTW;     // strips of 8 x 16: a strip row is one k16
constexpr int kWgHW = kWgTW + 2;                // halo width
constexpr int kWgNPOS = (kWgTH + 2) * kWgHW;    // halo pixels
// Halo pixels a channel group: one past a multiple of 8, so that the
// 16-byte copies of 8 neighbouring groups of a pixel land in distinct banks.
constexpr int kWgNP = (kWgNPOS + 7) / 8 * 8 + 1;
constexpr int kWgDP = kWgBM + 8;                // dpre pixel pitch (bf16): ldmatrix rows in distinct banks
constexpr int kWgDPRE = kWgTH * kWgTW * kWgDP;  // a stage's dpre tile (bf16)
constexpr int kWgOnes = 128;                    // db's B: a 16 x 8 tile of bf16 ones
static_assert(kWgNP % 8 == 1, "8 channel groups of a pixel in distinct banks");

// BN input channels a block. A stage holds the dpre tile, pixel-major (the
// A operand, dpre transposed, read by ldmatrix.trans into registers), and
// the input's halo as [BN / 8][pixel][8 channels]: wgmma's MN-major B, whose
// core matrices are 8 consecutive pixels of one channel group, so a tap's
// shift is a 16-byte step of the descriptor's start. After the walk the
// same memory holds the tile's sums in fp32.
template <int BN_, int DG_>
struct WgCfg {
  static constexpr int BN = BN_;
  static constexpr int DG = DG_;                   // dpre channel groups staged: Cout <= 8 DG
  static constexpr int S = 5;                       // stages
  static constexpr int L = S - 2;                   // strips loaded ahead
  static constexpr int HALO = BN / 8 * kWgNP * 8;  // bf16
  static constexpr int STAGE = kWgDPRE + HALO;     // bf16, a multiple of 8
  static constexpr int PIPE_BYTES = S * STAGE * 2;
  static constexpr int RED_BYTES = (kWgBM * BN * 9 + kWgBM) * 4;
  static constexpr int ONES_AT = (PIPE_BYTES > RED_BYTES ? PIPE_BYTES : RED_BYTES);
  static constexpr int SMEM = ONES_AT + kWgOnes * 2;
};

// grid (Cout tiles x Cin tiles, splits), the Cin tile fastest. Warpgroup wg
// sums kernel row ky = wg: taps (wg, 0), (wg, 1), (wg, 2) on m64nBNk16, 3 x
// BN / 2 sums a thread, and db, A against a B of ones (m64n8k16). Per strip
// row each warp reads its A fragment once for its warpgroup's three taps;
// a row's four products go out as one group, waited one row later, while
// the next strips load.
template <class Cfg>
__global__ void __launch_bounds__(kWgThreads, 1) conv3x3_dw_wgmma_kernel(const TArgs a) {
  constexpr int BN = Cfg::BN, TH = kWgTH, TW = kWgTW, S = Cfg::S, L = Cfg::L;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  uint16_t* smem = reinterpret_cast<uint16_t*>(wg_smem);
  uint16_t* ones = reinterpret_cast<uint16_t*>(wg_smem + Cfg::ONES_AT);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int nt = blockIdx.x % a.tiles_n, mt = blockIdx.x / a.tiles_n;
  const int co0 = mt * kWgBM, ci0 = nt * BN;
  const int split = blockIdx.y;
  const long long s_lo = (long long)split * a.per_split;
  const int ns = static_cast<int>(min((long long)a.per_split, a.strips - s_lo));
  const int cw = min(kWgBM, a.Cout - co0);  // the tile's output channels
  for (int i = tid; i < kWgOnes; i += kWgThreads) ones[i] = 0x3F80;
  if (!a.vec_d || !a.vec_x || Cfg::DG < kWgBM / 8) {
    // The scalar stagings write the tile's channels alone, and the copies
    // the first DG channel groups of dpre: the rest of every stage stays
    // zero.
    for (int i = tid; i < S * Cfg::STAGE; i += kWgThreads) smem[i] = 0;
  }
  __syncthreads();

  auto strip_at = [&](long long s, int& b, int& oy0, int& ox0) {
    ox0 = static_cast<int>(s % a.strips_w) * TW;
    const long long t = s / a.strips_w;
    oy0 = static_cast<int>(t % a.strips_h) * TH;
    b = static_cast<int>(t / a.strips_h);
  };

  // Strip s into a stage: the dpre tile (zero past the image and Cout),
  // then the input's halo (border from indices; zero past Cin and where
  // the zero border reads outside the image).
  auto load = [&](long long s, uint16_t* st) {
    int b, oy0, ox0;
    strip_at(s, b, oy0, ox0);
    if (a.vec_d) {
      constexpr int DG = Cfg::DG;
#pragma unroll 1
      for (int i = tid; i < TH * TW * DG; i += kWgThreads) {
        const int v = i % DG, p = i / DG;
        const int oy = oy0 + p / TW, ox = ox0 + p % TW, co = co0 + v * 8;
        const bool ok = oy < a.H && ox < a.W && co < a.Cout;
        const uint16_t* src =
            ok ? a.dpre + (((long long)b * a.H + oy) * a.W + ox) * a.Cout + co : a.dpre;
        cp_async16(st + p * kWgDP + v * 8, src, ok);
      }
    } else {
      for (int i = tid; i < TH * TW * cw; i += kWgThreads) {
        const int m = i % cw, p = i / cw;
        const int oy = oy0 + p / TW, ox = ox0 + p % TW;
        const bool ok = oy < a.H && ox < a.W;
        st[p * kWgDP + m] =
            ok ? a.dpre[(((long long)b * a.H + oy) * a.W + ox) * a.Cout + co0 + m] : uint16_t(0);
      }
    }
    uint16_t* xs = st + kWgDPRE;
    const uint16_t* xb = a.x + (long long)b * a.H * a.W * a.Cin;
    if (a.vec_x) {
      constexpr int V = BN / 8;
#pragma unroll 1
      for (int i = tid; i < kWgNPOS * V; i += kWgThreads) {
        const int v = i % V, pos = i / V;
        const int r = pos / kWgHW, c = pos - r * kWgHW;
        const int hs = src_index(oy0 - 1 + r, a.H, a.border);
        const int wsrc = src_index(ox0 - 1 + c, a.W, a.border);
        const int ci = ci0 + v * 8;
        const bool ok = hs >= 0 && wsrc >= 0 && ci < a.Cin;
        const uint16_t* src = ok ? xb + ((long long)hs * a.W + wsrc) * a.Cin + ci : a.x;
        cp_async16(xs + (v * kWgNP + pos) * 8, src, ok);
      }
    } else {
      for (int i = tid; i < kWgNPOS * BN; i += kWgThreads) {
        const int n = i % BN, pos = i / BN;
        const int r = pos / kWgHW, c = pos - r * kWgHW;
        const int hs = src_index(oy0 - 1 + r, a.H, a.border);
        const int wsrc = src_index(ox0 - 1 + c, a.W, a.border);
        const int ci = ci0 + n;
        const bool ok = hs >= 0 && wsrc >= 0 && ci < a.Cin;
        xs[((n >> 3) * kWgNP + pos) * 8 + (n & 7)] =
            ok ? xb[((long long)hs * a.W + wsrc) * a.Cin + ci] : uint16_t(0);
      }
    }
  };

  // The tile's sums. No instruction but the products writes them: the
  // first strip's first row writes them fresh (scale-d 0; a block walks at
  // least one strip). Every warpgroup sums db (an n8 product a row) and the
  // first warpgroup of the first Cin tile writes it: no product sits on a
  // branch, which would make ptxas serialize them.
  float acc[3][BN / 2];
  float dacc[4];
  const uint64_t ones_desc = smem_desc(ones, 128, 256);
  // A: lanes 8j .. 8j + 7 point at pixels (j / 2) * 8 + 0..7 of the row, at
  // output channels (j % 2) * 8 of the warp's m16 rows: matrices (k 0-7, m
  // 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15) transposed are
  // a0-a3 (as in conv3x3_dw_tc_kernel).
  const int a_pix = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int a_col = wq * 16 + ((lane >> 3) & 1) * 8;
  // The A fragments of two strip rows: a row's products read them after
  // issue, so a row's registers stay live until the next row's wait.
  uint32_t af[2][4] = {};

#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (i < ns) load(s_lo + i, smem + i * Cfg::STAGE);
    cp_async_commit();
  }
  for (int k = 0; k < ns; ++k) {
    cp_async_wait<L - 1>();
    // The halo is read by wgmma through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // Strip k has landed for every thread; every warpgroup's products of
    // strip k - 2 are done (a row's wait leaves only the row before it).
    __syncthreads();
    if (k + L < ns) load(s_lo + k + L, smem + ((k + L) % S) * Cfg::STAGE);
    cp_async_commit();
    const uint16_t* ds = smem + (k % S) * Cfg::STAGE;
    const uint16_t* xs = ds + kWgDPRE;
    // B of tap (wg, kx) at strip row rr, MN-major: the halo from pixel
    // (rr + wg, kx), 8 pixels a core matrix, the next 8 pixels 128 bytes on
    // (the leading offset), the next 8 input channels a group on (the
    // stride offset). A strip's rows past H hold zero dpre: their products
    // add nothing.
    const uint64_t dbx = smem_desc(xs + wg * kWgHW * 8, 128, kWgNP * 16);
#pragma unroll
    for (int rr = 0; rr < TH; ++rr) {
      ldsm_x4_trans(af[rr & 1], ds + (rr * TW + a_pix) * kWgDP + a_col);
      wgmma_fence();
      const int scale = rr > 0 || k > 0;
#pragma unroll
      for (int t = 0; t < 3; ++t)
        wgmma_rs_tb<1>(acc[t], af[rr & 1], dbx + (((rr * kWgHW + t) * 16) >> 4), scale);
      wgmma_rs_tb<0>(dacc, af[rr & 1], ones_desc, scale);
      wgmma_commit();
      // The previous row's products are done: only now may its fragment
      // registers take the next row's loads.
      wgmma_wait<1>();
      keep_live(af[(rr + 1) & 1]);
    }
  }
  wgmma_wait<0>();
  keep_live(af[0]);
  keep_live(af[1]);
#pragma unroll
  for (int t = 0; t < 3; ++t) fence_operand(acc[t]);
  fence_operand(dacc);
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done with the stages

  // The tile's sums in shared memory, red[(m * BN + n) * 9 + tap] (each
  // warpgroup its own taps), then db's 64 values; then contiguous runs. A
  // fragment holds (row g, columns 2q, 2q + 1) and (row g + 8, the same) of
  // each 8 columns.
  float* red = reinterpret_cast<float*>(wg_smem);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          red[((wq * 16 + g + 8 * h) * BN + j * 8 + 2 * q + e) * 9 + wg * 3 + t] =
              acc[t][4 * j + 2 * h + e];
  if (wg == 0 && nt == 0 && q == 0) {
    red[kWgBM * BN * 9 + wq * 16 + g] = dacc[0];
    red[kWgBM * BN * 9 + wq * 16 + g + 8] = dacc[2];
  }
  __syncthreads();
  float* out = a.ws + (long long)split * a.Cout * a.N;
  for (int i = tid; i < kWgBM * BN * 9; i += kWgThreads) {
    const int m = i / (BN * 9), rest = i - m * BN * 9;
    const int co = co0 + m, ci = ci0 + rest / 9;
    if (co < a.Cout && ci < a.Cin) out[(long long)co * a.N + ci0 * 9 + rest] = red[i];
  }
  if (nt == 0)
    for (int m = tid; m < kWgBM; m += kWgThreads)
      if (co0 + m < a.Cout) out[(long long)(co0 + m) * a.N + 9 * a.Cin] = red[kWgBM * BN * 9 + m];
}

// ---- dW of the heads (Cout = 1) in bf16 on the CUDA cores ------------------

constexpr int kHwThreads = 256;
constexpr int kHwTH = 8;       // strip rows
constexpr int kHwStages = 2;

// C input channels a block (a channel pair a thread), TW strip columns.
// The threads form LANES = 256 / (C / 2) pixel lanes; a lane walks SEG
// columns of RPL strip rows, holding its channel pair's 3 x 3 window of the
// halo in registers and sliding it one column a pixel: 3 new halo words
// and one dpre value a pixel for 18 FMAs.
template <int C_, int TW_>
struct HwCfg {
  static constexpr int C = C_, TW = TW_;
  static constexpr int CP = C / 2;                  // channel pairs
  static constexpr int LANES = kHwThreads / CP;
  static constexpr int RPL = LANES >= kHwTH ? 1 : kHwTH / LANES;   // rows a lane
  static constexpr int SEGS = LANES >= kHwTH ? LANES / kHwTH : 1;  // lanes a row
  static constexpr int SEG = TW / SEGS;             // columns a lane
  static constexpr int HP = C + 8;                  // halo pixel pitch (bf16)
  static constexpr int HALO = (kHwTH + 2) * (TW + 2) * HP;
  static constexpr int DPRE = kHwTH * TW;           // dpre, fp32
  static constexpr int STAGE = HALO * 2 + DPRE * 4;  // bytes, a multiple of 16
  static constexpr int RED = LANES * (9 * C + 1);   // the lanes' sums, fp32
  static constexpr int SMEM = kHwStages * STAGE > RED * 4 ? kHwStages * STAGE : RED * 4;
  static_assert(LANES >= kHwTH ? LANES == kHwTH * SEGS : LANES * RPL == kHwTH,
                "the lanes tile the strip's rows");
  static_assert(TW % SEGS == 0, "the lanes tile the strip's columns");
  static_assert(STAGE % 16 == 0, "stages stay 16-byte aligned");
};

// grid (Cin tiles of C, splits). The dpre tile is staged in fp32 (a 16-bit
// value a pixel), the halo (border from indices, zero past the image under
// the zero border and past Cin) by 16-byte cp.async; two stages, the next
// strip in flight, three blocks an SM (more stages at fewer blocks an SM
// ran slower on an H100). After the walk the lanes' sums meet in lane
// order.
template <class Cfg>
__global__ void __launch_bounds__(kHwThreads, 3) conv3x3_dw_head_kernel(const TArgs a) {
  constexpr int C = Cfg::C, TW = Cfg::TW, CP = Cfg::CP, HP = Cfg::HP, S = kHwStages;
  extern __shared__ __align__(128) unsigned char hw_smem[];
  const int tid = threadIdx.x;
  const int cp = tid % CP, lane = tid / CP;
  const int ci0 = blockIdx.x * C;
  const int split = blockIdx.y;
  const long long s_lo = (long long)split * a.per_split;
  const int ns = static_cast<int>(min((long long)a.per_split, a.strips - s_lo));

  auto strip_at = [&](long long s, int& b, int& oy0, int& ox0) {
    ox0 = static_cast<int>(s % a.strips_w) * TW;
    const long long t = s / a.strips_w;
    oy0 = static_cast<int>(t % a.strips_h) * kHwTH;
    b = static_cast<int>(t / a.strips_h);
  };
  auto halo_of = [&](int st) { return reinterpret_cast<uint16_t*>(hw_smem + st * Cfg::STAGE); };
  auto dpre_of = [&](int st) {
    return reinterpret_cast<float*>(hw_smem + st * Cfg::STAGE + Cfg::HALO * 2);
  };

  auto load = [&](long long s, int st) {
    int b, oy0, ox0;
    strip_at(s, b, oy0, ox0);
    uint16_t* xs = halo_of(st);
    const uint16_t* xb = a.x + (long long)b * a.H * a.W * a.Cin;
    constexpr int NPOS = (kHwTH + 2) * (TW + 2);
    if (a.vec_x) {
      constexpr int V = C / 8;
      for (int i = tid; i < NPOS * V; i += kHwThreads) {
        const int v = i % V, pos = i / V;
        const int r = pos / (TW + 2), c = pos - r * (TW + 2);
        const int hs = src_index(oy0 - 1 + r, a.H, a.border);
        const int wsrc = src_index(ox0 - 1 + c, a.W, a.border);
        const int ci = ci0 + v * 8;
        const bool ok = hs >= 0 && wsrc >= 0 && ci < a.Cin;
        cp_async16(xs + pos * HP + v * 8,
                   ok ? xb + ((long long)hs * a.W + wsrc) * a.Cin + ci : a.x, ok);
      }
    } else {
      for (int i = tid; i < NPOS * C; i += kHwThreads) {
        const int n = i % C, pos = i / C;
        const int r = pos / (TW + 2), c = pos - r * (TW + 2);
        const int hs = src_index(oy0 - 1 + r, a.H, a.border);
        const int wsrc = src_index(ox0 - 1 + c, a.W, a.border);
        const bool ok = hs >= 0 && wsrc >= 0 && ci0 + n < a.Cin;
        xs[pos * HP + n] = ok ? xb[((long long)hs * a.W + wsrc) * a.Cin + ci0 + n] : uint16_t(0);
      }
    }
    float* ds = dpre_of(st);
    for (int p = tid; p < kHwTH * TW; p += kHwThreads) {
      const int oy = oy0 + p / TW, ox = ox0 + p % TW;
      ds[p] = oy < a.H && ox < a.W
                  ? __uint_as_float(uint32_t(a.dpre[((long long)b * a.H + oy) * a.W + ox]) << 16)
                  : 0.f;
    }
  };

  float acc[9][2], dsum = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t][0] = acc[t][1] = 0.f;
  // This lane's rows and columns of a strip.
  const int row0 = (lane % (Cfg::LANES >= kHwTH ? kHwTH : Cfg::LANES)) * Cfg::RPL;
  const int col0 = (Cfg::LANES >= kHwTH ? lane / kHwTH : 0) * Cfg::SEG;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < ns) load(s_lo + i, i);
    cp_async_commit();
  }
  for (int k = 0; k < ns; ++k) {
    cp_async_wait<S - 2>();
    // Strip k has landed for every thread (the dpre tile by plain stores),
    // and every lane is done with strip k - 1, whose stage the load below
    // overwrites.
    __syncthreads();
    if (k + S - 1 < ns) load(s_lo + k + S - 1, (k + S - 1) % S);
    cp_async_commit();
    const uint16_t* xs = halo_of(k % S);
    const float* ds = dpre_of(k % S);
#pragma unroll
    for (int rr = 0; rr < Cfg::RPL; ++rr) {
      const int r = row0 + rr;
      // The window of halo columns c .. c + 2 of rows r .. r + 2, as
      // channel pairs.
      uint32_t win[3][3];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 2; ++kx)
          win[ky][kx + 1] = lds32(xs + ((r + ky) * (TW + 2) + col0 + kx) * HP + 2 * cp);
#pragma unroll 4
      for (int c = 0; c < Cfg::SEG; ++c) {
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          win[ky][0] = win[ky][1];
          win[ky][1] = win[ky][2];
          win[ky][2] = lds32(xs + ((r + ky) * (TW + 2) + col0 + c + 2) * HP + 2 * cp);
        }
        const float d = ds[r * TW + col0 + c];
        dsum += d;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            acc[ky * 3 + kx][0] = fmaf(d, __uint_as_float(win[ky][kx] << 16), acc[ky * 3 + kx][0]);
            acc[ky * 3 + kx][1] =
                fmaf(d, __uint_as_float(win[ky][kx] & 0xffff0000u), acc[ky * 3 + kx][1]);
          }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every lane is done with the stages

  // red[lane][(ci * 9 + tap)], then db at [lane][9 C]; the lanes added in
  // lane order, then the tile's columns written whole.
  float* red = reinterpret_cast<float*>(hw_smem);
  constexpr int RW = 9 * C + 1;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    red[lane * RW + (2 * cp) * 9 + t] = acc[t][0];
    red[lane * RW + (2 * cp + 1) * 9 + t] = acc[t][1];
  }
  if (cp == 0) red[lane * RW + 9 * C] = dsum;
  __syncthreads();
  float* out = a.ws + (long long)split * a.N;
  for (int i = tid; i < RW; i += kHwThreads) {
    float v = red[i];
    for (int l = 1; l < Cfg::LANES; ++l) v += red[l * RW + i];
    if (i < 9 * C) {
      if (ci0 + i / 9 < a.Cin) out[ci0 * 9 + i] = v;
    } else if (blockIdx.x == 0) {
      out[9 * a.Cin] = v;
    }
  }
}

// Calls f with the heads' dW configuration for Cin: 16, 32 or 64 channels
// a block and 64, 32 or 16 strip columns; 128 (16 columns) above.
template <typename F>
auto with_dw_head_cfg(int Cin, F f) {
  if (Cin <= 16) return f(HwCfg<16, 64>{});
  if (Cin <= 32) return f(HwCfg<32, 32>{});
  if (Cin <= 64) return f(HwCfg<64, 16>{});
  return f(HwCfg<128, 16>{});
}

template <class Cfg>
cudaError_t dw_head_capacity(int device, int* cap) {
  static int cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    const auto kernel = &conv3x3_dw_head_kernel<Cfg>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kHwThreads, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[device] = per_sm * sms;
  }
  *cap = cached[device];
  return cudaSuccess;
}

cudaError_t dw_head_plan(int B, int H, int W, int Cin, int device, long long* plan) {
  return with_dw_head_cfg(Cin, [&](auto cfg) {
    using Cfg = decltype(cfg);
    int cap = 0;
    const cudaError_t err = dw_head_capacity<Cfg>(device, &cap);
    if (err != cudaSuccess) return err;
    const long long strips = (long long)B * ((H + kHwTH - 1) / kHwTH) *
                             ((W + Cfg::TW - 1) / Cfg::TW);
    split_strips(strips, (Cin + Cfg::C - 1) / Cfg::C, cap, Cin, 1, plan);
    return cudaSuccess;
  });
}

// The wgmma dW kernel's input channels a tile for Cin: 16, 32, 48 (Cin an
// odd multiple of 16 times 3, upconv_1_1's 96: two tiles, not three) or 64.
int dw_wgmma_bn(int Cin) {
  if (Cin <= 16) return 16;
  if (Cin <= 32) return 32;
  if (Cin % 64 != 0 && Cin % 48 == 0) return 48;
  if (Cin % 64 != 0 && Cin % 32 == 0) return 32;
  return 64;
}

// Calls f with the wgmma dW configuration for (Cin, Cout): dw_wgmma_bn's
// input tile; the dpre tile's first 4 channel groups alone where Cout <= 32
// (the m64 tile's other rows stay zero).
template <typename F>
auto with_dw_wgmma_cfg(int Cin, int Cout, F f) {
  const int bn = dw_wgmma_bn(Cin);
  if (Cout <= 32) {
    if (bn == 16) return f(WgCfg<16, 4>{});
    if (bn == 32) return f(WgCfg<32, 4>{});
    if (bn == 48) return f(WgCfg<48, 4>{});
    return f(WgCfg<64, 4>{});
  }
  if (bn == 16) return f(WgCfg<16, 8>{});
  if (bn == 32) return f(WgCfg<32, 8>{});
  if (bn == 48) return f(WgCfg<48, 8>{});
  return f(WgCfg<64, 8>{});
}

// Which bf16 dW kernel takes (Cin, Cout): 2 conv3x3_dw_wgmma_kernel (Cout
// > 16), 3 conv3x3_dw_head_kernel (the heads, Cout = 1), 1
// conv3x3_dw_tc_kernel (2-16 output channels, where the mma.sync kernel's
// 16-row tiles waste no rows).
int dw_bf16_route(int Cin, int Cout) { return Cout > 16 ? 2 : Cout == 1 ? 3 : 1; }

template <class Cfg>
cudaError_t dw_wgmma_capacity(int device, int* cap) {
  static int cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[device] == 0) {
    const auto kernel = &conv3x3_dw_wgmma_kernel<Cfg>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWgThreads, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    err = sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[device] = per_sm * sms;
  }
  *cap = cached[device];
  return cudaSuccess;
}

cudaError_t dw_wgmma_plan(int B, int H, int W, int Cin, int Cout, int device, long long* plan) {
  return with_dw_wgmma_cfg(Cin, Cout, [&](auto cfg) {
    using Cfg = decltype(cfg);
    int cap = 0;
    const cudaError_t err = dw_wgmma_capacity<Cfg>(device, &cap);
    if (err != cudaSuccess) return err;
    const long long strips = (long long)B * ((H + kWgTH - 1) / kWgTH) *
                             ((W + kWgTW - 1) / kWgTW);
    const long long tiles =
        (long long)((Cout + kWgBM - 1) / kWgBM) * ((Cin + Cfg::BN - 1) / Cfg::BN);
    split_strips(strips, tiles, cap, Cin, Cout, plan);
    return cudaSuccess;
  });
}

bool shape_ok(int B, int H, int W, int Cin, int Cout) {
  return B > 0 && H > 0 && W > 0 && Cin > 0 && Cout > 0 &&
         (long long)B * H * W < (1LL << 31) && 9LL * Cin + 1 < (1LL << 31) &&
         9LL * Cout < (1LL << 31);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool aligned_to(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

unsigned grid_for(long long n) {
  return static_cast<unsigned>(std::max<long long>(1, std::min<long long>((n + kThreads - 1) / kThreads, 1 << 16)));
}

template <typename TG, typename TD>
cudaError_t launch_dpre(const void* g, const void* out, void* dpre, long long n, int act,
                        cudaStream_t s) {
  const int vec = aligned_to(g, 4 * sizeof(TG)) && aligned_to(out, 4 * sizeof(TG)) &&
                  aligned_to(dpre, 4 * sizeof(TD));
  conv3x3_dpre_kernel<TG, TD><<<grid_for(vec ? n / 4 : n), kThreads, 0, s>>>(
      static_cast<const TG*>(g), static_cast<const TG*>(out), static_cast<TD*>(dpre), n, act,
      vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx_head(const void* dpre, const void* w, void* dx, int B, int H, int W,
                           int Cin, cudaStream_t s) {
  const int tiles_h = (H + kHxTH - 1) / kHxTH;
  const int tiles_w = (W + kHxTW - 1) / kHxTW;
  const long long blocks = (long long)B * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks), (Cin + kHxC - 1) / kHxC);
  auto kernel = (Cin % 4 == 0 && aligned16(dx)) ? &conv3x3_dx_head_kernel<T, 4>
                                                : &conv3x3_dx_head_kernel<T, 1>;
  kernel<<<grid, kThreads, 0, s>>>(static_cast<const T*>(dpre), static_cast<const T*>(w),
                                   static_cast<T*>(dx), H, W, Cin, tiles_h, tiles_w);
  return cudaGetLastError();
}

// The fold's destinations for a shape: where the padded rows and columns
// land, and the segments (each row the border lands on without the
// columns, each such column without the rows, each corner; across the
// batch) in tiles of `tile`. Returns the tiles.
int fold_setup(FoldArgs& a, int B, int H, int W, int Cin, int Cout, int border, int tile) {
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.tile = tile;
  a.top = src_index(-1, H, border);
  a.bot = src_index(H, H, border);
  a.left = src_index(-1, W, border);
  a.right = src_index(W, W, border);
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
    tiles += (count + tile - 1) / tile;
  };
  for (int i = 0; i < a.nr; ++i) add(0, a.rows[i], 0, B * (W - a.nc));
  for (int j = 0; j < a.nc; ++j) add(1, 0, a.cols[j], B * (H - a.nr));
  for (int i = 0; i < a.nr; ++i)
    for (int j = 0; j < a.nc; ++j) add(2, a.rows[i], a.cols[j], B);
  a.seg_tile[a.nseg] = tiles;
  return tiles;
}

template <typename OutT>
cudaError_t launch_dw_reduce(const float* ws, void* dw, void* db, int splits, int Cin, int Cout,
                             cudaStream_t s) {
  const long long total = (long long)Cout * (9LL * Cin + 1);
  OutT* dwp = static_cast<OutT*>(dw);
  OutT* dbp = static_cast<OutT*>(db);
  if (splits >= 64) {
    const unsigned blocks = static_cast<unsigned>((total + 7) / 8);
    conv3x3_dw_reduce_kernel<8, OutT><<<blocks, kThreads, 0, s>>>(ws, dwp, dbp, splits, Cin,
                                                                  total);
  } else {
    const unsigned blocks = static_cast<unsigned>((total + 31) / 32);
    conv3x3_dw_reduce_kernel<32, OutT><<<blocks, kThreads, 0, s>>>(ws, dwp, dbp, splits, Cin,
                                                                   total);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace sde

// dpre (n elements) = g * act'(out), in fp32, stored in ddtype; g and out in
// gdtype (0 fp32, 1 bf16): fp32 -> fp32, bf16 -> bf16 and fp32 -> bf16 (the
// heads of a bf16 network, whose g and sigmoid output are fp32). act: 0
// none, 1 elu, 2 relu, 3 sigmoid.
extern "C" int sde_conv3x3_bwd_dpre(const void* g, const void* out, void* dpre, long long n,
                                    int act, int gdtype, int ddtype, int device, void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gdtype == sde::kFloat32 && ddtype == sde::kFloat32)
    return static_cast<int>(sde::launch_dpre<float, float>(g, out, dpre, n, act, s));
  if (gdtype == sde::kBFloat16 && ddtype == sde::kBFloat16)
    return static_cast<int>(
        sde::launch_dpre<__nv_bfloat16, __nv_bfloat16>(g, out, dpre, n, act, s));
  if (gdtype == sde::kFloat32 && ddtype == sde::kBFloat16)
    return static_cast<int>(sde::launch_dpre<float, __nv_bfloat16>(g, out, dpre, n, act, s));
  return static_cast<int>(cudaErrorInvalidValue);
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

// The tensor-core slab of w' from a bf16 w (Cout, Cin, 3, 3): (9,
// round_up(Cout, 16), round_up(Cin, 8)) bf16, conv3x3_dx_slab_bf16_kernel's.
extern "C" int sde_conv3x3_bwd_slab_bf16(const void* w, void* tc, int Cin, int Cout, int device,
                                         void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Cin <= 0 || Cout <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = 9LL * sde::round_to(Cout, 16) * sde::round_to(Cin, 8);
  sde::conv3x3_dx_slab_bf16_kernel<<<sde::grid_for(n), sde::kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(w), static_cast<uint16_t*>(tc), Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

// The heads' dx interior: dx (B, H, W, Cin) from dpre (B, H, W, 1) and w
// (1, Cin, 3, 3), the zero-bordered transposed conv; all in dtype (0 fp32,
// 1 bf16), contiguous.
extern "C" int sde_conv3x3_bwd_dx_head(const void* dpre, const void* w, void* dx, int B, int H,
                                       int W, int Cin, int dtype, int device, void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!sde::shape_ok(B, H, W, Cin, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sde::kFloat32)
    return static_cast<int>(sde::launch_dx_head<float>(dpre, w, dx, B, H, W, Cin, s));
  if (dtype == sde::kBFloat16)
    return static_cast<int>(sde::launch_dx_head<__nv_bfloat16>(dpre, w, dx, B, H, W, Cin, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Adds the border's gradient to dx (B, H, W, Cin), which holds the interior:
// from dpre (B, H, W, Cout) and the fp32 slab of sde_conv3x3_bwd_slab; dpre
// and dx fp32 (dtype 0; bf16 takes sde_conv3x3_bwd_fold_bf16). border: 0
// edge, 1 reflect (2, zero, has none: nothing is launched).
extern "C" int sde_conv3x3_bwd_fold(const void* dpre, const void* slab, void* dx, int B, int H,
                                    int W, int Cin, int Cout, int border, int dtype, int device,
                                    void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!sde::shape_ok(B, H, W, Cin, Cout) || dtype != sde::kFloat32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (border == 2) return static_cast<int>(cudaSuccess);
  sde::FoldArgs a{};
  a.dpre = dpre;
  a.slab = static_cast<const float*>(slab);
  a.dx = dx;
  a.kp = sde::round_to(Cout, 8);
  a.np = sde::round_to(Cin, 4);
  const int tiles = sde::fold_setup(a, B, H, W, Cin, Cout, border, sde::kFoldP);
  const dim3 grid(tiles, (Cin + sde::kFoldN - 1) / sde::kFoldN);
  sde::conv3x3_dx_fold_kernel<<<grid, sde::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 border fold on the tensor cores: adds the border's gradient to
// dx (B, H, W, Cin) bf16, which holds the rounded interior, in fp32, and
// rounds again; from dpre (B, H, W, Cout) bf16 and the tensor-core slab of
// w' of sde_conv3x3_bwd_slab_bf16 (9, round_up(Cout, 16), round_up(Cin,
// 8)). border: 0 edge, 1 reflect (2, zero, has none: nothing is launched).
extern "C" int sde_conv3x3_bwd_fold_bf16(const void* dpre, const void* slab, void* dx, int B,
                                         int H, int W, int Cin, int Cout, int border, int device,
                                         void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!sde::shape_ok(B, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  if (border == 2) return static_cast<int>(cudaSuccess);
  sde::FoldArgs a{};
  a.dpre = dpre;
  a.dx = dx;
  const int tiles = sde::fold_setup(a, B, H, W, Cin, Cout, border, sde::kFoldTcP);
  const dim3 grid(tiles, (Cin + sde::kFoldTcN - 1) / sde::kFoldTcN);
  const int vec_a = Cout % 2 == 0 && sde::aligned_to(dpre, 4);
  sde::conv3x3_dx_fold_tc_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const uint16_t*>(slab), (Cout + 15) / 16, (Cin + 7) / 8, vec_a);
  return static_cast<int>(cudaGetLastError());
}

// How sde_conv3x3_bwd_dw runs this shape in dtype (0 fp32: the CUDA-core
// kernel; 1 bf16: the tensor-core kernels) on `device`: plan[0] the slices
// of its strips, plan[1] the fp32 workspace it needs (elements), plan[2]
// the strips a slice, plan[3] the kernel (0 conv3x3_dw_kernel, 1
// conv3x3_dw_tc_kernel, 2 conv3x3_dw_wgmma_kernel, 3
// conv3x3_dw_head_kernel).
extern "C" int sde_conv3x3_bwd_plan(int B, int H, int W, int Cin, int Cout, int dtype,
                                    int device, long long* plan) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!sde::shape_ok(B, H, W, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == sde::kFloat32) {
    plan[3] = 0;
    return static_cast<int>(sde::dw_plan(B, H, W, Cin, Cout, device, plan));
  }
  if (dtype == sde::kBFloat16) {
    plan[3] = sde::dw_bf16_route(Cin, Cout);
    return static_cast<int>(plan[3] == 2   ? sde::dw_wgmma_plan(B, H, W, Cin, Cout, device, plan)
                            : plan[3] == 3 ? sde::dw_head_plan(B, H, W, Cin, device, plan)
                                           : sde::dw_tc_plan(B, H, W, Cin, Cout, device, plan));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dw (Cout, Cin, 3, 3) and db (Cout) from dpre (B, H, W, Cout) and x (B, H,
// W, Cin); all in dtype (0 fp32, 1 bf16), contiguous. border: 0 edge, 1
// reflect, 2 zero. ws: at least plan[1] fp32 elements of
// sde_conv3x3_bwd_plan, the caller's scratch (written whole before it is
// read). Two launches: the slices' partial sums, then their sum in slice
// order, rounded once to dtype.
extern "C" int sde_conv3x3_bwd_dw(const void* dpre, const void* x, void* dw, void* db, void* ws,
                                  long long ws_elems, int B, int H, int W, int Cin, int Cout,
                                  int border, int dtype, int device, void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!sde::shape_ok(B, H, W, Cin, Cout) || (dtype != sde::kFloat32 && dtype != sde::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == sde::kFloat32;
  const int route = f32 ? 0 : sde::dw_bf16_route(Cin, Cout);
  long long plan[3];
  err = route == 0   ? sde::dw_plan(B, H, W, Cin, Cout, device, plan)
        : route == 1 ? sde::dw_tc_plan(B, H, W, Cin, Cout, device, plan)
        : route == 2 ? sde::dw_wgmma_plan(B, H, W, Cin, Cout, device, plan)
                     : sde::dw_head_plan(B, H, W, Cin, device, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ws == nullptr || ws_elems < plan[1] || plan[0] > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = static_cast<int>(plan[0]);
  if (f32) {
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
  } else if (route == 3) {
    err = sde::with_dw_head_cfg(Cin, [&](auto cfg) {
      using Cfg = decltype(cfg);
      sde::TArgs a{};
      a.dpre = static_cast<const uint16_t*>(dpre);
      a.x = static_cast<const uint16_t*>(x);
      a.ws = static_cast<float*>(ws);
      a.B = B;
      a.H = H;
      a.W = W;
      a.Cin = Cin;
      a.Cout = 1;
      a.border = border;
      a.strips_h = (H + sde::kHwTH - 1) / sde::kHwTH;
      a.strips_w = (W + Cfg::TW - 1) / Cfg::TW;
      a.strips = (long long)B * a.strips_h * a.strips_w;
      a.per_split = static_cast<int>(plan[2]);
      a.N = 9 * Cin + 1;
      a.vec_x = Cin % 8 == 0 && sde::aligned16(x);
      const dim3 grid((Cin + Cfg::C - 1) / Cfg::C, splits);
      sde::conv3x3_dw_head_kernel<Cfg><<<grid, sde::kHwThreads, Cfg::SMEM, s>>>(a);
      return cudaGetLastError();
    });
  } else if (route == 2) {
    err = sde::with_dw_wgmma_cfg(Cin, Cout, [&](auto cfg) {
      using Cfg = decltype(cfg);
      sde::TArgs a{};
      a.dpre = static_cast<const uint16_t*>(dpre);
      a.x = static_cast<const uint16_t*>(x);
      a.ws = static_cast<float*>(ws);
      a.B = B;
      a.H = H;
      a.W = W;
      a.Cin = Cin;
      a.Cout = Cout;
      a.border = border;
      a.strips_h = (H + sde::kWgTH - 1) / sde::kWgTH;
      a.strips_w = (W + sde::kWgTW - 1) / sde::kWgTW;
      a.strips = (long long)B * a.strips_h * a.strips_w;
      a.per_split = static_cast<int>(plan[2]);
      a.tiles_n = (Cin + Cfg::BN - 1) / Cfg::BN;
      a.N = 9 * Cin + 1;
      a.vec_d = Cout % 8 == 0 && sde::aligned16(dpre);
      a.vec_x = Cin % 8 == 0 && sde::aligned16(x);
      const dim3 grid(((Cout + sde::kWgBM - 1) / sde::kWgBM) * a.tiles_n, splits);
      sde::conv3x3_dw_wgmma_kernel<Cfg><<<grid, sde::kWgThreads, Cfg::SMEM, s>>>(a);
      return cudaGetLastError();
    });
  } else {
    err = sde::with_dw_tc_cfg(Cin, Cout, [&](auto cfg) {
      using Cfg = decltype(cfg);
      sde::TArgs a{};
      a.dpre = static_cast<const uint16_t*>(dpre);
      a.x = static_cast<const uint16_t*>(x);
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
      a.vec_d = Cout % 8 == 0 && sde::aligned16(dpre);
      a.vec_x = Cin % 8 == 0 && sde::aligned16(x);
      const dim3 grid(((Cout + Cfg::BM - 1) / Cfg::BM) * a.tiles_n, splits);
      sde::conv3x3_dw_tc_kernel<Cfg><<<grid, 256, Cfg::SMEM, s>>>(a);
      return cudaGetLastError();
    });
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* wsp = static_cast<const float*>(ws);
  return static_cast<int>(f32 ? sde::launch_dw_reduce<float>(wsp, dw, db, splits, Cin, Cout, s)
                              : sde::launch_dw_reduce<__nv_bfloat16>(wsp, dw, db, splits, Cin,
                                                                      Cout, s));
}
