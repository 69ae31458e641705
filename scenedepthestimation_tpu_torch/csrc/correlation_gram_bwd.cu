// correlation_gram_bwd: the gradient of correlation_gram's bf16 cost volume
//   cost[b, h, w, d] = bf16( (1/C) sum_c fl[b, h, w, c] fr[b, h, w - d, c] )
// with respect to both feature maps, given g = dL/dcost in bf16:
//   d_fl[w, c] = 1/C sum_d g[w, d] fr[w - d, c]          (w - d >= 0)
//   d_fr[w, c] = 1/C sum_d g[w + d, d] fl[w + d, c]      (w + d < W)
// every term inside one (b, h) row; bf16 products, fp32 sums, each output
// rounded to bf16 once, after the 1/C.
//
// It replaces what XLA derives for the JAX package's bf16 cost,
// scenedepthestimation_tpu/ops/correlation.py::_correlation_gram, in the
// JAX bf16 train steps (the transposed banded dot_general); the TPU
// kernels of the forward (correlation_v2.py, correlation_v3.py) have no
// VJP.
//
// What bounds it on an H100: bytes. At stereo_kitti2015_b16_bf16_v5e8's
// (16, 96, 288, 64), D = 48 it reads g (42.5 MB) and both views and writes
// both gradients (4 x 56.6 MB): 269 MB, 80 us at 3.35 TB/s. Its 5.4 GFLOP
// of useful products take 5.5 us on the bf16 tensor cores (81 us as fp32
// FMAs on the CUDA cores: the bound itself), so the products run on
// mma.sync, and the design spends few instructions around them and keeps
// two blocks on every SM, so that one block's loads run under the other's
// work (on an H100 at config 5: 0.100 ms of kernel time; 0.109 with one
// 12-warp block an SM over 96-wide tiles, whose steps' work added to their
// loads' time).
//
// Design. Both gradients are transposed banded Grams of one matrix,
//   M[x, y] = g[x, x - y] where 0 <= x - y < D, else 0:
//   d_fl[x] = 1/C sum_y M[x, y] fr[y],   d_fr[y] = 1/C sum_x M[x, y] fl[x].
//   * A unit is a (row, 64-wide W tile w0; config 5's 288 columns make
//     4.5 tiles). Persistent blocks of 8 warps, two an SM (115,200 bytes of
//     shared memory each at D = 48), walk the units (blockIdx.x, +
//     gridDim.x, ...), each in steps of a 64-channel chunk and a D chunk.
//   * A step stages, by 16-byte cp.async into a ring of 2 stages so that
//     the next step's loads are in flight while a step runs: fr's window in
//     reversed order, WR[c] = fr[w0 - d0 + T-1 - c], and fl's, WL[r] =
//     fl[w0 + d0 + r] (R = T + 16 (S - 1) rows each, 64
//     channels in 128-byte rows whose 16-byte chunks are XORed with the
//     row % 8, as the forward's), and g's rows G[r] = g[w0 + d0 + r][d0,
//     d0 + DT) read through its strides (the aggregation's concat hands
//     back the slice [..., :D] of a (D + C)-wide gradient), at column 16 of
//     88-wide rows whose other columns stay zero. Zeros outside [0, W),
//     past C and past D. All three are staged once for both outputs.
//   * Warps 0-3 run d_fl's row tiles (16 pixels each), warps 4-7 d_fr's,
//     on mma.sync.m16n8k16 with fp32 sums: B = the window (WR, WL) by
//     ldmatrix.trans, 8 n8 tiles over the chunk's 64 channels, and only the
//     S = ceil((15 + DT) / 16) k16 slices that the tile's band touches (4
//     at D = 48: 64 products for 48 useful). The band A[m][k] (tile row m,
//     window row kbase + k, kbase = T - 16 - 16 i) is g at disparity
//     m + k - 15 of row 16 i + m (d_fl) or kbase + k (d_fr): its fragments
//     are gathered from G's rows, zeros off the band coming from the zero
//     columns. d_fl's pairs (k, k + 1) are adjacent in a row of G: two
//     32-bit loads and a funnel shift by 0 or 16 bits (the pair's parity
//     is the lane's row's). d_fr's pairs lie on a diagonal: two 16-bit
//     loads and a byte permute. No pass over g, and one barrier a step.
//   * The epilogue multiplies by 1/C in fp32 and rounds once to bf16; each
//     warp writes its 16 x 64 tile by stmatrix into a tile of its own and
//     stores it with 16-byte stores, with no barrier.
//   * D over 48 runs in D chunks of DT (a multiple of 8) whose sums stay in
//     registers; d_fl then reads g's rows w0 + r, which no longer coincide
//     with d_fr's (w0 + d0 + r), so they are staged apart, after d_fr's.
//     C over 64 runs in channel chunks, each with its outputs.
// No atomics; the same bits on every run. A C that is not a multiple of 8,
// views or a gradient whose rows are not 16-byte aligned, and D not a
// multiple of 8 take scalar staging into the same layout; outputs whose
// rows are not 16-byte multiples take scalar stores.
#include "common.cuh"

namespace sde {
namespace {

constexpr int kT = 64;               // pixels a unit (the W tile)
constexpr int kTiles = kT / 16;      // m16 row tiles of one output
constexpr int kWarps = 2 * kTiles;   // warps 0-3 d_fl, 4-7 d_fr
constexpr int kThreads = kWarps * 32;
constexpr int kKC = 64;              // channels a chunk: 8 n8 tiles
constexpr int kDTMax = 48;           // disparities a D chunk
constexpr int kSMax = (15 + kDTMax + 15) / 16;  // k16 slices a row tile: 4
constexpr int kG0 = 16;              // column of G's first disparity
constexpr int kGP = 88;              // G's row pitch (16-byte multiple)
constexpr int kOP = 72;              // a warp's output tile row pitch: 9 chunks
constexpr int kStages = 2;           // the cp.async ring

// The gathers read G's columns [kG0 - 16, kG0 + 16 S + 2): disparities -16
// to 16 S + 1 around the band.
static_assert(kG0 >= 16 && kG0 + 16 * kSMax + 2 <= kGP && kGP % 8 == 0, "G's zero columns");

// bf16 offset of 16-byte chunk k of 128-byte row j: the chunk index XORed
// with j % 8, so the 8 rows of an ldmatrix phase fall in distinct banks.
__device__ __forceinline__ int swz(int j, int k) { return j * kKC + ((k ^ (j & 7)) << 3); }

struct Args {
  const uint16_t* g;
  long long sgb, sgh, sgw;  // g's strides; its D stride is 1
  const uint16_t* fl;
  long long sbl;            // batch strides; (W, C) rows contiguous
  const uint16_t* fr;
  long long sbr;
  uint16_t* dfl;            // (B, H, W, C) contiguous
  uint16_t* dfr;
  int H, W, C, D;
  int DT, nd, nc, ntw, units;
  int S, R;      // k16 slices a row tile; window rows, T + 16 (S - 1)
  int grows;     // staged g rows: R, plus d_fl's T with D chunks
  int stage;     // bf16 elements of one ring stage
  bool own_fl;   // D chunks: d_fl's g rows staged apart
  bool vec_f, vec_g, vec_out;
};

// Channels [c0, c0 + kKC) of the view columns col0 + dir * j, j in [0, n),
// into dst row j, zeros outside [0, W) x [0, C).
__device__ __forceinline__ void stage_win(uint16_t* __restrict__ dst,
                                          const uint16_t* __restrict__ src, int col0, int dir,
                                          int n, int W, int C, int c0, bool vec) {
  if (vec) {
    // A thread keeps one vector slot v (kThreads is a multiple of kV).
    constexpr int kV = kKC / 8;
    const int v = threadIdx.x % kV, c = c0 + v * 8;
    const uint16_t* sc = src + c;
    for (int j = threadIdx.x / kV; j < n; j += kThreads / kV) {
      const int col = col0 + dir * j;
      const bool ok = col >= 0 && col < W && c < C;
      cp_async16(dst + swz(j, v), ok ? sc + (long long)col * C : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < n * kKC; i += kThreads) {
      const int j = i / kKC, k = i % kKC, c = c0 + k, col = col0 + dir * j;
      dst[swz(j, k >> 3) + (k & 7)] =
          (col >= 0 && col < W && c < C) ? src[(long long)col * C + c] : uint16_t(0);
    }
  }
}

// g's rows row0 + r, r in [0, n), disparities [d0, d0 + DT), into columns
// [kG0, kG0 + DT) of dst's rows (pitch kGP), zeros at or past W and D.
__device__ __forceinline__ void stage_g(uint16_t* __restrict__ dst,
                                        const uint16_t* __restrict__ grow, long long sgw,
                                        int row0, int n, int W, int D, int d0, int DT, bool vec) {
  if (vec) {
    // A thread keeps one vector slot v of the DT / 8 a row.
    const int v = threadIdx.x & 7, d = d0 + 8 * v;
    if (8 * v >= DT) return;
    for (int r = threadIdx.x >> 3; r < n; r += kThreads / 8) {
      const int w = row0 + r;
      const bool ok = w < W && d < D;
      cp_async16(dst + r * kGP + kG0 + 8 * v, ok ? grow + w * sgw + d : grow, ok);
    }
  } else {
    for (int i = threadIdx.x; i < n * DT; i += kThreads) {
      const int r = i / DT, k = i - r * DT, w = row0 + r, d = d0 + k;
      dst[r * kGP + kG0 + k] = (w < W && d < D) ? grow[w * sgw + d] : uint16_t(0);
    }
  }
}

// One unit's place: its row's views and g, and its W tile.
struct Unit {
  const uint16_t* fl;
  const uint16_t* fr;
  const uint16_t* g;
  int row, w0;
};

__device__ __forceinline__ Unit unit_of(const Args& a, int u) {
  Unit t;
  t.w0 = (u % a.ntw) * kT;
  t.row = u / a.ntw;
  const int b = t.row / a.H, h = t.row - b * a.H;
  const long long rowoff = (long long)h * a.W * a.C;
  t.fl = a.fl + b * a.sbl + rowoff;
  t.fr = a.fr + b * a.sbr + rowoff;
  t.g = a.g + b * a.sgb + h * a.sgh;
  return t;
}

// Walks this block's steps in order: unit blockIdx.x + i * gridDim.x,
// channel chunk cc, D chunk dc (fastest).
struct Cursor {
  int unit, cc, dc, stage;
  Unit t;
  __device__ __forceinline__ void start(const Args& a) {
    unit = blockIdx.x;
    cc = dc = stage = 0;
    t = unit_of(a, unit);
  }
  __device__ __forceinline__ void advance(const Args& a, int stages) {
    stage = stage + 1 == stages ? 0 : stage + 1;
    if (++dc < a.nd) return;
    dc = 0;
    if (++cc < a.nc) return;
    cc = 0;
    unit += gridDim.x;
    if (unit < a.units) t = unit_of(a, unit);
  }
};

__global__ void __launch_bounds__(kThreads, 2) correlation_gram_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;  // mma group and thread in group
  uint16_t* otile = smem + kStages * a.stage + warp * 16 * kOP;  // the warp's output tile
  const int steps = (a.units - blockIdx.x + gridDim.x - 1) / gridDim.x * a.nc * a.nd;

  // G's columns outside [kG0, kG0 + DT) are zero for the whole launch.
  for (int s = 0; s < kStages; ++s) {
    uint4* gz = reinterpret_cast<uint4*>(smem + s * a.stage + 2 * a.R * kKC);
    for (int i = threadIdx.x; i < a.grows * kGP / 8; i += kThreads)
      gz[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // Loads of the next step into its stage; one commit group a step, empty
  // past the last.
  Cursor in;
  in.start(a);
  int issued = 0;
  auto issue = [&]() {
    if (issued++ < steps) {
      const Unit& t = in.t;
      const int d0 = in.dc * a.DT, c0 = in.cc * kKC;
      uint16_t* st = smem + in.stage * a.stage;
      stage_win(st, t.fr, t.w0 - d0 + kT - 1, -1, a.R, a.W, a.C, c0, a.vec_f);
      stage_win(st + a.R * kKC, t.fl, t.w0 + d0, 1, a.R, a.W, a.C, c0, a.vec_f);
      uint16_t* sg = st + 2 * a.R * kKC;
      stage_g(sg, t.g, a.sgw, t.w0 + d0, a.R, a.W, a.D, d0, a.DT, a.vec_g);
      if (a.own_fl) stage_g(sg + a.R * kGP, t.g, a.sgw, t.w0, kT, a.W, a.D, d0, a.DT, a.vec_g);
      in.advance(a, kStages);
    }
    cp_async_commit();
  };

  // Warp w runs d_fl's row tile w (w < 4) or d_fr's tile w - 4 (pixels
  // T-1 - 16 (w - 4) - m for tile row m); both read window rows kbase + k.
  const bool right = warp >= kTiles;
  const int jt = right ? warp - kTiles : warp;
  const int kbase = kT - 16 - 16 * jt;
  const int ylo = right ? kbase : 16 * jt;  // the tile's first output pixel
  // The lane's a0 in G (elements from the stage's G): A[m][k] is G's column
  // kG0 + m + k - 15 of row 16 jt + m (d_fl) or kbase + k (d_fr), with m =
  // g and k = 2 q for a0. d_fl: the even column at or below it and the
  // funnel shift that starts the pair there.
  int aoff;
  uint32_t sh = 0;
  if (right) {
    aoff = (kbase + 2 * q) * kGP + kG0 + g + 2 * q - 15;
  } else {
    const int col = kG0 + g + 2 * q - 15;
    aoff = ((a.own_fl ? a.R : 0) + 16 * jt + g) * kGP + (col & ~1);
    sh = (col & 1) * 16;
  }
  const int brow = kbase + (lane & 15);  // window row of the lane, slice 0
  const int key = lane & 7;              // brow % 8 in every slice

  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue();

  const float inv_c = 1.f / static_cast<float>(a.C);
  Cursor cur;
  cur.start(a);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // step s has landed (this thread's part)
    __syncthreads();               // ... every thread's; step s-1 is consumed
    issue();

    const Unit t = cur.t;
    const int cc = cur.cc, dc = cur.dc;
    const uint16_t* st = smem + cur.stage * a.stage;
    cur.advance(a, kStages);
    const int nvalid = min(kT, a.W - t.w0);  // pixels inside the frame
    if (ylo < nvalid) {
      const uint16_t* win = st + (right ? a.R * kKC : 0);
      const uint16_t* ga = st + 2 * a.R * kKC + aoff;
#pragma unroll
      for (int ks = 0; ks < kSMax; ++ks) {
        if (ks >= a.S) break;
        uint32_t af[4];
        if (right) {
          // Rows kbase + k, k + 1 (+ 8); columns m + k - 15, + 1 (m + 8).
          const uint16_t* p = ga + ks * (16 * kGP + 16);
          af[0] = __byte_perm(p[0], p[kGP + 1], 0x5410);
          af[1] = __byte_perm(p[8], p[kGP + 9], 0x5410);
          af[2] = __byte_perm(p[8 * kGP + 8], p[9 * kGP + 9], 0x5410);
          af[3] = __byte_perm(p[8 * kGP + 16], p[9 * kGP + 17], 0x5410);
        } else {
          // Rows 16 jt + m (m + 8 eight rows on); columns m + k - 15, + 1.
          const uint32_t* p0 = reinterpret_cast<const uint32_t*>(ga) + 8 * ks;
          const uint32_t* p1 = p0 + 4 * kGP;
          af[0] = __funnelshift_r(p0[0], p0[1], sh);
          af[1] = __funnelshift_r(p1[4], p1[5], sh);
          af[2] = __funnelshift_r(p0[4], p0[5], sh);
          af[3] = __funnelshift_r(p1[8], p1[9], sh);
        }
        const uint16_t* pb = win + (brow + 16 * ks) * kKC;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, pb + (((2 * p + (lane >> 4)) ^ key) << 3));
          mma_bf16(acc[2 * p], af, bf[0], bf[1]);
          mma_bf16(acc[2 * p + 1], af, bf[2], bf[3]);
        }
      }
    }
    if (dc != a.nd - 1) continue;

    // Epilogue of the unit's channel chunk: the sums scaled and rounded
    // once into the warp's tile (row m, channel chunk n8), then its rows to
    // device memory, 8 lanes a row.
#pragma unroll
    for (int tt = 0; tt < 8; tt += 2) {
      stsm_x4(otile + (lane & 15) * kOP + ((tt + (lane >> 4)) << 3),
              pack_bf16x2(acc[tt][0] * inv_c, acc[tt][1] * inv_c),
              pack_bf16x2(acc[tt][2] * inv_c, acc[tt][3] * inv_c),
              pack_bf16x2(acc[tt + 1][0] * inv_c, acc[tt + 1][1] * inv_c),
              pack_bf16x2(acc[tt + 1][2] * inv_c, acc[tt + 1][3] * inv_c));
    }
#pragma unroll
    for (int tt = 0; tt < 8; ++tt) acc[tt][0] = acc[tt][1] = acc[tt][2] = acc[tt][3] = 0.f;
    __syncwarp();
    const int k = lane & 7, c = cc * kKC + 8 * k;
    if (ylo < nvalid && c < a.C) {
      uint16_t* out = (right ? a.dfr : a.dfl) + ((long long)t.row * a.W + t.w0) * a.C + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = (lane >> 3) + 4 * j;
        const int y = right ? kT - 1 - 16 * jt - m : 16 * jt + m;
        if (y >= nvalid) continue;
        const uint16_t* src = otile + m * kOP + 8 * k;
        uint16_t* dst = out + (long long)y * a.C;
        if (a.vec_out) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && c + e < a.C; ++e) dst[e] = src[e];
        }
      }
    }
  }
  cp_async_wait<0>();
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

// Launches a grid of as many blocks as the card holds at once (fewer for
// fewer units). The shared-memory attribute and the blocks an SM holds are
// asked once per device and size.
cudaError_t launch(const Args& a, int bytes, int device, cudaStream_t stream) {
  static int attr_bytes[kMaxDevices], per_sm[kMaxDevices];
  cudaError_t err;
  if (attr_bytes[device] != bytes) {
    err = cudaFuncSetAttribute(correlation_gram_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[device],
                                                        correlation_gram_bwd_kernel, kThreads,
                                                        bytes);
    if (err != cudaSuccess) return err;
    attr_bytes[device] = bytes;
  }
  if (per_sm[device] < 1) return cudaErrorInvalidConfiguration;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const int grid = std::min(a.units, sms * per_sm[device]);
  correlation_gram_bwd_kernel<<<static_cast<unsigned>(grid), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sde

// g (B, H, W, D) bf16 with strides sgb, sgh, sgw (elements) and D stride 1;
// fl, fr (B, H, W, C) bf16 views with contiguous (W, C) rows and batch
// strides sbl, sbr; d_fl, d_fr (B, H, W, C) contiguous bf16, written
// whole. The blocking (ops/cuda/correlation_gram.py backward_plan): D in
// the fewest chunks of at most 48, each ceil(D / chunks) rounded up to a
// multiple of 8; S k16 slices a row tile for the band's width, min(D, DT);
// as many blocks an SM as fit (two at D <= 48).
extern "C" int sde_correlation_gram_bwd(const void* g, long long sgb, long long sgh,
                                        long long sgw, const void* fl, long long sbl,
                                        const void* fr, long long sbr, void* dfl, void* dfr,
                                        int B, int H, int W, int C, int D, int device,
                                        void* stream) {
  using namespace sde;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || H < 1 || W < 1 || C < 1 || D < 1 || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.g = static_cast<const uint16_t*>(g);
  a.sgb = sgb;
  a.sgh = sgh;
  a.sgw = sgw;
  a.fl = static_cast<const uint16_t*>(fl);
  a.sbl = sbl;
  a.fr = static_cast<const uint16_t*>(fr);
  a.sbr = sbr;
  a.dfl = static_cast<uint16_t*>(dfl);
  a.dfr = static_cast<uint16_t*>(dfr);
  a.H = H;
  a.W = W;
  a.C = C;
  a.D = D;
  const int chunks = (D + kDTMax - 1) / kDTMax;
  a.DT = ((D + chunks - 1) / chunks + 7) / 8 * 8;
  a.nd = (D + a.DT - 1) / a.DT;
  a.nc = (C + kKC - 1) / kKC;
  a.ntw = (W + kT - 1) / kT;
  a.S = (15 + std::min(a.DT, D) + 15) / 16;
  a.R = kT + 16 * (a.S - 1);
  a.own_fl = a.nd > 1;
  a.grows = a.R + (a.own_fl ? kT : 0);
  a.stage = 2 * a.R * kKC + a.grows * kGP;
  const long long units = (long long)B * H * a.ntw;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.units = static_cast<int>(units);
  a.vec_f = C % 8 == 0 && sbl % 8 == 0 && sbr % 8 == 0 && aligned16(fl) && aligned16(fr);
  a.vec_g = D % 8 == 0 && sgb % 8 == 0 && sgh % 8 == 0 && sgw % 8 == 0 && aligned16(g);
  a.vec_out = C % 8 == 0 && aligned16(dfl) && aligned16(dfr);
  const int bytes = 2 * (kStages * a.stage + kWarps * 16 * kOP);
  return static_cast<int>(launch(a, bytes, device, static_cast<cudaStream_t>(stream)));
}
