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
// Design. The features are read where the stereo tower left them: FL and
// FR are (B, H, W, C) views with contiguous (W, C) rows and a batch
// stride of their own (2*H*W*C for the halves of the tower's interleaved
// output), so no copy of either view is made.
//   * Units of work are (row, 96-wide W tile, D tile); 288 = 3 x 96 wastes
//     no part of a tile at the bf16 presets' W. A grid of as many blocks
//     as fit on the card (two of 6 warps a SM) walks the units in turn
//     (unit = block + i*grid), so neighbouring blocks share a row and its
//     halo stays in L2. Each unit is decoded once, in 32-bit arithmetic:
//     64-bit divisions in every step cost more issue slots than the
//     step's products.
//   * Each unit is staged in 64-channel steps, each step the tile's 96
//     left columns and only the 96 + TD - 1 right-view columns its band
//     reads (zeros outside [0, W) and past C; the D - 1 halo columns are
//     read again from L2 by the neighbouring tile), by 16-byte cp.async
//     into 128-byte rows whose 16-byte chunks are XORed with the row
//     index % 8, so the 8 rows of an ldmatrix phase fall in distinct
//     banks with no padding (a padded 144-byte pitch measured 8% slower).
//     Window rows past those (up to the last n8 tile) feed only products
//     that the band never reads. A ring of 3 stages keeps the next two
//     steps' loads in flight, across units, while a step's products and a
//     unit's epilogue run: one barrier a step.
//   * Warp i owns the left rows [16i, 16i+16) and runs
//     mma.sync.m16n8k16 (fragments by ldmatrix) only on the n8 tiles of
//     window columns [16i, 16i + 15 + TD - 1] that its band reads. The
//     step's four k16 slices are unrolled and the kernel is compiled for
//     two blocks a SM (__launch_bounds__): at config 5 on an H100 that
//     ran about 5% faster than ptxas's own register choice.
//   * The epilogue rounds cost[u, d] = G[u, u + TD - 1 - d] * (1/C) to
//     bf16 into a shared tile laid out as the output, and writes it with
//     16-byte stores: with all of D in one tile, a unit's output is one
//     contiguous run of 96*D values (96 B a pixel at D = 48). With D > 64
//     (several D tiles, which no preset has) each value is stored alone.
// A C that is not a multiple of 8, or a view whose rows are not 16-byte
// aligned, is staged by scalar loads instead of cp.async (same ring).
#include "common.cuh"

namespace sde {
namespace {

constexpr int kT = 96;                 // left columns per unit (the W tile)
constexpr int kWarps = kT / 16;        // one m16 row tile per warp
constexpr int kThreads = kWarps * 32;
constexpr int kKC = 64;                // channels staged per step
constexpr int kPitch = kKC;            // 128-byte rows, 16-byte chunks XOR-swizzled
constexpr int kStages = 3;             // ring depth: two steps in flight
constexpr int kTDMax = 64;             // disparities per unit

// bf16 offset of 16-byte chunk k of shared row j: the chunk index XORed
// with j % 8, so the 8 rows of an ldmatrix phase fall in distinct banks.
__device__ __forceinline__ int swz(int j, int k) { return j * kPitch + ((k ^ (j & 7)) << 3); }

// Window rows staged for NTP pairs of n8 tiles: warp kWarps-1's last tile.
__host__ __device__ constexpr int win_rows(int ntp) { return 16 * (kWarps - 1) + 16 * ntp; }

__host__ __device__ constexpr int stage_elems(int ntp) { return (kT + win_rows(ntp)) * kPitch; }

// Shared bytes: the ring, then the bf16 output tile (8 values of slack
// for the flat store's alignment).
__host__ __device__ constexpr int smem_bytes(int ntp, int td) {
  return (kStages * stage_elems(ntp) + ((kT * td + 8 + 7) / 8) * 8) * 2;
}

struct Args {
  const uint16_t* fl;
  const uint16_t* fr;
  __nv_bfloat16* out;
  long long sbl, sbr;  // batch strides of FL and FR, in elements
  int units;           // (row, W tile, D tile) units, < 2^31
  int H, W, C, D, TD, ntw, nd, nk;
  bool vec;   // 16-byte cp.async staging
  bool flat;  // TD == D: a unit's output is one contiguous run
};

// Stages channels [c0, c0 + kKC) of the columns [col0, col0 + ncols) of
// one row's (W, C) features into dst[ncols][kPitch], zeros outside
// [0, W) x [0, C).
__device__ __forceinline__ void stage_cols(uint16_t* __restrict__ dst,
                                           const uint16_t* __restrict__ src,
                                           int col0, int ncols, int W, int C,
                                           int c0, bool vec) {
  if (vec) {
    // A thread keeps one vector slot v (kThreads is a multiple of kV).
    constexpr int kV = kKC / 8;  // 16-byte vectors a column
    const int v = threadIdx.x % kV, c = c0 + v * 8;
    const uint16_t* sc = src + c;
    for (int j = threadIdx.x / kV; j < ncols; j += kThreads / kV) {
      const int col = col0 + j;
      const bool ok = col >= 0 && col < W && c < C;
      cp_async16(dst + swz(j, v), ok ? sc + (long long)col * C : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ncols * kKC; i += kThreads) {
      const int j = i / kKC, k = i % kKC, c = c0 + k, col = col0 + j;
      dst[swz(j, k >> 3) + (k & 7)] =
          (col >= 0 && col < W && c < C) ? src[(long long)col * C + c] : uint16_t(0);
    }
  }
}

// One unit's place: its left and right rows, W tile and D tile. Units
// are decoded once each, in 32-bit arithmetic: 64-bit divisions in every
// step cost more issue slots than the step's products.
struct Unit {
  const uint16_t* lrow;
  const uint16_t* rrow;
  int row, x0, d0;
};

__device__ __forceinline__ Unit unit_of(const Args& a, int u) {
  Unit r;
  const int dt = u % a.nd;
  u /= a.nd;
  r.x0 = (u % a.ntw) * kT;
  r.row = u / a.ntw;
  r.d0 = dt * a.TD;
  const int b = r.row / a.H, h = r.row - b * a.H;
  const long long rowoff = (long long)h * a.W * a.C;
  r.lrow = a.fl + b * a.sbl + rowoff;
  r.rrow = a.fr + b * a.sbr + rowoff;
  return r;
}

// Walks this block's steps in order: unit blockIdx.x + i * gridDim.x,
// channel step kc.
struct Cursor {
  int unit, kc, stage;
  Unit t;
  __device__ __forceinline__ void start(const Args& a) {
    unit = blockIdx.x;
    kc = stage = 0;
    t = unit_of(a, unit);
  }
  __device__ __forceinline__ void advance(const Args& a, int stages) {
    stage = stage + 1 == stages ? 0 : stage + 1;
    if (++kc == a.nk) {
      kc = 0;
      unit += gridDim.x;
      if (unit < a.units) t = unit_of(a, unit);
    }
  }
};

template <int NTP>
__global__ void __launch_bounds__(kThreads, 2)
    correlation_gram_kernel(const Args a) {
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sout = smem + kStages * stage_elems(NTP);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;  // mma group and thread in group
  const int steps = (a.units - blockIdx.x + gridDim.x - 1) / gridDim.x * a.nk;

  // Loads of the next step into its stage; one commit group a step, empty
  // past the last.
  Cursor in;  // the next step to load
  in.start(a);
  int issued = 0;
  auto issue = [&]() {
    if (issued++ < steps) {
      const Unit& t = in.t;
      uint16_t* st = smem + in.stage * stage_elems(NTP);
      // Window row j holds right-view column r0 + j, so that
      // cost[x0 + u, d0 + dl] = G[u, u + TD - 1 - dl].
      const int r0 = t.x0 - t.d0 - (a.TD - 1);
      stage_cols(st, t.lrow, t.x0, kT, a.W, a.C, in.kc * kKC, a.vec);
      stage_cols(st + kT * kPitch, t.rrow, r0, kT + a.TD - 1, a.W, a.C, in.kc * kKC, a.vec);
      in.advance(a, kStages);
    }
    cp_async_commit();
  };

  float acc[2 * NTP][4];
#pragma unroll
  for (int t = 0; t < 2 * NTP; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue();

  const float inv_c = 1.f / static_cast<float>(a.C);
  Cursor cur;  // the step to compute
  cur.start(a);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // step s has landed (this thread's part)
    __syncthreads();               // ... every thread's; step s-1 is consumed
    issue();

    const Unit t = cur.t;
    const int kc = cur.kc;
    const int nvalid = min(kT, a.W - t.x0);  // left columns inside the frame
    const uint16_t* sl = smem + cur.stage * stage_elems(NTP);
    cur.advance(a, kStages);
    const uint16_t* sw = sl + kT * kPitch;
    if (warp * 16 < nvalid) {
      const int ksteps = (min(kKC, a.C - kc * kKC) + 15) / 16;
      // Every row a lane points at is lane % 8 modulo 8: one XOR key.
      const int key = lane & 7;
      const uint16_t* pa = sl + (warp * 16 + (lane & 15)) * kPitch;
      const uint16_t* pb = sw + (warp * 16 + (lane & 7) + ((lane >> 4) << 3)) * kPitch;
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        if (ks >= ksteps) break;
        const int ca = ((2 * ks + (lane >> 4)) ^ key) << 3;
        const int cb = ((2 * ks + ((lane >> 3) & 1)) ^ key) << 3;
        uint32_t af[4];
        ldsm_x4(af, pa + ca);
#pragma unroll
        for (int tp = 0; tp < NTP; ++tp) {
          uint32_t bf[4];
          ldsm_x4(bf, pb + tp * 16 * kPitch + cb);
          mma_bf16(acc[2 * tp], af, bf[0], bf[1]);
          mma_bf16(acc[2 * tp + 1], af, bf[2], bf[3]);
        }
      }
    }
    if (kc != a.nk - 1) continue;

    // Epilogue of the unit: the band, scaled and rounded once, into the
    // output tile; then the tile to device memory.
    const int td = min(a.TD, a.D - t.d0);
    const long long g0 = ((long long)t.row * a.W + t.x0) * a.D + t.d0;  // first output value
    const int lead =
        a.flat ? static_cast<int>((reinterpret_cast<std::uintptr_t>(a.out + g0) >> 1) & 7) : 0;
    if (warp * 16 < nvalid) {
#pragma unroll
      for (int tt = 0; tt < 2 * NTP; ++tt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = warp * 16 + g + (e >> 1) * 8;
          const int dl = g + (e >> 1) * 8 + a.TD - 1 - 8 * tt - 2 * q - (e & 1);
          if (dl >= 0 && dl < td && u < nvalid)
            sout[lead + u * a.TD + dl] =
                __bfloat16_as_ushort(__float2bfloat16(acc[tt][e] * inv_c));
          acc[tt][e] = 0.f;
        }
      }
    }
    __syncthreads();
    if (a.flat) {
      // The unit's nvalid*D values are one run; sout[lead + k] holds value
      // g0 + k, so sout's 16-byte vectors line up with the output's.
      const int n = nvalid * a.D;
      __nv_bfloat16* gb = a.out + g0 - lead;
      const uint16_t* sb = sout;
      for (int m = threadIdx.x; m < (lead + n + 7) / 8; m += kThreads) {
        const int lo = 8 * m;
        if (lo >= lead && lo + 8 <= lead + n) {
          *reinterpret_cast<uint4*>(gb + lo) = *reinterpret_cast<const uint4*>(sb + lo);
        } else {
          for (int k = max(lo, lead); k < min(lo + 8, lead + n); ++k)
            reinterpret_cast<uint16_t*>(gb)[k] = sb[k];
        }
      }
    } else {
      // Several D tiles: each pixel's td values.
      for (int i = threadIdx.x; i < nvalid * td; i += kThreads) {
        const int u = i / td, dl = i - u * td;
        reinterpret_cast<uint16_t*>(a.out)[g0 + (long long)u * a.D + dl] = sout[u * a.TD + dl];
      }
    }
  }
  cp_async_wait<0>();
}

// Launches a grid of as many blocks as the card holds at once (fewer for
// fewer units). The shared-memory attribute and the blocks an SM holds
// are asked once per device and size.
template <int NTP>
cudaError_t launch(const Args& a, int device, cudaStream_t stream) {
  static int attr_bytes[kMaxDevices], occ_bytes[kMaxDevices], occ_blocks[kMaxDevices];
  const int bytes = smem_bytes(NTP, a.TD);
  cudaError_t err;
  if (attr_bytes[device] < bytes) {
    err = cudaFuncSetAttribute(correlation_gram_kernel<NTP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_bytes[device] = bytes;
  }
  if (occ_bytes[device] != bytes) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ_blocks[device], correlation_gram_kernel<NTP>, kThreads, bytes);
    if (err != cudaSuccess) return err;
    occ_bytes[device] = bytes;
  }
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const int per_sm = occ_blocks[device];
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = std::min(a.units, sms * per_sm);
  correlation_gram_kernel<NTP><<<static_cast<unsigned>(grid), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sde

// fl, fr: (B, H, W, C) bfloat16 views with contiguous (W, C) rows (C
// stride 1, W stride C, H stride W*C) and batch strides sbl, sbr (in
// elements); out (B, H, W, D) contiguous bfloat16. td: disparities per
// unit (1..64; td == D, or D > 64 split in ceil(D / td) tiles).
extern "C" int sde_correlation_gram(const void* fl, long long sbl, const void* fr,
                                    long long sbr, void* out, int B, int H, int W, int C,
                                    int D, int td, int device, void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || H < 1 || W < 1 || C < 1 || D < 1 || td < 1 || td > sde::kTDMax ||
      (D <= sde::kTDMax && td != D) || device < 0 || device >= sde::kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  sde::Args a;
  a.fl = static_cast<const uint16_t*>(fl);
  a.fr = static_cast<const uint16_t*>(fr);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.sbl = sbl;
  a.sbr = sbr;
  a.H = H;
  a.W = W;
  a.C = C;
  a.D = D;
  a.TD = td;
  a.ntw = (W + sde::kT - 1) / sde::kT;
  a.nd = (D + td - 1) / td;
  a.nk = (C + sde::kKC - 1) / sde::kKC;
  const long long units = (long long)B * H * a.ntw * a.nd;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.units = static_cast<int>(units);
  a.flat = td == D;
  a.vec = C % 8 == 0 && reinterpret_cast<std::uintptr_t>(fl) % 16 == 0 &&
          reinterpret_cast<std::uintptr_t>(fr) % 16 == 0 && sbl % 8 == 0 && sbr % 8 == 0;
  const int nt = (td + 15 + 7) / 8;  // n8 tiles over [16i, 16i + 15 + td - 1]
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((nt + 1) / 2) {
    case 1: err = sde::launch<1>(a, device, s); break;
    case 2: err = sde::launch<2>(a, device, s); break;
    case 3: err = sde::launch<3>(a, device, s); break;
    case 4: err = sde::launch<4>(a, device, s); break;
    case 5: err = sde::launch<5>(a, device, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
