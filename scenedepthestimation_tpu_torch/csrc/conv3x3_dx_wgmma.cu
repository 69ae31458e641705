// conv3x3_dx_wgmma: the interior of conv3x3's bf16 input gradient (kernel
// 1e of the port), dx[y, x, ci] = sum_{ky, kx, co} dpre[y + 1 - ky,
// x + 1 - kx, co] w[co, ci, ky, kx], zero outside the image: the
// zero-bordered 3x3 conv of dpre (B, H, W, Cout) with the flipped,
// transposed weight w', an implicit GEMM with M = the pixels, N = Cin and
// K = 9 Cout, on wgmma.mma_async m64nNk16 (bf16 in, fp32 sums, one rounding
// to bf16). conv3x3_bwd.cu's fold then adds the reflect or edge border's
// gradient (in fp32, rounding again) and holds the rest of the backward.
//
// Replaces, with conv3x3_bwd.cu, the backward of the TPU kernel's custom
// VJP, scenedepthestimation_tpu/ops/pallas/conv_block.py::_fused_bwd
// (jax.vjp of conv3x3_xla in bf16), and of the bf16 DispHead's conv.
//
// What bounds it on an H100. At the bench preset's decoder at b128
// (mono_kitti_384x1152_bench) the levels of 128-512 channels are 130-522
// GFLOP a call (0.13-0.53 ms at 989 TFLOP/s), the levels of 16-64 channels
// move more bytes than they do operations (0.2-1.4 ms at 3.35 TB/s). The
// forward's conv3x3_tc_kernel, tuned for the forward's shapes, would run
// dx with 128-pixel tiles that re-read their N tile of w' (the large
// operand in dx, where K = 9 Cout) for the whole of K, 0.6 MB a tile at
// 512 -> 256 channels, with one barrier and a full drain of two cp.async
// stages every 16 channels; at 32 channels (K = 288) its two steps never
// fill the pipeline, and w' makes up 97% of the bytes a block reads. What
// this kernel does about it:
// - Persistent blocks, each holding one N tile of TN channels and walking
//   pixel tiles; the N tiles of a pixel tile run on neighbouring blocks, so
//   dpre's halo is read from device memory about once.
// - Where w' for the whole of K fits beside the pipeline in half an SM's
//   shared memory (the levels of 128 channels and less), the block stages
//   it once ("resident") and streams only dpre's halo, two blocks an SM of
//   two warpgroups (8 x 16 pixel tiles), so that one block's barrier and
//   epilogue overlap the other's products. Otherwise w' streams with the
//   halo, 16 channels a step, through one block an SM of four warpgroups
//   (16 x 16 pixel tiles: half the bytes of w' a pixel of the forward's
//   128-pixel tiles).
// - A ring of four stages by 16-byte cp.async, two steps loaded ahead, one
//   barrier a step. Both operands come from shared memory through
//   descriptors (no swizzle): A is a warpgroup's 8 x 8 pixel quadrant of
//   the halo shifted by the tap, K-major, the halo stored as [channel
//   group][pixel][8 channels] so that a tap's shift is a 16-byte step of
//   the descriptor's start and an 8-pixel row of the quadrant a halo row
//   on; B is w' in wgmma's core-matrix order, conv3x3_dx_slab_bf16_kernel's
//   slab. A step's 9 products go out as one group, waited one step later,
//   so the tensor cores run across the barrier. No instruction but the
//   products writes the sums (a tile's first product writes them fresh,
//   scale-d 0): sums zeroed by stores make ptxas serialize the products
//   (its warning C7515), at about a third of the tensor cores' rate
//   whatever the tiling.
// - The zero border comes free: the halo's pixels outside the image are
//   zero-filled by the copy.
// - The output tile is rounded once and stored from the registers (32-bit
//   stores of two channels) while the next tile's loads are in flight.
#include "common.cuh"

namespace sde {
namespace {

constexpr int kDxTW = 16;                      // tile columns
constexpr int kDxQ = 8;                        // a warpgroup's quadrant: 8 x 8 pixels (m64)
constexpr int kDxHW = kDxTW + 2;               // halo width
constexpr int kDxCK = 16;                      // dpre channels (K) a step: two groups
constexpr int kDxS = 4;                        // stages
constexpr int kDxL = kDxS - 2;                 // steps loaded ahead
constexpr int kDxSmemOne = 232448;             // shared memory of one block an SM, at most
constexpr int kDxSmemTwo = 115712;             // of each of two blocks an SM

// TN output channels a block; RES: w' resident for the whole of K; WGS
// warpgroups (4: one block an SM, a 16 x 16 pixel tile; 2: two blocks an
// SM, whose loads, barriers and epilogues overlap each other's products, a
// 8 x 16 tile).
template <int TN_, bool RES_, int WGS_>
struct DxCfg {
  static constexpr int TN = TN_, WGS = WGS_;
  static constexpr bool RES = RES_;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int MINB = 4 / WGS;
  static constexpr int TH = kDxQ * WGS / 2;           // tile rows
  static constexpr int NPOS = (TH + 2) * kDxHW;       // halo pixels
  // Halo pixels a channel group: one past a multiple of 8, so that the
  // 16-byte copies of a pixel's two groups land in distinct banks.
  static constexpr int NP = (NPOS + 7) / 8 * 8 + 1;
  static constexpr int HALO = 2 * NP * 8;             // a stage's halo (bf16)
  static constexpr int BSTEP = 9 * TN * kDxCK;        // one step's w' (bf16)
  // Shared memory (bf16) besides a resident w'.
  static constexpr int FIXED = (RES ? 0 : kDxS * BSTEP) + kDxS * HALO;
  static constexpr int SMEM_MAX = WGS == 4 ? kDxSmemOne : kDxSmemTwo;
  static_assert(RES || FIXED * 2 <= SMEM_MAX, "the streamed configuration fits");
};

struct DxArgs {
  const uint16_t* dpre;  // (B, H, W, Cout) bf16
  const uint16_t* slab;  // w' in wgmma's order: (9, KC x 16, NB x 8), conv3x3_bwd.cu's
  uint16_t* dx;          // (B, H, W, Cin) bf16
  int B, H, W, Cin, Cout;
  int KC, NB;            // dpre's 16-channel steps; the slab's 8-channel column groups
  int tiles_h, tiles_w;  // pixel tiles of an image
  long long mtiles;      // B x tiles_h x tiles_w
  int ntiles, per_n;     // N tiles; blocks on each N tile
  int vec_d, vec_out;    // 16-byte copies of dpre; 32-bit stores of dx
};

// grid (ntiles x per_n): block i holds N tile i % ntiles and walks the pixel
// tiles i / ntiles, + per_n, ...; each pixel tile is KC steps of 16 dpre
// channels, and the steps of all its tiles form one pipeline. Warpgroup wg
// owns the tile's quadrant (wg / 2, wg % 2) of 8 x 8 pixels, an m64 tile
// whose eight 8-pixel rows are the A operand's core matrices.
template <class Cfg>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MINB)
    conv3x3_dx_wgmma_kernel(const DxArgs a) {
  constexpr int TN = Cfg::TN, TH = Cfg::TH, NP = Cfg::NP, S = kDxS, L = kDxL;
  constexpr int NT = Cfg::THREADS;
  extern __shared__ __align__(128) unsigned char dx_smem[];
  uint16_t* const bsm = reinterpret_cast<uint16_t*>(dx_smem);  // w': stages or resident
  uint16_t* const hsm = bsm + (Cfg::RES ? 9 * a.KC * TN * kDxCK : S * Cfg::BSTEP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int qr = (wg >> 1) * kDxQ, qc = (wg & 1) * kDxQ;  // the quadrant's origin
  const int nt = blockIdx.x % a.ntiles, first = blockIdx.x / a.ntiles;
  const int n0 = nt * TN;
  if (first >= a.mtiles) return;  // the whole block: no barrier is reached
  const long long items = (a.mtiles - 1 - first) / a.per_n + 1;
  const long long steps = items * a.KC;

  auto tile_of = [&](long long j, int& b, int& h0, int& w0) {
    const long long m = first + j * a.per_n;
    const int per = a.tiles_h * a.tiles_w;
    b = static_cast<int>(m / per);
    const int t = static_cast<int>(m - (long long)b * per);
    h0 = (t / a.tiles_w) * TH;
    w0 = (t % a.tiles_w) * kDxTW;
  };

  // Step c's w' tiles (9 taps x TN x 16, each contiguous in the slab; zero
  // past its column groups) into dst.
  auto load_b = [&](int c, uint16_t* dst) {
    constexpr int NV = TN * kDxCK / 8;  // 16-byte vectors of one tap's tile
    for (int i = tid; i < 9 * NV; i += NT) {
      const int tap = i / NV, v = i - tap * NV;
      const bool ok = n0 / 8 + v / 16 < a.NB;  // 16 vectors a column group
      const uint16_t* src =
          ok ? a.slab + (((long long)tap * a.KC + c) * a.NB + n0 / 8) * 128 + v * 8 : a.slab;
      cp_async16(dst + tap * TN * kDxCK + v * 8, src, ok);
    }
  };

  // Step s into slot: the halo of 16 dpre channels as [group][pixel][8]
  // (zero outside the image and past Cout), and w' where it streams.
  auto load = [&](long long s, int slot) {
    const long long j = s / a.KC;
    const int c = static_cast<int>(s - j * a.KC);
    int b, h0, w0;
    tile_of(j, b, h0, w0);
    uint16_t* hs = hsm + slot * Cfg::HALO;
    const uint16_t* dp = a.dpre + (long long)b * a.H * a.W * a.Cout;
    const int ch0 = c * kDxCK;
    if (a.vec_d) {
      for (int i = tid; i < Cfg::NPOS * 2; i += NT) {
        const int pos = i >> 1, grp = i & 1;
        const int r = pos / kDxHW, cc = pos - r * kDxHW;
        const int y = h0 - 1 + r, x = w0 - 1 + cc, ch = ch0 + grp * 8;
        const bool ok = y >= 0 && y < a.H && x >= 0 && x < a.W && ch < a.Cout;
        cp_async16(hs + (grp * NP + pos) * 8,
                   ok ? dp + ((long long)y * a.W + x) * a.Cout + ch : a.dpre, ok);
      }
    } else {
      for (int i = tid; i < Cfg::NPOS * kDxCK; i += NT) {
        const int pos = i / kDxCK, cc = i - pos * kDxCK;
        const int r = pos / kDxHW, col = pos - r * kDxHW;
        const int y = h0 - 1 + r, x = w0 - 1 + col, ch = ch0 + cc;
        const bool ok = y >= 0 && y < a.H && x >= 0 && x < a.W && ch < a.Cout;
        hs[((cc >> 3) * NP + pos) * 8 + (cc & 7)] =
            ok ? dp[((long long)y * a.W + x) * a.Cout + ch] : uint16_t(0);
      }
    }
    if constexpr (!Cfg::RES) load_b(c, bsm + slot * Cfg::BSTEP);
  };

  // The tile's sums. No instruction but the products writes them: a tile's
  // first product writes them fresh (scale-d 0).
  float acc[TN / 2];

  // The rounded tile from the sums: D row m = 16 wq + g + 8h of the
  // quadrant is its pixel (row 2 wq + h, column g), columns 8j + 2q, +1.
  auto epilogue = [&](long long j) {
    int b, h0, w0;
    tile_of(j, b, h0, w0);
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = h0 + qr + 2 * wq + h, x = w0 + qc + g;
      if (y >= a.H || x >= a.W) continue;
      uint16_t* d = a.dx + (((long long)b * a.H + y) * a.W + x) * a.Cin;
#pragma unroll
      for (int jj = 0; jj < TN / 8; ++jj) {
        const int n = n0 + jj * 8 + 2 * q;
        const float v0 = acc[4 * jj + 2 * h], v1 = acc[4 * jj + 2 * h + 1];
        if (a.vec_out) {
          if (n < a.Cin) *reinterpret_cast<uint32_t*>(d + n) = pack_bf16x2(v0, v1);
        } else {
          if (n < a.Cin) d[n] = __bfloat16_as_ushort(__float2bfloat16(v0));
          if (n + 1 < a.Cin) d[n + 1] = __bfloat16_as_ushort(__float2bfloat16(v1));
        }
      }
    }
  };

  // A resident w' joins the first group.
  if constexpr (Cfg::RES) {
    for (int c = 0; c < a.KC; ++c) load_b(c, bsm + c * Cfg::BSTEP);
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (i < steps) load(i, i);
    cp_async_commit();
  }
  for (long long s = 0; s < steps; ++s) {
    cp_async_wait<L - 1>();
    // The halo and w' are read by wgmma through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // This warpgroup's products of step s - 2 are done (those of s - 1 may
    // run on); after the barrier every warpgroup's are, so step s + L may
    // overwrite their slot, and step s has landed for every thread.
    wgmma_wait<1>();
    __syncthreads();
    if (s + L < steps) load(s + L, static_cast<int>((s + L) % S));
    cp_async_commit();
    const int slot = static_cast<int>(s % S);
    const long long j = s / a.KC;
    const int c = static_cast<int>(s - j * a.KC);
    // A: the quadrant shifted by the tap, K-major: the 16 channels of a
    // pixel in two core matrices a group apart, its 8-pixel rows a halo row
    // (kDxHW pixels) apart. B: w' in core-matrix order.
    const uint64_t da = smem_desc(hsm + slot * Cfg::HALO + (qr * kDxHW + qc) * 8, NP * 16,
                                  kDxHW * 16);
    const uint64_t db = b_desc(Cfg::RES ? bsm + c * Cfg::BSTEP : bsm + slot * Cfg::BSTEP);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      wgmma_ss<0, 0>(acc, da + (((ky * kDxHW + kx) * 16) >> 4),
                     db + ((tap * TN * kDxCK * 2) >> 4), tap > 0 || c > 0);
    }
    wgmma_commit();
    if (c == a.KC - 1) {
      wgmma_wait<0>();
      fence_operand(acc);
      epilogue(j);
    }
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
}

template <class Cfg>
cudaError_t launch_dx(DxArgs a, int smem_bytes, int sms, cudaStream_t s) {
  a.tiles_h = (a.H + Cfg::TH - 1) / Cfg::TH;
  a.tiles_w = (a.W + kDxTW - 1) / kDxTW;
  a.mtiles = (long long)a.B * a.tiles_h * a.tiles_w;
  a.ntiles = (a.Cin + Cfg::TN - 1) / Cfg::TN;
  a.per_n = static_cast<int>(
      std::max<long long>(1, std::min<long long>(a.mtiles, sms * Cfg::MINB / a.ntiles)));
  const long long blocks = (long long)a.ntiles * a.per_n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const auto kernel = &conv3x3_dx_wgmma_kernel<Cfg>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), Cfg::THREADS, smem_bytes, s>>>(a);
  return cudaGetLastError();
}

// Shared memory of a resident w' of KC steps at TN beside two warpgroups'
// halo stages.
long long res_bytes(int TN, int KC) {
  return 2 * (9LL * KC * TN * kDxCK + kDxS * DxCfg<16, true, 2>::HALO);
}

// The plan of sde_conv3x3_bwd_dx_bf16 for (Cin, Cout): plan[0] the N tile,
// plan[1] 1 where w' is resident (two warpgroups, two blocks an SM), 0
// where it streams (four warpgroups, one block an SM), plan[2] the shared
// memory a block takes.
void dx_wgmma_plan(int Cin, int Cout, int* plan) {
  const int KC = (Cout + kDxCK - 1) / kDxCK;
  const int tn = Cin <= 16 ? 16 : Cin <= 32 ? 32 : Cin <= 64 ? 64 : 128;
  // The widest tile whose resident w' fits (the one covering Cin, or half
  // of it); else w' streams.
  for (int t = tn; t >= 16 && t >= tn / 2; t /= 2) {
    if (res_bytes(t, KC) <= kDxSmemTwo) {
      plan[0] = t;
      plan[1] = 1;
      plan[2] = static_cast<int>(res_bytes(t, KC));
      return;
    }
  }
  plan[0] = tn <= 64 ? 64 : 128;
  plan[1] = 0;
  plan[2] = plan[0] == 64 ? DxCfg<64, false, 4>::FIXED * 2 : DxCfg<128, false, 4>::FIXED * 2;
}

}  // namespace
}  // namespace sde

// How sde_conv3x3_bwd_dx_bf16 runs (Cin, Cout): plan (3 ints) as
// sde::dx_wgmma_plan gives it.
extern "C" int sde_conv3x3_bwd_dx_plan(int Cin, int Cout, int* plan) {
  if (Cin <= 0 || Cout <= 0) return static_cast<int>(cudaErrorInvalidValue);
  sde::dx_wgmma_plan(Cin, Cout, plan);
  return 0;
}

// The interior of the bf16 input gradient: dx (B, H, W, Cin) from dpre (B,
// H, W, Cout) and the slab of w' that sde_conv3x3_bwd_slab_bf16 writes (9,
// round_up(Cout, 16), round_up(Cin, 8)), bf16, contiguous; the zero border
// (the fold adds the others' gradients after it). Cin, Cout >= 2.
extern "C" int sde_conv3x3_bwd_dx_bf16(const void* dpre, const void* slab, void* dx, int B, int H,
                                       int W, int Cin, int Cout, int device, void* stream) {
  cudaError_t err = sde::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || H <= 0 || W <= 0 || Cin < 2 || Cout < 2 || (long long)B * H * W >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = sde::sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  sde::DxArgs a{};
  a.dpre = static_cast<const uint16_t*>(dpre);
  a.slab = static_cast<const uint16_t*>(slab);
  a.dx = static_cast<uint16_t*>(dx);
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.KC = (Cout + sde::kDxCK - 1) / sde::kDxCK;
  a.NB = (Cin + 7) / 8;
  a.vec_d = Cout % 8 == 0 && (reinterpret_cast<uintptr_t>(dpre) & 15) == 0;
  a.vec_out = Cin % 2 == 0 && (reinterpret_cast<uintptr_t>(dx) & 3) == 0;
  int plan[3];
  sde::dx_wgmma_plan(Cin, Cout, plan);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using sde::DxCfg;
  if (plan[1]) {
    switch (plan[0]) {
      case 16: return static_cast<int>(sde::launch_dx<DxCfg<16, true, 2>>(a, plan[2], sms, s));
      case 32: return static_cast<int>(sde::launch_dx<DxCfg<32, true, 2>>(a, plan[2], sms, s));
      case 64: return static_cast<int>(sde::launch_dx<DxCfg<64, true, 2>>(a, plan[2], sms, s));
      default: return static_cast<int>(sde::launch_dx<DxCfg<128, true, 2>>(a, plan[2], sms, s));
    }
  }
  if (plan[0] == 64) return static_cast<int>(sde::launch_dx<DxCfg<64, false, 4>>(a, plan[2], sms, s));
  return static_cast<int>(sde::launch_dx<DxCfg<128, false, 4>>(a, plan[2], sms, s));
}
