// winograd: a zero-padded 3x3 stride-1 conv as Winograd F(2x2, 3x3) in
// phase space, with the folded-BN bias, an optional residual and an
// optional ReLU fused, NHWC.
//
//   x_ab = x[:, a::2, b::2, :]  (B, Hp, Wp, C), a, b in {0, 1}   (phases)
//   y    = relu(conv3x3_zero_pad(x, g) + bias (+ residual))       (phases)
//
// One Winograd tile is the 2x2 output block at (2r, 2c); it reads the 4x4
// input window at rows 2r-1 .. 2r+2 and columns 2c-1 .. 2c+2: tap k along
// an axis is phase parity (k+1)%2 at phase index r + (k+1)/2 - 1, zero
// outside the image. V = B^T d B (B^T rows d0-d2, d1+d2, d2-d1, d1-d3),
// M_k = V_k . U_k for the 16 products k = 4i+j (U from transform_weights,
// (16, C, Co)), Y = A^T M A (A^T rows m0+m1+m2, m1-m2-m3).
//
// Replaces the TPU kernel scenedepthestimation_tpu/ops/pallas/winograd.py::
// winograd_conv3x3_phases. As there, the input transform is taken in the
// phases' dtype (bf16 rounds after the row pass and again after the
// column pass), the products and the output transform in fp32, then +
// bias (fp32) + residual, ReLU and one rounding to the output dtype.
//
// What bounds it on an H100: at the ResNet-18 encoder's stage shapes of
// the b128 bf16 bench (96x288 C=64 .. 12x36 C=512) each conv is 116 GFLOP
// of Winograd products (0.12 ms on the bf16 tensor cores) and reads and
// writes 453 .. 57 MB a tensor: the C=64 and C=128 stages are bound by
// bytes, C=256 and C=512 by the products. The design keeps every
// intermediate on chip: one read of the phases (+ residual), one write of
// the output phases.
//
// Two kernels on one tiling: a block takes 64 consecutive tiles of the
// flattened (B, Hp, Wp) tile grid (so any Hp, Wp and the batch pack the
// blocks fully) and 64 output channels, and loops over the input channels
// in chunks: it builds V for its tiles and the chunk in shared memory
// (each thread loads 16 taps of a few channels straight from the phases,
// L1 and L2 catch the overlap of neighbouring windows), stages U's chunk,
// then runs the 16 products of the chunk and adds each, with its output
// transform coefficient (0 or +-1), into four output-phase accumulators.
// The transform is linear, so only those four live across the C loop.
// * bf16 (winograd_tc_kernel): the products on mma.sync.m16n8k16 (bf16
//   in, fp32 sums), 16 channels a chunk; 8 warps as 4 (16 tiles) x 2 (32
//   output channels).
// * fp32 (winograd_fp32_kernel, CUDA cores, no TF32): 8 channels a chunk;
//   each thread a 4 tiles x 4 channels block.
// C and Co need not be multiples of anything: channels past C are zero in
// V and U, outputs past Co are not written.
//
// Later work: wgmma and TMA; V built once for all Co blocks; the next
// chunk's loads in flight during the products; 16-byte stores.
#include "common.cuh"

namespace sde {
namespace {

constexpr int kThreads = 256;
constexpr int kMT = 64;  // Winograd tiles a block
constexpr int kNT = 64;  // output channels a block

struct WinoArgs {
  const void* x[4];  // input phases 00 01 10 11
  long long sxb, sxh, sxw;
  const void* r[4];  // residual phases, r[0] == nullptr: none
  long long srb, srh, srw;
  const void* u;      // (16, C, Co) in the phases' dtype
  const float* bias;  // (Co)
  void* y[4];         // output phases
  long long syb, syh, syw;
  int Hp, Wp, C, Co;
  long long M;  // B * Hp * Wp tiles
  bool relu;
};

// Output transform coefficient of product k = 4i + j for output phase
// o = 2p + q: A^T[p][i] * A^T[q][j], A^T = [[1, 1, 1, 0], [0, 1, -1, -1]].
__host__ __device__ constexpr float at_coef(int p, int i) {
  return p == 0 ? (i == 3 ? 0.f : 1.f) : (i == 0 ? 0.f : (i == 1 ? 1.f : -1.f));
}
__host__ __device__ constexpr float out_coef(int o, int k) {
  return at_coef(o >> 1, k >> 2) * at_coef(o & 1, k & 3);
}

// Where tile m's taps lie: tile (b, r, c), its element offset in a phase
// with these strides, and which of the rows r-1, r+1 and columns c-1, c+1
// exist.
struct Tile {
  long long base;
  bool valid, up, down, left, right;
};

__device__ __forceinline__ Tile locate(long long m, const WinoArgs& a) {
  Tile t;
  t.valid = m < a.M;
  const long long mm = t.valid ? m : 0;
  const long long per_img = (long long)a.Hp * a.Wp;
  const long long b = mm / per_img;
  const int rem = static_cast<int>(mm - b * per_img);
  const int r = rem / a.Wp, c = rem - (rem / a.Wp) * a.Wp;
  t.base = b * a.sxb + r * a.sxh + c * a.sxw;
  t.up = r > 0;
  t.down = r + 1 < a.Hp;
  t.left = c > 0;
  t.right = c + 1 < a.Wp;
  return t;
}

// Tap (k, l) of a tile: its phase and element offset; ok = inside the image.
__device__ __forceinline__ int tap_phase(int k, int l) {
  return 2 * ((k + 1) & 1) + ((l + 1) & 1);
}
__device__ __forceinline__ long long tap_offset(const Tile& t, int k, int l,
                                                const WinoArgs& a, bool& ok) {
  const int dr = ((k + 1) >> 1) - 1, dc = ((l + 1) >> 1) - 1;
  ok = t.valid && (dr >= 0 || t.up) && (dr <= 0 || t.down) && (dc >= 0 || t.left) &&
       (dc <= 0 || t.right);
  return t.base + dr * a.sxh + dc * a.sxw;
}

// Element offset of tile m in a phase with strides (sb, sh, sw).
__device__ __forceinline__ long long tile_offset(long long m, const WinoArgs& a,
                                                 long long sb, long long sh,
                                                 long long sw) {
  const long long per_img = (long long)a.Hp * a.Wp;
  const long long b = m / per_img;
  const int rem = static_cast<int>(m - b * per_img);
  return b * sb + (long long)(rem / a.Wp) * sh + (long long)(rem % a.Wp) * sw;
}

// ---- bf16: the products on the tensor cores ----------------------------
constexpr int kCC = 16;       // input channels a chunk: one k16 step
constexpr int kVP = kCC + 8;  // V row pitch (bf16): rows g fall in distinct banks
constexpr int kUP = kNT + 8;  // U row pitch (bf16): ldmatrix rows in distinct banks
constexpr int kTcWarps = kThreads / 32;
static_assert(kTcWarps == 8 && kMT == 4 * 16 && kNT == 2 * 32, "warp tiling");
constexpr int kVElems = 16 * kMT * kVP;
constexpr int kUElems = 16 * kCC * kUP;
constexpr int kTcSmem = 2 * (kVElems + kUElems);

using bf2 = __nv_bfloat162;

// 4 channels of a tap as two bf16 pairs; zero outside the image or past C.
__device__ __forceinline__ void load_tap(bf2 (&d)[2], const uint16_t* p, bool ok,
                                         int c, int C, bool vec) {
  if (vec) {
    uint2 raw = make_uint2(0u, 0u);
    if (ok && c < C) raw = *reinterpret_cast<const uint2*>(p);
    d[0] = *reinterpret_cast<bf2*>(&raw.x);
    d[1] = *reinterpret_cast<bf2*>(&raw.y);
  } else {
    uint16_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (ok && c + e < C) ? p[e] : uint16_t(0);
    const uint32_t lo = v[0] | (uint32_t(v[1]) << 16), hi = v[2] | (uint32_t(v[3]) << 16);
    d[0] = *reinterpret_cast<const bf2*>(&lo);
    d[1] = *reinterpret_cast<const bf2*>(&hi);
  }
}

// grid: (ceil(M / kMT), ceil(Co / kNT)). `vec_in`: C % 4 == 0 and the
// phases' strides and pointers allow 8-byte loads; `vec_u`: Co % 8 == 0
// and u 16-byte aligned; `vec_out`: bf16 pairs can be stored as one word.
__global__ void __launch_bounds__(kThreads, 2)
    winograd_tc_kernel(const WinoArgs a, bool vec_in, bool vec_u, bool vec_out) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  uint16_t* vs = reinterpret_cast<uint16_t*>(dyn_smem);  // [16][kMT][kVP]
  uint16_t* us = vs + kVElems;                           // [16][kCC][kUP]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const long long m0 = (long long)blockIdx.x * kMT;
  const int n0 = blockIdx.y * kNT;
  const uint16_t* u = static_cast<const uint16_t*>(a.u);

  // The tile and 4 channels this thread transforms in every chunk.
  const int my_tile = tid >> 2, my_c = (tid & 3) * 4;
  const Tile tile = locate(m0 + my_tile, a);

  float acc[4][4][4];  // [output phase][n8 tile][fragment]
#pragma unroll
  for (int o = 0; o < 4; ++o)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[o][nt][e] = 0.f;

  for (int c0 = 0; c0 < a.C; c0 += kCC) {
    __syncthreads();  // the previous chunk's products are done with vs, us
    // ---- V = B^T d B for this thread's tile and 4 channels, in bf16.
    {
      const int c = c0 + my_c;
      bf2 t[4][4][2];  // [i][l][pair]: the row pass, one column l at a time
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        bf2 d[4][2];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          bool ok;
          const long long off = tap_offset(tile, k, l, a, ok);
          load_tap(d[k], static_cast<const uint16_t*>(a.x[tap_phase(k, l)]) + off + c,
                   ok, c, a.C, vec_in);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          t[0][l][h] = __hsub2(d[0][h], d[2][h]);
          t[1][l][h] = __hadd2(d[1][h], d[2][h]);
          t[2][l][h] = __hsub2(d[2][h], d[1][h]);
          t[3][l][h] = __hsub2(d[1][h], d[3][h]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bf2 v[4][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          v[0][h] = __hsub2(t[i][0][h], t[i][2][h]);
          v[1][h] = __hadd2(t[i][1][h], t[i][2][h]);
          v[2][h] = __hsub2(t[i][2][h], t[i][1][h]);
          v[3][h] = __hsub2(t[i][1][h], t[i][3][h]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint2 st;
          st.x = *reinterpret_cast<uint32_t*>(&v[j][0]);
          st.y = *reinterpret_cast<uint32_t*>(&v[j][1]);
          *reinterpret_cast<uint2*>(vs + ((4 * i + j) * kMT + my_tile) * kVP + my_c) = st;
        }
      }
    }
    // ---- U's chunk: us[k][c][n] = u[k][c0 + c][n0 + n], zero past C, Co.
    if (vec_u) {
      for (int e = tid; e < 16 * kCC * (kNT / 8); e += kThreads) {
        const int nv = e % (kNT / 8), c = (e / (kNT / 8)) % kCC, k = e / (kCC * (kNT / 8));
        const int n = n0 + nv * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (c0 + c < a.C && n < a.Co)
          val = *reinterpret_cast<const uint4*>(u + ((long long)k * a.C + c0 + c) * a.Co + n);
        *reinterpret_cast<uint4*>(us + (k * kCC + c) * kUP + nv * 8) = val;
      }
    } else {
      for (int e = tid; e < 16 * kCC * kNT; e += kThreads) {
        const int nn = e % kNT, c = (e / kNT) % kCC, k = e / (kCC * kNT);
        const int n = n0 + nn;
        us[(k * kCC + c) * kUP + nn] =
            (c0 + c < a.C && n < a.Co) ? u[((long long)k * a.C + c0 + c) * a.Co + n]
                                       : uint16_t(0);
      }
    }
    __syncthreads();

    // ---- the 16 products of the chunk, each into the output phases.
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      uint32_t af[4];
      const uint16_t* vp = vs + (k * kMT + wm * 16 + g) * kVP + 2 * q;
      af[0] = lds32(vp);
      af[1] = lds32(vp + 8 * kVP);
      af[2] = lds32(vp + 8);
      af[3] = lds32(vp + 8 * kVP + 8);
      uint32_t bf[4][2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t r[4];
        ldsm_x4_trans(r, us + (k * kCC + (lane & 15)) * kUP + wn * 32 + half * 16 +
                             (lane >> 4) * 8);
        bf[2 * half][0] = r[0];
        bf[2 * half][1] = r[1];
        bf[2 * half + 1][0] = r[2];
        bf[2 * half + 1][1] = r[3];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float m[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(m, af, bf[nt][0], bf[nt][1]);
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const float cf = out_coef(o, k);
          if (cf == 0.f) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[o][nt][e] += cf * m[e];
        }
      }
    }
  }

  // ---- epilogue: + bias (+ residual), ReLU, one rounding to bf16.
  const bool has_res = a.r[0] != nullptr;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long m = m0 + wm * 16 + g + 8 * hh;
    if (m >= a.M) continue;
    const long long oy = tile_offset(m, a, a.syb, a.syh, a.syw);
    const long long orr = has_res ? tile_offset(m, a, a.srb, a.srh, a.srw) : 0;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + 2 * q;
      if (n >= a.Co) continue;
      const bool two = n + 1 < a.Co;
      const float b0 = a.bias[n], b1 = two ? a.bias[n + 1] : 0.f;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        float v0 = acc[o][nt][2 * hh] + b0, v1 = acc[o][nt][2 * hh + 1] + b1;
        if (has_res) {
          const __nv_bfloat16* rp = static_cast<const __nv_bfloat16*>(a.r[o]) + orr + n;
          v0 += __bfloat162float(rp[0]);
          if (two) v1 += __bfloat162float(rp[1]);
        }
        if (a.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.y[o]) + oy + n;
        if (vec_out) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (two) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---- fp32: the products on the CUDA cores -----------------------------
constexpr int kCC32 = 8;        // input channels a chunk
constexpr int kVP32 = kMT + 4;  // V row pitch (floats): the transform's stores spread over banks
constexpr int kV32Elems = 16 * kCC32 * kVP32;
constexpr int kU32Elems = 16 * kCC32 * kNT;
constexpr int kFp32Smem = 4 * (kV32Elems + kU32Elems);

// grid as the bf16 kernel. `vec_u`: Co % 4 == 0 and u 16-byte aligned.
__global__ void __launch_bounds__(kThreads, 2)
    winograd_fp32_kernel(const WinoArgs a, bool vec_u) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  float* vs = reinterpret_cast<float*>(dyn_smem);  // [16][kCC32][kVP32]: tiles inner
  float* us = vs + kV32Elems;                      // [16][kCC32][kNT]

  const int tid = threadIdx.x;
  const int tm = tid & 15, tn = tid >> 4;  // tiles 4tm.., channels 4tn..
  const long long m0 = (long long)blockIdx.x * kMT;
  const int n0 = blockIdx.y * kNT;
  const float* u = static_cast<const float*>(a.u);

  // This thread transforms channel my_c of tiles my_tile and my_tile + 32.
  const int my_c = tid & 7, my_tile = tid >> 3;
  const Tile tiles[2] = {locate(m0 + my_tile, a), locate(m0 + my_tile + 32, a)};

  float acc[4][4][4];  // [output phase][tile][channel]
#pragma unroll
  for (int o = 0; o < 4; ++o)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[o][i][j] = 0.f;

  for (int c0 = 0; c0 < a.C; c0 += kCC32) {
    __syncthreads();
    const int c = c0 + my_c;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float t[4][4];  // [i][l]
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        float d[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          bool ok;
          const long long off = tap_offset(tiles[s], k, l, a, ok);
          d[k] = (ok && c < a.C)
                     ? static_cast<const float*>(a.x[tap_phase(k, l)])[off + c]
                     : 0.f;
        }
        t[0][l] = __fsub_rn(d[0], d[2]);
        t[1][l] = __fadd_rn(d[1], d[2]);
        t[2][l] = __fsub_rn(d[2], d[1]);
        t[3][l] = __fsub_rn(d[1], d[3]);
      }
      float* vt = vs + my_c * kVP32 + my_tile + 32 * s;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        vt[(4 * i + 0) * kCC32 * kVP32] = __fsub_rn(t[i][0], t[i][2]);
        vt[(4 * i + 1) * kCC32 * kVP32] = __fadd_rn(t[i][1], t[i][2]);
        vt[(4 * i + 2) * kCC32 * kVP32] = __fsub_rn(t[i][2], t[i][1]);
        vt[(4 * i + 3) * kCC32 * kVP32] = __fsub_rn(t[i][1], t[i][3]);
      }
    }
    if (vec_u) {
      for (int e = tid; e < 16 * kCC32 * (kNT / 4); e += kThreads) {
        const int nv = e % (kNT / 4), cc = (e / (kNT / 4)) % kCC32, k = e / (kCC32 * (kNT / 4));
        const int n = n0 + nv * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c0 + cc < a.C && n < a.Co)
          val = *reinterpret_cast<const float4*>(u + ((long long)k * a.C + c0 + cc) * a.Co + n);
        *reinterpret_cast<float4*>(us + (k * kCC32 + cc) * kNT + nv * 4) = val;
      }
    } else {
      for (int e = tid; e < 16 * kCC32 * kNT; e += kThreads) {
        const int nn = e % kNT, cc = (e / kNT) % kCC32, k = e / (kCC32 * kNT);
        const int n = n0 + nn;
        us[(k * kCC32 + cc) * kNT + nn] =
            (c0 + cc < a.C && n < a.Co) ? u[((long long)k * a.C + c0 + cc) * a.Co + n] : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float m[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) m[i][j] = 0.f;
#pragma unroll
      for (int cc = 0; cc < kCC32; ++cc) {
        const float4 av = *reinterpret_cast<const float4*>(vs + (k * kCC32 + cc) * kVP32 + 4 * tm);
        const float4 bv = *reinterpret_cast<const float4*>(us + (k * kCC32 + cc) * kNT + 4 * tn);
        const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) m[i][j] = fmaf(ar[i], br[j], m[i][j]);
      }
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const float cf = out_coef(o, k);
        if (cf == 0.f) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[o][i][j] += cf * m[i][j];
      }
    }
  }

  const bool has_res = a.r[0] != nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + 4 * tm + i;
    if (m >= a.M) continue;
    const long long oy = tile_offset(m, a, a.syb, a.syh, a.syw);
    const long long orr = has_res ? tile_offset(m, a, a.srb, a.srh, a.srw) : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tn + j;
      if (n >= a.Co) continue;
      const float bn = a.bias[n];
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        float v = acc[o][i][j] + bn;
        if (has_res) v += static_cast<const float*>(a.r[o])[orr + n];
        if (a.relu) v = fmaxf(v, 0.f);
        static_cast<float*>(a.y[o])[oy + n] = v;
      }
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

}  // namespace
}  // namespace sde

// Phases x (B, Hp, Wp, C), residual r and output y (B, Hp, Wp, Co), four
// pointers each with the strides (elements) they share over batch, row and
// column; channels contiguous. r00 == nullptr: no residual. u (16, C, Co)
// contiguous in `dtype`, bias (Co) fp32. y must not overlap x or r.
extern "C" int sde_winograd(const void* x00, const void* x01, const void* x10,
                            const void* x11, long long sxb, long long sxh,
                            long long sxw, const void* r00, const void* r01,
                            const void* r10, const void* r11, long long srb,
                            long long srh, long long srw, const void* u,
                            const void* bias, void* y00, void* y01, void* y10,
                            void* y11, long long syb, long long syh, long long syw,
                            int B, int Hp, int Wp, int C, int Co, int relu,
                            int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || Hp < 1 || Wp < 1 || C < 1 || Co < 1) return static_cast<int>(cudaErrorInvalidValue);
  sde::WinoArgs a;
  a.x[0] = x00; a.x[1] = x01; a.x[2] = x10; a.x[3] = x11;
  a.sxb = sxb; a.sxh = sxh; a.sxw = sxw;
  a.r[0] = r00; a.r[1] = r01; a.r[2] = r10; a.r[3] = r11;
  a.srb = srb; a.srh = srh; a.srw = srw;
  a.u = u;
  a.bias = static_cast<const float*>(bias);
  a.y[0] = y00; a.y[1] = y01; a.y[2] = y10; a.y[3] = y11;
  a.syb = syb; a.syh = syh; a.syw = syw;
  a.Hp = Hp; a.Wp = Wp; a.C = C; a.Co = Co;
  a.M = (long long)B * Hp * Wp;
  a.relu = relu != 0;
  const long long mblocks = (a.M + sde::kMT - 1) / sde::kMT;
  if (mblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(mblocks), (Co + sde::kNT - 1) / sde::kNT);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sde::kFloat32) {
    err = cudaFuncSetAttribute(sde::winograd_fp32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, sde::kFp32Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool vec_u = Co % 4 == 0 && sde::aligned(u, 16);
    sde::winograd_fp32_kernel<<<grid, sde::kThreads, sde::kFp32Smem, s>>>(a, vec_u);
  } else {
    err = cudaFuncSetAttribute(sde::winograd_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, sde::kTcSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    bool vec_in = C % 4 == 0 && sxb % 4 == 0 && sxh % 4 == 0 && sxw % 4 == 0;
    for (const void* p : a.x) vec_in = vec_in && sde::aligned(p, 8);
    const bool vec_u = Co % 8 == 0 && sde::aligned(u, 16);
    bool vec_out = Co % 2 == 0 && syb % 2 == 0 && syh % 2 == 0 && syw % 2 == 0;
    for (void* p : a.y) vec_out = vec_out && sde::aligned(p, 4);
    sde::winograd_tc_kernel<<<grid, sde::kThreads, sde::kTcSmem, s>>>(a, vec_in, vec_u,
                                                                      vec_out);
  }
  return static_cast<int>(cudaGetLastError());
}
