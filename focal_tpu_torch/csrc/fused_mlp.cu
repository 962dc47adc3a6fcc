// Fused Swin MLP for Hopper (sm_90a): fc1 -> exact GELU -> fc2 on [T, C]
// token rows, forward (#10), forward with dropout (#11) and backward (#12,
// with and without dropout).
//
// Replaces the TPU kernels of focal_tpu/ops/pallas_kernels.py:
//   #10 _mlp_fwd_kernel          (_mlp_fwd_impl, seed None -> pl.pallas_call)
//   #11 _mlp_fwd_dropout_kernel  (_mlp_fwd_impl with a seed)
//   #12 _mlp_bwd_kernel and _mlp_bwd_dropout_kernel (_mlp_bwd_impl)
// With x [T, C], W1 [C, H], b1 [H], W2 [H, C], b2 [C] (H = 4C in Swin):
//   z = x W1 + b1,  h = GELU(z) * keep1 / (1 - rate),
//   y = (h W2 + b2) * keep2 / (1 - rate)
// and for the gradient g of y, g2 = g * keep2 / (1 - rate):
//   dh = g2 W2^T,  dz = dh * keep1 / (1 - rate) * GELU'(z)
//   dx = dz W1^T,  dW1 = x^T dz,  db1 = sum dz,  dW2 = h^T g2,  db2 = sum g2.
// keep1 [T, H] and keep2 [T, C] are Philox4x32-10 bits keyed by the seed and
// counted by (row, column / 4, site): kept iff bits >= threshold = rate*2^32,
// as the TPU kernel draws them (pk:506-513). The masks are never stored:
// the backward draws them again from the seed, as the TPU kernel does.
// GELU is the exact erff one (the TPU kernel's erf is a polynomial).
//
// What bounds them on this card: operations. Each output of fc1 and fc2 is
// a C- or H-long dot product; at C = 64 a row does 4CH = 65,536 FLOPs for
// 2C*4 = 512 bytes of x and y, far above the f32 ridge of 20 FLOP/byte
// (67 TFLOP/s over 3.35 TB/s) and the TF32 tensor cores' 148.
//
// What the design does about it: every product is a row-tiled product on
// the tensor cores over all the rows of a chunk, 128 x 128 output tiles a
// block, or 128 x 64 (two blocks an SM) where the product's width is not a
// multiple of 128 (C = 64) and for the hidden products of the backward and
// of forwards at C < 256 (make_plan), 3xTF32 (gemm_3xtf32.cuh: f32
// accuracy, the ~1e-4 gates hold), with the elementwise work in the
// products' epilogues:
//   forward (#10, #11): h = GELU(x W1 + b1) (keep1) into a workspace
//       [rows, H]; y = h W2 + b2 (keep2). Two launches.
//   backward (#12): g2 = g keep2 / (1 - rate) into [rows, C] (with dropout
//       only; else g itself); one launch computes z = x W1 + b1 and then,
//       in the same block over the same tile, dh = g2 W2^T, whose epilogue
//       reads z back (its own thread's writes, still in L2) and writes dz
//       and the h the forward used (keep1) over it; dx = dz W1^T (W1^T as
//       nn.Linear holds it, [H, C]); the weight gradients x^T dz | sum dz
//       and h^T g2 | sum g2 as fixed split-K partials (gemm_splitk.cuh,
//       the core #3 and #5 use), summed in split order. 10 TCH FLOPs (the
//       first port recomputed z and dh twice: 14), no float atomics: two
//       calls give the same bits.
// The workspaces are transient (one call) and capped: the rows are
// processed in chunks so that one [rows, H] array stays within
// kChunkFloats (128 MiB; MOD_WIDE's audio stage 0, [73,728, 1,024], takes
// three chunks). Later chunks add their weight-gradient partials to the
// first chunk's, in chunk order. So -pallas_mlp keeps its memory: autograd
// saves only x and the weights.
// The backward's hidden kernel (two products, then GELU' and the mask in
// its epilogue) spills ~150 bytes a thread at 128 registers; without the
// spill at one block an SM it was 6 % slower on the H100.
// Not yet (f32): keeping h on chip, wgmma and TMA; the bf16 forms below do
// both.
//
// The bf16 forms (-compute_dtype bfloat16): #10-bf16 (forward), #11-bf16
// (forward with dropout) and #12-bf16 (backward) replace the same TPU
// kernels fed a bf16 x (pk:516-609, called with the f32 weights uncast by
// focal_tpu/models/swin.py:431-446), and round where the TPU kernel rounds:
// the weights to bf16 (w1_ref[...].astype(x.dtype)); z = x W1 + b1 and the
// GELU in f32 with the TPU kernel's erf (the A-S polynomial, pk:484-503:
// ROADMAP C6); h (keep1), g2 = g keep2 / (1 - rate) and dz = dh keep1 /
// (1 - rate) GELU'(z) rounded to bf16 before their products; db1 summed
// from the f32 dz (pk:564), db2 from the f32 g2; y and dx stored as bf16,
// the weight and bias gradients f32. The masks are #11's Philox draws
// (keep_bits): the same seed gives #11's masks.
// What bounds them: operations (4TCH / 10TCH at 989 TFLOP/s bf16; x, y, g
// and dx move 2 bytes a value). What the design does about it: every
// product is a wgmma on bf16 tiles that TMA stages in a ring of shared
// memory, one producer warpgroup and two consumer warpgroups a block
// (gemm_wgmma.cuh); the weights are rounded to bf16 once a call
// (mlp_wcast_kernel) and read as they lie in either major order, so no
// transposed copy is made.
//   forward, C <= 256 (mlp_wg_fwd_kernel): one launch; a block's 128 rows
//       walk H in 64-column chunks, z by wgmma from shared memory, the GELU
//       (keep1) in the epilogue rounded to bf16 straight into the register
//       A fragments of y += h W2[chunk, :], y in registers across the
//       chunks: h never reaches device memory, and the only bytes are x, y
//       and the weights (from L2 in every block).
//   forward, C > 256: row chunks of two launches, h = GELU(x W1 + b1) into
//       a bf16 workspace (mlp_wg_gelu_kernel), y = h W2 + b2
//       (mlp_wg_out_kernel): y's 64 x C accumulator would not fit in a
//       thread's registers.
//   backward (#12-bf16): row chunks of g2 (bf16, with db2's f32 per-tile
//       column partials; mlp_wg_g2_kernel), z = x W1 and dh = g2 W2^T over
//       one tile (mlp_wg_hidden_kernel: dz and the h the forward used
//       stored as bf16, db1's f32 per-tile partials), dx = dz W1^T
//       (mlp_wg_out_kernel), dW1 = x^T dz and dW2 = h^T g2 over fixed row
//       splits (gemm_wgmma.cuh's wg_wgrad_kernel, both operands MN-major
//       as they lie); then one reduction in fixed order (wg_reduce_kernel;
//       both shared with #3-bf16 and #5-bf16). No float
//       atomics: two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "gemm_3xtf32.cuh"
#include "gemm_splitk.cuh"
#include "gemm_wgmma.cuh"
#include "philox.cuh"

namespace focal {
struct FusedMlpSrc {};  // tags this library's instances of gemm_splitk.cuh's kernels
}  // namespace focal

namespace {

using Src = focal::FusedMlpSrc;
constexpr int kThreads = 256;
constexpr int kSiteHidden = 0;    // keep1, after the GELU
constexpr int kSiteOut = 1;       // keep2, after fc2
constexpr long long kChunkFloats = 1ll << 25;  // one [rows, H] workspace: 128 MiB at most
static_assert(kThreads == focal::kGemmThreads, "one block size for every kernel here");

// The keep bits of columns 4*col4 .. 4*col4 + 3 of `row` at `site`: word u
// belongs to column 4*col4 + u (Philox4x32-10, philox.cuh). Every kernel
// here draws through this.
__device__ __forceinline__ uint4 keep_bits(unsigned long long seed, int row, int col4, int site) {
  return focal::philox4x32_10(make_uint4((unsigned)row, (unsigned)col4, (unsigned)site, 0u),
                              focal::philox_key(seed));
}

__device__ __forceinline__ unsigned word(const uint4& r, int u) {
  return u == 0 ? r.x : u == 1 ? r.y : u == 2 ? r.z : r.w;
}

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.f + erff(z * 0.7071067811865476f));
}

__device__ __forceinline__ float gelu_grad(float z) {
  return 0.5f * (1.f + erff(z * 0.7071067811865476f)) + z * expf(-0.5f * z * z) * 0.3989422804014327f;
}

struct Keep {
  unsigned long long seed;
  unsigned threshold;
  float inv_keep;
};

// Whether columns col and col + 1 (col even) of `row` are kept at `site`.
__device__ __forceinline__ void kept_pair(const Keep& k, int row, int col, int site, bool& k0,
                                          bool& k1) {
  const uint4 b = keep_bits(k.seed, row, col >> 2, site);
  const int u = col & 3;  // 0 or 2
  k0 = word(b, u) >= k.threshold;
  k1 = word(b, u + 1) >= k.threshold;
}

// v scaled by 1 / (1 - rate) where kept, else 0.
__device__ __forceinline__ float keep_or_zero(bool kept, float v, const Keep& k) {
  return kept ? v * k.inv_keep : 0.f;
}

// The hidden products of a chunk of `rows` rows (row0: its first row in
// the call, which counts the Philox draws). Forward: h = GELU(x W1 + b1),
// keep1 with kDropout. Backward: z = x W1 + b1, then dh = g2 W2^T over the
// same tile, dz = dh GELU'(z) and the h the forward used, both with keep1.
struct HiddenArgs {
  const float* x;    // [rows, C]
  const float* w1;   // [C, H]
  const float* b1;   // [H]
  const float* g2;   // [rows, C] (backward)
  const float* w2t;  // [C, H] (backward): W2 transposed
  float* h;          // [rows, H]: h (backward: z, then h as used)
  float* dz;         // [rows, H] (backward)
  int rows, C, H, row0;
  Keep keep;
};

template <int kBN, bool kBackward, bool kDropout>
__global__ void __launch_bounds__(kThreads, kBN == 64 ? 2 : 1) mlp_hidden_kernel(const HiddenArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tiles_n = (p.H + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / tiles_n) * focal::kGemmBM, n0 = (blockIdx.x % tiles_n) * kBN;
  float acc[4][focal::gemm_nt<kBN>()][4], csum = 0.f;
  focal::gemm_tile<false, false, kBN>(p.x, p.C, p.w1, p.H, p.rows, p.H, m0, n0, 0, p.C, smem, acc,
                                      csum);
  focal::gemm_for_each_output<kBN>(acc, p.rows, p.H, m0, n0, [&](int row, int col, float v0, float v1) {
    v0 += __ldg(p.b1 + col);
    v1 += __ldg(p.b1 + col + 1);
    if (!kBackward) {
      v0 = gelu(v0);
      v1 = gelu(v1);
      if (kDropout) {
        bool k0, k1;
        kept_pair(p.keep, p.row0 + row, col, kSiteHidden, k0, k1);
        v0 = keep_or_zero(k0, v0, p.keep);
        v1 = keep_or_zero(k1, v1, p.keep);
      }
    }
    *reinterpret_cast<float2*>(p.h + (size_t)row * p.H + col) = make_float2(v0, v1);
  });
  if (!kBackward) return;
  __syncthreads();  // every warp is done with the first product's ring slots
  focal::gemm_tile<false, false, kBN>(p.g2, p.C, p.w2t, p.H, p.rows, p.H, m0, n0, 0, p.C, smem, acc,
                                      csum);
  focal::gemm_for_each_output<kBN>(acc, p.rows, p.H, m0, n0, [&](int row, int col, float dh0, float dh1) {
    float2* hz = reinterpret_cast<float2*>(p.h + (size_t)row * p.H + col);
    const float2 z = *hz;  // this thread's own write above
    float d0 = dh0 * gelu_grad(z.x), d1 = dh1 * gelu_grad(z.y);
    float h0 = gelu(z.x), h1 = gelu(z.y);
    if (kDropout) {
      bool k0, k1;
      kept_pair(p.keep, p.row0 + row, col, kSiteHidden, k0, k1);
      d0 = keep_or_zero(k0, d0, p.keep);
      d1 = keep_or_zero(k1, d1, p.keep);
      h0 = keep_or_zero(k0, h0, p.keep);
      h1 = keep_or_zero(k1, h1, p.keep);
    }
    *hz = make_float2(h0, h1);
    *reinterpret_cast<float2*>(p.dz + (size_t)row * p.H + col) = make_float2(d0, d1);
  });
}

// out = a b (+ bias) for a chunk of `rows` rows: a [rows, K], b [K, N]
// (N = C): y = h W2 + b2 (keep2 with kDropout) and dx = dz W1^T.
struct OutArgs {
  const float* a;
  const float* b;
  const float* bias;  // [N] or null
  float* out;         // [rows, N]
  int rows, K, N, row0;
  Keep keep;
};

template <int kBN, bool kDropout>
__global__ void __launch_bounds__(kThreads, kBN == 64 ? 2 : 1) mlp_out_kernel(const OutArgs p) {
  extern __shared__ float4 smem4[];
  const int tiles_n = (p.N + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / tiles_n) * focal::kGemmBM, n0 = (blockIdx.x % tiles_n) * kBN;
  float acc[4][focal::gemm_nt<kBN>()][4], csum = 0.f;
  focal::gemm_tile<false, false, kBN>(p.a, p.K, p.b, p.N, p.rows, p.N, m0, n0, 0, p.K,
                                      reinterpret_cast<float*>(smem4), acc, csum);
  focal::gemm_for_each_output<kBN>(acc, p.rows, p.N, m0, n0, [&](int row, int col, float v0, float v1) {
    if (p.bias) {
      v0 += __ldg(p.bias + col);
      v1 += __ldg(p.bias + col + 1);
    }
    if (kDropout) {
      bool k0, k1;
      kept_pair(p.keep, p.row0 + row, col, kSiteOut, k0, k1);
      v0 = keep_or_zero(k0, v0, p.keep);
      v1 = keep_or_zero(k1, v1, p.keep);
    }
    *reinterpret_cast<float2*>(p.out + (size_t)row * p.N + col) = make_float2(v0, v1);
  });
}

// g2 = g * keep2 / (1 - rate) for a chunk of `rows` rows of C columns.
__global__ void __launch_bounds__(kThreads) mlp_g2_kernel(const float* __restrict__ g,
                                                          float* __restrict__ g2, int rows, int C,
                                                          int row0, Keep k) {
  const int c4n = C / 4;
  const size_t total = (size_t)rows * c4n;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int r = (int)(e / c4n), c4 = (int)(e - (size_t)r * c4n);
    float4 v = __ldg(reinterpret_cast<const float4*>(g) + e);
    const uint4 b = keep_bits(k.seed, row0 + r, c4, kSiteOut);
    v.x = keep_or_zero(b.x >= k.threshold, v.x, k);
    v.y = keep_or_zero(b.y >= k.threshold, v.y, k);
    v.z = keep_or_zero(b.z >= k.threshold, v.z, k);
    v.w = keep_or_zero(b.w >= k.threshold, v.w, k);
    reinterpret_cast<float4*>(g2)[e] = v;
  }
}

// keep1 [T, H] and keep2 [T, C] as bytes, from the same bits the kernels
// draw: for the tests and the plain version on the card, never on the
// training path.
__global__ void mlp_masks_kernel(unsigned long long seed, unsigned threshold, int T, int C, int H,
                                 uint8_t* __restrict__ keep1, uint8_t* __restrict__ keep2) {
  const size_t h4 = (H + 3) / 4, c4 = C / 4;
  const size_t n1 = (size_t)T * h4, total = n1 + (size_t)T * c4;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const bool hidden = e < n1;
    const size_t f = hidden ? e : e - n1;
    const size_t per = hidden ? h4 : c4;
    const int row = (int)(f / per), col4 = (int)(f - (size_t)row * per);
    const int width = hidden ? H : C;
    const uint4 b = keep_bits(seed, row, col4, hidden ? kSiteHidden : kSiteOut);
    uint8_t* dst = hidden ? keep1 : keep2;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = col4 * 4 + u;
      if (col < width) dst[(size_t)row * width + col] = word(b, u) >= threshold ? 1 : 0;
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16 forms (#10-bf16, #11-bf16, #12-bf16), on the wgmma core

// erf by Abramowitz & Stegun 7.1.26, as the TPU kernel computes it
// (pk:484-494; conv_tower.cu's), and the GELU and GELU' built on it. The
// reciprocal and exp are the hardware's approximations (__fdividef,
// __expf: a few f32 ulps, far below the bf16 step h and dz are rounded
// to): the GELU runs once per hidden element beside 4C tensor-core FLOPs,
// and the exact forms cost as many instruction slots as the products.
// erf(x), and in e the exp(-x^2) it takes.
__device__ __forceinline__ float erf_as(float x, float& e) {
  const float ax = fabsf(x);
  const float t = __fdividef(1.f, 1.f + 0.3275911f * ax);
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) * t;
  e = __expf(-ax * ax);
  return copysignf(1.f - poly * e, x);
}

__device__ __forceinline__ float gelu_as(float z) {
  float e;
  return 0.5f * z * (1.f + erf_as(z * 0.7071067811865476f, e));
}

// GELU(z) and GELU'(z) together: erf's exp(-(z / sqrt 2)^2) is GELU''s
// exp(-z^2 / 2), so one reciprocal and one exp serve both.
__device__ __forceinline__ void gelu_and_grad_as(float z, float& g, float& dg) {
  float e;
  const float cdf = 0.5f * (1.f + erf_as(z * 0.7071067811865476f, e));
  g = z * cdf;
  dg = cdf + z * e * 0.3989422804014327f;
}

namespace wgk = focal::wg;
using bf16 = __nv_bfloat16;

constexpr int kHiddenChunk = 64;  // #10-bf16's hidden columns a step: one m64n64k16 z tile
constexpr int kFusedMaxC = 256;   // widest C whose y tile (64 x C f32 a warpgroup) stays in registers

// Two f32 weights of n4 float4 each rounded to bf16 (to nearest even, as the
// TPU kernel's astype) into w1b and w2b: one pass a call; every product then
// reads the bf16 copies through TMA.
__global__ void __launch_bounds__(kThreads) mlp_wcast_kernel(const float* __restrict__ w1,
                                                             const float* __restrict__ w2,
                                                             bf16* __restrict__ w1b,
                                                             bf16* __restrict__ w2b, size_t n4) {
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < 2 * n4;
       e += (size_t)gridDim.x * kThreads) {
    const bool second = e >= n4;
    const size_t f = second ? e - n4 : e;
    const float4 v = __ldg(reinterpret_cast<const float4*>(second ? w2 : w1) + f);
    reinterpret_cast<uint2*>(second ? w2b : w1b)[f] =
        make_uint2(wgk::pack_bf16(v.x, v.y), wgk::pack_bf16(v.z, v.w));
  }
}

// The keep flags of columns col and col + 1 (col % 8 == 2 (lane % 4)) in
// rows row and row + 8, bits 0-1 and 2-3: the layout of a wgmma
// accumulator's register pairs. The four lanes of a quad share an 8-column
// group, two Philox calls a row: each lane draws one (its columns' call in
// row + 8 (lane % 2)) and swaps the words its neighbour needs, so a flag
// costs half the draws of kept_pair and is the same bit.
__device__ __forceinline__ unsigned keep_quad(const Keep& k, int row, int col, int site) {
  const bool p = threadIdx.x & 1;
  const uint4 b = keep_bits(k.seed, row + 8 * p, col >> 2, site);
  const unsigned o0 = p ? b.z : b.x, o1 = p ? b.w : b.y;  // this row, this lane's columns
  const unsigned s0 = p ? b.x : b.z, s1 = p ? b.y : b.w;  // this row, the neighbour's
  const unsigned g0 = __shfl_xor_sync(0xffffffffu, s0, 1), g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  const unsigned own = (o0 >= k.threshold ? 1u : 0u) | (o1 >= k.threshold ? 2u : 0u);
  const unsigned got = (g0 >= k.threshold ? 1u : 0u) | (g1 >= k.threshold ? 2u : 0u);
  return p ? (got | own << 2) : (own | got << 2);
}

// #10-bf16 (and #11-bf16 with kDropout) where C <= kFusedMaxC: the whole MLP
// of a 128-row tile in one block, h never in device memory. The producer
// stages the x tile once (C/64 K-major boxes), then for each chunk of 64
// hidden columns W1[:, chunk] (MN-major, C rows) and W2[chunk, :] (kCy/64
// MN-major boxes) through a 4-stage ring. Each consumer warpgroup (64 rows):
//   z = x W1[:, chunk]         wgmma m64n64k16, A and B from shared memory;
//   h = GELU(z + b1) (keep1)   in f32 (the A-S erf), rounded to bf16 in the
//                              registers of the A fragment;
//   y += h W2[chunk, :]        wgmma m64n{kCy}k16, A from registers;
// y (kCy / 2 registers a thread) stays in registers across the chunks; then
// y + b2 (keep2) is stored as bf16. kCy: C rounded up to 64 (the columns past
// C are computed and dropped). A chunk's GELU runs while the last chunk's y
// step does: done after it, the tensor cores idled through every GELU
// (H100: ~2,300 of ~4,500 cycles a chunk at C 256).
template <int kCy>
struct FwdSmem {
  static constexpr int kStages = 4;
  static constexpr int kXBytes = kCy / 64 * wgk::kBM * 128;
  // a W1 chunk (<= kCy rows) and its 64 b1 values (in the last 1 KB), or a
  // W2 chunk (kCy / 64 boxes)
  static constexpr int kB1Offset = kCy * 128;
  static constexpr int kStageBytes = kCy * 128 + 1024;
  static constexpr int kBytes = kXBytes + kStages * kStageBytes + 1024 + 16 * kStages + 16;
};

struct FwdArgs {
  const float* b1;
  const float* b2;
  int T, C, H;
  Keep keep;
};

template <int kCy, bool kDropout, bool kSplit>
__global__ void __launch_bounds__(wgk::kThreads, 1)
mlp_wg_fwd_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw1,
                  const __grid_constant__ CUtensorMap mw2, const __grid_constant__ CUtensorMap my,
                  const FwdArgs p) {
  using S = FwdSmem<kCy>;
  constexpr int kRows = kSplit ? wgk::kBM / 2 : wgk::kBM;  // rows a block (and an x box)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = wgk::align1024(smem_raw);
  uint8_t* ring = xs + S::kXBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::kStages * S::kStageBytes);
  uint64_t* empty = full + S::kStages;
  uint64_t* x_full = empty + S::kStages;
  const int m0 = blockIdx.x * kRows;
  const int x_boxes = (p.C + 63) / 64, k_steps = (p.C + 15) / 16;
  const int chunks = (p.H + kHiddenChunk - 1) / kHiddenChunk;
  // kSplit: warpgroup 0 takes chunks [0, half), warpgroup 1 [half, chunks),
  // over the same 64 rows; the stages run chunk 0, chunk half, chunk 1, ...
  const int half = (chunks + 1) / 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      wgk::mbar_init(&full[s], 1);
      wgk::mbar_init(&empty[s], kSplit ? 1 : 2);
    }
    wgk::mbar_init(x_full, 1);
    wgk::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= wgk::kConsumers) {
    wgk::set_max_regs_dec<wgk::kProducerRegs>();
    if (threadIdx.x == wgk::kConsumers) {
      wgk::mbar_expect_tx(x_full, x_boxes * kRows * 128);
      for (int i = 0; i < x_boxes; ++i) wgk::tma_load(xs + i * kRows * 128, &mx, x_full, 64 * i, m0);
      const uint32_t w1_bytes = (uint32_t)k_steps * 16 * 128;  // the map's box: C rounded up to 16 rows
      int it = 0;
      for (int n = 0; n < chunks; ++n) {
        const int c = kSplit ? (n & 1 ? half + n / 2 : n / 2) : n;
        for (int part = 0; part < 2; ++part, ++it) {
          const int s = it % S::kStages;
          if (it >= S::kStages) wgk::mbar_wait(&empty[s], ((it / S::kStages) & 1) ^ 1);
          uint8_t* st = ring + s * S::kStageBytes;
          if (part == 0) {
            const uint32_t b1_bytes = 4 * min(kHiddenChunk, p.H - kHiddenChunk * c);
            wgk::mbar_expect_tx(&full[s], w1_bytes + b1_bytes);
            wgk::tma_load(st, &mw1, &full[s], kHiddenChunk * c, 0);
            wgk::bulk_load(st + S::kB1Offset, p.b1 + kHiddenChunk * c, b1_bytes, &full[s]);
          } else {
            wgk::mbar_expect_tx(&full[s], x_boxes * wgk::kBoxBytes);
            for (int i = 0; i < x_boxes; ++i)
              wgk::tma_load(st + i * wgk::kBoxBytes, &mw2, &full[s], 64 * i, kHiddenChunk * c);
          }
        }
      }
    }
  } else {
    wgk::set_max_regs_inc<wgk::kConsumerRegs>();
    const wgk::Frag f;
    const int wg = wgk::warpgroup();
    // the warpgroup's rows: its 64 of the block's 128, or the block's 64
    const uint8_t* xa = xs + (kSplit ? 0 : wg * (wgk::kBM / 2) * 128);
    const int row0 = m0 + (kSplit ? f.row0 - wg * (wgk::kBM / 2) : f.row0);  // of register 0
    const int c0 = kSplit ? wg * half : 0, c1 = kSplit && wg == 0 ? half : chunks;
    // stage of chunk c's W1 (part 0) or W2 (part 1)
    auto stage = [&](int c, int part) {
      return 2 * (kSplit ? (wg == 0 ? 2 * c : 2 * (c - half) + 1) : c) + part;
    };
    float y[kCy / 2], z[32];
    uint32_t ha[4][4], hb[4][4];  // the A fragments of h: two sets, used in turns
    wgk::mbar_wait(x_full, 0);
    // Chunk c's z is issued before chunk c - 1's y step, in a group of its
    // own: once z is done, its GELU runs while the y step does (as
    // FlashAttention-3 overlaps its softmax with P V), into the fragment set
    // that step does not read. The loop is unrolled by two chunks, so that
    // no register is copied, and every group in it is issued
    // unconditionally: otherwise ptxas serializes the wgmma pipeline.
    auto issue_z = [&](int c) {  // z = x W1[:, chunk c]
      const int it = stage(c, 0), s = it % S::kStages;
      wgk::mbar_wait(&full[s], (it / S::kStages) & 1);
      const uint8_t* st = ring + s * S::kStageBytes;
      for (int k = 0; k < k_steps; ++k)
        wgk::Mma<64>::ss<0, 1>(z, wgk::desc_k(xa + (k >> 2) * kRows * 128, k & 3),
                               wgk::desc_mn(st, k), k > 0 ? 1 : 0);
      wgk::mma_commit();
    };
    auto issue_y = [&](int c, uint32_t (&h)[4][4]) {  // y += h W2[chunk c, :]
      const int it = stage(c, 1), s = it % S::kStages;
      wgk::mbar_wait(&full[s], (it / S::kStages) & 1);
      const uint8_t* st = ring + s * S::kStageBytes;
#pragma unroll
      for (int k = 0; k < kHiddenChunk / 16; ++k)
        wgk::Mma<kCy>::template rs<1>(y, h[k], wgk::desc_mn(st, k), (c > c0 || k > 0) ? 1 : 0);
      wgk::mma_commit();
    };
    auto release = [&](int c, int part) {
      if ((threadIdx.x & 127) == 0) wgk::mbar_arrive(&empty[stage(c, part) % S::kStages]);
    };
    // keep1's bits of chunk c (4 a column group j, at bit 4 j), drawn one
    // group at a time (few registers live) while the products run: they
    // depend on the rows and columns alone
    auto keep_bits1 = [&](int c) {
      unsigned bits = 0;
      if (kDropout) {
#pragma unroll 1
        for (int j = 0; j < kHiddenChunk / 8; ++j)
          bits |= keep_quad(p.keep, row0, kHiddenChunk * c + 8 * j + f.col0, kSiteHidden) << (4 * j);
      }
      return bits;
    };
    // h = GELU(z + b1) (keep1) in f32, rounded to bf16 into the set h; b1
    // from chunk c's W1 stage (released after)
    auto gelu = [&](int c, unsigned kept, uint32_t (&h)[4][4]) {
      const float* b1s = reinterpret_cast<const float*>(
          ring + stage(c, 0) % S::kStages * S::kStageBytes + S::kB1Offset);
#pragma unroll
      for (int j = 0; j < kHiddenChunk / 8; ++j) {
        const int lcol = 8 * j + f.col0, col = kHiddenChunk * c + lcol;
        const float2 bb = col < p.H ? *reinterpret_cast<const float2*>(b1s + lcol)
                                    : make_float2(0.f, 0.f);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r;
          float v0 = gelu_as(z[i] + bb.x), v1 = gelu_as(z[i + 1] + bb.y);
          if (kDropout) {
            v0 = keep_or_zero(kept >> (4 * j + 2 * r) & 1, v0, p.keep);
            v1 = keep_or_zero(kept >> (4 * j + 2 * r + 1) & 1, v1, p.keep);
          }
          h[j >> 1][(j & 1) * 2 + r] = wgk::pack_bf16(v0, v1);
        }
      }
      wgk::hold(h);
      release(c, 0);
    };
    // chunk c: its z, and chunk c - 1's y step from hin; its h into hout
    auto step = [&](int c, uint32_t (&hin)[4][4], uint32_t (&hout)[4][4]) {
      wgk::mma_fence();
      issue_z(c);
      issue_y(c - 1, hin);
      const unsigned kept = keep_bits1(c);
      wgk::mma_wait<1>();  // z; the y step may still run
      wgk::hold(z);
      gelu(c, kept, hout);
      wgk::mma_wait<0>();
      wgk::hold(y);
      wgk::hold(hin);
      release(c - 1, 1);
    };
    auto last = [&](int c, uint32_t (&hin)[4][4]) {  // chunk c's y step alone
      wgk::mma_fence();
      issue_y(c, hin);
      wgk::mma_wait<0>();
      wgk::hold(y);
      wgk::hold(hin);
      release(c, 1);
    };
    if (c0 < c1) {
      wgk::mma_fence();
      issue_z(c0);
      const unsigned kept = keep_bits1(c0);
      wgk::mma_wait<0>();
      wgk::hold(z);
      gelu(c0, kept, ha);
      for (int c = c0 + 1;; c += 2) {
        if (c == c1) {
          last(c - 1, ha);
          break;
        }
        step(c, ha, hb);
        if (c + 1 == c1) {
          last(c, hb);
          break;
        }
        step(c + 1, hb, ha);
      }
    }
    // Every stage is consumed: the ring stages y (bf16) for its TMA store,
    // after warpgroup 1's partial y in split blocks.
    uint8_t* ystage = ring + (kSplit ? 256 * kCy : 0);
    if (kSplit) {
      // warpgroup 1's y added to warpgroup 0's (thread t of each holds the
      // same elements)
      float* other = reinterpret_cast<float*>(ring);
      wgk::consumers_sync();
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < kCy / 2; ++i)  // (no chunk of its own where H <= 64)
          other[i * 128 + (threadIdx.x & 127)] = c1 > c0 ? y[i] : 0.f;
      }
      wgk::consumers_sync();
      if (wg == 1) return;
#pragma unroll
      for (int i = 0; i < kCy / 2; ++i) y[i] += other[i * 128 + threadIdx.x];
    } else {
      wgk::consumers_sync();
    }
    // y + b2 (keep2), rounded to bf16
#pragma unroll
    for (int j = 0; j < kCy / 8; ++j) {
      const int col = 8 * j + f.col0;
      const float2 bo = col < p.C ? __ldg(reinterpret_cast<const float2*>(p.b2 + col))
                                  : make_float2(0.f, 0.f);
      const unsigned kept = kDropout ? keep_quad(p.keep, row0, col, kSiteOut) : 15u;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r;
        float v0 = y[i] + bo.x, v1 = y[i + 1] + bo.y;
        if (kDropout) {
          v0 = keep_or_zero(kept >> (2 * r) & 1, v0, p.keep);
          v1 = keep_or_zero(kept >> (2 * r + 1) & 1, v1, p.keep);
        }
        // rows past T and columns past C are staged too; the store leaves them out
        wgk::stage_pair(ystage, row0 + 8 * r - m0, col, wgk::pack_bf16(v0, v1), kRows);
      }
    }
    wgk::fence_async_smem();
    if (kSplit)
      wgk::warpgroup0_sync();
    else
      wgk::consumers_sync();
    if (threadIdx.x == 0) {
      for (int i = 0; i < x_boxes; ++i) wgk::tma_store(&my, ystage + i * kRows * 128, 64 * i, m0);
      wgk::tma_store_commit();
      wgk::tma_store_wait_read();
    }
  }
}

// out = act(a b + bias) (keep) as bf16 over a chunk of `rows` rows: a [rows,
// K] K-major, b [K, N] MN-major (kBT) or b^T [N, K] K-major. #10-bf16's
// two-launch form (C > kFusedMaxC): h = GELU(x W1 + b1) (keep1, kGelu) and
// y = h W2 + b2 (keep2); #12-bf16's dx = dz W1^T (no bias, b^T = W1).
struct OutArgs16 {
  const float* bias;  // [N] or null
  bf16* out;          // [rows, N]
  int rows, N, K, row0;
  Keep keep;
};

template <int kBN, bool kBT, bool kGelu, bool kDropout>
__device__ __forceinline__ void out_tiles(void* smem, const CUtensorMap* ma, const CUtensorMap* mb,
                                          const OutArgs16& p) {
  const int tiles_n = (p.N + kBN - 1) / kBN;
  const int tiles = (p.rows + wgk::kBM - 1) / wgk::kBM * tiles_n;
  const int k_tiles = (p.K + wgk::kBK - 1) / wgk::kBK;
  auto plan = [&](int tile) {
    return wgk::Job<1>{{ma}, {mb}, tile / tiles_n * wgk::kBM, p.rows, tile % tiles_n * kBN, p.N, 0,
                       k_tiles};
  };
  auto epi = [&](const wgk::Job<1>& j, float (&acc)[1][kBN / 2]) {
    const wgk::Frag f;
#pragma unroll
    for (int g = 0; g < kBN / 8; ++g) {
      const int col = j.n0 + 8 * g + f.col0;
      if (col >= p.N) continue;  // alike in every lane: N is a multiple of 8
      const unsigned kept = kDropout ? keep_quad(p.keep, p.row0 + j.m0 + f.row0, col,
                                                 kGelu ? kSiteHidden : kSiteOut)
                                     : 15u;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * g + 2 * r, row = j.m0 + f.row(i);
        if (row >= p.rows) continue;
        float v0 = acc[0][i], v1 = acc[0][i + 1];
        if (p.bias) {
          v0 += __ldg(p.bias + col);
          v1 += __ldg(p.bias + col + 1);
        }
        if (kGelu) {
          v0 = gelu_as(v0);
          v1 = gelu_as(v1);
        }
        if (kDropout) {
          v0 = keep_or_zero(kept >> (2 * r) & 1, v0, p.keep);
          v1 = keep_or_zero(kept >> (2 * r + 1) & 1, v1, p.keep);
        }
        *reinterpret_cast<uint32_t*>(p.out + (size_t)row * p.N + col) = wgk::pack_bf16(v0, v1);
      }
    }
  };
  wgk::streamed_tiles<kBN, false, kBT, wgk::kStreamStages<kBN>, 1>(smem, tiles, plan, epi);
}

template <int kBN, bool kDropout>
__global__ void __launch_bounds__(wgk::kThreads, 1)
mlp_wg_gelu_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                   const OutArgs16 p) {
  extern __shared__ uint8_t smem_raw[];
  out_tiles<kBN, true, true, kDropout>(smem_raw, &ma, &mb, p);
}

template <int kBN, bool kBT, bool kDropout>
__global__ void __launch_bounds__(wgk::kThreads, 1)
mlp_wg_out_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                  const OutArgs16 p) {
  extern __shared__ uint8_t smem_raw[];
  out_tiles<kBN, kBT, false, kDropout>(smem_raw, &ma, &mb, p);
}

// #12-bf16's g2 over a chunk: g2 = g keep2 / (1 - rate) in f32, stored as bf16
// with kDropout (without, the products read g itself), and the f32 column
// sums of each 128-row tile (db2's partials, tile `tile0 + blockIdx.x` of the
// call) in a fixed order: a thread sums rows slot, slot + slots, ... of its 8
// columns, then the slots are added in order.
struct G2Args {
  const bf16* g;      // [rows, C]
  bf16* g2;           // [rows, C] (kDropout)
  float* db2_part;    // [tiles of the call][C]
  int rows, C, row0, tile0;
  Keep keep;
};

template <bool kDropout>
__global__ void __launch_bounds__(kThreads) mlp_wg_g2_kernel(const G2Args p) {
  __shared__ float red[2048];
  const int groups = p.C / 8, slots = kThreads / groups;
  const int cg = threadIdx.x % groups, slot = threadIdx.x / groups;
  const int m0 = blockIdx.x * wgk::kBM;
  float s[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) s[u] = 0.f;
  if (slot < slots) {
    for (int r = slot; r < wgk::kBM && m0 + r < p.rows; r += slots) {
      const size_t off = (size_t)(m0 + r) * p.C + 8 * cg;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p.g + off));
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      float v[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[2 * u] = __uint_as_float(w[u] << 16);
        v[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
      }
      if (kDropout) {
        const int row = p.row0 + m0 + r;
        const uint4 b0 = keep_bits(p.keep.seed, row, 2 * cg, kSiteOut);
        const uint4 b1 = keep_bits(p.keep.seed, row, 2 * cg + 1, kSiteOut);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = keep_or_zero(word(u < 4 ? b0 : b1, u & 3) >= p.keep.threshold, v[u], p.keep);
        *reinterpret_cast<uint4*>(p.g2 + off) =
            make_uint4(wgk::pack_bf16(v[0], v[1]), wgk::pack_bf16(v[2], v[3]),
                       wgk::pack_bf16(v[4], v[5]), wgk::pack_bf16(v[6], v[7]));
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) s[u] += v[u];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) red[slot * p.C + 8 * cg + u] = s[u];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < p.C; col += kThreads) {
    float a = 0.f;
    for (int sl = 0; sl < slots; ++sl) a += red[sl * p.C + col];
    p.db2_part[(size_t)(p.tile0 + blockIdx.x) * p.C + col] = a;
  }
}

// #12-bf16's hidden products over a chunk: for each 128 x kBN tile of [rows,
// H], z = x W1 and dh = g2 W2^T (two passes of streamed_tiles over the same
// tile, both accumulators in registers), then in the epilogue, in f32:
// z += b1, h = GELU(z) keep1 / (1 - rate), dz = dh keep1 / (1 - rate)
// GELU'(z); h and dz stored as bf16 (the values the later products read),
// and the f32 column sums of dz over the tile's rows (db1's partials, tile
// tile0 + m0 / 128 of the call) in a fixed order: a thread's two rows, a
// butterfly over the warp's lanes (the same bits in every lane), the eight
// warps in order.
struct HiddenArgs16 {
  const float* b1;
  bf16* h;           // [rows, H]: h as used
  bf16* dz;          // [rows, H]
  float* db1_part;   // [tiles of the call][H]
  int rows, C, H, row0, tile0;
  Keep keep;
};

constexpr int kHiddenStages = 4;  // leaves room for the staged h and dz tiles

// The hidden kernel's shared memory from its 1,024-byte aligned start: the
// ring's tiles and a 1 KB page for its barriers, then h and dz staged for
// their TMA stores (kBM x kBN bf16 each), then the column sums [8][kBN].
template <int kBN>
struct HiddenSmem {
  static constexpr size_t kTile = (size_t)wgk::kBM * kBN * 2;
  static constexpr size_t kStaged =
      (size_t)kHiddenStages * wgk::Ring<kBN, false, true, kHiddenStages>::kStageBytes + 1024;
  static constexpr size_t kBytes = 1024 + kStaged + 2 * kTile + 8 * kBN * sizeof(float);
};

template <int kBN, bool kDropout>
__global__ void __launch_bounds__(wgk::kThreads, 1)
mlp_wg_hidden_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw1,
                     const __grid_constant__ CUtensorMap mg2,
                     const __grid_constant__ CUtensorMap mw2t,
                     const __grid_constant__ CUtensorMap mh_out,
                     const __grid_constant__ CUtensorMap mdz_out, const HiddenArgs16 p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* h_tile = wgk::align1024(smem_raw) + HiddenSmem<kBN>::kStaged;
  uint8_t* dz_tile = h_tile + HiddenSmem<kBN>::kTile;
  float* red = reinterpret_cast<float*>(dz_tile + HiddenSmem<kBN>::kTile);
  const int tiles_n = (p.H + kBN - 1) / kBN;
  const int tiles = (p.rows + wgk::kBM - 1) / wgk::kBM * tiles_n;
  const int k_tiles = (p.C + wgk::kBK - 1) / wgk::kBK;
  auto plan = [&](int tile) {
    return wgk::Job<2>{{&mx, &mg2}, {&mw1, &mw2t}, tile / tiles_n * wgk::kBM, p.rows,
                       tile % tiles_n * kBN, p.H, 0, k_tiles};
  };
  auto epi = [&](const wgk::Job<2>& j, float (&acc)[2][kBN / 2]) {
    const wgk::Frag f;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // the last tile's stores have read the staged tiles
    if (threadIdx.x == 0) wgk::tma_store_wait_read();
    wgk::consumers_sync();
    float cs[kBN / 4];  // the thread's column sums: two columns of each 8-column group
#pragma unroll
    for (int jj = 0; jj < kBN / 8; ++jj) {
      const int lcol = 8 * jj + f.col0, col = j.n0 + lcol;
      const float2 bb = col < p.H ? __ldg(reinterpret_cast<const float2*>(p.b1 + col))
                                  : make_float2(0.f, 0.f);
      cs[2 * jj] = cs[2 * jj + 1] = 0.f;
      const unsigned kept = kDropout ? keep_quad(p.keep, p.row0 + j.m0 + f.row0, col, kSiteHidden)
                                     : 15u;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * jj + 2 * r, lrow = f.row(i);
        const float z0 = acc[0][i] + bb.x, z1 = acc[0][i + 1] + bb.y;
        float h0, h1, gd0, gd1, dh0 = acc[1][i], dh1 = acc[1][i + 1];
        gelu_and_grad_as(z0, h0, gd0);
        gelu_and_grad_as(z1, h1, gd1);
        if (kDropout) {
          const bool k0 = kept >> (2 * r) & 1, k1 = kept >> (2 * r + 1) & 1;
          h0 = keep_or_zero(k0, h0, p.keep);
          h1 = keep_or_zero(k1, h1, p.keep);
          dh0 = keep_or_zero(k0, dh0, p.keep);
          dh1 = keep_or_zero(k1, dh1, p.keep);
        }
        const float d0 = dh0 * gd0, d1 = dh1 * gd1;
        // rows past the chunk (x = g2 = 0 there: dz = 0) and columns past H
        // are staged too; the TMA stores leave them out
        wgk::stage_pair(h_tile, lrow, lcol, wgk::pack_bf16(h0, h1));
        wgk::stage_pair(dz_tile, lrow, lcol, wgk::pack_bf16(d0, d1));
        cs[2 * jj] += d0;
        cs[2 * jj + 1] += d1;
      }
    }
    wgk::fence_async_smem();
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int u = 0; u < kBN / 4; ++u) cs[u] += __shfl_xor_sync(0xffffffffu, cs[u], off);
    if (lane < 4) {
#pragma unroll
      for (int jj = 0; jj < kBN / 8; ++jj) {
        red[warp * kBN + 8 * jj + 2 * lane] = cs[2 * jj];
        red[warp * kBN + 8 * jj + 2 * lane + 1] = cs[2 * jj + 1];
      }
    }
    wgk::consumers_sync();  // h, dz and the sums staged
    if (threadIdx.x == 0) {
#pragma unroll
      for (int b = 0; b < kBN / 64; ++b) {
        wgk::tma_store(&mh_out, h_tile + b * wgk::kBM * 128, j.n0 + 64 * b, j.m0);
        wgk::tma_store(&mdz_out, dz_tile + b * wgk::kBM * 128, j.n0 + 64 * b, j.m0);
      }
      wgk::tma_store_commit();
    }
    if ((int)threadIdx.x < kBN && j.n0 + (int)threadIdx.x < p.H) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < wgk::kConsumers / 32; ++w) a += red[w * kBN + threadIdx.x];
      p.db1_part[(size_t)(p.tile0 + j.m0 / wgk::kBM) * p.H + j.n0 + threadIdx.x] = a;
    }
    wgk::consumers_sync();  // the sums are read
  };
  wgk::streamed_tiles<kBN, false, true, kHiddenStages, 2>(smem_raw, tiles, plan, epi);
  if (threadIdx.x == 0) wgk::tma_store_wait_read();  // the last stores have left shared memory
}

// #12-bf16's weight gradients and its reduction run gemm_wgmma.cuh's
// wg_wgrad_kernel (dW1 = x^T dz, dW2 = h^T g2) and wg_reduce_kernel, which
// #3-bf16 and #5-bf16 share.

// ---------------------------------------------------------------------------
// host side

int check_dims(int T, int C, int H) {
  if (T < 1 || C < 4 || C % 4 != 0 || H < 4 || H % 4 != 0 ||
      (long long)T * std::max(C, H) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  return 0;
}

cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// The launch plan of a call: row chunks of equal size (a multiple of
// kGemmBM where there are several) with one [rows, H] array within
// kChunkFloats; the tile widths of the hidden products (N = H), the output
// products (N = C) and the weight gradients; the weight gradients' row
// splits of a chunk; the workspace, in floats: h [rows, H] and, for the
// backward, dz [rows, H], g2 [rows, C] and the split partials [splits, E]
// (E = C H | H | H C | C: dW1, db1, dW2, db2).
struct Plan {
  int rows, chunks, hbn, obn, wbn, splits, rows_per_split;
  size_t E, h, dz, g2, part, total;
};

Plan make_plan(int T, int C, int H, bool backward, int sms) {
  Plan P{};
  const long long cap = std::max<long long>(
      focal::kGemmBM, kChunkFloats / H / focal::kGemmBM * focal::kGemmBM);
  const int chunks = (int)((T + cap - 1) / cap);
  P.rows = (T + chunks - 1) / chunks;
  if (chunks > 1) P.rows = (P.rows + focal::kGemmBM - 1) / focal::kGemmBM * focal::kGemmBM;
  P.chunks = (T + P.rows - 1) / P.rows;
  // the hidden products in 64-wide tiles, two blocks an SM, in the backward
  // (two products a tile) and where K = C is short; 128-wide where the
  // forward's K is 256 (on the H100: #12 15-22 % faster, #10 at MOD_WIDE
  // 7 % slower at 64)
  P.hbn = backward || C < 256 ? 64 : focal::tile_bn(H, 0);
  P.obn = focal::tile_bn(C, 0);
  P.wbn = focal::tile_bn(H, C);
  int t1 = 0, t2 = 0, unused = 0;
  focal::set_tiles(C, H, P.wbn, &unused, &t1);
  focal::set_tiles(H, C, P.wbn, &unused, &t2);
  const focal::RowSplits rs = focal::split_rows(P.rows, t1 + t2, sms);
  P.splits = rs.splits;
  P.rows_per_split = rs.rows_per_split;
  P.E = 2 * (size_t)C * H + H + C;
  size_t o = 0;  // every size below is a multiple of 4 floats: each array 16-byte aligned
  P.h = o, o += (size_t)P.rows * H;
  if (backward) {
    P.dz = o, o += (size_t)P.rows * H;
    P.g2 = o, o += (size_t)P.rows * C;
    P.part = o, o += (size_t)P.splits * P.E;
  }
  P.total = o;
  return P;
}

template <class Kernel, class Args>
cudaError_t launch_gemm(Kernel kernel, int tiles, const Args& a, cudaStream_t s, int bn) {
  const size_t smem = focal::gemm_smem_bytes(bn);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<tiles, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The backward's hidden products run in 64-wide tiles only (make_plan).
template <bool kBackward, bool kDropout>
cudaError_t launch_hidden(const HiddenArgs& a, int bn, cudaStream_t s) {
  int tiles_n = 0, tiles = 0;
  focal::set_tiles(a.rows, a.H, bn, &tiles_n, &tiles);
  if constexpr (kBackward) {
    return launch_gemm(mlp_hidden_kernel<64, true, kDropout>, tiles, a, s, 64);
  } else {
    return bn == 128 ? launch_gemm(mlp_hidden_kernel<128, false, kDropout>, tiles, a, s, 128)
                     : launch_gemm(mlp_hidden_kernel<64, false, kDropout>, tiles, a, s, 64);
  }
}

template <bool kDropout>
cudaError_t launch_out(const OutArgs& a, int bn, cudaStream_t s) {
  int tiles_n = 0, tiles = 0;
  focal::set_tiles(a.rows, a.N, bn, &tiles_n, &tiles);
  return bn == 128 ? launch_gemm(mlp_out_kernel<128, kDropout>, tiles, a, s, 128)
                   : launch_gemm(mlp_out_kernel<64, kDropout>, tiles, a, s, 64);
}

int plan_for(int T, int C, int H, bool backward, Plan* P) {
  if (int e = check_dims(T, C, H)) return e;
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  *P = make_plan(T, C, H, backward, sms);
  return 0;
}

// The bf16 forms' launch plan. The forward is one launch (mlp_wg_fwd_kernel)
// where C <= kFusedMaxC, split (64-row blocks, each warpgroup half the hidden
// chunks) where the call has fewer 128-row tiles than the card has SMs;
// wider, row chunks of two launches (mlp_wg_gelu_kernel
// into h [rows, H] bf16, then mlp_wg_out_kernel). The backward runs row
// chunks of g2, hidden, dx and weight-gradient launches, then one
// reduction. Chunks are of equal size (a multiple of kBM where there are
// several), one [rows, H] bf16 array within 2 kChunkFloats values (128 MiB).
// Tile widths: the hidden products (N = H), the output products (N = C),
// the weight gradients (both), 128 or 64 columns (tile_bn). The weight
// gradients' row splits of a chunk are multiples of 64 rows. The workspace,
// in floats (each array 16-byte aligned): the bf16 weights W1 [C, H] and W2
// [H, C] (forward) or W2^T [C, H] (backward); h [rows, H] bf16 (two-launch
// forward, backward); dz [rows, H] and g2 [rows, C] bf16, the split partials
// [splits][2 C H] and the bias partials [tiles][H] and [tiles][C] of the
// call's 128-row tiles (backward).
struct Plan16 {
  bool fused, split;
  int rows, chunks, tiles, hbn, obn, wbn, splits, rows_per_split, sms;
  size_t w1b, w2b, h, dz, g2, wpart, b1part, b2part, total;
};

size_t bf16_floats(size_t n) { return (n + 7) / 8 * 4; }

Plan16 make_plan16(int T, int C, int H, bool backward, int sms) {
  Plan16 P{};
  P.sms = sms;
  P.fused = !backward && C <= kFusedMaxC;
  P.split = P.fused && (T + wgk::kBM - 1) / wgk::kBM < sms;
  P.rows = T;
  P.chunks = 1;
  if (!P.fused) {
    const long long cap =
        std::max<long long>(wgk::kBM, 2 * kChunkFloats / H / wgk::kBM * wgk::kBM);
    const int chunks = (int)((T + cap - 1) / cap);
    P.rows = (T + chunks - 1) / chunks;
    if (chunks > 1) P.rows = (P.rows + wgk::kBM - 1) / wgk::kBM * wgk::kBM;
    P.chunks = (T + P.rows - 1) / P.rows;
  }
  P.tiles = (T + wgk::kBM - 1) / wgk::kBM;
  P.hbn = focal::tile_bn(H, 0);
  P.obn = focal::tile_bn(C, 0);
  P.wbn = focal::tile_bn(H, C);
  // the weight gradients' row splits (gemm_wgmma.cuh's wgrad_splits)
  const int wtiles = wgk::wgrad_tiles(C, H, P.wbn) + wgk::wgrad_tiles(H, C, P.wbn);
  const wgk::WgradSplits ws = wgk::wgrad_splits(P.rows, wtiles, sms);
  P.splits = ws.splits;
  P.rows_per_split = ws.rows_per_split;
  size_t o = 0;
  P.w1b = o, o += bf16_floats((size_t)C * H);
  P.w2b = o, o += bf16_floats((size_t)C * H);
  if (!P.fused) P.h = o, o += bf16_floats((size_t)P.rows * H);
  if (backward) {
    P.dz = o, o += bf16_floats((size_t)P.rows * H);
    P.g2 = o, o += bf16_floats((size_t)P.rows * C);
    P.wpart = o, o += (size_t)P.splits * 2 * C * H;
    P.b1part = o, o += (size_t)P.tiles * H;
    P.b2part = o, o += (size_t)P.tiles * C;
  }
  P.total = o;
  return P;
}

int plan16_for(int T, int C, int H, bool backward, Plan16* P) {
  if (C % 8 != 0 || H % 8 != 0) return (int)cudaErrorInvalidValue;
  if (int e = check_dims(T, C, H)) return e;
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  *P = make_plan16(T, C, H, backward, sms);
  return 0;
}

int launch_wcast(const void* w1, const void* w2, bf16* w1b, bf16* w2b, int C, int H, int sms,
                 cudaStream_t s) {
  const size_t n4 = (size_t)C * H / 4;
  const int grid = (int)std::min<size_t>((2 * n4 + kThreads - 1) / kThreads, (size_t)sms * 8);
  mlp_wcast_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(w1),
                                             static_cast<const float*>(w2), w1b, w2b, n4);
  return (int)cudaGetLastError();
}

// The fused forward over 128-row blocks, or (split) over 64-row blocks with
// the hidden chunks halved between the warpgroups: twice the blocks where a
// call has fewer 128-row tiles than the card has SMs.
template <int kCy>
int launch_fused(const CUtensorMap (&m)[4], const FwdArgs& a, bool dropout, bool split,
                 cudaStream_t s) {
  const int rows = split ? wgk::kBM / 2 : wgk::kBM;
  const int grid = (a.T + rows - 1) / rows;
  const size_t smem = FwdSmem<kCy>::kBytes;
  if (split)
    return dropout ? wgk::launch(mlp_wg_fwd_kernel<kCy, true, true>, grid, smem, s, m[0], m[1], m[2],
                               m[3], a)
                   : wgk::launch(mlp_wg_fwd_kernel<kCy, false, true>, grid, smem, s, m[0], m[1], m[2],
                               m[3], a);
  return dropout ? wgk::launch(mlp_wg_fwd_kernel<kCy, true, false>, grid, smem, s, m[0], m[1], m[2],
                             m[3], a)
                 : wgk::launch(mlp_wg_fwd_kernel<kCy, false, false>, grid, smem, s, m[0], m[1], m[2],
                             m[3], a);
}

// One launch of out_tiles (kGelu: mlp_wg_gelu_kernel, else mlp_wg_out_kernel)
// over a chunk, in bn-wide tiles, persistent over min(tiles, SMs) blocks.
template <bool kGelu, bool kBT>
int launch_out16(const CUtensorMap& ma, const CUtensorMap& mb, const OutArgs16& a, int bn,
                 bool dropout, int sms, cudaStream_t s) {
  const int tiles = (a.rows + wgk::kBM - 1) / wgk::kBM * ((a.N + bn - 1) / bn);
  const int grid = std::min(tiles, sms);
  if (bn == 128) {
    const size_t smem = wgk::stream_smem<128, false, kBT>();
    if (kGelu)
      return dropout ? wgk::launch(mlp_wg_gelu_kernel<128, true>, grid, smem, s, ma, mb, a)
                     : wgk::launch(mlp_wg_gelu_kernel<128, false>, grid, smem, s, ma, mb, a);
    return dropout ? wgk::launch(mlp_wg_out_kernel<128, kBT, true>, grid, smem, s, ma, mb, a)
                   : wgk::launch(mlp_wg_out_kernel<128, kBT, false>, grid, smem, s, ma, mb, a);
  }
  const size_t smem = wgk::stream_smem<64, false, kBT>();
  if (kGelu)
    return dropout ? wgk::launch(mlp_wg_gelu_kernel<64, true>, grid, smem, s, ma, mb, a)
                   : wgk::launch(mlp_wg_gelu_kernel<64, false>, grid, smem, s, ma, mb, a);
  return dropout ? wgk::launch(mlp_wg_out_kernel<64, kBT, true>, grid, smem, s, ma, mb, a)
                 : wgk::launch(mlp_wg_out_kernel<64, kBT, false>, grid, smem, s, ma, mb, a);
}

template <int kBN>
int launch_hidden16(const CUtensorMap (&m)[6], const HiddenArgs16& a, bool dropout, int sms,
                    cudaStream_t s) {
  const int tiles = (a.rows + wgk::kBM - 1) / wgk::kBM * ((a.H + kBN - 1) / kBN);
  const int grid = std::min(tiles, sms);
  const size_t smem = HiddenSmem<kBN>::kBytes;
  return dropout ? wgk::launch(mlp_wg_hidden_kernel<kBN, true>, grid, smem, s, m[0], m[1], m[2], m[3],
                             m[4], m[5], a)
                 : wgk::launch(mlp_wg_hidden_kernel<kBN, false>, grid, smem, s, m[0], m[1], m[2], m[3],
                             m[4], m[5], a);
}

}  // namespace

// Workspace of focal_mlp_fwd (backward 0) or focal_mlp_bwd (backward 1),
// in floats, and the row chunks a call takes, for this geometry on the
// current device.
extern "C" int focal_mlp_workspace(int T, int C, int H, int backward, long long* floats,
                                   int* chunks) {
  Plan P;
  if (int e = plan_for(T, C, H, backward != 0, &P)) return e;
  *floats = (long long)P.total;
  *chunks = P.chunks;
  return 0;
}

// The same for focal_mlp_fwd_bf16 and focal_mlp_bwd_bf16: an error where C
// or H is not a multiple of 8, which their bf16 rows need.
extern "C" int focal_mlp_workspace_bf16(int T, int C, int H, int backward, long long* floats,
                                        int* chunks) {
  Plan16 P;
  if (int e = plan16_for(T, C, H, backward != 0, &P)) return e;
  *floats = (long long)P.total;
  *chunks = P.chunks;
  return 0;
}

// #10 (dropout 0) or #11 (dropout 1): y [T, C] from x [T, C], w1 [C, H],
// b1 [H], w2 [H, C], b2 [C]; with dropout both keep masks of `seed` at
// `threshold`, survivors scaled by inv_keep. x, w1, w2, y and ws 16-byte
// aligned; ws holds focal_mlp_workspace(.., 0) floats. Two launches a row
// chunk on `stream`: h = GELU(x W1 + b1), y = h W2 + b2.
extern "C" int focal_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* y, void* ws, int T, int C, int H, int dropout,
                             unsigned long long seed, unsigned threshold, float inv_keep,
                             void* stream) {
  Plan P;
  if (int e = plan_for(T, C, H, false, &P)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Keep keep{seed, threshold, inv_keep};
  float* h = static_cast<float*>(ws) + P.h;
  for (int c = 0; c < P.chunks; ++c) {
    const int r0 = c * P.rows, rows = std::min(P.rows, T - r0);
    const HiddenArgs ha{static_cast<const float*>(x) + (size_t)r0 * C, static_cast<const float*>(w1),
                        static_cast<const float*>(b1), nullptr, nullptr, h, nullptr, rows, C, H, r0,
                        keep};
    cudaError_t err = dropout ? launch_hidden<false, true>(ha, P.hbn, s)
                              : launch_hidden<false, false>(ha, P.hbn, s);
    if (err != cudaSuccess) return (int)err;
    const OutArgs oa{h, static_cast<const float*>(w2), static_cast<const float*>(b2),
                     static_cast<float*>(y) + (size_t)r0 * C, rows, H, C, r0, keep};
    err = dropout ? launch_out<true>(oa, P.obn, s) : launch_out<false>(oa, P.obn, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// #12: dx [T, C] and dweights = [dW1 (C x H) | db1 (H) | dW2 (H x C) |
// db2 (C)] for the gradient g [T, C] of y, from x, w1 [C, H], b1, w1t
// [H, C] (W1 transposed) and w2t [C, H] (W2 transposed); with dropout the
// forward's masks are drawn again from `seed`. x, w1, w1t, w2t, g, dx and
// ws 16-byte aligned; ws holds focal_mlp_workspace(.., 1) floats. A row
// chunk launches on `stream`: g2 (with dropout), z and dh (one launch), dx,
// the weight-gradient partials; then one ordered sum of the partials.
extern "C" int focal_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w1t,
                             const void* w2t, const void* g, void* dx, void* dweights, void* ws,
                             int T, int C, int H, int dropout, unsigned long long seed,
                             unsigned threshold, float inv_keep, void* stream) {
  Plan P;
  if (int e = plan_for(T, C, H, true, &P)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Keep keep{seed, threshold, inv_keep};
  float* w = static_cast<float*>(ws);
  float *h = w + P.h, *dz = w + P.dz, *part = w + P.part;
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  const size_t ch = (size_t)C * H;
  cudaError_t err = cudaSuccess;
  for (int c = 0; c < P.chunks; ++c) {
    const int r0 = c * P.rows, rows = std::min(P.rows, T - r0);
    const float* xc = xf + (size_t)r0 * C;
    const float* g2 = gf + (size_t)r0 * C;
    if (dropout) {
      const size_t n4 = (size_t)rows * (C / 4);
      const int grid = (int)std::min<size_t>((n4 + kThreads - 1) / kThreads, 1u << 16);
      mlp_g2_kernel<<<grid, kThreads, 0, s>>>(g2, w + P.g2, rows, C, r0, keep);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      g2 = w + P.g2;
    }
    // 1. z = x W1 + b1 and dh = g2 W2^T; dz and the h the forward used
    const HiddenArgs ha{xc, static_cast<const float*>(w1), static_cast<const float*>(b1), g2,
                        static_cast<const float*>(w2t), h, dz, rows, C, H, r0, keep};
    err = dropout ? launch_hidden<true, true>(ha, P.hbn, s) : launch_hidden<true, false>(ha, P.hbn, s);
    if (err != cudaSuccess) return (int)err;
    // 2. dx = dz W1^T
    const OutArgs oa{dz, static_cast<const float*>(w1t), nullptr,
                     static_cast<float*>(dx) + (size_t)r0 * C, rows, H, C, r0, keep};
    if ((err = launch_out<false>(oa, P.obn, s)) != cudaSuccess) return (int)err;
    // 3. dW1 = x^T dz with db1, dW2 = h^T g2 with db2, per split, added to
    //    the earlier chunks' partials
    const focal::WgradGemm w1g = focal::wgrad_gemm(xc, dz, C, H, 0, ch, P.wbn);
    const focal::WgradGemm w2g = focal::wgrad_gemm(h, g2, H, C, ch + H, 2 * ch + H, P.wbn);
    const int splits = (rows + P.rows_per_split - 1) / P.rows_per_split;
    err = focal::launch_wgrad<Src>(P.wbn, w1g, w2g, rows, P.rows_per_split, splits, part, P.E,
                                   c > 0, s);
    if (err != cudaSuccess) return (int)err;
  }
  // 4. the partials summed in split order
  return (int)focal::launch_reduce<Src>(part, P.splits, P.E, static_cast<float*>(dweights), s);
}

// #10-bf16 (dropout 0) or #11-bf16 (dropout 1): focal_mlp_fwd with a bf16 x
// and y (w1, b1, w2, b2 f32), C and H multiples of 8; ws holds
// focal_mlp_workspace_bf16(.., 0) floats. On `stream`: the weights rounded
// to bf16 into ws, then one launch (C <= 256: h kept on chip) or two a row
// chunk (h = GELU(x W1 + b1) into ws as bf16, y = h W2 + b2).
extern "C" int focal_mlp_fwd_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* y, void* ws, int T, int C, int H,
                                  int dropout, unsigned long long seed, unsigned threshold,
                                  float inv_keep, void* stream) {
  Plan16 P;
  if (int e = plan16_for(T, C, H, false, &P)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Keep keep{seed, threshold, inv_keep};
  float* w = static_cast<float*>(ws);
  bf16 *w1b = reinterpret_cast<bf16*>(w + P.w1b), *w2b = reinterpret_cast<bf16*>(w + P.w2b);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  const float *b1f = static_cast<const float*>(b1), *b2f = static_cast<const float*>(b2);
  if (int e = launch_wcast(w1, w2, w1b, w2b, C, H, P.sms, s)) return e;
  CUtensorMap ma, mb;
  if (P.fused) {
    // x, W1 [C, H] (MN-major B, C rows a box), W2 [H, C] (MN-major B), y
    CUtensorMap m[4];
    const int rows = P.split ? wgk::kBM / 2 : wgk::kBM;
    if (int e = wgk::map(&m[0], xb, T, C, rows)) return e;
    if (int e = wgk::map(&m[1], w1b, C, H, (C + 15) / 16 * 16)) return e;
    if (int e = wgk::map(&m[2], w2b, H, C, 64)) return e;
    if (int e = wgk::map(&m[3], yb, T, C, rows)) return e;
    const FwdArgs a{b1f, b2f, T, C, H, keep};
    if (C <= 64) return launch_fused<64>(m, a, dropout, P.split, s);
    if (C <= 128) return launch_fused<128>(m, a, dropout, P.split, s);
    if (C <= 192) return launch_fused<192>(m, a, dropout, P.split, s);
    return launch_fused<256>(m, a, dropout, P.split, s);
  }
  bf16* h = reinterpret_cast<bf16*>(w + P.h);
  for (int c = 0; c < P.chunks; ++c) {
    const int r0 = c * P.rows, rows = std::min(P.rows, T - r0);
    // h = GELU(x W1 + b1) (keep1): A = x K-major, B = W1 [C, H] MN-major
    if (int e = wgk::map(&ma, xb + (size_t)r0 * C, rows, C, wgk::kBM)) return e;
    if (int e = wgk::map(&mb, w1b, C, H, 64)) return e;
    const OutArgs16 ha{b1f, h, rows, H, C, r0, keep};
    if (int e = launch_out16<true, true>(ma, mb, ha, P.hbn, dropout, P.sms, s)) return e;
    // y = h W2 + b2 (keep2): A = h K-major, B = W2 [H, C] MN-major
    if (int e = wgk::map(&ma, h, rows, H, wgk::kBM)) return e;
    if (int e = wgk::map(&mb, w2b, H, C, 64)) return e;
    const OutArgs16 oa{b2f, yb + (size_t)r0 * C, rows, C, H, r0, keep};
    if (int e = launch_out16<false, true>(ma, mb, oa, P.obn, dropout, P.sms, s)) return e;
  }
  return 0;
}

// #12-bf16: dx [T, C] bf16 and dweights f32 as focal_mlp_bwd's for the bf16
// gradient g [T, C] of y, from a bf16 x and the f32 w1 [C, H], b1 and w2t
// [C, H] (W2 transposed), C and H multiples of 8; with dropout the masks
// drawn again from `seed`. ws holds focal_mlp_workspace_bf16(.., 1) floats.
// On `stream`: the weights rounded to bf16 into ws; a row chunk's g2 (and
// db2's tile partials), hidden (h, dz, db1's tile partials), dx and
// weight-gradient launches; then one ordered reduction.
extern "C" int focal_mlp_bwd_bf16(const void* x, const void* w1, const void* b1, const void* w2t,
                                  const void* g, void* dx, void* dweights, void* ws, int T, int C,
                                  int H, int dropout, unsigned long long seed, unsigned threshold,
                                  float inv_keep, void* stream) {
  Plan16 P;
  if (int e = plan16_for(T, C, H, true, &P)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Keep keep{seed, threshold, inv_keep};
  float* w = static_cast<float*>(ws);
  bf16 *w1b = reinterpret_cast<bf16*>(w + P.w1b), *w2tb = reinterpret_cast<bf16*>(w + P.w2b);
  bf16 *h = reinterpret_cast<bf16*>(w + P.h), *dz = reinterpret_cast<bf16*>(w + P.dz);
  bf16* g2w = reinterpret_cast<bf16*>(w + P.g2);
  const bf16 *xb = static_cast<const bf16*>(x), *gb = static_cast<const bf16*>(g);
  bf16* dxb = static_cast<bf16*>(dx);
  if (int e = launch_wcast(w1, w2t, w1b, w2tb, C, H, P.sms, s)) return e;
  // the weights as B: W1 and W2^T [C, H] MN-major (z, dh), W1 K-major (dx)
  CUtensorMap mw1, mw2t, mw1k;
  if (int e = wgk::map(&mw1, w1b, C, H, 64)) return e;
  if (int e = wgk::map(&mw2t, w2tb, C, H, 64)) return e;
  if (int e = wgk::map(&mw1k, w1b, C, H, P.obn)) return e;
  for (int c = 0; c < P.chunks; ++c) {
    const int r0 = c * P.rows, rows = std::min(P.rows, T - r0), tile0 = r0 / wgk::kBM;
    const bf16* xc = xb + (size_t)r0 * C;
    const bf16* gc = gb + (size_t)r0 * C;
    // 1. g2 = g keep2 / (1 - rate) (with dropout) and db2's partials
    const G2Args ga{gc, g2w, w + P.b2part, rows, C, r0, tile0, keep};
    const int g2_grid = (rows + wgk::kBM - 1) / wgk::kBM;
    if (dropout)
      mlp_wg_g2_kernel<true><<<g2_grid, kThreads, 0, s>>>(ga);
    else
      mlp_wg_g2_kernel<false><<<g2_grid, kThreads, 0, s>>>(ga);
    if (int e = (int)cudaGetLastError()) return e;
    const bf16* g2 = dropout ? g2w : gc;
    // 2. z = x W1 + b1 and dh = g2 W2^T; h, dz and db1's partials
    CUtensorMap mh[6] = {};
    if (int e = wgk::map(&mh[0], xc, rows, C, wgk::kBM)) return e;
    mh[1] = mw1;
    if (int e = wgk::map(&mh[2], g2, rows, C, wgk::kBM)) return e;
    mh[3] = mw2t;
    if (int e = wgk::map(&mh[4], h, rows, H, wgk::kBM)) return e;   // the stores of h and dz
    if (int e = wgk::map(&mh[5], dz, rows, H, wgk::kBM)) return e;
    const HiddenArgs16 ha{static_cast<const float*>(b1), h, dz, w + P.b1part, rows, C, H, r0, tile0,
                          keep};
    if (int e = P.hbn == 128 ? launch_hidden16<128>(mh, ha, dropout, P.sms, s)
                             : launch_hidden16<64>(mh, ha, dropout, P.sms, s))
      return e;
    // 3. dx = dz W1^T: A = dz K-major, B^T = W1 [C, H] K-major
    const OutArgs16 oa{nullptr, dxb + (size_t)r0 * C, rows, C, H, r0, keep};
    if (int e = launch_out16<false, false>(mh[5], mw1k, oa, P.obn, false, P.sms, s)) return e;
    // 4. dW1 = x^T dz and dW2 = h^T g2 over the chunk's row splits, all
    //    four operands MN-major as they lie
    CUtensorMap mwg[4] = {};
    if (int e = wgk::map(&mwg[0], xc, rows, C, 64)) return e;
    if (int e = wgk::map(&mwg[1], dz, rows, H, 64)) return e;
    if (int e = wgk::map(&mwg[2], h, rows, H, 64)) return e;
    if (int e = wgk::map(&mwg[3], g2, rows, C, 64)) return e;
    const int splits = (rows + P.rows_per_split - 1) / P.rows_per_split;
    const wgk::WgradArgs wa{w + P.wpart, rows, C, H, H, C, P.rows_per_split, splits, c > 0};
    if (int e = wgk::launch_wgrad<Src>(mwg, wa, P.wbn, P.sms, s)) return e;
  }
  // 5. dweights from the partials, in fixed order
  const wgk::ReduceArgs ra{w + P.wpart, w + P.b1part, w + P.b2part, nullptr,
                           static_cast<float*>(dweights), nullptr, P.splits, P.tiles, C, H, H,
                           C, 0};
  return wgk::launch_reduce<Src>(ra, s);
}

// The keep masks of `seed` as uint8: keep1 [T, H], keep2 [T, C].
extern "C" int focal_mlp_masks(unsigned long long seed, unsigned threshold, int T, int C, int H,
                               void* keep1, void* keep2, void* stream) {
  if (int e = check_dims(T, C, H)) return e;
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  mlp_masks_kernel<<<sms * 8, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, threshold, T, C, H, static_cast<uint8_t*>(keep1), static_cast<uint8_t*>(keep2));
  return (int)cudaGetLastError();
}

extern "C" const char* focal_cuda_error_string(int err) {
  if (err >= wgk::kMapError) return "cuTensorMapEncodeTiled refused a tensor map (CUresult: the code less 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
