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
// Not yet: keeping h on chip (fc2 accumulated over hidden chunks in
// registers), wgmma and TMA.
//
// The bf16 forms (-compute_dtype bfloat16): #10-bf16 (forward), #11-bf16
// (forward with dropout) and #12-bf16 (backward) replace the same TPU
// kernels fed a bf16 x (pk:516-609, called with the f32 weights uncast by
// focal_tpu/models/swin.py:431-446). They run #10-#12's launch plan with
// every product on the bf16 tensor cores (gemm_bf16.cuh: one mma.sync pass
// of m16n8k16, 989 TFLOP/s dense on the H100) and round where the TPU
// kernel rounds:
//   * the f32 weights are read as they lie and rounded to bf16 as they are
//     staged (w1_ref[...].astype(x.dtype)): no cast kernels;
//   * z = x W1 + b1 and the GELU in f32, with the TPU kernel's erf (the A-S
//     polynomial, pk:484-503: ROADMAP C6), h (with keep1) stored as bf16,
//     y = h W2 + b2 (keep2 in f32) stored as bf16;
//   * backward: g2 = g keep2 / (1 - rate) in f32 (g itself without
//     dropout), rounded to bf16 as dh = g2 W2^T and dW2 stage it; dz = dh
//     keep1 / (1 - rate) GELU'(z) in f32, rounded to bf16 as dx = dz W1^T
//     and dW1 = x^T dz stage it, while db1 sums the f32 dz (pk:564) and db2
//     the f32 g2; dW2 = bf16(h as used)^T g2; dx stored as bf16, the weight
//     and bias gradients f32.
// The masks are #11's Philox draws (keep_bits): the same seed gives #11's
// masks. The split-K weight gradients are gemm_splitk.cuh's bf16 form,
// which #3-bf16/#5-bf16 use too.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "gemm_3xtf32.cuh"
#include "gemm_bf16.cuh"
#include "gemm_splitk.cuh"
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
// the bf16 forms (#10-bf16, #11-bf16, #12-bf16)

// erf by Abramowitz & Stegun 7.1.26, as the TPU kernel computes it
// (pk:484-494; conv_tower.cu's), and the GELU and GELU' built on it.
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * ax);
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) * t;
  return copysignf(1.f - poly * expf(-ax * ax), x);
}

__device__ __forceinline__ float gelu_as(float z) {
  return 0.5f * z * (1.f + erf_as(z * 0.7071067811865476f));
}

__device__ __forceinline__ float gelu_grad_as(float z) {
  const float cdf = 0.5f * (1.f + erf_as(z * 0.7071067811865476f));
  return cdf + z * expf(-0.5f * z * z) * 0.3989422804014327f;
}

// The hidden products of a chunk in bf16. Forward: h = GELU(x W1 + b1)
// (keep1) stored as bf16. Backward: z = x W1 + b1 into dz (f32), then dh =
// g2 W2^T over the same tile; its epilogue reads z back (its own thread's
// writes), writes dz = dh keep1 / (1 - rate) GELU'(z) over it in f32 and the
// h the forward used (keep1) as bf16.
struct BfHiddenArgs {
  focal::BfOperand x;    // [rows, C] bf16
  focal::BfOperand w1;   // [C, H] f32, rounded as staged
  const float* b1;       // [H]
  focal::BfOperand g2;   // [rows, C] (backward): g (bf16) or g2 (f32)
  focal::BfOperand w2t;  // [C, H] f32 (backward): W2 transposed
  __nv_bfloat16* h;      // [rows, H]: h (backward: h as used)
  float* dz;             // [rows, H] (backward): z, then dz
  int rows, C, H, row0;
  Keep keep;
};

template <int kBN, bool kBackward, bool kDropout>
__global__ void __launch_bounds__(kThreads, kBN == 64 ? 2 : 1)
mlp_bf16_hidden_kernel(const BfHiddenArgs p) {
  __shared__ __align__(16) uint32_t smem[focal::bf_smem_words(kBN)];
  const int tiles_n = (p.H + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / tiles_n) * focal::kGemmBM, n0 = (blockIdx.x % tiles_n) * kBN;
  float acc[4][focal::gemm_nt<kBN>()][4], sums[2][8];
  focal::bf_gemm_tile<false, false, kBN>(p.x, p.w1, p.rows, p.H, m0, n0, 0, p.C, smem, acc, sums,
                                         false);
  focal::gemm_for_each_output<kBN>(acc, p.rows, p.H, m0, n0, [&](int row, int col, float v0, float v1) {
    v0 += __ldg(p.b1 + col);
    v1 += __ldg(p.b1 + col + 1);
    const size_t at = (size_t)row * p.H + col;
    if (kBackward) {
      *reinterpret_cast<float2*>(p.dz + at) = make_float2(v0, v1);
      return;
    }
    v0 = gelu_as(v0);
    v1 = gelu_as(v1);
    if (kDropout) {
      bool k0, k1;
      kept_pair(p.keep, p.row0 + row, col, kSiteHidden, k0, k1);
      v0 = keep_or_zero(k0, v0, p.keep);
      v1 = keep_or_zero(k1, v1, p.keep);
    }
    *reinterpret_cast<uint32_t*>(p.h + at) = focal::pack_bf16x2(v0, v1);
  });
  if (!kBackward) return;
  __syncthreads();  // every warp is done with the first product's stages
  focal::bf_gemm_tile<false, false, kBN>(p.g2, p.w2t, p.rows, p.H, m0, n0, 0, p.C, smem, acc, sums,
                                         false);
  focal::gemm_for_each_output<kBN>(acc, p.rows, p.H, m0, n0, [&](int row, int col, float dh0, float dh1) {
    const size_t at = (size_t)row * p.H + col;
    float2* zd = reinterpret_cast<float2*>(p.dz + at);
    const float2 z = *zd;  // this thread's own write above
    float h0 = gelu_as(z.x), h1 = gelu_as(z.y);
    if (kDropout) {
      bool k0, k1;
      kept_pair(p.keep, p.row0 + row, col, kSiteHidden, k0, k1);
      dh0 = keep_or_zero(k0, dh0, p.keep);
      dh1 = keep_or_zero(k1, dh1, p.keep);
      h0 = keep_or_zero(k0, h0, p.keep);
      h1 = keep_or_zero(k1, h1, p.keep);
    }
    *zd = make_float2(dh0 * gelu_grad_as(z.x), dh1 * gelu_grad_as(z.y));
    *reinterpret_cast<uint32_t*>(p.h + at) = focal::pack_bf16x2(h0, h1);
  });
}

// out = a b (+ bias) for a chunk in bf16, stored as bf16: y = h W2 + b2
// (keep2 with kDropout) and dx = dz W1^T.
struct BfOutArgs {
  focal::BfOperand a;  // [rows, K]
  focal::BfOperand b;  // [K, N] f32, rounded as staged
  const float* bias;   // [N] or null
  __nv_bfloat16* out;  // [rows, N]
  int rows, K, N, row0;
  Keep keep;
};

template <int kBN, bool kDropout>
__global__ void __launch_bounds__(kThreads, kBN == 64 ? 2 : 1) mlp_bf16_out_kernel(const BfOutArgs p) {
  __shared__ __align__(16) uint32_t smem[focal::bf_smem_words(kBN)];
  const int tiles_n = (p.N + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / tiles_n) * focal::kGemmBM, n0 = (blockIdx.x % tiles_n) * kBN;
  float acc[4][focal::gemm_nt<kBN>()][4], sums[2][8];
  focal::bf_gemm_tile<false, false, kBN>(p.a, p.b, p.rows, p.N, m0, n0, 0, p.K, smem, acc, sums,
                                         false);
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
    *reinterpret_cast<uint32_t*>(p.out + (size_t)row * p.N + col) = focal::pack_bf16x2(v0, v1);
  });
}

// g2 = g * keep2 / (1 - rate) in f32 from a bf16 g, for a chunk of `rows`
// rows of C columns (a multiple of 8).
__global__ void __launch_bounds__(kThreads) mlp_bf16_g2_kernel(const __nv_bfloat16* __restrict__ g,
                                                               float* __restrict__ g2, int rows,
                                                               int C, int row0, Keep k) {
  const int c4n = C / 4;
  const size_t total = (size_t)rows * c4n;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int r = (int)(e / c4n), c4 = (int)(e - (size_t)r * c4n);
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(g) + e);
    const uint4 b = keep_bits(k.seed, row0 + r, c4, kSiteOut);
    float4 v;
    v.x = keep_or_zero(b.x >= k.threshold, __uint_as_float(raw.x << 16), k);
    v.y = keep_or_zero(b.y >= k.threshold, __uint_as_float(raw.x & 0xffff0000u), k);
    v.z = keep_or_zero(b.z >= k.threshold, __uint_as_float(raw.y << 16), k);
    v.w = keep_or_zero(b.w >= k.threshold, __uint_as_float(raw.y & 0xffff0000u), k);
    reinterpret_cast<float4*>(g2)[e] = v;
  }
}

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

// The bf16 kernels' launches (static shared memory): the hidden products
// of the backward in 64-wide tiles only, as the f32 ones (make_plan).
template <bool kBackward, bool kDropout>
cudaError_t launch_bf16_hidden(const BfHiddenArgs& a, int bn, cudaStream_t s) {
  int tiles_n = 0, tiles = 0;
  focal::set_tiles(a.rows, a.H, bn, &tiles_n, &tiles);
  if (kBackward || bn == 64)
    mlp_bf16_hidden_kernel<64, kBackward, kDropout><<<tiles, kThreads, 0, s>>>(a);
  else
    mlp_bf16_hidden_kernel<128, false, kDropout><<<tiles, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <bool kDropout>
cudaError_t launch_bf16_out(const BfOutArgs& a, int bn, cudaStream_t s) {
  int tiles_n = 0, tiles = 0;
  focal::set_tiles(a.rows, a.N, bn, &tiles_n, &tiles);
  if (bn == 128)
    mlp_bf16_out_kernel<128, kDropout><<<tiles, kThreads, 0, s>>>(a);
  else
    mlp_bf16_out_kernel<64, kDropout><<<tiles, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

focal::BfOperand bf16_operand(const void* p, int ld) { return focal::BfOperand{p, ld, 0}; }
focal::BfOperand f32_operand(const void* p, int ld) { return focal::BfOperand{p, ld, 1}; }

int plan_for(int T, int C, int H, bool backward, Plan* P) {
  if (int e = check_dims(T, C, H)) return e;
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  *P = make_plan(T, C, H, backward, sms);
  return 0;
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
  if (C % 8 != 0 || H % 8 != 0) return (int)cudaErrorInvalidValue;
  return focal_mlp_workspace(T, C, H, backward, floats, chunks);
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
// and y (w1, b1, w2, b2 f32, the weights rounded to bf16 as they are
// staged) and C and H multiples of 8; the same workspace. Two launches a
// row chunk on `stream`: h = GELU(x W1 + b1) as bf16, y = h W2 + b2.
extern "C" int focal_mlp_fwd_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* y, void* ws, int T, int C, int H,
                                  int dropout, unsigned long long seed, unsigned threshold,
                                  float inv_keep, void* stream) {
  Plan P;
  if (C % 8 != 0 || H % 8 != 0) return (int)cudaErrorInvalidValue;
  if (int e = plan_for(T, C, H, false, &P)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Keep keep{seed, threshold, inv_keep};
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(static_cast<float*>(ws) + P.h);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  for (int c = 0; c < P.chunks; ++c) {
    const int r0 = c * P.rows, rows = std::min(P.rows, T - r0);
    const BfHiddenArgs ha{bf16_operand(xb + (size_t)r0 * C, C), f32_operand(w1, H),
                          static_cast<const float*>(b1), focal::BfOperand{}, focal::BfOperand{},
                          h, nullptr, rows, C, H, r0, keep};
    cudaError_t err = dropout ? launch_bf16_hidden<false, true>(ha, P.hbn, s)
                              : launch_bf16_hidden<false, false>(ha, P.hbn, s);
    if (err != cudaSuccess) return (int)err;
    const BfOutArgs oa{bf16_operand(h, H), f32_operand(w2, C), static_cast<const float*>(b2),
                       yb + (size_t)r0 * C, rows, H, C, r0, keep};
    err = dropout ? launch_bf16_out<true>(oa, P.obn, s) : launch_bf16_out<false>(oa, P.obn, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// #12-bf16: focal_mlp_bwd with a bf16 x, g and dx (w1, b1, w1t, w2t f32,
// rounded to bf16 as they are staged), C and H multiples of 8; dweights f32
// as focal_mlp_bwd's; the same workspace. A row chunk launches on `stream`:
// g2 (with dropout), z and dh (one launch), dx, the weight-gradient
// partials; then one ordered sum of the partials.
extern "C" int focal_mlp_bwd_bf16(const void* x, const void* w1, const void* b1, const void* w1t,
                                  const void* w2t, const void* g, void* dx, void* dweights,
                                  void* ws, int T, int C, int H, int dropout,
                                  unsigned long long seed, unsigned threshold, float inv_keep,
                                  void* stream) {
  Plan P;
  if (C % 8 != 0 || H % 8 != 0) return (int)cudaErrorInvalidValue;
  if (int e = plan_for(T, C, H, true, &P)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Keep keep{seed, threshold, inv_keep};
  float* w = static_cast<float*>(ws);
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(w + P.h);
  float *dz = w + P.dz, *part = w + P.part;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
  __nv_bfloat16* dxb = static_cast<__nv_bfloat16*>(dx);
  const size_t ch = (size_t)C * H;
  cudaError_t err = cudaSuccess;
  for (int c = 0; c < P.chunks; ++c) {
    const int r0 = c * P.rows, rows = std::min(P.rows, T - r0);
    const __nv_bfloat16* xc = xb + (size_t)r0 * C;
    focal::BfOperand g2 = bf16_operand(gb + (size_t)r0 * C, C);
    if (dropout) {
      const size_t n4 = (size_t)rows * (C / 4);
      const int grid = (int)std::min<size_t>((n4 + kThreads - 1) / kThreads, 1u << 16);
      mlp_bf16_g2_kernel<<<grid, kThreads, 0, s>>>(gb + (size_t)r0 * C, w + P.g2, rows, C, r0,
                                                   keep);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      g2 = f32_operand(w + P.g2, C);
    }
    // 1. z = x W1 + b1 and dh = g2 W2^T; dz and the h the forward used
    const BfHiddenArgs ha{bf16_operand(xc, C), f32_operand(w1, H), static_cast<const float*>(b1),
                          g2, f32_operand(w2t, H), h, dz, rows, C, H, r0, keep};
    err = dropout ? launch_bf16_hidden<true, true>(ha, P.hbn, s)
                  : launch_bf16_hidden<true, false>(ha, P.hbn, s);
    if (err != cudaSuccess) return (int)err;
    // 2. dx = dz W1^T
    const BfOutArgs oa{f32_operand(dz, H), f32_operand(w1t, C), nullptr, dxb + (size_t)r0 * C,
                       rows, H, C, r0, keep};
    if ((err = launch_bf16_out<false>(oa, P.obn, s)) != cudaSuccess) return (int)err;
    // 3. dW1 = x^T dz with db1 (the f32 dz), dW2 = h^T g2 with db2, per split,
    //    added to the earlier chunks' partials
    const focal::BfWgrad w1g = focal::bf_wgrad(bf16_operand(xc, C), f32_operand(dz, H), C, H, 0,
                                               ch, P.wbn);
    const focal::BfWgrad w2g = focal::bf_wgrad(bf16_operand(h, H), g2, H, C, ch + H, 2 * ch + H,
                                               P.wbn);
    const int splits = (rows + P.rows_per_split - 1) / P.rows_per_split;
    err = focal::launch_bf16_wgrad<Src>(P.wbn, w1g, w2g, rows, P.rows_per_split, splits, part, P.E,
                                        c > 0, s);
    if (err != cudaSuccess) return (int)err;
  }
  // 4. the partials summed in split order
  return (int)focal::launch_reduce<Src>(part, P.splits, P.E, static_cast<float*>(dweights), s);
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
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
