// DeepSense conv tower for Hopper (sm_90a), train mode: the forward (#13)
// and the backward (#14) of a chain of ConvLayer2D blocks.
//
// Replaces the TPU kernels of focal_tpu/ops/conv_tower.py:
//   #13 _conv0_kernel (_conv0_call -> pl.pallas_call) and _apply_kernel
//       (_apply_call -> pl.pallas_call)
//   #14 _bwd_stats_kernel, _bwd_apply_kernel and _bwd_dc_kernel
//       (_bwd_stats_call, _bwd_apply_call, _bwd_dc_call -> pl.pallas_call)
// Activations are [R*S, C] f32 row-major: row g = r*S + s, r a (sample,
// interval) row, s a spectrum position, channels contiguous. Layer k:
//   c_k = conv(a_{k-1}, W_k) + b_k   1 x KW taps, SAME: tap j reads position
//                                    s + j - (KW-1)/2, zero outside [0, S)
//   y   = c_k A + B                  A = invstd*scale, B = bias - mu*A (batch stats)
//   a_k = GELU(y) * mask[sample] (+ a_{k-1})
// with W_k [KW*Cin, Cout] (tap-major im2col rows), the mask [M, C] per
// sample (row r takes mask[r / (R/M)]: Dropout2d, broadcast over intervals
// and spectrum), GELU the exact one with the TPU kernel's erf (Abramowitz &
// Stegun 7.1.26). The backward of layer k, given da = dL/da_k:
//   gy = da * mask * GELU'(y), x̂ = c P - Q   (P = invstd, Q = mu*invstd)
//   sums Σgy, Σgy·x̂ over all rows -> m0 = Σgy*scale/n, m1 = Σgy·x̂*scale/n
//   dc = P (gy*scale - m0 - x̂ m1)
//   d a_{k-1} = convT(dc, W_k) (+ da),  dW_k = im2col(a_{k-1})^T dc,  db_k = Σ dc
// The [C]-sized steps between them (the statistics to A, B, P, Q; m0, m1)
// end the reductions that produce their sums (bn_stats_kernel,
// bn_grad_stats_kernel); an external first conv's statistics are the
// caller's.
//
// What bounds them on this card: operations. A (1, KW) conv over C = 64
// channels does 2*KW*C multiply-adds per output for 8 bytes of activation
// in and out: 48-160 FLOP per byte at C 64, 4x that at C 256, above the
// f32 ridge of 20 (67 TFLOP/s over 3.35 TB/s) and, as three TF32 products
// an f32 one, near or above the tensor cores' (495 / 3 TFLOP/s: 49). The
// elementwise steps (BN, GELU, mask, residual, the sums) are bound by bytes.
//
// What the design does about it: every conv, transposed conv and weight
// gradient is a row-tiled product on the tensor cores, 3xTF32
// (gemm_3xtf32.cuh: f32 accuracy; each 32-deep slice summed from zero and
// added in f32), 128 x 128 output tiles at C 256 and 128 x 64 (two blocks
// an SM) at C 64 (tile_bn), over all R*S rows of a call:
//   * the conv as an implicit-im2col product (ConvStage): the K-slice
//     [k0, k0 + 32) of tap j reads rows g + j - lo of the activation, and
//     cp.async zero-fills where the position leaves the sample: the SAME
//     padding without an im2col in memory. The transposed conv of the
//     backward is the same loader with the shift negated and B the per-tap
//     W^T (tap_transpose_kernel). Its epilogue adds the bias (or the
//     residual da), writes the output and, in the forward, each row tile's
//     column sums Σc and Σc² (a fixed shuffle tree over the tile's rows).
//   * the elementwise work in byte-bound passes, each once over the rows,
//     four channels (16 bytes) a thread: layer k's apply writes a_k (saved
//     for #14, then read by the next conv: no column block recomputes
//     GELU); the backward's dc is one pass into a workspace; Σgy and Σgy·x̂
//     a pass of column sums.
//   * dW | db = im2col(a_{k-1})^T dc | Σ dc as a split-K product over fixed
//     row splits (ConvWgradStage: the same shifted rows read transposed) on
//     gemm_splitk.cuh's split plan, tagged ConvTowerSrc.
//   * every cross-row sum is a per-tile or per-split partial in a fixed row
//     order, then an ordered sum over tiles (gemm_splitk.cuh's
//     reduce_partials_kernel, or bn_stats_kernel and bn_grad_stats_kernel,
//     which go on to the BN coefficients: the host launches no [C]-sized
//     step between the calls, which at MOD are bound by its launches): no
//     float atomics, two calls give the same bits.
// The products need cin % 4 == 0, so that a float4 never straddles two
// taps (the loaders' invariant; C 16, 64 and 256 take them). The seismic
// first conv (cin 2: K = KW*cin = 6) cannot, and its three products stay
// on the CUDA cores (narrow_conv_kernel, narrow_convT_kernel,
// narrow_wgrad_kernel): 0.08 GFLOP at MOD and 0.16 at MOD_WIDE forward,
// whose time is set by writing c [R*S, C], not by the multiply-adds;
// padding x0 to 4 channels would add a copy of x0 and of dx0 and the
// products' waste on the padding for nothing.
// Not yet: wgmma and TMA; Σgy and Σgy·x̂ folded into the previous
// transposed conv's epilogue.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "gemm_3xtf32.cuh"
#include "gemm_splitk.cuh"

namespace focal {
struct ConvTowerSrc {};  // tags this library's instances of gemm_splitk.cuh's kernels
}  // namespace focal

namespace {

using Src = focal::ConvTowerSrc;
constexpr int kThreads = 256;
constexpr int kStatRows = 256;   // rows per block of the column sums and the narrow convs
constexpr int kNarrowM = 8;      // weight-gradient rows a narrow block sums at once
constexpr int kMaxChannels = 4096;
constexpr float kBnEps = 1e-5f;
static_assert(kThreads == focal::kGemmThreads, "one block size for every kernel here");

__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * ax);
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) * t;
  return copysignf(1.f - poly * expf(-ax * ax), x);
}

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.f + erf_as(z * 0.7071067811865476f));
}

__device__ __forceinline__ float gelu_grad(float z) {
  const float cdf = 0.5f * (1.f + erf_as(z * 0.7071067811865476f));
  return cdf + z * expf(-0.5f * z * z) * 0.3989422804014327f;
}

// Operands of the elementwise passes over [RS, C] (C = the layer's
// channels).
struct BnArgs {
  const float* c;      // the conv output c_k [RS, C]
  const float* da;     // dL/da_k [RS, C] (backward)
  const float* rows;   // [5, C]: A, B, P, Q, scale
  const float* m;      // [2, C]: m0, m1 (backward)
  const float* mask;   // [M, C]; row g takes mask[g / S / group]
  const float* aprev;  // the residual a_{k-1} [RS, C], or null (forward)
  float* out;          // a_k (forward) or dc (backward) [RS, C]
  int R, S, C, group;
};

// Four consecutive channels: the elementwise passes and the column sums
// move 16 bytes a thread (C % 4 == 0; every array they read or write is
// 16-byte aligned).
struct F4 {
  float v[4];
};

__device__ __forceinline__ F4 ld4(const float* base, size_t i4) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(base) + i4);
  return {{t.x, t.y, t.z, t.w}};
}

__device__ __forceinline__ void st4(float* base, size_t i4, const F4& f) {
  reinterpret_cast<float4*>(base)[i4] = make_float4(f.v[0], f.v[1], f.v[2], f.v[3]);
}

// The mask of row g at channels 4 c4 .. 4 c4 + 3.
__device__ __forceinline__ F4 mask4(const BnArgs& p, int g, int c4) {
  return ld4(p.mask + (size_t)(g / p.S / p.group) * p.C, c4);
}

// out over all RS*C elements, four channels a thread: a_k = GELU(c A + B)
// * mask (+ a_{k-1}) (kBackward false) or dc = P (gy scale - m0 - x̂ m1),
// gy = da * mask * GELU'(c A + B).
template <bool kBackward>
__global__ void __launch_bounds__(kThreads) bn_elementwise_kernel(const BnArgs p) {
  const int C4 = p.C / 4;
  const size_t total = (size_t)p.R * p.S * C4;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int g = (int)(e / C4), c4 = (int)(e - (size_t)g * C4);
    const F4 c = ld4(p.c, e), A = ld4(p.rows, c4), B = ld4(p.rows + p.C, c4);
    const F4 mk = mask4(p, g, c4);
    F4 o;
    if (!kBackward) {
#pragma unroll
      for (int u = 0; u < 4; ++u) o.v[u] = gelu(fmaf(c.v[u], A.v[u], B.v[u])) * mk.v[u];
      if (p.aprev != nullptr) {
        const F4 a = ld4(p.aprev, e);
#pragma unroll
        for (int u = 0; u < 4; ++u) o.v[u] += a.v[u];
      }
    } else {
      const F4 da = ld4(p.da, e), P = ld4(p.rows + 2 * p.C, c4), Q = ld4(p.rows + 3 * p.C, c4);
      const F4 sc = ld4(p.rows + 4 * p.C, c4), m0 = ld4(p.m, c4), m1 = ld4(p.m + p.C, c4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float gy = da.v[u] * mk.v[u] * gelu_grad(fmaf(c.v[u], A.v[u], B.v[u]));
        const float xhat = fmaf(c.v[u], P.v[u], -Q.v[u]);
        o.v[u] = P.v[u] * (gy * sc.v[u] - m0.v[u] - xhat * m1.v[u]);
      }
    }
    st4(p.out, e, o);
  }
}

// The column sums of a block of kStatRows rows, four columns a thread:
// threads are (lane, col) pairs, cols = min(K / 4, kThreads) groups of
// four columns and lanes = kThreads / cols; a thread sums its group c4
// over rows g_begin + lane, + lanes, ... in order (f(g, c4, s1, s2) adds
// to its two sums), and the lanes' sums are added in lane order into
// part[blockIdx.x] [2, K]. red holds column_sums_smem(K) bytes.
template <class F>
__device__ __forceinline__ void block_column_sums(int K, int g_begin, int g_end, float* red,
                                                  float* part, F f) {
  const int K4 = K / 4, cols = min(K4, kThreads), lanes = kThreads / cols;
  const int lane = threadIdx.x / cols, col = threadIdx.x % cols;
  if (lane < lanes) {
    for (int c4 = col; c4 < K4; c4 += cols) {
      F4 s1{}, s2{};
#pragma unroll 4  // four rows' loads in flight
      for (int g = g_begin + lane; g < g_end; g += lanes) f(g, c4, s1, s2);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        red[lane * K + 4 * c4 + u] = s1.v[u];
        red[(lanes + lane) * K + 4 * c4 + u] = s2.v[u];
      }
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < K; ch += kThreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int l = 0; l < lanes; ++l) {
      t1 += red[l * K + ch];
      t2 += red[(lanes + l) * K + ch];
    }
    part[(size_t)blockIdx.x * 2 * K + ch] = t1;
    part[((size_t)blockIdx.x * 2 + 1) * K + ch] = t2;
  }
}

size_t column_sums_smem(int K) {
  return (size_t)2 * (kThreads / std::min(K / 4, kThreads)) * K * sizeof(float);
}

// Per block of kStatRows rows: Σgy and Σgy·x̂ per channel, into part[block].
__global__ void __launch_bounds__(kThreads) bn_grad_sums_kernel(const BnArgs p,
                                                                float* __restrict__ part) {
  extern __shared__ float red[];
  const int C4 = p.C / 4;
  const int g_begin = blockIdx.x * kStatRows;
  block_column_sums(p.C, g_begin, min(p.R * p.S, g_begin + kStatRows), red, part,
                    [&](int g, int c4, F4& s1, F4& s2) {
                      const size_t e = (size_t)g * C4 + c4;
                      const F4 c = ld4(p.c, e), da = ld4(p.da, e), mk = mask4(p, g, c4);
                      const F4 A = ld4(p.rows, c4), B = ld4(p.rows + p.C, c4);
                      const F4 P = ld4(p.rows + 2 * p.C, c4), Q = ld4(p.rows + 3 * p.C, c4);
#pragma unroll
                      for (int u = 0; u < 4; ++u) {
                        const float y = fmaf(c.v[u], A.v[u], B.v[u]);
                        const float gy = da.v[u] * mk.v[u] * gelu_grad(y);
                        s1.v[u] += gy;
                        s2.v[u] = fmaf(gy, fmaf(c.v[u], P.v[u], -Q.v[u]), s2.v[u]);
                      }
                    });
}

// The BatchNorm of a conv's output: its affine (scale, bias [C]) in; the
// coefficients rows [5, C] and the batch mean and biased variance [C] out.
struct BnStats {
  const float* scale;
  const float* bias;
  float* rows;
  float* mu;
  float* var;
};

// One thread a channel: the ordered sum of a forward conv's column-sum
// partials [tiles, 2, C], then mu = Σc / n, var = max(Σc² / n - mu², 0)
// (the fast variance), invstd = rsqrt(var + eps) and rows = [A = invstd
// scale; B = bias - mu A; P = invstd; Q = mu invstd; scale], each step
// rounded on its own as the plain version's torch ops round it.
__global__ void bn_stats_kernel(const float* __restrict__ part, int tiles, int C, float n,
                                const BnStats st) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= C) return;
  float s1 = 0.f, s2 = 0.f;
  for (int t = 0; t < tiles; ++t) {
    s1 += part[(size_t)t * 2 * C + ch];
    s2 += part[((size_t)t * 2 + 1) * C + ch];
  }
  const float mu = s1 / n;
  const float var = fmaxf(__fsub_rn(s2 / n, __fmul_rn(mu, mu)), 0.f);
  const float invstd = rsqrtf(var + kBnEps);
  const float sc = st.scale[ch], a = __fmul_rn(invstd, sc);
  st.rows[ch] = a;
  st.rows[C + ch] = __fsub_rn(st.bias[ch], __fmul_rn(mu, a));
  st.rows[2 * C + ch] = invstd;
  st.rows[3 * C + ch] = __fmul_rn(mu, invstd);
  st.rows[4 * C + ch] = sc;
  st.mu[ch] = mu;
  st.var[ch] = var;
}

// One thread a channel: the ordered sum of the backward's column-sum
// partials [blocks, 2, C] into s2 = [Σgy; Σgy·x̂], and m = s2 scale / n
// (the means of dx̂ and dx̂·x̂).
__global__ void bn_grad_stats_kernel(const float* __restrict__ part, int blocks, int C, float n,
                                     const float* __restrict__ rows, float* __restrict__ s2,
                                     float* __restrict__ m) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= C) return;
  float t1 = 0.f, t2 = 0.f;
  for (int b = 0; b < blocks; ++b) {
    t1 += part[(size_t)b * 2 * C + ch];
    t2 += part[((size_t)b * 2 + 1) * C + ch];
  }
  const float sc = rows[4 * C + ch];
  s2[ch] = t1;
  s2[C + ch] = t2;
  m[ch] = __fmul_rn(t1, sc) / n;
  m[C + ch] = __fmul_rn(t2, sc) / n;
}

// ---------------------------------------------------------------------------
// the tensor-core products

// A conv (sign +1) or transposed conv (sign -1) as an implicit-im2col
// product: out = im2col(a.x) w (+ bias) (+ add), [M, N], K = KW * a.cin;
// with part, each row tile's column sums of out and out^2 into part[tile]
// [2, N].
struct ConvGemmArgs {
  focal::ShiftRows a;
  const float* w;     // [K, N]
  const float* bias;  // [N], or null
  const float* add;   // [M, N], or null
  float* out;         // [M, N]
  float* part;        // [row tiles, 2, N], or null
  int M, N, K;
};

template <int kBN>
__global__ void __launch_bounds__(kThreads, kBN == 64 ? 2 : 1)
conv_gemm_kernel(const ConvGemmArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int kNT = focal::gemm_nt<kBN>();
  const int tiles_n = (p.N + kBN - 1) / kBN;
  const int tile_m = blockIdx.x / tiles_n;
  const int m0 = tile_m * focal::kGemmBM, n0 = (blockIdx.x % tiles_n) * kBN;
  float acc[4][kNT][4], csum = 0.f;
  focal::gemm_tile_staged<false, false, kBN>(
      focal::ConvStage<kBN>(p.a, p.w, p.M, p.N, m0, n0, p.K), 0, p.K, smem, acc, csum);

  // the epilogue: fragment element (row g or g + 8, column 2t or 2t + 1) of
  // lane 4g + t (gemm_for_each_output's order), with the column sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = m0 + (warp >> 2) * 64, wc = (warp & 3) * (kBN / 4);
  float s1[kNT][2], s2[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = n0 + wc + nt * 8 + 2 * t;
    s1[nt][0] = s1[nt][1] = s2[nt][0] = s2[nt][1] = 0.f;
    if (col >= p.N) continue;  // N % 4 == 0: col + 1 lies inside with col
    const float b0 = p.bias ? __ldg(p.bias + col) : 0.f;
    const float b1 = p.bias ? __ldg(p.bias + col + 1) : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm + mt * 16 + g + 8 * half;
        if (row >= p.M) continue;
        const size_t e = (size_t)row * p.N + col;
        float v0 = acc[mt][nt][2 * half] + b0, v1 = acc[mt][nt][2 * half + 1] + b1;
        if (p.add) {
          v0 += p.add[e];
          v1 += p.add[e + 1];
        }
        *reinterpret_cast<float2*>(p.out + e) = make_float2(v0, v1);
        s1[nt][0] += v0;
        s1[nt][1] += v1;
        s2[nt][0] = fmaf(v0, v0, s2[nt][0]);
        s2[nt][1] = fmaf(v1, v1, s2[nt][1]);
      }
  }
  if (p.part == nullptr) return;
  // over the 8 lanes of a column (g = 0..7), a fixed butterfly; then the
  // two warps of a column block, in order
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[nt][u] += __shfl_xor_sync(0xffffffffu, s1[nt][u], off);
        s2[nt][u] += __shfl_xor_sync(0xffffffffu, s2[nt][u], off);
      }
  __syncthreads();  // every warp is done with the ring: its slots hold the sums now
  float* red = smem;  // [2 warp rows][s1, s2][kBN]
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = wc + nt * 8 + 2 * t + u;
        red[((warp >> 2) * 2) * kBN + c] = s1[nt][u];
        red[((warp >> 2) * 2 + 1) * kBN + c] = s2[nt][u];
      }
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < kBN && n0 + c < p.N) {
    p.part[(size_t)tile_m * 2 * p.N + n0 + c] = red[c] + red[2 * kBN + c];
    p.part[((size_t)tile_m * 2 + 1) * p.N + n0 + c] = red[kBN + c] + red[3 * kBN + c];
  }
}

// Block (tile, split): one tile of dW = im2col(a.x)^T dc [M = KW * cin, N]
// over the split's rows, and in the first row tile dc's column sums (db)
// over them, into the split's partial [dW | db] (E floats).
template <int kBN>
__global__ void __launch_bounds__(kThreads, kBN == 64 ? 2 : 1)
conv_wgrad_kernel(const focal::ShiftRows a, const float* __restrict__ dc, int M, int N, int RS,
                  int rows_per_split, float* __restrict__ part, size_t E) {
  extern __shared__ float4 smem4[];
  const int tiles_n = (N + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / tiles_n) * focal::kGemmBM, n0 = (blockIdx.x % tiles_n) * kBN;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(RS, r_begin + rows_per_split);
  float acc[4][focal::gemm_nt<kBN>()][4], csum = 0.f;
  focal::gemm_tile_staged<true, true, kBN>(
      focal::ConvWgradStage<kBN>(a, dc, M, N, m0, n0, r_end), r_begin, r_end,
      reinterpret_cast<float*>(smem4), acc, csum);
  float* out = part + (size_t)blockIdx.y * E;
  focal::gemm_for_each_output<kBN>(acc, M, N, m0, n0, [&](int row, int col, float v0, float v1) {
    *reinterpret_cast<float2*>(out + (size_t)row * N + col) = make_float2(v0, v1);
  });
  if (m0 == 0 && (int)threadIdx.x < kBN && n0 + (int)threadIdx.x < N)
    out[(size_t)M * N + n0 + threadIdx.x] = csum;
}

// wt [KW * C, cin] from w [KW * cin, C]: wt[j*C + co][ci] = w[j*cin + ci][co],
// the B of the transposed conv.
__global__ void tap_transpose_kernel(const float* __restrict__ w, int KW, int cin, int C,
                                     float* __restrict__ wt) {
  const size_t total = (size_t)KW * cin * C;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int ci = (int)(e % cin);
    const size_t jc = e / cin;
    const int co = (int)(jc % C), j = (int)(jc / C);
    wt[e] = w[((size_t)j * cin + ci) * C + co];
  }
}

// ---------------------------------------------------------------------------
// the narrow first conv (cin % 4 != 0: the seismic input, cin 2), on the
// CUDA cores

// c = conv(x, w) + b [RS, N] from x [RS, cin], w [KW * cin, N], and per
// block of kStatRows rows the column sums of c and c^2 into part[block].
__global__ void __launch_bounds__(kThreads)
narrow_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ out, float* __restrict__ part,
                   int RS, int S, int cin, int N, int KW) {
  extern __shared__ float red[];
  const int lo = (KW - 1) / 2;
  const int g_begin = blockIdx.x * kStatRows;
  block_column_sums(N, g_begin, min(RS, g_begin + kStatRows), red, part,
                    [&](int g, int c4, F4& s1, F4& s2) {
                      const int s = g % S;
                      F4 v;
#pragma unroll
                      for (int u = 0; u < 4; ++u) v.v[u] = b[4 * c4 + u];
                      for (int j = 0; j < KW; ++j) {
                        const int d = j - lo;
                        if ((unsigned)(s + d) >= (unsigned)S) continue;
                        const float* xr = x + (size_t)(g + d) * cin;
                        const float* wr = w + (size_t)j * cin * N + 4 * c4;
                        for (int ci = 0; ci < cin; ++ci) {
                          const float xv = xr[ci];
#pragma unroll
                          for (int u = 0; u < 4; ++u)
                            v.v[u] = fmaf(xv, wr[(size_t)ci * N + u], v.v[u]);
                        }
                      }
                      st4(out, (size_t)g * (N / 4) + c4, v);
#pragma unroll
                      for (int u = 0; u < 4; ++u) {
                        s1.v[u] += v.v[u];
                        s2.v[u] = fmaf(v.v[u], v.v[u], s2.v[u]);
                      }
                    });
}

// dx = convT(dc, w) [RS, cin] from dc [RS, C] and w [KW * cin, C]: one warp
// a row, its lanes over the C channels of dc (w's rows are contiguous in
// them), summed by a fixed butterfly.
__global__ void __launch_bounds__(kThreads)
narrow_convT_kernel(const float* __restrict__ dc, const float* __restrict__ w,
                    float* __restrict__ dx, int RS, int S, int cin, int C, int KW) {
  const int lo = (KW - 1) / 2;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (g >= RS) return;
  const int s = g % S;
  for (int ci = 0; ci < cin; ++ci) {
    float v = 0.f;
    for (int j = 0; j < KW; ++j) {
      const int d = lo - j;  // tap j of the forward read s + j - lo
      if ((unsigned)(s + d) >= (unsigned)S) continue;
      const float* dr = dc + (size_t)(g + d) * C;
      const float* wr = w + ((size_t)j * cin + ci) * C;
      for (int co = lane; co < C; co += 32) v = fmaf(dr[co], wr[co], v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) dx[(size_t)g * cin + ci] = v;
  }
}

// Split blockIdx.x: dW = im2col(x)^T dc [M = KW * cin, C] and db = Σ dc
// over the split's rows, into its partial [dW | db] (E floats). Threads
// are (lane, col) pairs, cols = min(C, kThreads) columns and lanes =
// kThreads / cols, a lane summing every lanes-th row; a pass sums kNarrowM
// rows of dW (and, in the first, db) and adds the lanes in order.
__global__ void __launch_bounds__(kThreads)
narrow_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dc, int RS, int S,
                    int cin, int C, int KW, int rows_per_split, float* __restrict__ part,
                    size_t E) {
  __shared__ float red[kThreads * (kNarrowM + 1)];
  const int lo = (KW - 1) / 2, M = KW * cin;
  const int cols = min(C, kThreads), lanes = kThreads / cols;
  const int lane = threadIdx.x / cols, col = threadIdx.x % cols;
  const int g_begin = blockIdx.x * rows_per_split;
  const int g_end = min(RS, g_begin + rows_per_split);
  float* out = part + (size_t)blockIdx.x * E;
  for (int ch0 = 0; ch0 < C; ch0 += cols) {
    const int ch = ch0 + col;
    for (int mb = 0; mb < M; mb += kNarrowM) {
      float acc[kNarrowM + 1];
      int d[kNarrowM], off[kNarrowM];  // row m's tap shift (S past M: never inside) and x offset
#pragma unroll
      for (int u = 0; u < kNarrowM; ++u) {
        const int m = mb + u, j = m / cin;
        d[u] = m < M ? j - lo : S;
        off[u] = (j - lo) * cin + (m - j * cin);
      }
#pragma unroll
      for (int u = 0; u <= kNarrowM; ++u) acc[u] = 0.f;
      if (lane < lanes && ch < C) {
        for (int g = g_begin + lane; g < g_end; g += lanes) {
          const float v = dc[(size_t)g * C + ch];
          const int s = g % S;
          acc[kNarrowM] += v;
#pragma unroll
          for (int u = 0; u < kNarrowM; ++u)
            if ((unsigned)(s + d[u]) < (unsigned)S)
              acc[u] = fmaf(x[(size_t)g * cin + off[u]], v, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u <= kNarrowM; ++u) red[u * kThreads + threadIdx.x] = acc[u];
      __syncthreads();
      if ((int)threadIdx.x < cols && ch < C) {
        for (int u = 0; u <= kNarrowM; ++u) {
          const int m = mb + u;
          if (u == kNarrowM ? mb != 0 : m >= M) continue;
          float tot = 0.f;
          for (int l = 0; l < lanes; ++l) tot += red[u * kThreads + l * cols + col];
          out[(u == kNarrowM ? (size_t)M * C : (size_t)m * C) + ch] = tot;
        }
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// host side

cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

bool channels_ok(int c) { return c >= 1 && c <= kMaxChannels; }

// Whether a conv over cin input channels runs on the tensor cores.
bool on_tensor_cores(int cin) { return cin % 4 == 0; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether every array of an elementwise pass or column sum is 16-byte
// aligned (they move four channels at a time).
bool bn_aligned(const BnArgs& p) {
  const void* arrays[] = {p.c, p.da, p.rows, p.m, p.mask, p.aprev, p.out};
  for (const void* a : arrays)
    if (a != nullptr && !aligned16(a)) return false;
  return true;
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// The column-sum partials of a forward conv over cin channels: one per
// 128-row tile of the product, or per kStatRows rows of the narrow conv.
int fwd_partials(int RS, int cin) {
  return on_tensor_cores(cin) ? ceil_div(RS, focal::kGemmBM) : ceil_div(RS, kStatRows);
}

// The weight gradient of a layer (KW * cin x C, and db): tile width, tiles,
// row splits and the partial size E = M C + C. The product's splits fill
// the card about four times over (split_rows); the narrow one takes
// kStatRows-row splits the same way, as one tile.
struct WgradPlan {
  int bn, tiles, splits, rows_per_split;
  size_t E;
};

WgradPlan wgrad_plan(int RS, int cin, int C, int KW, int sms) {
  WgradPlan P{};
  P.E = (size_t)KW * cin * C + C;
  int tiles_n = 0;
  if (on_tensor_cores(cin)) {
    P.bn = focal::tile_bn(C, 0);
    focal::set_tiles(KW * cin, C, P.bn, &tiles_n, &P.tiles);
  } else {
    P.bn = 0;
    P.tiles = 1;
  }
  const focal::RowSplits rs = focal::split_rows(RS, P.tiles, sms);
  P.splits = rs.splits;
  P.rows_per_split = rs.rows_per_split;
  return P;
}

// R rows of S positions with a mask of M rows (R % M == 0), and C channels
// (a multiple of 4: the products' outputs): every element index R*S*C fits
// an int.
int check_rows(int R, int S, int M, int C) {
  if (R < 1 || S < 1 || M < 1 || R % M != 0 || !channels_ok(C) ||
      (long long)R * S * C >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  return C % 4 == 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int kBN>
cudaError_t launch_conv_gemm_bn(const ConvGemmArgs& p, cudaStream_t s) {
  int tiles_n = 0, tiles = 0;
  focal::set_tiles(p.M, p.N, kBN, &tiles_n, &tiles);
  const size_t smem = focal::gemm_smem_bytes(kBN);
  cudaError_t err = set_smem(conv_gemm_kernel<kBN>, smem);
  if (err != cudaSuccess) return err;
  conv_gemm_kernel<kBN><<<tiles, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

// out = im2col(x) w (+ bias, + add) over RS rows of x [RS, cin], w [KW *
// cin, N]; sign -1 for the transposed conv; with part the row tiles'
// column sums.
cudaError_t launch_conv_gemm(const float* x, int cin, int S, int KW, int sign, const float* w,
                             const float* bias, const float* add, float* out, float* part, int RS,
                             int N, cudaStream_t s) {
  if (!aligned16(x) || !aligned16(w)) return cudaErrorMisalignedAddress;
  ConvGemmArgs p{};
  p.a = focal::ShiftRows{x, cin, S, (KW - 1) / 2, sign};
  p.w = w, p.bias = bias, p.add = add, p.out = out, p.part = part;
  p.M = RS, p.N = N, p.K = KW * cin;
  return focal::tile_bn(N, 0) == 128 ? launch_conv_gemm_bn<128>(p, s)
                                     : launch_conv_gemm_bn<64>(p, s);
}

int launch_elementwise(bool backward, const BnArgs& p, cudaStream_t s) {
  if (!bn_aligned(p)) return (int)cudaErrorMisalignedAddress;
  int sms = 0;
  cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)p.R * p.S * p.C / 4;
  const unsigned blocks =
      (unsigned)std::max<size_t>(1, std::min((total + kThreads - 1) / kThreads, (size_t)sms * 8));
  if (backward)
    bn_elementwise_kernel<true><<<blocks, kThreads, 0, s>>>(p);
  else
    bn_elementwise_kernel<false><<<blocks, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// The first conv (or layer k+1's conv) of the forward over x [RS, cin]:
// c [RS, cout] and its BatchNorm's statistics and coefficients st,
// through ws (the column-sum partials).
int conv_forward(const float* x, const float* w, const float* b, float* c, const BnStats& st,
                 float* ws, int RS, int S, int cin, int cout, int kw, cudaStream_t s) {
  cudaError_t err;
  if (on_tensor_cores(cin)) {
    err = launch_conv_gemm(x, cin, S, kw, 1, w, b, nullptr, c, ws, RS, cout, s);
  } else {
    if (!aligned16(c)) return (int)cudaErrorMisalignedAddress;
    const size_t smem = column_sums_smem(cout);
    err = set_smem(narrow_conv_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    narrow_conv_kernel<<<ceil_div(RS, kStatRows), kThreads, smem, s>>>(x, w, b, c, ws, RS, S, cin,
                                                                      cout, kw);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  bn_stats_kernel<<<ceil_div(cout, kThreads), kThreads, 0, s>>>(ws, fwd_partials(RS, cin), cout,
                                                                (float)RS, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Workspace, in floats, of one launch on the current device, or an error
// when no plan takes the geometry. kind 0: a forward conv (conv0 or apply
// with a next layer; cin = the conv's input channels, cout = its
// outputs); 1: the backward sums (cin = cout = C); 2: the backward apply
// (cin = the layer's input channels, cout = C).
extern "C" int focal_ct_workspace(int kind, int R, int S, int cin, int cout, int kw,
                                  long long* floats) {
  if (int e = check_rows(R, S, 1, cout)) return e;
  if (!channels_ok(cin) || kw < 1 || (long long)R * S * cin >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int RS = R * S;
  if (kind == 0) {
    *floats = (long long)fwd_partials(RS, cin) * 2 * cout;
    return 0;
  }
  if (kind == 1) {
    *floats = (long long)ceil_div(RS, kStatRows) * 2 * cout;
    return 0;
  }
  if (kind == 2) {
    int sms = 0;
    const cudaError_t err = device_sms(&sms);
    if (err != cudaSuccess) return (int)err;
    const WgradPlan W = wgrad_plan(RS, cin, cout, kw, sms);
    const long long wt = on_tensor_cores(cin) ? (long long)kw * cout * cin : 0;
    *floats = (long long)RS * cout + wt + (long long)W.splits * (long long)W.E;
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// The first conv of an internal-c0 tower (#13, _conv0_kernel): c = conv(x,
// w) + b [RS, cout], and from its batch statistics (with the BatchNorm's
// scale and bias [cout]) rows [5, cout], mu and var [cout]. ws holds
// focal_ct_workspace(0, R, S, cin, cout, kw) floats. Two launches on
// `stream`: the conv with its column-sum partials (the product, or the
// narrow conv where cin % 4 != 0) and their ordered sum with the
// statistics.
extern "C" int focal_ct_conv0(const void* x, const void* w, const void* b, const void* scale,
                              const void* bias, void* c, void* rows, void* mu, void* var, void* ws,
                              int R, int S, int cin, int cout, int kw, void* stream) {
  if (int e = check_rows(R, S, 1, cout)) return e;
  if (!channels_ok(cin) || kw < 1 || (long long)R * S * cin >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const BnStats st{static_cast<const float*>(scale), static_cast<const float*>(bias),
                   static_cast<float*>(rows), static_cast<float*>(mu), static_cast<float*>(var)};
  return conv_forward(static_cast<const float*>(x), static_cast<const float*>(w),
                      static_cast<const float*>(b), static_cast<float*>(c), st,
                      static_cast<float*>(ws), R * S, S, cin, cout, kw,
                      static_cast<cudaStream_t>(stream));
}

// Layer k's apply (#13, _apply_kernel): a = GELU(c*A + B) * mask (+ aprev)
// [RS, C], rows = [A; B; P; Q; scale] [5, C], mask [M, C] (R % M == 0),
// aprev null for no residual. With w [kw*C, cout], b and layer k+1's
// BatchNorm scale and bias: then layer k+1's c_next = conv(a, w) + b and
// from its batch statistics rows_next [5, cout], mu_next and var_next
// [cout] (ws: focal_ct_workspace(0, R, S, C, cout, kw) floats); with w
// null the apply alone (the rest unused). One launch, or three: the apply,
// the conv product with its column-sum partials, their ordered sum with
// the statistics.
extern "C" int focal_ct_apply(const void* c, const void* rows, const void* mask,
                              const void* aprev, const void* w, const void* b, const void* scale,
                              const void* bias, void* a, void* c_next, void* rows_next,
                              void* mu_next, void* var_next, void* ws, int R, int S, int M, int C,
                              int cout, int kw, void* stream) {
  if (int e = check_rows(R, S, M, C)) return e;
  if (w != nullptr) {
    if (int e = check_rows(R, S, 1, cout)) return e;
    if (kw < 1) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BnArgs p{};
  p.c = static_cast<const float*>(c);
  p.rows = static_cast<const float*>(rows);
  p.mask = static_cast<const float*>(mask);
  p.aprev = static_cast<const float*>(aprev);
  p.out = static_cast<float*>(a);
  p.R = R, p.S = S, p.C = C, p.group = R / M;
  int err = launch_elementwise(false, p, s);
  if (err || w == nullptr) return err;
  const BnStats st{static_cast<const float*>(scale), static_cast<const float*>(bias),
                   static_cast<float*>(rows_next), static_cast<float*>(mu_next),
                   static_cast<float*>(var_next)};
  return conv_forward(p.out, static_cast<const float*>(w), static_cast<const float*>(b),
                      static_cast<float*>(c_next), st, static_cast<float*>(ws), R * S, S, C, cout,
                      kw, s);
}

// The backward sums of layer k (#14, _bwd_stats_kernel): s2 = [Σgy; Σgy·x̂]
// [2, C] from da, c [RS, C], mask and rows, and m = s2 scale / n [2, C]
// (m0, m1 of the backward apply). ws: focal_ct_workspace(1, R, S, C, C, 1)
// floats. Two launches: per-block sums, their ordered sum.
extern "C" int focal_ct_bwd_stats(const void* da, const void* c, const void* mask,
                                  const void* rows, void* s2, void* m, void* ws, int R, int S,
                                  int M, int C, void* stream) {
  if (int e = check_rows(R, S, M, C)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BnArgs p{};
  p.c = static_cast<const float*>(c);
  p.da = static_cast<const float*>(da);
  p.rows = static_cast<const float*>(rows);
  p.mask = static_cast<const float*>(mask);
  p.R = R, p.S = S, p.C = C, p.group = R / M;
  if (!bn_aligned(p)) return (int)cudaErrorMisalignedAddress;
  const int blocks = ceil_div(R * S, kStatRows);
  const size_t smem = column_sums_smem(C);
  cudaError_t e = set_smem(bn_grad_sums_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  float* part = static_cast<float*>(ws);
  bn_grad_sums_kernel<<<blocks, kThreads, smem, s>>>(p, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_grad_stats_kernel<<<ceil_div(C, kThreads), kThreads, 0, s>>>(
      part, blocks, C, (float)(R * S), p.rows, static_cast<float*>(s2), static_cast<float*>(m));
  return (int)cudaGetLastError();
}

// The backward apply of layer k (#14, _bwd_apply_kernel): dc from da, c,
// mask, rows and m = [m0; m1] [2, C]; dprev = convT(dc, W) (+ da when
// `residual`) [RS, cin] from w = W [kw*cin, C]; dwb = [dW (kw*cin x C) | db
// (C)]. aprev [RS, cin] is the layer's input. ws: focal_ct_workspace(2, R,
// S, cin, C, kw) floats (dc, W's per-tap transpose, the weight-gradient
// partials). Launches: dc; W^T and the transposed-conv product (or the
// narrow transposed conv where cin % 4 != 0); the weight-gradient partials
// (product or narrow); their ordered sum.
extern "C" int focal_ct_bwd_apply(const void* da, const void* c, const void* mask,
                                  const void* rows, const void* m, const void* aprev,
                                  const void* w, void* dprev, void* dwb, void* ws, int R,
                                  int S, int M, int C, int cin, int kw, int residual,
                                  void* stream) {
  if (int e = check_rows(R, S, M, C)) return e;
  if (!channels_ok(cin) || kw < 1 || (residual && cin != C) ||
      (long long)R * S * cin >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int RS = R * S;
  const bool tc = on_tensor_cores(cin);
  const float* wf = static_cast<const float*>(w);
  const float* ap = static_cast<const float*>(aprev);
  float* dc = static_cast<float*>(ws);
  float* wt = dc + (size_t)RS * C;
  float* wpart = wt + (tc ? (size_t)kw * C * cin : 0);
  BnArgs p{};
  p.c = static_cast<const float*>(c);
  p.da = static_cast<const float*>(da);
  p.rows = static_cast<const float*>(rows);
  p.m = static_cast<const float*>(m);
  p.mask = static_cast<const float*>(mask);
  p.out = dc;
  p.R = R, p.S = S, p.C = C, p.group = R / M;
  if (int err = launch_elementwise(true, p, s)) return err;
  const WgradPlan W = wgrad_plan(RS, cin, C, kw, sms);
  if (tc) {
    if (!aligned16(ap)) return (int)cudaErrorMisalignedAddress;
    const size_t n = (size_t)kw * C * cin;
    tap_transpose_kernel<<<(unsigned)std::min<size_t>((n + kThreads - 1) / kThreads, sms * 8),
                           kThreads, 0, s>>>(wf, kw, cin, C, wt);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    e = launch_conv_gemm(dc, C, S, kw, -1, wt, nullptr, residual ? p.da : nullptr,
                         static_cast<float*>(dprev), nullptr, RS, cin, s);
    if (e != cudaSuccess) return (int)e;
    const focal::ShiftRows a{ap, cin, S, (kw - 1) / 2, 1};
    const size_t smem = focal::gemm_smem_bytes(W.bn);
    if (W.bn == 128) {
      if ((e = set_smem(conv_wgrad_kernel<128>, smem)) != cudaSuccess) return (int)e;
      conv_wgrad_kernel<128><<<dim3(W.tiles, W.splits), kThreads, smem, s>>>(
          a, dc, kw * cin, C, RS, W.rows_per_split, wpart, W.E);
    } else {
      if ((e = set_smem(conv_wgrad_kernel<64>, smem)) != cudaSuccess) return (int)e;
      conv_wgrad_kernel<64><<<dim3(W.tiles, W.splits), kThreads, smem, s>>>(
          a, dc, kw * cin, C, RS, W.rows_per_split, wpart, W.E);
    }
  } else {
    narrow_convT_kernel<<<ceil_div(RS, kThreads / 32), kThreads, 0, s>>>(
        dc, wf, static_cast<float*>(dprev), RS, S, cin, C, kw);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    narrow_wgrad_kernel<<<W.splits, kThreads, 0, s>>>(ap, dc, RS, S, cin, C, kw,
                                                      W.rows_per_split, wpart, W.E);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)focal::launch_reduce<Src>(wpart, W.splits, W.E, static_cast<float*>(dwb), s);
}

// dc alone (#14, _bwd_dc_kernel): the input gradient of an external first
// conv's output [RS, C]. One launch.
extern "C" int focal_ct_bwd_dc(const void* da, const void* c, const void* mask, const void* rows,
                               const void* m, void* dc, int R, int S, int M, int C,
                               void* stream) {
  if (int e = check_rows(R, S, M, C)) return e;
  BnArgs p{};
  p.c = static_cast<const float*>(c);
  p.da = static_cast<const float*>(da);
  p.rows = static_cast<const float*>(rows);
  p.m = static_cast<const float*>(m);
  p.mask = static_cast<const float*>(mask);
  p.out = static_cast<float*>(dc);
  p.R = R, p.S = S, p.C = C, p.group = R / M;
  return launch_elementwise(true, p, static_cast<cudaStream_t>(stream));
}

extern "C" const char* focal_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
