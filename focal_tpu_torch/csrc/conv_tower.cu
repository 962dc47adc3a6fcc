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
// caller's. Over several data ranks (DP-13-14: the JAX tower over a data
// mesh normalises with the global batch's statistics) those two kernels
// write the raw sums alone, the caller sums them over the ranks and forms
// the [C]-sized steps at the global count between the launches.
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
// Not yet, in f32: wgmma and TMA; Σgy and Σgy·x̂ folded into the previous
// transposed conv's epilogue (the bf16 forms below do both).
//
// The bf16 forms (-compute_dtype bfloat16): #13-bf16 and #14-bf16 replace
// the same TPU kernels fed bf16 rows (store_dtype bfloat16,
// focal_tpu/ops/conv_tower.py:437): every entry point takes `bf16`, and then
// x0, c, a, da, dc and dprev are bf16 rows, W is bf16, and the BN rows,
// masks, sums and dW, db stay f32. The rounding points are the JAX tower's:
// c = im2col(x) W (bf16 operands, f32 sums) + b rounded to bf16 once, the
// BN sums of the stored bf16 c; y, GELU, the mask and the residual in f32,
// a rounded once; in the backward gy and x̂ in f32 from the bf16 da and c,
// dc in f32 rounded to bf16 for the transposed conv and dW, db the sum of
// the f32 dc (the dc pass sums it per block, bn_dc_sums_kernel), dprev =
// convT(dc, W) + da rounded once.
// What bounds them: at MOD's widths bytes (a (1, KW) conv over C = 64 does
// 2*KW*64 FLOP an output for 4 bytes of bf16 rows in and out: 160 FLOP a
// byte at KW 5, below the bf16 ridge of 295), at MOD_WIDE's (C 256) the
// products' operations. The design:
//   * the three products on gemm_wgmma.cuh's ring (TMA into 128-byte-
//     swizzled stages, one producer and two consumer warpgroups, wgmma
//     m64nNk16, persistent blocks), every operand read as it lies:
//     ct_wg_conv_kernel for the conv and the transposed conv, ct_wg_wgrad_
//     kernel for dW = im2col(a_{k-1})^T dc, its split partials summed in
//     split order by gemm_wgmma.cuh's wg_reduce_kernel (tagged ConvTowerSrc),
//     with db from the dc pass's block sums. Operand A, the implicit im2col,
//     through a 3-D tensor map of the rows viewed [R, S, cin] (focal_wg_map3):
//     a tile is rb whole samples of sb positions (rb * sb <= 128 rows, 64 for
//     the weight gradient's K stages: MOD S 20 takes 6 samples, 120 rows;
//     S > 128 boxes of <= 128 positions, SampleTiles), and tap j's K stage is
//     the box at position s0 + j - lo (s0 - (j - lo) in the transposed conv):
//     TMA's zero fill of coordinates outside [0, S) is the SAME padding at
//     each sample's edges, with no im2col in memory and no predicate per
//     element. (TMA's im2col mode would do the same for a 4-D map; a tiled
//     3-D box of whole samples needs no [N, H, W, C] view and gives the
//     weight gradient its rows, K, as the same boxes.) Operand B, W viewed
//     [KW, cin, N]: a tap's K slice past cin reads zeros (cin < 64, e.g.
//     MOD_TINY's C 16, pads each tap's K to 64-channel blocks); the conv
//     reads it MN-major, the transposed conv K-major (wgmma's transpose
//     bit): no W^T pass. The rows of a tile past rb * sb, and of samples
//     past R, are out of the stores (TMA clips them) and of the column sums.
//   * the forward conv's epilogue adds the bias, rounds c to bf16 once,
//     stores it by TMA and adds the stored values' Σc and Σc² into the
//     persistent block's column sums (its tiles in order), one partial a
//     block: a fixed-order reduction that the card's SMs share.
//   * the transposed conv of layer k stores the rounded da_{k-1} and, in
//     the same epilogue, sums layer k-1's Σgy and Σgy·x̂ from it (with
//     c_{k-1}, its mask and BN rows: where the JAX tower takes them), so
//     only the last layer keeps its sums pass (bn_grad_sums_kernel).
//   * the cross-block sums (bn_stats_sliced_kernel, bn_grad_stats_sliced_
//     kernel, wg_reduce_kernel's column part) walk the partials in eight
//     slices of consecutive partials, a warp a slice and 32 channels a
//     block, then add the slices in order: no float atomics, two calls give
//     the same bits, and over several data ranks the raw sums still reach
//     the caller, which sums them over `data` before the [C]-sized steps.
// A first conv over cin % 8 != 0 (the seismic cin 2, the mod_extractor's
// cin 1) stays on the CUDA cores in bf16 (narrow_*_kernel<bf16>). Every
// layer after the first has cin = C, a multiple of 8 (check_rows), so it
// runs on the tensor cores. The f32 forms above are untouched by them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "gemm_3xtf32.cuh"
#include "gemm_splitk.cuh"
#include "gemm_wgmma.cuh"

namespace focal {
struct ConvTowerSrc {};  // tags this library's instances of gemm_splitk.cuh's and
                         // gemm_wgmma.cuh's kernels
}  // namespace focal

namespace {

using Src = focal::ConvTowerSrc;
namespace wgk = focal::wg;
using bf16 = __nv_bfloat16;
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
// channels); T, the rows' type, is float or bf16 (#13-bf16, #14-bf16).
template <class T>
struct BnArgs {
  const T* c;          // the conv output c_k [RS, C]
  const T* da;         // dL/da_k [RS, C] (backward)
  const float* rows;   // [5, C]: A, B, P, Q, scale
  const float* m;      // [2, C]: m0, m1 (backward)
  const float* mask;   // [M, C]; row g takes mask[g / S / group]
  const T* aprev;      // the residual a_{k-1} [RS, C], or null (forward)
  T* out;              // a_k (forward) or dc (backward) [RS, C]
  int R, S, C, group;
};

// Four consecutive channels: the elementwise passes and the column sums
// move 16 bytes (f32) or 8 bytes (bf16) a thread (C % 4 == 0; every array
// they read or write is 16-byte aligned).
struct F4 {
  float v[4];
};

__device__ __forceinline__ F4 ld4(const float* base, size_t i4) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(base) + i4);
  return {{t.x, t.y, t.z, t.w}};
}

__device__ __forceinline__ F4 ld4(const bf16* base, size_t i4) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(base) + i4);
  return {{__uint_as_float(t.x << 16), __uint_as_float(t.x & 0xffff0000u),
           __uint_as_float(t.y << 16), __uint_as_float(t.y & 0xffff0000u)}};
}

__device__ __forceinline__ void st4(float* base, size_t i4, const F4& f) {
  reinterpret_cast<float4*>(base)[i4] = make_float4(f.v[0], f.v[1], f.v[2], f.v[3]);
}

__device__ __forceinline__ void st4(bf16* base, size_t i4, const F4& f) {
  reinterpret_cast<uint2*>(base)[i4] =
      make_uint2(wgk::pack_bf16(f.v[0], f.v[1]), wgk::pack_bf16(f.v[2], f.v[3]));
}

// v as a T row stores it (bf16: rounded to nearest even), in f32.
__device__ __forceinline__ float stored(float v, const float*) { return v; }
__device__ __forceinline__ float stored(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// The mask of row g at channels 4 c4 .. 4 c4 + 3.
template <class T>
__device__ __forceinline__ F4 mask4(const BnArgs<T>& p, int g, int c4) {
  return ld4(p.mask + (size_t)(g / p.S / p.group) * p.C, c4);
}

// dc = P (gy scale - m0 - x̂ m1), gy = da * mask * GELU'(c A + B), at row g,
// channels 4 c4 .. 4 c4 + 3 (element e / 4).
template <class T>
__device__ __forceinline__ F4 bn_dc4(const BnArgs<T>& p, size_t e, int g, int c4) {
  const F4 c = ld4(p.c, e), da = ld4(p.da, e), mk = mask4(p, g, c4);
  const F4 A = ld4(p.rows, c4), B = ld4(p.rows + p.C, c4);
  const F4 P = ld4(p.rows + 2 * p.C, c4), Q = ld4(p.rows + 3 * p.C, c4);
  const F4 sc = ld4(p.rows + 4 * p.C, c4), m0 = ld4(p.m, c4), m1 = ld4(p.m + p.C, c4);
  F4 o;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float gy = da.v[u] * mk.v[u] * gelu_grad(fmaf(c.v[u], A.v[u], B.v[u]));
    const float xhat = fmaf(c.v[u], P.v[u], -Q.v[u]);
    o.v[u] = P.v[u] * (gy * sc.v[u] - m0.v[u] - xhat * m1.v[u]);
  }
  return o;
}

// out over all RS*C elements, four channels a thread: a_k = GELU(c A + B)
// * mask (+ a_{k-1}) (kBackward false) or dc (bn_dc4), stored as T rows.
template <bool kBackward, class T>
__global__ void __launch_bounds__(kThreads) bn_elementwise_kernel(const BnArgs<T> p) {
  const int C4 = p.C / 4;
  const size_t total = (size_t)p.R * p.S * C4;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int g = (int)(e / C4), c4 = (int)(e - (size_t)g * C4);
    F4 o;
    if (!kBackward) {
      const F4 c = ld4(p.c, e), A = ld4(p.rows, c4), B = ld4(p.rows + p.C, c4);
      const F4 mk = mask4(p, g, c4);
#pragma unroll
      for (int u = 0; u < 4; ++u) o.v[u] = gelu(fmaf(c.v[u], A.v[u], B.v[u])) * mk.v[u];
      if (p.aprev != nullptr) {
        const F4 a = ld4(p.aprev, e);
#pragma unroll
        for (int u = 0; u < 4; ++u) o.v[u] += a.v[u];
      }
    } else {
      o = bn_dc4(p, e, g, c4);
    }
    st4(p.out, e, o);
  }
}

// The column sums of a block of kStatRows rows, four columns a thread:
// threads are (lane, col) pairs, cols = min(K / 4, kThreads) groups of
// four columns and lanes = kThreads / cols; a thread sums its group c4
// over rows g_begin + lane, + lanes, ... in order (f(g, c4, s1, s2) adds
// to its two sums), and the lanes' sums are added in lane order into
// part[blockIdx.x] [2, K] (kRows 1: the first sum alone, [1, K]). red holds
// column_sums_smem(K) bytes.
template <int kRows = 2, class F>
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
    part[(size_t)blockIdx.x * kRows * K + ch] = t1;
    if (kRows == 2) part[((size_t)blockIdx.x * 2 + 1) * K + ch] = t2;
  }
}

size_t column_sums_smem(int K) {
  return (size_t)2 * (kThreads / std::min(K / 4, kThreads)) * K * sizeof(float);
}

// Per block of kStatRows rows: Σgy and Σgy·x̂ per channel, into part[block].
template <class T>
__global__ void __launch_bounds__(kThreads) bn_grad_sums_kernel(const BnArgs<T> p,
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

// #14-bf16's dc pass: dc (bn_dc4) stored as bf16 rows into p.out, and per
// block of kStatRows rows the column sums of the f32 dc (the conv bias's
// gradient db, before dc is rounded) into part[block] [C] (wg_reduce_kernel
// sums them into db).
__global__ void __launch_bounds__(kThreads) bn_dc_sums_kernel(const BnArgs<bf16> p,
                                                              float* __restrict__ part) {
  extern __shared__ float red[];
  const int C4 = p.C / 4;
  const int g_begin = blockIdx.x * kStatRows;
  block_column_sums<1>(p.C, g_begin, min(p.R * p.S, g_begin + kStatRows), red, part,
                    [&](int g, int c4, F4& s1, F4&) {
                      const size_t e = (size_t)g * C4 + c4;
                      const F4 dc = bn_dc4(p, e, g, c4);
                      st4(p.out, e, dc);
#pragma unroll
                      for (int u = 0; u < 4; ++u) s1.v[u] += dc.v[u];
                    });
}

// The BatchNorm of a conv's output: its affine (scale, bias [C]) in; the
// coefficients rows [5, C] and the batch mean and biased variance [C] out.
// With scale null (several data ranks, whose sums the caller adds and
// finalises at the global count): the raw sums [Σc; Σc²] into rows [2, C]
// alone.
struct BnStats {
  const float* scale;
  const float* bias;
  float* rows;
  float* mu;
  float* var;
};

// Channel ch's statistics from its sums s1 = Σc, s2 = Σc² over n rows: mu
// = s1 / n, var = max(s2 / n - mu², 0) (the fast variance), invstd =
// rsqrt(var + eps) and rows = [A = invstd scale; B = bias - mu A; P =
// invstd; Q = mu invstd; scale], each step rounded on its own as the plain
// version's torch ops round it; with st.scale null the raw sums.
__device__ __forceinline__ void finish_stats(const BnStats& st, int ch, int C, float n, float s1,
                                             float s2) {
  if (st.scale == nullptr) {
    st.rows[ch] = s1;
    st.rows[C + ch] = s2;
    return;
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

// One thread a channel: the ordered sum of a forward conv's column-sum
// partials [tiles, 2, C], then finish_stats (the f32 forms).
__global__ void bn_stats_kernel(const float* __restrict__ part, int tiles, int C, float n,
                                const BnStats st) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= C) return;
  float s1 = 0.f, s2 = 0.f;
  for (int t = 0; t < tiles; ++t) {
    s1 += part[(size_t)t * 2 * C + ch];
    s2 += part[((size_t)t * 2 + 1) * C + ch];
  }
  finish_stats(st, ch, C, n, s1, s2);
}

// Channel ch of s2 = [Σgy; Σgy·x̂] from its sums t1, t2, and m = s2 scale /
// n (the means of dx̂ and dx̂·x̂) where m is not null (several data ranks:
// the caller sums s2 over them first).
__device__ __forceinline__ void finish_grad_stats(int ch, int C, float n, const float* rows,
                                                  float* s2, float* m, float t1, float t2) {
  const float sc = rows[4 * C + ch];
  s2[ch] = t1;
  s2[C + ch] = t2;
  if (m == nullptr) return;
  m[ch] = __fmul_rn(t1, sc) / n;
  m[C + ch] = __fmul_rn(t2, sc) / n;
}

// One thread a channel: the ordered sum of the backward's column-sum
// partials [blocks, 2, C], then finish_grad_stats (the f32 forms).
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
  finish_grad_stats(ch, C, n, rows, s2, m, t1, t2);
}

// The bf16 forms' cross-block sums: partials [parts, 2, C] of channel ch =
// 32 blockIdx.x + lane summed in kSlices slices of consecutive partials
// (warp w the w-th, in order), then the slices added in order by warp 0.
// True in warp 0 for ch < C, with the sums; call with kSlices warps.
constexpr int kSlices = 8;

__device__ __forceinline__ bool sliced_sums(const float* __restrict__ part, int parts, int C,
                                            float& s1, float& s2) {
  __shared__ float red[2][kSlices][32];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int ch = blockIdx.x * 32 + lane;
  const int per = (parts + kSlices - 1) / kSlices;
  float a = 0.f, b = 0.f;
  if (ch < C) {
    const int t_end = min(parts, (slice + 1) * per);
#pragma unroll 4
    for (int t = slice * per; t < t_end; ++t) {
      a += part[(size_t)t * 2 * C + ch];
      b += part[((size_t)t * 2 + 1) * C + ch];
    }
  }
  red[0][slice][lane] = a;
  red[1][slice][lane] = b;
  __syncthreads();
  if (slice != 0 || ch >= C) return false;
  s1 = s2 = 0.f;
  for (int k = 0; k < kSlices; ++k) {
    s1 += red[0][k][lane];
    s2 += red[1][k][lane];
  }
  return true;
}

// #13-bf16's statistics: sliced_sums of a forward conv's partials, then
// finish_stats.
__global__ void __launch_bounds__(kSlices * 32)
bn_stats_sliced_kernel(const float* __restrict__ part, int parts, int C, float n, const BnStats st) {
  float s1, s2;
  if (sliced_sums(part, parts, C, s1, s2))
    finish_stats(st, blockIdx.x * 32 + (threadIdx.x & 31), C, n, s1, s2);
}

// #14-bf16's: sliced_sums of the backward's partials (the last layer's sums
// pass, or the fold of the transposed conv after it), then
// finish_grad_stats.
__global__ void __launch_bounds__(kSlices * 32)
bn_grad_stats_sliced_kernel(const float* __restrict__ part, int parts, int C, float n,
                            const float* __restrict__ rows, float* __restrict__ s2,
                            float* __restrict__ m) {
  float t1, t2;
  if (sliced_sums(part, parts, C, t1, t2))
    finish_grad_stats(blockIdx.x * 32 + (threadIdx.x & 31), C, n, rows, s2, m, t1, t2);
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

// v0, v1 stored at out + e (e even) as the output's type; v0, v1 become the
// values as stored (bf16: rounded to nearest even).
__device__ __forceinline__ void store_pair(float* out, size_t e, float& v0, float& v1) {
  *reinterpret_cast<float2*>(out + e) = make_float2(v0, v1);
}

// A conv product's epilogue over the block's tile (row tile tile_m, columns
// n0 ..): out = acc + bias (+ add) in the output's type T, fragment element
// (row g or g + 8, column 2t or 2t + 1) of lane 4g + t (gemm_for_each_output's
// order), and with part the tile's column sums of the stored out and out^2
// into part[tile_m] [2, N]: over the 8 lanes of a column a fixed butterfly,
// then the two warps of a column block in order, through red (4 kBN floats
// of the block's shared memory, free once every warp is done with its
// products).
template <int kBN, class T>
__device__ __forceinline__ void conv_epilogue(const float (&acc)[4][focal::gemm_nt<kBN>()][4],
                                              const float* bias, const T* add, T* out, float* part,
                                              int M, int N, int m0, int n0, int tile_m,
                                              float* red) {
  constexpr int kNT = focal::gemm_nt<kBN>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = m0 + (warp >> 2) * 64, wc = (warp & 3) * (kBN / 4);
  float s1[kNT][2], s2[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = n0 + wc + nt * 8 + 2 * t;
    s1[nt][0] = s1[nt][1] = s2[nt][0] = s2[nt][1] = 0.f;
    if (col >= N) continue;  // N % 4 == 0 (8 in bf16): col + 1 lies inside with col
    const float b0 = bias ? __ldg(bias + col) : 0.f;
    const float b1 = bias ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm + mt * 16 + g + 8 * half;
        if (row >= M) continue;
        const size_t e = (size_t)row * N + col;
        float v0 = acc[mt][nt][2 * half] + b0, v1 = acc[mt][nt][2 * half + 1] + b1;
        if (add) {
          v0 += to_f32(add[e]);
          v1 += to_f32(add[e + 1]);
        }
        store_pair(out, e, v0, v1);
        s1[nt][0] += v0;
        s1[nt][1] += v1;
        s2[nt][0] = fmaf(v0, v0, s2[nt][0]);
        s2[nt][1] = fmaf(v1, v1, s2[nt][1]);
      }
  }
  if (part == nullptr) return;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[nt][u] += __shfl_xor_sync(0xffffffffu, s1[nt][u], off);
        s2[nt][u] += __shfl_xor_sync(0xffffffffu, s2[nt][u], off);
      }
  __syncthreads();  // every warp is done with the products: red's words hold the sums now
  if (g == 0) {  // red: [2 warp rows][s1, s2][kBN]
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
  if (c < kBN && n0 + c < N) {
    part[(size_t)tile_m * 2 * N + n0 + c] = red[c] + red[2 * kBN + c];
    part[((size_t)tile_m * 2 + 1) * N + n0 + c] = red[kBN + c] + red[3 * kBN + c];
  }
}

template <int kBN>
__global__ void __launch_bounds__(kThreads, kBN == 64 ? 2 : 1)
conv_gemm_kernel(const ConvGemmArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tiles_n = (p.N + kBN - 1) / kBN;
  const int tile_m = blockIdx.x / tiles_n;
  const int m0 = tile_m * focal::kGemmBM, n0 = (blockIdx.x % tiles_n) * kBN;
  float acc[4][focal::gemm_nt<kBN>()][4], csum = 0.f;
  focal::gemm_tile_staged<false, false, kBN>(
      focal::ConvStage<kBN>(p.a, p.w, p.M, p.N, m0, n0, p.K), 0, p.K, smem, acc, csum);
  conv_epilogue<kBN>(acc, p.bias, p.add, p.out, p.part, p.M, p.N, m0, n0, tile_m, smem);
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
template <class T>
__global__ void tap_transpose_kernel(const T* __restrict__ w, int KW, int cin, int C,
                                     T* __restrict__ wt) {
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
// the bf16 products (#13-bf16, #14-bf16) on gemm_wgmma.cuh's TMA ring and
// wgmma

// Row tiles of whole samples of rows [R, S, C]: a tile is rb samples of sb
// positions (rb * sb <= the tile's rows), one box (64 channels, sb, rb) of
// a 3-D tensor map; where a sample is longer than the tile's rows it is cut
// into s_tiles boxes of sb positions (rb 1). Tile t starts at sample r0(t)
// and position s0(t); its row q < rb * sb is sample r0 + q / sb, position
// s0 + q % sb. The rows past rb * sb, and those of samples past R or
// positions past S, belong to no output.
struct SampleTiles {
  int rb, sb, s_tiles, r_tiles;
  __host__ __device__ int tiles() const { return r_tiles * s_tiles; }
  __host__ __device__ int rows() const { return rb * sb; }
  __host__ __device__ int r0(int t) const { return t / s_tiles * rb; }
  __host__ __device__ int s0(int t) const { return t % s_tiles * sb; }
};

SampleTiles sample_tiles(int R, int S, int rows) {
  SampleTiles t{};
  if (S <= rows) {
    t.sb = S;
    t.rb = std::min(rows / S, R);
    t.s_tiles = 1;
  } else {
    t.s_tiles = (S + rows - 1) / rows;
    t.sb = (S + t.s_tiles - 1) / t.s_tiles;
    t.rb = 1;
  }
  t.r_tiles = (R + t.rb - 1) / t.rb;
  return t;
}

// A bf16 conv's or transposed conv's plan over N output channels on `sms`
// SMs: 128-row tiles of whole samples, bn-wide column tiles (128 where N is
// a multiple of 128, else 64), and per column tile per_n persistent blocks,
// each summing its tiles' columns into one partial: per_n column-sum
// partials [per_n, 2, N].
struct ConvPlan16 {
  SampleTiles st;
  int bn, tiles_n, per_n;
};

ConvPlan16 conv_plan16(int R, int S, int N, int sms) {
  ConvPlan16 P{};
  P.st = sample_tiles(R, S, wgk::kBM);
  P.bn = N % 128 == 0 ? 128 : 64;
  P.tiles_n = (N + P.bn - 1) / P.bn;
  P.per_n = std::max(1, std::min(P.st.tiles(), sms / P.tiles_n));
  return P;
}

// A bf16 weight gradient's plan, dW = im2col(x)^T dc [kw * cin, N]: K
// stages of whole samples (up to 64 rows; a stage's rows past them stay
// zero), dW's rows padded per tap to cb 64-channel blocks (m_pad = kw * cb
// * 64 rows, those past cin dropped), bn-wide columns, wtiles output tiles,
// and the stages in `splits` runs of per_split (gemm_wgmma.cuh's
// wgrad_splits over 64-row stages).
struct WgradPlan16 {
  SampleTiles st;
  int cb, m_pad, bn, tn, wtiles, per_split, splits;
};

WgradPlan16 wgrad_plan16(int R, int S, int cin, int N, int kw, int sms) {
  WgradPlan16 W{};
  W.st = sample_tiles(R, S, wgk::kBK);
  W.cb = (cin + 63) / 64;
  W.m_pad = kw * W.cb * 64;
  W.bn = N % 128 == 0 ? 128 : 64;
  W.tn = (N + W.bn - 1) / W.bn;
  W.wtiles = wgk::wgrad_tiles(W.m_pad, N, W.bn);
  const wgk::WgradSplits sp = wgk::wgrad_splits(W.st.tiles() * wgk::kBK, W.wtiles, sms);
  W.per_split = sp.rows_per_split / wgk::kBK;
  W.splits = sp.splits;
  return W;
}

// A bf16 conv (sign +1: out = im2col(x) W + bias) or transposed conv (sign
// -1: out = convT(x, W) (+ add)) of rows x [R, S, cx] into out [R, S, N],
// rounded to bf16 once; K is kw taps of cb 64-channel blocks of x. With
// part, each persistent block's column sums over its tiles into part[i]
// [2, N] (i the block's place in its column tile): the conv's Σout and
// Σout² of the stored values, or, with c (the transposed conv of layer k),
// layer k-1's Σgy and Σgy·x̂ from the stored out, its da (gy = da *
// mask * GELU'(c A + B), x̂ = c P - Q with layer k-1's c, mask and BN rows).
struct ConvArgs16 {
  SampleTiles st;
  int R, S, N, tiles_n;
  int cb, kw, lo, sign;
  const float* bias;   // [N], or null
  const bf16* add;     // [R S, N], or null
  float* part;         // [per_n, 2, N], or null
  const bf16* c;       // layer k-1's c [R S, N], or null
  const float* mask;   // its mask [M, N]: row r takes mask[r / group]
  const float* rows;   // its BN rows [5, N]
  int group;
};

// The shared memory of ct_wg_conv_kernel: the ring, a 1 KB page for its
// barriers (and the epilogue's two), the staged output tile, in the
// transposed conv (kT) the tile of layer k-1's c, and the blocks'
// column-sum exchange.
template <int kBN, bool kT>
struct ConvSmem16 {
  static constexpr int kStages = kBN == 128 ? (kT ? 4 : 5) : 7;
  static constexpr size_t kTile = (size_t)wgk::kBM * kBN * 2;
  static constexpr size_t kStaged =
      (size_t)kStages * wgk::Ring<kBN, false, false, kStages>::kStageBytes + 1024;
  static constexpr size_t kC = kStaged + kTile;
  static constexpr size_t kRed = kC + (kT ? kTile : 0);
  static constexpr size_t kBytes = 1024 + kRed + (size_t)8 * 2 * kBN * sizeof(float);
};

struct ConvJob16 {
  int t, tile, n0, k_tiles;  // launch tile t: row tile `tile`, columns from n0
};

// The bf16 pair at (row, col) of a tile staged for TMA (kBM-row boxes of
// 64 columns, 128-byte swizzle: gemm_wgmma.cuh's stage_pair).
__device__ __forceinline__ uint32_t* staged_pair(uint8_t* tile, int row, int col) {
  return reinterpret_cast<uint32_t*>(tile + (col >> 6) * (wgk::kBM * 128) + row * 128 +
                                     ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2);
}

// Persistent blocks over the row tiles x column tiles (a block keeps one
// column tile: the grid is per_n * tiles_n), each tile's K stages tap by
// tap and 64-channel block by block: A the box of x at the tap's shifted
// position (zeros outside the sample), B W's tap slice, MN-major (the conv:
// B [cin, N] as it lies) or K-major (kT, the transposed conv: B^T [N = cin,
// C] as it lies). In the transposed conv the producer also loads, after a
// tile's stages, the tile's residual (into the staged output tile, added in
// place) and layer k-1's c (the fold's) by TMA through mda and mc (the
// barriers efull, and efree once the last tile's store has read them), so
// that the epilogue reads them from shared memory. The epilogue rounds the
// tile once, stores it by TMA and adds its rows' sums into the thread's
// running sums; the block's last tile reduces them (a fixed butterfly over
// each warp's row groups, then the eight warps in order) into its partial.
template <int kBN, bool kT>
__global__ void __launch_bounds__(wgk::kThreads, 1)
ct_wg_conv_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                  const __grid_constant__ CUtensorMap mout, const __grid_constant__ CUtensorMap mda,
                  const __grid_constant__ CUtensorMap mc, const ConvArgs16 p) {
  using Sm = ConvSmem16<kBN, kT>;
  constexpr int kCols = kBN / 4;  // a consumer thread's columns of a tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = wgk::align1024(smem_raw);
  uint8_t* staged = base + Sm::kStaged;
  uint8_t* ctile = base + Sm::kC;
  float* red = reinterpret_cast<float*>(base + Sm::kRed);
  // efull, efree: after the ring's 2 kStages barriers in its page
  uint64_t* ebar = reinterpret_cast<uint64_t*>(base + Sm::kStaged - 1024) + 2 * Sm::kStages;
  const bool fold = kT && p.c != nullptr, eload = kT && (p.add != nullptr || fold);
  const int tiles = p.st.tiles() * p.tiles_n, k_tiles = p.kw * p.cb;
  if (threadIdx.x == 0 && eload) {
    wgk::mbar_init(&ebar[0], 1);
    wgk::mbar_init(&ebar[1], 1);
  }
  float s1[kCols], s2[kCols];
  int et = 0;  // tiles done: the producer's (loads issued) and each consumer's (epilogues)
  auto plan = [&](int t) {
    return ConvJob16{t, t / p.tiles_n, t % p.tiles_n * kBN, k_tiles};
  };
  auto load = [&](const auto& ring, int s, const ConvJob16& j, int kt) {
    const int tap = kt / p.cb, c0 = kt % p.cb * 64;
    const int r0 = p.st.r0(j.tile), s0 = p.st.s0(j.tile);
    const int b_boxes = kT ? 1 : min(kBN / 64, (p.N - j.n0 + 63) / 64);
    wgk::mbar_expect_tx(&ring.full[s],
                        p.st.rows() * 128 + (kT ? kBN * 128 : b_boxes * wgk::kBoxBytes));
    wgk::tma_load3(ring.a(s), &mx, &ring.full[s], c0, s0 + p.sign * (tap - p.lo), r0);
    if (kT) {
      wgk::tma_load3(ring.b(s), &mw, &ring.full[s], c0, j.n0, tap);
    } else {
      for (int i = 0; i < b_boxes; ++i)
        wgk::tma_load3(ring.b(s) + i * wgk::kBoxBytes, &mw, &ring.full[s], j.n0 + 64 * i, c0, tap);
    }
  };
  auto after = [&](const ConvJob16& j) {
    if (!eload) return;
    if (et > 0) wgk::mbar_wait(&ebar[1], (et - 1) & 1);  // the last tile's store has read them
    const int r0 = p.st.r0(j.tile), s0 = p.st.s0(j.tile);
    const int boxes = min(kBN / 64, (p.N - j.n0 + 63) / 64);
    wgk::mbar_expect_tx(&ebar[0], boxes * p.st.rows() * 128 * ((p.add ? 1 : 0) + (fold ? 1 : 0)));
    for (int b = 0; b < boxes; ++b) {
      if (p.add) wgk::tma_load3(staged + b * wgk::kBM * 128, &mda, &ebar[0], j.n0 + 64 * b, s0, r0);
      if (fold) wgk::tma_load3(ctile + b * wgk::kBM * 128, &mc, &ebar[0], j.n0 + 64 * b, s0, r0);
    }
    ++et;
  };
  auto epi = [&](const ConvJob16& j, float (&acc)[kBN / 2]) {
    const wgk::Frag f;
    const int r0 = p.st.r0(j.tile), s0 = p.st.s0(j.tile);
    if (j.t == (int)blockIdx.x) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) s1[c] = s2[c] = 0.f;
    }
    // the thread's two rows: whether they hold outputs and their sample's
    // mask row
    bool in[2];
    int mrow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = f.row0 + 8 * h, rl = q / p.st.sb, r = r0 + rl, s = s0 + q - rl * p.st.sb;
      in[h] = q < p.st.rows() && r < p.R && s < p.S;
      mrow[h] = fold && in[h] ? r / p.group : 0;
    }
    if (threadIdx.x == 0) wgk::tma_store_wait_read();
    if (eload) wgk::mbar_wait(&ebar[0], et & 1);  // the tile's residual and c are staged
    ++et;
    wgk::consumers_sync();
    // kGroup column groups of 8 at a time: their global loads (L1-resident
    // bias, BN rows and mask) first, at addresses inside the arrays, so
    // that they issue together, then their math
    constexpr int kGroup = 4;
#pragma unroll
    for (int j0 = 0; j0 < kBN / 8; j0 += kGroup) {
      float2 mk[kGroup][2], cf[kGroup][4];  // the mask; bias, or A, B, P, Q
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const int n = j.n0 + f.col(4 * (j0 + jj)), nn = n < p.N ? n : 0;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mk[jj][h] = fold ? __ldg(reinterpret_cast<const float2*>(p.mask + (size_t)mrow[h] * p.N +
                                                                   nn))
                           : make_float2(0.f, 0.f);
        if (!kT) {
          cf[jj][0] = make_float2(__ldg(p.bias + nn), __ldg(p.bias + nn + 1));
        } else if (fold) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            cf[jj][k] = __ldg(reinterpret_cast<const float2*>(p.rows + (size_t)k * p.N + nn));
        }
      }
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c2 = 2 * (j0 + jj), i = 4 * (j0 + jj) + 2 * h, n = j.n0 + f.col(i);
          const bool on = in[h] && n < p.N;  // N % 8 == 0: n + 1 lies inside with n
          uint32_t* at = staged_pair(staged, f.row(i), f.col(i));
          float v0 = acc[i], v1 = acc[i + 1];
          if (!kT) {
            v0 += cf[jj][0].x;
            v1 += cf[jj][0].y;
          } else if (p.add) {
            const uint32_t d = *at;
            v0 += __uint_as_float(d << 16);
            v1 += __uint_as_float(d & 0xffff0000u);
          }
          const uint32_t packed = wgk::pack_bf16(v0, v1);
          *at = packed;
          if (!on || p.part == nullptr) continue;
          const float o[2] = {__uint_as_float(packed << 16), __uint_as_float(packed & 0xffff0000u)};
          if (!kT) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              s1[c2 + u] += o[u];
              s2[c2 + u] = fmaf(o[u], o[u], s2[c2 + u]);
            }
          } else {
            const uint32_t cc = *staged_pair(ctile, f.row(i), f.col(i));
            const float c[2] = {__uint_as_float(cc << 16), __uint_as_float(cc & 0xffff0000u)};
            const float m[2] = {mk[jj][h].x, mk[jj][h].y};
            const float A[2] = {cf[jj][0].x, cf[jj][0].y}, B[2] = {cf[jj][1].x, cf[jj][1].y};
            const float P[2] = {cf[jj][2].x, cf[jj][2].y}, Q[2] = {cf[jj][3].x, cf[jj][3].y};
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float gy = o[u] * m[u] * gelu_grad(fmaf(c[u], A[u], B[u]));
              s1[c2 + u] += gy;
              s2[c2 + u] = fmaf(gy, fmaf(c[u], P[u], -Q[u]), s2[c2 + u]);
            }
          }
        }
      }
    }
    wgk::fence_async_smem();
    wgk::consumers_sync();  // the tile is staged
    if (threadIdx.x == 0) {
#pragma unroll
      for (int b = 0; b < kBN / 64; ++b)
        if (j.n0 + 64 * b < p.N)
          wgk::tma_store3(&mout, staged + b * wgk::kBM * 128, j.n0 + 64 * b, s0, r0);
      wgk::tma_store_commit();
      if (eload) {  // the staged tile and c free for the next tile's loads
        wgk::tma_store_wait_read();
        wgk::mbar_arrive(&ebar[1]);
      }
    }
    if (p.part == nullptr || j.t + (int)gridDim.x < tiles) return;
    // the block's last tile: its partial
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[c] += __shfl_xor_sync(0xffffffffu, s1[c], off);
        s2[c] += __shfl_xor_sync(0xffffffffu, s2[c], off);
      }
    if (lane < 4) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = f.col0 + 8 * (c / 2) + c % 2;
        red[(2 * warp) * kBN + col] = s1[c];
        red[(2 * warp + 1) * kBN + col] = s2[c];
      }
    }
    wgk::consumers_sync();
    const int n = j.n0 + (int)threadIdx.x;
    if ((int)threadIdx.x < kBN && n < p.N) {
      float t1 = 0.f, t2 = 0.f;
      for (int w = 0; w < 8; ++w) {
        t1 += red[(2 * w) * kBN + threadIdx.x];
        t2 += red[(2 * w + 1) * kBN + threadIdx.x];
      }
      const size_t i = blockIdx.x / p.tiles_n;
      p.part[i * 2 * p.N + n] = t1;
      p.part[(i * 2 + 1) * p.N + n] = t2;
    }
  };
  wgk::streamed_tiles_by<kBN, false, !kT, Sm::kStages>(smem_raw, tiles, plan, load, epi, after);
  if (threadIdx.x == 0) wgk::tma_store_wait_read();  // the last store has left shared memory
}

// dW = im2col(x)^T dc over a split's K stages, into its partial part + split
// kw cin N (the rows of dW past cin in a tap dropped): A the boxes of x at
// each 64-row block of dW's tap-shifted channels, B dc's box, both MN-major
// as they lie (rows are K).
struct WgradArgs16 {
  WgradPlan16 w;
  int kw, cin, N, lo;
  float* part;  // [splits, kw cin, N]
};

struct WgradJob16 {
  int m0, n0, b0, k_tiles, split;
};

template <int kBN>
__global__ void __launch_bounds__(wgk::kThreads, 1)
ct_wg_wgrad_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mdc,
                   const WgradArgs16 p) {
  constexpr int kStages = wgk::kStreamStages<kBN>;
  extern __shared__ uint8_t smem_raw[];
  const WgradPlan16& w = p.w;
  {  // zeros in every stage: a stage's K rows past w.st.rows() are never loaded
    uint4* z = reinterpret_cast<uint4*>(wgk::align1024(smem_raw));
    const int words = kStages * wgk::Ring<kBN, true, true, kStages>::kStageBytes / 16;
    for (int i = threadIdx.x; i < words; i += blockDim.x) z[i] = make_uint4(0u, 0u, 0u, 0u);
    wgk::fence_async_smem();
  }
  const int tap_rows = w.cb * 64;
  auto plan = [&](int t) {
    const int split = t / w.wtiles, tt = t % w.wtiles, b0 = split * w.per_split;
    return WgradJob16{tt / w.tn * wgk::kBM, tt % w.tn * kBN, b0,
                      min(w.st.tiles(), b0 + w.per_split) - b0, split};
  };
  auto load = [&](const auto& ring, int s, const WgradJob16& j, int kt) {
    const int b = j.b0 + kt, r0 = w.st.r0(b), s0 = w.st.s0(b);
    const int a_boxes = j.m0 + 64 < w.m_pad ? 2 : 1;
    const int b_boxes = min(kBN / 64, (p.N - j.n0 + 63) / 64);
    wgk::mbar_expect_tx(&ring.full[s], (a_boxes + b_boxes) * w.st.rows() * 128);
    for (int i = 0; i < a_boxes; ++i) {
      const int m = j.m0 + 64 * i, tap = m / tap_rows;
      wgk::tma_load3(ring.a(s) + i * wgk::kBoxBytes, &mx, &ring.full[s], m - tap * tap_rows,
                     s0 + tap - p.lo, r0);
    }
    for (int i = 0; i < b_boxes; ++i)
      wgk::tma_load3(ring.b(s) + i * wgk::kBoxBytes, &mdc, &ring.full[s], j.n0 + 64 * i, s0, r0);
  };
  auto epi = [&](const WgradJob16& j, float (&acc)[kBN / 2]) {
    const wgk::Frag f;
    float* out = p.part + (size_t)j.split * p.kw * p.cin * p.N;
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2) {
      const int mp = j.m0 + f.row(i), n = j.n0 + f.col(i);
      const int tap = mp / tap_rows, ci = mp - tap * tap_rows;
      if (mp >= w.m_pad || ci >= p.cin || n >= p.N) continue;
      *reinterpret_cast<float2*>(out + ((size_t)tap * p.cin + ci) * p.N + n) =
          make_float2(acc[i], acc[i + 1]);
    }
  };
  wgk::streamed_tiles_by<kBN, true, true, kStages>(smem_raw, w.splits * w.wtiles, plan, load, epi);
}

// ---------------------------------------------------------------------------
// the narrow first conv (cin % 4 != 0: the seismic input, cin 2; in bf16
// cin % 8 != 0), on the CUDA cores

// c = conv(x, w) + b [RS, N] from x [RS, cin], w [KW * cin, N] (T rows:
// c stored as T, f32 sums), and per block of kStatRows rows the column sums
// of the stored c and c^2 into part[block].
template <class T>
__global__ void __launch_bounds__(kThreads)
narrow_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ b, T* __restrict__ out, float* __restrict__ part,
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
                        const T* xr = x + (size_t)(g + d) * cin;
                        const T* wr = w + (size_t)j * cin * N + 4 * c4;
                        for (int ci = 0; ci < cin; ++ci) {
                          const float xv = to_f32(xr[ci]);
#pragma unroll
                          for (int u = 0; u < 4; ++u)
                            v.v[u] = fmaf(xv, to_f32(wr[(size_t)ci * N + u]), v.v[u]);
                        }
                      }
                      st4(out, (size_t)g * (N / 4) + c4, v);
#pragma unroll
                      for (int u = 0; u < 4; ++u) {
                        const float sv = stored(v.v[u], out);
                        s1.v[u] += sv;
                        s2.v[u] = fmaf(sv, sv, s2.v[u]);
                      }
                    });
}

// dx = convT(dc, w) [RS, cin] from dc [RS, C] and w [KW * cin, C] (T rows,
// f32 sums, dx stored as T): one warp a row, its lanes over the C channels
// of dc (w's rows are contiguous in them), summed by a fixed butterfly.
template <class T>
__global__ void __launch_bounds__(kThreads)
narrow_convT_kernel(const T* __restrict__ dc, const T* __restrict__ w,
                    T* __restrict__ dx, int RS, int S, int cin, int C, int KW) {
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
      const T* dr = dc + (size_t)(g + d) * C;
      const T* wr = w + ((size_t)j * cin + ci) * C;
      for (int co = lane; co < C; co += 32) v = fmaf(to_f32(dr[co]), to_f32(wr[co]), v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) put(dx + (size_t)g * cin + ci, v);
  }
}

// Split blockIdx.x: dW = im2col(x)^T dc [M = KW * cin, C] and, with
// `with_db`, db = Σ dc over the split's rows, into its partial [dW | db] (E
// floats; T rows, f32 sums). Threads are (lane, col) pairs, cols = min(C,
// kThreads) columns and lanes = kThreads / cols, a lane summing every
// lanes-th row; a pass sums kNarrowM rows of dW (and, in the first, db) and
// adds the lanes in order.
template <class T>
__global__ void __launch_bounds__(kThreads)
narrow_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dc, int RS, int S,
                    int cin, int C, int KW, int rows_per_split, float* __restrict__ part,
                    size_t E, bool with_db) {
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
          const float v = to_f32(dc[(size_t)g * C + ch]);
          const int s = g % S;
          acc[kNarrowM] += v;
#pragma unroll
          for (int u = 0; u < kNarrowM; ++u)
            if ((unsigned)(s + d[u]) < (unsigned)S)
              acc[u] = fmaf(to_f32(x[(size_t)g * cin + off[u]]), v, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u <= kNarrowM; ++u) red[u * kThreads + threadIdx.x] = acc[u];
      __syncthreads();
      if ((int)threadIdx.x < cols && ch < C) {
        for (int u = 0; u <= kNarrowM; ++u) {
          const int m = mb + u;
          if (u == kNarrowM ? mb != 0 || !with_db : m >= M) continue;
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

// Whether a conv over cin input channels runs on the tensor cores: a
// 16-byte piece of its rows (four f32 channels, eight bf16) within one tap.
bool on_tensor_cores(int cin, bool bf16) { return cin % (bf16 ? 8 : 4) == 0; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether every array of an elementwise pass or column sum is 16-byte
// aligned (they move four channels at a time).
template <class T>
bool bn_aligned(const BnArgs<T>& p) {
  const void* arrays[] = {p.c, p.da, p.rows, p.m, p.mask, p.aprev, p.out};
  for (const void* a : arrays)
    if (a != nullptr && !aligned16(a)) return false;
  return true;
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Floats of workspace that n bf16 values take, rounded up to 16 bytes.
size_t bf16_floats(size_t n) { return (n + 7) / 8 * 4; }

// The column-sum partials of an f32 forward conv over cin channels: one
// per 128-row tile of the product, or per kStatRows rows of the narrow conv.
int fwd_partials(int RS, int cin) {
  return on_tensor_cores(cin, false) ? ceil_div(RS, focal::kGemmBM) : ceil_div(RS, kStatRows);
}

// The same of a bf16 forward conv into cout channels: one per persistent
// block of the product (conv_plan16), or per kStatRows rows of the narrow
// conv.
int fwd_partials16(int R, int S, int cin, int cout, int sms) {
  return on_tensor_cores(cin, true) ? conv_plan16(R, S, cout, sms).per_n
                                    : ceil_div((long long)R * S, kStatRows);
}

// The weight gradient of an f32 layer (KW * cin x C, and db), or of a bf16
// narrow first conv (KW * cin x C: db comes from the dc pass): tile width,
// tiles, row splits and the partial size E. The product's splits fill the
// card about four times over (split_rows); the narrow one takes
// kStatRows-row splits the same way, as one tile.
struct WgradPlan {
  int bn, tiles, splits, rows_per_split;
  size_t E;
};

WgradPlan wgrad_plan(int RS, int cin, int C, int KW, int sms, bool bf16) {
  WgradPlan P{};
  P.E = (size_t)KW * cin * C + (bf16 ? 0 : C);
  int tiles_n = 0;
  if (on_tensor_cores(cin, bf16)) {
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

// The weight-gradient splits of a bf16 layer: wgrad_plan16's on the tensor
// cores, wgrad_plan's for a narrow first conv.
int wgrad_splits16(int R, int S, int cin, int C, int kw, int sms) {
  return on_tensor_cores(cin, true) ? wgrad_plan16(R, S, cin, C, kw, sms).splits
                                    : wgrad_plan(R * S, cin, C, kw, sms, true).splits;
}

// R rows of S positions with a mask of M rows (R % M == 0), and C channels
// (a multiple of 4: the products' outputs; of 8 in bf16, so that every
// layer after the first runs on the tensor cores): every element index
// R*S*C fits an int.
int check_rows(int R, int S, int M, int C, bool bf16) {
  if (R < 1 || S < 1 || M < 1 || R % M != 0 || !channels_ok(C) ||
      (long long)R * S * C >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  return C % (bf16 ? 8 : 4) == 0 ? 0 : (int)cudaErrorInvalidConfiguration;
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

// A bf16 conv (sign 1) or transposed conv (sign -1) on the TMA ring
// (ct_wg_conv_kernel) over rows x [R, S, cx]: w [kw * wrows, wcols] viewed
// [kw, wrows, wcols] (the conv's: cx = wrows, out [R, S, wcols]; the
// transposed conv's: cx = wcols, out [R, S, wrows]); a holds the bias, the
// residual, the partials and the fold. Each map encoded once a call.
int launch_conv16(const bf16* x, int cx, const bf16* w, int wrows, int wcols, int kw, int sign,
                  ConvArgs16 a, bf16* out, int R, int S, int sms, cudaStream_t s) {
  const int N = sign > 0 ? wcols : wrows;
  if (!aligned16(x) || !aligned16(w) || !aligned16(out) || (a.add && !aligned16(a.add)) ||
      (a.c && !aligned16(a.c)))
    return (int)cudaErrorMisalignedAddress;
  const ConvPlan16 P = conv_plan16(R, S, N, sms);
  // x, w, out; the residual and layer k-1's c (the transposed conv's
  // epilogue loads; out's map where there is none)
  CUtensorMap m[5];
  if (int e = wgk::map3(&m[0], x, R, S, cx, P.st.rb, P.st.sb)) return e;
  if (int e = wgk::map3(&m[1], w, kw, wrows, wcols, 1, sign > 0 ? 64 : P.bn)) return e;
  if (int e = wgk::map3(&m[2], out, R, S, N, P.st.rb, P.st.sb)) return e;
  m[3] = m[4] = m[2];
  if (a.add)
    if (int e = wgk::map3(&m[3], a.add, R, S, N, P.st.rb, P.st.sb)) return e;
  if (a.c)
    if (int e = wgk::map3(&m[4], a.c, R, S, N, P.st.rb, P.st.sb)) return e;
  a.st = P.st;
  a.R = R, a.S = S, a.N = N, a.tiles_n = P.tiles_n;
  a.cb = (cx + 63) / 64, a.kw = kw, a.lo = (kw - 1) / 2, a.sign = sign;
  const int grid = P.per_n * P.tiles_n;
  if (sign > 0)
    return P.bn == 128
               ? wgk::launch(ct_wg_conv_kernel<128, false>, grid, ConvSmem16<128, false>::kBytes, s,
                             m[0], m[1], m[2], m[3], m[4], a)
               : wgk::launch(ct_wg_conv_kernel<64, false>, grid, ConvSmem16<64, false>::kBytes, s,
                             m[0], m[1], m[2], m[3], m[4], a);
  return P.bn == 128
             ? wgk::launch(ct_wg_conv_kernel<128, true>, grid, ConvSmem16<128, true>::kBytes, s,
                           m[0], m[1], m[2], m[3], m[4], a)
             : wgk::launch(ct_wg_conv_kernel<64, true>, grid, ConvSmem16<64, true>::kBytes, s, m[0],
                           m[1], m[2], m[3], m[4], a);
}

// The split partials of a bf16 weight gradient im2col(x)^T dc, x [R, S,
// cin], dc [R, S, C], into part [splits, kw cin, C] (ct_wg_wgrad_kernel,
// persistent over min(tiles, sms) blocks). Returns the splits through
// *splits.
int launch_wgrad16(const bf16* x, int cin, const bf16* dc, int C, int kw, float* part, int R,
                   int S, int sms, int* splits, cudaStream_t s) {
  const WgradPlan16 W = wgrad_plan16(R, S, cin, C, kw, sms);
  *splits = W.splits;
  CUtensorMap m[2];
  if (int e = wgk::map3(&m[0], x, R, S, cin, W.st.rb, W.st.sb)) return e;
  if (int e = wgk::map3(&m[1], dc, R, S, C, W.st.rb, W.st.sb)) return e;
  const WgradArgs16 a{W, kw, cin, C, (kw - 1) / 2, part};
  const int grid = std::min(W.splits * W.wtiles, sms);
  return W.bn == 128 ? wgk::launch(ct_wg_wgrad_kernel<128>, grid,
                                   wgk::stream_smem<128, true, true>(), s, m[0], m[1], a)
                     : wgk::launch(ct_wg_wgrad_kernel<64>, grid, wgk::stream_smem<64, true, true>(),
                                   s, m[0], m[1], a);
}

template <class T>
int launch_elementwise(bool backward, const BnArgs<T>& p, cudaStream_t s) {
  if (!bn_aligned(p)) return (int)cudaErrorMisalignedAddress;
  int sms = 0;
  cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)p.R * p.S * p.C / 4;
  const unsigned blocks =
      (unsigned)std::max<size_t>(1, std::min((total + kThreads - 1) / kThreads, (size_t)sms * 8));
  if (backward)
    bn_elementwise_kernel<true, T><<<blocks, kThreads, 0, s>>>(p);
  else
    bn_elementwise_kernel<false, T><<<blocks, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// The first conv (or layer k+1's conv) of the forward over x [R S, cin]:
// c [R S, cout] and its BatchNorm's statistics and coefficients st,
// through ws (the column-sum partials). T: the rows' type. f32: the 3xTF32
// product (or the narrow conv) and bn_stats_kernel; bf16: the wgmma product
// (or the narrow conv) and bn_stats_sliced_kernel.
template <class T>
int conv_forward(const T* x, const T* w, const float* b, T* c, const BnStats& st, float* ws,
                 int R, int S, int cin, int cout, int kw, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int RS = R * S;
  cudaError_t err;
  int sms = 0;
  if (kBf16 && (err = device_sms(&sms)) != cudaSuccess) return (int)err;
  if (on_tensor_cores(cin, kBf16)) {
    if constexpr (kBf16) {
      ConvArgs16 a{};
      a.bias = b;
      a.part = ws;
      if (int e = launch_conv16(x, cin, w, cin, cout, kw, 1, a, c, R, S, sms, s)) return e;
      err = cudaSuccess;
    } else {
      err = launch_conv_gemm(x, cin, S, kw, 1, w, b, nullptr, c, ws, RS, cout, s);
    }
  } else {
    if (!aligned16(c)) return (int)cudaErrorMisalignedAddress;
    const size_t smem = column_sums_smem(cout);
    err = set_smem(narrow_conv_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    narrow_conv_kernel<T><<<ceil_div(RS, kStatRows), kThreads, smem, s>>>(x, w, b, c, ws, RS, S,
                                                                         cin, cout, kw);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  if (kBf16)
    bn_stats_sliced_kernel<<<ceil_div(cout, 32), kSlices * 32, 0, s>>>(
        ws, fwd_partials16(R, S, cin, cout, sms), cout, (float)RS, st);
  else
    bn_stats_kernel<<<ceil_div(cout, kThreads), kThreads, 0, s>>>(ws, fwd_partials(RS, cin), cout,
                                                                  (float)RS, st);
  return (int)cudaGetLastError();
}

template <class T>
int ct_conv0(const void* x, const void* w, const void* b, const BnStats& st, void* c, void* ws,
             int R, int S, int cin, int cout, int kw, cudaStream_t s) {
  return conv_forward(static_cast<const T*>(x), static_cast<const T*>(w),
                      static_cast<const float*>(b), static_cast<T*>(c), st,
                      static_cast<float*>(ws), R, S, cin, cout, kw, s);
}

template <class T>
int ct_apply(const void* c, const void* rows, const void* mask, const void* aprev, const void* w,
             const void* b, const BnStats& st, void* a, void* c_next, void* ws, int R, int S,
             int M, int C, int cout, int kw, cudaStream_t s) {
  BnArgs<T> p{};
  p.c = static_cast<const T*>(c);
  p.rows = static_cast<const float*>(rows);
  p.mask = static_cast<const float*>(mask);
  p.aprev = static_cast<const T*>(aprev);
  p.out = static_cast<T*>(a);
  p.R = R, p.S = S, p.C = C, p.group = R / M;
  int err = launch_elementwise(false, p, s);
  if (err || w == nullptr) return err;
  return conv_forward(static_cast<const T*>(p.out), static_cast<const T*>(w),
                      static_cast<const float*>(b), static_cast<T*>(c_next), st,
                      static_cast<float*>(ws), R, S, C, cout, kw, s);
}

// The backward sums: per-block partials (bn_grad_sums_kernel) then their
// ordered sum, or in bf16 with `folded` (the partials of layer k+1's
// transposed conv, conv_plan16's per_n of them) the ordered sum alone.
template <class T>
int ct_bwd_stats(const void* da, const void* c, const void* mask, const void* rows, void* s2,
                 void* m, void* ws, const void* folded, int R, int S, int M, int C,
                 cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  BnArgs<T> p{};
  p.c = static_cast<const T*>(c);
  p.da = static_cast<const T*>(da);
  p.rows = static_cast<const float*>(rows);
  p.mask = static_cast<const float*>(mask);
  p.R = R, p.S = S, p.C = C, p.group = R / M;
  cudaError_t e;
  const float* part = static_cast<const float*>(folded);
  int parts = 0;
  if (part != nullptr) {
    if (!kBf16) return (int)cudaErrorInvalidValue;
    int sms = 0;
    if ((e = device_sms(&sms)) != cudaSuccess) return (int)e;
    parts = conv_plan16(R, S, C, sms).per_n;
  } else {
    if (!bn_aligned(p)) return (int)cudaErrorMisalignedAddress;
    parts = ceil_div(R * S, kStatRows);
    const size_t smem = column_sums_smem(C);
    e = set_smem(bn_grad_sums_kernel<T>, smem);
    if (e != cudaSuccess) return (int)e;
    bn_grad_sums_kernel<T><<<parts, kThreads, smem, s>>>(p, static_cast<float*>(ws));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    part = static_cast<const float*>(ws);
  }
  if (kBf16)
    bn_grad_stats_sliced_kernel<<<ceil_div(C, 32), kSlices * 32, 0, s>>>(
        part, parts, C, (float)(R * S), p.rows, static_cast<float*>(s2), static_cast<float*>(m));
  else
    bn_grad_stats_kernel<<<ceil_div(C, kThreads), kThreads, 0, s>>>(
        part, parts, C, (float)(R * S), p.rows, static_cast<float*>(s2), static_cast<float*>(m));
  return (int)cudaGetLastError();
}

template <class T>
int ct_bwd_dc(const void* da, const void* c, const void* mask, const void* rows, const void* m,
              void* dc, int R, int S, int M, int C, cudaStream_t s) {
  BnArgs<T> p{};
  p.c = static_cast<const T*>(c);
  p.da = static_cast<const T*>(da);
  p.rows = static_cast<const float*>(rows);
  p.m = static_cast<const float*>(m);
  p.mask = static_cast<const float*>(mask);
  p.out = static_cast<T*>(dc);
  p.R = R, p.S = S, p.C = C, p.group = R / M;
  return launch_elementwise(true, p, s);
}

// #14's backward apply (focal_ct_bwd_apply's launches) on f32 rows. The
// workspace holds dc [RS, C], W's per-tap transpose, then the
// weight-gradient partials (dW beside db); dc in one elementwise pass.
int bwd_apply(const BnArgs<float>& p0, const float* w, const float* ap, float* dprev, float* dwb,
              float* ws, int R, int S, int C, int cin, int kw, int residual, int sms,
              cudaStream_t s) {
  const int RS = R * S;
  const bool tc = on_tensor_cores(cin, false);
  float* dc = ws;
  float* wt = ws + (size_t)RS * C;
  float* wpart = wt + (tc ? (size_t)kw * C * cin : 0);
  BnArgs<float> p = p0;
  p.out = dc;
  const WgradPlan W = wgrad_plan(RS, cin, C, kw, sms, false);
  cudaError_t e;
  if (int err = launch_elementwise(true, p, s)) return err;
  if (tc) {
    if (!aligned16(ap)) return (int)cudaErrorMisalignedAddress;
    const size_t n = (size_t)kw * C * cin;
    tap_transpose_kernel<float>
        <<<(unsigned)std::min<size_t>((n + kThreads - 1) / kThreads, sms * 8), kThreads, 0, s>>>(
            w, kw, cin, C, wt);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    e = launch_conv_gemm(dc, C, S, kw, -1, wt, nullptr, residual ? p.da : nullptr, dprev, nullptr,
                         RS, cin, s);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(W.tiles, W.splits);
    const focal::ShiftRows a{ap, cin, S, (kw - 1) / 2, 1};
    const size_t smem = focal::gemm_smem_bytes(W.bn);
    if (W.bn == 128) {
      if ((e = set_smem(conv_wgrad_kernel<128>, smem)) != cudaSuccess) return (int)e;
      conv_wgrad_kernel<128><<<grid, kThreads, smem, s>>>(a, dc, kw * cin, C, RS,
                                                         W.rows_per_split, wpart, W.E);
    } else {
      if ((e = set_smem(conv_wgrad_kernel<64>, smem)) != cudaSuccess) return (int)e;
      conv_wgrad_kernel<64><<<grid, kThreads, smem, s>>>(a, dc, kw * cin, C, RS,
                                                        W.rows_per_split, wpart, W.E);
    }
  } else {
    narrow_convT_kernel<float><<<ceil_div(RS, kThreads / 32), kThreads, 0, s>>>(dc, w, dprev, RS,
                                                                              S, cin, C, kw);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    narrow_wgrad_kernel<float><<<W.splits, kThreads, 0, s>>>(ap, dc, RS, S, cin, C, kw,
                                                             W.rows_per_split, wpart, W.E, true);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)focal::launch_reduce<Src>(wpart, W.splits, W.E, dwb, s);
}

// Layer k-1's arrays for the fold of layer k's transposed conv (bf16): its
// c, mask [M, cin] and BN rows, and where its Σgy, Σgy·x̂ partials go
// (null: no fold).
struct Fold16 {
  const bf16* c;
  const float* mask;
  const float* rows;
  float* part;
  int M;
};

// #14-bf16's backward apply: four launches. The dc pass (dc rounded to
// bf16, the f32 dc's block sums), the transposed conv on the TMA ring with
// the residual and the fold (or the narrow transposed conv of a first conv
// over cin % 8 != 0), the weight gradient's split partials (the wgmma
// product, or the narrow one), and wg_reduce_kernel: dW's splits summed in
// split order, db the block sums summed in slices. The workspace holds dc,
// the block sums [blocks, C] and the split partials [splits, kw cin C].
int bwd_apply16(const BnArgs<bf16>& p0, const bf16* w, const bf16* ap, bf16* dprev, float* dwb,
                float* ws, const Fold16& fold, int R, int S, int C, int cin, int kw, int residual,
                int sms, cudaStream_t s) {
  const int RS = R * S;
  const bool tc = on_tensor_cores(cin, true);
  if (fold.part && (!tc || fold.M < 1 || R % fold.M)) return (int)cudaErrorInvalidValue;
  const int blocks = ceil_div(RS, kStatRows);
  bf16* dc = reinterpret_cast<bf16*>(ws);
  float* dsum = ws + bf16_floats((size_t)RS * C);
  float* wpart = dsum + (size_t)blocks * C;
  BnArgs<bf16> p = p0;
  p.out = dc;
  if (!bn_aligned(p) || !aligned16(ap)) return (int)cudaErrorMisalignedAddress;
  cudaError_t e;
  const size_t smem = column_sums_smem(C);
  if ((e = set_smem(bn_dc_sums_kernel, smem)) != cudaSuccess) return (int)e;
  bn_dc_sums_kernel<<<blocks, kThreads, smem, s>>>(p, dsum);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  int splits = 0;
  if (tc) {
    ConvArgs16 a{};
    a.add = residual ? p.da : nullptr;
    if (fold.part) {
      a.part = fold.part;
      a.c = fold.c;
      a.mask = fold.mask;
      a.rows = fold.rows;
      a.group = R / fold.M;
    }
    if (int err = launch_conv16(dc, C, w, cin, C, kw, -1, a, dprev, R, S, sms, s)) return err;
    if (int err = launch_wgrad16(ap, cin, dc, C, kw, wpart, R, S, sms, &splits, s)) return err;
  } else {
    const WgradPlan W = wgrad_plan(RS, cin, C, kw, sms, true);
    narrow_convT_kernel<bf16><<<ceil_div(RS, kThreads / 32), kThreads, 0, s>>>(dc, w, dprev, RS, S,
                                                                             cin, C, kw);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    narrow_wgrad_kernel<bf16><<<W.splits, kThreads, 0, s>>>(ap, dc, RS, S, cin, C, kw,
                                                            W.rows_per_split, wpart, W.E, false);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    splits = W.splits;
  }
  const wgk::ReduceArgs r{wpart, dsum, nullptr, nullptr, dwb, nullptr, splits, blocks,
                          kw * cin, C, 0, 0, 0};
  return wgk::launch_reduce<Src>(r, s);
}

int ct_bwd_apply(const void* da, const void* c, const void* mask, const void* rows, const void* m,
                 const void* aprev, const void* w, void* dprev, void* dwb, void* ws,
                 const Fold16& fold, int R, int S, int M, int C, int cin, int kw, int residual,
                 int bf16_rows, int sms, cudaStream_t s) {
  if (bf16_rows) {
    BnArgs<bf16> p{};
    p.c = static_cast<const bf16*>(c);
    p.da = static_cast<const bf16*>(da);
    p.rows = static_cast<const float*>(rows);
    p.m = static_cast<const float*>(m);
    p.mask = static_cast<const float*>(mask);
    p.R = R, p.S = S, p.C = C, p.group = R / M;
    return bwd_apply16(p, static_cast<const bf16*>(w), static_cast<const bf16*>(aprev),
                       static_cast<bf16*>(dprev), static_cast<float*>(dwb),
                       static_cast<float*>(ws), fold, R, S, C, cin, kw, residual, sms, s);
  }
  if (fold.part) return (int)cudaErrorInvalidValue;
  BnArgs<float> p{};
  p.c = static_cast<const float*>(c);
  p.da = static_cast<const float*>(da);
  p.rows = static_cast<const float*>(rows);
  p.m = static_cast<const float*>(m);
  p.mask = static_cast<const float*>(mask);
  p.R = R, p.S = S, p.C = C, p.group = R / M;
  return bwd_apply(p, static_cast<const float*>(w), static_cast<const float*>(aprev),
                   static_cast<float*>(dprev), static_cast<float*>(dwb), static_cast<float*>(ws),
                   R, S, C, cin, kw, residual, sms, s);
}

}  // namespace

// Workspace, in floats, of one launch on the current device, or an error
// when no plan takes the geometry. kind 0: a forward conv (conv0 or apply
// with a next layer; cin = the conv's input channels, cout = its
// outputs); 1: the backward sums (cin = cout = C); 2: the backward apply
// (cin = the layer's input channels, cout = C); 3 (bf16 only): the
// partials of a backward apply's fold, layer k-1's Σgy and Σgy·x̂ (cin =
// the layer's input channels, layer k-1's C). bf16: the launch's rows are
// bf16 (#13-bf16, #14-bf16).
extern "C" int focal_ct_workspace(int kind, int R, int S, int cin, int cout, int kw, int bf16_rows,
                                  long long* floats) {
  if (int e = check_rows(R, S, 1, cout, bf16_rows)) return e;
  if (!channels_ok(cin) || kw < 1 || (long long)R * S * cin >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int RS = R * S;
  if (kind == 1) {
    *floats = (long long)ceil_div(RS, kStatRows) * 2 * cout;
    return 0;
  }
  if (kind < 0 || kind > 3 || (kind == 3 && !bf16_rows)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const bool tc = on_tensor_cores(cin, bf16_rows);
  if (kind == 0) {
    *floats = (long long)(bf16_rows ? fwd_partials16(R, S, cin, cout, sms) : fwd_partials(RS, cin)) *
              2 * cout;
  } else if (kind == 3) {
    if (!tc) return (int)cudaErrorInvalidConfiguration;
    *floats = (long long)conv_plan16(R, S, cin, sms).per_n * 2 * cin;
  } else if (bf16_rows) {
    *floats = (long long)bf16_floats((size_t)RS * cout) + (long long)ceil_div(RS, kStatRows) * cout +
              (long long)wgrad_splits16(R, S, cin, cout, kw, sms) * kw * cin * cout;
  } else {
    const WgradPlan W = wgrad_plan(RS, cin, cout, kw, sms, false);
    *floats = (long long)RS * cout + (tc ? (long long)kw * cout * cin : 0) +
              (long long)W.splits * (long long)W.E;
  }
  return 0;
}

// The first conv of an internal-c0 tower (#13, _conv0_kernel): c = conv(x,
// w) + b [RS, cout], and from its batch statistics (with the BatchNorm's
// scale and bias [cout]) rows [5, cout], mu and var [cout]; with scale null
// the raw sums [Σc; Σc²] into rows [2, cout] alone (mu, var unused: several
// data ranks). ws holds
// focal_ct_workspace(0, R, S, cin, cout, kw, bf16) floats. Two launches on
// `stream`: the conv with its column-sum partials (the product, or the
// narrow conv where cin is not a multiple of 4, 8 in bf16) and their
// ordered sum with the statistics. bf16 (#13-bf16): x, w and c bf16, c
// rounded once.
extern "C" int focal_ct_conv0(const void* x, const void* w, const void* b, const void* scale,
                              const void* bias, void* c, void* rows, void* mu, void* var, void* ws,
                              int R, int S, int cin, int cout, int kw, int bf16_rows, void* stream) {
  if (int e = check_rows(R, S, 1, cout, bf16_rows)) return e;
  if (!channels_ok(cin) || kw < 1 || (long long)R * S * cin >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const BnStats st{static_cast<const float*>(scale), static_cast<const float*>(bias),
                   static_cast<float*>(rows), static_cast<float*>(mu), static_cast<float*>(var)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_rows ? ct_conv0<bf16>(x, w, b, st, c, ws, R, S, cin, cout, kw, s)
              : ct_conv0<float>(x, w, b, st, c, ws, R, S, cin, cout, kw, s);
}

// Layer k's apply (#13, _apply_kernel): a = GELU(c*A + B) * mask (+ aprev)
// [RS, C], rows = [A; B; P; Q; scale] [5, C], mask [M, C] (R % M == 0),
// aprev null for no residual. With w [kw*C, cout], b and layer k+1's
// BatchNorm scale and bias: then layer k+1's c_next = conv(a, w) + b and
// from its batch statistics rows_next [5, cout], mu_next and var_next
// [cout] (with scale null the raw sums into rows_next [2, cout], as
// focal_ct_conv0's; ws: focal_ct_workspace(0, R, S, C, cout, kw, bf16)
// floats); with
// w null the apply alone (the rest unused). One launch, or three: the
// apply, the conv product with its column-sum partials, their ordered sum
// with the statistics. bf16 (#13-bf16): c, aprev, a, w and c_next bf16.
extern "C" int focal_ct_apply(const void* c, const void* rows, const void* mask,
                              const void* aprev, const void* w, const void* b, const void* scale,
                              const void* bias, void* a, void* c_next, void* rows_next,
                              void* mu_next, void* var_next, void* ws, int R, int S, int M, int C,
                              int cout, int kw, int bf16_rows, void* stream) {
  if (int e = check_rows(R, S, M, C, bf16_rows)) return e;
  if (w != nullptr) {
    if (int e = check_rows(R, S, 1, cout, bf16_rows)) return e;
    if (kw < 1) return (int)cudaErrorInvalidValue;
  }
  const BnStats st{static_cast<const float*>(scale), static_cast<const float*>(bias),
                   static_cast<float*>(rows_next), static_cast<float*>(mu_next),
                   static_cast<float*>(var_next)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_rows ? ct_apply<bf16>(c, rows, mask, aprev, w, b, st, a, c_next, ws, R, S, M, C, cout,
                               kw, s)
              : ct_apply<float>(c, rows, mask, aprev, w, b, st, a, c_next, ws, R, S, M, C, cout,
                                kw, s);
}

// The backward sums of layer k (#14, _bwd_stats_kernel): s2 = [Σgy; Σgy·x̂]
// [2, C] from da, c [RS, C], mask and rows, and m = s2 scale / n [2, C]
// (m0, m1 of the backward apply; m null: s2 alone, for several data ranks,
// whose caller forms m from the ranks' sum). ws: focal_ct_workspace(1, R, S, C, C, 1,
// bf16) floats. Two launches: per-block sums, their ordered sum. bf16: da
// and c bf16; with `folded` (the partials that layer k+1's backward apply
// summed in its transposed conv's epilogue, focal_ct_workspace kind 3) one
// launch, their ordered sum (da, c, mask and ws unused).
extern "C" int focal_ct_bwd_stats(const void* da, const void* c, const void* mask,
                                  const void* rows, void* s2, void* m, void* ws,
                                  const void* folded, int R, int S, int M, int C, int bf16_rows,
                                  void* stream) {
  if (int e = check_rows(R, S, M, C, bf16_rows)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_rows ? ct_bwd_stats<bf16>(da, c, mask, rows, s2, m, ws, folded, R, S, M, C, s)
              : ct_bwd_stats<float>(da, c, mask, rows, s2, m, ws, folded, R, S, M, C, s);
}

// The backward apply of layer k (#14, _bwd_apply_kernel): dc from da, c,
// mask, rows and m = [m0; m1] [2, C]; dprev = convT(dc, W) (+ da when
// `residual`) [RS, cin] from w = W [kw*cin, C]; dwb = [dW (kw*cin x C) | db
// (C)]. aprev [RS, cin] is the layer's input. ws: focal_ct_workspace(2, R,
// S, cin, C, kw, bf16) floats. f32 launches: dc; W's per-tap transpose and
// the transposed-conv product (or the narrow transposed conv where cin is
// not a multiple of 4); the weight-gradient partials (product or narrow);
// their ordered sum. bf16 (#14-bf16): da, c, aprev, w and dprev bf16, dc
// rounded to bf16 for the products, db the f32 dc's sum; four launches
// (bwd_apply16). With fold_part (bf16, cin % 8 == 0): layer k-1's Σgy and
// Σgy·x̂ from the stored dprev, with its c (fold_c [RS, cin]), mask
// (fold_mask [fold_M, cin]) and rows (fold_rows [5, cin]), into fold_part
// (focal_ct_workspace(3, R, S, cin, cin, kw, 1) floats) for
// focal_ct_bwd_stats's `folded`.
extern "C" int focal_ct_bwd_apply(const void* da, const void* c, const void* mask,
                                  const void* rows, const void* m, const void* aprev,
                                  const void* w, void* dprev, void* dwb, void* ws,
                                  const void* fold_c, const void* fold_mask, const void* fold_rows,
                                  void* fold_part, int R, int S, int M, int C, int cin, int kw,
                                  int residual, int fold_M, int bf16_rows, void* stream) {
  if (int e = check_rows(R, S, M, C, bf16_rows)) return e;
  if (!channels_ok(cin) || kw < 1 || (residual && cin != C) ||
      (long long)R * S * cin >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Fold16 fold{static_cast<const bf16*>(fold_c), static_cast<const float*>(fold_mask),
                    static_cast<const float*>(fold_rows), static_cast<float*>(fold_part), fold_M};
  return ct_bwd_apply(da, c, mask, rows, m, aprev, w, dprev, dwb, ws, fold, R, S, M, C, cin, kw,
                      residual, bf16_rows, sms, s);
}

// dc alone (#14, _bwd_dc_kernel): the input gradient of an external first
// conv's output [RS, C]. One launch. bf16: da, c and dc bf16, dc rounded
// once.
extern "C" int focal_ct_bwd_dc(const void* da, const void* c, const void* mask, const void* rows,
                               const void* m, void* dc, int R, int S, int M, int C, int bf16_rows,
                               void* stream) {
  if (int e = check_rows(R, S, M, C, bf16_rows)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_rows ? ct_bwd_dc<bf16>(da, c, mask, rows, m, dc, R, S, M, C, s)
              : ct_bwd_dc<float>(da, c, mask, rows, m, dc, R, S, M, C, s);
}

extern "C" const char* focal_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
