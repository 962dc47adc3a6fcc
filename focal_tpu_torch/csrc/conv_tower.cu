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
// Not yet: wgmma and TMA; Σgy and Σgy·x̂ folded into the previous
// transposed conv's epilogue.
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
// convT(dc, W) + da rounded once. The products run on the bf16 tensor cores
// (gemm_bf16.cuh: mma.sync.m16n8k16, f32 sums, one pass where 3xTF32 takes
// three): bf16_conv_gemm_kernel with BfConvRows, an implicit-im2col loader
// of bf16 rows (eight channels, 16 bytes, of one tap a piece: cin % 8 == 0;
// the SAME padding zero-filled), and bf16_conv_wgrad_kernel with
// BfConvWgradRows, the same rows read transposed. At MOD's widths these are
// bound by bytes: a (1, KW) conv over C = 64 does 2*KW*64 FLOP an output for
// 4 bytes of bf16 rows in and out (160 FLOP a byte at KW 5, below the bf16
// ridge of 295). A first conv over cin % 8 != 0 (the seismic cin 2, the
// mod_extractor's cin 1) stays on the CUDA cores in bf16
// (narrow_*_kernel<bf16>). Every layer after the first has cin = C, a
// multiple of 8 (check_rows), so it runs on the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "gemm_3xtf32.cuh"
#include "gemm_bf16.cuh"
#include "gemm_splitk.cuh"

namespace focal {
struct ConvTowerSrc {};  // tags this library's instances of gemm_splitk.cuh's kernels
}  // namespace focal

namespace {

using Src = focal::ConvTowerSrc;
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
      make_uint2(focal::pack_bf16x2(f.v[0], f.v[1]), focal::pack_bf16x2(f.v[2], f.v[3]));
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
// gradient db, before dc is rounded) into part[block] [2, C] (the second
// row zeros).
__global__ void __launch_bounds__(kThreads) bn_dc_sums_kernel(const BnArgs<bf16> p,
                                                              float* __restrict__ part) {
  extern __shared__ float red[];
  const int C4 = p.C / 4;
  const int g_begin = blockIdx.x * kStatRows;
  block_column_sums(p.C, g_begin, min(p.R * p.S, g_begin + kStatRows), red, part,
                    [&](int g, int c4, F4& s1, F4&) {
                      const size_t e = (size_t)g * C4 + c4;
                      const F4 dc = bn_dc4(p, e, g, c4);
                      st4(p.out, e, dc);
#pragma unroll
                      for (int u = 0; u < 4; ++u) s1.v[u] += dc.v[u];
                    });
}

// out[ch] = the ordered sum over blocks of part[block][0][ch] (C channels):
// db from bn_dc_sums_kernel's partials.
__global__ void column_total_kernel(const float* __restrict__ part, int blocks, int C,
                                    float* __restrict__ out) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= C) return;
  float t = 0.f;
  for (int b = 0; b < blocks; ++b) t += part[(size_t)b * 2 * C + ch];
  out[ch] = t;
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

// One thread a channel: the ordered sum of the backward's column-sum
// partials [blocks, 2, C] into s2 = [Σgy; Σgy·x̂], and m = s2 scale / n
// (the means of dx̂ and dx̂·x̂) where m is not null (several data ranks:
// the caller sums s2 over them first).
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
  if (m == nullptr) return;
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

// v0, v1 stored at out + e (e even) as the output's type; v0, v1 become the
// values as stored (bf16: rounded to nearest even).
__device__ __forceinline__ void store_pair(float* out, size_t e, float& v0, float& v1) {
  *reinterpret_cast<float2*>(out + e) = make_float2(v0, v1);
}

__device__ __forceinline__ void store_pair(bf16* out, size_t e, float& v0, float& v1) {
  const uint32_t packed = focal::pack_bf16x2(v0, v1);
  *reinterpret_cast<uint32_t*>(out + e) = packed;
  v0 = __uint_as_float(packed << 16);
  v1 = __uint_as_float(packed & 0xffff0000u);
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
// the bf16 products (#13-bf16, #14-bf16) on gemm_bf16.cuh's tensor-core
// tiles

// The A operand of a bf16 (1, KW) SAME conv (sign +1) or transposed conv
// (sign -1), implicit im2col as ShiftRows: column k = j * cin + ci of row g
// is x[g + sign * (j - lo), ci], zero where the position leaves [0, S).
// cin % 8 == 0: a 16-byte piece (eight bf16) of a row never straddles two
// taps.
struct BfShiftRows {
  const bf16* x;
  int cin, S, lo, sign;
};

// A K-slice of kGemmBM rows of im2col(x) in a thread's registers: 2 x 8
// values (row tid / 4 + 64 i, columns tid % 4 * 8), zeros outside the
// matrix and the sample. The rows' positions are found once.
struct BfConvRows {
  BfShiftRows a;
  int M, m0, K;
  int s[2];  // the positions of the thread's rows, -1 past M
  uint4 v[2];

  __device__ __forceinline__ BfConvRows(const BfShiftRows& a_, int M_, int m0_, int K_)
      : a(a_), M(M_), m0(m0_), K(K_) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + (threadIdx.x >> 2) + 64 * i;
      s[i] = row < M ? row % a.S : -1;
    }
  }

  __device__ __forceinline__ void load(int k0) {
    const int c = (threadIdx.x & 3) * 8, k = k0 + c;
    const int j = k / a.cin, ci = k - j * a.cin;
    const int d = a.sign * (j - a.lo);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (threadIdx.x >> 2) + 64 * i;
      const bool ok = k < K && s[i] >= 0 && (unsigned)(s[i] + d) < (unsigned)a.S;
      v[i] = ok ? __ldg(reinterpret_cast<const uint4*>(a.x + (size_t)(m0 + r + d) * a.cin + ci))
                : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // Into the tile [kGemmBM][kBfRowWords] (words of K pairs).
  __device__ __forceinline__ void store(uint32_t* tile) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (threadIdx.x >> 2) + 64 * i, c = (threadIdx.x & 3) * 8;
      *reinterpret_cast<uint4*>(tile + r * focal::kBfRowWords + c / 2) = v[i];
    }
  }
};

// A K-slice (K running over the rows g) of im2col(x) read transposed, the A
// of a weight gradient im2col(x)^T dc over rows [.., k_end): the thread's
// unit is K pair p = tid % 16 (rows k0 + 2p, + 1) of the column group tid /
// 16 (eight columns m = j * cin + ci of one tap), stored as gemm_bf16.cuh's
// PairSlice stores bf16. The column's tap shift and offset are found once.
struct BfConvWgradRows {
  BfShiftRows a;
  int k_end;
  int d, off;  // the group's tap shift and its offset in x, d * cin + ci
  bool m_ok;   // the group lies inside M
  uint4 lo, hi;

  __device__ __forceinline__ BfConvWgradRows(const BfShiftRows& a_, int M, int m0, int k_end_)
      : a(a_), k_end(k_end_) {
    const int m = m0 + (threadIdx.x >> 4) * 8;
    const int j = m / a.cin;
    d = a.sign * (j - a.lo);
    off = d * a.cin + (m - j * a.cin);
    m_ok = m < M;
  }

  __device__ __forceinline__ uint4 row(int g) const {
    const bool ok = m_ok && g < k_end && (unsigned)(g % a.S + d) < (unsigned)a.S;
    return ok ? __ldg(reinterpret_cast<const uint4*>(a.x + (size_t)g * a.cin + off))
              : make_uint4(0u, 0u, 0u, 0u);
  }

  __device__ __forceinline__ void load(int k0) {
    const int g = k0 + 2 * (threadIdx.x & 15);
    lo = row(g);
    hi = row(g + 1);
  }

  __device__ __forceinline__ void store(uint32_t* tile) const {
    const int p = threadIdx.x & 15, cg = threadIdx.x >> 4;
    const uint32_t l[4] = {lo.x, lo.y, lo.z, lo.w}, h[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t a0 = (j & 1) ? l[j / 2] >> 16 : l[j / 2] & 0xffffu;
      const uint32_t b0 = (j & 1) ? h[j / 2] >> 16 : h[j / 2] & 0xffffu;
      tile[(cg * 8 + j) * focal::kBfRowWords + p] = a0 | (b0 << 16);
    }
  }
};

// acc = A B over K in [k_begin, k_end), A staged by `a` (BfConvRows or
// BfConvWgradRows), B [K, N] bf16 (row-major, ldb = N) by gemm_bf16.cuh's
// PairSlice, on bf_compute's warp tiles: two shared-memory stages fed
// through registers.
template <int kBN, class ARows>
__device__ __forceinline__ void bf_conv_tile(ARows& a, const bf16* B, int N, int n0, int k_begin,
                                             int k_end, uint32_t* smem,
                                             float (&acc)[4][focal::gemm_nt<kBN>()][4]) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < focal::gemm_nt<kBN>(); ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const focal::BfOperand bop{B, N};
  focal::PairSlice<kBN> bs;
  const int kt_n = (k_end - k_begin + focal::kBfBK - 1) / focal::kBfBK;
  if (kt_n > 0) {
    a.load(k_begin);
    bs.load(bop, N, n0, k_begin, k_end);
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    uint32_t* As = smem + (kt & 1) * focal::bf_stage_words(kBN);
    uint32_t* Bs = As + focal::kGemmBM * focal::kBfRowWords;
    a.store(As);
    bs.store(Bs);
    // the slot is staged; and every warp finished slice kt - 2, the last
    // reader of this slot, before it reached the barrier of slice kt - 1
    __syncthreads();
    if (kt + 1 < kt_n) {
      const int k0 = k_begin + (kt + 1) * focal::kBfBK;
      a.load(k0);
      bs.load(bop, N, n0, k0, k_end);
    }
    focal::bf_compute<kBN>(As, Bs, acc);
  }
}

// A bf16 conv (sign +1) or transposed conv (sign -1) as an implicit-im2col
// product: out = im2col(a.x) w + bias (+ add), rounded to bf16 once [M, N],
// K = KW * a.cin; with part, each row tile's column sums of the stored out
// and out^2 into part[tile] [2, N].
struct BfConvGemmArgs {
  BfShiftRows a;
  const bf16* w;      // [K, N]
  const float* bias;  // [N], or null
  const bf16* add;    // [M, N], or null
  bf16* out;          // [M, N]
  float* part;        // [row tiles, 2, N], or null
  int M, N, K;
};

// Two blocks an SM at 64 columns, one at 128; 30 or 40 KB of static shared
// memory.
template <int kBN>
__global__ void __launch_bounds__(kThreads, kBN == 64 ? 2 : 1)
bf16_conv_gemm_kernel(const BfConvGemmArgs p) {
  __shared__ __align__(16) uint32_t smem[focal::bf_smem_words(kBN)];
  const int tiles_n = (p.N + kBN - 1) / kBN;
  const int tile_m = blockIdx.x / tiles_n;
  const int m0 = tile_m * focal::kGemmBM, n0 = (blockIdx.x % tiles_n) * kBN;
  float acc[4][focal::gemm_nt<kBN>()][4];
  BfConvRows rows(p.a, p.M, m0, p.K);
  bf_conv_tile<kBN>(rows, p.w, p.N, n0, 0, p.K, smem, acc);
  conv_epilogue<kBN>(acc, p.bias, p.add, p.out, p.part, p.M, p.N, m0, n0, tile_m,
                     reinterpret_cast<float*>(smem));
}

// Block (tile, split): one tile of dW = im2col(a.x)^T dc [M = KW * cin, N]
// over the split's rows (bf16 operands, f32 sums), into the split's partial
// (E = M N floats; db comes from the dc pass).
template <int kBN>
__global__ void __launch_bounds__(kThreads, kBN == 64 ? 2 : 1)
bf16_conv_wgrad_kernel(const BfShiftRows a, const bf16* __restrict__ dc, int M, int N, int RS,
                       int rows_per_split, float* __restrict__ part, size_t E) {
  __shared__ __align__(16) uint32_t smem[focal::bf_smem_words(kBN)];
  const int tiles_n = (N + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / tiles_n) * focal::kGemmBM, n0 = (blockIdx.x % tiles_n) * kBN;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(RS, r_begin + rows_per_split);
  float acc[4][focal::gemm_nt<kBN>()][4];
  BfConvWgradRows rows(a, M, m0, r_end);
  bf_conv_tile<kBN>(rows, dc, N, n0, r_begin, r_end, smem, acc);
  float* out = part + (size_t)blockIdx.y * E;
  focal::gemm_for_each_output<kBN>(acc, M, N, m0, n0, [&](int row, int col, float v0, float v1) {
    *reinterpret_cast<float2*>(out + (size_t)row * N + col) = make_float2(v0, v1);
  });
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

// The column-sum partials of a forward conv over cin channels: one per
// 128-row tile of the product, or per kStatRows rows of the narrow conv.
int fwd_partials(int RS, int cin, bool bf16) {
  return on_tensor_cores(cin, bf16) ? ceil_div(RS, focal::kGemmBM) : ceil_div(RS, kStatRows);
}

// The weight gradient of a layer (KW * cin x C, and in f32 db): tile width,
// tiles, row splits and the partial size E = M C + C (bf16: M C, db comes
// from the dc pass). The product's splits fill the card about four times
// over (split_rows); the narrow one takes kStatRows-row splits the same
// way, as one tile.
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

// The same in bf16 (bf16_conv_gemm_kernel): x, w, add and out bf16, out
// rounded once.
cudaError_t launch_conv_gemm(const bf16* x, int cin, int S, int KW, int sign, const bf16* w,
                             const float* bias, const bf16* add, bf16* out, float* part, int RS,
                             int N, cudaStream_t s) {
  if (!aligned16(x) || !aligned16(w) || !aligned16(out) || (add && !aligned16(add)))
    return cudaErrorMisalignedAddress;
  BfConvGemmArgs p{};
  p.a = BfShiftRows{x, cin, S, (KW - 1) / 2, sign};
  p.w = w, p.bias = bias, p.add = add, p.out = out, p.part = part;
  p.M = RS, p.N = N, p.K = KW * cin;
  int tiles_n = 0, tiles = 0;
  if (focal::tile_bn(N, 0) == 128) {
    focal::set_tiles(p.M, p.N, 128, &tiles_n, &tiles);
    bf16_conv_gemm_kernel<128><<<tiles, kThreads, 0, s>>>(p);
  } else {
    focal::set_tiles(p.M, p.N, 64, &tiles_n, &tiles);
    bf16_conv_gemm_kernel<64><<<tiles, kThreads, 0, s>>>(p);
  }
  return cudaGetLastError();
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

// The first conv (or layer k+1's conv) of the forward over x [RS, cin]:
// c [RS, cout] and its BatchNorm's statistics and coefficients st,
// through ws (the column-sum partials). T: the rows' type.
template <class T>
int conv_forward(const T* x, const T* w, const float* b, T* c, const BnStats& st, float* ws,
                 int RS, int S, int cin, int cout, int kw, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  cudaError_t err;
  if (on_tensor_cores(cin, kBf16)) {
    err = launch_conv_gemm(x, cin, S, kw, 1, w, b, nullptr, c, ws, RS, cout, s);
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
  bn_stats_kernel<<<ceil_div(cout, kThreads), kThreads, 0, s>>>(
      ws, fwd_partials(RS, cin, kBf16), cout, (float)RS, st);
  return (int)cudaGetLastError();
}

template <class T>
int ct_conv0(const void* x, const void* w, const void* b, const BnStats& st, void* c, void* ws,
             int R, int S, int cin, int cout, int kw, cudaStream_t s) {
  return conv_forward(static_cast<const T*>(x), static_cast<const T*>(w),
                      static_cast<const float*>(b), static_cast<T*>(c), st,
                      static_cast<float*>(ws), R * S, S, cin, cout, kw, s);
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
                      static_cast<float*>(ws), R * S, S, C, cout, kw, s);
}

template <class T>
int ct_bwd_stats(const void* da, const void* c, const void* mask, const void* rows, void* s2,
                 void* m, void* ws, int R, int S, int M, int C, cudaStream_t s) {
  BnArgs<T> p{};
  p.c = static_cast<const T*>(c);
  p.da = static_cast<const T*>(da);
  p.rows = static_cast<const float*>(rows);
  p.mask = static_cast<const float*>(mask);
  p.R = R, p.S = S, p.C = C, p.group = R / M;
  if (!bn_aligned(p)) return (int)cudaErrorMisalignedAddress;
  const int blocks = ceil_div(R * S, kStatRows);
  const size_t smem = column_sums_smem(C);
  cudaError_t e = set_smem(bn_grad_sums_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  float* part = static_cast<float*>(ws);
  bn_grad_sums_kernel<T><<<blocks, kThreads, smem, s>>>(p, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_grad_stats_kernel<<<ceil_div(C, kThreads), kThreads, 0, s>>>(
      part, blocks, C, (float)(R * S), p.rows, static_cast<float*>(s2), static_cast<float*>(m));
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

// Floats of workspace that n values of T take, rounded up to 16 bytes.
template <class T>
size_t row_floats(size_t n) {
  return sizeof(T) == 4 ? n : bf16_floats(n);
}

// #14's backward apply (focal_ct_bwd_apply's launches) on T rows. The
// workspace holds dc [RS, C] and W's per-tap transpose as T, in bf16 the dc
// pass's block sums, then the weight-gradient partials. f32: dc in one
// elementwise pass, db beside dW in the partials; bf16: dc rounded to bf16
// with the f32 dc's block sums, db their ordered sum.
template <class T>
int bwd_apply(const BnArgs<T>& p0, const T* w, const T* ap, T* dprev, float* dwb, float* ws,
              int R, int S, int C, int cin, int kw, int residual, int sms, cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int RS = R * S;
  const bool tc = on_tensor_cores(cin, kBf16);
  const int blocks = ceil_div(RS, kStatRows);
  T* dc = reinterpret_cast<T*>(ws);
  float* next = ws + row_floats<T>((size_t)RS * C);
  T* wt = reinterpret_cast<T*>(next);
  next += tc ? row_floats<T>((size_t)kw * C * cin) : 0;
  float* dsum = next;
  float* wpart = next + (kBf16 ? (size_t)blocks * 2 * C : 0);
  BnArgs<T> p = p0;
  p.out = dc;
  const WgradPlan W = wgrad_plan(RS, cin, C, kw, sms, kBf16);
  cudaError_t e;
  if constexpr (kBf16) {
    if (!bn_aligned(p)) return (int)cudaErrorMisalignedAddress;
    const size_t smem = column_sums_smem(C);
    if ((e = set_smem(bn_dc_sums_kernel, smem)) != cudaSuccess) return (int)e;
    bn_dc_sums_kernel<<<blocks, kThreads, smem, s>>>(p, dsum);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    column_total_kernel<<<ceil_div(C, kThreads), kThreads, 0, s>>>(dsum, blocks, C, dwb + W.E);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  } else {
    if (int err = launch_elementwise(true, p, s)) return err;
  }
  if (tc) {
    if (!aligned16(ap)) return (int)cudaErrorMisalignedAddress;
    const size_t n = (size_t)kw * C * cin;
    tap_transpose_kernel<T><<<(unsigned)std::min<size_t>((n + kThreads - 1) / kThreads, sms * 8),
                              kThreads, 0, s>>>(w, kw, cin, C, wt);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    e = launch_conv_gemm(dc, C, S, kw, -1, wt, nullptr, residual ? p.da : nullptr, dprev, nullptr,
                         RS, cin, s);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(W.tiles, W.splits);
    if constexpr (kBf16) {
      const BfShiftRows a{ap, cin, S, (kw - 1) / 2, 1};
      if (W.bn == 128)
        bf16_conv_wgrad_kernel<128><<<grid, kThreads, 0, s>>>(a, dc, kw * cin, C, RS,
                                                             W.rows_per_split, wpart, W.E);
      else
        bf16_conv_wgrad_kernel<64><<<grid, kThreads, 0, s>>>(a, dc, kw * cin, C, RS,
                                                            W.rows_per_split, wpart, W.E);
    } else {
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
    }
  } else {
    narrow_convT_kernel<T><<<ceil_div(RS, kThreads / 32), kThreads, 0, s>>>(dc, w, dprev, RS, S,
                                                                          cin, C, kw);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    narrow_wgrad_kernel<T><<<W.splits, kThreads, 0, s>>>(ap, dc, RS, S, cin, C, kw,
                                                         W.rows_per_split, wpart, W.E, !kBf16);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return (int)focal::launch_reduce<Src>(wpart, W.splits, W.E, dwb, s);
}

template <class T>
int ct_bwd_apply(const void* da, const void* c, const void* mask, const void* rows, const void* m,
                 const void* aprev, const void* w, void* dprev, void* dwb, void* ws, int R, int S,
                 int M, int C, int cin, int kw, int residual, int sms, cudaStream_t s) {
  BnArgs<T> p{};
  p.c = static_cast<const T*>(c);
  p.da = static_cast<const T*>(da);
  p.rows = static_cast<const float*>(rows);
  p.m = static_cast<const float*>(m);
  p.mask = static_cast<const float*>(mask);
  p.R = R, p.S = S, p.C = C, p.group = R / M;
  return bwd_apply(p, static_cast<const T*>(w), static_cast<const T*>(aprev),
                   static_cast<T*>(dprev), static_cast<float*>(dwb), static_cast<float*>(ws), R, S,
                   C, cin, kw, residual, sms, s);
}

}  // namespace

// Workspace, in floats, of one launch on the current device, or an error
// when no plan takes the geometry. kind 0: a forward conv (conv0 or apply
// with a next layer; cin = the conv's input channels, cout = its
// outputs); 1: the backward sums (cin = cout = C); 2: the backward apply
// (cin = the layer's input channels, cout = C). bf16: the launch's rows
// are bf16 (#13-bf16, #14-bf16).
extern "C" int focal_ct_workspace(int kind, int R, int S, int cin, int cout, int kw, int bf16_rows,
                                  long long* floats) {
  if (int e = check_rows(R, S, 1, cout, bf16_rows)) return e;
  if (!channels_ok(cin) || kw < 1 || (long long)R * S * cin >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int RS = R * S;
  if (kind == 0) {
    *floats = (long long)fwd_partials(RS, cin, bf16_rows) * 2 * cout;
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
    const WgradPlan W = wgrad_plan(RS, cin, cout, kw, sms, bf16_rows);
    const bool tc = on_tensor_cores(cin, bf16_rows);
    if (bf16_rows)
      *floats = (long long)(bf16_floats((size_t)RS * cout) +
                            (tc ? bf16_floats((size_t)kw * cout * cin) : 0)) +
                (long long)ceil_div(RS, kStatRows) * 2 * cout + (long long)W.splits * W.E;
    else
      *floats = (long long)RS * cout + (tc ? (long long)kw * cout * cin : 0) +
                (long long)W.splits * (long long)W.E;
    return 0;
  }
  return (int)cudaErrorInvalidValue;
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
// and c bf16.
extern "C" int focal_ct_bwd_stats(const void* da, const void* c, const void* mask,
                                  const void* rows, void* s2, void* m, void* ws, int R, int S,
                                  int M, int C, int bf16_rows, void* stream) {
  if (int e = check_rows(R, S, M, C, bf16_rows)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_rows ? ct_bwd_stats<bf16>(da, c, mask, rows, s2, m, ws, R, S, M, C, s)
              : ct_bwd_stats<float>(da, c, mask, rows, s2, m, ws, R, S, M, C, s);
}

// The backward apply of layer k (#14, _bwd_apply_kernel): dc from da, c,
// mask, rows and m = [m0; m1] [2, C]; dprev = convT(dc, W) (+ da when
// `residual`) [RS, cin] from w = W [kw*cin, C]; dwb = [dW (kw*cin x C) | db
// (C)]. aprev [RS, cin] is the layer's input. ws: focal_ct_workspace(2, R,
// S, cin, C, kw, bf16) floats (dc, W's per-tap transpose, in bf16 the dc
// pass's block sums, the weight-gradient partials). Launches: dc (in bf16
// with its block sums and then db); W^T and the transposed-conv product (or
// the narrow transposed conv where cin is not a multiple of 4, 8 in bf16);
// the weight-gradient partials (product or narrow); their ordered sum.
// bf16 (#14-bf16): da, c, aprev, w and dprev bf16, dc rounded to bf16 for
// the products, db the f32 dc's sum.
extern "C" int focal_ct_bwd_apply(const void* da, const void* c, const void* mask,
                                  const void* rows, const void* m, const void* aprev,
                                  const void* w, void* dprev, void* dwb, void* ws, int R,
                                  int S, int M, int C, int cin, int kw, int residual, int bf16_rows,
                                  void* stream) {
  if (int e = check_rows(R, S, M, C, bf16_rows)) return e;
  if (!channels_ok(cin) || kw < 1 || (residual && cin != C) ||
      (long long)R * S * cin >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_rows)
    return ct_bwd_apply<bf16>(da, c, mask, rows, m, aprev, w, dprev, dwb, ws, R, S, M, C, cin, kw,
                              residual, sms, s);
  return ct_bwd_apply<float>(da, c, mask, rows, m, aprev, w, dprev, dwb, ws, R, S, M, C, cin, kw,
                             residual, sms, s);
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
