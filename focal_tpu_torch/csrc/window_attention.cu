// Swin window attention alone (the qkv and output projections stay outside)
// for Hopper (sm_90a): forward (#6), forward with attention dropout (#7),
// backward (#8) and backward with attention dropout (#9).
//
// Replaces the TPU kernels of focal_tpu/ops/pallas_kernels.py:
//   #6 _attn_fwd_kernel (pk:119; fused_window_attention -> _fwd_impl ->
//      _call_forward -> pl.pallas_call, pk:233)
//   #7 _attn_fwd_dropout_kernel (pk:129; fused_window_attention_dropout, pk:241)
//   #8 _attn_bwd_kernel (pk:189; the VJP of #6, _call_backward, pk:266)
//   #9 _attn_bwd_dropout_kernel (pk:200; the VJP of #7, pk:274)
// Per (window w, head h) pair of q, k, v [B, H, N, hd] (f32, q pre-scaled):
//   a   = softmax(q k^T + rel_bias[h] + mask[w % nW])
//   a_v = keep ? a / (1 - rate) : 0            (#7, #9; a_v = a otherwise)
//   out = a_v v
// and its VJP for the output gradient g:
//   da = keep ? (g v^T) / (1 - rate) : 0,  ds = a (da - rowsum(da a))
//   dq = ds k,  dk = ds^T q,  dv = a_v^T g,  drel_bias[h] = sum over w of ds
//
// What bounds them on this card: bytes. A pair moves 4 N hd floats in the
// forward (q, k, v in, out) and 7 N hd in the backward (q, k, v, g in; dq,
// dk, dv out) for 4 N^2 hd and 10 N^2 hd FLOPs: at N = 9 that is 2.3 and
// 3.2 FLOP per byte, far under the f32 ridge of 20 FLOP per byte (67 TFLOP/s
// over 3.35 TB/s). What the design does about it is move each input and
// output once, and nothing else:
//   * A block owns P consecutive (window, head) pairs. Their q, k, v (and g)
//     rows are staged in shared memory with coalesced float4 loads (rows
//     padded to hd + 4 floats), from any row strides: the caller's views of
//     the qkv projection need no copy.
//   * G lanes serve one query row (G a power of two up to 8, lane l taking
//     the float4 columns l, l + G, ...). Their partial dot products are
//     summed by a butterfly of warp shuffles, which leaves the same bits in
//     every lane. Scores, softmax and dropout stay in registers: no
//     [B, H, N, N] tensor reaches device memory. Outputs go from registers
//     to device memory, a row's lanes writing neighbouring float4s.
//   * Dropout bits come from Philox4x32-10 with #2's counters
//     (philox.cuh): the same seed and geometry give #2's mask bit for bit.
//     #9 draws the mask again from the seed; nothing is stored between the
//     passes (focal_wattn_keep_mask writes it out for the checks only).
//   * drel_bias sums ds over every window: backward blocks walk the chunks
//     of pairs with a fixed stride, each sums its chunks' ds per head in
//     pair order in shared memory, and one ordered pass adds the blocks'
//     partials. No atomics: two calls give the same bits.
//   * f32 throughout with fmaf and expf, as the TPU kernels' f32 softmax.
//   * Not yet: overlapping the next chunk's loads with this chunk's math
//     (cp.async or TMA); two or three blocks per SM do it coarsely.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "philox.cuh"
#include "window_rows.cuh"

namespace {

using focal::Geo;
using focal::make_geo;
using focal::Row;
using focal::row_dots;
using focal::softmax_row;
using focal::Strides;
using focal::stage_rows;
using focal::thread_row;
constexpr int kMaxN = focal::kAttnMaxN;
constexpr int kMaxHd = focal::kAttnMaxHd;
constexpr int kThreads = focal::kAttnThreads;

size_t fwd_smem_floats(const Geo& g) { return (size_t)3 * g.pairs * g.N * g.stride; }

size_t bwd_smem_floats(const Geo& g) {
  return (size_t)4 * g.pairs * g.N * g.stride + (size_t)2 * g.pairs * g.N * g.N +
         (size_t)g.H * g.N * g.N;
}

int check_geometry(int B, int H, int N, int hd, const void* mask, int nW) {
  if (B < 0 || H < 1 || N < 1 || N > kMaxN || hd < 4 || hd > kMaxHd || hd % 4 != 0 ||
      (long long)B * H * N > 0x7fffffffLL || (mask != nullptr && nW < 1))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// ---------------------------------------------------------------------------
// forward (#6; #7 with kDropout)

template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
wattn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, Strides sq, Strides sk, Strides sv,
                 const float* __restrict__ rel_bias, const float* __restrict__ mask,
                 float* __restrict__ out, unsigned long long seed, unsigned threshold,
                 float inv_keep, Geo g, int nW) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + g.pairs * g.N * g.stride;
  float* vs = ks + g.pairs * g.N * g.stride;
  const int p0 = blockIdx.x * g.pairs;
  const int np = (int)min((long long)g.pairs, g.total - p0);
  stage_rows(q, sq, p0, np, g, qs);
  stage_rows(k, sk, p0, np, g, ks);
  stage_rows(v, sv, p0, np, g, vs);
  __syncthreads();

  const Row t = thread_row(g, p0, np);
  const int N = g.N;
  float p[kMaxN];
  row_dots(qs + t.r * g.stride, ks + t.pl * N * g.stride, g, t.lane, p);
  softmax_row(p, rel_bias + (t.h * N + t.i) * N,
              mask ? mask + ((size_t)(t.w % nW) * N + t.i) * N : nullptr, N);
  if (kDropout) {
    bool kept[kMaxN];
    focal::attn_keep_row(seed, (unsigned)t.w, t.h, t.i, N, threshold, kept);
#pragma unroll
    for (int j = 0; j < kMaxN; ++j)
      if (j < N) p[j] = kept[j] ? p[j] * inv_keep : 0.f;
  }
  const float* vb = vs + t.pl * N * g.stride;
  float4* o = reinterpret_cast<float4*>(out + ((size_t)t.pair * N + t.i) * g.hd);
  for (int c = t.lane; c < g.c4; c += g.lanes) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < N) {
        const float4 y = *reinterpret_cast<const float4*>(vb + j * g.stride + 4 * c);
        acc.x = fmaf(p[j], y.x, acc.x);
        acc.y = fmaf(p[j], y.y, acc.y);
        acc.z = fmaf(p[j], y.z, acc.z);
        acc.w = fmaf(p[j], y.w, acc.w);
      }
    }
    if (t.active) o[c] = acc;
  }
}

// ---------------------------------------------------------------------------
// backward (#8; #9 with kDropout)

// Per chunk of pairs: stage q, k, v, g; per query row i (stage 1) recompute
// the softmax p, d_attn = g_i . v_j, the dropped weights a_v and the score
// gradients ds (both to shared memory), and dq_i = ds k; then per key row j
// (stage 2) dk_j = sum_i ds[i][j] q_i and dv_j = sum_i a_v[i][j] g_i, and the
// block's d rel_bias += ds of the chunk's pairs, in pair order.
template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
wattn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ gout, Strides sq,
                 Strides sk, Strides sv, Strides sg, const float* __restrict__ rel_bias,
                 const float* __restrict__ mask, float* __restrict__ dq, float* __restrict__ dk,
                 float* __restrict__ dv, float* __restrict__ dbias_part, unsigned long long seed,
                 unsigned threshold, float inv_keep, Geo g, int nW) {
  extern __shared__ float4 smem4[];
  const int N = g.N, nn = N * N, slab = g.pairs * N * g.stride;
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + slab;
  float* vs = ks + slab;
  float* gs = vs + slab;
  float* dss = gs + slab;              // [P][N][N] score gradients
  float* avs = dss + g.pairs * nn;     // [P][N][N] weights as applied to v
  float* dacc = avs + g.pairs * nn;    // [H][N][N] this block's d rel_bias
  const int nchunks = (int)((g.total + g.pairs - 1) / g.pairs);

  for (int e = threadIdx.x; e < g.H * nn; e += kThreads) dacc[e] = 0.f;

  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    const int p0 = chunk * g.pairs;
    const int np = (int)min((long long)g.pairs, g.total - p0);
    __syncthreads();  // the previous chunk's readers are done with shared memory
    stage_rows(q, sq, p0, np, g, qs);
    stage_rows(k, sk, p0, np, g, ks);
    stage_rows(v, sv, p0, np, g, vs);
    stage_rows(gout, sg, p0, np, g, gs);
    __syncthreads();

    // stage 1: query row i of pair pl
    const Row t = thread_row(g, p0, np);
    const float* kb = ks + t.pl * N * g.stride;
    float p[kMaxN], ds[kMaxN];
    row_dots(qs + t.r * g.stride, kb, g, t.lane, p);
    row_dots(gs + t.r * g.stride, vs + t.pl * N * g.stride, g, t.lane, ds);  // d_attn
    softmax_row(p, rel_bias + (t.h * N + t.i) * N,
                mask ? mask + ((size_t)(t.w % nW) * N + t.i) * N : nullptr, N);
    bool kept[kMaxN];
    if (kDropout) focal::attn_keep_row(seed, (unsigned)t.w, t.h, t.i, N, threshold, kept);
    float dot = 0.f;
    float* avrow = avs + t.r * N;
    float* dsrow = dss + t.r * N;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < N) {
        if (kDropout) ds[j] = kept[j] ? ds[j] * inv_keep : 0.f;  // da
        dot = fmaf(ds[j], p[j], dot);
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < N) {
        const float a_v = kDropout ? (kept[j] ? p[j] * inv_keep : 0.f) : p[j];
        ds[j] = p[j] * (ds[j] - dot);
        if (t.active && t.lane == 0) {
          avrow[j] = a_v;
          dsrow[j] = ds[j];
        }
      }
    }
    float4* dqo = reinterpret_cast<float4*>(dq + ((size_t)t.pair * N + t.i) * g.hd);
    for (int c = t.lane; c < g.c4; c += g.lanes) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) {
        if (j < N) {
          const float4 y = *reinterpret_cast<const float4*>(kb + j * g.stride + 4 * c);
          acc.x = fmaf(ds[j], y.x, acc.x);
          acc.y = fmaf(ds[j], y.y, acc.y);
          acc.z = fmaf(ds[j], y.z, acc.z);
          acc.w = fmaf(ds[j], y.w, acc.w);
        }
      }
      if (t.active) dqo[c] = acc;
    }
    __syncthreads();

    // stage 2: key row j = t.i of pair pl
    if (t.active) {
      const int j = t.i;
      const float* dsc = dss + t.pl * nn + j;  // ds[.][j]
      const float* avc = avs + t.pl * nn + j;  // a_v[.][j]
      const float* qb = qs + t.pl * N * g.stride;
      const float* gb = gs + t.pl * N * g.stride;
      float dsj[kMaxN], avj[kMaxN];
#pragma unroll
      for (int i = 0; i < kMaxN; ++i) {
        if (i < N) {
          dsj[i] = dsc[i * N];
          avj[i] = avc[i * N];
        }
      }
      const size_t row = ((size_t)t.pair * N + j) * g.hd;
      float4* dko = reinterpret_cast<float4*>(dk + row);
      float4* dvo = reinterpret_cast<float4*>(dv + row);
      for (int c = t.lane; c < g.c4; c += g.lanes) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
#pragma unroll
        for (int i = 0; i < kMaxN; ++i) {
          if (i < N) {
            const float4 x = *reinterpret_cast<const float4*>(qb + i * g.stride + 4 * c);
            const float4 y = *reinterpret_cast<const float4*>(gb + i * g.stride + 4 * c);
            a.x = fmaf(dsj[i], x.x, a.x);
            a.y = fmaf(dsj[i], x.y, a.y);
            a.z = fmaf(dsj[i], x.z, a.z);
            a.w = fmaf(dsj[i], x.w, a.w);
            b.x = fmaf(avj[i], y.x, b.x);
            b.y = fmaf(avj[i], y.y, b.y);
            b.z = fmaf(avj[i], y.z, b.z);
            b.w = fmaf(avj[i], y.w, b.w);
          }
        }
        dko[c] = a;
        dvo[c] = b;
      }
    }
    // the block's d rel_bias: element (h, i, j) adds the chunk's pairs of
    // head h in pair order (each element keeps its thread across chunks)
    for (int e = threadIdx.x; e < g.H * nn; e += kThreads) {
      const int h = e / nn, ij = e - h * nn;
      float acc = dacc[e];
      for (int pl = ((h - p0 % g.H) + g.H) % g.H; pl < np; pl += g.H) acc += dss[pl * nn + ij];
      dacc[e] = acc;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < g.H * nn; e += kThreads)
    dbias_part[(size_t)blockIdx.x * g.H * nn + e] = dacc[e];
}

// out[e] = sum over s (in order) of part[s][e]: the ordered second pass of
// d rel_bias.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int S, int E,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * E + e];
  out[e] = acc;
}

// The keep mask of #7 / #9 as uint8 [B, H, N, N], one thread per query row.
__global__ void keep_mask_kernel(unsigned char* __restrict__ keep, int B, int H, int N,
                                 unsigned long long seed, unsigned threshold) {
  const int rows = B * H * N;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += gridDim.x * blockDim.x) {
    const int pair = r / N, i = r - pair * N;
    const int w = pair / H, h = pair - w * H;
    bool kept[kMaxN];
    focal::attn_keep_row(seed, (unsigned)w, h, i, N, threshold, kept);
    for (int j = 0; j < N; ++j) keep[(size_t)r * N + j] = kept[j] ? 1 : 0;
  }
}

template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The backward's grid: as many blocks as fit the card at once, at most one
// a chunk. Deterministic for a geometry on a card, so the d rel_bias
// partials (and their sum) are too.
cudaError_t bwd_grid(const Geo& g, bool dropout, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t bytes = bwd_smem_floats(g) * sizeof(float);
  if (err == cudaSuccess)
    err = dropout ? set_smem(wattn_bwd_kernel<true>, bytes) : set_smem(wattn_bwd_kernel<false>, bytes);
  if (err == cudaSuccess)
    err = dropout ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wattn_bwd_kernel<true>,
                                                                  kThreads, bytes)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wattn_bwd_kernel<false>,
                                                                  kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long nchunks = (g.total + g.pairs - 1) / g.pairs;
  *grid = (int)std::min<long long>(nchunks, (long long)per_sm * sms);
  return cudaSuccess;
}

Strides strides_at(const long long* s, int k) { return Strides{s[3 * k], s[3 * k + 1], s[3 * k + 2]}; }

}  // namespace

// Forward: #6 (dropout 0) or #7 (dropout 1: each weight kept iff its Philox
// word, keyed by `seed`, is >= `threshold`, then scaled by `inv_keep`).
// q, k, v are device pointers to [B, H, N, hd] f32 with hd contiguous;
// `strides` holds their element strides over (B, H, N), nine in all (each a
// multiple of 4, pointers 16-byte aligned). rel_bias [H, N, N]; mask [nW, N,
// N] or null (window w takes mask[w % nW]); out contiguous [B, H, N, hd].
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int focal_wattn_fwd(const void* q, const void* k, const void* v,
                               const long long* strides, const void* rel_bias, const void* mask,
                               void* out, int B, int H, int N, int hd, int nW, int dropout,
                               unsigned long long seed, unsigned threshold, float inv_keep,
                               void* stream) {
  if (int e = check_geometry(B, H, N, hd, mask, nW)) return e;
  if (B == 0) return 0;
  const Geo g = make_geo(B, H, N, hd);
  const size_t bytes = fwd_smem_floats(g) * sizeof(float);
  cudaError_t err = dropout ? set_smem(wattn_fwd_kernel<true>, bytes)
                            : set_smem(wattn_fwd_kernel<false>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)((g.total + g.pairs - 1) / g.pairs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FOCAL_WATTN_FWD_ARGS                                                                   \
  static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),    \
      strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),                  \
      static_cast<const float*>(rel_bias), static_cast<const float*>(mask),                    \
      static_cast<float*>(out), seed, threshold, inv_keep, g, mask != nullptr ? nW : 1
  if (dropout)
    wattn_fwd_kernel<true><<<grid, kThreads, bytes, s>>>(FOCAL_WATTN_FWD_ARGS);
  else
    wattn_fwd_kernel<false><<<grid, kThreads, bytes, s>>>(FOCAL_WATTN_FWD_ARGS);
#undef FOCAL_WATTN_FWD_ARGS
  return (int)cudaGetLastError();
}

// Workspace of the backward, in floats, for this geometry on the current
// device: the blocks' d rel_bias partials.
extern "C" int focal_wattn_bwd_workspace(int B, int H, int N, int hd, int dropout,
                                         long long* floats) {
  if (int e = check_geometry(B, H, N, hd, nullptr, 1)) return e;
  if (B == 0) {
    *floats = 0;
    return 0;
  }
  const Geo g = make_geo(B, H, N, hd);
  int grid = 0;
  const cudaError_t err = bwd_grid(g, dropout != 0, &grid);
  if (err != cudaSuccess) return (int)err;
  *floats = (long long)grid * H * N * N;
  return 0;
}

// Backward: #8 (dropout 0) or #9 (dropout 1, the forward's mask drawn again
// from `seed`). q, k, v, g (the output's gradient) as focal_wattn_fwd's
// operands, twelve strides; dq, dk, dv contiguous [B, H, N, hd]; drel_bias
// [H, N, N]; `ws` holds focal_wattn_bwd_workspace floats. Two launches on
// `stream`: the per-chunk kernel and the ordered sum of d rel_bias.
extern "C" int focal_wattn_bwd(const void* q, const void* k, const void* v, const void* g_out,
                               const long long* strides, const void* rel_bias, const void* mask,
                               void* dq, void* dk, void* dv, void* drel_bias, void* ws, int B,
                               int H, int N, int hd, int nW, int dropout, unsigned long long seed,
                               unsigned threshold, float inv_keep, void* stream) {
  if (int e = check_geometry(B, H, N, hd, mask, nW)) return e;
  if (B == 0) return 0;
  const Geo g = make_geo(B, H, N, hd);
  int grid = 0;
  cudaError_t err = bwd_grid(g, dropout != 0, &grid);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = bwd_smem_floats(g) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
#define FOCAL_WATTN_BWD_ARGS                                                                   \
  static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),    \
      static_cast<const float*>(g_out), strides_at(strides, 0), strides_at(strides, 1),        \
      strides_at(strides, 2), strides_at(strides, 3), static_cast<const float*>(rel_bias),     \
      static_cast<const float*>(mask), static_cast<float*>(dq), static_cast<float*>(dk),       \
      static_cast<float*>(dv), part, seed, threshold, inv_keep, g, mask != nullptr ? nW : 1
  if (dropout)
    wattn_bwd_kernel<true><<<grid, kThreads, bytes, s>>>(FOCAL_WATTN_BWD_ARGS);
  else
    wattn_bwd_kernel<false><<<grid, kThreads, bytes, s>>>(FOCAL_WATTN_BWD_ARGS);
#undef FOCAL_WATTN_BWD_ARGS
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int E = H * N * N;
  reduce_partials_kernel<<<(E + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, grid, E, static_cast<float*>(drel_bias));
  return (int)cudaGetLastError();
}

// The keep mask #7 and #9 draw for `seed` at this geometry, written out as
// uint8 [B, H, N, N] (1 kept, 0 dropped): for the checks; the kernels
// themselves never store it.
extern "C" int focal_wattn_keep_mask(void* keep, int B, int H, int N, unsigned long long seed,
                                     unsigned threshold, void* stream) {
  if (int e = check_geometry(B, H, N, 4, nullptr, 1)) return e;
  if (B == 0) return 0;
  const int rows = B * H * N;
  const int grid = std::min((rows + kThreads - 1) / kThreads, 4096);
  keep_mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(keep), B, H, N, seed, threshold);
  return (int)cudaGetLastError();
}

extern "C" const char* focal_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
