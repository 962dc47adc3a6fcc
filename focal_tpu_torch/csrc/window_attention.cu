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
// Per (window w, head h) pair of q, k, v [B, H, N, hd] (f32, q scaled by
// hd^-0.5, by the caller or in the kernel):
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
//   * A block takes P consecutive (window, head) pairs at a time. Their q,
//     k, v (and g) rows are staged in shared memory with coalesced 16-byte
//     copies (rows padded to hd + 4 floats), from any row strides: the
//     caller's views of the qkv projection need no copy.
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
//   * f32 throughout with fmaf and expf, as the TPU kernels' f32 softmax.
// All four keep the load units busy while they compute:
//   * A persistent grid (as many blocks as fit the card at once, at most one
//     a chunk) walks chunks of P (window, head) pairs with a fixed stride.
//     Each chunk's q, k, v (and g) rows are staged by cp.async into one slot
//     of a two-deep ring while the block computes the chunk before it: the
//     staging and the math no longer alternate. A thread's staging row is
//     found once for all its operands. The forward needs one barrier a
//     chunk (the one after the chunk's copies land also frees the other
//     slot), the backward two (it keeps ds and a_v in shared memory). The
//     operands, their f32 staging and the stores live in window_rows.cuh
//     (Operands, stage_chunk_async, store4), shared with the attention of
//     the bf16 whole-block backward (#3-bf16, #5-bf16), whose walk there
//     (ring_walk) has this loop's shape; these kernels keep the loop
//     inline (#9 in f32 ran ~5 % slower through ring_walk on the H100).
//   * q arrives unscaled where the caller passes its scale: each thread
//     multiplies the q float4s it staged itself, after its own copies land
//     and before the chunk's barrier. The f32 product rounds as the
//     caller's q * scale does, so the kernels see the same bits, and no
//     scaled copy of q is written or kept.
//   * At N = 9 (every packaged window) the row tile is exactly 9 keys with
//     a lane's two float4 columns unrolled (hd 16, 32, 64): no
//     predicated-off lanes of a 16-wide tile. The G lanes of a query row
//     share its Philox words (lane l draws words l, l + G, ...) instead of
//     each drawing all of them.
//   * Outputs are written at the caller's strides: the forward's out as
//     contiguous [B, H, N, hd] or as the head columns of one [B, N, C]
//     tensor (the output projection's input, which then needs no copy);
//     dq, dk and dv as contiguous [B, H, N, hd] or the head columns of one
//     d(qkv) [B, N, 3C] with dq times the q scale, the layout the qkv
//     Linear's backward takes. Then autograd stacks and copies nothing.
//   * Each kernel's launch plan (pairs a chunk, grid, shared memory) is made
//     once a geometry and device: the host's per-call path makes no
//     attribute or occupancy query.
//   * drel_bias sums ds over every window: each block sums its chunks' ds
//     per head in pair order in shared memory, and one ordered pass adds
//     the blocks' partials. No atomics: two calls give the same bits.
//
// The bf16 forms (-compute_dtype bfloat16): #6-bf16 to #9-bf16
// (focal_wattn_fwd_bf16, focal_wattn_bwd_bf16) replace the same TPU kernels
// fed bf16 q, k, v and g (pk:119, :129, :189, :200), which upcast them to
// f32 first, compute as in f32 and store out, dq, dk and dv in the inputs'
// type (pk:235, :254-256), dbias in f32 (pk:257). So do these: the same
// kernel bodies, instantiated on the element type.
//   * Rows are staged 16 bytes (8 bf16) at a time by the same cp.async
//     ring, into the upper half of the 32 bytes each 8 values take in f32;
//     once its copies land, each thread widens them to f32 in place, before
//     the chunk's barrier (as it scales f32 q). The ring's layout, the math
//     and the shared memory stay the f32 kernels' (hd a multiple of 8).
//   * q_scale is rounded to bf16 once and each q to bf16(q bf16(scale)) as
//     it is widened: the rounding of the JAX caller's bf16 `qkv[0] * scale`
//     (focal_tpu/models/swin.py:270).
//   * Softmax, dropout and every sum stay in f32 with fmaf and expf; out,
//     dq, dk and dv are rounded to bf16 once as they are stored, the q
//     columns of d(qkv) as bf16(bf16(dq) bf16(scale)), the VJP of that
//     multiply; drel_bias stays f32 in the same fixed order.
//   * What bounds them is bytes, as in f32 (the rows at 2 bytes move half
//     as many): no tensor-core product is needed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <array>
#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

#include "gemm_3xtf32.cuh"
#include "philox.cuh"
#include "window_rows.cuh"

namespace {

using focal::chunk_pairs;
using focal::Geo;
using focal::make_geo;
using focal::Operands;
using focal::Row;
using focal::row_dots;
using focal::stage_chunk_async;
using focal::store4;
using focal::Strides;
using focal::thread_row;
constexpr int kMaxN = focal::kAttnMaxN;
constexpr int kMaxHd = focal::kAttnMaxHd;
constexpr int kThreads = focal::kAttnThreads;
using bf16 = __nv_bfloat16;

// The forward's shared memory: the two-slot ring of q, k, v rows.
size_t fwd_smem_floats(const Geo& g) { return (size_t)6 * g.pairs * g.N * g.stride; }

// The backward's shared memory: the two-slot ring of q, k, v, g rows, ds
// and a_v [P][N][N], and the block's d rel_bias [H][N][N].
size_t bwd_smem_floats(const Geo& g) {
  return (size_t)8 * g.pairs * g.N * g.stride + (size_t)2 * g.pairs * g.N * g.N +
         (size_t)g.H * g.N * g.N;
}

// The head widths a row of element type T is staged at: multiples of 4
// floats or of 8 bf16 (16 bytes).
template <class T>
constexpr int hd_multiple() {
  return std::is_same<T, float>::value ? 4 : 8;
}

template <class T>
int check_geometry(int B, int H, int N, int hd, const void* mask, int nW) {
  constexpr int m = hd_multiple<T>();
  if (B < 0 || H < 1 || N < 1 || N > kMaxN || hd < m || hd > kMaxHd || hd % m != 0 ||
      (long long)B * H * N > 0x7fffffffLL || (mask != nullptr && nW < 1))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// ---------------------------------------------------------------------------
// the staging both directions share

// Multiply the chunk's q rows in a ring slot by `scale`: each thread scales
// the float4s it copied itself (stage_chunk_async's mapping), so it may do
// so right after its own cp_async_wait, before the chunk's barrier.
__device__ __forceinline__ void scale_staged_q(int chunk, const Geo& g, float* qs, float scale) {
  const int np = chunk_pairs(g, chunk);
  const int per_pass = kThreads / g.c4;
  const int c = threadIdx.x % g.c4, r0 = threadIdx.x / g.c4;
  if (r0 >= per_pass) return;
  for (int r = r0; r < np * g.N; r += per_pass) {
    float4* x = reinterpret_cast<float4*>(qs + r * g.stride + 4 * c);
    const float4 y = *x;
    *x = make_float4(y.x * scale, y.y * scale, y.z * scale, y.w * scale);
  }
}

// x rounded to the nearest bf16 (ties to even), on the card or the host.
__host__ __device__ inline float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The staging of one chunk of bf16 operands: stage_chunk_async's ring
// layout and thread mapping over 8-column groups (c8 = hd / 8 of them):
// thread tid copies the 16 bytes of group tid % c8 of rows tid / c8, + R,
// ... (R = kThreads / c8) by cp.async into the upper half of the 32 bytes
// the group takes in f32, where widen_staged_bf16 later reads them.
template <int kOps>
__device__ __forceinline__ void stage_chunk_async_bf16(const Operands<bf16>& in, int chunk,
                                                       const Geo& g, float* slot) {
  const int p0 = chunk * g.pairs, np = chunk_pairs(g, chunk);
  const int c8 = g.c4 / 2;
  const int per_pass = kThreads / c8;
  const int c = threadIdx.x % c8, r0 = threadIdx.x / c8;
  if (r0 >= per_pass) return;
  const int slab = g.pairs * g.N * g.stride;
  for (int r = r0; r < np * g.N; r += per_pass) {
    const int pl = r / g.N, i = r - pl * g.N;
    const int pair = p0 + pl;
    const int b = pair / g.H, h = pair - b * g.H;
#pragma unroll
    for (int o = 0; o < kOps; ++o) {
      const bf16* row = in.src[o] + b * in.st[o].b + h * in.st[o].h + i * in.st[o].n;
      focal::cp_async16(slot + o * slab + r * g.stride + 8 * c + 4,
                        reinterpret_cast<const float*>(row + 8 * c), true);
    }
  }
}

// Widen the chunk's bf16 rows in a ring slot to f32 in place: each thread
// reads the 16 bytes it copied itself (stage_chunk_async_bf16's mapping)
// and writes the group's 8 floats over them, so it may do so right after
// its own cp_async_wait, before the chunk's barrier. q (operand 0) becomes
// bf16(q q_scale) where q_scale != 1 (q_scale is a bf16 value: the product
// of two is exact in f32, then rounded once).
template <int kOps>
__device__ __forceinline__ void widen_staged_bf16(int chunk, const Geo& g, float* slot,
                                                  float q_scale) {
  const int np = chunk_pairs(g, chunk);
  const int c8 = g.c4 / 2;
  const int per_pass = kThreads / c8;
  const int c = threadIdx.x % c8, r0 = threadIdx.x / c8;
  if (r0 >= per_pass) return;
  const int slab = g.pairs * g.N * g.stride;
  for (int r = r0; r < np * g.N; r += per_pass) {
#pragma unroll
    for (int o = 0; o < kOps; ++o) {
      float4* d = reinterpret_cast<float4*>(slot + o * slab + r * g.stride + 8 * c);
      const uint4 u = *reinterpret_cast<const uint4*>(d + 1);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
      float f[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // the lower bf16 of a word is the lower address
        f[2 * e] = __uint_as_float(w[e] << 16);
        f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
      if (o == 0 && q_scale != 1.f) {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = round_bf16(f[e] * q_scale);
      }
      d[0] = make_float4(f[0], f[1], f[2], f[3]);
      d[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
}

// A chunk's staging by element type, both by cp.async: f32 rows, or bf16
// rows that land_chunk widens.
template <int kOps>
__device__ __forceinline__ void stage_chunk(const Operands<float>& in, int chunk, const Geo& g,
                                            float* slot) {
  stage_chunk_async<kOps>(in, chunk, g, slot);
}

template <int kOps>
__device__ __forceinline__ void stage_chunk(const Operands<bf16>& in, int chunk, const Geo& g,
                                            float* slot) {
  stage_chunk_async_bf16<kOps>(in, chunk, g, slot);
}

// What a thread does to its own copies of a chunk once they have landed,
// before the chunk's barrier: scale the f32 q rows (scale_staged_q), or
// widen the bf16 rows to f32, q scaled and rounded (widen_staged_bf16).
template <class T, int kOps>
__device__ __forceinline__ void land_chunk(int chunk, const Geo& g, float* slot, float q_scale) {
  if (std::is_same<T, float>::value) {
    if (q_scale != 1.f) scale_staged_q(chunk, g, slot, q_scale);
  } else {
    widen_staged_bf16<kOps>(chunk, g, slot, q_scale);
  }
}

// dq as it leaves for d(qkv): times dq_scale in f32, or in bf16 the VJP of
// the caller's bf16 q * scale, bf16(bf16(dq) scale) (store4 rounds last).
template <class T>
__device__ __forceinline__ float4 scaled_dq(float4 a, float s) {
  if (std::is_same<T, float>::value) return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
  return make_float4(round_bf16(a.x) * s, round_bf16(a.y) * s, round_bf16(a.z) * s,
                     round_bf16(a.w) * s);
}

// ---------------------------------------------------------------------------
// forward (#6; #7 with kDropout)

// A persistent grid: block b takes chunks b, b + grid, ... of P (window,
// head) pairs. Each chunk's q, k and v are staged by cp.async into one slot
// of a two-deep ring while the block computes the chunk before it. Query
// row i of each pair: the scores, softmax and dropout in registers, then
// out_i = a_v v, written at the caller's strides `so`. One barrier a chunk:
// the one after a chunk's copies land (and its q is scaled) also frees the
// other slot, which the chunk before was read from, so the next chunk's
// copies are issued right after it. kN and kCols as in wattn_bwd; T the
// element type of q, k, v and out (float, or bf16: stage_chunk_async_bf16).
template <class T, int kN, int kCols, bool kDropout>
__device__ __forceinline__ void wattn_fwd(const Operands<T>& in, Strides so,
                                          const float* __restrict__ rel_bias,
                                          const float* __restrict__ mask, T* __restrict__ out,
                                          float q_scale, unsigned long long seed,
                                          unsigned threshold, float inv_keep, const Geo& g,
                                          int nW) {
  extern __shared__ float4 smem4[];
  const int N = kN < kMaxN ? kN : g.N, slab = g.pairs * N * g.stride;
  float* ring = reinterpret_cast<float*>(smem4);  // [2][q, k, v][P][N][stride]
  const int nchunks = (int)((g.total + g.pairs - 1) / g.pairs);

  stage_chunk<3>(in, blockIdx.x, g, ring);  // the grid is at most one block a chunk
  focal::cp_async_commit();

  int it = 0;
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x, ++it) {
    const int p0 = chunk * g.pairs, np = chunk_pairs(g, chunk);
    float* qs = ring + (it & 1) * 3 * slab;
    focal::cp_async_wait<0>();  // this thread's copies of the chunk have landed
    land_chunk<T, 3>(chunk, g, qs, q_scale);
    __syncthreads();  // and every thread's, scaled (widened); the other slot is free
    const int next = chunk + gridDim.x;
    if (next < nchunks)  // the next chunk's loads fly while this one computes
      stage_chunk<3>(in, next, g, ring + ((it + 1) & 1) * 3 * slab);
    focal::cp_async_commit();
    const float* ks = qs + slab;
    const float* vs = ks + slab;

    const Row t = thread_row(g, p0, np);
    const float* brow = rel_bias + (t.h * N + t.i) * N;
    const float* mrow = mask ? mask + ((size_t)(t.w % nW) * N + t.i) * N : nullptr;
    float bias[kN];  // the row's bias and mask, loaded ahead of the products
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (focal::key_in_row<kN>(j, N)) bias[j] = __ldg(brow + j);
    float mk[kN];
    if (mrow) {
#pragma unroll
      for (int j = 0; j < kN; ++j)
        if (focal::key_in_row<kN>(j, N)) mk[j] = __ldg(mrow + j);
    }
    unsigned kept = ~0u;
    if (kDropout)
      kept = focal::keep_bits_row(seed, (unsigned)t.w, t.h, t.i, N, threshold, t.lane, g.lanes);
    float p[kN];
    row_dots<kCols>(qs + t.r * g.stride, ks + t.pl * N * g.stride, g, t.lane, p);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (focal::key_in_row<kN>(j, N)) {
        p[j] += bias[j];
        if (mrow) p[j] += mk[j];
      }
    }
    focal::softmax_scores(p, N);
    if (kDropout) {
#pragma unroll
      for (int j = 0; j < kN; ++j)
        if (focal::key_in_row<kN>(j, N)) p[j] = (kept >> j) & 1u ? p[j] * inv_keep : 0.f;
    }
    const float* vb = vs + t.pl * N * g.stride;
    T* o = out + t.w * so.b + t.h * so.h + t.i * so.n;
    focal::for_lane_cols<kCols>(t.lane, g, [&](int c) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        if (focal::key_in_row<kN>(j, N)) {
          const float4 y = *reinterpret_cast<const float4*>(vb + j * g.stride + 4 * c);
          acc.x = fmaf(p[j], y.x, acc.x);
          acc.y = fmaf(p[j], y.y, acc.y);
          acc.z = fmaf(p[j], y.z, acc.z);
          acc.w = fmaf(p[j], y.w, acc.w);
        }
      }
      if (t.active) store4(o + 4 * c, acc);
    });
  }
}

template <int kN, int kCols, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
wattn_fwd_kernel(Operands<float> in, Strides so, const float* __restrict__ rel_bias,
                 const float* __restrict__ mask, float* __restrict__ out, float q_scale,
                 unsigned long long seed, unsigned threshold, float inv_keep, Geo g, int nW) {
  wattn_fwd<float, kN, kCols, kDropout>(in, so, rel_bias, mask, out, q_scale, seed, threshold,
                                        inv_keep, g, nW);
}

template <int kN, int kCols, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
wattn_fwd_bf16_kernel(Operands<bf16> in, Strides so, const float* __restrict__ rel_bias,
                      const float* __restrict__ mask, bf16* __restrict__ out, float q_scale,
                      unsigned long long seed, unsigned threshold, float inv_keep, Geo g, int nW) {
  wattn_fwd<bf16, kN, kCols, kDropout>(in, so, rel_bias, mask, out, q_scale, seed, threshold,
                                       inv_keep, g, nW);
}

// ---------------------------------------------------------------------------
// backward (#8; #9 with kDropout)

// Output element strides of the backward: dq, dk and dv as [B, H, N, hd]
// operands (contiguous, or the head columns of one d(qkv) [B, N, 3C]).
struct OutStrides {
  Strides dq, dk, dv;
};

// A persistent grid: block b takes chunks b, b + grid, ... of P (window,
// head) pairs. Each chunk's q, k, v and g are staged by cp.async into one
// slot of a two-deep ring while the block computes the chunk before it:
//   stage 1, query row i of each pair: the softmax p, d_attn = g_i . v_j,
//     the dropped weights a_v and the score gradients ds (both to shared
//     memory, [P][N][N]), and dq_i = ds k (times dq_scale);
//   stage 2, key row j: dk_j = sum_i ds[i][j] q_i, dv_j = sum_i a_v[i][j]
//     g_i, and the block's d rel_bias += ds of the chunk's pairs, in pair
//     order.
// Two barriers a chunk: the one after a chunk's copies land (and its q is
// scaled by q_scale) also frees the other slot and ds / a_v (read by the
// chunk before), so the next chunk's copies are issued right after it. kN
// = 9 is the 3 x 3 window's exact row tile, kN = kAttnMaxN any N up to 16;
// kCols > 0 unrolls a lane's kCols float4 columns (c4 = kCols G: 2 at hd
// 16, 32 and 64). T is the element type of q, k, v, g, dq, dk and dv.
template <class T, int kN, int kCols, bool kDropout>
__device__ __forceinline__ void wattn_bwd(const Operands<T>& in, const OutStrides& so,
                                          const float* __restrict__ rel_bias,
                                          const float* __restrict__ mask, T* __restrict__ dq,
                                          T* __restrict__ dk, T* __restrict__ dv, float q_scale,
                                          float dq_scale, float* __restrict__ dbias_part,
                                          unsigned long long seed, unsigned threshold,
                                          float inv_keep, const Geo& g, int nW) {
  extern __shared__ float4 smem4[];
  const int N = kN < kMaxN ? kN : g.N, nn = N * N, slab = g.pairs * N * g.stride;
  float* ring = reinterpret_cast<float*>(smem4);  // [2][q, k, v, g][P][N][stride]
  float* dss = ring + 8 * slab;                    // [P][N][N] score gradients
  float* avs = dss + g.pairs * nn;                 // [P][N][N] weights as applied to v
  float* dacc = avs + g.pairs * nn;                // [H][N][N] this block's d rel_bias
  const int nchunks = (int)((g.total + g.pairs - 1) / g.pairs);

  for (int e = threadIdx.x; e < g.H * nn; e += kThreads) dacc[e] = 0.f;
  stage_chunk<4>(in, blockIdx.x, g, ring);  // the grid is at most one block a chunk
  focal::cp_async_commit();

  int it = 0;
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x, ++it) {
    const int p0 = chunk * g.pairs, np = chunk_pairs(g, chunk);
    float* qs = ring + (it & 1) * 4 * slab;
    focal::cp_async_wait<0>();  // this chunk's copies have landed (each thread its own)
    land_chunk<T, 4>(chunk, g, qs, q_scale);
    __syncthreads();            // and every thread's; the other slot and ds / a_v are free
    const int next = chunk + gridDim.x;
    if (next < nchunks)  // the next chunk's loads fly while this one computes
      stage_chunk<4>(in, next, g, ring + ((it + 1) & 1) * 4 * slab);
    focal::cp_async_commit();
    const float* ks = qs + slab;
    const float* vs = ks + slab;
    const float* gs = vs + slab;

    // stage 1: query row i of pair pl
    const Row t = thread_row(g, p0, np);
    const float* brow = rel_bias + (t.h * N + t.i) * N;
    const float* mrow = mask ? mask + ((size_t)(t.w % nW) * N + t.i) * N : nullptr;
    float bias[kN];  // the row's bias and mask, loaded ahead of the products
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (focal::key_in_row<kN>(j, N)) bias[j] = __ldg(brow + j);
    float mk[kN];
    if (mrow) {
#pragma unroll
      for (int j = 0; j < kN; ++j)
        if (focal::key_in_row<kN>(j, N)) mk[j] = __ldg(mrow + j);
    }
    unsigned kept = ~0u;
    if (kDropout)
      kept = focal::keep_bits_row(seed, (unsigned)t.w, t.h, t.i, N, threshold, t.lane, g.lanes);
    const float* kb = ks + t.pl * N * g.stride;
    float p[kN], ds[kN];
    row_dots<kCols>(qs + t.r * g.stride, kb, g, t.lane, p);
    row_dots<kCols>(gs + t.r * g.stride, vs + t.pl * N * g.stride, g, t.lane, ds);  // d_attn
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (focal::key_in_row<kN>(j, N)) {
        p[j] += bias[j];
        if (mrow) p[j] += mk[j];
      }
    }
    focal::softmax_scores(p, N);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (focal::key_in_row<kN>(j, N)) {
        if (kDropout) ds[j] = (kept >> j) & 1u ? ds[j] * inv_keep : 0.f;  // da
        dot = fmaf(ds[j], p[j], dot);
      }
    }
    float* avrow = avs + t.r * N;
    float* dsrow = dss + t.r * N;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (focal::key_in_row<kN>(j, N)) {
        const float a_v = kDropout ? ((kept >> j) & 1u ? p[j] * inv_keep : 0.f) : p[j];
        ds[j] = p[j] * (ds[j] - dot);
        if (t.active && j % g.lanes == t.lane) {
          avrow[j] = a_v;
          dsrow[j] = ds[j];
        }
      }
    }
    T* dqo = dq + t.w * so.dq.b + t.h * so.dq.h + t.i * so.dq.n;
    focal::for_lane_cols<kCols>(t.lane, g, [&](int c) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        if (focal::key_in_row<kN>(j, N)) {
          const float4 y = *reinterpret_cast<const float4*>(kb + j * g.stride + 4 * c);
          acc.x = fmaf(ds[j], y.x, acc.x);
          acc.y = fmaf(ds[j], y.y, acc.y);
          acc.z = fmaf(ds[j], y.z, acc.z);
          acc.w = fmaf(ds[j], y.w, acc.w);
        }
      }
      if (t.active) store4(dqo + 4 * c, scaled_dq<T>(acc, dq_scale));
    });
    __syncthreads();

    // stage 2: key row j = t.i of pair pl
    if (t.active) {
      const int j = t.i;
      const float* dsc = dss + t.pl * nn + j;  // ds[.][j]
      const float* avc = avs + t.pl * nn + j;  // a_v[.][j]
      const float* qb = qs + t.pl * N * g.stride;
      const float* gb = gs + t.pl * N * g.stride;
      float dsj[kN], avj[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        if (focal::key_in_row<kN>(i, N)) {
          dsj[i] = dsc[i * N];
          avj[i] = avc[i * N];
        }
      }
      T* dko = dk + t.w * so.dk.b + t.h * so.dk.h + j * so.dk.n;
      T* dvo = dv + t.w * so.dv.b + t.h * so.dv.h + j * so.dv.n;
      focal::for_lane_cols<kCols>(t.lane, g, [&](int c) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          if (focal::key_in_row<kN>(i, N)) {
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
        store4(dko + 4 * c, a);
        store4(dvo + 4 * c, b);
      });
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

template <int kN, int kCols, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
wattn_bwd_kernel(Operands<float> in, OutStrides so, const float* __restrict__ rel_bias,
                 const float* __restrict__ mask, float* __restrict__ dq, float* __restrict__ dk,
                 float* __restrict__ dv, float q_scale, float dq_scale,
                 float* __restrict__ dbias_part, unsigned long long seed, unsigned threshold,
                 float inv_keep, Geo g, int nW) {
  wattn_bwd<float, kN, kCols, kDropout>(in, so, rel_bias, mask, dq, dk, dv, q_scale, dq_scale,
                                        dbias_part, seed, threshold, inv_keep, g, nW);
}

template <int kN, int kCols, bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
wattn_bwd_bf16_kernel(Operands<bf16> in, OutStrides so, const float* __restrict__ rel_bias,
                      const float* __restrict__ mask, bf16* __restrict__ dq, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, float q_scale, float dq_scale,
                      float* __restrict__ dbias_part, unsigned long long seed, unsigned threshold,
                      float inv_keep, Geo g, int nW) {
  wattn_bwd<bf16, kN, kCols, kDropout>(in, so, rel_bias, mask, dq, dk, dv, q_scale, dq_scale,
                                       dbias_part, seed, threshold, inv_keep, g, nW);
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

template <class T>
using FwdKernel = void (*)(Operands<T>, Strides, const float*, const float*, T*, float,
                           unsigned long long, unsigned, float, Geo, int);
template <class T>
using BwdKernel = void (*)(Operands<T>, OutStrides, const float*, const float*, T*, T*, T*, float,
                           float, float*, unsigned long long, unsigned, float, Geo, int);

// A kernel instance of element type T: the f32 kernels, or their bf16 twins.
template <class T, int kN, int kCols, bool kDropout>
FwdKernel<T> fwd_instance() {
  if constexpr (std::is_same<T, float>::value) return wattn_fwd_kernel<kN, kCols, kDropout>;
  else return wattn_fwd_bf16_kernel<kN, kCols, kDropout>;
}

template <class T, int kN, int kCols, bool kDropout>
BwdKernel<T> bwd_instance() {
  if constexpr (std::is_same<T, float>::value) return wattn_bwd_kernel<kN, kCols, kDropout>;
  else return wattn_bwd_bf16_kernel<kN, kCols, kDropout>;
}

// Each direction's instance: the exact 3 x 3 window tile with two float4
// columns a lane (hd 16, 32, 64 at N = 9), or any N and head width.
template <class T>
FwdKernel<T> fwd_kernel(const Geo& g, bool dropout) {
  if (g.N == 9 && g.c4 == 2 * g.lanes)
    return dropout ? fwd_instance<T, 9, 2, true>() : fwd_instance<T, 9, 2, false>();
  return dropout ? fwd_instance<T, kMaxN, 0, true>() : fwd_instance<T, kMaxN, 0, false>();
}

template <class T>
BwdKernel<T> bwd_kernel(const Geo& g, bool dropout) {
  if (g.N == 9 && g.c4 == 2 * g.lanes)
    return dropout ? bwd_instance<T, 9, 2, true>() : bwd_instance<T, 9, 2, false>();
  return dropout ? bwd_instance<T, kMaxN, 0, true>() : bwd_instance<T, kMaxN, 0, false>();
}

// A launch plan on the current device: make_geo's pairs a block, fewer
// where the ring does not fit a block's shared memory (the backward's from
// hd ~ 256 at N = 9); a persistent grid of as many blocks as fit the card
// at once, at most one a chunk. Deterministic for a geometry on a card, so
// the backward's d rel_bias partials (and their sum) are too.
template <class Kernel>
struct Plan {
  Geo geo;
  Kernel kernel;
  size_t smem;
  int grid;
  cudaError_t err;
};

template <class Kernel>
Plan<Kernel> make_plan(int B, int H, int N, int hd, bool dropout,
                       Kernel (*pick)(const Geo&, bool), size_t (*smem_floats)(const Geo&)) {
  Plan<Kernel> P{};
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  P.err = cudaGetDevice(&dev);
  if (P.err == cudaSuccess) P.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (P.err == cudaSuccess)
    P.err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (P.err != cudaSuccess) return P;
  P.geo = make_geo(B, H, N, hd);
  while (P.geo.pairs > 1 && smem_floats(P.geo) * sizeof(float) > (size_t)optin) --P.geo.pairs;
  P.smem = smem_floats(P.geo) * sizeof(float);
  if (P.smem > (size_t)optin) {
    P.err = cudaErrorInvalidValue;
    return P;
  }
  P.kernel = pick(P.geo, dropout);
  P.err = focal::raise_smem(P.kernel, P.smem);
  if (P.err == cudaSuccess)
    P.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, P.kernel, kThreads, P.smem);
  if (P.err == cudaSuccess && per_sm < 1) P.err = cudaErrorInvalidConfiguration;
  if (P.err != cudaSuccess) return P;
  const long long nchunks = (P.geo.total + P.geo.pairs - 1) / P.geo.pairs;
  P.grid = (int)std::min<long long>(nchunks, (long long)per_sm * sms);
  return P;
}

// make_plan, once a geometry and device (one cache a direction): its
// attribute and occupancy queries cost more host time than a small launch
// takes on the card.
template <class Kernel>
Plan<Kernel> cached_plan(int B, int H, int N, int hd, bool dropout,
                         Kernel (*pick)(const Geo&, bool), size_t (*smem_floats)(const Geo&)) {
  static std::mutex mutex;
  static std::map<std::array<int, 6>, Plan<Kernel>> plans;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return Plan<Kernel>{Geo{}, nullptr, 0, 0, err};
  const std::array<int, 6> key{dev, B, H, N, hd, (int)dropout};
  std::lock_guard<std::mutex> lock(mutex);
  const auto it = plans.find(key);
  if (it != plans.end()) return it->second;
  const Plan<Kernel> P = make_plan(B, H, N, hd, dropout, pick, smem_floats);
  if (P.err == cudaSuccess) plans.emplace(key, P);
  return P;
}

template <class T>
Plan<FwdKernel<T>> fwd_plan(int B, int H, int N, int hd, bool dropout) {
  return cached_plan(B, H, N, hd, dropout, fwd_kernel<T>, fwd_smem_floats);
}

template <class T>
Plan<BwdKernel<T>> bwd_plan(int B, int H, int N, int hd, bool dropout) {
  return cached_plan(B, H, N, hd, dropout, bwd_kernel<T>, bwd_smem_floats);
}

Strides strides_at(const long long* s, int k) { return Strides{s[3 * k], s[3 * k + 1], s[3 * k + 2]}; }

template <class T>
int wattn_fwd_launch(const void* q, const void* k, const void* v, const void* rel_bias,
                     const void* mask, void* out, const long long* strides, float q_scale, int B,
                     int H, int N, int hd, int nW, int dropout, unsigned long long seed,
                     unsigned threshold, float inv_keep, void* stream) {
  if (int e = check_geometry<T>(B, H, N, hd, mask, nW)) return e;
  if (B == 0) return 0;
  const Plan<FwdKernel<T>> P = fwd_plan<T>(B, H, N, hd, dropout != 0);
  if (P.err != cudaSuccess) return (int)P.err;
  const Operands<T> in{{static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), nullptr},
                       {strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
                        Strides{}}};
  P.kernel<<<P.grid, kThreads, P.smem, static_cast<cudaStream_t>(stream)>>>(
      in, strides_at(strides, 3), static_cast<const float*>(rel_bias),
      static_cast<const float*>(mask), static_cast<T*>(out), q_scale, seed, threshold, inv_keep,
      P.geo, mask != nullptr ? nW : 1);
  return (int)cudaGetLastError();
}

template <class T>
int wattn_bwd_workspace(int B, int H, int N, int hd, int dropout, long long* floats) {
  if (int e = check_geometry<T>(B, H, N, hd, nullptr, 1)) return e;
  if (B == 0) {
    *floats = 0;
    return 0;
  }
  const Plan<BwdKernel<T>> P = bwd_plan<T>(B, H, N, hd, dropout != 0);
  if (P.err != cudaSuccess) return (int)P.err;
  *floats = (long long)P.grid * H * N * N;
  return 0;
}

template <class T>
int wattn_bwd_launch(const void* q, const void* k, const void* v, const void* g_out,
                     const long long* strides, const void* rel_bias, const void* mask, void* dq,
                     void* dk, void* dv, const long long* out_strides, float q_scale,
                     float dq_scale, void* drel_bias, void* ws, int B, int H, int N, int hd,
                     int nW, int dropout, unsigned long long seed, unsigned threshold,
                     float inv_keep, void* stream) {
  if (int e = check_geometry<T>(B, H, N, hd, mask, nW)) return e;
  if (B == 0) return 0;
  const Plan<BwdKernel<T>> P = bwd_plan<T>(B, H, N, hd, dropout != 0);
  if (P.err != cudaSuccess) return (int)P.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  const Operands<T> in{{static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), static_cast<const T*>(g_out)},
                       {strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
                        strides_at(strides, 3)}};
  const OutStrides so{strides_at(out_strides, 0), strides_at(out_strides, 1),
                      strides_at(out_strides, 2)};
  P.kernel<<<P.grid, kThreads, P.smem, s>>>(
      in, so, static_cast<const float*>(rel_bias), static_cast<const float*>(mask),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), q_scale, dq_scale, part, seed,
      threshold, inv_keep, P.geo, mask != nullptr ? nW : 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int E = H * N * N;
  reduce_partials_kernel<<<(E + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, P.grid, E, static_cast<float*>(drel_bias));
  return (int)cudaGetLastError();
}

}  // namespace

// Forward: #6 (dropout 0) or #7 (dropout 1: each weight kept iff its Philox
// word, keyed by `seed`, is >= `threshold`, then scaled by `inv_keep`).
// q, k, v are device pointers to [B, H, N, hd] f32 with hd contiguous; q is
// multiplied by `q_scale` as it is staged (1 for q already scaled). out is
// a [B, H, N, hd] operand too: contiguous, or the head columns of one [B,
// N, C] tensor. `strides` holds the element strides over (B, H, N) of q, k,
// v and out, twelve in all (each a multiple of 4, pointers 16-byte
// aligned). rel_bias [H, N, N]; mask [nW, N, N] or null (window w takes
// mask[w % nW]). Launches on `stream`; returns cudaGetLastError() (0 on
// success), or the error of the launch plan.
extern "C" int focal_wattn_fwd(const void* q, const void* k, const void* v, const void* rel_bias,
                               const void* mask, void* out, const long long* strides,
                               float q_scale, int B, int H, int N, int hd, int nW, int dropout,
                               unsigned long long seed, unsigned threshold, float inv_keep,
                               void* stream) {
  return wattn_fwd_launch<float>(q, k, v, rel_bias, mask, out, strides, q_scale, B, H, N, hd, nW,
                                 dropout, seed, threshold, inv_keep, stream);
}

// #6-bf16 / #7-bf16: focal_wattn_fwd's arguments with q, k, v and out bf16
// (hd a multiple of 8; every stride a multiple of 8 elements and the
// pointers 16-byte aligned), rel_bias and mask f32. q_scale is rounded to
// bf16 here, and each q to bf16(q q_scale) as it is widened.
extern "C" int focal_wattn_fwd_bf16(const void* q, const void* k, const void* v,
                                    const void* rel_bias, const void* mask, void* out,
                                    const long long* strides, float q_scale, int B, int H, int N,
                                    int hd, int nW, int dropout, unsigned long long seed,
                                    unsigned threshold, float inv_keep, void* stream) {
  return wattn_fwd_launch<bf16>(q, k, v, rel_bias, mask, out, strides, round_bf16(q_scale), B, H,
                                N, hd, nW, dropout, seed, threshold, inv_keep, stream);
}

// Workspace of the backward, in floats, for this geometry on the current
// device: the blocks' d rel_bias partials. An error where it has no plan.
extern "C" int focal_wattn_bwd_workspace(int B, int H, int N, int hd, int dropout,
                                         long long* floats) {
  return wattn_bwd_workspace<float>(B, H, N, hd, dropout, floats);
}

// The workspace of focal_wattn_bwd_bf16 (its own plan), as above.
extern "C" int focal_wattn_bwd_workspace_bf16(int B, int H, int N, int hd, int dropout,
                                              long long* floats) {
  return wattn_bwd_workspace<bf16>(B, H, N, hd, dropout, floats);
}

// Backward: #8 (dropout 0) or #9 (dropout 1, the forward's mask drawn again
// from `seed`). q, k, v, g (the output's gradient) as focal_wattn_fwd's
// operands (q times `q_scale` as it is staged), twelve strides. dq, dk, dv:
// [B, H, N, hd] operands at the nine element strides `out_strides` (each a
// multiple of 4, pointers 16-byte aligned): contiguous, or the head columns
// of one d(qkv) [B, N, 3C]; dq (the gradient of the scaled q) is
// multiplied by dq_scale (the q scale, for the gradient of q before it;
// 1 for none). drel_bias [H, N, N]; `ws` holds focal_wattn_bwd_workspace
// floats. Two launches on `stream`: the persistent chunk kernel and the
// ordered sum of d rel_bias.
extern "C" int focal_wattn_bwd(const void* q, const void* k, const void* v, const void* g_out,
                               const long long* strides, const void* rel_bias, const void* mask,
                               void* dq, void* dk, void* dv, const long long* out_strides,
                               float q_scale, float dq_scale, void* drel_bias, void* ws, int B,
                               int H, int N, int hd, int nW, int dropout, unsigned long long seed,
                               unsigned threshold, float inv_keep, void* stream) {
  return wattn_bwd_launch<float>(q, k, v, g_out, strides, rel_bias, mask, dq, dk, dv, out_strides,
                                 q_scale, dq_scale, drel_bias, ws, B, H, N, hd, nW, dropout, seed,
                                 threshold, inv_keep, stream);
}

// #8-bf16 / #9-bf16: focal_wattn_bwd's arguments with q, k, v, g, dq, dk and
// dv bf16 (strides and pointers as focal_wattn_fwd_bf16's), `ws` holding
// focal_wattn_bwd_workspace_bf16 floats; drel_bias f32. q_scale and dq_scale
// are rounded to bf16 here; dq leaves as bf16(bf16(dq) dq_scale), the
// gradient of the caller's bf16 q before its bf16 multiply by the scale.
extern "C" int focal_wattn_bwd_bf16(const void* q, const void* k, const void* v,
                                    const void* g_out, const long long* strides,
                                    const void* rel_bias, const void* mask, void* dq, void* dk,
                                    void* dv, const long long* out_strides, float q_scale,
                                    float dq_scale, void* drel_bias, void* ws, int B, int H, int N,
                                    int hd, int nW, int dropout, unsigned long long seed,
                                    unsigned threshold, float inv_keep, void* stream) {
  return wattn_bwd_launch<bf16>(q, k, v, g_out, strides, rel_bias, mask, dq, dk, dv, out_strides,
                                round_bf16(q_scale), round_bf16(dq_scale), drel_bias, ws, B, H, N,
                                hd, nW, dropout, seed, threshold, inv_keep, stream);
}

// The keep mask #7 and #9 draw for `seed` at this geometry, written out as
// uint8 [B, H, N, N] (1 kept, 0 dropped): for the checks; the kernels
// themselves never store it.
extern "C" int focal_wattn_keep_mask(void* keep, int B, int H, int N, unsigned long long seed,
                                     unsigned threshold, void* stream) {
  if (int e = check_geometry<float>(B, H, N, 4, nullptr, 1)) return e;
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
