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
// (focal_wattn_fwd_bf16, focal_wattn_bwd_bf16; wattn_bf16_fwd_kernel,
// wattn_bf16_bwd_kernel) replace the same TPU kernels fed bf16 q, k, v and g
// (pk:119, :129, :189, :200), which upcast them to f32 first, compute as in
// f32 and store out, dq, dk and dv in the inputs' type (pk:235, :254-256),
// dbias in f32 (pk:257). Their rows move half the f32 kernels' bytes, so
// the bound halves; run as the f32 bodies on bf16 rows (widened to f32 in
// the ring), they took the f32 kernels' time (#9-bf16 2.02 ms a MOD step
// against a bound of 0.47 on the H100, diagnose_attention.py --bf16): the
// work inside the SM set the pace, and in bf16 it was the f32 work. These
// kernels cut that work:
//   * Rows stay bf16 in shared memory: copied 16 bytes at a time by
//     cp.async into a two-slot ring, at a row stride
//     of hd16 + 8 (hd rounded up to 16; the columns past hd zeroed once), no
//     widening pass; q scaled in place (bf16(q bf16(scale)): the rounding
//     of the JAX caller's bf16 `qkv[0] * scale`, focal_tpu/models/swin.py:270)
//     by the threads that copied it, before the chunk's barrier. A slot
//     takes as many pairs as fit kFwdSlotBytes / kBwdSlotBytes.
//   * The products run on the tensor cores, a (window, head) pair a 16 x 16
//     tile: its 9 (up to 16) rows and keys pad to 16, the rows past N
//     reading row N - 1 (ldmatrix's row addresses, clamped: finite values,
//     masked as keys and never stored as rows). Each product is
//     mma.sync.m16n8k16 bf16 with f32 accumulators fed by ldmatrix (.trans
//     for the operands read along their rows): q k^T and g v^T over hd16,
//     then per 16 columns out = a_v v, dq = ds k, dk = ds^T q, dv = a_v^T g.
//     q k^T and g v^T are exact (bf16 products, f32 sums). a_v and ds are
//     f32 in the TPU kernel: each is split into bf16 hi = bf16(x) and lo =
//     bf16(x - hi), two products into one accumulator (about 16
//     significant bits against the output's 8).
//   * The softmax works a row a lane: a warp takes its pairs grp = 32 / N
//     at a time (3 at N = 9), writes their scores (and d_attn) from the
//     accumulators to its scratch, and lane u N + i takes query row i of
//     pair u: bias, mask, softmax, the keep bits (philox.cuh's
//     attn_keep_row: #7's and #2's mask bit for bit), da, ds and a_v in f32
//     in registers, as the f32 bodies do; 27 of 32 lanes busy at N = 9,
//     where one pair's 16 x 16 accumulator tile holds 81 scores in 256
//     places. The lane writes its row's a_v (ds) back as bf16 hi and lo
//     tile rows over the scores; the products read them by ldmatrix, the
//     transposes by ldmatrix.trans, rows past N from a zero row.
//   * Outputs leave at the caller's strides as bf16 pairs, rounded once: out
//     into the proj Linear's [B, N, C] input, dq, dk, dv into d(qkv) [B, N,
//     3C], the q columns as bf16(bf16(dq) bf16(scale)), the VJP of that
//     multiply.
//   * drel_bias in f32: the row's lane writes ds to one of two [P][N][N]
//     buffers; after the next chunk's barrier the block adds the chunk's ds
//     head by head in pair order, and one ordered pass adds the blocks'
//     partials (gemm_splitk.cuh's reduce_partials_kernel): bitwise
//     repeatable, one barrier a chunk in both directions.
//   * The products do ~5 FLOP a byte in bf16, far under the card's bf16
//     ridge (~295): wgmma's 64-row tiles would have to pack seven windows
//     block-diagonally for nothing, and mma.sync's 16 x 16 tile already
//     takes a window whole.
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
#include "gemm_splitk.cuh"
#include "philox.cuh"
#include "window_rows.cuh"

namespace focal {
struct WindowAttentionSrc {};  // tags this library's instances of gemm_splitk.cuh's kernels
}  // namespace focal

namespace {

using Src = focal::WindowAttentionSrc;
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

// The f32 forward's shared memory: the two-slot ring of q, k, v rows.
size_t fwd_smem_bytes(const Geo& g) { return (size_t)6 * g.pairs * g.N * g.stride * sizeof(float); }

// The f32 backward's: the two-slot ring of q, k, v, g rows, ds and a_v
// [P][N][N], and the block's d rel_bias [H][N][N].
size_t bwd_smem_bytes(const Geo& g) {
  return ((size_t)8 * g.pairs * g.N * g.stride + (size_t)2 * g.pairs * g.N * g.N +
          (size_t)g.H * g.N * g.N) * sizeof(float);
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

// ---------------------------------------------------------------------------
// forward (#6; #7 with kDropout)

// A persistent grid: block b takes chunks b, b + grid, ... of P (window,
// head) pairs. Each chunk's q, k and v are staged by cp.async into one slot
// of a two-deep ring while the block computes the chunk before it. Query
// row i of each pair: the scores, softmax and dropout in registers, then
// out_i = a_v v, written at the caller's strides `so`. One barrier a chunk:
// the one after a chunk's copies land (and its q is scaled) also frees the
// other slot, which the chunk before was read from, so the next chunk's
// copies are issued right after it. kN and kCols as in wattn_bwd.
template <int kN, int kCols, bool kDropout>
__device__ __forceinline__ void wattn_fwd(const Operands<float>& in, Strides so,
                                          const float* __restrict__ rel_bias,
                                          const float* __restrict__ mask, float* __restrict__ out,
                                          float q_scale, unsigned long long seed,
                                          unsigned threshold, float inv_keep, const Geo& g,
                                          int nW) {
  extern __shared__ float4 smem4[];
  const int N = kN < kMaxN ? kN : g.N, slab = g.pairs * N * g.stride;
  float* ring = reinterpret_cast<float*>(smem4);  // [2][q, k, v][P][N][stride]
  const int nchunks = (int)((g.total + g.pairs - 1) / g.pairs);

  stage_chunk_async<3>(in, blockIdx.x, g, ring);  // the grid is at most one block a chunk
  focal::cp_async_commit();

  int it = 0;
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x, ++it) {
    const int p0 = chunk * g.pairs, np = chunk_pairs(g, chunk);
    float* qs = ring + (it & 1) * 3 * slab;
    focal::cp_async_wait<0>();  // this thread's copies of the chunk have landed
    if (q_scale != 1.f) scale_staged_q(chunk, g, qs, q_scale);
    __syncthreads();  // and every thread's, scaled; the other slot is free
    const int next = chunk + gridDim.x;
    if (next < nchunks)  // the next chunk's loads fly while this one computes
      stage_chunk_async<3>(in, next, g, ring + ((it + 1) & 1) * 3 * slab);
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
    float* o = out + t.w * so.b + t.h * so.h + t.i * so.n;
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
  wattn_fwd<kN, kCols, kDropout>(in, so, rel_bias, mask, out, q_scale, seed, threshold, inv_keep,
                                 g, nW);
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
// 16, 32 and 64).
template <int kN, int kCols, bool kDropout>
__device__ __forceinline__ void wattn_bwd(const Operands<float>& in, const OutStrides& so,
                                          const float* __restrict__ rel_bias,
                                          const float* __restrict__ mask, float* __restrict__ dq,
                                          float* __restrict__ dk, float* __restrict__ dv,
                                          float q_scale,
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
  stage_chunk_async<4>(in, blockIdx.x, g, ring);  // the grid is at most one block a chunk
  focal::cp_async_commit();

  int it = 0;
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x, ++it) {
    const int p0 = chunk * g.pairs, np = chunk_pairs(g, chunk);
    float* qs = ring + (it & 1) * 4 * slab;
    focal::cp_async_wait<0>();  // this chunk's copies have landed (each thread its own)
    if (q_scale != 1.f) scale_staged_q(chunk, g, qs, q_scale);
    __syncthreads();            // and every thread's; the other slot and ds / a_v are free
    const int next = chunk + gridDim.x;
    if (next < nchunks)  // the next chunk's loads fly while this one computes
      stage_chunk_async<4>(in, next, g, ring + ((it + 1) & 1) * 4 * slab);
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
    float* dqo = dq + t.w * so.dq.b + t.h * so.dq.h + t.i * so.dq.n;
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
      if (t.active)
        store4(dqo + 4 * c, make_float4(acc.x * dq_scale, acc.y * dq_scale, acc.z * dq_scale,
                                        acc.w * dq_scale));
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
      float* dko = dk + t.w * so.dk.b + t.h * so.dk.h + j * so.dk.n;
      float* dvo = dv + t.w * so.dv.b + t.h * so.dv.h + j * so.dv.n;
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
  wattn_bwd<kN, kCols, kDropout>(in, so, rel_bias, mask, dq, dk, dv, q_scale, dq_scale, dbias_part,
                                 seed, threshold, inv_keep, g, nW);
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

using FwdKernel = void (*)(Operands<float>, Strides, const float*, const float*, float*, float,
                           unsigned long long, unsigned, float, Geo, int);
using BwdKernel = void (*)(Operands<float>, OutStrides, const float*, const float*, float*, float*,
                           float*, float, float, float*, unsigned long long, unsigned, float, Geo,
                           int);

// Each f32 direction's instance: the exact 3 x 3 window tile with two
// float4 columns a lane (hd 16, 32, 64 at N = 9), or any N and head width.
FwdKernel fwd_kernel(const Geo& g, bool dropout) {
  if (g.N == 9 && g.c4 == 2 * g.lanes)
    return dropout ? wattn_fwd_kernel<9, 2, true> : wattn_fwd_kernel<9, 2, false>;
  return dropout ? wattn_fwd_kernel<kMaxN, 0, true> : wattn_fwd_kernel<kMaxN, 0, false>;
}

BwdKernel bwd_kernel(const Geo& g, bool dropout) {
  if (g.N == 9 && g.c4 == 2 * g.lanes)
    return dropout ? wattn_bwd_kernel<9, 2, true> : wattn_bwd_kernel<9, 2, false>;
  return dropout ? wattn_bwd_kernel<kMaxN, 0, true> : wattn_bwd_kernel<kMaxN, 0, false>;
}

// ---------------------------------------------------------------------------
// the bf16 kernels (#6-bf16 to #9-bf16): a window's products on tensor-core
// tiles, its softmax a row a lane

constexpr int kThreads16 = 128;  // threads of a bf16 block: four warps
constexpr int kWarps16 = kThreads16 / 32;
constexpr int kPairsMax = 64;    // pairs a chunk at most
constexpr int kTileRs = 24;      // a bf16 tile row's stride: 16 keys, 8 more for ldmatrix's banks
// A ring slot's bytes at most (the ring has two), so that several blocks,
// each with a slot of loads in flight, share an SM.
constexpr int kFwdSlotBytes = 26 * 1024;
constexpr int kBwdSlotBytes = 36 * 1024;

// Launch geometry of a bf16 call: rows of hd bf16 in shared memory at a
// stride of rs = hd16 + 8 elements (hd16: hd rounded up to 16, the depth of
// the products; the 8 more put the 8 rows an ldmatrix reads on 8 distinct
// 16-byte bank groups), chunks of P pairs; a warp's pairs taken grp at a
// time, so that grp N of its lanes hold a query row each in the row phase.
struct Geo16 {
  int B, H, N, hd;
  int hd16;         // hd rounded up to 16; columns hd .. hd16 - 1 are zeros
  int c8;           // hd / 8: a row's 16-byte groups
  int rs;           // shared-memory row stride in bf16, hd16 + 8
  int pairs;        // P: (window, head) pairs a chunk
  int grp;          // pairs a warp takes at once: min(8, 32 / N)
  int wbytes;       // a warp's scratch: scores, then tiles, and a zero row
  long long total;  // B * H pairs
};

// The geometry of a call whose ring slot holds `ops` operands: as many
// pairs a chunk as fit `slot_bytes`, a multiple of the block's warps times
// grp where that many fit; the warps' scratch for `scores` f32 [grp][N][N]
// tiles, then (over them) `tiles` bf16 [grp N][kTileRs] ones.
Geo16 make_geo16(int B, int H, int N, int hd, int ops, int slot_bytes, int scores, int tiles) {
  Geo16 g;
  g.B = B, g.H = H, g.N = N, g.hd = hd;
  g.hd16 = (hd + 15) / 16 * 16, g.c8 = hd / 8, g.rs = g.hd16 + 8;
  g.total = (long long)B * H;
  g.grp = std::min(8, 32 / N);
  const int unit = kWarps16 * g.grp;
  int p = slot_bytes / (ops * N * g.rs * (int)sizeof(bf16));
  if (p >= unit) p -= p % unit;
  g.pairs = std::max(1, std::min(p, kPairsMax));
  const int rows = g.grp * N;
  const int over = std::max(scores * rows * N * (int)sizeof(float),
                            tiles * rows * kTileRs * (int)sizeof(bf16));
  g.wbytes = (over + 15) / 16 * 16 + kTileRs * (int)sizeof(bf16);
  return g;
}

Geo16 fwd16_geo(int B, int H, int N, int hd) {
  return make_geo16(B, H, N, hd, 3, kFwdSlotBytes, 1, 2);  // scores; a_v hi, lo
}

Geo16 bwd16_geo(int B, int H, int N, int hd) {
  return make_geo16(B, H, N, hd, 4, kBwdSlotBytes, 2, 4);  // scores, d_attn; ds, a_v hi, lo
}

// The forward's shared memory: the two-slot ring of q, k, v rows and the
// warps' scratch.
size_t fwd16_smem_bytes(const Geo16& g) {
  return (size_t)6 * g.pairs * g.N * g.rs * sizeof(bf16) + (size_t)kWarps16 * g.wbytes;
}

// The backward's: the two-slot ring of q, k, v, g rows, the warps'
// scratch, two buffers of the chunk's ds [P][N][N] (f32) and the block's d
// rel_bias [H][N][N].
size_t bwd16_smem_bytes(const Geo16& g) {
  return (size_t)8 * g.pairs * g.N * g.rs * sizeof(bf16) +
         (size_t)kWarps16 * g.wbytes +
         ((size_t)2 * g.pairs * g.N * g.N + (size_t)g.H * g.N * g.N) * sizeof(float);
}

__device__ __forceinline__ int chunk_pairs16(const Geo16& g, int chunk) {
  return (int)min((long long)g.pairs, g.total - (long long)chunk * g.pairs);
}

__device__ __forceinline__ void cp_async16_bf16(bf16* smem, const bf16* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// The staging of one chunk: cp.async copies of its rows of the first kOps
// bf16 operands into a ring slot ([kOps][P][N][rs]), 16 bytes each. Thread
// tid copies group e % c8 of row e / c8 for e = tid, tid + kThreads16, ...
template <int kOps>
__device__ __forceinline__ void stage16(const Operands<bf16>& in, int chunk, const Geo16& g,
                                        bf16* slot) {
  const int p0 = chunk * g.pairs, n = chunk_pairs16(g, chunk) * g.N * g.c8;
  const int slab = g.pairs * g.N * g.rs;
  for (int e = threadIdx.x; e < n; e += kThreads16) {
    const int r = e / g.c8, c = e - r * g.c8;
    const int pl = r / g.N, i = r - pl * g.N;
    const int pair = p0 + pl;
    const int b = pair / g.H, h = pair - b * g.H;
#pragma unroll
    for (int o = 0; o < kOps; ++o)
      cp_async16_bf16(slot + o * slab + r * g.rs + 8 * c,
                      in.src[o] + b * in.st[o].b + h * in.st[o].h + i * in.st[o].n + 8 * c);
  }
}

// q (operand 0 of a slot) times `scale` in place, rounded to bf16: each
// thread the groups it copied itself (stage16's mapping), right after its
// own cp_async_wait. scale is a bf16 value: the product is exact in f32 and
// rounds once, as the caller's bf16 q * scale.
__device__ __forceinline__ void scale_q16(int chunk, const Geo16& g, bf16* slot, float scale) {
  const int n = chunk_pairs16(g, chunk) * g.N * g.c8;
  for (int e = threadIdx.x; e < n; e += kThreads16) {
    const int r = e / g.c8, c = e - r * g.c8;
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(slot + r * g.rs + 8 * c);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(x[u]);
      x[u] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
  }
}

// Zero columns hd .. hd16 - 1 of the ring's `rows` rows, and each warp's
// zero row (at the end of its scratch `wsp`), once: nothing writes them
// after, and the products read them.
__device__ __forceinline__ void zero_pads16(bf16* ring, int rows, const Geo16& g, char* wsp) {
  if (g.hd16 != g.hd)
    for (int r = threadIdx.x; r < rows; r += kThreads16)
      *reinterpret_cast<uint4*>(ring + r * g.rs + g.hd) = make_uint4(0u, 0u, 0u, 0u);
  const int lane = threadIdx.x % 32;
  if (lane < kTileRs / 8)
    reinterpret_cast<uint4*>(wsp + g.wbytes - kTileRs * sizeof(bf16))[lane] =
        make_uint4(0u, 0u, 0u, 0u);
}

// ---- the warp's tile operations (m16n8k16 fragments: lane = 4 gr + tq)

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a b, a 16 x 16 (row) and b 16 x 8 (column) bf16, c f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// s = a b^T for a pair's 16 x 16 tile: a's and b's rows at offsets offA and
// offB (the lane's ldmatrix row addresses), over hd16 columns, kKS k-steps
// of 16 (0: ks of them). s[n][0..1]: row gr, keys 8 n + 2 tq, + 1;
// s[n][2..3]: row gr + 8.
template <int kKS>
__device__ __forceinline__ void tile_dots(const bf16* a, const bf16* b, int offA, int offB, int ks,
                                          float (&s)[2][4]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) s[n][u] = 0.f;
  const int steps = kKS > 0 ? kKS : ks;
#pragma unroll
  for (int kk = 0; kk < steps; ++kk) {
    uint32_t fa[4], fb[4];
    ldsm_x4(fa, a + offA + 16 * kk);
    ldsm_x4(fb, b + offB + 16 * kk);
    mma_bf16(s[0], fa, fb[0], fb[1]);
    mma_bf16(s[1], fa, fb[2], fb[3]);
  }
}

// c = (hi + lo) b for columns n0 .. n0 + 15 of rows b (16 rows at the
// lane's ldmatrix.trans offset offT): two n8 accumulators, the lo product
// first.
__device__ __forceinline__ void tile_apply(const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                                           const bf16* b, int offT, int n0, float (&c)[2][4]) {
  uint32_t fb[4];
  ldsm_x4_trans(fb, b + offT + n0);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int u = 0; u < 4; ++u) c[n][u] = 0.f;
    mma_bf16(c[n], lo, fb[2 * n], fb[2 * n + 1]);
    mma_bf16(c[n], hi, fb[2 * n], fb[2 * n + 1]);
  }
}

// Store columns n0 .. n0 + 15 of a 16-row tile's rows < N (and columns <
// hd) as bf16 pairs at row pointer o (row i at o + i * ld); with kScale
// each value first rounded to bf16 and times `scale` (dq into d(qkv)).
template <bool kScale>
__device__ __forceinline__ void store_tile(const float (&c)[2][4], bf16* o, long long ld, int n0,
                                           int N, int hd, int gr, int tq, float scale) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int col = n0 + 8 * n + 2 * tq;
    if (col >= hd) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = gr + 8 * h;
      float x0 = c[n][2 * h], x1 = c[n][2 * h + 1];
      if (kScale) x0 = round_bf16(x0) * scale, x1 = round_bf16(x1) * scale;
      if (row < N) *reinterpret_cast<uint32_t*>(o + row * ld + col) = pack_bf16(x0, x1);
    }
  }
}

// The lane's ldmatrix row offsets into a pair's N rows in the ring (rows
// past N read row N - 1: finite values whose products are masked or never
// stored): offA for A operands and .trans B operands (row lane % 16,
// columns 8 (lane / 16) on), offB for non-transposed B operands (row lane %
// 8 + 8 (lane / 16), columns 8 (lane / 8 % 2) on).
struct Lane16 {
  int gr, tq, offA, offB;
};

__device__ __forceinline__ Lane16 lane16(const Geo16& g) {
  const int lane = threadIdx.x % 32;
  Lane16 l;
  l.gr = lane / 4, l.tq = lane % 4;
  l.offA = min(lane % 16, g.N - 1) * g.rs + 8 * (lane / 16);
  l.offB = min(lane % 8 + 8 * (lane / 16), g.N - 1) * g.rs + 8 * (lane / 8 % 2);
  return l;
}

// A pair's scores (rows and keys < N) from the accumulator fragments into
// its [N][N] f32 block of the warp's scratch.
__device__ __forceinline__ void store_scores(const float (&s)[2][4], float* dst, int N,
                                             const Lane16& l) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = l.gr + 8 * h;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int key = 8 * n + 2 * l.tq + u;
        if (row < N && key < N) dst[row * N + key] = s[n][2 * h + u];
      }
  }
}

__device__ __forceinline__ void load_row(const float* src, int N, float (&x)[kMaxN]) {
#pragma unroll
  for (int j = 0; j < kMaxN; ++j)
    if (j < N) x[j] = src[j];
}

// A row of f32 weights (keys < N; 0 past N) as bf16 hi = bf16(x) and lo =
// bf16(x - hi) tile rows, about 16 significant bits in all.
__device__ __forceinline__ void store_split_row(const float (&x)[kMaxN], int N, bf16* hi,
                                                bf16* lo) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 8 * c + 2 * u;
      const float x0 = j < N ? x[j] : 0.f, x1 = j + 1 < N ? x[j + 1] : 0.f;
      const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
      const float2 r = __bfloat1622float2(b);
      h[u] = *reinterpret_cast<const uint32_t*>(&b);
      l[u] = pack_bf16(x0 - r.x, x1 - r.y);
    }
    reinterpret_cast<uint4*>(hi)[c] = make_uint4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<uint4*>(lo)[c] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The lane's ldmatrix address into tile rows [u N, u N + N) of a group's
// tile (pair u), as an A operand (row lane % 16) or, with kTrans, as the
// .trans A operand of the tile's transpose (row lane % 8 + 8 (lane / 16)):
// rows past N read the warp's zero row.
template <bool kTrans>
__device__ __forceinline__ const bf16* tile_at(const bf16* tile, int u, int N, const bf16* zrow) {
  const int lane = threadIdx.x % 32;
  const int row = kTrans ? lane % 8 + 8 * (lane / 16) : lane % 16;
  const int col = kTrans ? 8 * (lane / 8 % 2) : 8 * (lane / 16);
  return (row < N ? tile + (u * N + row) * kTileRs : zrow) + col;
}

// ---------------------------------------------------------------------------
// bf16 forward (#6-bf16; #7-bf16 with kDropout)

// A persistent grid: block b takes chunks b, b + grid, ... of P (window,
// head) pairs, staged by cp.async into one slot of a two-deep ring while
// the block computes the chunk before it; one barrier a chunk (the one
// after a chunk's copies land, and its q is scaled, also frees the other
// slot). Warp w takes the chunk's pairs w, w + 4, ..., grp at a time:
// each pair's scores are one 16 x 16 tile on the tensor cores, written to
// the warp's scratch; then lane u N + i takes query row i of pair u: bias,
// mask, softmax and dropout in f32 in registers, a_v written back as bf16
// hi and lo tile rows (over the scores); then per pair out = a_v v, two
// products a 16 columns, stored at the caller's strides `so`. kKS: hd16 /
// 16 unrolled (0: any).
template <int kKS, bool kDropout>
__global__ void __launch_bounds__(kThreads16, 4)
wattn_bf16_fwd_kernel(Operands<bf16> in, Strides so, const float* __restrict__ rel_bias,
                      const float* __restrict__ mask, bf16* __restrict__ out, float q_scale,
                      unsigned long long seed, unsigned threshold, float inv_keep, Geo16 g, int nW) {
  extern __shared__ uint4 smem16[];
  const int N = g.N, nn = N * N, slab = g.pairs * N * g.rs, ks = g.hd16 / 16, rows = g.grp * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* ring = reinterpret_cast<bf16*>(smem16);  // [2][q, k, v][P][N][rs]
  char* wsp = reinterpret_cast<char*>(ring + 6 * slab) + warp * g.wbytes;
  float* sc = reinterpret_cast<float*>(wsp);  // [grp][N][N] scores, then over them:
  bf16* tl = reinterpret_cast<bf16*>(wsp);    // [a_v hi, lo][grp N][kTileRs]
  const bf16* zrow = reinterpret_cast<const bf16*>(wsp + g.wbytes) - kTileRs;
  const int nchunks = (int)((g.total + g.pairs - 1) / g.pairs);
  const Lane16 l = lane16(g);

  zero_pads16(ring, 6 * g.pairs * N, g, wsp);
  stage16<3>(in, blockIdx.x, g, ring);  // the grid is at most one block a chunk
  focal::cp_async_commit();

  int it = 0;
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x, ++it) {
    const int p0 = chunk * g.pairs, np = chunk_pairs16(g, chunk);
    bf16* qs0 = ring + (it & 1) * 3 * slab;
    focal::cp_async_wait<0>();  // this thread's copies of the chunk have landed
    // [phase 0]
    if (q_scale != 1.f) scale_q16(chunk, g, qs0, q_scale);
    // [phase 1]
    __syncthreads();  // and every thread's, q scaled; the other slot is free
    // [phase 2]
    const int next = chunk + gridDim.x;
    if (next < nchunks)  // the next chunk's loads fly while this one computes
      stage16<3>(in, next, g, ring + ((it + 1) & 1) * 3 * slab);
    focal::cp_async_commit();
    // [phase 3]
    const int mine = warp < np ? (np - warp + kWarps16 - 1) / kWarps16 : 0;
    for (int m0 = 0; m0 < mine; m0 += g.grp) {
      const int cnt = min(g.grp, mine - m0), pl0 = warp + kWarps16 * m0;
      __syncwarp();  // the group before is done with the scratch
      // [math]
      for (int u = 0; u < cnt; ++u) {
        const bf16* qs = qs0 + (pl0 + kWarps16 * u) * N * g.rs;
        float s[2][4];
        tile_dots<kKS>(qs, qs + slab, l.offA, l.offB, ks, s);
        store_scores(s, sc + u * nn, N, l);
      }
      __syncwarp();
      // [phase 4]
      const int ru = lane / N, ri = lane - ru * N;  // the lane's pair and query row
      float p[kMaxN];
      if (ru < cnt) load_row(sc + (ru * N + ri) * N, N, p);
      __syncwarp();  // every row is read: the tiles go over the scores
      if (ru < cnt) {
        const int pair = p0 + pl0 + kWarps16 * ru, w = pair / g.H, h = pair - w * g.H;
        focal::softmax_row(p, rel_bias + (h * N + ri) * N,
                           mask ? mask + ((size_t)(w % nW) * N + ri) * N : nullptr, N);
        if (kDropout) {
          bool kept[kMaxN];
          focal::attn_keep_row(seed, (unsigned)w, h, ri, N, threshold, kept);
#pragma unroll
          for (int j = 0; j < kMaxN; ++j)
            if (j < N) p[j] = kept[j] ? p[j] * inv_keep : 0.f;
        }
        store_split_row(p, N, tl + (ru * N + ri) * kTileRs, tl + (rows + ru * N + ri) * kTileRs);
      }
      __syncwarp();
      // [phase 5]
      for (int u = 0; u < cnt; ++u) {
        const int pl = pl0 + kWarps16 * u, pair = p0 + pl, w = pair / g.H, h = pair - w * g.H;
        uint32_t hi[4], lo[4];
        ldsm_x4(hi, tile_at<false>(tl, u, N, zrow));
        ldsm_x4(lo, tile_at<false>(tl + rows * kTileRs, u, N, zrow));
        const bf16* vs = qs0 + 2 * slab + pl * N * g.rs;
        bf16* o = out + w * so.b + h * so.h;
        const int groups = kKS > 0 ? kKS : ks;
#pragma unroll
        for (int c = 0; c < groups; ++c) {
          float acc[2][4];
          tile_apply(hi, lo, vs, l.offA, 16 * c, acc);
          store_tile<false>(acc, o, so.n, 16 * c, N, g.hd, l.gr, l.tq, 1.f);
        }
      }
      // [phase 6]
      // [end math]
    }
  }
  // [end]
}

// ---------------------------------------------------------------------------
// bf16 backward (#8-bf16; #9-bf16 with kDropout)

// The block's d rel_bias: element (h, i, j) adds ds of a chunk's pairs of
// head h in pair order (each element keeps its thread across chunks).
__device__ __forceinline__ void add_dbias16(const float* dss, int p0, int np, int H, int nn,
                                            float* dacc) {
  for (int e = threadIdx.x; e < H * nn; e += kThreads16) {
    const int h = e / nn, ij = e - h * nn;
    float acc = dacc[e];
    for (int pl = ((h - p0 % H) + H) % H; pl < np; pl += H) acc += dss[pl * nn + ij];
    dacc[e] = acc;
  }
}

// The forward's walk with q, k, v and g staged; warp w takes the chunk's
// pairs w, w + 4, ..., grp at a time: s = q k^T and d_attn = g v^T (two
// tiles a pair) into the warp's scratch; lane u N + i takes query row i of
// pair u: the softmax p, da (dropped as the forward's weights), ds = p (da -
// rowsum(da p)) and a_v in f32, written back as bf16 hi and lo tile rows
// (over the scores) and ds in f32 to one of two [P][N][N] buffers; then per
// pair dq = ds k, dk = ds^T q and dv = a_v^T g, the transposes read by
// ldmatrix.trans. After the next chunk's barrier the block adds the ds
// buffer to its d rel_bias in pair order (add_dbias16): one barrier a
// chunk, as the forward's.
template <int kKS, bool kDropout>
__global__ void __launch_bounds__(kThreads16, 3)
wattn_bf16_bwd_kernel(Operands<bf16> in, OutStrides so, const float* __restrict__ rel_bias,
                      const float* __restrict__ mask, bf16* __restrict__ dq, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, float q_scale, float dq_scale,
                      float* __restrict__ dbias_part, unsigned long long seed, unsigned threshold,
                      float inv_keep, Geo16 g, int nW) {
  extern __shared__ uint4 smem16[];
  const int N = g.N, nn = N * N, slab = g.pairs * N * g.rs, ks = g.hd16 / 16, rows = g.grp * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* ring = reinterpret_cast<bf16*>(smem16);  // [2][q, k, v, g][P][N][rs]
  char* scratch = reinterpret_cast<char*>(ring + 8 * slab);
  char* wsp = scratch + warp * g.wbytes;
  float* sc = reinterpret_cast<float*>(wsp);  // [scores, d_attn][grp][N][N], then over them:
  bf16* tl = reinterpret_cast<bf16*>(wsp);    // [ds hi, ds lo, a_v hi, a_v lo][grp N][kTileRs]
  const bf16* zrow = reinterpret_cast<const bf16*>(wsp + g.wbytes) - kTileRs;
  float* dss = reinterpret_cast<float*>(scratch + kWarps16 * g.wbytes);  // [2][P][N][N] ds
  float* dacc = dss + 2 * g.pairs * nn;  // [H][N][N] this block's d rel_bias
  const int nchunks = (int)((g.total + g.pairs - 1) / g.pairs);
  const Lane16 l = lane16(g);

  for (int e = threadIdx.x; e < g.H * nn; e += kThreads16) dacc[e] = 0.f;
  zero_pads16(ring, 8 * g.pairs * N, g, wsp);
  stage16<4>(in, blockIdx.x, g, ring);  // the grid is at most one block a chunk
  focal::cp_async_commit();

  int prev_p0 = 0, prev_np = 0;
  int it = 0;
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x, ++it) {
    const int p0 = chunk * g.pairs, np = chunk_pairs16(g, chunk);
    bf16* qs0 = ring + (it & 1) * 4 * slab;
    focal::cp_async_wait<0>();  // this thread's copies of the chunk have landed
    // [phase 0]
    if (q_scale != 1.f) scale_q16(chunk, g, qs0, q_scale);
    // [phase 1]
    __syncthreads();  // and every thread's; the other slot and ds buffer are free
    // [phase 2]
    const int next = chunk + gridDim.x;
    if (next < nchunks)  // the next chunk's loads fly while this one computes
      stage16<4>(in, next, g, ring + ((it + 1) & 1) * 4 * slab);
    focal::cp_async_commit();
    if (it > 0) add_dbias16(dss + ((it - 1) & 1) * g.pairs * nn, prev_p0, prev_np, g.H, nn, dacc);
    float* dsb = dss + (it & 1) * g.pairs * nn;
    // [phase 3]
    const int mine = warp < np ? (np - warp + kWarps16 - 1) / kWarps16 : 0;
    for (int m0 = 0; m0 < mine; m0 += g.grp) {
      const int cnt = min(g.grp, mine - m0), pl0 = warp + kWarps16 * m0;
      __syncwarp();  // the group before is done with the scratch
      // [math]
      for (int u = 0; u < cnt; ++u) {
        const bf16* qs = qs0 + (pl0 + kWarps16 * u) * N * g.rs;
        float s[2][4];
        tile_dots<kKS>(qs, qs + slab, l.offA, l.offB, ks, s);
        store_scores(s, sc + u * nn, N, l);
        tile_dots<kKS>(qs + 3 * slab, qs + 2 * slab, l.offA, l.offB, ks, s);  // d_attn = g v^T
        store_scores(s, sc + (g.grp + u) * nn, N, l);
      }
      __syncwarp();
      // [phase 4]
      const int ru = lane / N, ri = lane - ru * N;  // the lane's pair and query row
      float p[kMaxN], da[kMaxN];
      if (ru < cnt) {
        load_row(sc + (ru * N + ri) * N, N, p);
        load_row(sc + ((g.grp + ru) * N + ri) * N, N, da);
      }
      __syncwarp();  // every row is read: the tiles go over the scores
      if (ru < cnt) {
        const int pl = pl0 + kWarps16 * ru, pair = p0 + pl, w = pair / g.H, h = pair - w * g.H;
        focal::softmax_row(p, rel_bias + (h * N + ri) * N,
                           mask ? mask + ((size_t)(w % nW) * N + ri) * N : nullptr, N);
        bool kept[kMaxN];
        if (kDropout) focal::attn_keep_row(seed, (unsigned)w, h, ri, N, threshold, kept);
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxN; ++j) {
          if (j < N) {
            if (kDropout) da[j] = kept[j] ? da[j] * inv_keep : 0.f;
            dot = fmaf(da[j], p[j], dot);
          }
        }
        float* dsrow = dsb + pl * nn + ri * N;
#pragma unroll
        for (int j = 0; j < kMaxN; ++j) {
          if (j < N) {
            da[j] = p[j] * (da[j] - dot);  // ds
            dsrow[j] = da[j];
            if (kDropout) p[j] = kept[j] ? p[j] * inv_keep : 0.f;  // a_v
          }
        }
        const int r = ru * N + ri;
        store_split_row(da, N, tl + r * kTileRs, tl + (rows + r) * kTileRs);
        store_split_row(p, N, tl + (2 * rows + r) * kTileRs, tl + (3 * rows + r) * kTileRs);
      }
      __syncwarp();
      // [phase 5]
      for (int u = 0; u < cnt; ++u) {
        const int pl = pl0 + kWarps16 * u, pair = p0 + pl, w = pair / g.H, h = pair - w * g.H;
        const bf16* qs = qs0 + pl * N * g.rs;
        const int groups = kKS > 0 ? kKS : ks;
        uint32_t hi[4], lo[4];
        ldsm_x4(hi, tile_at<false>(tl, u, N, zrow));
        ldsm_x4(lo, tile_at<false>(tl + rows * kTileRs, u, N, zrow));
        bf16* dqo = dq + w * so.dq.b + h * so.dq.h;
#pragma unroll
        for (int c = 0; c < groups; ++c) {
          float acc[2][4];
          tile_apply(hi, lo, qs + slab, l.offA, 16 * c, acc);  // ds k
          store_tile<true>(acc, dqo, so.dq.n, 16 * c, N, g.hd, l.gr, l.tq, dq_scale);
        }
        // [phase 6]
        uint32_t ahi[4], alo[4];
        ldsm_x4_trans(hi, tile_at<true>(tl, u, N, zrow));  // ds^T
        ldsm_x4_trans(lo, tile_at<true>(tl + rows * kTileRs, u, N, zrow));
        ldsm_x4_trans(ahi, tile_at<true>(tl + 2 * rows * kTileRs, u, N, zrow));  // a_v^T
        ldsm_x4_trans(alo, tile_at<true>(tl + 3 * rows * kTileRs, u, N, zrow));
        bf16* dko = dk + w * so.dk.b + h * so.dk.h;
        bf16* dvo = dv + w * so.dv.b + h * so.dv.h;
#pragma unroll
        for (int c = 0; c < groups; ++c) {
          float acc[2][4];
          tile_apply(hi, lo, qs, l.offA, 16 * c, acc);
          store_tile<false>(acc, dko, so.dk.n, 16 * c, N, g.hd, l.gr, l.tq, 1.f);
          tile_apply(ahi, alo, qs + 3 * slab, l.offA, 16 * c, acc);
          store_tile<false>(acc, dvo, so.dv.n, 16 * c, N, g.hd, l.gr, l.tq, 1.f);
        }
        // [phase 7]
      }
      // [end math]
    }
    prev_p0 = p0, prev_np = np;
  }
  __syncthreads();  // the last chunk's ds
  if (it > 0) add_dbias16(dss + ((it - 1) & 1) * g.pairs * nn, prev_p0, prev_np, g.H, nn, dacc);
  for (int e = threadIdx.x; e < g.H * nn; e += kThreads16)
    dbias_part[(size_t)blockIdx.x * g.H * nn + e] = dacc[e];
  // [end]
}

// ---------------------------------------------------------------------------
// bf16 kernel instances
using FwdKernel16 = void (*)(Operands<bf16>, Strides, const float*, const float*, bf16*, float,
                             unsigned long long, unsigned, float, Geo16, int);
using BwdKernel16 = void (*)(Operands<bf16>, OutStrides, const float*, const float*, bf16*, bf16*,
                             bf16*, float, float, float*, unsigned long long, unsigned, float, Geo16,
                             int);

// Each direction's instance: hd16 / 16 = 1, 2 or 4 k-steps unrolled (hd 16,
// 32, 64 and the widths that pad to them), or any.
template <bool kDropout>
FwdKernel16 fwd16_instance(int steps) {
  switch (steps) {
    case 1: return wattn_bf16_fwd_kernel<1, kDropout>;
    case 2: return wattn_bf16_fwd_kernel<2, kDropout>;
    case 4: return wattn_bf16_fwd_kernel<4, kDropout>;
    default: return wattn_bf16_fwd_kernel<0, kDropout>;
  }
}

template <bool kDropout>
BwdKernel16 bwd16_instance(int steps) {
  switch (steps) {
    case 1: return wattn_bf16_bwd_kernel<1, kDropout>;
    case 2: return wattn_bf16_bwd_kernel<2, kDropout>;
    case 4: return wattn_bf16_bwd_kernel<4, kDropout>;
    default: return wattn_bf16_bwd_kernel<0, kDropout>;
  }
}

FwdKernel16 fwd16_kernel(const Geo16& g, bool dropout) {
  return dropout ? fwd16_instance<true>(g.hd16 / 16) : fwd16_instance<false>(g.hd16 / 16);
}

BwdKernel16 bwd16_kernel(const Geo16& g, bool dropout) {
  return dropout ? bwd16_instance<true>(g.hd16 / 16) : bwd16_instance<false>(g.hd16 / 16);
}

// ---------------------------------------------------------------------------
// launch plans

// A launch plan on the current device: the geometry's pairs a chunk, fewer
// where the shared memory does not fit a block (the f32 backward's from hd
// ~ 256 at N = 9); a persistent grid of as many blocks as fit the card at
// once, at most one a chunk. Deterministic for a geometry on a card, so
// the backward's d rel_bias partials (and their sum) are too.
template <class G, class Kernel>
struct Plan {
  G geo;
  Kernel kernel;
  size_t smem;
  int threads, grid;
  cudaError_t err;
};

template <class G, class Kernel>
Plan<G, Kernel> make_plan(G geo, bool dropout, Kernel (*pick)(const G&, bool),
                          size_t (*smem_bytes)(const G&), int threads) {
  Plan<G, Kernel> P{};
  P.threads = threads;
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  P.err = cudaGetDevice(&dev);
  if (P.err == cudaSuccess) P.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (P.err == cudaSuccess)
    P.err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (P.err != cudaSuccess) return P;
  P.geo = geo;
  while (P.geo.pairs > 1 && smem_bytes(P.geo) > (size_t)optin) --P.geo.pairs;
  P.smem = smem_bytes(P.geo);
  if (P.smem > (size_t)optin) {
    P.err = cudaErrorInvalidValue;
    return P;
  }
  P.kernel = pick(P.geo, dropout);
  P.err = focal::raise_smem(P.kernel, P.smem);
  if (P.err == cudaSuccess)
    P.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, P.kernel, threads, P.smem);
  if (P.err == cudaSuccess && per_sm < 1) P.err = cudaErrorInvalidConfiguration;
  if (P.err != cudaSuccess) return P;
  const long long nchunks = (P.geo.total + P.geo.pairs - 1) / P.geo.pairs;
  P.grid = (int)std::min<long long>(nchunks, (long long)per_sm * sms);
  return P;
}

// make(), once a geometry and device (one cache a kind of plan): its
// attribute and occupancy queries cost more host time than a small launch
// takes on the card.
template <class PlanT, class Make>
PlanT cached_plan(int B, int H, int N, int hd, bool dropout, const Make& make) {
  static std::mutex mutex;
  static std::map<std::array<int, 6>, PlanT> plans;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    PlanT P{};
    P.err = err;
    return P;
  }
  const std::array<int, 6> key{dev, B, H, N, hd, (int)dropout};
  std::lock_guard<std::mutex> lock(mutex);
  const auto it = plans.find(key);
  if (it != plans.end()) return it->second;
  const PlanT P = make();
  if (P.err == cudaSuccess) plans.emplace(key, P);
  return P;
}

// Each element type's plans: the f32 kernels on Geo, the bf16 ones on Geo16.
template <class T>
auto fwd_plan(int B, int H, int N, int hd, bool dropout) {
  if constexpr (std::is_same<T, float>::value)
    return cached_plan<Plan<Geo, FwdKernel>>(B, H, N, hd, dropout, [=] {
      return make_plan(make_geo(B, H, N, hd), dropout, fwd_kernel, fwd_smem_bytes, kThreads);
    });
  else
    return cached_plan<Plan<Geo16, FwdKernel16>>(B, H, N, hd, dropout, [=] {
      return make_plan(fwd16_geo(B, H, N, hd), dropout, fwd16_kernel, fwd16_smem_bytes,
                       kThreads16);
    });
}

template <class T>
auto bwd_plan(int B, int H, int N, int hd, bool dropout) {
  if constexpr (std::is_same<T, float>::value)
    return cached_plan<Plan<Geo, BwdKernel>>(B, H, N, hd, dropout, [=] {
      return make_plan(make_geo(B, H, N, hd), dropout, bwd_kernel, bwd_smem_bytes, kThreads);
    });
  else
    return cached_plan<Plan<Geo16, BwdKernel16>>(B, H, N, hd, dropout, [=] {
      return make_plan(bwd16_geo(B, H, N, hd), dropout, bwd16_kernel, bwd16_smem_bytes,
                       kThreads16);
    });
}

Strides strides_at(const long long* s, int k) { return Strides{s[3 * k], s[3 * k + 1], s[3 * k + 2]}; }

template <class T>
int wattn_fwd_launch(const void* q, const void* k, const void* v, const void* rel_bias,
                     const void* mask, void* out, const long long* strides, float q_scale, int B,
                     int H, int N, int hd, int nW, int dropout, unsigned long long seed,
                     unsigned threshold, float inv_keep, void* stream) {
  if (int e = check_geometry<T>(B, H, N, hd, mask, nW)) return e;
  if (B == 0) return 0;
  const auto P = fwd_plan<T>(B, H, N, hd, dropout != 0);
  if (P.err != cudaSuccess) return (int)P.err;
  const Operands<T> in{{static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), nullptr},
                       {strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
                        Strides{}}};
  P.kernel<<<P.grid, P.threads, P.smem, static_cast<cudaStream_t>(stream)>>>(
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
  const auto P = bwd_plan<T>(B, H, N, hd, dropout != 0);
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
  const auto P = bwd_plan<T>(B, H, N, hd, dropout != 0);
  if (P.err != cudaSuccess) return (int)P.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  const Operands<T> in{{static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), static_cast<const T*>(g_out)},
                       {strides_at(strides, 0), strides_at(strides, 1), strides_at(strides, 2),
                        strides_at(strides, 3)}};
  const OutStrides so{strides_at(out_strides, 0), strides_at(out_strides, 1),
                      strides_at(out_strides, 2)};
  P.kernel<<<P.grid, P.threads, P.smem, s>>>(
      in, so, static_cast<const float*>(rel_bias), static_cast<const float*>(mask),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), q_scale, dq_scale, part, seed,
      threshold, inv_keep, P.geo, mask != nullptr ? nW : 1);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)focal::launch_reduce<Src>(part, P.grid, (size_t)H * N * N,
                                        static_cast<float*>(drel_bias), s);
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
