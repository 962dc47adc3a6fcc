// Whole-block Swin window attention for Hopper (sm_90a): the eval forward
// (#1), the training forward with attention dropout (#2) and its backward
// (#3), and the same pair for the blocks the JAX package routes to its
// per-head kernels (#4 forward, with or without dropout; #5 backward).
//
// Replaces the TPU kernels of focal_tpu/ops/pallas_kernels.py:
//   #1 _wblock_fwd_kernel (fused_window_block -> _wblock_fwd_impl -> pl.pallas_call)
//   #2 the same kernel with rate > 0 (fused_window_block_dropout), which also
//      writes its keep mask out
//   #3 _wblock_bwd_kernel (_wblock_bwd_impl -> pl.pallas_call), the VJP of both
//   #4 _wblock_ph_fwd_kernel (_wblock_ph_fwd_impl -> pl.pallas_call), with
//      and without dropout
//   #5 _wblock_ph_bwd_kernel (_wblock_ph_bwd_impl -> pl.pallas_call)
//   #4-TP, #5-TP: #4 and #5 on a tensor-parallel shard's heads
//      (sharded_window_block_tp -> _sharded_wblock_tp_op), the f32 code below
//      at an inner width D = H hd below C: Wqkv [C, 3D], Wproj [D, C], the
//      attention over the shard's H heads; y and dx are partial sums that the
//      caller adds over the model ranks (D = C for #1-#5)
//   #4-TP-bf16, #5-TP-bf16: the same in bf16 (sharded_window_block_tp fed
//      bf16), the bf16 code below at the inner width D
// Per window w of x [B, N, C] (f32, row-major):
//   qkv = x Wqkv + bqkv                      (q columns pre-scaled by the caller)
//   a_h = softmax(q_h k_h^T + rel_bias[h] + mask[w % nW])   for each head h
//   a_h = keep ? a_h / (1 - rate) : 0        (training with dropout)
//   y   = concat_h(a_h v_h) Wproj + bproj
//
// What bounds them on this card: operations. A window does 2*9*C*4C
// multiply-adds of projection in the forward (2*9*C*11C in the backward) for
// 9*C*2 floats of activations in and out: at C = 64..1024 that is 69-900
// FLOP per byte, above the f32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s =
// 20 FLOP/byte) and the TF32 tensor-core ridge (495 TFLOP/s, 148 FLOP/byte)
// at C >= 256. About 99 % of the FLOPs are the projections.
//
// The TPU kernels walk a lane-tile of 128 windows in VMEM, so each weight
// they load feeds a thousand rows. Kept per window, as the first port did,
// a block held one to eight windows and fetched each weight from L2 for
// 9-72 FMAs on the CUDA cores: 5-8 TFLOP/s. Here the per-window fusion is
// dropped for the card's shape, at every width and for all five kernels:
//   * The projections are matrix products over all R = B N rows of the
//     launch, 128 x 128 output tiles a block (128 x 64 where a product's
//     width is not a multiple of 128: C = 64), staged by a 3-deep cp.async
//     ring and run on the tensor cores with mma.sync (gemm_3xtf32.cuh). Each
//     staged weight feeds 128 rows. 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi
//     b_hi) keeps f32 accuracy: the ~1e-4 gates of f32 hold; one TF32
//     product would not. Bound on these units: 3x the FLOPs at 495 TFLOP/s.
//       forward (#1, #2, #4): qkv = x Wqkv + bqkv into a workspace [R, 3C];
//           the attention into ao [R, C]; y = ao Wproj + bproj. #1 is the
//           instance without dropout (no keep mask written).
//       backward (#3, #5): qkv and g = dy Wproj^T (one launch); the
//           attention backward (dq | dk | dv into [R, 3C], the attention
//           output into [R, C]); dx = dqkv Wqkv^T; the weight gradients x^T
//           dqkv and ao^T dy with their column sums as fixed split-K
//           partials (A read transposed in the tile loads: no copies); the
//           ordered reductions (gemm_splitk.cuh, shared with #12).
//     What sets their pace, even at C = 64, is the throughput of three
//     mma.sync passes (~45 TFLOP/s of f32 work on the H100), not the
//     workspaces' round trip (~10 C floats a row forward, ~24 C backward):
//     at C = 64 the products take ~4x the time their bytes need.
//   * The attention (<2 % of the FLOPs, bound by bytes) is the row-parallel
//     design of the attention-only kernels #6-#9 (window_rows.cuh): a block
//     stages a few (window, head) pairs' rows, G lanes a query row, scores
//     and softmax in registers. Any head width: one that is not a multiple
//     of 4 is staged by scalar loads, zero-padded, and written back by
//     scalar stores; a head too wide for kThreads / (N G) pairs' rows in
//     shared memory takes fewer pairs a block. Dropout bits come from
//     Philox4x32-10 keyed by the seed and counted by (window, head, row)
//     (philox.cuh, shared with #7 and #9): the forward writes the mask as
//     uint8 [B, H, N, N], the backward reads it back.
//   * No float atomics anywhere: the same bits on every call.
//   * #1, #2 and #4 (and #3 and #5) run the same code; they differ in the
//     geometries and rates the Python side routes to them (wblock_fits, the
//     JAX package's gate) and in their launch counts.
//   * Not yet: wgmma and TMA (the tf32 wgmma takes K-major operands only;
//     wqkv_t and wproj_t are that layout already), and fusing the attention
//     into the projections' epilogues.
//
// The bf16 forms (-compute_dtype bfloat16): #1-bf16 and #2-bf16 (the forward
// at rate 0 and with dropout) and #3-bf16 (their backward), and #4-bf16 and
// #5-bf16 (the same code at the per-head geometries, whose TPU kernels fed
// bf16 round at the same points), replace the same TPU kernels fed bf16
// operands (pk:908-938, 971-1072: bf16 dots with f32 accumulation, the
// softmax in f32), rounding where they round: qkv = x Wqkv + bqkv kept in
// f32; the attention output rounded to bf16 before the output projection;
// y = ao Wproj + bproj stored as bf16; in the backward qkv and g = dy
// Wproj^T recomputed in f32, the softmax and its gradient in f32, dq, dk,
// dv and the attention output rounded to bf16 before the dx and weight
// products, dbqkv and d rel_bias summed from the f32 values, dbproj the f32
// sum of dy, dx stored as bf16.
//   * The forward (#1-, #2-, #4-bf16; wblock_fwd_bf16) is built for Hopper.
//     What bounds it: operations for the products (8 N C^2 FLOPs a window at
//     989 TFLOP/s), bytes for the attention (its f32 qkv in, its bf16 ao
//     out: 14 bytes a row and column). Three launches, on the backward's
//     pieces:
//       (a) qkv = x Wqkv + bqkv (f32) on wgmma: wb_wg_qkvg_kernel's problem
//           0 alone, Wqkv read MN-major as it lies, the bias added in the
//           epilogue, each f32 tile staged in shared memory and stored by
//           TMA (store_tile: a third faster than stores from registers);
//       (b) the attention (attn_fwd_bf16_kernel) on the persistent two-slot
//           cp.async ring (ring_walk, stage_chunk_async from the f32 qkv;
//           the exact 9-key row tile): the softmax and dropout in f32, the
//           keep mask written as uint8 [B, H, N, N], ao rounded once to
//           bf16 into [R, C] (half the bytes of f32). A head too wide for
//           two slots takes fewer pairs, then one slot;
//       (c) y = ao Wproj + bproj on wgmma, ao read by TMA, Wproj MN-major as
//           it lies; the bias added in f32, each value rounded to bf16 once
//           and stored by TMA (store_tile, as dx of the backward).
//   * The backward (#3-bf16, #5-bf16; wblock_bwd_bf16) is built for Hopper.
//     What bounds it: operations for the products (22 N C^2 FLOPs a window
//     at 989 TFLOP/s), bytes for the attention (its f32 qkv and g in, its
//     bf16 dq | dk | dv and ao out: 24 bytes a row and column, ~2 FLOPs a
//     byte). What the design does about it, in five launches:
//       (a) qkv = x Wqkv + bqkv and g = dy Wproj^T (f32) in one launch of two
//           problems on gemm_wgmma.cuh's core: TMA into 128-byte-swizzled
//           rings, one producer and two consumer warpgroups, wgmma
//           m64nNk16 with f32 sums; Wqkv read MN-major and Wproj K-major as
//           they lie (streamed_tiles' per-problem B order), so no transposed
//           copy of either is made or kept; the f32 tiles stored by TMA;
//       (b) the attention backward (attn_bwd_bf16_kernel) on #8/#9's design,
//           through window_rows.cuh (Operands and stage_chunk_async, which
//           #6-#9 share; ring_walk, their walk as a function: a persistent
//           grid over chunks of (window, head) pairs, a two-slot cp.async
//           ring; the exact 9-key row tile; row_dots and the softmax): the
//           keep mask read back, dq, dk, dv
//           and ao rounded once to bf16 into [R, 3C] and [R, C] as the
//           products read them by TMA (half the bytes of f32), and the f32
//           sums as per-block partials in pair order: d rel_bias, dbqkv and
//           dbproj (the block's share of dy's rows). A head too wide for two
//           slots takes fewer pairs, then one slot (the gate's own shared
//           memory: wblock_takes admits what it admitted);
//       (c) dx = dqkv Wqkv^T on wgmma, stored as bf16 by TMA;
//       (d) dWqkv = x^T dqkv and dWproj = ao^T dy on wgmma over fixed row
//           splits, all four operands MN-major as they lie (gemm_wgmma.cuh's
//           wg_wgrad_kernel, shared with #12-bf16);
//       (e) one ordered reduction (wg_reduce_kernel): the weights over the
//           splits in split order, the three sums over the attention's
//           blocks in block order. No float atomics: two calls give the same
//           bits.
//   * At an inner width D < C (#4-TP-bf16, #5-TP-bf16: a tensor-parallel
//     shard's H heads, Wqkv [C, 3D], Wproj [D, C]) the same launches: the
//     qkv and g products D-wide (3D and D columns), the attention's rows
//     3D and D wide, y's and dx's products over K = D and 3D (TMA's zero
//     fill past an edge pads a K or N below a box: no narrow plan of its
//     own), dbqkv 3D and dbproj C wide. y and dx are partial sums, each
//     rounded to bf16 once, that the caller adds over the model ranks; at
//     D = C the bits of #1-#5-bf16.
//   * Not yet: the f32 #1-#5 on wgmma and their attention on the cp.async
//     ring; fusing the attention into the products (the forward's qkv and
//     ao make one round trip through device memory).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <array>
#include <map>
#include <mutex>

#include "gemm_3xtf32.cuh"
#include "gemm_splitk.cuh"
#include "gemm_wgmma.cuh"
#include "philox.cuh"
#include "window_rows.cuh"

namespace focal {
struct WindowBlockSrc {};  // tags this library's instances of gemm_splitk.cuh's kernels
}  // namespace focal

namespace {

using Src = focal::WindowBlockSrc;
using focal::set_tiles;
using focal::tile_bn;

constexpr int kMaxN = 16;            // window tokens a thread keeps in registers
// Threads of every block launched here. The block-wide loops step by this
// constant, not by blockDim.x: a runtime stride cost the first port 5 % on
// the H100.
constexpr int kThreads = 256;
static_assert(kMaxN == focal::kAttnMaxN && kThreads == focal::kAttnThreads &&
                  kThreads == focal::kGemmThreads,
              "one block size and window bound for every kernel here");

// ---------------------------------------------------------------------------
// row-tiled projections on the tensor cores, attention per (window, head)
// pair between them

// Projections over all R = B N rows of a launch, one 128 x kBN output tile
// a block (focal::gemm_tile, 3xTF32): c = a b (+ bias) with a [M, K]
// row-major (lda), b [K, N] (ldb), c [M, N] (ldc). One launch may run two
// problems: blocks [0, p0.tiles) take p0, the rest p1.
struct ProjGemm {
  const float* a;
  const float* b;
  const float* bias;  // [N] or null
  float* c;
  int lda, ldb, ldc, M, N, K, tiles_n, tiles;
};

ProjGemm proj_gemm(const float* a, int lda, const float* b, int ldb, const float* bias, float* c,
                   int ldc, int M, int N, int K) {
  return ProjGemm{a, b, bias, c, lda, ldb, ldc, M, N, K, 0, 0};
}

// Two blocks an SM at 64 columns (<= 128 registers), one at 128.
template <int kBN>
__global__ void __launch_bounds__(focal::kGemmThreads, kBN == 64 ? 2 : 1)
proj_gemm_kernel(ProjGemm p0, ProjGemm p1) {
  extern __shared__ float4 smem4[];
  int tile = blockIdx.x;
  const ProjGemm p = tile < p0.tiles ? p0 : p1;
  if (tile >= p0.tiles) tile -= p0.tiles;
  const int m0 = (tile / p.tiles_n) * focal::kGemmBM, n0 = (tile % p.tiles_n) * kBN;
  float acc[4][focal::gemm_nt<kBN>()][4], csum = 0.f;
  focal::gemm_tile<false, false, kBN>(p.a, p.lda, p.b, p.ldb, p.M, p.N, m0, n0, 0, p.K,
                                      reinterpret_cast<float*>(smem4), acc, csum);
  focal::gemm_for_each_output<kBN>(acc, p.M, p.N, m0, n0, [&](int row, int col, float v0, float v1) {
    if (p.bias) {
      v0 += __ldg(p.bias + col);
      v1 += __ldg(p.bias + col + 1);
    }
    *reinterpret_cast<float2*>(p.c + (size_t)row * p.ldc + col) = make_float2(v0, v1);
  });
}

// Element strides of head h's q (k, v: add C, 2C) columns in the [R, 3C]
// qkv (or dqkv) workspace, and of its columns in an [R, C] tensor, as
// [B, H, N, hd] operands.
__device__ __forceinline__ focal::Strides qkv_strides(int N, int C, int hd) {
  return {(long long)N * 3 * C, hd, 3 * C};
}
__device__ __forceinline__ focal::Strides row_strides(int N, int C, int hd) {
  return {(long long)N * C, hd, C};
}

// Columns 4c .. 4c + 3 of one head's row (hd floats at `row`): a float4
// store where hd % 4 == 0 (the row is then 16-byte aligned), else the
// columns below hd one at a time.
__device__ __forceinline__ void store_cols(float* row, int c, float4 v, int hd) {
  if (hd % 4 == 0) {
    reinterpret_cast<float4*>(row)[c] = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (4 * c + k < hd) row[4 * c + k] = e[k];
}

// The attention of the forward per (window, head) pair (the row-parallel
// design of window_attention.cu, focal/window_rows.cuh): q, k, v from the
// qkv workspace, the softmax of q k^T + rel_bias + mask, dropout by
// focal::attn_keep_row's Philox counters, which #7 and #9 draw too (kDropout;
// the keep flags written out as uint8 [B, H, N, N]), and the attention
// output a v to ao [R, C] at the head's columns.
template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ rel_bias,
                const float* __restrict__ mask, float* __restrict__ ao,
                unsigned char* __restrict__ keep, unsigned long long seed, unsigned threshold,
                float inv_keep, focal::Geo g, int C, int nW) {
  extern __shared__ float4 smem4[];
  const int N = g.N, slab = g.pairs * N * g.stride;
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + slab;
  float* vs = ks + slab;
  const int p0 = blockIdx.x * g.pairs;
  const int np = (int)min((long long)g.pairs, g.total - p0);
  const focal::Strides sq = qkv_strides(N, C, g.hd);
  focal::stage_rows<true>(qkv, sq, p0, np, g, qs);
  focal::stage_rows<true>(qkv + C, sq, p0, np, g, ks);
  focal::stage_rows<true>(qkv + 2 * C, sq, p0, np, g, vs);
  __syncthreads();

  const focal::Row t = focal::thread_row(g, p0, np);
  float p[kMaxN];
  focal::row_dots(qs + t.r * g.stride, ks + t.pl * N * g.stride, g, t.lane, p);
  focal::softmax_row(p, rel_bias + (t.h * N + t.i) * N,
                     mask ? mask + ((size_t)(t.w % nW) * N + t.i) * N : nullptr, N);
  if (kDropout) {
    bool kept[kMaxN];
    focal::attn_keep_row(seed, (unsigned)t.w, t.h, t.i, N, threshold, kept);
    unsigned char* kr = keep + (((size_t)t.w * g.H + t.h) * N + t.i) * N;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < N) {
        if (t.active && t.lane == 0) kr[j] = kept[j] ? 1 : 0;
        p[j] = kept[j] ? p[j] * inv_keep : 0.f;
      }
    }
  }
  const float* vb = vs + t.pl * N * g.stride;
  float* o = ao + ((size_t)t.w * N + t.i) * C + t.h * g.hd;
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
    if (t.active) store_cols(o, c, acc, g.hd);
  }
}

// The attention backward per (window, head) pair: from q, k, v (the qkv
// workspace), g = dy Wproj^T ([R, C]) and the forward's keep mask, per query
// row i the softmax p, the weights as applied to v (a_v), the score
// gradients ds, dq_i = ds k and the attention output a_v v (into ao, for
// dWproj); per key row j dk_j = ds^T q and dv_j = a_v^T g; dq | dk | dv into
// the dqkv workspace at the head's columns. Blocks walk the chunks of pairs
// with a fixed stride and sum the chunks' ds per head in pair order into one
// d rel_bias partial each: no atomics.
template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ gao,
                const float* __restrict__ rel_bias, const float* __restrict__ mask,
                const unsigned char* __restrict__ keep, float inv_keep,
                float* __restrict__ dqkv, float* __restrict__ ao, float* __restrict__ dbias_part,
                focal::Geo g, int C, int nW) {
  extern __shared__ float4 smem4[];
  const int N = g.N, nn = N * N, slab = g.pairs * N * g.stride;
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + slab;
  float* vs = ks + slab;
  float* gs = vs + slab;
  float* dss = gs + slab;            // [P][N][N] score gradients
  float* avs = dss + g.pairs * nn;   // [P][N][N] weights as applied to v
  float* dacc = avs + g.pairs * nn;  // [H][N][N] this block's d rel_bias
  const int nchunks = (int)((g.total + g.pairs - 1) / g.pairs);
  const focal::Strides sq = qkv_strides(N, C, g.hd), sg = row_strides(N, C, g.hd);

  for (int e = threadIdx.x; e < g.H * nn; e += kThreads) dacc[e] = 0.f;

  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    const int p0 = chunk * g.pairs;
    const int np = (int)min((long long)g.pairs, g.total - p0);
    __syncthreads();  // the previous chunk's readers are done with shared memory
    focal::stage_rows<true>(qkv, sq, p0, np, g, qs);
    focal::stage_rows<true>(qkv + C, sq, p0, np, g, ks);
    focal::stage_rows<true>(qkv + 2 * C, sq, p0, np, g, vs);
    focal::stage_rows<true>(gao, sg, p0, np, g, gs);
    __syncthreads();

    // query row i of pair pl
    const focal::Row t = focal::thread_row(g, p0, np);
    const float* kb = ks + t.pl * N * g.stride;
    const float* vb = vs + t.pl * N * g.stride;
    float p[kMaxN], ds[kMaxN], av[kMaxN];
    focal::row_dots(qs + t.r * g.stride, kb, g, t.lane, p);
    focal::row_dots(gs + t.r * g.stride, vb, g, t.lane, ds);  // d(weights) = g_i . v_j
    focal::softmax_row(p, rel_bias + (t.h * N + t.i) * N,
                       mask ? mask + ((size_t)(t.w % nW) * N + t.i) * N : nullptr, N);
    const unsigned char* kr = kDropout ? keep + (((size_t)t.w * g.H + t.h) * N + t.i) * N : nullptr;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < N) {
        const bool kp = kDropout ? kr[j] != 0 : true;
        av[j] = kDropout ? (kp ? p[j] * inv_keep : 0.f) : p[j];
        if (kDropout) ds[j] = kp ? ds[j] * inv_keep : 0.f;
        dot = fmaf(ds[j], p[j], dot);
      }
    }
    float* avrow = avs + t.r * N;
    float* dsrow = dss + t.r * N;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < N) {
        ds[j] = p[j] * (ds[j] - dot);
        if (t.active && t.lane == 0) {
          avrow[j] = av[j];
          dsrow[j] = ds[j];
        }
      }
    }
    const size_t row = (size_t)t.w * N + t.i;
    float* dqo = dqkv + row * 3 * C + t.h * g.hd;
    float* aoo = ao + row * C + t.h * g.hd;
    for (int c = t.lane; c < g.c4; c += g.lanes) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) {
        if (j < N) {
          const float4 x = *reinterpret_cast<const float4*>(kb + j * g.stride + 4 * c);
          const float4 y = *reinterpret_cast<const float4*>(vb + j * g.stride + 4 * c);
          a.x = fmaf(ds[j], x.x, a.x);
          a.y = fmaf(ds[j], x.y, a.y);
          a.z = fmaf(ds[j], x.z, a.z);
          a.w = fmaf(ds[j], x.w, a.w);
          b.x = fmaf(av[j], y.x, b.x);
          b.y = fmaf(av[j], y.y, b.y);
          b.z = fmaf(av[j], y.z, b.z);
          b.w = fmaf(av[j], y.w, b.w);
        }
      }
      if (t.active) {
        store_cols(dqo, c, a, g.hd);
        store_cols(aoo, c, b, g.hd);
      }
    }
    __syncthreads();

    // key row j = t.i of pair pl
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
      float* base = dqkv + row * 3 * C + t.h * g.hd;
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
        store_cols(base + C, c, a, g.hd);
        store_cols(base + 2 * C, c, b, g.hd);
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

// ---------------------------------------------------------------------------
// launch plans

// Raise `kernel`'s dynamic shared memory limit to `smem` bytes and, when
// asked, report how many of its blocks fit one SM.
template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem, int* blocks_per_sm) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && blocks_per_sm)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
  return err;
}

// The current device's attribute `attr`.
cudaError_t device_attr(cudaDeviceAttr attr, int* value) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(value, attr, dev);
  return err;
}

size_t attn_fwd_smem(const focal::Geo& g) {
  return (size_t)3 * g.pairs * g.N * g.stride * sizeof(float);
}

size_t attn_bwd_smem(const focal::Geo& g) {
  return ((size_t)4 * g.pairs * g.N * g.stride + (size_t)2 * g.pairs * g.N * g.N +
          (size_t)g.H * g.N * g.N) * sizeof(float);
}

// The attention's geometry for (B, N, D, H), D = H hd the width of the
// attention's rows, and its shared memory in bytes: focal::make_geo's pairs
// a block, fewer where a head is too wide for them to fit a block's shared
// memory (the backward's from hd ~ 530 at N = 9). An error where even one
// pair does not fit.
cudaError_t attn_geo(int B, int N, int D, int H, size_t (*smem_of)(const focal::Geo&),
                     focal::Geo* g, size_t* smem) {
  int optin = 0;
  cudaError_t err = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin);
  if (err != cudaSuccess) return err;
  *g = focal::make_geo(B, H, N, D / H);
  while (g->pairs > 1 && smem_of(*g) > (size_t)optin) --g->pairs;
  *smem = smem_of(*g);
  return *smem <= (size_t)optin ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch plan of the backward (#3, #5; #5-TP at D < C) and its workspace,
// in floats: qkv and dqkv [R, 3D], g and the attention output [R, D], the
// attention blocks' d rel_bias partials, and the weight-gradient split
// partials (E floats each: dWqkv [C, 3D], dbqkv, dWproj [D, C], dbproj).
struct BwdPlan {
  focal::Geo geo;
  size_t attn_smem;
  int attn_grid, wbn, wtiles, splits, rows_per_split;
  size_t E, qkv, dqkv, g, ao, dbias, wpart, total;
  cudaError_t err;
};

BwdPlan bwd_plan(int B, int N, int C, int D, int H, bool dropout) {
  BwdPlan P{};
  int sms = 0, per_sm = 0;
  P.err = device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (P.err == cudaSuccess) P.err = attn_geo(B, N, D, H, attn_bwd_smem, &P.geo, &P.attn_smem);
  if (P.err != cudaSuccess) return P;
  P.err = dropout ? set_smem(attn_bwd_kernel<true>, P.attn_smem, &per_sm)
                  : set_smem(attn_bwd_kernel<false>, P.attn_smem, &per_sm);
  if (P.err == cudaSuccess && per_sm < 1) P.err = cudaErrorInvalidConfiguration;
  if (P.err != cudaSuccess) return P;
  const long long nchunks = (P.geo.total + P.geo.pairs - 1) / P.geo.pairs;
  P.attn_grid = (int)std::min<long long>(nchunks, (long long)per_sm * sms);
  const int R = B * N;
  P.wbn = tile_bn(3 * D, C);
  int tq = 0, tp = 0, unused = 0;
  set_tiles(C, 3 * D, P.wbn, &unused, &tq);
  set_tiles(D, C, P.wbn, &unused, &tp);
  P.wtiles = tq + tp;
  const focal::RowSplits rs = focal::split_rows(R, P.wtiles, sms);
  P.splits = rs.splits;
  P.rows_per_split = rs.rows_per_split;
  P.E = (size_t)4 * C * D + 3 * D + C;
  size_t o = 0;
  P.qkv = o, o += (size_t)R * 3 * D;
  P.dqkv = o, o += (size_t)R * 3 * D;
  P.g = o, o += (size_t)R * D;
  P.ao = o, o += (size_t)R * D;
  P.dbias = o, o += ((size_t)P.attn_grid * H * N * N + 3) / 4 * 4;  // keeps wpart 16-byte aligned
  P.wpart = o, o += (size_t)P.splits * P.E;
  P.total = o;
  return P;
}

// x [R, C] and an attention of H heads over rows D = H hd wide (D = C but
// for a tensor-parallel shard's heads).
int check_geometry(int N, int C, int D, int H) {
  if (N < 1 || N > kMaxN || C < 4 || C % 4 != 0 || D < 4 || D % 4 != 0 || H < 1 || D % H != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// One projection launch (one or two problems; p1 = ProjGemm{} for none) on
// `stream`, in tiles of tile_bn columns.
template <int kBN>
cudaError_t launch_proj_bn(ProjGemm p0, ProjGemm p1, cudaStream_t s) {
  set_tiles(p0.M, p0.N, kBN, &p0.tiles_n, &p0.tiles);
  set_tiles(p1.M, p1.N, kBN, &p1.tiles_n, &p1.tiles);
  const size_t smem = focal::gemm_smem_bytes(kBN);
  cudaError_t err = set_smem(proj_gemm_kernel<kBN>, smem, nullptr);
  if (err != cudaSuccess) return err;
  proj_gemm_kernel<kBN><<<p0.tiles + p1.tiles, focal::kGemmThreads, smem, s>>>(p0, p1);
  return cudaGetLastError();
}

cudaError_t launch_proj(const ProjGemm& p0, const ProjGemm& p1, cudaStream_t s) {
  return tile_bn(p0.N, p1.N) == 128 ? launch_proj_bn<128>(p0, p1, s)
                                    : launch_proj_bn<64>(p0, p1, s);
}

// The f32 forward's three launches on `stream` (focal_wblock_fwd_dropout):
// qkv = x Wqkv + bqkv into the workspace, the attention per (window,
// head), y = ao Wproj + bproj; x [R, C], Wqkv [C, 3D], Wproj [D, C].
int wblock_fwd(const float* x, const float* wqkv, const float* bqkv, const float* wproj,
               const float* bproj, const void* rel_bias, const void* mask, float* y, void* keep,
               void* ws, int B, int N, int C, int D, int H, int nW, unsigned long long seed,
               unsigned threshold, float inv_keep, void* stream) {
  if (check_geometry(N, C, D, H) || (mask != nullptr && nW < 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  focal::Geo g;
  size_t smem = 0;
  cudaError_t err = attn_geo(B, N, D, H, attn_fwd_smem, &g, &smem);
  const bool dropout = keep != nullptr;
  if (err == cudaSuccess)
    err = dropout ? set_smem(attn_fwd_kernel<true>, smem, nullptr)
                  : set_smem(attn_fwd_kernel<false>, smem, nullptr);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * N;
  float* qkv = static_cast<float*>(ws);
  float* ao = qkv + (size_t)R * 3 * D;
  err = launch_proj(proj_gemm(x, C, wqkv, 3 * D, bqkv, qkv, 3 * D, R, 3 * D, C), ProjGemm{}, s);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)((g.total + g.pairs - 1) / g.pairs);
#define FOCAL_ATTN_ARGS                                                                       \
  qkv, static_cast<const float*>(rel_bias), static_cast<const float*>(mask), ao,              \
      static_cast<unsigned char*>(keep), seed, threshold, inv_keep, g, D,                     \
      mask != nullptr ? nW : 1
  if (dropout)
    attn_fwd_kernel<true><<<grid, kThreads, smem, s>>>(FOCAL_ATTN_ARGS);
  else
    attn_fwd_kernel<false><<<grid, kThreads, smem, s>>>(FOCAL_ATTN_ARGS);
#undef FOCAL_ATTN_ARGS
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_proj(proj_gemm(ao, D, wproj, C, bproj, y, C, R, C, D), ProjGemm{}, s);
}

// The backward's six launches on `stream` (focal_wblock_bwd): qkv = x
// Wqkv + bqkv and g = dy Wproj^T (one launch, f32 into the workspace), the
// attention backward (dqkv, the attention output, d rel_bias partials), dx
// = dqkv Wqkv^T, the weight-gradient split partials (x^T dqkv, ao^T dy and
// the column sums), and the two ordered reductions. Wqkv^T is [3D, C],
// Wproj^T [C, D].
int wblock_bwd(const float* x, const float* wqkv, const float* bqkv, const float* wqkv_t,
               const float* wproj_t, const void* rel_bias, const void* mask, const float* dy,
               const void* keep, float inv_keep, float* dx, void* dweights, void* drel_bias,
               void* ws, int B, int N, int C, int D, int H, int nW, void* stream) {
  if (check_geometry(N, C, D, H) || (mask != nullptr && nW < 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const bool dropout = keep != nullptr;
  const BwdPlan P = bwd_plan(B, N, C, D, H, dropout);
  if (P.err != cudaSuccess) return (int)P.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * N;
  float* w = static_cast<float*>(ws);
  float *qkv = w + P.qkv, *dqkv = w + P.dqkv, *g = w + P.g, *ao = w + P.ao;
  // 1. qkv = x Wqkv + bqkv (recomputed) and g = dy Wproj^T
  cudaError_t err = launch_proj(proj_gemm(x, C, wqkv, 3 * D, bqkv, qkv, 3 * D, R, 3 * D, C),
                                proj_gemm(dy, C, wproj_t, D, nullptr, g, D, R, D, C), s);
  if (err != cudaSuccess) return (int)err;
  // 2. the attention backward per (window, head)
#define FOCAL_ATTN_ARGS                                                                       \
  qkv, g, static_cast<const float*>(rel_bias), static_cast<const float*>(mask),               \
      static_cast<const unsigned char*>(keep), inv_keep, dqkv, ao, w + P.dbias, P.geo, D,    \
      mask != nullptr ? nW : 1
  if (dropout)
    attn_bwd_kernel<true><<<P.attn_grid, kThreads, P.attn_smem, s>>>(FOCAL_ATTN_ARGS);
  else
    attn_bwd_kernel<false><<<P.attn_grid, kThreads, P.attn_smem, s>>>(FOCAL_ATTN_ARGS);
#undef FOCAL_ATTN_ARGS
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 3. dx = dqkv Wqkv^T
  err = launch_proj(proj_gemm(dqkv, 3 * D, wqkv_t, C, nullptr, dx, C, R, C, 3 * D), ProjGemm{}, s);
  if (err != cudaSuccess) return (int)err;
  // 4. dWqkv = x^T dqkv with dbqkv, dWproj = ao^T dy with dbproj, per split
  const size_t q = (size_t)3 * C * D, p_out = q + 3 * D, p_sums = p_out + (size_t)D * C;
  err = focal::launch_wgrad<Src>(P.wbn, focal::wgrad_gemm(x, dqkv, C, 3 * D, 0, q, P.wbn),
                                 focal::wgrad_gemm(ao, dy, D, C, p_out, p_sums, P.wbn), R,
                                 P.rows_per_split, P.splits, w + P.wpart, P.E, false, s);
  if (err != cudaSuccess) return (int)err;
  // 5. the partials summed in split order, and d rel_bias in block order
  err = focal::launch_reduce<Src>(w + P.wpart, P.splits, P.E, static_cast<float*>(dweights), s);
  if (err != cudaSuccess) return (int)err;
  return (int)focal::launch_reduce<Src>(w + P.dbias, P.attn_grid, (size_t)H * N * N,
                                        static_cast<float*>(drel_bias), s);
}

// ---------------------------------------------------------------------------
// the bf16 forward (#1-bf16, #2-bf16, #4-bf16) and backward (#3-bf16,
// #5-bf16): products on wgmma, the attention on the chunk walk of #8/#9

namespace wgk = focal::wg;
using bf16 = __nv_bfloat16;

// The shared memory of a product whose output tiles (bf16, or f32 with
// kF32) leave by TMA stores: fewer stages than kStreamStages make room for
// a staged tile.
template <int kBN, bool kF32 = false>
struct StoreSmem {
  static constexpr int kStages = wgk::kStreamStages<kBN> - (kF32 ? 2 : 1);
  // from the 1,024-byte aligned start: the ring's tiles and a 1 KB page for
  // its barriers, then the staged tile
  static constexpr size_t kStaged =
      (size_t)kStages * wgk::Ring<kBN, false, false, kStages>::kStageBytes + 1024;
  static constexpr size_t kBytes = 1024 + kStaged + (size_t)wgk::kBM * kBN * (kF32 ? 4 : 2);
};

// The epilogue of such a product: the 128 x kBN tile's f32 sums (each column
// n < N plus bias[n], where bias is not null), kept in f32 (kF32) or
// rounded to bf16 once, staged in shared memory (boxes of 128-byte rows,
// swizzled) and stored by TMA through `map`, which leaves out the rows past
// M and the columns past N. Thread 0 issues the stores; it first waits
// until the last tile's store has read the staged tile.
template <int kBN, bool kF32>
__device__ __forceinline__ void store_tile(uint8_t* tile, const CUtensorMap* map,
                                           const wgk::Job<1>& j, const float (&acc)[kBN / 2],
                                           const float* __restrict__ bias) {
  constexpr int kBoxCols = kF32 ? 32 : 64;
  const wgk::Frag f;
  if (threadIdx.x == 0) wgk::tma_store_wait_read();
  wgk::consumers_sync();
#pragma unroll
  for (int jj = 0; jj < kBN / 8; ++jj) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 4 * jj + 2 * r, n = j.n0 + f.col(i);
      float v0 = acc[i], v1 = acc[i + 1];
      if (bias && n < j.N) {  // N is a multiple of 8, n even
        v0 += __ldg(bias + n);
        v1 += __ldg(bias + n + 1);
      }
      if (kF32)
        wgk::stage_pair_f32(tile, f.row(i), f.col(i), make_float2(v0, v1));
      else
        wgk::stage_pair(tile, f.row(i), f.col(i), wgk::pack_bf16(v0, v1));
    }
  }
  wgk::fence_async_smem();
  wgk::consumers_sync();  // the tile is staged
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < kBN / kBoxCols; ++b)
      wgk::tma_store(map, tile + b * wgk::kBM * 128, j.n0 + kBoxCols * b, j.m0);
    wgk::tma_store_commit();
  }
}

// qkv = x Wqkv + bqkv and, in the backward, g = dy Wproj^T, f32, into the
// workspaces: one or two problems in one launch (gemm_wgmma.cuh's
// streamed_tiles over the problems' tiles): A = x or dy [R, C] K-major, B =
// Wqkv [C, 3D] MN-major as it lies, or Wproj [D, C] read as B^T, K-major as
// it lies (problem 1's order, kBT1). Each f32 tile leaves by TMA
// (store_tile through mqkv or mg). With g null the launch is problem 0
// alone: the forward's (a).
struct QkvgArgs {
  const float* bqkv;
  float* qkv;  // [R, 3D]
  float* g;    // [R, D], or null
  int R, C, D;  // D: the attention's width (C but for a tensor-parallel shard)
};

// Output tiles of a QkvgArgs launch in kBN-wide tiles.
__host__ __device__ inline int qkvg_tiles(const QkvgArgs& p, int bn) {
  const int tn = (3 * p.D + bn - 1) / bn + (p.g ? (p.D + bn - 1) / bn : 0);
  return (p.R + wgk::kBM - 1) / wgk::kBM * tn;
}

template <int kBN>
__global__ void __launch_bounds__(wgk::kThreads, 1)
wb_wg_qkvg_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mwqkv,
                  const __grid_constant__ CUtensorMap mdy, const __grid_constant__ CUtensorMap mwproj,
                  const __grid_constant__ CUtensorMap mqkv, const __grid_constant__ CUtensorMap mg,
                  const QkvgArgs p) {
  extern __shared__ uint8_t smem_raw[];
  using Smem = StoreSmem<kBN, true>;
  uint8_t* tile = wgk::align1024(smem_raw) + Smem::kStaged;
  const int rt = (p.R + wgk::kBM - 1) / wgk::kBM;
  const int tn0 = (3 * p.D + kBN - 1) / kBN, tn1 = (p.D + kBN - 1) / kBN;
  const int k_tiles = (p.C + wgk::kBK - 1) / wgk::kBK;
  auto plan = [&](int tile) {
    const bool second = tile >= rt * tn0;
    const int t = second ? tile - rt * tn0 : tile, tn = second ? tn1 : tn0;
    return wgk::Job<1>{{second ? &mdy : &mx}, {second ? &mwproj : &mwqkv}, t / tn * wgk::kBM, p.R,
                       t % tn * kBN, second ? p.D : 3 * p.D, 0, k_tiles, second ? 1 : 0};
  };
  auto epi = [&](const wgk::Job<1>& j, float (&acc)[1][kBN / 2]) {
    store_tile<kBN, true>(tile, j.problem ? &mg : &mqkv, j, acc[0], j.problem ? nullptr : p.bqkv);
  };
  wgk::streamed_tiles<kBN, false, true, Smem::kStages, 1, false>(smem_raw, qkvg_tiles(p, kBN), plan,
                                                                 epi);
  if (threadIdx.x == 0) wgk::tma_store_wait_read();  // the last store has left shared memory
}

// The backward's dx = dqkv Wqkv^T: A = dqkv [R, 3D] bf16 K-major, B^T =
// Wqkv [C, 3D] K-major as it lies; each tile of dx rounded to bf16 and
// stored by TMA (store_tile).
template <int kBN>
__global__ void __launch_bounds__(wgk::kThreads, 1)
wb_wg_dx_kernel(const __grid_constant__ CUtensorMap mdqkv, const __grid_constant__ CUtensorMap mwqkv,
                const __grid_constant__ CUtensorMap mdx, int R, int C, int D) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tile = wgk::align1024(smem_raw) + StoreSmem<kBN>::kStaged;
  const int tn = (C + kBN - 1) / kBN;
  const int tiles = (R + wgk::kBM - 1) / wgk::kBM * tn;
  const int k_tiles = (3 * D + wgk::kBK - 1) / wgk::kBK;
  auto plan = [&](int t) {
    return wgk::Job<1>{{&mdqkv}, {&mwqkv}, t / tn * wgk::kBM, R, t % tn * kBN, C, 0, k_tiles, 0};
  };
  auto epi = [&](const wgk::Job<1>& j, float (&acc)[1][kBN / 2]) {
    store_tile<kBN, false>(tile, &mdx, j, acc[0], nullptr);
  };
  wgk::streamed_tiles<kBN, false, false, StoreSmem<kBN>::kStages, 1>(smem_raw, tiles, plan, epi);
  if (threadIdx.x == 0) wgk::tma_store_wait_read();  // the last store has left shared memory
}

// The forward's y = ao Wproj + bproj: A = the attention's bf16 ao [R, D]
// K-major, B = Wproj [D, C] MN-major as it lies; bproj added to the f32
// sums, then each value rounded to bf16 once and stored by TMA
// (store_tile).
template <int kBN>
__global__ void __launch_bounds__(wgk::kThreads, 1)
wb_wg_y_kernel(const __grid_constant__ CUtensorMap mao, const __grid_constant__ CUtensorMap mwproj,
               const __grid_constant__ CUtensorMap my, const float* __restrict__ bproj, int R,
               int C, int D) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tile = wgk::align1024(smem_raw) + StoreSmem<kBN>::kStaged;
  const int tn = (C + kBN - 1) / kBN;
  const int tiles = (R + wgk::kBM - 1) / wgk::kBM * tn;
  const int k_tiles = (D + wgk::kBK - 1) / wgk::kBK;
  auto plan = [&](int t) {
    return wgk::Job<1>{{&mao}, {&mwproj}, t / tn * wgk::kBM, R, t % tn * kBN, C, 0, k_tiles, 0};
  };
  auto epi = [&](const wgk::Job<1>& j, float (&acc)[1][kBN / 2]) {
    store_tile<kBN, false>(tile, &my, j, acc[0], bproj);
  };
  wgk::streamed_tiles<kBN, false, true, StoreSmem<kBN>::kStages, 1>(smem_raw, tiles, plan, epi);
  if (threadIdx.x == 0) wgk::tma_store_wait_read();  // the last store has left shared memory
}

// Columns 4c .. 4c + 3 of a head's row at `row` stored in T (f32, or bf16
// rounded once): a vector store where hd % 4 == 0 (kAnyHd false: the row is
// then 16- or 8-byte aligned), else each column below hd alone.
__device__ __forceinline__ void put_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void put_elem(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

template <bool kAnyHd, class T>
__device__ __forceinline__ void store_head4(T* row, int c, float4 v, int hd) {
  if (!kAnyHd) {
    focal::store4(row + 4 * c, v);
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (4 * c + k < hd) put_elem(row + 4 * c + k, e[k]);
}

// The attention of #1-bf16, #2-bf16 and #4-bf16 per (window, head) pair, on
// the chunk walk of #6/#7 (focal::ring_walk: a persistent grid, the rows of
// q, k and v staged by cp.async from the f32 qkv workspace into a two-slot
// ring, the next chunk's copies in flight while this one computes; one
// slot where a head is too wide for two; the exact 9-key row tile where N
// = 9). Query row i of each pair: the scores, softmax of q k^T + rel_bias
// (+ the shifted-window mask) and dropout in f32 registers (the keep flags
// drawn by focal::keep_bits_row, the G lanes of a row sharing its Philox
// words, and written out as uint8 [B, H, N, N]), then ao_i = a_v v rounded
// once to bf16 into ao [R, D] at the head's columns: the layout and type
// the output projection reads by TMA. C here is the attention's width D.
struct AttnFwdArgs {
  const float* qkv;        // [R, 3D] f32, q pre-scaled
  const float* rel_bias;   // [H, N, N]
  const float* mask;       // [nW, N, N] or null
  bf16* ao;                // [R, D]
  unsigned char* keep;     // [B, H, N, N] (kDropout)
  unsigned long long seed;
  unsigned threshold;
  float inv_keep;
  int C, nW, two_slots;  // C: the rows' width D
};

template <int kN, int kCols, bool kDropout, bool kAnyHd>
__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_bf16_kernel(const AttnFwdArgs a, const focal::Geo g) {
  extern __shared__ float4 smem4[];
  const int N = kN < kMaxN ? kN : g.N, slab = g.pairs * N * g.stride;
  const int C = a.C, hd = g.hd;
  float* ring = reinterpret_cast<float*>(smem4);  // [slots][q, k, v][P][N][stride]
  const focal::Strides sq = qkv_strides(N, C, hd);
  const focal::Operands<float> in{{a.qkv, a.qkv + C, a.qkv + 2 * C, nullptr}, {sq, sq, sq, {}}};
  auto stage = [&](int chunk, float* slot) {
    focal::stage_chunk_async<3, kAnyHd>(in, chunk, g, slot);
  };
  auto land = [](int, float*) {};
  focal::ring_walk(g, ring, 3 * slab, a.two_slots != 0, stage, land, [&](int chunk, float* qs) {
    const int p0 = chunk * g.pairs, np = focal::chunk_pairs(g, chunk);
    const float* ks = qs + slab;
    const float* vs = ks + slab;
    const focal::Row t = focal::thread_row(g, p0, np);
    const float* brow = a.rel_bias + (t.h * N + t.i) * N;
    const float* mrow = a.mask ? a.mask + ((size_t)(t.w % a.nW) * N + t.i) * N : nullptr;
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
    if (kDropout) {
      kept = focal::keep_bits_row(a.seed, (unsigned)t.w, t.h, t.i, N, a.threshold, t.lane, g.lanes);
      if (t.active) {
        unsigned char* kr = a.keep + (((size_t)t.w * g.H + t.h) * N + t.i) * N;
        for (int j = t.lane; j < N; j += g.lanes) kr[j] = (kept >> j) & 1u;
      }
    }
    float p[kN];
    focal::row_dots<kCols>(qs + t.r * g.stride, ks + t.pl * N * g.stride, g, t.lane, p);
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
        if (focal::key_in_row<kN>(j, N)) p[j] = (kept >> j) & 1u ? p[j] * a.inv_keep : 0.f;
    }
    const float* vb = vs + t.pl * N * g.stride;
    bf16* o = a.ao + ((size_t)t.w * N + t.i) * C + t.h * hd;
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
      if (t.active) store_head4<kAnyHd>(o, c, acc, hd);
    });
  });
}

// The attention backward of #3-bf16 and #5-bf16 per (window, head) pair, on
// the chunk walk of #8/#9 (focal::ring_walk: a persistent grid, the rows of
// q, k, v (from the f32 qkv workspace) and g (the f32 [R, C] workspace)
// staged by cp.async into a two-slot ring, at most one chunk a block, the
// exact 9-key row tile where N = 9). Per chunk:
//   stage 1, query row i of each pair: the softmax p, d(weights) = g_i . v_j,
//     the weights as applied to v, a_v (the forward's keep mask read back),
//     the score gradients ds (a_v and ds to shared memory), dq_i = ds k and
//     the attention output ao_i = a_v v;
//   stage 2, key row j: dk_j = ds^T q, dv_j = a_v^T g;
//   dq, dk, dv and ao rounded once to bf16 into dqkv [R, 3C] (the head's
//   columns) and ao [R, C], the layouts the products read by TMA; dq's f32
//   rows kept in shared memory, dk's and dv's over the chunk's k and v
//   (read by then), and after a third barrier the block's f32 sums: d
//   rel_bias per head and dbqkv per column, each over the chunk's pairs in
//   pair order (and a column's rows in order).
// After its chunks a block sums its share of dy's rows (dbproj's partial;
// rows [b rpb, (b + 1) rpb)): a thread's 8 columns over rows slot, slot +
// slots, ..., then the slots in order. Every sum is a per-block partial,
// added in block order by the reduction: no atomics.
// kWide (a head too wide for two slots; only with kAnyHd and kN kMaxN): one
// slot, and dq's f32 rows and the dbqkv partial in device memory (over the
// chunk's own q rows of the qkv workspace, read by then, and at the
// block's partial), so the shared memory is the gate's (wblock_takes).
// C is the attention's width D (C but for a tensor-parallel shard), Cy dy's.
struct AttnBwdArgs {
  float* qkv;                 // [R, 3D] f32, q pre-scaled
  const float* g;             // [R, D] f32
  const float* rel_bias;      // [H, N, N]
  const float* mask;          // [nW, N, N] or null
  const unsigned char* keep;  // [B, H, N, N] (kDropout)
  const bf16* dy;             // [R, Cy]
  bf16* dqkv;                 // [R, 3D]
  bf16* ao;                   // [R, D]
  float* dbqkv_part;          // [grid][3D]
  float* dbproj_part;         // [grid][Cy]
  float* dbias_part;          // [grid][H N N]
  float inv_keep;
  int C, nW, R, Cy;
};

template <int kN, int kCols, bool kDropout, bool kAnyHd, bool kWide>
__global__ void __launch_bounds__(kThreads, 2)
attn_bwd_bf16_kernel(const AttnBwdArgs a, const focal::Geo g) {
  extern __shared__ float4 smem4[];
  const int N = kN < kMaxN ? kN : g.N, nn = N * N, slab = g.pairs * N * g.stride;
  const int C = a.C, C3 = 3 * C, hd = g.hd;
  float* ring = reinterpret_cast<float*>(smem4);   // [slots][q, k, v, g][P][N][stride]
  float* dqs = ring + (kWide ? 4 : 8) * slab;      // [P][N][stride]: dq's f32 rows
  float* dss = dqs + (kWide ? 0 : slab);           // [P][N][N] score gradients
  float* avs = dss + g.pairs * nn;                 // [P][N][N] weights as applied to v
  float* dacc = avs + g.pairs * nn;                // [H][N][N] this block's d rel_bias
  float* dbacc = kWide ? a.dbqkv_part + (size_t)blockIdx.x * C3 : dacc + g.H * nn;  // [3C]
  for (int e = threadIdx.x; e < g.H * nn; e += kThreads) dacc[e] = 0.f;
  for (int e = threadIdx.x; e < C3; e += kThreads) dbacc[e] = 0.f;
  const focal::Strides sq = qkv_strides(N, C, hd), sg = row_strides(N, C, hd);
  const focal::Operands<float> in{{a.qkv, a.qkv + C, a.qkv + 2 * C, a.g}, {sq, sq, sq, sg}};
  auto stage = [&](int chunk, float* slot) {
    focal::stage_chunk_async<4, kAnyHd>(in, chunk, g, slot);
  };
  auto land = [](int, float*) {};
  focal::ring_walk(g, ring, 4 * slab, !kWide, stage, land, [&](int chunk, float* qs) {
    const int p0 = chunk * g.pairs, np = focal::chunk_pairs(g, chunk);
    float* ks = qs + slab;
    float* vs = ks + slab;
    const float* gs = vs + slab;

    // stage 1: query row i of pair pl
    const focal::Row t = focal::thread_row(g, p0, np);
    const float* brow = a.rel_bias + (t.h * N + t.i) * N;
    const float* mrow = a.mask ? a.mask + ((size_t)(t.w % a.nW) * N + t.i) * N : nullptr;
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
    if (kDropout) {
      const unsigned char* kr = a.keep + (((size_t)t.w * g.H + t.h) * N + t.i) * N;
      kept = 0u;
#pragma unroll
      for (int j = 0; j < kN; ++j)
        if (focal::key_in_row<kN>(j, N)) kept |= (__ldg(kr + j) != 0 ? 1u : 0u) << j;
    }
    const float* kb = ks + t.pl * N * g.stride;
    const float* vb = vs + t.pl * N * g.stride;
    float p[kN], ds[kN];
    focal::row_dots<kCols>(qs + t.r * g.stride, kb, g, t.lane, p);
    focal::row_dots<kCols>(gs + t.r * g.stride, vb, g, t.lane, ds);  // d(weights) = g_i . v_j
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
        if (kDropout) ds[j] = (kept >> j) & 1u ? ds[j] * a.inv_keep : 0.f;  // da
        dot = fmaf(ds[j], p[j], dot);
      }
    }
    float* avrow = avs + t.r * N;
    float* dsrow = dss + t.r * N;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (focal::key_in_row<kN>(j, N)) {
        ds[j] = p[j] * (ds[j] - dot);
        if (kDropout) p[j] = (kept >> j) & 1u ? p[j] * a.inv_keep : 0.f;  // a_v from here on
        if (t.active && j % g.lanes == t.lane) {
          avrow[j] = p[j];
          dsrow[j] = ds[j];
        }
      }
    }
    const size_t row = (size_t)t.w * N + t.i;
    bf16* dqo = a.dqkv + row * C3 + t.h * hd;
    bf16* aoo = a.ao + row * C + t.h * hd;
    float* dqf = kWide ? a.qkv + row * C3 + t.h * hd : dqs + t.r * g.stride;
    focal::for_lane_cols<kCols>(t.lane, g, [&](int c) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        if (focal::key_in_row<kN>(j, N)) {
          const float4 u = *reinterpret_cast<const float4*>(kb + j * g.stride + 4 * c);
          const float4 w = *reinterpret_cast<const float4*>(vb + j * g.stride + 4 * c);
          x.x = fmaf(ds[j], u.x, x.x);
          x.y = fmaf(ds[j], u.y, x.y);
          x.z = fmaf(ds[j], u.z, x.z);
          x.w = fmaf(ds[j], u.w, x.w);
          y.x = fmaf(p[j], w.x, y.x);
          y.y = fmaf(p[j], w.y, y.y);
          y.z = fmaf(p[j], w.z, y.z);
          y.w = fmaf(p[j], w.w, y.w);
        }
      }
      if (t.active) {
        store_head4<kAnyHd>(dqo, c, x, hd);
        store_head4<kAnyHd>(aoo, c, y, hd);
        store_head4<kWide>(dqf, c, x, hd);
      }
    });
    __syncthreads();  // ds and a_v written; k and v read

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
      bf16* base = a.dqkv + row * C3 + t.h * hd;
      focal::for_lane_cols<kCols>(t.lane, g, [&](int c) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          if (focal::key_in_row<kN>(i, N)) {
            const float4 u = *reinterpret_cast<const float4*>(qb + i * g.stride + 4 * c);
            const float4 w = *reinterpret_cast<const float4*>(gb + i * g.stride + 4 * c);
            x.x = fmaf(dsj[i], u.x, x.x);
            x.y = fmaf(dsj[i], u.y, x.y);
            x.z = fmaf(dsj[i], u.z, x.z);
            x.w = fmaf(dsj[i], u.w, x.w);
            y.x = fmaf(avj[i], w.x, y.x);
            y.y = fmaf(avj[i], w.y, y.y);
            y.z = fmaf(avj[i], w.z, y.z);
            y.w = fmaf(avj[i], w.w, y.w);
          }
        }
        store_head4<kAnyHd>(base + C, c, x, hd);
        store_head4<kAnyHd>(base + 2 * C, c, y, hd);
        *reinterpret_cast<float4*>(ks + t.r * g.stride + 4 * c) = x;  // k's rows are read
        *reinterpret_cast<float4*>(vs + t.r * g.stride + 4 * c) = y;
      });
    }
    __syncthreads();  // dq's, dk's and dv's f32 rows written

    // the block's d rel_bias: element (h, i, j) adds the chunk's pairs of
    // head h in pair order (each element keeps its thread across chunks)
    for (int e = threadIdx.x; e < g.H * nn; e += kThreads) {
      const int h = e / nn, ij = e - h * nn;
      float acc = dacc[e];
      for (int pl = ((h - p0 % g.H) + g.H) % g.H; pl < np; pl += g.H) acc += dss[pl * nn + ij];
      dacc[e] = acc;
    }
    // the block's dbqkv: column e (q, k or v of head h, column d) adds the
    // chunk's pairs of head h in pair order, a pair's rows in order
    for (int e = threadIdx.x; e < C3; e += kThreads) {
      const int part = e / C, cc = e - part * C, h = cc / hd, d = cc - h * hd;
      const float* src = part == 0 ? dqs : part == 1 ? ks : vs;
      float acc = dbacc[e];
      for (int pl = ((h - p0 % g.H) + g.H) % g.H; pl < np; pl += g.H) {
        for (int i = 0; i < N; ++i) {
          if (kWide && part == 0)
            acc += a.qkv[((size_t)((p0 + pl) / g.H) * N + i) * C3 + cc];
          else
            acc += src[(pl * N + i) * g.stride + d];
        }
      }
      dbacc[e] = acc;
    }
  });
  __syncthreads();
  for (int e = threadIdx.x; e < g.H * nn; e += kThreads)
    a.dbias_part[(size_t)blockIdx.x * g.H * nn + e] = dacc[e];
  if (!kWide)
    for (int e = threadIdx.x; e < C3; e += kThreads)
      a.dbqkv_part[(size_t)blockIdx.x * C3 + e] = dbacc[e];
  __syncthreads();  // shared memory is reused below

  // dbproj's partial: this block's rows of dy, 8 columns a thread (groups
  // of at most kThreads column groups at a time)
  float* red = reinterpret_cast<float*>(smem4);  // [slots][8 gb]
  const int rpb = (a.R + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * rpb, r1 = min(a.R, r0 + rpb), Cy = a.Cy;
  for (int cg0 = 0; cg0 < Cy / 8; cg0 += kThreads) {
    const int gb = min(kThreads, Cy / 8 - cg0), slots = kThreads / gb;
    const int cg = threadIdx.x % gb, slot = threadIdx.x / gb;
    if (slot < slots) {
      float s[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) s[u] = 0.f;
#pragma unroll 4  // four rows' loads in flight a thread
      for (int r = r0 + slot; r < r1; r += slots) {
        const uint4 raw =
            __ldg(reinterpret_cast<const uint4*>(a.dy + (size_t)r * Cy + 8 * (cg0 + cg)));
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // the lower bf16 of a word is the lower address
          s[2 * u] += __uint_as_float(w[u] << 16);
          s[2 * u + 1] += __uint_as_float(w[u] & 0xffff0000u);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) red[slot * 8 * gb + 8 * cg + u] = s[u];
    }
    __syncthreads();
    for (int col = threadIdx.x; col < 8 * gb; col += kThreads) {
      float acc = 0.f;
      for (int sl = 0; sl < slots; ++sl) acc += red[sl * 8 * gb + col];
      a.dbproj_part[(size_t)blockIdx.x * Cy + 8 * cg0 + col] = acc;
    }
    __syncthreads();
  }
}

// The bf16 attentions' shared memory, in floats: the forward's ring (two
// slots of q, k, v rows, or one where wide); the backward's ring (two
// slots of q, k, v, g rows, or one with kWide), dq's f32 rows (not kWide),
// ds and a_v, d rel_bias, dbqkv (not kWide), at least the 2,048 of dbproj's
// sums.
size_t attn_fwd16_floats(const focal::Geo& g, bool wide) {
  return (size_t)(wide ? 3 : 6) * g.pairs * g.N * g.stride;
}

size_t attn_bwd16_floats(const focal::Geo& g, int C, bool wide) {
  const size_t slab = (size_t)g.pairs * g.N * g.stride, nn = (size_t)g.N * g.N;
  const size_t f = (wide ? 4 : 9) * slab + 2 * g.pairs * nn + g.H * nn + (wide ? 0 : 3 * (size_t)C);
  return std::max<size_t>(f, 2048);
}

using AttnFwd16 = void (*)(AttnFwdArgs, focal::Geo);
using AttnBwd16 = void (*)(AttnBwdArgs, focal::Geo);

// The instance for a geometry: the exact 9-key tile at N = 9 (two float4
// columns a lane unrolled where a lane takes exactly two), any N up to 16
// otherwise; heads that are not a multiple of 4 (or wider than 1,024)
// staged by kAnyHd's loop, 4 bytes at a time; in the backward kWide where
// two slots do not fit (the forward takes its slots at run time).
template <bool kDropout>
AttnFwd16 attn_fwd16_kernel(const focal::Geo& g) {
  if (g.hd % 4 != 0 || g.c4 > kThreads) return attn_fwd_bf16_kernel<kMaxN, 0, kDropout, true>;
  if (g.N == 9)
    return g.c4 == 2 * g.lanes ? attn_fwd_bf16_kernel<9, 2, kDropout, false>
                               : attn_fwd_bf16_kernel<9, 0, kDropout, false>;
  return attn_fwd_bf16_kernel<kMaxN, 0, kDropout, false>;
}

template <bool kDropout>
AttnBwd16 attn_bwd16_kernel(const focal::Geo& g, bool wide) {
  if (wide) return attn_bwd_bf16_kernel<kMaxN, 0, kDropout, true, true>;
  if (g.hd % 4 != 0 || g.c4 > kThreads)
    return attn_bwd_bf16_kernel<kMaxN, 0, kDropout, true, false>;
  if (g.N == 9)
    return g.c4 == 2 * g.lanes ? attn_bwd_bf16_kernel<9, 2, kDropout, false, false>
                               : attn_bwd_bf16_kernel<9, 0, kDropout, false, false>;
  return attn_bwd_bf16_kernel<kMaxN, 0, kDropout, false, false>;
}

// A bf16 attention's ring on the current device: make_geo's pairs a chunk,
// fewer where floats(geo, wide) floats do not fit a block's shared memory,
// then (wide) one slot with make_geo's pairs, and fewer again. Then the
// instance's shared memory, its limit raised, and its persistent grid (as
// many blocks as fit the card at once, at most one a chunk). An error where
// one pair in one slot does not fit.
struct Ring16 {
  focal::Geo geo;
  bool wide;
  size_t smem;
  int grid, sms;
  cudaError_t err;
};

template <class Kernel, class Floats, class Pick>
Ring16 plan_ring16(int B, int N, int C, int H, const Floats& floats, const Pick& pick,
                   Kernel* kernel) {
  Ring16 r{};
  int optin = 0, per_sm = 0;
  r.err = device_attr(cudaDevAttrMultiProcessorCount, &r.sms);
  if (r.err == cudaSuccess) r.err = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin);
  if (r.err != cudaSuccess) return r;
  const focal::Geo full = focal::make_geo(B, H, N, C / H);
  r.geo = full;
  while (floats(r.geo, r.wide) * sizeof(float) > (size_t)optin) {
    if (r.geo.pairs > 1) {
      --r.geo.pairs;
    } else if (!r.wide) {
      r.wide = true;
      r.geo.pairs = full.pairs;
    } else {
      r.err = cudaErrorInvalidValue;
      return r;
    }
  }
  r.smem = floats(r.geo, r.wide) * sizeof(float);
  *kernel = pick(r.geo, r.wide);
  r.err = focal::raise_smem(*kernel, r.smem);
  if (r.err == cudaSuccess)
    r.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, *kernel, kThreads, r.smem);
  if (r.err == cudaSuccess && per_sm < 1) r.err = cudaErrorInvalidConfiguration;
  if (r.err != cudaSuccess) return r;
  const long long nchunks = (r.geo.total + r.geo.pairs - 1) / r.geo.pairs;
  r.grid = (int)std::min<long long>(nchunks, (long long)per_sm * r.sms);
  return r;
}

size_t bf16_floats(size_t n) { return (n + 7) / 8 * 4; }

// Launch plan of the bf16 forward: the attention's ring (plan_ring16, over
// D = H hd) and instance, the products' tile widths, the workspace in
// floats: qkv [R, 3D] f32, then ao [R, D] bf16 (16-byte aligned: D is a
// multiple of 8).
struct FwdPlan16 {
  Ring16 ring;
  AttnFwd16 attn;
  int qbn, ybn;
  size_t qkv, ao, total;
  cudaError_t err;
};

FwdPlan16 make_fwd_plan16(int B, int N, int C, int D, int H, bool dropout) {
  FwdPlan16 P{};
  P.ring = plan_ring16(
      B, N, D, H, attn_fwd16_floats,
      [&](const focal::Geo& g, bool) {
        return dropout ? attn_fwd16_kernel<true>(g) : attn_fwd16_kernel<false>(g);
      },
      &P.attn);
  P.err = P.ring.err;
  const int R = B * N;
  P.qbn = tile_bn(3 * D, 0);
  P.ybn = tile_bn(C, 0);
  P.qkv = 0;
  P.ao = (size_t)R * 3 * D;
  P.total = P.ao + bf16_floats((size_t)R * D);
  return P;
}

// Launch plan of the bf16 backward: the attention's ring (plan_ring16) and
// instance; the products' tile widths; the weight gradients' row splits
// (wgrad_splits); the workspace, in floats, each array 16-byte aligned: qkv
// [R, 3D] and g [R, D] f32, dqkv [R, 3D] and ao [R, D] bf16, the attention
// blocks' partials of dbqkv [grid][3D], dbproj [grid][C] and d rel_bias
// [grid][H N N], the weight-gradient split partials [splits][4 C D].
struct BwdPlan16 {
  Ring16 ring;
  AttnBwd16 attn;
  int qbn, dbn, wbn, splits, rows_per_split;
  size_t qkv, g, dqkv, ao, dbqkv, dbproj, dbias, wpart, total;
  cudaError_t err;
};

BwdPlan16 make_bwd_plan16(int B, int N, int C, int D, int H, bool dropout) {
  BwdPlan16 P{};
  P.ring = plan_ring16(
      B, N, D, H, [&](const focal::Geo& g, bool wide) { return attn_bwd16_floats(g, D, wide); },
      [&](const focal::Geo& g, bool wide) {
        return dropout ? attn_bwd16_kernel<true>(g, wide) : attn_bwd16_kernel<false>(g, wide);
      },
      &P.attn);
  P.err = P.ring.err;
  if (P.err != cudaSuccess) return P;
  const int R = B * N, grid = P.ring.grid;
  P.qbn = tile_bn(3 * D, D);
  P.dbn = tile_bn(C, 0);
  P.wbn = tile_bn(3 * D, C);
  const int wtiles = wgk::wgrad_tiles(C, 3 * D, P.wbn) + wgk::wgrad_tiles(D, C, P.wbn);
  const wgk::WgradSplits ws = wgk::wgrad_splits(R, wtiles, P.ring.sms);
  P.splits = ws.splits;
  P.rows_per_split = ws.rows_per_split;
  const size_t E = (size_t)4 * C * D, nn = (size_t)N * N;
  size_t o = 0;
  P.qkv = o, o += (size_t)R * 3 * D;
  P.g = o, o += (size_t)R * D;
  P.dqkv = o, o += bf16_floats((size_t)R * 3 * D);
  P.ao = o, o += bf16_floats((size_t)R * D);
  P.dbqkv = o, o += (size_t)grid * 3 * D;
  P.dbproj = o, o += (size_t)grid * C;
  P.dbias = o, o += ((size_t)grid * H * nn + 3) / 4 * 4;
  P.wpart = o, o += (size_t)P.splits * E;
  P.total = o;
  return P;
}

// make(B, N, C, D, H, dropout) once a geometry and device (one cache a
// plan type): its attribute and occupancy queries cost host time a call
// would otherwise pay.
template <class Plan>
Plan cached_plan(int B, int N, int C, int D, int H, bool dropout,
                 Plan (*make)(int, int, int, int, int, bool)) {
  static std::mutex mutex;
  static std::map<std::array<int, 7>, Plan> plans;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    Plan P{};
    P.err = err;
    return P;
  }
  const std::array<int, 7> key{dev, B, N, C, D, H, (int)dropout};
  std::lock_guard<std::mutex> lock(mutex);
  const auto it = plans.find(key);
  if (it != plans.end()) return it->second;
  const Plan P = make(B, N, C, D, H, dropout);
  if (P.err == cudaSuccess) plans.emplace(key, P);
  return P;
}

FwdPlan16 fwd_plan16(int B, int N, int C, int D, int H, bool dropout) {
  return cached_plan(B, N, C, D, H, dropout, make_fwd_plan16);
}

BwdPlan16 bwd_plan16(int B, int N, int C, int D, int H, bool dropout) {
  return cached_plan(B, N, C, D, H, dropout, make_bwd_plan16);
}

template <int kBN>
int launch_qkvg(const CUtensorMap (&m)[6], const QkvgArgs& a, int sms, cudaStream_t s) {
  return wgk::launch(wb_wg_qkvg_kernel<kBN>, std::min(qkvg_tiles(a, kBN), sms),
                     StoreSmem<kBN, true>::kBytes, s, m[0], m[1], m[2], m[3], m[4], m[5], a);
}

// dx (wb_wg_dx_kernel) or y (wb_wg_y_kernel): [R, C] in kBN-wide tiles.
template <int kBN, class Kernel, class... Args>
int launch_store(Kernel kernel, const CUtensorMap (&m)[3], int R, int C, int sms, cudaStream_t s,
                 const Args&... args) {
  const int tiles = (R + wgk::kBM - 1) / wgk::kBM * ((C + kBN - 1) / kBN);
  return wgk::launch(kernel, std::min(tiles, sms), StoreSmem<kBN>::kBytes, s, m[0], m[1], m[2],
                     args...);
}

// The bf16 entry points' geometry: check_geometry's, and bf16 rows of C
// and D values 16-byte multiples (the products stage them by TMA).
int check_geometry16(int N, int C, int D, int H) {
  return check_geometry(N, C, D, H) || C % 8 != 0 || D % 8 != 0 ? (int)cudaErrorInvalidValue : 0;
}

// The bf16 forward's three launches on `stream` (focal_wblock_fwd_bf16):
// (a) qkv = x Wqkv + bqkv in f32 (wb_wg_qkvg_kernel, problem 0 alone), (b)
// the attention (attn_fwd_bf16_kernel: ao in bf16, the keep mask), (c) y =
// ao Wproj + bproj in bf16 (wb_wg_y_kernel).
int wblock_fwd_bf16(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                    const void* bproj, const void* rel_bias, const void* mask, void* y,
                    void* keep, void* ws, int B, int N, int C, int D, int H, int nW,
                    unsigned long long seed, unsigned threshold, float inv_keep, void* stream) {
  if (check_geometry16(N, C, D, H) || (mask != nullptr && nW < 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const FwdPlan16 P = fwd_plan16(B, N, C, D, H, keep != nullptr);
  if (P.err != cudaSuccess) return (int)P.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * N, sms = P.ring.sms;
  float* w = static_cast<float*>(ws);
  float* qkv = w + P.qkv;
  bf16* ao = reinterpret_cast<bf16*>(w + P.ao);
  // (a) qkv = x Wqkv + bqkv: A = x K-major, B = Wqkv MN-major as it lies
  CUtensorMap mq[6];
  if (int e = wgk::map(&mq[0], x, R, C, wgk::kBM)) return e;
  if (int e = wgk::map(&mq[1], wqkv, C, 3 * D, 64)) return e;
  if (int e = wgk::map(&mq[4], qkv, R, 3 * D, wgk::kBM, true)) return e;
  mq[2] = mq[0];  // problem 1's maps: no problem 1
  mq[3] = mq[1];
  mq[5] = mq[4];
  const QkvgArgs qa{static_cast<const float*>(bqkv), qkv, nullptr, R, C, D};
  if (int e = P.qbn == 128 ? launch_qkvg<128>(mq, qa, sms, s) : launch_qkvg<64>(mq, qa, sms, s))
    return e;
  // (b) the attention per (window, head)
  const AttnFwdArgs aa{qkv, static_cast<const float*>(rel_bias), static_cast<const float*>(mask), ao,
                       static_cast<unsigned char*>(keep), seed, threshold, inv_keep, D,
                       mask != nullptr ? nW : 1, P.ring.wide ? 0 : 1};
  P.attn<<<P.ring.grid, kThreads, P.ring.smem, s>>>(aa, P.ring.geo);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  // (c) y = ao Wproj + bproj: A = ao K-major, B = Wproj MN-major as it lies
  CUtensorMap my[3];
  if (int e = wgk::map(&my[0], ao, R, D, wgk::kBM)) return e;
  if (int e = wgk::map(&my[1], wproj, D, C, 64)) return e;
  if (int e = wgk::map(&my[2], y, R, C, wgk::kBM)) return e;
  const float* bp = static_cast<const float*>(bproj);
  return P.ybn == 128 ? launch_store<128>(wb_wg_y_kernel<128>, my, R, C, sms, s, bp, R, C, D)
                      : launch_store<64>(wb_wg_y_kernel<64>, my, R, C, sms, s, bp, R, C, D);
}

// The bf16 backward's five launches on `stream` (focal_wblock_bwd_bf16):
// (a) qkv and g, (b) the attention backward (with the partials of d
// rel_bias, dbqkv and dbproj), (c) dx, (d) the weight-gradient split
// partials x^T dqkv and ao^T dy, (e) the ordered reduction of every
// partial.
int wblock_bwd_bf16(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                    const void* rel_bias, const void* mask, const void* dy, const void* keep,
                    float inv_keep, void* dx, void* dweights, void* drel_bias, void* ws, int B,
                    int N, int C, int D, int H, int nW, void* stream) {
  if (check_geometry16(N, C, D, H) || (mask != nullptr && nW < 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const bool dropout = keep != nullptr;
  const BwdPlan16 P = bwd_plan16(B, N, C, D, H, dropout);
  if (P.err != cudaSuccess) return (int)P.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * N, sms = P.ring.sms;
  float* w = static_cast<float*>(ws);
  float *qkv = w + P.qkv, *g = w + P.g;
  bf16* dqkv = reinterpret_cast<bf16*>(w + P.dqkv);
  bf16* ao = reinterpret_cast<bf16*>(w + P.ao);
  // (a) qkv = x Wqkv + bqkv (recomputed) and g = dy Wproj^T
  CUtensorMap mq[6];
  if (int e = wgk::map(&mq[0], x, R, C, wgk::kBM)) return e;
  if (int e = wgk::map(&mq[1], wqkv, C, 3 * D, 64)) return e;
  if (int e = wgk::map(&mq[2], dy, R, C, wgk::kBM)) return e;
  if (int e = wgk::map(&mq[3], wproj, D, C, P.qbn)) return e;
  if (int e = wgk::map(&mq[4], qkv, R, 3 * D, wgk::kBM, true)) return e;
  if (int e = wgk::map(&mq[5], g, R, D, wgk::kBM, true)) return e;
  const QkvgArgs qa{static_cast<const float*>(bqkv), qkv, g, R, C, D};
  if (int e = P.qbn == 128 ? launch_qkvg<128>(mq, qa, sms, s) : launch_qkvg<64>(mq, qa, sms, s))
    return e;
  // (b) the attention backward per (window, head)
  const AttnBwdArgs aa{qkv, g, static_cast<const float*>(rel_bias), static_cast<const float*>(mask),
                       static_cast<const unsigned char*>(keep), static_cast<const bf16*>(dy), dqkv,
                       ao, w + P.dbqkv, w + P.dbproj, w + P.dbias, inv_keep, D,
                       mask != nullptr ? nW : 1, R, C};
  P.attn<<<P.ring.grid, kThreads, P.ring.smem, s>>>(aa, P.ring.geo);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  // (c) dx = dqkv Wqkv^T: A = dqkv K-major, B^T = Wqkv K-major as it lies
  CUtensorMap md[3];
  if (int e = wgk::map(&md[0], dqkv, R, 3 * D, wgk::kBM)) return e;
  if (int e = wgk::map(&md[1], wqkv, C, 3 * D, P.dbn)) return e;
  if (int e = wgk::map(&md[2], dx, R, C, wgk::kBM)) return e;
  if (int e = P.dbn == 128 ? launch_store<128>(wb_wg_dx_kernel<128>, md, R, C, sms, s, R, C, D)
                            : launch_store<64>(wb_wg_dx_kernel<64>, md, R, C, sms, s, R, C, D))
    return e;
  // (d) dWqkv = x^T dqkv and dWproj = ao^T dy over the row splits, all four
  //     operands MN-major as they lie
  CUtensorMap mw[4];
  if (int e = wgk::map(&mw[0], x, R, C, 64)) return e;
  if (int e = wgk::map(&mw[1], dqkv, R, 3 * D, 64)) return e;
  if (int e = wgk::map(&mw[2], ao, R, D, 64)) return e;
  if (int e = wgk::map(&mw[3], dy, R, C, 64)) return e;
  const wgk::WgradArgs wa{w + P.wpart, R, C, 3 * D, D, C, P.rows_per_split, P.splits, 0};
  if (int e = wgk::launch_wgrad<Src>(mw, wa, P.wbn, sms, s)) return e;
  // (e) the weights over the splits in split order; dbqkv, dbproj and d
  //     rel_bias over the attention blocks in block order
  const wgk::ReduceArgs ra{w + P.wpart, w + P.dbqkv, w + P.dbproj, w + P.dbias,
                           static_cast<float*>(dweights), static_cast<float*>(drel_bias),
                           P.splits, P.ring.grid, C, 3 * D, D, C, H * N * N};
  return wgk::launch_reduce<Src>(ra, s);
}

}  // namespace

// Workspace of the f32 forward (#1, #2, #4; #4-TP), in floats: the qkv
// projection [R, 3D] and the attention output [R, D], R = B N, D = C but
// for a tensor-parallel shard's heads. An error where the attention has no
// launch plan (a head too wide for shared memory).
extern "C" int focal_wblock_fwd_workspace(int B, int N, int C, int D, int H, long long* floats) {
  if (check_geometry(N, C, D, H) || B < 0) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    focal::Geo g;
    size_t smem = 0;
    const cudaError_t err = attn_geo(B, N, D, H, attn_fwd_smem, &g, &smem);
    if (err != cudaSuccess) return (int)err;
  }
  *floats = (long long)B * N * 4 * D;
  return 0;
}

// Forward (#1 with `keep` null; #2 and #4 with attention dropout where
// `keep` is not null: each (window, head, query, key) weight is kept iff its
// Philox word (keyed by `seed`) is >= `threshold`, then scaled by
// `inv_keep`, and the keep mask is written to `keep` as uint8 [B, H, N, N]).
// x [B, N, C], wqkv [C, 3D], bqkv [3D], wproj [D, C], bproj [C], rel_bias
// [H, N, N], D = H hd (D = C but for #4-TP, a tensor-parallel shard's H
// heads, whose y is a partial sum). Pointers are device pointers to
// contiguous f32 tensors; `mask` may be null (nW ignored). `ws` holds
// focal_wblock_fwd_workspace floats, 16-byte aligned, as x, wqkv and wproj
// must be. Three launches on `stream`: qkv = x Wqkv + bqkv, the attention
// per (window, head), y = ao Wproj + bproj.
extern "C" int focal_wblock_fwd_dropout(const void* x, const void* wqkv, const void* bqkv,
                                        const void* wproj, const void* bproj,
                                        const void* rel_bias, const void* mask, void* y,
                                        void* keep, void* ws, int B, int N, int C, int D, int H,
                                        int nW, unsigned long long seed, unsigned threshold,
                                        float inv_keep, void* stream) {
  return wblock_fwd(static_cast<const float*>(x), static_cast<const float*>(wqkv),
                    static_cast<const float*>(bqkv), static_cast<const float*>(wproj),
                    static_cast<const float*>(bproj), rel_bias, mask, static_cast<float*>(y), keep,
                    ws, B, N, C, D, H, nW, seed, threshold, inv_keep, stream);
}

// Workspace the bf16 forward (#1-bf16, #2-bf16, #4-bf16, #4-TP-bf16;
// `dropout` for the instance with a keep mask) needs, in floats, for this
// geometry on the current device (make_fwd_plan16): qkv [R, 3D] f32 and
// the attention output [R, D] bf16. An error where C or D is not a multiple
// of 8 or the attention has no launch plan.
extern "C" int focal_wblock_fwd_workspace_bf16(int B, int N, int C, int D, int H, int dropout,
                                               long long* floats) {
  if (check_geometry16(N, C, D, H) || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) {
    *floats = 0;
    return 0;
  }
  const FwdPlan16 P = fwd_plan16(B, N, C, D, H, dropout != 0);
  if (P.err != cudaSuccess) return (int)P.err;
  *floats = (long long)P.total;
  return 0;
}

// The forward in bf16 (#1-bf16 with `keep` null, #2-bf16 with it; #4-bf16;
// #4-TP-bf16 at D < C): focal_wblock_fwd_dropout's function with x, wqkv
// [C, 3D], wproj [D, C] and y bf16 (C and D multiples of 8; the weights
// read as they lie), bqkv,
// bproj, rel_bias and mask f32: qkv = x Wqkv + bqkv kept in f32, the
// softmax and dropout in f32, the attention output rounded once to bf16, y
// rounded once after the bias. x, the weights, y and `ws` 16-byte aligned;
// `ws` holds focal_wblock_fwd_workspace_bf16 floats. Three launches on
// `stream` (wblock_fwd_bf16). An error code at or above 100000 is libcuda's
// refusal of a tensor map (CUresult + 100000).
extern "C" int focal_wblock_fwd_bf16(const void* x, const void* wqkv, const void* bqkv,
                                     const void* wproj, const void* bproj, const void* rel_bias,
                                     const void* mask, void* y, void* keep, void* ws, int B, int N,
                                     int C, int D, int H, int nW, unsigned long long seed,
                                     unsigned threshold, float inv_keep, void* stream) {
  return wblock_fwd_bf16(x, wqkv, bqkv, wproj, bproj, rel_bias, mask, y, keep, ws, B, N, C, D, H,
                         nW, seed, threshold, inv_keep, stream);
}

// Workspace the backward (#3, #5; #5-TP) needs, in floats, for this
// geometry on the current device (bwd_plan).
extern "C" int focal_wblock_bwd_workspace(int B, int N, int C, int D, int H, int dropout,
                                          long long* floats) {
  if (check_geometry(N, C, D, H)) return (int)cudaErrorInvalidValue;
  if (B == 0) {
    *floats = 0;
    return 0;
  }
  const BwdPlan P = bwd_plan(B, N, C, D, H, dropout != 0);
  if (P.err != cudaSuccess) return (int)P.err;
  *floats = (long long)P.total;
  return 0;
}

// Backward (#3; #5; #5-TP at D < C). Inputs: x, wqkv [C, 3D] and its
// transpose [3D, C], bqkv, the transpose of wproj [D, C] ([C, D]), rel_bias,
// mask (may be null), dy, keep (uint8 [B, H, N, N] from the forward, or null
// for no dropout) with inv_keep; x, the weights, dy and `ws` 16-byte
// aligned. Outputs: dx [B, N, C] (a partial sum at D < C); dweights, flat
// [dWqkv C*3D | dbqkv 3D | dWproj D*C | dbproj C]; drel_bias [H, N, N]. `ws`
// holds focal_wblock_bwd_workspace floats. Six launches on `stream`
// (wblock_bwd).
extern "C" int focal_wblock_bwd(const void* x, const void* wqkv, const void* bqkv,
                                const void* wqkv_t, const void* wproj_t, const void* rel_bias,
                                const void* mask, const void* dy, const void* keep,
                                float inv_keep, void* dx, void* dweights, void* drel_bias,
                                void* ws, int B, int N, int C, int D, int H, int nW,
                                void* stream) {
  return wblock_bwd(static_cast<const float*>(x), static_cast<const float*>(wqkv),
                    static_cast<const float*>(bqkv), static_cast<const float*>(wqkv_t),
                    static_cast<const float*>(wproj_t), rel_bias, mask,
                    static_cast<const float*>(dy), keep, inv_keep, static_cast<float*>(dx),
                    dweights, drel_bias, ws, B, N, C, D, H, nW, stream);
}

// Workspace the bf16 backward (#3-bf16, #5-bf16, #5-TP-bf16) needs, in
// floats, for this geometry on the current device (make_bwd_plan16); an
// error where C or D is not a multiple of 8 or the attention has no launch
// plan.
extern "C" int focal_wblock_bwd_workspace_bf16(int B, int N, int C, int D, int H, int dropout,
                                               long long* floats) {
  if (check_geometry16(N, C, D, H) || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) {
    *floats = 0;
    return 0;
  }
  const BwdPlan16 P = bwd_plan16(B, N, C, D, H, dropout != 0);
  if (P.err != cudaSuccess) return (int)P.err;
  *floats = (long long)P.total;
  return 0;
}

// The backward in bf16 (#3-bf16; #5-bf16; #5-TP-bf16 at D < C, dx then a
// partial sum): focal_wblock_bwd's function with x, wqkv [C, 3D], wproj
// [D, C], dy and dx bf16 (C and D multiples of 8; every one read as it
// lies, so no transposed weight), bqkv, rel_bias and mask
// f32; the weight, bias and bias-table gradients f32 in focal_wblock_bwd's
// layout. x, the weights, dy, dx and `ws` 16-byte aligned; `ws` holds
// focal_wblock_bwd_workspace_bf16 floats. Five launches on `stream`
// (wblock_bwd_bf16). An error code at or above 100000 is libcuda's refusal
// of a tensor map (CUresult + 100000).
extern "C" int focal_wblock_bwd_bf16(const void* x, const void* wqkv, const void* bqkv,
                                     const void* wproj, const void* rel_bias, const void* mask,
                                     const void* dy, const void* keep, float inv_keep, void* dx,
                                     void* dweights, void* drel_bias, void* ws, int B, int N,
                                     int C, int D, int H, int nW, void* stream) {
  return wblock_bwd_bf16(x, wqkv, bqkv, wproj, rel_bias, mask, dy, keep, inv_keep, dx, dweights,
                         drel_bias, ws, B, N, C, D, H, nW, stream);
}

// The projections' product alone, for the checks: c = a b with a [M, K]
// row-major or, with a_trans, c = a^T b with a stored [K, M], followed in c
// by b's column sums (c then holds M N + N floats). b is [K, N]; N and
// (a_trans ? M : K) must be multiples of 4. One launch on `stream`.
extern "C" int focal_gemm_3xtf32(const void* a, const void* b, void* c, int M, int N, int K,
                                 int a_trans, void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 4 != 0 || (a_trans ? M : K) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* cf = static_cast<float*>(c);
  if (!a_trans) return (int)launch_proj(proj_gemm(af, K, bf, N, nullptr, cf, N, M, N, K), ProjGemm{}, s);
  const int bn = tile_bn(N, 0);
  const focal::WgradGemm p = focal::wgrad_gemm(af, bf, M, N, 0, (size_t)M * N, bn);
  return (int)focal::launch_wgrad<Src>(bn, p, focal::WgradGemm{}, K, K, 1, cf, 0, false, s);
}

extern "C" const char* focal_cuda_error_string(int err) {
  if (err >= wgk::kMapError) return "cuTensorMapEncodeTiled refused a tensor map (CUresult: the code less 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
