// Whole-block Swin window attention for Hopper (sm_90a): forward (#1),
// forward with attention dropout (#2) and backward (#3), and the same
// function for blocks too wide for them: forward (#4) and backward (#5).
//
// Replaces the TPU kernels of focal_tpu/ops/pallas_kernels.py:
//   #1 _wblock_fwd_kernel (fused_window_block -> _wblock_fwd_impl -> pl.pallas_call)
//   #2 the same kernel with rate > 0 (fused_window_block_dropout), which also
//      writes its keep mask out
//   #3 _wblock_bwd_kernel (_wblock_bwd_impl -> pl.pallas_call), the VJP of both
//   #4 _wblock_ph_fwd_kernel (_wblock_ph_fwd_impl -> pl.pallas_call), with
//      and without dropout
//   #5 _wblock_ph_bwd_kernel (_wblock_ph_bwd_impl -> pl.pallas_call)
// Per window w of x [B, N, C] (f32, row-major):
//   qkv = x Wqkv + bqkv                      (q columns pre-scaled by the caller)
//   a_h = softmax(q_h k_h^T + rel_bias[h] + mask[w % nW])   for each head h
//   a_h = keep ? a_h / (1 - rate) : 0        (#2, #4 with dropout)
//   y   = concat_h(a_h v_h) Wproj + bproj
//
// What bounds them on this card: operations. A window does 2*9*C*4C
// multiply-adds of projection in the forward (2*9*C*11C in the backward) for
// 9*C*2 floats of activations in and out: at C = 64..1024 that is 69-900
// FLOP per byte, above the f32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s =
// 20 FLOP/byte) and the TF32 tensor-core ridge (495 TFLOP/s, 148 FLOP/byte)
// at C >= 256. About 99 % of the FLOPs are the projections.
//
// #1-#3 (C <= 256, MOD and MOD_WIDE stage 0), f32 on the CUDA cores:
//   * A block owns a few windows whose activations sit in dynamic shared
//     memory (forward: x and qkv, ~74 KB; backward: x, dy, qkv, d(attn out)
//     and dqkv, ~110 KB), so two blocks fit one SM. Each projection thread
//     computes one output column for all N rows of one window: every weight
//     it loads from global memory (L2 resident; consecutive threads read
//     consecutive columns) feeds N FMAs, and the activation operand is a
//     float4 broadcast from shared memory (project_rows).
//   * The attention (2% of the FLOPs) is one thread per (window, head, row)
//     with an exact N-long softmax: rows are not padded to a power of two.
//   * Dropout bits come from Philox4x32-10 keyed by the seed and counted by
//     (window, head, row): the mask is a pure function of (seed, geometry),
//     whatever the block shape. #2 writes it out as uint8 [B, H, N, N] and
//     #3 reads it back, as the TPU kernels store theirs.
//   * The backward's cross-window sums (dWqkv, dbqkv, dWproj, dbproj: a
//     reduction over B*N rows; d rel_bias: over B windows) are deterministic:
//     the per-window kernel writes dqkv and the attention output to a
//     workspace, a split-K kernel with a fixed row range per block writes
//     one partial per split, and a second kernel sums the partials in split
//     order. No atomics, so two runs give the same bits.
//   * f32 throughout with fmaf and expf: no TF32, no bf16 (the TPU kernel's
//     bf16 downcast at C >= 128 was a VMEM workaround that does not apply).
//
// #4 and #5 (C = 512, 1024: MOD_WIDE stages 1-2). The TPU kernels walk the
// heads of a lane-tile of 128 windows in VMEM, so each weight they load
// feeds a thousand rows. Kept per window, as the first port did, a block
// held one or two windows (x, dy, dx rows are ~186 KB a window at C = 1024)
// and each weight fed 9 or 18 FMAs from L2: 4-6 TFLOP/s. Here the fused
// per-window structure is dropped for the card's:
//   * The projections are matrix products over all R = B N rows of the
//     launch, 128 x 128 output tiles a block, staged by a 3-deep cp.async
//     ring and run on the tensor cores with mma.sync (gemm_3xtf32.cuh). Each
//     staged weight feeds 128 rows. 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi
//     b_hi) keeps f32 accuracy: the ~1e-4 gates of the f32 kernels hold; one
//     TF32 product would not. Bound on these units: 3x the FLOPs at 495
//     TFLOP/s.
//       #4: qkv = x Wqkv + bqkv into a workspace [R, 3C]; the attention;
//           y = ao Wproj + bproj.
//       #5: qkv and g = dy Wproj^T (one launch); the attention backward
//           (dq | dk | dv into [R, 3C], the attention output into [R, C]);
//           dx = dqkv Wqkv^T; the weight gradients x^T dqkv and ao^T dy with
//           their column sums as fixed split-K partials (A read transposed
//           in the tile loads: no copies); the ordered reductions.
//   * The attention (<1 % of the FLOPs, bound by bytes) is the row-parallel
//     design of the attention-only kernels #6-#9 (window_rows.cuh): a block
//     stages a few (window, head) pairs' rows, G lanes a query row, scores
//     and softmax in registers. #4 draws its mask with #2's Philox counters
//     (#2 and #4 agree bit for bit) and writes it; #5 reads it back.
//   * No float atomics anywhere: the same bits on every call.
//   * Not yet: wgmma and TMA (the tf32 wgmma takes K-major operands only;
//     wqkv_t and wproj_t are that layout already), and fusing the attention
//     into the projections' epilogues.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "gemm_3xtf32.cuh"
#include "philox.cuh"
#include "window_rows.cuh"

namespace {

constexpr int kMaxN = 16;            // window tokens a thread keeps in registers
// Threads of every block launched here. The block-wide loops step by this
// constant, not by blockDim.x: the runtime stride cost #1 5 % on the H100.
constexpr int kThreads = 256;
constexpr int kActBudget = 73728;    // forward: bytes of x + qkv per block (two blocks per SM)
constexpr int kBwdBudget = 112640;   // backward: bytes of activations per block (two per SM)
constexpr int kTile = 64;            // weight-gradient output tile (rows and columns)
constexpr int kTileK = 16;           // weight-gradient rows per shared-memory stage
static_assert(kMaxN == focal::kAttnMaxN && kThreads == focal::kAttnThreads &&
                  kThreads == focal::kGemmThreads,
              "one block size and window bound for every kernel here");

int windows_per_block(int N, int C) {
  const int wpb = kActBudget / (N * 16 * C);
  return wpb < 1 ? 1 : wpb;
}

size_t smem_bytes(int wpb, int N, int C) {
  return (size_t)wpb * N * ((C + 4) + (3 * C + 1)) * sizeof(float);
}

// ---------------------------------------------------------------------------
// shared device helpers

// Copy `rows` rows of C floats (contiguous in global memory) into shared
// memory rows of `stride` floats (stride % 4 == 0), float4 at a time.
__device__ __forceinline__ void load_rows(const float* __restrict__ g, int C, float* s,
                                          int stride, int rows) {
  const int c4 = C / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
    const int row = i / c4, col = i - row * c4;
    *reinterpret_cast<float4*>(s + row * stride + col * 4) = g4[i];
  }
}

// The reverse of load_rows.
__device__ __forceinline__ void store_rows(const float* s, int stride, float* __restrict__ g,
                                           int C, int rows) {
  const int c4 = C / 4;
  float4* g4 = reinterpret_cast<float4*>(g);
  for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
    const int row = i / c4, col = i - row * c4;
    g4[i] = *reinterpret_cast<const float4*>(s + row * stride + col * 4);
  }
}

// dst[w][r][j] = sum_k src[w][r][k] W[k][j] (+ bias[j]) for nwin windows of N
// rows, j < ncols, k < K (K % 4 == 0). src is shared memory with rows of
// src_stride floats (% 4 == 0); W is global [K][ldw]; dst rows are
// dst_stride floats apart and windows dst_win_stride floats apart (shared or
// global memory). One (window, column) per item, all N rows at once.
__device__ __forceinline__ void project_rows(const float* src, int src_stride, int K,
                                             const float* __restrict__ W, int ldw, int ncols,
                                             const float* __restrict__ bias, float* dst,
                                             int dst_stride, int dst_win_stride, int nwin,
                                             int N) {
  for (int item = threadIdx.x; item < nwin * ncols; item += kThreads) {
    const int w = item / ncols, j = item - w * ncols;
    const float* sw = src + w * N * src_stride;
    float acc[kMaxN];
#pragma unroll
    for (int r = 0; r < kMaxN; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; k += 4) {
      const float b0 = __ldg(W + (size_t)(k + 0) * ldw + j);
      const float b1 = __ldg(W + (size_t)(k + 1) * ldw + j);
      const float b2 = __ldg(W + (size_t)(k + 2) * ldw + j);
      const float b3 = __ldg(W + (size_t)(k + 3) * ldw + j);
#pragma unroll
      for (int r = 0; r < kMaxN; ++r) {
        if (r < N) {
          const float4 a = *reinterpret_cast<const float4*>(sw + r * src_stride + k);
          acc[r] = fmaf(a.x, b0, acc[r]);
          acc[r] = fmaf(a.y, b1, acc[r]);
          acc[r] = fmaf(a.z, b2, acc[r]);
          acc[r] = fmaf(a.w, b3, acc[r]);
        }
      }
    }
    const float bj = bias ? __ldg(bias + j) : 0.f;
    float* dw = dst + w * dst_win_stride;
#pragma unroll
    for (int r = 0; r < kMaxN; ++r) {
      if (r < N) dw[r * dst_stride + j] = acc[r] + bj;
    }
  }
}

// p = exp(p - mx) / sum over the first N entries, in registers; mx is
// their maximum.
__device__ __forceinline__ void softmax_from_max(float (&p)[kMaxN], float mx, int N) {
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    if (j < N) {
      p[j] = expf(p[j] - mx);
      sum += p[j];
    }
  }
  const float inv = 1.f / sum;
#pragma unroll
  for (int j = 0; j < kMaxN; ++j)
    if (j < N) p[j] *= inv;
}

// p[j] = softmax_j(q . k_j + bias[j] + mask[j]) for one query row. q and the
// k rows (kr0 + j * stride) hold hd floats of one head. The maximum is taken
// in the score loop: split into a loop of its own, #1 lost 1.5 % on the
// H100 (48 registers and a spill instead of 75).
__device__ __forceinline__ void softmax_row(const float* q, const float* kr0, int stride, int hd,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ m, int N,
                                            float (&p)[kMaxN]) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    if (j < N) {
      const float* kr = kr0 + j * stride;
      float d = 0.f;
      for (int t = 0; t < hd; ++t) d = fmaf(q[t], kr[t], d);
      d += __ldg(bias + j);
      if (m) d += __ldg(m + j);
      p[j] = d;
      mx = fmaxf(mx, d);
    }
  }
  softmax_from_max(p, mx, N);
}

// Attention dropout of one (window, head, query row): the keep flags of
// focal::attn_keep_row (philox.cuh, the counter rule #7 and #9 share).
// Writes the row's keep bytes to kr and scales the kept weights by inv_keep,
// zeroing the rest. #2 and #4 both draw through here, so the mask depends on
// (seed, geometry) only.
__device__ __forceinline__ void drop_row(float (&p)[kMaxN], int N, unsigned window, int h, int i,
                                         unsigned long long seed, unsigned threshold,
                                         float inv_keep, unsigned char* __restrict__ kr) {
  bool kept[kMaxN];
  focal::attn_keep_row(seed, window, h, i, N, threshold, kept);
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    if (j < N) {
      kr[j] = kept[j] ? 1 : 0;
      p[j] = kept[j] ? p[j] * inv_keep : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// forward (#1; #2 with kDropout)

template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
wblock_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                  const float* __restrict__ bqkv, const float* __restrict__ wproj,
                  const float* __restrict__ bproj, const float* __restrict__ rel_bias,
                  const float* __restrict__ mask, float* __restrict__ y,
                  unsigned char* __restrict__ keep, unsigned long long seed,
                  unsigned threshold, float inv_keep, int B, int N, int C, int H, int nW,
                  int wpb) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int xs_stride = C + 4;      // x rows, later the attention output rows
  const int qs_stride = 3 * C + 1;  // qkv rows
  float* xs = smem;                          // [wpb][N][C + 4]
  float* qs = smem + wpb * N * xs_stride;    // [wpb][N][3C + 1]
  const int w0 = blockIdx.x * wpb;
  const int nwin = min(wpb, B - w0);
  const int hd = C / H;

  // 1. the block's windows are contiguous in x: stage them in shared memory
  load_rows(x + (size_t)w0 * N * C, C, xs, xs_stride, nwin * N);
  __syncthreads();

  // 2. qkv = x Wqkv + bqkv
  project_rows(xs, xs_stride, C, wqkv, 3 * C, 3 * C, bqkv, qs, qs_stride, N * qs_stride, nwin, N);
  __syncthreads();

  // 3. attention per (window, head, query row); the output overwrites x,
  //    which step 2 has consumed
  for (int item = threadIdx.x; item < nwin * H * N; item += kThreads) {
    const int i = item % N;
    const int h = (item / N) % H;
    const int w = item / (N * H);
    const float* qw = qs + w * N * qs_stride;
    const float* m = mask ? mask + ((size_t)((w0 + w) % nW) * N + i) * N : nullptr;
    float s[kMaxN];
    softmax_row(qw + i * qs_stride + h * hd, qw + C + h * hd, qs_stride, hd,
                rel_bias + (h * N + i) * N, m, N, s);
    if (kDropout)
      drop_row(s, N, (unsigned)(w0 + w), h, i, seed, threshold, inv_keep,
               keep + (((size_t)(w0 + w) * H + h) * N + i) * N);
    const float* vbase = qw + 2 * C + h * hd;
    float* o = xs + (w * N + i) * xs_stride + h * hd;
    for (int t = 0; t < hd; ++t) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxN; ++j)
        if (j < N) a = fmaf(s[j], vbase[j * qs_stride + t], a);
      o[t] = a;
    }
  }
  __syncthreads();

  // 4. y = attn_out Wproj + bproj, written straight to global memory
  project_rows(xs, xs_stride, C, wproj, C, C, bproj, y + (size_t)w0 * N * C, C, N * C, nwin, N);
}

// ---------------------------------------------------------------------------
// backward (#3)

// Shared-memory layout of the per-window backward, in floats.
struct BwdLayout {
  int wpb;
  int dq_stride, xs_stride, qs_stride, gs_stride;
  size_t dq, xs, qs, gs, ps, ds, dacc, total;
};

BwdLayout bwd_layout(int wpb, int N, int C, int H) {
  BwdLayout L;
  L.wpb = wpb;
  L.dq_stride = 3 * C + 4;  // dy, then dqkv (float4 rows)
  L.xs_stride = C + 4;      // x, then the attention output (float4 rows)
  L.qs_stride = 3 * C + 1;  // qkv
  L.gs_stride = C + 1;      // d(attention output) = dy Wproj^T
  const size_t nn = (size_t)H * N * N;
  L.dq = 0;
  L.xs = L.dq + (size_t)wpb * N * L.dq_stride;
  L.qs = L.xs + (size_t)wpb * N * L.xs_stride;
  L.gs = L.qs + (size_t)wpb * N * L.qs_stride;
  L.ps = L.gs + (size_t)wpb * N * L.gs_stride;  // attention weights as applied to v
  L.ds = L.ps + wpb * nn;                       // score gradients
  L.dacc = L.ds + wpb * nn;                     // this block's d rel_bias
  L.total = L.dacc + nn;
  return L;
}

BwdLayout bwd_plan_layout(int N, int C, int H) {
  const BwdLayout one = bwd_layout(1, N, C, H);
  const size_t per_window = (one.total - (size_t)H * N * N) * sizeof(float);
  int wpb = (int)(kBwdBudget / per_window);
  return bwd_layout(wpb < 1 ? 1 : wpb, N, C, H);
}

// Per window: recompute qkv and the softmax, then dqkv, dx, the attention
// output (for dWproj) and the score gradients. dqkv and the attention output
// go to the workspace for the weight-gradient kernel; each block sums the
// score gradients of its windows (in window order) into one d rel_bias
// partial. Blocks walk the window chunks with a fixed stride, so the
// partials do not depend on timing.
template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
wblock_bwd_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                  const float* __restrict__ bqkv, const float* __restrict__ wqkv_t,
                  const float* __restrict__ wproj_t, const float* __restrict__ rel_bias,
                  const float* __restrict__ mask, const float* __restrict__ dy,
                  const unsigned char* __restrict__ keep, float inv_keep,
                  float* __restrict__ dx, float* __restrict__ dqkv_out,
                  float* __restrict__ ao_out, float* __restrict__ dbias_part, int B, int N,
                  int C, int H, int nW, BwdLayout L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* dqs = smem + L.dq;
  float* xs = smem + L.xs;
  float* qs = smem + L.qs;
  float* gs = smem + L.gs;
  float* ps = smem + L.ps;
  float* dss = smem + L.ds;
  float* dacc = smem + L.dacc;
  const int hd = C / H;
  const int nn = H * N * N;
  const int wpb = L.wpb;
  const int nchunks = (B + wpb - 1) / wpb;

  for (int e = threadIdx.x; e < nn; e += blockDim.x) dacc[e] = 0.f;

  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    const int w0 = chunk * wpb;
    const int nwin = min(wpb, B - w0);
    __syncthreads();  // the previous chunk's readers are done with shared memory

    // 1. x and dy of the chunk's windows
    load_rows(x + (size_t)w0 * N * C, C, xs, L.xs_stride, nwin * N);
    load_rows(dy + (size_t)w0 * N * C, C, dqs, L.dq_stride, nwin * N);
    __syncthreads();

    // 2. qkv = x Wqkv + bqkv (recomputed: the forward keeps no residual but
    //    x) and g = dy Wproj^T, the gradient of the attention output
    project_rows(xs, L.xs_stride, C, wqkv, 3 * C, 3 * C, bqkv, qs, L.qs_stride,
                 N * L.qs_stride, nwin, N);
    project_rows(dqs, L.dq_stride, C, wproj_t, C, C, nullptr, gs, L.gs_stride,
                 N * L.gs_stride, nwin, N);
    __syncthreads();

    // 3. per (window, head, query row i): softmax p, the weights applied to
    //    v (a), the attention output (into xs, consumed by step 2), the
    //    score gradient ds and dq (into dqs, whose dy step 2 consumed)
    for (int item = threadIdx.x; item < nwin * H * N; item += kThreads) {
      const int i = item % N;
      const int h = (item / N) % H;
      const int w = item / (N * H);
      const float* qw = qs + w * N * L.qs_stride;
      const float* m = mask ? mask + ((size_t)((w0 + w) % nW) * N + i) * N : nullptr;
      float p[kMaxN];
      softmax_row(qw + i * L.qs_stride + h * hd, qw + C + h * hd, L.qs_stride, hd,
                  rel_bias + (h * N + i) * N, m, N, p);
      float a[kMaxN], da[kMaxN];
      bool kp[kMaxN];
      const unsigned char* kr =
          kDropout ? keep + (((size_t)(w0 + w) * H + h) * N + i) * N : nullptr;
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) {
        if (j < N) {
          kp[j] = kDropout ? kr[j] != 0 : true;
          a[j] = kDropout ? (kp[j] ? p[j] * inv_keep : 0.f) : p[j];
        }
      }
      float* prow = ps + ((w * H + h) * N + i) * N;
#pragma unroll
      for (int j = 0; j < kMaxN; ++j)
        if (j < N) prow[j] = a[j];

      const float* vbase = qw + 2 * C + h * hd;
      const float* grow = gs + (w * N + i) * L.gs_stride + h * hd;
      float* o = xs + (w * N + i) * L.xs_stride + h * hd;
#pragma unroll
      for (int j = 0; j < kMaxN; ++j)
        if (j < N) da[j] = 0.f;
      for (int t = 0; t < hd; ++t) {
        const float gt = grow[t];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxN; ++j) {
          if (j < N) {
            const float vj = vbase[j * L.qs_stride + t];
            acc = fmaf(a[j], vj, acc);
            da[j] = fmaf(gt, vj, da[j]);
          }
        }
        o[t] = acc;
      }
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) {
        if (j < N) {
          if (kDropout) da[j] = kp[j] ? da[j] * inv_keep : 0.f;
          dot = fmaf(da[j], p[j], dot);
        }
      }
      float* dsrow = dss + ((w * H + h) * N + i) * N;
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) {
        if (j < N) {
          da[j] = p[j] * (da[j] - dot);  // ds
          dsrow[j] = da[j];
        }
      }
      const float* kbase = qw + C + h * hd;
      float* dq = dqs + (w * N + i) * L.dq_stride + h * hd;
      for (int t = 0; t < hd; ++t) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxN; ++j)
          if (j < N) acc = fmaf(da[j], kbase[j * L.qs_stride + t], acc);
        dq[t] = acc;
      }
    }
    __syncthreads();

    // 4. per (window, head, key row j): dk_j = sum_i ds[i][j] q_i and
    //    dv_j = sum_i a[i][j] g_i; and this block's d rel_bias += ds
    for (int item = threadIdx.x; item < nwin * H * N; item += kThreads) {
      const int j = item % N;
      const int h = (item / N) % H;
      const int w = item / (N * H);
      const float* qw = qs + w * N * L.qs_stride;
      const float* dsc = dss + (w * H + h) * N * N + j;
      const float* pc = ps + (w * H + h) * N * N + j;
      float dsj[kMaxN], aj[kMaxN];
#pragma unroll
      for (int i = 0; i < kMaxN; ++i) {
        if (i < N) {
          dsj[i] = dsc[i * N];
          aj[i] = pc[i * N];
        }
      }
      const float* qbase = qw + h * hd;
      const float* gbase = gs + w * N * L.gs_stride + h * hd;
      float* drow = dqs + (w * N + j) * L.dq_stride + h * hd;
      for (int t = 0; t < hd; ++t) {
        float dk = 0.f, dv = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxN; ++i) {
          if (i < N) {
            dk = fmaf(dsj[i], qbase[i * L.qs_stride + t], dk);
            dv = fmaf(aj[i], gbase[i * L.gs_stride + t], dv);
          }
        }
        drow[C + t] = dk;
        drow[2 * C + t] = dv;
      }
    }
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      float acc = dacc[e];
      for (int w = 0; w < nwin; ++w) acc += dss[w * nn + e];
      dacc[e] = acc;
    }
    __syncthreads();

    // 5. dx = dqkv Wqkv^T to global memory; dqkv and the attention output
    //    to the workspace
    project_rows(dqs, L.dq_stride, 3 * C, wqkv_t, C, C, nullptr, dx + (size_t)w0 * N * C, C,
                 N * C, nwin, N);
    store_rows(dqs, L.dq_stride, dqkv_out + (size_t)w0 * N * 3 * C, 3 * C, nwin * N);
    store_rows(xs, L.xs_stride, ao_out + (size_t)w0 * N * C, C, nwin * N);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nn; e += blockDim.x) dbias_part[(size_t)blockIdx.x * nn + e] = dacc[e];
}

// #3's weight gradients as split-K products over the B*N rows on the CUDA
// cores: block (tile, split) computes one 64x64 tile of
//   dWqkv = x^T dqkv  [C, 3C]   or   dWproj = ao^T dy  [C, C]
// over its split's fixed row range, plus (first row tile) the column sums
// dbqkv / dbproj, and writes them to its split's partial. Each thread holds
// a 4x4 tile of the output; rows are staged 16 at a time in shared memory.
// Partial layout per split: [dWqkv C*3C | dbqkv 3C | dWproj C*C | dbproj C].
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dqkv,
             const float* __restrict__ ao, const float* __restrict__ dy, int R, int C,
             int rows_per_split, float* __restrict__ part, int E) {
  __shared__ __align__(16) float As[kTileK][kTile];
  __shared__ __align__(16) float Bs[kTileK][kTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int tiles_c = (C + kTile - 1) / kTile;
  const int tiles_q = tiles_c * ((3 * C + kTile - 1) / kTile);
  int tile = blockIdx.x;
  const float* A;
  const float* Bm;
  int J;
  float* out = part + (size_t)blockIdx.y * E;
  if (tile < tiles_q) {
    A = x;
    Bm = dqkv;
    J = 3 * C;
  } else {
    tile -= tiles_q;
    A = ao;
    Bm = dy;
    J = C;
    out += 3 * C * C + 3 * C;
  }
  float* out_b = out + C * J;
  const int tiles_j = (J + kTile - 1) / kTile;
  const int c0 = (tile / tiles_j) * kTile;
  const int j0 = (tile % tiles_j) * kTile;
  const bool col_sums = c0 == 0;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  float bsum = 0.f;
  const int lr = tid / 16, lc = (tid % 16) * 4;
  for (int r = r_begin; r < r_end; r += kTileK) {
    const int rr = r + lr;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if (rr < r_end) {
      if (c0 + lc < C) av = *reinterpret_cast<const float4*>(A + (size_t)rr * C + c0 + lc);
      if (j0 + lc < J) bv = *reinterpret_cast<const float4*>(Bm + (size_t)rr * J + j0 + lc);
    }
    *reinterpret_cast<float4*>(&As[lr][lc]) = av;
    *reinterpret_cast<float4*>(&Bs[lr][lc]) = bv;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ar[4] = {a4.x, a4.y, a4.z, a4.w};
      const float br[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ar[a], br[b], acc[a][b]);
    }
    if (col_sums && tid < kTile) {
#pragma unroll
      for (int k = 0; k < kTileK; ++k) bsum += Bs[k][tid];
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int c = c0 + ty * 4 + a;
    if (c < C) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = j0 + tx * 4 + b;
        if (j < J) out[(size_t)c * J + j] = acc[a][b];
      }
    }
  }
  if (col_sums && tid < kTile && j0 + tid < J) out_b[j0 + tid] = bsum;
}

// out[e] = sum over s (in order) of part[s][e]: the deterministic second
// pass of the cross-block reductions.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int S, int E,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * E + e];
  out[e] = acc;
}

// ---------------------------------------------------------------------------
// per-head kernels (#4 forward, #5 backward): row-tiled projections on the
// tensor cores, attention per (window, head) pair between them

// Projections over all R = B N rows of a launch, one 128 x 128 output tile a
// block (focal::gemm_tile, 3xTF32): c = a b (+ bias) with a [M, K] row-major
// (lda), b [K, N] (ldb), c [M, N] (ldc). One launch may run two problems:
// blocks [0, p0.tiles) take p0, the rest p1.
struct ProjGemm {
  const float* a;
  const float* b;
  const float* bias;  // [N] or null
  float* c;
  int lda, ldb, ldc, M, N, K, tiles_n, tiles;
};

ProjGemm proj_gemm(const float* a, int lda, const float* b, int ldb, const float* bias, float* c,
                   int ldc, int M, int N, int K) {
  ProjGemm p{a, b, bias, c, lda, ldb, ldc, M, N, K, 0, 0};
  p.tiles_n = (N + focal::kGemmBN - 1) / focal::kGemmBN;
  p.tiles = ((M + focal::kGemmBM - 1) / focal::kGemmBM) * p.tiles_n;
  return p;
}

__global__ void __launch_bounds__(focal::kGemmThreads)
proj_gemm_kernel(ProjGemm p0, ProjGemm p1) {
  extern __shared__ float4 smem4[];
  int tile = blockIdx.x;
  const ProjGemm p = tile < p0.tiles ? p0 : p1;
  if (tile >= p0.tiles) tile -= p0.tiles;
  const int m0 = (tile / p.tiles_n) * focal::kGemmBM, n0 = (tile % p.tiles_n) * focal::kGemmBN;
  float acc[4][4][4], csum = 0.f;
  focal::gemm_tile<false, false>(p.a, p.lda, p.b, p.ldb, p.M, p.N, m0, n0, 0, p.K,
                                 reinterpret_cast<float*>(smem4), acc, csum);
  focal::gemm_for_each_output(acc, p.M, p.N, m0, n0, [&](int row, int col, float v0, float v1) {
    if (p.bias) {
      v0 += __ldg(p.bias + col);
      v1 += __ldg(p.bias + col + 1);
    }
    *reinterpret_cast<float2*>(p.c + (size_t)row * p.ldc + col) = make_float2(v0, v1);
  });
}

// Weight gradients as fixed split-K partials: block (tile, split) computes
// one 128 x 128 tile of a^T b over its split's rows, a [R, M] and b [R, N]
// read as they lie (a transposed in the tile loads), plus, in the first row
// tile, b's column sums over those rows (the bias gradients). It writes
// them to its split's partial at `out` ([M, N]) and `sums_out` ([N]); the
// partials are summed in split order by reduce_partials_kernel. Two problems
// a launch, as proj_gemm_kernel.
struct WgradGemm {
  const float* a;
  const float* b;
  int M, N, tiles_n, tiles;
  size_t out, sums_out;  // offsets in a partial, in floats
};

WgradGemm wgrad_gemm(const float* a, const float* b, int M, int N, size_t out, size_t sums_out) {
  WgradGemm p{a, b, M, N, 0, 0, out, sums_out};
  p.tiles_n = (N + focal::kGemmBN - 1) / focal::kGemmBN;
  p.tiles = ((M + focal::kGemmBM - 1) / focal::kGemmBM) * p.tiles_n;
  return p;
}

__global__ void __launch_bounds__(focal::kGemmThreads)
wgrad_gemm_kernel(WgradGemm p0, WgradGemm p1, int R, int rows_per_split, float* __restrict__ part,
                  size_t E) {
  extern __shared__ float4 smem4[];
  int tile = blockIdx.x;
  const WgradGemm p = tile < p0.tiles ? p0 : p1;
  if (tile >= p0.tiles) tile -= p0.tiles;
  const int m0 = (tile / p.tiles_n) * focal::kGemmBM, n0 = (tile % p.tiles_n) * focal::kGemmBN;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  float acc[4][4][4], csum = 0.f;
  focal::gemm_tile<true, true>(p.a, p.M, p.b, p.N, p.M, p.N, m0, n0, r_begin, r_end,
                               reinterpret_cast<float*>(smem4), acc, csum);
  float* out = part + (size_t)blockIdx.y * E;
  focal::gemm_for_each_output(acc, p.M, p.N, m0, n0, [&](int row, int col, float v0, float v1) {
    *reinterpret_cast<float2*>(out + p.out + (size_t)row * p.N + col) = make_float2(v0, v1);
  });
  if (m0 == 0 && threadIdx.x < focal::kGemmBN && n0 + threadIdx.x < p.N)
    out[p.sums_out + n0 + threadIdx.x] = csum;
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

// Attention of #4 per (window, head) pair (the row-parallel design of
// window_attention.cu, focal/window_rows.cuh): q, k, v from the qkv
// workspace, the softmax of q k^T + rel_bias + mask, dropout with #2's
// Philox counters (kDropout; the keep flags written out as uint8 [B, H, N,
// N]), and the attention output a v to ao [R, C] at the head's columns.
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
  focal::stage_rows(qkv, sq, p0, np, g, qs);
  focal::stage_rows(qkv + C, sq, p0, np, g, ks);
  focal::stage_rows(qkv + 2 * C, sq, p0, np, g, vs);
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
  float4* o = reinterpret_cast<float4*>(ao + ((size_t)t.w * N + t.i) * C + t.h * g.hd);
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

// Attention backward of #5 per (window, head) pair: from q, k, v (the qkv
// workspace), g = dy Wproj^T ([R, C]) and #4's keep mask, per query row i
// the softmax p, the weights as applied to v (a_v), the score gradients ds,
// dq_i = ds k and the attention output a_v v (into ao, for dWproj); per key
// row j dk_j = ds^T q and dv_j = a_v^T g; dq | dk | dv into the dqkv
// workspace at the head's columns. Blocks walk the chunks of pairs with a
// fixed stride and sum the chunks' ds per head in pair order into one
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
    focal::stage_rows(qkv, sq, p0, np, g, qs);
    focal::stage_rows(qkv + C, sq, p0, np, g, ks);
    focal::stage_rows(qkv + 2 * C, sq, p0, np, g, vs);
    focal::stage_rows(gao, sg, p0, np, g, gs);
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
    float4* dqo = reinterpret_cast<float4*>(dqkv + row * 3 * C + t.h * g.hd);
    float4* aoo = reinterpret_cast<float4*>(ao + row * C + t.h * g.hd);
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
        dqo[c] = a;
        aoo[c] = b;
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
      float4* dko = reinterpret_cast<float4*>(base + C);
      float4* dvo = reinterpret_cast<float4*>(base + 2 * C);
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

// The current device's SM count.
cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// Launch plan of #3: per-window blocks (a fixed, occupancy-sized grid
// walking the window chunks) and the weight-gradient splits.
struct BwdPlan {
  BwdLayout L;
  size_t smem, ws_floats;
  int grid, splits, rows_per_split, wtiles, E;
  cudaError_t err;
};

BwdPlan bwd_plan(int B, int N, int C, int H, bool dropout) {
  BwdPlan P{};
  int sms = 0, per_sm = 0;
  P.err = device_sms(&sms);
  if (P.err != cudaSuccess) return P;
  P.L = bwd_plan_layout(N, C, H);
  P.smem = P.L.total * sizeof(float);
  P.err = dropout ? set_smem(wblock_bwd_kernel<true>, P.smem, &per_sm)
                  : set_smem(wblock_bwd_kernel<false>, P.smem, &per_sm);
  if (P.err == cudaSuccess && per_sm < 1) P.err = cudaErrorInvalidConfiguration;
  if (P.err != cudaSuccess) return P;
  const int nchunks = (B + P.L.wpb - 1) / P.L.wpb;
  P.grid = std::min(nchunks, per_sm * sms);
  const int R = B * N;
  const int tiles_c = (C + kTile - 1) / kTile;
  P.wtiles = tiles_c * ((3 * C + kTile - 1) / kTile) + tiles_c * tiles_c;
  int splits = (4 * sms + P.wtiles - 1) / P.wtiles;
  const int max_splits = (R + 63) / 64;
  splits = std::max(1, std::min(splits, max_splits));
  int rps = (R + splits - 1) / splits;
  rps = (rps + kTileK - 1) / kTileK * kTileK;
  P.rows_per_split = rps;
  P.splits = (R + rps - 1) / rps;
  P.E = 4 * C * C + 4 * C;
  P.ws_floats = (size_t)R * 3 * C + (size_t)R * C + (size_t)P.grid * H * N * N +
                (size_t)P.splits * P.E;
  return P;
}

// Launch plan of #5 and its workspace, in floats: qkv and dqkv [R, 3C], g
// and the attention output [R, C], the attention blocks' d rel_bias
// partials, and the weight-gradient split partials.
struct PhBwdPlan {
  focal::Geo geo;
  size_t attn_smem;
  int attn_grid, wtiles, splits, rows_per_split;
  size_t E, qkv, dqkv, g, ao, dbias, wpart, total;
  cudaError_t err;
};

size_t attn_fwd_smem(const focal::Geo& g) {
  return (size_t)3 * g.pairs * g.N * g.stride * sizeof(float);
}

size_t attn_bwd_smem(const focal::Geo& g) {
  return ((size_t)4 * g.pairs * g.N * g.stride + (size_t)2 * g.pairs * g.N * g.N +
          (size_t)g.H * g.N * g.N) * sizeof(float);
}

PhBwdPlan ph_bwd_plan(int B, int N, int C, int H, bool dropout) {
  PhBwdPlan P{};
  int sms = 0, per_sm = 0;
  P.err = device_sms(&sms);
  if (P.err != cudaSuccess) return P;
  P.geo = focal::make_geo(B, H, N, C / H);
  P.attn_smem = attn_bwd_smem(P.geo);
  P.err = dropout ? set_smem(attn_bwd_kernel<true>, P.attn_smem, &per_sm)
                  : set_smem(attn_bwd_kernel<false>, P.attn_smem, &per_sm);
  if (P.err == cudaSuccess && per_sm < 1) P.err = cudaErrorInvalidConfiguration;
  if (P.err != cudaSuccess) return P;
  const long long nchunks = (P.geo.total + P.geo.pairs - 1) / P.geo.pairs;
  P.attn_grid = (int)std::min<long long>(nchunks, (long long)per_sm * sms);
  // split the rows so that the weight-gradient tiles fill the card about
  // four times over (two blocks an SM), each split at least 256 rows
  const int R = B * N;
  const int tiles_c = (C + focal::kGemmBM - 1) / focal::kGemmBM;
  P.wtiles = tiles_c * ((3 * C + focal::kGemmBN - 1) / focal::kGemmBN) +
             tiles_c * ((C + focal::kGemmBN - 1) / focal::kGemmBN);
  int splits = (4 * sms + P.wtiles - 1) / P.wtiles;
  splits = std::max(1, std::min(splits, (R + 255) / 256));
  int rps = (R + splits - 1) / splits;
  rps = (rps + focal::kGemmBK - 1) / focal::kGemmBK * focal::kGemmBK;
  P.rows_per_split = rps;
  P.splits = (R + rps - 1) / rps;
  P.E = (size_t)4 * C * C + 4 * C;
  size_t o = 0;
  P.qkv = o, o += (size_t)R * 3 * C;
  P.dqkv = o, o += (size_t)R * 3 * C;
  P.g = o, o += (size_t)R * C;
  P.ao = o, o += (size_t)R * C;
  P.dbias = o, o += ((size_t)P.attn_grid * H * N * N + 3) / 4 * 4;  // keeps wpart 16-byte aligned
  P.wpart = o, o += (size_t)P.splits * P.E;
  P.total = o;
  return P;
}

int check_geometry(int N, int C, int H) {
  if (N < 1 || N > kMaxN || C < 4 || C % 4 != 0 || H < 1 || C % H != 0) return (int)cudaErrorInvalidValue;
  return 0;
}

// The per-head kernels' attention reads a head's columns as float4 (hd % 4
// == 0) and stages whole heads in shared memory (hd <= 256).
int check_ph_geometry(int N, int C, int H) {
  if (check_geometry(N, C, H) || (C / H) % 4 != 0 || C / H > focal::kAttnMaxHd)
    return (int)cudaErrorInvalidValue;
  return 0;
}

int bwd_workspace(int B, int N, int C, int H, int dropout, long long* floats) {
  if (check_geometry(N, C, H)) return (int)cudaErrorInvalidValue;
  if (B == 0) {
    *floats = 0;
    return 0;
  }
  const BwdPlan P = bwd_plan(B, N, C, H, dropout != 0);
  if (P.err != cudaSuccess) return (int)P.err;
  *floats = (long long)P.ws_floats;
  return 0;
}

// The four launches of #3 on `stream`: the per-window kernel, the
// weight-gradient partials, and the two ordered reductions.
int run_backward(const void* x, const void* wqkv, const void* bqkv, const void* wqkv_t,
                 const void* wproj_t, const void* rel_bias, const void* mask, const void* dy,
                 const void* keep, float inv_keep, void* dx, void* dweights, void* drel_bias,
                 void* ws, int B, int N, int C, int H, int nW, void* stream) {
  if (check_geometry(N, C, H) || (mask != nullptr && nW < 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const bool dropout = keep != nullptr;
  const BwdPlan P = bwd_plan(B, N, C, H, dropout);
  if (P.err != cudaSuccess) return (int)P.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t R = (size_t)B * N;
  float* w = static_cast<float*>(ws);
  float* dqkv = w;
  float* ao = dqkv + R * 3 * C;
  float* dbias_part = ao + R * C;
  float* wpart = dbias_part + (size_t)P.grid * H * N * N;
  const int nw = mask != nullptr ? nW : 1;
#define FOCAL_BWD_ARGS                                                                        \
  static_cast<const float*>(x), static_cast<const float*>(wqkv),                              \
      static_cast<const float*>(bqkv), static_cast<const float*>(wqkv_t),                     \
      static_cast<const float*>(wproj_t), static_cast<const float*>(rel_bias),                \
      static_cast<const float*>(mask), static_cast<const float*>(dy),                         \
      static_cast<const unsigned char*>(keep), inv_keep, static_cast<float*>(dx), dqkv, ao, \
      dbias_part, B, N, C, H, nw, P.L
  if (dropout)
    wblock_bwd_kernel<true><<<P.grid, kThreads, P.smem, s>>>(FOCAL_BWD_ARGS);
  else
    wblock_bwd_kernel<false><<<P.grid, kThreads, P.smem, s>>>(FOCAL_BWD_ARGS);
#undef FOCAL_BWD_ARGS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wgrad_kernel<<<dim3(P.wtiles, P.splits), kThreads, 0, s>>>(
      static_cast<const float*>(x), dqkv, ao, static_cast<const float*>(dy), (int)R, C,
      P.rows_per_split, wpart, P.E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(P.E + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      wpart, P.splits, P.E, static_cast<float*>(dweights));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nn = H * N * N;
  reduce_partials_kernel<<<(nn + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      dbias_part, P.grid, nn, static_cast<float*>(drel_bias));
  return (int)cudaGetLastError();
}

// One projection launch (one or two problems) on `stream`.
cudaError_t launch_proj(const ProjGemm& p0, const ProjGemm& p1, cudaStream_t s) {
  cudaError_t err = set_smem(proj_gemm_kernel, focal::kGemmSmemBytes, nullptr);
  if (err != cudaSuccess) return err;
  proj_gemm_kernel<<<p0.tiles + p1.tiles, focal::kGemmThreads, focal::kGemmSmemBytes, s>>>(p0, p1);
  return cudaGetLastError();
}

}  // namespace

// Forward (#1). Launch on `stream`; returns cudaGetLastError() (0 on
// success). Pointers are device pointers to contiguous f32 tensors; `mask`
// may be null (nW ignored).
extern "C" int focal_wblock_fwd(const void* x, const void* wqkv, const void* bqkv,
                                const void* wproj, const void* bproj,
                                const void* rel_bias, const void* mask, void* y,
                                int B, int N, int C, int H, int nW, void* stream) {
  if (check_geometry(N, C, H) || (mask != nullptr && nW < 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int wpb = windows_per_block(N, C);
  const size_t smem = smem_bytes(wpb, N, C);
  cudaError_t err = cudaFuncSetAttribute(
      wblock_fwd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + wpb - 1) / wpb;
  wblock_fwd_kernel<false><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(wproj),
      static_cast<const float*>(bproj), static_cast<const float*>(rel_bias),
      static_cast<const float*>(mask), static_cast<float*>(y), nullptr, 0ull, 0u, 1.f, B, N, C,
      H, mask != nullptr ? nW : 1, wpb);
  return (int)cudaGetLastError();
}

// Forward with attention dropout (#2): as focal_wblock_fwd, and each
// (window, head, query, key) weight is kept iff its Philox word (keyed by
// `seed`) is >= `threshold`, then scaled by `inv_keep`. The keep mask is
// written to `keep` as uint8 [B, H, N, N].
extern "C" int focal_wblock_fwd_dropout(const void* x, const void* wqkv, const void* bqkv,
                                        const void* wproj, const void* bproj,
                                        const void* rel_bias, const void* mask, void* y,
                                        void* keep, int B, int N, int C, int H, int nW,
                                        unsigned long long seed, unsigned threshold,
                                        float inv_keep, void* stream) {
  if (check_geometry(N, C, H) || (mask != nullptr && nW < 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int wpb = windows_per_block(N, C);
  const size_t smem = smem_bytes(wpb, N, C);
  cudaError_t err = cudaFuncSetAttribute(
      wblock_fwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + wpb - 1) / wpb;
  wblock_fwd_kernel<true><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(wproj),
      static_cast<const float*>(bproj), static_cast<const float*>(rel_bias),
      static_cast<const float*>(mask), static_cast<float*>(y),
      static_cast<unsigned char*>(keep), seed, threshold, inv_keep, B, N, C, H,
      mask != nullptr ? nW : 1, wpb);
  return (int)cudaGetLastError();
}

// Workspace of the per-head forward (#4), in floats: the qkv projection
// [R, 3C] and the attention output [R, C], R = B N.
extern "C" int focal_wblock_ph_fwd_workspace(int B, int N, int C, int H, long long* floats) {
  if (check_geometry(N, C, H) || B < 0) return (int)cudaErrorInvalidValue;
  *floats = (long long)B * N * 4 * C;
  return 0;
}

// Per-head forward (#4), with attention dropout when `keep` is not null:
// the function of focal_wblock_fwd (keep null) or focal_wblock_fwd_dropout,
// the same mask bits for the same seed. `ws` holds
// focal_wblock_ph_fwd_workspace floats. Three launches on `stream`: qkv =
// x Wqkv + bqkv, the attention per (window, head), y = ao Wproj + bproj.
// Needs (C / H) % 4 == 0 and C / H <= 256.
extern "C" int focal_wblock_ph_fwd(const void* x, const void* wqkv, const void* bqkv,
                                   const void* wproj, const void* bproj, const void* rel_bias,
                                   const void* mask, void* y, void* keep, void* ws, int B, int N,
                                   int C, int H, int nW, unsigned long long seed,
                                   unsigned threshold, float inv_keep, void* stream) {
  if (check_ph_geometry(N, C, H) || (mask != nullptr && nW < 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * N;
  float* qkv = static_cast<float*>(ws);
  float* ao = qkv + (size_t)R * 3 * C;
  cudaError_t err = launch_proj(
      proj_gemm(static_cast<const float*>(x), C, static_cast<const float*>(wqkv), 3 * C,
                static_cast<const float*>(bqkv), qkv, 3 * C, R, 3 * C, C),
      ProjGemm{}, s);
  if (err != cudaSuccess) return (int)err;
  const focal::Geo g = focal::make_geo(B, H, N, C / H);
  const size_t smem = attn_fwd_smem(g);
  const bool dropout = keep != nullptr;
  err = dropout ? set_smem(attn_fwd_kernel<true>, smem, nullptr)
                : set_smem(attn_fwd_kernel<false>, smem, nullptr);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)((g.total + g.pairs - 1) / g.pairs);
#define FOCAL_PH_ATTN_ARGS                                                                    \
  qkv, static_cast<const float*>(rel_bias), static_cast<const float*>(mask), ao,              \
      static_cast<unsigned char*>(keep), seed, threshold, inv_keep, g, C,                     \
      mask != nullptr ? nW : 1
  if (dropout)
    attn_fwd_kernel<true><<<grid, kThreads, smem, s>>>(FOCAL_PH_ATTN_ARGS);
  else
    attn_fwd_kernel<false><<<grid, kThreads, smem, s>>>(FOCAL_PH_ATTN_ARGS);
#undef FOCAL_PH_ATTN_ARGS
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_proj(proj_gemm(ao, C, static_cast<const float*>(wproj), C,
                                    static_cast<const float*>(bproj), static_cast<float*>(y), C,
                                    R, C, C),
                          ProjGemm{}, s);
}

// Workspace the backward needs, in floats, for this geometry on the current
// device (dqkv and the attention output, the d rel_bias partials and the
// weight-gradient partials).
extern "C" int focal_wblock_bwd_workspace(int B, int N, int C, int H, int dropout,
                                          long long* floats) {
  return bwd_workspace(B, N, C, H, dropout, floats);
}

// Backward (#3). Inputs: x, wqkv [C, 3C] and its transpose [3C, C], bqkv,
// the transpose of wproj [C, C], rel_bias, mask (may be null), dy, keep
// (uint8 [B, H, N, N] from #2, or null for no dropout) with inv_keep.
// Outputs: dx [B, N, C]; dweights, flat [dWqkv C*3C | dbqkv 3C | dWproj C*C |
// dbproj C]; drel_bias [H, N, N]. `ws` holds focal_wblock_bwd_workspace
// floats. Four launches on `stream`: per-window backward, weight-gradient
// partials, and the two ordered reductions.
extern "C" int focal_wblock_bwd(const void* x, const void* wqkv, const void* bqkv,
                                const void* wqkv_t, const void* wproj_t, const void* rel_bias,
                                const void* mask, const void* dy, const void* keep,
                                float inv_keep, void* dx, void* dweights, void* drel_bias,
                                void* ws, int B, int N, int C, int H, int nW, void* stream) {
  return run_backward(x, wqkv, bqkv, wqkv_t, wproj_t, rel_bias, mask, dy, keep, inv_keep, dx,
                      dweights, drel_bias, ws, B, N, C, H, nW, stream);
}

// Workspace of the per-head backward (#5), in floats, for this geometry on
// the current device (ph_bwd_plan).
extern "C" int focal_wblock_ph_bwd_workspace(int B, int N, int C, int H, int dropout,
                                             long long* floats) {
  if (check_ph_geometry(N, C, H)) return (int)cudaErrorInvalidValue;
  if (B == 0) {
    *floats = 0;
    return 0;
  }
  const PhBwdPlan P = ph_bwd_plan(B, N, C, H, dropout != 0);
  if (P.err != cudaSuccess) return (int)P.err;
  *floats = (long long)P.total;
  return 0;
}

// Per-head backward (#5): focal_wblock_bwd's arguments and outputs, keep
// from #4; `ws` holds focal_wblock_ph_bwd_workspace floats. Six launches on
// `stream`: qkv = x Wqkv + bqkv and g = dy Wproj^T (one launch), the
// attention backward (dqkv, the attention output, d rel_bias partials), dx =
// dqkv Wqkv^T, the weight-gradient split partials (x^T dqkv, ao^T dy and
// the column sums), and the two ordered reductions.
extern "C" int focal_wblock_ph_bwd(const void* x, const void* wqkv, const void* bqkv,
                                   const void* wqkv_t, const void* wproj_t, const void* rel_bias,
                                   const void* mask, const void* dy, const void* keep,
                                   float inv_keep, void* dx, void* dweights, void* drel_bias,
                                   void* ws, int B, int N, int C, int H, int nW, void* stream) {
  if (check_ph_geometry(N, C, H) || (mask != nullptr && nW < 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const bool dropout = keep != nullptr;
  const PhBwdPlan P = ph_bwd_plan(B, N, C, H, dropout);
  if (P.err != cudaSuccess) return (int)P.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * N;
  float* w = static_cast<float*>(ws);
  float *qkv = w + P.qkv, *dqkv = w + P.dqkv, *g = w + P.g, *ao = w + P.ao;
  const float* xf = static_cast<const float*>(x);
  const float* dyf = static_cast<const float*>(dy);
  // 1. qkv = x Wqkv + bqkv (recomputed) and g = dy Wproj^T
  cudaError_t err = launch_proj(
      proj_gemm(xf, C, static_cast<const float*>(wqkv), 3 * C, static_cast<const float*>(bqkv),
                qkv, 3 * C, R, 3 * C, C),
      proj_gemm(dyf, C, static_cast<const float*>(wproj_t), C, nullptr, g, C, R, C, C), s);
  if (err != cudaSuccess) return (int)err;
  // 2. the attention backward per (window, head)
#define FOCAL_PH_ATTN_ARGS                                                                    \
  qkv, g, static_cast<const float*>(rel_bias), static_cast<const float*>(mask),               \
      static_cast<const unsigned char*>(keep), inv_keep, dqkv, ao, w + P.dbias, P.geo, C,    \
      mask != nullptr ? nW : 1
  if (dropout)
    attn_bwd_kernel<true><<<P.attn_grid, kThreads, P.attn_smem, s>>>(FOCAL_PH_ATTN_ARGS);
  else
    attn_bwd_kernel<false><<<P.attn_grid, kThreads, P.attn_smem, s>>>(FOCAL_PH_ATTN_ARGS);
#undef FOCAL_PH_ATTN_ARGS
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 3. dx = dqkv Wqkv^T
  err = launch_proj(proj_gemm(dqkv, 3 * C, static_cast<const float*>(wqkv_t), C, nullptr,
                              static_cast<float*>(dx), C, R, C, 3 * C),
                    ProjGemm{}, s);
  if (err != cudaSuccess) return (int)err;
  // 4. dWqkv = x^T dqkv with dbqkv, dWproj = ao^T dy with dbproj, per split
  const size_t q = (size_t)3 * C * C;
  err = set_smem(wgrad_gemm_kernel, focal::kGemmSmemBytes, nullptr);
  if (err != cudaSuccess) return (int)err;
  wgrad_gemm_kernel<<<dim3(P.wtiles, P.splits), focal::kGemmThreads, focal::kGemmSmemBytes, s>>>(
      wgrad_gemm(xf, dqkv, C, 3 * C, 0, q),
      wgrad_gemm(ao, dyf, C, C, q + 3 * C, q + 3 * C + (size_t)C * C),
      R, P.rows_per_split, w + P.wpart, P.E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 5. the partials summed in split order, and d rel_bias in block order
  reduce_partials_kernel<<<(int)((P.E + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      w + P.wpart, P.splits, (int)P.E, static_cast<float*>(dweights));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nn = H * N * N;
  reduce_partials_kernel<<<(nn + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      w + P.dbias, P.attn_grid, nn, static_cast<float*>(drel_bias));
  return (int)cudaGetLastError();
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
  cudaError_t err = set_smem(wgrad_gemm_kernel, focal::kGemmSmemBytes, nullptr);
  if (err != cudaSuccess) return (int)err;
  const WgradGemm p = wgrad_gemm(af, bf, M, N, 0, (size_t)M * N);
  wgrad_gemm_kernel<<<dim3(p.tiles, 1), focal::kGemmThreads, focal::kGemmSmemBytes, s>>>(
      p, WgradGemm{}, K, K, cf, 0);
  return (int)cudaGetLastError();
}

extern "C" const char* focal_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
