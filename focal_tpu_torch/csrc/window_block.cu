// Whole-block Swin window attention for Hopper (sm_90a): forward (#1),
// forward with attention dropout (#2) and backward (#3), and the same
// function walked one head at a time for wide blocks: forward (#4) and
// backward (#5).
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
//   a_h = keep ? a_h / (1 - rate) : 0        (#2 only)
//   y   = concat_h(a_h v_h) Wproj + bproj
// All products run in these kernels' bodies; qkv and the attention output
// never leave shared memory in the forward.
//
// What bounds them on this card: operations. At the MOD geometries (N = 9,
// C = 64..256) a window does 2*9*C*4C multiply-adds of projection in the
// forward (2*9*C*11C in the backward) for 9*C*2 floats of activations in and
// out: 69-234 FLOP per byte, above the f32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte), so f32 FMA throughput is the limit, not HBM.
//
// What the design does about it:
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
//   * Wide blocks (#4, #5): #3 keeps qkv, dqkv and d(attention output) of
//     all heads per window, N (8C + 10) floats, which passes the 227 KB a
//     block may hold at C = 1024. #4 and #5 keep the whole-row tensors (x,
//     y; x, dy, dx) per window and only ONE head's q|k|v (and dq|dk|dv, g =
//     dy Wproj_h^T, its attention output) at a time, N (2C + 4hd) floats
//     forward and N (3C + 8hd) backward: y and dx sum the heads in head
//     order in shared memory, no atomics. The head's attention is spread
//     over (window, query, key) and (window, row, dim) items instead of one
//     thread per row, so hd = 256 does not serialise it. #5 writes dq|dk|dv
//     and the attention output into the same workspace layout as #3, and
//     the weight gradients come from the same split-K kernel. #4 draws its
//     mask with #2's Philox counters, so #2 and #4 agree bit for bit.
//   * Not yet: wgmma / tensor cores, TMA. Those are the later performance work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "philox.cuh"

namespace {

constexpr int kMaxN = 16;            // window tokens a thread keeps in registers
// Threads of every block launched here. The block-wide loops step by this
// constant, not by blockDim.x: the runtime stride cost #1 5 % on the H100.
constexpr int kThreads = 256;
constexpr int kActBudget = 73728;    // forward: bytes of x + qkv per block (two blocks per SM)
constexpr int kBwdBudget = 112640;   // backward: bytes of activations per block (two per SM)
constexpr int kTile = 64;            // weight-gradient output tile (rows and columns)
constexpr int kTileK = 16;           // weight-gradient rows per shared-memory stage

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

// Copy `rows` rows of `ncols` floats (% 4 == 0) from rows `s_stride` floats
// apart to rows `d_stride` floats apart, float4 at a time (16-byte aligned
// rows on both sides).
__device__ __forceinline__ void copy_rows(const float* s, int s_stride, float* d, int d_stride,
                                          int ncols, int rows) {
  const int c4 = ncols / 4;
  for (int i = threadIdx.x; i < rows * c4; i += kThreads) {
    const int row = i / c4, col = i - row * c4;
    *reinterpret_cast<float4*>(d + (size_t)row * d_stride + col * 4) =
        *reinterpret_cast<const float4*>(s + (size_t)row * s_stride + col * 4);
  }
}

// dst[w][r][j] = sum_k src[w][r][k] W[k][j] (+ bias[j]) for nwin windows of N
// rows, j < ncols, k < K (K % 4 == 0). src is shared memory with rows of
// src_stride floats (% 4 == 0); W is global [K][ldw]; dst rows are
// dst_stride floats apart and windows dst_win_stride floats apart (shared or
// global memory). One (window, column) per item, all N rows at once. With
// kAccumulate the sum is added to dst instead (each item keeps its thread
// from call to call, so repeated calls need no barrier between them).
template <bool kAccumulate = false>
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
      if (r < N) {
        if (kAccumulate)
          dw[r * dst_stride + j] += acc[r] + bj;
        else
          dw[r * dst_stride + j] = acc[r] + bj;
      }
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

// p = softmax(p) over the first N entries, in registers.
__device__ __forceinline__ void softmax_regs(float (&p)[kMaxN], int N) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxN; ++j)
    if (j < N) mx = fmaxf(mx, p[j]);
  softmax_from_max(p, mx, N);
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

// a . b over n floats (n % 4 == 0, both 16-byte aligned).
__device__ __forceinline__ float dot4(const float* a, const float* b, int n) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float d = 0.f;
  for (int t = 0; t < n / 4; ++t) {
    const float4 u = a4[t], v = b4[t];
    d = fmaf(u.x, v.x, d);
    d = fmaf(u.y, v.y, d);
    d = fmaf(u.z, v.z, d);
    d = fmaf(u.w, v.w, d);
  }
  return d;
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
// per-head forward (#4; with kDropout, #4 with attention dropout)

// Shared-memory layout of the per-head kernels, in floats. Per window: rows
// of C + 4 for x and y (forward) or x, dy and dx (backward); rows of 3hd + 4
// for one head's q|k|v (backward also dq|dk|dv); rows of hd + 4 for its
// attention output (backward also g = dy Wproj_h^T); N x N for its
// attention weights (backward also their gradients). The backward adds the
// block's d rel_bias [H, N, N] once.
struct PhLayout {
  int wpb, cs, qs, hs;  // windows per block; row strides
  size_t x, y, dx, qkv, dqkv, ao, g, p, dp, dacc, total;
};

PhLayout ph_layout(int wpb, int N, int C, int H, bool backward) {
  const int hd = C / H;
  PhLayout L;
  L.wpb = wpb;
  L.cs = C + 4;
  L.qs = 3 * hd + 4;
  L.hs = hd + 4;
  const size_t rows = (size_t)wpb * N, nn = (size_t)wpb * N * N;
  size_t o = 0;
  L.x = o, o += rows * L.cs;
  L.y = o, o += rows * L.cs;  // y, or dy in the backward
  L.dx = o, o += backward ? rows * L.cs : 0;
  L.qkv = o, o += rows * L.qs;
  L.dqkv = o, o += backward ? rows * L.qs : 0;
  L.ao = o, o += rows * L.hs;
  L.g = o, o += backward ? rows * L.hs : 0;
  L.p = o, o += nn;  // float4 rows end here: the N x N blocks need no alignment
  L.dp = o, o += backward ? nn : 0;
  L.dacc = o, o += backward ? (size_t)H * N * N : 0;
  L.total = o;
  return L;
}

// Windows per block of a per-head kernel: as many as `budget` bytes hold,
// at least one; 0 when one window does not fit the card's opt-in limit.
int ph_windows(int N, int C, int H, bool backward, size_t budget, size_t optin) {
  const PhLayout one = ph_layout(1, N, C, H, backward);
  if (one.total * sizeof(float) > optin) return 0;
  const size_t fixed = (one.total - one.dacc) * sizeof(float);  // d rel_bias, once a block
  const size_t per_window = one.dacc * sizeof(float);
  const size_t room = budget > fixed ? budget - fixed : 0;
  return std::max(1, (int)(room / per_window));
}

// Per window, for each head h in order: q|k|v of h, its scores, softmax (and
// dropout), attention output, and y += ao_h Wproj[h hd:(h+1) hd, :] (y starts
// at bproj with head 0).
template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
wblock_ph_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                     const float* __restrict__ bqkv, const float* __restrict__ wproj,
                     const float* __restrict__ bproj, const float* __restrict__ rel_bias,
                     const float* __restrict__ mask, float* __restrict__ y,
                     unsigned char* __restrict__ keep, unsigned long long seed,
                     unsigned threshold, float inv_keep, int B, int N, int C, int H, int nW,
                     PhLayout L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem + L.x;
  float* ys = smem + L.y;
  float* qs = smem + L.qkv;
  float* os = smem + L.ao;
  float* ps = smem + L.p;
  const int hd = C / H;
  const int w0 = blockIdx.x * L.wpb;
  const int nwin = min(L.wpb, B - w0);

  load_rows(x + (size_t)w0 * N * C, C, xs, L.cs, nwin * N);
  __syncthreads();
  for (int h = 0; h < H; ++h) {
    // 1. q | k | v of head h: three hd-column blocks of the fused [C, 3C]
    for (int part = 0; part < 3; ++part)
      project_rows(xs, L.cs, C, wqkv + part * C + h * hd, 3 * C, hd, bqkv + part * C + h * hd,
                   qs + part * hd, L.qs, N * L.qs, nwin, N);
    __syncthreads();

    // 2. scores per (window, query i, key j)
    for (int item = threadIdx.x; item < nwin * N * N; item += kThreads) {
      const int j = item % N, r = item / N;
      const int w = r / N, i = r - w * N;
      float s = dot4(qs + r * L.qs, qs + (w * N + j) * L.qs + hd, hd);
      s += __ldg(rel_bias + (h * N + i) * N + j);
      if (mask) s += __ldg(mask + ((size_t)((w0 + w) % nW) * N + i) * N + j);
      ps[item] = s;
    }
    __syncthreads();

    // 3. softmax (and dropout) per (window, query row), in place
    for (int item = threadIdx.x; item < nwin * N; item += kThreads) {
      const int w = item / N, i = item - w * N;
      float* prow = ps + item * N;
      float p[kMaxN];
#pragma unroll
      for (int j = 0; j < kMaxN; ++j)
        if (j < N) p[j] = prow[j];
      softmax_regs(p, N);
      if (kDropout)
        drop_row(p, N, (unsigned)(w0 + w), h, i, seed, threshold, inv_keep,
                 keep + (((size_t)(w0 + w) * H + h) * N + i) * N);
#pragma unroll
      for (int j = 0; j < kMaxN; ++j)
        if (j < N) prow[j] = p[j];
    }
    __syncthreads();

    // 4. attention output per (window, row, dim)
    for (int item = threadIdx.x; item < nwin * N * hd; item += kThreads) {
      const int t = item % hd, r = item / hd;
      const int w = r / N;
      const float* prow = ps + r * N;
      const float* vcol = qs + w * N * L.qs + 2 * hd + t;
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxN; ++j)
        if (j < N) a = fmaf(prow[j], vcol[j * L.qs], a);
      os[r * L.hs + t] = a;
    }
    __syncthreads();

    // 5. y (+)= ao_h Wproj[h hd:(h+1) hd, :]; the next head's steps 1-3
    //    touch neither os nor ys, so no barrier until step 4 reuses os
    if (h == 0)
      project_rows(os, L.hs, hd, wproj, C, C, bproj, ys, L.cs, N * L.cs, nwin, N);
    else
      project_rows<true>(os, L.hs, hd, wproj + (size_t)h * hd * C, C, C, nullptr, ys, L.cs,
                         N * L.cs, nwin, N);
  }
  __syncthreads();
  store_rows(ys, L.cs, y + (size_t)w0 * N * C, C, nwin * N);
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

// ---------------------------------------------------------------------------
// per-head backward (#5)

// Per window, for each head h in order: recompute q|k|v of h and its
// softmax, g = dy Wproj_h^T, then the weights' and scores' gradients, dq,
// dk, dv and the attention output, and dx (+)= dq|dk|dv Wqkv_h^T. dq|dk|dv
// and the attention output go to the workspace in #3's layout ([R, 3C] and
// [R, C]), where the weight-gradient kernel reads them. Blocks walk window
// chunks with a fixed stride and sum their score gradients in window and
// head order into one d rel_bias partial, as #3 does.
template <bool kDropout>
__global__ void __launch_bounds__(kThreads)
wblock_ph_bwd_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                     const float* __restrict__ bqkv, const float* __restrict__ wqkv_t,
                     const float* __restrict__ wproj_t, const float* __restrict__ rel_bias,
                     const float* __restrict__ mask, const float* __restrict__ dy,
                     const unsigned char* __restrict__ keep, float inv_keep,
                     float* __restrict__ dx, float* __restrict__ dqkv_out,
                     float* __restrict__ ao_out, float* __restrict__ dbias_part, int B, int N,
                     int C, int H, int nW, PhLayout L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem + L.x;
  float* dys = smem + L.y;
  float* dxs = smem + L.dx;
  float* qs = smem + L.qkv;
  float* dqs = smem + L.dqkv;
  float* os = smem + L.ao;
  float* gs = smem + L.g;
  float* ps = smem + L.p;
  float* dps = smem + L.dp;
  float* dacc = smem + L.dacc;
  const int hd = C / H;
  const int nn = N * N;
  const int nchunks = (B + L.wpb - 1) / L.wpb;

  for (int e = threadIdx.x; e < H * nn; e += kThreads) dacc[e] = 0.f;

  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    const int w0 = chunk * L.wpb;
    const int nwin = min(L.wpb, B - w0);
    __syncthreads();  // the previous chunk's readers are done with shared memory
    load_rows(x + (size_t)w0 * N * C, C, xs, L.cs, nwin * N);
    load_rows(dy + (size_t)w0 * N * C, C, dys, L.cs, nwin * N);
    __syncthreads();

    for (int h = 0; h < H; ++h) {
      // 1. q | k | v of head h (recomputed) and g = dy Wproj_h^T, the
      //    gradient of its attention output
      for (int part = 0; part < 3; ++part)
        project_rows(xs, L.cs, C, wqkv + part * C + h * hd, 3 * C, hd, bqkv + part * C + h * hd,
                     qs + part * hd, L.qs, N * L.qs, nwin, N);
      project_rows(dys, L.cs, C, wproj_t + h * hd, C, hd, nullptr, gs, L.hs, N * L.hs, nwin, N);
      __syncthreads();

      // 2. per (window, query i, key j): the score and d(weight) = g_i . v_j
      for (int item = threadIdx.x; item < nwin * nn; item += kThreads) {
        const int j = item % N, r = item / N;
        const int w = r / N, i = r - w * N;
        const float* kv = qs + (w * N + j) * L.qs;
        float s = dot4(qs + r * L.qs, kv + hd, hd);
        s += __ldg(rel_bias + (h * N + i) * N + j);
        if (mask) s += __ldg(mask + ((size_t)((w0 + w) % nW) * N + i) * N + j);
        ps[item] = s;
        dps[item] = dot4(gs + r * L.hs, kv + 2 * hd, hd);
      }
      __syncthreads();

      // 3. per (window, query row): softmax p; the weights as applied to v
      //    (a, into ps) and the score gradients ds (into dps)
      for (int item = threadIdx.x; item < nwin * N; item += kThreads) {
        const int w = item / N, i = item - w * N;
        float* prow = ps + item * N;
        float* drow = dps + item * N;
        const unsigned char* kr =
            kDropout ? keep + (((size_t)(w0 + w) * H + h) * N + i) * N : nullptr;
        float p[kMaxN];
#pragma unroll
        for (int j = 0; j < kMaxN; ++j)
          if (j < N) p[j] = prow[j];
        softmax_regs(p, N);
        float da[kMaxN];
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxN; ++j) {
          if (j < N) {
            const bool kp = kDropout ? kr[j] != 0 : true;
            prow[j] = kDropout ? (kp ? p[j] * inv_keep : 0.f) : p[j];
            da[j] = kDropout ? (kp ? drow[j] * inv_keep : 0.f) : drow[j];
            dot = fmaf(da[j], p[j], dot);
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxN; ++j)
          if (j < N) drow[j] = p[j] * (da[j] - dot);
      }
      __syncthreads();

      // 4. per (window, row, dim): attention output, dq, dk, dv; and the
      //    block's d rel_bias += ds (windows in order)
      for (int item = threadIdx.x; item < nwin * N * hd; item += kThreads) {
        const int t = item % hd, r = item / hd;
        const int w = r / N, i = r - w * N;
        const float* arow = ps + r * N;              // a[i][.]
        const float* drow = dps + r * N;             // ds[i][.]
        const float* acol = ps + w * nn + i;         // a[.][i]
        const float* dcol = dps + w * nn + i;        // ds[.][i]
        const float* qkv_w = qs + w * N * L.qs + t;  // q|k|v rows of the window
        const float* g_w = gs + w * N * L.hs + t;
        float ao = 0.f, dq = 0.f, dk = 0.f, dv = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxN; ++j) {
          if (j < N) {
            const float* row = qkv_w + j * L.qs;
            ao = fmaf(arow[j], row[2 * hd], ao);
            dq = fmaf(drow[j], row[hd], dq);
            dk = fmaf(dcol[j * N], row[0], dk);
            dv = fmaf(acol[j * N], g_w[j * L.hs], dv);
          }
        }
        os[r * L.hs + t] = ao;
        float* d = dqs + r * L.qs + t;
        d[0] = dq;
        d[hd] = dk;
        d[2 * hd] = dv;
      }
      for (int e = threadIdx.x; e < nn; e += kThreads) {
        float acc = dacc[h * nn + e];
        for (int w = 0; w < nwin; ++w) acc += dps[w * nn + e];
        dacc[h * nn + e] = acc;
      }
      __syncthreads();

      // 5. dx (+)= dq Wq_h^T + dk Wk_h^T + dv Wv_h^T (rows part C + h hd of
      //    the [3C, C] transpose); dq|dk|dv and the attention output to the
      //    workspace. The next head's steps 1-3 touch none of dqs, os, dxs.
      for (int part = 0; part < 3; ++part) {
        const float* wt = wqkv_t + (size_t)(part * C + h * hd) * C;
        if (h == 0 && part == 0)
          project_rows(dqs, L.qs, hd, wt, C, C, nullptr, dxs, L.cs, N * L.cs, nwin, N);
        else
          project_rows<true>(dqs + part * hd, L.qs, hd, wt, C, C, nullptr, dxs, L.cs, N * L.cs,
                             nwin, N);
        copy_rows(dqs + part * hd, L.qs, dqkv_out + (size_t)w0 * N * 3 * C + part * C + h * hd,
                  3 * C, hd, nwin * N);
      }
      copy_rows(os, L.hs, ao_out + (size_t)w0 * N * C + h * hd, C, hd, nwin * N);
    }
    __syncthreads();
    store_rows(dxs, L.cs, dx + (size_t)w0 * N * C, C, nwin * N);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < H * nn; e += kThreads)
    dbias_part[(size_t)blockIdx.x * H * nn + e] = dacc[e];
}

// Weight gradients as split-K products over the B*N rows: block (tile,
// split) computes one 64x64 tile of
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

// Launch plan of a backward (#3, or #5 with `perhead`): per-window blocks
// (a fixed, occupancy-sized grid walking the window chunks) and the
// weight-gradient splits.
struct BwdPlan {
  bool perhead;
  BwdLayout L;  // #3
  PhLayout P;   // #5
  size_t smem, ws_floats;
  int wpb, grid, splits, rows_per_split, wtiles, E;
  cudaError_t err;
};

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

// The current device's SM count and the shared memory one block may opt in
// to (232,448 bytes on the H100).
cudaError_t device_limits(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

BwdPlan bwd_plan(int B, int N, int C, int H, bool dropout, bool perhead) {
  BwdPlan P{};
  P.perhead = perhead;
  int sms = 0, optin = 0, per_sm = 0;
  P.err = device_limits(&sms, &optin);
  if (P.err != cudaSuccess) return P;
  if (perhead) {
    // one block per SM: the window count is sized by the card's limit
    P.wpb = ph_windows(N, C, H, true, optin, optin);
    if (P.wpb == 0) {
      P.err = cudaErrorInvalidConfiguration;
      return P;
    }
    P.P = ph_layout(P.wpb, N, C, H, true);
    P.smem = P.P.total * sizeof(float);
    P.err = dropout ? set_smem(wblock_ph_bwd_kernel<true>, P.smem, &per_sm)
                    : set_smem(wblock_ph_bwd_kernel<false>, P.smem, &per_sm);
  } else {
    P.L = bwd_plan_layout(N, C, H);
    P.wpb = P.L.wpb;
    P.smem = P.L.total * sizeof(float);
    P.err = dropout ? set_smem(wblock_bwd_kernel<true>, P.smem, &per_sm)
                    : set_smem(wblock_bwd_kernel<false>, P.smem, &per_sm);
  }
  if (P.err == cudaSuccess && per_sm < 1) P.err = cudaErrorInvalidConfiguration;
  if (P.err != cudaSuccess) return P;
  const int nchunks = (B + P.wpb - 1) / P.wpb;
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

int check_geometry(int N, int C, int H) {
  if (N < 1 || N > kMaxN || C < 4 || C % 4 != 0 || H < 1 || C % H != 0) return (int)cudaErrorInvalidValue;
  return 0;
}

// The per-head kernels also read a head's columns as float4: hd % 4 == 0.
int check_ph_geometry(int N, int C, int H) {
  if (check_geometry(N, C, H) || (C / H) % 4 != 0) return (int)cudaErrorInvalidValue;
  return 0;
}

int bwd_workspace(int B, int N, int C, int H, int dropout, bool perhead, long long* floats) {
  if (perhead ? check_ph_geometry(N, C, H) : check_geometry(N, C, H))
    return (int)cudaErrorInvalidValue;
  if (B == 0) {
    *floats = 0;
    return 0;
  }
  const BwdPlan P = bwd_plan(B, N, C, H, dropout != 0, perhead);
  if (P.err != cudaSuccess) return (int)P.err;
  *floats = (long long)P.ws_floats;
  return 0;
}

// The four launches of a backward on `stream`: the per-window kernel (#3,
// or #5 with `perhead`), the weight-gradient partials, and the two ordered
// reductions.
int run_backward(bool perhead, const void* x, const void* wqkv, const void* bqkv,
                 const void* wqkv_t, const void* wproj_t, const void* rel_bias, const void* mask,
                 const void* dy, const void* keep, float inv_keep, void* dx, void* dweights,
                 void* drel_bias, void* ws, int B, int N, int C, int H, int nW, void* stream) {
  if ((perhead ? check_ph_geometry(N, C, H) : check_geometry(N, C, H)) ||
      (mask != nullptr && nW < 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const bool dropout = keep != nullptr;
  const BwdPlan P = bwd_plan(B, N, C, H, dropout, perhead);
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
      dbias_part, B, N, C, H, nw
  if (perhead && dropout)
    wblock_ph_bwd_kernel<true><<<P.grid, kThreads, P.smem, s>>>(FOCAL_BWD_ARGS, P.P);
  else if (perhead)
    wblock_ph_bwd_kernel<false><<<P.grid, kThreads, P.smem, s>>>(FOCAL_BWD_ARGS, P.P);
  else if (dropout)
    wblock_bwd_kernel<true><<<P.grid, kThreads, P.smem, s>>>(FOCAL_BWD_ARGS, P.L);
  else
    wblock_bwd_kernel<false><<<P.grid, kThreads, P.smem, s>>>(FOCAL_BWD_ARGS, P.L);
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

// Per-head forward (#4), with attention dropout when `keep` is not null:
// the function of focal_wblock_fwd (keep null) or focal_wblock_fwd_dropout,
// the same mask bits for the same seed. Needs (C / H) % 4 == 0. Returns
// cudaErrorInvalidConfiguration when one window does not fit a block.
extern "C" int focal_wblock_ph_fwd(const void* x, const void* wqkv, const void* bqkv,
                                   const void* wproj, const void* bproj, const void* rel_bias,
                                   const void* mask, void* y, void* keep, int B, int N, int C,
                                   int H, int nW, unsigned long long seed, unsigned threshold,
                                   float inv_keep, void* stream) {
  if (check_ph_geometry(N, C, H) || (mask != nullptr && nW < 1)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return (int)err;
  // two blocks per SM where one window allows it (each block also holds
  // 1 KB of the SM's 228 KB for the runtime)
  const int wpb = ph_windows(N, C, H, false, (size_t)optin / 2 - 1024, optin);
  if (wpb == 0) return (int)cudaErrorInvalidConfiguration;
  const PhLayout L = ph_layout(wpb, N, C, H, false);
  const size_t smem = L.total * sizeof(float);
  const bool dropout = keep != nullptr;
  err = dropout ? set_smem(wblock_ph_fwd_kernel<true>, smem, nullptr)
                : set_smem(wblock_ph_fwd_kernel<false>, smem, nullptr);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + wpb - 1) / wpb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FOCAL_PH_FWD_ARGS                                                                     \
  static_cast<const float*>(x), static_cast<const float*>(wqkv),                              \
      static_cast<const float*>(bqkv), static_cast<const float*>(wproj),                      \
      static_cast<const float*>(bproj), static_cast<const float*>(rel_bias),                  \
      static_cast<const float*>(mask), static_cast<float*>(y),                                \
      static_cast<unsigned char*>(keep), seed, threshold, inv_keep, B, N, C, H,               \
      mask != nullptr ? nW : 1, L
  if (dropout)
    wblock_ph_fwd_kernel<true><<<grid, kThreads, smem, s>>>(FOCAL_PH_FWD_ARGS);
  else
    wblock_ph_fwd_kernel<false><<<grid, kThreads, smem, s>>>(FOCAL_PH_FWD_ARGS);
#undef FOCAL_PH_FWD_ARGS
  return (int)cudaGetLastError();
}

// Workspace the backward needs, in floats, for this geometry on the current
// device (dqkv and the attention output, the d rel_bias partials and the
// weight-gradient partials).
extern "C" int focal_wblock_bwd_workspace(int B, int N, int C, int H, int dropout,
                                          long long* floats) {
  return bwd_workspace(B, N, C, H, dropout, false, floats);
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
  return run_backward(false, x, wqkv, bqkv, wqkv_t, wproj_t, rel_bias, mask, dy, keep, inv_keep,
                      dx, dweights, drel_bias, ws, B, N, C, H, nW, stream);
}

// Per-head backward (#5): focal_wblock_bwd_workspace and focal_wblock_bwd
// with the per-window kernel walking the heads. Same arguments and outputs;
// keep comes from #4.
extern "C" int focal_wblock_ph_bwd_workspace(int B, int N, int C, int H, int dropout,
                                             long long* floats) {
  return bwd_workspace(B, N, C, H, dropout, true, floats);
}

extern "C" int focal_wblock_ph_bwd(const void* x, const void* wqkv, const void* bqkv,
                                   const void* wqkv_t, const void* wproj_t, const void* rel_bias,
                                   const void* mask, const void* dy, const void* keep,
                                   float inv_keep, void* dx, void* dweights, void* drel_bias,
                                   void* ws, int B, int N, int C, int H, int nW, void* stream) {
  return run_backward(true, x, wqkv, bqkv, wqkv_t, wproj_t, rel_bias, mask, dy, keep, inv_keep,
                      dx, dweights, drel_bias, ws, B, N, C, H, nW, stream);
}

extern "C" const char* focal_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
