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
//
// What bounds them on this card: operations. Each output of fc1 and fc2 is
// a C- or H-long dot product; at C = 64 a row does 4CH = 65,536 FLOPs for
// 2C*4 = 512 bytes of x and y, far above the f32 ridge of 20 FLOP/byte
// (67 TFLOP/s over 3.35 TB/s). f32 on the CUDA cores; no tensor cores yet.
//
// What the design does about it:
//   * The [T, H] hidden never reaches device memory, in either pass. A
//     forward block owns 32 rows: x in shared memory, then for each 32-wide
//     chunk of H the chunk of W1 and of W2 staged in shared memory, z and
//     h for 32 x 32 (one row x 4 columns a thread), and y += h W2[chunk] in
//     registers (2 rows x 4 columns x C/64 a thread). At C = 256 that is
//     ~100 KB of shared memory, two blocks an SM.
//   * The backward needs two sums that cross the tiling: dx sums over H,
//     the weight gradients over T. It runs two kernels that both recompute
//     z and dh from x, g and the weights (14 TCH FLOPs against the 10 the
//     function needs, and no [T, H] traffic): mlp_bwd_dx_kernel walks the
//     chunks of H for a tile of rows like the forward and writes dx;
//     mlp_bwd_dw_kernel owns one chunk of H and a fixed group of rows,
//     keeps its chunk of dW1, dW2 and db1 (and db2, chunk 0) in registers
//     over the group's tiles, and writes them to its group's partial. One
//     ordered sum over the groups (reduce_partials_kernel) gives the
//     gradients: no float atomics, so two calls give the same bits. The
//     group count is bounded so that the partials stay under 64 MB.
//   * Weights come in the layouts each product reads row by row: W1 [C, H]
//     and W2 [H, C] for the forward, and also W1^T [H, C] and W2^T [C, H]
//     (nn.Linear's own layouts) for the backward.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;         // token rows of a tile
constexpr int kChunk = 32;        // hidden units of a chunk
constexpr int kHS = kChunk + 4;   // padded row stride of [kRows][kChunk] tiles
constexpr int kMaxC = 256;        // widest C: one thread per column in the db2 sum, 4 column passes
constexpr int kSiteHidden = 0;    // keep1, after the GELU
constexpr int kSiteOut = 1;       // keep2, after fc2
constexpr size_t kMaxPartialBytes = 64ull << 20;

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

struct MlpArgs {
  const float* x;    // [T, C]
  const float* w1;   // [C, H]
  const float* b1;   // [H]
  const float* w2;   // [H, C] (forward)
  const float* b2;   // [C] (forward)
  const float* w1t;  // [H, C] (backward, dx)
  const float* w2t;  // [C, H] (backward, dh)
  const float* g;    // [T, C] (backward)
  float* out;        // forward: y [T, C]; backward: dx [T, C]
  float* part;       // backward: [groups, E] weight-gradient partials
  int T, C, H, rows_per_group;
  unsigned long long seed;
  unsigned threshold;
  float inv_keep;
};

// Rows [r0, r0 + kRows) of a [T, C] array into shared memory (row stride
// C + 4), zero from row r_end on; with kMaskOut the values are g2 = g *
// keep2 / (1 - rate).
template <bool kMaskOut>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* dst, int r0,
                                          int r_end, const MlpArgs& p) {
  const int C = p.C, XS = C + 4, c4n = C / 4;
  for (int e = threadIdx.x; e < kRows * c4n; e += kThreads) {
    const int r = e / c4n, c4 = e - r * c4n;
    const int row = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < r_end) {
      v = __ldg(reinterpret_cast<const float4*>(src + (size_t)row * C) + c4);
      if (kMaskOut) {
        const uint4 b = keep_bits(p.seed, row, c4, kSiteOut);
        v.x = b.x >= p.threshold ? v.x * p.inv_keep : 0.f;
        v.y = b.y >= p.threshold ? v.y * p.inv_keep : 0.f;
        v.z = b.z >= p.threshold ? v.z * p.inv_keep : 0.f;
        v.w = b.w >= p.threshold ? v.w * p.inv_keep : 0.f;
      }
    }
    *reinterpret_cast<float4*>(&dst[r * XS + c4 * 4]) = v;
  }
}

// Columns [j0, j0 + kChunk) of a [R, H] array into [R][kChunk], zero past H.
__device__ __forceinline__ void load_col_chunk(const float* __restrict__ src, float* dst, int R,
                                               int H, int j0) {
  for (int e = threadIdx.x; e < R * kChunk; e += kThreads) {
    const int r = e / kChunk, jj = e - r * kChunk;
    dst[e] = j0 + jj < H ? __ldg(src + (size_t)r * H + j0 + jj) : 0.f;
  }
}

// Rows [j0, j0 + kChunk) of a [H, C] array into [kChunk][C], zero past H.
__device__ __forceinline__ void load_row_chunk(const float* __restrict__ src, float* dst, int C,
                                               int H, int j0) {
  for (int e = threadIdx.x; e < kChunk * C; e += kThreads) {
    const int jj = e / C;
    dst[e] = j0 + jj < H ? __ldg(src + (size_t)j0 * C + e) : 0.f;
  }
}

// z (with b1) and, with kGrad, dh = g2 W2^T[:, chunk] for the thread's row
// zr and chunk columns zc .. zc + 3, from the staged tiles.
template <bool kGrad>
__device__ __forceinline__ void chunk_products(const float* xs, const float* gs, const float* w1s,
                                               const float* w2ts, const MlpArgs& p, int j0,
                                               int zr, int zc, float (&z)[4], float (&dh)[4]) {
  const int XS = p.C + 4;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    z[u] = j0 + zc + u < p.H ? __ldg(p.b1 + j0 + zc + u) : 0.f;
    dh[u] = 0.f;
  }
  for (int c = 0; c < p.C; ++c) {
    const float a = xs[zr * XS + c];
    const float4 w = *reinterpret_cast<const float4*>(&w1s[c * kChunk + zc]);
    z[0] = fmaf(a, w.x, z[0]);
    z[1] = fmaf(a, w.y, z[1]);
    z[2] = fmaf(a, w.z, z[2]);
    z[3] = fmaf(a, w.w, z[3]);
    if (kGrad) {
      const float gv = gs[zr * XS + c];
      const float4 v = *reinterpret_cast<const float4*>(&w2ts[c * kChunk + zc]);
      dh[0] = fmaf(gv, v.x, dh[0]);
      dh[1] = fmaf(gv, v.y, dh[1]);
      dh[2] = fmaf(gv, v.z, dh[2]);
      dh[3] = fmaf(gv, v.w, dh[3]);
    }
  }
}

// acc[i][q] += tile[rows ty, ty + 16][:] . wrows[:, columns tx*4 + 64q]: the
// second product of the forward (h W2) and of dx (dz W1^T).
template <int kQ>
__device__ __forceinline__ void accumulate_rows(const float* tile, const float* wrows, int C, int tx,
                                                int ty, float (&acc)[2][kQ][4]) {
#pragma unroll 4
  for (int j = 0; j < kChunk; ++j) {
    const float a0 = tile[ty * kHS + j], a1 = tile[(ty + 16) * kHS + j];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int col = q * 64 + tx * 4;
      if (col < C) {
        const float4 b = *reinterpret_cast<const float4*>(&wrows[j * C + col]);
        acc[0][q][0] = fmaf(a0, b.x, acc[0][q][0]);
        acc[0][q][1] = fmaf(a0, b.y, acc[0][q][1]);
        acc[0][q][2] = fmaf(a0, b.z, acc[0][q][2]);
        acc[0][q][3] = fmaf(a0, b.w, acc[0][q][3]);
        acc[1][q][0] = fmaf(a1, b.x, acc[1][q][0]);
        acc[1][q][1] = fmaf(a1, b.y, acc[1][q][1]);
        acc[1][q][2] = fmaf(a1, b.z, acc[1][q][2]);
        acc[1][q][3] = fmaf(a1, b.w, acc[1][q][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// forward (#10; #11 with kDropout)

template <int kQ, bool kDropout>
__global__ void __launch_bounds__(kThreads) mlp_fwd_kernel(const MlpArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, H = p.H, XS = C + 4;
  float* xs = smem;                  // [kRows][XS]
  float* w1s = xs + kRows * XS;      // [C][kChunk]
  float* w2s = w1s + C * kChunk;     // [kChunk][C]
  float* hs = w2s + kChunk * C;      // [kRows][kHS]
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int zr = tid / 8, zc = (tid % 8) * 4;   // z: one row, four chunk columns
  const int tx = tid % 16, ty = tid / 16;       // y: rows ty, ty + 16; columns tx*4 + 64q
  load_rows<false>(p.x, xs, r0, p.T, p);
  float acc[2][kQ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][q][u] = 0.f;

  for (int j0 = 0; j0 < H; j0 += kChunk) {
    __syncthreads();  // x is staged; the last chunk's weights and h are read
    load_col_chunk(p.w1, w1s, C, H, j0);
    load_row_chunk(p.w2, w2s, C, H, j0);
    __syncthreads();
    float z[4], unused[4];
    chunk_products<false>(xs, nullptr, w1s, nullptr, p, j0, zr, zc, z, unused);
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (kDropout) bits = keep_bits(p.seed, r0 + zr, (j0 + zc) >> 2, kSiteHidden);
    float4 h;
    float* hv = reinterpret_cast<float*>(&h);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float v = gelu(z[u]);
      if (kDropout) v = word(bits, u) >= p.threshold ? v * p.inv_keep : 0.f;
      hv[u] = j0 + zc + u < H ? v : 0.f;
    }
    *reinterpret_cast<float4*>(&hs[zr * kHS + zc]) = h;
    __syncthreads();
    accumulate_rows<kQ>(hs, w2s, C, tx, ty, acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= p.T) continue;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int col = q * 64 + tx * 4;
      if (col >= C) continue;
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (kDropout) bits = keep_bits(p.seed, row, col >> 2, kSiteOut);
      float4 o;
      float* ov = reinterpret_cast<float*>(&o);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v = acc[i][q][u] + __ldg(p.b2 + col + u);
        if (kDropout) v = word(bits, u) >= p.threshold ? v * p.inv_keep : 0.f;
        ov[u] = v;
      }
      *reinterpret_cast<float4*>(p.out + (size_t)row * C + col) = o;
    }
  }
}

// ---------------------------------------------------------------------------
// backward (#12): dz of the thread's row and four chunk columns, and the
// h actually used (after keep1), from the recomputed z and dh

template <bool kDropout>
__device__ __forceinline__ void hidden_grads(const MlpArgs& p, int row, int j0, int zc,
                                             const float (&z)[4], const float (&dh)[4],
                                             float4& dz, float4& hu) {
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);
  if (kDropout) bits = keep_bits(p.seed, row, (j0 + zc) >> 2, kSiteHidden);
  float* dzv = reinterpret_cast<float*>(&dz);
  float* huv = reinterpret_cast<float*>(&hu);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float d = dh[u] * gelu_grad(z[u]);
    float h = gelu(z[u]);
    if (kDropout) {
      const bool keep = word(bits, u) >= p.threshold;
      d = keep ? d * p.inv_keep : 0.f;
      h = keep ? h * p.inv_keep : 0.f;
    }
    const bool valid = j0 + zc + u < p.H;
    dzv[u] = valid ? d : 0.f;
    huv[u] = valid ? h : 0.f;
  }
}

// dx for a tile of 32 rows, walking the chunks of H.
template <int kQ, bool kDropout>
__global__ void __launch_bounds__(kThreads) mlp_bwd_dx_kernel(const MlpArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, H = p.H, XS = C + 4;
  float* xs = smem;                  // [kRows][XS]
  float* gs = xs + kRows * XS;       // [kRows][XS]: g2
  float* w1s = gs + kRows * XS;      // [C][kChunk]: W1[:, chunk]
  float* w2ts = w1s + C * kChunk;    // [C][kChunk]: W2^T[:, chunk]
  float* w1ts = w2ts + C * kChunk;   // [kChunk][C]: W1^T[chunk, :]
  float* dzs = w1ts + kChunk * C;    // [kRows][kHS]
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int zr = tid / 8, zc = (tid % 8) * 4;
  const int tx = tid % 16, ty = tid / 16;
  load_rows<false>(p.x, xs, r0, p.T, p);
  load_rows<kDropout>(p.g, gs, r0, p.T, p);
  float acc[2][kQ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][q][u] = 0.f;

  for (int j0 = 0; j0 < H; j0 += kChunk) {
    __syncthreads();
    load_col_chunk(p.w1, w1s, C, H, j0);
    load_col_chunk(p.w2t, w2ts, C, H, j0);
    load_row_chunk(p.w1t, w1ts, C, H, j0);
    __syncthreads();
    float z[4], dh[4];
    chunk_products<true>(xs, gs, w1s, w2ts, p, j0, zr, zc, z, dh);
    float4 dz, hu;
    hidden_grads<kDropout>(p, r0 + zr, j0, zc, z, dh, dz, hu);
    *reinterpret_cast<float4*>(&dzs[zr * kHS + zc]) = dz;
    __syncthreads();
    accumulate_rows<kQ>(dzs, w1ts, C, tx, ty, acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= p.T) continue;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int col = q * 64 + tx * 4;
      if (col < C)
        *reinterpret_cast<float4*>(p.out + (size_t)row * C + col) =
            make_float4(acc[i][q][0], acc[i][q][1], acc[i][q][2], acc[i][q][3]);
    }
  }
}

// The weight gradients of one chunk of H (blockIdx.x) over one group of
// rows (blockIdx.y), into the group's partial [dW1 (C x H) | db1 (H) |
// dW2 (H x C) | db2 (C)]. db2 is summed by the blocks of chunk 0.
template <int kQ, bool kDropout>
__global__ void __launch_bounds__(kThreads) mlp_bwd_dw_kernel(const MlpArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, H = p.H, XS = C + 4;
  float* w1s = smem;                 // [C][kChunk]
  float* w2ts = w1s + C * kChunk;    // [C][kChunk]
  float* xs = w2ts + C * kChunk;     // [kRows][XS]
  float* gs = xs + kRows * XS;       // [kRows][XS]: g2
  float* dzs = gs + kRows * XS;      // [kRows][kHS]
  float* hus = dzs + kRows * kHS;    // [kRows][kHS]
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kChunk;
  const int g_begin = blockIdx.y * p.rows_per_group;
  const int g_end = min(p.T, g_begin + p.rows_per_group);
  const int zr = tid / 8, zc = (tid % 8) * 4;   // z, dz; dW1 rows zr + 32i, columns zc
  const int tx = tid % 16, ty = tid / 16;       // dW2 rows ty, ty + 16; columns tx*4 + 64q
  load_col_chunk(p.w1, w1s, C, H, j0);
  load_col_chunk(p.w2t, w2ts, C, H, j0);
  float acc1[2 * kQ][4], acc2[2][kQ][4];
#pragma unroll
  for (int i = 0; i < 2 * kQ; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc1[i][u] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc2[i][q][u] = 0.f;
  float db1 = 0.f, db2 = 0.f;

  for (int r0 = g_begin; r0 < g_end; r0 += kRows) {
    __syncthreads();  // the weights are staged; the last tile is read
    load_rows<false>(p.x, xs, r0, g_end, p);
    load_rows<kDropout>(p.g, gs, r0, g_end, p);
    __syncthreads();
    float z[4], dh[4];
    chunk_products<true>(xs, gs, w1s, w2ts, p, j0, zr, zc, z, dh);
    float4 dz, hu;
    hidden_grads<kDropout>(p, r0 + zr, j0, zc, z, dh, dz, hu);
    *reinterpret_cast<float4*>(&dzs[zr * kHS + zc]) = dz;
    *reinterpret_cast<float4*>(&hus[zr * kHS + zc]) = hu;
    __syncthreads();
    // dW1[c][chunk] += x^T dz; dW2[chunk][n] += h_used^T g2 (rows past
    // g_end hold x = g2 = 0, so dz = 0 and h_used g2 = 0 there)
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      const float4 d4 = *reinterpret_cast<const float4*>(&dzs[r * kHS + zc]);
#pragma unroll
      for (int i = 0; i < 2 * kQ; ++i) {
        const int c = zr + 32 * i;
        if (c < C) {
          const float a = xs[r * XS + c];
          acc1[i][0] = fmaf(a, d4.x, acc1[i][0]);
          acc1[i][1] = fmaf(a, d4.y, acc1[i][1]);
          acc1[i][2] = fmaf(a, d4.z, acc1[i][2]);
          acc1[i][3] = fmaf(a, d4.w, acc1[i][3]);
        }
      }
      const float h0 = hus[r * kHS + ty], h1 = hus[r * kHS + ty + 16];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int col = q * 64 + tx * 4;
        if (col < C) {
          const float4 g4 = *reinterpret_cast<const float4*>(&gs[r * XS + col]);
          acc2[0][q][0] = fmaf(h0, g4.x, acc2[0][q][0]);
          acc2[0][q][1] = fmaf(h0, g4.y, acc2[0][q][1]);
          acc2[0][q][2] = fmaf(h0, g4.z, acc2[0][q][2]);
          acc2[0][q][3] = fmaf(h0, g4.w, acc2[0][q][3]);
          acc2[1][q][0] = fmaf(h1, g4.x, acc2[1][q][0]);
          acc2[1][q][1] = fmaf(h1, g4.y, acc2[1][q][1]);
          acc2[1][q][2] = fmaf(h1, g4.z, acc2[1][q][2]);
          acc2[1][q][3] = fmaf(h1, g4.w, acc2[1][q][3]);
        }
      }
    }
    if (tid < kChunk)
      for (int r = 0; r < kRows; ++r) db1 += dzs[r * kHS + tid];
    if (blockIdx.x == 0 && tid < C)
      for (int r = 0; r < kRows; ++r) db2 += gs[r * XS + tid];
  }

  const size_t E = 2 * (size_t)C * H + H + C;
  float* out = p.part + (size_t)blockIdx.y * E;
  float* out_db1 = out + (size_t)C * H;
  float* out_dw2 = out_db1 + H;
  float* out_db2 = out_dw2 + (size_t)H * C;
#pragma unroll
  for (int i = 0; i < 2 * kQ; ++i) {
    const int c = zr + 32 * i;
    if (c >= C) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + zc + u < H) out[(size_t)c * H + j0 + zc + u] = acc1[i][u];
  }
  if (tid < kChunk && j0 + tid < H) out_db1[j0 + tid] = db1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = j0 + ty + 16 * i;
    if (j >= H) continue;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int col = q * 64 + tx * 4;
      if (col >= C) continue;
#pragma unroll
      for (int u = 0; u < 4; ++u) out_dw2[(size_t)j * C + col + u] = acc2[i][q][u];
    }
  }
  if (blockIdx.x == 0 && tid < C) out_db2[tid] = db2;
}

// out[e] = sum over s (in order) of part[s][e]: the deterministic second
// pass of the weight gradients.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int S, size_t E,
                                       float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * E + e];
  out[e] = acc;
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
// host side

int check_dims(int T, int C, int H) {
  if (T < 1 || C < 4 || C > kMaxC || C % 4 != 0 || H < 1 ||
      (long long)T * std::max(C, H) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  return 0;
}

size_t fwd_smem(int C) { return sizeof(float) * ((size_t)kRows * (C + 4) + 2 * C * kChunk + kRows * kHS); }
size_t dx_smem(int C) { return sizeof(float) * (2ull * kRows * (C + 4) + 3 * C * kChunk + kRows * kHS); }
size_t dw_smem(int C) { return sizeof(float) * (2ull * kRows * (C + 4) + 2 * C * kChunk + 2 * kRows * kHS); }

cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// The row groups of the weight-gradient kernel: enough (chunk, group)
// blocks for four waves of the card, at most the row tiles, and partials
// within kMaxPartialBytes.
struct GroupPlan {
  int groups, rows_per_group;
  size_t E;
};

GroupPlan group_plan(int T, int C, int H, int sms) {
  GroupPlan P{};
  P.E = 2 * (size_t)C * H + H + C;
  const int chunks = (H + kChunk - 1) / kChunk;
  const int tiles = (T + kRows - 1) / kRows;
  int g = (4 * sms + chunks - 1) / chunks;
  g = std::min(g, tiles);
  g = std::min<long long>(g, std::max<long long>(1, kMaxPartialBytes / (P.E * sizeof(float))));
  g = std::max(g, 1);
  const int tiles_per_group = (tiles + g - 1) / g;
  P.rows_per_group = tiles_per_group * kRows;
  P.groups = (T + P.rows_per_group - 1) / P.rows_per_group;
  return P;
}

template <class Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s, const MlpArgs& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

#define FOCAL_MLP_DISPATCH(KERNEL, GRID, SMEM)                                       \
  switch ((p.C + 63) / 64) {                                                         \
    case 1: return dropout ? launch(KERNEL<1, true>, GRID, SMEM, s, p)               \
                           : launch(KERNEL<1, false>, GRID, SMEM, s, p);             \
    case 2: return dropout ? launch(KERNEL<2, true>, GRID, SMEM, s, p)               \
                           : launch(KERNEL<2, false>, GRID, SMEM, s, p);             \
    case 3: return dropout ? launch(KERNEL<3, true>, GRID, SMEM, s, p)               \
                           : launch(KERNEL<3, false>, GRID, SMEM, s, p);             \
    case 4: return dropout ? launch(KERNEL<4, true>, GRID, SMEM, s, p)               \
                           : launch(KERNEL<4, false>, GRID, SMEM, s, p);             \
    default: return (int)cudaErrorInvalidValue;                                      \
  }

int launch_fwd(const MlpArgs& p, bool dropout, cudaStream_t s) {
  const dim3 grid((p.T + kRows - 1) / kRows);
  FOCAL_MLP_DISPATCH(mlp_fwd_kernel, grid, fwd_smem(p.C))
}

int launch_dx(const MlpArgs& p, bool dropout, cudaStream_t s) {
  const dim3 grid((p.T + kRows - 1) / kRows);
  FOCAL_MLP_DISPATCH(mlp_bwd_dx_kernel, grid, dx_smem(p.C))
}

int launch_dw(const MlpArgs& p, bool dropout, int groups, cudaStream_t s) {
  const dim3 grid((p.H + kChunk - 1) / kChunk, groups);
  FOCAL_MLP_DISPATCH(mlp_bwd_dw_kernel, grid, dw_smem(p.C))
}

}  // namespace

// #10 (dropout 0) or #11 (dropout 1): y [T, C] from x [T, C], w1 [C, H],
// b1 [H], w2 [H, C], b2 [C]; with dropout both keep masks of `seed` at
// `threshold`, survivors scaled by inv_keep. One launch on `stream`.
extern "C" int focal_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* y, int T, int C, int H, int dropout,
                             unsigned long long seed, unsigned threshold, float inv_keep,
                             void* stream) {
  if (int e = check_dims(T, C, H)) return e;
  MlpArgs p{};
  p.x = static_cast<const float*>(x);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<float*>(y);
  p.T = T, p.C = C, p.H = H, p.seed = seed, p.threshold = threshold, p.inv_keep = inv_keep;
  return launch_fwd(p, dropout != 0, static_cast<cudaStream_t>(stream));
}

// Workspace of focal_mlp_bwd, in floats: the groups' weight-gradient
// partials.
extern "C" int focal_mlp_bwd_workspace(int T, int C, int H, long long* floats) {
  if (int e = check_dims(T, C, H)) return e;
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const GroupPlan P = group_plan(T, C, H, sms);
  *floats = (long long)P.groups * (long long)P.E;
  return 0;
}

// #12: dx [T, C] and dweights = [dW1 (C x H) | db1 (H) | dW2 (H x C) |
// db2 (C)] for the gradient g [T, C] of y, from x, w1 [C, H], b1, w1t
// [H, C] (W1 transposed) and w2t [C, H] (W2 transposed); with dropout the
// forward's masks are drawn again from `seed`. ws holds
// focal_mlp_bwd_workspace floats. Three launches on `stream`: dx, the
// groups' partials, their ordered sum.
extern "C" int focal_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w1t,
                             const void* w2t, const void* g, void* dx, void* dweights, void* ws,
                             int T, int C, int H, int dropout, unsigned long long seed,
                             unsigned threshold, float inv_keep, void* stream) {
  if (int e = check_dims(T, C, H)) return e;
  int sms = 0;
  cudaError_t cerr = device_sms(&sms);
  if (cerr != cudaSuccess) return (int)cerr;
  const GroupPlan P = group_plan(T, C, H, sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MlpArgs p{};
  p.x = static_cast<const float*>(x);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w1t = static_cast<const float*>(w1t);
  p.w2t = static_cast<const float*>(w2t);
  p.g = static_cast<const float*>(g);
  p.out = static_cast<float*>(dx);
  p.part = static_cast<float*>(ws);
  p.T = T, p.C = C, p.H = H, p.rows_per_group = P.rows_per_group;
  p.seed = seed, p.threshold = threshold, p.inv_keep = inv_keep;
  int err = launch_dx(p, dropout != 0, s);
  if (err) return err;
  err = launch_dw(p, dropout != 0, P.groups, s);
  if (err) return err;
  reduce_partials_kernel<<<(unsigned)((P.E + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      p.part, P.groups, P.E, static_cast<float*>(dweights));
  return (int)cudaGetLastError();
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
