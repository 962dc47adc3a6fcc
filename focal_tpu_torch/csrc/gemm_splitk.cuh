// Weight gradients as fixed split-K products on the tensor cores, and their
// ordered reduction: the core that #3 and #5 (window_block.cu) and #12
// (fused_mlp.cu) share; #14 (conv_tower.cu) takes its split plan and its
// reduction. (The bf16 backwards' weight gradients run on gemm_wgmma.cuh's
// wg_wgrad_kernel.)
//
// A weight gradient a^T b sums over the R rows of a launch (a [R, M] and
// b [R, N], read as they lie: a transposed in the tile loads of
// gemm_3xtf32.cuh's gemm_tile). The rows are cut into fixed splits; block
// (tile, split) computes one kGemmBM x kBN tile of a^T b over its split's
// rows and, in the first row tile, b's column sums over them (the bias
// gradients), and writes both to its split's partial. reduce_partials_kernel
// then sums the partials in split order. No float atomics: two calls give
// the same bits.
//
// Each kernel here takes a tag type, Src, that the including source defines
// (one per library), so that a profile's kernel names say which library
// launched a shared kernel.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

#include "gemm_3xtf32.cuh"

namespace focal {

// The output tile width of a launch of products of widths n0 and n1 (0 for
// none): 128 columns, or 64 where one is not a multiple of 128 (C = 64: 64,
// 192 or 256 beside 64), so that no column of a tile idles.
inline int tile_bn(int n0, int n1) { return n0 % 128 == 0 && n1 % 128 == 0 ? 128 : 64; }

// (row tiles x column tiles) of an M x N product in kGemmBM x bn tiles.
inline void set_tiles(int M, int N, int bn, int* tiles_n, int* tiles) {
  *tiles_n = (N + bn - 1) / bn;
  *tiles = ((M + kGemmBM - 1) / kGemmBM) * *tiles_n;
}

// One product of a weight-gradient launch: a^T b, a [R, M] and b [R, N],
// into [M, N] at offset `out` of a partial and b's column sums at
// `sums_out` (offsets in floats). One launch runs two problems: blocks
// [0, p0.tiles) take p0, the rest p1.
struct WgradGemm {
  const float* a;
  const float* b;
  int M, N, tiles_n, tiles;
  size_t out, sums_out;
};

inline WgradGemm wgrad_gemm(const float* a, const float* b, int M, int N, size_t out,
                            size_t sums_out, int bn) {
  WgradGemm p{a, b, M, N, 0, 0, out, sums_out};
  set_tiles(M, N, bn, &p.tiles_n, &p.tiles);
  return p;
}

// The row splits of R rows for a launch of `tiles` output tiles a split:
// enough splits to fill `sms` SMs about four times over, each at least 256
// rows, a multiple of kGemmBK.
struct RowSplits {
  int splits, rows_per_split;
};

inline RowSplits split_rows(int R, int tiles, int sms) {
  int splits = (4 * sms + tiles - 1) / tiles;
  splits = std::max(1, std::min(splits, (R + 255) / 256));
  int rps = (R + splits - 1) / splits;
  rps = (rps + kGemmBK - 1) / kGemmBK * kGemmBK;
  return {(R + rps - 1) / rps, rps};
}

// Block (tile, split = blockIdx.y): its tile of p0 or p1 over rows
// [split * rows_per_split, ...) of R, into the split's partial (E floats
// from part + split * E). With `accumulate` it adds to what the partial
// holds (a later chunk of rows of the same product: still one fixed
// order). Two blocks an SM at 64 columns (<= 128 registers), one at 128.
template <int kBN, class Src>
__global__ void __launch_bounds__(kGemmThreads, kBN == 64 ? 2 : 1)
wgrad_gemm_kernel(WgradGemm p0, WgradGemm p1, int R, int rows_per_split, float* __restrict__ part,
                  size_t E, bool accumulate) {
  extern __shared__ float4 smem4[];
  int tile = blockIdx.x;
  const WgradGemm p = tile < p0.tiles ? p0 : p1;
  if (tile >= p0.tiles) tile -= p0.tiles;
  const int m0 = (tile / p.tiles_n) * kGemmBM, n0 = (tile % p.tiles_n) * kBN;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(R, r_begin + rows_per_split);
  float acc[4][gemm_nt<kBN>()][4], csum = 0.f;
  gemm_tile<true, true, kBN>(p.a, p.M, p.b, p.N, p.M, p.N, m0, n0, r_begin, r_end,
                             reinterpret_cast<float*>(smem4), acc, csum);
  float* out = part + (size_t)blockIdx.y * E;
  gemm_for_each_output<kBN>(acc, p.M, p.N, m0, n0, [&](int row, int col, float v0, float v1) {
    float2* dst = reinterpret_cast<float2*>(out + p.out + (size_t)row * p.N + col);
    if (accumulate) {
      const float2 o = *dst;
      v0 = o.x + v0;
      v1 = o.y + v1;
    }
    *dst = make_float2(v0, v1);
  });
  if (m0 == 0 && (int)threadIdx.x < kBN && n0 + (int)threadIdx.x < p.N) {
    float* s = out + p.sums_out + n0 + threadIdx.x;
    *s = accumulate ? *s + csum : csum;
  }
}

// out[e] = sum over s (in order) of part[s][e]: the deterministic second
// pass of the cross-block reductions.
template <class Src>
__global__ void reduce_partials_kernel(const float* __restrict__ part, int S, size_t E,
                                       float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * E + e];
  out[e] = acc;
}

// One weight-gradient launch of `splits` row splits of R rows (partials E
// floats apart at `part`) on `stream`, in tiles of kBN columns.
template <int kBN, class Src>
cudaError_t launch_wgrad_bn(const WgradGemm& p0, const WgradGemm& p1, int R, int rows_per_split,
                            int splits, float* part, size_t E, bool accumulate, cudaStream_t s) {
  const size_t smem = gemm_smem_bytes(kBN);
  cudaError_t err = cudaFuncSetAttribute(wgrad_gemm_kernel<kBN, Src>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wgrad_gemm_kernel<kBN, Src><<<dim3(p0.tiles + p1.tiles, splits), kGemmThreads, smem, s>>>(
      p0, p1, R, rows_per_split, part, E, accumulate);
  return cudaGetLastError();
}

// The same in tiles of bn (128 or 64) columns.
template <class Src>
cudaError_t launch_wgrad(int bn, const WgradGemm& p0, const WgradGemm& p1, int R,
                         int rows_per_split, int splits, float* part, size_t E, bool accumulate,
                         cudaStream_t s) {
  return bn == 128 ? launch_wgrad_bn<128, Src>(p0, p1, R, rows_per_split, splits, part, E,
                                               accumulate, s)
                   : launch_wgrad_bn<64, Src>(p0, p1, R, rows_per_split, splits, part, E,
                                              accumulate, s);
}

// The ordered sum of S partials of E floats into `out`, on `stream`.
template <class Src>
cudaError_t launch_reduce(const float* part, int S, size_t E, float* out, cudaStream_t s) {
  constexpr int kThreads = 256;
  reduce_partials_kernel<Src><<<(unsigned)((E + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, S, E, out);
  return cudaGetLastError();
}

}  // namespace focal
