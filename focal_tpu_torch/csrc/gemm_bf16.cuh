// Block-tiled matrix products on the bf16 tensor cores (mma.sync m16n8k16,
// sm_80 and later; built for Hopper, sm_90a): the conv tower's bf16
// products (#13-bf16, #14-bf16, conv_tower.cu). (The other bf16 products,
// the window block's and the fused MLP's, run on gemm_wgmma.cuh.)
//
// One block of kGemmThreads threads computes a kGemmBM x kBN output tile
// (kBN 128, or 64 for products whose width is not a multiple of 128), eight
// warps (2 x 4) each a 64 x kBN / 4 warp tile of mma.sync.m16n8k16 bf16
// products accumulated in f32: one tensor-core pass where 3xTF32 takes
// three. The accumulator layout is m16n8k8 .tf32's, so gemm_3xtf32.cuh's
// gemm_for_each_output visits the outputs.
//
// Shared memory holds bf16 tiles with K contiguous, [rows][kBfBK + 8], so
// every fragment register is one 32-bit load of two K-neighbours and the 32
// lanes of a fragment read hit 32 banks. The caller stages A (the conv
// tower's implicit-im2col rows); B is [K, N] in device memory, K the
// strided axis, transposed while staged by PairSlice: a thread reads two K
// rows and writes bf16 pairs. The caller's pipeline is two shared-memory
// stages fed through registers (conv_tower.cu's bf_conv_tile).
//
// Requirements (the wrappers check them): every operand 16-byte aligned, its
// contiguous extent and leading dimension multiples of 8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_3xtf32.cuh"

namespace focal {

constexpr int kBfBK = 32;                   // K of a slice: two m16n8k16 steps
constexpr int kBfRowWords = kBfBK / 2 + 4;  // a staged row: 16 words of bf16 pairs, 4 of padding

// Words of one pipeline stage (the A tile, then the B tile) and of the two.
__host__ __device__ constexpr int bf_stage_words(int bn) { return (kGemmBM + bn) * kBfRowWords; }
__host__ __device__ constexpr int bf_smem_words(int bn) { return 2 * bf_stage_words(bn); }

// A bf16 operand in device memory: `ld` elements between rows.
struct BfOperand {
  const __nv_bfloat16* p;
  int ld;
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes (8 values) of an operand's row `row` from element `col`, or zeros.
__device__ __forceinline__ uint4 bf_load16(const BfOperand& op, int row, int col, bool ok) {
  if (!ok) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(reinterpret_cast<const uint4*>(op.p + (size_t)row * op.ld + col));
}

// c += a b for one m16n8k16 fragment triple (bf16 operands, f32 sums).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A K-slice of kW columns of a bf16 operand stored [K, cols] (K the strided
// axis: B), transposed into a tile [kW][K pairs] as it is stored. A
// thread's unit u = tid + 256 i is K pair p = u % 16 (rows k0 + 2p and k0 +
// 2p + 1) of the column group u / 16 (8 columns): 2 kW units.
template <int kW>
struct PairSlice {
  static constexpr int kUnits = 2 * kW;
  uint4 v[4];  // unit i: rows 2p (v[2i]) and 2p + 1 (v[2i + 1])

  __device__ __forceinline__ void load(const BfOperand& op, int ncols, int c0, int k0, int k_end) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = threadIdx.x + 256 * i;
      const bool unit = u < kUnits;
      const int p = u & 15, col = c0 + (u >> 4) * 8;
      v[2 * i] = bf_load16(op, k0 + 2 * p, col, unit && k0 + 2 * p < k_end && col < ncols);
      v[2 * i + 1] =
          bf_load16(op, k0 + 2 * p + 1, col, unit && k0 + 2 * p + 1 < k_end && col < ncols);
    }
  }

  __device__ __forceinline__ void store(uint32_t* tile) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = threadIdx.x + 256 * i;
      if (u >= kUnits) continue;
      const int p = u & 15, cg = u >> 4;
      const uint32_t lo[4] = {v[2 * i].x, v[2 * i].y, v[2 * i].z, v[2 * i].w};
      const uint32_t hi[4] = {v[2 * i + 1].x, v[2 * i + 1].y, v[2 * i + 1].z, v[2 * i + 1].w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t a = (j & 1) ? lo[j / 2] >> 16 : lo[j / 2] & 0xffffu;
        const uint32_t b = (j & 1) ? hi[j / 2] >> 16 : hi[j / 2] & 0xffffu;
        tile[(cg * 8 + j) * kBfRowWords + p] = a | (b << 16);
      }
    }
  }
};

// acc += A tile times B tile, both [rows][kBfRowWords] with K pairs along
// the row. Warp w owns rows (w / 4) * 64 and columns (w % 4) * kBN / 4 of
// the block tile. Fragments as the PTX ISA lays out m16n8k16 .bf16: A
// registers (row g, K 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8); B
// (K 2t, column g), (2t + 8, g); lane 4 g + t.
template <int kBN>
__device__ __forceinline__ void bf_compute(const uint32_t* As, const uint32_t* Bs,
                                           float (&acc)[4][gemm_nt<kBN>()][4]) {
  constexpr int kNT = gemm_nt<kBN>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * (kBN / 4);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kBfBK / 2; ks += 8) {
    uint32_t b[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const uint32_t* row = Bs + (wn + nt * 8 + g) * kBfRowWords + ks + t;
      b[nt][0] = row[0];
      b[nt][1] = row[4];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const uint32_t* r0 = As + (wm + mt * 16 + g) * kBfRowWords + ks + t;
      const uint32_t* r8 = r0 + 8 * kBfRowWords;
      const uint32_t a[4] = {r0[0], r8[0], r0[4], r8[4]};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
    }
  }
}

}  // namespace focal
