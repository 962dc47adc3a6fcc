// Block-tiled matrix products on the bf16 tensor cores for Hopper (sm_90a;
// mma.sync works from sm_80 on): the bf16 forms of the window-block
// forwards' projections (#1-bf16, #2-bf16, #4-bf16, window_block.cu) and of
// the conv tower's products (#13-bf16, #14-bf16, conv_tower.cu). (The bf16
// backwards' products run on gemm_wgmma.cuh.)
//
// One block of kGemmThreads threads computes a kGemmBM x kBN output tile
// (kBN 128, or 64 for products whose width is not a multiple of 128), eight
// warps (2 x 4) each a 64 x kBN / 4 warp tile of mma.sync.m16n8k16 bf16
// products accumulated in f32: one tensor-core pass where 3xTF32 takes
// three. The accumulator layout is m16n8k8 .tf32's, so gemm_3xtf32.cuh's
// gemm_for_each_output visits the outputs.
//
// An operand is f32 or bf16 in device memory (BfOperand::f32, a runtime
// flag: one kernel serves every mix the window block needs). An f32 operand
// is rounded to bf16 (round to nearest even) as it is staged, so a product
// of f32 activations rounds them where the JAX package's kernel casts them
// (attn_out.astype(bf16), dq/dk/dv.astype(bf16)). Shared memory holds bf16
// tiles with K contiguous, [rows][kBfBK + 8], so every fragment register is
// one 32-bit load of two K-neighbours and the 32 lanes of a fragment read hit
// 32 banks. A is read row-major ([M, K], rows staged as they lie); B is
// [K, N]. Tiles stored with K as the strided axis are transposed while
// staged: a thread reads two K rows and writes bf16 pairs.
//
// The pipeline is two shared-memory stages fed through registers: the
// global loads of slice kt + 1 are in flight while the tensor cores work on
// slice kt; one barrier a slice. The sums go into the running accumulators
// (the tensor cores' truncation over K of a few thousand is ~1e-5 of the
// output, far inside the bf16 gates). wgmma and TMA are not used yet.
//
// Requirements (the wrappers check them): every operand 16-byte aligned, its
// contiguous extent and leading dimension multiples of 8 (bf16) or 4 (f32).
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

// An operand in device memory: `ld` elements between rows; f32 != 0 for
// float elements (rounded to bf16 when staged), 0 for __nv_bfloat16.
struct BfOperand {
  const void* p;
  int ld, f32;
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes of an operand's row `row` from element `col`, or zeros.
__device__ __forceinline__ uint4 bf_load16(const BfOperand& op, int row, int col, bool ok) {
  if (!ok) return make_uint4(0u, 0u, 0u, 0u);
  const size_t off = (size_t)row * op.ld + col;
  return op.f32 ? __ldg(reinterpret_cast<const uint4*>(static_cast<const float*>(op.p) + off))
                : __ldg(reinterpret_cast<const uint4*>(
                      static_cast<const __nv_bfloat16*>(op.p) + off));
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

// A K-slice of kGemmBM rows of an operand whose rows hold K contiguously
// ([M, K]: the projections' A), in a thread's registers: f32, 4 float4 a
// thread (row tid / 8 + 32 i, columns tid % 8 * 4); bf16, 2 x 8 values (row
// tid / 4 + 64 i, columns tid % 4 * 8). A 16-byte piece lies wholly inside
// or outside [k0, k_end): K is a multiple of 8.
struct RowSlice {
  uint4 v[4];

  __device__ __forceinline__ void load(const BfOperand& op, int M, int m0, int k0, int k_end) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (op.f32) {
        const int r = (threadIdx.x >> 3) + 32 * i, c = (threadIdx.x & 7) * 4;
        v[i] = bf_load16(op, m0 + r, k0 + c, m0 + r < M && k0 + c < k_end);
      } else if (i < 2) {
        const int r = (threadIdx.x >> 2) + 64 * i, c = (threadIdx.x & 3) * 8;
        v[i] = bf_load16(op, m0 + r, k0 + c, m0 + r < M && k0 + c < k_end);
      }
    }
  }

  // Into the tile [kGemmBM][kBfRowWords] (words of K pairs).
  __device__ __forceinline__ void store(const BfOperand& op, uint32_t* tile) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (op.f32) {
        const int r = (threadIdx.x >> 3) + 32 * i, c = (threadIdx.x & 7) * 4;
        *reinterpret_cast<uint2*>(tile + r * kBfRowWords + c / 2) =
            make_uint2(pack_bf16x2(__uint_as_float(v[i].x), __uint_as_float(v[i].y)),
                       pack_bf16x2(__uint_as_float(v[i].z), __uint_as_float(v[i].w)));
      } else if (i < 2) {
        const int r = (threadIdx.x >> 2) + 64 * i, c = (threadIdx.x & 3) * 8;
        *reinterpret_cast<uint4*>(tile + r * kBfRowWords + c / 2) = v[i];
      }
    }
  }
};

// A K-slice of kW columns of an operand stored [K, cols] (K the strided
// axis: B), transposed into a tile [kW][K pairs] as it is stored. A
// thread's unit u = tid + 256 i is K pair p = u % 16 (rows k0 + 2p and k0 +
// 2p + 1) of the column group u / 16 (4 f32 or 8 bf16 columns): f32 has 16
// kW / 4 units, bf16 16 kW / 8.
template <int kW>
struct PairSlice {
  uint4 v[4];  // unit i: rows 2p (v[2i]) and 2p + 1 (v[2i + 1])

  __device__ __forceinline__ static int units(const BfOperand& op) { return op.f32 ? 4 * kW : 2 * kW; }

  __device__ __forceinline__ void load(const BfOperand& op, int ncols, int c0, int k0, int k_end) {
    const int vec = op.f32 ? 4 : 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = threadIdx.x + 256 * i;
      const bool unit = u < units(op);
      const int p = u & 15, col = c0 + (u >> 4) * vec;
      v[2 * i] = bf_load16(op, k0 + 2 * p, col, unit && k0 + 2 * p < k_end && col < ncols);
      v[2 * i + 1] =
          bf_load16(op, k0 + 2 * p + 1, col, unit && k0 + 2 * p + 1 < k_end && col < ncols);
    }
  }

  __device__ __forceinline__ void store(const BfOperand& op, uint32_t* tile) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = threadIdx.x + 256 * i;
      if (u >= units(op)) continue;
      const int p = u & 15, cg = u >> 4;
      const uint32_t lo[4] = {v[2 * i].x, v[2 * i].y, v[2 * i].z, v[2 * i].w};
      const uint32_t hi[4] = {v[2 * i + 1].x, v[2 * i + 1].y, v[2 * i + 1].z, v[2 * i + 1].w};
      if (op.f32) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = __uint_as_float(lo[j]), b = __uint_as_float(hi[j]);
          tile[(cg * 4 + j) * kBfRowWords + p] = pack_bf16x2(a, b);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t a = (j & 1) ? lo[j / 2] >> 16 : lo[j / 2] & 0xffffu;
          const uint32_t b = (j & 1) ? hi[j / 2] >> 16 : hi[j / 2] & 0xffffu;
          tile[(cg * 8 + j) * kBfRowWords + p] = a | (b << 16);
        }
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

// The block's tile acc = A[m0 : m0 + BM, K range] B[K range, n0 : n0 + kBN]
// over K in [k_begin, k_end): A row-major [M, K], B [K, N]. smem holds
// bf_smem_words(kBN) words.
template <int kBN>
__device__ __forceinline__ void bf_gemm_tile(const BfOperand& a, const BfOperand& b, int M, int N,
                                             int m0, int n0, int k_begin, int k_end,
                                             uint32_t* smem,
                                             float (&acc)[4][gemm_nt<kBN>()][4]) {
  constexpr int kNT = gemm_nt<kBN>();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  RowSlice ar;
  PairSlice<kBN> bs;
  auto load = [&](int k0) {
    ar.load(a, M, m0, k0, k_end);
    bs.load(b, N, n0, k0, k_end);
  };
  const int kt_n = (k_end - k_begin + kBfBK - 1) / kBfBK;
  if (kt_n > 0) load(k_begin);
  for (int kt = 0; kt < kt_n; ++kt) {
    uint32_t* As = smem + (kt & 1) * bf_stage_words(kBN);
    uint32_t* Bs = As + kGemmBM * kBfRowWords;
    ar.store(a, As);
    bs.store(b, Bs);
    // the slot is staged; and every warp finished slice kt - 2, the last
    // reader of this slot, before it reached the barrier of slice kt - 1
    __syncthreads();
    if (kt + 1 < kt_n) load(k_begin + (kt + 1) * kBfBK);
    bf_compute<kBN>(As, Bs, acc);
  }
}

}  // namespace focal
