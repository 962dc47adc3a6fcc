// A block-tiled f32 matrix product on the tensor cores, accurate to f32 by
// the 3xTF32 split, for Hopper (sm_90a; mma.sync works from sm_80 on).
//
// One block of kGemmThreads threads computes a kGemmBM x kBN tile (kBN 128,
// or 64 for products whose N is not a multiple of 128, so that no column of
// a tile idles) of
//   acc = A[m0 : m0 + BM, k_begin : k_end] B[k_begin : k_end, n0 : n0 + BN]
// with A either row-major [M, K] or stored transposed, [K, M] (kATrans: the
// weight gradients x^T dqkv read x [R, C] as it lies), or the im2col of a
// (1, KW) convolution's input read in place (ConvStage, ConvWgradStage: the
// conv tower's products), and B row-major [K, N].
// Tiles of A and B are staged in shared memory by a kGemmStages-deep ring of
// cp.async copies (zero-filled past the edges, so ragged M, N and K need no
// padding), and eight warps (2 x 4) each issue mma.sync.m16n8k8 over a
// 64 x kBN / 4 warp tile from them, reading fragments in any layout.
//
// 3xTF32: each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna: round to nearest on the low 13 mantissa bits, ties away), and
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in f32. One TF32
// product keeps ~11 significant bits of each operand and misses f32 gates
// over K = 512 .. 3072 by a factor of ~4; the split keeps ~22 and holds them
// (tests/test_torch_port_perhead_stages.py emulates both). The tensor cores
// truncate each sum they add into a running accumulator; measured on the
// H100 that drifts by ~3.5e-5 of the output at K = 3072 when one
// accumulator takes all of K, so each K-slice of 32 is summed from zero and
// added to the running sum with an f32 add.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace focal {

constexpr int kGemmBM = 128, kGemmBK = 32;
constexpr int kGemmStages = 3;
constexpr int kGemmThreads = 256;
constexpr int kGemmAStride = kGemmBK + 4;  // row-major A tile: [BM][BK + 4]
constexpr int kGemmTStride = kGemmBM + 8;  // transposed A tile: [BK][BM + 8]
constexpr int kGemmAFloats = kGemmBM * kGemmAStride;  // >= kGemmBK * kGemmTStride
static_assert(kGemmAFloats >= kGemmBK * kGemmTStride, "either A layout fits the A slot");

// The B tile [BK][kBN + 8] (the stride puts a fragment's 32 reads on 32
// banks), a ring slot, and the ring, for a tile kBN columns wide.
__host__ __device__ constexpr int gemm_b_stride(int bn) { return bn + 8; }
__host__ __device__ constexpr int gemm_stage_floats(int bn) {
  return kGemmAFloats + kGemmBK * gemm_b_stride(bn);
}
constexpr size_t gemm_smem_bytes(int bn) {
  return (size_t)kGemmStages * gemm_stage_floats(bn) * sizeof(float);
}

// 16 bytes from global to shared memory, asynchronously; zeros where !valid
// (src-size 0: the source is not read).
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// x = hi + lo, each a tf32 value in a 32-bit register.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c += a b for one m16n8k8 fragment triple.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage the K-slice [k0, k0 + BK) of B's columns [n0, n0 + kBN) into the B
// tile of a ring slot: kBN / 32 float4 copies per thread. N and the
// contiguous extent of K are multiples of 4, so a float4 lies wholly inside
// or wholly outside the matrix.
template <int kBN>
__device__ __forceinline__ void gemm_load_b(const float* B, int ldb, int N, int n0, int k0,
                                            int k_end, float* Bs) {
#pragma unroll
  for (int i = 0; i < kBN / 32; ++i) {  // BK rows of kBN / 4 float4
    const int idx = threadIdx.x + i * kGemmThreads;
    const int r = idx / (kBN / 4), c = idx % (kBN / 4) * 4;
    const bool ok = k0 + r < k_end && n0 + c < N;
    cp_async16(Bs + r * gemm_b_stride(kBN) + c, ok ? B + (size_t)(k0 + r) * ldb + n0 + c : B, ok);
  }
}

// Stage the K-slice [k0, k0 + BK) of the block's A rows and B columns into
// one ring slot: 4 float4 copies of A and kBN / 32 of B per thread. M, N
// and the contiguous extent of K are multiples of 4, so a float4 lies
// wholly inside or wholly outside the matrix.
template <bool kATrans, int kBN>
__device__ __forceinline__ void gemm_load_stage(const float* A, int lda, const float* B, int ldb,
                                                int M, int N, int m0, int n0, int k0, int k_end,
                                                float* slot) {
  float* As = slot;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + i * kGemmThreads;
    if (!kATrans) {
      const int r = idx >> 3, c = (idx & 7) * 4;  // BM rows of BK / 4 float4
      const bool ok = m0 + r < M && k0 + c < k_end;
      cp_async16(As + r * kGemmAStride + c, ok ? A + (size_t)(m0 + r) * lda + k0 + c : A, ok);
    } else {
      const int r = idx >> 5, c = (idx & 31) * 4;  // BK rows of BM / 4 float4
      const bool ok = k0 + r < k_end && m0 + c < M;
      cp_async16(As + r * kGemmTStride + c, ok ? A + (size_t)(k0 + r) * lda + m0 + c : A, ok);
    }
  }
  gemm_load_b<kBN>(B, ldb, N, n0, k0, k_end, slot + kGemmAFloats);
}

// The A operand of a (1, KW) SAME convolution, read as its im2col without
// storing it (implicit im2col). x [rows, cin] holds positions s = row % S of
// whole samples; column k = j * cin + ci of im2col row g is x[g + d_j, ci]
// with the shift d_j = sign * (j - lo) of tap j (sign -1: the transposed
// conv), and zero where s + d_j leaves [0, S): cp.async's zero-fill is the
// SAME padding. cin % 4 == 0 (the loaders' invariant): a float4 of a row
// never straddles two taps.
struct ShiftRows {
  const float* x;
  int cin, S, lo, sign;
};

// The loader of a conv product, im2col(x) [M, KW * cin] W [KW * cin, N]:
// A staged in the row-major layout. A thread's 4 rows (tid / 8 + 32 i) and
// its column in the slice (tid % 8 * 4) stay the same over the K loop, so
// their positions are found once; a slice costs one division for its tap.
template <int kBN>
struct ConvStage {
  ShiftRows a;
  const float* B;
  int N, n0, m0, k_end;
  int s[4];  // the positions of the thread's rows, -1 past M

  __device__ __forceinline__ ConvStage(const ShiftRows& a_, const float* B_, int M, int N_, int m0_,
                                       int n0_, int k_end_)
      : a(a_), B(B_), N(N_), n0(n0_), m0(m0_), k_end(k_end_) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + (threadIdx.x >> 3) + 32 * i;
      s[i] = row < M ? row % a.S : -1;
    }
  }

  __device__ __forceinline__ void operator()(int k0, float* slot) const {
    const int c = (threadIdx.x & 7) * 4, k = k0 + c;
    const int j = k / a.cin, ci = k - j * a.cin;
    const int d = a.sign * (j - a.lo);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (threadIdx.x >> 3) + 32 * i;
      const bool ok = k < k_end && s[i] >= 0 && (unsigned)(s[i] + d) < (unsigned)a.S;
      cp_async16(slot + r * kGemmAStride + c,
                 ok ? a.x + (size_t)(m0 + r + d) * a.cin + ci : a.x, ok);
    }
    gemm_load_b<kBN>(B, N, N, n0, k0, k_end, slot + kGemmAFloats);
  }
};

// The loader of a conv's weight gradient, im2col(x)^T B over rows [.., k_end)
// (B [rows, N]): A staged in the transposed layout, K running over the rows.
// A thread's column m = m0 + tid % 32 * 4 of im2col, so its tap and channel,
// stay the same over the K loop.
template <int kBN>
struct ConvWgradStage {
  ShiftRows a;
  const float* B;
  int N, n0, k_end;
  int d, off;  // the column's tap shift and its offset in x, d * cin + ci
  bool m_ok;    // the column lies inside M

  __device__ __forceinline__ ConvWgradStage(const ShiftRows& a_, const float* B_, int M, int N_,
                                            int m0, int n0_, int k_end_)
      : a(a_), B(B_), N(N_), n0(n0_), k_end(k_end_) {
    const int m = m0 + (threadIdx.x & 31) * 4;
    const int j = m / a.cin;
    d = a.sign * (j - a.lo);
    off = d * a.cin + (m - j * a.cin);
    m_ok = m < M;
  }

  __device__ __forceinline__ void operator()(int k0, float* slot) const {
    const int c = (threadIdx.x & 31) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (threadIdx.x >> 5) + 8 * i, g = k0 + r;
      const bool ok = m_ok && g < k_end && (unsigned)(g % a.S + d) < (unsigned)a.S;
      cp_async16(slot + r * kGemmTStride + c, ok ? a.x + (size_t)g * a.cin + off : a.x, ok);
    }
    gemm_load_b<kBN>(B, N, N, n0, k0, k_end, slot + kGemmAFloats);
  }
};

// The number of 8-column fragments of a warp's tile, kBN / 32.
template <int kBN>
__host__ __device__ constexpr int gemm_nt() { return kBN / 32; }

// acc += the slot's A tile times its B tile. Warp w owns rows (w / 4) * 64
// and columns (w % 4) * kBN / 4 of the block tile: 4 x kBN / 32 fragments of
// 16 x 8. Fragment element (row g or g + 8, column t or t + 4) of lane 4 g +
// t, as the PTX ISA lays out m16n8k8 .tf32; the strides keep those 32 reads
// on 32 distinct banks in either A layout.
template <bool kATrans, int kBN>
__device__ __forceinline__ void gemm_compute_stage(const float* slot,
                                                   float (&acc)[4][gemm_nt<kBN>()][4]) {
  constexpr int kNT = gemm_nt<kBN>(), kBS = gemm_b_stride(kBN);
  const float* As = slot;
  const float* Bs = slot + kGemmAFloats;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * (kBN / 4);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kGemmBK; kk += 8) {
    uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = wn + nt * 8 + g;
      split_tf32(Bs[(kk + t) * kBS + n], bh[nt][0], bl[nt][0]);
      split_tf32(Bs[(kk + t + 4) * kBS + n], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int r = wm + mt * 16 + g;
      float a[4];
      if (!kATrans) {
        a[0] = As[r * kGemmAStride + kk + t];
        a[1] = As[(r + 8) * kGemmAStride + kk + t];
        a[2] = As[r * kGemmAStride + kk + t + 4];
        a[3] = As[(r + 8) * kGemmAStride + kk + t + 4];
      } else {
        a[0] = As[(kk + t) * kGemmTStride + r];
        a[1] = As[(kk + t) * kGemmTStride + r + 8];
        a[2] = As[(kk + t + 4) * kGemmTStride + r];
        a[3] = As[(kk + t + 4) * kGemmTStride + r + 8];
      }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {  // the small terms first
        mma_tf32(acc[mt][nt], al, bh[nt]);
        mma_tf32(acc[mt][nt], ah, bl[nt]);
        mma_tf32(acc[mt][nt], ah, bh[nt]);
      }
    }
  }
}

// The block's tile over K in [k_begin, k_end), each K-slice staged into
// its ring slot by load(k0, slot) (gemm_load_stage, ConvStage or
// ConvWgradStage): acc (zeroed here) and, with kColSums, csum += the sum
// over those rows of B's column n0 + threadIdx.x (threads below kBN, rows in
// order: the same bits on every call). smem holds gemm_smem_bytes(kBN).
// Nothing is in flight when it returns.
template <bool kATrans, bool kColSums, int kBN, class Load>
__device__ __forceinline__ void gemm_tile_staged(const Load& load, int k_begin, int k_end,
                                                 float* smem, float (&acc)[4][gemm_nt<kBN>()][4],
                                                 float& csum) {
  constexpr int kNT = gemm_nt<kBN>(), kSlot = gemm_stage_floats(kBN);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int kt_n = (k_end - k_begin + kGemmBK - 1) / kGemmBK;
#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < kt_n) load(k_begin + s * kGemmBK, smem + s * kSlot);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kGemmStages - 2>();  // slice kt has landed
    __syncthreads();                   // and every warp is done with slice kt - 1's slot
    const int pf = kt + kGemmStages - 1;
    if (pf < kt_n) load(k_begin + pf * kGemmBK, smem + (pf % kGemmStages) * kSlot);
    cp_async_commit();
    const float* slot = smem + (kt % kGemmStages) * kSlot;
    if (kColSums && threadIdx.x < kBN) {
      const float* col = slot + kGemmAFloats + threadIdx.x;
#pragma unroll 8
      for (int k = 0; k < kGemmBK; ++k) csum += col[k * gemm_b_stride(kBN)];
    }
    // the slice's 12 products a fragment start from zero and are added to
    // acc in f32 (round to nearest): the tensor cores truncate what they
    // add to a running sum, an error that would grow with K
    float part[4][kNT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
    gemm_compute_stage<kATrans, kBN>(slot, part);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
  cp_async_wait<0>();
}

// gemm_tile_staged over A [M, K] (or [K, M] with kATrans) and B [K, N] as
// they lie in memory.
template <bool kATrans, bool kColSums, int kBN>
__device__ __forceinline__ void gemm_tile(const float* A, int lda, const float* B, int ldb, int M,
                                          int N, int m0, int n0, int k_begin, int k_end,
                                          float* smem, float (&acc)[4][gemm_nt<kBN>()][4],
                                          float& csum) {
  gemm_tile_staged<kATrans, kColSums, kBN>(
      [&](int k0, float* slot) {
        gemm_load_stage<kATrans, kBN>(A, lda, B, ldb, M, N, m0, n0, k0, k_end, slot);
      },
      k_begin, k_end, smem, acc, csum);
}

// Visit the thread's outputs of a tile: f(row, col, v0, v1) for the pairs
// (row, col), (row, col + 1) inside [M, N) (col is even and N % 4 == 0, so
// both or neither lie inside).
template <int kBN, class F>
__device__ __forceinline__ void gemm_for_each_output(const float (&acc)[4][gemm_nt<kBN>()][4],
                                                     int M, int N, int m0, int n0, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = m0 + (warp >> 2) * 64, wn = n0 + (warp & 3) * (kBN / 4);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < gemm_nt<kBN>(); ++nt) {
      const int col = wn + nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm + mt * 16 + g + 8 * half;
        if (row < M && col < N) f(row, col, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
}

}  // namespace focal
