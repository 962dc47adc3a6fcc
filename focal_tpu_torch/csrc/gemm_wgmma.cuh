// Matrix products on Hopper's warpgroup tensor-core path (sm_90a): bf16
// operands staged by the Tensor Memory Accelerator (TMA) into a ring of
// shared-memory stages, consumed by wgmma.mma_async with f32 sums in
// registers. The core of the fused MLP's bf16 kernels (#10-bf16 to #12-bf16,
// fused_mlp.cu), of the bf16 whole-block kernels' products (#1-bf16 to
// #5-bf16, window_block.cu) and of the bf16 conv tower's (#13-bf16,
// #14-bf16, conv_tower.cu).
//
// Layout. Every staged tile is bf16 in 128-byte rows with the 128-byte
// swizzle (16-byte chunk c of row r stored at chunk c ^ (r % 8)): TMA writes
// it so (CU_TENSOR_MAP_SWIZZLE_128B, a box 64 values wide) and wgmma reads
// it so (layout type 1 in the matrix descriptor). An operand lies either
// K-major (its K index runs along the 128-byte rows: A [M, K] or B^T [N, K]
// as they lie) or MN-major (its M or N index runs along them: A^T [K, M] or
// B [K, N] as they lie); wgmma takes either for bf16 (its transpose bits),
// so each array in device memory serves every product it feeds as it lies.
//   K-major, a tile [rows][64]: row r at r * 128 bytes; the descriptor's
//     stride byte offset (SBO) is 1,024 (eight rows), its leading byte
//     offset unused; K step k of 16 values starts 32 k bytes in.
//   MN-major, boxes [64 K rows][64] side by side: K row k of box b at
//     b * 8,192 + k * 128 bytes; SBO 1,024 (eight K rows), leading byte
//     offset (LBO) 8,192 (the next 64 M or N values); K step k starts
//     2,048 k bytes in.
// Each tile starts on a 1,024-byte boundary, so the swizzle phase of a row
// is r % 8 for TMA and wgmma alike.
//
// Roles. A block is two consumer warpgroups (threads 0-255: rows 0-63 and
// 64-127 of the block's 128-row tile) and one producer warpgroup (threads
// 256-383) whose first thread issues every TMA copy; setmaxnreg moves the
// producer's registers to the consumers (40 and 232 a thread). A stage
// has a "full" mbarrier (the producer's expected bytes, completed by TMA)
// and an "empty" one (one arrival a consumer warpgroup once its wgmma has
// read the stage). Rows, columns or K past an array's edge are zeros (TMA's
// fill), so ragged tiles need no padding; outputs past the edge are masked
// by the caller's epilogue.
//
// The accumulator of m64nNk16 (f32, N / 2 registers a thread): register i of
// thread t (warp w = t / 32 of its warpgroup, lane l) holds row 16 w + l / 4
// + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2. For bf16 those
// registers, rounded in pairs, are the A fragment of a register-A wgmma
// over the same rows (FlashAttention-3 feeds P so): k step s takes
// registers 8 s .. 8 s + 7.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace focal {
namespace wg {

constexpr int kBM = 128;             // rows of a block tile: two consumer warpgroups
constexpr int kBK = 64;              // K of a stage: one 128-byte row of bf16
constexpr int kThreads = 384;        // two consumer warpgroups, one producer warpgroup
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kBoxBytes = 64 * 128;  // an MN-major box: 64 K rows of 128 bytes

// This thread's warpgroup, broadcast from lane 0 so that the compiler
// knows it alike across the warp (a wgmma in a path it cannot prove
// warp-uniform is serialized).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 7), 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------------------
// mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to TMA (the async proxy).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 2-D tensor map at (column c0, row c1) into shared memory,
// completing `bar`'s expected bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, "
      "%4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// One box of a 3-D tensor map at (c0, c1, c2), c0 the contiguous axis; a
// coordinate may lie outside the map (negative, or past its extent): TMA
// fills what it does not find with zeros.
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                          int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, "
      "%4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box from shared memory to a 2-D tensor map at (column c0, row c1)
// (rows and columns past the map's edges are not written), in the issuing
// thread's bulk group; tma_store_wait_read waits until the thread's groups
// have read their shared memory. fence_async_smem makes the calling thread's
// plain shared-memory writes visible to TMA before a barrier.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
// The same to a 3-D tensor map at (c0, c1, c2): coordinates past the map's
// extent are not written.
__device__ __forceinline__ void tma_store3(const CUtensorMap* map, const void* src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A bf16 pair (columns col, col + 1) of row `row` into a tile staged for
// TMA stores: box_rows rows by 64-column boxes, each [box_rows][128 bytes]
// with the 128-byte swizzle (as TMA loads write them).
__device__ __forceinline__ void stage_pair(uint8_t* tile, int row, int col, uint32_t v,
                                           int box_rows = kBM) {
  *reinterpret_cast<uint32_t*>(tile + (col >> 6) * (box_rows * 128) + row * 128 +
                               ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2) = v;
}

// An f32 pair (columns col, col + 1; col even) of row `row` into a tile
// staged for TMA stores: kBM-row boxes of 32 columns (128 bytes), each
// [kBM][128 bytes] with the 128-byte swizzle.
__device__ __forceinline__ void stage_pair_f32(uint8_t* tile, int row, int col, float2 v) {
  *reinterpret_cast<float2*>(tile + (col >> 5) * (kBM * 128) + row * 128 +
                             ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4) = v;
}

// The threads of warpgroup 0 only (named barrier 2).
__device__ __forceinline__ void warpgroup0_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned, completing `bar`'s expected bytes (a bulk copy: no tensor map).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The 256 consumer threads only (named barrier 1; the producer warpgroup
// takes no part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void set_max_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void set_max_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---------------------------------------------------------------------------
// wgmma

__device__ __forceinline__ void mma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps registers that an asynchronous wgmma reads or writes where they are
// until this point (no copy, no reuse, no reordering across it).
template <int kN>
__device__ __forceinline__ void hold(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int kN>
__device__ __forceinline__ void hold(uint32_t (&r)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// K step k (16 values) of a tile staged K-major or MN-major (see above).
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int k) {
  return desc(tile + 32 * k, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int k) {
  return desc(tile + 2048 * k, kBoxBytes, 1024);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma.mma_async m64nNk16, bf16 operands, f32 sums: Mma<N>::ss (A and B
// by descriptor; kTA, kTB 1 for an MN-major operand; N 64 and 128) and
// Mma<N>::rs (A the register fragment; N 64 to 256). `accumulate` 0
// overwrites d.
template <int N>
struct Mma;

template <>
struct Mma<64> {
  // d (+)= A B, A and B read from shared memory by descriptors.
  template <int kTA, int kTB>
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB));
  }
  // d (+)= A B, A from registers (the m64k16 bf16 fragment), B by descriptor.
  template <int kTB>
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(kTB));
  }
};

template <>
struct Mma<128> {
  // d (+)= A B, A and B read from shared memory by descriptors.
  template <int kTA, int kTB>
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate), "n"(kTA), "n"(kTB));
  }
  // d (+)= A B, A from registers (the m64k16 bf16 fragment), B by descriptor.
  template <int kTB>
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(kTB));
  }
};

template <>
struct Mma<192> {
  // d (+)= A B, A from registers (the m64k16 bf16 fragment), B by descriptor.
  template <int kTB>
  __device__ __forceinline__ static void rs(float (&d)[96], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
        "{%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(kTB));
  }
};

template <>
struct Mma<256> {
  // d (+)= A B, A from registers (the m64k16 bf16 fragment), B by descriptor.
  template <int kTB>
  __device__ __forceinline__ static void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(kTB));
  }
};

// Row and column, within the block's 128-row tile, of accumulator register
// i (and i + 1: the next column) of this consumer thread.
struct Frag {
  int row0, col0;
  __device__ __forceinline__ Frag() {
    const int t = threadIdx.x & 127;
    row0 = 64 * (int)(threadIdx.x >> 7) + 16 * (t >> 5) + ((t & 31) >> 2);
    col0 = 2 * (t & 3);
  }
  __device__ __forceinline__ int row(int i) const { return row0 + 8 * ((i >> 1) & 1); }
  __device__ __forceinline__ int col(int i) const { return col0 + 8 * (i >> 2); }
};

__device__ __forceinline__ uint8_t* align1024(void* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The ring of a streamed product: kStages stages, each an A tile of kBM
// rows by kBK of K and a B tile of kBN columns by kBK, K-major or MN-major
// (kAT, kBT); their full and empty barriers after the tiles.
template <int kBN, bool kAT, bool kBT, int kStages>
struct Ring {
  static_assert(kBN == 64 || kBN == 128, "64- or 128-column tiles");
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = kBN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 16 * kStages;

  uint8_t* tiles;
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ explicit Ring(void* smem) {
    tiles = align1024(smem);
    full = reinterpret_cast<uint64_t*>(tiles + kStages * kStageBytes);
    empty = full + kStages;
  }

  __device__ __forceinline__ void init() const {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    mbar_fence_init();
  }

  __device__ __forceinline__ uint8_t* a(int s) const { return tiles + s * kStageBytes; }
  __device__ __forceinline__ uint8_t* b(int s) const { return a(s) + kABytes; }

  // Producer: the tiles of K from k (A's rows or columns from m0 of M, B's
  // columns or rows from n0 of N) into stage `it` of the ring, once the
  // consumers have released its last use. An MN-major box wholly past M or
  // N is not loaded: the outputs it would feed are masked.
  __device__ __forceinline__ void load(int it, const CUtensorMap* ma, const CUtensorMap* mb, int m0,
                                       int M, int n0, int N, int k) const {
    const int s = it % kStages;
    if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
    const int a_boxes = kAT ? (m0 + 64 < M ? 2 : 1) : 0;
    const int b_boxes = kBT ? min(kBN / 64, (N - n0 + 63) / 64) : 0;
    mbar_expect_tx(&full[s], (kAT ? a_boxes * kBoxBytes : kABytes) +
                                 (kBT ? b_boxes * kBoxBytes : kBBytes));
    if (kAT) {
      for (int i = 0; i < a_boxes; ++i) tma_load(a(s) + i * kBoxBytes, ma, &full[s], m0 + 64 * i, k);
    } else {
      tma_load(a(s), ma, &full[s], k, m0);
    }
    if (kBT) {
      for (int i = 0; i < b_boxes; ++i) tma_load(b(s) + i * kBoxBytes, mb, &full[s], n0 + 64 * i, k);
    } else {
      tma_load(b(s), mb, &full[s], k, n0);
    }
  }

  // Consumer warpgroup: acc (+)= its 64 rows of stage `it`'s A times its B,
  // four k steps, issued and committed (not waited for).
  __device__ __forceinline__ void mma(int it, float (&acc)[kBN / 2], bool accumulate) const {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    // the warpgroup's 64 rows of a K-major A, or its 64-column box of an
    // MN-major one: 8 KB in either case
    const uint8_t* ta = a(s) + (threadIdx.x >> 7) * (kABytes / 2);
    mma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k) {
      const uint64_t da = kAT ? desc_mn(ta, k) : desc_k(ta, k);
      const uint64_t db = kBT ? desc_mn(b(s), k) : desc_k(b(s), k);
      Mma<kBN>::template ss<kAT ? 1 : 0, kBT ? 1 : 0>(acc, da, db, (accumulate || k > 0) ? 1 : 0);
    }
    mma_commit();
  }

  // The consumer warpgroup is done with stage `it` (its wgmma has completed).
  __device__ __forceinline__ void release(int it) const {
    if ((threadIdx.x & 127) == 0) mbar_arrive(&empty[it % kStages]);
  }
};

// One output tile of a streamed product: kPasses products over the same
// kBM x kBN tile (rows m0 of M, columns n0 of N), one after the other,
// acc[p] = A_p B_p over K [k0, k0 + 64 k_tiles), A_p and B_p read through
// the maps a[p], b[p]. `problem` says which problem of a two-problem launch
// the tile belongs to (0 where there is one).
template <int kPasses>
struct Job {
  const CUtensorMap* a[kPasses];
  const CUtensorMap* b[kPasses];
  int m0, M, n0, N, k0, k_tiles;
  int problem;
};

// A persistent block's share of `tiles` output tiles (blockIdx.x, then every
// gridDim.x-th): plan(tile) gives a tile's Job<kPasses>. The producer
// warpgroup streams the tiles' stages, running ahead into the next tile's
// while the consumers finish one; the consumer warpgroups multiply, one
// wgmma group in flight while the next stage is awaited, then run
// epi(job, acc) on the finished tile. Jobs of problem 1 read their B in
// kBT1's order (both orders stage the same bytes a stage): each order's
// tile is a whole wgmma pipeline of its own, from its first group to its
// last wait, so the branch between them splits no pipeline. Call with all
// kThreads threads and Ring's kSmemBytes of dynamic shared memory (more for
// the epilogue's own).
template <int kBN, bool kAT, bool kBT, int kStages, int kPasses, bool kBT1 = kBT, class Plan,
          class Epi>
__device__ __forceinline__ void streamed_tiles(void* smem, int tiles, const Plan& plan,
                                               const Epi& epi) {
  using R0 = Ring<kBN, kAT, kBT, kStages>;
  using R1 = Ring<kBN, kAT, kBT1, kStages>;
  const R0 ring(smem);
  const R1 ring1(smem);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    set_max_regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const Job<kPasses> j = plan(tile);
        for (int p = 0; p < kPasses; ++p)
          for (int kt = 0; kt < j.k_tiles; ++kt, ++it) {
            if (kBT1 != kBT && j.problem)
              ring1.load(it, j.a[p], j.b[p], j.m0, j.M, j.n0, j.N, j.k0 + kt * kBK);
            else
              ring.load(it, j.a[p], j.b[p], j.m0, j.M, j.n0, j.N, j.k0 + kt * kBK);
          }
      }
    }
  } else {
    set_max_regs_inc<kConsumerRegs>();
    float acc[kPasses][kBN / 2];
    int it = 0;
    // one tile's products through ring r
    auto multiply = [&](const auto& r, const Job<kPasses>& j) {
      const int it0 = it;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        for (int kt = 0; kt < j.k_tiles; ++kt, ++it) {
          r.mma(it, acc[p], kt > 0);
          mma_wait<1>();
          if (it > it0) r.release(it - 1);
        }
      }
      mma_wait<0>();
#pragma unroll
      for (int p = 0; p < kPasses; ++p) hold(acc[p]);
      r.release(it - 1);
    };
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const Job<kPasses> j = plan(tile);
      if (kBT1 != kBT && j.problem)
        multiply(ring1, j);
      else
        multiply(ring, j);
      epi(j, acc);
    }
  }
}

// No producer work between tiles (streamed_tiles_by's default).
struct NoTileHook {
  template <class Job>
  __device__ __forceinline__ void operator()(const Job&) const {}
};

// streamed_tiles with one pass a tile and the producer's copies the
// caller's: plan(tile) gives a job with a k_tiles member, and load(ring,
// stage, job, kt) issues K tile kt's copies into ring.a(stage) and
// ring.b(stage), their bytes expected on ring.full[stage], once the ring has
// freed the stage; after(job), the producer's after a tile's stages (the
// copies an epilogue reads, on barriers of the caller's). For operands that
// a 2-D box cannot cut, such as the conv tower's rows read through a 3-D
// map of whole samples (conv_tower.cu). The consumers run as in
// streamed_tiles, then epi(job, acc).
template <int kBN, bool kAT, bool kBT, int kStages, class Plan, class Load, class Epi,
          class After = NoTileHook>
__device__ __forceinline__ void streamed_tiles_by(void* smem, int tiles, const Plan& plan,
                                                  const Load& load, const Epi& epi,
                                                  const After& after = After()) {
  using R = Ring<kBN, kAT, kBT, kStages>;
  const R ring(smem);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    set_max_regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const auto j = plan(tile);
        for (int kt = 0; kt < j.k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&ring.empty[s], ((it / kStages) & 1) ^ 1);
          load(ring, s, j, kt);
        }
        after(j);
      }
    }
  } else {
    set_max_regs_inc<kConsumerRegs>();
    float acc[kBN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const auto j = plan(tile);
      const int it0 = it;
      for (int kt = 0; kt < j.k_tiles; ++kt, ++it) {
        ring.mma(it, acc, kt > 0);
        mma_wait<1>();
        if (it > it0) ring.release(it - 1);
      }
      mma_wait<0>();
      hold(acc);
      ring.release(it - 1);
      epi(j, acc);
    }
  }
}

// The stages of a streamed product's ring: ~192 KB of shared memory.
template <int kBN>
constexpr int kStreamStages = kBN == 128 ? 6 : 8;

template <int kBN, bool kAT, bool kBT>
constexpr size_t stream_smem(size_t extra = 0) {
  return Ring<kBN, kAT, kBT, kStreamStages<kBN>>::kSmemBytes + extra;
}

// ---------------------------------------------------------------------------
// weight gradients over fixed row splits, and the ordered reduction: the
// bf16 backwards' shared last phases (fused_mlp.cu's #12-bf16,
// window_block.cu's #3-bf16 and #5-bf16; conv_tower.cu's #14-bf16 takes
// the reduction and the split plan). Src is a tag type of the
// including library, so that a profile's kernel names say who launched
// them.

// Two weight gradients A0^T B0 [M0, N0] and A1^T B1 [M1, N1] over the same
// rows, every operand [rows, M] or [rows, N] bf16 read MN-major as it lies,
// over fixed row splits (rows_per_split a multiple of kBK); tile t of the
// launch is split t / (tiles0 + tiles1), then problem 0's tiles0 tiles,
// then problem 1's. Each tile writes its split's partial, part + split E
// (E = M0 N0 + M1 N1: problem 0, then problem 1); with `accumulate` it
// adds to it (a later row chunk of the same splits, still one fixed order).
struct WgradArgs {
  float* part;
  int rows, M0, N0, M1, N1, rows_per_split, splits;
  int accumulate;
};

// Output tiles of a weight-gradient split: problem 0's, then problem 1's.
__host__ __device__ inline int wgrad_tiles(int M, int N, int bn) {
  return (M + kBM - 1) / kBM * ((N + bn - 1) / bn);
}

template <int kBN, class Src>
__global__ void __launch_bounds__(kThreads, 1)
wg_wgrad_kernel(const __grid_constant__ CUtensorMap ma0, const __grid_constant__ CUtensorMap mb0,
                const __grid_constant__ CUtensorMap ma1, const __grid_constant__ CUtensorMap mb1,
                const WgradArgs p) {
  extern __shared__ uint8_t smem_raw[];
  const int tn0 = (p.N0 + kBN - 1) / kBN, tn1 = (p.N1 + kBN - 1) / kBN;
  const int tiles0 = wgrad_tiles(p.M0, p.N0, kBN);
  const int per_split = tiles0 + wgrad_tiles(p.M1, p.N1, kBN);
  const size_t e0 = (size_t)p.M0 * p.N0, E = e0 + (size_t)p.M1 * p.N1;
  auto plan = [&](int tile) {
    const int split = tile / per_split, t = tile % per_split;
    const bool second = t >= tiles0;
    const int tt = second ? t - tiles0 : t, tn = second ? tn1 : tn0;
    const int k0 = split * p.rows_per_split;
    const int k_tiles = (min(p.rows, k0 + p.rows_per_split) - k0 + kBK - 1) / kBK;
    return Job<1>{{second ? &ma1 : &ma0}, {second ? &mb1 : &mb0}, tt / tn * kBM,
                  second ? p.M1 : p.M0, tt % tn * kBN, second ? p.N1 : p.N0, k0, k_tiles,
                  second ? 1 : 0};
  };
  auto epi = [&](const Job<1>& j, float (&acc)[1][kBN / 2]) {
    const Frag f;
    const int split = j.k0 / p.rows_per_split;
    float* out = p.part + (size_t)split * E + (j.problem ? e0 : 0);
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2) {
      const int m = j.m0 + f.row(i), n = j.n0 + f.col(i);
      if (m >= j.M || n >= j.N) continue;
      float2* dst = reinterpret_cast<float2*>(out + (size_t)m * j.N + n);
      float2 v = make_float2(acc[0][i], acc[0][i + 1]);
      if (p.accumulate) {
        const float2 o = *dst;
        v = make_float2(o.x + v.x, o.y + v.y);
      }
      *dst = v;
    }
  };
  streamed_tiles<kBN, true, true, kStreamStages<kBN>, 1>(smem_raw, p.splits * per_split, plan, epi);
}

// The fewest row splits (rows_per_split a multiple of kBK) that give a
// weight-gradient launch of `wtiles` tiles a split its least span on `sms`
// persistent blocks (waves of tiles times a tile's kBK-row stages), which
// also keeps the partials few.
struct WgradSplits {
  int splits, rows_per_split;
};

inline WgradSplits wgrad_splits(int rows, int wtiles, int sms) {
  WgradSplits w{1, rows};
  const int max_splits = std::max(1, std::min((rows + 255) / 256, 8 * sms / wtiles + 1));
  long long best = -1;
  for (int s = 1; s <= max_splits; ++s) {
    const int rps = ((rows + s - 1) / s + kBK - 1) / kBK * kBK;
    const int splits = (rows + rps - 1) / rps;
    const long long span = (long long)((splits * wtiles + sms - 1) / sms) * (rps / kBK);
    if (best < 0 || span < best) {
      best = span;
      w.rows_per_split = rps;
      w.splits = splits;
    }
  }
  return w;
}

// out = [W0 | b0 | W1 | b1 | x]: the weight gradients (M0 N0 and M1 N1
// values) summed over the splits in split order (one thread an element);
// the bias sums b0 (N0 values) and b1 (N1) and, where xn > 0, one more
// vector x (xn values, at xout) from their partials [tiles][n], each over
// the tiles in eight consecutive slices (a warp a slice, 32 columns a
// block), the slices then added in order.
struct ReduceArgs {
  const float* wpart;   // [splits][M0 N0 + M1 N1]
  const float* b0part;  // [tiles][N0]
  const float* b1part;  // [tiles][N1]
  const float* xpart;   // [tiles][xn] or null
  float* out;
  float* xout;
  int splits, tiles, M0, N0, M1, N1, xn;
};

constexpr int kReduceThreads = 256;

template <class Src>
__global__ void __launch_bounds__(kReduceThreads) wg_reduce_kernel(const ReduceArgs p) {
  const size_t e0 = (size_t)p.M0 * p.N0, E = e0 + (size_t)p.M1 * p.N1;
  const int wblocks = (int)((E + kReduceThreads - 1) / kReduceThreads);
  if ((int)blockIdx.x < wblocks) {
    const size_t e = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
    if (e >= E) return;
    float a = 0.f;
    for (int s = 0; s < p.splits; ++s) a += p.wpart[(size_t)s * E + e];
    p.out[e < e0 ? e : e + p.N0] = a;
    return;
  }
  __shared__ float red[kReduceThreads / 32][32];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5, slices = kReduceThreads / 32;
  const int col = (blockIdx.x - wblocks) * 32 + lane;
  const int nb = p.N0 + p.N1;
  const int which = col < p.N0 ? 0 : col < nb ? 1 : 2;
  const bool in = col < nb + p.xn;
  const int n = which == 0 ? p.N0 : which == 1 ? p.N1 : p.xn;
  const int cc = which == 0 ? col : which == 1 ? col - p.N0 : col - nb;
  const float* part = which == 0 ? p.b0part : which == 1 ? p.b1part : p.xpart;
  const int per = (p.tiles + slices - 1) / slices;
  float a = 0.f;
  if (in)
    for (int t = slice * per; t < min(p.tiles, (slice + 1) * per); ++t) a += part[(size_t)t * n + cc];
  red[slice][lane] = a;
  __syncthreads();
  if (slice == 0 && in) {
    float s = 0.f;
    for (int k = 0; k < slices; ++k) s += red[k][lane];
    if (which == 2)
      p.xout[cc] = s;
    else
      p.out[which == 0 ? e0 + cc : E + p.N0 + cc] = s;
  }
}

// ---------------------------------------------------------------------------
// host side

// One launch of a kernel here (kThreads threads a block) with `smem` bytes
// of dynamic shared memory; 0 or the CUDA error.
template <class Kernel, class... Args>
int launch(Kernel kernel, int grid, size_t smem, cudaStream_t s, const Args&... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// wg_wgrad_kernel over a.splits splits in bn-wide tiles (128 or 64),
// persistent over min(tiles, sms) blocks; m: the maps of A0, B0, A1, B1,
// each with 64-row boxes.
template <class Src>
int launch_wgrad(const CUtensorMap (&m)[4], const WgradArgs& a, int bn, int sms, cudaStream_t s) {
  const int tiles = a.splits * (wgrad_tiles(a.M0, a.N0, bn) + wgrad_tiles(a.M1, a.N1, bn));
  if (bn == 128)
    return launch(wg_wgrad_kernel<128, Src>, std::min(tiles, sms), stream_smem<128, true, true>(),
                  s, m[0], m[1], m[2], m[3], a);
  return launch(wg_wgrad_kernel<64, Src>, std::min(tiles, sms), stream_smem<64, true, true>(), s,
                m[0], m[1], m[2], m[3], a);
}

// wg_reduce_kernel over its outputs.
template <class Src>
int launch_reduce(const ReduceArgs& a, cudaStream_t s) {
  const size_t E = (size_t)a.M0 * a.N0 + (size_t)a.M1 * a.N1;
  const int grid =
      (int)((E + kReduceThreads - 1) / kReduceThreads) + (a.N0 + a.N1 + a.xn + 31) / 32;
  wg_reduce_kernel<Src><<<grid, kReduceThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace focal

// Host side: the tensor map of a bf16 matrix [rows, cols] in device memory
// (cols contiguous, a multiple of 8; 16-byte aligned), or with `f32` of an
// f32 one (cols a multiple of 4), read or written in boxes of 128 bytes of
// a row (64 bf16 or 32 f32 columns) by box_rows rows, with the 128-byte
// swizzle; reads past its edges give zeros, writes past them are dropped.
// Returns 0 or libcuda's CUresult (CUDA_ERROR_NOT_FOUND without its
// cuTensorMapEncodeTiled, which is looked up in the loaded libcuda at first
// use, so the library links no libcuda itself).
using FocalWgEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or null.
inline FocalWgEncode focal_wg_encode() {
  static const FocalWgEncode encode = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<FocalWgEncode>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return encode;
}

inline int focal_wg_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                        bool f32 = false) {
  const FocalWgEncode encode = focal_wg_encode();
  if (!encode) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {f32 ? 32u : 64u, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1u, 1u};
  return (int)encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     2, const_cast<void*>(base), dims,
                     strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The 3-D form: a bf16 array [d2, d1, d0] (d0 contiguous, a multiple of 8;
// 16-byte aligned) in boxes of 64 values of d0 (128 bytes) by box1 of d1 by
// box2 of d2 (each at most 256), stored in shared memory as box1 * box2
// rows of 128 bytes (d1 the faster), with the 128-byte swizzle: a box of
// whole samples of the conv tower's rows [R, S, C], or a tap's slice of its
// weights [KW, cin, C]. Reads past an edge (a negative coordinate among
// them) give zeros, writes past one are dropped.
inline int focal_wg_map3(CUtensorMap* map, const void* base, int d2, int d1, int d0, int box2,
                         int box1) {
  const FocalWgEncode encode = focal_wg_encode();
  if (!encode) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 2, (cuuint64_t)d0 * d1 * 2};
  const cuuint32_t box[3] = {64u, (cuuint32_t)box1, (cuuint32_t)box2};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                     strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

namespace focal {
namespace wg {

constexpr int kMapError = 100000;  // + libcuda's CUresult: a tensor map was refused

// focal_wg_map, its refusal as kMapError + the CUresult.
inline int map(CUtensorMap* m, const void* base, int rows, int cols, int box_rows,
               bool f32 = false) {
  const int r = focal_wg_map(m, base, rows, cols, box_rows, f32);
  return r == 0 ? 0 : kMapError + r;
}

// focal_wg_map3, its refusal as kMapError + the CUresult.
inline int map3(CUtensorMap* m, const void* base, int d2, int d1, int d0, int box2, int box1) {
  const int r = focal_wg_map3(m, base, d2, d1, d0, box2, box1);
  return r == 0 ? 0 : kMapError + r;
}

}  // namespace wg
}  // namespace focal
