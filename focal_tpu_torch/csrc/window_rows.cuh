// Row-parallel window attention: the device helpers that the attention-only
// kernels (#6-#9, window_attention.cu) and the attention phase of the
// window-block training kernels (#2-#5 and their bf16 forms, window_block.cu)
// share. A block owns P consecutive (window, head) pairs of [B, H, N, hd]
// operands; G lanes serve one query row; scores and softmax stay in
// registers (the design note of window_attention.cu). #6-#9 and the bf16
// whole-block kernels (the forward #1-, #2-, #4-bf16 and the backward
// #3-bf16, #5-bf16) also share the staging of a persistent grid's chunks of
// P pairs into a two-slot cp.async ring (Operands, stage_chunk_async), the
// stores and the exact 9-key row tile (kN = 9); ring_walk is that walk as a
// function, which the bf16 whole-block kernels run (#6-#9 keep the same
// loop inline).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

#include "gemm_3xtf32.cuh"

namespace focal {

constexpr int kAttnMaxN = 16;      // window tokens a thread keeps in registers
constexpr int kAttnMaxHd = 256;    // widest head
constexpr int kAttnMaxLanes = 8;   // lanes a query row may take
constexpr int kAttnThreads = 256;  // threads of every block that uses these helpers
constexpr unsigned kAttnFull = 0xffffffffu;

// Element strides of a [B, H, N, hd] operand whose hd axis is contiguous.
struct Strides {
  long long b, h, n;
};

// Launch geometry of a (B, H, N, hd) call.
struct Geo {
  int B, H, N, hd, c4;  // c4 = ceil(hd / 4) float4 columns
  int lanes;            // G: lanes a query row takes
  int pairs;            // P: (window, head) pairs a block stages at once
  int stride;           // shared-memory row stride in floats, 4 c4 + 4
  long long total;      // B * H pairs
};

inline Geo make_geo(int B, int H, int N, int hd) {
  Geo g;
  g.B = B, g.H = H, g.N = N, g.hd = hd, g.c4 = (hd + 3) / 4;
  int lanes = 1;  // a power of two dividing c4, at least two columns a lane
  while (2 * lanes <= kAttnMaxLanes && g.c4 % (2 * lanes) == 0 && 4 * lanes <= g.c4) lanes *= 2;
  g.lanes = lanes;
  g.pairs = std::max(1, kAttnThreads / (N * lanes));
  g.stride = 4 * g.c4 + 4;
  g.total = (long long)B * H;
  return g;
}

// The first float of row r = (pair - p0) * N + i of the block's pairs in
// `src`.
__device__ __forceinline__ const float* pair_row(const float* src, Strides st, int p0, int r,
                                                 const Geo& g) {
  const int pl = r / g.N, i = r - pl * g.N;
  const int pair = p0 + pl;
  const int b = pair / g.H, h = pair - b * g.H;
  return src + b * st.b + h * st.h + i * st.n;
}

// Stage the rows of pairs p0 .. p0 + np - 1 of `src` into shared memory, row
// r = (pair - p0) * N + i at dst + r * S, float4 at a time. With kAnyHd, a
// head width that is not a multiple of 4 (the whole-block kernels take any)
// is read one float at a time and padded with zeros to 4 c4 columns; the
// attention-only kernels, which take multiples of 4 only, compile without
// that path (a branch in the float4 loop cost #8/#9 6-7 % on the H100).
template <bool kAnyHd = false>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, Strides st, int p0,
                                           int np, const Geo& g, float* dst) {
  const int c4 = g.c4;
  if (kAnyHd && g.hd % 4 != 0) {
    for (int e = threadIdx.x; e < np * g.N * c4; e += kAttnThreads) {
      const int r = e / c4, c = e - r * c4;
      const float* row = pair_row(src, st, p0, r, g);
      float t[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) t[k] = 4 * c + k < g.hd ? __ldg(row + 4 * c + k) : 0.f;
      *reinterpret_cast<float4*>(dst + r * g.stride + 4 * c) = make_float4(t[0], t[1], t[2], t[3]);
    }
    return;
  }
  for (int e = threadIdx.x; e < np * g.N * c4; e += kAttnThreads) {
    const int r = e / c4, c = e - r * c4;
    const float4* row = reinterpret_cast<const float4*>(pair_row(src, st, p0, r, g));
    *reinterpret_cast<float4*>(dst + r * g.stride + 4 * c) = __ldg(row + c);
  }
}

// Whether key j of a row tile of kN keys is one of the row's N: a tile
// narrower than kAttnMaxN holds exactly N = kN keys (no test in its
// unrolled loops), the kAttnMaxN tile any N up to it.
template <int kN>
__device__ __forceinline__ bool key_in_row(int j, int N) {
  return kN < kAttnMaxN || j < N;
}

// f(c) for the float4 columns c = lane, lane + G, ... of a head: kCols of
// them, unrolled, where the caller knows that a lane takes exactly kCols
// (c4 = kCols G); with kCols 0 a loop up to c4.
template <int kCols, class F>
__device__ __forceinline__ void for_lane_cols(int lane, const Geo& g, F f) {
  if (kCols > 0) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) f(lane + k * g.lanes);
  } else {
    for (int c = lane; c < g.c4; c += g.lanes) f(c);
  }
}

// d[j] = a . b_j for j < N over hd floats, where a is one shared row and b_j
// the rows b0 + j * S: each of the G lanes sums its float4 columns, then a
// butterfly of shuffles adds the lanes (every lane ends with the same bits:
// each step adds the same two numbers, in either order). Every lane of the
// warp must call it.
template <int kCols = 0, int kN>
__device__ __forceinline__ void row_dots(const float* a, const float* b0, const Geo& g, int lane,
                                         float (&d)[kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) d[j] = 0.f;
  for_lane_cols<kCols>(lane, g, [&](int c) {
    const float4 x = *reinterpret_cast<const float4*>(a + 4 * c);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (key_in_row<kN>(j, g.N)) {
        const float4 y = *reinterpret_cast<const float4*>(b0 + j * g.stride + 4 * c);
        d[j] = fmaf(x.x, y.x, d[j]);
        d[j] = fmaf(x.y, y.y, d[j]);
        d[j] = fmaf(x.z, y.z, d[j]);
        d[j] = fmaf(x.w, y.w, d[j]);
      }
    }
  });
  for (int off = g.lanes / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (key_in_row<kN>(j, g.N)) d[j] += __shfl_xor_sync(kAttnFull, d[j], off);
  }
}

// p = exp(p - mx) / sum over the first N entries, mx their maximum.
template <int kN>
__device__ __forceinline__ void softmax_from_max(float (&p)[kN], float mx, int N) {
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (key_in_row<kN>(j, N)) {
      p[j] = expf(p[j] - mx);
      sum += p[j];
    }
  }
  const float inv = 1.f / sum;
#pragma unroll
  for (int j = 0; j < kN; ++j)
    if (key_in_row<kN>(j, N)) p[j] *= inv;
}

// p = softmax(p) over the first N entries, p holding the scores with their
// bias and mask added.
template <int kN>
__device__ __forceinline__ void softmax_scores(float (&p)[kN], int N) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kN; ++j)
    if (key_in_row<kN>(j, N)) mx = fmaxf(mx, p[j]);
  softmax_from_max(p, mx, N);
}

// p = softmax(s + rel_bias row + mask row) over the first N entries. The
// maximum is taken in the loop that adds the bias: in a loop of its own,
// #2/#3 took ~1.5 % longer on the H100.
template <int kN>
__device__ __forceinline__ void softmax_row(float (&p)[kN], const float* __restrict__ bias,
                                            const float* __restrict__ m, int N) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    if (key_in_row<kN>(j, N)) {
      p[j] += __ldg(bias + j);
      if (m) p[j] += __ldg(m + j);
      mx = fmaxf(mx, p[j]);
    }
  }
  softmax_from_max(p, mx, N);
}

// The thread's query row: threads tid = r * G + lane serve row r of the
// block's chunk; rows past the chunk (its last pairs, or threads past P N G)
// work on row 0 and write nothing, so every lane reaches the shuffles.
struct Row {
  bool active;
  int lane, r, pl, i, pair, w, h;
};

__device__ __forceinline__ Row thread_row(const Geo& g, int p0, int np) {
  Row t;
  const int r = threadIdx.x / g.lanes;
  t.lane = threadIdx.x - r * g.lanes;
  t.active = r < np * g.N;
  t.r = t.active ? r : 0;
  t.pl = t.r / g.N;
  t.i = t.r - t.pl * g.N;
  t.pair = p0 + t.pl;
  t.w = t.pair / g.H;
  t.h = t.pair - t.w * g.H;
  return t;
}

// ---------------------------------------------------------------------------
// the chunk walk and its ring

// The operands a chunk stages: q, k, v (the forward's three), g (the
// backward's fourth), each [B, H, N, hd] of T at its own element strides.
template <class T>
struct Operands {
  const T* src[4];
  Strides st[4];
};

// The pairs chunk `chunk` holds (the last may hold fewer than P).
__device__ __forceinline__ int chunk_pairs(const Geo& g, int chunk) {
  return (int)min((long long)g.pairs, g.total - (long long)chunk * g.pairs);
}

// 4 bytes from global to shared memory, asynchronously; zero where !valid.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}

// The staging of one chunk: cp.async copies of its rows of the first kOps
// f32 operands into a ring slot ([kOps][P][N][stride]), 16 bytes each.
// Thread tid copies float4 column tid % c4 of rows tid / c4, + R, + 2R, ...
// (R = kThreads / c4 rows a pass; c4 <= kThreads): the row's (pair, token)
// is found once for its kOps operands. With kAnyHd, any head width: float4
// column e % c4 of row e / c4 for e = tid, tid + kThreads, ..., copied 4
// bytes at a time (a width that is not a multiple of 4 leaves rows that are
// not 16-byte aligned), the columns past hd zero-filled.
template <int kOps, bool kAnyHd = false>
__device__ __forceinline__ void stage_chunk_async(const Operands<float>& in, int chunk,
                                                  const Geo& g, float* slot) {
  const int p0 = chunk * g.pairs, np = chunk_pairs(g, chunk);
  const int slab = g.pairs * g.N * g.stride;
  if (kAnyHd) {
    for (int e = threadIdx.x; e < np * g.N * g.c4; e += kAttnThreads) {
      const int r = e / g.c4, c = e - r * g.c4;
      const int pl = r / g.N, i = r - pl * g.N;
      const int pair = p0 + pl;
      const int b = pair / g.H, h = pair - b * g.H;
#pragma unroll
      for (int o = 0; o < kOps; ++o) {
        const float* row = in.src[o] + b * in.st[o].b + h * in.st[o].h + i * in.st[o].n;
        float* dst = slot + o * slab + r * g.stride + 4 * c;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool ok = 4 * c + k < g.hd;
          cp_async4(dst + k, ok ? row + 4 * c + k : row, ok);
        }
      }
    }
    return;
  }
  const int per_pass = kAttnThreads / g.c4;
  const int c = threadIdx.x % g.c4, r0 = threadIdx.x / g.c4;
  if (r0 >= per_pass) return;
  for (int r = r0; r < np * g.N; r += per_pass) {
    const int pl = r / g.N, i = r - pl * g.N;
    const int pair = p0 + pl;
    const int b = pair / g.H, h = pair - b * g.H;
#pragma unroll
    for (int o = 0; o < kOps; ++o) {
      const float* row = in.src[o] + b * in.st[o].b + h * in.st[o].h + i * in.st[o].n;
      cp_async16(slot + o * slab + r * g.stride + 4 * c, row + 4 * c, true);
    }
  }
}

// The walk of a persistent grid over a call's chunks of P (window, head)
// pairs: block b takes chunks b, b + grid, ... (the grid is at most one
// block a chunk). stage(chunk, slot) issues a chunk's cp.async copies into
// a slot of slot_floats floats at `ring`; once a thread's own copies have
// landed it runs land(chunk, slot) on them (the copies it made itself),
// then a barrier, then body(chunk, slot). With two slots the next chunk's
// copies fly while this one computes: the barrier after a chunk's copies
// land also frees the other slot, which the chunk before was read from, so
// they are issued right after it. With one slot (a head too wide for two)
// they are issued after the body and a second barrier.
template <class Stage, class Land, class Body>
__device__ __forceinline__ void ring_walk(const Geo& g, float* ring, int slot_floats, bool two_slots,
                                          const Stage& stage, const Land& land, const Body& body) {
  const int nchunks = (int)((g.total + g.pairs - 1) / g.pairs);
  stage(blockIdx.x, ring);
  cp_async_commit();
  int it = 0;
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x, ++it) {
    float* slot = ring + (two_slots ? (it & 1) * slot_floats : 0);
    cp_async_wait<0>();  // this thread's copies of the chunk have landed
    land(chunk, slot);
    __syncthreads();  // and every thread's; with two slots the other slot is free
    const int next = chunk + gridDim.x;
    if (two_slots) {
      if (next < nchunks)  // the next chunk's loads fly while this one computes
        stage(next, ring + ((it + 1) & 1) * slot_floats);
      cp_async_commit();
    }
    body(chunk, slot);
    if (!two_slots) {
      __syncthreads();  // the slot's readers are done
      if (next < nchunks) stage(next, ring);
      cp_async_commit();
    }
  }
}

// Four f32 results stored at p: as a float4, or rounded to bf16 (8 bytes).
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

// ---------------------------------------------------------------------------
// host side

// Raise a kernel's dynamic shared memory limit to `bytes` on the current
// device, never lowering it below what an earlier plan (the cached plans
// keep them) launches it with.
template <class Kernel>
inline cudaError_t raise_smem(Kernel kernel, size_t bytes) {
  static std::mutex mutex;
  static std::map<std::pair<int, const void*>, size_t> limits;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mutex);
  size_t& limit = limits[{dev, reinterpret_cast<const void*>(kernel)}];
  if (bytes <= limit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) limit = bytes;
  return err;
}

}  // namespace focal
