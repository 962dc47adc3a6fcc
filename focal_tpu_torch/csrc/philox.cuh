// Philox4x32-10 and the attention-dropout counter rule, shared by the port's
// CUDA sources (window_block.cu, window_attention.cu, fused_mlp.cu). One copy,
// so that kernels that must draw the same mask (#2, #4, #7, #9) cannot drift
// apart.
#pragma once

#include <cuda_runtime.h>

namespace focal {

// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011): four independent 32-bit words per (counter, key).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ uint2 philox_key(unsigned long long seed) {
  return make_uint2((unsigned)seed, (unsigned)(seed >> 32));
}

// Query rows a head's counters span: the counter row of (head h, query i) is
// h * kAttnCounterRows + i, so windows of up to 16 tokens never share one.
constexpr int kAttnCounterRows = 16;

// Attention dropout's Philox words for keys 4 jb .. 4 jb + 3 of one (window,
// head, query row): counter (window, head * kAttnCounterRows + row, jb, 0)
// under the seed's key. Key j is kept iff word j % 4 of block j / 4 is >=
// the threshold: the flags are a function of (seed, window, head, row)
// alone, whatever kernel or block shape draws them.
__device__ __forceinline__ uint4 attn_keep_words(uint2 key, unsigned window, int head, int row,
                                                 int jb) {
  return philox4x32_10(
      make_uint4(window, (unsigned)(head * kAttnCounterRows + row), (unsigned)jb, 0u), key);
}

// The keep flags of keys 0..n-1 of one (window, head, query row).
template <int kMaxKeys>
__device__ __forceinline__ void attn_keep_row(unsigned long long seed, unsigned window, int head,
                                              int row, int n, unsigned threshold,
                                              bool (&kept)[kMaxKeys]) {
  static_assert(kMaxKeys % 4 == 0 && kMaxKeys <= kAttnCounterRows, "keys come four to a word");
  const uint2 key = philox_key(seed);
#pragma unroll
  for (int jb = 0; jb < kMaxKeys / 4; ++jb) {
    if (jb * 4 < n) {
      const uint4 r = attn_keep_words(key, window, head, row, jb);
      const unsigned bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) kept[jb * 4 + t] = bits[t] >= threshold;
    }
  }
}

// The keep flags of keys 0..N-1 of one (window, head, query row), as bit j
// of the result, with the G lanes of the row sharing the Philox words: lane
// l draws blocks jb = l, l + G, ... of attn_keep_words (so the bits are
// attn_keep_row's) and a butterfly of shuffles ORs the lanes' bits. Every
// lane of the warp must call it.
__device__ __forceinline__ unsigned keep_bits_row(unsigned long long seed, unsigned window,
                                                  int head, int row, int N, unsigned threshold,
                                                  int lane, int lanes) {
  const uint2 key = philox_key(seed);
  unsigned bits = 0u;
  for (int jb = lane; jb * 4 < N; jb += lanes) {
    const uint4 r = attn_keep_words(key, window, head, row, jb);
    bits |= (r.x >= threshold ? 1u : 0u) << (4 * jb);
    bits |= (r.y >= threshold ? 2u : 0u) << (4 * jb);
    bits |= (r.z >= threshold ? 4u : 0u) << (4 * jb);
    bits |= (r.w >= threshold ? 8u : 0u) << (4 * jb);
  }
  for (int off = lanes / 2; off > 0; off >>= 1) bits |= __shfl_xor_sync(0xffffffffu, bits, off);
  return bits;
}

}  // namespace focal
