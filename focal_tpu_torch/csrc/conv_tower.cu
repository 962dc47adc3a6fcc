// DeepSense conv tower for Hopper (sm_90a), train mode: the forward (#13)
// and the backward (#14) of a chain of ConvLayer2D blocks.
//
// Replaces the TPU kernels of focal_tpu/ops/conv_tower.py:
//   #13 _conv0_kernel (_conv0_call -> pl.pallas_call) and _apply_kernel
//       (_apply_call -> pl.pallas_call)
//   #14 _bwd_stats_kernel, _bwd_apply_kernel and _bwd_dc_kernel
//       (_bwd_stats_call, _bwd_apply_call, _bwd_dc_call -> pl.pallas_call)
// Activations are [R*S, C] f32 row-major: row g = r*S + s, r a (sample,
// interval) row, s a spectrum position, channels contiguous. Layer k:
//   c_k = conv(a_{k-1}, W_k) + b_k   1 x KW taps, SAME: tap j reads position
//                                    s + j - (KW-1)/2, zero outside [0, S)
//   y   = c_k A + B                  A = invstd*scale, B = bias - mu*A (batch stats)
//   a_k = GELU(y) * mask[sample] (+ a_{k-1})
// with W_k [KW*Cin, Cout] (tap-major im2col rows), the mask [M, C] per
// sample (row r takes mask[r / (R/M)]: Dropout2d, broadcast over intervals
// and spectrum), GELU the exact one with the TPU kernel's erf (Abramowitz &
// Stegun 7.1.26). The backward of layer k, given da = dL/da_k:
//   gy = da * mask * GELU'(y), x̂ = c P - Q   (P = invstd, Q = mu*invstd)
//   sums Σgy, Σgy·x̂ over all rows -> m0 = Σgy*scale/n, m1 = Σgy·x̂*scale/n
//   dc = P (gy*scale - m0 - x̂ m1)
//   d a_{k-1} = convT(dc, W_k) (+ da),  dW_k = im2col(a_{k-1})^T dc,  db_k = Σ dc
// The [C]-sized steps between launches (statistics to A, B, P, Q; m0, m1;
// the per-tap transpose of W) are the caller's.
//
// What bounds them on this card: operations. A (1, KW) conv over C = 64
// channels does 2*KW*C multiply-adds per output for 8 bytes of activation
// in and out: 80-160 FLOP per byte, above the f32 ridge of 20 (67 TFLOP/s
// over 3.35 TB/s). The elementwise steps (BN, GELU, mask, residual, the
// sums) are bound by bytes and ride along with the convs.
//
// What the design does about it:
//   * One conv kernel (conv_tile_kernel) serves the forward's first conv,
//     the forward's apply-plus-next-conv and the backward's dc-plus-
//     transposed-conv: a block owns a tile of whole samples (ts*S rows, so
//     a tap never leaves the tile: SAME padding is a read of a zero row)
//     and builds that tile's input activations in shared memory once,
//     by its prologue: a plain load (first conv), layer k's BN + GELU +
//     mask + residual (apply; the block of column tile 0 also writes a_k
//     out), or the BN backward (dc; written out likewise for dW). It then
//     computes a 64-column slice of the tile's conv as an implicit-im2col
//     product, 8 or 4 rows x 4 columns per thread, the weights staged 16
//     rows at a time. The tile's rows are chosen so that its activations
//     fit ~96 KB (two blocks an SM): 120 rows at C = 64, 60 at C = 256.
//   * Cross-row sums (the forward's [2, C] statistics, the backward's
//     Σgy and Σgy·x̂, dW and db) are per-block partials in a fixed row
//     order, then an ordered sum over blocks (reduce_partials_kernel): no
//     atomics, so a launch repeats bit for bit. dW is a split-K product over
//     the rows (wgrad_kernel), the splits' partials summed in split order.
//   * f32 throughout; no TF32, no tensor cores yet (later work: wgmma).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;          // output channels per conv block: 16 column groups of 4
constexpr int kBK = 16;          // input channels of the weights staged per step
constexpr int kLanes = 16;       // row lanes of a conv block: thread (tx, ty) owns rows ty + 16 i
constexpr int kMaxRows = 128;    // rows of a conv tile
constexpr int kActBytes = 96 * 1024;  // a conv tile's activations (two blocks an SM)
constexpr int kStatRows = 256;   // rows per block of the backward sums
constexpr int kTile = 64;        // weight-gradient output tile (rows and columns)
constexpr int kTileK = 16;       // weight-gradient rows per shared-memory stage
constexpr int kMaxChannels = 4096;

enum Prologue { kLoad = 0, kApply = 1, kBnBackward = 2 };

// Operands of the conv and elementwise kernels. K is the tile's channels
// (the conv's input), N the conv's output channels.
struct TileArgs {
  const float* x;      // kLoad: the activations [RS, K]; else the conv output c_k [RS, K]
  const float* da;     // kBnBackward: dL/da_k [RS, K]
  const float* rows;   // [5, K]: A, B, P, Q, scale
  const float* m;      // kBnBackward: [2, K]: m0, m1
  const float* mask;   // [M, K]; row g takes mask[g / S / group]
  const float* aprev;  // kApply: the residual a_{k-1} [RS, K], or null
  float* act_out;      // kApply: a_k; kBnBackward: dc ([RS, K], written once)
  const float* w;      // [KW*K, N]
  const float* bias;   // [N], or null
  const float* add;    // [RS, N] added to the output, or null
  float* out;          // [RS, N]
  float* part;         // [tiles, 2, N]: each tile's column sums of out and out^2, or null
  int R, S, K, N, KW, ts, group, sign;  // sign: +1 conv, -1 transposed conv
};

__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * ax);
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t - 0.284496736f) * t +
       0.254829592f) * t;
  return copysignf(1.f - poly * expf(-ax * ax), x);
}

__device__ __forceinline__ float gelu(float z) {
  return 0.5f * z * (1.f + erf_as(z * 0.7071067811865476f));
}

__device__ __forceinline__ float gelu_grad(float z) {
  const float cdf = 0.5f * (1.f + erf_as(z * 0.7071067811865476f));
  return cdf + z * expf(-0.5f * z * z) * 0.3989422804014327f;
}

// The tile's input activation at row g, channel ch.
template <int kMode>
__device__ __forceinline__ float prologue(const TileArgs& p, int g, int ch) {
  const size_t e = (size_t)g * p.K + ch;
  if (kMode == kLoad) return p.x[e];
  const float c = p.x[e];
  const float y = fmaf(c, p.rows[ch], p.rows[p.K + ch]);
  const float mk = p.mask[(size_t)(g / p.S / p.group) * p.K + ch];
  if (kMode == kApply) {
    float z = gelu(y) * mk;
    if (p.aprev != nullptr) z += p.aprev[e];
    return z;
  }
  const float P = p.rows[2 * p.K + ch];
  const float xhat = fmaf(c, P, -p.rows[3 * p.K + ch]);
  const float gy = p.da[e] * mk * gelu_grad(y);
  return P * (gy * p.rows[4 * p.K + ch] - p.m[ch] - xhat * p.m[p.K + ch]);
}

// Shared-memory layout of a conv block: the activation tile (rows + one
// zero row, row stride K + 1 against bank conflicts), the staged weights
// and the column sums of the epilogue.
__host__ __device__ inline size_t act_floats(int ts, int S, int K) {
  return ((size_t)(ts * S + 1) * (K + 1) + 3) / 4 * 4;
}

__host__ __device__ inline size_t conv_smem_bytes(int ts, int S, int K) {
  return (act_floats(ts, S, K) + kBK * kBN + 2 * kLanes * kBN) * sizeof(float);
}

// One block: a tile of ts whole samples (rows [r0*S, (r0+ts)*S)) x output
// columns [n0, n0 + 64). kIters row iterations of 16 lanes cover the tile.
template <int kMode, int kIters>
__global__ void __launch_bounds__(kThreads) conv_tile_kernel(const TileArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int ld = p.K + 1;
  const int tile_rows = p.ts * p.S;
  float* act = smem;
  float* wsh = smem + act_floats(p.ts, p.S, p.K);
  float* red = wsh + kBK * kBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * p.ts;
  const int rows = min(p.ts, p.R - r0) * p.S;
  const int g0 = r0 * p.S;
  const int n0 = blockIdx.y * kBN;

  for (int e = tid; e < rows * p.K; e += kThreads) {
    const int r = e / p.K, ch = e - r * p.K;
    const float v = prologue<kMode>(p, g0 + r, ch);
    act[r * ld + ch] = v;
    if (kMode != kLoad && blockIdx.y == 0) p.act_out[(size_t)g0 * p.K + e] = v;
  }
  for (int ch = tid; ch < p.K; ch += kThreads) act[tile_rows * ld + ch] = 0.f;

  int s_row[kIters];
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int r = ty + kLanes * i;
    s_row[i] = r < rows ? r % p.S : -1;
  }
  float acc[kIters][4];
#pragma unroll
  for (int i = 0; i < kIters; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int lo = (p.KW - 1) / 2;
  for (int k = 0; k < p.KW; ++k) {
    const int d = p.sign * (k - lo);
    int off[kIters];  // the tap's source row in the tile, or the zero row
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int s = s_row[i] + d;
      off[i] = (s_row[i] >= 0 && s >= 0 && s < p.S) ? (ty + kLanes * i + d) * ld : tile_rows * ld;
    }
    for (int c0 = 0; c0 < p.K; c0 += kBK) {
      __syncthreads();  // the tile is built; the last step's weights are read
      {
        const int lr = tid / 16, lc = (tid % 16) * 4;
        const int kr = c0 + lr;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + lc + q;
          wsh[lr * kBN + lc + q] =
              (kr < p.K && n < p.N) ? p.w[(size_t)(k * p.K + kr) * p.N + n] : 0.f;
        }
      }
      __syncthreads();
      const int kc = min(kBK, p.K - c0);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        if (kk < kc) {
          const float4 b4 = *reinterpret_cast<const float4*>(&wsh[kk * kBN + tx * 4]);
#pragma unroll
          for (int i = 0; i < kIters; ++i) {
            const float a = act[off[i] + c0 + kk];
            acc[i][0] = fmaf(a, b4.x, acc[i][0]);
            acc[i][1] = fmaf(a, b4.y, acc[i][1]);
            acc[i][2] = fmaf(a, b4.z, acc[i][2]);
            acc[i][3] = fmaf(a, b4.w, acc[i][3]);
          }
        }
      }
    }
  }

  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  const int nb = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int r = ty + kLanes * i;
    if (r >= rows) continue;
    const size_t g = (size_t)(g0 + r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb + j;
      if (n >= p.N) continue;
      float v = acc[i][j];
      if (p.bias != nullptr) v += p.bias[n];
      if (p.add != nullptr) v += p.add[g * p.N + n];
      p.out[g * p.N + n] = v;
      s1[j] += v;
      s2[j] = fmaf(v, v, s2[j]);
    }
  }
  if (p.part != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[ty * kBN + tx * 4 + j] = s1[j];
      red[(kLanes + ty) * kBN + tx * 4 + j] = s2[j];
    }
    __syncthreads();
    if (tid < kBN && n0 + tid < p.N) {
      float t1 = 0.f, t2 = 0.f;
      for (int l = 0; l < kLanes; ++l) {
        t1 += red[l * kBN + tid];
        t2 += red[(kLanes + l) * kBN + tid];
      }
      p.part[(size_t)blockIdx.x * 2 * p.N + n0 + tid] = t1;
      p.part[((size_t)blockIdx.x * 2 + 1) * p.N + n0 + tid] = t2;
    }
  }
}

// act_out[e] = prologue(e) over all R*S*K elements: the last layer's apply
// and the external first conv's dc.
template <int kMode>
__global__ void __launch_bounds__(kThreads) elementwise_kernel(const TileArgs p) {
  const size_t total = (size_t)p.R * p.S * p.K;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int g = (int)(e / p.K), ch = (int)(e - (size_t)g * p.K);
    p.act_out[e] = prologue<kMode>(p, g, ch);
  }
}

// Per block of kStatRows rows: Σgy and Σgy·x̂ per channel, into part[block]
// [2, K]. Threads are (lane, channel) pairs; lanes sum strided rows and
// are summed in lane order.
__global__ void __launch_bounds__(kThreads) bn_grad_sums_kernel(const TileArgs p,
                                                                float* __restrict__ part) {
  extern __shared__ float red[];  // [2][lanes][K]
  const int cols = min(p.K, kThreads), lanes = kThreads / cols;
  const int lane = threadIdx.x / cols, col = threadIdx.x % cols;
  const int RS = p.R * p.S;
  const int g_begin = blockIdx.x * kStatRows, g_end = min(RS, g_begin + kStatRows);
  if (lane < lanes) {
    for (int ch = col; ch < p.K; ch += cols) {
      const float A = p.rows[ch], B = p.rows[p.K + ch];
      const float P = p.rows[2 * p.K + ch], Q = p.rows[3 * p.K + ch];
      float s1 = 0.f, s2 = 0.f;
      for (int g = g_begin + lane; g < g_end; g += lanes) {
        const size_t e = (size_t)g * p.K + ch;
        const float c = p.x[e];
        const float mk = p.mask[(size_t)(g / p.S / p.group) * p.K + ch];
        const float gy = p.da[e] * mk * gelu_grad(fmaf(c, A, B));
        s1 += gy;
        s2 = fmaf(gy, fmaf(c, P, -Q), s2);
      }
      red[lane * p.K + ch] = s1;
      red[(lanes + lane) * p.K + ch] = s2;
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < p.K; ch += kThreads) {
    float t1 = 0.f, t2 = 0.f;
    for (int l = 0; l < lanes; ++l) {
      t1 += red[l * p.K + ch];
      t2 += red[(lanes + l) * p.K + ch];
    }
    part[(size_t)blockIdx.x * 2 * p.K + ch] = t1;
    part[((size_t)blockIdx.x * 2 + 1) * p.K + ch] = t2;
  }
}

// Weight gradient as a split-K product over the rows: block (tile, split)
// computes one 64x64 tile of dW = im2col(aprev)^T dc [KW*Cin, N] over its
// split's fixed row range, plus (first row tile) the column sums db, and
// writes them to its split's partial [dW | db]. Each thread holds a 4x4
// tile of the output; rows are staged 16 at a time in shared memory.
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const float* __restrict__ aprev, const float* __restrict__ dc, int R, int S,
             int Cin, int N, int KW, int rows_per_split, float* __restrict__ part) {
  __shared__ __align__(16) float As[kTileK][kTile];
  __shared__ __align__(16) float Bs[kTileK][kTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int M = KW * Cin;
  const size_t E = (size_t)M * N + N;
  const int tiles_n = (N + kTile - 1) / kTile;
  const int m0 = (blockIdx.x / tiles_n) * kTile;
  const int n0 = (blockIdx.x % tiles_n) * kTile;
  float* out = part + (size_t)blockIdx.y * E;
  const int RS = R * S;
  const int g_begin = blockIdx.y * rows_per_split;
  const int g_end = min(RS, g_begin + rows_per_split);
  const bool col_sums = m0 == 0;
  const int lo = (KW - 1) / 2;
  const int lr = tid / 16, lc = (tid % 16) * 4;
  int tap[4], ci[4];  // the tap shift and channel of the thread's 4 staged columns of A
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = m0 + lc + q;
    const int k = m / Cin;
    tap[q] = m < M ? k - lo : S;  // S: never a valid shift
    ci[q] = m - k * Cin;
  }

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  float bsum = 0.f;
  for (int g = g_begin; g < g_end; g += kTileK) {
    const int gg = g + lr;
    const bool row_ok = gg < g_end;
    const int s = row_ok ? gg % S : 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ss = s + tap[q];
      As[lr][lc + q] = (row_ok && ss >= 0 && ss < S)
                           ? aprev[(size_t)(gg + tap[q]) * Cin + ci[q]] : 0.f;
      const int n = n0 + lc + q;
      Bs[lr][lc + q] = (row_ok && n < N) ? dc[(size_t)gg * N + n] : 0.f;
    }
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
    const int m = m0 + ty * 4 + a;
    if (m >= M) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int n = n0 + tx * 4 + b;
      if (n < N) out[(size_t)m * N + n] = acc[a][b];
    }
  }
  if (col_sums && tid < kTile && n0 + tid < N) out[(size_t)M * N + n0 + tid] = bsum;
}

// out[e] = sum over s (in order) of part[s][e]: the deterministic second
// pass of every cross-block reduction.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int S, size_t E,
                                       float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * E + e];
  out[e] = acc;
}

cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

bool channels_ok(int c) { return c >= 1 && c <= kMaxChannels; }

// Tile plan of the conv kernel for S positions and K input channels: whole
// samples per tile (ts) and row iterations (8 or 4: 128 or 64 rows at most),
// the pair that leaves the fewest idle row lanes; ts 0 when one sample does
// not fit.
struct ConvPlan {
  int ts, iters;
  size_t smem;
};

ConvPlan conv_plan(int S, int K) {
  ConvPlan best{0, 0, 0};
  float best_eff = 0.f;
  if (S < 1 || S > kMaxRows || !channels_ok(K)) return best;
  for (int iters : {8, 4}) {
    const int cap = kLanes * iters;
    const int by_smem = kActBytes / (S * (K + 1) * (int)sizeof(float));
    const int ts = std::min(cap / S, by_smem);
    if (ts < 1) continue;
    const float eff = (float)(ts * S) / cap;
    if (eff > best_eff) {
      best_eff = eff;
      best = ConvPlan{ts, iters, conv_smem_bytes(ts, S, K)};
    }
  }
  return best;
}

int conv_tiles(int R, const ConvPlan& P) { return (R + P.ts - 1) / P.ts; }

// The weight-gradient split: the rows cut into `splits` fixed ranges of
// `rows_per_split` (a multiple of kTileK).
struct WgradPlan {
  int tiles, splits, rows_per_split;
  size_t E;
};

WgradPlan wgrad_plan(int RS, int M, int N, int sms) {
  WgradPlan P{};
  P.tiles = ((M + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
  int splits = (4 * sms + P.tiles - 1) / P.tiles;
  splits = std::max(1, std::min(splits, (RS + 63) / 64));
  int rps = (RS + splits - 1) / splits;
  P.rows_per_split = (rps + kTileK - 1) / kTileK * kTileK;
  P.splits = (RS + P.rows_per_split - 1) / P.rows_per_split;
  P.E = (size_t)M * N + N;
  return P;
}

template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int kMode>
int launch_conv(const TileArgs& p, const ConvPlan& P, cudaStream_t s) {
  const dim3 grid(conv_tiles(p.R, P), (p.N + kBN - 1) / kBN);
  cudaError_t err;
  if (P.iters == 8) {
    err = set_smem(conv_tile_kernel<kMode, 8>, P.smem);
    if (err != cudaSuccess) return (int)err;
    conv_tile_kernel<kMode, 8><<<grid, kThreads, P.smem, s>>>(p);
  } else {
    err = set_smem(conv_tile_kernel<kMode, 4>, P.smem);
    if (err != cudaSuccess) return (int)err;
    conv_tile_kernel<kMode, 4><<<grid, kThreads, P.smem, s>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_elementwise(const TileArgs& p, cudaStream_t s) {
  int sms = 0;
  cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)p.R * p.S * p.K;
  const size_t blocks = std::min((total + kThreads - 1) / kThreads, (size_t)sms * 8);
  elementwise_kernel<kMode><<<(unsigned)std::max<size_t>(blocks, 1), kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

int launch_reduce(const float* part, int S, size_t E, float* out, cudaStream_t s) {
  reduce_partials_kernel<<<(unsigned)((E + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, S, E, out);
  return (int)cudaGetLastError();
}

// R rows of S positions with a mask of M rows (R % M == 0), and C channels:
// every element index R*S*C fits an int.
int check_rows(int R, int S, int M, int C) {
  if (R < 1 || S < 1 || S > kMaxRows || M < 1 || R % M != 0 || !channels_ok(C) ||
      (long long)R * S * C >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Workspace, in floats, of one launch on the current device, or an error
// when no plan takes the geometry. kind 0: a forward conv (conv0 or apply
// with a next layer; cin = the tile's channels, cout = the conv's
// outputs); 1: the backward sums (cin = cout = C); 2: the backward apply
// (cin = the layer's input channels, cout = C).
extern "C" int focal_ct_workspace(int kind, int R, int S, int cin, int cout, int kw,
                                  long long* floats) {
  if (check_rows(R, S, 1, std::max(cin, cout)) || !channels_ok(cin) || !channels_ok(cout) || kw < 1)
    return (int)cudaErrorInvalidValue;
  const long long RS = (long long)R * S;
  if (kind == 0) {
    const ConvPlan P = conv_plan(S, cin);
    if (P.ts == 0) return (int)cudaErrorInvalidConfiguration;
    *floats = (long long)conv_tiles(R, P) * 2 * cout;
    return 0;
  }
  if (kind == 1) {
    *floats = (RS + kStatRows - 1) / kStatRows * 2 * cout;
    return 0;
  }
  if (kind == 2) {
    const ConvPlan P = conv_plan(S, cout);
    if (P.ts == 0) return (int)cudaErrorInvalidConfiguration;
    int sms = 0;
    const cudaError_t err = device_sms(&sms);
    if (err != cudaSuccess) return (int)err;
    const WgradPlan W = wgrad_plan((int)RS, kw * cin, cout, sms);
    *floats = RS * cout + (long long)W.splits * (long long)W.E;
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// The first conv of an internal-c0 tower (#13, _conv0_kernel): c = conv(x,
// w) + b [RS, cout] and its column sums [2, cout] (Σc, Σc²). ws holds
// focal_ct_workspace(0, R, S, cin, cout, kw) floats. Two launches on
// `stream`: the conv tiles and the ordered sum of their partials.
extern "C" int focal_ct_conv0(const void* x, const void* w, const void* b, void* c, void* sums,
                              void* ws, int R, int S, int cin, int cout, int kw, void* stream) {
  if (check_rows(R, S, 1, std::max(cin, cout)) || !channels_ok(cin) || !channels_ok(cout) ||
      kw < 1)
    return (int)cudaErrorInvalidValue;
  const ConvPlan P = conv_plan(S, cin);
  if (P.ts == 0) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TileArgs p{};
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(b);
  p.out = static_cast<float*>(c);
  p.part = static_cast<float*>(ws);
  p.R = R, p.S = S, p.K = cin, p.N = cout, p.KW = kw, p.ts = P.ts, p.group = 1, p.sign = 1;
  int err = launch_conv<kLoad>(p, P, s);
  if (err) return err;
  return launch_reduce(p.part, conv_tiles(R, P), (size_t)2 * cout, static_cast<float*>(sums), s);
}

// Layer k's apply (#13, _apply_kernel): a = GELU(c*A + B) * mask (+ aprev)
// [RS, C], rows = [A; B; P; Q; scale] [5, C], mask [M, C] (R % M == 0),
// aprev null for no residual. With w [kw*C, cout] and b: also layer k+1's
// c_next = conv(a, w) + b and its sums [2, cout] in the same pass (ws:
// focal_ct_workspace(0, R, S, C, cout, kw) floats); with w null the apply
// alone (c_next, sums, ws unused).
extern "C" int focal_ct_apply(const void* c, const void* rows, const void* mask,
                              const void* aprev, const void* w, const void* b, void* a,
                              void* c_next, void* sums, void* ws, int R, int S, int M, int C,
                              int cout, int kw, void* stream) {
  if (check_rows(R, S, M, std::max(C, cout))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TileArgs p{};
  p.x = static_cast<const float*>(c);
  p.rows = static_cast<const float*>(rows);
  p.mask = static_cast<const float*>(mask);
  p.aprev = static_cast<const float*>(aprev);
  p.act_out = static_cast<float*>(a);
  p.R = R, p.S = S, p.K = C, p.group = R / M, p.sign = 1;
  if (w == nullptr) return launch_elementwise<kApply>(p, s);
  if (!channels_ok(cout) || kw < 1) return (int)cudaErrorInvalidValue;
  const ConvPlan P = conv_plan(S, C);
  if (P.ts == 0) return (int)cudaErrorInvalidConfiguration;
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(b);
  p.out = static_cast<float*>(c_next);
  p.part = static_cast<float*>(ws);
  p.N = cout, p.KW = kw, p.ts = P.ts;
  int err = launch_conv<kApply>(p, P, s);
  if (err) return err;
  return launch_reduce(p.part, conv_tiles(R, P), (size_t)2 * cout, static_cast<float*>(sums), s);
}

// The backward sums of layer k (#14, _bwd_stats_kernel): s2 = [Σgy; Σgy·x̂]
// [2, C] from da, c [RS, C], mask and rows. ws: focal_ct_workspace(1, R,
// S, C, C, 1) floats. Two launches: per-block sums, their ordered sum.
extern "C" int focal_ct_bwd_stats(const void* da, const void* c, const void* mask,
                                  const void* rows, void* s2, void* ws, int R, int S, int M,
                                  int C, void* stream) {
  if (check_rows(R, S, M, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TileArgs p{};
  p.x = static_cast<const float*>(c);
  p.da = static_cast<const float*>(da);
  p.rows = static_cast<const float*>(rows);
  p.mask = static_cast<const float*>(mask);
  p.R = R, p.S = S, p.K = C, p.group = R / M;
  const int blocks = (R * S + kStatRows - 1) / kStatRows;
  const int lanes = kThreads / std::min(C, kThreads);
  const size_t smem = (size_t)2 * lanes * C * sizeof(float);
  cudaError_t e = set_smem(bn_grad_sums_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  float* part = static_cast<float*>(ws);
  bn_grad_sums_kernel<<<blocks, kThreads, smem, s>>>(p, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_reduce(part, blocks, (size_t)2 * C, static_cast<float*>(s2), s);
}

// The backward apply of layer k (#14, _bwd_apply_kernel): dc from da, c,
// mask, rows and m = [m0; m1] [2, C]; dprev = convT(dc, W) (+ da when
// `residual`) [RS, cin], from wt [kw*C, cin], W's per-tap transpose
// (wt[j*C + co][ci] = W[j*cin + ci][co]); dwb = [dW (kw*cin x C) | db (C)].
// aprev [RS, cin] is the layer's input. ws: focal_ct_workspace(2, R, S,
// cin, C, kw) floats (dc, then the weight-gradient partials). Three
// launches: dc + transposed conv, weight-gradient partials, their ordered
// sum.
extern "C" int focal_ct_bwd_apply(const void* da, const void* c, const void* mask,
                                  const void* rows, const void* m, const void* aprev,
                                  const void* wt, void* dprev, void* dwb, void* ws, int R,
                                  int S, int M, int C, int cin, int kw, int residual,
                                  void* stream) {
  if (check_rows(R, S, M, std::max(C, cin)) || !channels_ok(cin) || kw < 1 ||
      (residual && cin != C))
    return (int)cudaErrorInvalidValue;
  const ConvPlan P = conv_plan(S, C);
  if (P.ts == 0) return (int)cudaErrorInvalidConfiguration;
  int sms = 0;
  cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int RS = R * S;
  float* dc = static_cast<float*>(ws);
  float* wpart = dc + (size_t)RS * C;
  TileArgs p{};
  p.x = static_cast<const float*>(c);
  p.da = static_cast<const float*>(da);
  p.rows = static_cast<const float*>(rows);
  p.m = static_cast<const float*>(m);
  p.mask = static_cast<const float*>(mask);
  p.act_out = dc;
  p.w = static_cast<const float*>(wt);
  p.add = residual ? static_cast<const float*>(da) : nullptr;
  p.out = static_cast<float*>(dprev);
  p.R = R, p.S = S, p.K = C, p.N = cin, p.KW = kw, p.ts = P.ts, p.group = R / M, p.sign = -1;
  int err = launch_conv<kBnBackward>(p, P, s);
  if (err) return err;
  const WgradPlan W = wgrad_plan(RS, kw * cin, C, sms);
  wgrad_kernel<<<dim3(W.tiles, W.splits), kThreads, 0, s>>>(
      static_cast<const float*>(aprev), dc, R, S, cin, C, kw, W.rows_per_split, wpart);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_reduce(wpart, W.splits, W.E, static_cast<float*>(dwb), s);
}

// dc alone (#14, _bwd_dc_kernel): the input gradient of an external first
// conv's output [RS, C]. One launch.
extern "C" int focal_ct_bwd_dc(const void* da, const void* c, const void* mask, const void* rows,
                               const void* m, void* dc, int R, int S, int M, int C,
                               void* stream) {
  if (check_rows(R, S, M, C)) return (int)cudaErrorInvalidValue;
  TileArgs p{};
  p.x = static_cast<const float*>(c);
  p.da = static_cast<const float*>(da);
  p.rows = static_cast<const float*>(rows);
  p.m = static_cast<const float*>(m);
  p.mask = static_cast<const float*>(mask);
  p.act_out = static_cast<float*>(dc);
  p.R = R, p.S = S, p.K = C, p.group = R / M;
  return launch_elementwise<kBnBackward>(p, static_cast<cudaStream_t>(stream));
}

extern "C" const char* focal_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
