// Whole-block Swin window attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel focal_tpu/ops/pallas_kernels.py::_wblock_fwd_kernel
// (reached through fused_window_block -> _wblock_fwd_impl -> pl.pallas_call).
// Per window w of x [B, N, C] (f32, row-major):
//   qkv = x Wqkv + bqkv                      (q columns pre-scaled by the caller)
//   o_h = softmax(q_h k_h^T + rel_bias[h] + mask[w % nW]) v_h   for each head h
//   y   = concat_h(o_h) Wproj + bproj
// All three products run in this kernel's body; qkv and the attention output
// never leave shared memory.
//
// What bounds it on this card: operations. At the MOD geometries (N = 9,
// C = 64..256) a window does 2*9*C*4C multiply-adds of projection for
// 9*C*2 floats of input and output, ~2.59 GFLOP against ~38 MB per launch at
// stage 0: about 69 FLOP per byte, above the f32 CUDA-core ridge
// (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte), so f32 FMA throughput is the
// limit, not HBM.
//
// What the design does about it:
//   * A block owns WPB windows (WPB * N * 4C floats of activations, ~74 KB,
//     so two blocks fit one SM). Each thread computes one output column for
//     all N rows of one window: every weight it loads from global memory (L2
//     resident; consecutive threads read consecutive columns) feeds N FMAs,
//     and the activation operand is a float4 broadcast from shared memory.
//   * The attention (2% of the FLOPs) is one thread per (window, head, query
//     row) with an exact N-long softmax: rows are not padded to a power of
//     two. Row strides in shared memory are padded (3C + 1, C + 4) so the
//     rows a warp touches fall in different banks.
//   * f32 throughout with fmaf and expf: no TF32, no bf16 (the TPU kernel's
//     bf16 downcast at C >= 128 was a VMEM workaround that does not apply).
//   * Not yet: wgmma / tensor cores, TMA, a persistent grid. Those are the
//     later performance work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 16;           // window tokens a thread keeps in registers
constexpr int kThreads = 256;
constexpr int kActBudget = 73728;   // bytes of x + qkv per block (two blocks per SM)

int windows_per_block(int N, int C) {
  const int wpb = kActBudget / (N * 16 * C);
  return wpb < 1 ? 1 : wpb;
}

size_t smem_bytes(int wpb, int N, int C) {
  return (size_t)wpb * N * ((C + 4) + (3 * C + 1)) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
wblock_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                  const float* __restrict__ bqkv, const float* __restrict__ wproj,
                  const float* __restrict__ bproj, const float* __restrict__ rel_bias,
                  const float* __restrict__ mask, float* __restrict__ y,
                  int B, int N, int C, int H, int nW, int wpb) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int xs_stride = C + 4;      // x rows, later the attention output rows
  const int qs_stride = 3 * C + 1;  // qkv rows
  float* xs = smem;                          // [wpb][N][C + 4]
  float* qs = smem + wpb * N * xs_stride;    // [wpb][N][3C + 1]
  const int w0 = blockIdx.x * wpb;
  const int nwin = min(wpb, B - w0);
  const int C3 = 3 * C;
  const int hd = C / H;
  const int tid = threadIdx.x;

  // 1. the block's windows are contiguous in x: stage them in shared memory
  const int c4 = C / 4;
  const float4* xg = reinterpret_cast<const float4*>(x + (size_t)w0 * N * C);
  for (int i = tid; i < nwin * N * c4; i += kThreads) {
    const int row = i / c4, col = i - row * c4;
    *reinterpret_cast<float4*>(xs + row * xs_stride + col * 4) = xg[i];
  }
  __syncthreads();

  // 2. qkv = x Wqkv + bqkv: one (window, column) per item, all N rows
  for (int item = tid; item < nwin * C3; item += kThreads) {
    const int w = item / C3, j = item - w * C3;
    const float* xw = xs + w * N * xs_stride;
    float acc[kMaxN];
#pragma unroll
    for (int r = 0; r < kMaxN; ++r) acc[r] = 0.f;
    for (int k = 0; k < C; k += 4) {
      const float b0 = __ldg(wqkv + (size_t)(k + 0) * C3 + j);
      const float b1 = __ldg(wqkv + (size_t)(k + 1) * C3 + j);
      const float b2 = __ldg(wqkv + (size_t)(k + 2) * C3 + j);
      const float b3 = __ldg(wqkv + (size_t)(k + 3) * C3 + j);
#pragma unroll
      for (int r = 0; r < kMaxN; ++r) {
        if (r < N) {
          const float4 a = *reinterpret_cast<const float4*>(xw + r * xs_stride + k);
          acc[r] = fmaf(a.x, b0, acc[r]);
          acc[r] = fmaf(a.y, b1, acc[r]);
          acc[r] = fmaf(a.z, b2, acc[r]);
          acc[r] = fmaf(a.w, b3, acc[r]);
        }
      }
    }
    const float bj = __ldg(bqkv + j);
    float* qw = qs + w * N * qs_stride;
#pragma unroll
    for (int r = 0; r < kMaxN; ++r)
      if (r < N) qw[r * qs_stride + j] = acc[r] + bj;
  }
  __syncthreads();

  // 3. attention per (window, head, query row); the output overwrites x,
  //    which step 2 has consumed
  for (int item = tid; item < nwin * H * N; item += kThreads) {
    const int i = item % N;
    const int h = (item / N) % H;
    const int w = item / (N * H);
    const float* qw = qs + w * N * qs_stride;
    const float* q = qw + i * qs_stride + h * hd;
    const float* bias = rel_bias + (h * N + i) * N;
    const float* m = mask ? mask + ((size_t)((w0 + w) % nW) * N + i) * N : nullptr;
    float s[kMaxN];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < N) {
        const float* kr = qw + j * qs_stride + C + h * hd;
        float d = 0.f;
        for (int t = 0; t < hd; ++t) d = fmaf(q[t], kr[t], d);
        d += __ldg(bias + j);
        if (m) d += __ldg(m + j);
        s[j] = d;
        mx = fmaxf(mx, d);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j) {
      if (j < N) {
        s[j] = expf(s[j] - mx);
        sum += s[j];
      }
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int j = 0; j < kMaxN; ++j)
      if (j < N) s[j] *= inv;
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
  for (int item = tid; item < nwin * C; item += kThreads) {
    const int w = item / C, j = item - w * C;
    const float* aw = xs + w * N * xs_stride;
    float acc[kMaxN];
#pragma unroll
    for (int r = 0; r < kMaxN; ++r) acc[r] = 0.f;
    for (int k = 0; k < C; k += 4) {
      const float b0 = __ldg(wproj + (size_t)(k + 0) * C + j);
      const float b1 = __ldg(wproj + (size_t)(k + 1) * C + j);
      const float b2 = __ldg(wproj + (size_t)(k + 2) * C + j);
      const float b3 = __ldg(wproj + (size_t)(k + 3) * C + j);
#pragma unroll
      for (int r = 0; r < kMaxN; ++r) {
        if (r < N) {
          const float4 a = *reinterpret_cast<const float4*>(aw + r * xs_stride + k);
          acc[r] = fmaf(a.x, b0, acc[r]);
          acc[r] = fmaf(a.y, b1, acc[r]);
          acc[r] = fmaf(a.z, b2, acc[r]);
          acc[r] = fmaf(a.w, b3, acc[r]);
        }
      }
    }
    const float bj = __ldg(bproj + j);
    float* yw = y + (size_t)(w0 + w) * N * C;
#pragma unroll
    for (int r = 0; r < kMaxN; ++r)
      if (r < N) yw[r * C + j] = acc[r] + bj;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). Pointers are
// device pointers to contiguous f32 tensors; `mask` may be null (nW ignored).
extern "C" int focal_wblock_fwd(const void* x, const void* wqkv, const void* bqkv,
                                const void* wproj, const void* bproj,
                                const void* rel_bias, const void* mask, void* y,
                                int B, int N, int C, int H, int nW, void* stream) {
  if (N < 1 || N > kMaxN || C < 4 || C % 4 != 0 || H < 1 || C % H != 0 ||
      (mask != nullptr && nW < 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int wpb = windows_per_block(N, C);
  const size_t smem = smem_bytes(wpb, N, C);
  cudaError_t err = cudaFuncSetAttribute(
      wblock_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + wpb - 1) / wpb;
  wblock_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(wproj),
      static_cast<const float*>(bproj), static_cast<const float*>(rel_bias),
      static_cast<const float*>(mask), static_cast<float*>(y), B, N, C, H,
      mask != nullptr ? nW : 1, wpb);
  return (int)cudaGetLastError();
}

extern "C" const char* focal_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
