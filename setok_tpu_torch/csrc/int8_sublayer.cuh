// Building blocks shared by the int8 kernels' C entries: STEP (a chain's
// launch count), the warp sums and maximum, the tanh GELU of the JAX
// kernels (the int8 MLP epilogues of wgmma_s8.cuh), and rows_kernel, the
// trailing LayerNorm of the post-norm sublayers (row 4's
// fused_bert_attention_int8.cu and row 5's mlp_postnorm_int8 in
// fused_sublayer.cu). Every multiply and add whose rounding the JAX kernel
// fixes is written with __fmul_rn/__fadd_rn so that nvcc contracts none of
// them into an FMA; built without --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One launch of a host entry point's chain: return the CUDA error, else count
// the launch in *launched.
#define STEP(call)                                  \
  do {                                              \
    cudaError_t e_ = (call);                        \
    if (e_ != cudaSuccess) return (int)e_;          \
    ++*launched;                                    \
  } while (0)

namespace int8k {

constexpr int kThreads = 256;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// The LayerNorm of a row, one warp per row: y = (x - mu) * r * g + b in f32,
// mu and the variance from f64 sums rounded to f32 once (the plain
// `layernorm`'s values, whatever the order of the sums), r = rsqrt(var +
// eps).

__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ x, const float* __restrict__ g,
            const float* __restrict__ b, float eps, int rows, int C,
            float* __restrict__ y) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * C;
  double s = 0.0;
  for (int c = lane; c < C; c += 32) s += (double)xr[c];
  const float mu = (float)(warp_sum(s) / (double)C);
  double v = 0.0;
  for (int c = lane; c < C; c += 32) {
    const double d = (double)__fsub_rn(xr[c], mu);
    v += d * d;
  }
  const float var = (float)(warp_sum(v) / (double)C);
  const float r = (float)rsqrt((double)__fadd_rn(var, eps));
  for (int c = lane; c < C; c += 32)
    y[(size_t)row * C + c] =
        __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xr[c], mu), r), g[c]), b[c]);
}

inline cudaError_t launch_rows(const float* x, const float* g, const float* b,
                               float eps, int rows, int C, float* y,
                               cudaStream_t s) {
  constexpr int kWarps = kThreads / 32;
  rows_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      x, g, b, eps, rows, C, y);
  return cudaGetLastError();
}

// jax.nn.gelu(approximate=True): x * (0.5 * (1 + tanh(c * (x + 0.044715 x³))))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;   // sqrt(2/pi) as float32
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(c, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

}  // namespace int8k
