// Whole-sequence int8 self-attention of the unfused route:
// out = proj(softmax(q.k^T + mask bias) v), qkv = int8 product of x.
//
// Replaces setok_tpu/kernels/fused_attention_int8.py:84 fused_attention_int8,
// the attention that the JAX package's Attention(quant8) takes where its
// whole-sublayer kernel does not fit (the tokenizer Blocks when their MLP is
// 4096 wide). The TPU kernel is one Pallas program per image that keeps qkv
// and the scores in VMEM. Here it is a chain of the kernels of
// int8_sublayer.cuh, with the intermediates in device memory:
//
//   rows(quant x) -> gemm(qkv, f32 out) -> attn(f32) -> rows(quant o)
//   -> gemm(proj, + b_proj)                                   5 launches
//
// Unlike attn_sublayer_int8 (fused_sublayer.cu) the JAX kernel keeps q, k,
// v, the scores, p and PV in float32: attn_kernel<float> reads f32 q, k, v
// and keeps p in f32. The steps are the JAX kernel's: the softmax scale
// arrives folded into the q columns of the qkv scales and bias (the wrapper
// does it, as the JAX wrapper does); the mask is a -1e30*(1-m) bias; exact
// row max, exp and the sum l in f32; 1/max(l, 1e-30) applied after PV, 0 on
// a fully masked row; o row-quantised over the whole C, then the int8
// projection. The attention products are f32 FMAs on the CUDA cores: a TF32
// product (~1e-3) would flip int8 steps of o.
//
// The head dim on the path is 384 (2 heads at C = 768): attn_kernel walks it
// in chunks of 16 for the scores and 64 for PV, and keeps one 64-query row
// block of scores (N <= 768 keys) in shared memory.
//
// What bounds it (H100 SXM data sheet, B=64 images of N=256, C=768, 2
// heads): the f32 attention products, 4*B*N^2*C = 12.9 G FLOP, 192 us at
// 67 TFLOP/s, plus the int8 products, 2*B*N*C*4C = 77 G operations, 39 us
// at 1979 TOP/s. PERF.md carries its times beside that bound.

#include "int8_sublayer.cuh"

using namespace int8k;

// x, out: (B*N, C) f32. w_qkv (3C, C) int8 with scales s_qkv and bias b_qkv
// (3C), the q columns pre-scaled; w_proj (C, C). mask: (B, N, N) bytes,
// nonzero = attend, or null. Scratch: x8 (B*N*C) int8, xs (B*N), qkv
// (B*N*3C) f32, o (B*N*C) f32.
extern "C" int fused_attention_int8_f32(
    const float* x, const int8_t* w_qkv, const float* s_qkv,
    const float* b_qkv, const int8_t* w_proj, const float* s_proj,
    const float* b_proj, const uint8_t* mask, float* out, int8_t* x8,
    float* xs, float* qkv, float* o, int B, int N, int C, int H, int device,
    void* stream, int* launched) {
  *launched = 0;
  if (B < 1 || N < 1 || N > kMaxKeys || H < 1 || C % H != 0 ||
      (C / H) % 4 != 0 || C % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N, D = C / H;

  STEP(launch_rows(x, nullptr, nullptr, 0.f, M, C, x8, xs, nullptr, s));
  STEP(launch_gemm<kF32>(x8, xs, w_qkv, s_qkv, b_qkv, nullptr, qkv, 3 * C,
                         1.0f, M, 3 * C, C, s));
  STEP(launch_attn(static_cast<const float*>(qkv), (long long)N * 3 * C,
                   3 * C, qkv + C, qkv + 2 * C, (long long)N * 3 * C, 3 * C,
                   mask, (long long)N * N, N, o, (long long)N * C, C, B, H, N,
                   N, D, s));
  STEP(launch_rows(o, nullptr, nullptr, 0.f, M, C, x8, xs, nullptr, s));
  STEP(launch_gemm<kF32>(x8, xs, w_proj, s_proj, b_proj, nullptr, out, C,
                         1.0f, M, C, C, s));
  return 0;
}
