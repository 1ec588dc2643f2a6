// The int8 BERT attention sublayer of the Q-Former mapper:
//   out = LN(Wo . MHA(q = Wq x, k = Wk kv, v = Wv kv) + bo + x), eps 1e-12,
// self-attention (kv is x) or cross-attention with a (B, M) key mask.
//
// Replaces setok_tpu/kernels/fused_bert_attention_int8.py::
// fused_bert_attention_int8 (:100), one Pallas program per sequence. Here a
// chain of the kernels of int8_sublayer.cuh:
//
//   rows(quant x) [-> rows(quant kv), cross only] -> gemm(q, bf16 of
//   (q + bq) / sqrt(d)) -> gemm(k, bf16) -> gemm(v, bf16) -> attn
//   -> rows(quant o) -> gemm(out, + x) -> rows(LN)    8 launches (9 cross)
//
// x and kv are quantised separately, as in the JAX kernel; for
// self-attention the two quantisations are the same, so kv reuses x's. The
// scale is applied after the bias and before the bf16 cast (`(q * scale)`
// in the JAX kernel), unlike the sublayer kernel's folded scale.
//
// What bounds it (H100 SXM data sheet, B=64, N=256 queries, C=768):
// self-attention 77.3 G int8 operations plus 12.9 G bf16, 0.052 ms; cross
// over M=80 keys 2*C*C*(2N + 2M)*B = 50.7 G int8 plus 4*B*N*M*C = 4.0 G
// bf16, about 0.030 ms of operations against 0.035 ms of f32 input and
// output. Like fused_sublayer.cu, this first version is far from that.

#include "int8_sublayer.cuh"

using namespace int8k;

// x, out: (B, N, C) f32; kv: (B, M, C) f32, or the same pointer as x for
// self-attention. wq, wk, wv, wo: (C, C) int8 with per-row scales and
// biases. kv_mask: (B, M) bytes, nonzero = attend, or null. Scratch:
// x8 (B*N*C), xs (B*N), kv8 (B*M*C), kvs (B*M), q16 (B*N*C) bf16,
// kv16 (B*M*2C) bf16, o (B*N*C) f32, y (B*N*C) f32.
extern "C" int fused_bert_attention_int8_f32(
    const float* x, const float* kv, const int8_t* wq, const float* sq,
    const float* bq, const int8_t* wk, const float* sk, const float* bk,
    const int8_t* wv, const float* sv, const float* bv, const int8_t* wo,
    const float* so, const float* bo, const float* ln_g, const float* ln_b,
    float eps, const uint8_t* kv_mask, float* out, int8_t* x8, float* xs,
    int8_t* kv8, float* kvs, __nv_bfloat16* q16, __nv_bfloat16* kv16,
    float* o, float* y, int B, int N, int M, int C, int H, float q_scale,
    int device, void* stream, int* launched) {
  *launched = 0;
  if (B < 1 || N < 1 || M < 1 || M > kMaxKeys || H < 1 || C % H != 0 ||
      (C / H) % 4 != 0 || C % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * N, krows = B * M, D = C / H;

  STEP(launch_rows(x, nullptr, nullptr, 0.f, rows, C, x8, xs, nullptr, s));
  if (kv != x) {
    STEP(launch_rows(kv, nullptr, nullptr, 0.f, krows, C, kv8, kvs, nullptr,
                     s));
  } else {
    kv8 = x8;
    kvs = xs;
  }
  STEP(launch_gemm<kBf16>(x8, xs, wq, sq, bq, nullptr, q16, C, q_scale, rows,
                          C, C, s));
  STEP(launch_gemm<kBf16>(kv8, kvs, wk, sk, bk, nullptr, kv16, 2 * C, 1.0f,
                          krows, C, C, s));
  STEP(launch_gemm<kBf16>(kv8, kvs, wv, sv, bv, nullptr, kv16 + C, 2 * C,
                          1.0f, krows, C, C, s));
  STEP(launch_attn(q16, (long long)N * C, C, kv16, kv16 + C,
                   (long long)M * 2 * C, 2 * C, kv_mask, M, 0, o,
                   (long long)N * C, C, B, H, N, M, D, s));
  STEP(launch_rows(o, nullptr, nullptr, 0.f, rows, C, x8, xs, nullptr, s));
  STEP(launch_gemm<kResid>(x8, xs, wo, so, bo, x, y, C, 1.0f, rows, C, C, s));
  STEP(launch_rows(y, ln_g, ln_b, eps, rows, C, nullptr, nullptr, out, s));
  return 0;
}
