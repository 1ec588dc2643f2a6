// The int8 BERT attention sublayer of the Q-Former mapper:
//   out = LN(Wo . MHA(q = Wq x, k = Wk kv, v = Wv kv) + bo + x), eps 1e-12,
// self-attention (kv is x) or cross-attention with a (B, M) key mask.
//
// Replaces setok_tpu/kernels/fused_bert_attention_int8.py::
// fused_bert_attention_int8 (:100), one Pallas program per sequence. Here a
// chain of launches with the intermediates in device memory, on the pieces
// of row 2 (fused_sublayer.cu):
//
//   quant_rows_kernel   x -> x8, xs (no LN); clears omax
//   [quant_rows_kernel  kv -> kv8, kvs: cross only; self-attention reuses
//                       x's, the same values]
//   wgmma GEMM, q       bf16(((acc * xs) * sq + bq) * (1/sqrt(d))): the
//                       softmax scale after the bias, the JAX kernel's
//                       order, for any d (at d = 64 the scale 0.125 is a
//                       power of two and folding it into sq and bq would
//                       give the same bits; the epilogue does not rely on
//                       it)
//   wgmma GEMM, k, v    bf16((acc * kvs) * s + b) into the (B*M, 2C) rows,
//                       k in columns [0, C), v in [C, 2C)
//   attn_mma_kernel     attn_mma.cuh over q (B*N, C) and k, v (B*M, 2C),
//                       the key mask as a -1e30 * (1 - m) bias: exact f64
//                       scores, the exact softmax, bf16 P.V; o in f32 and
//                       each row's |o| maximum by atomicMax on its bits
//   hidden_quant        o -> int8 with max(omax, 1e-8) / 127, one read
//   wgmma GEMM, out     y = x + ((acc * os) * so + bo)
//   rows_kernel         out = LN(y)                8 launches (9 cross)
//
// The three projections stay three GEMMs: the module holds three weights,
// and one GEMM over their concatenation would copy them every call.
//
// What bounds it (chip_smoke.int8_bound; H100 SXM data sheet, B=64, N=256
// queries, C=768, 12 heads of 64): self-attention 77.3 G int8 operations
// plus 12.9 G bf16 for the scores and PV, 0.0521 ms; cross over M=80 keys
// 50.7 G int8 plus 4.0 G bf16 (0.030 ms), under the 119 MB of f32 input
// and output and int8 weights, 0.0355 ms. PERF.md carries its times beside
// those bounds.

#include "attn_mma.cuh"

using namespace wg;

// x, out: (B, N, C) f32; kv: (B, M, C) f32, or the same pointer as x for
// self-attention. wq, wk, wv, wo: (C, C) int8 with per-row scales and
// biases. kv_mask: (B, M) bytes, nonzero = attend, or null. Scratch, each
// 16-byte aligned: x8 (B*N*C) int8 (then o's int8 rows), xs (B*N), kv8
// (B*M*C) and kvs (B*M) (cross only), q16 (B*N*C) bf16, kv16 (B*M*2C) bf16,
// o (B*N*C) f32, omax (B*N) u32, y (B*N*C) f32. Takes C % 16 == 0, D = C /
// H a multiple of 16, M <= 768 and a shared-memory need within the card's:
// else cudaErrorInvalidValue, nothing launched. Each launch counts one in
// *launched; returns the CUDA error of the first launch that failed, else 0.
extern "C" int fused_bert_attention_int8_f32(
    const float* x, const float* kv, const int8_t* wq, const float* sq,
    const float* bq, const int8_t* wk, const float* sk, const float* bk,
    const int8_t* wv, const float* sv, const float* bv, const int8_t* wo,
    const float* so, const float* bo, const float* ln_g, const float* ln_b,
    float eps, const uint8_t* kv_mask, float* out, int8_t* x8, float* xs,
    int8_t* kv8, float* kvs, __nv_bfloat16* q16, __nv_bfloat16* kv16,
    float* o, unsigned* omax, float* y, int B, int N, int M, int C, int H,
    float q_scale, int device, void* stream, int* launched) {
  *launched = 0;
  const bool cross = kv != x;
  if (!attn::takes(B, N, M, C, H) || C % 16 != 0 || !aligned16(x) ||
      !aligned16(kv) || !aligned16(wq) || !aligned16(wk) || !aligned16(wv) ||
      !aligned16(wo) || !aligned16(x8) || !aligned16(q16) ||
      !aligned16(kv16) || !aligned16(o) ||
      (cross && (kv8 == nullptr || !aligned16(kv8))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * N, krows = B * M, D = C / H;
  int sms = 0, stages = 0, smem = 0;
  err = sm_count(device, &sms);
  if (err == cudaSuccess)
    err = attn::launch_shape<false>(M, D, device, &stages, &smem);
  if (err != cudaSuccess) return (int)err;
  if (stages == 0) return (int)cudaErrorInvalidValue;

  const RowLn no_ln{nullptr, nullptr, 0.f};
  STEP(launch_quant_rows(x, 0, rows, C, no_ln, x8, xs, omax, nullptr, 0, s));
  if (cross) {
    STEP(launch_quant_rows(kv, 0, krows, C, no_ln, kv8, kvs, nullptr, nullptr,
                           0, s));
  } else {
    kv8 = x8;
    kvs = xs;
  }
  using Bf16Epi = BiasEpi<__nv_bfloat16, false>;
  const BiasEpi<__nv_bfloat16, true> qe{q16, C, xs, sq, bq, q_scale};
  STEP((launch_gemm<kBInt8, false>(x8, wq, qe, nullptr, nullptr, 0, rows, C,
                                   C, device, s)));
  STEP((launch_gemm<kBInt8, false>(kv8, wk, Bf16Epi{kv16, 2 * C, kvs, sk, bk,
                                                    1.f},
                                   nullptr, nullptr, 0, krows, C, C, device,
                                   s)));
  STEP((launch_gemm<kBInt8, false>(kv8, wv, Bf16Epi{kv16 + C, 2 * C, kvs, sv,
                                                    bv, 1.f},
                                   nullptr, nullptr, 0, krows, C, C, device,
                                   s)));
  const attn::Args a{q16, kv16, kv16 + C, C, 2 * C, kv_mask, M, 0, o, omax,
                     C, N, M, D, stages};
  STEP(attn::launch<false>(a, B, H, smem, s));
  STEP(launch_hidden_quant(o, omax, rows, C, x8, sms, s));
  const MlpFc2Epi<true> oe{y, omax, so, bo, x};
  STEP((launch_gemm<kBInt8, false>(x8, wo, oe, nullptr, nullptr, 0, rows, C,
                                   C, device, s)));
  STEP(int8k::launch_rows(y, ln_g, ln_b, eps, rows, C, out, s));
  return 0;
}
