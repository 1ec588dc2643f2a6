// Whole-sequence int8 self-attention of the unfused route:
// out = proj(softmax(q.k^T + mask bias) v), qkv = int8 product of x.
//
// Replaces setok_tpu/kernels/fused_attention_int8.py:84 fused_attention_int8,
// the attention that the JAX package's Attention(quant8) takes where its
// whole-sublayer kernel does not fit (the tokenizer Blocks when their MLP is
// 4096 wide). The TPU kernel is one Pallas program per image that keeps qkv
// and the scores in VMEM. Here it is a chain of launches with the
// intermediates in device memory, on the pieces of row 2
// (fused_sublayer.cu):
//
//   quant_rows_kernel  x -> x8, xs (no LN); clears omax
//   wgmma GEMM, qkv    (acc * xs) * s + b in f32 (the softmax scale arrives
//                      folded into the q columns of s and b: the wrapper
//                      does it, as the JAX wrapper does)
//   attn_mma_kernel    attn_mma.cuh's f32 form over the (B*N, 3C) qkv rows,
//                      the (B, N, N) mask as a -1e30 * (1 - m) bias: f64
//                      scores and P.V on the FP64 tensor cores, the exact
//                      softmax with p in f32; o in f32 and each row's |o|
//                      maximum by atomicMax on its bits
//   hidden_quant       o -> int8 over the whole C, one read
//   wgmma GEMM, proj   (acc * os) * s + b_proj            5 launches
//
// Unlike attn_sublayer_int8 the JAX kernel keeps q, k, v, the scores, p and
// PV in float32: no bf16 cast. An f32 x f32 product is exact in f64, so the
// scores and PV are float64 sums rounded once, as the plain version takes
// them (float64 products, exact_scores=True, exact_pv=True). A TF32
// product (~1e-3) would flip int8 steps of o; a float32 sum in another
// order than the plain version's flips some too. A fully masked row gives o
// = 0 and out = b_proj.
//
// What bounds it (chip_smoke.unfused_bound; H100 SXM data sheet, B=64
// images of N=256, C=768, 2 heads of 384): the int8 products, 2*B*N*C*4C =
// 77.3 G operations (39 us at 1,979 TOP/s), plus the f32 attention products
// over the unmasked score cells, 4*C per cell at 67 TFLOP/s: 0.231 ms with
// no mask, 0.0780 ms at the inner Block's cluster mask (20 % of the cells).
// PERF.md carries its times beside that bound.

#include "attn_mma.cuh"

using namespace wg;

// x, out: (B*N, C) f32. w_qkv (3C, C) int8 with scales s_qkv and bias b_qkv
// (3C), the q columns pre-scaled; w_proj (C, C). mask: (B, N, N) bytes,
// nonzero = attend, or null. Scratch, each 16-byte aligned: x8 (B*N*C) int8
// (then o's int8 rows), xs (B*N), qkv (B*N*3C) f32, o (B*N*C) f32, omax
// (B*N) u32. Takes C % 16 == 0, D = C / H a multiple of 16, N <= 768 and a
// shared-memory need within the card's: else cudaErrorInvalidValue, nothing
// launched. Each launch counts one in *launched; returns the CUDA error of
// the first launch that failed, else 0.
extern "C" int fused_attention_int8_f32(
    const float* x, const int8_t* w_qkv, const float* s_qkv,
    const float* b_qkv, const int8_t* w_proj, const float* s_proj,
    const float* b_proj, const uint8_t* mask, float* out, int8_t* x8,
    float* xs, float* qkv, float* o, unsigned* omax, int B, int N, int C,
    int H, int device, void* stream, int* launched) {
  *launched = 0;
  if (!attn::takes(B, N, N, C, H) || C % 16 != 0 || !aligned16(x) ||
      !aligned16(w_qkv) || !aligned16(w_proj) || !aligned16(x8) ||
      !aligned16(qkv) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N, D = C / H;
  int sms = 0, stages = 0, smem = 0;
  err = sm_count(device, &sms);
  if (err == cudaSuccess)
    err = attn::launch_shape<true>(N, D, device, &stages, &smem);
  if (err != cudaSuccess) return (int)err;
  if (stages == 0) return (int)cudaErrorInvalidValue;

  STEP(launch_quant_rows(x, 0, M, C, RowLn{nullptr, nullptr, 0.f}, x8, xs,
                         omax, nullptr, 0, s));
  const BiasEpi<float, false> qkv_epi{qkv, 3 * C, xs, s_qkv, b_qkv, 1.f};
  STEP((launch_gemm<kBInt8, false>(x8, w_qkv, qkv_epi, nullptr, nullptr, 0,
                                   M, 3 * C, C, device, s)));
  const attn::Args a{qkv, qkv + C, qkv + 2 * C, 3 * C, 3 * C, mask,
                     (long long)N * N, N, o, omax, C, N, N, D, stages};
  STEP(attn::launch<true>(a, B, H, smem, s));
  STEP(launch_hidden_quant(o, omax, M, C, x8, sms, s));
  const MlpFc2Epi<false> proj{out, omax, s_proj, b_proj, nullptr};
  STEP((launch_gemm<kBInt8, false>(x8, w_proj, proj, nullptr, nullptr, 0, M,
                                   C, C, device, s)));
  return 0;
}
