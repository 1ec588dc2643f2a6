// The int8 transformer sublayers of the ViT, the tokenizer Blocks, the pixel
// decoder and the Q-Former FFN.
//
// Replaces setok_tpu/kernels/fused_sublayer.py:
//   attn_sublayer_int8  out = x + proj(attn(qkv(LN x)))         (:196)
//   mlp_sublayer_int8   out = x + fc2(gelu_tanh(fc1(LN x)))     (:347)
//   mlp_postnorm_int8   out = LN(x + fc2(gelu_tanh(fc1 x)))     (:304)
// Each TPU kernel is one Pallas program per image or per 256 rows that keeps
// everything in VMEM.
//
// What bounds them (H100 SXM data sheet, B=64 images of N=256, C=768): the
// int8 products. Attention: 2*B*N*C*4C = 77.3 G int8 operations (39 us at
// 1,979 TOP/s) plus 4*B*N^2*C = 12.9 G bf16 for the scores and PV (13 us at
// 989 TFLOP/s): 0.0521 ms, against 30 us for the f32 input and output. MLP:
// 4*M*C*3072 = 154.6 G int8 operations at M = 16,384 rows, 0.0781 ms.
//
// What the design does: a block on Hopper has at most 227 KB of shared
// memory, so each sublayer is a chain of launches with the intermediates in
// device memory, the int8 products on the persistent wgmma GEMM of
// wgmma_s8.cuh (TMA ring, m64n256k32 s8, exact s32 sums) and the pieces of
// the unfused MLP (fused_mlp.cu, row 6) shared:
//
//   attention  quant_rows_kernel  LN and quantisation in one read of x (the
//                                 row in registers, f64 statistics rounded
//                                 once); clears omax
//              wgmma GEMM, qkv    bf16((acc * xs) * s + b), the q columns'
//                                 s and b pre-multiplied by the softmax
//                                 scale (the wrapper folds it, as JAX does)
//              attn_mma_kernel    the attention on the tensor cores (below,
//                                 attn_mma.cuh, shared with rows 4 and 7);
//                                 o in f32 and each row's |o| maximum over
//                                 the heads, by atomicMax on its bits
//              hidden_quant       o -> int8 with max(omax, 1e-8) / 127, one
//                                 read of o
//              wgmma GEMM, proj   x + ((acc * os) * s + b)      5 launches
//   MLP        quant_rows_kernel  LN and quantisation (as above); clears hmax
//              wgmma GEMM, fc1    gelu_tanh((acc * xs) * s1 + b1), f32, and
//                                 the rows' |h| maxima by atomicMax
//              hidden_quant       h -> int8, one read of h
//              wgmma GEMM, fc2    x + ((acc * hs) * s2 + b2)    4 launches
//   post-norm  as the MLP without the LN in front, the residual epilogue
//              writing z, then rows_kernel: LN(z)               5 launches
//
// Every multiply and add is rounded as written (__fmul_rn / __fadd_rn), in
// the JAX kernels' order, the residual added last: the MLPs give their plain
// versions' values to the bit.
//
// The attention is attn_mma.cuh's tensor-core kernel over the bf16 qkv
// rows: exact scores on the FP64 tensor cores, rounded once to f32 (the
// plain version's scores are the same exact values, a float64 product), the
// exact full-row softmax in shared memory, bf16 P.V on mma.sync m16n8k16.
// Scores summed in float32 in any other order than the plain version's flip
// enough bf16 roundings of p, and the int8 steps of o behind them, to fail
// the 0.99 share bar: a float32 plain version against its own float64-score
// twin reads 0.985 at chip_smoke.py's B = 4 ViT case (NVIDIA H100 80GB
// HBM3, 700 W), and a bf16 MMA of the scores (each 16-wide slice of D from
// zero) fell under the bar at B = 3 and 4.

#include "attn_mma.cuh"

using namespace wg;

// x, out: (B*N, C) f32. w_qkv (3C, C) int8 with scales s_qkv and bias b_qkv
// (3C), the q columns pre-scaled; w_proj (C, C). mask: (B, N, N) bytes,
// nonzero = attend, or null. Scratch, each 16-byte aligned: x8 (B*N*C)
// int8 (then o's int8 rows), xs (B*N) f32, qkv (B*N*3C) bf16, o (B*N*C) f32,
// omax (B*N) u32. Takes C % 16 == 0, C <= 1024, D = C / H a multiple of 16,
// N <= 768 and a shared-memory need within the card's: else
// cudaErrorInvalidValue, nothing launched. Each launch counts one in
// *launched; returns the CUDA error of the first launch that failed, else 0.
extern "C" int attn_sublayer_int8_f32(
    const float* x, const float* ln_g, const float* ln_b, float ln_eps,
    const int8_t* w_qkv, const float* s_qkv, const float* b_qkv,
    const int8_t* w_proj, const float* s_proj, const float* b_proj,
    const uint8_t* mask, float* out, int8_t* x8, float* xs,
    __nv_bfloat16* qkv, float* o, unsigned* omax, int B, int N, int C, int H,
    int device, void* stream, int* launched) {
  *launched = 0;
  if (!attn::takes(B, N, N, C, H) || C % 16 != 0 || C > kRowHeld ||
      !aligned16(x) ||
      !aligned16(ln_g) || !aligned16(ln_b) || !aligned16(w_qkv) ||
      !aligned16(w_proj) || !aligned16(x8) || !aligned16(qkv) ||
      !aligned16(o))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N, D = C / H;
  int sms = 0, stages = 0, smem = 0;
  err = sm_count(device, &sms);
  if (err == cudaSuccess)
    err = attn::launch_shape<false>(N, D, device, &stages, &smem);
  if (err != cudaSuccess) return (int)err;
  if (stages == 0) return (int)cudaErrorInvalidValue;

  STEP(launch_quant_rows(x, 0, M, C, RowLn{ln_g, ln_b, ln_eps}, x8, xs, omax,
                         nullptr, 0, s));
  const BiasEpi<__nv_bfloat16, false> qkv_epi{qkv, 3 * C, xs, s_qkv, b_qkv,
                                              1.f};
  STEP((launch_gemm<kBInt8, false>(x8, w_qkv, qkv_epi, nullptr, nullptr, 0, M,
                                   3 * C, C, device, s)));
  const attn::Args a{qkv, qkv + C, qkv + 2 * C, 3 * C, 3 * C, mask,
                     (long long)N * N, N, o, omax, C, N, N, D, stages};
  STEP(attn::launch<false>(a, B, H, smem, s));
  STEP(launch_hidden_quant(o, omax, M, C, x8, sms, s));
  const MlpFc2Epi<true> proj{out, omax, s_proj, b_proj, x};
  STEP((launch_gemm<kBInt8, false>(x8, w_proj, proj, nullptr, nullptr, 0, M,
                                   C, C, device, s)));
  return 0;
}

// x, out: (M, C) f32; w1 (Hd, C), w2 (C, Hd) int8 with per-row scales.
// ln_g == null: the post-norm form (no LN before fc1, LN(ln2_g, ln2_b)
// after the residual). Scratch, each 16-byte aligned: x8 (M*C) int8, xs
// (M) f32, h (M*Hd) f32, h8 (M*Hd) int8, hmax (M) u32, z (M*C) f32
// (post-norm only). Takes C and Hd multiples of 16 and, with the LN in
// front, C <= 1024: else cudaErrorInvalidValue, nothing launched.
extern "C" int mlp_int8_f32(
    const float* x, const float* ln_g, const float* ln_b, float ln_eps,
    const int8_t* w1, const float* s1, const float* b1, const int8_t* w2,
    const float* s2, const float* b2, const float* ln2_g, const float* ln2_b,
    float ln2_eps, float* out, int8_t* x8, float* xs, float* h, int8_t* h8,
    unsigned* hmax, float* z, int M, int C, int Hd, int device, void* stream,
    int* launched) {
  *launched = 0;
  const bool post = ln2_g != nullptr;
  if (M < 1 || C < 16 || C % 16 != 0 || Hd < 16 || Hd % 16 != 0 ||
      (post && (ln_g != nullptr || z == nullptr)) ||
      (ln_g != nullptr &&
       (C > kRowHeld || !aligned16(ln_g) || !aligned16(ln_b))) ||
      !aligned16(x) || !aligned16(w1) || !aligned16(w2) || !aligned16(x8) ||
      !aligned16(h) || !aligned16(h8))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return (int)err;

  STEP(launch_quant_rows(x, 0, M, C, RowLn{ln_g, ln_b, ln_eps}, x8, xs, hmax,
                         nullptr, 0, s));
  STEP((launch_gemm<kBInt8, false>(x8, w1, MlpFc1Epi{h, xs, s1, b1, hmax},
                                   nullptr, nullptr, 0, M, Hd, C, device,
                                   s)));
  STEP(launch_hidden_quant(h, hmax, M, Hd, h8, sms, s));
  const MlpFc2Epi<true> fc2{post ? z : out, hmax, s2, b2, x};
  STEP((launch_gemm<kBInt8, false>(h8, w2, fc2, nullptr, nullptr, 0, M, C, Hd,
                                   device, s)));
  if (post)
    STEP(int8k::launch_rows(z, ln2_g, ln2_b, ln2_eps, M, C, out, s));
  return 0;
}
