// The int8 transformer sublayers of the ViT, the tokenizer Blocks, the pixel
// decoder and the Q-Former FFN.
//
// Replaces setok_tpu/kernels/fused_sublayer.py:
//   attn_sublayer_int8  out = x + proj(attn(qkv(LN x)))         (:196)
//   mlp_sublayer_int8   out = x + fc2(gelu_tanh(fc1(LN x)))     (:347)
//   mlp_postnorm_int8   out = LN(x + fc2(gelu_tanh(fc1 x)))     (:304)
// Each TPU kernel is one Pallas program per image or per 256 rows that keeps
// everything in VMEM. Here each is a chain of the kernels of
// int8_sublayer.cuh, with the intermediates in device memory:
//
//   attention  rows(LN, quant) -> gemm(qkv, bf16 out) -> attn
//              -> rows(quant) -> gemm(proj, + x)                 5 launches
//   MLP        rows(LN, quant) -> gemm(fc1, gelu) -> rows(quant)
//              -> gemm(fc2, + x)                                 4 launches
//   post-norm  rows(quant) -> gemm(fc1, gelu) -> rows(quant)
//              -> gemm(fc2, + x) -> rows(LN)                     5 launches
//
// The attention's softmax scale arrives folded into the q columns of the
// qkv scales and bias (the wrapper does it, as the JAX wrapper does).
//
// What bounds them (H100 SXM data sheet, B=64 images of N=256, C=768):
// the int8 products. Attention: 2*B*N*C*4C = 77.3 G int8 operations (39 us
// at 1979 TOP/s) plus 4*B*N^2*C = 12.9 G bf16 (13 us at 989 TFLOP/s),
// against 30 us of f32 input and output. MLPs: 4*M*C*3072 = 154.6 G at
// M = 16384 rows, 78 us. This first version does the int8 products with
// mma.sync (not wgmma) from a two-stage cp.async ring and the attention's
// bf16 products on the CUDA cores, and moves every intermediate through
// device memory: it is far from those bounds, and PERF.md carries its times.

#include "int8_sublayer.cuh"

using namespace int8k;

namespace {

bool gemm_shape_ok(int N, int K) { return N >= 2 && N % 2 == 0 && K % 16 == 0; }

}  // namespace

// x, out: (B*N, C) f32. w_qkv (3C, C) int8 with scales s_qkv and bias b_qkv
// (3C), the q columns pre-scaled; w_proj (C, C). mask: (B, N, N) bytes,
// nonzero = attend, or null. Scratch: x8 (B*N*C) int8, xs (B*N), qkv
// (B*N*3C) bf16, o (B*N*C) f32.
extern "C" int attn_sublayer_int8_f32(
    const float* x, const float* ln_g, const float* ln_b, float ln_eps,
    const int8_t* w_qkv, const float* s_qkv, const float* b_qkv,
    const int8_t* w_proj, const float* s_proj, const float* b_proj,
    const uint8_t* mask, float* out, int8_t* x8, float* xs,
    __nv_bfloat16* qkv, float* o, int B, int N, int C, int H, int device,
    void* stream, int* launched) {
  *launched = 0;
  if (B < 1 || N < 1 || N > kMaxKeys || H < 1 || C % H != 0 ||
      (C / H) % 4 != 0 || !gemm_shape_ok(C, C))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N, D = C / H;

  STEP(launch_rows(x, ln_g, ln_b, ln_eps, M, C, x8, xs, nullptr, s));
  STEP(launch_gemm<kBf16>(x8, xs, w_qkv, s_qkv, b_qkv, nullptr, qkv, 3 * C,
                          1.0f, M, 3 * C, C, s));
  STEP(launch_attn(qkv, (long long)N * 3 * C, 3 * C, qkv + C, qkv + 2 * C,
                   (long long)N * 3 * C, 3 * C, mask, (long long)N * N, N, o,
                   (long long)N * C, C, B, H, N, N, D, s));
  STEP(launch_rows(o, nullptr, nullptr, 0.f, M, C, x8, xs, nullptr, s));
  STEP(launch_gemm<kResid>(x8, xs, w_proj, s_proj, b_proj, x, out, C, 1.0f, M,
                           C, C, s));
  return 0;
}

// x, out: (M, C) f32; w1 (Hd, C), w2 (C, Hd) int8 with per-row scales.
// ln_g == null: the post-norm form (no LN before fc1, LN(ln2_g, ln2_b)
// after the residual). Scratch: x8 (M*C), xs (M), h (M*Hd) f32, h8 (M*Hd),
// hs (M), z (M*C) f32 (post-norm only).
extern "C" int mlp_int8_f32(
    const float* x, const float* ln_g, const float* ln_b, float ln_eps,
    const int8_t* w1, const float* s1, const float* b1, const int8_t* w2,
    const float* s2, const float* b2, const float* ln2_g, const float* ln2_b,
    float ln2_eps, float* out, int8_t* x8, float* xs, float* h, int8_t* h8,
    float* hs, float* z, int M, int C, int Hd, int device, void* stream,
    int* launched) {
  *launched = 0;
  const bool post = ln2_g != nullptr;
  if (M < 1 || !gemm_shape_ok(Hd, C) || !gemm_shape_ok(C, Hd) ||
      (post && (ln_g != nullptr || z == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  STEP(launch_rows(x, ln_g, ln_b, ln_eps, M, C, x8, xs, nullptr, s));
  STEP(launch_gemm<kGelu>(x8, xs, w1, s1, b1, nullptr, h, Hd, 1.0f, M, Hd, C,
                          s));
  STEP(launch_rows(h, nullptr, nullptr, 0.f, M, Hd, h8, hs, nullptr, s));
  STEP(launch_gemm<kResid>(h8, hs, w2, s2, b2, x, post ? z : out, C, 1.0f, M,
                           C, Hd, s));
  if (post)
    STEP(launch_rows(z, ln2_g, ln2_b, ln2_eps, M, C, nullptr, nullptr, out,
                     s));
  return 0;
}
