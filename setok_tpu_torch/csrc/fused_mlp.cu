// The int8 MLP of the unfused route: out = fc2(gelu_tanh(fc1(x))).
//
// Replaces setok_tpu/kernels/fused_mlp.py:46 fused_mlp_int8, the MLP that
// the JAX package's Mlp(quant8) takes where its whole-sublayer kernel does
// not fit (the ViT, the inner Block and the pixel decoder at 384 px). The
// TPU kernel is one Pallas program per 256 rows that keeps the (rows x
// hidden) intermediate in VMEM. Here it is a chain of the kernels of
// int8_sublayer.cuh, with the intermediates in device memory:
//
//   rows(quant x) -> gemm(fc1, gelu) -> rows(quant h) -> gemm(fc2, + b2)
//                                                             4 launches
//
// mlp_sublayer_int8 of fused_sublayer.cu without its LayerNorm and its
// residual. The numerics are the JAX kernel's: xs = max(absmax, 1e-8)/127
// per row (a true division), h = (acc*xs)*s1 + b1, the tanh GELU, h
// row-quantised over the whole hidden width, y = (acc*hs)*s2 + b2, f32.
//
// What bounds it (H100 SXM data sheet, B=64 images of N=576, C=768,
// H=3072): the int8 products, 4*M*C*H = 348 G operations at M = 36864
// rows, 176 us at 1979 TOP/s, against 226 MB of f32 input and output
// (68 us). This first version multiplies with mma.sync from a two-stage
// cp.async ring and moves the f32 and int8 hidden rows through device
// memory; PERF.md carries its times beside that bound.

#include "int8_sublayer.cuh"

using namespace int8k;

// x: (M, C) f32, out: (M, Co) f32; w1 (Hd, C), w2 (Co, Hd) int8 with
// per-row scales s1, s2 and biases b1, b2. Scratch: x8 (M*C) int8, xs (M),
// h (M*Hd) f32, h8 (M*Hd) int8, hs (M).
extern "C" int fused_mlp_int8_f32(
    const float* x, const int8_t* w1, const float* s1, const float* b1,
    const int8_t* w2, const float* s2, const float* b2, float* out,
    int8_t* x8, float* xs, float* h, int8_t* h8, float* hs, int M, int C,
    int Hd, int Co, int device, void* stream, int* launched) {
  *launched = 0;
  if (M < 1 || C % 16 != 0 || Hd < 2 || Hd % 16 != 0 || Co < 2 || Co % 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  STEP(launch_rows(x, nullptr, nullptr, 0.f, M, C, x8, xs, nullptr, s));
  STEP(launch_gemm<kGelu>(x8, xs, w1, s1, b1, nullptr, h, Hd, 1.0f, M, Hd, C,
                          s));
  STEP(launch_rows(h, nullptr, nullptr, 0.f, M, Hd, h8, hs, nullptr, s));
  STEP(launch_gemm<kF32>(h8, hs, w2, s2, b2, nullptr, out, Co, 1.0f, M, Co,
                         Hd, s));
  return 0;
}
