// The int8 MLP of the unfused route: out = fc2(gelu_tanh(fc1(x))).
//
// Replaces setok_tpu/kernels/fused_mlp.py:46 fused_mlp_int8, the MLP that
// the JAX package's Mlp(quant8) takes where its whole-sublayer kernel does
// not fit (the ViT, the inner Block and the pixel decoder at 384 px). The
// TPU kernel is one Pallas program per 256 rows that keeps the (rows x
// hidden) intermediate in VMEM. Here it is a chain of four launches, both
// products on the persistent wgmma GEMM of wgmma_s8.cuh, whose epilogues
// and hidden pass rows 3 and 5 (fused_sublayer.cu) share:
//
//   quant_rows_kernel   x (float32 or bfloat16, widened exactly) -> x8, xs;
//                       clears hmax
//   wgmma GEMM, fc1     h = gelu_tanh((acc * xs) * s1 + b1), f32 to device
//                       memory; each thread's |h| maximum over its fragment
//                       row, reduced over the 4 lanes that share the row,
//                       posted with one atomicMax on the float's bits into
//                       hmax[row] (non-negative floats order as their bits,
//                       and a maximum is order-free: exact)
//   hidden_quant_kernel h -> h8 with hs = max(hmax, 1e-8) / 127: one read
//                       of h
//   wgmma GEMM, fc2     y = (acc * hs) * s2 + b2, f32
//
// The numerics are the JAX kernel's: xs = max(absmax, 1e-8)/127 per row (a
// true division), h row-quantised over the whole hidden width, every
// multiply and add of the epilogues rounded as written (__fmul_rn /
// __fadd_rn), the GELU of int8_sublayer.cuh.
//
// What bounds it (H100 SXM data sheet, B=64 images of N=576, C=768,
// H=3072): the int8 products, 4*M*C*H = 348 G operations at M = 36864
// rows, 176 us at 1979 TOP/s, against 226 MB of f32 input and output
// (68 us). The f32 hidden rows (453 MB written and read once) and their
// int8 copy (113 MB written and read once) add 0.35 ms of device memory
// traffic that the TPU kernel keeps in VMEM; PERF.md carries the times.

#include "wgmma_s8.cuh"

using namespace wg;

// x: (M, C) of x_type (0 float32, 1 bfloat16), out: (M, Co) f32; w1 (Hd, C),
// w2 (Co, Hd) int8 with per-row scales s1, s2 and biases b1, b2. Scratch,
// each 16-byte aligned: x8 (M*C) int8, xs (M) f32, h (M*Hd) f32, h8 (M*Hd)
// int8, hmax (M) u32. Each launch counts one in *launched; returns the CUDA
// error of the first launch that failed, else 0.
extern "C" int fused_mlp_int8(const void* x, int x_type, const int8_t* w1,
                              const float* s1, const float* b1,
                              const int8_t* w2, const float* s2,
                              const float* b2, float* out, int8_t* x8,
                              float* xs, float* h, int8_t* h8,
                              unsigned* hmax, int M, int C, int Hd, int Co,
                              int device, void* stream, int* launched) {
  *launched = 0;
  if (M < 1 || C < 16 || C % 16 != 0 || Hd < 16 || Hd % 16 != 0 || Co < 1 ||
      (x_type != 0 && x_type != 1) || !aligned16(x) || !aligned16(w1) ||
      !aligned16(w2) || !aligned16(x8) || !aligned16(h) || !aligned16(h8))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return (int)err;

  STEP(launch_quant_rows(x, x_type, M, C, RowLn{nullptr, nullptr, 0.f}, x8,
                         xs, hmax, nullptr, 0, s));
  STEP((launch_gemm<kBInt8, false>(x8, w1, MlpFc1Epi{h, xs, s1, b1, hmax},
                                   nullptr, nullptr, 0, M, Hd, C, device,
                                   s)));
  STEP(launch_hidden_quant(h, hmax, M, Hd, h8, sms, s));
  const MlpFc2Epi<false> fc2{out, hmax, s2, b2, nullptr};
  STEP((launch_gemm<kBInt8, false>(h8, w2, fc2, nullptr, nullptr, 0, M, Co,
                                   Hd, device, s)));
  return 0;
}
