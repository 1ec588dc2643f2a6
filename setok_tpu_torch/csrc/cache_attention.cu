// Decode attention over the int8 KV cache, dequantised in the kernel.
//
// Replaces setok_tpu/kernels/cache_attention.py:75
// (int8_cache_decode_attention). One query per row (a decode step); GQA
// folded as G = H / KVH query rows per (batch row, kv head). The TPU kernel
// is one Pallas program per (b, kv head) that holds the (S, D) int8 slabs in
// VMEM. Here one block per (b, kv head) does the same in three passes over
// shared memory, in the JAX kernel's order:
//
//   1. s[g][j] = (q[g] . K[j]) * (k_scale[j] * sm_scale), or -1e30 where the
//      key is masked (a warp reads D/16 lanes x 16 bytes per key row);
//   2. s - max, exp, divided by the sum (a true division); a fully masked
//      row is all -1e30, so it becomes the uniform average over all S keys;
//   3. out[g] = sum_j (p[g][j] * v_scale[j]) * V[j], each thread 4 columns
//      over a slice of the keys.
//
// Every sum (the q.K dots, the softmax sum, the PV sums) and the exp run in
// float64 and round to float32 once, and so does the plain version: the
// float32 results of exact sums, whatever the order. Summed in float32 in
// another order, the two differed in the last bit, and an int8 KV cache
// turns such a bit into a flipped rounding step of a cached K or V entry,
// which every later decode step reads (1e-2 on the logits of a 2-layer
// trunk after a few steps, measured on the card).
//
// What bounds it (H100 SXM data sheet): the cache bytes. At B = 4, S = 512,
// KVH = 32, D = 128 one layer reads 2 x 8.4 MB of int8 K/V plus 0.5 MB of
// scales, 5.2 us at 3.35 TB/s; its 16.8 M multiply-adds (in float64, 34
// TFLOP/s on the CUDA cores) take 0.5 us. This first version reads each
// slab once, with 16-byte (K) and 4-byte (V) loads, from B x KVH = 128
// blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ T block_reduce(T v, bool is_max, T* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = 16; o > 0; o >>= 1) {
    const T u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? (u > v ? u : v) : v + u;
  }
  __syncthreads();            // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kWarps; ++w)
    v = is_max ? (red[w] > v ? red[w] : v) : v + red[w];
  return v;
}

// q: (B, KVH*G, D) f32; k, v: (B, S, KVH, D) int8; ks, vs: (B, S, KVH) f32;
// valid: (B, S) bytes, nonzero = attend. out: (B, KVH*G, D) f32.
// Shared: q (G*D), scores/probabilities (G*S) f32; partial outputs
// (slices*G*D) and reduction scratch (kWarps) f64.
__global__ void __launch_bounds__(kThreads)
cache_attn_kernel(const float* __restrict__ q, const int8_t* __restrict__ k,
                  const float* __restrict__ ks, const int8_t* __restrict__ v,
                  const float* __restrict__ vs,
                  const uint8_t* __restrict__ valid, float* __restrict__ out,
                  float sm_scale, int S, int KVH, int G, int D) {
  extern __shared__ __align__(16) double smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slices = kThreads / (D / 4);
  double* part = smem;                            // slices x G x D
  double* red = part + slices * G * D;            // kWarps
  float* qs = reinterpret_cast<float*>(red + kWarps);   // G x D
  float* sc = qs + G * D;                         // G x S

  const float* qb = q + ((size_t)b * KVH + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = qb[i];
  __syncthreads();

  // 1. scores: LPK lanes per key, 16 columns each
  const int lpk = D / 16, kpw = 32 / lpk;
  const int sub = lane % lpk, d0 = sub * 16;
  for (int j0 = warp * kpw; j0 < S; j0 += kWarps * kpw) {
    const int j = j0 + lane / lpk;
    double dot[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) dot[g] = 0.0;
    if (j < S) {
      const size_t at = (((size_t)b * S + j) * KVH + h) * D + d0;
      const uint4 raw = *reinterpret_cast<const uint4*>(k + at);
      const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float* qr = qs + g * D + d0;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int kv = (int)(signed char)(w[i >> 2] >> (8 * (i & 3)));
          dot[g] = fma((double)qr[i], (double)kv, dot[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      for (int o = lpk / 2; o > 0; o >>= 1)
        dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
    }
    if (j < S && sub == 0) {
      const size_t row = (size_t)b * S + j;
      const float scale = __fmul_rn(ks[row * KVH + h], sm_scale);
      const bool on = valid[row] != 0;
      for (int g = 0; g < G; ++g)
        sc[(size_t)g * S + j] = on ? __fmul_rn((float)dot[g], scale) : kNegInf;
    }
  }
  __syncthreads();

  // 2. softmax of each row; then p * v_scale
  for (int g = 0; g < G; ++g) {
    float* sr = sc + (size_t)g * S;
    double m = -INFINITY;
    for (int j = tid; j < S; j += kThreads) m = fmax(m, (double)sr[j]);
    const float mf = (float)block_reduce(m, true, red);
    double l = 0.0;
    for (int j = tid; j < S; j += kThreads) {
      const float p = (float)exp((double)__fsub_rn(sr[j], mf));
      sr[j] = p;
      l += p;
    }
    const float lf = (float)block_reduce(l, false, red);
    for (int j = tid; j < S; j += kThreads)
      sr[j] = __fmul_rn(__fdiv_rn(sr[j], lf),
                        vs[((size_t)b * S + j) * KVH + h]);
  }
  __syncthreads();

  // 3. out = pv . V: thread (slice, column group of 4)
  const int cg = tid % (D / 4), slice = tid / (D / 4);
  double acc[kMaxG][4];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[g][c] = 0.0;
  for (int j = slice; j < S; j += slices) {
    const char4 v4 = *reinterpret_cast<const char4*>(
        v + (((size_t)b * S + j) * KVH + h) * D + cg * 4);
    const double vv[4] = {(double)v4.x, (double)v4.y, (double)v4.z,
                          (double)v4.w};
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const double p = sc[(size_t)g * S + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][c] = fma(p, vv[c], acc[g][c]);
    }
  }
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      part[((size_t)slice * G + g) * D + cg * 4 + c] = acc[g][c];
  __syncthreads();
  float* ob = out + ((size_t)b * KVH + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    double o = part[i];
    for (int s = 1; s < slices; ++s) o += part[(size_t)s * G * D + i];
    ob[i] = (float)o;
  }
}

size_t smem_bytes(int S, int G, int D) {
  const int slices = kThreads / (D / 4);
  return sizeof(double) * ((size_t)slices * G * D + kWarps) +
         sizeof(float) * ((size_t)G * D + (size_t)G * S);
}

}  // namespace

extern "C" int int8_cache_decode_attention_f32(
    const float* q, const int8_t* k, const float* ks, const int8_t* v,
    const float* vs, const uint8_t* valid, float* out, float sm_scale, int B,
    int S, int KVH, int G, int D, int device, void* stream, int* launched) {
  *launched = 0;
  // D a power of two in [16, 512]: whole 16-byte chunks per lane and whole
  // 4-column groups per thread
  if (B < 1 || S < 1 || KVH < 1 || G < 1 || G > kMaxG || D < 16 || D > 512 ||
      (D & (D - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S, G, D);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(cache_attn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cache_attn_kernel<<<dim3(KVH, B), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      q, k, ks, v, vs, valid, out, sm_scale, S, KVH, G, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return 0;
}
