// The int8 GEMM of Hopper's warpgroup MMA, shared by quant_matmul.cu (w8a8
// and w4a8, rows 8 and 9 of PERF.md's kernel table), fused_mlp.cu (row 6),
// fused_sublayer.cu (rows 2, 3 and 5), fused_bert_attention_int8.cu (row 4)
// and fused_attention_int8.cu (row 7), the row quantisation pass that feeds
// it, and the epilogues and the hidden rows' pass of the int8 MLPs and the
// attention sublayers.
//
//   quant_rows_kernel  x (float32, bfloat16 or float16) -> x8, xs, with an
//                      optional LayerNorm in front; s = max(absmax, 1e-8) /
//                      127, q = clip(rint(x / s), +-127), a warp per row, 8
//                      values a 16-byte load, a row of <= 1024 read once
//   wgmma_gemm_kernel<BSRC, Epi>
//                      out = Epi(A . B^T), A (M, K) int8 row-major, B in the
//                      torch (out, in) layout, exact s32 sums
//   hidden_quant_kernel  a row whose |max| an epilogue posted -> int8, one
//                      read
//
// The GEMM is persistent and warp-specialised: one block per SM walking the
// output tiles, consumer warpgroups and one producer warpgroup. A producer warpgroup's one thread keeps TMA
// loads of 128-byte-wide k-slices in flight into a four-stage ring
// (128-byte swizzle, mbarriers; TMA zero-fills past M, N and K), and two
// consumer warpgroups run wgmma.mma_async ... s32.s8.s8 with both operands
// K-major in shared memory, as int8 wgmma requires. A consumer releases a
// stage once its next stage's products are issued; the epilogue of a tile
// overlaps the producer's loads of the next.
//
// The B-tile source (BSRC):
//   kBInt8     B is an int8 (N, K) matrix, TMA'd straight into the wgmma
//              tile. 128 x 256 output tiles, each consumer 64 rows x 256
//              columns (m64n256k32, 128 s32 registers a thread).
//   kBNibbles  B is half-packed int4, (N, K/2) bytes: logical input row i in
//              the low nibble of byte i, row i + K/2 in its high nibble. The
//              packed tile is TMA'd with the same 128-byte swizzle, and each
//              consumer unpacks its own 128 columns' bytes into an int8 B
//              tile in shared memory (a swizzled 16-byte unit of the packed
//              tile unpacks into the same unit of the B tile, so the unpack
//              is elementwise), then fence.proxy.async and a warpgroup
//              barrier before the wgmma that reads it. 64 x 256 output
//              tiles, four consumers of 64 rows x 64 columns each
//              (m64n64k32, 32 s32 registers): no consumer waits on
//              another's unpack, and four chains of unpack, products and
//              group folds interleave on the tensor cores.
//              The k walk goes plane by plane, the low nibbles' K/2 rows
//              first (the packed tile of a k-slice is loaded once for each
//              plane; the second load hits L2). With group scales (G rows
//              a group, G % 32 == 0, one group's rows in one plane) the
//              group's exact s32 sum is folded into a float32 accumulator
//              at its last k32 step, acc_f = acc_f + float(dot_g) * s[g] in
//              the group order (__fmul_rn / __fadd_rn), and the next group
//              starts its sum with scale-d = 0. The nibbles go into the B
//              tile as unsigned bytes n ^ 8 (the signed value + 8: one
//              logic operation a word) and the products are s8 x u8; 8 x
//              the row sums of x8 over the group (or all of K), from the
//              row pass, come off each exact sum.
//
// The epilogue (Epi) gets each consumer thread's fragment: the exact s32
// sums, or the float32 acc_f under group scales. Value 4j + 2h + e of the
// fragment is row r0 + 8h, column c0 + 8j + e.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from
                   // libcuda at run time (dlsym), nothing is linked
#include <cuda_fp16.h>
#include <dlfcn.h>

#include "int8_sublayer.cuh"   // STEP, the warp sums, gelu_tanh

namespace wg {

using int8k::warp_max;

// ---------------------------------------------------------------------------
// x in its own type, 8 values (16-byte loads), and the output type's stores

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __half* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
// x_type 0 float32, 1 bfloat16, 2 float16 (exact in float32)
__device__ __forceinline__ void load8(const void* x, int x_type, size_t i,
                                      float (&v)[8]) {
  if (x_type == 0)
    load8(static_cast<const float*>(x) + i, v);
  else if (x_type == 1)
    load8(static_cast<const __nv_bfloat16*>(x) + i, v);
  else
    load8(static_cast<const __half*>(x) + i, v);
}

// eight values quantised with scale s, packed into two words
__device__ __forceinline__ uint2 quant8(const float (&v)[8], float s) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = (int)fminf(fmaxf(rintf(v[i] / s), -127.f), 127.f);
    w[i >> 2] |= (uint32_t)(q & 0xff) << (8 * (i & 3));
  }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(__half* p, float v) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// columns col, col + 1 of an (M, N) row-major output row (two: col + 1 < N)
template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* p, bool two, bool pairs,
                                           float v0, float v1) {
  if (two && pairs) {
    store2(p, v0, v1);
  } else {
    store1(p, v0);
    if (two) store1(p + 1, v1);
  }
}

// ---------------------------------------------------------------------------
// Row quantisation, a warp per row. K % 8 == 0 and x 16-byte aligned, so
// every row starts on a 16-byte boundary. A row of at most kRowHeld values
// (8 per lane per load, kRowLoads loads) stays in the lane's registers and
// is read once; a longer one is read twice (its maximum, then its values),
// each lane with kRowLoads 16-byte loads in flight: so400m's 5,832 rows of
// 4304 are less than one wave of warps, each a long chain of loads.
// ln.g != nullptr (rows of at most kRowHeld): the row's LayerNorm first,
// (x - mu) * r * g + b in float32 with mu, the variance and r = rsqrt(var +
// eps) from float64 sums rounded to float32 once (the plain `layernorm`'s
// values, whatever the order of the sums). clear != nullptr: clear[row] =
// 0 too (a buffer that a later launch of the chain reduces into). rsum !=
// nullptr: the row's sums of q over each run of gsize columns, rsum[row *
// K / gsize + run] (gsize % 8 == 0, K % gsize == 0).

constexpr int kRowThreads = 256;
constexpr int kRowLoads = 4;
constexpr int kRowHeld = kRowLoads * 32 * 8;

// the LayerNorm in front of the quantisation: g, b (K) float32, 16-byte
// aligned, or g == nullptr for none
struct RowLn {
  const float* g;
  const float* b;
  float eps;
};

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
quant_rows_kernel(const T* __restrict__ x, int M, int K, RowLn ln,
                  int8_t* __restrict__ q8, float* __restrict__ scale,
                  unsigned* __restrict__ clear, int* __restrict__ rsum,
                  int gsize) {
  constexpr int kStep = 32 * 8;   // values a sweep of the warp
  const int row = (blockIdx.x * kRowThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  const bool held = K <= kRowHeld;
  float v[kRowLoads][8];
  float m = 0.f;
  if (held) {
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u)
      if (lane * 8 + u * kStep < K) load8(xr + lane * 8 + u * kStep, v[u]);
    if (ln.g != nullptr) {
      double sum = 0.0;
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u)
        if (lane * 8 + u * kStep < K)
#pragma unroll
          for (int i = 0; i < 8; ++i) sum += (double)v[u][i];
      const float mu = (float)(int8k::warp_sum(sum) / (double)K);
      double sq = 0.0;
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u)
        if (lane * 8 + u * kStep < K)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const double d = (double)__fsub_rn(v[u][i], mu);
            sq += d * d;
          }
      const float var = (float)(int8k::warp_sum(sq) / (double)K);
      const float r = (float)rsqrt((double)__fadd_rn(var, ln.eps));
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int c = lane * 8 + u * kStep;
        if (c < K) {
          float g[8], b[8];
          load8(ln.g + c, g);
          load8(ln.b + c, b);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v[u][i] = __fadd_rn(
                __fmul_rn(__fmul_rn(__fsub_rn(v[u][i], mu), r), g[i]), b[i]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u)
      if (lane * 8 + u * kStep < K)
#pragma unroll
        for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(v[u][i]));
  } else {
    for (int c0 = lane * 8; c0 < K; c0 += kRowLoads * kStep) {
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u)
        if (c0 + u * kStep < K) load8(xr + c0 + u * kStep, v[u]);
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u)
        if (c0 + u * kStep < K)
#pragma unroll
          for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(v[u][i]));
    }
  }
  m = warp_max(m);
  const float s = fmaxf(m, 1e-8f) / 127.0f;
  int8_t* qr = q8 + (size_t)row * K;
  const int n_rs = rsum != nullptr ? K / gsize : 0;
  int* rs = rsum + (size_t)row * n_rs;
  if (n_rs > 1) {
    for (int i = lane; i < n_rs; i += 32) rs[i] = 0;
    __syncwarp();
  }
  int total = 0;   // n_rs == 1: the lane's sum of q
  // the 8 values at column c: quantised, stored, and summed where asked
  auto put = [&](const float (&w)[8], int c) {
    const uint2 q = quant8(w, s);
    *reinterpret_cast<uint2*>(qr + c) = q;
    if (n_rs > 0) {
      // the 8 bytes' sum, exact: dp4a against ones
      const int sum = __dp4a((int)q.x, 0x01010101, __dp4a((int)q.y,
                                                           0x01010101, 0));
      if (n_rs == 1)
        total += sum;
      else
        atomicAdd(rs + c / gsize, sum);
    }
  };
  if (held) {
#pragma unroll
    for (int u = 0; u < kRowLoads; ++u)
      if (lane * 8 + u * kStep < K) put(v[u], lane * 8 + u * kStep);
  } else {
    for (int c0 = lane * 8; c0 < K; c0 += kRowLoads * kStep) {
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u)
        if (c0 + u * kStep < K) load8(xr + c0 + u * kStep, v[u]);
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u)
        if (c0 + u * kStep < K) put(v[u], c0 + u * kStep);
    }
  }
  if (n_rs == 1) {
    for (int o = 16; o > 0; o >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, o);
    if (lane == 0) rs[0] = total;
  }
  if (lane == 0) {
    scale[row] = s;
    if (clear != nullptr) clear[row] = 0u;
  }
}

// x_type 0 float32, 1 bfloat16, 2 float16. ln.g != nullptr needs K <=
// kRowHeld.
inline cudaError_t launch_quant_rows(const void* x, int x_type, int M, int K,
                                     RowLn ln, int8_t* x8, float* xs,
                                     unsigned* clear, int* rsum, int gsize,
                                     cudaStream_t s) {
  if (ln.g != nullptr && K > kRowHeld) return cudaErrorInvalidValue;
  const int blocks = (M + kRowThreads / 32 - 1) / (kRowThreads / 32);
  if (x_type == 0)
    quant_rows_kernel<float><<<blocks, kRowThreads, 0, s>>>(
        static_cast<const float*>(x), M, K, ln, x8, xs, clear, rsum, gsize);
  else if (x_type == 1)
    quant_rows_kernel<__nv_bfloat16><<<blocks, kRowThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), M, K, ln, x8, xs, clear, rsum,
        gsize);
  else
    quant_rows_kernel<__half><<<blocks, kRowThreads, 0, s>>>(
        static_cast<const __half*>(x), M, K, ln, x8, xs, clear, rsum, gsize);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// mbarriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// the (box) tile of `map` at (inner c0, outer c1) → shared dst, completing
// its bytes on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle, 8
// rows (1024 bytes) a core-matrix group; `addr` may step along K inside the
// 128 bytes (the tile itself is 1024-aligned)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins the accumulators in place around the asynchronous products, so that
// no ordinary instruction reading or writing them moves across a fence or
// a wait
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[128] (+)= A (64 x 32, shared, K-major) . B (256 x 32, shared,
// K-major)^T, s8 x s8 -> s32: one wgmma of the warpgroup; scale_d == 0
// drops the old d
__device__ __forceinline__ void wgmma_k32(int (&d)[128], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// the same with B 64 x 32 of unsigned bytes: d[32] (+)= A . B^T
// (m64n64k32, s8 x u8)
__device__ __forceinline__ void wgmma_k32(int (&d)[32], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.u8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// The kernel

enum BSource { kBInt8 = 0, kBNibbles = 1 };

constexpr int kBK = 128;          // bytes of K a k-slice: one swizzle row
constexpr int kStages = 4;

// warpgroups 0 .. CONSUMERS - 1 consume, the last one produces
template <int BSRC>
struct Tile {
  static constexpr int BM = BSRC == kBInt8 ? 128 : 64;   // rows a tile
  static constexpr int BN = 256;                         // columns a tile
  static constexpr int CONSUMERS = BSRC == kBInt8 ? 2 : 4;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int WN = BSRC == kBInt8 ? 256 : 64;   // columns a consumer
  static constexpr int A_BYTES = BM * kBK;
  static constexpr int B_BYTES = BN * kBK;   // int8 or packed bytes
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // kBNibbles: the unpacked B tiles, two per consumer (double-buffered)
  static constexpr int U_BYTES = BSRC == kBNibbles ? 2 * BN * kBK : 0;
  // the ring, the unpacked tiles, the full and empty barriers, and slack to
  // align the ring to 1024
  static constexpr size_t SMEM = 1024 + (size_t)kStages * STAGE_BYTES +
                                 U_BYTES + 2 * kStages * sizeof(uint64_t);
};

// kBNibbles: rsum (M, n_rs) int32, each row's sums of x8 over runs of
// K / n_rs columns (the groups, or all of K), for the correction of the
// unsigned nibbles; grouped: n_half > 0 group-scale rows a plane, gs
// (2 * n_half, N) float32
template <int BSRC, bool GROUPED, class Epi>
__global__ void __launch_bounds__(Tile<BSRC>::THREADS, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, Epi epi,
                  const int* __restrict__ rsum, const float* __restrict__ gs,
                  int n_half, int M, int N, int K) {
  using T = Tile<BSRC>;
  static_assert(BSRC == kBNibbles || !GROUPED, "groups are int4 only");
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t ring = (smem_u32(gemm_smem) + 1023u) & ~1023u;
  const uint32_t unpacked = ring + kStages * T::STAGE_BYTES;
  const uint32_t bars = unpacked + T::U_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const int n_tiles = (N + T::BN - 1) / T::BN;
  const int n_work = (M + T::BM - 1) / T::BM * n_tiles;
  // k-slices a tile: int8, ceil(K / 128); int4, ceil(K/2 / 128) a plane
  const int kh = K / 2;
  const int plane_slices = (kh + kBK - 1) / kBK;
  const int k_slices =
      BSRC == kBInt8 ? (K + kBK - 1) / kBK : 2 * plane_slices;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);   // the producer's arrival, with the TMA bytes
      mbar_init(empty(s), T::CONSUMERS);  // one arrival a consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  constexpr int kProducer = 128 * T::CONSUMERS;   // its first thread
  if (threadIdx.x >= kProducer) {
    // the producer warpgroup: one thread issues every load
    if constexpr (BSRC == kBInt8)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kProducer) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_work; tile += gridDim.x) {
        const int m0 = tile / n_tiles * T::BM, n0 = tile % n_tiles * T::BN;
        for (int ks = 0; ks < k_slices; ++ks) {
          // int4: the k-slice's packed columns and its plane's x8 columns
          const int plane = ks >= plane_slices;
          const int pk = (ks - plane * plane_slices) * kBK;
          const int a_col = BSRC == kBInt8 ? ks * kBK : plane * kh + pk;
          const int b_col = BSRC == kBInt8 ? ks * kBK : pk;
          mbar_wait(empty(stage), phase ^ 1);
          const uint32_t a = ring + stage * T::STAGE_BYTES;
          mbar_expect_tx(full(stage), T::STAGE_BYTES);
          tma_load_2d(a, &map_a, a_col, m0, full(stage));
          tma_load_2d(a + T::A_BYTES, &map_b, b_col, n0, full(stage));
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup. kBInt8: rows cw * 64 .. +63 of the tile, all 256
  // columns; kBNibbles: all 64 rows, columns cw * 64 .. +63.
  // Registers: the block holds 168 x 384 (or 96 x 640) from its launch, and
  // what the producer gives back is all the consumers can take: 2 x 128 x
  // 232 + 128 x 40 = 168 x 384, or 4 x 128 x 112 + 128 x 24 <= 96 x 640
  // (an increase the pool cannot serve never returns)
  if constexpr (BSRC == kBInt8)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n");
  const int cw = threadIdx.x >> 7, wl = threadIdx.x & 127;
  const int g = (wl & 31) >> 2, t4 = wl & 3;
  const int a_row0 = BSRC == kBInt8 ? cw * 64 : 0;
  const int b_row0 = BSRC == kBInt8 ? 0 : cw * T::WN;
  int stage = 0;
  uint32_t phase = 0;
  int prev = -1;           // the stage whose products are still pending
  int slice_count = 0;     // k-slices this consumer has taken (U buffer)
  uint32_t a = 0, b = 0;   // the current slice's A and B tiles

  // wait for the stage's slice; kBNibbles: unpack this consumer's 64
  // packed rows of it into its B tile as unsigned nibbles n ^ 8 (the
  // signed value + 8; the products are s8 x u8 and the epilogue takes 8 x
  // the x8 row sums off): 16-byte unit i of the swizzled packed tile →
  // unit i of the B tile, zeros past the plane's end (pk: the slice's first
  // packed column), so that every slice runs four full k32 products
  auto begin_slice = [&](int plane, int pk) {
    mbar_wait(full(stage), phase);
    a = ring + stage * T::STAGE_BYTES + a_row0 * kBK;
    b = ring + stage * T::STAGE_BYTES + T::A_BYTES + b_row0 * kBK;
    if constexpr (BSRC == kBNibbles) {
      const uint32_t u =
          unpacked +
          ((slice_count & 1) * T::CONSUMERS + cw) * (T::WN * kBK);
      const unsigned char* src = gemm_smem + (b - smem_u32(gemm_smem));
      unsigned char* dst = gemm_smem + (u - smem_u32(gemm_smem));
      const int shift = plane ? 4 : 0;
      const int valid = (kh - pk) / 16;   // 16-byte units of the row left
#pragma unroll
      for (int i = 0; i < T::WN * kBK / 16 / 128; ++i) {
        const int unit = wl + 128 * i;     // row unit / 8, swizzled unit % 8
        const int at = unit * 16;
        const uint4 p = *reinterpret_cast<const uint4*>(src + at);
        uint4 q = make_uint4(((p.x >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u,
                             ((p.y >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u,
                             ((p.z >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u,
                             ((p.w >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u);
        if (valid < kBK / 16 && ((unit & 7) ^ ((unit >> 3) & 7)) >= valid)
          q = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dst + at) = q;
      }
      // the generic-proxy stores, seen by the async proxy of the wgmma
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      b = u;
      ++slice_count;
    }
    wgmma_fence();
  };
  // the slice's products are issued and committed: once the previous
  // slice's are done, release its stage
  auto end_slice = [&]() {
    wgmma_wait<1>();
    if (prev >= 0 && wl == 0) mbar_arrive(empty(prev));
    prev = stage;
    if (++stage == kStages) stage = 0, phase ^= 1;
  };

  for (int tile = blockIdx.x; tile < n_work; tile += gridDim.x) {
    const int m0 = tile / n_tiles * T::BM, n0 = tile % n_tiles * T::BN;
    const int r0 = m0 + a_row0 + (wl >> 5) * 16 + g;
    const int c0 = n0 + b_row0 + 2 * t4;
    // the two rows of this thread's fragment
    const int rows[2] = {r0 < M ? r0 : M - 1, r0 + 8 < M ? r0 + 8 : M - 1};
    int d[T::WN / 2];
#pragma unroll
    for (int i = 0; i < T::WN / 2; ++i) d[i] = 0;
    fence_regs(d);
    if constexpr (!GROUPED) {
      for (int ks = 0; ks < k_slices; ++ks) {
        const int plane = ks >= plane_slices;
        begin_slice(plane, (ks - plane * plane_slices) * kBK);
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          wgmma_k32(d, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32), 1);
        wgmma_commit();
        end_slice();
      }
      wgmma_wait<0>();
      fence_regs(d);
      if constexpr (BSRC == kBNibbles) {
        // the exact signed sums: 8 x the row's x8 sum off the unsigned one
        const int off[2] = {8 * rsum[rows[0]], 8 * rsum[rows[1]]};
#pragma unroll
        for (int i = 0; i < T::WN / 2; ++i) d[i] -= off[(i >> 1) & 1];
      }
      // every product of the tile is done: release its last stage before
      // the epilogue, so that the producer fills the ring meanwhile
      if (prev >= 0 && wl == 0) mbar_arrive(empty(prev));
      prev = -1;
      epi(d, r0, c0, M, N);
    } else {
      // Groups: one exact s32 sum a group, started with scale-d = 0 and
      // folded at its last k32 step once its products are done, acc_f =
      // acc_f + float(dot_g) * s[g] in the group order. The consumer
      // warpgroups fold at different times, so the tensor cores keep
      // running the others' products.
      const int G = kh / n_half;
      const int n_rs = 2 * n_half;
      const int plane_steps = kh / 32;
      // |dot_g| <= 127 * 8 * G < 2^22 for G <= 4096: float(dot_g) as the
      // bits of dot_g + 1.5 * 2^23 less 1.5 * 2^23 (exact, and at the full
      // rate, where a conversion instruction runs at a sixteenth of it)
      const bool magic = G <= 4096;
      float accf[T::WN / 2];
#pragma unroll
      for (int i = 0; i < T::WN / 2; ++i) accf[i] = 0.f;
      // the group's scale row and row-sum offsets, loaded at its first
      // step so that they arrive while its products run
      float sc[T::WN / 4];
      int bias[2], off[2];
      auto load_group = [&](int gi) {
        const float* srow = gs + (size_t)gi * N;
#pragma unroll
        for (int j = 0; j < T::WN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + 8 * j + e;
            sc[2 * j + e] = col < N ? srow[col] : 0.f;
          }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          off[hh] = 8 * rsum[(size_t)rows[hh] * n_rs + gi];
          bias[hh] = 0x4B400000 - off[hh];
        }
      };
      auto fold = [&]() {
#pragma unroll
        for (int j = 0; j < T::WN / 8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 4 * j + q, hh = q >> 1;
            const float dot =
                magic ? __fsub_rn(__int_as_float(d[i] + bias[hh]),
                                  12582912.0f)
                      : (float)(d[i] - off[hh]);
            accf[i] = __fadd_rn(accf[i], __fmul_rn(dot, sc[2 * j + (q & 1)]));
          }
      };
      // the walk's place in its group, counted (no division a step): k32
      // steps into the group, and the group's scale row; a plane ends on a
      // group's end
      const int gsteps = G / 32;
      int gstep = 0, gi = 0;
      for (int ks = 0; ks < k_slices; ++ks) {
        const int plane = ks >= plane_slices;
        const int t0 = (ks - plane * plane_slices) * (kBK / 32);
        bool released = false;   // this slice's stage handed back
        begin_slice(plane, t0 * 32);
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          // past the plane's end (a partial last slice) B is zero and the
          // count stands still
          const bool valid = t0 + kk < plane_steps;
          const bool first = gstep == 0;
          if (first && valid) load_group(gi);
          wgmma_k32(d, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32),
                    !first);
          if (valid) {
            if (gstep == gsteps - 1) {
              wgmma_commit();
              wgmma_wait<0>();
              // every product so far is done: hand back the stages read,
              // this one too at its last step, before the fold runs
              if (wl == 0) {
                if (prev >= 0) mbar_arrive(empty(prev));
                if (kk == kBK / 32 - 1) mbar_arrive(empty(stage));
              }
              prev = -1;
              released = kk == kBK / 32 - 1;
              fence_regs(d);
              fold();
              fence_regs(d);
              wgmma_fence();
              gstep = 0, ++gi;
            } else {
              ++gstep;
            }
          }
        }
        wgmma_commit();
        if (released) {
          if (++stage == kStages) stage = 0, phase ^= 1;
        } else {
          end_slice();
        }
      }
      wgmma_wait<0>();
      if (prev >= 0 && wl == 0) mbar_arrive(empty(prev));
      prev = -1;
      epi(accf, r0, c0, M, N);
    }
  }
}

// ---------------------------------------------------------------------------
// Epilogues: operator()(v, r0, c0, M, N) over a consumer thread's fragment
// (s32 sums, converted where they are used, or float32), value 4j + 2h + e
// at (r0 + 8h, c0 + 8j + e)

// out = (acc * xs[row]) * ws[col] (PER_CHANNEL), or acc_f * xs[row] (the
// group scales already folded), rounded once to OutT
template <typename OutT, bool PER_CHANNEL = true>
struct QuantEpi {
  OutT* out;
  const float* xs;
  const float* ws;
  template <typename V, int R>
  __device__ __forceinline__ void operator()(const V (&v)[R], int r0, int c0,
                                             int M, int N) const {
    const float as[2] = {r0 < M ? xs[r0] : 0.f,
                         r0 + 8 < M ? xs[r0 + 8] : 0.f};
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int col = c0 + 8 * j;
      if (col >= N) continue;
      const bool two = col + 1 < N;
      float w0 = 0.f, w1 = 0.f;
      if constexpr (PER_CHANNEL) w0 = ws[col], w1 = two ? ws[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= M) continue;
        float v0 = __fmul_rn((float)v[4 * j + 2 * h], as[h]);
        float v1 = __fmul_rn((float)v[4 * j + 2 * h + 1], as[h]);
        if constexpr (PER_CHANNEL)
          v0 = __fmul_rn(v0, w0), v1 = __fmul_rn(v1, w1);
        store_pair(out + (size_t)row * N + col, two, pairs, v0, v1);
      }
    }
  }
};

// The int8 sublayers' epilogues (rows 2, 3, 5 and 6: fused_sublayer.cu,
// fused_mlp.cu), every multiply and add rounded as written (__fmul_rn /
// __fadd_rn), as the JAX kernels and the plain versions order them.

// h = gelu_tanh((acc * xs) * s1 + b1), f32, and the rows' |h| maxima: each
// thread's maximum over its fragment row, reduced over the 4 lanes that
// share the row, posted with one atomicMax on the float's bits into
// hmax[row] (non-negative floats order as their bits, and a maximum is
// order-free: exact)
struct MlpFc1Epi {
  float* h;
  const float* xs;
  const float* s1;
  const float* b1;
  unsigned* hmax;
  template <int R>
  __device__ __forceinline__ void operator()(const int (&v)[R], int r0,
                                             int c0, int M, int N) const {
    const float as[2] = {r0 < M ? xs[r0] : 0.f,
                         r0 + 8 < M ? xs[r0 + 8] : 0.f};
    float mx[2] = {0.f, 0.f};
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int col = c0 + 8 * j;
      if (col >= N) continue;
      const bool two = col + 1 < N;
      const float w0 = s1[col], w1 = two ? s1[col + 1] : 0.f;
      const float c0b = b1[col], c1b = two ? b1[col + 1] : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        if (row >= M) continue;
        const float y0 = int8k::gelu_tanh(__fadd_rn(
            __fmul_rn(__fmul_rn((float)v[4 * j + 2 * hh], as[hh]), w0), c0b));
        const float y1 = int8k::gelu_tanh(__fadd_rn(
            __fmul_rn(__fmul_rn((float)v[4 * j + 2 * hh + 1], as[hh]), w1),
            c1b));
        mx[hh] = fmaxf(mx[hh], fabsf(y0));
        if (two) mx[hh] = fmaxf(mx[hh], fabsf(y1));
        store_pair(h + (size_t)row * N + col, two, pairs, y0, y1);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float m = mx[hh];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const int row = r0 + 8 * hh;
      if ((threadIdx.x & 3) == 0 && row < M)
        atomicMax(hmax + row, __float_as_uint(m));
    }
  }
};

// the scale of a row quantised over a whole width whose |max| another
// launch posted by its bits
__device__ __forceinline__ float row_scale(const unsigned* amax, int row) {
  return fmaxf(__uint_as_float(amax[row]), 1e-8f) / 127.0f;
}

// y = (acc * hs) * s2 + b2, f32, hs from the rows' |h| maxima; RESID: out =
// resid + y, the residual added last (resid and out (M, N))
template <bool RESID>
struct MlpFc2Epi {
  float* out;
  const unsigned* hmax;
  const float* s2;
  const float* b2;
  const float* resid;
  template <int R>
  __device__ __forceinline__ void operator()(const int (&v)[R], int r0,
                                             int c0, int M, int N) const {
    float hs[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      hs[hh] = r0 + 8 * hh < M ? row_scale(hmax, r0 + 8 * hh) : 0.f;
    const bool pairs = (N & 1) == 0;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int col = c0 + 8 * j;
      if (col >= N) continue;
      const bool two = col + 1 < N;
      const float w0 = s2[col], w1 = two ? s2[col + 1] : 0.f;
      const float c0b = b2[col], c1b = two ? b2[col + 1] : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        if (row >= M) continue;
        const size_t at = (size_t)row * N + col;
        float y0 = __fadd_rn(
            __fmul_rn(__fmul_rn((float)v[4 * j + 2 * hh], hs[hh]), w0), c0b);
        float y1 = __fadd_rn(
            __fmul_rn(__fmul_rn((float)v[4 * j + 2 * hh + 1], hs[hh]), w1),
            c1b);
        if constexpr (RESID) {
          y0 = __fadd_rn(resid[at], y0);
          if (two) y1 = __fadd_rn(resid[at + 1], y1);
        }
        store_pair(out + at, two, pairs, y0, y1);
      }
    }
  }
};

// out = ((acc * xs) * s + b) [* post], rounded once to OutT, output rows of
// ld elements: row 2's bf16 qkv (the q columns' s and b arrive multiplied
// by the softmax scale), row 4's q, k and v into their bf16 rows (POST: the
// softmax scale after the bias, as the JAX kernel takes it), row 7's f32
// qkv
template <typename OutT, bool POST>
struct BiasEpi {
  OutT* out;
  int ld;
  const float* xs;
  const float* s;
  const float* b;
  float post;
  template <int R>
  __device__ __forceinline__ void operator()(const int (&v)[R], int r0,
                                             int c0, int M, int N) const {
    const float as[2] = {r0 < M ? xs[r0] : 0.f,
                         r0 + 8 < M ? xs[r0 + 8] : 0.f};
    const bool pairs = (N & 1) == 0 && (ld & 1) == 0;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int col = c0 + 8 * j;
      if (col >= N) continue;
      const bool two = col + 1 < N;
      const float w0 = s[col], w1 = two ? s[col + 1] : 0.f;
      const float c0b = b[col], c1b = two ? b[col + 1] : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        if (row >= M) continue;
        float y0 = __fadd_rn(
            __fmul_rn(__fmul_rn((float)v[4 * j + 2 * hh], as[hh]), w0), c0b);
        float y1 = __fadd_rn(
            __fmul_rn(__fmul_rn((float)v[4 * j + 2 * hh + 1], as[hh]), w1),
            c1b);
        if constexpr (POST) y0 = __fmul_rn(y0, post), y1 = __fmul_rn(y1, post);
        store_pair(out + (size_t)row * ld + col, two, pairs, y0, y1);
      }
    }
  }
};

// h (M, H) f32 -> h8 with the row scale hs = max(hmax, 1e-8) / 127, one
// read of h; H % 8 == 0, so 8 values of one row a thread, 16-byte loads
constexpr int kQuantThreads = 256;

__global__ void __launch_bounds__(kQuantThreads)
hidden_quant_kernel(const float* __restrict__ h,
                    const unsigned* __restrict__ hmax, int M, int H,
                    int8_t* __restrict__ h8) {
  const size_t n8 = (size_t)M * H / 8;
  for (size_t i = (size_t)blockIdx.x * kQuantThreads + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * kQuantThreads) {
    const int row = (int)(i * 8 / H);
    float v[8];
    load8(h + 8 * i, v);
    *reinterpret_cast<uint2*>(h8 + 8 * i) = quant8(v, row_scale(hmax, row));
  }
}

// at most 16 blocks an SM, each walking the rows' 8-value runs
inline cudaError_t launch_hidden_quant(const float* h, const unsigned* hmax,
                                       int M, int H, int8_t* h8, int sms,
                                       cudaStream_t s) {
  const size_t n8 = (size_t)M * H / 8;
  const size_t want = (n8 + kQuantThreads - 1) / kQuantThreads;
  const int blocks = (int)(want < (size_t)sms * 16 ? want : (size_t)sms * 16);
  hidden_quant_kernel<<<blocks, kQuantThreads, 0, s>>>(h, hmax, M, H, h8);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// template instantiation helpers of the host side

// cuTensorMapEncodeTiled from libcuda, looked up once
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// the TMA map of a (rows, cols) byte matrix in boxes of box_rows x 128
// bytes, 128-byte swizzle, zeros past its edges
inline bool byte_tile_map(CUtensorMap* map, const void* base, int rows,
                          int cols, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// raises `kernel`'s dynamic shared-memory limit to `bytes` on `device`,
// once. Keyed by the kernel's address: the statics of an inline function
// or a template are one object across every library of a process (GNU
// unique symbols) wherever its types agree, while each library built from
// these headers registers kernels of its own.
inline cudaError_t raise_smem_limit(const void* kernel, int device,
                                    int bytes) {
  constexpr int kSlots = 64;
  static const void* kernels[kSlots] = {};
  static int devices[kSlots] = {};
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (kernels[i] == kernel && devices[i] == device) return cudaSuccess;
  cudaSetDevice(device);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && used < kSlots) {
    kernels[used] = kernel;
    devices[used] = device;
    ++used;
  }
  return err;
}

inline cudaError_t sm_count(int device, int* sms) {
  static int cached[32] = {0};
  if (device >= 0 && device < 32 && cached[device] > 0) {
    *sms = cached[device];
    return cudaSuccess;
  }
  const cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device >= 0 && device < 32) cached[device] = *sms;
  return err;
}

// out = Epi(a8 (M, K) . b^T): b is int8 (N, K) (kBInt8) or packed int4 (N,
// K/2) (kBNibbles: with a8's row sums rsum, over all of K or, GROUPED, over
// each group, and the group scales gs of n_half rows a plane). a8 and b
// 16-byte aligned, K % 16 == 0 (int4: K/2 % 32 == 0).
template <int BSRC, bool GROUPED, class Epi>
cudaError_t launch_gemm(const int8_t* a8, const int8_t* b, Epi epi,
                        const int* rsum, const float* gs, int n_half, int M,
                        int N, int K, int device, cudaStream_t s) {
  using T = Tile<BSRC>;
  CUtensorMap map_a, map_b;
  if (!byte_tile_map(&map_a, a8, M, K, T::BM) ||
      !byte_tile_map(&map_b, b, N, BSRC == kBInt8 ? K : K / 2, T::BN))
    return cudaErrorInvalidValue;
  auto kernel = wgmma_gemm_kernel<BSRC, GROUPED, Epi>;
  cudaError_t err = raise_smem_limit(
      reinterpret_cast<const void*>(kernel), device, (int)T::SMEM);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const int work = (M + T::BM - 1) / T::BM * ((N + T::BN - 1) / T::BN);
  const int blocks = work < sms ? work : sms;   // persistent: one per SM
  kernel<<<blocks, T::THREADS, T::SMEM, s>>>(map_a, map_b, epi, rsum, gs,
                                               n_half, M, N, K);
  return cudaGetLastError();
}

}  // namespace wg
