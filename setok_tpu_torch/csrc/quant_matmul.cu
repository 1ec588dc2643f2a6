// w8a8 and w4a8 matrix products: the serving trunk's linears and the int8
// SeTok's Dense(quant8).
//
// Replaces setok_tpu/kernels/quant_matmul.py:
//   quant_matmul    x (M, K) float . W8 (K, N) int8, per-channel scales (:54)
//   quant4_matmul   the same over half-packed int4 nibbles, per-channel or
//                   per-group scales                                   (:226)
// The TPU kernel is one Pallas program per (256-row, N-block) tile that
// reads x in its own type, quantises its rows, unpacks the nibbles in VMEM,
// runs the MXU and writes out_dtype from its epilogue. Here x is read and the
// output written in their own types too (float32, bfloat16 or float16), and
// the route is a shape rule:
//
//   M <= 8 (decode)  gemv_kernel, one launch and no scratch: each block
//                    quantises the M rows of x into shared memory (x stays
//                    in L2), then its warps stream weight rows, two output
//                    channels a warp (they share each x chunk read from
//                    shared memory), 4 x 16 bytes a lane and row in flight
//                    and the next 4 loaded before the current ones are used,
//                    dp4a over the int8 rows. A block per SM; the first
//                    weight loads are issued before the row pass, so they
//                    overlap it. The exact int dots are summed across lanes
//                    by a shuffle reduce-scatter (integers: any order): at a
//                    channel's end, or per group, where a group's chunks are
//                    an aligned run of lanes (else a butterfly or a
//                    segmented scan); the writer lanes add the group sums to
//                    the warp's (channel, row, group) sums in shared memory,
//                    and lane r * MR + m folds row m of channel r in the JAX
//                    kernel's group order at the end of the channel.
//   M > 8            quant_rows_kernel (x -> x8, xs), then the persistent
//                    wgmma GEMM of wgmma_s8.cuh: int8 weights TMA'd into the
//                    B tile (kBInt8), or packed int4 TMA'd and unpacked into
//                    it by the consumers (kBNibbles), plane by plane, with
//                    group scales folded at each group's end.
//
// Weights are in the torch (out, in) layout: W8 (N, K), packed (N, K/2) with
// logical input row i in the low nibble of byte i and row i + K/2 in its high
// nibble. The int products are exact (int32); the epilogue is the JAX
// kernel's, (float(acc) * xs) * ws rounded once to the output type, or for
// groups one float32 accumulator acc_f = acc_f + float(dot_g) * s[g] over
// the low plane's groups, then the high plane's, and acc_f * xs.
//
// What bounds them (H100 SXM data sheet). Decode, M = 4: the weight bytes,
// 4096 x 11008 int8 = 45 MB in 13.5 us (int4 half of it); the products are
// 0.36 G int8 operations, 0.2 us. The row pass reads x once a block from L2
// (64-176 KB at M = 4 in f32), which costs device time beside the weights
// but saves a launch and an allocation on the host, which is what a decode
// step waits for. Prefill, M = 512, the seven linears of a
// Vicuna-7B layer: 207 G int8 operations, 105 us at 1979 TOP/s, against
// 101 MB of int4 weights (30 us). The int8 SeTok's Dense at 384 px (M =
// 36,864, 768 -> 2304, bf16 in and out): 130 G int8 operations, 66 us,
// against 0.23 GB of x and output, 68 us at 3.35 TB/s.

#include "wgmma_s8.cuh"

namespace {

using namespace wg;

enum Mode { kW8 = 0, kW4 = 1, kW4G = 2 };

constexpr int kGemvWarps = 16;          // warps a block, fewer if its
constexpr int kGemvMaxSmem = 227 * 1024;  // shared memory would not fit
constexpr int kLoads = 4;               // 16-byte loads a lane a batch

__device__ __forceinline__ int dot16(uint4 a, uint4 b, int acc) {
  acc = __dp4a((int)a.x, (int)b.x, acc);
  acc = __dp4a((int)a.y, (int)b.y, acc);
  acc = __dp4a((int)a.z, (int)b.z, acc);
  return __dp4a((int)a.w, (int)b.w, acc);
}

// four sign-extended int8 values from the low / high nibbles of four bytes
__device__ __forceinline__ unsigned lo_nibbles(unsigned w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ unsigned hi_nibbles(unsigned w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}


__device__ __forceinline__ uint4 lo16(uint4 p) {
  return make_uint4(lo_nibbles(p.x), lo_nibbles(p.y), lo_nibbles(p.z),
                    lo_nibbles(p.w));
}
__device__ __forceinline__ uint4 hi16(uint4 p) {
  return make_uint4(hi_nibbles(p.x), hi_nibbles(p.y), hi_nibbles(p.z),
                    hi_nibbles(p.w));
}

// channels a warp streams at once (they share the x chunks read from
// shared memory); one at 8 rows, for registers
__host__ __device__ constexpr int channels_of(int mr) { return mr <= 4 ? 2 : 1; }

// shared memory of the GEMV: the int8 rows, their scales, the row pass's
// per-warp maxima and (kW4G) the per-warp (channel, row, group) sums
inline size_t gemv_smem(int mode, int mr, int K, int n_scales, int warps) {
  return ((size_t)mr * K + 15) / 16 * 16 + 4 * (size_t)mr +
         4 * (size_t)warps * mr +
         (mode == kW4G ? 4 * (size_t)warps * channels_of(mr) * mr * n_scales
                       : 0);
}

// Sums V ints over each aligned group of L lanes (L >= V, both powers of
// two) and scatters them: the lane's result is the group's sum of value
// (lane & (L - 1)) / (L / V), and the lanes with (lane & (L / V - 1)) == 0
// hold the V sums between them. Integers: the order is free.
template <int V>
__device__ __forceinline__ int reduce_scatter(int (&val)[V], int L,
                                              int lane) {
  int o = L >> 1;
#pragma unroll
  for (int cnt = V; cnt > 1; cnt >>= 1, o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < cnt / 2; ++i) {
      const int send = upper ? val[i] : val[i + cnt / 2];
      const int keep = upper ? val[i + cnt / 2] : val[i];
      val[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  int v = val[0];
  for (; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// M <= MR rows, one launch. A weight row is nch 16-byte chunks; a warp
// streams R = channels_of(MR) rows at once, lane l taking chunks l, l + 32,
// ... of each in batches of kLoads.

template <int MODE, int MR, typename OutT>
__global__ void __launch_bounds__(kGemvWarps * 32, 1)
gemv_kernel(const void* __restrict__ x, int x_type,
            const int8_t* __restrict__ W, const float* __restrict__ ws,
            int n_scales, OutT* __restrict__ out, int M, int N, int K) {
  constexpr int R = channels_of(MR);
  extern __shared__ __align__(16) unsigned char gemv_smem_[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int8_t* xq = reinterpret_cast<int8_t*>(gemv_smem_);
  float* xsc = reinterpret_cast<float*>(gemv_smem_ +
                                        ((size_t)MR * K + 15) / 16 * 16);
  float* red = xsc + MR;                                // nw x MR
  int* gsum = reinterpret_cast<int*>(red + nw * MR);
  int* sums = gsum + warp * R * MR * n_scales;          // R x MR x n_scales

  const int kh = K / 2;
  const int row_bytes = MODE == kW8 ? K : kh;
  const int nch = row_bytes / 16;
  const int n_half = n_scales / 2;
  const int G = MODE == kW4G ? kh / n_half : 0;   // rows a group
  const int cpg = G / 16;                          // chunks a group
  // groups as aligned runs of L lanes (a power of two of chunks up to 32,
  // or a multiple of 32), or else a segmented scan
  const bool aligned = MODE == kW4G && ((cpg & (cpg - 1)) == 0 || cpg % 32 == 0);
  const int L = cpg < 32 ? cpg : 32;
  // a chunk's group: a shift where cpg is a power of two
  const int cpg_shift = MODE == kW4G && (cpg & (cpg - 1)) == 0 ? __ffs(cpg) - 1
                                                               : -1;
  const int units = (N + R - 1) / R;               // R-channel units
  const int stride = gridDim.x * nw;

  // the first batch of weights, in flight during the row pass
  int p = blockIdx.x * nw + warp, b0 = 0;
  uint4 cur[R][kLoads];
  auto load = [&](uint4 (&w)[R][kLoads], int pp, int bb) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = pp * R + r;
      const int8_t* row = W + (size_t)(n < N ? n : 0) * row_bytes;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int c = bb + 32 * u + lane;
        w[r][u] = n < N && c < nch
                      ? __ldg(reinterpret_cast<const uint4*>(row + 16 * c))
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  if (p < units) load(cur, p, 0);

  if constexpr (MODE == kW4G)
    for (int i = lane; i < R * MR * n_scales; i += 32) sums[i] = 0;

  // the row pass: s = max(absmax, 1e-8) / 127, q = clip(rint(x / s))
  float mx[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) mx[m] = 0.f;
  for (int q = threadIdx.x; q < K / 8; q += blockDim.x) {
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m >= M) break;
      float v[8];
      load8(x, x_type, (size_t)m * K + 8 * q, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) mx[m] = fmaxf(mx[m], fabsf(v[i]));
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const float w = warp_max(mx[m]);
    if (lane == 0) red[warp * MR + m] = w;
  }
  __syncthreads();
  float s[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    float w = red[m];
    for (int i = 1; i < nw; ++i) w = fmaxf(w, red[i * MR + m]);
    s[m] = fmaxf(w, 1e-8f) / 127.0f;
  }
  for (int q = threadIdx.x; q < K / 8; q += blockDim.x) {
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m >= M) break;
      float v[8];
      load8(x, x_type, (size_t)m * K + 8 * q, v);
      *reinterpret_cast<uint2*>(xq + (size_t)m * K + 8 * q) = quant8(v, s[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m)
    if (threadIdx.x == m) xsc[m] = s[m];
  __syncthreads();

  int acc[R][MR];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MR; ++m) acc[r][m] = 0;
  while (p < units) {
    // the next batch's position, loaded before this one is used
    int pn = p, nb = b0 + 32 * kLoads;
    if (nb >= nch) pn += stride, nb = 0;
    uint4 nxt[R][kLoads];
    if (pn < units) load(nxt, pn, nb);

#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (b0 + 32 * u >= nch) break;
      const int c = b0 + 32 * u + lane;
      const bool ok = c < nch;
      const int cc = ok ? c : 0;
      if constexpr (MODE == kW8) {
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          if (m >= M) break;
          const uint4 xv =
              *reinterpret_cast<const uint4*>(xq + (size_t)m * K + 16 * cc);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][m] = dot16(cur[r][u], xv, acc[r][m]);
        }
      } else {
        uint4 lo[R], hi[R];
#pragma unroll
        for (int r = 0; r < R; ++r) lo[r] = lo16(cur[r][u]), hi[r] = hi16(cur[r][u]);
        int dl[R][MR], dh[R][MR];
#pragma unroll
        for (int m = 0; m < MR; ++m) {
#pragma unroll
          for (int r = 0; r < R; ++r) dl[r][m] = dh[r][m] = 0;
          if (m >= M) continue;
          const int8_t* xr = xq + (size_t)m * K + 16 * cc;
          const uint4 xl = *reinterpret_cast<const uint4*>(xr);
          const uint4 xh = *reinterpret_cast<const uint4*>(xr + kh);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            dl[r][m] = dot16(lo[r], xl, 0);
            dh[r][m] = dot16(hi[r], xh, 0);
          }
        }
        if constexpr (MODE == kW4) {
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int m = 0; m < MR; ++m) acc[r][m] += dl[r][m] + dh[r][m];
        } else {
          // the exact int dot of each group (its chunks lie in
          // consecutive lanes), added to the warp's (channel, row, group)
          // sums; the same lane adds to a sum throughout a channel except
          // in the segmented scan
          const int gid = cpg_shift >= 0 ? c >> cpg_shift : c / cpg;
          if (aligned && L >= 2 * MR) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              int val[2 * MR];
#pragma unroll
              for (int m = 0; m < MR; ++m) val[m] = dl[r][m], val[MR + m] = dh[r][m];
              const int v = reduce_scatter(val, L, lane);
              // 2^per_shift lanes hold one value
              const int per_shift = (__ffs(L) - 1) - (__ffs(2 * MR) - 1);
              const int idx = (lane & (L - 1)) >> per_shift;
              const int m = idx % MR, plane = idx / MR;
              if (ok && (lane & ((1 << per_shift) - 1)) == 0 && m < M)
                sums[(r * MR + m) * n_scales + plane * n_half + gid] += v;
            }
          } else if (aligned) {
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int m = 0; m < MR; ++m) {
                int vl = dl[r][m], vh = dh[r][m];
                for (int o = L >> 1; o > 0; o >>= 1) {
                  vl += __shfl_xor_sync(0xffffffffu, vl, o);
                  vh += __shfl_xor_sync(0xffffffffu, vh, o);
                }
                if (ok && (lane & (L - 1)) == 0 && m < M) {
                  sums[(r * MR + m) * n_scales + gid] += vl;
                  sums[(r * MR + m) * n_scales + n_half + gid] += vh;
                }
              }
          } else {
            // segmented inclusive scan over the group's lanes, then its
            // last lane adds
            for (int o = 1; o < L; o <<= 1) {
              const bool same = ok && lane >= o && (c - o) / cpg == gid;
#pragma unroll
              for (int r = 0; r < R; ++r)
#pragma unroll
                for (int m = 0; m < MR; ++m) {
                  const int pl = __shfl_up_sync(0xffffffffu, dl[r][m], o);
                  const int ph = __shfl_up_sync(0xffffffffu, dh[r][m], o);
                  if (same) dl[r][m] += pl, dh[r][m] += ph;
                }
            }
            const bool tail =
                ok && (lane == 31 || c + 1 >= nch || (c + 1) / cpg != gid);
            if (tail)
#pragma unroll
              for (int r = 0; r < R; ++r)
#pragma unroll
                for (int m = 0; m < MR; ++m)
                  if (m < M) {
                    sums[(r * MR + m) * n_scales + gid] += dl[r][m];
                    sums[(r * MR + m) * n_scales + n_half + gid] += dh[r][m];
                  }
            __syncwarp();
          }
        }
      }
    }

    if (nb == 0) {
      // the unit's last batch: reduce and write its R channels
      if constexpr (MODE == kW4G) {
        __syncwarp();
        if (lane < R * MR) {
          const int r = lane / MR, m = lane % MR, n = p * R + r;
          if (m < M && n < N) {
            float accf = 0.f;
            const int* sr = sums + lane * n_scales;
#pragma unroll 4
            for (int gi = 0; gi < n_scales; ++gi)
              accf = __fadd_rn(accf, __fmul_rn((float)sr[gi],
                                               ws[(size_t)gi * N + n]));
            store1(out + (size_t)m * N + n, __fmul_rn(accf, xsc[m]));
          }
        }
        __syncwarp();
        for (int i = lane; i < R * MR * n_scales; i += 32) sums[i] = 0;
        __syncwarp();
      } else {
        int val[R * MR];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int m = 0; m < MR; ++m) val[r * MR + m] = acc[r][m], acc[r][m] = 0;
        const int v = reduce_scatter(val, 32, lane);
        const int per = 32 / (R * MR);
        const int idx = lane / per, r = idx / MR, m = idx % MR;
        const int n = p * R + r;
        if ((lane & (per - 1)) == 0 && m < M && n < N)
          store1(out + (size_t)m * N + n,
                 __fmul_rn(__fmul_rn((float)v, xsc[m]), ws[n]));
      }
    }
    p = pn, b0 = nb;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int u = 0; u < kLoads; ++u) cur[r][u] = nxt[r][u];
  }
}

template <int MODE, int MR, typename OutT>
cudaError_t launch_gemv(const void* x, int x_type, const int8_t* W,
                        const float* ws, int n_scales, OutT* out, int M,
                        int N, int K, int warps, int device, cudaStream_t s) {
  const size_t smem = gemv_smem(MODE, MR, K, n_scales, warps);
  auto kernel = gemv_kernel<MODE, MR, OutT>;
  static int raised[32] = {0};   // the limit set so far, per device
  if (smem > 48 * 1024 && (device >= 32 || raised[device] < (int)smem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (device < 32) raised[device] = (int)smem;
  }
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  const int units = (N + channels_of(MR) - 1) / channels_of(MR);
  const int need = (units + warps - 1) / warps;
  kernel<<<need < sms ? need : sms, warps * 32, smem, s>>>(
      x, x_type, W, ws, n_scales, out, M, N, K);
  return cudaGetLastError();
}

// warps a GEMV block of MR rows gets, 0 if not even 4 fit
inline int gemv_warps(int mode, int mr, int K, int n_scales) {
  for (int w = kGemvWarps; w >= 4; w -= 4)
    if (gemv_smem(mode, mr, K, n_scales, w) <= kGemvMaxSmem) return w;
  return 0;
}

template <int MODE, typename OutT>
cudaError_t launch_gemv_rows(const void* x, int x_type, const int8_t* W,
                             const float* ws, int n_scales, OutT* out, int M,
                             int N, int K, int warps, int device,
                             cudaStream_t s) {
  if (M <= 1)
    return launch_gemv<MODE, 1>(x, x_type, W, ws, n_scales, out, M, N, K,
                                warps, device, s);
  if (M <= 2)
    return launch_gemv<MODE, 2>(x, x_type, W, ws, n_scales, out, M, N, K,
                                warps, device, s);
  if (M <= 4)
    return launch_gemv<MODE, 4>(x, x_type, W, ws, n_scales, out, M, N, K,
                                warps, device, s);
  return launch_gemv<MODE, 8>(x, x_type, W, ws, n_scales, out, M, N, K,
                              warps, device, s);
}

template <typename OutT>
int run(const void* x, int x_type, const int8_t* w, const float* ws,
        int n_scales, int bits, OutT* out, void* scratch, int M, int N,
        int K, int device, cudaStream_t s, int* launched) {
  const int mode = bits == 8 ? kW8 : n_scales > 1 ? kW4G : kW4;
  const int mr = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8;
  if (M <= 8) {
    const int warps = gemv_warps(mode, mr, K, n_scales);
    if (warps == 0) return (int)cudaErrorInvalidValue;
    if (mode == kW8)
      STEP(launch_gemv_rows<kW8>(x, x_type, w, ws, 1, out, M, N, K, warps,
                                 device, s));
    else if (mode == kW4)
      STEP(launch_gemv_rows<kW4>(x, x_type, w, ws, 1, out, M, N, K, warps,
                                 device, s));
    else
      STEP(launch_gemv_rows<kW4G>(x, x_type, w, ws, n_scales, out, M, N, K,
                                  warps, device, s));
    return 0;
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  int8_t* x8 = reinterpret_cast<int8_t*>(base);
  const size_t xs_at = ((size_t)M * K + 15) / 16 * 16;
  float* xs = reinterpret_cast<float*>(base + xs_at);
  // int4: the x8 row sums over each group (or all of K)
  int* rsum = mode == kW8 ? nullptr
                          : reinterpret_cast<int*>(base + xs_at +
                                                   (4 * (size_t)M + 15) / 16 *
                                                       16);
  const int gsize = mode == kW4G ? K / n_scales : K;
  STEP(launch_quant_rows(x, x_type, M, K, RowLn{nullptr, nullptr, 0.f}, x8,
                         xs, nullptr, rsum, gsize, s));
  if (mode == kW8)
    STEP((launch_gemm<kBInt8, false>(x8, w, QuantEpi<OutT>{out, xs, ws},
                                     nullptr, nullptr, 0, M, N, K, device,
                                     s)));
  else if (mode == kW4)
    STEP((launch_gemm<kBNibbles, false>(x8, w, QuantEpi<OutT>{out, xs, ws},
                                        rsum, nullptr, 0, M, N, K, device,
                                        s)));
  else
    STEP((launch_gemm<kBNibbles, true>(
        x8, w, QuantEpi<OutT, false>{out, xs, nullptr}, rsum, ws, n_scales / 2, M,
        N, K, device, s)));
  return 0;
}

}  // namespace

// x: (M, K) of x_type; w: (N, K) int8 (bits 8) or (N, K/2) packed (bits 4);
// ws: (n_scales, N) f32, n_scales 1 or K/G; out: (M, N) of out_type. Types:
// 0 float32, 1 bfloat16, 2 float16. scratch (M > 8; may be null at M <= 8):
// x8 (M*K int8) at its start, then xs (M float32) at the next multiple of 16
// bytes, then (bits 4) the x8 row sums, M x n_scales int32, at the next. x, w and scratch 16-byte aligned. M <= 8 runs the GEMV, whose
// shared memory must hold the int8 rows (M * K <= ~200 KB). Each launch
// counts one in *launched; returns the CUDA error of the first launch that
// failed, else 0.
extern "C" int quant_matmul(const void* x, int x_type, const int8_t* w,
                            const float* ws, int n_scales, int bits,
                            void* out, int out_type, void* scratch, int M,
                            int N, int K, int device, void* stream,
                            int* launched) {
  *launched = 0;
  const bool grouped = n_scales > 1;
  if (M < 1 || N < 1 || K < 32 || K % 16 != 0 || (bits != 8 && bits != 4) ||
      x_type < 0 || x_type > 2 || out_type < 0 || out_type > 2 ||
      !aligned16(x) || !aligned16(w) || !aligned16(scratch) ||
      (bits == 8 && grouped) ||
      (bits == 4 && (K % 64 != 0 ||
                     (grouped && (n_scales % 2 != 0 ||
                                  (K / 2) % (n_scales / 2) != 0 ||
                                  ((K / 2) / (n_scales / 2)) % 32 != 0)))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_type == 0)
    return run(x, x_type, w, ws, n_scales, bits, static_cast<float*>(out),
               scratch, M, N, K, device, s, launched);
  if (out_type == 1)
    return run(x, x_type, w, ws, n_scales, bits,
               static_cast<__nv_bfloat16*>(out), scratch, M, N, K, device, s,
               launched);
  return run(x, x_type, w, ws, n_scales, bits, static_cast<__half*>(out),
             scratch, M, N, K, device, s, launched);
}
