// DPC-KNN density and parent distance for B images of N tokens, C features.
//
// Replaces setok_tpu/kernels/cluster_pallas.py::dpc_density_parent (the two
// Pallas kernels _density_kernel and _parent_kernel). For each image, with
// G = x x^T, sq_i = G[i][i] and
// d2[i][j] = max(sq_i + sq_j - 2 G[i][j], 0) / C in float32, d2[i][i] = 0:
//
//   density[i] = exp(-(sum of the k smallest d2[i][:]) / k) + (i+0.5)/N*1e-6
//   rowmax[i]  = max_j sqrt(d2[i][j])
//   parent[i]  = min_j (density[j] > density[i] ? sqrt(d2[i][j]) : rowmax[j])
//
// parent carries the reference fill (non-higher entries take the per-column
// row max), i.e. what the JAX wrapper holds after its fill_min step. G is the
// float64 product rounded once to float32 (an f32 x f32 product is exact in
// float64), in the kernel and in its plain version alike; d2 is formed from
// it in float32, in the JAX order.
//
// What bounds it: the Gram product. d2 is symmetric, so the function needs
// the dot products for i <= j only, B*N*(N+1)*C operations (3.2 GFLOP at
// B=64, N=256, C=768: 0.048 ms at 67 TFLOP/s, the H100 SXM data sheet's f32
// CUDA-core peak, which the FP64 tensor cores equal). Up to N = 1024, two
// launches:
//
//   gram_kernel  one CTA of 4 warps per image and pair of 64-row tiles
//                I <= J (N = 256: 10 pairs, not 16; 5 CTAs an SM, so that
//                B = 64's 640 CTAs run in one wave). x streams in chunks of
//                16 features through a ring of three stages of cp.async
//                copies, in f32 (rows padded to 24 floats: a half warp's
//                8-byte fragment loads hit 16 bank pairs); each lane
//                converts its fragment values to f64 as it loads them, one
//                conversion a DMMA (staging f64 tiles instead took as many
//                shared-memory bytes again as the fragments themselves).
//                Each warp owns a 32 x 32 block of the pair and sums it on
//                the FP64 tensor cores (mma.sync m16n8k4 f64: 512 FMAs an
//                instruction, operands from shared memory, no per-FMA
//                shared load), then writes it rounded to f32, and its
//                mirror. On a diagonal pair the warp above the diagonal
//                idles (its block is the mirror of its neighbour's). Each
//                64-row tile of x is read N/64 times an image (N/16 with
//                16-row tiles).
//   density_parent_kernel  (N <= 1024) one cluster of CS CTAs (CS in {1,
//                2, 4, 8}, so that B * CS covers the SMs) per image, 8 warps a
//                CTA, 8 lanes a row up to N = 256 (4 rows a warp at once:
//                fewer shuffles a row and more independent work), 16 up to
//                512, else 32: the row of d2 from G and the diagonal, held in
//                registers; the exact k-th smallest value by a radix select
//                on the float bits (d2 >= +0, so the bits order like the
//                values; from the top bit of the row max down, 31 steps at
//                most), and the values below it plus the k-th value times
//                the remaining count: the exact multiset sum of the k
//                smallest, as the TPU kernel's bisection gives; only the
//                order of summation differs. The CTAs post their rows'
//                densities and row maxes in shared memory; after a cluster
//                barrier each gathers the others' through distributed
//                shared memory, and the parent of each row reads its row of
//                G again (from L2): the least d2 over the denser tokens,
//                one sqrt (monotone, so the same value as the least sqrt),
//                against the least row max of the others.
//
// Past N = 1024 a row no longer fits a warp's registers, and one cluster of
// at most 8 CTAs an image leaves most SMs idle at small B. Two launches take
// the place of density_parent_kernel there (3 a call in all):
//
//   density_rows_kernel  one warp a row, 8 rows a CTA, a CTA per (image, 8
//                rows): B * N / 8 CTAs over every SM. The warp builds its row
//                of d2 once from G (the same d2_of), into shared memory up to
//                N = 3072 (8 rows and their counts, 106.5 KB: 2 CTAs an SM),
//                recomputed from G at each pass past it. The k-th smallest by
//                a histogram select on the bits: four digits, [30:23] (the
//                exponent; bit 31 is 0), [22:15], [14:7] and [6:0], each
//                counted into the warp's 256 bins in shared memory (integer
//                atomics: the counts, and so the select, are exact and
//                repeatable) over the values whose higher digits match those
//                found so far; a warp scan of the bins picks the digit that
//                holds the k-th. The first digit is counted in the pass that
//                builds the row, with the row max, and lanes of one bin add
//                once (__match_any_sync: the exponents of a row fall in a
//                few bins). Each d2 is read 5 times (build, 3 digits, the
//                sum), where a radix select would read it up to 33 times.
//                The k-th value is the radix select's, and the sum takes the
//                values in the 32-lane order of the register path.
//   parent_rows_kernel  the same grid, a row a warp: the row of G once more
//                for the parent, as above, with sq, the densities and the
//                row maxes of the image read through L1 / L2 (held in
//                shared memory, 12 bytes a row, they would leave one CTA of
//                8 warps an SM at N = 19370, too few loads in flight: G was
//                read at 0.24 TB/s so).
//
// gram_kernel also writes sq (its diagonal) contiguously for these two.
//
// kMaxN: 227 KB, the most a block may opt in to on the H100, over the 12
// bytes a row (sq, dens, rmax) that each CTA of density_parent_kernel keeps;
// past kMaxRegN no array grows with N but the Gram scratch, B*N*N floats
// (16.8 MB at B=64, N=256; 1.5 GB an image at N = 19370). Shapes: any C,
// 1 <= N <= kMaxN, 1 <= k <= N.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

using mma16::dmma;

constexpr int kSmemOptIn = 232448;             // 227 KB a block (H100)
constexpr int kRowBytes = 3 * sizeof(float);   // sq, dens, rmax
constexpr int kMaxN = kSmemOptIn / kRowBytes;  // 19370
constexpr int kMaxRegN = 1024;                 // rows held in registers
constexpr int kMaxSmemRowN = 3072;             // then rows in shared memory
constexpr int kGT = 64;          // rows of a Gram tile
constexpr int kKC = 16;          // features a staged chunk
constexpr int kLdF = kKC + 8;    // floats a staged row (16-byte aligned rows)
constexpr int kStages = 3;       // chunks in the ring
constexpr int kGThreads = 128;   // 4 warps, 2 x 2 blocks of 32 x 32
constexpr int kPThreads = 256;   // 8 warps
constexpr int kPWarps = kPThreads / 32;
constexpr int kBins = 256;                     // a digit's counts, a warp

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// d2 in the JAX order: (sq_i + sq_j) - 2 g, clamped at 0, times 1/C
__device__ __forceinline__ float d2_of(float sqi, float sqj, float g,
                                       bool diag, float inv_c) {
  const float d = __fsub_rn(__fadd_rn(sqi, sqj), __fmul_rn(2.f, g));
  return (d > 0.f && !diag) ? __fmul_rn(d, inv_c) : 0.f;
}

// chunk ch (features ch*16 ..) of the tiles at rows r0 and r1 (64 rows
// each) into a stage of raw f32 rows (kLdF floats apart): 16-byte copies
// where C is a multiple of 4, else 4-byte ones; zeros past N or C. One
// commit group, empty past the last chunk.
__device__ __forceinline__ void load_chunk(float* stage, const float* xb,
                                            int r0, int r1, int ntiles,
                                            int ch, int N, int C, int nch) {
  if (ch < nch) {
    const int c0 = ch * kKC;
    for (int t = 0; t < ntiles; ++t) {
      float* dst = stage + t * kGT * kLdF;
      const int rt = t ? r1 : r0;
      if ((C & 3) == 0) {
        for (int e = threadIdx.x; e < kGT * kKC / 4; e += kGThreads) {
          const int r = e >> 2, c = c0 + (e & 3) * 4;
          const bool in = rt + r < N && c < C;
          mma16::cp_async16(mma16::smem_addr(dst + r * kLdF + (e & 3) * 4),
                            in ? xb + (size_t)(rt + r) * C + c : xb,
                            in ? 16 : 0);
        }
      } else {
        for (int e = threadIdx.x; e < kGT * kKC; e += kGThreads) {
          const int r = e / kKC, c = c0 + e % kKC;
          const bool in = rt + r < N && c < C;
          mma16::cp_async4(mma16::smem_addr(dst + r * kLdF + e % kKC),
                           in ? xb + (size_t)(rt + r) * C + c : xb,
                           in ? 4 : 0);
        }
      }
    }
  }
  mma16::cp_async_commit();
}

// gram: (B, N, N) f32, G[i][j] = x_i . x_j as the float64 sum rounded once;
// sq: (B, N), its diagonal.
// Grid (nT (nT + 1) / 2, B), nT = ceil(N / 64). Shared: a ring of kStages
// chunks of raw f32 rows; each lane converts its fragment values to f64 as
// it loads them (one conversion a DMMA).
__global__ void __launch_bounds__(kGThreads, 5)
gram_kernel(const float* __restrict__ x, float* __restrict__ gram,
            float* __restrict__ sq, int N, int C, int nT) {
  __shared__ __align__(16) float raw[kStages][2 * kGT * kLdF];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  int I = 0, rem = blockIdx.x;
  while (rem >= nT - I) {
    rem -= nT - I;
    ++I;
  }
  const int J = I + rem;
  const bool diag = I == J;
  const bool active = !diag || wm >= wn;
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * N * C;
  const int ri = I * kGT, rj = J * kGT;
  const int ntiles = diag ? 1 : 2;
  const int nch = (C + kKC - 1) / kKC;

  double acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0;

  load_chunk(raw[0], xb, ri, rj, ntiles, 0, N, C, nch);
  load_chunk(raw[1], xb, ri, rj, ntiles, 1, N, C, nch);
  for (int ch = 0; ch < nch; ++ch) {
    mma16::cp_async_wait<1>();   // chunk ch has landed
    __syncthreads();             // ... for every thread; chunk ch - 1 is done
    load_chunk(raw[(ch + 2) % kStages], xb, ri, rj, ntiles, ch + 2, N, C,
                nch);
    if (active) {
      // a float2 at feature kb*8 + 2 t4 holds two k steps' operands: one
      // sums features kb*8 + {0, 2, 4, 6}, the other the odd ones
      const float* st = raw[ch % kStages];
      const float* A = st + (wm * 32 + g) * kLdF + 2 * t4;
      const float* Bm = st + (diag ? 0 : kGT * kLdF) + (wn * 32 + g) * kLdF +
                        2 * t4;
#pragma unroll 1
      for (int kb = 0; kb < kKC / 8; ++kb) {
        double b0[4], b1[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float2 f =
              *reinterpret_cast<const float2*>(Bm + nt * 8 * kLdF + kb * 8);
          b0[nt] = (double)f.x;
          b1[nt] = (double)f.y;
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float2 f0 = *reinterpret_cast<const float2*>(
              A + mt * 16 * kLdF + kb * 8);
          const float2 f1 = *reinterpret_cast<const float2*>(
              A + (mt * 16 + 8) * kLdF + kb * 8);
          const double a0x = f0.x, a1x = f1.x, a0y = f0.y, a1y = f1.y;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) dmma(acc[mt][nt], a0x, a1x, b0[nt]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) dmma(acc[mt][nt], a0y, a1y, b1[nt]);
        }
      }
    }
  }

  if (!active) return;
  float* gb = gram + (size_t)b * N * N;
  const bool mirror = !(diag && wm == wn);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ri + wm * 32 + mt * 16 + g + (e >> 1) * 8;
        const int j = rj + wn * 32 + nt * 8 + 2 * t4 + (e & 1);
        if (i < N && j < N) {
          const float val = (float)acc[mt][nt][e];
          gb[(size_t)i * N + j] = val;
          if (mirror) gb[(size_t)j * N + i] = val;
          if (i == j) sq[(size_t)b * N + i] = val;
        }
      }
}

// Grid (B * CS), clusters of CS: CTA r of an image's cluster owns rows
// r * ceil(N / CS) ..; a row takes LPR lanes (a warp 32 / LPR rows at a
// time), each lane NPL values of it (NPL * LPR >= N, N <= kMaxRegN).
// Dynamic shared memory: sq, dens and rmax, N floats each.
template <int LPR, int NPL>
__global__ void __launch_bounds__(kPThreads)
density_parent_kernel(const float* __restrict__ gram,
                      float* __restrict__ density, float* __restrict__ parent,
                      float* __restrict__ rowmax, int N, int k, float inv_c) {
  constexpr int kRows = 32 / LPR;   // rows a warp at a time
  extern __shared__ float smem[];
  float* sq = smem;
  float* dens = smem + N;
  float* rmax = smem + 2 * N;
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int seg = lane / LPR, l = lane % LPR;
  const float* gb = gram + (size_t)b * N * N;
  for (int j = tid; j < N; j += kPThreads) sq[j] = gb[(size_t)j * (N + 1)];
  __syncthreads();
  const int per = (N + CS - 1) / CS;
  const int r0 = rank * per, r1 = min(N, r0 + per);

  for (int base = r0 + warp * kRows; base < r1; base += kPWarps * kRows) {
    const int i = base + seg;
    const bool own = i < r1;
    const float* row = gb + (size_t)(own ? i : r0) * N;
    const float sqi = sq[own ? i : r0];
    float v[NPL];
    float m = 0.f;
#pragma unroll
    for (int t = 0; t < NPL; ++t) {
      const int j = l + LPR * t;
      v[t] = INFINITY;   // past N: never below the k-th value
      if (own && j < N) {
        v[t] = d2_of(sqi, sq[j], row[j], i == j, inv_c);
        m = fmaxf(m, v[t]);
      }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    // largest bit pattern t with #{v < t} < k: the k-th smallest value (at
    // most the row max, so the bits above the warp's largest max are 0)
    const unsigned top = __float_as_uint(warp_max(m));
    unsigned int kth = 0u;
    for (int bit = top ? 31 - __clz(top) : -1; bit >= 0; --bit) {
      const unsigned int cand = kth | (1u << bit);
      int cnt = 0;
#pragma unroll
      for (int t = 0; t < NPL; ++t) cnt += __float_as_uint(v[t]) < cand;
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
      if (cnt < k) kth = cand;
    }
    const float kv = __uint_as_float(kth);
    float s = 0.f;
    int below = 0;
#pragma unroll
    for (int t = 0; t < NPL; ++t) {
      if (v[t] < kv) {
        s += v[t];
        ++below;
      }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      below += __shfl_xor_sync(0xffffffffu, below, o);
    }
    if (own && l == 0) {
      s += kv * (float)(k - below);
      const float di =
          expf(-(s / (float)k)) + ((float)i + 0.5f) / (float)N * 1e-6f;
      const float rm = sqrtf(m);
      dens[i] = di;
      rmax[i] = rm;
      density[(size_t)b * N + i] = di;
      rowmax[(size_t)b * N + i] = rm;
    }
  }

  cluster.sync();
  for (int p = 0; p < CS; ++p) {
    if (p == rank) continue;
    const float* pd = cluster.map_shared_rank(dens, p);
    const float* pr = cluster.map_shared_rank(rmax, p);
    const int p1 = min(N, (p + 1) * per);
    for (int j = p * per + tid; j < p1; j += kPThreads) {
      dens[j] = pd[j];
      rmax[j] = pr[j];
    }
  }
  cluster.sync();   // every density gathered; no peer reads this CTA again

  // parent = min(sqrt(min of d2 over the higher j), min of rmax over the
  // others): sqrt is monotone, so this is the min of the row's entries
  for (int base = r0 + warp * kRows; base < r1; base += kPWarps * kRows) {
    const int i = base + seg;
    const bool own = i < r1;
    const float* row = gb + (size_t)(own ? i : r0) * N;
    const float sqi = sq[own ? i : r0], di = dens[own ? i : r0];
    float near = INFINITY, fill = INFINITY;
#pragma unroll
    for (int t = 0; t < NPL; ++t) {
      const int j = l + LPR * t;
      if (own && j < N) {
        if (dens[j] > di)
          near = fminf(near, d2_of(sqi, sq[j], row[j], i == j, inv_c));
        else
          fill = fminf(fill, rmax[j]);
      }
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) {
      near = fminf(near, __shfl_xor_sync(0xffffffffu, near, o));
      fill = fminf(fill, __shfl_xor_sync(0xffffffffu, fill, o));
    }
    if (own && l == 0) parent[(size_t)b * N + i] = fminf(sqrtf(near), fill);
  }
}

// The bin of a warp's 256 counts that holds the kk-th smallest (1-based) of
// the values counted; kk becomes its rank within that bin. Lane l reads
// bins 8l .. 8l + 7; an inclusive scan of the lanes' sums finds the lane
// whose bins cross kk.
__device__ __forceinline__ unsigned find_bin(const unsigned* hist, int& kk,
                                             int lane) {
  const uint4 a = reinterpret_cast<const uint4*>(hist)[2 * lane];
  const uint4 c = reinterpret_cast<const uint4*>(hist)[2 * lane + 1];
  const unsigned n[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  unsigned local = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) local += n[t];
  unsigned incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  const unsigned want = (unsigned)kk, excl = incl - local;
  const int src =
      __ffs(__ballot_sync(0xffffffffu, excl < want && want <= incl)) - 1;
  unsigned bin = 0, below = excl, run = excl;
  bool found = false;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (!found && run + n[t] >= want) {
      bin = 8 * lane + t;
      below = run;
      found = true;
    }
    run += n[t];
  }
  bin = __shfl_sync(0xffffffffu, bin, src);
  below = __shfl_sync(0xffffffffu, below, src);
  kk -= (int)below;
  return bin;
}

__device__ __forceinline__ void zero_bins(unsigned* hist, int lane) {
  reinterpret_cast<uint4*>(hist)[2 * lane] = make_uint4(0, 0, 0, 0);
  reinterpret_cast<uint4*>(hist)[2 * lane + 1] = make_uint4(0, 0, 0, 0);
}

// d2[i][j] of a row past kMaxRegN: from the warp's copy in shared memory
// (kRow), else again from the Gram row and sq
template <bool kRow>
__device__ __forceinline__ float row_value(const float* rowbuf,
                                           const float* row, const float* sq,
                                           float sqi, int i, int j,
                                           float inv_c) {
  if constexpr (kRow)
    return rowbuf[j];
  else
    return d2_of(sqi, __ldg(sq + j), __ldg(row + j), i == j, inv_c);
}

// Grid (ceil(N / 8), B), 8 warps: warp w of CTA x owns row 8x + w of image
// y. Dynamic shared memory: 8 warps' 256 counts, then (kRow) their rows of
// N floats. The density and row max of that row.
template <bool kRow>
__global__ void __launch_bounds__(kPThreads)
density_rows_kernel(const float* __restrict__ gram,
                    const float* __restrict__ sqg,
                    float* __restrict__ density, float* __restrict__ rowmax,
                    int N, int k, float inv_c) {
  extern __shared__ __align__(16) unsigned char rsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, i = blockIdx.x * kPWarps + warp;
  if (i >= N) return;   // a whole warp; no block barrier below
  unsigned* hist = reinterpret_cast<unsigned*>(rsm) + warp * kBins;
  float* rowbuf =
      reinterpret_cast<float*>(rsm + kPWarps * kBins * 4) + (size_t)warp * N;
  const float* row = gram + ((size_t)b * N + i) * N;
  const float* sq = sqg + (size_t)b * N;
  const float sqi = sq[i];

  // build: the row (kRow), its max, and the exponent digit's counts
  zero_bins(hist, lane);
  __syncwarp();
  float m = 0.f;
  for (int j0 = 0; j0 < N; j0 += 32) {
    const int j = j0 + lane;
    unsigned bin = 0xffffffffu;   // past N: no bin
    if (j < N) {
      const float v = d2_of(sqi, __ldg(sq + j), __ldg(row + j), i == j, inv_c);
      if constexpr (kRow) rowbuf[j] = v;
      m = fmaxf(m, v);
      bin = __float_as_uint(v) >> 23;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (j < N && lane == __ffs(peers) - 1) atomicAdd(hist + bin, __popc(peers));
  }
  m = warp_max(m);
  __syncwarp();
  int kk = k;
  unsigned kth = find_bin(hist, kk, lane) << 23;
  // digits [22:15], [14:7], [6:0] over the values that match the bits above
#pragma unroll 1
  for (int d = 1; d < 4; ++d) {
    const int shift = d == 1 ? 15 : d == 2 ? 7 : 0;
    const int hi = d == 3 ? 7 : shift + 8;
    const unsigned mask = d == 3 ? 0x7fu : 0xffu;
    __syncwarp();   // every lane has read the last digit's counts
    zero_bins(hist, lane);
    __syncwarp();
    for (int j = lane; j < N; j += 32) {
      const unsigned u = __float_as_uint(
          row_value<kRow>(rowbuf, row, sq, sqi, i, j, inv_c));
      if ((u >> hi) == (kth >> hi)) atomicAdd(hist + ((u >> shift) & mask), 1u);
    }
    __syncwarp();
    kth |= find_bin(hist, kk, lane) << shift;
  }

  // the values below the k-th, in the register path's 32-lane order
  const float kv = __uint_as_float(kth);
  float s = 0.f;
  int below = 0;
  for (int j = lane; j < N; j += 32) {
    const float v = row_value<kRow>(rowbuf, row, sq, sqi, i, j, inv_c);
    if (v < kv) {
      s += v;
      ++below;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    below += __shfl_xor_sync(0xffffffffu, below, o);
  }
  if (lane == 0) {
    s += kv * (float)(k - below);
    density[(size_t)b * N + i] =
        expf(-(s / (float)k)) + ((float)i + 0.5f) / (float)N * 1e-6f;
    rowmax[(size_t)b * N + i] = sqrtf(m);
  }
}

// Grid (ceil(N / 8), B), 8 warps: warp w of CTA x owns row 8x + w of image
// y, as in density_rows_kernel. sq, the densities and the row maxes come
// from L1 / L2 (12 bytes a row of the image), the row of G once more.
__global__ void __launch_bounds__(kPThreads)
parent_rows_kernel(const float* __restrict__ gram,
                   const float* __restrict__ sqg,
                   const float* __restrict__ density,
                   const float* __restrict__ rowmax,
                   float* __restrict__ parent, int N, float inv_c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, i = blockIdx.x * kPWarps + warp;
  if (i >= N) return;
  const size_t off = (size_t)b * N;
  const float* row = gram + (off + i) * N;
  const float* sq = sqg + off;
  const float* dens = density + off;
  const float* rmax = rowmax + off;
  const float sqi = sq[i], di = dens[i];
  float near = INFINITY, fill = INFINITY;
  for (int j = lane; j < N; j += 32) {
    const float g = __ldg(row + j);
    if (__ldg(dens + j) > di)
      near = fminf(near, d2_of(sqi, __ldg(sq + j), g, i == j, inv_c));
    else
      fill = fminf(fill, __ldg(rmax + j));
  }
  for (int o = 16; o > 0; o >>= 1) {
    near = fminf(near, __shfl_xor_sync(0xffffffffu, near, o));
    fill = fminf(fill, __shfl_xor_sync(0xffffffffu, fill, o));
  }
  if (lane == 0) parent[off + i] = fminf(sqrtf(near), fill);
}

int sm_count(int device) {
  static int cached[32] = {0};
  if (device >= 0 && device < 32 && cached[device] > 0) return cached[device];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  if (device >= 0 && device < 32) cached[device] = n;
  return n;
}

// Above 48 KB of dynamic shared memory a kernel must opt in: once a device
// for each kernel (the static is this instantiation's own).
template <auto Kernel>
cudaError_t allow_smem(size_t bytes, int device) {
  static bool raised[32] = {false};
  if (bytes <= 48 * 1024 || raised[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (err == cudaSuccess) raised[device] = true;
  return err;
}

template <int LPR, int NPL>
cudaError_t launch_density_parent(const float* gram, float* density,
                                  float* parent, float* rowmax, int B, int N,
                                  int k, float inv_c, int CS,
                                  cudaStream_t stream) {
  const size_t smem = (size_t)N * kRowBytes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * CS, 1, 1);
  cfg.blockDim = dim3(kPThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, density_parent_kernel<LPR, NPL>, gram,
                            density, parent, rowmax, N, k, inv_c);
}

// past kMaxRegN: the rows of d2, over every SM
template <bool kRow>
cudaError_t launch_density_rows(const float* gram, const float* sq,
                                float* density, float* rowmax, int B, int N,
                                int k, float inv_c, int device,
                                cudaStream_t stream) {
  const size_t smem =
      (size_t)kPWarps * kBins * 4 + (kRow ? (size_t)kPWarps * N * 4 : 0);
  const cudaError_t err = allow_smem<density_rows_kernel<kRow>>(smem, device);
  if (err != cudaSuccess) return err;
  density_rows_kernel<kRow>
      <<<dim3((N + kPWarps - 1) / kPWarps, B), kPThreads, smem, stream>>>(
          gram, sq, density, rowmax, N, k, inv_c);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when every launch was accepted. Launches
// the kernels above on `stream` (2 up to N = kMaxRegN, 3 past it) and counts
// each accepted launch in *launched; allocates nothing (gram is B*N*N floats
// of scratch, sq B*N).
extern "C" int dpc_density_parent_f32(const float* x, float* density,
                                      float* parent, float* rowmax,
                                      float* gram, float* sq, int B, int N,
                                      int C, int k, float inv_c, int device,
                                      void* stream, int* launched) {
  *launched = 0;
  if (B < 1 || B > 65535 || N < 1 || N > kMaxN || C < 1 || k < 1 || k > N ||
      device < 0 || device >= 32)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const int sms = sm_count(device);
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const int nT = (N + kGT - 1) / kGT;
  gram_kernel<<<dim3(nT * (nT + 1) / 2, B), kGThreads, 0, s>>>(x, gram, sq, N,
                                                               C, nT);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;

  if (N > kMaxRegN) {
    err = N <= kMaxSmemRowN
              ? launch_density_rows<true>(gram, sq, density, rowmax, B, N, k,
                                          inv_c, device, s)
              : launch_density_rows<false>(gram, sq, density, rowmax, B, N, k,
                                           inv_c, device, s);
    if (err != cudaSuccess) return (int)err;
    ++*launched;
    parent_rows_kernel<<<dim3((N + kPWarps - 1) / kPWarps, B), kPThreads, 0,
                         s>>>(gram, sq, density, rowmax, parent, N, inv_c);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ++*launched;
    return 0;
  }

  // the least cluster whose CTAs cover the SMs (at most 8), with 8 rows a
  // CTA at least
  int cs = 1;
  while (cs < 8 && (long long)B * cs < sms) cs *= 2;
  while (cs > 1 && cs * kPWarps > N) cs /= 2;
  // lanes a row: 8 (4 rows a warp) up to N = 256, 16 up to 512, else 32
  if (N <= 256)
    err = launch_density_parent<8, 32>(gram, density, parent, rowmax, B, N,
                                       k, inv_c, cs, s);
  else if (N <= 512)
    err = launch_density_parent<16, 32>(gram, density, parent, rowmax, B, N,
                                        k, inv_c, cs, s);
  else if (N <= 768)
    err = launch_density_parent<32, 24>(gram, density, parent, rowmax, B, N,
                                        k, inv_c, cs, s);
  else
    err = launch_density_parent<32, 32>(gram, density, parent, rowmax, B, N,
                                        k, inv_c, cs, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}
