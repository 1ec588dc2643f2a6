// Decode attention over the int8 KV cache, dequantised in the kernel.
//
// Replaces setok_tpu/kernels/cache_attention.py:75
// (int8_cache_decode_attention). One query per row (a decode step); GQA
// folded as G = H / KVH query rows per (batch row, kv head). The TPU kernel
// is one Pallas program per (b, kv head) that holds the (S, D) int8 slabs in
// VMEM and computes, in this order:
//
//   s = (q . K^T) * (k_scale * sm_scale), -1e30 where the key is masked;
//   p = exp(s - max) / sum (a fully masked row: the uniform average);
//   out = (p * v_scale) . V.
//
// Every sum (the q.K dots, the softmax sum, the P.V sums) and the exp run in
// float64 and round to float32 once, and so does the plain version: the
// float32 results of exact sums, whatever the order. Summed in float32 in
// another order, the two differed in the last bit, and an int8 KV cache
// turns such a bit into a flipped rounding step of a cached K or V entry,
// which every later decode step reads (1e-2 on the logits of a 2-layer
// trunk after a few steps, measured on the card).
//
// What bounds it (H100 SXM data sheet): the cache bytes. At B = 4, S = 512,
// KVH = 32, D = 128 one layer reads 2 x 8.4 MB of int8 K/V plus 0.5 MB of
// scales, 5.2 us at 3.35 TB/s. The design:
//
//   * A thread-block cluster of CS CTAs per (b, kv head), CS in {1, 2, 4, 8}:
//     the largest whose B * KVH * CS CTAs run in one wave at 2 an SM (CS =
//     2 at the serving shape: 256 CTAs; measured on the H100, CS = 4 ran
//     two waves and took 2.0x as long, CS = 1 1.25x), CS = 8 for a few
//     heads over a long cache. The keys come in tiles of 32; CTA r of the
//     cluster owns tiles r, r + CS, r + 2 CS, ... (interleaved, so that a
//     prefix of valid keys spreads over the cluster).
//   * Each CTA streams its K tiles, then its V tiles, through a ring of two
//     batches of up to 32 KB (8 tiles at D = 128) of cp.async 16-byte
//     copies (a key's row is D bytes at a stride of KVH * D): the V tiles'
//     copies are in flight while the K tiles' scores and the cluster's
//     softmax exchange run. A batch is consumed at once, by every warp:
//     a CTA's steps are each a long dependent chain (starting a copy, a
//     barrier, 16 dependent FMAs and a shuffle tree), so fewer, wider
//     steps (two keys a lane at once) are what shortens its life.
//   * The softmax stays exact and in the JAX order across the cluster,
//     through distributed shared memory: each CTA posts its rows' float32
//     maxima, every CTA reads all CS of them after a cluster barrier (the
//     same global max m); then each posts its float64 partial sums of
//     p = (float)exp(s - m), and every CTA adds the CS partials in rank
//     order and rounds once (l). p / l * v_scale is a float32 product, as
//     in the JAX kernel. Each CTA's float64 partial P.V (its keys, every
//     column) is summed over its warps in shared memory and stored into the
//     shared memory of the CTA that owns the column (CTA r: columns
//     r * D / CS ..); after a third and last cluster barrier each CTA adds
//     the CS partials of its columns in rank order, rounds once and writes
//     them in q's type.
//   * A tile whose 32 keys are all masked, in a row that has a valid key,
//     is skipped: exp(-1e30 - m) is exactly 0 in float64, so it would add
//     exactly 0 to l and to P.V. A row with no valid key reads every key
//     (every s - m is 0: the uniform average). `skipped`, where given,
//     counts the tiles skipped.
//   * int8 values become doubles without a conversion instruction (the
//     card converts to and from 64-bit types at a quarter of its FP64 FMA
//     rate): the byte, offset by 128, is the low word of 2^52 + u, and one
//     float64 subtraction gives the exact value.
//   * One launch a call: q is read in its own type (f32, bf16 or f16) and
//     the output written in it; the mask is read at its batch stride; the
//     shared-memory opt-in is set once per kernel and device.
//
// Shapes: G <= 8, D a power of two in [16, 512], any S whose cluster split
// fits shared memory (every S <= 8192 at those G and D).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mma16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // keys a tile
constexpr int kMaxG = 8;
constexpr int kMaxCluster = 8;
constexpr int kBatchBudget = 32768;  // bytes of K or V tiles a batch at most
constexpr int kSmemLimit = 232448;
constexpr float kNegInf = -1e30f;
// 2^52 + 128: the double whose low word is a byte offset by 128, less this,
// is the signed byte
constexpr double kByteBias = 4503599627370624.0;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// byte i of w (whose bytes were xor-ed with 0x80) as the exact signed value
__device__ __forceinline__ double s8_at(uint32_t w, int i) {
  return __hiloint2double(0x43300000, (int)__byte_perm(w, 0, 0x4440 | i)) -
         kByteBias;
}

// the shared memory of one CTA (byte offsets)
struct Layout {
  int ntl;     // tiles a CTA owns at most
  int per;     // tiles a batch
  int qd, sc, kvs, pvd, recv, ring, small, total;
};

__host__ __device__ inline int qd_stride(int D) { return D + D / 8; }

__host__ __device__ inline Layout layout_of(int S, int G, int D, int CS) {
  Layout a;
  const int nt = (S + kTile - 1) / kTile;
  a.ntl = (nt + CS - 1) / CS;
  int per = kBatchBudget / (kTile * D);
  if (per > a.ntl) per = a.ntl;
  a.per = per < 1 ? 1 : per;
  const int ring = 2 * a.per * kTile * D;   // two batches
  const int red = kThreads * 4 * G * 8;     // the warps' partial P.V, f64
  a.qd = 0;                                                   // G x stride f64
  a.sc = a.qd + G * qd_stride(D) * 8;                         // G x ntl*32 f32
  a.kvs = a.sc + G * a.ntl * kTile * 4;                      // 2 x ntl*32 f32
  a.pvd = a.kvs + (2 * a.ntl * kTile * 4 + 15) / 16 * 16;     // G x per*32 f64
  a.recv = a.pvd + G * a.per * kTile * 8;                     // G x D f64
  a.ring = a.recv + G * D * 8;                                // ring | red
  a.small = a.ring + (ring > red ? ring : red);
  // xl[8] f64, wred[kWarps][8] f64, xm[8], mg[8], lf[8] f32, nlive, the
  // live tiles (ntl), the tiles' mask bits (nt)
  a.total = a.small + 8 * 8 + kWarps * kMaxG * 8 + 3 * 8 * 4 + 16 +
            a.ntl * 4 + nt * 4;
  return a;
}

// batch bi of the ring (K batches, then V batches; `per` tiles each, of the
// live list) into its slot (bi % 2): 16-byte copies of the key rows; a K
// batch also brings its keys' k and v scales (4-byte copies; past S,
// zeros). One commit group, empty past the last batch.
__device__ __forceinline__ void load_batch(
    int bi, int nbk, int nl, int per, const int* list, unsigned char* ring,
    float* kss, float* vss, const int8_t* k, const int8_t* v,
    const float* ks, const float* vs, size_t row0, int S, int KVH, int h,
    int D) {
  if (bi < 2 * nbk) {
    const bool kside = bi < nbk;
    const int u0 = (kside ? bi : bi - nbk) * per;
    const int nb = min(per, nl - u0);
    const int8_t* src = kside ? k : v;
    unsigned char* slot = ring + (bi & 1) * per * kTile * D;
    const int cpr = D >> 4;   // 16-byte chunks a key row
    for (int c = threadIdx.x; c < nb * kTile * cpr; c += kThreads) {
      const int kk = c / cpr, part = c % cpr;
      const int j = list[u0 + kk / kTile] * kTile + kk % kTile;
      if (j < S)
        cp_async16(smem_addr(slot + kk * D + part * 16),
                   src + ((row0 + j) * KVH + h) * D + part * 16, 16);
    }
    if (kside)
      for (int c = threadIdx.x; c < 2 * nb * kTile; c += kThreads) {
        const int kk = c % (nb * kTile), e = (u0 * kTile) + kk;
        const int j = list[u0 + kk / kTile] * kTile + kk % kTile;
        const bool kscale = c < nb * kTile;
        cp_async4(smem_addr((kscale ? kss : vss) + e),
                  (kscale ? ks : vs) + (row0 + (j < S ? j : 0)) * KVH + h,
                  j < S ? 4 : 0);
      }
  }
  cp_async_commit();
}

// q: (B, KVH*G, D) of T; k, v: (B, S, KVH, D) int8; ks, vs: (B, S, KVH) f32;
// valid: byte b * valid_sb + j, nonzero = attend. out: (B, KVH*G, D) of T.
// Grid (KVH * CS, B), clusters of CS along x.
template <typename T, int MAXG>
__global__ void __launch_bounds__(kThreads, 2)
cache_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                  const float* __restrict__ ks, const int8_t* __restrict__ v,
                  const float* __restrict__ vs,
                  const uint8_t* __restrict__ valid, long long valid_sb,
                  T* __restrict__ out, unsigned* __restrict__ skipped,
                  float sm_scale, int S, int KVH, int G, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.x / CS, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Layout L = layout_of(S, G, D, CS);
  const int nloc = L.ntl * kTile;
  const int qs = qd_stride(D);
  double* qd = reinterpret_cast<double*>(smem + L.qd);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* kss = reinterpret_cast<float*>(smem + L.kvs);   // k_scale, live keys
  float* vss = kss + nloc;                               // v_scale
  double* pvd = reinterpret_cast<double*>(smem + L.pvd);
  unsigned char* ring = smem + L.ring;
  double* red = reinterpret_cast<double*>(smem + L.ring);
  double* recv = reinterpret_cast<double*>(smem + L.recv);
  double* xl = reinterpret_cast<double*>(smem + L.small);
  double* wred = xl + 8;
  float* xm = reinterpret_cast<float*>(wred + kWarps * kMaxG);
  float* mg = xm + 8;
  float* lf = mg + 8;
  int* nlive = reinterpret_cast<int*>(lf + 8);
  int* list = nlive + 4;
  unsigned* tmask = reinterpret_cast<unsigned*>(list + L.ntl);
  const uint8_t* vrow = valid + (long long)b * valid_sb;
  const size_t row0 = (size_t)b * S;

  // q as doubles, each 16 values followed by 2 doubles of padding (a lane
  // reads its 16 columns; the padding puts 8 lanes in 8 bank groups)
  const T* qb = q + ((size_t)b * KVH + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    qd[g * qs + d + (d >> 4) * 2] = (double)to_f32(qb[i]);
  }
  // the mask bits of every tile (a warp a tile); does the row have a valid
  // key; which of this CTA's tiles are live
  const int nt = (S + kTile - 1) / kTile;
  int found = 0;
#pragma unroll 4
  for (int t = warp; t < nt; t += kWarps) {
    const int j = t * kTile + lane;
    const unsigned bal = __ballot_sync(0xffffffffu, j < S && vrow[j] != 0);
    if (lane == 0) tmask[t] = bal;
    found |= bal != 0;
  }
  const bool any = __syncthreads_or(found) != 0;
  int ntl = 0;
  for (int t = rank; t < nt; t += CS) ++ntl;
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < ntl; base += 32) {
      const int lt = base + lane;
      const int t = rank + lt * CS;
      const bool live = lt < ntl && (!any || tmask[t] != 0);
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (live) list[n + __popc(bal & ((1u << lane) - 1u))] = t;
      n += __popc(bal);
    }
    if (lane == 0) {
      *nlive = n;
      if (skipped != nullptr && ntl > n)
        atomicAdd(skipped, (unsigned)(ntl - n));
    }
  }
  __syncthreads();
  const int nl = *nlive;

  // 1. scores of the K tiles, a batch at a time: D / 16 lanes a key, 16
  // columns each, two keys a lane at once (independent chains); one query
  // row at a time, its 16 values of the lane in registers
  const int per = L.per;
  const int nbk = (nl + per - 1) / per;
  const int lpk = D >> 4;
  const int kpw = 32 / lpk < 1 ? 1 : 32 / lpk;
  const int sub = lane % lpk;
  const int pass = kWarps * kpw;   // keys of all warps' lanes at once
  load_batch(0, nbk, nl, per, list, ring, kss, vss, k, v, ks, vs, row0, S,
              KVH, h, D);
  load_batch(1, nbk, nl, per, list, ring, kss, vss, k, v, ks, vs, row0, S,
              KVH, h, D);
  for (int bi = 0; bi < nbk; ++bi) {
    cp_async_wait<1>();   // batch bi has landed
    __syncthreads();
    const unsigned char* slot = ring + (bi & 1) * per * kTile * D;
    const int u0 = bi * per;
    const int kb = min(per, nl - u0) * kTile;   // keys of the batch
    for (int g = 0; g < G; ++g) {
      double qr[16];
      const double* ql = qd + g * qs + sub * 18;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const double2 qq = *reinterpret_cast<const double2*>(ql + 2 * c);
        qr[2 * c] = qq.x;
        qr[2 * c + 1] = qq.y;
      }
      for (int i0 = 0; i0 < kb; i0 += 2 * pass) {
        int kk[2], j[2];
        bool in[2];
        uint32_t w[2][4];
        double dot[2] = {0.0, 0.0};
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          kk[x] = i0 + x * pass + warp * kpw + lane / lpk;
          j[x] = kk[x] < kb ? list[u0 + kk[x] / kTile] * kTile + kk[x] % kTile
                            : S;
          in[x] = j[x] < S;
          uint4 raw = make_uint4(0u, 0u, 0u, 0u);
          if (in[x])
            raw = *reinterpret_cast<const uint4*>(slot + kk[x] * D + sub * 16);
          w[x][0] = raw.x ^ 0x80808080u;
          w[x][1] = raw.y ^ 0x80808080u;
          w[x][2] = raw.z ^ 0x80808080u;
          w[x][3] = raw.w ^ 0x80808080u;
        }
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          dot[0] = fma(qr[c], s8_at(w[0][c >> 2], c & 3), dot[0]);
          dot[1] = fma(qr[c], s8_at(w[1][c >> 2], c & 3), dot[1]);
        }
        for (int o = lpk >> 1; o > 0; o >>= 1) {
          dot[0] += __shfl_xor_sync(0xffffffffu, dot[0], o);
          dot[1] += __shfl_xor_sync(0xffffffffu, dot[1], o);
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if (kk[x] < kb && sub == 0) {
            const int e = u0 * kTile + kk[x];
            const unsigned bits = tmask[list[u0 + kk[x] / kTile]];
            sc[g * nloc + e] =
                !in[x] ? -INFINITY
                : (bits >> (kk[x] % kTile)) & 1u
                    ? __fmul_rn((float)dot[x], __fmul_rn(kss[e], sm_scale))
                    : kNegInf;
          }
        }
      }
    }
    __syncthreads();   // the slot is free
    load_batch(bi + 2, nbk, nl, per, list, ring, kss, vss, k, v, ks, vs,
                row0, S, KVH, h, D);
  }
  __syncthreads();

  // 2. the cluster's max, exp and sum; then p / l * v_scale in place
  const int keys = nl * kTile;
  for (int g = 0; g < G; ++g) {
    float m = -INFINITY;
    for (int j = tid; j < keys; j += kThreads) m = fmaxf(m, sc[g * nloc + j]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) reinterpret_cast<float*>(wred)[warp * kMaxG + g] = m;
  }
  __syncthreads();
  if (tid < G) {
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w)
      m = fmaxf(m, reinterpret_cast<float*>(wred)[w * kMaxG + tid]);
    xm[tid] = m;
  }
  cluster.sync();
  if (tid < G) {
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < CS) m = fmaxf(m, *cluster.map_shared_rank(xm + tid, r));
    mg[tid] = m;
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    const float m = mg[g];
    double l = 0.0;
    for (int j = tid; j < keys; j += kThreads) {
      const float p = (float)exp((double)__fsub_rn(sc[g * nloc + j], m));
      sc[g * nloc + j] = p;
      l += p;
    }
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) wred[warp * kMaxG + g] = l;
  }
  __syncthreads();
  if (tid < G) {
    double l = 0.0;
    for (int w = 0; w < kWarps; ++w) l += wred[w * kMaxG + tid];
    xl[tid] = l;
  }
  cluster.sync();
  if (tid < G) {
    double part[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      part[r] = r < CS ? *cluster.map_shared_rank(xl + tid, r) : 0.0;
    double l = 0.0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < CS) l += part[r];
    lf[tid] = (float)l;
  }
  __syncthreads();
  for (int e = tid; e < G * keys; e += kThreads) {
    const int g = e / keys, jl = e % keys;
    const int j = list[jl / kTile] * kTile + jl % kTile;
    float* s = sc + g * nloc + jl;
    *s = j < S ? __fmul_rn(__fdiv_rn(*s, lf[g]), vss[jl]) : 0.f;
  }

  // 3. P.V of the V tiles, a batch at a time: thread (slice, 4 columns),
  // keys slice, slice + slices, ..; two sets of sums (even and odd keys of
  // the thread) where registers allow, added at the end
  constexpr int kSets = MAXG <= 2 ? 2 : 1;
  const int cgs = D >> 2;
  const int c4 = tid % cgs, slice = tid / cgs, slices = kThreads / cgs;
  double acc[kSets][MAXG][4];
#pragma unroll
  for (int z = 0; z < kSets; ++z)
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[z][g][c] = 0.0;
  __syncthreads();   // p / l * v_scale is in place
  for (int bi = nbk; bi < 2 * nbk; ++bi) {
    const int u0 = (bi - nbk) * per;
    const int kb = min(per, nl - u0) * kTile;
    for (int e = tid; e < G * kb; e += kThreads) {
      const int g = e / kb, kk = e % kb;
      pvd[g * per * kTile + kk] = (double)sc[g * nloc + u0 * kTile + kk];
    }
    cp_async_wait<1>();   // batch bi has landed
    __syncthreads();
    const unsigned char* slot = ring + (bi & 1) * per * kTile * D;
#pragma unroll 2
    for (int kk = slice; kk < kb; kk += kSets * slices) {
#pragma unroll
      for (int z = 0; z < kSets; ++z) {
        const int kz = kk + z * slices;
        if (kz < kb) {
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(slot + kz * D + c4 * 4) ^
              0x80808080u;
          const double vv[4] = {s8_at(w, 0), s8_at(w, 1), s8_at(w, 2),
                                s8_at(w, 3)};
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
              // 0 past S (p was set to 0 there), and the bytes there are
              // finite: the product adds exactly nothing
              const double p = pvd[g * per * kTile + kz];
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[z][g][c] = fma(p, vv[c], acc[z][g][c]);
            }
          }
        }
      }
    }
    __syncthreads();   // the slot and pvd are free
    load_batch(bi + 2, nbk, nl, per, list, ring, kss, vss, k, v, ks, vs,
                row0, S, KVH, h, D);
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the warps' partial P.V go there

#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        double o = acc[0][g][c];
#pragma unroll
        for (int z = 1; z < kSets; ++z) o += acc[z][g][c];
        red[((size_t)slice * G + g) * D + c4 * 4 + c] = o;
      }
  __syncthreads();
  // the CTA's partial of column d goes to rank d / (D / CS), which adds the
  // CS partials of its columns in rank order
  const int dcs = D / CS;
  for (int e = tid; e < G * D; e += kThreads) {
    double o = red[e];
    for (int s = 1; s < slices; ++s) o += red[(size_t)s * G * D + e];
    const int g = e / D, d = e % D;
    *cluster.map_shared_rank(recv + (rank * G + g) * dcs + d % dcs,
                             d / dcs) = o;
  }
  cluster.sync();   // every partial has arrived; nothing remote after this
  T* ob = out + ((size_t)b * KVH + h) * G * D;
  for (int e = tid; e < G * dcs; e += kThreads) {
    const int g = e / dcs, dd = e % dcs;
    double o = 0.0;
    for (int r = 0; r < CS; ++r) o += recv[(r * G + g) * dcs + dd];
    ob[g * D + rank * dcs + dd] = from_f32<T>((float)o);
  }
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

// the cluster size: the largest of 1, 2, 4, 8 whose CTAs fit in one wave
// at 2 an SM (so that no cluster waits for a second wave), at most the key
// tiles, doubled while its shared memory is over the limit
int cluster_size(int B, int S, int KVH, int G, int D, int sms) {
  const long long heads = (long long)B * KVH;
  int cs = 8;
  while (cs > 1 && heads * cs > 2LL * sms) cs /= 2;
  const int nt = (S + kTile - 1) / kTile;
  while (cs > 1 && cs > nt) cs /= 2;
  while (cs < 8 && layout_of(S, G, D, cs).total > kSmemLimit) cs *= 2;
  return cs;
}

template <typename T, int MAXG>
cudaError_t launch(const void* q, const int8_t* k, const float* ks,
                   const int8_t* v, const float* vs, const uint8_t* valid,
                   long long valid_sb, void* out, unsigned* skipped,
                   float sm_scale, int B, int S, int KVH, int G, int D,
                   int CS, int device, cudaStream_t stream) {
  static bool raised[32] = {false};
  auto kernel = cache_attn_kernel<T, MAXG>;
  if (device < 0 || device >= 32) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KVH * CS, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)layout_of(S, G, D, CS).total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), k, ks, v,
                            vs, valid, valid_sb, static_cast<T*>(out),
                            skipped, sm_scale, S, KVH, G, D);
}

template <typename T>
cudaError_t launch_g(const void* q, const int8_t* k, const float* ks,
                     const int8_t* v, const float* vs, const uint8_t* valid,
                     long long valid_sb, void* out, unsigned* skipped,
                     float sm_scale, int B, int S, int KVH, int G, int D,
                     int CS, int device, cudaStream_t stream) {
  if (G == 1)
    return launch<T, 1>(q, k, ks, v, vs, valid, valid_sb, out, skipped,
                        sm_scale, B, S, KVH, G, D, CS, device, stream);
  if (G == 2)
    return launch<T, 2>(q, k, ks, v, vs, valid, valid_sb, out, skipped,
                        sm_scale, B, S, KVH, G, D, CS, device, stream);
  if (G <= 4)
    return launch<T, 4>(q, k, ks, v, vs, valid, valid_sb, out, skipped,
                        sm_scale, B, S, KVH, G, D, CS, device, stream);
  return launch<T, kMaxG>(q, k, ks, v, vs, valid, valid_sb, out, skipped,
                          sm_scale, B, S, KVH, G, D, CS, device, stream);
}

}  // namespace

// Returns a cudaError_t code, 0 when the launch was accepted; *launched is 1
// then, and *cluster the CTAs of a cluster. q_type: 0 f32, 1 bf16, 2 f16 (q
// and out). skipped may be null.
extern "C" int int8_cache_decode_attention(
    const void* q, int q_type, const int8_t* k, const float* ks,
    const int8_t* v, const float* vs, const uint8_t* valid,
    long long valid_sb, void* out, unsigned* skipped, float sm_scale, int B,
    int S, int KVH, int G, int D, int device, void* stream, int* launched,
    int* cluster) {
  *launched = 0;
  *cluster = 0;
  // D a power of two in [16, 512]: whole 16-byte chunks per lane and whole
  // 4-column groups per thread
  if (B < 1 || S < 1 || KVH < 1 || G < 1 || G > kMaxG || D < 16 || D > 512 ||
      (D & (D - 1)) != 0 || q_type < 0 || q_type > 2)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const int sms = sm_count(device);
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int CS = cluster_size(B, S, KVH, G, D, sms);
  if (layout_of(S, G, D, CS).total > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_type == 0)
    err = launch_g<float>(q, k, ks, v, vs, valid, valid_sb, out, skipped,
                          sm_scale, B, S, KVH, G, D, CS, device, s);
  else if (q_type == 1)
    err = launch_g<__nv_bfloat16>(q, k, ks, v, vs, valid, valid_sb, out,
                                  skipped, sm_scale, B, S, KVH, G, D, CS,
                                  device, s);
  else
    err = launch_g<__half>(q, k, ks, v, vs, valid, valid_sb, out, skipped,
                           sm_scale, B, S, KVH, G, D, CS, device, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  *cluster = CS;
  return 0;
}
