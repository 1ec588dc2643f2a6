// DPC-KNN density and parent distance for B images of N tokens, C features.
//
// Replaces setok_tpu/kernels/cluster_pallas.py::dpc_density_parent (the two
// Pallas kernels _density_kernel and _parent_kernel). For each image, with
// d2[i][j] = max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0) / C and d2[i][i] = 0:
//
//   density[i] = exp(-(sum of the k smallest d2[i][:]) / k) + (i+0.5)/N*1e-6
//   rowmax[i]  = max_j sqrt(d2[i][j])
//   parent[i]  = min_j (density[j] > density[i] ? sqrt(d2[i][j]) : rowmax[j])
//
// parent carries the reference fill (non-higher entries take the per-column
// row max), i.e. what the JAX wrapper holds after its fill_min step.
//
// What bounds it: the Gram product. d2 is symmetric, so the function needs
// the dot products for i <= j only, B*N*(N+1)*C f32 operations (3.2 GFLOP at
// B=64, N=256, C=768: 0.048 ms at the 67 TFLOP/s f32 CUDA-core peak of the
// H100 SXM data sheet); the input read is B*N*C*4 bytes (50 MB, 15 us at
// 3.35 TB/s). This simple design computes every (i, j) product, twice the
// bound's operations, but each only once:
//
//   sqnorm_kernel   one warp per token: |x_i|^2.
//   density_kernel  one block per (image, 16-row tile). It streams C in
//                   chunks of 16 through shared memory, each thread holding
//                   a 4x4 register tile of the 16x256 output tile, so each
//                   shared-memory load feeds four FMAs. The tile's 16 rows
//                   of d2 stay in shared memory (16*N*4 bytes, 64 KB at
//                   N=1024) and are also written to a scratch d2 (B,N,N).
//                   One warp per row then finds the exact k-th smallest
//                   value by a 31-step radix select on the float bits
//                   (d2 >= +0, so the bits order like the values), and sums
//                   the values below it plus the k-th value times the
//                   remaining count: the exact multiset sum of the k
//                   smallest, as the TPU kernel's bisection gives; only the
//                   order of summation differs.
//   parent_kernel   every row needs every density, so a second launch: one
//                   warp per row reads its d2 row back from the scratch.
//                   The scratch is stored rather than recomputed because
//                   recomputing would double the operations that bound the
//                   kernel, while at B=64, N=256 the scratch is 16.8 MB and
//                   stays in the 50 MB L2.
//
// CUDA-core f32 FMAs only, no tensor cores: f32 products keep the distances
// the plain version computes. Shapes: any C, 1 <= N <= 1024, 1 <= k <= N.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;     // rows per density block
constexpr int kCols = 256;    // columns per output tile
constexpr int kChunk = 16;    // features per shared-memory chunk
constexpr int kMaxN = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
sqnorm_kernel(const float* __restrict__ x, float* __restrict__ sq, int rows,
              int C) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s = fmaf(xr[c], xr[c], s);
  s = warp_sum(s);
  if (lane == 0) sq[row] = s;
}

__global__ void __launch_bounds__(kThreads)
density_kernel(const float* __restrict__ x, const float* __restrict__ sq,
               float* __restrict__ d2, float* __restrict__ density,
               float* __restrict__ rowmax, int N, int C, int k, float inv_c) {
  extern __shared__ float smem[];
  float* tile_d2 = smem;                         // kRows * N
  float* xi_s = tile_d2 + kRows * N;             // kChunk * kRows
  float* xj_s = xi_s + kChunk * kRows;           // kChunk * (kCols + 1)

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int ty = tid / 64;                       // rows ty*4 .. ty*4+3
  const int tx = tid % 64;                       // cols tx + 64*q
  const float* xb = x + (size_t)b * N * C;
  const float* sqb = sq + (size_t)b * N;
  float* d2b = d2 + (size_t)b * N * N;

  for (int j0 = 0; j0 < N; j0 += kCols) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

    for (int c0 = 0; c0 < C; c0 += kChunk) {
      {  // kRows * kChunk == kThreads: one element each
        const int r = tid / kChunk, cc = tid % kChunk;
        const int gi = r0 + r, gc = c0 + cc;
        xi_s[cc * kRows + r] =
            (gi < N && gc < C) ? xb[(size_t)gi * C + gc] : 0.f;
      }
      for (int e = tid; e < kCols * kChunk; e += kThreads) {
        const int j = e / kChunk, cc = e % kChunk;
        const int gj = j0 + j, gc = c0 + cc;
        xj_s[cc * (kCols + 1) + j] =
            (gj < N && gc < C) ? xb[(size_t)gj * C + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < kChunk; ++cc) {
        float a[4], v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = xi_s[cc * kRows + ty * 4 + r];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = xj_s[cc * (kCols + 1) + tx + 64 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], v[q], acc[r][q]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lr = ty * 4 + r, i = r0 + lr;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + tx + 64 * q;
        if (i < N && j < N) {
          float d = sqb[i] + sqb[j] - 2.f * acc[r][q];
          d = (d > 0.f && i != j) ? d * inv_c : 0.f;
          tile_d2[lr * N + j] = d;
          d2b[(size_t)i * N + j] = d;
        }
      }
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int lr = warp; lr < kRows; lr += kWarps) {
    const int i = r0 + lr;
    if (i >= N) break;
    const float* row = tile_d2 + lr * N;

    float m = 0.f;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);

    // largest bit pattern t with #{v < t} < k: the k-th smallest value
    unsigned int kth = 0u;
    for (int bit = 30; bit >= 0; --bit) {
      const unsigned int cand = kth | (1u << bit);
      int cnt = 0;
      for (int j = lane; j < N; j += 32) cnt += __float_as_uint(row[j]) < cand;
      if (warp_sum_int(cnt) < k) kth = cand;
    }
    const float kv = __uint_as_float(kth);
    float s = 0.f;
    int below = 0;
    for (int j = lane; j < N; j += 32) {
      const float v = row[j];
      if (v < kv) {
        s += v;
        ++below;
      }
    }
    s = warp_sum(s);
    below = warp_sum_int(below);
    if (lane == 0) {
      s += kv * (float)(k - below);
      density[(size_t)b * N + i] =
          expf(-(s / (float)k)) + ((float)i + 0.5f) / (float)N * 1e-6f;
      rowmax[(size_t)b * N + i] = sqrtf(m);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
parent_kernel(const float* __restrict__ d2, const float* __restrict__ density,
              const float* __restrict__ rowmax, float* __restrict__ parent,
              int N) {
  __shared__ float dens_s[kMaxN];
  __shared__ float rmax_s[kMaxN];
  const int b = blockIdx.y;
  for (int j = threadIdx.x; j < N; j += kThreads) {
    dens_s[j] = density[(size_t)b * N + j];
    rmax_s[j] = rowmax[(size_t)b * N + j];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= N) return;
  const float* row = d2 + ((size_t)b * N + i) * N;
  const float di = dens_s[i];
  float best = INFINITY;
  for (int j = lane; j < N; j += 32)
    best = fminf(best, dens_s[j] > di ? sqrtf(row[j]) : rmax_s[j]);
  best = warp_min(best);
  if (lane == 0) parent[(size_t)b * N + i] = best;
}

}  // namespace

// Returns a cudaError_t code: 0 when every launch was accepted. Launches the
// three kernels above on `stream` and counts each accepted launch in
// *launched; allocates nothing (d2 is B*N*N floats of scratch, sq B*N).
extern "C" int dpc_density_parent_f32(const float* x, float* density,
                                      float* parent, float* rowmax, float* d2,
                                      float* sq, int B, int N, int C, int k,
                                      float inv_c, int device, void* stream,
                                      int* launched) {
  *launched = 0;
  if (B < 1 || N < 1 || N > kMaxN || C < 1 || k < 1 || k > N)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const int rows = B * N;
  sqnorm_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(x, sq, rows,
                                                                    C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;

  const size_t smem =
      sizeof(float) * ((size_t)kRows * N + kChunk * kRows +
                       (size_t)kChunk * (kCols + 1));
  err = cudaFuncSetAttribute(density_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  density_kernel<<<dim3((N + kRows - 1) / kRows, B), kThreads, smem, s>>>(
      x, sq, d2, density, rowmax, N, C, k, inv_c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;

  parent_kernel<<<dim3((N + kWarps - 1) / kWarps, B), kThreads, 0, s>>>(
      d2, density, rowmax, parent, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  return 0;
}
