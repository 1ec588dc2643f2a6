// Native host-side image preprocessing for the data loader.
//
// The PyTorch port's copy of csrc/fast_image.cpp (the JAX package's): the
// hot per-image transform of the data loader, resize + normalize into the
// model's float layout, bound via ctypes (setok_tpu_torch/data/native.py,
// which builds it with g++ into build/ at first use). The host work is the
// same on a GPU host as on a TPU host.
//
// Build: g++ -O3 -shared -fPIC -o libfast_image.so fast_image.cpp

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Bilinear resize HWC uint8 -> float32 HWC with fused affine normalize:
//   out = (src/255 - mean[c]) / std[c] * scale + offset
// (scale=1, offset=0 gives processor normalization; mean=0, std=1,
//  scale=2, offset=-1 gives the generator's [-1, 1] convention.)
void resize_bilinear_normalize(const uint8_t* src, int sh, int sw,
                               float* dst, int dh, int dw,
                               const float* mean, const float* stdd,
                               float scale, float offset) {
    const float ry = (float)sh / dh;
    const float rx = (float)sw / dw;
    float inv_std[3], m[3];
    for (int c = 0; c < 3; ++c) {
        inv_std[c] = 1.0f / (255.0f * stdd[c]);
        m[c] = mean[c] / stdd[c];
    }
    for (int y = 0; y < dh; ++y) {
        // align centers (half-pixel convention, matches PIL bilinear)
        float fy = (y + 0.5f) * ry - 0.5f;
        int y0 = (int)std::floor(fy);
        float wy = fy - y0;
        int y1 = std::min(y0 + 1, sh - 1);
        y0 = std::max(y0, 0);
        const uint8_t* row0 = src + (size_t)y0 * sw * 3;
        const uint8_t* row1 = src + (size_t)y1 * sw * 3;
        float* out = dst + (size_t)y * dw * 3;
        for (int x = 0; x < dw; ++x) {
            float fx = (x + 0.5f) * rx - 0.5f;
            int x0 = (int)std::floor(fx);
            float wx = fx - x0;
            int x1 = std::min(x0 + 1, sw - 1);
            x0 = std::max(x0, 0);
            const uint8_t* p00 = row0 + x0 * 3;
            const uint8_t* p01 = row0 + x1 * 3;
            const uint8_t* p10 = row1 + x0 * 3;
            const uint8_t* p11 = row1 + x1 * 3;
            for (int c = 0; c < 3; ++c) {
                float top = p00[c] + (p01[c] - p00[c]) * wx;
                float bot = p10[c] + (p11[c] - p10[c]) * wx;
                float v = top + (bot - top) * wy;
                out[x * 3 + c] =
                    (v * inv_std[c] - m[c]) * scale + offset;
            }
        }
    }
}

// Batched variant: n images with identical geometry, contiguous buffers.
void resize_bilinear_normalize_batch(const uint8_t* src, int n, int sh,
                                     int sw, float* dst, int dh, int dw,
                                     const float* mean, const float* stdd,
                                     float scale, float offset) {
    const size_t in_stride = (size_t)sh * sw * 3;
    const size_t out_stride = (size_t)dh * dw * 3;
    for (int i = 0; i < n; ++i) {
        resize_bilinear_normalize(src + i * in_stride, sh, sw,
                                  dst + i * out_stride, dh, dw, mean, stdd,
                                  scale, offset);
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Multi-threaded batch assembly: N variably-sized uint8 HWC images ->
// one (N, dh, dw, 3) float32 batch, work-stealing across a spawned team.
// ctypes releases the GIL for the whole call, so this parallelizes where
// Python-thread loops cannot. (The reference gets parallelism from torch
// DataLoader worker *processes*, train_setok.sh --dataloader_num_workers 4;
// this is the single-process TPU-host equivalent.)
#include <atomic>
#include <thread>
#include <vector>

extern "C" {

void assemble_batch(const uint8_t** srcs, const int32_t* shapes, int n,
                    float* dst, int dh, int dw,
                    const float* mean, const float* stdd,
                    float scale, float offset, int num_threads) {
    std::atomic<int> next{0};
    auto work = [&]() {
        int i;
        while ((i = next.fetch_add(1)) < n) {
            resize_bilinear_normalize(
                srcs[i], shapes[2 * i], shapes[2 * i + 1],
                dst + (size_t)i * dh * dw * 3, dh, dw,
                mean, stdd, scale, offset);
        }
    };
    int t = std::max(1, std::min(num_threads, n));
    std::vector<std::thread> team;
    for (int k = 1; k < t; ++k) team.emplace_back(work);
    work();
    for (auto& th : team) th.join();
}

}  // extern "C"
