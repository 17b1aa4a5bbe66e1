// Fused Monochrome block for Hopper (sm_90a).
//
// Replaces univer_ocr_tpu/ops/pallas/fused_conv.py:fused_monochrome, the
// Pallas TPU kernel.  It computes, with SAME zero padding,
//
//   out = sigmoid(conv3x3_{16->1}(Z(leaky(conv3x3_{1->16}(x) + b1))) + b2)
//
// where Z zeroes the hidden map outside the true image: conv1's bias makes
// the halo ring nonzero, and conv2 must read zeros there, as the
// unfused reference does.
//
// Bound on the H100: 576 FLOP per pixel against 8 bytes per pixel (one f32
// read, one f32 written), so the work, not the traffic, bounds it: one
// chunk of 8 pages at 496x736 is 1.68 GFLOP, 25 us at the 67 TFLOP/s of
// FP32 outside the tensor cores, against 23.4 MB, 7 us at 3.35 TB/s.
//
// Design: one block per (page, 16x64 output tile).  The input tile and its
// 2-pixel halo sit in shared memory; the 16 hidden channels are made one at
// a time into a double-buffered shared tile (18x66 with its 1-pixel halo)
// and never reach device memory; the 288 weights sit in shared memory and
// are read as broadcasts.  Each thread keeps its 4 output pixels in
// registers across the channel loop.  Ragged edges are masked, so any H
// and W work.  expf (not __expf) keeps the sigmoid within 1e-5 of the
// reference.

#include <cuda_runtime.h>

namespace {

constexpr int kMid = 16;            // hidden channels
constexpr int kTileH = 16;          // output rows per block
constexpr int kTileW = 64;          // output columns per block
constexpr int kThreads = 256;
constexpr int kInH = kTileH + 4;    // input tile + 2-pixel halo
constexpr int kInW = kTileW + 4;
constexpr int kHidH = kTileH + 2;   // hidden tile + 1-pixel halo
constexpr int kHidW = kTileW + 2;
constexpr int kPerThread = kTileH * kTileW / kThreads;
constexpr int kRowStep = kThreads / kTileW;
constexpr float kLeakyAlpha = 0.01f;

static_assert(kTileH * kTileW % kThreads == 0, "tile must split evenly");

__global__ void __launch_bounds__(kThreads)
fused_monochrome_kernel(const float* __restrict__ x,
                        const float* __restrict__ w1,
                        const float* __restrict__ b1,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2,
                        float* __restrict__ out, int H, int W) {
    __shared__ float xs[kInH][kInW];
    __shared__ float hs[2][kHidH][kHidW];
    __shared__ float w1s[9 * kMid];   // HWIO (3,3,1,16): [tap][channel]
    __shared__ float w2s[9 * kMid];   // HWIO (3,3,16,1): [tap][channel]
    __shared__ float b1s[kMid];

    const int tid = threadIdx.x;
    const int r0 = blockIdx.y * kTileH;
    const int c0 = blockIdx.x * kTileW;
    const size_t page = (size_t)blockIdx.z * H * W;
    const float* xb = x + page;

    for (int i = tid; i < 9 * kMid; i += kThreads) {
        w1s[i] = w1[i];
        w2s[i] = w2[i];
    }
    if (tid < kMid) b1s[tid] = b1[tid];
    for (int i = tid; i < kInH * kInW; i += kThreads) {
        const int r = i / kInW, c = i % kInW;
        const int gr = r0 - 2 + r, gc = c0 - 2 + c;
        xs[r][c] = (gr >= 0 && gr < H && gc >= 0 && gc < W)
                       ? xb[(size_t)gr * W + gc] : 0.f;
    }
    __syncthreads();

    const int col = tid % kTileW;
    const int row = tid / kTileW;
    float acc[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) acc[k] = 0.f;

    for (int ch = 0; ch < kMid; ++ch) {
        float (*h)[kHidW] = hs[ch & 1];
        // hidden channel ch at global (r0-1+r, c0-1+c); zero outside
        for (int i = tid; i < kHidH * kHidW; i += kThreads) {
            const int r = i / kHidW, c = i % kHidW;
            const int gr = r0 - 1 + r, gc = c0 - 1 + c;
            float v = 0.f;
            if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
                float s = 0.f;
#pragma unroll
                for (int ky = 0; ky < 3; ++ky)
#pragma unroll
                    for (int kx = 0; kx < 3; ++kx)
                        s = fmaf(w1s[(ky * 3 + kx) * kMid + ch],
                                 xs[r + ky][c + kx], s);
                s += b1s[ch];
                v = s >= 0.f ? s : kLeakyAlpha * s;
            }
            h[r][c] = v;
        }
        // one barrier per channel: the other buffer was last read two
        // channels ago, before the previous barrier
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
            const int r = row + k * kRowStep;
#pragma unroll
            for (int ky = 0; ky < 3; ++ky)
#pragma unroll
                for (int kx = 0; kx < 3; ++kx)
                    acc[k] = fmaf(w2s[(ky * 3 + kx) * kMid + ch],
                                  h[r + ky][col + kx], acc[k]);
        }
    }

    const float bias2 = b2[0];
    const int gc = c0 + col;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        const int gr = r0 + row + k * kRowStep;
        if (gr < H && gc < W) {
            const float v = acc[k] + bias2;
            out[page + (size_t)gr * W + gc] = 1.f / (1.f + expf(-v));
        }
    }
}

}  // namespace

// x, out: (B, H, W) float32; w1: (3,3,1,16); b1: (16,); w2: (3,3,16,1);
// b2: (1,).  Launches on `stream` and returns cudaGetLastError().
extern "C" int uocr_fused_monochrome(const float* x, const float* w1,
                                     const float* b1, const float* w2,
                                     const float* b2, float* out, int B,
                                     int H, int W, void* stream) {
    if (B <= 0 || H <= 0 || W <= 0 || B > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
    fused_monochrome_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x, w1, b1, w2, b2, out, H, W);
    return (int)cudaGetLastError();
}

extern "C" const char* uocr_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
