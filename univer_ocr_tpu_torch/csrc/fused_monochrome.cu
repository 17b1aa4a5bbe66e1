// Fused Monochrome block for Hopper (sm_90a).
//
// Replaces univer_ocr_tpu/ops/pallas/fused_conv.py:fused_monochrome, the
// Pallas TPU kernel.  It computes, with SAME zero padding,
//
//   out = sigmoid(conv3x3_{16->1}(Z(leaky(conv3x3_{1->16}(x) + b1))) + b2)
//
// where Z zeroes the hidden map outside the true image: conv1's bias makes
// the halo ring nonzero, and conv2 must read zeros there, as the
// unfused reference does (the Pallas kernel's `inside` mask).
//
// Bound on the H100: 576 FLOP per pixel against 8 bytes per pixel (one f32
// read, one f32 written), so the work, not the traffic, bounds it: one
// chunk of 8 pages at 496x736 is 1.68 GFLOP, 25 us at the 67 TFLOP/s of
// FP32 outside the tensor cores, against 23.4 MB, 7 us at 3.35 TB/s.  The
// 1->16->1 convolutions have no tensor-core shape, so the design makes
// every load feed as many FFMAs as it can.
//
// Design: one block of 256 threads per (page, 32x64 output tile).
// * The 305 weights and biases are a by-value kernel parameter (1,220 B),
//   packed once per set of weights by ops/kernels/fused_monochrome.py:
//   prepare_monochrome.  Indexed with constants, each is an FFMA's
//   constant-bank operand: no load, no shared memory, and no global
//   symbol shared between pipelines or streams.
// * Stage the 36x68 input tile (2-pixel halo) in shared memory.  Then, for
//   each half of the hidden channels, each thread takes hidden pixels of
//   the 34x66 hidden tile (1-pixel halo), holds the pixel's 3x3 input
//   patch in registers and makes the 8 channels from it (9 loads for 72
//   FFMAs), writing 0 where the pixel lies outside the page.  One barrier,
//   and conv2 reads the half.
// * conv2: each thread owns a 2x4 block of output pixels and, for each
//   channel, loads the 4x6 hidden window under it (one 16-byte and one
//   8-byte load a row) for 72 FFMAs; the sums stay in registers across
//   both halves.
// * Shared memory: 9,792 B input + 73,984 B hidden = 83,776 B, so two
//   blocks share an SM; holding all 16 channels at once (one block per
//   SM) was slower on an H100.  Ragged edges are masked, so any
//   H and W work.  expf (not __expf) keeps the sigmoid within 1e-5 of the
//   reference.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kMid = 16;            // hidden channels
constexpr int kTileH = 32;          // output rows per block
constexpr int kTileW = 64;          // output columns per block
constexpr int kThreads = 256;
constexpr int kInH = kTileH + 4;    // input tile + 2-pixel halo
constexpr int kInW = kTileW + 4;
constexpr int kHidH = kTileH + 2;   // hidden tile + 1-pixel halo
constexpr int kHidW = kTileW + 2;
constexpr int kStride = 68;         // row stride of both tiles, in floats
constexpr int kPlane = kHidH * kStride;
constexpr int kOutRows = 2;         // output block of a thread
constexpr int kOutCols = 4;
constexpr float kLeakyAlpha = 0.01f;
constexpr int kGroup = kMid / 2;    // hidden channels in shared memory
constexpr int kSmemBytes = (kInH * kStride + kGroup * kPlane) * 4;

static_assert(kInW <= kStride && kHidW <= kStride, "rows fit the stride");
static_assert((kTileH / kOutRows) * (kTileW / kOutCols) == kThreads,
              "one output block per thread");

// HWIO weights flattened: w1[tap][channel], w2[tap][channel]
struct MonoWeights {
    float w1[9][kMid];
    float b1[kMid];
    float w2[9][kMid];
    float b2;
};
static_assert(sizeof(MonoWeights) == 305 * 4, "305 packed floats");

__global__ void __launch_bounds__(kThreads, 1)
fused_monochrome_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int H, int W, const MonoWeights p) {
    extern __shared__ __align__(16) float smem[];
    float* xs = smem;                    // (kInH, kStride)
    float* hs = smem + kInH * kStride;   // (kGroup, kHidH, kStride)

    const int tid = threadIdx.x;
    const int r0 = blockIdx.y * kTileH;
    const int c0 = blockIdx.x * kTileW;
    const size_t page = (size_t)blockIdx.z * H * W;
    const float* xb = x + page;

    for (int i = tid; i < kInH * kInW; i += kThreads) {
        const int r = i / kInW, c = i % kInW;
        const int gr = r0 - 2 + r, gc = c0 - 2 + c;
        xs[r * kStride + c] = (gr >= 0 && gr < H && gc >= 0 && gc < W)
                                  ? xb[(size_t)gr * W + gc] : 0.f;
    }
    __syncthreads();

    const int tr = tid / (kTileW / kOutCols);
    const int tc = tid % (kTileW / kOutCols);
    float acc[kOutRows][kOutCols];
#pragma unroll
    for (int a = 0; a < kOutRows; ++a)
#pragma unroll
        for (int b = 0; b < kOutCols; ++b) acc[a][b] = 0.f;
#pragma unroll
    for (int ch0 = 0; ch0 < kMid; ch0 += kGroup) {
        if (ch0 > 0) __syncthreads();   // conv2 is done with the last half
        // hidden pixel (r, c) is global (r0-1+r, c0-1+c): channels ch0 ..
        // ch0+7 from one 3x3 patch; zero outside the page
        for (int i = tid; i < kHidH * kHidW; i += kThreads) {
            const int r = i / kHidW, c = i % kHidW;
            const int gr = r0 - 1 + r, gc = c0 - 1 + c;
            float* h = hs + r * kStride + c;
            if (gr < 0 || gr >= H || gc < 0 || gc >= W) {
#pragma unroll
                for (int ch = 0; ch < kGroup; ++ch) h[ch * kPlane] = 0.f;
                continue;
            }
            float patch[9];
#pragma unroll
            for (int ky = 0; ky < 3; ++ky)
#pragma unroll
                for (int kx = 0; kx < 3; ++kx)
                    patch[ky * 3 + kx] = xs[(r + ky) * kStride + c + kx];
#pragma unroll
            for (int ch = 0; ch < kGroup; ++ch) {
                float s = 0.f;
#pragma unroll
                for (int k = 0; k < 9; ++k)
                    s = fmaf(p.w1[k][ch0 + ch], patch[k], s);
                s += p.b1[ch0 + ch];
                h[ch * kPlane] = fmaxf(s, kLeakyAlpha * s);
            }
        }
        __syncthreads();

        // conv2: a 2x4 output block; hidden rows 2tr .. 2tr+3, columns
        // 4tc .. 4tc+5
#pragma unroll 2
        for (int ch = 0; ch < kGroup; ++ch) {
            const float* h = hs + ch * kPlane + (tr * kOutRows) * kStride
                             + tc * kOutCols;
            float win[kOutRows + 2][kOutCols + 2];
#pragma unroll
            for (int y = 0; y < kOutRows + 2; ++y) {
                const float4 v =
                    *reinterpret_cast<const float4*>(h + y * kStride);
                const float2 u =
                    *reinterpret_cast<const float2*>(h + y * kStride + 4);
                win[y][0] = v.x; win[y][1] = v.y; win[y][2] = v.z;
                win[y][3] = v.w; win[y][4] = u.x; win[y][5] = u.y;
            }
#pragma unroll
            for (int ky = 0; ky < 3; ++ky)
#pragma unroll
                for (int kx = 0; kx < 3; ++kx) {
                    const float w = p.w2[ky * 3 + kx][ch0 + ch];
#pragma unroll
                    for (int a = 0; a < kOutRows; ++a)
#pragma unroll
                        for (int b = 0; b < kOutCols; ++b)
                            acc[a][b] =
                                fmaf(w, win[a + ky][b + kx], acc[a][b]);
                }
        }
    }

#pragma unroll
    for (int a = 0; a < kOutRows; ++a) {
        const int gr = r0 + tr * kOutRows + a;
        if (gr >= H) continue;
#pragma unroll
        for (int b = 0; b < kOutCols; ++b) {
            const int gc = c0 + tc * kOutCols + b;
            if (gc < W) {
                const float v = acc[a][b] + p.b2;
                out[page + (size_t)gr * W + gc] = 1.f / (1.f + expf(-v));
            }
        }
    }
}

}  // namespace

// x, out: (B, H, W) float32 on the card; weights: 305 floats in host
// memory, w1 (3,3,1,16) + b1 (16,) + w2 (3,3,16,1) + b2 (1,) flattened
// (ops/kernels/fused_monochrome.py: prepare_monochrome), copied into the
// launch's parameters.  Launches on `stream` and returns the launch's
// error code.
extern "C" int uocr_fused_monochrome(const float* x, const float* weights,
                                     float* out, int B, int H, int W,
                                     void* stream) {
    if (B <= 0 || H <= 0 || W <= 0 || B > 65535 || weights == nullptr)
        return (int)cudaErrorInvalidValue;
    MonoWeights p;
    memcpy(&p, weights, sizeof(p));
    cudaError_t err = cudaFuncSetAttribute(
        fused_monochrome_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
    fused_monochrome_kernel<<<grid, kThreads, kSmemBytes,
                              (cudaStream_t)stream>>>(x, out, H, W, p);
    return (int)cudaGetLastError();
}

extern "C" const char* uocr_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
