// Fused Char head for Hopper (sm_90a).
//
// Replaces univer_ocr_tpu/ops/pallas/char_head.py:fused_char_head, the
// Pallas TPU kernel.  For each line n and column j of the conv stack's
// (N, W, 64) output it computes
//
//   window = x[n, j-4 : j+4, :]           (zero outside [0, W); 512 floats)
//   h1     = leaky(window @ W1[:512] + W1[512])      (1024)
//   h2     = leaky(h1 @ W2[:1024] + W2[1024])        (128)
//   logits = h2 @ W3[:128] + W3[128]                 (162)
//
// Bound on the H100: 1,352,192 FLOP per column against ~1.6 KB of traffic
// per column, so the work bounds it: at W=256 (16 lines, 4,096 columns)
// 5.54 GFLOP, 83 us at the 67 TFLOP/s of FP32 outside the tensor cores,
// against 6.4 MB, 2 us at 3.35 TB/s; at W=2048, about 660 us.
//
// Design: one block per (line, tile of 32 columns).  The unfold costs
// nothing: the 39 input columns a tile needs are staged once in shared
// memory, and row j of the first product's A matrix is the 512 floats that
// start at column j of that stage (a matrix with row stride 64).  The
// (32 x 1024) hidden map and the (32 x 128) one stay in dynamic shared
// memory (186 KB, one block per SM); only the logits are written.  The
// weights stream through a shared 32-row slab; each thread holds a 4x8
// register tile of the product.  Arithmetic is full FP32 FFMA: plain TF32
// would miss the 2e-4 bar on a K=512 sum.  Tensor cores, wgmma and TMA are
// left for a later kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kC = 64;                 // conv-stack channels
constexpr int kUnfold = 8;             // window width
constexpr int kHalf = kUnfold / 2;     // window j covers [j-4, j+4)
constexpr int kK1 = kC * kUnfold;      // 512
constexpr int kD1 = 1024;
constexpr int kD2 = 128;
constexpr int kMaxD3 = 192;
constexpr int kTile = 32;              // columns per block (GEMM rows)
constexpr int kThreads = 256;
constexpr int kSlab = 32;              // weight rows staged per step
constexpr int kChunk1 = 256;           // first product: output chunk
constexpr int kRows = 4;               // GEMM rows per thread
constexpr int kXRows = kTile + kUnfold - 1;
constexpr float kLeakyAlpha = 0.01f;

// dynamic shared memory layout, in floats
constexpr int kXsOff = 0;
constexpr int kH1Off = kXsOff + kXRows * kC;
constexpr int kH2Off = kH1Off + kTile * kD1;
constexpr int kBsOff = kH2Off + kTile * kD2;
constexpr int kBsLen = kSlab * kChunk1;
constexpr int kSmemFloats = kBsOff + kBsLen;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

static_assert(kTile == (kThreads / 32) * kRows, "one warp per 4 rows");
static_assert(kSlab * kMaxD3 <= kBsLen, "third slab must fit");

__device__ __forceinline__ float leaky(float v) {
    return v >= 0.f ? v : kLeakyAlpha * v;
}

__global__ void __launch_bounds__(kThreads)
char_head_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ w2, const float* __restrict__ w3,
                 float* __restrict__ out, int W, int D3) {
    extern __shared__ float smem[];
    float* xs = smem + kXsOff;   // (kXRows, 64): x columns j0-4 .. j0+kTile+2
    float* h1 = smem + kH1Off;   // (kTile, 1024)
    float* h2 = smem + kH2Off;   // (kTile, 128)
    float* bs = smem + kBsOff;   // weight slab

    const int tid = threadIdx.x;
    const int n = blockIdx.y;
    const int j0 = blockIdx.x * kTile;
    const int tm = tid / 32;     // warp: GEMM rows tm*4 .. tm*4+3
    const int tn = tid % 32;     // lane: GEMM columns tn + 32*i
    const float* xn = x + (size_t)n * W * kC;

    for (int i = tid; i < kXRows * kC; i += kThreads) {
        const int r = i / kC, c = i % kC;
        const int col = j0 - kHalf + r;
        xs[i] = (col >= 0 && col < W) ? xn[(size_t)col * kC + c] : 0.f;
    }

    // h1 = leaky(A @ W1[:512] + W1[512]), A[j][k] = xs[j*64 + k]
    for (int n0 = 0; n0 < kD1; n0 += kChunk1) {
        float acc[kRows][8];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
        for (int k0 = 0; k0 < kK1; k0 += kSlab) {
            __syncthreads();
            for (int i = tid; i < kSlab * kChunk1 / 4; i += kThreads) {
                const int kk = i / (kChunk1 / 4), q = i % (kChunk1 / 4);
                reinterpret_cast<float4*>(bs)[i] =
                    reinterpret_cast<const float4*>(
                        w1 + (size_t)(k0 + kk) * kD1 + n0)[q];
            }
            __syncthreads();
#pragma unroll 4
            for (int kk = 0; kk < kSlab; ++kk) {
                float a[kRows], b[8];
#pragma unroll
                for (int r = 0; r < kRows; ++r)
                    a[r] = xs[(tm * kRows + r) * kC + k0 + kk];
#pragma unroll
                for (int i = 0; i < 8; ++i) b[i] = bs[kk * kChunk1 + tn + 32 * i];
#pragma unroll
                for (int r = 0; r < kRows; ++r)
#pragma unroll
                    for (int i = 0; i < 8; ++i)
                        acc[r][i] = fmaf(a[r], b[i], acc[r][i]);
            }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int col = n0 + tn + 32 * i;
            const float bias = w1[(size_t)kK1 * kD1 + col];
#pragma unroll
            for (int r = 0; r < kRows; ++r)
                h1[(tm * kRows + r) * kD1 + col] = leaky(acc[r][i] + bias);
        }
    }

    // h2 = leaky(h1 @ W2[:1024] + W2[1024])
    {
        float acc[kRows][4];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
        for (int k0 = 0; k0 < kD1; k0 += kSlab) {
            __syncthreads();
            for (int i = tid; i < kSlab * kD2 / 4; i += kThreads)
                reinterpret_cast<float4*>(bs)[i] =
                    reinterpret_cast<const float4*>(w2 + (size_t)k0 * kD2)[i];
            __syncthreads();
#pragma unroll 4
            for (int kk = 0; kk < kSlab; ++kk) {
                float a[kRows], b[4];
#pragma unroll
                for (int r = 0; r < kRows; ++r)
                    a[r] = h1[(tm * kRows + r) * kD1 + k0 + kk];
#pragma unroll
                for (int i = 0; i < 4; ++i) b[i] = bs[kk * kD2 + tn + 32 * i];
#pragma unroll
                for (int r = 0; r < kRows; ++r)
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        acc[r][i] = fmaf(a[r], b[i], acc[r][i]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int col = tn + 32 * i;
            const float bias = w2[(size_t)kD1 * kD2 + col];
#pragma unroll
            for (int r = 0; r < kRows; ++r)
                h2[(tm * kRows + r) * kD2 + col] = leaky(acc[r][i] + bias);
        }
    }

    // logits = h2 @ W3[:128] + W3[128]; D3 <= 192 columns, 6 per lane
    {
        constexpr int kCols3 = kMaxD3 / 32;
        float acc[kRows][kCols3];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int i = 0; i < kCols3; ++i) acc[r][i] = 0.f;
        for (int k0 = 0; k0 < kD2; k0 += kSlab) {
            __syncthreads();
            for (int i = tid; i < kSlab * kMaxD3; i += kThreads) {
                const int kk = i / kMaxD3, c = i % kMaxD3;
                bs[i] = c < D3 ? w3[(size_t)(k0 + kk) * D3 + c] : 0.f;
            }
            __syncthreads();
#pragma unroll 4
            for (int kk = 0; kk < kSlab; ++kk) {
                float a[kRows], b[kCols3];
#pragma unroll
                for (int r = 0; r < kRows; ++r)
                    a[r] = h2[(tm * kRows + r) * kD2 + k0 + kk];
#pragma unroll
                for (int i = 0; i < kCols3; ++i)
                    b[i] = bs[kk * kMaxD3 + tn + 32 * i];
#pragma unroll
                for (int r = 0; r < kRows; ++r)
#pragma unroll
                    for (int i = 0; i < kCols3; ++i)
                        acc[r][i] = fmaf(a[r], b[i], acc[r][i]);
            }
        }
#pragma unroll
        for (int i = 0; i < kCols3; ++i) {
            const int col = tn + 32 * i;
            if (col >= D3) continue;
            const float bias = w3[(size_t)kD2 * D3 + col];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const int j = j0 + tm * kRows + r;
                if (j < W)
                    out[((size_t)n * W + j) * D3 + col] = acc[r][i] + bias;
            }
        }
    }
}

}  // namespace

// x: (N, W, 64); w1: (513, 1024); w2: (1025, 128); w3: (129, D3) with
// D3 <= 192; out: (N, W, D3); all float32, w1 and w2 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int uocr_char_head(const float* x, const float* w1, const float* w2,
                              const float* w3, float* out, int N, int W,
                              int D3, void* stream) {
    if (N <= 0 || W <= 0 || N > 65535 || D3 <= 0 || D3 > kMaxD3)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        char_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((W + kTile - 1) / kTile, N);
    char_head_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        x, w1, w2, w3, out, W, D3);
    return (int)cudaGetLastError();
}
