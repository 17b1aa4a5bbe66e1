// Fused Char head for Hopper (sm_90a), on the tensor cores in 3xTF32.
//
// Replaces univer_ocr_tpu/ops/pallas/char_head.py:fused_char_head, the
// Pallas TPU kernel.  For each line n and column j of the conv stack's
// (N, W, 64) output it computes
//
//   window = x[n, j-4 : j+4, :]           (zero outside [0, W); 512 floats)
//   h1     = leaky(window @ W1[:512] + W1[512])      (1024)
//   h2     = leaky(h1 @ W2[:1024] + W2[1024])        (128)
//   logits = h2 @ W3[:128] + W3[128]                 (D3 <= 192)
//
// Precision.  The path runs in full float32 and holds the logits (near
// 70) to rtol 2e-4 / atol 1e-4; one TF32 pass (10 mantissa bits) misses
// that on a K=512 sum.  So every operand v is split into big =
// cvt.rna.tf32(v) and small = cvt.rna.tf32(v - big), and each product is
// small*big + big*small + big*big in float32 (an mma on .tf32 operands
// ignores the low 13 bits of a float32: without the explicit split this
// would be plain TF32).  The tensor cores' float32 sums are not rounded
// to nearest and their error grows with the accumulator: summed over the
// whole of K, the logits missed the bar on an H100 (5e-4 off).  So
// products are gathered in short runs that start from zero (one k-step
// of `mma.sync`, two of `wgmma`) and added to the running sums with
// rounded FADDs.  The weights are split once per set of weights
// (ops/kernels/char_head.py: prepare_char_head); the activations as they
// are staged.
//
// Bound on the H100: 3 x 1,352,192 TF32 FLOP per column at 495 TFLOP/s;
// 16 lines at W=256 are 0.0336 ms (0.0671 / 0.1343 / 0.2685 ms at W=512
// / 1024 / 2048).  The input and the logits are ~1.7 KB per column.
//
// Design.
// * A tile is 128 columns j of one line.  kParts = 4 CTAs share a tile:
//   CTA p owns the hidden units [256p, 256p + 256) and walks them in 2
//   chunks of 128:
//     h1c   = leaky(A @ W1[:, chunk] + b1[chunk])        (128 x 128)
//     h2acc += h1c @ W2[chunk, :]                          (128 x 128)
//   so the 128 x 1024 hidden map is never whole anywhere.  The 8 warps
//   are two warpgroups of 64 rows; warp w owns rows [16w, 16w + 16).
// * The first product (80 % of the work) runs on `wgmma.m64n128k8.tf32`,
//   A from registers, B (W1's chunk) from shared memory.  The unfold costs
//   nothing: the tile's 135 input columns are staged once (split, row
//   stride 68 so that the fragment loads hit 32 banks), and row j of A is
//   the 512 floats from column j of that stage, loaded straight into the
//   A fragment.  wgmma takes .tf32 B K-major only: prepare_char_head
//   stores W1 transposed, in 8 x 4 core matrices.
// * The second product runs on `mma.sync.m16n8k8.tf32` with h1c as its A
//   operand, straight from the registers where the first product left it:
//   an accumulator holds columns (2t, 2t+1), which become the A
//   fragment's k = (t, t+4) when W2's rows are stored in that pairing
//   (prepare_char_head again).  h2acc (64 floats a thread) waits in
//   shared memory while the first product runs, to leave it registers.
// * Weights stream through a ring of kRing = 4 stages of 16 KB in shared
//   memory.  Each stage is one contiguous block of the prepared stream
//   (16 K rows of W1's chunk, or 16 rows of W2's), copied by one
//   `cp.async.bulk` (TMA) that completes on the stage's mbarrier.  Each
//   warpgroup signals when it is done with a stage; the second to finish
//   issues the copy of stage s + 4 into its slot, so the two warpgroups
//   are never held at one barrier, and three stages are in flight behind
//   the one multiplied.
// * Split over D1, reduced by the last CTA.  Each CTA writes its partial
//   h2acc (64 KB) to a global scratch and counts itself in the tile's
//   counter; the fourth to arrive sums the partials in a fixed order,
//   applies b2 and LeakyReLU and computes the tile's logits (mma.sync).
//   Filling the card at W=256 (16 lines: 32 tiles) needs 128 CTAs for
//   132 SMs.  A 4-CTA cluster summing through distributed shared memory
//   did that in a first version, but an H100 schedules fewer such clusters
//   at once than the 32 needed (cudaOccupancyMaxActiveClusters), so they
//   ran in two waves; independent CTAs all fit in one.  Smaller row tiles
//   would read the weights from L2 once per 32 or 64 rows; a persistent
//   grid does not add CTAs where there is too little work.
// * L2 traffic per launch: each CTA reads its 1.31 MB share of the split
//   W1/W2 stream and 35 KB of input and writes 64 KB of partials; the
//   last reads 256 KB of partials and 172 KB of W3 fragments.  So 5.8 MB
//   per 128 columns: 186 MB at W=256 (the FFMA kernel it replaces read
//   348 MB there), 372 / 744 / 1488 MB at W=512 / 1024 / 2048.
// * Shared memory: 73,440 B input stage + 65,536 B ring + 65,536 B h2acc
//   + barriers = 204,544 B (the last CTA reuses it for h2), one CTA of 8
//   warps per SM.
// * Any W and N: ragged tiles are masked at the input and at the store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                   // conv-stack channels
constexpr int kUnfold = 8;               // window width
constexpr int kHalf = kUnfold / 2;       // window j covers [j-4, j+4)
constexpr int kK1 = kC * kUnfold;        // 512
constexpr int kD1 = 1024;
constexpr int kD2 = 128;
constexpr int kMaxD3 = 192;
constexpr int kParts = 4;                // CTAs of a tile, splitting D1
constexpr int kChunk = 128;              // hidden units per chunk
constexpr int kChunks = kD1 / kParts / kChunk;
constexpr int kBM = 128;                 // columns j per tile
constexpr int kThreads = 256;            // 8 warps, 16 rows each
constexpr int kStageBytes = 16384;
constexpr int kStageVecs = kStageBytes / 16;
constexpr int kW1KSteps = 2;             // k-steps of 8 in a W1 stage
constexpr int kW1Stages = kK1 / 8 / kW1KSteps;
constexpr int kW2Stages = kChunk / 16;   // 2 k-steps x 16 n-tiles each
constexpr int kStages = kChunks * (kW1Stages + kW2Stages);
constexpr int kRing = 4;
constexpr int kXCols = kBM + kUnfold - 1;
constexpr int kXStride = 68;
constexpr int kHStride = 132;
constexpr int kTiles3 = kMaxD3 / 8;
constexpr float kLeakyAlpha = 0.01f;

constexpr int kXBytes = kXCols * kXStride * 4;
constexpr int kOffXBig = 0;
constexpr int kOffXSmall = kXBytes;
constexpr int kOffRing = 2 * kXBytes;
constexpr int kOffAcc = kOffRing + kRing * kStageBytes;
constexpr int kOffBar = kOffAcc + kThreads * 64 * 4;
constexpr int kSmemBytes = kOffBar + kRing * 8;
constexpr int kHBytes = kBM * kHStride * 4;
// a W1 k-step in a stage: big then small, each 16 groups of 8 hidden
// units x 2 core matrices of 4 k (128 B) -> LBO (along K) 128 B, SBO 256 B
constexpr int kKStepBytes = 2 * kChunk * 8 * 4;
constexpr uint32_t kLBO = 128, kSBO = 256;

static_assert(kOffRing % 16 == 0, "16-byte stages");
static_assert(2 * kHBytes <= kOffBar, "h2 fits in the idle stage and ring");
static_assert(kW1KSteps * kKStepBytes == kStageBytes, "W1 stage layout");
static_assert(2 * 16 * 32 == kStageVecs, "W2 stage layout");

__device__ __forceinline__ float leaky(float v) {
    return v >= 0.f ? v : kLeakyAlpha * v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
}

// v = big + small, both TF32; small carries the bits the mma would drop
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
    big = tf32(v);
    small = tf32(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    float b0, float b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
          "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// d += a * b in 3xTF32, one k-step from zero; b = (big_0, big_1,
// small_0, small_1), the lane's B fragment as prepare_char_head packs it
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float4 b) {
    float step[4] = {0.f, 0.f, 0.f, 0.f};
    mma(step, as, b.x, b.y);
    mma(step, ab, b.z, b.w);
    mma(step, ab, b.x, b.y);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += step[e];
}

// shared-memory matrix descriptor: no swizzle, K-major 8 x 16-byte core
// matrices, kLBO apart along K and kSBO apart along N
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kLBO >> 4) << 16)
           | ((uint64_t)(kSBO >> 4) << 32);
}

// d (64 x 128 over the warpgroup) = (scale_d ? d : 0) + a * b, a from
// registers (the mma.m16n8k8 A fragment of the warp's 16 rows)
__device__ __forceinline__ void wgmma128(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(scale_d));
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT_AGAIN:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT_AGAIN;\n"
        "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// one TMA bulk copy of a stage, completing on `bar`
__device__ __forceinline__ void load_stage(uint32_t dst, const void* src,
                                           uint32_t bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(kStageBytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];"
                 :: "r"(dst), "l"(src), "r"(kStageBytes), "r"(bar)
                 : "memory");
}

// A fragment of rows (r, r+8), columns (c, c+4) of a row-major matrix
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const float* m,
                                       int r, int c, int stride) {
    a[0] = __float_as_uint(m[r * stride + c]);
    a[1] = __float_as_uint(m[(r + 8) * stride + c]);
    a[2] = __float_as_uint(m[r * stride + c + 4]);
    a[3] = __float_as_uint(m[(r + 8) * stride + c + 4]);
}

__global__ void __launch_bounds__(kThreads, 1)
char_head_kernel(const float* __restrict__ x,
                 const float4* __restrict__ stream,
                 const float4* __restrict__ w3f,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 const float* __restrict__ b3, float* __restrict__ partial,
                 int* __restrict__ arrived, float* __restrict__ out, int W,
                 int tiles, int D3) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ int last;
    __shared__ int freed[kRing];
    const float* xbig = reinterpret_cast<const float*>(smem + kOffXBig);
    const float* xsmall = reinterpret_cast<const float*>(smem + kOffXSmall);
    const float4* ring = reinterpret_cast<const float4*>(smem + kOffRing);

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int part = blockIdx.x;
    const int tile = blockIdx.y;
    const int n = tile / tiles;
    const int j0 = (tile % tiles) * kBM;
    const float4* my_stream = stream + (size_t)part * kStages * kStageVecs;
    const uint32_t bar0 = smem_u32(smem + kOffBar);
    const uint32_t ring0 = smem_u32(smem + kOffRing);

    if (tid == 0) {
        for (int i = 0; i < kRing; ++i) {
            mbar_init(bar0 + 8 * i);
            freed[i] = 0;
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        for (int s = 0; s < kRing; ++s)
            load_stage(ring0 + s * kStageBytes, my_stream + s * kStageVecs,
                       bar0 + 8 * s);
    }

    // input columns j0-4 .. j0+130 of line n, split into big and small
    const float* xn = x + (size_t)n * W * kC;
    for (int i = tid; i < kXCols * (kC / 4); i += kThreads) {
        const int r = i / (kC / 4), q = i % (kC / 4);
        const int col = j0 - kHalf + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col >= 0 && col < W)
            v = reinterpret_cast<const float4*>(xn + (size_t)col * kC)[q];
        uint4 big, small;
        split(v.x, big.x, small.x);
        split(v.y, big.y, small.y);
        split(v.z, big.z, small.z);
        split(v.w, big.w, small.w);
        reinterpret_cast<uint4*>(smem + kOffXBig)[r * kXStride / 4 + q] = big;
        reinterpret_cast<uint4*>(smem + kOffXSmall)[r * kXStride / 4 + q] =
            small;
    }
    __syncthreads();

    // stage s: wait for its copy; when both warpgroups are done with it
    // (bar.sync of the warpgroup, then a count of two per use of the
    // slot), the second refills the slot with stage s + kRing
    auto acquire = [&](int s) {
        mbar_wait(bar0 + 8 * (s % kRing), (s / kRing) & 1);
        return s % kRing;
    };
    auto release = [&](int s) {
        asm volatile("bar.sync %0, 128;" :: "r"(1 + warp / 4) : "memory");
        if (tid % 128 == 0 && atomicAdd(freed + s % kRing, 1) % 2 == 1
            && s + kRing < kStages)
            load_stage(ring0 + (s % kRing) * kStageBytes,
                       my_stream + (size_t)(s + kRing) * kStageVecs,
                       bar0 + 8 * (s % kRing));
    };

    // h2acc lives in shared memory while the first product runs ([64]
    // floats a thread, strided so that a warp's accesses hit 32 banks)
    float* acc2s = reinterpret_cast<float*>(smem + kOffAcc) + tid;
    float acc2[16][4];
    const int arow = warp * 16 + g;
    int s = 0;
    for (int c = 0; c < kChunks; ++c) {
        float acc1[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc1[i] = 0.f;

        // h1c = A @ W1[:, chunk] on wgmma: K = 512 in 32 stages of 2
        // k-steps, each stage's 6 products gathered from zero in `run`
        for (int slab = 0; slab < kW1Stages; ++slab, ++s) {
            const uint32_t slot = ring0 + acquire(s) * kStageBytes;
            // the stage's A fragments first, so that no register an
            // in-flight wgmma reads is written between its products
            uint32_t ab[kW1KSteps][4], as[kW1KSteps][4];
#pragma unroll
            for (int kk = 0; kk < kW1KSteps; ++kk) {
                const int ks = slab * kW1KSteps + kk;
                const int col = (ks & 7) * 8 + t;
                load_a(ab[kk], xbig + (ks >> 3) * kXStride, arow, col,
                       kXStride);
                load_a(as[kk], xsmall + (ks >> 3) * kXStride, arow, col,
                       kXStride);
            }
            float run[64];
#pragma unroll
            for (int i = 0; i < 64; ++i) run[i] = 0.f;
            fence_operands(run);
            asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
            for (int kk = 0; kk < kW1KSteps; ++kk) {
                const uint64_t big = wgmma_desc(slot + kk * kKStepBytes);
                const uint64_t small =
                    wgmma_desc(slot + kk * kKStepBytes + kKStepBytes / 2);
                wgmma128(run, as[kk], big, kk > 0);
                wgmma128(run, ab[kk], small, 1);
                wgmma128(run, ab[kk], big, 1);
            }
            asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
            fence_operands(run);
#pragma unroll
            for (int i = 0; i < 64; ++i) acc1[i] += run[i];
            release(s);
        }

        // h2acc += leaky(h1c + b1) @ W2[chunk, :]: n-tile q of h1c is
        // k-step q here, its accumulator (2t, 2t+1) read as k = (t, t+4)
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                acc2[i][e] = c > 0 ? acc2s[(4 * i + e) * kThreads] : 0.f;
        const int hid0 = part * (kD1 / kParts) + c * kChunk;
#pragma unroll
        for (int st = 0; st < kW2Stages; ++st, ++s) {
            const float4* bs = ring + acquire(s) * kStageVecs;
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
                const int q = st * 2 + kk;
                const float bias0 = __ldg(b1 + hid0 + q * 8 + 2 * t);
                const float bias1 = __ldg(b1 + hid0 + q * 8 + 2 * t + 1);
                uint32_t ab[4], as[4];
                split(leaky(acc1[4 * q] + bias0), ab[0], as[0]);
                split(leaky(acc1[4 * q + 2] + bias0), ab[1], as[1]);
                split(leaky(acc1[4 * q + 1] + bias1), ab[2], as[2]);
                split(leaky(acc1[4 * q + 3] + bias1), ab[3], as[3]);
#pragma unroll
                for (int nt = 0; nt < 16; ++nt)
                    mma3(acc2[nt], ab, as, bs[(kk * 16 + nt) * 32 + lane]);
            }
            release(s);
        }
        if (c + 1 < kChunks) {
#pragma unroll
            for (int i = 0; i < 16; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    acc2s[(4 * i + e) * kThreads] = acc2[i][e];
        }
    }

    // partial h2 of this CTA's hidden units -> the tile's scratch
    float* mine = partial + ((size_t)tile * kParts + part) * kBM * kD2;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
        const int col = nt * 8 + 2 * t;
        __stcg(reinterpret_cast<float2*>(mine + arow * kD2 + col),
               make_float2(acc2[nt][0], acc2[nt][1]));
        __stcg(reinterpret_cast<float2*>(mine + (arow + 8) * kD2 + col),
               make_float2(acc2[nt][2], acc2[nt][3]));
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        last = atomicAdd(arrived + tile, 1) == kParts - 1;
        if (last) __threadfence();
    }
    __syncthreads();
    if (!last) return;

    // the last CTA of the tile: h2 = leaky(sum of the partials + b2), in
    // the parts' order, split into big and small over the idle stages
    float* hbig = reinterpret_cast<float*>(smem);
    float* hsmall = hbig + kBM * kHStride;
    const float* tile_parts = partial + (size_t)tile * kParts * kBM * kD2;
    for (int i = tid; i < kBM * kD2 / 4; i += kThreads) {
        const int r = i / (kD2 / 4), q = i % (kD2 / 4);
        float4 v = __ldg(reinterpret_cast<const float4*>(b2) + q);
#pragma unroll
        for (int p = 0; p < kParts; ++p) {
            const float4 u = __ldcg(reinterpret_cast<const float4*>(
                tile_parts + (size_t)p * kBM * kD2) + i);
            v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
        }
        uint4 big, small;
        split(leaky(v.x), big.x, small.x);
        split(leaky(v.y), big.y, small.y);
        split(leaky(v.z), big.z, small.z);
        split(leaky(v.w), big.w, small.w);
        reinterpret_cast<uint4*>(hbig + r * kHStride)[q] = big;
        reinterpret_cast<uint4*>(hsmall + r * kHStride)[q] = small;
    }
    __syncthreads();

    // logits = h2 @ W3 + b3: warp w takes rows [16w, 16w + 16)
    const int nt3 = (D3 + 7) / 8;
    float acc3[kTiles3][4];
#pragma unroll
    for (int i = 0; i < kTiles3; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc3[i][e] = 0.f;
    for (int ks = 0; ks < kD2 / 8; ++ks) {
        uint32_t ab[4], as[4];
        load_a(ab, hbig, arow, ks * 8 + t, kHStride);
        load_a(as, hsmall, arow, ks * 8 + t, kHStride);
#pragma unroll
        for (int nt = 0; nt < kTiles3; ++nt)
            if (nt < nt3)
                mma3(acc3[nt], ab, as,
                     __ldg(w3f + ((size_t)ks * nt3 + nt) * 32 + lane));
    }
#pragma unroll
    for (int nt = 0; nt < kTiles3; ++nt) {
        if (nt >= nt3) continue;
        const int col = nt * 8 + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int j = j0 + arow + 8 * half;
            if (j >= W) continue;
            float* o = out + ((size_t)n * W + j) * D3;
            if (col < D3) o[col] = acc3[nt][2 * half] + __ldg(b3 + col);
            if (col + 1 < D3)
                o[col + 1] = acc3[nt][2 * half + 1] + __ldg(b3 + col + 1);
        }
    }
}

}  // namespace

// x: (N, W, 64); stream: (4, 4, 20, 4096) the prepared W1/W2 stages;
// w3f: (16, ceil(D3/8), 32, 4) the prepared W3 fragments; b1: (1024,);
// b2: (128,); b3: (ceil(D3/8)*8,); partial: (tiles, 4, 128, 128) and
// arrived: (tiles,) zeroed int32, scratch for tiles = N * ceil(W / 128);
// out: (N, W, D3); all
// 16-byte aligned (ops/kernels/char_head.py).  Launches on `stream_` and
// returns the launch's error code.
extern "C" int uocr_char_head(const float* x, const float* stream,
                              const float* w3f, const float* b1,
                              const float* b2, const float* b3,
                              float* partial, int* arrived, float* out,
                              int N, int W, int D3, void* stream_) {
    if (N <= 0 || W <= 0 || D3 <= 0 || D3 > kMaxD3)
        return (int)cudaErrorInvalidValue;
    const int tiles = (W + kBM - 1) / kBM;
    if ((long long)N * tiles > 65535) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        char_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(kParts, N * tiles);
    char_head_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream_>>>(
        x, reinterpret_cast<const float4*>(stream),
        reinterpret_cast<const float4*>(w3f), b1, b2, b3, partial, arrived,
        out, W, tiles, D3);
    return (int)cudaGetLastError();
}
