// Connected components with their statistics, for Hopper (sm_90a).
//
// Labels each of N binary images 4-connected, as scipy.ndimage.label and
// the host library's ccl_4conn_stats do, and gathers each component's
// pixel count, y and x sums and box in the same launch.  Components are
// numbered in raster order of their first pixel (scipy's numbering, less
// one).  The device cascade runs it on both band channels of every
// paragraph of a launch (the line planner's input) and on the paragraph
// masks of a chunk (the paragraph planner's labels).
//
// Bound on the H100: traffic, not work.  The compulsory bytes are the
// masks (1 byte a pixel) and the tables (7 ints a component); the
// labelling itself reads and writes a 4-byte label a pixel a few times,
// which stays in L2 for one image.
//
// Design: one block of 1024 threads per image, so every pass is separated
// by a block barrier and the whole labelling is one launch with no host
// sync.  Each thread owns a contiguous run of the image's valid region in
// raster order, so neighbours along a row are mostly its own.
//  1. init: L[p] = p on the foreground, -1 elsewhere;
//  2. union-find over the left and upper neighbours, linking the larger
//     root under the smaller with atomicMin (Playne and Hawick), so each
//     root ends as its component's smallest raster index;
//  3. compression: L[p] = root(p);
//  4. ranks: each thread counts the roots in its run, a block scan gives
//     the first rank of each run, and each root's L becomes -(rank + 2);
//  5. statistics: each thread accumulates its run's pixels while the
//     component stays the same and flushes with shared-memory atomics into
//     the first `max_comp` rows of the table; with `labels_out`, each
//     pixel's rank (or -1) is written out.
// The component count may exceed `max_comp`; the caller flags that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kFields = 7;          // count, sum_y, sum_x, y0, y1, x0, x1
constexpr int kMaxComp = 256;       // shared table rows a launch may ask for

__device__ __forceinline__ int find_root(volatile int* L, int p) {
    int next = L[p];
    while (next != p) {
        p = next;
        next = L[p];
    }
    return p;
}

__device__ void unite(int* L, int a, int b) {
    volatile int* vL = L;
    while (true) {
        a = find_root(vL, a);
        b = find_root(vL, b);
        if (a == b) return;
        if (a < b) {
            int old = atomicMin(&L[b], a);
            if (old == b) return;
            b = old;
        } else {
            int old = atomicMin(&L[a], b);
            if (old == a) return;
            a = old;
        }
    }
}

__global__ void __launch_bounds__(kThreads, 1)
band_ccl_kernel(const uint8_t* __restrict__ masks,
                const int* __restrict__ h_valid,
                const int* __restrict__ w_valid, int H, int W,
                int max_comp, int* __restrict__ scratch,
                int* __restrict__ stats, int* __restrict__ n_comp,
                int* __restrict__ labels_out) {
    __shared__ int table[kMaxComp * kFields];
    __shared__ int scan[kThreads];
    const int img = blockIdx.x;
    const int t = threadIdx.x;
    const size_t base = (size_t)img * H * W;
    const uint8_t* m = masks + base;
    int* L = scratch + base;
    const int h = min(max(h_valid[img], 0), H);
    const int w = min(max(w_valid[img], 0), W);
    const int n_px = h * w;
    const int per = (n_px + kThreads - 1) / kThreads;
    const int lo = min(t * per, n_px);
    const int hi = min(lo + per, n_px);

    for (int i = t; i < max_comp * kFields; i += kThreads) {
        const int f = i % kFields;
        table[i] = (f == 3 || f == 5) ? 0x7fffffff : (f == 4 || f == 6) ? -1
                                                                          : 0;
    }
    // 1. init
    for (int i = lo; i < hi; ++i) {
        const int y = i / w, x = i - (i / w) * w;
        const int p = y * W + x;
        L[p] = m[p] ? p : -1;
    }
    __syncthreads();
    // 2. union with the left and upper neighbours
    for (int i = lo; i < hi; ++i) {
        const int y = i / w, x = i - (i / w) * w;
        const int p = y * W + x;
        if (!m[p]) continue;
        if (x > 0 && m[p - 1]) unite(L, p, p - 1);
        if (y > 0 && m[p - W]) unite(L, p, p - W);
    }
    __syncthreads();
    // 3. compression
    for (int i = lo; i < hi; ++i) {
        const int y = i / w, x = i - (i / w) * w;
        const int p = y * W + x;
        if (m[p]) L[p] = find_root(L, p);
    }
    __syncthreads();
    // 4. ranks of the roots in raster order
    int roots = 0;
    for (int i = lo; i < hi; ++i) {
        const int y = i / w, x = i - (i / w) * w;
        const int p = y * W + x;
        roots += (m[p] && L[p] == p);
    }
    scan[t] = roots;
    __syncthreads();
    for (int off = 1; off < kThreads; off <<= 1) {
        const int v = t >= off ? scan[t - off] : 0;
        __syncthreads();
        scan[t] += v;
        __syncthreads();
    }
    int rank = scan[t] - roots;
    if (t == kThreads - 1) n_comp[img] = scan[t];
    for (int i = lo; i < hi; ++i) {
        const int y = i / w, x = i - (i / w) * w;
        const int p = y * W + x;
        if (m[p] && L[p] == p) L[p] = -(rank++ + 2);
    }
    __syncthreads();
    // 5. statistics of the run, flushed when the component changes
    int cur = -1, cnt = 0, sy = 0, sx = 0, y0 = 0, y1 = 0, x0 = 0, x1 = 0;
    auto flush = [&]() {
        if (cur >= 0 && cur < max_comp) {
            int* row = table + cur * kFields;
            atomicAdd(row + 0, cnt);
            atomicAdd(row + 1, sy);
            atomicAdd(row + 2, sx);
            atomicMin(row + 3, y0);
            atomicMax(row + 4, y1);
            atomicMin(row + 5, x0);
            atomicMax(row + 6, x1);
        }
    };
    for (int i = lo; i < hi; ++i) {
        const int y = i / w, x = i - (i / w) * w;
        const int p = y * W + x;
        int r = -1;
        if (m[p]) {
            const int v = L[p];
            r = v < 0 ? -v - 2 : -L[v] - 2;
        }
        if (labels_out != nullptr) labels_out[base + p] = r;
        if (r < 0) continue;
        if (r != cur) {
            flush();
            cur = r;
            cnt = sy = sx = 0;
            y0 = y1 = y;
            x0 = x1 = x;
        }
        ++cnt;
        sy += y;
        sx += x;
        y0 = min(y0, y);
        y1 = max(y1, y);
        x0 = min(x0, x);
        x1 = max(x1, x);
    }
    flush();
    __syncthreads();
    int* out = stats + (size_t)img * max_comp * kFields;
    for (int i = t; i < max_comp * kFields; i += kThreads) {
        const int f = i % kFields;
        const int c = i / kFields;
        const bool live = table[c * kFields] > 0;
        int v = table[i];
        if (!live) v = 0;
        else if (f == 4 || f == 6) v += 1;      // exclusive stops
        out[i] = v;
    }
}

}  // namespace

// masks: (N, H, W) uint8 0/1 on the card; h_valid, w_valid: (N,) int32,
// the region of each image to label (pixels outside it are background);
// scratch: (N, H, W) int32; stats: (N, max_comp, 7) int32, written whole
// (count, sum_y, sum_x, y0, y1, x0, x1 with exclusive stops; zero rows
// past the components); n_comp: (N,) int32, every component counted;
// labels_out: null or (N, H, W) int32, each pixel's component rank or -1
// (outside the valid region it is left unwritten).  Launches on `stream`
// and returns the launch's error code.
extern "C" int uocr_band_ccl(const uint8_t* masks, const int* h_valid,
                             const int* w_valid, int N, int H, int W,
                             int max_comp, int* scratch, int* stats,
                             int* n_comp, int* labels_out, void* stream) {
    if (N <= 0 || H <= 0 || W <= 0 || max_comp <= 0 || max_comp > kMaxComp
        || (long long)H * W > 0x7fffffff)
        return (int)cudaErrorInvalidValue;
    band_ccl_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
        masks, h_valid, w_valid, H, W, max_comp, scratch, stats, n_comp,
        labels_out);
    return (int)cudaGetLastError();
}
