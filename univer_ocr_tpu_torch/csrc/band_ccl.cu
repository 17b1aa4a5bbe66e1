// Connected components with their statistics, for Hopper (sm_90a).
//
// Labels each of N binary images 4-connected, as scipy.ndimage.label and
// the host library's ccl_4conn_stats do, and gathers each component's
// pixel count, y and x sums and box.  Components are numbered in raster
// order of their first pixel (scipy's numbering, less one).  The device
// cascade runs it on both band channels of every paragraph of a launch
// (the line planner's input) and on the paragraph masks of a chunk (the
// paragraph planner's labels).  It replaces no TPU kernel: the JAX
// package's band tables are row statistics in XLA.
//
// Bound on the H100: traffic, not work.  The compulsory bytes are the
// masks (1 byte a pixel) and the tables (7 ints a component); the
// labelling also reads and writes a 4-byte label a pixel a few times,
// which mostly stays in the 50 MB L2.  In practice latency bounds it: a
// union or a root search is a chain of dependent loads, and a pass over an
// image is short.  So the work of an image is spread over many blocks in
// flight, every chain runs in shared memory where it can, and every pass
// reads and writes with neighbouring lanes on neighbouring pixels.
//
// Design: block-based union-find (Playne and Hawick 2018, Allegretti et
// al. 2019) over tiles of `tile_h` rows by `tile_w` columns, one 256-thread
// block a tile, N x tiles blocks a kernel, the tile shape chosen by the
// wrapper from (N, H, W) so that a launch fills the SMs.  Warps walk rows,
// lanes neighbouring pixels.  Blocks whose tile lies outside the image's
// valid region return at once.
// A label is the raster index of a pixel; a root is its own label, and
// every union links the larger root under the smaller (atomicMin), so each
// root ends as its component's first pixel in raster order.
//  1. tiles: in shared memory, each foreground pixel points at the start
//     of its run along the row (warp ballots), the runs join the runs above
//     them, and every pixel's label becomes its tile component's root;
//  2. merge: the pixel pairs across each tile's top and left borders are
//     joined in device memory (only the first pair of a run of pairs);
//  3. roots: each tile component linked out of its tile finds its root
//     through the other tiles, the tile's labels are compressed in shared
//     memory, every root is replaced by -(its rank in its row segment + 2)
//     and every other pixel's label by its root, and each row segment
//     (a row of a tile) writes how many roots it holds;
//  4. scan: one block an image turns the row segments' counts, in raster
//     order, into each segment's first rank, counts the components and
//     makes the table ready for the atomics (rows past the components 0);
//  5. stats: each pixel's rank is its root's segment's first rank plus the
//     root's rank in it; the runs of one rank along a row are summed in
//     closed form into a shared table and flushed with atomics into the
//     first `max_comp` rows; with `labels_out`, each pixel's rank (or -1).
// No pass depends on what an earlier call left in the scratch, so a graph
// replay starts clean.  The component count may exceed `max_comp`; the
// caller flags that.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kFields = 7;          // count, sum_y, sum_x, y0, y1, x0, x1
constexpr int kMaxComp = 256;       // shared table rows a launch may ask for
constexpr int kTilePixels = 8192;   // a tile's labels: 32 KB of shared memory
constexpr unsigned kAll = 0xffffffffu;

struct Grid {
    int H, W, th, tw, tiles_x, tiles;  // tiles an image
};

// The tile of this block, clipped to its image's valid region.
struct Tile {
    int img, tx, y0, x0, rows, cols;
    size_t base;                       // the image's first pixel
};

__device__ bool tile_of(const Grid& g, const int* h_valid,
                        const int* w_valid, Tile& t) {
    t.img = blockIdx.x / g.tiles;
    const int k = blockIdx.x - t.img * g.tiles;
    const int ty = k / g.tiles_x;
    t.tx = k - ty * g.tiles_x;
    t.y0 = ty * g.th;
    t.x0 = t.tx * g.tw;
    t.rows = min(g.th, min(max(h_valid[t.img], 0), g.H) - t.y0);
    t.cols = min(g.tw, min(max(w_valid[t.img], 0), g.W) - t.x0);
    t.base = (size_t)t.img * g.H * g.W;
    return t.rows > 0 && t.cols > 0;
}

__device__ __forceinline__ int find_root(volatile int* L, int p) {
    int next = L[p];
    while (next != p) {
        p = next;
        next = L[p];
    }
    return p;
}

// Links the roots of a and b, the larger under the smaller.
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

// Calls f(ly, lx) on every pixel of the tile: a warp on 32 neighbours of
// a row at a time, the warps over the rows' chunks.
template <typename F>
__device__ __forceinline__ void for_pixels(const Tile& t, F f) {
    const int chunks = (t.cols + 31) >> 5;
    const int lane = threadIdx.x & 31;
    for (int j = threadIdx.x >> 5; j < t.rows * chunks; j += kWarps) {
        const int ly = j / chunks, lx = ((j - ly * chunks) << 5) + lane;
        if (lx < t.cols) f(ly, lx);
    }
}

// Lanes 0..lane of a ballot.
__device__ __forceinline__ unsigned upto(unsigned bits, int lane) {
    return bits & (kAll >> (31 - lane));
}

__global__ void __launch_bounds__(kThreads)
band_ccl_kernel_tiles(const uint8_t* __restrict__ masks,
                      const int* __restrict__ h_valid,
                      const int* __restrict__ w_valid, Grid g,
                      int* __restrict__ L) {
    extern __shared__ int S[];         // tile labels, row stride g.tw
    Tile t;
    if (!tile_of(g, h_valid, w_valid, t)) return;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint8_t* m = masks + t.base;
    // each foreground pixel points at the first pixel of its run, -1 off it
    for (int ly = warp; ly < t.rows; ly += kWarps) {
        const uint8_t* row = m + (size_t)(t.y0 + ly) * g.W + t.x0;
        int carry_fg = 0, carry_start = 0;
        for (int cx = 0; cx < t.cols; cx += 32) {
            const int lx = cx + lane;
            const int fg = lx < t.cols && row[lx];
            const int up = __shfl_up_sync(kAll, fg, 1);
            const int prev = lane == 0 ? carry_fg : up;
            const unsigned starts = upto(__ballot_sync(kAll, fg && !prev),
                                         lane);
            const int start = starts ? cx + 31 - __clz(starts) : carry_start;
            if (lx < t.cols) S[ly * g.tw + lx] = fg ? ly * g.tw + start : -1;
            carry_fg = __shfl_sync(kAll, fg, 31);
            carry_start = __shfl_sync(kAll, start, 31);
        }
    }
    __syncthreads();
    // join each run to the runs above it: at the first of each run of
    // vertical pairs, the others are joined through it
    for_pixels(t, [&](int ly, int lx) {
        if (ly == 0) return;
        const int l = ly * g.tw + lx, u = l - g.tw;
        if (S[l] < 0 || S[u] < 0) return;
        if (lx > 0 && S[l - 1] >= 0 && S[u - 1] >= 0) return;
        unite(S, l, u);
    });
    __syncthreads();
    // the first pixel of each run at its root; the walks halve the paths
    // they take (only the runs' first pixels are linked, each link to an
    // ancestor, and no union runs any more)
    volatile int* vS = S;
    for_pixels(t, [&](int ly, int lx) {
        const int l = ly * g.tw + lx;
        if (vS[l] < 0 || (lx > 0 && vS[l - 1] >= 0)) return;
        int p = l;
        while (true) {
            const int parent = vS[p];
            if (parent == p) break;
            const int grand = vS[parent];
            if (grand != parent) vS[p] = grand;
            p = grand;
        }
        vS[l] = p;
    });
    __syncthreads();
    // each pixel's label: the raster index of its tile component's root,
    // the root of its run's first pixel
    for_pixels(t, [&](int ly, int lx) {
        const int v = S[ly * g.tw + lx];
        int label = -1;
        if (v >= 0) {
            const int r = S[v], ry = r / g.tw;
            label = (t.y0 + ry) * g.W + t.x0 + r - ry * g.tw;
        }
        L[t.base + (size_t)(t.y0 + ly) * g.W + t.x0 + lx] = label;
    });
}

__global__ void __launch_bounds__(kThreads)
band_ccl_kernel_merge(const uint8_t* __restrict__ masks,
                      const int* __restrict__ h_valid,
                      const int* __restrict__ w_valid, Grid g, int* L) {
    Tile t;
    if (!tile_of(g, h_valid, w_valid, t)) return;
    const uint8_t* m = masks + t.base;
    int* Li = L + t.base;
    if (t.y0 > 0) {                    // the border with the tile above
        for (int lx = threadIdx.x; lx < t.cols; lx += kThreads) {
            const int p = t.y0 * g.W + t.x0 + lx, q = p - g.W;
            if (!m[p] || !m[q]) continue;
            if (lx > 0 && m[p - 1] && m[q - 1]) continue;
            unite(Li, p, q);
        }
    }
    if (t.x0 > 0) {                    // the border with the tile left of it
        for (int ly = threadIdx.x; ly < t.rows; ly += kThreads) {
            const int p = (t.y0 + ly) * g.W + t.x0, q = p - 1;
            if (!m[p] || !m[q]) continue;
            if (ly > 0 && m[p - g.W] && m[q - g.W]) continue;
            unite(Li, p, q);
        }
    }
}

// A label's place in the tile's shared labels, or -(label + 2) if the
// pixel lies outside the tile.
__device__ __forceinline__ int to_tile(const Grid& g, const Tile& t, int v) {
    const int y = v / g.W, x = v - y * g.W;
    if (y >= t.y0 && y < t.y0 + t.rows && x >= t.x0 && x < t.x0 + t.cols)
        return (y - t.y0) * g.tw + x - t.x0;
    return -(v + 2);
}

// The root of p while other tiles mark their roots with ranks (< -1).
__device__ __forceinline__ int find_marked(volatile int* L, int p) {
    while (true) {
        const int v = L[p];
        if (v == p || v < 0) return p;
        p = v;
    }
}

__global__ void __launch_bounds__(kThreads)
band_ccl_kernel_roots(const int* __restrict__ h_valid,
                      const int* __restrict__ w_valid, Grid g, int* L,
                      int* __restrict__ counts) {
    extern __shared__ int S[];         // labels: in the tile, or -(label+2)
    Tile t;
    if (!tile_of(g, h_valid, w_valid, t)) return;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int* Li = L + t.base;
    for_pixels(t, [&](int ly, int lx) {
        const int v = Li[(t.y0 + ly) * g.W + t.x0 + lx];
        S[ly * g.tw + lx] = v < 0 ? -1 : to_tile(g, t, v);
    });
    __syncthreads();
    // the tile components linked out of the tile: their roots
    for_pixels(t, [&](int ly, int lx) {
        const int l = ly * g.tw + lx, v = S[l];
        if (v > -2) return;
        const int root = find_marked(Li, -v - 2);
        Li[(t.y0 + ly) * g.W + t.x0 + lx] = root;   // shortens others' walks
        S[l] = to_tile(g, t, root);
    });
    __syncthreads();
    // compression inside the tile: every pixel at its root; a label read
    // once, as its owner may rewrite it to its own root meanwhile
    volatile int* vS = S;
    for_pixels(t, [&](int ly, int lx) {
        const int l = ly * g.tw + lx;
        int e = l, v = vS[l];
        if (v < 0) return;
        while (v >= 0 && v != e) {
            e = v;
            v = vS[e];
        }
        vS[l] = v >= 0 ? e : v;
    });
    __syncthreads();
    // ranks of the roots in each row segment, raster order
    for (int ly = warp; ly < t.rows; ly += kWarps) {
        const int row = (t.y0 + ly) * g.W + t.x0;
        int total = 0;
        for (int cx = 0; cx < t.cols; cx += 32) {
            const int lx = cx + lane, l = ly * g.tw + lx;
            const int v = lx < t.cols ? S[l] : -1;
            const unsigned roots = __ballot_sync(kAll, v == l);
            if (v == l) {
                Li[row + lx] = -(total + __popc(roots & ((1u << lane) - 1))
                                 + 2);
            } else if (v != -1) {
                const int vy = v / g.tw;
                Li[row + lx] = v >= 0 ? (t.y0 + vy) * g.W + t.x0 + v - vy * g.tw
                                      : -v - 2;
            }
            total += __popc(roots);
        }
        if (lane == 0)
            counts[((size_t)t.img * g.H + t.y0 + ly) * g.tiles_x + t.tx] = total;
    }
}

__global__ void __launch_bounds__(kScanThreads)
band_ccl_kernel_scan(const int* __restrict__ h_valid,
                     const int* __restrict__ w_valid, Grid g, int max_comp,
                     int* __restrict__ counts, int* __restrict__ stats,
                     int* __restrict__ n_comp) {
    __shared__ int warp_sums[kScanThreads / 32];
    const int img = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int h = min(max(h_valid[img], 0), g.H);
    const int w = min(max(w_valid[img], 0), g.W);
    const int segments = (w + g.tw - 1) / g.tw;   // of a row, in the region
    const int E = h * g.tiles_x;
    int* c = counts + (size_t)img * g.H * g.tiles_x;
    int carry = 0;
    for (int e0 = 0; e0 < E; e0 += kScanThreads) {
        const int e = e0 + threadIdx.x;
        const int v = e < E && e % g.tiles_x < segments ? c[e] : 0;
        int x = v;
        for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(kAll, x, off);
            if (lane >= off) x += y;
        }
        if (lane == 31) warp_sums[warp] = x;
        __syncthreads();
        if (warp == 0) {
            int s = warp_sums[lane];
            for (int off = 1; off < 32; off <<= 1) {
                const int y = __shfl_up_sync(kAll, s, off);
                if (lane >= off) s += y;
            }
            warp_sums[lane] = s;
        }
        __syncthreads();
        x += warp > 0 ? warp_sums[warp - 1] : 0;
        if (e < E) c[e] = carry + x - v;              // first rank
        carry += warp_sums[31];
        __syncthreads();
    }
    if (threadIdx.x == 0) n_comp[img] = carry;
    const int live = min(carry, max_comp);
    int* out = stats + (size_t)img * max_comp * kFields;
    for (int i = threadIdx.x; i < max_comp * kFields; i += kScanThreads) {
        const int f = i % kFields;
        out[i] = i / kFields < live && (f == 3 || f == 5) ? INT_MAX : 0;
    }
}

// Adds the pixels x0..x1 of row y, all of component r, to its table row.
__device__ __forceinline__ void add_run(int* table, int r, int y, int x0,
                                        int x1) {
    const int cnt = x1 - x0 + 1;
    int* row = table + r * kFields;
    atomicAdd(row + 0, cnt);
    atomicAdd(row + 1, (int)((long long)cnt * y));
    atomicAdd(row + 2, (int)((long long)cnt * (x0 + x1) / 2));
    atomicMin(row + 3, y);
    atomicMax(row + 4, y + 1);
    atomicMin(row + 5, x0);
    atomicMax(row + 6, x1 + 1);
}

__global__ void __launch_bounds__(kThreads)
band_ccl_kernel_stats(const int* __restrict__ h_valid,
                      const int* __restrict__ w_valid, Grid g, int max_comp,
                      const int* __restrict__ L,
                      const int* __restrict__ first,
                      int* __restrict__ stats, int* __restrict__ labels_out) {
    extern __shared__ int table[];     // max_comp x kFields
    Tile t;
    if (!tile_of(g, h_valid, w_valid, t)) return;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int* Li = L + t.base;
    const int* first_i = first + (size_t)t.img * g.H * g.tiles_x;
    for (int i = threadIdx.x; i < max_comp * kFields; i += kThreads) {
        const int f = i % kFields;
        table[i] = f == 3 || f == 5 ? INT_MAX : 0;
    }
    __syncthreads();
    for (int ly = warp; ly < t.rows; ly += kWarps) {
        const int y = t.y0 + ly, row = y * g.W + t.x0;
        const int seg_first = first_i[y * g.tiles_x + t.tx];
        int carry_r = -1, carry_s = 0;
        for (int cx = 0; cx < t.cols; cx += 32) {
            const int lx = cx + lane;
            int r = -1;
            if (lx < t.cols) {
                const int v = Li[row + lx];
                if (v < -1) {
                    r = seg_first - v - 2;
                } else if (v >= 0) {
                    const int vy = v / g.W;
                    r = first_i[vy * g.tiles_x + (v - vy * g.W) / g.tw]
                        - Li[v] - 2;
                }
                if (labels_out != nullptr) labels_out[t.base + row + lx] = r;
            }
            // runs of one rank along the row, each summed by its last lane
            const int up = __shfl_up_sync(kAll, r, 1);
            const int down = __shfl_down_sync(kAll, r, 1);
            const unsigned starts = upto(
                __ballot_sync(kAll, r != (lane == 0 ? carry_r : up)), lane);
            const int s = starts ? cx + 31 - __clz(starts) : carry_s;
            // a run carried over that ended with the last chunk
            if (lane == 0 && carry_r >= 0 && carry_r < max_comp
                && r != carry_r)
                add_run(table, carry_r, y, t.x0 + carry_s, t.x0 + cx - 1);
            const bool last = lane < 31 ? r != down : cx + 32 >= t.cols;
            if (last && r >= 0 && r < max_comp)
                add_run(table, r, y, t.x0 + s, t.x0 + lx);
            carry_r = __shfl_sync(kAll, r, 31);
            carry_s = __shfl_sync(kAll, s, 31);
        }
    }
    __syncthreads();
    int* out = stats + (size_t)t.img * max_comp * kFields;
    for (int c = threadIdx.x; c < max_comp; c += kThreads) {
        const int* row_t = table + c * kFields;
        if (row_t[0] == 0) continue;
        int* o = out + c * kFields;
        atomicAdd(o + 0, row_t[0]);
        atomicAdd(o + 1, row_t[1]);
        atomicAdd(o + 2, row_t[2]);
        atomicMin(o + 3, row_t[3]);
        atomicMax(o + 4, row_t[4]);
        atomicMin(o + 5, row_t[5]);
        atomicMax(o + 6, row_t[6]);
    }
}

}  // namespace

// masks: (N, H, W) uint8 0/1 on the card; h_valid, w_valid: (N,) int32,
// the region of each image to label (pixels outside it are background);
// tile_h, tile_w: the tile shape (tile_h * tile_w <= 8192, tile_w <= W,
// tile_h <= H); scratch: N*H*W + N*H*ceil(W / tile_w) int32, no state
// carried between calls; stats: (N, max_comp, 7) int32, written whole
// (count, sum_y, sum_x, y0, y1, x0, x1 with exclusive stops; zero rows
// past the components); n_comp: (N,) int32, every component counted;
// labels_out: null or (N, H, W) int32, each pixel's component rank or -1
// (outside the valid region it is left unwritten).  Launches five kernels
// on `stream`, whose grids follow from (N, H, W, tile_h, tile_w) alone,
// and returns the first launch error.
extern "C" int uocr_band_ccl(const uint8_t* masks, const int* h_valid,
                             const int* w_valid, int N, int H, int W,
                             int max_comp, int tile_h, int tile_w,
                             int* scratch, int* stats, int* n_comp,
                             int* labels_out, void* stream) {
    if (N <= 0 || H <= 0 || W <= 0 || max_comp <= 0 || max_comp > kMaxComp
        || (long long)H * W > INT_MAX || tile_h <= 0 || tile_w <= 0
        || tile_h > H || tile_w > W || tile_h * tile_w > kTilePixels)
        return (int)cudaErrorInvalidValue;
    Grid g;
    g.H = H;
    g.W = W;
    g.th = tile_h;
    g.tw = tile_w;
    g.tiles_x = (W + tile_w - 1) / tile_w;
    g.tiles = g.tiles_x * ((H + tile_h - 1) / tile_h);
    if ((long long)N * g.tiles > INT_MAX) return (int)cudaErrorInvalidValue;
    const int blocks = N * g.tiles;
    const size_t tile_bytes = (size_t)tile_h * tile_w * sizeof(int);
    const size_t table_bytes = (size_t)max_comp * kFields * sizeof(int);
    int* L = scratch;
    int* counts = scratch + (size_t)N * H * W;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    band_ccl_kernel_tiles<<<blocks, kThreads, tile_bytes, s>>>(
        masks, h_valid, w_valid, g, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    band_ccl_kernel_merge<<<blocks, kThreads, 0, s>>>(masks, h_valid,
                                                      w_valid, g, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    band_ccl_kernel_roots<<<blocks, kThreads, tile_bytes, s>>>(
        h_valid, w_valid, g, L, counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    band_ccl_kernel_scan<<<N, kScanThreads, 0, s>>>(
        h_valid, w_valid, g, max_comp, counts, stats, n_comp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    band_ccl_kernel_stats<<<blocks, kThreads, table_bytes, s>>>(
        h_valid, w_valid, g, max_comp, L, counts, stats, labels_out);
    return (int)cudaGetLastError();
}
