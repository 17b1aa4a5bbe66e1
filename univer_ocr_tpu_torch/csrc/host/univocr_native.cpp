// Native host-CV kernels for the interpreter's hot loops (the port's copy
// of univer_ocr_tpu/native/univocr_native.cpp, with the labelling's first
// pass shared by ccl_4conn and the port's own ccl_4conn_stats).
//
// The cascade's host stages (paragraph/line cropping) spend their time in
// connected-component labeling, image rotation, and zooming.  These C++
// implementations are allocation-light (rotation is multithreaded); the
// port binds them with ctypes (univer_ocr_tpu_torch/native.py), which
// builds this file with g++ at first use.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int32_t find_root(std::vector<int32_t>& parent, int32_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

// First pass of the labelling: provisional labels + unions.  parent[0] is
// the background sentinel; every other entry is a provisional label.
std::vector<int32_t> provisional_labels(const uint8_t* mask, int H, int W,
                                        int32_t* labels) {
    std::vector<int32_t> parent;
    parent.reserve(1024);
    parent.push_back(0);
    auto unite = [&](int32_t a, int32_t b) {
        a = find_root(parent, a); b = find_root(parent, b);
        if (a != b) parent[std::max(a, b)] = std::min(a, b);
    };
    for (int y = 0; y < H; ++y) {
        for (int x = 0; x < W; ++x) {
            const int idx = y * W + x;
            if (!mask[idx]) { labels[idx] = 0; continue; }
            const int32_t up   = (y > 0) ? labels[idx - W] : 0;
            const int32_t left = (x > 0) ? labels[idx - 1] : 0;
            if (up && left) {
                labels[idx] = std::min(find_root(parent, up),
                                       find_root(parent, left));
                unite(up, left);
            } else if (up || left) {
                labels[idx] = up ? up : left;
            } else {
                const int32_t fresh = (int32_t)parent.size();
                parent.push_back(fresh);
                labels[idx] = fresh;
            }
        }
    }
    return parent;
}

// One component's statistics, gathered in the renumbering pass.
struct Component {
    int64_t count, sum_y, sum_x;
    int32_t y0, y1, x0, x1;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Connected-component labeling, 4-connectivity, raster-scan label order —
// matches scipy.ndimage.label's default structuring element and numbering.
// mask: H*W uint8 (nonzero = foreground); labels: H*W int32 out.
// Returns the number of components.
// ---------------------------------------------------------------------------
int ccl_4conn(const uint8_t* mask, int H, int W, int32_t* labels) {
    std::vector<int32_t> parent = provisional_labels(mask, H, W, labels);

    // Second pass: flatten + renumber in first-encounter raster order
    // (scipy's numbering).
    std::vector<int32_t> remap(parent.size(), 0);
    int32_t next = 0;
    for (int i = 0; i < H * W; ++i) {
        if (!labels[i]) continue;
        const int32_t root = find_root(parent, labels[i]);
        if (!remap[root]) remap[root] = ++next;
        labels[i] = remap[root];
    }
    return next;
}

// ---------------------------------------------------------------------------
// ccl_4conn's labels and count, and, gathered in its renumbering pass, the
// statistics of each label l = 1..n at row l - 1: counts (n int64, its
// pixels), sums (n*2 int64: the sums of their y and of their x) and boxes
// (n*4 int32: ymin, ymax_exclusive, xmin, xmax_exclusive).  The statistics
// are written only when n <= cap; the count is returned either way.
// ---------------------------------------------------------------------------
int ccl_4conn_stats(const uint8_t* mask, int H, int W, int32_t* labels,
                    int cap, int64_t* counts, int64_t* sums,
                    int32_t* boxes) {
    std::vector<int32_t> parent = provisional_labels(mask, H, W, labels);

    // The second pass of ccl_4conn, a run of one provisional label at a
    // time: its pixels take the label, and its statistics are added at once.
    std::vector<int32_t> remap(parent.size(), 0);
    std::vector<Component> comps;
    for (int y = 0; y < H; ++y) {
        int32_t* row = labels + (size_t)y * W;
        int x = 0;
        while (x < W) {
            const int32_t prov = row[x];
            if (!prov) { ++x; continue; }
            int end = x + 1;
            while (end < W && row[end] == prov) ++end;
            const int32_t root = find_root(parent, prov);
            if (!remap[root]) {
                comps.push_back({0, 0, 0, y, y + 1, x, end});
                remap[root] = (int32_t)comps.size();
            }
            const int32_t l = remap[root];
            std::fill(row + x, row + end, l);
            const int64_t len = end - x;
            Component& c = comps[l - 1];
            c.count += len;
            c.sum_y += (int64_t)y * len;
            c.sum_x += (int64_t)(x + end - 1) * len / 2;
            c.y1 = y + 1;  // rows arrive in order
            c.x0 = std::min(c.x0, x); c.x1 = std::max(c.x1, end);
            x = end;
        }
    }
    const int n = (int)comps.size();
    if (n <= cap) {
        for (int i = 0; i < n; ++i) {
            const Component& c = comps[i];
            counts[i] = c.count;
            sums[i * 2 + 0] = c.sum_y; sums[i * 2 + 1] = c.sum_x;
            boxes[i * 4 + 0] = c.y0; boxes[i * 4 + 1] = c.y1;
            boxes[i * 4 + 2] = c.x0; boxes[i * 4 + 3] = c.x1;
        }
    }
    return n;
}

// ---------------------------------------------------------------------------
// Per-label bounding boxes. labels: H*W int32 with n components;
// out_boxes: n*4 int32 (ymin, ymax_exclusive, xmin, xmax_exclusive).
// ---------------------------------------------------------------------------
void label_bboxes(const int32_t* labels, int H, int W, int n,
                  int32_t* out_boxes) {
    for (int i = 0; i < n; ++i) {
        out_boxes[i * 4 + 0] = H; out_boxes[i * 4 + 1] = 0;
        out_boxes[i * 4 + 2] = W; out_boxes[i * 4 + 3] = 0;
    }
    for (int y = 0; y < H; ++y) {
        for (int x = 0; x < W; ++x) {
            const int32_t l = labels[y * W + x];
            if (!l) continue;
            int32_t* b = out_boxes + (l - 1) * 4;
            b[0] = std::min(b[0], y); b[1] = std::max(b[1], y + 1);
            b[2] = std::min(b[2], x); b[3] = std::max(b[3], x + 1);
        }
    }
}

// ---------------------------------------------------------------------------
// Rotation with expansion (reshape=True), about the image center, matching
// scipy.ndimage.rotate's output size and coordinate convention for the
// (W, H)-plane rotation the interpreter uses (axes=(2,1)).  order: 0 =
// nearest, 1 = bilinear; outside = 0.  Multithreaded over rows.
// in: H*W*C float32; out: outH*outW*C float32 (caller computes outH/outW
// via rotated_size()).
// ---------------------------------------------------------------------------
void rotated_size(int H, int W, double angle_deg, int* outH, int* outW) {
    const double a = angle_deg * M_PI / 180.0;
    const double c = std::abs(std::cos(a)), s = std::abs(std::sin(a));
    // scipy: out dims = rounded rotated corners extents
    *outW = (int)std::round(W * c + H * s);
    *outH = (int)std::round(H * c + W * s);
}

void rotate_image(const float* in, int H, int W, int C, double angle_deg,
                  int order, float* out, int outH, int outW) {
    const double a = angle_deg * M_PI / 180.0;
    const double ca = std::cos(a), sa = std::sin(a);
    // Inverse map: for output pixel (yo, xo) centered coords, input coords
    // (matching ndimage.rotate(axes=(2,1)): y' = y ca - x sa; x' = y sa + x ca
    // => inverse: y = y' ca + x' sa; x = -y' sa + x' ca).
    const double cy_in = (H - 1) / 2.0, cx_in = (W - 1) / 2.0;
    const double cy_out = (outH - 1) / 2.0, cx_out = (outW - 1) / 2.0;

    int n_threads = std::max(1u, std::thread::hardware_concurrency());
    n_threads = std::min(n_threads, 8);
    std::vector<std::thread> threads;
    std::atomic<int> next_row{0};

    auto worker = [&]() {
        int yo;
        while ((yo = next_row.fetch_add(1)) < outH) {
            for (int xo = 0; xo < outW; ++xo) {
                const double yr = yo - cy_out, xr = xo - cx_out;
                const double yi = yr * ca + xr * sa + cy_in;
                const double xi = -yr * sa + xr * ca + cx_in;
                float* dst = out + (yo * outW + xo) * C;
                if (order == 0) {
                    const int y0 = (int)std::round(yi);
                    const int x0 = (int)std::round(xi);
                    if (y0 < 0 || y0 >= H || x0 < 0 || x0 >= W) {
                        for (int c = 0; c < C; ++c) dst[c] = 0.0f;
                    } else {
                        const float* src = in + (y0 * W + x0) * C;
                        for (int c = 0; c < C; ++c) dst[c] = src[c];
                    }
                } else {
                    const int y0 = (int)std::floor(yi), x0 = (int)std::floor(xi);
                    const double fy = yi - y0, fx = xi - x0;
                    for (int c = 0; c < C; ++c) {
                        double acc = 0.0;
                        for (int dy = 0; dy < 2; ++dy) {
                            for (int dx = 0; dx < 2; ++dx) {
                                const int yy = y0 + dy, xx = x0 + dx;
                                if (yy < 0 || yy >= H || xx < 0 || xx >= W)
                                    continue;
                                const double wgt =
                                    (dy ? fy : 1 - fy) * (dx ? fx : 1 - fx);
                                acc += wgt * in[(yy * W + xx) * C + c];
                            }
                        }
                        dst[c] = (float)acc;
                    }
                }
            }
        }
    };
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
}

// ---------------------------------------------------------------------------
// Nearest-neighbor zoom (the line-crop height normalization,
// interpreter.py:511-514).  Coordinate convention matches
// scipy.ndimage.zoom(order=0): in = round(out * (in_size-1)/(out_size-1))
// for out_size > 1 (endpoint-aligned).
// ---------------------------------------------------------------------------
void zoom_nearest(const float* in, int H, int W, int C,
                  float* out, int outH, int outW) {
    std::vector<int> xmap(outW);
    const double sx = outW > 1 ? (double)(W - 1) / (outW - 1) : 0.0;
    const double sy = outH > 1 ? (double)(H - 1) / (outH - 1) : 0.0;
    for (int x = 0; x < outW; ++x)
        xmap[x] = std::min(W - 1, (int)std::round(x * sx));
    for (int y = 0; y < outH; ++y) {
        const int yi = std::min(H - 1, (int)std::round(y * sy));
        const float* src_row = in + yi * W * C;
        float* dst_row = out + y * outW * C;
        for (int x = 0; x < outW; ++x) {
            std::memcpy(dst_row + x * C, src_row + xmap[x] * C,
                        C * sizeof(float));
        }
    }
}

}  // extern "C"
