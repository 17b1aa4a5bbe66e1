// Native host-CV kernels for the interpreter's hot loops (the port's copy
// of univer_ocr_tpu/native/univocr_native.cpp; the code is unchanged).
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

extern "C" {

// ---------------------------------------------------------------------------
// Connected-component labeling, 4-connectivity, raster-scan label order —
// matches scipy.ndimage.label's default structuring element and numbering.
// mask: H*W uint8 (nonzero = foreground); labels: H*W int32 out.
// Returns the number of components.
// ---------------------------------------------------------------------------
int ccl_4conn(const uint8_t* mask, int H, int W, int32_t* labels) {
    std::vector<int32_t> parent;
    parent.reserve(1024);
    parent.push_back(0);  // 0 = background sentinel

    auto find = [&](int32_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    };
    auto unite = [&](int32_t a, int32_t b) {
        a = find(a); b = find(b);
        if (a != b) parent[std::max(a, b)] = std::min(a, b);
    };

    // First pass: provisional labels + unions.
    for (int y = 0; y < H; ++y) {
        for (int x = 0; x < W; ++x) {
            const int idx = y * W + x;
            if (!mask[idx]) { labels[idx] = 0; continue; }
            const int32_t up   = (y > 0) ? labels[idx - W] : 0;
            const int32_t left = (x > 0) ? labels[idx - 1] : 0;
            if (up && left) {
                labels[idx] = std::min(find(up), find(left));
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

    // Second pass: flatten + renumber in first-encounter raster order
    // (scipy's numbering).
    std::vector<int32_t> remap(parent.size(), 0);
    int32_t next = 0;
    for (int i = 0; i < H * W; ++i) {
        if (!labels[i]) continue;
        const int32_t root = find(labels[i]);
        if (!remap[root]) remap[root] = ++next;
        labels[i] = remap[root];
    }
    return next;
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
