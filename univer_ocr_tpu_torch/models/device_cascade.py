"""Device-resident cascade (univer_ocr_tpu/models/device_cascade.py): the
host cascade's paragraph and line crops, computed on the device.

The monochrome map stays on the device for the whole cascade, in the
uint8 steps the host cascade pulls it in; the host sees only what it
plans from.  Two gathers replace the host's CPU resampling, and each
computes the host's own geometry:

  * `paragraph_crops`: a paragraph's box of the map, masked to the
    paragraph, rotated as `ndimage.rotate(..., axes=(1, 0), order=1,
    reshape=True)` rotates it (its output shape and centre, its inverse
    map in float64, its edge rule: zero wherever a coordinate leaves the
    input) and cut to the box of the order-0 rotated mask: the host
    cascade's `deskew_paragraph` and the reference's `crop_paragraph`;
  * `zoomed_line_crops`: a line's box turned upright (np.rot90) and zoomed
    to height 32 as `ndimage.zoom(order=0)` zooms it (its float64
    coordinates, zero where one passes the input's last index), then
    right-padded with zeros to width 8: the host's `extract_line`.

The JAX package resamples in float32 (one bilinear gather, or two 1D
passes); its crops read 6-10 % of characters away from the host
cascade's text, so the port's device cascade departs from it here and
follows the host cascade.

The paragraph planners (`device_page_plans`, `device_chunk_plans`) label
the paragraph masks on the device (`page_labels`: the `band_ccl` kernel,
4-connected as the host's labels) and compute what the host planner
(OCRPipeline._page_paragraph_plans) computes for each component: the
deskew angle of least height on the 1-degree grid, the rotated frame and
the box of the order-0 rotated mask.  Each crop reads its component from
the chunk's labels, so nothing is uploaded for it.

The forwards' convolutions are full float32 in 'highest' only while TF32
is off: run the stages inside `ops.precision.backend_flags(precision)`
(OCRPipeline.ocr_pages holds it for every thread of the cascade).
"""

import functools

import numpy as np
import torch
from scipy import special

from ..ops.kernels.band_ccl import band_ccl
from .band_tables import band_threshold
from .bucketing import CHAR_FIXED_WIDTH, CHAR_INPUT_HEIGHT
from .fastpath import line_forward_masked

F64 = torch.float64

# ---------------------------------------------------------------------------
# Host-side geometry
# ---------------------------------------------------------------------------

#: inverse affine of np.rot90(k, axes=(2, 1)) per k on an (h, w) plane:
#: rotated[yr, xr] == original[ys, xs] with
#: ys = A[0]*yr + A[1]*xr + A[2](h, w), xs = A[3]*yr + A[4]*xr + A[5](h, w)
_ROT90_INVERSE = {
    0: lambda h, w: (1, 0, 0, 0, 1, 0),
    1: lambda h, w: (0, -1, h - 1, 1, 0, 0),
    2: lambda h, w: (-1, 0, h - 1, 0, -1, w - 1),
    3: lambda h, w: (0, 1, 0, -1, 0, w - 1),
}


def rot90_inverse_affine(rotation, h, w):
    """Inverse index map of `rotate_array(x, rotation)` for right-angle
    rotations (np.rot90 with k = (4 - rotation//90) % 4).  Returns the
    rotated shape and the 6 affine coefficients."""
    k = 0 if rotation is None else (4 - int(rotation) // 90) % 4
    out_shape = (h, w) if k % 2 == 0 else (w, h)
    return out_shape, _ROT90_INVERSE[k](h, w)


def zoom_output_width(w, zoom):
    """scipy.ndimage.zoom output length for one axis."""
    return int(round(w * zoom))


# ---------------------------------------------------------------------------
# scipy's rotation in float64
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rotation_table(device):
    """(cos, sin) of each whole degree in [0, 180] on `device`, float64:
    the values `ndimage.rotate` builds its matrix from (special.cosdg and
    sindg, exact at 0, 90 and 180 degrees)."""
    deg = np.arange(181.0)
    return (torch.as_tensor(special.cosdg(deg), dtype=F64, device=device),
            torch.as_tensor(special.sindg(deg), dtype=F64, device=device))


@functools.lru_cache(maxsize=None)
def _menu_table(menu, device):
    """(2, len(menu)) int64 heights and widths of a crop-shape menu (a
    tuple of (hb, wb)) on `device`, copied there once: a copy from
    pageable memory waits for the stream, which a CUDA graph's capture may
    not do."""
    return torch.as_tensor(np.asarray(menu, np.int64).T, device=device)


@functools.lru_cache(maxsize=None)
def _angle_table(device):
    """(cos, sin) of each whole degree in [0, 180], as find_rotation_angle
    computes them (np.cos of np.deg2rad), float64 on `device`."""
    t = np.deg2rad(np.arange(181.0))
    return (torch.as_tensor(np.cos(t), dtype=F64, device=device),
            torch.as_tensor(np.sin(t), dtype=F64, device=device))


def _fma(a, b, c):
    """a * b + c with one rounding, from float64 operations (Dekker's exact
    product and Knuth's exact sum): numpy computes the 2x2 matrix products
    of `ndimage.rotate`'s centre this way (its BLAS kernel fuses them)."""
    p = a * b
    split = 134217729.0                     # 2**27 + 1
    ta, tb = split * a, split * b
    ah, bh = ta - (ta - a), tb - (tb - b)
    al, bl = a - ah, b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    v = s - p
    return s + (((p - (s - v)) + (c - v)) + err)


def rotate_geometry(angle, h, w):
    """`ndimage.rotate(reshape=True)`'s geometry for whole-degree `angle`s
    (integer tensors, 0 the identity) of (h, w) planes: (cos, sin, out_h,
    out_w, off_y, off_x), float64 where scipy's are, with the input
    coordinate of output (y, x) = [[cos, sin], [-sin, cos]] @ (y, x) +
    (off_y, off_x)."""
    cos_t, sin_t = _rotation_table(angle.device)
    c, s = cos_t[angle.long()], sin_t[angle.long()]
    hf, wf = h.to(F64), w.to(F64)
    zero = torch.zeros_like(hf)
    # the box of the rotated corners (0, 0), (0, w), (h, 0), (h, w)
    ys = torch.stack([zero, s * wf, c * hf, c * hf + s * wf])
    xs = torch.stack([zero, c * wf, -s * hf, -s * hf + c * wf])
    out_h = torch.floor(ys.amax(0) - ys.amin(0) + 0.5).long()
    out_w = torch.floor(xs.amax(0) - xs.amin(0) + 0.5).long()
    a, b = (out_h - 1).to(F64) / 2, (out_w - 1).to(F64) / 2
    off_y = (hf - 1) / 2 - _fma(c, a, s * b)
    off_x = (wf - 1) / 2 - _fma(-s, a, c * b)
    return c, s, out_h, out_w, off_y, off_x


def _source_coords(c, s, off_y, off_x, qy, qx):
    """scipy's geometric transform: the offset, plus each output
    coordinate times its matrix entry, in that order."""
    return (off_y + qy * c) + qx * s, (off_x + qy * -s) + qx * c


# ---------------------------------------------------------------------------
# Device gathers
# ---------------------------------------------------------------------------


def paragraph_crops(mono, labels, page, label, y0, x0, h, w, angle, ry0,
                    rx0, out_h, out_w, py, px, out_hb, out_wb):
    """Deskewed paragraph crops as one gather from the chunk's maps.

    mono (N, H, W) float32 maps; labels (N, H, W) integer component
    labels of the paragraph masks; the rest (B,) integer columns of the
    plans (PARAGRAPH_FIELDS): the paragraph's page, its label, its box
    (y0, x0, h, w), its deskew angle in degrees, the box of its rotated
    mask (ry0, rx0, out_h, out_w) and the crop's place (py, px) in the
    (out_hb, out_wb) bucket (make_divisible_by's centre pad).

    Equal to the host cascade's crop: (map * mask)[box] through
    `ndimage.rotate(order=1)` (float64 inside, float32 out), cut to the
    order-0 rotated mask's box.  Returns (B, out_hb, out_wb, 1) float32,
    zero outside the crop."""
    dev = mono.device
    B = page.shape[0]
    N, H, W = mono.shape

    def col(v):
        return v.to(torch.int64).reshape(B, 1, 1)

    c, s, _, _, oy, ox = (t.reshape(B, 1, 1) for t in
                          rotate_geometry(angle, h, w))
    i = torch.arange(out_hb, device=dev).reshape(1, -1, 1)
    j = torch.arange(out_wb, device=dev).reshape(1, 1, -1)
    pyc, pxc = col(py), col(px)
    cy, cx = _source_coords(c, s, oy, ox, (i - pyc + col(ry0)).to(F64),
                            (j - pxc + col(rx0)).to(F64))
    hc, wc = col(h), col(w)
    inside = ((cy >= 0) & (cy <= (hc - 1).to(F64)) & (cx >= 0)
              & (cx <= (wc - 1).to(F64)) & (i >= pyc)
              & (i < pyc + col(out_h)) & (j >= pxc) & (j < pxc + col(out_w)))
    fy, fx = torch.floor(cy), torch.floor(cx)
    ty, tx = cy - fy, cx - fx
    yi, xi = fy.to(torch.int64), fx.to(torch.int64)
    src, lab = mono.reshape(-1), labels.reshape(-1)
    base = (col(page) * H + col(y0)) * W + col(x0)
    lb = col(label)

    def tap(dy, dx):
        # clamped taps carry zero weight wherever the coordinate is inside
        yy = torch.minimum(torch.clamp(yi + dy, min=0), hc - 1)
        xx = torch.minimum(torch.clamp(xi + dx, min=0), wc - 1)
        at = base + yy * W + xx
        return torch.where(lab[at] == lb, src[at].to(F64), 0.0)

    wy, wx = 1.0 - ty, 1.0 - tx
    t = tap(0, 0) * wy * wx
    t = t + tap(0, 1) * wy * tx
    t = t + tap(1, 0) * ty * wx
    t = t + tap(1, 1) * ty * tx
    return torch.where(inside, t, 0.0).to(torch.float32)[..., None]


def zoomed_line_crops(crop_stack, para_idx, lh, lw, w_out, a_yy, a_yx, b_y,
                      a_xy, a_xx, b_x, out_h, out_w):
    """Zoomed line crops as one nearest gather from the paragraph crops.

    Equal to the host's extract_line: the line's box, turned upright by
    np.rot90, through `ndimage.zoom(order=0)` to (out_h, w_out), zero
    columns from w_out on.  Returns (Bl, out_h, out_w, 1).

    crop_stack : (P, HB, WB, 1) float32 paragraph crops.
    para_idx   : (Bl,) source crop of each line.
    lh, lw     : (Bl,) the upright line's extent.
    w_out      : (Bl,) its zoomed width.
    a_*/b_*    : (Bl,) rot90-inverse affine composed with the line box's
                 offset (maps upright coords to crop coords).
    out_h/out_w: the output bucket (32, a width-menu entry).
    """
    dev = crop_stack.device
    Bl = para_idx.shape[0]

    def col(v):
        return v.to(torch.int64).reshape(Bl, 1, 1)

    def axis(n_in, n_out, length, shape):
        # scipy: coordinate k * (n_in - 1) / (n_out - 1) in float64, the
        # nearest pixel floor(c + 0.5), zero past the input's last index
        ratio = torch.where(n_out > 1, (n_in - 1).to(F64)
                            / torch.clamp(n_out - 1, min=1).to(F64), 1.0)
        k = torch.arange(length, dtype=F64, device=dev).reshape(shape)
        coord = k * ratio
        return (torch.floor(coord + 0.5).to(torch.int64),
                coord <= (n_in - 1).to(F64))

    lh_c, lw_c, w_c = col(lh), col(lw), col(w_out)
    yr, y_ok = axis(lh_c, torch.full_like(lh_c, out_h), out_h, (1, -1, 1))
    xr, x_ok = axis(lw_c, w_c, out_w, (1, 1, -1))
    ys = col(a_yy) * yr + col(a_yx) * xr + col(b_y)
    xs = col(a_xy) * yr + col(a_xx) * xr + col(b_x)
    HB, WB = crop_stack.shape[1], crop_stack.shape[2]
    ys = torch.clamp(ys, 0, HB - 1)
    xs = torch.clamp(xs, 0, WB - 1)
    values = crop_stack[:, :, :, 0].reshape(-1)[(col(para_idx) * HB + ys)
                                                * WB + xs]
    cols = torch.arange(out_w, device=dev).reshape(1, 1, out_w)
    keep = y_ok & x_ok & (cols < w_c)
    return torch.where(keep, values, torch.zeros((), device=dev))[..., None]


def to_u8_steps(x):
    """round(x * 255) / 255 in float32, round half to even: the values the
    host cascade's uint8 transfers give its device stages."""
    return torch.round(x * 255.0) / 255.0


# ---------------------------------------------------------------------------
# Plan matrices: every stage launch carries its plans as ONE int32 matrix,
# sliced into columns on the device
# ---------------------------------------------------------------------------

#: column order of the paragraph-stage plan matrix
PARAGRAPH_FIELDS = ('page', 'label', 'y0', 'x0', 'h', 'w', 'angle', 'ry0',
                    'rx0', 'out_h', 'out_w', 'py', 'px', 'hv', 'wv')
#: column order of the line-stage plan matrix
LINE_FIELDS = ('para_idx', 'lh', 'lw', 'w_out', 'a_yy', 'a_yx', 'b_y',
               'a_xy', 'a_xx', 'b_x', 'w_valid')


def _unpack(plan, fields):
    return {name: plan[:, i] for i, name in enumerate(fields)}


def unpack_paragraph_plan(plan):
    """ONE (B, 15) int32 plan matrix -> per-field (B,) column dict."""
    return _unpack(plan, PARAGRAPH_FIELDS)


def unpack_line_plan(plan):
    """ONE (B, 11) int32 plan matrix -> per-field (B,) column dict."""
    return _unpack(plan, LINE_FIELDS)


def line_plan_fields(rotation, y0, y1, x0, x1, char_h=CHAR_INPUT_HEIGHT,
                     char_min_w=CHAR_FIXED_WIDTH):
    """A line's gather plan from its box in the paragraph crop and the
    text's rotation (LINE_FIELDS but para_idx), as extract_line crops it:
    {field: int}."""
    h_l, w_l = y1 - y0, x1 - x0
    (lh, lw), (a_yy, a_yx, b_y, a_xy, a_xx, b_x) = rot90_inverse_affine(
        rotation, h_l, w_l)
    w_out = zoom_output_width(lw, char_h / lh)
    return {'lh': lh, 'lw': lw, 'w_out': w_out, 'a_yy': a_yy, 'a_yx': a_yx,
            'b_y': b_y + y0, 'a_xy': a_xy, 'a_xx': a_xx, 'b_x': b_x + x0,
            'w_valid': max(w_out, char_min_w)}


# ---------------------------------------------------------------------------
# The paragraph stage
# ---------------------------------------------------------------------------


def paragraph_stage(params, mono, labels, plan, out_hb, out_wb,
                    precision=None):
    """Paragraph crops (paragraph_crops) + the masked Line forward on
    them in uint8 steps + the host cascade's band threshold.  Returns
    (crops (B, out_hb, out_wb, 1) float32, bands (B, out_hb, out_wb, 2)
    bool)."""
    iv = unpack_paragraph_plan(plan)
    crops = paragraph_crops(
        mono, labels, iv['page'], iv['label'], iv['y0'], iv['x0'], iv['h'],
        iv['w'], iv['angle'], iv['ry0'], iv['rx0'], iv['out_h'],
        iv['out_w'], iv['py'], iv['px'], out_hb, out_wb)
    pred = line_forward_masked(params, to_u8_steps(crops), iv['hv'],
                               iv['wv'], prefix='Line', precision=precision)
    return crops, band_threshold(pred, iv['hv'], iv['wv'])


# ---------------------------------------------------------------------------
# Device paragraph planner: the host planner's arithmetic on the card,
# where the mask already is
# ---------------------------------------------------------------------------

#: angles of the deskew search evaluated at once (bounds its memory)
ANGLE_BLOCK = 16


def page_labels(para_stack, k_max):
    """4-connected labels of (N, H, W) paragraph masks by the band_ccl
    kernel: ((N, H, W) int32 component ranks, -1 elsewhere; (N, k_max, 7)
    statistics; (N,) component counts)."""
    N, H, W = para_stack.shape
    full_h = torch.full((N,), H, dtype=torch.int32, device=para_stack.device)
    full_w = torch.full((N,), W, dtype=torch.int32, device=para_stack.device)
    stats, n_comp, labels = band_ccl(para_stack > 0, full_h, full_w, k_max,
                                     labels=True)
    return labels, stats, n_comp


def _deskew_degrees(labels, y0, x0, live, k_max):
    """find_rotation_angle of each component: the whole degree in [0, 180]
    of least height of y*cos - x*sin over each row's extreme pixels
    (bbox-local, float64), 0 within a degree of level.  (B, K) int64."""
    B, H, W = labels.shape
    K = k_max
    dev = labels.device
    flat = labels.reshape(B, H * W).to(torch.int64)
    slot = torch.where((flat >= 0) & (flat < K), flat, K)
    lin = torch.arange(H * W, device=dev)
    key = slot * H + lin // W
    xs = (lin % W).expand(B, -1)

    def row_extreme(init, reduce):
        out = torch.full((B, (K + 1) * H), init, dtype=torch.int64,
                         device=dev)
        out.scatter_reduce_(1, key, xs, reduce)
        return out.reshape(B, K + 1, H)[:, :K]

    xmin_r, xmax_r = row_extreme(W, 'amin'), row_extreme(-1, 'amax')
    rows = (xmax_r >= 0)[..., None]
    ysl = (torch.arange(H, device=dev) - y0[..., None]).to(F64)[..., None]
    xlo = (xmin_r - x0[..., None]).to(F64)[..., None]
    xhi = (xmax_r - x0[..., None]).to(F64)[..., None]
    cos_t, sin_t = _angle_table(dev)
    heights = []
    for a in range(0, 181, ANGLE_BLOCK):
        tc, ts = cos_t[a:a + ANGLE_BLOCK], sin_t[a:a + ANGLE_BLOCK]
        lo = ysl * tc - xlo * ts
        hi = ysl * tc - xhi * ts
        top = torch.maximum(torch.where(rows, lo, -np.inf).amax(dim=2),
                            torch.where(rows, hi, -np.inf).amax(dim=2))
        bottom = torch.minimum(torch.where(rows, lo, np.inf).amin(dim=2),
                               torch.where(rows, hi, np.inf).amin(dim=2))
        heights.append(top - bottom)
    degree = torch.argmin(torch.cat(heights, dim=2), dim=2)     # first
    level = (degree < 1) | (degree > 179) | ~live
    return torch.where(level, 0, degree)


def _rotated_mask_boxes(labels, k_max, y0, x0, h, w, angle):
    """The box (ry0, rx0, out_h, out_w) of each component's order-0
    rotated mask, `ndimage.rotate(mask, angle, order=0, reshape=True)`:
    an output pixel is set iff the input pixel nearest its coordinate
    (floor(c + 0.5), inside the input) is the component's.  Each
    component pixel's preimage is a unit square around R^T (p - off),
    which holds at most two whole coordinates a side, so four candidates
    a pixel find every set output pixel.  (B, K) int64 each."""
    B, H, W = labels.shape
    K = k_max
    dev = labels.device
    c, s, rh, rw, oy, ox = rotate_geometry(angle, h, w)
    flat = labels.reshape(B, H * W).to(torch.int64)
    member = (flat >= 0) & (flat < K)
    slot = torch.where(member, flat, K)

    def per_pixel(t):
        padded = torch.cat([t, t.new_zeros((B, 1))], dim=1)
        return torch.gather(padded, 1, slot)

    c, s, oy, ox, rh, rw = map(per_pixel, (c, s, oy, ox, rh, rw))
    lin = torch.arange(H * W, device=dev)
    yl = lin // W - per_pixel(y0)
    xl = lin % W - per_pixel(x0)
    hp, wp = per_pixel(h), per_pixel(w)
    dy, dx = yl.to(F64) - oy, xl.to(F64) - ox
    qy0 = torch.ceil(c * dy - s * dx - 0.7072)
    qx0 = torch.ceil(s * dy + c * dx - 0.7072)
    boxes = [torch.full((B, K + 1), init, dtype=torch.int64, device=dev)
             for init in (2 ** 40, -1, 2 ** 40, -1)]
    for a, b in ((0, 0), (0, 1), (1, 0), (1, 1)):
        qy, qx = qy0 + a, qx0 + b
        cy, cx = _source_coords(c, s, oy, ox, qy, qx)
        qy, qx = qy.to(torch.int64), qx.to(torch.int64)
        hit = (member & (qy >= 0) & (qy < rh) & (qx >= 0) & (qx < rw)
               & (cy >= 0) & (cy <= (hp - 1).to(F64)) & (cx >= 0)
               & (cx <= (wp - 1).to(F64))
               & (torch.floor(cy + 0.5).to(torch.int64) == yl)
               & (torch.floor(cx + 0.5).to(torch.int64) == xl))
        at = torch.where(hit, slot, K)
        for box, q, reduce in zip(boxes, (qy, qy, qx, qx),
                                  ('amin', 'amax', 'amin', 'amax')):
            box.scatter_reduce_(1, at, q, reduce)
    ymin, ymax, xmin, xmax = (b[:, :K] for b in boxes)
    hit = ymax >= 0
    ry0 = torch.where(hit, ymin, 0)
    rx0 = torch.where(hit, xmin, 0)
    return (ry0, rx0, torch.where(hit, ymax + 1 - ymin, 1),
            torch.where(hit, xmax + 1 - xmin, 1))


def _page_component_plans(labels, stats, n_comp, menu, k_max):
    """Paragraph-stage plan rows of each page from its labels.

    labels (B, H, W) component ranks, stats (B, K, 7) and n_comp (B,) of
    page_labels; menu: a tuple of (hb, wb) crop shapes.  Returns (plan
    (B, K, 15) int32 rows in PARAGRAPH_FIELDS order, menu_idx (B, K)
    int64 into `menu`, n_comp (B,)).

    The arithmetic of OCRPipeline._page_paragraph_plans: the component's
    box, find_rotation_angle's degree, the box of the order-0 rotated
    mask, make_divisible_by's centre pad to a multiple of 16 and
    pick_line_shape's menu entry, every field clamped to it.  Dead slots
    carry a 4x4 filler crop of no component (label -1)."""
    B = labels.shape[0]
    K = k_max
    dev = labels.device
    live = torch.arange(K, device=dev)[None, :] < n_comp[:, None]
    st = stats.to(torch.int64)
    y0, x0 = st[..., 3], st[..., 5]
    h = torch.clamp(st[..., 4] - y0, min=1)
    w = torch.clamp(st[..., 6] - x0, min=1)
    angle = _deskew_degrees(labels, y0, x0, live, K)
    ry0, rx0, out_h, out_w = _rotated_mask_boxes(labels, K, y0, x0, h, w,
                                                 angle)
    pad_h, pad_w = 16 - out_h % 16, 16 - out_w % 16
    hv, wv = out_h + pad_h, out_w + pad_w
    py, px = pad_h // 2, pad_w // 2
    menu_idx = torch.full_like(hv, len(menu) - 1)
    for mi in range(len(menu) - 1, -1, -1):
        mhb, mwb = menu[mi]
        menu_idx = torch.where((hv <= mhb) & (wv <= mwb), mi, menu_idx)
    hb, wb = _menu_table(tuple(map(tuple, menu)), dev)[:, menu_idx]
    out_h, hv = torch.minimum(out_h, hb), torch.minimum(hv, hb)
    out_w, wv = torch.minimum(out_w, wb), torch.minimum(wv, wb)
    filler = {'h': 4, 'w': 4, 'out_h': 4, 'out_w': 4, 'hv': 4, 'wv': 4,
              'label': -1}
    fields = {'page': torch.arange(B, device=dev)[:, None].expand(B, K),
              'label': torch.arange(K, device=dev).expand(B, K),
              'y0': y0, 'x0': x0, 'h': h, 'w': w, 'angle': angle,
              'ry0': ry0, 'rx0': rx0, 'out_h': out_h, 'out_w': out_w,
              'py': py, 'px': px, 'hv': hv, 'wv': wv}
    plan = torch.stack([torch.where(live, fields[k], filler.get(k, 0))
                        for k in PARAGRAPH_FIELDS], dim=2)
    return plan.to(torch.int32), menu_idx, n_comp


def device_page_plans(para2d, out_hb, out_wb, k_max=32):
    """Paragraph-stage plans of ONE page on the device (the single-page
    chain's planner): every component cropped in the (out_hb, out_wb)
    frame.  para2d (H, W) paragraph mask.  Returns (labels (H, W),
    plan (k_max, 15), n_comp, ok: False iff the components overflow
    k_max, where the caller must plan on the host)."""
    labels, stats, n_comp = page_labels(para2d[None], k_max)
    plan, _, n_comp = _page_component_plans(
        labels, stats, n_comp, ((out_hb, out_wb),), k_max)
    return labels[0], plan[0], n_comp[0], n_comp[0] <= k_max


def device_chunk_plans(para_stack, menu, k_max=48):
    """The device paragraph planner of a chunk.  para_stack (B, H, W)
    paragraph masks; menu: the crop-shape menu (line_shape_menu).
    Returns (labels (B, H, W), plans (B, k_max, 15), menu_idx (B, k_max),
    n_comp (B,)).  Pages with more than k_max components are the host
    planner's."""
    labels, stats, n_comp = page_labels(para_stack, k_max)
    plans, menu_idx, n_comp = _page_component_plans(labels, stats, n_comp,
                                                    menu, k_max)
    return labels, plans, menu_idx, n_comp
