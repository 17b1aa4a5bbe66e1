"""Device-resident cascade, parity mode (univer_ocr_tpu/models/
device_cascade.py with `exact_bands=True` and the 'gather' sampler).

The monochrome map stays on the device for the whole cascade; the host
sees only masks and decides geometry, and the pixels it used to crop and
resample on the CPU are gathered on the device instead:

  * `rotated_paragraph_crops`: crop + blob mask + `ndimage.rotate(order=1)`
    + rotated-bbox slice as ONE bilinear gather from the page stack, with
    scipy's rotate convention computed per sample on the host
    (`rotate_affine`);
  * `zoomed_line_crops`: line-bbox crop + `np.rot90` +
    `ndimage.zoom(order=0)` + min-width pad as one nearest gather (the
    JAX package's line stage takes its one-hot matrix-product form,
    `zoomed_line_crops_matmul`, because gathers are slow on a TPU; the
    values are the same).

The serving sampler, 'twopass' (`twopass_paragraph_crops*`), resamples
the same crops in two 1D passes (an exact rot90 parity fold, an integer
bbox extraction, then one shear-and-scale pass per axis).  The JAX
package runs its extraction and its 2-tap blends as one-hot matrix
products on the MXU; here they are gathers, with the same values: the
extraction and the integer shifts are pure selection, and each output
sample is the same two products and their sum.

Both compose with the masked Line/Char forwards (fastpath.py) into the
stage functions `paragraph_stage*` and the pipeline's line stage.  In the
parity mode the paragraph stage returns the band masks, as one byte per
pixel where the JAX package bit-packs them (the bits are the same); in
the tables mode (band_tables.py) it returns the sheared crops and the
tables payload.

The device paragraph planners (`device_page_plans`, `device_chunk_plans`)
label the paragraph mask on the device (the page CCL: band_tables.
grid_ccl_labels with the row scans) and compute what the host planner
(OCRPipeline._page_paragraph_plans) computes for each component, so the
serving default pulls one small plan matrix instead of the mask.

The forwards' convolutions are full float32 in 'highest' only while TF32
is off: run the stages inside `ops.precision.backend_flags(precision)`
(OCRPipeline.ocr_pages holds it for every thread of the cascade).
"""

import functools

import numpy as np
import torch

from ..ops import precision as precision_policy
from .band_tables import (_CCL_BIG, _shear_span, grid_ccl_labels,
                          pack_tables_payload, tables_state)
from .deskew_table import COS_DEG, SIN_DEG
from .fastpath import _mask_hw, line_forward_masked

# ---------------------------------------------------------------------------
# Host-side geometry (scipy conventions, computed per sample)
# ---------------------------------------------------------------------------


def rotate_affine(angle_deg, in_h, in_w):
    """Output shape and output->input affine of
    `scipy.ndimage.rotate(angle, axes=(2, 1), reshape=True)` on an
    (in_h, in_w) plane: in = R @ out + offset."""
    if angle_deg is None:
        return (in_h, in_w), (1.0, 0.0), (0.0, 0.0)
    rad = np.deg2rad(angle_deg)
    cos_a, sin_a = float(np.cos(rad)), float(np.sin(rad))
    rot = np.array([[cos_a, sin_a], [-sin_a, cos_a]])
    corners = rot @ np.array([[0, 0, in_h, in_h], [0, in_w, 0, in_w]], float)
    out_shape = (np.ptp(corners, axis=1) + 0.5).astype(int)
    offset = ((np.array([in_h, in_w]) - 1) / 2.0
              - rot @ ((out_shape - 1) / 2.0))
    return ((int(out_shape[0]), int(out_shape[1])),
            (cos_a, sin_a), (float(offset[0]), float(offset[1])))


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


def zoom_ratio(in_len, out_len):
    """scipy's endpoint-aligned coordinate ratio (grid_mode=False)."""
    if out_len <= 1:
        return 0.0
    return (in_len - 1) / (out_len - 1)


# ---------------------------------------------------------------------------
# Device gathers
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """a * b + c with one rounding.  The JAX package's compiled programs
    evaluate a product whose only use is a sum this way (XLA's CPU
    backend contracts the pair into a fused multiply-add), so the
    resampler's coordinates take it at the same places: a floor of a
    coordinate moves with the rounding of its last ulp."""
    return torch.addcmul(c, a, torch.as_tensor(b, dtype=a.dtype,
                                               device=a.device))


@functools.lru_cache(maxsize=None)
def _deskew_tables(device):
    """(cos, sin) of the deskew grid's 181 degrees on `device`, the JAX
    package's float32 values (deskew_table.py)."""
    return (torch.tensor(COS_DEG, dtype=torch.float32, device=device),
            torch.tensor(SIN_DEG, dtype=torch.float32, device=device))


def _per_sample(v, n, dtype, device):
    return torch.as_tensor(v, device=device).to(dtype).reshape(n, 1, 1)


def _bilinear_crops(mono_stack, page_idx, src_y0, src_x0, src_h, src_w,
                    cos_a, sin_a, off_y, off_x, out_y0, out_x0, out_h,
                    out_w, pad_y, pad_x, out_hb, out_wb, blob=None,
                    para_stack=None):
    """The bilinear gather shared by both crop variants: the blob is read
    from `blob` (bbox-local, (B, HB, WB) bytes) or, when that is None,
    from `para_stack` at the page coordinates of the mono sample."""
    dev = mono_stack.device
    B, HB, WB = page_idx.shape[0], out_hb, out_wb

    def col(v, dtype=torch.float32):
        return _per_sample(v, B, dtype, dev)

    rows = torch.arange(HB, dtype=torch.float32, device=dev).reshape(1, HB, 1)
    cols = torch.arange(WB, dtype=torch.float32, device=dev).reshape(1, 1, WB)
    grid_y = rows + col(out_y0) - col(pad_y)
    grid_x = cols + col(out_x0) - col(pad_x)
    cos_c, sin_c = col(cos_a), col(sin_a)
    in_y = cos_c * grid_y + sin_c * grid_x + col(off_y)
    in_x = -sin_c * grid_y + cos_c * grid_x + col(off_x)

    y_floor = torch.floor(in_y)
    x_floor = torch.floor(in_x)
    wy = in_y - y_floor
    wx = in_x - x_floor
    y_base = y_floor.to(torch.int64)
    x_base = x_floor.to(torch.int64)

    pages = mono_stack[:, :, :, 0].reshape(-1)
    page_h, page_w = mono_stack.shape[1], mono_stack.shape[2]
    page = col(page_idx, torch.int64)
    sy0, sx0 = col(src_y0, torch.int64), col(src_x0, torch.int64)
    sh, sw = col(src_h, torch.int64), col(src_w, torch.int64)

    # scipy mode='constant': a coordinate anywhere outside [0, size-1] is
    # entirely cval (no partial edge interpolation)
    in_domain = ((in_y >= 0) & (in_y <= col(src_h) - 1)
                 & (in_x >= 0) & (in_x <= col(src_w) - 1))
    if blob is not None:
        blob = blob.to(torch.float32).reshape(-1)
        b_idx = torch.arange(B, device=dev).reshape(B, 1, 1)
    else:
        paras = para_stack[:, :, :, 0].reshape(-1)

    def corner(dy, dx):
        # in-domain coords have all four corners within [0, size-1] after
        # clamping (the +1 corner only exceeds it with zero weight)
        yy = torch.clamp(torch.minimum(y_base + dy, sh - 1), min=0)
        xx = torch.clamp(torch.minimum(x_base + dx, sw - 1), min=0)
        yp = torch.clamp(sy0 + yy, 0, page_h - 1)
        xp = torch.clamp(sx0 + xx, 0, page_w - 1)
        at = (page * page_h + yp) * page_w + xp
        if blob is None:
            return pages[at] * paras[at]
        yb = torch.clamp(yy, 0, HB - 1)
        xb = torch.clamp(xx, 0, WB - 1)
        return pages[at] * blob[(b_idx * HB + yb) * WB + xb]

    top = corner(0, 0) * (1 - wx) + corner(0, 1) * wx
    bottom = corner(1, 0) * (1 - wx) + corner(1, 1) * wx
    value = top * (1 - wy) + bottom * wy

    out_rows = rows.to(torch.int64)
    out_cols = cols.to(torch.int64)
    py, px = col(pad_y, torch.int64), col(pad_x, torch.int64)
    in_slice = ((out_rows >= py) & (out_rows < py + col(out_h, torch.int64))
                & (out_cols >= px)
                & (out_cols < px + col(out_w, torch.int64)))
    return torch.where(in_domain & in_slice, value,
                       torch.zeros((), device=dev))[..., None]


def rotated_paragraph_crops(mono_stack, blob, page_idx,
                            src_y0, src_x0, src_h, src_w,
                            cos_a, sin_a, off_y, off_x,
                            out_y0, out_x0, out_h, out_w,
                            pad_y, pad_x):
    """Deskewed, blob-masked paragraph crops as one bilinear gather.

    Equivalent to crop_and_rotate_single_paragraph (interpreter.py) on the
    monochrome map: (mono * blob)[bbox] rotated by the deskew angle and
    sliced to the rotated-mask bbox, zero-padded into a (B, HB, WB, 1)
    bucket.

    mono_stack : (N, H, W, 1) float32 monochrome maps.
    blob       : (B, HB, WB) uint8 0/1: the paragraph blob mask of each
                 sample's bbox at (0, 0), zero-padded.
    page_idx   : (B,) page of each paragraph.
    src_*      : (B,) paragraph bbox (y0, x0, h, w) in page coords.
    cos/sin/off: (B,) float32 scipy rotate affine (out -> in, bbox-local).
    out_y0/x0  : (B,) rotated-mask bbox offset in the rotated grid.
    out_h/out_w: (B,) rotated-mask bbox extent; the output is zero beyond
                 it (bilinear support can bleed one pixel past the
                 order-0 mask bbox).
    pad_y/pad_x: (B,) placement of the content inside the bucket,
                 make_divisible_by's CENTER padding (the stride-2 Line
                 convs are phase sensitive).
    """
    return _bilinear_crops(mono_stack, page_idx, src_y0, src_x0, src_h,
                           src_w, cos_a, sin_a, off_y, off_x, out_y0,
                           out_x0, out_h, out_w, pad_y, pad_x,
                           blob.shape[1], blob.shape[2], blob=blob)


def rotated_paragraph_crops_resident(mono_stack, para_stack, page_idx,
                                     src_y0, src_x0, src_h, src_w,
                                     cos_a, sin_a, off_y, off_x,
                                     out_y0, out_x0, out_h, out_w,
                                     pad_y, pad_x, out_hb, out_wb):
    """rotated_paragraph_crops with the blob sampled from the device-
    resident paragraph mask (`para_stack`, (N, H, W, 1) float 0/1; for
    bboxes that hold one component only): the gather reads mono and mask
    at the same source coordinates."""
    return _bilinear_crops(mono_stack, page_idx, src_y0, src_x0, src_h,
                           src_w, cos_a, sin_a, off_y, off_x, out_y0,
                           out_x0, out_h, out_w, pad_y, pad_x, out_hb,
                           out_wb, para_stack=para_stack)


def zoomed_line_crops(crop_stack, para_idx,
                      ratio_y, ratio_x, w_out,
                      a_yy, a_yx, b_y, a_xy, a_xx, b_x,
                      out_h, out_w):
    """Zoomed line crops as one nearest gather from the paragraph crops.

    Equivalent to crop_lines_of_paragraph's per-line bbox crop + rot90
    orientation fix + ndimage.zoom(order=0) + zero min-width pad
    (pipeline.py), composed into one integer index map.  Returns
    (Bl, out_h, out_w, 1) with columns >= w_out zeroed.

    crop_stack : (P, HB, WB, 1) float32 paragraph crops.
    para_idx   : (Bl,) source crop of each line.
    ratio_y/x  : (Bl,) float32 scipy zoom coordinate ratios per axis.
    w_out      : (Bl,) true zoomed width of each line.
    a_*/b_*    : (Bl,) rot90-inverse affine composed with the line bbox
                 offset (maps post-rot90 coords to crop coords).
    out_h/out_w: the output bucket (32, a width-menu entry).
    """
    dev = crop_stack.device
    Bl = para_idx.shape[0]

    def col(v, dtype):
        return _per_sample(v, Bl, dtype, dev)

    grid_y = torch.arange(out_h, dtype=torch.float32,
                          device=dev).reshape(1, out_h, 1)
    grid_x = torch.arange(out_w, dtype=torch.float32,
                          device=dev).reshape(1, 1, out_w)
    # scipy zoom: in = out * ratio, spline order 0 rounds via floor(x+0.5)
    yr = torch.floor(grid_y * col(ratio_y, torch.float32) + 0.5).to(
        torch.int64)
    xr = torch.floor(grid_x * col(ratio_x, torch.float32) + 0.5).to(
        torch.int64)
    ys = (col(a_yy, torch.int64) * yr + col(a_yx, torch.int64) * xr
          + col(b_y, torch.int64))
    xs = (col(a_xy, torch.int64) * yr + col(a_xx, torch.int64) * xr
          + col(b_x, torch.int64))

    HB, WB = crop_stack.shape[1], crop_stack.shape[2]
    ys = torch.clamp(ys, 0, HB - 1)
    xs = torch.clamp(xs, 0, WB - 1)
    src = col(para_idx, torch.int64)
    values = crop_stack[:, :, :, 0].reshape(-1)[(src * HB + ys) * WB + xs]
    cols = torch.arange(out_w, device=dev).reshape(1, 1, out_w)
    values = torch.where(cols < col(w_out, torch.int64), values,
                         torch.zeros((), device=dev))
    return values[..., None]


# ---------------------------------------------------------------------------
# Packed plan matrices: every stage launch carries ~20 scalars per sample,
# packed into ONE float32 matrix (integer fields are below 2^24, exact in
# float32) and sliced into columns on the device
# ---------------------------------------------------------------------------

#: column order of the integer fields of the paragraph-stage plan matrix
PARAGRAPH_INT_FIELDS = ('page', 'y0', 'x0', 'h', 'w', 'ry0', 'rx0',
                        'out_h', 'out_w', 'py', 'px', 'hv', 'wv')
#: column order of its float fields, after the integer ones
PARAGRAPH_FLT_FIELDS = ('cos', 'sin', 'off_y', 'off_x')
#: column order of the integer fields of the line-stage plan matrix
LINE_INT_FIELDS = ('para_idx', 'w_out', 'a_yy', 'a_yx', 'b_y',
                   'a_xy', 'a_xx', 'b_x', 'w_valid')
#: column order of its float fields, after the integer ones
LINE_FLT_FIELDS = ('ratio_y', 'ratio_x')


def _unpack(plan, int_fields, flt_fields):
    ni = len(int_fields)
    ints = plan[:, :ni].to(torch.int32)
    iv = {name: ints[:, i] for i, name in enumerate(int_fields)}
    fv = {name: plan[:, ni + i] for i, name in enumerate(flt_fields)}
    return iv, fv


def unpack_paragraph_plan(plan):
    """ONE (B, 17) float32 plan matrix -> per-field (B,) column dicts
    (integer fields cast back exactly)."""
    return _unpack(plan, PARAGRAPH_INT_FIELDS, PARAGRAPH_FLT_FIELDS)


def unpack_line_plan(plan):
    """ONE (B, 11) float32 plan matrix -> per-field (B,) column dicts."""
    return _unpack(plan, LINE_INT_FIELDS, LINE_FLT_FIELDS)




# ---------------------------------------------------------------------------
# Two-pass paragraph crops (the tables mode's sampler)
#
#   1. parity fold: angles in (45, 135) degrees sample the rot90'd source,
#      so the residual rotation has |cos| >= |sin|;
#   2. bbox extraction: an integer gather of the (folded) bbox;
#   3. rotation as two 1D passes (Catmull-Smith / Paeth): per line an
#      integer shift and a 2-tap fractional blend, then a 2-tap resample
#      at a shared scale.
#
# Level paragraphs (the identity affine) take integer positions and
# weights 0 and 1, so their crops equal the gather sampler's bit for bit.
# ---------------------------------------------------------------------------


def _log_shift_cols(padded, v, K):
    """out[b, i, x] = padded[b, i, x + v[b, i]] for x < K, as one gather;
    reads past the end repeat the last column."""
    last = padded.shape[2] - 1
    idx = torch.clamp(torch.arange(K, device=padded.device).reshape(1, 1, K)
                      + v[:, :, None], max=last)
    return torch.gather(padded, 2, idx)


def _affine_pass(src, scale, line_off, pos_off, S):
    """One resample pass: dst[b, i, j] = linear interpolation of
    src[b, i, .] at scale_b*j + line_off_b*(i - I//2) + pos_off_b, zero
    outside [0, K-1].  S bounds |line_off*(i - I//2)|.  In bfloat16 the
    blend rounds per operation and the resample rounds its float32 sum
    once, as the JAX package's bf16 elementwise blend and one-hot
    product do."""
    B, I, K = src.shape
    dev, dt = src.device, src.dtype
    i_rel = torch.arange(I, dtype=torch.float32, device=dev) - (I // 2)
    q = line_off[:, None] * i_rel[None, :]                        # (B, I)
    d = torch.floor(q)
    f = (q - d).to(dt)
    d = torch.clamp(d.to(torch.int64), -S, S)
    padded = torch.cat([src.new_zeros((B, I, 2 * S)), src,
                        src.new_zeros((B, I, 2 * S + 1))], dim=2)
    shifted = _log_shift_cols(padded, S + d, K + 2 * S + 1)
    # per-line fractional blend: blended[x] = src[x - S + q], zero-extended
    blended = (shifted[:, :, :K + 2 * S] * (1 - f)[:, :, None]
               + shifted[:, :, 1:] * f[:, :, None])
    pos0 = _fma(scale[:, None], torch.arange(K, dtype=torch.float32,
                                             device=dev)[None, :],
                pos_off[:, None])                                 # (B, J)
    x0 = torch.floor(pos0)
    w = (pos0 - x0).to(dt)
    xi = x0.to(torch.int64) + S
    N = K + 2 * S

    def tap(idx):
        inside = (idx >= 0) & (idx < N)
        got = torch.gather(blended, 2, torch.clamp(idx, 0, N - 1)[
            :, None, :].expand(B, I, K))
        return torch.where(inside[:, None, :], got, 0).to(torch.float32)

    out = (tap(xi) * (1 - w).to(torch.float32)[:, None, :]
           + tap(xi + 1) * w.to(torch.float32)[:, None, :])
    return out.to(dt)


def _twopass_crops(pages, blob, page_idx, src_y0, src_x0, src_h, src_w,
                   cos_a, sin_a, off_y, off_x, out_y0, out_x0,
                   out_h, out_w, pad_y, pad_x, out_hb, out_wb,
                   precision=None):
    """Core of both two-pass crop variants.

    pages: (N, HP, WP) float32 page planes, already paragraph-masked on
    the resident path; blob: (B, HB, WB) bbox-local 0/1 blob or None.
    Other arguments as rotated_paragraph_crops.  Returns (B, HB, WB, 1)
    float32.  In 'bf16' the page is rounded to bfloat16 first and each
    pass's result after it, as in the JAX package."""
    dev = pages.device
    B, HB, WB = page_idx.shape[0], out_hb, out_wb
    dt = (torch.bfloat16 if precision_policy.resolve(precision) == 'bf16'
          else torch.float32)
    HP, WP = pages.shape[1], pages.shape[2]
    flat = pages.to(dt).reshape(-1)

    def col(v, dtype=torch.int64):
        return _per_sample(v, B, dtype, dev)

    page, sy0, sx0 = col(page_idx), col(src_y0), col(src_x0)
    sh, sw = col(src_h), col(src_w)
    cos_v, sin_v = (torch.as_tensor(v, device=dev).to(torch.float32)
                    for v in (cos_a, sin_a))
    oy, ox = (torch.as_tensor(v, device=dev).to(torch.float32)
              for v in (off_y, off_x))

    # parity fold: sample the rot90'd source when |sin| > |cos|
    par = torch.abs(sin_v) > torch.abs(cos_v)
    c_r = torch.where(par, sin_v, cos_v)
    s_r = torch.where(par, -cos_v, sin_v)
    swf = sw.reshape(B).to(torch.float32)
    oy_r = torch.where(par, swf - 1.0 - ox, oy)
    ox_r = torch.where(par, oy, ox)

    zero = torch.zeros((), dtype=dt, device=dev)
    iH = torch.arange(HB, device=dev).reshape(1, HB, 1)
    iW = torch.arange(WB, device=dev).reshape(1, 1, WB)

    def take(ys, xs, valid):
        inside = valid & (ys >= 0) & (ys < HP) & (xs >= 0) & (xs < WP)
        at = ((page * HP + torch.clamp(ys, 0, HP - 1)) * WP
              + torch.clamp(xs, 0, WP - 1))
        return torch.where(inside, flat[at], zero)

    # parity 0: e0[i, j] = page[sy0 + i, sx0 + j]
    e0 = take(sy0 + iH, sx0 + iW, (iH < sh) & (iW < sw))
    # parity 1: e90[i, j] = page[sy0 + j, sx0 + sw - 1 - i], the rot90 of
    # the bbox crop
    e90 = take(sy0 + iW, sx0 + sw - 1 - iH, (iW < sh) & (iH < sw))
    if blob is not None:
        blob = blob.to(dt)
        e0 = e0 * blob
        # e90[i, j] takes the blob at (j, sw - 1 - i)
        bx = sw - 1 - iH
        inside = (iW < HB) & (iH < sw) & (bx < WB)
        at = ((torch.arange(B, device=dev).reshape(B, 1, 1) * HB
               + torch.clamp(iW, max=HB - 1)) * WB + torch.clamp(bx, 0, WB - 1))
        e90 = e90 * torch.where(inside, blob.reshape(-1)[at], zero)
    src = torch.where(par[:, None, None], e90, e0)

    gy0 = (torch.as_tensor(out_y0, device=dev).to(torch.float32)
           - torch.as_tensor(pad_y, device=dev).to(torch.float32))
    gx0 = (torch.as_tensor(out_x0, device=dev).to(torch.float32)
           - torch.as_tensor(pad_x, device=dev).to(torch.float32))

    # pass 1 (x): X'(y, g) = (1/c)(g + gx0) - (s/c) y + ox + (s/c) oy,
    # which composed with pass 2's rows lands on the affine's backward map
    inv_c = 1.0 / c_r
    t = s_r * inv_c                                               # |t| <= 1
    h_mid = _affine_pass(
        src, inv_c, -t,
        _fma(-t, HB // 2, _fma(t, oy_r, _fma(inv_c, gx0, ox_r))),
        HB - HB // 2 + 1)
    # pass 2 (y): Y(r, g) = c (r + gy0) + s (g + gx0) + oy, along the rows
    # of the transposed intermediate
    out_t = _affine_pass(
        h_mid.transpose(1, 2), c_r, s_r,
        _fma(s_r, WB // 2, _fma(c_r, gy0, s_r * gx0) + oy_r),
        int(np.ceil(0.70711 * (WB - WB // 2))) + 1)
    crops = out_t.transpose(1, 2).to(torch.float32)

    # domain and output-window masks from the original affine, the gather
    # sampler's expressions
    grid_y = iH.to(torch.float32) + gy0.reshape(B, 1, 1)
    grid_x = iW.to(torch.float32) + gx0.reshape(B, 1, 1)
    cos_c, sin_c = cos_v.reshape(B, 1, 1), sin_v.reshape(B, 1, 1)
    in_y = _fma(cos_c, grid_y, sin_c * grid_x) + oy.reshape(B, 1, 1)
    in_x = _fma(-sin_c, grid_y, cos_c * grid_x) + ox.reshape(B, 1, 1)
    shf = sh.to(torch.float32)
    in_domain = ((in_y >= 0) & (in_y <= shf - 1)
                 & (in_x >= 0) & (in_x <= swf.reshape(B, 1, 1) - 1))
    py, px = col(pad_y), col(pad_x)
    in_slice = ((iH >= py) & (iH < py + col(out_h))
                & (iW >= px) & (iW < px + col(out_w)))
    return torch.where(in_domain & in_slice, crops,
                       torch.zeros((), device=dev))[..., None]


def twopass_paragraph_crops(mono_stack, blob, page_idx,
                            src_y0, src_x0, src_h, src_w,
                            cos_a, sin_a, off_y, off_x,
                            out_y0, out_x0, out_h, out_w,
                            pad_y, pad_x, precision=None):
    """rotated_paragraph_crops by the two-pass sampler; blob (B, HB, WB)
    0/1 bytes."""
    return _twopass_crops(mono_stack[:, :, :, 0], blob, page_idx,
                          src_y0, src_x0, src_h, src_w, cos_a, sin_a,
                          off_y, off_x, out_y0, out_x0, out_h, out_w,
                          pad_y, pad_x, blob.shape[1], blob.shape[2],
                          precision=precision)


def twopass_paragraph_crops_resident(mono_stack, para_stack, page_idx,
                                     src_y0, src_x0, src_h, src_w,
                                     cos_a, sin_a, off_y, off_x,
                                     out_y0, out_x0, out_h, out_w,
                                     pad_y, pad_x, out_hb, out_wb,
                                     precision=None):
    """rotated_paragraph_crops_resident by the two-pass sampler: the
    paragraph mask multiplies the page before resampling, as the gather
    multiplies both at the same integer source coordinates."""
    masked = mono_stack[:, :, :, 0] * para_stack[:, :, :, 0]
    return _twopass_crops(masked, None, page_idx, src_y0, src_x0,
                          src_h, src_w, cos_a, sin_a, off_y, off_x,
                          out_y0, out_x0, out_h, out_w, pad_y, pad_x,
                          out_hb, out_wb, precision=precision)


# ---------------------------------------------------------------------------
# Stage functions
# ---------------------------------------------------------------------------


def _thresholded_bands(params, crops, h_valid, w_valid, precision=None):
    """Masked Line forward + the band threshold (arr > 0.5*(mean+max) over
    the valid region) -> (B, H, W, 2) bool band masks."""
    pred = line_forward_masked(params, crops, h_valid, w_valid,
                               prefix='Line', precision=precision)
    pred = _mask_hw(pred, h_valid, w_valid)
    hv = h_valid.reshape(-1, 1, 1, 1)
    wv = w_valid.reshape(-1, 1, 1, 1)
    rows = torch.arange(pred.shape[1], device=pred.device).reshape(
        1, -1, 1, 1)
    cols = torch.arange(pred.shape[2], device=pred.device).reshape(
        1, 1, -1, 1)
    valid = (rows < hv) & (cols < wv)
    mean = pred.sum(dim=(1, 2), keepdim=True) / (hv.float() * wv.float())
    peak = pred.amax(dim=(1, 2), keepdim=True)
    return (pred > 0.5 * (mean + peak)) & valid


def _finish_paragraph_stage(params, crops, h_valid, w_valid, precision=None,
                            tables=False, syncs=None):
    """Tail of both paragraph stages: Line forward and band threshold,
    then the band masks as uint8 0/1 (parity mode), or, with tables=True,
    the crops sheared by tables_state (with the shear margin of rotated
    crops, whose content starts at row 0) and ONE (B, NBYTES) uint8 tables
    payload (pack_tables_payload); `syncs` counts tables_state's host
    syncs."""
    bands = _thresholded_bands(params, crops, h_valid, w_valid,
                               precision=precision)
    if not tables:
        return crops, bands.to(torch.uint8)
    crops, *state = tables_state(bands, crops, syncs=syncs)
    return crops, pack_tables_payload(*state)


def extract_paragraph_crops(mono_stack, blob, page_idx,
                            src_y0, src_x0, src_h, src_w,
                            cos_a, sin_a, off_y, off_x,
                            out_y0, out_x0, out_h, out_w,
                            pad_y, pad_x, precision=None, sampler='gather'):
    """Paragraph crops with the blobs uploaded, by `sampler` ('gather' or
    'twopass')."""
    args = (page_idx, src_y0, src_x0, src_h, src_w, cos_a, sin_a,
            off_y, off_x, out_y0, out_x0, out_h, out_w, pad_y, pad_x)
    if sampler == 'twopass':
        return twopass_paragraph_crops(mono_stack, blob, *args,
                                       precision=precision)
    return rotated_paragraph_crops(mono_stack, blob, *args)


def extract_paragraph_crops_resident(mono_stack, para_stack, page_idx,
                                     src_y0, src_x0, src_h, src_w,
                                     cos_a, sin_a, off_y, off_x,
                                     out_y0, out_x0, out_h, out_w,
                                     pad_y, pad_x, out_hb, out_wb,
                                     precision=None, sampler='gather'):
    """Paragraph crops with the blobs read from the resident paragraph
    mask, by `sampler`."""
    args = (page_idx, src_y0, src_x0, src_h, src_w, cos_a, sin_a,
            off_y, off_x, out_y0, out_x0, out_h, out_w, pad_y, pad_x,
            out_hb, out_wb)
    if sampler == 'twopass':
        return twopass_paragraph_crops_resident(
            mono_stack, para_stack, *args, precision=precision)
    return rotated_paragraph_crops_resident(mono_stack, para_stack, *args)


def paragraph_stage(params, mono_stack, blob, page_idx,
                    src_y0, src_x0, src_h, src_w,
                    cos_a, sin_a, off_y, off_x, out_y0, out_x0,
                    out_h, out_w, pad_y, pad_x, h_valid, w_valid,
                    precision=None, tables=False, sampler='gather',
                    syncs=None):
    """Deskewed-paragraph stage with the blobs uploaded: crop resampling
    by `sampler` ('gather' or 'twopass') + masked Line forward + band
    threshold.  Returns (crops, band masks | tables payload)."""
    crops = extract_paragraph_crops(
        mono_stack, blob, page_idx, src_y0, src_x0, src_h, src_w, cos_a,
        sin_a, off_y, off_x, out_y0, out_x0, out_h, out_w, pad_y, pad_x,
        precision=precision, sampler=sampler)
    return _finish_paragraph_stage(params, crops, h_valid, w_valid,
                                   precision=precision, tables=tables,
                                   syncs=syncs)


def paragraph_stage_rot_resident(params, mono_stack, para_stack, page_idx,
                                 src_y0, src_x0, src_h, src_w,
                                 cos_a, sin_a, off_y, off_x,
                                 out_y0, out_x0, out_h, out_w,
                                 pad_y, pad_x, h_valid, w_valid,
                                 out_hb, out_wb, precision=None,
                                 tables=False, sampler='gather', syncs=None):
    """paragraph_stage without the blob upload (bboxes that hold one
    component): the blob is read from the resident paragraph mask."""
    crops = extract_paragraph_crops_resident(
        mono_stack, para_stack, page_idx, src_y0, src_x0, src_h, src_w,
        cos_a, sin_a, off_y, off_x, out_y0, out_x0, out_h, out_w, pad_y,
        pad_x, out_hb, out_wb, precision=precision, sampler=sampler)
    return _finish_paragraph_stage(params, crops, h_valid, w_valid,
                                   precision=precision, tables=tables,
                                   syncs=syncs)


# ---------------------------------------------------------------------------
# Device paragraph planner: the page CCL and _page_paragraph_plans' plan
# arithmetic ('twopass' branch) on the card, where the mask already is
# ---------------------------------------------------------------------------

#: sweep cap of the page CCL; hitting it flags the page for the host
#: planner
PAGE_CCL_MAX_ITERS = 96


@functools.lru_cache(maxsize=None)
def _menu_table(menu, device):
    """(hb, wb) columns of a crop-shape menu on `device`, copied once."""
    return torch.as_tensor(np.asarray(menu, np.int64).T, device=device)


def _page_component_plans(lab, menu, k_max):
    """Paragraph-stage plan rows of each page from its CCL labels.

    lab (B, H, W) int64 labels of grid_ccl_labels; menu: a tuple of
    (hb, wb) crop shapes.  Returns (roots (B, K) int64, the components'
    root labels in raster order, _CCL_BIG past the last; plan (B, K, 18)
    float32 rows: PARAGRAPH_INT_FIELDS, PARAGRAPH_FLT_FIELDS and the root
    label (-1 on dead slots); menu_idx (B, K) int64 into `menu`; n_comp
    (B,)).

    The field arithmetic of OCRPipeline._page_paragraph_plans (the
    'twopass' branch): the 1-degree deskew sweep of find_rotation_angle
    over each row's extreme pixels, rotate_affine's geometry, the
    analytic rotated bbox with its (|cos| + |sin|) / 2 margin, the centre
    pad to a multiple of 16, and _line_menu_shape's pick with the shear
    margin, every clamp to the chosen entry.  Dead slots carry a 4x4
    filler crop.  The JAX package builds a (K, H, W) membership tensor
    per page; here the bboxes and per-row extremes are integer
    scatter_reduces keyed by each label's rank among the roots."""
    B, H, W = lab.shape
    K = k_max
    dev = lab.device
    flat = lab.reshape(B, H * W)
    lin = torch.arange(H * W, device=dev)
    is_root = (flat == lin) & (flat < _CCL_BIG)
    n_comp = is_root.sum(dim=1)
    rank = torch.cumsum(is_root, dim=1) - 1
    roots = torch.full((B, K + 1), _CCL_BIG, dtype=torch.int64, device=dev)
    roots.scatter_(1, torch.where(is_root & (rank < K), rank, K),
                   lin.expand(B, -1))
    roots = roots[:, :K]
    live = roots < _CCL_BIG

    member = flat < _CCL_BIG
    slot = torch.gather(rank, 1, torch.where(member, flat, 0))
    slot = torch.where(member & (slot < K), slot, K)
    ys, xs = lin // W, lin % W
    key = slot * H + ys                                      # (slot, row)

    def row_extreme(init, reduce):
        out = torch.full((B, (K + 1) * H), init, dtype=torch.int64,
                         device=dev)
        out.scatter_reduce_(1, key, xs.expand(B, -1), reduce)
        return out.reshape(B, K + 1, H)[:, :K]

    xmin_r = row_extreme(W, 'amin')                          # (B, K, H)
    xmax_r = row_extreme(-1, 'amax')
    rows_any = xmax_r >= 0
    ih = torch.arange(H, device=dev)
    y0 = torch.where(rows_any, ih, H).amin(dim=2)
    y1 = torch.where(rows_any, ih, -1).amax(dim=2)
    x0 = xmin_r.amin(dim=2)
    x1 = xmax_r.amax(dim=2)
    h = torch.clamp(y1 - y0 + 1, min=1)
    w = torch.clamp(x1 - x0 + 1, min=1)
    hf, wf = h.to(torch.float32), w.to(torch.float32)

    # deskew angle: the height of y*cos - x*sin over each row's extreme
    # pixels (bbox-local) on a 1-degree grid over [0, 180]
    f32 = torch.float32
    ysl = (ih - y0[..., None]).to(f32)                       # (B, K, H)
    xlo = (xmin_r - x0[..., None]).to(f32)
    xhi = (xmax_r - x0[..., None]).to(f32)
    tc, ts = _deskew_tables(dev)
    big = 3.0e8
    vm = rows_any[..., None]

    def proj(x):
        return _fma(ysl[..., None], tc, -(x[..., None] * ts))  # (B, K, H, A)

    plo, phi = proj(xlo), proj(xhi)
    pmax = torch.maximum(torch.where(vm, plo, -big).amax(dim=2),
                         torch.where(vm, phi, -big).amax(dim=2))
    pmin = torch.minimum(torch.where(vm, plo, big).amin(dim=2),
                         torch.where(vm, phi, big).amin(dim=2))
    del plo, phi
    degree = torch.argmin(pmax - pmin, dim=2)                # first minimum
    level = (degree < 1) | (degree > 179)

    # rotate_affine: the geometry of scipy's rotate(angle, reshape=True)
    ca, sa = tc[degree], ts[degree]
    zero = torch.zeros_like(hf)
    cyc = torch.stack([zero, zero, hf, hf], dim=2)
    cxc = torch.stack([zero, wf, zero, wf], dim=2)
    py_c = _fma(ca[..., None], cyc, sa[..., None] * cxc)     # (B, K, 4)
    px_c = _fma(-sa[..., None], cyc, ca[..., None] * cxc)
    rh = torch.floor(py_c.amax(dim=2) - py_c.amin(dim=2) + 0.5).to(
        torch.int64)
    rw = torch.floor(px_c.amax(dim=2) - px_c.amin(dim=2) + 0.5).to(
        torch.int64)
    rhf, rwf = rh.to(f32), rw.to(f32)
    off_y = (hf - 1.0) / 2.0 - (ca * (rhf - 1.0) / 2.0
                                + sa * (rwf - 1.0) / 2.0)
    off_x = (wf - 1.0) / 2.0 - (-sa * (rhf - 1.0) / 2.0
                                + ca * (rwf - 1.0) / 2.0)

    # the rotated bbox of the extreme pixels, plus the sampling margin
    dy = ysl - off_y[..., None]
    dlo = xlo - off_x[..., None]
    dhi = xhi - off_x[..., None]
    c3, s3 = ca[..., None], sa[..., None]

    def extreme(lo, hi, fill, reduce):
        pick = torch.minimum if reduce == 'amin' else torch.maximum
        return pick(getattr(torch.where(rows_any, lo, fill), reduce)(dim=2),
                    getattr(torch.where(rows_any, hi, fill), reduce)(dim=2))

    py_lo, py_hi = _fma(c3, dy, -(s3 * dlo)), _fma(c3, dy, -(s3 * dhi))
    px_lo, px_hi = _fma(s3, dy, c3 * dlo), _fma(s3, dy, c3 * dhi)
    py_min = extreme(py_lo, py_hi, big, 'amin')
    py_max = extreme(py_lo, py_hi, -big, 'amax')
    px_min = extreme(px_lo, px_hi, big, 'amin')
    px_max = extreme(px_lo, px_hi, -big, 'amax')
    marg = (ca.abs() + sa.abs()) / 2.0
    ry0 = torch.clamp(torch.floor(py_min - marg), min=0.0).to(torch.int64)
    rx0 = torch.clamp(torch.floor(px_min - marg), min=0.0).to(torch.int64)
    ry1 = torch.minimum(torch.ceil(py_max + marg).to(torch.int64), rh - 1)
    rx1 = torch.minimum(torch.ceil(px_max + marg).to(torch.int64), rw - 1)
    out_h = ry1 - ry0 + 1
    out_w = rx1 - rx0 + 1

    # level paragraphs take the identity affine
    ca = torch.where(level, 1.0, ca)
    sa = torch.where(level, 0.0, sa)
    off_y = torch.where(level, 0.0, off_y)
    off_x = torch.where(level, 0.0, off_x)
    ry0 = torch.where(level, 0, ry0)
    rx0 = torch.where(level, 0, rx0)
    out_h = torch.where(level, h, out_h)
    out_w = torch.where(level, w, out_w)

    # make_divisible_by's centre pad, which always adds at least one
    pad_h = 16 - out_h % 16
    pad_w = 16 - out_w % 16
    hv, wv = out_h + pad_h, out_w + pad_w
    py, px = pad_h // 2, pad_w // 2

    # _line_menu_shape(shear_margin=True), and the clamps to its pick
    fold = sa.abs() > ca.abs()
    need_h = torch.maximum(torch.maximum(h, hv), torch.where(fold, w, 0))
    need_w = torch.maximum(torch.maximum(w, wv), torch.where(fold, h, 0))
    menu_idx = torch.full_like(need_h, len(menu) - 1)
    for mi in range(len(menu) - 1, -1, -1):
        mhb, mwb = menu[mi]
        fits = ((need_h + 2 * _shear_span(mwb) <= mhb)
                & (need_w + 2 * _shear_span(mhb) <= mwb))
        menu_idx = torch.where(fits, mi, menu_idx)
    hb_sel, wb_sel = _menu_table(tuple(menu), dev)[:, menu_idx]
    out_h = torch.minimum(out_h, hb_sel)
    hv = torch.minimum(hv, hb_sel)
    out_w = torch.minimum(out_w, wb_sel)
    wv = torch.minimum(wv, wb_sel)

    def pick(real, filler):
        return torch.where(live, real, filler).to(f32)

    fields = {
        'page': torch.arange(K, device=dev).expand(B, K).to(f32),
        'y0': pick(y0, 4), 'x0': pick(x0, 4), 'h': pick(h, 4),
        'w': pick(w, 4), 'ry0': pick(ry0, 0), 'rx0': pick(rx0, 0),
        'out_h': pick(out_h, 4), 'out_w': pick(out_w, 4),
        'py': pick(py, 0), 'px': pick(px, 0), 'hv': pick(hv, 4),
        'wv': pick(wv, 4), 'cos': pick(ca, 1.0), 'sin': pick(sa, 0.0),
        'off_y': pick(off_y, 0.0), 'off_x': pick(off_x, 0.0),
    }
    plan = torch.stack(
        [fields[k] for k in PARAGRAPH_INT_FIELDS + PARAGRAPH_FLT_FIELDS]
        + [pick(roots, -1)], dim=2)
    return roots, plan, menu_idx, n_comp


def _page_labels(para_stack, syncs=None):
    """Page CCL of (B, H, W) paragraph masks: grid_ccl_labels with the
    row scans, capped at PAGE_CCL_MAX_ITERS, its sweep blocks counted as
    syncs['page_ccl_block'].  Returns ((B, H, W) labels, converged)."""
    lab, _, converged = grid_ccl_labels(
        (para_stack > 0)[..., None], max_iters=PAGE_CCL_MAX_ITERS,
        syncs=syncs, column_scan=True)
    return lab[..., 0], converged


def device_page_plans(para2d, out_hb, out_wb, k_max=32, syncs=None):
    """Paragraph-stage plans of ONE page on the device (the single-page
    chain's planner): every component cropped in the (out_hb, out_wb)
    frame.  para2d (H, W) paragraph mask.  Returns (labels (H, W), roots
    (k_max,), plan (k_max, 17) float32 rows of PARAGRAPH_INT_FIELDS and
    PARAGRAPH_FLT_FIELDS, n_comp, ok: False iff the CCL hit its sweep cap
    or the components overflow k_max, where the caller must plan on the
    host).  'page' is the plan's slot: the chain crops each component
    from the page masked to it."""
    lab, converged = _page_labels(para2d[None], syncs=syncs)
    roots, plan, _, n_comp = _page_component_plans(
        lab, ((out_hb, out_wb),), k_max)
    ok = (n_comp[0] <= k_max) & converged
    return lab[0], roots[0], plan[0, :, :-1], n_comp[0], ok


def device_chunk_plans(para_stack, menu, k_max=48, syncs=None):
    """The device paragraph planner of a chunk.  para_stack (B, H, W)
    paragraph masks; menu: the crop-shape menu (line_shape_menu).
    Returns (labels (B, H, W), plans (B, k_max, 18) with the root label
    last, menu_idx (B, k_max), n_comp (B,), converged: a host bool).
    Pages with more than k_max components, or all of them when the CCL
    did not converge, are the host planner's."""
    lab, converged = _page_labels(para_stack, syncs=syncs)
    _, plans, menu_idx, n_comp = _page_component_plans(lab, menu, k_max)
    return lab, plans, menu_idx, n_comp, converged
