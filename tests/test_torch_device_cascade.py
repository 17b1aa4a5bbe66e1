"""The port's device-cascade gathers (univer_ocr_tpu_torch.models.
device_cascade) against the host cascade's CPU resampling, which the plain
reference of benchmark/reference/cascade.py shares: scipy's rotation and
zoom, on seeded inputs.

Bars, all exact:
  * `rotate_geometry`: `ndimage.rotate(reshape=True)`'s output shape and
    offsets, bit for bit (float64; the offsets' 2x2 products rounded as
    numpy's matrix product rounds them);
  * `paragraph_crops`: `ndimage.rotate(map * mask, angle, axes=(1, 0),
    order=1, reshape=True)` cut to the box of the order-0 rotated mask,
    at every kind of angle (level, small, 45 degrees, 90 exactly, past
    90), and the host cascade's paragraph crops (`_crop_page`) on the
    fixture pages;
  * `_rotated_mask_boxes`: the box of scipy's order-0 rotation of the
    mask;
  * `zoomed_line_crops`: extract_line (np.rot90, `ndimage.zoom(order=0)`,
    the right pad), zero where scipy's coordinate passes the last index
    as scipy leaves it, and the host cascade's line crops on a fixture
    page."""

import json
from fractions import Fraction

import numpy as np
import pytest
import torch
from scipy import ndimage

from univer_ocr_tpu_torch.interpreter import (extract_line,
                                              plan_paragraph_lines,
                                              rotate_array)
from univer_ocr_tpu_torch.models import device_cascade as tdc
from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT, params_from_numpy

from test_torch_fixture import N_PAGES, PAGE_SHAPE, load_fixture

#: whole degrees of every kind: level, small tilts, 45, 90 exactly, past 90
ANGLES = [0, 1, 2, 3, 7, 15, 30, 45, 60, 75, 89, 90, 91, 105, 120, 135,
          150, 165, 179]
#: plane sizes of the geometry checks
SIZES = [(1, 1), (5, 7), (37, 211), (100, 300), (123, 77), (496, 736)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i(*vals):
    return [torch.tensor([v]) for v in vals]


def _scipy_geometry(angle, h, w):
    """ndimage.rotate's own arithmetic for the output shape and offset."""
    from scipy import special
    c, s = special.cosdg(angle), special.sindg(angle)
    rot = np.array([[c, s], [-s, c]])
    bounds = rot @ [[0, 0, h, h], [0, w, 0, w]]
    out = (np.ptp(bounds, axis=1) + 0.5).astype(int)
    offset = (np.array([h, w]) - 1) / 2 - rot @ ((out - 1) / 2)
    return tuple(out), tuple(offset)


def _blob(rs, h, w, angle=0):
    """A random blob filling its (h, w) box: a rectangle tilted by
    `angle`, with ragged edges."""
    mask = np.zeros((h, w), bool)
    mask[h // 5:4 * h // 5, w // 9:8 * w // 9] = True
    if angle:
        mask = ndimage.rotate(mask.astype(np.uint8), angle, order=0,
                              reshape=False) > 0
    mask &= rs.rand(h, w) > 0.03
    ys, xs = np.nonzero(mask)
    return mask[ys.min():ys.max() + 1, xs.min():xs.max() + 1]


def _mask_box(mask, angle):
    """(ry0, rx0, out_h, out_w) of scipy's order-0 rotation of the mask."""
    rot = rotate_array(mask[None, :, :, None].astype(np.uint8),
                       None if angle == 0 else angle, good_rotation=False)
    _, ry, rx, _ = ndimage.find_objects(rot)[0]
    return ry.start, rx.start, ry.stop - ry.start, rx.stop - rx.start


@pytest.mark.parametrize('angle', ANGLES[::2] + [90, 91])
def test_rotate_geometry_equals_scipy(angle):
    for h, w in SIZES:
        c, s, out_h, out_w, off_y, off_x = tdc.rotate_geometry(
            *_i(angle, h, w))
        (rh, rw), (oy, ox) = _scipy_geometry(angle, h, w)
        assert (int(out_h), int(out_w)) == (rh, rw), (angle, h, w)
        assert (float(off_y), float(off_x)) == (oy, ox), (angle, h, w)


def test_fma_rounds_once():
    """The emulated fused multiply-add: the exactly rounded a * b + c on
    the products of the rotation's centre, and on hard cases."""
    rs = np.random.RandomState(0)
    a = np.concatenate([rs.uniform(-1, 1, 500), [0.5, 1.0, 0.1, -0.3]])
    b = np.concatenate([rs.uniform(0, 400, 500), [3.0, 1e-17, 0.7, 1e8]])
    c = np.concatenate([rs.uniform(-200, 200, 500), [-1.5, 1.0, -0.07,
                                                     3e7]])
    got = tdc._fma(_t(a), _t(b), _t(c)).numpy()
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('angle', ANGLES)
def test_paragraph_crops_equal_scipy_rotate(angle):
    """One gather equals the host's rotation of the masked box, cut to
    the rotated mask's box and centre-padded in the bucket; pixels of
    another component inside the box are read as zero."""
    rs = np.random.RandomState(angle)
    blob = _blob(rs, 41, 97, angle=-angle % 40)
    h, w = blob.shape
    page = (rs.randint(0, 256, (1, 160, 200)) / 255.0).astype(np.float32)
    labels = np.full((1, 160, 200), -1, np.int32)
    y0, x0 = 30, 50
    labels[0, y0:y0 + h, x0:x0 + w] = np.where(blob, 3, 2)
    ry0, rx0, out_h, out_w = _mask_box(blob, angle)
    py, px = 5, 3
    got = tdc.paragraph_crops(
        _t(page), _t(labels), *_i(0, 3, y0, x0, h, w, angle, ry0, rx0,
                                  out_h, out_w, py, px), out_h + 12,
        out_w + 9)[0, :, :, 0].numpy()
    masked = page[0, y0:y0 + h, x0:x0 + w] * blob
    want = rotate_array(masked[None, :, :, None], None if angle == 0
                        else angle)[0, ry0:ry0 + out_h, rx0:rx0 + out_w, 0]
    assert want.dtype == np.float32
    np.testing.assert_array_equal(got[py:py + out_h, px:px + out_w], want)
    outside = np.ones(got.shape, bool)
    outside[py:py + out_h, px:px + out_w] = False
    assert not got[outside].any()


@pytest.mark.parametrize('angle', ANGLES)
def test_rotated_mask_boxes_equal_scipy(angle):
    """The four-candidate search finds the box of scipy's order-0
    rotation of each component, two components a page."""
    rs = np.random.RandomState(100 + angle)
    blobs = [_blob(rs, 23, 61, angle=5), _blob(rs, 50, 30, angle=-12)]
    labels = np.full((1, 120, 150), -1, np.int64)
    places = [(3, 4), (60, 90)]
    for k, (blob, (y, x)) in enumerate(zip(blobs, places)):
        labels[0, y:y + blob.shape[0], x:x + blob.shape[1]][blob] = k
    y0, x0, h, w = (torch.tensor([[v[i] for v in vals]]) for i, vals in
                    ((0, places), (1, places), (0, [b.shape for b in blobs]),
                     (1, [b.shape for b in blobs])))
    boxes = tdc._rotated_mask_boxes(_t(labels), 2, y0, x0, h, w,
                                    torch.full((1, 2), angle))
    for k, blob in enumerate(blobs):
        assert [int(b[0, k]) for b in boxes] == list(_mask_box(blob, angle))


def _line_plan_args(rotation, box, crop_shape):
    (y0, y1), (x0, x1) = box
    lp = tdc.line_plan_fields(rotation, y0, y1, x0, x1)
    return lp, [torch.tensor([0])] + [torch.tensor([lp[f]])
                                      for f in tdc.LINE_FIELDS[1:-1]]


@pytest.mark.parametrize('rotation', [None, 90, 180, 270])
def test_zoomed_line_crops_equal_extract_line(rotation):
    """Line boxes of many shapes: turned upright, zoomed to height 32 and
    right-padded to 8 as extract_line does, in one gather."""
    rs = np.random.RandomState(7 if rotation is None else rotation)
    crop = rs.rand(1, 80, 300, 1).astype(np.float32)
    for _ in range(12):
        h, w = rs.randint(1, 40), rs.randint(1, 250)
        y0, x0 = rs.randint(0, 80 - h + 1), rs.randint(0, 300 - w + 1)
        want = extract_line(crop, (slice(y0, y0 + h), slice(x0, x0 + w)),
                            rotation, 32, 8)[0, :, :, 0]
        lp, args = _line_plan_args(rotation, ((y0, y0 + h), (x0, x0 + w)),
                                   crop.shape)
        assert lp['w_valid'] == want.shape[1]
        got = tdc.zoomed_line_crops(_t(crop), *args, 32, 2048)[0, :, :, 0]
        np.testing.assert_array_equal(got[:, :want.shape[1]].numpy(), want)
        assert not got[:, want.shape[1]:].any()


def test_zoomed_line_crops_zero_past_the_last_index():
    """Where scipy's zoom coordinate of the last column passes the input's
    last index (a 24x248 box zooms to 331 columns, and 330 * 247 / 330
    rounds above 247), scipy reads zero, and so does the gather."""
    crop = np.random.RandomState(0).rand(1, 30, 260, 1).astype(np.float32)
    crop += 0.5
    want = extract_line(crop, (slice(0, 24), slice(0, 248)), None, 32, 8)
    assert want.shape[2] == 331 and not want[0, :, 330, 0].any()
    _, args = _line_plan_args(None, ((0, 24), (0, 248)), crop.shape)
    got = tdc.zoomed_line_crops(_t(crop), *args, 32, 512)[0, :, :331, 0]
    np.testing.assert_array_equal(got.numpy(), want[0, :, :, 0])


def test_plan_matrices_unpack():
    """Each plan matrix column is its field, by name."""
    rs = np.random.RandomState(0)
    for fields, unpack in ((tdc.PARAGRAPH_FIELDS, tdc.unpack_paragraph_plan),
                           (tdc.LINE_FIELDS, tdc.unpack_line_plan)):
        mat = rs.randint(-5, 1000, (6, len(fields))).astype(np.int32)
        cols = unpack(_t(mat))
        assert list(cols) == list(fields)
        for i, f in enumerate(fields):
            np.testing.assert_array_equal(cols[f].numpy(), mat[:, i])


def test_to_u8_steps_is_the_host_rounding():
    """round(x * 255) / 255 in float32, half to even: the host's uint8
    transfer and back."""
    x = np.concatenate([np.random.RandomState(0).rand(5000),
                        (np.arange(255) + 0.5) / 255.0]).astype(np.float32)
    want = np.round(x * np.float32(255.0)).astype(np.uint8).astype(
        np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(tdc.to_u8_steps(_t(x)).numpy(), want)


# ---------------------------------------------------------------------------
# Against the host cascade on the fixture pages
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def host_and_stage():
    """The host cascade's paragraph crops and band masks of each fixture
    page, beside the device paragraph stage's on the same maps:
    [(host crops, host bands, device crops, device bands, plans)]."""
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    params = params_from_numpy(weights, 'cpu')
    pages, _ = load_fixture()
    out = []
    with OCRPipeline(PAGE_SHAPE, weights=weights, chunk=1, workers=1,
                     device='cpu', device_cascade=True,
                     exact_bands=True) as pipeline:
        for page in pages:
            batch = pipeline._upload_pages([page[None, :, :, None]])
            m_u8, para = pipeline.front(batch)
            mono = m_u8.numpy().astype(np.float32) / 255.0
            host_crops = pipeline._crop_page(mono, para.numpy())
            host_bands = pipeline._run_line_batched(host_crops)
            labels = tdc.page_labels(para[..., 0], 48)[0]
            plans = pipeline._page_paragraph_plans(0, para[0, :, :, 0].numpy())
            crops, bands = [None] * len(plans), [None] * len(plans)
            # one launch a menu bucket, as the pipeline groups them
            for menu in {plan['menu'] for plan in plans}:
                sel = [k for k, plan in enumerate(plans)
                       if plan['menu'] == menu]
                mat = _t(np.asarray([[plans[k][f]
                                      for f in tdc.PARAGRAPH_FIELDS]
                                     for k in sel], np.int32))
                c, b = tdc.paragraph_stage(params, _t(mono[..., 0]), labels,
                                           mat, *menu, precision='highest')
                for i, k in enumerate(sel):
                    hv, wv = plans[k]['hv'], plans[k]['wv']
                    crops[k] = c[i, :hv, :wv, 0].numpy()
                    bands[k] = b[i, :hv, :wv].numpy()
            out.append((host_crops, host_bands, crops, bands, plans))
    return out


@pytest.mark.parametrize('page', range(N_PAGES))
def test_paragraph_stage_equals_host_cascade_crops(host_and_stage, page):
    """Every paragraph's crop (the deskewed, centre-padded box) and its
    band masks: the host cascade's, exactly."""
    host_crops, host_bands, crops, bands, plans = host_and_stage[page]
    assert len(crops) == len(host_crops) > 0
    assert any(plan['angle'] for plan in plans) or page != 0
    for k, (hc, hb, c, b) in enumerate(zip(host_crops, host_bands, crops,
                                           bands)):
        np.testing.assert_array_equal(c, hc[0, :, :, 0], err_msg=str(k))
        np.testing.assert_array_equal(b, hb[0] > 0, err_msg=str(k))


def test_line_crops_equal_host_cascade(host_and_stage):
    """Every line of the first fixture page, planned from its paragraph's
    band masks and gathered from the device crop: the host cascade's
    zoomed line crop, exactly."""
    host_crops, host_bands, crops, _, _ = host_and_stage[0]
    n_lines = 0
    for hc, hb, c in zip(host_crops, host_bands, crops):
        boxes, rotation = plan_paragraph_lines(hb, thresholded_input=True)
        for y, x in boxes:
            want = extract_line(hc, (y, x), rotation, 32, 8)[0, :, :, 0]
            lp, args = _line_plan_args(rotation,
                                       ((y.start, y.stop), (x.start, x.stop)),
                                       c.shape)
            got = tdc.zoomed_line_crops(_t(c[None, :, :, None]), *args, 32,
                                        2048)[0, :, :want.shape[1], 0]
            np.testing.assert_array_equal(got.numpy(), want)
            n_lines += 1
    assert n_lines > 10
