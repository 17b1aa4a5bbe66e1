"""The port's device-cascade functions (univer_ocr_tpu_torch.models.
device_cascade and the line planner of its OCRPipeline) against their JAX
twins (univer_ocr_tpu.models.device_cascade, univer_ocr_tpu.models.
pipeline) on the same seeded float32 inputs, following
tests/test_device_cascade.py.

Bar: 1e-5 on every float output (the crops, the zoomed lines); the host
geometry (affines, plans, line plans) and the unpacked plan columns must
be equal.  The band masks are thresholds of float32 sums, so a pixel may
differ only where the JAX prediction lies within 1e-5 of its threshold.
The port moves masks as bytes where JAX bit-packs them: blobs go to JAX
packed and to the port as bytes, and masks are compared unpacked.

The tables mode (exact_bands=False, sampler 'twopass'): the two-pass
crops at 1e-6 against JAX under `jax.jit`, as its pipeline runs them
(tests/test_torch_band_tables.py says why), the tables payload equal byte for byte once the band masks
are (they may differ only where the prediction is within 1e-5 of its
threshold), and the host planners' plans and escalation decisions
equal."""

import functools
import json

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax
import jax.numpy as jnp

from univer_ocr_tpu.models import device_cascade as jdc
from univer_ocr_tpu.models.pipeline import OCRPipeline as JaxPipeline
from univer_ocr_tpu_torch.interpreter import (
    _mask_centers, crop_and_rotate_single_paragraph, find_rotation_angle,
    label_layer, rotate_array)
from univer_ocr_tpu_torch.models import device_cascade as tdc
from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT, params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
PAGE_SHAPE = (1, 96, 128, 1)


@pytest.fixture(scope='module')
def params():
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    jax_params = {name: {k: jnp.asarray(np.asarray(v, np.float32))
                         for k, v in entry.items()}
                  for name, entry in weights.items()}
    return jax_params, params_from_numpy(weights, 'cpu')


@pytest.fixture(scope='module')
def pipelines():
    jax_pipeline = JaxPipeline(PAGE_SHAPE, chunk=1, workers=1,
                               device_cascade=True, exact_bands=True,
                               use_pallas=False)
    with OCRPipeline(PAGE_SHAPE, chunk=1, workers=1, device='cpu',
                     device_cascade=True, exact_bands=True) as port:
        yield jax_pipeline, port


def _blob(h, w, angle=0.0):
    """A filled rotated-rectangle blob inside an (h, w) page region."""
    mask = np.zeros((h, w), bool)
    mask[h // 4:3 * h // 4, w // 8:7 * w // 8] = True
    if angle:
        mask = ndimage.rotate(mask.astype(float), angle, order=0,
                              reshape=False) > 0.5
    return mask


def _i32(*vals):
    return [np.asarray([v], np.int32) for v in vals]


def _f32(*vals):
    return [np.asarray([v], np.float32) for v in vals]


def _crop_args(blob, hb, wb, pad=(0, 0)):
    """Host geometry of one blob (the plan _page_paragraph_plans makes):
    the per-sample argument columns shared by both crop variants, after
    the page index."""
    ys, xs = np.nonzero(blob)
    y0, x0 = ys.min(), xs.min()
    h, w = ys.max() + 1 - y0, xs.max() + 1 - x0
    crop_mask = blob[y0:y0 + h, x0:x0 + w]
    angle = find_rotation_angle(crop_mask[None, :, :, None])
    _, (cos_a, sin_a), (off_y, off_x) = tdc.rotate_affine(angle, h, w)
    rotated = rotate_array(crop_mask[None, :, :, None].astype(np.uint8),
                           angle, good_rotation=False)
    _, ry, rx, _ = ndimage.find_objects(rotated)[0]
    out_h, out_w = ry.stop - ry.start, rx.stop - rx.start
    assert out_h + pad[0] <= hb and out_w + pad[1] <= wb, (out_h, out_w)
    buf = np.zeros((hb, wb), np.uint8)
    buf[:h, :w] = crop_mask
    args = (_i32(y0, x0, h, w) + _f32(cos_a, sin_a, off_y, off_x)
            + _i32(ry.start, rx.start, out_h, out_w, *pad))
    return buf, args, (out_h, out_w)


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_host_geometry_equals_jax():
    for angle in (None, 3.5, -3.5, 30.0, 88.0, 90.0, 133.7):
        for h, w in ((40, 90), (33, 17)):
            assert (tdc.rotate_affine(angle, h, w)
                    == jdc.rotate_affine(angle, h, w)), (angle, h, w)
    for rotation in (None, 90, 180, 270):
        assert (tdc.rot90_inverse_affine(rotation, 24, 86)
                == jdc.rot90_inverse_affine(rotation, 24, 86))
    for n, out in ((24, 32), (86, 115), (5, 1), (1, 1)):
        assert tdc.zoom_ratio(n, out) == jdc.zoom_ratio(n, out)
        assert (tdc.zoom_output_width(n, 32 / 24)
                == jdc.zoom_output_width(n, 32 / 24))


# level, small tilts either way, a steep one and one near 90 degrees
@pytest.mark.parametrize('angle', [0.0, 3.5, -3.5, 30.0, 88.0])
def test_rotated_paragraph_crops_match_jax(angle):
    rs = np.random.RandomState(int(abs(angle) * 10) + 1)
    pages = rs.rand(2, 96, 128, 1).astype(np.float32)
    blob = _blob(96, 128, angle)
    buf, args, (out_h, out_w) = _crop_args(blob, 160, 160, pad=(3, 5))
    page_idx = _i32(1)

    got = tdc.rotated_paragraph_crops(
        *_torch([pages, buf[None]] + page_idx + args)).numpy()
    exp = np.asarray(jdc.rotated_paragraph_crops(
        *_jax([pages, np.packbits(buf, axis=1)[None]] + page_idx + args)))
    assert got.shape == exp.shape == (1, 160, 160, 1)
    np.testing.assert_allclose(got, exp, **TOL)

    # and the host path it replaces: crop, blob mask, scipy rotate, slice
    host = crop_and_rotate_single_paragraph(blob[None, :, :, None],
                                            [pages[1:2]])[0][0, :, :, 0]
    assert host.shape == (out_h, out_w)
    np.testing.assert_allclose(got[0, 3:3 + out_h, 5:5 + out_w, 0], host,
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize('angle', [0.0, -3.5, 30.0])
def test_rotated_paragraph_crops_resident_match_jax(angle):
    rs = np.random.RandomState(7)
    pages = rs.rand(2, 96, 128, 1).astype(np.float32)
    para = np.zeros((2, 96, 128, 1), np.float32)
    blob = _blob(96, 128, angle)
    para[0, :, :, 0] = blob
    _, args, _ = _crop_args(blob, 160, 192, pad=(2, 7))
    page_idx = _i32(0)
    got = tdc.rotated_paragraph_crops_resident(
        *_torch([pages, para] + page_idx + args), 160, 192).numpy()
    exp = np.asarray(jdc.rotated_paragraph_crops_resident(
        *_jax([pages, para] + page_idx + args), 160, 192))
    np.testing.assert_allclose(got, exp, **TOL)


def test_identity_affine_gather_is_exact_crop():
    """Level paragraphs take the identity affine: integer sample
    coordinates make the bilinear weights exact, so the crop equals the
    masked bbox crop at the make_divisible_by placement bit for bit."""
    rs = np.random.RandomState(9)
    pages = rs.rand(2, 64, 96, 1).astype(np.float32)
    y0, x0, h, w = 10, 8, 30, 72
    py, px, hb, wb = 3, 5, 48, 96
    blob = np.zeros((1, hb, wb), np.uint8)
    blob[0, :h, :w] = 1
    blob[0, 4:9, 20:30] = 0                 # a hole the crop must keep
    got = tdc.rotated_paragraph_crops(*_torch(
        [pages, blob] + _i32(1, y0, x0, h, w) + _f32(1.0, 0.0, 0.0, 0.0)
        + _i32(0, 0, h, w, py, px))).numpy()
    ref = np.zeros((1, hb, wb, 1), np.float32)
    ref[0, py:py + h, px:px + w, 0] = (pages[1, y0:y0 + h, x0:x0 + w, 0]
                                       * blob[0, :h, :w])
    np.testing.assert_array_equal(got, ref)


def _line_args(rotation, crop_shape, ly, lx, wc=192):
    h_pre, w_pre = ly.stop - ly.start, lx.stop - lx.start
    (lh, lw), (ayy, ayx, by, axy, axx, bx) = tdc.rot90_inverse_affine(
        rotation, h_pre, w_pre)
    w_out = tdc.zoom_output_width(lw, 32.0 / lh)
    assert w_out <= wc
    cols = (_i32(crop_shape[0] - 1)
            + _f32(tdc.zoom_ratio(lh, 32), tdc.zoom_ratio(lw, w_out))
            + _i32(w_out, ayy, ayx, by + ly.start, axy, axx, bx + lx.start))
    return cols, w_out


@pytest.mark.parametrize('rotation', [None, 90, 180, 270])
def test_zoomed_line_crops_match_jax_and_host(rotation):
    rs = np.random.RandomState(3)
    crop = rs.rand(2, 80, 120, 1).astype(np.float32)
    ly, lx = slice(10, 34), slice(8, 110)
    cols, w_out = _line_args(rotation, crop.shape, ly, lx)
    got = tdc.zoomed_line_crops(*_torch([crop] + cols), 32, 192).numpy()
    exp = np.asarray(jdc.zoomed_line_crops(*_jax([crop] + cols), 32, 192))
    np.testing.assert_allclose(got, exp, **TOL)

    # the host path: bbox crop, rot90, nearest zoom
    img = rotate_array(crop[1:2, ly, lx, :], rotation)
    host = ndimage.zoom(img, (1, 32.0 / img.shape[1],
                              32.0 / img.shape[1], 1), order=0)
    assert host.shape == (1, 32, w_out, 1)
    np.testing.assert_array_equal(got[0, :, :w_out], host[0])
    assert np.all(got[0, :, w_out:] == 0)


@pytest.mark.parametrize('precision', ['highest', 'bf16'])
@pytest.mark.parametrize('rotation', [None, 90, 180, 270])
def test_zoomed_line_crops_equal_jax_one_hot_form(rotation, precision):
    """The gather equals the JAX line stage's one-hot form
    (`zoomed_line_crops_matmul`) bit for bit, with a line of each rot90
    parity in one launch; in 'bf16' that form rounds the crop to bfloat16
    first, which the port's Char forward does to the gathered values."""
    rs = np.random.RandomState(5)
    crop = rs.rand(2, 64, 96, 1).astype(np.float32)
    cols, _ = _line_args(rotation, crop.shape, slice(6, 30), slice(4, 90))
    other = 90 if rotation in (None, 180) else None
    cols2, _ = _line_args(other, crop.shape, slice(2, 20), slice(10, 60))
    cols = [np.concatenate([a, b]) for a, b in zip(cols, cols2)]
    got = tdc.zoomed_line_crops(*_torch([crop] + cols), 32, 192)
    if precision == 'bf16':
        got = got.to(torch.bfloat16).float()
    exp = np.asarray(jdc.zoomed_line_crops_matmul(
        *_jax([crop] + cols), 32, 192, precision=precision))
    np.testing.assert_array_equal(got.numpy(), exp)


#: JAX's paragraph-plan fields that only its labeled and fused stages
#: read (ROADMAP A5, A6)
TABLES_FIELDS = {'start_y', 'start_x'}


def test_plan_matrices_unpack_like_jax():
    """The same field values, packed in each package's column order,
    unpack to the same columns.  The port's paragraph plan leaves out
    the fields only the tables mode reads."""
    rs = np.random.RandomState(11)
    for port, jax in (
            ((tdc.PARAGRAPH_INT_FIELDS, tdc.PARAGRAPH_FLT_FIELDS,
              tdc.unpack_paragraph_plan),
             (jdc.PARAGRAPH_INT_FIELDS, jdc.PARAGRAPH_FLT_FIELDS,
              jdc.unpack_paragraph_plan)),
            ((tdc.LINE_INT_FIELDS, tdc.LINE_FLT_FIELDS, tdc.unpack_line_plan),
             (jdc.LINE_INT_FIELDS, jdc.LINE_FLT_FIELDS,
              jdc.unpack_line_plan))):
        assert port[0] == tuple(k for k in jax[0] if k not in TABLES_FIELDS)
        assert port[1] == jax[1]
        values = {k: float(rs.randint(-3, 1 << 20)) for k in jax[0]}
        values.update({k: float(np.float32(rs.randn())) for k in jax[1]})
        iv_t, fv_t = port[2](torch.tensor(
            [[values[k] for k in port[0] + port[1]]] * 3, dtype=torch.float32))
        iv_j, fv_j = jax[2](jnp.asarray(
            [[values[k] for k in jax[0] + jax[1]]] * 3, jnp.float32))
        for k in port[0]:
            np.testing.assert_array_equal(iv_t[k].numpy(), np.asarray(iv_j[k]))
        for k in port[1]:
            np.testing.assert_array_equal(fv_t[k].numpy(), np.asarray(fv_j[k]))


def _assert_bands_match(got, exp_fn, params_j, crops, hv, wv, precision):
    """Band masks equal, but where the JAX prediction is within 1e-5 of
    its threshold."""
    from univer_ocr_tpu.models.fastpath import _mask_hw, line_forward_masked
    pred = _mask_hw(line_forward_masked(params_j, jnp.asarray(crops),
                                        jnp.asarray(hv), jnp.asarray(wv),
                                        prefix='Line', precision=precision),
                    jnp.asarray(hv), jnp.asarray(wv))
    pred = np.asarray(pred)
    exp = exp_fn()
    assert got.shape == exp.shape
    for b in range(len(hv)):
        region = pred[b, :hv[b], :wv[b]]
        thr = 0.5 * (region.sum(axis=(0, 1)) / (hv[b] * wv[b])
                     + region.max(axis=(0, 1)))
        differ = got[b] != exp[b]
        near = np.abs(pred[b] - thr) < 1e-5
        assert not (differ & ~near).any(), b
    return exp


@pytest.mark.parametrize('precision', ['highest', 'bf16'])
def test_paragraph_stages_match_jax(params, precision):
    """Both paragraph-stage variants: crops at 1e-5, band masks equal but
    at threshold ties.  The pages are smoothed noise, so the Line model
    finds bands in them."""
    params_j, params_t = params
    rs = np.random.RandomState(13)
    pages = ndimage.uniform_filter(rs.rand(2, 96, 128, 1), (0, 5, 9, 0))
    pages = (pages > 0.5).astype(np.float32)
    hb, wb = 128, 160
    blob = _blob(96, 128, 3.5)
    buf, args, (out_h, out_w) = _crop_args(blob, hb, wb, pad=(2, 4))
    hv = np.asarray([out_h + 16 - out_h % 16], np.int32)
    wv = np.asarray([out_w + 16 - out_w % 16], np.int32)
    para = np.zeros((2, 96, 128, 1), np.float32)
    para[1, :, :, 0] = blob
    page_idx = _i32(1)
    cols = page_idx + args + [hv, wv]

    crops, bands = tdc.paragraph_stage(
        params_t, *_torch([pages, buf[None]] + cols), precision=precision)
    crops_j, packed_j = jdc.paragraph_stage(
        params_j, *_jax([pages, np.packbits(buf, axis=1)[None]] + cols),
        precision=precision, sampler='gather')
    np.testing.assert_allclose(crops.numpy(), np.asarray(crops_j), **TOL)
    assert bands.dtype == torch.uint8
    exp = _assert_bands_match(
        bands.numpy(), lambda: np.unpackbits(np.asarray(packed_j), axis=2),
        params_j, np.asarray(crops_j), hv, wv, precision)
    assert exp.sum() > 0

    crops_r, bands_r = tdc.paragraph_stage_rot_resident(
        params_t, *_torch([pages, para] + cols), hb, wb, precision=precision)
    crops_rj, packed_rj = jdc.paragraph_stage_rot_resident(
        params_j, *_jax([pages, para] + cols), hb, wb,
        precision=precision, sampler='gather')
    np.testing.assert_allclose(crops_r.numpy(), np.asarray(crops_rj), **TOL)
    _assert_bands_match(
        bands_r.numpy(), lambda: np.unpackbits(np.asarray(packed_rj), axis=2),
        params_j, np.asarray(crops_rj), hv, wv, precision)


def _band_pair(shape, lines, vertical=False, fragments=False):
    """Synthetic (H, W, 2) top/bottom band masks: each line a top bar
    over a bottom bar (or side by side, for rotated text), optionally
    broken into fragments."""
    bands = np.zeros(shape + (2,), bool)
    for k, (a, b, lo, hi) in enumerate(lines):
        for ch, off in ((0, 0), (1, 4)):
            if vertical:
                bands[lo:hi, a + off:b + off, ch] = True
            else:
                bands[a + off:b + off, lo:hi, ch] = True
            if fragments and k % 2 == 0:
                if vertical:
                    bands[(lo + hi) // 2:(lo + hi) // 2 + 3, :, ch] = False
                else:
                    bands[:, (lo + hi) // 2:(lo + hi) // 2 + 3, ch] = False
    return bands


@pytest.mark.parametrize('case', ['level', 'upside_down', 'vertical',
                                  'fragments', 'empty'])
def test_line_planner_equals_jax(pipelines, case):
    jax_pipeline, port = pipelines
    lines = [(6, 9, 10, 150), (22, 25, 12, 120), (38, 41, 8, 160)]
    bands = {
        'level': lambda: _band_pair((64, 176), lines),
        'upside_down': lambda: _band_pair((64, 176), lines)[::-1, ::-1,
                                                            ::-1],
        'vertical': lambda: _band_pair((176, 64), lines, vertical=True),
        'fragments': lambda: _band_pair((64, 176), lines, fragments=True),
        'empty': lambda: np.zeros((64, 176, 2), bool),
    }[case]()
    bands = np.ascontiguousarray(bands)
    got = port._plan_lines(bands)
    assert got == jax_pipeline._plan_lines(bands)
    assert (len(got) == 0) == (case == 'empty')
    # band statistics: centres bit-identical to the host path's
    for ch in range(2):
        boxes, centres = port._band_blob_stats(bands[:, :, ch])
        boxes_j, centres_j = jax_pipeline._band_blob_stats(bands[:, :, ch])
        assert boxes == boxes_j
        np.testing.assert_array_equal(centres, centres_j)
        masks = label_layer(bands[None, :, :, ch:ch + 1])
        if masks:
            np.testing.assert_array_equal(
                centres, np.asarray(_mask_centers(masks))[:, 1:3])


def test_paragraph_plans_equal_jax(pipelines):
    """Level and deskewed blobs, and a bbox that holds part of another
    component (its blob must be uploaded)."""
    jax_pipeline, port = pipelines
    para = np.zeros((96, 128), np.uint8)
    para[2:12, 8:120] = 1                                  # level
    tilted = _blob(96, 128, 12.0)
    para[tilted] = 1
    # a dot inside the tilted blob's bbox that does not touch it
    ys, xs = np.nonzero(tilted)
    free = ~ndimage.binary_dilation(tilted, iterations=2)
    free[:ys.min(), :] = free[ys.max():, :] = False
    free[:, :xs.min()] = free[:, xs.max():] = False
    y, x = np.argwhere(free)[0]
    para[y, x] = 1
    got = port._page_paragraph_plans(3, para)
    exp = jax_pipeline._page_paragraph_plans(3, para)
    assert len(got) == len(exp) >= 3
    assert any(p['rotated'] for p in got) and any(p['needs_blob']
                                                  for p in got)
    for g, e in zip(got, exp):
        g = dict(g)
        e = {k: v for k, v in e.items() if k not in TABLES_FIELDS}
        np.testing.assert_array_equal(np.packbits(g.pop('blob'), axis=1),
                                      e.pop('blob'))
        assert g == e


# ---------------------------------------------------------------------------
# The tables mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def tables_pipelines():
    jax_pipeline = JaxPipeline(PAGE_SHAPE, chunk=1, workers=1,
                               device_cascade=True, fused_tail=False,
                               use_pallas=False)
    with OCRPipeline(PAGE_SHAPE, chunk=1, workers=1, device='cpu',
                     device_cascade=True, fused_tail=False) as port:
        assert port.band_tables and port.sampler == 'twopass'
        yield jax_pipeline, port


@pytest.mark.parametrize('precision', ['highest', 'bf16'])
def test_paragraph_stages_tables_mode_match_jax(params, precision):
    """Both paragraph stages with tables=True and the two-pass sampler:
    the sheared crops at 1e-6, the band masks equal but at threshold
    ties, and the payload: the port's tables of JAX's bands equal JAX's
    payload byte for byte, and the port's payload is its tables of its
    own bands."""
    from univer_ocr_tpu_torch.models import band_tables as tbt
    params_j, params_t = params
    rs = np.random.RandomState(13)
    pages = ndimage.uniform_filter(rs.rand(2, 96, 128, 1), (0, 5, 9, 0))
    pages = (pages > 0.5).astype(np.float32)
    hb, wb = 128, 160
    blob = _blob(96, 128, 3.5)
    buf, args, (out_h, out_w) = _crop_args(blob, hb, wb, pad=(2, 4))
    hv = np.asarray([out_h + 16 - out_h % 16], np.int32)
    wv = np.asarray([out_w + 16 - out_w % 16], np.int32)
    para = np.zeros((2, 96, 128, 1), np.float32)
    para[1, :, :, 0] = blob
    cols = _i32(1) + args + [hv, wv]
    kwargs = dict(precision=precision, tables=True, sampler='twopass')

    def jitted(fn, *static, **kw):
        return jax.jit(functools.partial(fn, **kw), static_argnums=static)
    crop_fns = (
        (lambda: tdc.twopass_paragraph_crops(
            *_torch([pages, buf[None]] + cols[:-2]), precision=precision),
         lambda: jitted(jdc.twopass_paragraph_crops, precision=precision)(
            *_jax([pages, np.packbits(buf, axis=1)[None]] + cols[:-2]))),
        (lambda: tdc.twopass_paragraph_crops_resident(
            *_torch([pages, para] + cols[:-2]), hb, wb, precision=precision),
         lambda: jitted(jdc.twopass_paragraph_crops_resident, 17, 18,
                        precision=precision)(
            *_jax([pages, para] + cols[:-2]), hb, wb)))
    stages = (
        (lambda: tdc.paragraph_stage(
            params_t, *_torch([pages, buf[None]] + cols), **kwargs),
         lambda: jitted(jdc.paragraph_stage, **kwargs)(
            params_j, *_jax([pages, np.packbits(buf, axis=1)[None]] + cols))),
        (lambda: tdc.paragraph_stage_rot_resident(
            params_t, *_torch([pages, para] + cols), hb, wb, **kwargs),
         lambda: jitted(jdc.paragraph_stage_rot_resident, 20, 21,
                        **kwargs)(
            params_j, *_jax([pages, para] + cols), hb, wb)))
    for (crop_t, crop_j), (stage_t, stage_j) in zip(crop_fns, stages):
        crops_t, crops_j = crop_t(), np.asarray(crop_j())
        assert np.abs(crops_t.numpy() - crops_j).max() <= 1e-6
        sheared, payload = stage_t()
        sheared_j, payload_j = stage_j()
        bands = tdc._thresholded_bands(params_t, crops_t, _torch([hv])[0],
                                       _torch([wv])[0], precision=precision)
        bands_j = _assert_bands_match(
            bands.numpy(), lambda: np.asarray(jdc._thresholded_bands(
                params_j, jnp.asarray(crops_j), jnp.asarray(hv),
                jnp.asarray(wv), precision=precision)),
            params_j, crops_j, hv, wv, precision)
        assert bands_j.sum() > 0
        crops_of_j, *state_j = tbt.tables_state(
            torch.from_numpy(np.array(bands_j)),
            torch.from_numpy(np.array(crops_j)))
        np.testing.assert_array_equal(
            tbt.pack_tables_payload(*state_j).numpy(), np.asarray(payload_j))
        np.testing.assert_allclose(crops_of_j.numpy(), np.asarray(sheared_j),
                                   rtol=0, atol=1e-6)
        crops_of_t, *state_t = tbt.tables_state(bands, crops_t)
        assert torch.equal(tbt.pack_tables_payload(*state_t), payload)
        assert torch.equal(crops_of_t, sheared)


def test_paragraph_plans_twopass_equal_jax(tables_pipelines):
    """The analytic rotated bbox, the rot90-fold bucket rule and the shear
    margin: plans equal field for field, menus included, at angles on
    both sides of 45 degrees."""
    jax_pipeline, port = tables_pipelines
    page = np.zeros((96, 128), np.uint8)
    page[2:12, 8:120] = 1                                  # level
    for angle, where in ((12.0, (slice(10, 60), slice(0, 70))),
                         (80.0, (slice(40, 96), slice(60, 128)))):
        blob = _blob(50 if angle == 12.0 else 56, 70 if angle == 12.0 else 68,
                     angle)
        page[where][blob] = 1
    got = port._page_paragraph_plans(2, page)
    exp = jax_pipeline._page_paragraph_plans(2, page)
    assert len(got) == len(exp) >= 3
    assert sum(p['rotated'] for p in got) >= 2
    assert any(abs(p['sin']) > abs(p['cos']) for p in got)
    for g, e in zip(got, exp):
        g = dict(g)
        e = {k: v for k, v in e.items() if k not in TABLES_FIELDS}
        np.testing.assert_array_equal(np.packbits(g.pop('blob'), axis=1),
                                      e.pop('blob'))
        assert g == e
    for shape in ((30, 200), (100, 240), (120, 250), (300, 10)):
        for margin in (False, True):
            assert (port._line_menu_shape(*shape, shear_margin=margin)
                    == jax_pipeline._line_menu_shape(*shape,
                                                     shear_margin=margin))


def _tables_of(bands):
    from univer_ocr_tpu.models.device_cascade import band_blob_tables_host
    return band_blob_tables_host(bands)[:2]


@pytest.mark.parametrize('case', ['level', 'upside_down', 'vertical',
                                  'fragments', 'overflow'])
def test_table_planner_equals_jax(tables_pipelines, case):
    """_plan_lines_from_tables on each axis and on the one JAX's host
    planner chooses, _cross_axis_escalation, and the fragment-merging
    pairing on the masks' blobs."""
    jax_pipeline, port = tables_pipelines
    lines = [(6, 9, 10, 150), (22, 25, 12, 120), (38, 41, 8, 160)]
    if case == 'overflow':
        bands = np.zeros((220, 40, 2), bool)
        bands[::4, 4:36, 0] = True
        bands[1::4, 4:36, 1] = True
    else:
        bands = {
            'level': lambda: _band_pair((64, 176), lines),
            'upside_down': lambda: _band_pair((64, 176), lines)[::-1, ::-1,
                                                                ::-1],
            'vertical': lambda: _band_pair((176, 64), lines, vertical=True),
            'fragments': lambda: _band_pair((64, 176), lines,
                                            fragments=True),
        }[case]()
    bands = np.ascontiguousarray(bands)
    from univer_ocr_tpu.models.device_cascade import choose_stacking_axis_host
    tbl, nb = _tables_of(bands[None])
    chosen = int(choose_stacking_axis_host(tbl, nb)[0])
    got = port._plan_lines_from_tables(tbl[0], nb[0], chosen)
    assert got == jax_pipeline._plan_lines_from_tables(tbl[0], nb[0])
    assert len(got) > 0
    for axis in (0, 1):
        assert (port._plan_lines_from_tables(tbl[0], nb[0], axis)
                == jax_pipeline._plan_lines_from_tables(tbl[0], nb[0], axis))
        assert (port._cross_axis_escalation(tbl[0], nb[0], axis)
                == jax_pipeline._cross_axis_escalation(tbl[0], nb[0], axis))
    stats = [port._band_blob_stats(bands[:, :, c]) for c in (0, 1)]
    merged = port._plans_from_bboxes(*port._pair_lines(
        *stats[0], *stats[1], merge_fragments=True))
    assert merged == jax_pipeline._plan_lines(bands, merge_fragments=True)


def test_profile_planner_and_merge_equal_jax(tables_pipelines):
    """tests/test_band_tables.py's staggered lines: cross-axis escalation
    fires and the profile planner separates the two lines, as in JAX, in
    both view orientations; and the fragment merge of line bboxes."""
    from univer_ocr_tpu.models.device_cascade import suspect_profile_host
    jax_pipeline, port = tables_pipelines
    H, W = 64, 256
    bands = np.zeros((1, H, W, 2), bool)
    bands[0, 10:14, 4:100, 0] = True
    bands[0, 18:22, 4:100, 1] = True
    bands[0, 14:18, 150:250, 0] = True
    bands[0, 22:26, 150:250, 1] = True
    for axis, view in ((0, bands), (1, bands.transpose(0, 2, 1, 3))):
        hb, wb = (H, W) if axis == 0 else (W, H)
        _, prof = suspect_profile_host(
            bands if axis == 0 else np.ascontiguousarray(view))
        packed = np.packbits(prof[0].reshape(prof.shape[1], -1).astype(
            np.uint8), axis=1)
        got = port._plan_lines_from_profile(packed, axis, hb, wb)
        assert got == jax_pipeline._plan_lines_from_profile(packed, axis,
                                                            hb, wb)
        if axis == 0:
            assert len(got) == 2
    tbl, nb = _tables_of(bands)
    assert port._cross_axis_escalation(tbl[0], nb[0], 0)
    s = slice
    for bboxes, picks in (
            ([(s(10, 30), s(5, 60)), (s(10, 30), s(70, 120))], [0, 0]),
            ([(s(10, 30), s(5, 60)), (s(10, 30), s(70, 120))], [0, 1]),
            ([(s(10, 30), s(5, 60)), (s(40, 60), s(5, 60)),
              (s(12, 28), s(62, 90))], [1, 0, 1])):
        assert (port._merge_line_bboxes(bboxes, picks)
                == JaxPipeline._merge_line_bboxes(bboxes, picks, None))


@pytest.mark.parametrize('escalation', [True, False])
def test_launch_planner_escalates_like_jax(tables_pipelines, escalation):
    """One launch's payload holding a merge suspect (JAX's tables_state
    without the device resolve), side-by-side lines and a level paragraph: the
    port's launch planner takes JAX's planner for each paragraph (profile
    for the flagged ones when escalation is on, tables otherwise) and
    counts them as JAX's handle_launch does."""
    from concurrent.futures import Future
    jax_pipeline, port = tables_pipelines
    H, W = 96, 256
    bands = np.zeros((3, H, W, 2), bool)
    bands[0, 4:11, 5:60, 0] = True         # merge suspect: lines chained
    bands[0, 20:27, 5:60, 0] = True        # through a staggered bridge
    bands[0, 8:23, 80:140, 0] = True
    bands[0, 12:19, 5:60, 1] = True
    bands[0, 28:35, 5:60, 1] = True
    bands[0, 16:31, 80:140, 1] = True
    bands[1, 10:14, 4:100, 0] = True       # side by side
    bands[1, 18:22, 4:100, 1] = True
    bands[1, 14:18, 150:250, 0] = True
    bands[1, 22:26, 150:250, 1] = True
    bands[2, 10:16, 10:150, 0] = True      # level
    bands[2, 20:26, 10:150, 1] = True
    crops = np.zeros((3, H, W, 1), np.float32)
    _, *state = jdc.tables_state(bands, crops, margin=True,
                                 resolve_suspects=False)
    payload = np.asarray(jdc.pack_tables_payload(*state))
    fut = Future()
    fut.set_result(payload)
    plans = [{'menu': (H, W)}] * 3
    port.escalation = escalation
    port.escalation_stats = dict.fromkeys(port.escalation_stats, 0)
    try:
        flat = port._plan_launch_from_tables([0, 1, 2], plans, fut)
    finally:
        port.escalation = True
    tables, n_blobs, _, axes, suspects, profiles = (
        jdc.unpack_tables_payload(payload))
    assert list(suspects) == [True, False, False]
    expected, stats = [], {'paragraphs': 3, 'suspect': 0, 'cross_axis': 0}
    for bi in range(3):
        ax = int(axes[bi])
        escalate = bool(suspects[bi])
        if escalate:
            stats['suspect'] += 1
        elif jax_pipeline._cross_axis_escalation(tables[bi], n_blobs[bi], ax):
            stats['cross_axis'] += 1
            escalate = True
        if escalate and escalation:
            lps = jax_pipeline._plan_lines_from_profile(profiles[bi], ax,
                                                        H, W)
        else:
            lps = jax_pipeline._plan_lines_from_tables(tables[bi],
                                                       n_blobs[bi], ax)
        expected.extend((bi, lp) for lp in lps)
    assert stats == {'paragraphs': 3, 'suspect': 1, 'cross_axis': 1}
    assert port.escalation_stats == stats
    assert flat == expected
