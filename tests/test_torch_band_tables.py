"""The port's tables mode (univer_ocr_tpu_torch.models.band_tables and the
two-pass sampler of its device_cascade) against the JAX package's
(univer_ocr_tpu.models.device_cascade), on seeded band masks from the
generators of tests/test_band_tables.py and tests/test_grid_ccl.py.

Bars:
  * integer and table fields (shears, blob tables, counts, suspects,
    profiles, labels, payload bytes): exactly equal.  The port's segment
    sums are integer and the JAX package's float32 sums of integers
    below 2^24, so both are exact; every float table field is one float32
    division (or product chain) done in the same order;
  * two-pass crops in 'highest': 1e-6 absolute (values in [0, 1]),
    against the JAX functions under `jax.jit`, as the JAX pipeline runs
    them: XLA's CPU backend contracts each product whose only use is a
    sum into a fused multiply-add, and the port takes an FMA at the same
    points of the sample positions (device_cascade._fma).  Each output is
    the same two products and their sum, but the JAX package sums them
    inside a one-hot matrix product; measured on the CPU: at most 1.2e-7
    (one float32 ulp at 1.0).  (Run op by op, the JAX functions round
    each product and differ from their jitted selves by up to 5.8e-6 at
    these shapes.);
  * at 0 degrees the two-pass crop equals the gather sampler's bit for
    bit, in both packages;
  * two-pass crops in 'bf16': equal to the JAX package's, jitted: both
    round the page, the blend and each pass's float32 sum to bfloat16 at
    the same points."""

import functools
from collections import Counter

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax
import jax.numpy as jnp

from univer_ocr_tpu.models import device_cascade as jdc
from univer_ocr_tpu_torch.models import band_tables as tbt
from univer_ocr_tpu_torch.models import device_cascade as tdc

from test_band_tables import _random_bands, _tilted_bands
from test_grid_ccl import _blocky

EIGHT = np.ones((3, 3), bool)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jit(fn, **static):
    """A JAX function compiled once per set of static arguments: eager
    dispatch compiles every op of these long programs on its own."""
    return jax.jit(functools.partial(fn, **static))


def _eq(got, exp):
    np.testing.assert_array_equal(_np(got), np.asarray(exp))


def _bands(case):
    """Band masks of each shape the tables must handle."""
    rs = np.random.RandomState(0)
    if case == 'clean':
        return _random_bands(rs, frag=False)
    if case == 'fragmented':
        bands = _random_bands(rs, frag=True)
        bands[1, :, :, 1] = False
        bands[2] |= rs.rand(*bands.shape[1:]) > 0.999
        return bands
    if case == 'tilted':
        return np.concatenate([_tilted_bands(0.04),
                               _tilted_bands(-0.03)[:, :, ::-1]])
    if case == 'vertical':
        return np.ascontiguousarray(
            _random_bands(rs, B=2, H=96, W=64, frag=True).transpose(
                0, 2, 1, 3))
    if case == 'overflow':
        # more row runs than the table holds
        bands = np.zeros((1, 4 * tbt.MAX_BAND_BLOBS + 16, 40, 2), bool)
        bands[0, ::4, 4:36, 0] = True
        bands[0, 1::4, 4:36, 1] = True
        return bands
    raise ValueError(case)


CASES = ['clean', 'fragmented', 'tilted', 'vertical', 'overflow']


def _group_occupancy(view):
    """The (B, L, G, C) column-group occupancy of a (B, L, E, C) bool view,
    as tables_state derives it from the group statistics."""
    return tbt._group_row_stats(_t(np.ascontiguousarray(view)))[0] > 0


def _both_axes(bands):
    """The port's both-axis blob tables, as the first lines of
    tables_state make them: (tables, n_blobs, shears), the JAX package's
    band_blob_tables with margin=True."""
    rows, cols = tbt._group_stats_both(_t(bands))
    t0, n0, s0, _, _ = tbt._axis_pack(rows, bands.shape[2])
    t1, n1, s1, _, _ = tbt._axis_pack(cols, bands.shape[1])
    return (torch.stack([t0, tbt._swap_yx(t1)], dim=1),
            torch.stack([n0, n1], dim=1), torch.stack([s0, s1], dim=1))


# ---------------------------------------------------------------------------
# Shear
# ---------------------------------------------------------------------------


def test_shear_constants_and_geometry_equal_jax():
    for name in ('MAX_BAND_BLOBS', 'CLOSE_RADIUS', 'PROFILE_ROW_DS',
                 'SHEAR_CANDIDATES', 'MAX_SHEAR', 'SHEAR_GROUPS',
                 'MERGE_MIN_ROWS', 'GRID_CCL_MAX_ITERS'):
        assert getattr(tbt, name) == getattr(jdc, name), name
    assert tbt._CCL_BIG == int(jdc._CCL_BIG)
    assert tbt.GRID_CCL_MAX_ITERS % tbt.GRID_CCL_BLOCK == 0
    _eq(tbt._shear_candidates(), jdc._shear_candidates())
    for extent in (1, 40, 64, 65, 96, 256, 512, 768):
        assert tbt._shear_span(extent) == jdc._shear_span(extent)
        G, gw, centers = tbt._group_centers(extent)
        Gj, gwj, centers_j = jdc._group_centers(extent)
        assert (G, gw) == (Gj, gwj)
        _eq(centers, centers_j)


@pytest.mark.parametrize('case', CASES)
def test_best_shear_equals_jax(case):
    """The sweep over the group occupancy tables_state scores, against
    the JAX package's _best_shear of the masks."""
    bands = _bands(case)
    for view in (bands, bands.transpose(0, 2, 1, 3)):
        prof = _group_occupancy(view).any(dim=3)
        _eq(tbt._best_shear_from_prof(prof, view.shape[2]),
            _jit(jdc._best_shear)(jnp.asarray(view)))


@pytest.mark.parametrize('dtype', ['bool', 'float32'])
@pytest.mark.parametrize('margin', [False, True])
def test_group_shifts_and_shear_rows_equal_jax(dtype, margin):
    """Every candidate slope (half-way roundings included) at two widths,
    on masks and on crops."""
    rs = np.random.RandomState(4)
    slopes = np.float32(tbt._shear_candidates())
    for W in (96, 256):
        _eq(tbt._group_shifts(_t(slopes), W),
            _jit(jdc._group_shifts, W=W)(jnp.asarray(slopes)))
        B = len(slopes)
        arr = (rs.rand(B, 40, W, 2) > 0.6 if dtype == 'bool'
               else rs.rand(B, 40, W, 1).astype(np.float32))
        S = tbt._shear_span(W)
        off = np.where(slopes != 0, S, 0).astype(np.int32) if margin else \
            np.zeros(B, np.int32)
        got = tbt._shear_rows(_t(arr), _t(slopes), _t(off))
        exp = _jit(jdc._shear_rows)(jnp.asarray(arr), jnp.asarray(slopes),
                                     jnp.asarray(off))
        _eq(got, exp)


def test_log_shifts_equal_jax():
    """Per-(b, column) row shifts and per-(b, row) column shifts over
    their whole range [0, padded extent - output extent]."""
    rs = np.random.RandomState(6)
    padded = rs.rand(3, 20, 5, 2).astype(np.float32)
    v = rs.randint(0, 5, (3, 5)).astype(np.int32)
    _eq(tbt._log_shift_rows(_t(padded), _t(v).long(), 16),
        jdc._log_shift_rows(jnp.asarray(padded), jnp.asarray(v), 16))
    cols = rs.rand(3, 6, 30).astype(np.float32)
    v = rs.randint(0, 7, (3, 6)).astype(np.int32)
    _eq(tdc._log_shift_cols(_t(cols), _t(v).long(), 24),
        jdc._log_shift_cols(jnp.asarray(cols), jnp.asarray(v), 24))


# ---------------------------------------------------------------------------
# Row statistics and blob tables
# ---------------------------------------------------------------------------


def test_close_runs_equal_jax():
    rs = np.random.RandomState(8)
    occ = rs.rand(3, 50, 4) > 0.5
    for radius in (0, 1, 2):
        _eq(tbt._close_runs(_t(occ), radius),
            jdc._close_runs(jnp.asarray(occ, jnp.float32), radius))


@pytest.mark.parametrize('case', CASES)
def test_group_stats_equal_jax(case):
    bands = _bands(case)
    rows, cols = tbt._group_stats_both(_t(bands))
    rows_j, cols_j = _jit(jdc._group_stats_both)(jnp.asarray(bands))
    for got, exp in zip(rows + cols, rows_j + cols_j):
        _eq(got, exp)
    for got, exp in zip(tbt._group_row_stats(_t(bands)) +
                        tbt._group_col_stats(_t(bands)), rows_j + cols_j):
        _eq(got, exp)


@pytest.mark.parametrize('transposed', [False, True])
@pytest.mark.parametrize('case', CASES)
def test_band_blob_tables_equal_jax(case, transposed):
    """Each case and its transpose (the other axis stacks the lines)."""
    bands = _bands(case)
    if transposed:
        bands = np.ascontiguousarray(bands.transpose(0, 2, 1, 3))
    got = _both_axes(bands)
    exp = _jit(jdc.band_blob_tables, margin=True)(jnp.asarray(bands))
    for g, e in zip(got, exp):
        _eq(g, e)
    if case == 'overflow':
        assert int(got[1].max()) > tbt.MAX_BAND_BLOBS
    else:
        assert int(got[1].max()) > 0


@pytest.mark.parametrize('case', CASES)
def test_axis_pack_equal_jax(case):
    """Table, counts, shear, suspect and closed profile of each axis, and
    the unsheared blob tables from the summed group statistics."""
    bands = _bands(case)
    for view in (bands, bands.transpose(0, 2, 1, 3)):
        stats = tbt._group_row_stats(_t(np.ascontiguousarray(view)))
        got = tbt._axis_pack(stats, view.shape[2])
        exp = _jit(jdc._axis_pack, margin=True)(jnp.asarray(view))
        for g, e in zip(got, exp):
            _eq(g, e)
    cnt, sumx, minx, maxx = tbt._group_row_stats(_t(bands))
    got = tbt._blob_tables_from_row_stats(
        cnt.sum(dim=2), sumx.sum(dim=2), minx.amin(dim=2), maxx.amax(dim=2),
        bands.shape[2], 1, tbt.MAX_BAND_BLOBS)
    exp = _jit(jdc._axis_blob_tables, close_radius=1,
               max_blobs=jdc.MAX_BAND_BLOBS)(jnp.asarray(bands))
    for g, e in zip(got, exp):
        _eq(g, e)


# ---------------------------------------------------------------------------
# Axis choice and suspects
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('case', CASES + ['wavy'])
def test_merge_suspect_and_axis_equal_jax(case):
    """_suspect_from_prof over the group occupancy tables_state feeds it,
    against the JAX package's merge_suspect and _suspect_profile of the
    masks; choose_stacking_axis against both of the JAX package's."""
    bands = (np.concatenate([_tilted_bands(0.04), _tilted_bands(0.0)])
             if case == 'wavy' else _bands(case))
    got = tbt._suspect_from_prof(_group_occupancy(bands))
    _eq(got[0], _jit(jdc.merge_suspect)(jnp.asarray(bands)))
    for g, e in zip(got, _jit(jdc._suspect_profile)(jnp.asarray(bands))):
        _eq(g, e)
    if case == 'wavy':
        assert bool(got[0][0])
    tables, n_blobs, _ = jdc.band_blob_tables_host(bands)
    axis = tbt.choose_stacking_axis(_t(tables), _t(n_blobs))
    _eq(axis, jdc.choose_stacking_axis(jnp.asarray(tables),
                                       jnp.asarray(n_blobs)))
    _eq(axis, jdc.choose_stacking_axis_host(tables, n_blobs))
    if case == 'vertical':
        assert _np(axis).all()


# ---------------------------------------------------------------------------
# Grid CCL
# ---------------------------------------------------------------------------


def _scipy_labels(occ):
    """The expected labels: each component's smallest linear index."""
    B, L, G, C = occ.shape
    want = np.full(occ.shape, tbt._CCL_BIG, np.int64)
    for b in range(B):
        for c in range(C):
            ref, cnt = ndimage.label(occ[b, :, :, c], structure=EIGHT)
            for blob in range(1, cnt + 1):
                cells = np.argwhere(ref == blob)
                want[b, cells[:, 0], cells[:, 1], c] = (
                    cells[:, 0] * G + cells[:, 1]).min()
    return want


@pytest.mark.parametrize('seed', [3, 4])
def test_grid_ccl_labels_match_scipy_and_jax(seed):
    rs = np.random.RandomState(seed)
    occ = _blocky(rs, 4, 48, 64, 2)
    labels, lin, converged = tbt.grid_ccl_labels(_t(occ))
    labels_j, lin_j, converged_j = _jit(jdc.grid_ccl_labels)(jnp.asarray(occ))
    assert converged and bool(converged_j)
    _eq(labels, _scipy_labels(occ))
    _eq(labels, labels_j)
    _eq(lin, lin_j)
    for reverse in (False, True):
        for axis in (1, 2):
            lab = np.where(occ, rs.randint(0, 1000, occ.shape), tbt._CCL_BIG)
            _eq(tbt._seg_cummin(_t(lab).long(), _t(occ), reverse, axis),
                _jit(jdc._seg_cummin, reverse=reverse, axis=axis)(
                    jnp.asarray(lab, jnp.int32), jnp.asarray(occ)))


def test_grid_ccl_unconverged_reports_false():
    """A serpentine corridor needs more sweeps than a cap of 4: not
    converged, as in JAX, with the same labels; the full cap converges."""
    L, G = 64, 64
    occ = np.zeros((1, L, G, 1), bool)
    occ[0, ::2, :, 0] = True
    for y in range(0, L - 1, 2):
        occ[0, y + 1, (G - 1) if (y // 2) % 2 == 0 else 0, 0] = True
    for cap in (1, 4, 12):
        labels, _, converged = tbt.grid_ccl_labels(_t(occ), max_iters=cap)
        labels_j, _, converged_j = _jit(jdc.grid_ccl_labels,
                                     max_iters=cap)(jnp.asarray(occ))
        assert not converged and not bool(converged_j)
        _eq(labels, labels_j)
    syncs = Counter()
    labels, _, converged = tbt.grid_ccl_labels(_t(occ), syncs=syncs)
    assert converged
    _eq(labels, _scipy_labels(occ))
    # one sync per block of sweeps
    assert 1 <= syncs['grid_ccl_block'] <= (
        tbt.GRID_CCL_MAX_ITERS // tbt.GRID_CCL_BLOCK)


def test_grid_ccl_tables_equal_jax():
    rs = np.random.RandomState(7)
    B, L, G, C = 5, 40, 64, 2
    prof = _blocky(rs, B, L, G, C, p=0.8, k=3)
    vh = np.array([80, 61, 40, 80, 33], np.int32)
    vw = np.full((B,), 640, np.int32)
    gw = np.array([10, 10, 12, 8, 10], np.int32)
    got = tbt.grid_ccl_tables(_t(prof), _t(vh), _t(vw), _t(gw))
    exp = _jit(jdc.grid_ccl_tables)(jnp.asarray(prof), jnp.asarray(vh),
                                     jnp.asarray(vw), jnp.asarray(gw))
    _eq(got[0], exp[0])
    _eq(got[1], exp[1])
    assert got[2] and bool(exp[2])
    # and the overflow: more components than slots
    t_small, n_small, _ = tbt.grid_ccl_tables(_t(prof), _t(vh), _t(vw),
                                              _t(gw), max_blobs=3)
    t_small_j, _, _ = _jit(jdc.grid_ccl_tables, max_blobs=3)(
        jnp.asarray(prof), jnp.asarray(vh), jnp.asarray(vw),
        jnp.asarray(gw))
    assert int(n_small.max()) > 3
    _eq(t_small, t_small_j)


# ---------------------------------------------------------------------------
# The tables state and its payload
# ---------------------------------------------------------------------------


def _suspect_bands():
    """tests/test_grid_ccl.py's merge-suspect paragraph (two lines chained
    through a staggered bridge) beside a level one, and a tilted pair."""
    B, H, W, C = 2, 96, 160, 2
    bands = np.zeros((B, H, W, C), bool)
    bands[0, 4:11, 5:60, 0] = True
    bands[0, 20:27, 5:60, 0] = True
    bands[0, 8:23, 80:140, 0] = True
    bands[0, 12:19, 5:60, 1] = True
    bands[0, 28:35, 5:60, 1] = True
    bands[0, 16:31, 80:140, 1] = True
    bands[1, 10:16, 10:150, 0] = True
    bands[1, 20:26, 10:150, 1] = True
    return bands


@pytest.mark.parametrize('flipped', [True, False])
@pytest.mark.parametrize('case', ['suspect', 'vertical', 'tilted'])
def test_tables_state_equal_jax(case, flipped):
    """Every output, with the suspects re-planned on the device, and the
    syncs it counts: one suspect check, and grid-CCL blocks only where a
    paragraph is suspect.  Each case also upside down."""
    rs = np.random.RandomState(12)
    bands = (_suspect_bands() if case == 'suspect'
             else np.ascontiguousarray(_bands(case)[:, :96, :160]))
    if case == 'vertical':
        bands = np.ascontiguousarray(_suspect_bands().transpose(0, 2, 1, 3))
    if flipped:
        bands = np.ascontiguousarray(bands[:, ::-1])
    crops = rs.rand(*bands.shape[:3], 1).astype(np.float32)
    syncs = Counter()
    got = tbt.tables_state(_t(bands), _t(crops), syncs=syncs)
    exp = _jit(jdc.tables_state, margin=True)(jnp.asarray(bands),
                                              jnp.asarray(crops))
    for name, g, e in zip(('crops', 'tbl', 'n_blobs', 'shears', 'axis',
                           'suspect', 'profile'), got, exp):
        np.testing.assert_array_equal(_np(g), np.asarray(e), err_msg=name)
    suspects_before = _np(_jit(
        jdc.tables_state, margin=True, resolve_suspects=False)(
        jnp.asarray(bands), jnp.asarray(crops))[5])
    if case != 'tilted':
        assert suspects_before[0]
    assert not _np(got[5]).any()
    assert syncs['suspect_check'] == 1
    assert (syncs['grid_ccl_block'] > 0) == bool(suspects_before.any())

    # the payload: the same bytes, and JAX's unpack reads the port's
    payload = tbt.pack_tables_payload(*got[1:])
    payload_j = _jit(jdc.pack_tables_payload)(*exp[1:])
    _eq(payload, payload_j)
    for g, e in zip(jdc.unpack_tables_payload(_np(payload)),
                    tbt.unpack_tables_payload(np.asarray(payload_j))):
        _eq(g, e)


def test_payload_roundtrip_through_jax_unpack():
    """Random fields: the port's packed bytes, unpacked by JAX's
    unpack_tables_payload, give back every field (pins the byte layout:
    little-endian float32 fields, then the big-endian packbits profile)."""
    rs = np.random.RandomState(5)
    B, L = 3, 96
    tbl = rs.rand(B, 2, tbt.MAX_BAND_BLOBS, 7, 2).astype(np.float32) * 500
    nb = rs.randint(0, 48, (B, 2, 2)).astype(np.int32)
    sh = ((rs.rand(B, 2) - 0.5) * 0.16).astype(np.float32)
    ax = rs.randint(0, 2, (B,)).astype(np.int32)
    sus = rs.rand(B) > 0.5
    bits = rs.rand(B, L, 128) > 0.5
    prof = tbt._packbits(_t(bits))
    _eq(prof, np.packbits(bits, axis=2))
    buf = tbt.pack_tables_payload(_t(tbl), _t(nb), _t(sh), _t(ax), _t(sus),
                                  prof)
    assert buf.dtype == torch.uint8
    for got, want in zip(jdc.unpack_tables_payload(_np(buf)),
                         (tbl, nb, sh, ax, sus, np.packbits(bits, axis=2))):
        _eq(got, want)


# ---------------------------------------------------------------------------
# The two-pass sampler
# ---------------------------------------------------------------------------


def _twopass_args(angle, h=40, w=60, y0=12, x0=20, hb=96, wb=128,
                  pad=(2, 3)):
    """One sample's plan columns (after the page index), as the planner
    makes them: the analytic rotated bbox of an (h, w) blob."""
    if angle:
        (rh, rw), (cos_a, sin_a), off = tdc.rotate_affine(angle, h, w)
        out_h, out_w = min(rh, hb - pad[0]), min(rw, wb - pad[1])
    else:
        (cos_a, sin_a), off, out_h, out_w = (1.0, 0.0), (0.0, 0.0), h, w
    i32 = [np.asarray([v], np.int32) for v in (y0, x0, h, w)]
    f32 = [np.asarray([v], np.float32) for v in (cos_a, sin_a) + off]
    tail = [np.asarray([v], np.int32) for v in (0, 0, out_h, out_w) + pad]
    return [np.asarray([0], np.int32)] + i32 + f32 + tail


def _pages(angle):
    rs = np.random.RandomState(int(abs(angle) * 10) + 3)
    mono = rs.rand(1, 96, 128, 1).astype(np.float32)
    para = (rs.rand(1, 96, 128, 1) > 0.3).astype(np.float32)
    return mono, para


ANGLES = [0.0, 3.5, -3.5, 30.0, 60.0, 88.0]


@pytest.mark.parametrize('angle', ANGLES)
def test_twopass_crops_match_jax(angle):
    """Both variants in 'highest' at 1e-6 against JAX's jitted ones (both
    rot90 parities: 60 and 88 degrees fold); at 0 degrees bit-equal to
    the gather sampler."""
    mono, para = _pages(angle)
    args = _twopass_args(angle)
    hb, wb = 96, 128
    got = tdc.twopass_paragraph_crops_resident(
        *map(_t, [mono, para] + args), hb, wb).numpy()
    exp = np.asarray(jax.jit(jdc.twopass_paragraph_crops_resident,
                             static_argnums=(17, 18))(
        *map(jnp.asarray, [mono, para] + args), hb, wb))
    assert np.abs(got - exp).max() <= 1e-6
    assert (got != 0).any()

    blob = np.zeros((1, hb, wb), np.uint8)
    blob[0, :40, :60] = np.random.RandomState(9).rand(40, 60) > 0.3
    got_b = tdc.twopass_paragraph_crops(
        *map(_t, [mono, blob] + args)).numpy()
    exp_b = np.asarray(jax.jit(jdc.twopass_paragraph_crops)(
        *map(jnp.asarray, [mono, np.packbits(blob, axis=2)] + args)))
    assert np.abs(got_b - exp_b).max() <= 1e-6
    if angle == 0.0:
        _eq(got, tdc.rotated_paragraph_crops_resident(
            *map(_t, [mono, para] + args), hb, wb))
        _eq(got_b, tdc.rotated_paragraph_crops(*map(_t, [mono, blob] + args)))


@pytest.mark.parametrize('angle', [0.0, -3.5, 60.0])
def test_twopass_crops_bf16_equal_jax(angle):
    mono, para = _pages(angle)
    args = _twopass_args(angle)
    got = tdc.twopass_paragraph_crops_resident(
        *map(_t, [mono, para] + args), 96, 128, precision='bf16').numpy()
    exp = np.asarray(jax.jit(functools.partial(
        jdc.twopass_paragraph_crops_resident, precision='bf16'),
        static_argnums=(17, 18))(
        *map(jnp.asarray, [mono, para] + args), 96, 128))
    _eq(got, exp)
