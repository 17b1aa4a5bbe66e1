"""The port's fused tail (univer_ocr_tpu_torch.models.fused_tail) against
the JAX package's (univer_ocr_tpu.models.fused_tail), function by
function, and the fused paragraph dispatch of the port's OCRPipeline.

Bars:
  * the flat run-length decode: glyph ids, counts and overflow flags
    exactly equal to JAX's scan and to the port's pred_ids_to_text;
  * the line planner and the cross-axis test: exactly equal (the same
    float32 operations in the same order; the compactions are selections
    in both packages);
  * fused_paragraph_tail on the same crops: the small payload byte for
    byte; the tables payload field for field, exactly, but for the
    centres of blobs whose coordinate sums pass 2^24 (JAX sums them in
    float32 one-hot products, which then round; the port sums integers,
    exactly): there within 1e-6 relative.  Such blobs lie on the axis
    not chosen (a level paragraph's whole band seen as one column run),
    whose centres no planner reads.  The sheared crops within 1.2e-7
    (the two-pass bar of tests/test_torch_band_tables.py; the shear is a
    selection, so they are in fact equal);
  * pipeline text on the fixture pages, against the JAX text stored in
    the fixture (tests/test_torch_fixture.py): exactly equal in
    'highest'; in 'bf16' within the flip budget of
    tests/test_torch_device_pipeline.py."""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from univer_ocr_tpu.models import device_cascade as jdc
from univer_ocr_tpu.models import fused_tail as jft
from univer_ocr_tpu_torch.interpreter import pred_ids_to_text
from univer_ocr_tpu_torch.models import band_tables as tbt
from univer_ocr_tpu_torch.models import fused_tail as tft
from univer_ocr_tpu_torch.models.device_cascade import (
    extract_paragraph_crops_resident, unpack_paragraph_plan)
from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
from univer_ocr_tpu_torch.primitives import CHARS, SIMILAR_CHARS_PAIRS_LIST
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT, params_from_numpy

from test_fused_tail import _random_run_ids, _synthetic_bands
from test_torch_device_pipeline import assert_within_flip_budget
from test_torch_fixture import PAGE_SHAPE, load_fixture


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, exp, msg=''):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(exp), err_msg=msg)


@pytest.fixture(scope='module')
def weights():
    with open(DEFAULT_CHECKPOINT) as fp:
        return json.load(fp)


@pytest.fixture(scope='module')
def pages():
    fixture_pages, _ = load_fixture()
    return [p[None, :, :, None] for p in fixture_pages]


def _port(weights, **kwargs):
    kwargs = dict(dict(chunk=2, workers=2, collapse_runs=4,
                       precision='highest', device='cpu',
                       device_cascade=True), **kwargs)
    return OCRPipeline(PAGE_SHAPE, weights=weights, **kwargs)


# ---------------------------------------------------------------------------
# The run-length decode
# ---------------------------------------------------------------------------


def _look_alike_rows(rs, B, W):
    """_random_run_ids rows (glyph runs, boundary noise, tab runs, invalid
    tails and holes), where a third of the runs repeat the previous run's
    look-alike or the same glyph, across short noise runs too."""
    partner = {}
    for a, b in SIMILAR_CHARS_PAIRS_LIST:
        partner[CHARS.index(a)] = CHARS.index(b)
        partner[CHARS.index(b)] = CHARS.index(a)
    ids = np.zeros((B, W), np.int32)
    valid = np.zeros((B, W), bool)
    for b in range(B):
        ids[b], valid[b] = _random_run_ids(rs, W)
        starts = np.flatnonzero(np.diff(ids[b], prepend=-1))
        prev = None
        for s, e in zip(starts, list(starts[1:]) + [W]):
            run = int(ids[b, s])
            if run and prev is not None and rs.rand() < 0.35:
                pick = rs.choice([partner.get(prev, prev), prev,
                                  rs.choice(list(partner))])
                ids[b, s:e] = pick
                run = int(pick)
            if run:
                prev = run
    return ids, valid


@pytest.mark.parametrize('min_run', [1, 2, 4])
def test_decode_equals_jax_and_host(min_run):
    rs = np.random.RandomState(min_run)
    ids, valid = _look_alike_rows(rs, 24, 320)
    glyphs, n, over = tft.decode_ids_device(_t(ids), _t(valid), min_run)
    exp = jax.jit(functools.partial(jft.decode_ids_device,
                                    min_run=min_run))(jnp.asarray(ids),
                                                      jnp.asarray(valid))
    _eq(glyphs, exp[0])
    _eq(n, exp[1])
    _eq(over, exp[2])
    collapse = True if min_run == 1 else min_run
    for b in range(ids.shape[0]):
        assert tft.glyphs_to_text(glyphs[b].numpy(), n[b]) == \
            pred_ids_to_text(ids[b], valid[b], collapse), b


def test_decode_overflow_flag_equals_jax():
    # 200 distinct 4-column runs: 200 glyphs > MAX_GLYPHS
    ids = np.repeat((np.arange(200) % 2) * 50 + np.arange(200) % 40 + 1,
                    4)[None, :].astype(np.int32)
    valid = np.ones(ids.shape, bool)
    got = tft.decode_ids_device(_t(ids), _t(valid), 4)
    exp = jft.decode_ids_device(jnp.asarray(ids), jnp.asarray(valid), 4)
    assert bool(got[2][0]) and int(got[1][0]) == tft.MAX_GLYPHS
    for g, e in zip(got, exp):
        _eq(g, e)


def test_look_alike_table_is_checked():
    """The decode is exact only where "equal or look-alike" is an
    equivalence: the committed table is (each glyph in one pair at most,
    its class shared with its partner), and a chain raises, naming it."""
    classes = tft._look_alike_classes()
    for a, b in SIMILAR_CHARS_PAIRS_LIST:
        assert classes[CHARS.index(a)] == classes[CHARS.index(b)]
    assert len(set(classes.tolist())) == len(CHARS) - len(
        SIMILAR_CHARS_PAIRS_LIST)
    np.testing.assert_array_equal(tft._similar_table(), jft._SIM)
    with pytest.raises(ValueError, match="'b'.*chain"):
        tft._look_alike_classes(CHARS, [('a', 'b'), ('b', 'c')])


# ---------------------------------------------------------------------------
# The line planner and the cross-axis test
# ---------------------------------------------------------------------------


def _random_tables(rs, B, M=48):
    """Random blob tables: integer bboxes, centres inside them, counts up
    to past the capacity, either axis."""
    tbl = np.zeros((B, 2, M, 7, 2), np.float32)
    y0 = rs.randint(0, 400, (B, 2, M, 2))
    x0 = rs.randint(0, 600, (B, 2, M, 2))
    y1 = y0 + rs.randint(1, 40, y0.shape)
    x1 = x0 + rs.randint(1, 300, x0.shape)
    tbl[:, :, :, 0] = rs.randint(1, 500, y0.shape)
    tbl[:, :, :, 1], tbl[:, :, :, 2] = y0, y1
    tbl[:, :, :, 3], tbl[:, :, :, 4] = x0, x1
    tbl[:, :, :, 5] = y0 + rs.rand(*y0.shape) * (y1 - y0)
    tbl[:, :, :, 6] = x0 + rs.rand(*x0.shape) * (x1 - x0)
    nb = rs.randint(0, 12, (B, 2, 2)).astype(np.int32)
    nb[0] = [[M + 3, M], [M, M + 1]]                    # over capacity
    nb[1, :, 1] = 0                                     # an empty channel
    return tbl, nb, rs.randint(0, 2, B).astype(np.int32)


def _band_tables(rotated):
    """JAX's tables and axes of tests/test_fused_tail.py's synthetic
    bands: paired stripes, level or transposed."""
    tbls, nbs, axes = [], [], []
    for seed in range(3):
        bands = _synthetic_bands(np.random.RandomState(seed),
                                 rotated=rotated)
        tbl, nb, _ = jax.jit(jdc.band_blob_tables)(jnp.asarray(bands))
        tbls.append(np.asarray(tbl)[0])
        nbs.append(np.asarray(nb)[0])
        axes.append(np.asarray(jdc.choose_stacking_axis(tbl, nb))[0])
    return np.stack(tbls), np.stack(nbs), np.asarray(axes, np.int32)


@pytest.mark.parametrize('case', ['level', 'rotated', 'random'])
def test_line_planner_and_cross_axis_equal_jax(case):
    if case == 'random':
        tbl, nb, axis = _random_tables(np.random.RandomState(3), 12)
    else:
        tbl, nb, axis = _band_tables(case == 'rotated')
    plans, n_lines, over = tft._plan_lines_single(_t(tbl), _t(nb), _t(axis))
    exp = jax.jit(jax.vmap(jft._plan_lines_single))(
        jnp.asarray(tbl), jnp.asarray(nb), jnp.asarray(axis))
    _eq(plans, exp[0])
    _eq(n_lines, exp[1])
    _eq(over, exp[2])
    assert int(n_lines.sum()) > 0
    if case == 'random':
        assert bool(over.any())
    else:
        assert not bool(over.any())
    if case == 'rotated':
        # the column axis: every line plan rotated by 90 or 270 degrees
        assert (plans[:, :, 3] == 0).all() and (plans[:, :, 4] != 0).any()
    cross = tft._cross_axis_single(_t(tbl), _t(nb), _t(axis))
    _eq(cross, jax.jit(jax.vmap(jft._cross_axis_single))(
        jnp.asarray(tbl), jnp.asarray(nb), jnp.asarray(axis)))


# ---------------------------------------------------------------------------
# The fused tail on the same crops
# ---------------------------------------------------------------------------


def test_fused_paragraph_tail_equals_jax(weights, pages):
    """One launch of paragraph crops of the first two fixture pages (the
    two-pass crops of the resident stage in their commonest menu shape): the
    port's tail and JAX's, with the plain Char head in both."""
    params = params_from_numpy(weights, 'cpu')
    jax_params = {name: {k: jnp.asarray(np.asarray(v, np.float32))
                         for k, v in entry.items()}
                  for name, entry in weights.items()}
    with _port(weights) as pipeline:
        mono, para = pipeline.front_resident(
            pipeline._upload_pages(pages[:2]))
        plans = [p for page in range(2)
                 for p in pipeline._page_paragraph_plans(
                     page, para[page, :, :, 0].numpy())]
        menus = [p['menu'] for p in plans]
        menu = max(set(menus), key=menus.count)
        sel = [p for p in plans if p['menu'] == menu]
        assert len(sel) >= 4
        mat = np.zeros((len(sel), 17), np.float32)
        fields = ('page', 'y0', 'x0', 'h', 'w', 'ry0', 'rx0', 'out_h',
                  'out_w', 'py', 'px', 'hv', 'wv', 'cos', 'sin', 'off_y',
                  'off_x')
        for i, plan in enumerate(sel):
            mat[i] = [plan[f] for f in fields]
        iv, fv = unpack_paragraph_plan(_t(mat))
        crops = extract_paragraph_crops_resident(
            mono, para.float(), iv['page'], iv['y0'], iv['x0'], iv['h'],
            iv['w'], fv['cos'], fv['sin'], fv['off_y'], fv['off_x'],
            iv['ry0'], iv['rx0'], iv['out_h'], iv['out_w'], iv['py'],
            iv['px'], *menu, sampler='twopass')
    hv, wv = iv['hv'], iv['wv']
    got = tft.fused_paragraph_tail(params, crops, hv, wv,
                                   precision='highest', min_run=4)
    exp = jax.jit(functools.partial(
        jft.fused_paragraph_tail, precision='highest', margin=True,
        min_run=4, char_head='xla'))(
        jax_params, jax_params, jnp.asarray(crops.numpy()),
        jnp.asarray(hv.numpy()), jnp.asarray(wv.numpy()))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(exp[0]), rtol=0,
                               atol=1.2e-7)
    _eq(got[1], exp[1], 'small payload')
    tables = tbt.unpack_tables_payload(got[2].numpy())
    tables_j = jdc.unpack_tables_payload(np.asarray(exp[2]))
    for name, g, e in zip(('n_blobs', 'shears', 'axis', 'suspect',
                           'profile'), tables[1:], tables_j[1:]):
        _eq(g, e, name)
    # the blob tables: exact but for the centres of blobs whose coordinate
    # sums pass 2^24, which JAX's float32 one-hot sums round (the port
    # sums integers); none of them is on the chosen axis
    tbl, tbl_j = tables[0], tables_j[0]
    _eq(tbl[:, :, :, :5], tbl_j[:, :, :, :5], 'table counts and bboxes')
    np.testing.assert_allclose(tbl, tbl_j, rtol=1e-6, atol=0)
    chosen = np.arange(len(sel)), tables[3]
    _eq(tbl[chosen], tbl_j[chosen], 'chosen-axis tables')
    texts, suspects = tft.unpack_fused_payload(got[1].numpy(), len(sel))
    assert sum(len(lines) for lines in texts) >= len(sel)
    assert not suspects.any()
    assert got[1].shape[0] == tft.fused_payload_nbytes(len(sel))


# ---------------------------------------------------------------------------
# The fused dispatch in the pipeline
# ---------------------------------------------------------------------------


def test_fused_tail_without_planner_matches_tables_text(weights, pages):
    """The fused tail on the host-planned dispatch gives the tables mode's
    text, as JAX's test_fused_pipeline_matches_classic holds: every
    paragraph decoded on the device (no suspect on these pages), one pull
    per wave of launches."""
    _, expected = load_fixture('tables_texts')
    with _port(weights) as pipeline:
        assert pipeline.fused_tail and pipeline._device_planner
        pipeline._device_planner = False
        got = pipeline.ocr_pages(pages[:2])
        stats = pipeline.escalation_stats
        tags = {tag for tag, *_ in pipeline.timeline}
    assert got == expected[:2]
    assert stats['paragraphs'] == sum(len(page) for page in got)
    assert stats['suspect'] == stats['capacity'] == 0
    assert 'chain_fallback' not in stats
    assert tags == set()                  # timers off: no timeline


def test_fused_overflow_escalates_to_tables_text(weights, pages,
                                                 monkeypatch):
    """With a pool of 2 lines and 8 glyphs a line, every launch overflows:
    the flagged paragraphs re-plan on the host from their tables, and the
    text is the tables mode's (host-planned dispatch) or the chain's (one
    page)."""
    _, tables_texts = load_fixture('tables_texts')
    _, chain_texts = load_fixture('chain_texts')
    monkeypatch.setattr(tft, 'LINE_POOL', 2)
    monkeypatch.setattr(tft, 'MAX_GLYPHS', 8)
    with _port(weights) as pipeline:
        pipeline._device_planner = False
        assert pipeline.ocr_pages(pages[:1]) == tables_texts[:1]
        stats = dict(pipeline.escalation_stats)
        pipeline._device_planner = True
        assert pipeline.ocr_pages(pages[:1]) == chain_texts[:1]
    assert stats['pool_of'] + stats['glyph_of'] > 0, stats
    assert stats['suspect'] > 0 and stats['capacity'] == stats['suspect']


def test_fused_bf16_matches_jax_plain_bf16(weights, pages):
    """'bf16' through the serving default (device planner, fused tail)
    against JAX's, run with the plain layers in bfloat16 (use_pallas=False)
    and stored in the fixture (`fused_bf16_texts`), on two pages."""
    _, expected = load_fixture('fused_bf16_texts')
    with _port(weights, precision='bf16') as pipeline:
        assert pipeline.mono_weights is None and pipeline.char_head == 'xla'
        got = pipeline.ocr_pages(pages[:2])
    assert sum(len(lines) for page in got for lines in page) > 0
    assert_within_flip_budget(got, expected)
