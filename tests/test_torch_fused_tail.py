"""The port's fused tail (univer_ocr_tpu_torch.models.fused_tail): its
run-length decode against the JAX package's and the host's, its line
planner against interpreter.pair_lines, the tail on a launch of crops,
and the fused paragraph dispatch of the port's OCRPipeline.

Bars:
  * the flat run-length decode: glyph ids, counts and overflow flags
    exactly equal to JAX's scan and to the port's pred_ids_to_text;
  * the line planner: exactly pair_lines' lines (the same float64
    centres, distances and stable orders) with extract_line's upright
    extents and zoomed widths (device_cascade.line_plan_fields);
  * fused_paragraph_tail on a launch of paragraph crops: each
    paragraph's lines, the host cascade's text of that paragraph;
  * pipeline text on the fixture pages, against the host cascade's text
    stored in the fixture (tests/test_torch_fixture.py): exactly equal in
    'highest'; in 'bf16', against the port's host cascade in 'bf16',
    within the flip budget of tests/test_torch_device_pipeline.py."""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from univer_ocr_tpu.models import fused_tail as jft
from univer_ocr_tpu_torch.interpreter import pair_lines, pred_ids_to_text
from univer_ocr_tpu_torch.models import fused_tail as tft
from univer_ocr_tpu_torch.models.band_tables import (band_tables,
                                                     table_components)
from univer_ocr_tpu_torch.models.device_cascade import (
    PARAGRAPH_FIELDS, line_plan_fields, paragraph_stage)
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
# The line planner
# ---------------------------------------------------------------------------


def _random_stats(rs, B, M=48):
    """Random band tables: integer boxes with sums of pixels inside them,
    counts up to past the capacity, an empty channel, and a paragraph of
    one top and one bottom of equal centres' distances."""
    stats = np.zeros((B, 2, M, 7), np.int32)
    y0 = rs.randint(0, 400, (B, 2, M))
    x0 = rs.randint(0, 600, (B, 2, M))
    h = rs.randint(1, 40, y0.shape)
    w = rs.randint(1, 300, x0.shape)
    cnt = rs.randint(1, 200, y0.shape)
    stats[..., 0] = cnt
    stats[..., 1] = cnt * y0 + rs.randint(0, 1 + cnt * (h - 1))
    stats[..., 2] = cnt * x0 + rs.randint(0, 1 + cnt * (w - 1))
    stats[..., 3], stats[..., 4] = y0, y0 + h
    stats[..., 5], stats[..., 6] = x0, x0 + w
    n = rs.randint(0, 12, (B, 2)).astype(np.int32)
    n[0] = [M + 3, M]                                   # over capacity
    n[1, 1] = 0                                         # an empty channel
    return stats, n


def _synthetic_stats(rotated):
    """band_tables of tests/test_fused_tail.py's synthetic bands: paired
    stripes, level or transposed."""
    bands = np.concatenate([_synthetic_bands(np.random.RandomState(seed),
                                             rotated=rotated)
                            for seed in range(3)])
    B, H, W, _ = bands.shape
    stats, n = band_tables(_t(bands), torch.full((B,), H),
                           torch.full((B,), W))
    return stats.numpy(), n.numpy()


@pytest.mark.parametrize('case', ['level', 'rotated', 'random', 'random-4',
                                  'random-5'])
def test_line_planner_and_cross_axis_equal_jax(case):
    """Every paragraph's plans are pair_lines' lines on the same
    components, in its order, with extract_line's geometry
    (line_plan_fields); every line of a paragraph is planned, however
    many (the random tables hold paragraphs of more than 20 lines, more
    than a generated paragraph holds), and the rows past them are zero."""
    if case.startswith('random'):
        seed = int(case.split('-')[1]) if '-' in case else 3
        stats, n = _random_stats(np.random.RandomState(seed), 12)
    else:
        stats, n = _synthetic_stats(case == 'rotated')
    plans, n_lines = tft._plan_lines_single(_t(stats), _t(n))
    M = stats.shape[2]
    for b in range(stats.shape[0]):
        (tb, tc), (bb, bc) = (table_components(stats[b, c],
                                               min(int(n[b, c]), M))
                              for c in (0, 1))
        boxes, _, rotation = pair_lines(tb, tc, bb, bc)
        want = [line_plan_fields(rotation, y.start, y.stop, x.start, x.stop)
                for y, x in boxes]
        assert int(n_lines[b]) == len(want)
        for k, lp in enumerate(want):
            assert plans[b, k].tolist() == [lp[f] for f in tft.PLAN_FIELDS]
        assert (plans[b, len(want):] == 0).all()
    assert int(n_lines.sum()) > 0
    assert (int(n_lines.max()) > 20) == case.startswith('random')
    if case == 'rotated':
        # transposed stripes: every line turned by 90 or 270 degrees
        live = plans[:, :, 0] > 0
        assert (plans[:, :, 3][live] == 0).all()


# ---------------------------------------------------------------------------
# The fused tail on the same crops
# ---------------------------------------------------------------------------


def test_fused_paragraph_tail_equals_jax(weights, pages):
    """One launch of paragraph crops of the first two fixture pages (the
    paragraphs of their commonest menu shape): each paragraph's decoded
    lines are the host cascade's lines of that paragraph."""
    params = params_from_numpy(weights, 'cpu')
    _, texts = load_fixture()
    with _port(weights) as pipeline:
        mono, para = pipeline.front_resident(
            pipeline._upload_pages(pages[:2]))
        labels = torch.stack([torch.from_numpy(
            ndimage_ranks(para[page, :, :, 0].numpy())) for page in range(2)])
        plans = [p for page in range(2)
                 for p in pipeline._page_paragraph_plans(
                     page, para[page, :, :, 0].numpy())]
        want = [texts[p['page']][p['label']] for p in plans]
        menus = [p['menu'] for p in plans]
        menu = max(set(menus), key=menus.count)
        sel = [i for i, p in enumerate(plans) if p['menu'] == menu]
        assert len(sel) >= 4
        mat = _t(np.asarray([[plans[i][f] for f in PARAGRAPH_FIELDS]
                             for i in sel], np.int32))
        crops, bands = paragraph_stage(
            params, torch.round(mono[..., 0] * 255.0) / 255.0, labels, mat,
            *menu, precision='highest')
    hv, wv = (mat[:, PARAGRAPH_FIELDS.index(k)] for k in ('hv', 'wv'))
    small, lines = tft.fused_paragraph_tail(params, crops, bands, hv, wv,
                                            precision='highest', min_run=4)
    got, flags, comps = tft.unpack_fused_payload(small.numpy(), len(sel))
    # the line plans left on the device: a nonzero row per line
    assert (lines[:, :, 0] > 0).sum(dim=1).tolist() == [
        len(want[i]) for i in sel]
    assert not flags.any()
    assert [[line.strip() for line in lines] for lines in got] == [
        want[i] for i in sel]
    assert (comps >= 2 * np.asarray([len(want[i]) for i in sel])).all()
    assert small.shape[0] == tft.fused_payload_nbytes(len(sel))


def ndimage_ranks(mask):
    from scipy import ndimage
    lab, _ = ndimage.label(mask > 0)
    return lab.astype(np.int32) - 1


# ---------------------------------------------------------------------------
# The fused dispatch in the pipeline
# ---------------------------------------------------------------------------


def test_fused_tail_without_planner_matches_tables_text(weights, pages):
    """The fused tail on the host-planned dispatch gives the host
    cascade's text: every paragraph decoded on the device (none flagged on
    these pages), one pull per wave of launches."""
    _, expected = load_fixture()
    with _port(weights) as pipeline:
        assert pipeline.fused_tail and pipeline._device_planner
        pipeline._device_planner = False
        got = pipeline.ocr_pages(pages[:2])
        stats = pipeline.escalation_stats
        tags = {tag for tag, *_ in pipeline.timeline}
    assert got == expected[:2]
    assert stats['paragraphs'] == sum(len(page) for page in got)
    assert stats['host_planned'] == 0
    assert 'chain_fallback' not in stats
    assert tags == set()                  # timers off: no timeline


def test_fused_overflow_escalates_to_tables_text(weights, pages,
                                                 monkeypatch):
    """With a pool of 2 lines and 8 glyphs a line, every launch overflows:
    the flagged paragraphs' device line plans are pulled and relaunched
    through the line stage, no band mask comes home, and the text is the
    host cascade's, on the host-planned dispatch and through the chain
    (one page)."""
    _, expected = load_fixture()
    monkeypatch.setattr(tft, 'LINE_POOL', 2)
    monkeypatch.setattr(tft, 'MAX_GLYPHS', 8)
    with _port(weights) as pipeline:
        pipeline._device_planner = False
        assert pipeline.ocr_pages(pages[:1]) == expected[:1]
        stats = dict(pipeline.escalation_stats)
        pipeline._device_planner = True
        assert pipeline.ocr_pages(pages[:1]) == expected[:1]
        assert pipeline.host_syncs['line_plans'] >= 2
        assert 'bands' not in pipeline.host_syncs
    assert stats['pool_of'] + stats['glyph_of'] > 0, stats
    assert 0 < stats['relaunched'] <= stats['paragraphs']
    assert stats['host_planned'] == stats['table_of'] == 0


@pytest.mark.parametrize('cap', [1, 3])
def test_fused_table_overflow_plans_from_bands(weights, pages, monkeypatch,
                                               cap):
    """With band tables of `cap` rows and a pool of 2 lines, a paragraph
    whose table overflows is planned on the host from its pulled band
    masks and the others that overflow the pool are relaunched from their
    device line plans, in one launch; the text is the host cascade's."""
    from univer_ocr_tpu_torch.models import band_tables
    _, expected = load_fixture()
    monkeypatch.setattr(band_tables, 'MAX_BAND_COMPONENTS', cap)
    monkeypatch.setattr(tft, 'LINE_POOL', 2)
    with _port(weights) as pipeline:
        pipeline._device_planner = False
        assert pipeline.ocr_pages(pages[:1]) == expected[:1]
        stats = pipeline.escalation_stats
        syncs = pipeline.host_syncs
    assert 0 < stats['host_planned'] == stats['table_of']
    assert syncs['bands'] > 0
    assert stats['host_planned'] + stats['relaunched'] <= stats['paragraphs']
    if cap == 3:
        assert stats['relaunched'] > 0 and syncs['line_plans'] > 0


def test_fused_bf16_matches_jax_plain_bf16(weights, pages):
    """'bf16' through the serving default (device planner, fused tail)
    against the port's host cascade in 'bf16', on two pages."""
    with _port(weights, precision='bf16', device_cascade=False) as host:
        expected = host.ocr_pages(pages[:2])
    with _port(weights, precision='bf16') as pipeline:
        assert pipeline.mono_weights is None and pipeline.char_head == 'xla'
        got = pipeline.ocr_pages(pages[:2])
    assert sum(len(lines) for page in got for lines in page) > 0
    assert_within_flip_budget(got, expected)
