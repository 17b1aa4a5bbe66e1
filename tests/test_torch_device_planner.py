"""The port's device paragraph planners (univer_ocr_tpu_torch.models.
device_cascade: the page labels of the band_ccl kernel's plain version,
device_page_plans, device_chunk_plans) against scipy and the port's host
planner, and the two paths of the serving default that run them: chunks
through the device planner, and one page through the single-page chain.

Bars:
  * labels and component counts: exactly scipy's 4-connected labels
    (less one), on generated masks at 288x432 (level blocks, rotated bars
    on both sides of 45 degrees, a comb and a spiral, and a page of 56
    blobs for the per-page fallback);
  * every plan field: exactly the host planner's
    (OCRPipeline._page_paragraph_plans: find_rotation_angle, the box of
    scipy's order-0 rotation of the mask);
  * pipeline text on the fixture pages: exactly the host cascade's text
    stored in the fixture (`texts`), in one call and page by page."""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from scipy import ndimage

from univer_ocr_tpu_torch.interpreter import find_rotation_angle
from univer_ocr_tpu_torch.models import device_cascade as tdc
from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
from univer_ocr_tpu_torch.utils.profiling import StageTimers
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

from test_torch_fixture import N_PAGES, PAGE_SHAPE, load_fixture

SMALL = (1, 288, 432, 1)
FIELDS = tdc.PARAGRAPH_FIELDS


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rotated_bar(angle, h=20, w=140):
    bar = np.zeros((h + 40, w + 20), np.float32)
    bar[20:20 + h, 10:10 + w] = 1.0
    return ndimage.rotate(bar, angle, reshape=True, order=0) > 0.5


def _paste(page, blob, y, x):
    page[y:y + blob.shape[0], x:x + blob.shape[1]] |= blob


def _page_masks():
    """(3, 288, 432) paragraph masks: level blocks; rotated bars at -14,
    9 and 80 degrees (the last folds through rot90) beside blocks; a comb
    and a spiral, which the page CCL needs several sweeps for."""
    rs = np.random.RandomState(0)
    masks = np.zeros((3, 288, 432), bool)
    for gy in range(2):
        for gx in range(3):
            y, x = 8 + gy * 144, 8 + gx * 144
            h, w = rs.randint(30, 120), rs.randint(40, 120)
            masks[0, y:y + h, x:x + w] = True
    _paste(masks[1], _rotated_bar(-14.0), 10, 10)
    _paste(masks[1], _rotated_bar(9.0, 30, 180), 120, 200)
    masks[1, 200:270, 20:150] = True
    _paste(masks[2], _rotated_bar(80.0, 24, 150), 100, 20)
    masks[2, 10:90, 120:130] = True                       # comb
    for k in range(5):
        masks[2, 10:14, 120 + 20 * k:130 + 20 * k] = True
        masks[2, 10:80, 140 + 20 * k - 10:140 + 20 * k - 6] = True
    y0, x0, y1, x1 = 120, 250, 280, 420                   # spiral
    while y1 - y0 > 12 and x1 - x0 > 12:
        masks[2, y0:y0 + 3, x0:x1] = True
        masks[2, y0:y1, x1 - 3:x1] = True
        masks[2, y1 - 3:y1, x0:x1] = True
        masks[2, y0 + 8:y1, x0:x0 + 3] = True
        y0, x0, y1, x1 = y0 + 8, x0 + 8, y1 - 8, x1 - 8
    return masks


def _blob_grid(rows, cols, shape=SMALL, pitch=(44, 52)):
    """A white page with a grid of separated ink blobs, each detected as
    a paragraph (tests/test_single_page_chain.py's over-capacity page)."""
    page = np.ones(shape, np.float32)
    for gy in range(rows):
        for gx in range(cols):
            y, x = 8 + gy * pitch[0], 12 + gx * pitch[1]
            page[0, y:y + 10, x:x + 24, 0] = 0.0
    return page


def _scipy_ranks(mask):
    """scipy's 4-connected labels of a 2-D mask, less one (-1 off it)."""
    lab, cnt = ndimage.label(mask)
    return lab.astype(np.int64) - 1, cnt


def _assert_plans_equal_host(plan, n_comp, host, where=''):
    """The first n_comp device plan rows against the host planner's
    dicts, field by field ('page' aside)."""
    assert int(n_comp) == len(host), where
    for k, hp in enumerate(host):
        for ci, f in enumerate(FIELDS):
            if f != 'page':
                assert int(plan[k, ci]) == hp[f], (where, k, f)


def test_deskew_degrees_equal_find_rotation_angle():
    """The device's deskew search on each component's row extremes:
    find_rotation_angle's degree (float64, the first minimum; 0 for
    level) for bars at many angles and the generated pages."""
    masks = list(_page_masks())
    angles = (-44, -30, -7, -1, 0, 1, 2, 13, 45, 46, 60, 89, 90, 91)
    for pair in range(0, len(angles), 2):
        page = np.zeros((288, 432), bool)
        for j, angle in enumerate(angles[pair:pair + 2]):
            _paste(page, _rotated_bar(angle), 10, 10 + 210 * j)
        masks.append(page)
    K = 20
    labels, stats, n = tdc.page_labels(_t(np.stack(masks)), K)
    live = torch.arange(K)[None, :] < n[:, None]
    got = tdc._deskew_degrees(labels, stats[..., 3].long(),
                              stats[..., 5].long(), live, K)
    for i, mask in enumerate(masks):
        ranks, cnt = _scipy_ranks(mask)
        assert cnt <= K
        for k, sl in enumerate(ndimage.find_objects(ranks + 1)):
            angle = find_rotation_angle(ranks[sl] == k)
            assert int(got[i, k]) == (0 if angle is None else int(angle)), (
                i, k)


# ---------------------------------------------------------------------------
# The page labels
# ---------------------------------------------------------------------------


def test_page_ccl_equals_scipy_and_jax():
    """The page labels of the generated masks (a comb and a spiral among
    them) are scipy's 4-connected labels, less one, and the statistics
    table holds each component's pixel count and box."""
    masks = _page_masks()
    labels, stats, n_comp = tdc.page_labels(_t(masks), 48)
    for b, mask in enumerate(masks):
        ranks, cnt = _scipy_ranks(mask)
        assert int(n_comp[b]) == cnt
        np.testing.assert_array_equal(labels[b].numpy(), ranks)
        for k, (ys, xs) in enumerate(ndimage.find_objects(ranks + 1)):
            row = stats[b, k].tolist()
            assert row[0] == int((ranks == k).sum())
            assert row[3:] == [ys.start, ys.stop, xs.start, xs.stop]


@pytest.mark.parametrize('cap', [1, 2, 3])
def test_page_ccl_unconverged_equals_jax(cap):
    """A table smaller than the page's components: every component is
    still labelled and counted, and the rows the table holds are the
    first components'."""
    masks = _page_masks()
    labels, stats, n_comp = tdc.page_labels(_t(masks), cap)
    full_labels, full_stats, full_n = tdc.page_labels(_t(masks), 48)
    assert torch.equal(labels, full_labels) and torch.equal(n_comp, full_n)
    assert int(n_comp.max()) > cap
    assert torch.equal(stats, full_stats[:, :cap])


# ---------------------------------------------------------------------------
# The planners
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def small_pipeline():
    with OCRPipeline(SMALL, chunk=2, workers=2, device='cpu',
                     device_cascade=True, collapse_runs=4) as pipeline:
        yield pipeline


def test_device_page_plans_equal_jax_and_host(small_pipeline):
    """Every field of each page's plans in the largest menu frame, against
    the host planner's: rotated bars on both sides of 45 degrees and
    level blocks."""
    hb, wb = small_pipeline.line_shape_menu[-1]
    rotated = 0
    for i, mask in enumerate(_page_masks()):
        lab, plan, n_comp, ok = tdc.device_page_plans(_t(mask), hb, wb,
                                                      k_max=16)
        assert bool(ok)
        ranks, _ = _scipy_ranks(mask)
        np.testing.assert_array_equal(lab.numpy(), ranks)
        host = small_pipeline._page_paragraph_plans(0, mask)
        for hp in host:
            hp.update(hv=min(hp['hv'], hb), wv=min(hp['wv'], wb))
            rotated += hp['angle'] != 0
        _assert_plans_equal_host(plan, n_comp, host, f'page {i}')
    assert rotated >= 3


def test_device_chunk_plans_equal_jax(small_pipeline):
    """A chunk of three pages, one of them with 56 components (more than
    CHUNK_PLAN_K): labels, counts, plans and menu picks as the host
    planner's."""
    masks = _page_masks()
    dense = _blob_grid(7, 8, pitch=(38, 52))[0, :, :, 0] < 0.5
    stack = np.stack([masks[1], dense, masks[0]])
    menu = tuple(small_pipeline.line_shape_menu)
    K = small_pipeline.CHUNK_PLAN_K
    lab, plans, menu_idx, n_comp = tdc.device_chunk_plans(_t(stack), menu,
                                                          k_max=K)
    assert int(n_comp[1]) == 56 > K
    for b in (0, 2):
        ranks, _ = _scipy_ranks(stack[b])
        np.testing.assert_array_equal(lab[b].numpy(), ranks)
        host = small_pipeline._page_paragraph_plans(b, stack[b])
        _assert_plans_equal_host(plans[b], n_comp[b], host, f'page {b}')
        assert int(plans[b, 0, FIELDS.index('page')]) == b
        assert [menu[int(i)] for i in menu_idx[b, :len(host)]] == [
            hp['menu'] for hp in host]


# ---------------------------------------------------------------------------
# The serving default in the pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def weights():
    with open(DEFAULT_CHECKPOINT) as fp:
        return json.load(fp)


@pytest.fixture(scope='module')
def pages():
    fixture_pages, _ = load_fixture()
    return [p[None, :, :, None] for p in fixture_pages]


def _port(weights, shape=PAGE_SHAPE, **kwargs):
    kwargs = dict(dict(chunk=2, workers=2, collapse_runs=4,
                       precision='highest', device='cpu'), **kwargs)
    return OCRPipeline(shape, weights=weights, device_cascade=True, **kwargs)


@pytest.fixture(scope='module')
def fused_run(weights, pages):
    """The serving default on the 4 fixture pages in one call (chunk 2),
    with its stage timers on: (texts, timers, timeline, escalation_stats,
    host_syncs)."""
    with _port(weights) as pipeline:
        assert pipeline.fused_tail and pipeline._device_planner
        pipeline.timers = StageTimers()
        texts = pipeline.ocr_pages(pages)
        return (texts, pipeline.timers.summary(), pipeline.timeline,
                pipeline.escalation_stats, pipeline.host_syncs)


def test_default_pipeline_matches_jax_fused_text(fused_run):
    """The host cascade's text, exactly."""
    _, expected = load_fixture()
    got = fused_run[0]
    assert sum(len(lines) for page in got for lines in page) > 0
    assert got == expected


def test_default_pipeline_timers_and_counters(fused_run):
    """The planned dispatch's stages and pulls: one plan matrix per chunk,
    one glyph pull per wave, no paragraph-mask pull and no line stage on
    these pages; its syncs only the counted kinds.  On the CPU every
    paragraph launch and chunk planner call runs eagerly: no graph
    replays."""
    texts, summary, timeline, stats, syncs = fused_run
    assert set(summary) == {'pull_plan_matrix', 'host_paragraph_plans',
                            'dispatch_paragraph_stage', 'pull_fused_glyphs',
                            'band_components', 'band_components_labelled',
                            'host_sync', 'stage_launches'}
    assert summary['stage_launches']['count'] == (
        summary['band_components']['count'] + N_PAGES // 2)
    assert summary['pull_plan_matrix']['count'] == N_PAGES // 2
    tags = Counter(tag for tag, *_ in timeline)
    assert set(tags) == {'plan_matrix', 'fused_glyphs'}
    assert tags['fused_glyphs'] == N_PAGES // 2
    assert stats['paragraphs'] == sum(len(page) for page in texts) == 32
    assert stats['host_planned'] == 0 and 'chain_fallback' not in stats
    assert syncs == Counter(plan_matrix=N_PAGES // 2,
                            fused_glyphs=N_PAGES // 2)
    assert summary['host_sync']['count'] == sum(syncs.values())
    lines = sum(len(lines) for page in texts for lines in page)
    assert summary['band_components']['count'] >= 2
    assert summary['band_components_labelled']['total_s'] >= 2 * lines


def test_single_page_chain_matches_jax_chain_text(weights, pages):
    """Each fixture page alone through the chain: the host cascade's
    text, with no fallback (no page holds more than 2 * DEVICE_BATCH
    paragraphs) and two host syncs a page: the plan and the glyphs."""
    _, expected = load_fixture()
    with _port(weights) as pipeline:
        for page, want in zip(pages, expected):
            assert pipeline.ocr_pages([page]) == [want]
        assert 'chain_fallback' not in pipeline.escalation_stats
        assert pipeline.host_syncs == Counter(chain_plan=N_PAGES,
                                              fused_glyphs=N_PAGES)


def test_chain_component_overflow_falls_back(weights):
    """48 components (more than 2 * DEVICE_BATCH): the chain's planner
    fails, the page takes the host-planned chunk path, and the text equals
    the device-planned chunk path's (48 fit CHUNK_PLAN_K)."""
    page = _blob_grid(6, 8)
    blank = np.ones(SMALL, np.float32)
    with _port(weights, SMALL) as pipeline:
        single = pipeline.ocr_pages([page])[0]
        assert pipeline.escalation_stats['chain_fallback'] == 1
        chunk = pipeline.ocr_pages([page, blank])[0]
        assert pipeline.escalation_stats['chain_fallback'] == 1
    assert len(single) == 48
    assert single == chunk


def test_planned_chunk_page_fallback(weights, pages):
    """A page with more components than the chunk planner's cap in a
    device-planned chunk is planned on the host, the other stays on the
    device, and the text equals the host-planned dispatch's.  The cap is
    cut to 8 here, so that a page of 12 blobs exceeds it (the planner at
    the cap of 48 is held against JAX above)."""
    normal = np.ascontiguousarray(pages[0][:, :288, :432])
    dense = _blob_grid(3, 4)
    with _port(weights, SMALL) as planned, \
            _port(weights, SMALL) as classic:
        planned.CHUNK_PLAN_K = 8
        classic._device_planner = False
        got = planned.ocr_pages([normal, dense])
        assert planned.escalation_stats['chain_fallback'] == 1
        assert got == classic.ocr_pages([normal, dense])
    assert len(got[1]) == 12 and 0 < len(got[0]) <= 8
