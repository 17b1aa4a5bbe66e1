"""The port's device paragraph planners (univer_ocr_tpu_torch.models.
device_cascade: the page CCL of band_tables.grid_ccl_labels with the row
scans, device_page_plans, device_chunk_plans) against the JAX package's
and against the port's host planner, and the two paths of the serving
default that run them: chunks through the device planner, and one page
through the single-page chain.

Bars:
  * labels, component counts, the convergence flag and every integer
    plan field: exactly equal to JAX's, on generated masks at 288x432
    (level blocks, rotated bars on both sides of 45 degrees, a comb and
    a spiral for the CCL, and a page of 56 blobs for the per-page
    fallback);
  * float plan fields (cos, sin, off_y, off_x): equal to JAX's jitted
    planners' too.  Both compute them in float32 from the same integer
    geometry; the port reads the cosines and sines of the deskew grid
    from a table of JAX's values (deskew_table.py, held to JAX here) and
    takes a fused multiply-add where XLA's CPU backend contracts one;
  * against the port's host planner (_page_paragraph_plans, float64):
    integer fields equal, float fields within 1e-3, as
    tests/test_single_page_chain.py holds JAX's;
  * pipeline text on the fixture pages: exactly equal to the JAX text
    stored in the fixture (`fused_texts`, `chain_texts`), with the
    chain's fallback where JAX took it and nowhere else."""

import functools
import json
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
from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
from univer_ocr_tpu_torch.utils.profiling import StageTimers
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

from test_torch_fixture import N_PAGES, PAGE_SHAPE, load_fixture

SMALL = (1, 288, 432, 1)
EIGHT = np.ones((3, 3), bool)
FIELDS = tdc.PARAGRAPH_INT_FIELDS + tdc.PARAGRAPH_FLT_FIELDS


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


def _scipy_labels(occ):
    want = np.full(occ.shape, tbt._CCL_BIG, np.int64)
    for b in range(occ.shape[0]):
        ref, cnt = ndimage.label(occ[b], structure=EIGHT)
        for blob in range(1, cnt + 1):
            cells = np.argwhere(ref == blob)
            want[b, cells[:, 0], cells[:, 1]] = (
                cells[:, 0] * occ.shape[2] + cells[:, 1]).min()
    return want


def _jax_fields(plan):
    """JAX plan rows -> {field: column}, its field names."""
    names = jdc.PARAGRAPH_INT_FIELDS + jdc.PARAGRAPH_FLT_FIELDS
    return {f: np.asarray(plan)[..., names.index(f)] for f in FIELDS}


def _assert_plans_equal(plan, plan_j, where=''):
    """Every field equal, by name."""
    plan = plan.numpy()
    fields_j = _jax_fields(plan_j)
    for ci, f in enumerate(FIELDS):
        np.testing.assert_array_equal(plan[..., ci], fields_j[f],
                                      err_msg=f'{where} {f}')


def test_deskew_tables_equal_jax():
    """The planners' cosines and sines of the deskew grid: JAX's float32
    cos and sin of deg2rad(0, 1, ..., 180), as its jitted planners
    compute them."""
    from univer_ocr_tpu_torch.models.deskew_table import COS_DEG, SIN_DEG
    deg = np.arange(0.0, 181.0, 1.0, dtype=np.float32)
    cos_j, sin_j = jax.jit(lambda a: (jnp.cos(jnp.deg2rad(a)),
                                      jnp.sin(jnp.deg2rad(a))))(deg)
    np.testing.assert_array_equal(np.asarray(COS_DEG, np.float32),
                                  np.asarray(cos_j))
    np.testing.assert_array_equal(np.asarray(SIN_DEG, np.float32),
                                  np.asarray(sin_j))


# ---------------------------------------------------------------------------
# The page CCL
# ---------------------------------------------------------------------------


def test_page_ccl_equals_scipy_and_jax():
    masks = _page_masks()
    syncs = Counter()
    lab, converged = tdc._page_labels(_t(masks).float(), syncs=syncs)
    lab_j, _, conv_j = jax.jit(functools.partial(
        jdc.grid_ccl_labels, max_iters=jdc.PAGE_CCL_MAX_ITERS,
        column_scan=True))(jnp.asarray(masks[..., None]))
    assert converged and bool(conv_j)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_j)[..., 0])
    np.testing.assert_array_equal(lab.numpy(), _scipy_labels(masks))
    assert tdc.PAGE_CCL_MAX_ITERS == jdc.PAGE_CCL_MAX_ITERS
    assert set(syncs) == {'page_ccl_block'}
    # the row scans converge the spiral within a block
    assert syncs['page_ccl_block'] <= 2


@pytest.mark.parametrize('cap', [1, 2, 3])
def test_page_ccl_unconverged_equals_jax(cap):
    """A spiral needs several sweeps even with the row scans: under a
    small cap both report no convergence, with the same labels."""
    occ = _page_masks()[2:, :, :, None]
    lab, _, converged = tbt.grid_ccl_labels(_t(occ), max_iters=cap,
                                            column_scan=True)
    lab_j, _, conv_j = jax.jit(functools.partial(
        jdc.grid_ccl_labels, max_iters=cap, column_scan=True))(
        jnp.asarray(occ))
    assert converged == bool(conv_j)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_j))
    if cap == 1:
        assert not converged


# ---------------------------------------------------------------------------
# The planners
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def small_pipeline():
    with OCRPipeline(SMALL, chunk=2, workers=2, device='cpu',
                     device_cascade=True, collapse_runs=4) as pipeline:
        yield pipeline


def test_device_page_plans_equal_jax_and_host(small_pipeline):
    """Every field of each page's plans: against JAX's device_page_plans
    and against the host planner in the largest menu frame."""
    hb, wb = small_pipeline.line_shape_menu[-1]
    fn = jax.jit(lambda p: jdc.device_page_plans(p, hb, wb, k_max=16))
    rotated = folded = 0
    for i, mask in enumerate(_page_masks()):
        syncs = Counter()
        lab, roots, plan, n_comp, ok = tdc.device_page_plans(
            _t(mask).float(), hb, wb, k_max=16, syncs=syncs)
        lab_j, roots_j, plan_j, n_comp_j, ok_j = fn(jnp.asarray(mask,
                                                                jnp.float32))
        assert bool(ok) and bool(ok_j)
        assert int(n_comp) == int(n_comp_j)
        np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_j))
        np.testing.assert_array_equal(roots.numpy(), np.asarray(roots_j))
        _assert_plans_equal(plan, plan_j, f'page {i}')
        assert syncs['page_ccl_block'] >= 1

        host = small_pipeline._page_paragraph_plans(0, mask)
        assert int(n_comp) == len(host)
        for k, hp in enumerate(host):
            rotated += hp['rotated']
            folded += abs(hp['sin']) > abs(hp['cos'])
            for ci, f in enumerate(FIELDS):
                if f == 'page':
                    continue
                if f in tdc.PARAGRAPH_FLT_FIELDS:
                    assert abs(plan[k, ci] - hp[f]) < 1e-3, (i, k, f)
                else:
                    assert int(plan[k, ci]) == hp[f], (i, k, f)
    assert rotated >= 3 and folded >= 1


def test_device_chunk_plans_equal_jax(small_pipeline):
    """A chunk of three pages, one of them with 56 components (more than
    CHUNK_PLAN_K): labels, plans, menu picks and counts as JAX's."""
    masks = _page_masks()
    dense = _blob_grid(7, 8, pitch=(38, 52))[0, :, :, 0] < 0.5
    stack = np.stack([masks[1], dense, masks[0]]).astype(np.float32)
    menu = tuple(small_pipeline.line_shape_menu)
    K = small_pipeline.CHUNK_PLAN_K
    lab, plans, menu_idx, n_comp, converged = tdc.device_chunk_plans(
        _t(stack), menu, k_max=K)
    lab_j, plans_j, menu_idx_j, n_comp_j, conv_j = jax.jit(
        functools.partial(jdc.device_chunk_plans, menu=menu, k_max=K))(
        jnp.asarray(stack))
    assert converged and bool(conv_j)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_j))
    np.testing.assert_array_equal(n_comp.numpy(), np.asarray(n_comp_j))
    assert int(n_comp[1]) == 56 > K
    # menu picks of live slots (JAX's dead slots pick from the background,
    # whose label their root sentinel equals; no reader looks past n_comp)
    live = np.arange(K)[None, :] < n_comp.numpy()[:, None]
    np.testing.assert_array_equal(menu_idx.numpy()[live],
                                  np.asarray(menu_idx_j)[live])
    _assert_plans_equal(plans[..., :-1], np.asarray(plans_j)[..., :-1])
    np.testing.assert_array_equal(plans[..., -1].numpy(),
                                  np.asarray(plans_j)[..., -1])
    assert len(set(menu_idx.numpy()[live].tolist())) >= 2


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
    _, expected = load_fixture('fused_texts')
    got = fused_run[0]
    assert sum(len(lines) for page in got for lines in page) > 0
    assert got == expected


def test_default_pipeline_timers_and_counters(fused_run):
    """The planned dispatch's stages and pulls: one plan matrix per chunk,
    one glyph pull per wave, no paragraph-mask pull and no line stage on
    these pages; its syncs only the counted kinds."""
    texts, summary, timeline, stats, syncs = fused_run
    assert set(summary) == {'pull_plan_matrix', 'host_paragraph_plans',
                            'dispatch_paragraph_stage', 'pull_fused_glyphs'}
    assert summary['pull_plan_matrix']['count'] == N_PAGES // 2
    tags = Counter(tag for tag, *_ in timeline)
    assert set(tags) == {'plan_matrix', 'fused_glyphs'}
    assert tags['fused_glyphs'] == N_PAGES // 2
    assert stats['paragraphs'] == sum(len(page) for page in texts) == 32
    assert stats['suspect'] == 0 and 'chain_fallback' not in stats
    assert set(syncs) == {'page_ccl_block', 'suspect_check',
                          'grid_ccl_block'}


def test_single_page_chain_matches_jax_chain_text(weights, pages):
    """Each fixture page alone through the chain: JAX's chain text, and
    the fallback exactly where JAX's chain took it."""
    _, expected = load_fixture('chain_texts')
    _, fallbacks = load_fixture('chain_fallbacks')
    with _port(weights) as pipeline:
        for page, want, fell_back in zip(pages, expected, fallbacks):
            before = pipeline.escalation_stats.get('chain_fallback', 0)
            syncs = sum(pipeline.host_syncs.values())
            assert pipeline.ocr_pages([page]) == [want]
            assert (pipeline.escalation_stats.get('chain_fallback', 0)
                    > before) == fell_back
            assert sum(pipeline.host_syncs.values()) > syncs
        assert pipeline.host_syncs['chain_plan'] == N_PAGES


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
