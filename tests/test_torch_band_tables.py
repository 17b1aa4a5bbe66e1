"""The band components of the device cascade: the band_ccl kernel's plain
version (univer_ocr_tpu_torch.ops.kernels.band_ccl) and the band tables
built on it (univer_ocr_tpu_torch.models.band_tables), against scipy's
labels and the host library's statistics (native.label_stats), which the
host cascade's line planner reads.

Bars, all exact: labels and component counts equal to
`ndimage.label`'s (4-connected, numbered in raster order; ranks are the
labels less one), each component's pixel count, box and integer
coordinate sums equal to native.label_stats' (so its centres are
bit-equal), on seeded random masks with random valid regions and on the
host cascade's real band masks of the fixture pages, where neighbouring
lines touch.  The kernel itself is held to this plain version on the card
(`cuda` test below, and chip_smoke.py)."""

import json
import zlib

import numpy as np
import pytest
import torch
from scipy import ndimage

from univer_ocr_tpu_torch import native
from univer_ocr_tpu_torch.interpreter import band_components
from univer_ocr_tpu_torch.models import band_tables as tbt
from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
from univer_ocr_tpu_torch.ops.kernels.band_ccl import (FIELDS, MAX_TABLE,
                                                       band_ccl,
                                                       band_ccl_reference,
                                                       tile_shape)
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

from test_torch_fixture import N_PAGES, PAGE_SHAPE, load_fixture


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_like_scipy(mask, stats, n_comp, labels=None):
    """One image's results against ndimage.label and native.label_stats."""
    lab, cnt = ndimage.label(mask)
    assert int(n_comp) == cnt
    if labels is not None:
        np.testing.assert_array_equal(labels, lab - 1)
    k = min(cnt, stats.shape[0])
    if cnt:
        _, n, counts, centres, boxes = native.label_stats(mask)
        rows = np.asarray(stats[:k], np.int64)
        np.testing.assert_array_equal(rows[:, 0], counts[:k])
        np.testing.assert_array_equal(rows[:, 3:], boxes[:k])
        np.testing.assert_array_equal(rows[:, 1:3] / rows[:, :1],
                                      centres[:k])
    assert not np.asarray(stats[k:]).any()


@pytest.mark.parametrize('seed', range(16))
def test_band_ccl_plain_matches_scipy_and_native(seed):
    """Random masks of random density, shapes and valid regions: labels
    (in the valid region; -1 outside it), counts and every statistic."""
    rs = np.random.RandomState(seed)
    N, H, W = 3, rs.randint(1, 70), rs.randint(1, 90)
    masks = rs.rand(N, H, W) > rs.uniform(0.15, 0.85)
    hv = rs.randint(0, H + 1, N)
    wv = rs.randint(0, W + 1, N)
    stats, n_comp, labels = band_ccl_reference(_t(masks), _t(hv), _t(wv),
                                               MAX_TABLE, labels=True)
    assert stats.dtype == n_comp.dtype == labels.dtype == torch.int32
    for i in range(N):
        _assert_like_scipy(masks[i, :hv[i], :wv[i]], stats[i].numpy(),
                           n_comp[i], labels[i, :hv[i], :wv[i]].numpy())
        outside = np.ones((H, W), bool)
        outside[:hv[i], :wv[i]] = False
        assert (labels[i].numpy()[outside] == -1).all()


def test_band_ccl_separates_diagonal_neighbours():
    """Stripes that touch only at a corner are two components (scipy's
    4-connectivity), stripes that share an edge one, and a spiral and a
    comb are one each."""
    mask = np.zeros((40, 60), bool)
    mask[2:5, 2:20] = True
    mask[5:8, 20:40] = True                   # corner to corner: separate
    mask[10:13, 5:30] = True
    mask[13:16, 29:50] = True                 # shares an edge: joined
    mask[20:22, 5:55] = True                  # a comb
    for x in range(5, 55, 6):
        mask[22:30, x] = True
    y0, x0, y1, x1 = 31, 2, 40, 60            # a flat spiral
    mask[y0, x0:x1] = mask[y1 - 1, x0:x1] = True
    mask[y0:y1, x1 - 1] = True
    stats, n_comp, labels = band_ccl_reference(
        _t(mask[None]), torch.tensor([40]), torch.tensor([60]), 48,
        labels=True)
    _assert_like_scipy(mask, stats[0].numpy(), n_comp[0],
                       labels[0].numpy())
    assert int(n_comp[0]) == 5


@pytest.mark.parametrize('shape', [(31, 64), (64, 31), (97, 203)])
def test_band_ccl_labels_serpentines(shape):
    """A serpentine that fills its image, the longest path a label can
    travel, as one component, and its complement, bars apart: labels and
    statistics as scipy's."""
    H, W = shape
    snake = np.zeros((H, W), bool)
    snake[::2] = True
    for y in range(1, H, 2):
        snake[y, W - 1 if y % 4 == 1 else 0] = True
    masks = np.stack([snake, ~snake])
    stats, n_comp, labels = band_ccl_reference(
        _t(masks), torch.tensor([H, H]), torch.tensor([W, W]), MAX_TABLE,
        labels=True)
    for i in range(2):
        _assert_like_scipy(masks[i], stats[i].numpy(), n_comp[i],
                           labels[i].numpy())
    assert int(n_comp[0]) == 1


@pytest.mark.parametrize('cap', [1, 2, 5])
def test_band_ccl_table_cap(cap):
    """A table of `cap` rows holds the first components; the count and
    the labels still take in every component."""
    rs = np.random.RandomState(cap)
    masks = rs.rand(2, 30, 40) > 0.6
    full = (torch.tensor([30, 30]), torch.tensor([40, 40]))
    stats, n_comp, labels = band_ccl_reference(_t(masks), *full, cap,
                                               labels=True)
    all_stats, all_n, all_labels = band_ccl_reference(_t(masks), *full,
                                                      MAX_TABLE, labels=True)
    assert (n_comp > cap).all()
    assert torch.equal(n_comp, all_n) and torch.equal(labels, all_labels)
    assert torch.equal(stats, all_stats[:, :cap])


def test_band_ccl_checks_its_arguments():
    masks = torch.zeros((1, 4, 4), dtype=torch.bool)
    size = (torch.tensor([4]), torch.tensor([4]))
    for cap in (0, MAX_TABLE + 1):
        with pytest.raises(ValueError, match='max_comp'):
            band_ccl(masks, *size, cap)
    with pytest.raises(ValueError, match=r'\(N, H, W\)'):
        band_ccl(masks[0], *size, 8)
    stats, n_comp = band_ccl(masks, *size, 8)
    assert stats.shape == (1, 8, len(FIELDS)) and int(n_comp[0]) == 0


# ---------------------------------------------------------------------------
# Hard masks for the kernel's tiles, on every shape of the main path
# ---------------------------------------------------------------------------

#: both band channels of a launch of 16 and of 4 paragraphs at each menu
#: bucket, a chunk's page labels, ragged shapes, and one wide enough for
#: tiles side by side
KERNEL_SHAPES = ([(2 * n, hb, wb) for hb, wb in ((128, 256), (256, 512),
                                                  (512, 768))
                  for n in (16, 4)]
                 + [(32, 496, 736), (3, 37, 91), (40, 64, 64), (2, 40, 2100)])
HARD_MASKS = ('serpentine', 'spanning', 'u_turn', 'stripes', 'empty_full',
              'border_lines', 'ragged')
#: at most this many pixels of a stack through the plain version on the
#: CPU; a larger stack checks its first four images
CPU_PIXELS = 1 << 21


def _serpentine(H, W, period, vertical):
    """Bars every `period` rows (columns), each joined to the next at
    alternate ends: one component through every tile."""
    if vertical:
        return _serpentine(W, H, period, False).T.copy()
    m = np.zeros((H, W), bool)
    bars = list(range(0, H, period))
    for k, y in enumerate(bars):
        m[y] = True
        if k + 1 < len(bars):
            m[y:bars[k + 1], W - 1 if k % 2 == 0 else 0] = True
    return m


def hard_masks(kind, N, H, W):
    """(masks (N, H, W) bool, h_valid, w_valid) of one kind of hard mask,
    placed against the kernel's tiles (`tile_shape`): the images of a
    stack cycle through the kind's variants."""
    th, tw = tile_shape(N, H, W)
    rs = np.random.RandomState(zlib.crc32(f'{kind} {N} {H} {W}'.encode()))
    masks = np.zeros((N, H, W), bool)
    hv, wv = np.full(N, H), np.full(N, W)
    for i in range(N):
        m = masks[i]
        if kind == 'serpentine':
            m[:] = _serpentine(H, W, 2 + i // 2 % 3, i % 2 == 1)
        elif kind == 'spanning':
            # a spine down one column and a tooth across every tile row
            m[:, i * 7 % W] = True
            m[i % th::th] = True
        elif kind == 'u_turn':
            # arms from the top that first meet on the last row; the arm
            # that starts lower joins its root only through the last tile
            a = i % max(1, W // 3)
            b = W - 1 - a
            m[i % 2:, a] = True
            m[(i + 1) % 2:, b] = True
            m[H - 1, a:b + 1] = True
            if i % 3 == 2 and b - a > 4 and H > 3:
                m[2:H - 2, a + 2] = m[3:H - 2, b - 2] = True
                m[H - 3, a + 2:b - 1] = True
        elif kind == 'stripes':
            for y in range(i % 5, H - 2, 17):
                m[y:y + 6, 3:W - 5] = True
            m &= rs.rand(H, W) > 0.08
            hv[i], wv[i] = rs.randint(H // 2, H + 1), rs.randint(W // 2, W + 1)
        elif kind == 'empty_full':
            m[:] = i % 2 == 1
        elif kind == 'border_lines':
            # one-pixel lines just above, just below or on both sides of
            # each tile border, and dominoes across it
            rows = ((-1,), (0,), (-1, 0), None)[i % 4]
            for yb in range(th, H, th):
                if rows is None:
                    m[yb - 1:yb + 1, ::2] = True
                else:
                    m[[yb + r for r in rows]] = True
            for xb in range(tw, W, tw):
                m[:, xb - (i % 2 == 0)] = True
        elif kind == 'ragged':
            # random pixels, the valid region's edges inside a tile
            m[:] = rs.rand(H, W) > rs.uniform(0.3, 0.7)
            hv[i] = rs.randint(1, H + 1)
            wv[i] = rs.randint(1, W + 1)
            if hv[i] % th == 0 and 1 < hv[i] < H:
                hv[i] -= 1
            if wv[i] % tw == 0 and 1 < wv[i] < W:
                wv[i] -= 1
    return masks, hv, wv


@pytest.mark.parametrize('shape', KERNEL_SHAPES, ids=str)
@pytest.mark.parametrize('kind', HARD_MASKS)
def test_band_ccl_hard_masks_like_scipy(kind, shape):
    """The plain version that the kernel is held to, on the card test's
    own hard masks: labels, counts and statistics as scipy's."""
    masks, hv, wv = hard_masks(kind, *shape)
    N, H, W = shape
    if N * H * W > CPU_PIXELS:
        masks, hv, wv = masks[:4], hv[:4], wv[:4]
    for cap in (1, 48, MAX_TABLE):
        stats, n_comp, labels = band_ccl_reference(_t(masks), _t(hv), _t(wv),
                                                   cap, labels=True)
        for i in range(len(masks)):
            _assert_like_scipy(masks[i, :hv[i], :wv[i]], stats[i].numpy(),
                               n_comp[i], labels[i, :hv[i], :wv[i]].numpy())
            assert (labels[i, hv[i]:] == -1).all()
            assert (labels[i, :, wv[i]:] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize('shape', KERNEL_SHAPES, ids=str)
def test_band_ccl_kernel_matches_plain_version(shape):
    """The kernel against the plain version (run on the card: integers,
    so the same results), bit for bit, on every hard mask, with tables of
    1, 48 and 256 rows and the labels on and off."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (run on the H100: chip_smoke.py)')
    for kind in HARD_MASKS:
        masks, hv, wv = (_t(a).cuda() for a in hard_masks(kind, *shape))
        for cap in (1, 48, MAX_TABLE):
            want = band_ccl_reference(masks, hv, wv, cap, labels=True)
            got = band_ccl(masks, hv, wv, cap, labels=True)
            for name, g, w in zip(('stats', 'n_comp', 'labels'), got, want):
                assert torch.equal(g, w), (kind, cap, name)
            got = band_ccl(masks, hv, wv, cap)
            assert len(got) == 2
            for name, g, w in zip(('stats', 'n_comp'), got, want):
                assert torch.equal(g, w), (kind, cap, name, 'no labels')


# ---------------------------------------------------------------------------
# The band tables of a launch
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def host_bands():
    """The host cascade's thresholded band masks of every paragraph of the
    fixture pages, [(page, (1, h, w, 2) uint8)]."""
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    pages, _ = load_fixture()
    out = []
    with OCRPipeline(PAGE_SHAPE, weights=weights, chunk=1, workers=1,
                     device='cpu') as host:
        for i, page in enumerate(pages):
            m_u8, para = host.front(host._upload_pages([page[None, :, :,
                                                              None]]))
            crops = host._crop_page(m_u8.numpy().astype(np.float32) / 255.0,
                                    para.numpy())
            out.extend((i, b) for b in host._run_line_batched(crops))
    return out


@pytest.mark.parametrize('page', range(N_PAGES))
def test_band_tables_equal_host_band_components(host_bands, page):
    """One launch of a page's paragraphs, bucketed at its largest crop:
    each channel's components are the host line planner's
    (interpreter.band_components), box for box and centre for centre."""
    bands = [b for p, b in host_bands if p == page]
    H = max(b.shape[1] for b in bands)
    W = max(b.shape[2] for b in bands)
    batch = np.zeros((len(bands), H, W, 2), bool)
    for k, b in enumerate(bands):
        batch[k, :b.shape[1], :b.shape[2]] = b[0] > 0
    hv = torch.tensor([b.shape[1] for b in bands])
    wv = torch.tensor([b.shape[2] for b in bands])
    stats, n_comp = tbt.band_tables(_t(batch), hv, wv)
    assert stats.shape[:3] == (len(bands), 2, tbt.MAX_BAND_COMPONENTS)
    for k, b in enumerate(bands):
        for c, (boxes, centres) in enumerate(band_components(
                b, thresholded_input=True)):
            got_boxes, got_centres = tbt.table_components(
                stats[k, c].numpy(), n_comp[k, c])
            assert got_boxes == boxes
            np.testing.assert_array_equal(got_centres, centres)
    assert int(n_comp.sum()) > 2 * len(bands)


def test_band_tables_full_channel_has_no_component():
    """A channel set over its whole valid region has no component (the
    host's `> mean` on a full mask), whatever lies outside the region; a
    channel set almost everywhere has one."""
    bands = np.zeros((2, 20, 30, 2), bool)
    bands[0, :12, :25, 0] = True
    bands[0, 15:, :, 0] = True                 # outside the valid region
    bands[1, :12, :25, 0] = True
    bands[1, 11, 24, 0] = False
    bands[:, 2:4, 3:9, 1] = True
    stats, n_comp = tbt.band_tables(_t(bands), torch.tensor([12, 12]),
                                    torch.tensor([25, 25]))
    assert n_comp.tolist() == [[0, 1], [1, 1]]
    assert not stats[0, 0].any()
    assert int(stats[1, 0, 0, 0]) == 12 * 25 - 1


def test_band_threshold_is_the_host_rule():
    """(pred - 0.5 * (mean + max)) > 1e-6 per channel over each sample's
    valid region, as the host cascade thresholds and the reference reads
    its bands: on predictions in 1/1024 steps, whose sums are exact in any
    order."""
    rs = np.random.RandomState(0)
    pred = (rs.randint(0, 1025, (3, 24, 40, 2)) / 1024.0).astype(np.float32)
    hv, wv = np.array([24, 10, 17]), np.array([40, 33, 8])
    got = tbt.band_threshold(_t(pred), _t(hv), _t(wv)).numpy()
    for i in range(3):
        for c in range(2):
            b = pred[i, :hv[i], :wv[i], c]
            want = b - 0.5 * (b.mean() + b.max()) > 1e-6
            np.testing.assert_array_equal(got[i, :hv[i], :wv[i], c], want)
        assert not got[i, hv[i]:].any() and not got[i, :, wv[i]:].any()


def test_tables_payload_roundtrip():
    rs = np.random.RandomState(1)
    stats = _t(rs.randint(0, 10 ** 6, (5, 2, 48, 7)).astype(np.int32))
    n_comp = _t(rs.randint(0, 60, (5, 2)).astype(np.int32))
    buf = tbt.pack_tables(stats, n_comp)
    assert buf.shape == (5, 2 * 48 * 7 + 2) and buf.dtype == torch.int32
    got_stats, got_n = tbt.unpack_tables(buf.numpy())
    np.testing.assert_array_equal(got_stats, stats.numpy())
    np.testing.assert_array_equal(got_n, n_comp.numpy())


@pytest.mark.parametrize('seed', range(4))
def test_table_components_equal_layer_components(seed):
    """The host's reading of a table row: layer_components' boxes and
    bit-equal centres."""
    from univer_ocr_tpu_torch.interpreter import layer_components
    mask = np.random.RandomState(seed).rand(50, 70) > 0.4
    stats, n_comp = band_ccl_reference(_t(mask[None]), torch.tensor([50]),
                                       torch.tensor([70]), MAX_TABLE)
    assert 1 < int(n_comp[0]) <= MAX_TABLE
    boxes, centres = layer_components(mask)
    got_boxes, got_centres = tbt.table_components(stats[0].numpy(),
                                                  n_comp[0])
    assert got_boxes == boxes
    np.testing.assert_array_equal(got_centres, centres)
