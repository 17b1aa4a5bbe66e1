"""The port's ground-truth decoder (univer_ocr_tpu_torch/interpreter.py:
interpret and its sort helpers) against the JAX package's, on the CPU:
equal dicts on rendered pages (upright and rotated), the demo page and
degenerate input; equal orders on random point sets.  interpret never
hands ndimage.find_objects a boolean array (newer scipy refuses one).
The line planner (plan_paragraph_lines, on component statistics) gives
the JAX package's plans, and the host cascade's paragraph crops
(OCRPipeline._crop_page, masks inside each box) are select_paragraph's
and deskew_paragraph's.  Every module on the card's path imports without
Pillow."""

import random
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
from scipy import ndimage

from univer_ocr_tpu import image_generator as jgen
from univer_ocr_tpu.interpreter import interpreter as jinterp
from univer_ocr_tpu.models import train_data_generator as jtdg
from univer_ocr_tpu_torch import interpreter as tinterp
from univer_ocr_tpu_torch.models.bucketing import make_divisible_by
from univer_ocr_tpu_torch.models.pipeline import OCRPipeline


def _page(seed, rotate):
    random.seed(seed)
    return jtdg.render_page(720, 480, rotate)


@pytest.mark.parametrize('seed, rotate', [(11, False), (12, True),
                                          (13, True)])
def test_interpret_equals_jax(seed, rotate):
    raw = _page(seed, rotate)
    want = jinterp.interpret(raw)
    assert want
    assert tinterp.interpret(raw) == want
    # the same layers as uint8 planes, as the card reads them
    planes = {name: np.asarray(img.convert('L'))
              for name, img in raw.items()}
    assert tinterp.interpret(planes) == want


def test_interpret_demo_page_equals_jax():
    random.seed(21)
    raw, _ = jgen.generate_demo(960, 540)
    assert tinterp.interpret(raw) == jinterp.interpret(raw)


def test_interpret_degenerate_input():
    """A blank page decodes to no lines and a line without glyphs to an
    empty line; a paragraph without line bands, which the generator never
    draws, raises in both packages alike."""
    blank = {name: np.zeros((64, 96), np.uint8)
             for name in jgen.LayeredImage.layer_names}
    assert tinterp.interpret(blank) == jinterp.interpret(blank) == {}
    para = dict(blank, paragraph=blank['paragraph'].copy())
    para['paragraph'][8:40, 10:80] = 255
    for interpret in (tinterp.interpret, jinterp.interpret):
        with pytest.raises(IndexError):
            interpret(para)
    lines = dict(para)
    for name, rows in (('line_top', (12, 22)), ('line_center', (16, 22)),
                       ('line_bottom', (16, 26))):
        lines[name] = blank[name].copy()
        lines[name][rows[0]:rows[1], 12:70] = 255
    assert tinterp.interpret(lines) == jinterp.interpret(lines) == {
        (0, 0): ''}


def test_sort_helpers_equal_jax():
    rs = np.random.RandomState(4)
    for _ in range(20):
        n = rs.randint(1, 12)
        top = [rs.rand(2) * 100 for _ in range(rs.randint(1, 6))]
        center = [rs.rand(2) * 100 for _ in range(n)]
        bottom = [rs.rand(2) * 100 for _ in range(rs.randint(1, 6))]
        ours = tinterp.rearrange_points(top, center, bottom)
        theirs = jinterp.rearrange_points(top, center, bottom)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        cm_top, _, cm_bottom = theirs
        assert tinterp.get_line_sort_ids(cm_top, cm_bottom, center) == \
            jinterp.get_line_sort_ids(cm_top, cm_bottom, center)
        letters = rs.randint(0, 100, (rs.randint(0, 15), 2))
        assert tinterp.get_letter_sort_ids(cm_top[0], cm_bottom[0],
                                           letters) == \
            jinterp.get_letter_sort_ids(cm_top[0], cm_bottom[0], letters)
        vector = rs.randn(2)
        assert tinterp.get_sort_ids(center[0], vector, letters) == \
            jinterp.get_sort_ids(center[0], vector, letters)
        order = rs.permutation(n)
        assert list(tinterp.iter_by_indices(center, order)) == list(
            jinterp.iter_by_indices(center, order))
    masks = [rs.rand(1, 20, 30, 1) > 0.7 for _ in range(3)]
    for a, b in zip(tinterp.get_center_of_mass(masks, masks[::-1]),
                    jinterp.get_center_of_mass(masks, masks[::-1])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _band_pred(lines, shape=(72, 150), seed=0):
    """(1, H, W, 2) float band prediction over faint noise: for each (row,
    x0, x1) a top bar at rows [row, row + 3) and a bottom bar at
    [row + 6, row + 9) over columns [x0, x1)."""
    rng = np.random.default_rng(seed)
    pred = 0.2 * rng.random((1,) + shape + (2,), np.float32)
    for row, x0, x1 in lines:
        pred[0, row:row + 3, x0:x1, 0] += 0.8
        pred[0, row + 6:row + 9, x0:x1, 1] += 0.8
    return pred


LINES = [(4, 10, 140), (20, 12, 120), (36, 8, 146), (52, 30, 100)]


def _plan_case(case):
    """-> (band prediction, thresholded_input)."""
    kind, _, turn = case.partition(' ')
    if kind in ('float', 'thresholded'):
        pred = np.rot90(_band_pred(LINES), int(turn) // 90, axes=(2, 1))
        if kind == 'float':
            return np.ascontiguousarray(pred), False
        return (pred > 0.5).astype(np.uint8), True
    pred = _band_pred(LINES)
    if case == 'more tops than bottoms':
        # the top bars break in two over one bottom bar: duplicate picks
        pred[0, :, 60:64, 0] = 0.0
    elif case == 'empty channel':
        pred[..., 1] = 0.0
    elif case == 'full channel':
        pred = (pred > 0.5).astype(np.uint8)
        pred[..., 0] = 1
        return pred, True
    elif case == 'tied centres':
        # two lines side by side (their centres tie in reading order) and
        # a top bar midway between two bottom bars (tied distances)
        pred = _band_pred([(4, 10, 60), (4, 80, 130)])
        pred[0, 40:43, 10:60, 0] += 0.8
        pred[0, 34:37, 10:60, 1] += 0.8
        pred[0, 46:49, 10:60, 1] += 0.8
    return pred, False


@pytest.mark.parametrize('case', [
    'float 0', 'float 90', 'float 180', 'float 270', 'thresholded 0',
    'thresholded 90', 'thresholded 180', 'thresholded 270',
    'more tops than bottoms', 'empty channel', 'full channel',
    'tied centres'])
def test_plan_paragraph_lines_equals_jax(case):
    """The port's planner, on one labelling pass's statistics, against the
    JAX package's on a mask per component: the same bbox slices in the
    same order and the same rotation."""
    pred, thresholded = _plan_case(case)
    got = tinterp.plan_paragraph_lines(pred, thresholded)
    want = jinterp.plan_paragraph_lines(pred, thresholded)
    assert got == want
    bboxes, rotation = got
    if case in ('empty channel', 'full channel'):
        assert bboxes == [] and rotation is None
    else:
        assert len(bboxes) >= 3
    if case.endswith((' 90', ' 180', ' 270')):
        assert rotation == int(case.split()[1])


def test_crop_page_equals_select_and_deskew():
    """OCRPipeline._crop_page's crops (the paragraph's mask formed inside
    its box alone) equal select_paragraph then deskew_paragraph on the
    full-page mask of each paragraph: a level block, a tilted one, and an
    L whose box holds another paragraph."""
    rng = np.random.default_rng(5)
    para = np.zeros((1, 96, 128, 1), np.float32)
    para[0, 4:20, 6:50, 0] = 1.0
    for x in range(60, 120):
        y = 10 + (x - 60) // 4
        para[0, y:y + 9, x, 0] = 1.0
    para[0, 40:90, 8:16, 0] = para[0, 82:90, 8:70, 0] = 1.0
    para[0, 60:70, 30:40, 0] = 1.0
    mono = rng.random(para.shape, np.float32)
    labels, n = ndimage.label(para[0, :, :, 0] > 0)
    assert n == 4
    want = []
    for k in range(1, n + 1):
        mask, selected = tinterp.select_paragraph(
            (labels == k)[None, :, :, None], [mono])
        (crop,) = tinterp.deskew_paragraph(mask, selected)
        want.append(make_divisible_by(crop, 16, 16))
    got = OCRPipeline._crop_page(SimpleNamespace(timers=None), mono, para)
    assert len(got) == n
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert tinterp.find_rotation_angle((labels == 2)[None, :, :, None])


def test_find_objects_never_gets_a_boolean_array(monkeypatch):
    raw = _page(14, True)
    find_objects = tinterp.ndimage.find_objects
    dtypes = []

    def checked(input, *args, **kwargs):
        dtypes.append(np.asarray(input).dtype)
        assert np.asarray(input).dtype != bool
        return find_objects(input, *args, **kwargs)

    monkeypatch.setattr(tinterp.ndimage, 'find_objects', checked)
    assert tinterp.interpret(raw)
    assert len(dtypes) > 2


def test_card_path_modules_import_without_pillow():
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "import univer_ocr_tpu_torch.web.app\n"
        "import univer_ocr_tpu_torch.models.datasets\n"
        "import univer_ocr_tpu_torch.models.evaluation\n"
        "import univer_ocr_tpu_torch.models.train_data_generator\n"
        "import univer_ocr_tpu_torch.eval_accuracy\n"
        "import univer_ocr_tpu_torch.interpreter\n"
        "import univer_ocr_tpu_torch.fonts\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'PIL.'))\n"
        "               or m == 'univer_ocr_tpu'\n"
        "               or m.startswith('univer_ocr_tpu.')\n"
        "               for m in sys.modules), sorted(sys.modules)\n"
        "from univer_ocr_tpu_torch.models.evaluation import "
        "render_eval_pages\n"
        "try:\n"
        "    render_eval_pages(1)\n"
        "except ImportError:\n"
        "    print('no pillow: raised')\n")
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'no pillow: raised'
