"""The port's ground-truth decoder (univer_ocr_tpu_torch/interpreter.py:
interpret and its sort helpers) against the JAX package's, on the CPU:
equal dicts on rendered pages (upright and rotated), the demo page and
degenerate input; equal orders on random point sets.  interpret never
hands ndimage.find_objects a boolean array (newer scipy refuses one).
Every module on the card's path imports without Pillow."""

import random
import subprocess
import sys

import numpy as np
import pytest

from univer_ocr_tpu import image_generator as jgen
from univer_ocr_tpu.interpreter import interpreter as jinterp
from univer_ocr_tpu.models import train_data_generator as jtdg
from univer_ocr_tpu_torch import interpreter as tinterp


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
