"""The port's page generator (univer_ocr_tpu_torch/image_generator,
fonts, models/train_data_generator.render_page) against the JAX
package's, on the CPU: the port draws from an explicit random.Random(s)
and the JAX package from the module-level random after random.seed(s),
and every layer must come out equal byte for byte (no tolerance)."""

import random

import numpy as np
import pytest

from univer_ocr_tpu import image_generator as jgen
from univer_ocr_tpu import primitives as jprim
from univer_ocr_tpu.models import train_data_generator as jtdg
from univer_ocr_tpu_torch import fonts, image_generator as tgen
from univer_ocr_tpu_torch.models import train_data_generator as ttdg


def _assert_layers_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        assert got[name].mode == want[name].mode, name
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]), err_msg=name)


def test_layer_names_and_font_registry():
    assert tgen.LayeredImage.layer_names == jgen.LayeredImage.layer_names
    assert len(tgen.LayeredImage.layer_names) == 17
    assert [(f.name, f.normal_path, f.bold_path, f.italic_path,
             f.bold_italic_path) for f in fonts.FONTS_LIST] == [
        (f.name, f.normal_path, f.bold_path, f.italic_path,
         f.bold_italic_path) for f in jprim.FONTS_LIST]
    assert list(fonts.FONTS_DICT) == list(jprim.FONTS_DICT)


def test_random_font_and_text_draw_as_jax():
    rng = random.Random(17)
    ours = [(tgen.random_font(rng, 12, 36), tgen.random_text(rng))
            for _ in range(25)]
    random.seed(17)
    theirs = [(jgen.random_font(12, 36), jgen.random_text())
              for _ in range(25)]
    for (f1, t1), (f2, t2) in zip(ours, theirs):
        assert (f1.path, f1.size) == (f2.path, f2.size)
        assert t1 == t2
    assert rng.random() == random.random()


@pytest.mark.parametrize('seed, rotate', [(1, False), (2, True), (3, False),
                                          (4, True)])
def test_render_page_equals_jax(seed, rotate):
    ours = ttdg.render_page(720, 480, rotate, rng=random.Random(seed))
    random.seed(seed)
    _assert_layers_equal(ours, jtdg.render_page(720, 480, rotate))


def test_generate_demo_equals_jax():
    raw, demo = tgen.generate_demo(960, 540, random.Random(5))
    random.seed(5)
    j_raw, j_demo = jgen.generate_demo(960, 540)
    _assert_layers_equal(raw, j_raw)
    _assert_layers_equal(demo, j_demo)


def test_to_bytesio_is_the_png_of_the_layer():
    from PIL import Image
    page = ttdg.render_page(360, 240, rng=random.Random(0))
    png = tgen.to_bytesio(page['paragraph']).read()
    assert png == jgen.to_bytesio(page['paragraph']).read()
    import io
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  np.asarray(page['paragraph']))
