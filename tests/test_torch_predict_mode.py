"""The per-page PREDICT mode of make_model_system (the whole cascade
through FastLineComponent, FastCharComponent and PredToText) and the
model-system path of models/predict.py (predict_page), against the JAX package's
PREDICT-mode model system on the committed checkpoint, in float32 on
the CPU.

Bars: the text equals JAX's exactly (on the CPU it has on every page
tried), and so do the components, the context's keys and the batch
shapes each bucketed component launches."""

import json

import numpy as np
import pytest
import torch

from univer_ocr_tpu import interpreter as jinterp
from univer_ocr_tpu.models import model as jmodel
from univer_ocr_tpu_torch import interpreter as tinterp
from univer_ocr_tpu_torch.models import model as tmodel
from univer_ocr_tpu_torch.models.constants import TRAIN_FIXTURE
from univer_ocr_tpu_torch.models.datasets import load_page_arrays
from univer_ocr_tpu_torch.models.predict import (load_model_system,
                                                 predict_page)
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT


@pytest.fixture(scope='module')
def weights():
    with open(DEFAULT_CHECKPOINT) as fp:
        return json.load(fp)


@pytest.fixture(scope='module')
def page():
    train, _ = load_page_arrays(TRAIN_FIXTURE)
    return train.get(0, layer_tags=['image'])['image']


def test_predict_mode_text_equals_jax(weights, page, monkeypatch):
    """A whole fixture page through both PREDICT-mode
    model systems: the same component names, context keys and text, and
    the bucketed Line and Char components launch JAX's batch shapes."""
    shapes = {'torch': [], 'jax': []}
    for name in ('line_forward_masked', 'char_forward_masked'):
        def record(params, x, *args, fn=getattr(tmodel, name), **kwargs):
            shapes['torch'].append(tuple(x.shape))
            return fn(params, x, *args, **kwargs)
        monkeypatch.setattr(tmodel, name, record)

    t_sys, _, t_names = tmodel.make_model_system(
        page.shape, weights=weights, mode=tmodel.Modes.PREDICT, device='cpu')
    t_ctx = tmodel.make_context_maker(tmodel.Modes.PREDICT, 'cpu')(
        lambda idx, layer_tags: {'image': page}, (0,))
    t_sys.predict(t_ctx)

    j_sys, _, j_names = jmodel.make_model_system(page.shape, weights=weights)
    for component in j_sys.components:
        if hasattr(component, '_fn'):
            def record(params, x, *args, fn=component._fn):
                shapes['jax'].append(tuple(x.shape))
                return fn(params, x, *args)
            component._fn = record
    j_ctx = jmodel.make_context_maker(jmodel.Modes.PREDICT)(
        lambda idx, layer_tags: {'image': page}, (0,))
    j_sys.predict(j_ctx)

    assert t_names == j_names == ['Monochrome', 'Paragraph', 'ParagraphCrop',
                                  'Line', 'LineCrop', 'Char', 'PredToText']
    assert sorted(t_ctx) == sorted(j_ctx)
    assert sorted(t_ctx['prediction']) == sorted(j_ctx['prediction'])
    assert len(t_ctx['text']) > 1
    assert t_ctx['text'] == j_ctx['text']
    assert shapes['torch'] == shapes['jax'] and len(shapes['jax']) > 2


def test_pred_to_text_equals_jax():
    """PredToText over [paragraph][line] scores, columns whose maximum is
    exactly 0 skipped, with and without collapsing runs."""
    rs = np.random.RandomState(0)
    nested = [[rs.randn(w, 162).astype(np.float32) for w in (30, 5)],
              [], [np.repeat(rs.randn(6, 162), 3, axis=0)]]
    nested[0][0][4] = 0.0
    nested[0][0][7] = -1.0
    for collapse in (False, True):
        with tinterp.PredToText(2, collapse) as pred_to_text:
            got = pred_to_text(nested)
        assert got == jinterp.PredToText(2, collapse)(nested)
        assert [len(p) for p in got] == [2, 0, 1]


def test_predict_page_is_the_model_system_path(weights, page):
    """predict_page (load_model_system + model_system.predict) gives the
    PREDICT-mode text of the committed checkpoint."""
    system = load_model_system(page.shape, device='cpu')
    assert [c.name for c in system.components
            if hasattr(c, 'model')] == ['Monochrome', 'Paragraph', 'Line',
                                        'Char']
    text = predict_page(page, device='cpu')
    t_sys, _, _ = tmodel.make_model_system(
        page.shape, weights=weights, mode=tmodel.Modes.PREDICT, device='cpu')
    context = {'monochrome_X': torch.from_numpy(page.astype(np.float32))}
    t_sys.predict(context)
    assert text == context['text']
