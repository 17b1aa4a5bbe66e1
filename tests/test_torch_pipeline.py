"""The port's host-cascade OCRPipeline against the JAX package's
(OCRPipeline with device_cascade=False) on the committed checkpoint:
per-page text equal on freshly rendered 720x480 pages (the bench page
shape after /16 padding), with quantized transfers on and off.

No flip budget: on the CPU the port's text has equalled the JAX text
exactly on every page tried (6 pages, 1, 3 and 8 torch threads), so any
difference is a fault."""

import json
import random

import numpy as np
import pytest
import torch

from univer_ocr_tpu.models.datasets import GeneratorDataset
from univer_ocr_tpu.models.pipeline import OCRPipeline as JaxPipeline
from univer_ocr_tpu_torch.device import resolve_device
from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
from univer_ocr_tpu_torch.models.predict import predict
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT, load_checkpoint

PAGE_SHAPE = (1, 496, 736, 1)   # 720x480 page after /16 padding


@pytest.fixture(scope='module')
def weights():
    with open(DEFAULT_CHECKPOINT) as fp:
        return json.load(fp)


@pytest.fixture(scope='module')
def pages():
    random.seed(42)
    np.random.seed(42)
    dataset = GeneratorDataset(2, 720, 480)
    return [dataset.get(i, layer_tags=['image'])['image'].astype(np.float32)
            for i in range(2)]


@pytest.mark.parametrize('quantized', [True, False])
def test_text_equals_jax_host_cascade(weights, pages, quantized):
    assert pages[0].shape == PAGE_SHAPE
    expected = JaxPipeline(PAGE_SHAPE, weights=weights, chunk=2, workers=2,
                           quantized_transfers=quantized,
                           device_cascade=False, precision='highest',
                           collapse_runs=4, use_pallas=False
                           ).ocr_pages(pages)
    with OCRPipeline(PAGE_SHAPE, weights=weights, chunk=2, workers=2,
                     quantized_transfers=quantized, precision='highest',
                     collapse_runs=4, device='cpu') as pipeline:
        got = pipeline.ocr_pages(pages)
    assert sum(len(para) for page in expected for para in page) > 0
    assert got == expected


def test_blank_page_matches_jax(weights):
    blank = [np.ones(PAGE_SHAPE, np.float32)]
    expected = JaxPipeline(PAGE_SHAPE, weights=weights, chunk=2, workers=1,
                           use_pallas=False).ocr_pages(blank)
    with OCRPipeline(PAGE_SHAPE, weights=load_checkpoint(device='cpu'),
                     chunk=2, workers=1, device='cpu') as pipeline:
        assert pipeline.ocr_pages(blank) == expected


def test_predict_writes_result(tmp_path, pages):
    page = np.round(pages[0][0, :480, :720, 0] * 255).astype(np.uint8)
    np.save(tmp_path / 'page.npy', page)
    text = predict(tmp_path / 'page.npy', tmp_path / 'out', device='cpu')
    assert (tmp_path / 'out' / 'result.txt').read_text() == f'{text}\n'
    assert len(text) > 0


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        OCRPipeline(PAGE_SHAPE, device='cuda')
