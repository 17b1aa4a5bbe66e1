"""The port's OCRPipeline over a mesh (`mesh=make_mesh(devices=[cpu] *
4)`: four 'data' shards on the CPU) against the port's unsharded
pipeline and the JAX package's pipeline over its mesh of 4 of the
conftest's 8 virtual devices, on the pages of tests/test_parallel.py
(`GeneratorDataset(2, 416, 272)` seeded 23, at (1, 288, 432, 1), the
committed checkpoint), in 'highest'.

Bars: the text is exact in the host cascade, the tables mode and the
fused tail (`collapse_runs=4`), for the two pages in one chunk, and in
the host cascade and the tables mode for the first page alone too (a
tail chunk padded over the shards; the fused tail's 1-page call costs
15 s on the CPU, 4 shards of 64-line pools).  The host cascade's sharded
text equals JAX's; the device modes' equals the port's host cascade's
(they compute its crops and line plans, where the JAX package's device
modes lose lines), and they count every paragraph."""

import json
import random

import numpy as np
import pytest
import torch

from univer_ocr_tpu.models.constants import MODEL_WEIGHTS_FILE_PATH
from univer_ocr_tpu.models.datasets import GeneratorDataset
from univer_ocr_tpu.models.pipeline import OCRPipeline as JaxPipeline
from univer_ocr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from univer_ocr_tpu_torch.models import fused_tail
from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
from univer_ocr_tpu_torch.parallel import make_mesh

SHAPE = (1, 288, 432, 1)
N_DATA = 4
MODES = {
    'host': {},
    'tables': dict(device_cascade=True),
    'fused': dict(device_cascade=True, collapse_runs=4),
}


@pytest.fixture(scope='module')
def trained_pages():
    with open(MODEL_WEIGHTS_FILE_PATH) as fp:
        weights = json.load(fp)
    random.seed(23)
    np.random.seed(23)
    dataset = GeneratorDataset(2, 416, 272)
    pages = [dataset.get(i, layer_tags=['image'])['image']
             .astype(np.float32) for i in range(2)]
    return weights, pages


def _pipeline(weights, mode, **kwargs):
    return OCRPipeline(SHAPE, weights=weights, chunk=2, workers=2,
                       device='cpu', **MODES[mode], **kwargs)


@pytest.mark.parametrize('mode', list(MODES))
def test_sharded_text_matches_unsharded_and_jax(trained_pages, mode,
                                                monkeypatch):
    """Every stage's launch batch splits over the 4 shards: the
    Monochrome front of 2 pages (padded to 4) and of 1 page runs one page
    a shard, and the fused tail runs once a shard on DEVICE_BATCH / 4
    paragraphs; the text is the unsharded pipeline's, and the host
    cascade's JAX's."""
    weights, pages = trained_pages
    with _pipeline(weights, mode) as single:
        expected = single.ocr_pages(pages)
    assert any(any(para) for page in expected for para in page)

    fronts, tails = [], []
    monochrome = OCRPipeline._monochrome
    monkeypatch.setattr(OCRPipeline, '_monochrome', lambda self, x: (
        fronts.append(x.shape[0]), monochrome(self, x))[1])
    tail = fused_tail.fused_paragraph_tail
    monkeypatch.setattr(fused_tail, 'fused_paragraph_tail',
                        lambda params, crops, *a, **k: (
                            tails.append(crops.shape[0]),
                            tail(params, crops, *a, **k))[1])
    mesh = make_mesh(devices=[torch.device('cpu')] * N_DATA)
    with _pipeline(weights, mode, mesh=mesh) as sharded:
        assert not sharded._device_planner
        assert sharded.fused_tail == (mode == 'fused')
        got = sharded.ocr_pages(pages)
        stats = dict(sharded.escalation_stats)
        if mode != 'fused':
            assert sharded.ocr_pages(pages[:1]) == expected[:1]
    assert got == expected
    assert fronts == [1] * (N_DATA if mode == 'fused' else 2 * N_DATA)
    batch = OCRPipeline.DEVICE_BATCH // N_DATA
    assert tails == ([batch] * len(tails) if mode == 'fused' else [])
    assert len(tails) % N_DATA == 0 and (mode != 'fused' or tails)

    if mode == 'host':
        jax_sharded = JaxPipeline(SHAPE, weights=weights, chunk=2, workers=2,
                                  mesh=jax_make_mesh(N_DATA,
                                                     model_parallel=1))
        assert jax_sharded.ocr_pages(pages) == expected
    else:
        with _pipeline(weights, 'host', collapse_runs=MODES[mode].get(
                'collapse_runs', False)) as host:
            assert host.ocr_pages(pages) == expected
        assert stats['paragraphs'] == sum(len(page) for page in expected)


def test_mesh_must_divide_the_device_batch():
    mesh = make_mesh(devices=[torch.device('cpu')] * 3)
    with pytest.raises(ValueError, match='DEVICE_BATCH'):
        OCRPipeline(SHAPE, device='cpu', mesh=mesh)
