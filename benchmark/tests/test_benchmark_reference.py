"""The plain reference on the CPU: it reads what the port's host cascade
reads, and the committed work table is its shapes' work."""

import json

import numpy as np
import pytest
import torch

from benchmark import check, core

CONFIG = core.load_json(core.BENCH / 'configs' / 'ocr-host-bf16.json')
#: per page, edits over reference characters allowed between the
#: reference and the host cascade in 'highest': the Paragraph and band
#: thresholds compare against means whose float32 sums run in another
#: order in each (torch's reductions against numpy's), so a pixel at a
#: threshold can flip and move a line's crop by one pixel
FLIP_BUDGET = 0.02


@pytest.fixture(scope='module')
def reference():
    torch.set_num_threads(4)
    _, ref, _ = check.load_reference(CONFIG, 'cpu')
    return ref


def test_reference_reads_what_the_host_cascade_reads(reference):
    from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
    from univer_ocr_tpu_torch.weights import load_checkpoint
    pool = core.load_pool()
    pages = [pool[i] for i in (0, 1)]
    with OCRPipeline((1,) + pool.shape[1:] + (1,),
                     load_checkpoint(device='cpu'), chunk=4, workers=2,
                     precision='highest', device='cpu') as pipeline:
        got = pipeline.ocr_pages([p[None, :, :, None] for p in pages])
    for page, answer in zip(pages, got):
        want = check.page_text(reference.read_page(page, False)[0])
        assert len(want) > 1000
        rate = check.levenshtein(check.page_text(answer), want) / len(want)
        assert rate <= FLIP_BUDGET


def test_work_table_is_the_reference_shapes_work(reference):
    work_mod = core.load_module(core.BENCH / 'reference' / 'work.py')
    table = core.load_work()
    page = core.load_pool()[5]
    _, shapes = reference.read_page(page, 4)
    shapes['page'] = table['meta']['page_drawn']
    row = json.loads(json.dumps(work_mod.page_work(shapes)))
    for stage, want in row.items():
        assert table['pages'][5][stage] == want, stage
    assert table['pages'][5]['lines'] == len(shapes['lines'])
    assert table['meta']['weight_bytes'] == work_mod.WEIGHT_BYTES


def test_float8_control_rounds_every_operand():
    x = torch.linspace(-3.0, 3.0, 1001)
    q = check.fp8(x)
    assert len(torch.unique(q)) < 256
    assert float((q - x).abs().max()) <= 3.0 / 8
    assert torch.equal(check.fp8(q), q)


@pytest.mark.parametrize('collapse', [False, True, 4])
def test_decode_is_the_port_decode(collapse):
    from univer_ocr_tpu_torch.interpreter import pred_ids_to_text
    mod = core.load_module(core.BENCH / 'reference' / 'cascade.py')
    assert len(mod.CHARS) == 162
    rng = np.random.default_rng(5)
    for _ in range(300):
        # long runs of few ids, with the look-alike pairs and the blank
        ids = np.repeat(rng.choice([0, 1, 2, 34, 36, 68, 94, 96, 161],
                                   size=12), rng.integers(1, 7, size=12))
        assert mod.decode(ids, collapse) == pred_ids_to_text(
            ids, np.ones(len(ids), bool), collapse)
