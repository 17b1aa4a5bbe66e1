"""The serving default (`OCRPipeline(device_cascade=True,
collapse_runs=4)`: the device planners, the band labelling and the fused
tail) against the benchmark's plain reference (benchmark/reference/
cascade.py: plain PyTorch in float32 and scipy, a frozen copy of the host
cascade's arithmetic, nothing of the program), on pool pages 0-7 of the
benchmark (benchmark/data/pages.npz), in 'highest' on the CPU.

Bars: the reference's 42 paragraphs and 138 lines, and its text, each
line equal (measured: every line equal, `cer` 0.0; the limit of the
`fused-batch32` cell's check is 0.07), through the chunk path (one call
of the 8 pages) and through the single-page chain (the first pages,
each alone).
Differences that remain are listed here: none."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / 'benchmark'
N_PAGES = 8
#: the reference's counts on pool pages 0-7
PARAGRAPHS, LINES = 42, 138
#: lines that may differ from the reference's: none
DIFFERENCES = []
#: pages the single-page chain reads, one call each, and their lines
CHAIN_PAGES, CHAIN_LINES = 3, 50


def _levenshtein(a, b):
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _text(page):
    return '\n\n'.join('\n'.join(lines) for lines in page)


@pytest.fixture(scope='module')
def pool():
    with np.load(BENCH / 'data' / 'pages.npz') as f:
        return f['pages'][:N_PAGES]


@pytest.fixture(scope='module')
def reference(pool):
    spec = importlib.util.spec_from_file_location(
        'bench_cascade', BENCH / 'reference' / 'cascade.py')
    cascade = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cascade)
    ref = cascade.Reference(cascade.load_weights(DEFAULT_CHECKPOINT, 'cpu'),
                            'cpu')
    return [ref.read_page(page, 4)[0] for page in pool]


@pytest.fixture(scope='module')
def serving(pool):
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    pipeline = OCRPipeline((1, 496, 736, 1), weights=weights, chunk=N_PAGES,
                           workers=4, collapse_runs=4, precision='highest',
                           device='cpu', device_cascade=True)
    with pipeline:
        assert pipeline.fused_tail and pipeline._device_planner
        yield pipeline


def _check(got, want):
    assert sum(len(page) for page in got) == PARAGRAPHS
    assert sum(len(p) for page in got for p in page) == LINES
    differ = [(i, k, j) for i, (page, page_w) in enumerate(zip(got, want))
              for k, (para, para_w) in enumerate(zip(page, page_w))
              for j, (line, line_w) in enumerate(zip(para, para_w))
              if line != line_w]
    assert differ == DIFFERENCES
    edits = sum(_levenshtein(_text(g), _text(w)) for g, w in zip(got, want)
                if g != w)
    assert edits / sum(len(_text(w)) for w in want) <= 0.01


def test_reference_counts(reference):
    assert sum(len(page) for page in reference) == PARAGRAPHS
    assert sum(len(p) for page in reference for p in page) == LINES


def test_serving_default_chunk_reads_the_reference_text(serving, pool,
                                                        reference):
    got = serving.ocr_pages([page[None, :, :, None] for page in pool])
    _check(got, reference)
    assert serving.escalation_stats['paragraphs'] == PARAGRAPHS
    assert 'chain_fallback' not in serving.escalation_stats


def test_single_page_chain_reads_the_reference_text(serving, pool,
                                                    reference):
    """The first CHAIN_PAGES pages, each alone."""
    got = [serving.ocr_pages([page[None, :, :, None]])[0]
           for page in pool[:CHAIN_PAGES]]
    want = reference[:CHAIN_PAGES]
    assert got == want
    assert sum(len(p) for page in got for p in page) == CHAIN_LINES
    assert 'chain_fallback' not in serving.escalation_stats
