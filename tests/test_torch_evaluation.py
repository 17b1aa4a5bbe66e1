"""The end-to-end evaluation and the eval gate (univer_ocr_tpu_torch.
models.evaluation) against the JAX package's (univer_ocr_tpu/models/
evaluation.py), and the gate's wiring into both trainers: the cases of
tests/test_evaluation.py on the port.

Bars: the scores are equal exactly (the same text gives the same
SequenceMatcher ratios); the committed checkpoint's text and per-page
score on the eval corpus, through the serving default in 'bf16' on the
CPU, equal the port's host cascade's in the same configuration (the
serving default computes the host cascade's crops and line plans; the
JAX package's serving default, whose text fixtures/eval_pages.npz
stores, loses lines the host cascade reads, so it is no longer the
oracle here).  On all 8 pages the text holds a stated budget (one line
off by one glyph, the score within 2e-4)."""

import json

import numpy as np
import pytest

from univer_ocr_tpu.models import evaluation as jeval
from univer_ocr_tpu_torch.models import evaluation as teval
from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

QUIET = dict(log=lambda *a: None)


class FakeModel:
    def __init__(self, weights):
        self._w = weights

    def get_weights(self):
        return self._w


def _both_gates(path, scores, **kwargs):
    """The port's gate and JAX's over the same score sequence."""
    return [module.make_eval_gate(str(path), score_fn=lambda w, it=iter(
                scores): next(it), **QUIET, **kwargs)
            for module in (teval, jeval)]


def test_eval_gate_reject_keeps_approve_ratchets(tmp_path):
    path = tmp_path / 'w.json'
    path.write_text(json.dumps({'a': [1]}))
    gates = _both_gates(path, [0.5,    # incumbent, from the checkpoint
                               0.4,    # a regression: rejected
                               0.6,    # an improvement: approved
                               0.55])  # below the ratcheted incumbent
    expected = [(False, 0.4, 0.5), (True, 0.6, 0.6), (False, 0.55, 0.6)]
    for gate in gates:
        assert [gate({'m': FakeModel({'b': [i]})})
                for i in range(3)] == expected


def test_eval_gate_scores_checkpoint_overlaid_with_candidates(tmp_path):
    path = tmp_path / 'w.json'
    path.write_text(json.dumps({'keep': [1], 'replace': [2]}))
    seen = []

    def score(weights):
        seen.append(dict(weights))
        return 1.0

    gate = teval.make_eval_gate(str(path), score_fn=score, **QUIET)
    gate({'m': FakeModel({'replace': [9], 'new': [3]})})
    assert seen[0] == {'keep': [1], 'replace': [2]}          # incumbent
    assert seen[1] == {'keep': [1], 'replace': [9], 'new': [3]}


def test_eval_gate_margin_and_missing_checkpoint(tmp_path):
    path = tmp_path / 'w.json'
    path.write_text(json.dumps({'a': [1]}))
    for gate in _both_gates(path, [0.50, 0.49], margin=0.02):
        ok, _, incumbent = gate({'m': FakeModel({})})
        assert ok and incumbent == 0.50   # max() keeps the higher one
    # no checkpoint file: the incumbent is -1, anything is approved
    for gate in _both_gates(tmp_path / 'none.json', [0.1]):
        assert gate({'m': FakeModel({})}) == (True, 0.1, 0.1)


TRUTHS = [{(0, 0): 'hello', (1, 0): 'world'},
          {(0, 0): 'alpha beta', (0, 1): 'gamma СC delta',
           (1, 0): 'x'}]
RESULTS = [
    [[['hello'], ['world']], [['alpha beta', 'gamma CC delta'], ['y']]],
    [[], [['gamma delta'], ['alpha beta', 'junk']]],
    [[['helo', 'word']], [['gamma CС delta', 'alpha beta', 'x']]],
]


@pytest.mark.parametrize('results', range(len(RESULTS)))
def test_score_results_equal_jax(results):
    got = teval.score_results(TRUTHS, RESULTS[results])
    assert got == jeval.score_results(TRUTHS, RESULTS[results])


def test_score_results_exact_and_degenerate():
    truths = [{'0_0': 'hello', '1_0': 'world'}]
    perfect = teval.score_results(truths, [[['hello'], ['world']]])
    assert perfect['concat'] == 1.0
    assert perfect['matched'] == pytest.approx(1.0)
    assert perfect['exact_lines'] == 2 and perfect['total_lines'] == 2
    empty = teval.score_results(truths, [[]])
    assert empty['concat'] < 0.1 and empty['exact_lines'] == 0


@pytest.mark.parametrize('pred', [['gamma delta', 'alpha beta'],
                                  ['gamma delta', 'alpha beta', 'junk'],
                                  [], ['alpha', ' beta gamma ']])
def test_line_matched_similarity_equals_jax(pred):
    true_lines = ['alpha beta', 'gamma delta']
    got = teval.line_matched_similarity(true_lines, pred)
    assert got == jeval.line_matched_similarity(true_lines, pred)
    if pred == ['gamma delta', 'alpha beta']:
        assert got == pytest.approx(1.0)      # order-independent
    if 'junk' in pred:
        assert 0.5 < got < 1.0                # an extra line dilutes


def test_canonical_maps_similar_pairs():
    from univer_ocr_tpu.primitives import SIMILAR_CHARS_PAIRS_LIST
    for ru, en in SIMILAR_CHARS_PAIRS_LIST:
        assert teval.canonical(ru) == teval.canonical(en) == \
            jeval.canonical(ru)
    text = ''.join(ru for ru, _ in SIMILAR_CHARS_PAIRS_LIST) + 'abc'
    assert teval.canonical(text) == jeval.canonical(text)


def test_eval_corpus_refuses_another_corpus():
    with pytest.raises(ValueError, match='seed 123'):
        teval.eval_corpus(8, seed=5)
    with pytest.raises(ValueError, match='9'):
        teval.eval_corpus(9)


@pytest.fixture(scope='module')
def host_texts():
    """The port's host cascade's text of the 8 eval pages in the gate's
    configuration (collapse 4, 'bf16', chunk 8) on the CPU, and its
    score_results dict."""
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    pages, truths = teval.eval_corpus(8)
    with OCRPipeline((1, 496, 736, 1), weights=weights, collapse_runs=4,
                     chunk=8, precision='bf16', device='cpu') as host:
        texts = host.ocr_pages(pages)
    return texts, jeval.score_results(truths, texts)


def test_score_weights_of_the_checkpoint_equals_jax(host_texts):
    """The gate's own scoring (score_weights: the serving default,
    collapse 4, 'bf16') of the committed checkpoint on the eval corpus's
    first two pages: the host cascade's text and per-page scores."""
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    texts, score = host_texts
    pages, truths = teval.eval_corpus(2)
    seen = []

    class Recorded(OCRPipeline):
        def ocr_pages(self, pages):
            results = super().ocr_pages(pages)
            seen.extend(results)
            return results

    got = teval.score_weights(weights, pages, truths, device='cpu',
                              pipeline_cls=Recorded)
    assert seen == texts[:2]
    assert got['per_page'] == score['per_page'][:2]
    assert got == jeval.score_results(truths, texts[:2])


def _edit_distance(a, b):
    row = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, cb in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1,
                                       prev + (ca != cb))
    return row[-1]


#: the budget of the whole corpus in 'bf16' on the CPU: lines that may
#: differ from the host cascade's text, glyphs per such line, and the
#: concat score's distance from its score (measured: equal)
CORPUS_LINES, CORPUS_GLYPHS, CORPUS_SCORE_ABS = 1, 1, 2e-4


def test_score_weights_of_the_checkpoint_on_the_whole_corpus(host_texts):
    """score_weights of the committed checkpoint on all 8 eval pages: the
    same paragraphs and lines as the host cascade's text, at most
    CORPUS_LINES lines differing, each by at most CORPUS_GLYPHS glyphs
    (edit distance), and the score within CORPUS_SCORE_ABS of its."""
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    texts, score = host_texts
    pages, truths = teval.eval_corpus(8)
    seen = []

    class Recorded(OCRPipeline):
        def ocr_pages(self, pages):
            results = super().ocr_pages(pages)
            seen.extend(results)
            return results

    got = teval.score_weights(weights, pages, truths, device='cpu',
                              pipeline_cls=Recorded)
    assert [[len(p) for p in page] for page in seen] == \
        [[len(p) for p in page] for page in texts]
    off = [(i, p, k, _edit_distance(a, b))
           for i, (page, page_j) in enumerate(zip(seen, texts))
           for p, (para, para_j) in enumerate(zip(page, page_j))
           for k, (a, b) in enumerate(zip(para, para_j)) if a != b]
    assert len(off) <= CORPUS_LINES, off
    assert all(d <= CORPUS_GLYPHS for *_, d in off), off
    assert got['concat'] == pytest.approx(score['concat'],
                                          abs=CORPUS_SCORE_ABS)


# ---------------------------------------------------------------------------
# Trainer integration: the gate controls checkpoint overwrites
# ---------------------------------------------------------------------------


def test_batched_stage_gate_blocks_checkpoint(tmp_path):
    from univer_ocr_tpu_torch.models.dp_train import train_stage_batched
    from univer_ocr_tpu_torch.models.model import Modes

    rs = np.random.RandomState(0)
    samples = [(rs.rand(1, 40, 100, 1).astype(np.float32),
                (rs.rand(1, 40, 100, 2) > 0.7).astype(np.float32))
               for _ in range(4)]
    path = tmp_path / 'w.json'
    path.write_text(json.dumps({'sentinel': [1]}))
    before = path.read_bytes()
    calls = []

    def rejecting_gate(models):
        calls.append(sorted(models))
        return False, 0.1, 0.5

    kwargs = dict(epochs=1, lr=1e-3, lr_step=0.995, batch=4,
                  input_shape=(1, 256, 320, 1), checkpoint_path=str(path),
                  device='cpu', **QUIET)
    train_stage_batched(Modes.TRAIN_LINE, samples, samples[:1], {},
                        eval_gate=rejecting_gate, **kwargs)
    assert calls == [['Line']]
    assert path.read_bytes() == before              # kept verbatim

    train_stage_batched(Modes.TRAIN_LINE, samples, samples[:1], {},
                        eval_gate=lambda m: (True, 0.9, 0.5), **kwargs)
    written = json.loads(path.read_text())
    assert 'sentinel' in written            # merge-saving writer
    assert any(k.startswith('Line') for k in written)


def test_per_sample_trainer_gate_blocks_save():
    from test_torch_trainer import StubDataset, make_setup
    from univer_ocr_tpu_torch.models.trainer import Trainer
    from univer_ocr_tpu_torch.nn.progress_tracker import BaseProgressTracker

    for approve, expect_saved in ((False, False), (True, True)):
        system, models, optimizer, context_fn = make_setup()
        saved, offered = [], []

        def gate(models, approve=approve):
            offered.append(sorted(models))
            return approve, 0.5, 0.5

        Trainer(system, context_fn, models, StubDataset(2),
                StubDataset(1, seed=1),
                progress_tracker=BaseProgressTracker(), optimizer=optimizer,
                save_weights_func=lambda names: saved.append(list(names)),
                eval_gate=gate).train(num_epochs=1)
        assert offered == [['Monochrome']]
        assert bool(saved) is expect_saved
