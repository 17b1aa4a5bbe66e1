"""End-to-end OCR accuracy and the trainers' eval gate
(univer_ocr_tpu/models/evaluation.py).

Stage-local validation loss does not predict end-to-end OCR quality (two
JAX rounds improved every stage's validation loss while the decoded text
collapsed), so a stage result may replace a checkpoint only when the text
it decodes does not regress:

  * `build_eval_corpus` — the seeded fixed corpus, rendered (Pillow and
    fonts, which the card machine lacks) with its geometric ground truth
    (interpreter.interpret on the mask layers); the same pages and truths
    as the JAX package's `build_eval_corpus`;
  * `eval_corpus` — that corpus at its defaults (8 pages, seed 123), read
    from the committed fixture fixtures/eval_pages.npz: the card's source;
  * `score_weights` — decoded-text similarity of a weight dict through the
    serving OCRPipeline configuration;
  * `make_eval_gate` — the save-time gate of both trainers.
"""

import json
import random
from difflib import SequenceMatcher
from pathlib import Path

import numpy as np

from ..interpreter import interpret
from ..nn.checkpoint import read_weights
from ..primitives import SIMILAR_CHARS_PAIRS_LIST

#: the committed corpus: JAX's build_eval_corpus(8, seed=123), its pages
#: as uint8 (tests/test_torch_eval_fixture.py writes it)
EVAL_FIXTURE = (Path(__file__).resolve().parents[1] / 'fixtures'
                / 'eval_pages.npz')

#: look-alike canonicalization: the registered RU/EN similar pairs render
#: pixel-identically, so a С-for-C read is not a model error; both sides
#: map through one representative
_CANON = {ru: en for ru, en in SIMILAR_CHARS_PAIRS_LIST}


def canonical(text):
    return ''.join(_CANON.get(c, c) for c in text)


def render_eval_pages(n_pages=8, seed=123, width=720, height=480):
    """The corpus's pages as raw {layer_name: PIL image} dicts: each page
    places paragraphs in rounds of 100 attempts until one lands, then is
    padded to /16, every draw from one `random.Random(seed)`."""
    from ..image_generator import LayeredImage, random_font, random_text
    rng = random.Random(seed)
    pages = []
    for _ in range(n_pages):
        img = LayeredImage(width, height, (255, 255, 255, 255), rng)
        while img.paragraphs_added == 0:
            for _ in range(100):
                img.add_paragraph(random_text(rng), random_font(rng, 12, 36))
        img.make_divisible_by(16, 16)
        pages.append(img.get_raw())
    return pages


def build_eval_corpus(n_pages=8, seed=123, width=720, height=480):
    """Seeded pages and their geometric ground truth: ([(1, H, W, 1)
    float32 page], [{(paragraph, line): text}])."""
    pages, truths = [], []
    for raw in render_eval_pages(n_pages, seed, width, height):
        truths.append(interpret(raw))
        gray = np.asarray(raw['image'].convert('L'))
        pages.append((gray / 255.0).astype(np.float32)[None, :, :, None])
    return pages, truths


def eval_corpus(n_pages=8, seed=123, path=EVAL_FIXTURE):
    """JAX's `build_eval_corpus(n_pages, seed)`, read from the fixture:
    ([(1, H, W, 1) float32 page], [{(paragraph, line): text}]).  The
    generator draws pages in order from its seed, so a shorter corpus is
    the fixture's first pages; any other seed or size raises."""
    with np.load(path) as f:
        stored_seed, stored_pages = int(f['seed']), int(f['n_pages'])
        if seed != stored_seed or not 0 < n_pages <= stored_pages:
            raise ValueError(
                f'{path} holds the eval corpus of seed {stored_seed}, '
                f'{stored_pages} pages; asked for seed {seed}, {n_pages}')
        u8 = f['pages'][:n_pages]
        truths = json.loads(str(f['truths']))[:n_pages]
    pages = [(page.astype(np.float32) / 255.0)[None, :, :, None]
             for page in u8]
    return pages, [{tuple(key): text for key, text in truth}
                   for truth in truths]


def score_results(truths, results):
    """Similarity metrics of decoded pipeline output vs ground truth."""
    ratios, canon, matched = [], [], []
    exact = exact_canon = total_lines = 0
    for truth, result in zip(truths, results):
        true_lines = [truth[k] for k in sorted(truth)]
        pred_lines = [line for para in result for line in para]
        true_text = '\n'.join(true_lines)
        pred_text = '\n'.join(pred_lines)
        ratios.append(
            SequenceMatcher(None, true_text, pred_text).ratio())
        canon.append(SequenceMatcher(None, canonical(true_text),
                                     canonical(pred_text)).ratio())
        matched.append(line_matched_similarity(true_lines, pred_lines))
        total_lines += len(true_lines)
        pred_set = set(pred_lines)
        exact += sum(1 for line in true_lines if line in pred_set)
        canon_set = {canonical(p) for p in pred_lines}
        exact_canon += sum(1 for line in true_lines
                           if canonical(line) in canon_set)
    return {
        'concat': float(np.mean(ratios)),
        'canonical': float(np.mean(canon)),
        'matched': float(np.mean(matched)),
        'exact_lines': exact,
        'exact_lines_canonical': exact_canon,
        'total_lines': total_lines,
        'per_page': ratios,
    }


def line_matched_similarity(true_lines, pred_lines):
    """Order-independent page score: greedily match each true line to its
    most-similar unused predicted line; char-weighted mean of the match
    ratios, unmatched predicted chars diluting the denominator."""
    true_lines = [t.strip() for t in true_lines]
    pred = [p.strip() for p in pred_lines]
    pairs = sorted(
        ((SequenceMatcher(None, t, p).ratio(), ti, pi)
         for ti, t in enumerate(true_lines)
         for pi, p in enumerate(pred)),
        key=lambda x: -x[0])
    used_t, used_p = set(), set()
    num = 0.0
    for r, ti, pi in pairs:
        if ti in used_t or pi in used_p:
            continue
        used_t.add(ti)
        used_p.add(pi)
        num += r * len(true_lines[ti])
    den = (sum(len(t) for t in true_lines)
           + sum(len(p) for i, p in enumerate(pred) if i not in used_p))
    return num / max(den, 1)


def score_weights(weights, pages, truths, collapse=4, chunk=8,
                  precision='bf16', device_cascade=True,
                  page_shape=(1, 496, 736, 1), pipeline_cls=None,
                  device=None):
    """Run the serving pipeline configuration on the eval corpus and
    score the decoded text.  `collapse` is the decode run-length filter
    (collapse_runs; 4 is the serving decode).  A fresh pipeline per call,
    closed after it: the kernels' weights are prepared from `weights`."""
    if pipeline_cls is None:
        from .pipeline import OCRPipeline as pipeline_cls
    with pipeline_cls(page_shape, weights=weights, collapse_runs=collapse,
                      chunk=chunk, device_cascade=device_cascade,
                      precision=precision, device=device) as pipe:
        return score_results(truths, pipe.ocr_pages(pages))


def make_eval_gate(checkpoint_path, n_pages=8, seed=123, collapse=4,
                   margin=0.0, device_cascade=True, precision='bf16',
                   page_shape=(1, 496, 736, 1), log=print,
                   score_fn=None, device=None):
    """Save-time gate: `gate(models) -> (ok, score, incumbent)`.

    `models` is a {name: model} dict of candidate stage results.  The
    candidate weights are the checkpoint at `checkpoint_path` overlaid
    with the candidates'; the gate scores them end to end on the eval
    corpus and approves only if the concat similarity does not fall below
    the incumbent score by more than `margin`.  The incumbent is scored
    from the checkpoint file on first use and advances on every approval,
    so a later stage cannot ratchet quality back down.

    `score_fn(weights) -> float` replaces the scoring (unit tests).
    """
    state = {'incumbent': None, 'corpus': None}

    def default_score(weights):
        if state['corpus'] is None:
            state['corpus'] = eval_corpus(n_pages, seed)
        pages, truths = state['corpus']
        return score_weights(weights, pages, truths, collapse=collapse,
                             device_cascade=device_cascade,
                             precision=precision, page_shape=page_shape,
                             device=device)['concat']

    score = score_fn or default_score

    def gate(models):
        weights = read_weights(checkpoint_path)
        if state['incumbent'] is None:
            state['incumbent'] = score(weights) if weights else -1.0
            log(f'[eval-gate] incumbent end-to-end score: '
                f'{state["incumbent"]:.4f}')
        candidate = dict(weights)
        for model in models.values():
            candidate.update(model.get_weights())
        cand_score = score(candidate)
        ok = cand_score >= state['incumbent'] - margin
        log(f'[eval-gate] candidate {cand_score:.4f} vs incumbent '
            f'{state["incumbent"]:.4f}: '
            f'{"APPROVE" if ok else "REJECT (checkpoint kept)"}')
        if ok:
            state['incumbent'] = max(state['incumbent'], cand_score)
        return ok, cand_score, state['incumbent']

    return gate
