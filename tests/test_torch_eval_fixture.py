"""The committed eval corpus, univer_ocr_tpu_torch/fixtures/eval_pages.npz,
which the port's eval gate scores (models/evaluation.py; the card machine
can render no pages: it has no Pillow and no fonts).

It holds `build_eval_corpus(8, seed=123)` (the port's, which renders the
JAX package's pages and truths; tests/test_torch_data_generator.py holds
it to this file): the 8 pages
as uint8 (`pages`, 496x736) and their geometric ground truth (`truths`,
JSON: per page a list of [[paragraph, line], text]), and what the JAX
package's `score_weights` gives for the committed checkpoint in the
gate's configuration (the serving default,
`device_cascade=True`, `collapse_runs=4`, 'bf16', chunk 8) on the CPU:
the decoded text of every page (`texts`) and the `score_results` dict
(`score`).

Regenerate with `JAX_PLATFORMS=cpu python tests/test_torch_eval_fixture.py`.
"""

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / 'univer_ocr_tpu_torch' / 'fixtures' / 'eval_pages.npz'
N_PAGES = 8
SEED = 123
PAGE = (496, 736)


def test_fixture_is_small_and_well_formed():
    assert FIXTURE.stat().st_size <= 1 << 20
    with np.load(FIXTURE) as f:
        pages = f['pages']
        truths = json.loads(str(f['truths']))
        texts = json.loads(str(f['texts']))
        score = json.loads(str(f['score']))
        assert (int(f['seed']), int(f['n_pages'])) == (SEED, N_PAGES)
    assert pages.shape == (N_PAGES,) + PAGE and pages.dtype == np.uint8
    assert len(truths) == len(texts) == N_PAGES
    assert all(truth and all(len(key) == 2 and isinstance(text, str)
                             for key, text in truth) for truth in truths)
    assert all(isinstance(line, str)
               for page in texts for para in page for line in para)
    assert len(score['per_page']) == N_PAGES
    assert 0.5 < score['concat'] <= 1.0


def test_port_reads_the_corpus_as_jax_renders_it():
    """The port's corpus reader gives the pages as float32 (1, H, W, 1)
    arrays of u8 / 255, as JAX's encode_layers does, and the truths; a
    shorter corpus is its first pages, as JAX's generator draws them in
    order from the seed."""
    from univer_ocr_tpu_torch.models.evaluation import eval_corpus
    pages, truths = eval_corpus()
    assert len(pages) == len(truths) == N_PAGES
    assert all(p.shape == (1,) + PAGE + (1,) and p.dtype == np.float32
               for p in pages)
    with np.load(FIXTURE) as f:
        np.testing.assert_array_equal(
            pages[3][0, :, :, 0], f['pages'][3].astype(np.float32) / 255.0)
    two, two_truths = eval_corpus(2)
    assert len(two) == 2 and two_truths == truths[:2]
    assert all(isinstance(key, tuple) for key in truths[0])


def generate():
    """Render the corpus with the port and score the committed checkpoint
    with JAX."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    sys.path.insert(0, str(ROOT))
    from univer_ocr_tpu.models.evaluation import score_results
    from univer_ocr_tpu.models.pipeline import OCRPipeline
    from univer_ocr_tpu_torch.models.evaluation import build_eval_corpus
    from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

    pages, truths = build_eval_corpus(N_PAGES, SEED)
    assert all(p.shape == (1,) + PAGE + (1,) for p in pages)
    u8 = np.stack([np.round(p[0, :, :, 0] * 255.0).astype(np.uint8)
                   for p in pages])
    assert all(np.array_equal(u8[i].astype(np.float32) / 255.0,
                              pages[i][0, :, :, 0]) for i in range(N_PAGES))
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    # evaluation.score_weights, with the texts kept
    pipe = OCRPipeline((1,) + PAGE + (1,), weights=weights,
                       collapse_runs=4, chunk=8, device_cascade=True,
                       precision='bf16')
    texts = pipe.ocr_pages(pages)
    score = score_results(truths, texts)
    print(json.dumps(score))
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        FIXTURE, pages=u8, truths=np.array(json.dumps(
            [[[list(key), text] for key, text in sorted(truth.items())]
             for truth in truths])),
        texts=np.array(json.dumps(texts)), score=np.array(json.dumps(score)),
        seed=np.array(SEED), n_pages=np.array(N_PAGES))
    print(f'{FIXTURE}: {FIXTURE.stat().st_size} bytes')


if __name__ == '__main__':
    generate()
