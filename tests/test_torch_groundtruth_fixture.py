"""The committed ground-truth corpus, univer_ocr_tpu_torch/fixtures/
eval_layers.npz, which the card reads (it has no Pillow and no fonts).

It holds the eval corpus (8 pages of seed 123, the pages of
eval_pages.npz) with all 17 layers as uint8 (`layers`, planar: (8, 17,
496, 736), the image layer as 8-bit gray; `layer_names`), rendered by the
port's own generator (models/evaluation.render_eval_pages), and what the
JAX package
gives for those pages on the CPU: `interpret` of each page (`truths`,
JSON: per page a list of [[paragraph, line], text]) and the line texts
of scripts/eval_accuracy.py's `main_gt_crops` for the committed
checkpoint (`gt_crops_highest`, `gt_crops_bf16`: per page a list of
lines; the decode's default collapse).

Regenerate with `JAX_PLATFORMS=cpu python tests/test_torch_groundtruth_
fixture.py` (~2 min).
"""

import json
import sys
from difflib import SequenceMatcher
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / 'univer_ocr_tpu_torch' / 'fixtures' / 'eval_layers.npz'
EVAL_PAGES = ROOT / 'univer_ocr_tpu_torch' / 'fixtures' / 'eval_pages.npz'
N_PAGES = 8
SEED = 123
PAGE = (496, 736)
LAYER_NAMES = ['image', 'image_monochrome', 'paragraph', 'line_top',
               'line_center', 'line_bottom', 'letter_spacing',
               'char_mask_box', 'char_full_box'] + [f'bit_{i}'
                                                    for i in range(8)]


def _stored():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def test_fixture_is_small_and_well_formed():
    assert FIXTURE.stat().st_size <= 1 << 20
    f = _stored()
    assert (int(f['seed']), int(f['n_pages'])) == (SEED, N_PAGES)
    assert json.loads(str(f['layer_names'])) == LAYER_NAMES
    assert f['layers'].shape == (N_PAGES, 17) + PAGE
    assert f['layers'].dtype == np.uint8
    truths = json.loads(str(f['truths']))
    assert len(truths) == N_PAGES and all(truths)
    for key in ('gt_crops_highest', 'gt_crops_bf16'):
        texts = json.loads(str(f[key]))
        assert len(texts) == N_PAGES
        assert all(isinstance(line, str) for page in texts for line in page)


def test_fixture_is_the_ports_render_of_the_eval_corpus():
    """The port's generator gives the stored layers byte for byte, and
    their image layer is eval_pages.npz's page."""
    from univer_ocr_tpu_torch.models.evaluation import render_eval_pages
    layers = _stored()['layers']
    for i, raw in enumerate(render_eval_pages(N_PAGES, SEED)):
        for c, name in enumerate(LAYER_NAMES):
            np.testing.assert_array_equal(
                np.asarray(raw[name].convert('L')), layers[i, c],
                err_msg=f'page {i} {name}')
    with np.load(EVAL_PAGES) as f:
        np.testing.assert_array_equal(layers[:, 0], f['pages'])


def test_port_interprets_the_stored_layers_as_jax():
    """interpret() of the uint8 layers equals JAX's interpret of the
    rendered pages, on every page."""
    from univer_ocr_tpu_torch.eval_accuracy import load_layer_pages
    from univer_ocr_tpu_torch.interpreter import interpret
    truths = json.loads(str(_stored()['truths']))
    for page, truth in zip(load_layer_pages(FIXTURE, N_PAGES), truths):
        assert interpret(page) == {tuple(k): text for k, text in truth}


@pytest.mark.parametrize('precision, bar', [('highest', 0.99),
                                            ('bf16', 0.9)])
def test_gt_crops_read_as_jax(precision, bar):
    """eval_accuracy.main_gt_crops on the stored layers (2 pages) on the
    CPU: each page's lines against JAX's stored lines at the card's
    bars."""
    from univer_ocr_tpu_torch.eval_accuracy import main_gt_crops
    stored = json.loads(str(_stored()[f'gt_crops_{precision}']))
    ratios, texts = main_gt_crops(2, precision=precision,
                                  pages_path=FIXTURE, device='cpu',
                                  log=lambda *a: None)
    assert len(ratios) == 2
    for got, want in zip(texts, stored):
        assert SequenceMatcher(None, '\n'.join(want), '\n'.join(got),
                               autojunk=False).ratio() >= bar


def _jax_gt_crop_texts(raw_pages, precision, weights):
    """scripts/eval_accuracy.py main_gt_crops' loop on JAX's rendered
    pages, with each page's lines kept."""
    from univer_ocr_tpu.interpreter.interpreter import (
        crop_and_rotate_single_paragraph, label_layer, pred_ids_to_text)
    from univer_ocr_tpu.models.datasets import encode_layers
    from univer_ocr_tpu.models.model import (CHAR_FIXED_WIDTH,
                                             CHAR_INPUT_HEIGHT,
                                             make_divisible_by)
    from univer_ocr_tpu.models.pipeline import (OCRPipeline,
                                                crop_lines_of_paragraph)
    pipe = OCRPipeline((1,) + PAGE + (1,), weights=weights,
                       collapse_runs=True, precision=precision)
    texts = []
    for raw in raw_pages:
        mono = encode_layers(
            {'image_monochrome': raw['image_monochrome'].convert('L')}
        )['monochrome'].astype(np.float32)
        line = encode_layers(
            {'line_top': raw['line_top'].convert('L'),
             'line_bottom': raw['line_bottom'].convert('L')}
        )['line'].astype(np.float32)
        para = encode_layers(
            {'paragraph': raw['paragraph'].convert('L')}
        )['paragraph'].astype(np.float32)
        pred_lines = []
        for mask in label_layer(para):
            mono_c, line_c = crop_and_rotate_single_paragraph(
                mask, [mono, line])
            mono_c = make_divisible_by(mono_c, 16, 16)
            line_c = make_divisible_by(line_c, 16, 16)
            lines = crop_lines_of_paragraph(
                line_c, mono_c, CHAR_INPUT_HEIGHT, CHAR_FIXED_WIDTH)
            for ids, valid in pipe._run_char_batched(lines):
                pred_lines.append(pred_ids_to_text(ids, valid, True))
        texts.append(pred_lines)
    return texts


def generate():
    """Render the corpus with the port; interpret and read it with JAX."""
    import random

    import jax
    jax.config.update('jax_platforms', 'cpu')
    sys.path.insert(0, str(ROOT))
    from univer_ocr_tpu.image_generator import (LayeredImage, random_font,
                                                random_text)
    from univer_ocr_tpu.interpreter import interpret
    from univer_ocr_tpu_torch.models.evaluation import render_eval_pages
    from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

    ours = render_eval_pages(N_PAGES, SEED)
    layers = np.stack([np.stack([np.asarray(raw[name].convert('L'))
                                 for name in LAYER_NAMES])
                       for raw in ours])
    # the JAX package's pages, drawn as its build_eval_corpus and
    # main_gt_crops draw them
    random.seed(SEED)
    jax_pages = []
    for _ in range(N_PAGES):
        img = LayeredImage(720, 480, (255, 255, 255, 255))
        while img.paragraphs_added == 0:
            for _ in range(100):
                img.add_paragraph(random_text(), random_font(12, 36))
        img.make_divisible_by(16, 16)
        jax_pages.append(img.get_raw())
    for raw, theirs in zip(ours, jax_pages):
        assert all(np.array_equal(np.asarray(raw[n]), np.asarray(theirs[n]))
                   for n in LAYER_NAMES)
    truths = [interpret(raw) for raw in jax_pages]
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    gt = {p: _jax_gt_crop_texts(jax_pages, p, weights)
          for p in ('highest', 'bf16')}
    np.savez_compressed(
        FIXTURE, layers=layers, layer_names=np.array(json.dumps(LAYER_NAMES)),
        truths=np.array(json.dumps(
            [[[list(key), text] for key, text in sorted(truth.items())]
             for truth in truths])),
        gt_crops_highest=np.array(json.dumps(gt['highest'])),
        gt_crops_bf16=np.array(json.dumps(gt['bf16'])),
        seed=np.array(SEED), n_pages=np.array(N_PAGES))
    print(f'{FIXTURE}: {FIXTURE.stat().st_size} bytes')


if __name__ == '__main__':
    generate()
