"""OCR accuracy of a checkpoint against geometric ground truth
(scripts/eval_accuracy.py of the JAX package).

    python -m univer_ocr_tpu_torch.eval_accuracy [n] [--gt-crops] [--f32]
        [--host-cascade] [--pages FILE.npz] [--no-collapse] [--min-run=N]
        [--chunk=N] [--exact-bands] [--weights JSON]
        [--cpu]

The pages are the eval corpus's (`evaluation.render_eval_pages(n, 123)`,
rendered with Pillow and fonts) or, with `--pages`, the first n pages of
a layers file such as fixtures/eval_layers.npz (no Pillow needed; a
missing Pillow without `--pages` raises).  The true text of each page is
`interpreter.interpret` of its mask layers.  The default run sends the
pages through the serving pipeline (the device cascade in 'bf16'; `--f32`
for 'highest', `--host-cascade` for the host cascade) and reports the
char similarity of the decoded text (concat, look-alikes canonical,
matched lines) and the exact-line rate.  `--gt-crops` takes paragraphs
and lines from the ground-truth masks instead, so only the Char model
reads, and reports each page's similarity.  The decode collapses repeated
glyphs (`--no-collapse`: one glyph per column; `--min-run=N`: also drops
runs under N columns, the serving decode at N=4).  The weights are the
committed checkpoint unless `--weights` names another file; the run is
on the card unless `--cpu`.
"""

import json
import sys
from difflib import SequenceMatcher

import numpy as np

from .interpreter import (crop_and_rotate_single_paragraph, interpret,
                          label_layer, pred_ids_to_text)
from .models.bucketing import (CHAR_FIXED_WIDTH, CHAR_INPUT_HEIGHT,
                               make_divisible_by)
from .models.evaluation import (line_matched_similarity, render_eval_pages,
                                score_results)
from .weights import DEFAULT_CHECKPOINT

PAGE_SHAPE = (1, 496, 736, 1)


def load_layer_pages(path, n_pages, seed=123):
    """The first n pages of a layers file (uint8 `layers` (N, L, H, W),
    their `layer_names`, `seed` and `n_pages`) as {layer_name: (H, W)
    uint8}; a file of another seed, or with fewer pages, raises."""
    with np.load(path) as f:
        stored_seed, stored_pages = int(f['seed']), int(f['n_pages'])
        if seed != stored_seed or not 0 < n_pages <= stored_pages:
            raise ValueError(
                f'{path} holds {stored_pages} pages of seed {stored_seed}; '
                f'asked for {n_pages} of seed {seed}')
        names = json.loads(str(f['layer_names']))
        layers = f['layers'][:n_pages]
    return [dict(zip(names, page)) for page in layers]


def corpus_pages(n_pages, seed=123, pages_path=None):
    """The eval pages as {layer_name: (H, W) uint8} dicts: read from
    `pages_path`, else rendered (needs Pillow and fonts)."""
    if pages_path is not None:
        return load_layer_pages(pages_path, n_pages, seed)
    return [{name: np.asarray(image.convert('L'))
             for name, image in raw.items()}
            for raw in render_eval_pages(n_pages, seed)]


def _unit(*planes):
    """uint8 planes -> one (1, H, W, C) float32 array of planes / 255."""
    return (np.stack(planes, axis=-1)[None] / 255.0).astype(np.float32)


def _pipeline(weights, device, **kwargs):
    from .models.pipeline import OCRPipeline
    if weights is None:
        with open(DEFAULT_CHECKPOINT) as fp:
            weights = json.load(fp)
    return OCRPipeline(PAGE_SHAPE, weights=weights, device=device, **kwargs)


def main(n_pages=8, collapse=True, seed=123, chunk=8, precision='bf16',
         device_cascade=True, exact_bands=False,
         pages_path=None, weights=None, device=None, log=print):
    """The pages through the OCR pipeline, scored against interpret() of
    their layers; returns `evaluation.score_results`' dict."""
    layers = corpus_pages(n_pages, seed, pages_path)
    truths = [interpret(page) for page in layers]
    pages = [_unit(page['image']) for page in layers]
    options = (dict(device_cascade=True, exact_bands=True)
               if exact_bands else
               dict(chunk=chunk, device_cascade=device_cascade))
    with _pipeline(weights, device, collapse_runs=collapse,
                   precision=precision, **options) as pipe:
        results = pipe.ocr_pages(pages)
    score = score_results(truths, results)
    for truth, result, ratio in zip(truths, results, score['per_page']):
        true_lines = [truth[k] for k in sorted(truth)]
        pred_lines = [line for para in result for line in para]
        log(f'page: {len(true_lines)} true lines, {len(pred_lines)} '
            f'predicted, similarity {ratio:.3f}, matched '
            f'{line_matched_similarity(true_lines, pred_lines):.3f}')
        if true_lines and pred_lines:
            log(f'  true[0]: {true_lines[0][:60]!r}')
            log(f'  pred[0]: {pred_lines[0][:60]!r}')
    log(f'\nmean char similarity (concat): {score["concat"]:.4f}')
    log(f'mean char similarity (concat, look-alikes canonical): '
        f'{score["canonical"]:.4f}')
    log(f'mean char similarity (matched lines): {score["matched"]:.4f}')
    log(f'exact line rate: {score["exact_lines"]}/{score["total_lines"]} '
        f'(look-alikes canonical: {score["exact_lines_canonical"]}/'
        f'{score["total_lines"]})')
    return score


def gt_crop_lines(pipe, page, collapse=True):
    """One page's text read by the Char model alone: its paragraphs and
    lines cut from the ground-truth masks (paragraph, line_top /
    line_bottom) out of its image_monochrome layer, deskewed and zoomed
    as the host cascade does; returns the lines in paragraph order."""
    from .models.pipeline import crop_lines_of_paragraph
    mono = _unit(page['image_monochrome'])
    line = _unit(page['line_top'], page['line_bottom'])
    para = _unit(page['paragraph'])
    lines = []
    for mask in label_layer(para):
        mono_c, line_c = crop_and_rotate_single_paragraph(mask, [mono, line])
        mono_c = make_divisible_by(mono_c, 16, 16)
        line_c = make_divisible_by(line_c, 16, 16)
        lines += crop_lines_of_paragraph(line_c, mono_c, CHAR_INPUT_HEIGHT,
                                         CHAR_FIXED_WIDTH)
    return [pred_ids_to_text(ids, valid, collapse)
            for ids, valid in pipe._run_char_batched(lines)]


def main_gt_crops(n_pages=8, collapse=True, seed=123, precision='bf16',
                  pages_path=None, weights=None, device=None, log=print):
    """Char-model accuracy on ground-truth crops (the host cascade's
    Char stage, `OCRPipeline._run_char_batched`); returns (each page's
    similarity to the true text, each page's lines)."""
    layers = corpus_pages(n_pages, seed, pages_path)
    ratios, texts = [], []
    with _pipeline(weights, device, collapse_runs=collapse,
                   precision=precision) as pipe:
        for page in layers:
            truth = interpret(page)
            pred_lines = gt_crop_lines(pipe, page, collapse)
            true_lines = [truth[k] for k in sorted(truth)]
            ratio = SequenceMatcher(None, '\n'.join(true_lines),
                                    '\n'.join(pred_lines)).ratio()
            ratios.append(ratio)
            texts.append(pred_lines)
            log(f'page: {len(true_lines)} true lines, {len(pred_lines)} '
                f'GT-crop lines, similarity {ratio:.3f}')
            if true_lines and pred_lines:
                log(f'  true[0]: {true_lines[0][:60]!r}')
                log(f'  pred[0]: {pred_lines[0][:60]!r}')
    log(f'\nmean GT-crop char similarity: {np.mean(ratios):.4f}')
    return ratios, texts


def cli(argv):
    positional = [a for a in argv if not a.startswith('--')]
    collapse = '--no-collapse' not in argv
    chunk, pages_path, weights = 8, None, None
    for i, a in enumerate(argv):
        if a.startswith('--min-run='):
            collapse = int(a.split('=')[1])
        if a.startswith('--chunk='):
            chunk = int(a.split('=')[1])
        if a == '--pages':
            pages_path = argv[i + 1]
            positional.remove(pages_path)
        if a == '--weights':
            with open(argv[i + 1]) as fp:
                weights = json.load(fp)
            positional.remove(argv[i + 1])
    n = int(positional[0]) if positional else 8
    precision = 'highest' if '--f32' in argv else 'bf16'
    device = 'cpu' if '--cpu' in argv else None
    if '--gt-crops' in argv:
        return main_gt_crops(n, collapse, precision=precision,
                             pages_path=pages_path, weights=weights,
                             device=device)
    return main(n, collapse, chunk=chunk, precision=precision,
                device_cascade='--host-cascade' not in argv,
                exact_bands='--exact-bands' in argv, pages_path=pages_path,
                weights=weights, device=device)


if __name__ == '__main__':
    cli(sys.argv[1:])
