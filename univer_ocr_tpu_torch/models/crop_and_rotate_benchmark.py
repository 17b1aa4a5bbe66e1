"""Benchmark of the host crop chain (univer_ocr_tpu/models/
crop_and_rotate_benchmark.py): ParagraphCrop -> LineCrop -> CharLabel ->
PredToText over the training pages on ground-truth layers, for 1, 2 and 4
workers, printing each stage's cumulative time and writing the decoded
text of the 4-worker run for inspection.

    python -m univer_ocr_tpu_torch crop_and_rotate_benchmark [limit]

The pages are `train_dataset()`'s: the PNG corpus under
generated_files/data when it exists, else pages rendered on demand from
seed 0 (both need Pillow).  The port's stage pools are threads only:
the JAX package's `MP` switch to worker processes is not ported, so its
process rows are not measured here.
"""

import random
from datetime import datetime as dt

from ..interpreter import (CropAndRotateParagraphs, CropRotateAndZoomLines,
                           LabelChar, PredToText)
from .bucketing import CHAR_FIXED_WIDTH, CHAR_INPUT_HEIGHT, make_divisible_by
from .constants import GENERATED_FILES_PATH
from .datasets import train_dataset

OUTPUT_PATH = GENERATED_FILES_PATH / 'crop_and_rotate_benchmark'
STAGES = ('ParagraphCrop', 'LineCrop', 'CharLabel', 'PredToText')


def run_chain(dataset, workers_count, limit=None, save_text=False):
    """The chain over the first `limit` pages; returns {stage: time} and
    the decoded [page][paragraph][line] text."""
    timers = {name: dt.now() - dt.now() for name in STAGES}
    n = len(dataset) if limit is None else min(limit, len(dataset))
    texts = []
    with CropAndRotateParagraphs(workers_count) as crop_paragraphs, \
            CropRotateAndZoomLines(workers_count, CHAR_INPUT_HEIGHT,
                                   CHAR_FIXED_WIDTH) as crop_lines, \
            LabelChar(workers_count) as label_char, \
            PredToText(workers_count) as pred_to_text:
        for idx in range(n):
            layers = dataset.get(idx, layer_tags=[
                'monochrome', 'paragraph', 'line', 'char'])

            ts = dt.now()
            cropped = crop_paragraphs(layers['paragraph'],
                                      [layers['monochrome'], layers['line'],
                                       layers['char']])
            cropped = [[make_divisible_by(t, 16, 16) for t in arrays]
                       for arrays in cropped]
            timers['ParagraphCrop'] += dt.now() - ts

            ts = dt.now()
            lines = crop_lines(cropped[1], [cropped[0], cropped[2]])
            timers['LineCrop'] += dt.now() - ts

            ts = dt.now()
            labels = label_char(lines[1])
            timers['CharLabel'] += dt.now() - ts

            ts = dt.now()
            texts.append(pred_to_text(labels))
            timers['PredToText'] += dt.now() - ts

    if save_text:
        OUTPUT_PATH.mkdir(parents=True, exist_ok=True)
        with open(OUTPUT_PATH / 'decoded.txt', 'w') as fp:
            for idx, text in enumerate(texts):
                print(f'=== page {idx} ===', file=fp)
                for p_id, para in enumerate(text):
                    for l_id, line in enumerate(para):
                        print(f'[{p_id}][{l_id}] {line}', file=fp)
    return timers, texts


def main(limit=10):
    dataset = train_dataset(random.Random(0))
    for workers in (1, 2, 4):
        ts = dt.now()
        timers, _ = run_chain(dataset, workers, limit=int(limit),
                              save_text=workers == 4)
        stages = ', '.join(f'{k}={v}' for k, v in timers.items())
        print(f'threading x{workers}: total={dt.now() - ts} | {stages}')


if __name__ == '__main__':
    main()
