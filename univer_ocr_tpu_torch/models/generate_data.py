"""Render the training and validation page corpora to PNG layer files
(univer_ocr_tpu/models/generate_data.py).

    python -m univer_ocr_tpu_torch generate_data [--train N]
        [--validation N] [--seed S] [--out DIR] [--workers N]

writes `{i}_{layer}.png` for the 17 layers of every page under
`DIR/train` and `DIR/validation` (default generated_files/data, 100 and
10 pages of 720x480, padded to 736x496), the corpus `Dataset` reads.
Page j of the corpus (the training pages first, then the validation
pages) is `render_page(720, 480)` drawn from `random.Random(seed + j)`,
so a seed gives the same corpus however many processes render it; the
JAX package's corpus comes from its feed, seeded from OS entropy.
Rendering needs Pillow and fonts: it is host work, done in spawned
processes.
"""

import argparse
import multiprocessing
import os
import random
import time
from pathlib import Path

from .constants import (GENERATED_FILES_PATH, TRAIN_DATASET_LENGTH,
                        VALIDATION_DATASET_LENGTH)
from .train_data_generator import render_page

#: the corpus's page size before padding (the JAX package's)
PAGE_WIDTH, PAGE_HEIGHT = 720, 480


def write_page(seed, prefix):
    """Render one corpus page from `seed` and save its layers as
    `{prefix}_{layer}.png`."""
    images = render_page(PAGE_WIDTH, PAGE_HEIGHT, False,
                         rng=random.Random(seed))
    for layer_name, image in images.items():
        image.save(f'{prefix}_{layer_name}.png')


def _write_page(job):
    return write_page(*job)


def generate_data(out_dir=GENERATED_FILES_PATH / 'data',
                  n_train=TRAIN_DATASET_LENGTH,
                  n_validation=VALIDATION_DATASET_LENGTH, seed=0,
                  workers=None):
    """Write the corpus under `out_dir`; returns the seconds it took."""
    t0 = time.perf_counter()
    out_dir = Path(out_dir)
    jobs = []
    for split, count, first in (('train', n_train, 0),
                                ('validation', n_validation, n_train)):
        (out_dir / split).mkdir(parents=True, exist_ok=True)
        jobs += [(seed + first + i, str(out_dir / split / str(i)))
                 for i in range(count)]
    workers = max(1, min(workers or os.cpu_count(), len(jobs)))
    with multiprocessing.get_context('spawn').Pool(workers) as pool:
        for _ in pool.imap_unordered(_write_page, jobs):
            pass
    return time.perf_counter() - t0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--train', type=int, default=TRAIN_DATASET_LENGTH)
    parser.add_argument('--validation', type=int,
                        default=VALIDATION_DATASET_LENGTH)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--out', default=str(GENERATED_FILES_PATH / 'data'))
    parser.add_argument('--workers', type=int, default=None)
    args = parser.parse_args(argv)
    seconds = generate_data(args.out, args.train, args.validation,
                            args.seed, args.workers)
    print(f'{args.train} train and {args.validation} validation pages '
          f'under {args.out} in {seconds:.1f} s')


if __name__ == '__main__':
    main()
