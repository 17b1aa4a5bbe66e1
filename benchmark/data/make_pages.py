"""Draw the benchmark's page pool with the port's page generator.

Page j is `generate_picture(720, 480, False, rng=random.Random(SEED0 + j))`
(the size and kind of the JAX package's bench.py), its `image` layer
taken as 8-bit gray.  The generator draws 480x720 and then pads the
layer to 496x736 with its background; the pool keeps the drawn 480x720
and zero-pads it in the centre to the pipeline's page shape (1, 496,
736, 1), as `web/app.bucket_page` pads an upload of 480x720, so that
every cell, `POST /ocr` included, serves the same pages.  Needs Pillow and the fonts, so it runs on a machine that has
them, never in a benchmark run:

    python benchmark/data/make_pages.py [--pages 48]

Writes benchmark/data/pages.npz: `pages` uint8 (N, 496, 736), `seeds`.
"""

import argparse
import random
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
SEED0 = 0
PAGE_W, PAGE_H = 720, 480
SHAPE_H, SHAPE_W = 496, 736


def draw(seed):
    sys.path.insert(0, str(ROOT))
    from univer_ocr_tpu_torch.models.train_data_generator import \
        generate_picture
    layers = generate_picture(PAGE_W, PAGE_H, False,
                              rng=random.Random(seed))
    image = np.asarray(layers['image'].convert('L'), np.uint8)
    gy, gx = (image.shape[0] - PAGE_H) // 2, (image.shape[1] - PAGE_W) // 2
    out = np.zeros((SHAPE_H, SHAPE_W), np.uint8)
    py, px = (SHAPE_H - PAGE_H) // 2, (SHAPE_W - PAGE_W) // 2
    out[py:py + PAGE_H, px:px + PAGE_W] = image[gy:gy + PAGE_H,
                                                 gx:gx + PAGE_W]
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--pages', type=int, default=48)
    parser.add_argument('--workers', type=int, default=4)
    args = parser.parse_args()
    seeds = list(range(SEED0, SEED0 + args.pages))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(args.workers) as pool:
        pages = np.stack(list(pool.map(draw, seeds)))
    np.savez_compressed(HERE / 'pages.npz', pages=pages,
                        seeds=np.asarray(seeds, np.int64))
    print(f'{len(pages)} pages {pages.shape} in '
          f'{time.perf_counter() - t0:.1f} s')


if __name__ == '__main__':
    main()
