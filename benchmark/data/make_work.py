"""Work table of the page pool: each page's FLOPs and compulsory bytes per
stage (reference/work.py), from the shapes the plain reference computes
on it: the drawn page, its paragraph crops and its lines at their true
widths.  Runs the reference in float32 on the CPU:

    python benchmark/data/make_work.py

Reads benchmark/data/pages.npz and the checkpoint; writes
benchmark/data/work.json: {'meta': {...}, 'pages': [{stage: {'flops',
'bytes'}, 'paragraphs': n, 'lines': n}]}, in pool order.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
sys.path.insert(0, str(BENCH / 'reference'))

import cascade  # noqa: E402
import work  # noqa: E402

from make_pages import PAGE_H, PAGE_W  # noqa: E402

WEIGHTS = BENCH.parent / 'univer_ocr_tpu' / 'models' / 'model_weights.json'


def main():
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pages = np.load(HERE / 'pages.npz')['pages']
    ref = cascade.Reference(cascade.load_weights(WEIGHTS, 'cpu'), 'cpu')
    rows = []
    for page in pages:
        _, shapes = ref.read_page(page, 4)
        shapes['page'] = [PAGE_H, PAGE_W]
        row = work.page_work(shapes)
        row['paragraphs'] = len(shapes['crops'])
        row['lines'] = len(shapes['lines'])
        rows.append(row)
    meta = {'page_drawn': [PAGE_H, PAGE_W],
            'page_frame': list(pages.shape[1:]),
            'weight_bytes': work.WEIGHT_BYTES,
            'seconds': round(time.perf_counter() - t0, 1)}
    with open(HERE / 'work.json', 'w') as fp:
        json.dump({'meta': meta, 'pages': rows}, fp, indent=0)
    print(f'{len(rows)} pages in {meta["seconds"]} s')


if __name__ == '__main__':
    main()
