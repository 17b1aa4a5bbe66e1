"""Work table of the band labelling kernel (`band_ccl`) on the page pool:
each page's compulsory bytes, from the shapes and components the plain
reference computes on it.  The kernel labels the two band channels of
every paragraph crop and writes a table row per component, so a page's
bytes are both band masks at one byte a pixel at the reference's true
crop sizes, plus 7 values of 4 bytes for each band component of both
channels.  It does no arithmetic worth counting: FLOPs are 0.  Runs the
reference in float32 on the CPU:

    python benchmark/data/make_band_work.py

Reads benchmark/data/pages.npz and the checkpoint; writes
benchmark/data/band_work.json: {'meta': {...}, 'pages': [{'band_ccl':
{'flops', 'bytes'}, 'components': n, 'crops': n}]}, in pool order.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from scipy import ndimage

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
sys.path.insert(0, str(BENCH / 'reference'))

import cascade  # noqa: E402

WEIGHTS = BENCH.parent / 'univer_ocr_tpu' / 'models' / 'model_weights.json'
#: one table row: count, y and x sums, the box's four edges, 4 bytes each
ROW_BYTES = 7 * 4


def page_bands(ref, page_u8):
    """[(crop (h, w), components of both band channels)] of one page, as
    the reference's read_page crops and thresholds it."""
    x = ref._tensor(page_u8)[None, None] / 255.0
    m = ref.monochrome(x)
    p = ref.fcn(m, 'Paragraph')
    para = ((p - p.mean()) > 1e-6)[0, 0].cpu().numpy()
    mono = (np.round(m[0, 0].cpu().numpy().astype(np.float32) * 255.0)
            .astype(np.uint8).astype(np.float32) / 255.0)
    labels, count = ndimage.label(para)
    out = []
    for lab in range(1, count + 1):
        crop = cascade.pad16(cascade.crop_paragraph(labels == lab, mono))
        xc = ref._tensor(cascade.to_u8(crop))[None, None] / 255.0
        bands = ref.fcn(xc, 'Line')[0].cpu().numpy()
        masks = [b - 0.5 * (b.mean() + b.max()) > 1e-6 for b in bands]
        out.append((crop.shape, sum(len(cascade._components(m))
                                    for m in masks)))
    return out


def main():
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pages = np.load(HERE / 'pages.npz')['pages']
    ref = cascade.Reference(cascade.load_weights(WEIGHTS, 'cpu'), 'cpu')
    rows = []
    for page in pages:
        crops = page_bands(ref, page)
        components = sum(n for _, n in crops)
        nbytes = sum(2 * h * w for (h, w), _ in crops) + ROW_BYTES * components
        rows.append({'band_ccl': {'flops': 0, 'bytes': int(nbytes)},
                     'components': int(components), 'crops': len(crops)})
    meta = {'row_bytes': ROW_BYTES,
            'seconds': round(time.perf_counter() - t0, 1)}
    with open(HERE / 'band_work.json', 'w') as fp:
        json.dump({'meta': meta, 'pages': rows}, fp, indent=0)
    print(f'{len(rows)} pages in {meta["seconds"]} s')


if __name__ == '__main__':
    main()
