"""OCR one page image and write `result.txt` (the port's counterpart of
univer_ocr_tpu/models/predict.py).

    python -m univer_ocr_tpu_torch.models.predict PAGE [--out DIR] [--cpu]

PAGE is an image file (read with Pillow) or a `.npy` array of gray values
(uint8, or float in [0, 1]; shape (H, W) or (1, H, W, 1)), which needs no
Pillow.  The page is center-padded to a multiple of 16 and run through
`OCRPipeline` (the host cascade, the CUDA kernels on the card) on the
committed checkpoint.  `result.txt` holds the [paragraph][line] text
list; an image input is also saved as `X.png`.  The default output
directory is `generated_files/prediction_result`.

`predict_page` is the JAX package's own predict path: the PREDICT-mode
model system (`load_model_system`: Monochrome, Paragraph, paragraph
crops, Line, line crops, Char and PredToText, in full float32).
"""

import argparse
import json
from pathlib import Path

import numpy as np

from ..device import resolve_device
from ..ops.precision import backend_flags
from ..weights import DEFAULT_CHECKPOINT, load_checkpoint
from .bucketing import make_divisible_by
from .model import Modes, make_model_system, to_device
from .pipeline import OCRPipeline

DEFAULT_OUT = Path('generated_files') / 'prediction_result'


def load_page(path):
    """An image file or a .npy array -> ((1, H, W, 1) float page in
    [0, 1], the PIL image or None)."""
    path = Path(path)
    if path.suffix == '.npy':
        arr = np.load(path)
        arr = arr.reshape(arr.shape[-3:-1] if arr.ndim == 4 else arr.shape)
        image = None
    else:
        from PIL import Image
        image = Image.open(path).convert('L')
        arr = np.asarray(image)
    if arr.dtype == np.uint8:
        arr = arr / 255.0
    return np.asarray(arr, np.float64)[None, :, :, None], image


def load_model_system(input_shape, path=DEFAULT_CHECKPOINT, device=None):
    """The PREDICT-mode model system for pages of `input_shape`, with the
    weights of the checkpoint at `path` (random ones when there is no
    file, as the JAX package's)."""
    try:
        with open(path) as fp:
            weights = json.load(fp)
    except OSError:
        print(f'No checkpoint found at {path}')
        weights = {}
    model_system, _, _ = make_model_system(input_shape, weights=weights,
                                           mode=Modes.PREDICT, device=device)
    return model_system


def predict_page(page, device=None, path=DEFAULT_CHECKPOINT):
    """One (1, H, W, 1) page (H, W multiples of 16) through the model
    system: `model_system.predict(context)`, in full float32; returns
    context['text'], the [paragraph][line] text list."""
    device = resolve_device(device)
    model_system = load_model_system(page.shape, path, device)
    context = {'monochrome_X': to_device(page, device)}
    with backend_flags('highest'):
        model_system.predict(context)
    return context['text']


def predict(path, out_dir=DEFAULT_OUT, device=None, collapse_runs=False):
    """OCR the page at `path`; write result.txt (and X.png) to `out_dir`.
    Returns the [paragraph][line] text list."""
    page, image = load_page(path)
    page = make_divisible_by(page, 16, 16)
    with OCRPipeline(page.shape, weights=load_checkpoint(device=device),
                     chunk=1, device=device,
                     collapse_runs=collapse_runs) as pipeline:
        text = pipeline.ocr_pages([page])[0]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if image is not None:
        image.save(out_dir / 'X.png')
    with open(out_dir / 'result.txt', 'w') as fp:
        print(text, file=fp)
    return text


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('page', help='image file or .npy array')
    parser.add_argument('--out', default=str(DEFAULT_OUT),
                        help='output directory')
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU instead of the card')
    args = parser.parse_args(argv)
    text = predict(args.page, args.out, device='cpu' if args.cpu else None)
    print(text)


if __name__ == '__main__':
    main()
