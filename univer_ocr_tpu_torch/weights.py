"""The `model_weights.json` checkpoint, carried into the port's tensors.

The checkpoint maps each layer name of the model zoo (for example
'Monochrome/conv_1', 'Char/dense_block/dense_1') to its parameters: conv
layers hold an HWIO 'w' and a 'b', dense layers one 'w' whose last row is
the bias.  The port keeps those names and layouts: parameters are a plain
dict `{name: {'w': tensor, 'b': tensor}}` of float32 tensors.
"""

import json
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device

#: the committed checkpoint of the JAX package, read as a data file
DEFAULT_CHECKPOINT = (Path(__file__).resolve().parents[1] / 'univer_ocr_tpu'
                      / 'models' / 'model_weights.json')


def params_from_numpy(weights, device=None):
    """{name: {'w': array-like, 'b': array-like}} -> the same dict of
    float32 tensors on `device` (None -> the card)."""
    device = resolve_device(device)
    return {
        name: {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
               for k, v in entry.items()}
        for name, entry in weights.items()
    }


def load_checkpoint(path=DEFAULT_CHECKPOINT, device=None):
    """Read a model_weights.json and return its parameters on `device`."""
    with open(path) as fp:
        weights = json.load(fp)
    return params_from_numpy(weights, device)
