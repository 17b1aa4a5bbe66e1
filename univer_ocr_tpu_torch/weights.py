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
from .ops.initializers import kaiming_uniform

#: the committed checkpoint of the JAX package, read as a data file
DEFAULT_CHECKPOINT = (Path(__file__).resolve().parents[1] / 'univer_ocr_tpu'
                      / 'models' / 'model_weights.json')


#: the model zoo's 18 parameter entries: conv layers by their HWIO weight
#: shape, dense layers by (n_in, n_out) (univer_ocr_tpu/models/model.py)
CONV_SHAPES = {
    'Monochrome/conv_1': (3, 3, 1, 16),
    'Monochrome/conv_2': (3, 3, 16, 1),
    'Paragraph/down_1/conv_1': (5, 5, 1, 1),
    'Paragraph/down_2/conv_1': (5, 5, 1, 1),
    'Paragraph/up_1/conv_block/conv_1': (5, 5, 1, 1),
    'Paragraph/up_2/conv_block/conv_1': (5, 5, 1, 1),
    'Paragraph/end/conv_1': (5, 5, 1, 1),
    'Line/down_1/conv_1': (5, 5, 1, 4),
    'Line/down_2/conv_1': (5, 5, 4, 4),
    'Line/up_1/conv_block/conv_1': (5, 5, 4, 4),
    'Line/up_2/conv_block/conv_1': (5, 5, 4, 4),
    'Line/end/conv_1': (5, 5, 4, 2),
    'Char/conv_block/conv_1': (5, 3, 1, 64),
    'Char/conv_block/conv_2': (5, 3, 64, 64),
    'Char/conv_block/conv_3': (5, 3, 64, 64),
}
DENSE_SHAPES = {
    'Char/dense_block/dense_1': (512, 1024),
    'Char/dense_block/dense_2': (1024, 128),
    'Char/dense_block/dense_3': (128, 162),
}


def random_params(generator, device=None):
    """Fresh parameters, drawn as the JAX package's layers draw them
    (univer_ocr_tpu/nn/layers.py, `init_params`): each entry is one
    `kaiming_uniform` matrix of (fan_in + 1, n_out), so its values lie in
    [0, a) with a = 1 / sqrt((fan_in + 1) / 2); a dense layer keeps the
    matrix as 'w' (bias in its last row), a conv layer splits off the
    last row as 'b'.  The values differ from JAX's, whose PRNG differs;
    the same generator state gives the same values."""
    device = resolve_device(device)
    params = {}
    for name, shape in CONV_SHAPES.items():
        fan_in = int(np.prod(shape[:3]))
        wb = kaiming_uniform(generator, fan_in + 1, shape[3])
        params[name] = {'w': wb[:-1].reshape(shape).to(device),
                        'b': wb[-1].to(device)}
    for name, (n_in, n_out) in DENSE_SHAPES.items():
        params[name] = {'w': kaiming_uniform(generator, n_in + 1,
                                             n_out).to(device)}
    return params


def params_from_numpy(weights, device=None):
    """{name: {'w': array-like, 'b': array-like}} (arrays, nested lists or
    tensors) -> the same dict of float32 tensors on `device` (None -> the
    card)."""
    device = resolve_device(device)
    return {
        name: {k: torch.as_tensor(
                   v if isinstance(v, torch.Tensor)
                   else np.asarray(v, np.float32),
                   dtype=torch.float32, device=device)
               for k, v in entry.items()}
        for name, entry in weights.items()
    }


def load_checkpoint(path=DEFAULT_CHECKPOINT, device=None):
    """Read a model_weights.json and return its parameters on `device`."""
    with open(path) as fp:
        weights = json.load(fp)
    return params_from_numpy(weights, device)


def refuse_committed(path):
    """Raise ValueError when `path` is the committed checkpoint, which the
    port's trainers only read."""
    if Path(path).resolve() == DEFAULT_CHECKPOINT.resolve():
        raise ValueError('the trainers do not write the committed '
                         f'checkpoint {DEFAULT_CHECKPOINT}; pass another '
                         'weights_out')
