"""Tensor ops of the port (the counterparts of univer_ocr_tpu/ops)."""

from .activations import leaky_relu, sigmoid
from .conv import conv2d, unfold_to_fixed_width
from .dense import dense
from .upsample import upsample2d

__all__ = [
    'conv2d', 'unfold_to_fixed_width', 'dense', 'leaky_relu', 'sigmoid',
    'upsample2d',
]
