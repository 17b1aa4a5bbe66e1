"""Tensor ops of the port (the counterparts of univer_ocr_tpu/ops)."""

from .activations import leaky_relu, relu, sigmoid
from .conv import (conv2d, conv_output_shape, unfold_output_shape,
                   unfold_to_fixed_width)
from .dense import dense
from .initializers import (kaiming_normal, kaiming_uniform, xavier_normal,
                           xavier_uniform)
from .losses import (segmentation_dice_2d, segmentation_jaccard_2d,
                     sigmoid_cross_entropy, softmax_cross_entropy)
from .pool import max_pool2d, pool_output_shape
from .regularizers import l1_regularizer, l2_regularizer
from .upsample import upsample2d

__all__ = [
    'conv2d', 'conv_output_shape', 'unfold_output_shape',
    'unfold_to_fixed_width', 'max_pool2d', 'pool_output_shape',
    'upsample2d', 'dense', 'relu', 'leaky_relu', 'sigmoid',
    'segmentation_dice_2d', 'segmentation_jaccard_2d',
    'sigmoid_cross_entropy', 'softmax_cross_entropy',
    'xavier_normal', 'xavier_uniform', 'kaiming_normal', 'kaiming_uniform',
    'l1_regularizer', 'l2_regularizer',
]
