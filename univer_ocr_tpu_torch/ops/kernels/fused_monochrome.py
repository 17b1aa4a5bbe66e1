"""Fused Monochrome block: the CUDA kernel `csrc/fused_monochrome.cu` and
its plain PyTorch version.

Replaces univer_ocr_tpu/ops/pallas/fused_conv.py:fused_monochrome.  It
computes sigmoid(conv3x3_{16->1}(leaky(conv3x3_{1->16}(x) + b1)) + b2) with
SAME zero padding; the hidden map is zero outside the image, as the
unfused version sees it.

Bound on the H100: FP32 work, not traffic: 576 FLOP per pixel, so one
chunk of 8 pages at 496x736 is 1.68 GFLOP, 25 us at 67 TFLOP/s, against
23.4 MB, 7 us at 3.35 TB/s.  The kernel keeps the 16 hidden channels in
shared memory, so the only device-memory traffic is the page in and the
map out, and reads its 305 weights as constant operands of a by-value
launch parameter (see the source for the tiling).  `prepare_monochrome`
packs them once per set of weights; the wrapper takes the
`MonochromeWeights` it returns and raises on anything else.

A CPU tensor takes `fused_monochrome_reference`; a CUDA tensor launches
the kernel or raises.
"""

import collections

import numpy as np
import torch

from .. import conv2d, leaky_relu, sigmoid
from . import _build

LEAKY_ALPHA = 0.01
NAME = 'fused_monochrome'

#: launches of the kernel by the (B, H, W) of its input, counted where
#: `_build.LAUNCHES` counts them (the shapes a path gives the kernel)
SHAPE_LAUNCHES = collections.Counter()


def fused_monochrome_reference(x, w1, b1, w2, b2, precision='highest'):
    """Plain PyTorch version: two convolutions, in full float32 unless
    `precision` says otherwise (ops/precision.py)."""
    h = leaky_relu(conv2d(x, w1, b1, padding=(1, 1), precision=precision),
                   LEAKY_ALPHA)
    h = conv2d(h, w2, b2, padding=(1, 1), precision=precision)
    return sigmoid(h)


class MonochromeWeights:
    """The Monochrome block's weights as the kernel takes them, made once
    per set of weights by `prepare_monochrome`: the four tensors, for the
    plain version, and `packed`, the 305 floats w1 (3,3,1,16), b1 (16,),
    w2 (3,3,16,1), b2 (1,) flattened into host memory, which each launch
    copies into its parameters."""

    def __init__(self, w1, b1, w2, b2):
        self.w1, self.b1, self.w2, self.b2 = w1, b1, w2, b2
        self.device = w1.device
        self.packed = np.ascontiguousarray(np.concatenate(
            [t.detach().float().cpu().numpy().ravel()
             for t in (w1, b1, w2, b2)]), dtype=np.float32)


def prepare_monochrome(w1, b1, w2, b2):
    """Check and pack the Monochrome weights (see `MonochromeWeights`)."""
    for t, name, shape in ((w1, 'w1', (3, 3, 1, 16)), (b1, 'b1', (16,)),
                           (w2, 'w2', (3, 3, 16, 1)), (b2, 'b2', (1,))):
        if tuple(t.shape) != shape or t.device != w1.device:
            raise ValueError(f'{NAME}: {name} must have shape {shape} on '
                             f'{w1.device}, got {tuple(t.shape)} on '
                             f'{t.device}')
    return MonochromeWeights(w1, b1, w2, b2)


def fused_monochrome(x, weights):
    """x: (B, H, W, 1) float32; weights: the `MonochromeWeights` of the
    block, on x's device.  Returns (B, H, W, 1) float32."""
    if not isinstance(weights, MonochromeWeights):
        raise TypeError(f'{NAME}: weights must be prepared by '
                        f'prepare_monochrome, got {type(weights).__name__}')
    if x.device.type == 'cpu':
        return fused_monochrome_reference(x, weights.w1, weights.b1,
                                          weights.w2, weights.b2)
    if x.device.type != 'cuda':
        raise ValueError(f'{NAME}: unsupported device {x.device}')
    if x.dim() != 4 or x.shape[-1] != 1:
        raise ValueError(f'{NAME}: x must be (B, H, W, 1), got {tuple(x.shape)}')
    if weights.device != x.device:
        raise ValueError(f'{NAME}: weights prepared on {weights.device} '
                         f'for x on {x.device}')
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f'{NAME}: x must be contiguous float32, got '
                         f'{x.dtype}')
    B, H, W, _ = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _build.function('uocr_fused_monochrome', 'pppiiip')
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), weights.packed.ctypes.data, out.data_ptr(),
                  B, H, W, stream)
    _build.check(code, NAME)
    with _build.COUNT_LOCK:
        _build.LAUNCHES[NAME] += 1
        _build.DEVICE_LAUNCHES[(NAME, x.device.index)] += 1
        SHAPE_LAUNCHES[(B, H, W)] += 1
    return out
