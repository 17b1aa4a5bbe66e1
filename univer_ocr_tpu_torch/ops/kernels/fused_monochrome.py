"""Fused Monochrome block: the CUDA kernel `csrc/fused_monochrome.cu` and
its plain PyTorch version.

Replaces univer_ocr_tpu/ops/pallas/fused_conv.py:fused_monochrome.  It
computes sigmoid(conv3x3_{16->1}(leaky(conv3x3_{1->16}(x) + b1)) + b2) with
SAME zero padding; the hidden map is zero outside the image, as the
unfused version sees it.

Bound on the H100: FP32 work, not traffic: 576 FLOP per pixel, so one
chunk of 8 pages at 496x736 is 1.68 GFLOP, 25 us at 67 TFLOP/s, against
23.4 MB, 7 us at 3.35 TB/s.  The kernel keeps the 16 hidden channels in
shared memory, one at a time, so the only device-memory traffic is the
page in and the map out (see the source for the tiling).

A CPU tensor takes `fused_monochrome_reference`; a CUDA tensor launches
the kernel or raises.
"""

import torch

from .. import conv2d, leaky_relu, sigmoid
from . import _build

LEAKY_ALPHA = 0.01
NAME = 'fused_monochrome'


def fused_monochrome_reference(x, w1, b1, w2, b2, precision='highest'):
    """Plain PyTorch version: two convolutions, in full float32 unless
    `precision` says otherwise (ops/precision.py)."""
    h = leaky_relu(conv2d(x, w1, b1, padding=(1, 1), precision=precision),
                   LEAKY_ALPHA)
    h = conv2d(h, w2, b2, padding=(1, 1), precision=precision)
    return sigmoid(h)


def _check(t, name, shape):
    if t.device != shape[0] or t.dtype != torch.float32:
        raise ValueError(f'{NAME}: {name} must be float32 on {shape[0]}, '
                         f'got {t.dtype} on {t.device}')
    if tuple(t.shape) != shape[1]:
        raise ValueError(f'{NAME}: {name} must have shape {shape[1]}, '
                         f'got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{NAME}: {name} must be contiguous')


def fused_monochrome(x, w1, b1, w2, b2):
    """x: (B, H, W, 1) float32; w1: (3, 3, 1, 16); b1: (16,);
    w2: (3, 3, 16, 1); b2: (1,).  Returns (B, H, W, 1) float32."""
    if x.device.type == 'cpu':
        return fused_monochrome_reference(x, w1, b1, w2, b2)
    if x.device.type != 'cuda':
        raise ValueError(f'{NAME}: unsupported device {x.device}')
    if x.dim() != 4 or x.shape[-1] != 1:
        raise ValueError(f'{NAME}: x must be (B, H, W, 1), got {tuple(x.shape)}')
    dev = x.device
    B, H, W, _ = x.shape
    _check(x, 'x', (dev, (B, H, W, 1)))
    _check(w1, 'w1', (dev, (3, 3, 1, 16)))
    _check(b1, 'b1', (dev, (16,)))
    _check(w2, 'w2', (dev, (3, 3, 16, 1)))
    _check(b2, 'b2', (dev, (1,)))
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _build.function('uocr_fused_monochrome', 'ppppppiiip')
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                  b2.data_ptr(), out.data_ptr(), B, H, W, stream)
    _build.check(code, NAME)
    _build.LAUNCHES[NAME] += 1
    return out
