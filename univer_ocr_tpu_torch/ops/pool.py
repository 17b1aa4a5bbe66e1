"""Max pooling with the reference's equal-split-among-ties gradient
(univer_ocr_tpu/ops/pool.py).

Two quirks of the reference MaxPool2D that autograd's max-pool backward
does not reproduce:

  1. zero padding takes part in the max: an all-negative window under
     padding yields 0, not its true max;
  2. the backward splits the incoming gradient equally among all tied
     maxima of a window, where `F.max_pool2d`'s gives all of it to one.

So the op is a `torch.autograd.Function`: the forward pads (zeros, then
-inf so that every ceil-mode window fits) and takes one `F.max_pool2d`;
the backward rebuilds the tie mask from strided slices of the padded
input and adds `grad * mask / tie_count` back through the same slices.
"""

import math

import torch
import torch.nn.functional as F


def pool_output_shape(input_shape, kernel_size, padding, stride, ceil_mode):
    """Spatial arithmetic of the reference (maxpool.py:204-216)."""
    batch_size, height, width, channels = input_shape
    kh, kw = kernel_size
    ph, pw = padding
    sh, sw = stride
    ceil = math.ceil if ceil_mode else math.floor
    out_height = ceil((height + 2 * ph - (kh - 1) - 1) / sh + 1)
    out_width = ceil((width + 2 * pw - (kw - 1) - 1) / sw + 1)
    return (batch_size, out_height, out_width, channels)


def _pad_for_pool(x, kernel_size, padding, stride, ceil_mode):
    """Zero-pad like the reference, then -inf-pad so every window fits
    (elements past the padded array are absent from the reference's
    windows under ceil_mode).  Returns the padded NHWC array and the
    output's spatial dims."""
    b, h, w, c = x.shape
    kh, kw = kernel_size
    ph, pw = padding
    sh, sw = stride
    _, oh, ow, _ = pool_output_shape(x.shape, kernel_size, padding, stride,
                                     ceil_mode)
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    extra_h = max(0, (oh - 1) * sh + kh - (h + 2 * ph))
    extra_w = max(0, (ow - 1) * sw + kw - (w + 2 * pw))
    if extra_h or extra_w:
        x = F.pad(x, (0, 0, 0, extra_w, 0, extra_h), value=-math.inf)
    return x, oh, ow


def _window_slice(arr, ky, kx, oh, ow, stride):
    sh, sw = stride
    return arr[:, ky:ky + sh * (oh - 1) + 1:sh, kx:kx + sw * (ow - 1) + 1:sw]


class _MaxPool2d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kernel_size, padding, stride, ceil_mode):
        padded, oh, ow = _pad_for_pool(x, kernel_size, padding, stride,
                                       ceil_mode)
        y = F.max_pool2d(padded.permute(0, 3, 1, 2), kernel_size,
                         stride=stride).permute(0, 2, 3, 1)
        y = y[:, :oh, :ow].contiguous()
        ctx.save_for_backward(x, y)
        ctx.window = (kernel_size, padding, stride, ceil_mode)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        kernel_size, padding, stride, ceil_mode = ctx.window
        (kh, kw), (ph, pw) = kernel_size, padding
        _, h, w, _ = x.shape
        padded, oh, ow = _pad_for_pool(x, kernel_size, padding, stride,
                                       ceil_mode)
        # tie mask per window offset: exact equality, like the reference
        # CPU path (maxpool.py:50)
        masks = [[_window_slice(padded, ky, kx, oh, ow, stride) == y
                  for kx in range(kw)] for ky in range(kh)]
        cnt = sum(m.to(g.dtype) for row in masks for m in row)
        contrib = g / cnt
        dpadded = torch.zeros_like(padded)
        for ky in range(kh):
            for kx in range(kw):
                _window_slice(dpadded, ky, kx, oh, ow, stride).add_(
                    torch.where(masks[ky][kx], contrib,
                                torch.zeros_like(contrib)))
        # crop the reference's zero padding and the -inf extension
        return dpadded[:, ph:ph + h, pw:pw + w], None, None, None, None


def max_pool2d(x, kernel_size=(2, 2), padding=(0, 0), stride=None,
               ceil_mode=False):
    """Max pooling over NHWC.  `stride` defaults to `kernel_size`."""
    stride = kernel_size if stride is None else stride
    return _MaxPool2d.apply(x, tuple(kernel_size), tuple(padding),
                            tuple(stride), ceil_mode)
