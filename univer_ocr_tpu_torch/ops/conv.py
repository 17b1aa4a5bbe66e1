"""NHWC convolution and the width->batch unfold (univer_ocr_tpu/ops/conv.py).

Public layouts are the JAX package's: NHWC activations and HWIO weights.
The transposes to PyTorch's NCHW/OIHW happen inside.  Padding is an
explicit constant pad followed by a VALID window, as in the JAX op.
"""

import math

import torch
import torch.nn.functional as F

from . import precision as precision_policy


def conv_output_shape(input_shape, kernel_size, padding, stride, out_channels):
    """Spatial arithmetic of the reference (convolutional.py:290-301)."""
    batch_size, height, width, _ = input_shape
    kh, kw = kernel_size
    ph, pw = padding
    sh, sw = stride
    out_height = math.floor((height + 2 * ph - (kh - 1) - 1) / sh + 1)
    out_width = math.floor((width + 2 * pw - (kw - 1) - 1) / sw + 1)
    return (batch_size, out_height, out_width, out_channels)


def conv2d(x, w, b, *, stride=(1, 1), padding=(0, 0), padding_value=0.0,
           bias=True, preferred_dtype=None, precision=None):
    """x: (B, H, W, Cin) NHWC; w: (kh, kw, Cin, Cout) HWIO; b: (Cout,).
    Returns (B, Ho, Wo, Cout).  `bias=False` leaves `b` out (the
    reference's `bias_flag * b`).  `preferred_dtype` is the type the
    products are summed and returned in, as JAX's
    `preferred_element_type` (None: the inputs' type; 'bf16' always sums
    in float32).  `precision` as in ops/precision.py (on the card,
    'highest' is full float32 inside its backend_flags)."""
    mode = precision_policy.resolve(precision)
    xc = x.permute(0, 3, 1, 2)
    ph, pw = padding
    if ph or pw:
        xc = F.pad(xc, (pw, pw, ph, ph), value=padding_value)
    # contiguous OIHW: the CPU convolution's backward requires it
    wc = w.permute(3, 2, 0, 1).contiguous()
    if mode == 'bf16':
        # bf16-rounded operands, float32 sums: JAX's bf16 inputs with
        # preferred_element_type=float32
        xc = xc.to(torch.bfloat16).float()
        wc = wc.to(torch.bfloat16).float()
    elif preferred_dtype is not None:
        xc = xc.to(preferred_dtype)
        wc = wc.to(preferred_dtype)
    y = F.conv2d(xc, wc, stride=tuple(stride)).permute(0, 2, 3, 1)
    if bias:
        y = y + b
    return y.contiguous()


def unfold_output_shape(input_shape, width):
    """Shape rule of Conv2DToBatchedFixedWidthed."""
    bs, h, w, ch = input_shape
    if w < width:
        raise ValueError(f'Input width must be >= than output width, '
                         f'found: {w} < {width}')
    return (bs * w, h, width, ch)


def unfold_to_fixed_width(x, width):
    """(B, H, W, C) -> (B*W, H, width, C): item b*W + i is the zero-padded
    window of columns [i - width//2, i + width - width//2) of item b."""
    bs, h, w, ch = x.shape
    hw = width // 2
    padded = F.pad(x, (0, 0, hw, width - hw))            # pad the W axis
    idx = (torch.arange(w, device=x.device)[:, None]
           + torch.arange(width, device=x.device)[None, :])
    y = padded[:, :, idx, :]                              # (bs, h, w, width, ch)
    y = y.movedim(2, 1)                                   # (bs, w, h, width, ch)
    return y.reshape(bs * w, h, width, ch)
