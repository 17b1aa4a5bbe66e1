"""NHWC convolution and the width->batch unfold (univer_ocr_tpu/ops/conv.py).

Public layouts are the JAX package's: NHWC activations and HWIO weights.
The transposes to PyTorch's NCHW/OIHW happen inside.  Padding is an
explicit constant pad followed by a VALID window, as in the JAX op.
"""

import torch
import torch.nn.functional as F

from . import precision as precision_policy


def conv2d(x, w, b, *, stride=(1, 1), padding=(0, 0), padding_value=0.0,
           precision=None):
    """x: (B, H, W, Cin) NHWC; w: (kh, kw, Cin, Cout) HWIO; b: (Cout,).
    Returns (B, Ho, Wo, Cout) float32.  `precision` as in ops/precision.py
    (on the card, 'highest' is full float32 inside its backend_flags)."""
    mode = precision_policy.resolve(precision)
    xc = x.permute(0, 3, 1, 2)
    ph, pw = padding
    if ph or pw:
        xc = F.pad(xc, (pw, pw, ph, ph), value=padding_value)
    wc = w.permute(3, 2, 0, 1)
    if mode == 'bf16':
        # bf16-rounded operands, float32 sums: JAX's bf16 inputs with
        # preferred_element_type=float32
        xc = xc.to(torch.bfloat16).float()
        wc = wc.to(torch.bfloat16).float()
    y = F.conv2d(xc, wc, stride=tuple(stride))
    return (y.permute(0, 2, 3, 1) + b).contiguous()


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
