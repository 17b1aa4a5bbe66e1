"""Fully-connected op with the bias folded in as the weight's last row
(univer_ocr_tpu/ops/dense.py; the model_weights.json layout)."""

import torch

from . import precision as precision_policy


def dense(x, w, *, precision=None):
    """x: (B, n_in); w: (n_in + 1, n_out), bias in the last row.
    `precision` as in ops/precision.py (on the card, 'highest' is full
    float32 inside its backend_flags)."""
    mode = precision_policy.resolve(precision)
    weight, bias_row = w[:-1, :], w[-1, :]
    if mode == 'bf16':
        # bf16-rounded operands, float32 sums (ops/precision.py)
        x = x.to(torch.bfloat16).float()
        weight = weight.to(torch.bfloat16).float()
    return x @ weight + bias_row
