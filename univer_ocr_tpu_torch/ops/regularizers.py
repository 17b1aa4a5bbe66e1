"""L1/L2 penalties (univer_ocr_tpu/ops/regularizers.py); autograd gives
the reference's sign(w) * strength and 2 * strength * w."""

import torch


def l1_regularizer(weights, reg_strength):
    return reg_strength * torch.sum(torch.abs(weights))


def l2_regularizer(weights, reg_strength):
    return reg_strength * torch.sum(weights ** 2)
