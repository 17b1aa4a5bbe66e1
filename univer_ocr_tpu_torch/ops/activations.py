"""Elementwise activations (univer_ocr_tpu/ops/activations.py)."""

import torch


def leaky_relu(x, alpha=0.01):
    return torch.where(x >= 0, x, alpha * x)


def sigmoid(x):
    return 1 / (1 + torch.exp(-x))
