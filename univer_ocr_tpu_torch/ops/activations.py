"""Elementwise activations (univer_ocr_tpu/ops/activations.py)."""

import torch


def relu(x):
    return torch.where(x >= 0, x, torch.zeros_like(x))


def leaky_relu(x, alpha=0.01):
    return torch.where(x >= 0, x, alpha * x)


def sigmoid(x):
    return 1 / (1 + torch.exp(-x))
