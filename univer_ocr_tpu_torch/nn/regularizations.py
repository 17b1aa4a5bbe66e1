"""Regularizer classes (univer_ocr_tpu/nn/regularizations.py).

`.fn(weights)` is the penalty used inside model steps; `__call__` returns
the reference's fused `(float(loss), grad)` pair.
"""

import torch

from ..ops.regularizers import l1_regularizer, l2_regularizer


class BaseRegularizer:
    def __init__(self, reg_strength):
        self.reg_strength = float(reg_strength)

    def fn(self, weights):
        raise NotImplementedError()

    def __call__(self, weights):
        w = torch.as_tensor(weights).detach().requires_grad_(True)
        loss = self.fn(w)
        (grad,) = torch.autograd.grad(loss, w)
        return float(loss.detach()), grad

    def __repr__(self):
        return f'{type(self).__name__}({self.reg_strength})'


class L1(BaseRegularizer):
    def fn(self, weights):
        return l1_regularizer(weights, self.reg_strength)


class L2(BaseRegularizer):
    def fn(self, weights):
        return l2_regularizer(weights, self.reg_strength)
