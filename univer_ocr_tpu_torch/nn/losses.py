"""Loss classes (univer_ocr_tpu/nn/losses.py).

`.fn(pred, gt)` is the scalar loss from ops/losses.py, used inside model
steps (autograd differentiates the whole step); `__call__(pred, gt) ->
(float(loss), grad)` is the reference's fused signature.
"""

import torch

from ..ops import losses as _L


class BaseLoss:
    fn = None

    def __call__(self, prediction, ground_truth):
        pred = torch.as_tensor(prediction).detach().requires_grad_(True)
        gt = torch.as_tensor(ground_truth)
        loss = type(self).fn(pred, gt)
        (grad,) = torch.autograd.grad(loss, pred)
        return float(loss.detach()), grad

    def __repr__(self):
        return f'{type(self).__name__}()'


class SegmentationDice2D(BaseLoss):
    fn = staticmethod(_L.segmentation_dice_2d)


class SegmentationJaccard2D(BaseLoss):
    fn = staticmethod(_L.segmentation_jaccard_2d)


class SigmoidCrossEntropy(BaseLoss):
    fn = staticmethod(_L.sigmoid_cross_entropy)


class SoftmaxCrossEntropy(BaseLoss):
    fn = staticmethod(_L.softmax_cross_entropy)
