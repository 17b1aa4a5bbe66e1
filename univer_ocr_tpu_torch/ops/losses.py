"""Loss functions as scalar-valued functions of tensors, differentiated by
autograd (univer_ocr_tpu/ops/losses.py).  The eps placement and the batch
normalisation are the reference's, so autograd gives its analytic
gradients."""

import torch

EPS = 1e-8


def _hw_sum(x):
    """(B, H, W, C) -> (B, C) sums over H and W, accumulated in float64
    and rounded to x's dtype.  A float32 sum's rounding on the CPU follows
    torch's thread count, and the ratios below cancel (1 - 2 num / den):
    two ulps of one sum moved a Monochrome loss by 3.7e-7 of itself."""
    return torch.sum(x, dim=(1, 2), dtype=torch.float64).to(x.dtype)


def segmentation_dice_2d(prediction, ground_truth):
    """Soft Dice over (B, H, W, C), summed over batch and channels:
    eps in the numerator, 2 * eps in the denominator,
    loss = sum(1 - 2 * num / den)."""
    num = _hw_sum(prediction * ground_truth) + EPS
    den = _hw_sum(prediction) + _hw_sum(ground_truth) + 2 * EPS
    return torch.sum(1 - 2 * num / den)


def segmentation_dice_2d_per_sample(prediction, ground_truth):
    """segmentation_dice_2d of each sample alone: (B,) losses, each
    summed over its channels (the JAX batched trainer's vmap of it)."""
    num = _hw_sum(prediction * ground_truth) + EPS
    den = _hw_sum(prediction) + _hw_sum(ground_truth) + 2 * EPS
    return torch.sum(1 - 2 * num / den, dim=1)


def segmentation_jaccard_2d(prediction, ground_truth):
    """Soft Jaccard (IoU) with the same eps placement."""
    num = _hw_sum(prediction * ground_truth) + EPS
    den = _hw_sum(prediction) + _hw_sum(ground_truth) - num + 2 * EPS
    return torch.sum(1 - num / den)


def sigmoid_cross_entropy(prediction, ground_truth):
    """Sigmoid + binary CE over logits, mean over the batch, in the
    reference's direct form (log of the sigmoid)."""
    pred = 1 / (1 + torch.exp(-prediction))
    batch_size = ground_truth.shape[0]
    return -(torch.sum(ground_truth * torch.log(pred)
                       + (1 - ground_truth) * torch.log(1 - pred))) / batch_size


def softmax_cross_entropy(prediction, ground_truth):
    """Max-subtracted softmax CE over (B, n_classes), mean over the true
    batch."""
    shifted = prediction - torch.amax(prediction, dim=1, keepdim=True)
    log_probs = shifted - torch.log(
        torch.sum(torch.exp(shifted), dim=1, keepdim=True))
    batch_size = ground_truth.shape[0]
    return -torch.sum(ground_truth * log_probs) / batch_size
