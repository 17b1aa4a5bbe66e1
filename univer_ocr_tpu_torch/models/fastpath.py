"""Masked fixed-shape forwards of the cascade (univer_ocr_tpu/models/
fastpath.py).

Crops are padded to a bucket shape; zeroing everything outside the valid
region after every conv keeps the valid region of the padded computation
equal to the unpadded one (conv padding is 0 and LeakyReLU(0) = 0
throughout this model zoo).  Valid extents are ints or (N,) tensors.
Parameters are the checkpoint dict `{name: {'w', 'b'}}` (weights.py);
activations are NHWC.
"""

import torch

from .. import ops
from ..nn.models import value_and_grad
from ..ops.losses import segmentation_dice_2d
from ..ops.kernels import (CharHeadWeights, fused_char_head,
                           fused_char_head_reference,
                           fused_monochrome_reference, prepare_char_head,
                           prepare_monochrome)

LEAKY_ALPHA = 0.01


def _per_sample(v, device):
    """A per-sample value broadcast over NHWC.  A Python int, one value
    for every sample, stays a scalar: as a tensor it would be copied to
    the device from pageable memory, which waits for the stream."""
    if isinstance(v, int):
        return v
    return torch.as_tensor(v, device=device).reshape(-1, 1, 1, 1)


def _mask_hw(x, h_valid, w_valid):
    """Zero NHWC entries with row >= h_valid or col >= w_valid."""
    rows = torch.arange(x.shape[1], device=x.device).reshape(1, -1, 1, 1)
    cols = torch.arange(x.shape[2], device=x.device).reshape(1, 1, -1, 1)
    keep = ((rows < _per_sample(h_valid, x.device))
            & (cols < _per_sample(w_valid, x.device)))
    return torch.where(keep, x, torch.zeros_like(x))


def _conv(params, key, x, stride=1, padding=2, precision=None):
    p = params[key]
    return ops.conv2d(x, p['w'], p['b'], stride=(stride, stride),
                      padding=(padding, padding), precision=precision)


def _leaky(x):
    return ops.leaky_relu(x, LEAKY_ALPHA)


def line_forward_masked(params, x, h_valid, w_valid, prefix='Line',
                        precision=None):
    """Masked Paragraph/Line FCN forward: x is a bucket-padded (B, H, W, C)
    crop whose true extent is (h_valid, w_valid), multiples of 4.  Returns
    the full padded output; callers trim to (h_valid, w_valid)."""
    x = _mask_hw(x, h_valid, w_valid)

    x = _leaky(_conv(params, f'{prefix}/down_1/conv_1', x, stride=2,
                     precision=precision))
    h2, w2 = h_valid // 2, w_valid // 2
    x = _mask_hw(x, h2, w2)

    x = _leaky(_conv(params, f'{prefix}/down_2/conv_1', x, stride=2,
                     precision=precision))
    h4, w4 = h_valid // 4, w_valid // 4
    x = _mask_hw(x, h4, w4)

    x = ops.upsample2d(x, 2)
    x = _leaky(_conv(params, f'{prefix}/up_2/conv_block/conv_1', x,
                     precision=precision))
    x = _mask_hw(x, h2, w2)

    x = ops.upsample2d(x, 2)
    x = _leaky(_conv(params, f'{prefix}/up_1/conv_block/conv_1', x,
                     precision=precision))
    x = _mask_hw(x, h_valid, w_valid)

    x = _conv(params, f'{prefix}/end/conv_1', x, precision=precision)
    return ops.sigmoid(x)


def char_forward_masked(params, x, w_valid, precision=None, head='xla'):
    """Masked Char forward: x is a (N, 32, W, 1) batch of bucket-padded
    lines, `w_valid` a (N,) vector of true widths.  Returns (N, W, 162)
    logits; row (n, j) is valid for j < w_valid[n].

    conv [64, 64, 64] k(5,3) p(0,1) s(2,1) -> width-8 unfold -> flatten ->
    dense [1024, 128, 162].  `head='xla'` runs the unfold and the dense
    chain as plain ops (the JAX package's name for that path), the fused
    head's plain version; `head='conv'` runs the unfold and dense_1 as
    one width-8 convolution (the JAX device cascade's line stage, which
    chip_smoke.py times beside the kernel); a
    `CharHeadWeights` (`char_head_weights`) runs them as the fused CUDA
    kernel (ops/kernels/char_head.py), which always computes in full
    float32 (3xTF32).
    """
    if head not in ('xla', 'conv') and not isinstance(head,
                                                      CharHeadWeights):
        raise ValueError("head must be 'xla', 'conv' or a CharHeadWeights: "
                         f'{head!r}')
    wv = _per_sample(w_valid, x.device)

    def mask_w(t):
        cols = torch.arange(t.shape[2], device=t.device).reshape(1, 1, -1, 1)
        return torch.where(cols < wv, t, torch.zeros_like(t))

    x = mask_w(x)
    for i in (1, 2, 3):
        p = params[f'Char/conv_block/conv_{i}']
        x = ops.conv2d(x, p['w'], p['b'], stride=(2, 1), padding=(0, 1),
                       precision=precision)
        x = mask_w(_leaky(x))

    x = x[:, 0, :, :].contiguous()
    if head == 'conv':
        return char_head_conv(params, x, precision)
    if isinstance(head, CharHeadWeights):
        return fused_char_head(x, head)
    return fused_char_head_reference(x, *_char_dense(params),
                                     precision=precision)


def char_head_conv(params, x, precision):
    """The Char head as a width-8 convolution (univer_ocr_tpu/models/
    fastpath.py, head='conv'): output column j of unfold(8) + dense_1
    reads conv-stack columns [j-4, j+4), flattened as (dx, c) -> dx*C + c,
    which is an HWIO (1, 8, C, 1024) kernel over the row padded by (4, 3);
    then dense_2 and dense_3.  x: (N, W, C) -> (N, W, 162) logits."""
    N, W, C = x.shape
    w1 = params['Char/dense_block/dense_1']['w']
    k1 = w1[:-1].reshape(1, 8, C, -1)
    padded = torch.nn.functional.pad(x, (0, 0, 4, 3))[:, None]
    h = ops.conv2d(padded, k1, w1[-1], precision=precision)
    h = _leaky(h).reshape(N * W, -1)
    h = _leaky(ops.dense(h, params['Char/dense_block/dense_2']['w'],
                         precision=precision))
    h = ops.dense(h, params['Char/dense_block/dense_3']['w'],
                  precision=precision)
    return h.reshape(N, W, -1)


def _char_dense(params):
    return [params[f'Char/dense_block/dense_{i}']['w'] for i in (1, 2, 3)]


def char_head_weights(params):
    """The Char dense weights prepared for the fused kernel, once per set
    of weights."""
    return prepare_char_head(*_char_dense(params))


def monochrome_forward(params, x, prefix='Monochrome', precision=None):
    """Monochrome conv block [16, 1] k3 p1 with a sigmoid end, as plain
    ops (the fused kernel's plain version).  Fixed page shape: no
    masking."""
    c1, c2 = params[f'{prefix}/conv_1'], params[f'{prefix}/conv_2']
    return fused_monochrome_reference(x, c1['w'], c1['b'], c2['w'], c2['b'],
                                      precision=precision)


def monochrome_weights(params, prefix='Monochrome'):
    """The Monochrome weights packed for the fused kernel, once per set of
    weights."""
    c1, c2 = params[f'{prefix}/conv_1'], params[f'{prefix}/conv_2']
    return prepare_monochrome(c1['w'], c1['b'], c2['w'], c2['b'])


# ---------------------------------------------------------------------------
# Masked training steps: bucket-padded crops with the per-crop loss and
# gradients of the unpadded computation.
#   * Line/Paragraph (Dice): the prediction is masked *after* the final
#     sigmoid (sigmoid(0) = 0.5 would otherwise inflate the denominator),
#     the target is zero-padded, so the per-channel Dice equals the
#     unpadded loss and invalid positions get zero gradient.
#   * Char (softmax CE): zero-padded label rows add 0 to the loss sum and
#     their logits get zero gradient, and the mean is taken over the
#     *true* width, not the padded one.
# ---------------------------------------------------------------------------


def masked_line_loss(params, x, y, h_valid, w_valid, prefix='Line',
                     reg_fn=None):
    pred = line_forward_masked(params, x, h_valid, w_valid, prefix=prefix)
    pred = _mask_hw(pred, h_valid, w_valid)
    out_loss = segmentation_dice_2d(pred, y)
    reg = reg_fn(params) if reg_fn is not None else 0.0
    return out_loss + reg, (out_loss, reg, pred)


def masked_char_loss(params, x, y, w_valid, reg_fn=None):
    """x: (1, 32, Wb, C); y: (Wb, n_chars) zero-padded beyond w_valid (an
    int)."""
    logits = char_forward_masked(params, x, w_valid)
    logits = logits.reshape(-1, logits.shape[-1])     # (Wb, n_chars)
    shifted = logits - torch.amax(logits, dim=1, keepdim=True)
    log_probs = shifted - torch.log(
        torch.sum(torch.exp(shifted), dim=1, keepdim=True))
    out_loss = -torch.sum(y * log_probs) / w_valid
    reg = reg_fn(params) if reg_fn is not None else 0.0
    return out_loss + reg, (out_loss, reg, logits)


def make_masked_train_step(opt, loss_fn):
    """step(params, opt_state, lr, *batch_args) -> (new_params,
    new_opt_state, out_loss, reg, pred): autograd of
    `loss_fn(params, *batch_args) -> (total, (out_loss, reg, pred))` over
    every parameter, then `opt`'s update."""
    def step(params, opt_state, lr, *batch_args):
        _, (out_loss, reg, pred), grads = value_and_grad(
            loss_fn, params, list(params), *batch_args)
        with torch.no_grad():
            new_params, new_opt_state = opt.update(params, grads, opt_state,
                                                   lr)
        return new_params, new_opt_state, out_loss, reg, pred

    return step


def make_masked_eval_step(loss_fn):
    def step(params, *batch_args):
        with torch.no_grad():
            _, (out_loss, reg, pred) = loss_fn(params, *batch_args)
        return out_loss, reg, pred

    return step
