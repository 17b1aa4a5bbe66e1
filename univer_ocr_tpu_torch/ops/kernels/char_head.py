"""Fused Char head: the CUDA kernel `csrc/char_head.cu` and its plain
PyTorch version.

Replaces univer_ocr_tpu/ops/pallas/char_head.py:fused_char_head.  For the
conv stack's (N, W, 64) output it computes the width-8 unfold (window j
reads columns [j-4, j+4), zero-padded), dense 512->1024 + LeakyReLU, dense
1024->128 + LeakyReLU and dense 128->162, each bias the last row of its
weight, and returns the (N, W, 162) logits.

Bound on the H100: FP32 work: 1,352,192 FLOP per column, so 16 lines at
W=256 are 5.54 GFLOP, 83 us at 67 TFLOP/s (660 us at W=2048), against
6.4 MB, 2 us at 3.35 TB/s.  The kernel never materialises the unfold and
keeps both hidden maps in shared memory, so only the input and the logits
touch device memory (see the source for the tiling).  It runs in full FP32
FFMA: TF32 would miss the 2e-4 bar on a K=512 sum.

A CPU tensor takes `fused_char_head_reference`; a CUDA tensor launches the
kernel or raises.
"""

import collections

import torch

from .. import dense, leaky_relu, unfold_to_fixed_width
from . import _build

LEAKY_ALPHA = 0.01
UNFOLD = 8
CHANNELS = 64
MAX_OUT = 192
NAME = 'fused_char_head'

#: launches of the kernel by the width W of its input, counted where
#: `_build.LAUNCHES` counts them (the path's width mix)
WIDTH_LAUNCHES = collections.Counter()


def fused_char_head_reference(x, w1, w2, w3, precision='highest'):
    """Plain PyTorch version: unfold + flatten + three dense layers, in
    full float32 unless `precision` says otherwise (ops/precision.py)."""
    N, W, C = x.shape
    unfolded = unfold_to_fixed_width(x[:, None, :, :], UNFOLD)
    flat = unfolded.reshape(unfolded.shape[0], -1)
    h = leaky_relu(dense(flat, w1, precision=precision), LEAKY_ALPHA)
    h = leaky_relu(dense(h, w2, precision=precision), LEAKY_ALPHA)
    logits = dense(h, w3, precision=precision)
    return logits.reshape(N, W, -1)


def _check(t, name, dev, shape, aligned=False):
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f'{NAME}: {name} must be float32 on {dev}, '
                         f'got {t.dtype} on {t.device}')
    if tuple(t.shape) != shape:
        raise ValueError(f'{NAME}: {name} must have shape {shape}, '
                         f'got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{NAME}: {name} must be contiguous')
    if aligned and t.data_ptr() % 16:
        raise ValueError(f'{NAME}: {name} must be 16-byte aligned')


def fused_char_head(x, w1, w2, w3):
    """x: (N, W, 64) float32; w1: (513, 1024); w2: (1025, 128);
    w3: (129, n_out) with n_out <= 192.  Returns (N, W, n_out) float32."""
    if x.device.type == 'cpu':
        return fused_char_head_reference(x, w1, w2, w3)
    if x.device.type != 'cuda':
        raise ValueError(f'{NAME}: unsupported device {x.device}')
    if x.dim() != 3 or w3.dim() != 2:
        raise ValueError(f'{NAME}: x must be (N, W, 64) and w3 2-D')
    dev = x.device
    N, W, _ = x.shape
    n_out = w3.shape[1]
    if not 0 < n_out <= MAX_OUT:
        raise ValueError(f'{NAME}: at most {MAX_OUT} outputs, got {n_out}')
    _check(x, 'x', dev, (N, W, CHANNELS))
    _check(w1, 'w1', dev, (CHANNELS * UNFOLD + 1, 1024), aligned=True)
    _check(w2, 'w2', dev, (1025, 128), aligned=True)
    _check(w3, 'w3', dev, (129, n_out))
    out = torch.empty((N, W, n_out), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.function('uocr_char_head', 'pppppiiip')
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
                  out.data_ptr(), N, W, n_out, stream)
    _build.check(code, NAME)
    _build.LAUNCHES[NAME] += 1
    WIDTH_LAUNCHES[W] += 1
    return out
