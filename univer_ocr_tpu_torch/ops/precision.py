"""Precision policy for the compute ops (univer_ocr_tpu/ops/precision.py).

  * 'highest': full float32.  cuDNN convolutions default to TF32 on an
    H100 (`torch.backends.cudnn.allow_tf32` is True), which keeps about
    three decimal digits and misses the 1e-5 parity bar, so on the card
    this mode needs TF32 off for both convolutions and matrix products:
    run the ops inside `backend_flags('highest')`.  OCRPipeline's device
    stages do.
  * 'bf16': inputs and weights rounded to bfloat16, products summed in
    float32, as JAX's bf16 operands with `preferred_element_type=float32`.
    A bf16 value is exact in TF32 (10 mantissa bits to bf16's 7), so
    inside `backend_flags('bf16')`, which turns TF32 on, cuDNN and cuBLAS
    run these ops on the tensor cores with float32 accumulation.
"""

import contextlib

import torch

VALID_MODES = ('highest', 'bf16')

_default_mode = 'highest'


def _checked(mode):
    if mode not in VALID_MODES:
        raise ValueError(f'precision must be one of {VALID_MODES}: {mode!r}')
    return mode


def set_default_precision(mode):
    """Set the mode that `resolve(None)` returns: the module default of
    code that threads no policy (training, the per-page path).  Pipelines
    pass their mode explicitly and are not affected."""
    global _default_mode
    _default_mode = _checked(mode)


def resolve(mode=None):
    """The effective mode: an explicit policy or the module default
    ('highest' unless set_default_precision changed it); raises on an
    unknown one."""
    return _default_mode if mode is None else _checked(mode)


@contextlib.contextmanager
def backend_flags(mode=None):
    """Inside the block, 'highest' turns TF32 off for cuDNN convolutions
    and cuBLAS matrix products, and 'bf16' turns it on; both switches are
    restored on exit.  The switches are process-wide, so enter this from
    one thread at a time."""
    mode = resolve(mode)
    tf32 = mode == 'bf16'
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield mode
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
