"""Precision policy for the compute ops (univer_ocr_tpu/ops/precision.py).

  * 'highest': full float32.  cuDNN convolutions default to TF32 on an
    H100 (`torch.backends.cudnn.allow_tf32` is True), which keeps about
    three decimal digits and misses the 1e-5 parity bar, so on the card
    this mode needs TF32 off for both convolutions and matrix products:
    run the ops inside `backend_flags('highest')`.  OCRPipeline's device
    stages do.
  * 'bf16': inputs cast to bfloat16 for the tensor cores; every result is
    cast back to float32, as JAX's `preferred_element_type=float32` hands
    back float32.
"""

import contextlib

import torch

VALID_MODES = ('highest', 'bf16')
DEFAULT_MODE = 'highest'


def resolve(mode=None):
    """The effective mode (None -> 'highest'); raises on an unknown one."""
    mode = DEFAULT_MODE if mode is None else mode
    if mode not in VALID_MODES:
        raise ValueError(f'precision must be one of {VALID_MODES}: {mode!r}')
    return mode


@contextlib.contextmanager
def backend_flags(mode=None):
    """Inside the block, 'highest' turns TF32 off for cuDNN convolutions
    and cuBLAS matrix products; both switches are restored on exit.
    'bf16' leaves them as they are.  The switches are process-wide, so
    enter this from one thread at a time."""
    mode = resolve(mode)
    if mode != 'highest':
        yield mode
        return
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield mode
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
