"""Hand-written CUDA kernels of the port, one module each, with the plain
PyTorch version beside each kernel.  `_build.LAUNCHES` counts launches."""

from ._build import LAUNCHES
from .char_head import fused_char_head, fused_char_head_reference
from .fused_monochrome import fused_monochrome, fused_monochrome_reference

__all__ = ['LAUNCHES', 'fused_char_head', 'fused_char_head_reference',
           'fused_monochrome', 'fused_monochrome_reference']
