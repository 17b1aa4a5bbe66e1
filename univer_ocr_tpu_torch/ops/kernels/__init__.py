"""Hand-written CUDA kernels of the port, one module each, with the plain
PyTorch version beside each kernel and the preparation of its weights,
made once per set of weights.  `_build.LAUNCHES` counts launches."""

from ._build import LAUNCHES
from .band_ccl import band_ccl, band_ccl_reference
from .char_head import (CharHeadWeights, fused_char_head,
                        fused_char_head_reference, prepare_char_head)
from .fused_monochrome import (MonochromeWeights, fused_monochrome,
                               fused_monochrome_reference,
                               prepare_monochrome)

__all__ = ['LAUNCHES', 'CharHeadWeights', 'MonochromeWeights', 'band_ccl',
           'band_ccl_reference', 'fused_char_head',
           'fused_char_head_reference', 'fused_monochrome',
           'fused_monochrome_reference', 'prepare_char_head',
           'prepare_monochrome']
