"""The device mesh and what runs over it (univer_ocr_tpu/parallel/): one
process drives a ('data', 'model') grid of torch devices; see mesh.py."""

from .data_parallel import (make_dp_train_step, make_tp_char_train_step,
                            shard_batch)
from .mesh import make_mesh

__all__ = ['make_dp_train_step', 'make_mesh', 'make_tp_char_train_step',
           'shard_batch']
