"""Weight initializers (univer_ocr_tpu/ops/initializers.py).

Same math as the JAX package, including its quirk that the *uniform*
variants sample from [0, 1) (asymmetric, not centred), kept because
checkpoints trained either way must behave identically; the default of
every layer is `kaiming_uniform`.  Symmetric variants are provided under
`*_symmetric` names.  Draws come from an explicit `torch.Generator` and
are made in float32 on the generator's device.
"""

import math

import torch


def _uniform(generator, in_num, out_num):
    return torch.rand((in_num, out_num), generator=generator,
                      dtype=torch.float32, device=generator.device)


def _normal(generator, in_num, out_num):
    return torch.randn((in_num, out_num), generator=generator,
                       dtype=torch.float32, device=generator.device)


def xavier_normal(generator, in_num, out_num):
    a = 1 / math.sqrt(in_num)
    return a * _normal(generator, in_num, out_num)


def xavier_uniform(generator, in_num, out_num):
    a = 1 / math.sqrt(in_num)
    return a * _uniform(generator, in_num, out_num)


def kaiming_normal(generator, in_num, out_num):
    a = 1 / math.sqrt(in_num / 2)
    return a * _normal(generator, in_num, out_num)


def kaiming_uniform(generator, in_num, out_num):
    a = 1 / math.sqrt(in_num / 2)
    return a * _uniform(generator, in_num, out_num)


def kaiming_uniform_symmetric(generator, in_num, out_num):
    a = 1 / math.sqrt(in_num / 2)
    return a * (2 * _uniform(generator, in_num, out_num) - 1)


def xavier_uniform_symmetric(generator, in_num, out_num):
    a = 1 / math.sqrt(in_num)
    return a * (2 * _uniform(generator, in_num, out_num) - 1)
