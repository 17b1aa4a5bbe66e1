"""Seeded generators for parameter initialisation
(univer_ocr_tpu/nn/rng.py).

The JAX package draws layer keys from one global seed and counter.  The
port keeps no global random state: a model draws its layers' parameters
in order from a `torch.Generator` it is given (the factories take one),
so one seed makes a whole model's initialisation reproducible.  Draws
are made on the CPU and copied to the model's device, so a seed gives
the same values on every device.
"""

import torch

DEFAULT_SEED = 0


def make_generator(seed=DEFAULT_SEED):
    """A CPU `torch.Generator` seeded with `seed`."""
    return torch.Generator().manual_seed(seed)
