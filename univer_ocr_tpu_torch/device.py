"""Device resolution: the port runs on the card unless told otherwise."""

import torch


def resolve_device(device=None):
    """`None` or 'cuda' -> the current CUDA device, raising when there is
    no card; 'cpu' (the tests' choice) -> the CPU.  Never falls back."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'a CUDA device was asked for but torch.cuda.is_available() is '
            "False; pass device='cpu' to run on the host")
    if device.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {device}')
    return device
