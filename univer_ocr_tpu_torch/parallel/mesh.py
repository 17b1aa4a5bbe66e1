"""The device mesh (univer_ocr_tpu/parallel/mesh.py): a ('data', 'model')
grid of `torch.device`s, driven by one process.

JAX's mesh has one controller: one Python process drives every chip, the
host work runs once, and each sharded stage splits its launch batch over
the 'data' devices and merges the results.  The port keeps that design:
a `Mesh` is a grid of devices, and the functions of parallel/serving.py
and parallel/data_parallel.py run each shard's work on its own device
from the calling thread, with `Replicated` and `Sharded` values holding
one entry per 'data' shard.  A device may repeat in the grid: a mesh of
four shards on one card (or on the CPU, as the tests run it) splits,
launches and merges exactly as a mesh of four cards does, which is this
port's counterpart of JAX's virtual host devices.
"""

import contextlib

import numpy as np
import torch

class Mesh:
    """A (data, model) grid of torch devices: `devices[d][m]` is the
    device of data shard d and model shard m."""

    def __init__(self, grid):
        self.devices = tuple(tuple(row) for row in grid)
        if not self.devices or len({len(row) for row in self.devices}) != 1:
            raise ValueError('a mesh is a non-empty rectangular grid')

    @property
    def shape(self):
        return {'data': len(self.devices), 'model': len(self.devices[0])}

    def data_devices(self):
        """The first device of each 'data' shard, in shard order (the
        mesh's first column)."""
        return [row[0] for row in self.devices]

    def model_devices(self):
        """The devices of the first 'data' shard along 'model' (the mesh's
        first row)."""
        return list(self.devices[0])

    @property
    def primary(self):
        """The first device: merged outputs and parameter masters live
        here."""
        return self.devices[0][0]

    def __repr__(self):
        return f'Mesh({self.shape}, {[list(map(str, r)) for r in self.devices]})'


def _device(d):
    d = torch.device(d)
    if d.type == 'cuda' and d.index is None:
        d = torch.device('cuda', torch.cuda.current_device())
    return d


def make_mesh(n_devices=None, model_parallel=1, devices=None):
    """A ('data', 'model') mesh of `n_devices` devices (default: all of
    `devices`), `model_parallel` along 'model'.  `devices` defaults to
    every visible CUDA device, raising when there is none or fewer than
    `n_devices`; an explicit list may repeat a device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'make_mesh needs CUDA devices but torch.cuda.is_available() '
                "is False; pass devices=[torch.device('cpu')] * n for a "
                'mesh on the host')
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise RuntimeError(f'a mesh of {n_devices} devices was asked '
                               f'for; {len(devices)} are available')
        devices = devices[:n_devices]
    n = len(devices)
    assert n % model_parallel == 0, (n, model_parallel)
    m = model_parallel
    return Mesh([devices[i * m:(i + 1) * m] for i in range(n // m)])


def mesh_device(mesh, device=None):
    """The device that a caller of `mesh` computes on: the mesh's first
    device.  `device`, when given, must be of the same type."""
    if device is not None and torch.device(device).type != mesh.primary.type:
        raise ValueError(f'device {device} does not match {mesh}')
    return mesh.primary


def on_device(device):
    """The context in which a shard's work is launched: its card as the
    current device (so that launches, events and copies use that card's
    current stream); nothing on the CPU."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def to_device(tree, device):
    """Tensors and numpy arrays (in nested dicts, lists and tuples) as
    tensors on `device`; a tensor already there is returned as it is."""
    if isinstance(tree, np.ndarray):
        tree = torch.tensor(tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=True)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


class Replicated:
    """One value per 'data' shard, each on its shard's device (the same
    value on each): JAX's replicated sharding, P()."""

    def __init__(self, parts):
        self.parts = list(parts)


class Sharded:
    """A batch split over 'data': one slice per shard, in shard order,
    each on its shard's device: JAX's P('data')."""

    def __init__(self, parts):
        self.parts = list(parts)


def replicate(tree, mesh):
    """`tree` copied once to each 'data' device (a device that repeats in
    the mesh shares one copy)."""
    copies = {}
    parts = []
    for dev in mesh.data_devices():
        if dev not in copies:
            with on_device(dev):
                copies[dev] = to_device(tree, dev)
        parts.append(copies[dev])
    return Replicated(parts)


def shard(x, mesh):
    """A batch (tensor or array, leading batch dim) split over 'data':
    equal slices along dim 0, each copied to its shard's device.  A
    `Sharded` value is returned as it is."""
    if isinstance(x, Sharded):
        return x
    t = torch.as_tensor(x) if isinstance(x, np.ndarray) else x
    n = mesh.shape['data']
    if t.shape[0] % n:
        raise ValueError(f'a batch of {t.shape[0]} does not divide over '
                         f'{n} data shards')
    parts = []
    for piece, dev in zip(torch.chunk(t, n), mesh.data_devices()):
        with on_device(dev):
            parts.append(piece.to(dev, non_blocking=True))
    return Sharded(parts)


def gather(parts, device):
    """Per-shard outputs merged in shard order on `device`: tensors
    concatenated along dim 0, tuples element by element, None kept."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return type(first)(gather([p[i] for p in parts], device)
                           for i in range(len(first)))
    return torch.cat([p.to(device, non_blocking=True) for p in parts])
