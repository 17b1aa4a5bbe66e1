"""Checkpoints (univer_ocr_tpu/nn/checkpoint.py).

Weights go to a model_weights.json (`{layer/path: {param: nested
lists}}`, the JAX package's schema) by a read-merge-write that is atomic
(a temporary file, fsync, rename), so that a reader never sees a torn
file; optimizer state goes beside it as `.opt.npz`, keyed
`model|layer|param|slot`.  The caller names the file: nothing here
defaults to the JAX package's committed checkpoint.
"""

import json
import os
from pathlib import Path

import numpy as np
import torch


def _flatten_state(opt_state, prefix=''):
    flat = {}
    for key, value in opt_state.items():
        path = f'{prefix}{key}' if not prefix else f'{prefix}|{key}'
        if isinstance(value, dict):
            flat.update(_flatten_state(value, path))
        else:
            flat[path] = value.detach().cpu().numpy()
    return flat


def _unflatten_state(flat, device):
    tree = {}
    for path, value in flat.items():
        parts = path.split('|')
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.as_tensor(value).to(device)
    return tree


def _write_atomically(path, write):
    tmp = path.with_name(path.name + '.tmp')
    with open(tmp, 'wb') as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_weights(weights, path):
    """Write a `{layer: {param: nested lists}}` dict as the JSON
    checkpoint at `path`, atomically."""
    _write_atomically(Path(path), lambda f: f.write(
        json.dumps(weights, separators=(',', ':')).encode()))


def save_weights(models, path):
    """Merge all models' weights into the JSON checkpoint at `path`
    (created if missing), atomically."""
    try:
        with open(path) as f:
            weights = json.load(f)
    except FileNotFoundError:
        weights = {}
    for model in models.values():
        weights.update(model.get_weights())
    write_weights(weights, path)


def read_weights(path):
    """The checkpoint dict at `path`, or {} when it cannot be read."""
    try:
        with open(path) as f:
            return json.load(f)
    except OSError:
        return {}


def load_weights(models, path):
    """Set every model's weights from the checkpoint at `path`; False when
    there is no file."""
    try:
        with open(path) as f:
            weights = json.load(f)
    except FileNotFoundError:
        return False
    for model in models.values():
        model.set_weights(weights)
    return True


def opt_state_path(weights_path):
    return Path(weights_path).with_suffix('.opt.npz')


def save_optimizer_state(models, weights_path):
    """Save every model's optimizer state beside the weights file."""
    flat = {}
    for name, model in models.items():
        if model.opt_state is None:
            continue
        for key, value in _flatten_state(model.opt_state).items():
            flat[f'{name}|{key}'] = value
    if not flat:
        return False
    _write_atomically(opt_state_path(weights_path),
                      lambda f: np.savez(f, **flat))
    return True


def load_optimizer_state(models, weights_path):
    path = opt_state_path(weights_path)
    if not path.exists():
        return False
    per_model = {}
    with np.load(path) as data:
        for key in data.files:
            model_name, rest = key.split('|', 1)
            per_model.setdefault(model_name, {})[rest] = data[key]
    loaded = False
    for name, model in models.items():
        if name in per_model:
            model.opt_state = _unflatten_state(per_model[name],
                                               model._compute_device())
            loaded = True
    return loaded
