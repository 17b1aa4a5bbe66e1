"""The checkpoint carried into the port, and the port's import boundary.

`params_from_numpy` and `load_checkpoint` must give the same 18 entries,
shapes and values as the JAX package's `model.set_weights` path on the
committed model_weights.json.  The guard test pins that nothing in the
port (the package and chip_smoke.py) imports JAX or the JAX package."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from univer_ocr_tpu.models import (make_char, make_line, make_monochrome,
                                   make_paragraph)
from univer_ocr_tpu_torch.weights import (DEFAULT_CHECKPOINT, load_checkpoint,
                                          params_from_numpy)

ROOT = Path(__file__).resolve().parents[1]
PAGE_SHAPE = (1, 496, 736, 1)


@pytest.fixture(scope='module')
def checkpoint():
    with open(DEFAULT_CHECKPOINT) as fp:
        return json.load(fp)


@pytest.fixture(scope='module')
def jax_params(checkpoint):
    params = {}
    for make in (make_monochrome, make_paragraph, make_line, make_char):
        model = make(PAGE_SHAPE)
        model.set_weights(checkpoint)
        params.update(model.params)
    return params


def _same(port, jax_params):
    assert len(port) == len(jax_params) == 18
    assert set(port) == set(jax_params)
    for name, entry in jax_params.items():
        assert set(port[name]) == set(entry), name
        for k, v in entry.items():
            t = port[name][k]
            assert t.dtype == torch.float32 and t.device.type == 'cpu'
            assert tuple(t.shape) == tuple(v.shape), (name, k)
            np.testing.assert_array_equal(t.numpy(), np.asarray(v))


def test_params_from_numpy_matches_set_weights(checkpoint, jax_params):
    arrays = {name: {k: np.asarray(v) for k, v in entry.items()}
              for name, entry in checkpoint.items()}
    _same(params_from_numpy(arrays, 'cpu'), jax_params)


def test_load_checkpoint_matches_set_weights(jax_params):
    _same(load_checkpoint(device='cpu'), jax_params)


def _port_files():
    return sorted((ROOT / 'univer_ocr_tpu_torch').rglob('*.py')) + [
        ROOT / 'chip_smoke.py']


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10 and (ROOT / 'chip_smoke.py').exists()
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {'jax', 'jaxlib', 'univer_ocr_tpu'}, path


def test_port_modules_do_not_import_pil():
    """The card machine has no Pillow: no module imports it when it is
    imported (predict.py opens image files with it inside a function)."""
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = {a.name.split('.')[0] for n in top
                 if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split('.')[0] for n in top
                  if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert 'PIL' not in names, path
