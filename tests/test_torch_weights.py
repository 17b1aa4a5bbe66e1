"""The checkpoint carried into the port, its random initialisation, and
the port's import boundary.

`params_from_numpy` and `load_checkpoint` must give the same 18 entries,
shapes and values as the JAX package's `model.set_weights` path on the
committed model_weights.json.  `random_params` draws the same entries
the way the JAX layers do (kaiming_uniform over (fan_in + 1, n_out),
values in [0, a)); its values cannot equal JAX's, whose PRNG differs, so
the tests hold names, shapes, the range, the mean near a/2 and
determinism under a seed.  The guard test pins that nothing in the port
(the package and chip_smoke.py) imports JAX or the JAX package."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from univer_ocr_tpu.models import (make_char, make_line, make_monochrome,
                                   make_paragraph)
from univer_ocr_tpu.ops import initializers as jax_initializers
from univer_ocr_tpu_torch.ops import initializers
from univer_ocr_tpu_torch.weights import (DEFAULT_CHECKPOINT, load_checkpoint,
                                          params_from_numpy, random_params)

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


def test_params_from_numpy_takes_tensors(checkpoint, jax_params):
    tensors = {name: {k: torch.tensor(v, dtype=torch.float64)
                      for k, v in entry.items()}
               for name, entry in checkpoint.items()}
    _same(params_from_numpy(tensors, 'cpu'), jax_params)


def _fan_in(name, entry):
    w = entry['w']
    return w.shape[0] - 1 if 'b' not in entry else int(np.prod(w.shape[:3]))


def test_random_params_have_the_checkpoint_layout(jax_params):
    params = random_params(torch.Generator().manual_seed(1), 'cpu')
    assert list(params) == list(load_checkpoint(device='cpu'))
    assert set(params) == set(jax_params)
    for name, entry in jax_params.items():
        assert set(params[name]) == set(entry), name
        for k, v in entry.items():
            t = params[name][k]
            assert t.dtype == torch.float32 and t.device.type == 'cpu'
            assert tuple(t.shape) == tuple(v.shape), (name, k)


def test_random_params_lie_in_the_kaiming_uniform_range():
    """Each entry is one (fan_in + 1, n_out) draw scaled by
    a = 1 / sqrt((fan_in + 1) / 2): values in [0, a] (a float32 product
    can round up to a), mean a/2 within 5 standard errors."""
    params = random_params(torch.Generator().manual_seed(2), 'cpu')
    for name, entry in params.items():
        values = torch.cat([t.reshape(-1) for t in entry.values()]).double()
        a = 1 / np.sqrt((_fan_in(name, entry) + 1) / 2)
        assert values.min() >= 0 and values.max() <= a * (1 + 1e-6), name
        sem = a / np.sqrt(12 * values.numel())
        assert abs(values.mean().item() - a / 2) <= 5 * sem, name


def test_random_params_are_deterministic_under_a_seed():
    a = random_params(torch.Generator().manual_seed(3), 'cpu')
    b = random_params(torch.Generator().manual_seed(3), 'cpu')
    c = random_params(torch.Generator().manual_seed(4), 'cpu')
    for name in a:
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k]), (name, k)
            assert not torch.equal(a[name][k], c[name][k]), (name, k)


@pytest.mark.parametrize('name', ['xavier_normal', 'xavier_uniform',
                                  'kaiming_normal', 'kaiming_uniform',
                                  'kaiming_uniform_symmetric',
                                  'xavier_uniform_symmetric'])
def test_initializers_match_jax_in_distribution(name):
    """Same scale and support as the JAX initializer of the same name,
    from another PRNG: mean and standard deviation within 5 % of the
    scale over 200 x 300 draws."""
    import jax
    got = getattr(initializers, name)(
        torch.Generator().manual_seed(5), 200, 300).numpy()
    exp = np.asarray(getattr(jax_initializers, name)(
        jax.random.PRNGKey(5), 200, 300, np.float32))
    assert got.shape == exp.shape == (200, 300)
    assert got.dtype == np.float32
    scale = np.abs(exp).max()
    assert abs(got.mean() - exp.mean()) <= 0.05 * scale
    assert abs(got.std() - exp.std()) <= 0.05 * scale
    assert (got.min() >= 0) == (exp.min() >= 0)


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
