"""The port's DAG models, masked train steps and checkpoint files
(univer_ocr_tpu_torch.nn.models, .models.model, .nn.checkpoint) against
the JAX package's, on the same numpy-seeded float32 inputs at small
sizes, with the same weights.  Bars: 1e-5 for losses, gradients and
parameters after a step; where a gradient is near 0 (|g| <= 1e-4 of the
largest), Adam's first step is close to lr * sqrt(1000) * sign(g) and a
sum order can flip the sign, so those elements are counted, not
compared, and the count is bounded."""

import ast
import json
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from univer_ocr_tpu.models import model as jmodel
from univer_ocr_tpu.nn.optimizers import Adam as JAdam
from univer_ocr_tpu.primitives import CHARS
from univer_ocr_tpu_torch.models import model as tmodel
from univer_ocr_tpu_torch.nn.checkpoint import (load_optimizer_state,
                                                load_weights,
                                                save_optimizer_state,
                                                save_weights)
from univer_ocr_tpu_torch.nn.optimizers import Adam as TAdam

ROOT = Path(__file__).resolve().parents[1]
LR = 1e-3
TOL = dict(rtol=1e-5, atol=1e-5)
#: elements with |g| <= NEAR_ZERO * max|g| are counted, not compared
NEAR_ZERO = 1e-4
#: at most this share of a model's near-zero elements may move the other
#: way after one Adam step
FLIP_SHARE = 0.02


def _inputs(name, rs):
    if name == 'Char':
        x = rs.rand(1, 32, 24, 1).astype(np.float32)
        y = np.eye(len(CHARS), dtype=np.float32)[rs.randint(0, len(CHARS),
                                                            24)]
        y[5] = 0                                   # an unlabeled column
        return (1, 32, 24, 1), x, y
    channels = {'Monochrome': 1, 'Paragraph': 1, 'Line': 2}[name]
    shape = (1, 32, 48, 1)
    x = rs.rand(*shape).astype(np.float32)
    y = (rs.rand(1, 32, 48, channels) > 0.6).astype(np.float32)
    return shape, x, y


_JAX_MODELS = {}


def _pair(name, seed=0):
    """The JAX model (its own random init, drawn once per test module:
    JAX draws it op by op) and the port's with its weights, both with a
    fresh Adam(LR), and the seeded (x, y)."""
    shape, x, y = _inputs(name, np.random.RandomState(seed))
    factory = f'make_{name.lower()}'
    if name not in _JAX_MODELS:
        jm = getattr(jmodel, factory)(shape, JAdam(lr=LR))
        _JAX_MODELS[name] = jm, jm.get_weights()
    jm, weights = _JAX_MODELS[name]
    jm.set_weights(weights)
    jm.opt_state = None
    tm = getattr(tmodel, factory)(shape, TAdam(lr=LR), device='cpu')
    tm.set_weights(weights)
    return jm, tm, x, y


def _np(tree):
    return {n: {k: np.asarray(v.detach() if isinstance(v, torch.Tensor)
                              else v) for k, v in d.items()}
            for n, d in tree.items()}


@pytest.mark.parametrize('name', ['Monochrome', 'Paragraph', 'Line', 'Char'])
def test_factory_model_matches_jax(name):
    jm, tm, x, y = _pair(name)

    # checkpoint names, relations and shapes
    assert list(tm.layers) == list(jm.layers)
    assert tm.relations == jm.relations
    assert sorted(tm.get_weights()) == sorted(jm.get_weights())
    assert tm.get_all_output_shapes(tm.input_shapes) == \
        jm.get_all_output_shapes(jm.input_shapes)
    assert tm.count_parameters() == jm.count_parameters()
    if jm.is_fully_convolutional():
        assert tm.get_receptive_fields() == jm.get_receptive_fields()
    else:
        with pytest.raises(AssertionError):
            tm.get_receptive_fields()

    # loss and gradients, parameters and inputs (JAX's in one jitted
    # value_and_grad of its loss_fn, the function its
    # compute_loss_and_gradients differentiates)
    t_losses = tm.compute_loss_and_gradients(x, y)
    (_, (j_out, j_reg, _)), (j_grads, j_in) = jax.jit(jax.value_and_grad(
        lambda p, xs: jm.loss_fn(p, xs, [jnp.asarray(y)]), argnums=(0, 1),
        has_aux=True))(jm.params, [jnp.asarray(x)])
    np.testing.assert_allclose(t_losses['output_losses'],
                               [float(v) for v in j_out], **TOL)
    np.testing.assert_allclose(t_losses['regularization_loss'],
                               float(j_reg), **TOL)
    np.testing.assert_allclose(tm.input_grads[0][0].numpy(),
                               np.asarray(j_in[0]), **TOL)
    j_grads = _np(j_grads)
    t_grads = _np(tm.gradients)
    assert sorted(t_grads) == sorted(j_grads)
    for n in j_grads:
        for k in j_grads[n]:
            scale = np.abs(j_grads[n][k]).max()
            np.testing.assert_allclose(t_grads[n][k], j_grads[n][k],
                                       rtol=1e-5, atol=1e-5 * max(scale, 1),
                                       err_msg=f'{n}/{k}')

    # one train step
    before = _np(jm.params)
    t_step = tm.train(x, y)
    j_step = jm.train(x, y)
    np.testing.assert_allclose(t_step['output_losses'],
                               j_step['output_losses'], **TOL)
    np.testing.assert_allclose(t_step['regularization_loss'],
                               j_step['regularization_loss'], **TOL)
    t_after, j_after = _np(tm.params), _np(jm.params)
    flips = near_zero = 0
    for n in j_after:
        for k in j_after[n]:
            g = j_grads[n][k]
            big = np.abs(g) > NEAR_ZERO * np.abs(g).max()
            np.testing.assert_allclose(t_after[n][k][big], j_after[n][k][big],
                                       **TOL, err_msg=f'{n}/{k}')
            t_move = np.sign(t_after[n][k] - before[n][k])[~big]
            j_move = np.sign(j_after[n][k] - before[n][k])[~big]
            flips += int((t_move != j_move).sum())
            near_zero += int((~big).sum())
    assert flips <= FLIP_SHARE * near_zero, (flips, near_zero)


def _line_inputs(rs, h=96, w=112):
    X = rs.rand(1, h, w, 1).astype(np.float32)
    y = (rs.rand(1, h, w, 2) > 0.5).astype(np.float32)
    return X, y


def _char_inputs(rs, w=50):
    X = rs.rand(1, 32, w, 1).astype(np.float32)
    y = np.eye(len(CHARS), dtype=np.float32)[rs.randint(0, len(CHARS), w)]
    return X, y


@pytest.mark.parametrize('name', ['Line', 'Char'])
@pytest.mark.parametrize('training', [True, False], ids=['train', 'test'])
def test_masked_component_step_matches_generic_and_jax(name, training):
    """The masked bucketed step of FastLineTrainComponent /
    FastCharTrainComponent gives the per-shape generic step's loss and
    parameters (the port's Model.train) and JAX's masked step's."""
    rs = np.random.RandomState(7)
    X, y = (_line_inputs if name == 'Line' else _char_inputs)(rs)
    jm, tm, _, _ = _pair(name)
    generic = getattr(tmodel, f'make_{name.lower()}')(
        tm.input_shapes[0], TAdam(lr=LR), device='cpu')
    generic.set_weights(jm.get_weights())
    comp_cls = f'Fast{name}TrainComponent'
    t_comp = getattr(tmodel, comp_cls)(name, tm, None)
    j_comp = getattr(jmodel, comp_cls)(name, jm, None)
    t_losses, t_pred = t_comp._run(X, y, training)
    j_losses, j_pred = j_comp._run(X, y, training)
    g_losses = (generic.train if training else generic.test)(X, y)
    for losses in (j_losses, g_losses):
        np.testing.assert_allclose(t_losses['output_losses'],
                                   losses['output_losses'], **TOL)
    np.testing.assert_allclose(t_losses['regularization_loss'],
                               j_losses['regularization_loss'], **TOL)
    np.testing.assert_allclose(t_pred.numpy(), np.asarray(j_pred),
                               rtol=1e-5, atol=1e-4)
    if training:
        t_after, j_after = _np(tm.params), _np(jm.params)
        g_after = _np(generic.params)
        for n in t_after:
            for k in t_after[n]:
                np.testing.assert_allclose(t_after[n][k], g_after[n][k],
                                           rtol=1e-4, atol=1e-5)
                close = np.isclose(t_after[n][k], j_after[n][k],
                                   rtol=1e-5, atol=1e-5)
                assert close.mean() > 0.98, (n, k, close.mean())


def test_port_checkpoint_loads_into_jax(tmp_path):
    """A checkpoint the port writes (merge-saved, atomically) holds JAX's
    names and shapes, loads into JAX's models, and JAX's forward then
    gives the port's values; the port reads it back, and its optimizer
    state round-trips through the .opt.npz."""
    rs = np.random.RandomState(8)
    gen = torch.Generator().manual_seed(3)
    shapes = {'Monochrome': (1, 32, 32, 1), 'Char': (1, 32, 24, 1)}
    models = {n: getattr(tmodel, f'make_{n.lower()}')(
                  s, TAdam(lr=LR), generator=gen, device='cpu')
              for n, s in shapes.items()}
    path = tmp_path / 'weights.json'
    path.write_text(json.dumps({'Other/layer': {'w': [1.0]}}))
    save_weights(models, path)
    written = json.loads(path.read_text())
    assert written['Other/layer'] == {'w': [1.0]}        # merged, kept
    assert not list(tmp_path.glob('*.tmp'))
    for name, shape in shapes.items():
        jm = getattr(jmodel, f'make_{name.lower()}')(shape)
        assert sorted(jm.get_weights()) == sorted(
            k for k in written if k.startswith(name))
        jm.set_weights(written)
        x = rs.rand(*shape).astype(np.float32)
        np.testing.assert_allclose(
            models[name].predict(x)[0].numpy(),
            np.asarray(jm.predict(x)[0]), **TOL)

    # the port reads its own file back, and its Adam state
    fresh = {n: getattr(tmodel, f'make_{n.lower()}')(s, device='cpu')
             for n, s in shapes.items()}
    assert load_weights(fresh, path)
    assert fresh['Char'].get_weights() == models['Char'].get_weights()
    models['Monochrome'].train(rs.rand(1, 32, 32, 1),
                               rs.rand(1, 32, 32, 1) > 0.5)
    assert save_optimizer_state(models, path)
    assert load_optimizer_state(fresh, path)
    for n, d in models['Monochrome'].opt_state.items():
        for k, slots in d.items():
            for slot, v in slots.items():
                assert torch.equal(fresh['Monochrome'].opt_state[n][k][slot],
                                   v)


NEW_MODULES = ['ops/pool.py', 'ops/losses.py', 'ops/regularizers.py',
               'nn/__init__.py', 'nn/help_func.py', 'nn/rng.py',
               'nn/progress_tracker.py', 'nn/layers.py', 'nn/losses.py',
               'nn/regularizations.py', 'nn/metrics.py', 'nn/optimizers.py',
               'nn/models.py', 'nn/model_system.py', 'nn/checkpoint.py',
               'models/model.py', 'models/trainer.py', 'models/datasets.py',
               'models/constants.py', 'models/train.py',
               'models/dp_train.py', 'models/evaluation.py',
               'models/predict.py']


@pytest.mark.parametrize('module', NEW_MODULES)
def test_training_modules_import_neither_jax_nor_pil(module):
    """The training modules import no JAX and nothing of the JAX package,
    at any level, and no Pillow when they are imported (the PNG dataset
    imports it where it reads a file)."""
    tree = ast.parse((ROOT / 'univer_ocr_tpu_torch' / module).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split('.')[0])
    assert not roots & {'jax', 'jaxlib', 'univer_ocr_tpu'}
    top = {a.name.split('.')[0] for n in tree.body
           if isinstance(n, ast.Import) for a in n.names}
    top |= {n.module.split('.')[0] for n in tree.body
            if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert 'PIL' not in top
