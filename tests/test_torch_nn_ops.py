"""The port's training ops, layers, losses and optimizers
(univer_ocr_tpu_torch.ops, .nn) against the JAX package's on the same
numpy-seeded float32 inputs, forward and gradient.  Bars: 1e-5 for ops
and layers (the bar of the JAX package's identity tests), 1e-6 for
optimizer updates."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from univer_ocr_tpu import nn as jnn
from univer_ocr_tpu import ops as jops
from univer_ocr_tpu.nn import optimizers as joptim
from univer_ocr_tpu.ops import precision as jprecision
from univer_ocr_tpu_torch import nn as _port_nn  # noqa: F401
from univer_ocr_tpu_torch import ops as tops
from univer_ocr_tpu_torch.nn import layers as tlayers
from univer_ocr_tpu_torch.nn import losses as tlosses
from univer_ocr_tpu_torch.nn import optimizers as toptim
from univer_ocr_tpu_torch.nn import regularizations as tregs
from univer_ocr_tpu_torch.ops import precision as tprecision

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, exp, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    exp = np.asarray(exp)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    np.testing.assert_allclose(got, exp, **tol)


def _both_grads(t_fn, j_fn, arrays):
    """Value and gradient w.r.t. every array of sum(fn(*arrays) * R), R a
    fixed random cotangent, in both frameworks."""
    rs = np.random.RandomState(99)
    t_in = [torch.tensor(a, requires_grad=True) for a in arrays]
    t_out = t_fn(*t_in)
    cot = rs.randn(*t_out.shape).astype(np.float32)
    (t_out * torch.from_numpy(cot)).sum().backward()
    j_out, vjp = jax.vjp(j_fn, *[jnp.asarray(a) for a in arrays])
    j_grads = vjp(jnp.asarray(cot))
    # an input the output does not depend on has no torch gradient and
    # a zero JAX one
    t_grads = [torch.zeros_like(t) if t.grad is None else t.grad
               for t in t_in]
    return (t_out, t_grads), (j_out, j_grads)


def _check_grads(t_fn, j_fn, arrays):
    (t_out, t_grads), (j_out, j_grads) = _both_grads(t_fn, j_fn, arrays)
    _close(t_out, j_out)
    for tg, jg in zip(t_grads, j_grads):
        _close(tg, jg)


# -- C3: conv2d's bias and preferred_dtype, the module default ----------

@pytest.mark.parametrize('kwargs', [
    dict(bias=False),
    dict(bias=True, preferred_dtype='float32'),
    dict(bias=False, stride=(2, 2), padding=(2, 2)),
], ids=['no_bias', 'preferred_f32', 'no_bias_s2'])
def test_conv2d_bias_and_preferred_dtype(kwargs):
    rs = np.random.RandomState(1)
    x = rs.rand(2, 12, 10, 3).astype(np.float32)
    w = (rs.randn(5, 5, 3, 4) / 8).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    pref = kwargs.pop('preferred_dtype', None)
    tk = dict(kwargs, preferred_dtype=None if pref is None else torch.float32)
    jk = dict(kwargs, preferred_dtype=None if pref is None else jnp.float32)
    _check_grads(lambda x, w, b: tops.conv2d(x, w, b, **tk),
                 lambda x, w, b: jops.conv2d(x, w, b, **jk), [x, w, b])


def test_set_default_precision_matches_jax():
    """The module default is 'highest', `resolve(None)` follows
    set_default_precision, and an op run with no policy then computes in
    the default's mode, as JAX's does."""
    assert tprecision.resolve() == jprecision.resolve() == 'highest'
    rs = np.random.RandomState(2)
    x = rs.rand(2, 9, 11, 4).astype(np.float32)
    w = (rs.randn(3, 3, 4, 5) / 6).astype(np.float32)
    b = rs.randn(5).astype(np.float32)
    try:
        tprecision.set_default_precision('bf16')
        jprecision.set_default_precision('bf16')
        assert tprecision.resolve() == 'bf16'
        got = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), padding=(1, 1))
        exp = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          padding=(1, 1))
        bf16 = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), padding=(1, 1),
                           precision='bf16')
        with pytest.raises(ValueError):
            tprecision.set_default_precision('fp16')
    finally:
        tprecision.set_default_precision('highest')
        jprecision.set_default_precision('highest')
    assert tprecision.resolve() == 'highest'
    _close(got, exp)
    assert torch.equal(got, bf16)


# -- max pooling, losses, regularizers ------------------------------------

@pytest.mark.parametrize('window', [
    dict(kernel_size=(2, 2), padding=(0, 0), stride=None, ceil_mode=False),
    dict(kernel_size=(3, 3), padding=(1, 1), stride=(2, 2), ceil_mode=True),
], ids=['k2', 'k3_p1_s2_ceil'])
def test_max_pool2d_splits_tied_gradients_as_jax(window):
    """Integer-valued inputs make many windows hold tied maxima (and, with
    padding, ties with the zero padding); the gradient splits equally
    among them, as JAX's custom VJP does."""
    rs = np.random.RandomState(3)
    x = rs.randint(-2, 3, size=(2, 7, 9, 3)).astype(np.float32)
    args = (window['kernel_size'], window['padding'], window['stride'],
            window['ceil_mode'])
    (t_out, (t_grad,)), (j_out, (j_grad,)) = _both_grads(
        lambda x: tops.max_pool2d(x, *args),
        lambda x: jops.max_pool2d(x, *args), [x])
    _close(t_out, j_out)
    _close(t_grad, j_grad)
    grad = t_grad.numpy()
    assert np.any((grad != 0) & (np.abs(grad) < np.abs(grad).max() / 2)), \
        'no tie was split'
    assert t_out.shape == tops.pool_output_shape(x.shape, *args[:2],
                                                 args[2] or args[0],
                                                 args[3])


@pytest.mark.parametrize('name', ['SegmentationDice2D',
                                  'SegmentationJaccard2D',
                                  'SigmoidCrossEntropy',
                                  'SoftmaxCrossEntropy'])
def test_loss_value_and_grad_match_jax(name):
    rs = np.random.RandomState(4)
    if name.startswith('Segmentation'):
        pred = rs.rand(2, 6, 7, 3).astype(np.float32)
        gt = (rs.rand(2, 6, 7, 3) > 0.5).astype(np.float32)
    elif name == 'SigmoidCrossEntropy':
        pred = rs.randn(5, 4).astype(np.float32)
        gt = (rs.rand(5, 4) > 0.5).astype(np.float32)
    else:
        pred = (3 * rs.randn(6, 162)).astype(np.float32)
        gt = np.eye(162, dtype=np.float32)[rs.randint(0, 162, 6)]
        gt[2] = 0                      # an unlabeled row, as padded lines
    t_loss, t_grad = getattr(tlosses, name)()(torch.from_numpy(pred),
                                              torch.from_numpy(gt))
    j_loss, j_grad = getattr(jnn, name)()(pred, gt)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    _close(t_grad, j_grad)


@pytest.mark.parametrize('name', ['L1', 'L2'])
def test_regularizer_value_and_grad_match_jax(name):
    w = np.random.RandomState(5).randn(5, 5, 4, 4).astype(np.float32)
    t_loss, t_grad = getattr(tregs, name)(0.01)(torch.from_numpy(w))
    j_loss, j_grad = getattr(jnn, name)(0.01)(w)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    _close(t_grad, j_grad)


# -- every layer of the zoo, forward and gradient -------------------------

LAYERS = {
    'concat': (lambda m: m.Concat(axis=-1), [(2, 5, 6, 3), (2, 5, 6, 2)]),
    'flatten': (lambda m: m.Flatten(), [(3, 4, 5, 2)]),
    'fully_connected': (lambda m: m.FullyConnected(n_output=7), [(3, 10)]),
    'conv_k3_p1': (lambda m: m.Convolutional2D((3, 3), out_channels=4,
                                               padding=1), [(2, 9, 11, 3)]),
    'conv_k53_s21_nobias': (
        lambda m: m.Convolutional2D((5, 3), out_channels=6, padding=(0, 1),
                                    stride=(2, 1), bias=False),
        [(2, 12, 10, 2)]),
    'conv_padding_value': (
        lambda m: m.Convolutional2D((3, 3), out_channels=2, padding=(1, 2),
                                    padding_value=0.5), [(1, 7, 8, 2)]),
    'unfold_width8': (lambda m: m.Conv2DToBatchedFixedWidthed(8),
                      [(2, 1, 10, 4)]),
    'max_pool': (lambda m: m.MaxPool2D(2), [(2, 8, 10, 3)]),
    'max_pool_ceil': (lambda m: m.MaxPool2D(3, padding=1, stride=2,
                                            ceil_mode=True), [(1, 9, 8, 2)]),
    'upsample': (lambda m: m.Upsample2D((2, 3)), [(2, 4, 5, 3)]),
    'relu': (lambda m: m.Relu(), [(2, 4, 5, 3)]),
    'sigmoid': (lambda m: m.Sigmoid(), [(2, 4, 5, 3)]),
    'leaky_relu': (lambda m: m.LeakyRelu(0.01), [(2, 4, 5, 3)]),
    'noop': (lambda m: m.Noop(), [(2, 4, 5, 3)]),
}


@pytest.mark.parametrize('name', sorted(LAYERS))
def test_layer_matches_jax(name):
    """Output shapes, the receptive-field preimage, the forward and the
    gradient w.r.t. the inputs and every parameter; the port's layer
    takes the JAX layer's drawn parameters."""
    make, shapes = LAYERS[name]
    jlayer, tlayer = make(jnn), make(tlayers)
    tlayer.device = 'cpu'
    jlayer.initialize(shapes)
    tlayer.initialize(shapes)
    assert tlayer.get_output_shapes(shapes) == jlayer.get_output_shapes(
        shapes)
    assert set(tlayer.params) == set(jlayer.params)
    params = {k: np.asarray(v, np.float32) for k, v in jlayer.params.items()}
    for k, v in params.items():
        assert tuple(tlayer.params[k].shape) == v.shape
    rs = np.random.RandomState(sorted(LAYERS).index(name))
    xs = [rs.randn(*s).astype(np.float32) for s in shapes]
    if name.startswith('max_pool'):
        xs = [np.round(x) for x in xs]     # tied maxima
    keys = sorted(params)

    def t_fn(*arrays):
        p = dict(zip(keys, arrays[:len(keys)]))
        return tlayer.apply(p, list(arrays[len(keys):]))[0]

    def j_fn(*arrays):
        p = dict(zip(keys, arrays[:len(keys)]))
        return jlayer.apply(p, list(arrays[len(keys):]))[0]

    _check_grads(t_fn, j_fn, [params[k] for k in keys] + xs)
    if jlayer.changes_receptive_field() and jlayer.FULLY_CONV and len(
            shapes) == 1:
        positions = np.array([0, 1, 3])
        for axis in (0, 1):
            t_pre, j_pre = (tlayer.rf_preimage(axis, positions),
                            jlayer.rf_preimage(axis, positions))
            assert (t_pre is None) == (j_pre is None)
            if t_pre is not None:
                np.testing.assert_array_equal(t_pre[0], j_pre[0])


def test_layer_weights_round_trip_and_nan_skip(capsys):
    """get_weights gives the checkpoint's nested lists; set_weights takes
    them back, skipping an entry with a NaN or the wrong shape."""
    layer = tlayers.Convolutional2D((3, 3), in_channels=2, out_channels=3,
                                    device='cpu')
    weights = layer.get_weights()
    assert np.asarray(weights['w']).shape == (3, 3, 2, 3)
    bad = {'w': np.full((3, 3, 2, 3), np.nan).tolist(), 'b': [1.0, 2.0]}
    layer.set_weights(bad)
    assert 'NaN found' in capsys.readouterr().out
    np.testing.assert_array_equal(layer.get_weights()['w'], weights['w'])
    layer.set_weights({'b': [1.0, 2.0, 3.0]})
    assert layer.get_weights()['b'] == [1.0, 2.0, 3.0]
    assert not layer.nan_weights() and layer.count_parameters() == 57


# -- optimizers -------------------------------------------------------------

OPTIMIZERS = {
    'adam': lambda m: m.Adam(lr=1e-3),
    'adagrad': lambda m: m.Adagrad(lr=1e-2),
    'momentum': lambda m: m.Momentum(lr=1e-2, momentum=0.9),
    'rmsprop': lambda m: m.RMSProp(lr=1e-2, rho=0.99),
}


@pytest.mark.parametrize('steps', [1, 3])
@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_optimizer_updates_match_jax(name, steps):
    """One and three updates of a fixed tree, with fresh gradients each
    step (some of them tiny, where Adam's update is sign-like): params
    and state within 1e-6."""
    rs = np.random.RandomState(6)
    shapes = {'a': {'w': (4, 5), 'b': (5,)}, 'c': {'w': (3, 3)}}
    params = {n: {k: rs.randn(*s).astype(np.float32) for k, s in d.items()}
              for n, d in shapes.items()}
    t_opt, j_opt = OPTIMIZERS[name](toptim), OPTIMIZERS[name](joptim)
    t_params = toptim.tree_map(torch.from_numpy, params)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    t_state = t_opt.init_state(t_params)
    j_state = j_opt.init_state(j_params)
    for _ in range(steps):
        grads = {n: {k: (rs.randn(*s) * 10.0 ** rs.randint(-6, 1, s))
                     .astype(np.float32) for k, s in d.items()}
                 for n, d in shapes.items()}
        with torch.no_grad():
            t_params, t_state = t_opt.update(
                t_params, toptim.tree_map(torch.from_numpy, grads), t_state,
                t_opt.lr)
        j_params, j_state = j_opt.update(
            j_params, jax.tree_util.tree_map(jnp.asarray, grads), j_state,
            jnp.float32(j_opt.lr))
    tol = dict(rtol=1e-6, atol=1e-6)
    for n, d in shapes.items():
        for k in d:
            _close(t_params[n][k], j_params[n][k], tol)
            for slot, value in t_state[n][k].items():
                assert value.dtype == torch.float32
                _close(value, j_state[n][k][slot], tol)
