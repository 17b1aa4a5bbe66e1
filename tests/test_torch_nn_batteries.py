"""The NN core's script batteries and the zoo's leftovers, against the JAX
package on the CPU: the four gradient checks give JAX's verdicts on tiny
float64 layers and models and return False on a deliberately wrong
gradient; both batteries pass on the CPU (test_identity compares the CPU
with itself there, as JAX's does; with use_gpu and no card it raises);
the entry, the batteries and /test-nn ask for the card unless told
'false'; /test-nn answers, /test-nn-ws refuses an unknown name with JAX's message
and streams a battery's pass counter; OneHot round-trips as JAX's does;
make_up and make_edge_detection give JAX's outputs within 1e-5."""

import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univer_ocr_tpu import nn as jnn
from univer_ocr_tpu.models import model as jmodel
from univer_ocr_tpu.nn import encoders as jencoders
from univer_ocr_tpu.nn import gradient_check as jcheck
from univer_ocr_tpu_torch import test_nn
from univer_ocr_tpu_torch.models import model as tmodel
from univer_ocr_tpu_torch.nn import encoders, gradient_check as check
from univer_ocr_tpu_torch.nn import layers as tl
from univer_ocr_tpu_torch.nn import losses as tlosses
from univer_ocr_tpu_torch.nn.models import Model, Sequential
from univer_ocr_tpu_torch.nn.test import test_gradients, test_identity
from univer_ocr_tpu_torch.web import create_app
from univer_ocr_tpu_torch.web.ws_client import FrameReader, WSClient

RS = np.random.RandomState
#: the batteries' tolerance, as in JAX: isclose(numeric, analytic, 1e-4)
#: with the two-point step 1e-5
DELTA, TOL = 1e-5, 1e-4


def _port(cls, *args, **kwargs):
    return cls(*args, dtype=torch.float64, device='cpu', **kwargs)


def _jax(cls, *args, **kwargs):
    return cls(*args, dtype=jnp.float64, **kwargs)


def _dag(make, mod, losses):
    return mod.Model(
        layers={'conv_a': make(mod.Convolutional2D, (3, 3), out_channels=2,
                               padding=1),
                'conv_b': make(mod.Convolutional2D, (3, 3), out_channels=2,
                               padding=1),
                'concat': mod.Concat(),
                'head_1': make(mod.Convolutional2D, (1, 1), out_channels=1),
                'head_2': make(mod.Convolutional2D, (1, 1), out_channels=1),
                'sig_1': mod.Sigmoid(), 'sig_2': mod.Sigmoid()},
        relations={'conv_a': 0, 'conv_b': 1, 'concat': ['conv_a', 'conv_b'],
                   'head_1': 'concat', 'head_2': 'concat', 'sig_1': 'head_1',
                   'sig_2': 'head_2', 0: 'sig_1', 1: 'sig_2'},
        loss=[losses.SegmentationDice2D(), losses.SegmentationJaccard2D()])


class _PortModules:
    """The port's names under the JAX package's `nn` spelling."""
    Model, Sequential = Model, Sequential
    Convolutional2D, Concat, Sigmoid = (tl.Convolutional2D, tl.Concat,
                                        tl.Sigmoid)
    Flatten, FullyConnected, LeakyRelu = (tl.Flatten, tl.FullyConnected,
                                          tl.LeakyRelu)


def _case(name, side):
    """(check function, its arguments) of one case on one side."""
    mod, make, gc, losses = ((_PortModules, _port, check, tlosses)
                             if side == 'port' else
                             (jnn, _jax, jcheck, jnn))
    X4 = RS(0).randn(1, 5, 4, 2)
    if name == 'Conv2D dX':
        return gc.check_layer_gradient, (make(
            mod.Convolutional2D, kernel_size=(3, 3), padding=1,
            out_channels=2), X4)
    if name == 'Conv2D dw':
        return gc.check_layer_param_gradient, (make(
            mod.Convolutional2D, kernel_size=(5, 3), padding=(0, 1),
            stride=(2, 1), out_channels=2), X4, 'w')
    if name == 'MaxPool2D':
        pool = (tl.MaxPool2D if side == 'port' else jnn.MaxPool2D)(
            kernel_size=(3, 2), padding=(0, 1), stride=(2, 2),
            ceil_mode=True)
        return gc.check_layer_gradient, (pool, X4)
    if name == 'Dense + SoftmaxCE':
        model = mod.Sequential([
            mod.Flatten(), make(mod.FullyConnected, n_output=6),
            mod.LeakyRelu(0.01), make(mod.FullyConnected, n_output=3)],
            loss=losses.SoftmaxCrossEntropy())
        return gc.check_model_gradient, (model, RS(1).randn(2, 2, 2, 1),
                                         np.eye(3)[[0, 2]])
    model = _dag(make, mod, losses)
    X = [RS(2).rand(1, 4, 4, 1), RS(3).rand(1, 4, 4, 1)]
    y = [(RS(4).rand(1, 4, 4, 1) > 0.5).astype(np.float64),
         (RS(5).rand(1, 4, 4, 1) > 0.5).astype(np.float64)]
    return gc.check_model_gradient, (model, X, y)


@pytest.mark.parametrize('name', ['Conv2D dX', 'Conv2D dw', 'MaxPool2D',
                                  'Dense + SoftmaxCE', 'two-input DAG'])
def test_checks_give_jax_verdicts(name):
    verdicts = {}
    for side in ('port', 'jax'):
        fn, args = _case(name, side)
        kwargs = {'device': 'cpu'} if side == 'port' else {}
        verdicts[side] = fn(*args, delta=DELTA, tol=TOL, **kwargs)
    assert verdicts == {'port': True, 'jax': True}


class _Skew(torch.autograd.Function):
    """Identity forward, 1.5x the gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return 1.5 * g


class _SkewedNoop(tl.Noop):
    def _apply(self, params, X):
        return _Skew.apply(X)


class _SkewedConv(tl.Convolutional2D):
    def _apply(self, params, X):
        return super()._apply({**params, 'w': _Skew.apply(params['w'])}, X)


@pytest.mark.parametrize('fn', ['check_gradient', 'check_layer_gradient',
                                'check_layer_param_gradient',
                                'check_model_gradient'])
def test_checks_catch_a_wrong_gradient(fn, capsys):
    """Each check passes the true gradient and returns False where it is
    1.5x what it should be; JAX's check_gradient gives the same verdicts
    on the plain function."""
    X = RS(6).randn(1, 4, 4, 1)
    conv = dict(kernel_size=(3, 3), padding=1, out_channels=1,
                dtype=torch.float64, device='cpu')
    if fn == 'check_gradient':
        def f(x, scale):
            return float(np.sum(x ** 2)), scale * 2 * x
        for gc in (check, jcheck):
            assert gc.check_gradient(lambda x: f(x, 1.0), X)
            assert not gc.check_gradient(lambda x: f(x, 1.5), X)
    elif fn == 'check_layer_gradient':
        assert check.check_layer_gradient(tl.Noop(), X, device='cpu')
        assert not check.check_layer_gradient(_SkewedNoop(), X, device='cpu')
    elif fn == 'check_layer_param_gradient':
        assert check.check_layer_param_gradient(
            tl.Convolutional2D(**conv), X, 'w')
        assert not check.check_layer_param_gradient(_SkewedConv(**conv), X,
                                                    'w')
    else:
        y = (RS(7).rand(1, 4, 4, 1) > 0.5).astype(np.float64)
        for layer, verdict in ((tl.Convolutional2D, True),
                               (_SkewedConv, False)):
            model = Sequential([layer(**conv), tl.Sigmoid()],
                               loss=tlosses.SegmentationDice2D())
            assert check.check_model_gradient(model, X, y,
                                              device='cpu') is verdict
    assert 'Gradients are different' in capsys.readouterr().out


@pytest.mark.parametrize('battery, checks', [(test_identity, 10),
                                             (test_gradients, 32)])
def test_batteries_pass_on_the_cpu(battery, checks, capsys):
    """`main(False)`: every check passes (test_identity compares the CPU
    with itself, as JAX's battery does without an accelerator)."""
    assert battery.main(False) is True
    assert f'Passed: {checks}, Failed: 0' in capsys.readouterr().out


def test_identity_with_use_gpu_and_no_card_raises(monkeypatch):
    """Where JAX's battery falls back to the CPU, the port's raises."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA device'):
        test_identity.main(True)


@pytest.mark.parametrize('args, on_card', [
    ((), True), (('true',), True), (('TRUE',), True), ((True,), True),
    (('false',), False), (('False',), False), ((False,), False)])
def test_test_nn_asks_for_the_card_unless_told_false(monkeypatch, args,
                                                     on_card):
    """The entry runs a battery on the card unless `use_gpu` is 'false',
    as the predict / train dispatcher does; both batteries default to it."""
    seen = []
    monkeypatch.setattr(test_identity, 'main',
                        lambda use_gpu: seen.append(use_gpu) or True)
    assert test_nn.main('test_identity', *args) is True
    assert seen == [on_card]


@pytest.mark.parametrize('battery', [test_identity, test_gradients])
def test_batteries_default_to_the_card(monkeypatch, battery):
    """`main()` asks for the card, and without one raises."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA device'):
        battery.main()


@pytest.fixture(scope='module')
def server():
    app = create_app(device='cpu')
    app.start_background(port=0)
    yield app
    app.shutdown()


def test_test_nn_page_and_links(server):
    for path, needle in (('/test-nn', b'/test-nn-ws'),
                         ('/', b'href="/test-nn"')):
        with urllib.request.urlopen(
                f'http://127.0.0.1:{server.port}{path}', timeout=10) as r:
            body = r.read()
            assert r.status == 200 and needle in body and b'<nav>' in body
            if path == '/test-nn':
                # the page asks for the card unless its box is cleared
                assert b'id="use_gpu" checked' in body


def test_test_nn_ws_runs_a_battery(server):
    """An unknown name gets JAX's message; `start` of test_identity on the
    CPU streams the battery's output, its pass counter and its exit."""
    browser = WSClient('127.0.0.1', server.port, '/test-nn-ws')
    reader = FrameReader(browser.sock)
    time.sleep(0.1)
    browser.emit('start', {'test_name': 'nope', 'use_gpu': False})
    assert reader.wait(lambda events: events, 10)
    assert reader.events[0] == {'event': 'message',
                                'data': 'unknown test nope\n'}
    browser.emit('start', {'test_name': 'test_identity', 'use_gpu': False})
    done = reader.wait(lambda events: any(
        'process exited' in str(e.get('data')) for e in events), 120)
    text = ''.join(str(e.get('data')) for e in reader.events)
    browser.close()
    assert done, text
    assert 'Passed: 10, Failed: 0' in text
    assert '[process exited with code 0]' in text


def test_one_hot_round_trips_as_jax():
    labels = RS(8).randint(0, 7, 12)
    port, jax_enc = encoders.OneHot(7), jencoders.OneHot(7)
    encoded = port.encode(labels)
    np.testing.assert_array_equal(encoded, jax_enc.encode(labels))
    assert encoded.dtype == jax_enc.encode(labels).dtype
    np.testing.assert_array_equal(port.decode(encoded), labels)
    np.testing.assert_array_equal(jax_enc.decode(encoded), labels)
    for enc in (port, jax_enc):
        with pytest.raises(AssertionError):
            enc.encode(np.array([7]))


def test_make_up_matches_jax():
    """Upsample, skip concat and conv block, the JAX model's weights set
    into the port's: outputs within 1e-5."""
    def build(zoo, model_cls, **kwargs):
        model = model_cls(layers={'up': zoo.make_up([4], kernel_size=(3, 3),
                                                    padding=1)},
                          relations={'up': [0, 1], 0: 'up'}, **kwargs)
        model.initialize([(1, 8, 8, 2), (1, 4, 4, 3)])
        return model

    skip = RS(0).rand(1, 8, 8, 2).astype(np.float32)
    feats = RS(1).rand(1, 4, 4, 3).astype(np.float32)
    jax_model = build(jmodel, jnn.Model)
    port_model = build(tmodel, Model, device='cpu')
    port_model.set_weights(jax_model.get_weights())
    exp = np.asarray(jax_model.predict([skip, feats])[0])
    got = port_model.predict([skip, feats])[0].numpy()
    assert got.shape == exp.shape == (1, 8, 8, 4)
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)


def test_make_edge_detection_matches_jax():
    X = RS(2).rand(2, 9, 7, 3).astype(np.float32)
    exp = np.asarray(jmodel.make_edge_detection(X.shape)(X))
    got = tmodel.make_edge_detection(X.shape, device='cpu')(X).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)
