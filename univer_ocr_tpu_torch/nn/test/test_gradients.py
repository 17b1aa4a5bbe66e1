"""Gradient-check battery (univer_ocr_tpu/nn/test/test_gradients.py):
numeric against autograd gradients of the layer zoo, the losses through
small models and a regularized two-input DAG, in float64.

    python -m univer_ocr_tpu_torch.test_nn test_gradients [use_gpu]

prints a line per check with its wall time, then the pass counter.
`use_gpu` true (the default) runs every probe on the card (float64
there too), false on the CPU.
"""

from datetime import datetime as dt

import numpy as np
import torch

from ...device import resolve_device
from ..gradient_check import (check_layer_gradient,
                              check_layer_param_gradient,
                              check_model_gradient)
from ..layers import (Concat, Conv2DToBatchedFixedWidthed, Convolutional2D,
                      Flatten, FullyConnected, LeakyRelu, MaxPool2D, Noop,
                      Relu, Sigmoid, Upsample2D)
from ..losses import (SegmentationDice2D, SegmentationJaccard2D,
                      SigmoidCrossEntropy, SoftmaxCrossEntropy)
from ..models import Model, Sequential
from ..regularizations import L1, L2

passed = 0
failed = 0


def time_it(name, func):
    global passed, failed
    ts = dt.now()
    ok = func()
    elapsed = dt.now() - ts
    status = 'OK' if ok else 'FAIL'
    print(f'  [{status}] {name} ({elapsed})', flush=True)
    if ok:
        passed += 1
    else:
        failed += 1


def main(use_gpu=True):
    global passed, failed
    passed = failed = 0
    device = resolve_device('cuda' if use_gpu else 'cpu')

    def f64(layer_cls, *args, **kwargs):
        return layer_cls(*args, dtype=torch.float64, device=device, **kwargs)

    def layer_ok(layer, X):
        return check_layer_gradient(layer, X, device=device)

    rs = np.random.RandomState(0)
    X4 = rs.randn(2, 8, 9, 3)
    X2 = rs.randn(3, 5)

    print('Layer input gradients:')
    time_it('FullyConnected', lambda: layer_ok(
        f64(FullyConnected, n_input=5, n_output=4), X2))
    time_it('Flatten', lambda: layer_ok(Flatten(), X4))
    time_it('Relu', lambda: layer_ok(Relu(), X4 + 0.5))
    time_it('LeakyRelu', lambda: layer_ok(LeakyRelu(0.01), X4 + 0.5))
    time_it('Sigmoid', lambda: layer_ok(Sigmoid(), X4))
    time_it('Noop', lambda: layer_ok(Noop(), X4))
    time_it('Upsample2D', lambda: layer_ok(Upsample2D(2), X4))
    time_it('Unfold', lambda: layer_ok(Conv2DToBatchedFixedWidthed(4), X4))

    print('Conv2D configurations:')
    for cfg in [dict(kernel_size=(3, 3), padding=1),
                dict(kernel_size=(3, 3), padding=0),
                dict(kernel_size=(5, 3), padding=(0, 1), stride=(2, 1)),
                dict(kernel_size=(5, 5), padding=2, stride=2),
                dict(kernel_size=(2, 2), padding=(2, 1), padding_value=0.5)]:
        layer = f64(Convolutional2D, out_channels=2, **cfg)
        time_it(f'Conv2D {cfg} dX', lambda l=layer: layer_ok(l, X4))
        for param in ('w', 'b'):
            layer = f64(Convolutional2D, out_channels=2, **cfg)
            time_it(f'Conv2D {cfg} d{param}', lambda l=layer, p=param:
                    check_layer_param_gradient(l, X4, p, device=device))

    print('MaxPool2D configurations:')
    for cfg in [dict(kernel_size=2),
                dict(kernel_size=(3, 3), stride=(2, 2)),
                dict(kernel_size=2, padding=1),
                dict(kernel_size=(3, 2), padding=(0, 1), stride=(2, 2),
                     ceil_mode=True)]:
        time_it(f'MaxPool2D {cfg}', lambda c=cfg: layer_ok(
            MaxPool2D(**c), X4))

    print('Losses through models (incl. input gradients):')
    rs2 = np.random.RandomState(1)
    Xs = rs2.rand(1, 6, 6, 1)
    ys = (rs2.rand(1, 6, 6, 2) > 0.5).astype(np.float64)
    for loss in [SegmentationDice2D(), SegmentationJaccard2D(),
                 SigmoidCrossEntropy()]:
        model = Sequential([
            f64(Convolutional2D, (3, 3), out_channels=2, padding=1),
            Sigmoid(),
        ], loss=loss, device=device)
        time_it(f'FCN + {type(loss).__name__}',
                lambda m=model: check_model_gradient(m, Xs, ys))

    model = Sequential([
        Flatten(),
        f64(FullyConnected, n_output=8),
        LeakyRelu(0.01),
        f64(FullyConnected, n_output=4),
    ], loss=SoftmaxCrossEntropy(), device=device)
    Xd = rs2.randn(3, 2, 2, 1)
    yd = np.eye(4)[rs2.randint(0, 4, 3)]
    time_it('Dense + SoftmaxCE', lambda: check_model_gradient(model, Xd, yd))

    print('Regularized + multi-IO DAG:')
    dag = Model(
        layers={
            'conv_a': f64(Convolutional2D, (3, 3), out_channels=2, padding=1,
                          regularizer=L2(0.01)),
            'conv_b': f64(Convolutional2D, (3, 3), out_channels=2, padding=1,
                          regularizer=L1(0.02)),
            'concat': Concat(),
            'head_1': f64(Convolutional2D, (1, 1), out_channels=1),
            'head_2': f64(Convolutional2D, (1, 1), out_channels=1),
            'sig_1': Sigmoid(),
            'sig_2': Sigmoid(),
        },
        relations={
            'conv_a': 0, 'conv_b': 1, 'concat': ['conv_a', 'conv_b'],
            'head_1': 'concat', 'head_2': 'concat',
            'sig_1': 'head_1', 'sig_2': 'head_2', 0: 'sig_1', 1: 'sig_2',
        },
        loss=[SegmentationDice2D(), SegmentationJaccard2D()], device=device)
    Xm = [rs2.rand(1, 5, 5, 1), rs2.rand(1, 5, 5, 1)]
    ym = [(rs2.rand(1, 5, 5, 1) > 0.5).astype(np.float64),
          (rs2.rand(1, 5, 5, 1) > 0.5).astype(np.float64)]
    time_it('Multi-IO DAG', lambda: check_model_gradient(dag, Xm, ym))

    print(f'\nPassed: {passed}, Failed: {failed}')
    return failed == 0


if __name__ == '__main__':
    main()
