"""Card-against-CPU parity battery (univer_ocr_tpu/nn/test/test_identity.py):
each layer's forward and input gradient (of the sum of its outputs) on
the CPU and on the card, with the same float32 weights and inputs, must
agree within 1e-5 (rtol and atol), at the JAX package's shape
(5, 120, 160, 6): Conv2D x5, MaxPool2D x4, Upsample2D.

    python -m univer_ocr_tpu_torch.test_nn test_identity [use_gpu]

`use_gpu` true (the default) compares the card with the CPU, under
`backend_flags('highest')` (cuDNN's default TF32 keeps about three
digits and would miss 1e-5 by orders of magnitude); it raises without a
card, where the JAX package falls back to comparing the CPU with itself.
`use_gpu` false compares the CPU with the CPU, which is trivial.
"""

from datetime import datetime as dt

import numpy as np
import torch

from ...device import resolve_device
from ...ops.precision import backend_flags
from ..layers import Convolutional2D, MaxPool2D, Upsample2D

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


def run_on(device, layer, params, X):
    """Forward and sum-loss input gradient of `layer` on `device`."""
    X_d = torch.tensor(X, dtype=torch.float32, device=device,
                       requires_grad=True)
    params_d = {k: v.to(device=device, dtype=torch.float32)
                for k, v in params.items()}
    with torch.enable_grad():
        outs = layer.apply(params_d, [X_d])
        (dx,) = torch.autograd.grad(sum(o.sum() for o in outs), X_d)
    return outs[0].detach().cpu().numpy(), dx.cpu().numpy()


def check_layer(layer, X, cpu_dev, acc_dev, tol=1e-5):
    layer.initialize_from_X([X])
    params = layer.params
    y_cpu, dx_cpu = run_on(cpu_dev, layer, params, X)
    y_acc, dx_acc = run_on(acc_dev, layer, params, X)
    ok = (y_cpu.shape == y_acc.shape and dx_cpu.shape == dx_acc.shape
          and np.allclose(y_cpu, y_acc, rtol=tol, atol=tol)
          and np.allclose(dx_cpu, dx_acc, rtol=tol, atol=tol))
    if not ok:
        print(f'    max |dy| = {np.abs(y_cpu - y_acc).max():.3e}, '
              f'max |ddx| = {np.abs(dx_cpu - dx_acc).max():.3e}')
    return ok


def main(use_gpu=True):
    global passed, failed
    passed = failed = 0

    cpu_dev = torch.device('cpu')
    if use_gpu:
        acc_dev = resolve_device('cuda')
        print(f'Comparing CPU vs {torch.cuda.get_device_name(acc_dev)}')
    else:
        acc_dev = cpu_dev
        print('No accelerator in use — comparing CPU vs CPU (trivial).')

    rs = np.random.RandomState(0)
    X = rs.randn(5, 120, 160, 6).astype(np.float32)

    with backend_flags('highest'):
        print('Convolutional2D:')
        for cfg in [dict(kernel_size=(3, 3), padding=1),
                    dict(kernel_size=(5, 5), padding=2, stride=2),
                    dict(kernel_size=(5, 3), padding=(0, 1), stride=(2, 1)),
                    dict(kernel_size=(2, 2), padding=(2, 1),
                         padding_value=0.5),
                    dict(kernel_size=(4, 4), padding=0, stride=(3, 3))]:
            time_it(f'Conv2D {cfg}', lambda c=cfg: check_layer(
                Convolutional2D(out_channels=4, device=cpu_dev, **c), X,
                cpu_dev, acc_dev))

        print('MaxPool2D:')
        for cfg in [dict(kernel_size=2),
                    dict(kernel_size=(3, 3), stride=(2, 2)),
                    dict(kernel_size=2, padding=1),
                    dict(kernel_size=(3, 2), padding=(0, 1),
                         ceil_mode=True)]:
            time_it(f'MaxPool2D {cfg}', lambda c=cfg: check_layer(
                MaxPool2D(**c), X, cpu_dev, acc_dev))

        print('Upsample2D:')
        time_it('Upsample2D x2', lambda: check_layer(
            Upsample2D(2), X, cpu_dev, acc_dev))

    print(f'\nPassed: {passed}, Failed: {failed}')
    return failed == 0


if __name__ == '__main__':
    main()
