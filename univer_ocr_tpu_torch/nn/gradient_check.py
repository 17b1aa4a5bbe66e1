"""Numerical gradient checks (univer_ocr_tpu/nn/gradient_check.py).

`check_gradient` compares an analytic gradient with the two-point
numerical one, (f(x + d) - f(x - d)) / 2d, at every element, with the JAX
package's delta and tolerance.  The layer and model helpers probe input
gradients through a layer, parameter gradients, and every parameter and
input gradient of a whole model; autograd gives the analytic side.

Run them in float64 (layers built with `dtype=torch.float64`): delta=1e-5
is below float32's resolution.  Every probe runs on `device` (None: the
layer's or model's own device, the card when that is None too); a layer
or model without a device of its own takes it before it draws its
parameters.
"""

import numpy as np
import torch

from ..device import resolve_device


def check_gradient(f, x, delta=1e-5, tol=1e-4):
    """f: array -> (scalar loss, analytic grad).  True iff the numeric
    gradient matches the analytic one at every element."""
    x = np.asarray(x, dtype=np.float64)
    _, analytic_grad = f(x)
    analytic_grad = np.asarray(analytic_grad)
    assert analytic_grad.shape == x.shape, (
        f'Gradient shape {analytic_grad.shape} != input shape {x.shape}')

    it = np.nditer(x, flags=['multi_index'])
    while not it.finished:
        ix = it.multi_index
        x_plus = x.copy()
        x_plus[ix] += delta
        x_minus = x.copy()
        x_minus[ix] -= delta
        numeric = (float(f(x_plus)[0]) - float(f(x_minus)[0])) / (2 * delta)
        analytic = analytic_grad[ix]
        if not np.isclose(numeric, analytic, tol):
            print(f'Gradients are different at {ix}. '
                  f'Analytic: {analytic}, Numeric: {numeric}')
            return False
        it.iternext()
    return True


def _probe(loss_fn, device):
    """A scalar function of a tensor -> check_gradient's (loss, grad)
    contract on float64 arrays, the gradient by autograd."""
    def f(x):
        xt = torch.tensor(x, dtype=torch.float64, device=device,
                          requires_grad=True)
        with torch.enable_grad():
            loss = loss_fn(xt)
        (grad,) = torch.autograd.grad(loss, xt, allow_unused=True)
        if grad is None:
            grad = torch.zeros_like(xt)
        return float(loss.detach()), grad.cpu().numpy()

    return f


def _adopt_device(obj, device):
    """The probes' device; a layer or model without one takes it."""
    device = resolve_device(obj.device if device is None else device)
    if obj.device is None:
        obj.device = device
    return device


def _tensor(x, device):
    return torch.tensor(np.asarray(x, dtype=np.float64), device=device)


def _scalar_loss_through_layer(layer, params, inputs):
    """Sum-of-outputs scalar loss, used to probe layer gradients."""
    return sum(o.sum() for o in layer.apply(params, inputs))


def check_layer_gradient(layer, X, delta=1e-5, tol=1e-4, device=None):
    """Input-gradient check for a single layer."""
    X = np.asarray(X, dtype=np.float64)
    device = _adopt_device(layer, device)
    if not layer.is_initialized:
        layer.initialize_from_X([X])
    params = layer.params
    f = _probe(lambda xi: _scalar_loss_through_layer(layer, params, [xi]),
               device)
    return check_gradient(f, X, delta, tol)


def check_layer_param_gradient(layer, X, param_name, delta=1e-5, tol=1e-4,
                               device=None):
    """Parameter-gradient check for a single layer."""
    device = _adopt_device(layer, device)
    X = _tensor(X, device)
    if not layer.is_initialized:
        layer.initialize_from_X([X])
    params = dict(layer.params)
    w0 = params[param_name].detach().cpu().numpy().astype(np.float64)

    def loss_fn(wi):
        p = dict(params)
        p[param_name] = wi
        return _scalar_loss_through_layer(layer, p, [X])

    return check_gradient(_probe(loss_fn, device), w0, delta, tol)


def check_model_gradient(model, X, y, delta=1e-5, tol=1e-4,
                         check_inputs=True, device=None):
    """Whole-model check: every parameter tensor and (optionally) every
    model input."""
    device = _adopt_device(model, device)
    X_list = [_tensor(x, device) for x in (X if isinstance(X, list) else [X])]
    y_list = [_tensor(t, device) for t in (y if isinstance(y, list) else [y])]
    if not model.is_initialized:
        model.initialize([tuple(x.shape) for x in X_list])
    params = model.params

    for layer_name in params:
        for param_name in params[layer_name]:
            w0 = params[layer_name][param_name].detach().cpu().numpy()

            def loss_fn(wi, _ln=layer_name, _pn=param_name):
                p = {ln: dict(lp) for ln, lp in params.items()}
                p[_ln][_pn] = wi
                total, _ = model.loss_fn(p, X_list, y_list)
                return total

            if not check_gradient(_probe(loss_fn, device),
                                  w0.astype(np.float64), delta, tol):
                print(f'Check failed for {layer_name}/{param_name}')
                return False

    if check_inputs:
        for in_id, x0 in enumerate(X_list):
            def loss_fn(xi, _i=in_id):
                xs = list(X_list)
                xs[_i] = xi
                total, _ = model.loss_fn(params, xs, y_list)
                return total

            if not check_gradient(_probe(loss_fn, device),
                                  x0.cpu().numpy(), delta, tol):
                print(f'Check failed for model input {in_id}')
                return False

    return True
