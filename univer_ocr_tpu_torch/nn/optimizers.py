"""Optimizers as functions over params dicts (univer_ocr_tpu/nn/
optimizers.py), written out rather than taken from `torch.optim`, whose
Adam corrects the moments' bias and places eps elsewhere.

The update math is the JAX package's, operation for operation:
  * Adam *without* bias correction:
    `param - lr / (sqrt(acc) + EPS) * vel`;
  * Adagrad with `self.lr` (the reference's fix);
  * state per parameter tensor, in its dtype, in a tree of dicts that
    mirrors the params dict (`{layer: {param: {'velocity', ...}}}`).

`self.lr` is a host attribute (the Trainer decays it between epochs);
each update takes it as a float32 scalar, as JAX's step does, and
divides by it exactly (`lr / x`, not `x.reciprocal() * lr`).
"""

import torch

EPS = 1e-8


def tree_map(fn, tree, *rest):
    """fn over the tensor leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


class BaseOptimizer:
    def __init__(self, lr):
        self.lr = lr

    def init_leaf_state(self, param):
        """Zero state tensors for one parameter tensor."""
        raise NotImplementedError()

    def leaf_update(self, param, grad, state, lr):
        """(param, grad, state, lr scalar tensor) -> (new_param, new_state)."""
        raise NotImplementedError()

    def init_state(self, params):
        return tree_map(self.init_leaf_state, params)

    def update(self, params, grads, state, lr):
        """New (params, state) trees; `lr` a Python float.  Call it under
        `torch.no_grad()`."""
        lr = torch.tensor(lr, dtype=torch.float32)   # a CPU scalar operand
        new_params, new_state = {}, {}
        for name, layer in params.items():
            new_params[name], new_state[name] = {}, {}
            for key, param in layer.items():
                new_params[name][key], new_state[name][key] = (
                    self.leaf_update(param, grads[name][key],
                                     state[name][key], lr))
        return new_params, new_state


class Adagrad(BaseOptimizer):
    def __init__(self, lr=0.01, initial_accumulated=0):
        super().__init__(lr)
        self.initial_accumulated = initial_accumulated

    def init_leaf_state(self, param):
        return {'accumulated': torch.full_like(param,
                                               self.initial_accumulated)}

    def leaf_update(self, param, grad, state, lr):
        acc = state['accumulated'] + grad ** 2
        new_param = param - lr / (torch.sqrt(acc) + EPS) * grad
        return new_param, {'accumulated': acc}


class Adam(BaseOptimizer):
    """The reference's Adam: no bias correction."""

    def __init__(self, lr=0.001, beta1=0.9, beta2=0.999,
                 initial_velocity=0, initial_accumulated=0):
        super().__init__(lr)
        self.beta1 = beta1
        self.beta2 = beta2
        self.initial_velocity = initial_velocity
        self.initial_accumulated = initial_accumulated

    def init_leaf_state(self, param):
        return {'velocity': torch.full_like(param, self.initial_velocity),
                'accumulated': torch.full_like(param,
                                               self.initial_accumulated)}

    def leaf_update(self, param, grad, state, lr):
        vel = self.beta1 * state['velocity'] + (1 - self.beta1) * grad
        acc = (self.beta2 * state['accumulated']
               + (1 - self.beta2) * grad ** 2)
        new_param = param - lr / (torch.sqrt(acc) + EPS) * vel
        return new_param, {'velocity': vel, 'accumulated': acc}


class Momentum(BaseOptimizer):
    def __init__(self, lr, momentum=0, initial_velocity=0):
        super().__init__(lr)
        self.momentum = momentum
        self.initial_velocity = initial_velocity

    def init_leaf_state(self, param):
        return {'velocity': torch.full_like(param, self.initial_velocity)}

    def leaf_update(self, param, grad, state, lr):
        vel = self.momentum * state['velocity'] - lr * grad
        return param + vel, {'velocity': vel}


class RMSProp(BaseOptimizer):
    def __init__(self, lr=0.01, rho=0.99, initial_accumulated=0):
        super().__init__(lr)
        self.rho = rho
        self.initial_accumulated = initial_accumulated

    def init_leaf_state(self, param):
        return {'accumulated': torch.full_like(param,
                                               self.initial_accumulated)}

    def leaf_update(self, param, grad, state, lr):
        acc = self.rho * state['accumulated'] + (1 - self.rho) * grad ** 2
        new_param = param - lr / (torch.sqrt(acc) + EPS) * grad
        return new_param, {'accumulated': acc}
