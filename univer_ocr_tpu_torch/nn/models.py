"""DAG model container (univer_ocr_tpu/nn/models.py).

The reference's `Model(layers, relations, loss)` schema, with nested
models flattened into `parent/child` leaf names, which are the
model_weights.json checkpoint namespace.  The DAG is walked by a function
`forward_fn(params, inputs)`; a train step is autograd over the trainable
parameters of `loss_fn` (outputs' losses + regularization), which sums
gradients at fan-outs as JAX's `value_and_grad` does, then the
optimizer's update under `torch.no_grad()`.  Eager PyTorch compiles
nothing, so there is no per-shape step cache.
"""

import numpy as np
import torch

from ..device import resolve_device
from .help_func import make_list_if_not
from .layers import BaseLayer
from .losses import SoftmaxCrossEntropy
from .progress_tracker import track_method
from .rng import make_generator


def value_and_grad(loss_fn, params, names, *args):
    """(total, aux, grads) of `loss_fn(params, *args) -> (total, aux)`,
    with grads `{name: {param: tensor}}` for the layers in `names` (the
    others are held constant) and aux detached."""
    leaves = {n: {k: v.detach().requires_grad_(True)
                  for k, v in params[n].items()} for n in names}
    with torch.enable_grad():
        total, aux = loss_fn({**params, **leaves}, *args)
    flat = [t for n in names for t in leaves[n].values()]
    grads = iter(torch.autograd.grad(total, flat))
    grads = {n: {k: next(grads) for k in leaves[n]} for n in names}
    return total.detach(), _detach(aux), grads


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detach(t) for t in tree)
    return tree


class BaseModel(BaseLayer):
    def compute_loss_and_gradients(self, X, y):
        raise NotImplementedError()

    def train(self, X, y):
        raise NotImplementedError()

    def test(self, X, y):
        raise NotImplementedError()

    def predict(self, X):
        raise NotImplementedError()


class Model(BaseModel):
    """DAG of named layers with integer-keyed model inputs/outputs.

    `relations` maps destination -> source(s); integer destinations are
    model outputs, integer sources are model inputs.  Nested Models are
    flattened into leaf layers named `parent/child`.  Leaves without a
    generator or a device take the model's when it initializes them.
    """

    def __init__(self, layers, relations, loss=SoftmaxCrossEntropy(),
                 *args, **kwargs):
        super().__init__(*args, **kwargs)

        if not isinstance(layers, dict):
            raise TypeError(
                f'layers argument must be dict, found: {type(layers).__name__}')
        if not isinstance(relations, dict):
            raise TypeError(
                f'relations argument must be dict, found: {type(relations).__name__}')

        self.ravelled_layers = layers
        self.ravelled_relations = relations
        self.layers = None
        self.relations = None
        self._topo = None
        # model inputs may appear as bare int values or inside source lists
        input_ids = [
            src
            for v in relations.values()
            for src in (v if isinstance(v, (list, tuple)) else [v])
            if isinstance(src, int)
        ]
        self.inputs_count = max(input_ids) + 1
        self.outputs_count = max(
            k for k, v in relations.items() if isinstance(k, int)) + 1
        self.layers_outputs = {}
        self.loss = loss
        self.input_grads = {}
        self.gradients = {}
        self.is_initialized = False

        self.opt_state = None

        self.unravel_model()

    # ------------------------------------------------------------------
    # Graph flattening: every (namespace, source) entry resolves lazily to
    # the flat leaf names that produce it, inlining each submodel once.
    # ------------------------------------------------------------------
    def unravel_model(self):
        flat_layers = {}
        flat_relations = {}

        def inline(model, prefix, resolve_input):
            """Register `model`'s leaf layers/relations under `prefix`.
            `resolve_input(i)` gives the flat sources feeding the model's
            input slot i.  Returns {out_id: [flat sources]}."""
            rels = {dst: make_list_if_not(srcs)
                    for dst, srcs in model.ravelled_relations.items()}
            inlined = {}

            def submodel(name):
                if name not in inlined:
                    feeds = rels.get(name, [])
                    inlined[name] = inline(
                        model.ravelled_layers[name], f'{prefix}{name}/',
                        lambda i, feeds=feeds: resolve(feeds[i]))
                return inlined[name]

            def resolve(src):
                # int: model input slot; (name, out_id, ...): selected
                # submodel outputs; str: a leaf layer (one flat source)
                # or a submodel (all its outputs, in output order).
                if isinstance(src, int):
                    return list(resolve_input(src))
                if isinstance(src, tuple) and len(src) > 1:
                    outs = submodel(src[0])
                    return [s for out_id in src[1:] for s in outs[out_id]]
                if isinstance(model.ravelled_layers.get(src), Model):
                    sub = model.ravelled_layers[src]
                    outs = submodel(src)
                    return [s for out_id in range(sub.get_outputs_count())
                            for s in outs[out_id]]
                return [f'{prefix}{src}']

            for name, layer in model.ravelled_layers.items():
                if not isinstance(layer, Model):
                    flat_layers[f'{prefix}{name}'] = layer

            outputs = {}
            for dst, srcs in rels.items():
                if (not isinstance(dst, int)
                        and isinstance(model.ravelled_layers.get(dst),
                                       Model)):
                    submodel(dst)       # inlined on demand by consumers
                    continue
                flat_srcs = [s for src in srcs for s in resolve(src)]
                if isinstance(dst, int):
                    outputs[dst] = flat_srcs
                else:
                    flat_relations[f'{prefix}{dst}'] = flat_srcs
            return outputs

        outputs = inline(self, '', lambda i: [i])
        for out_id, srcs in outputs.items():
            flat_relations[out_id] = srcs

        self.layers = flat_layers
        self.relations = flat_relations
        self._topo = None
        for layer_name, layer in self.layers.items():
            layer._set_name(layer_name)

    def get_leaf_layers(self):
        if self.layers is None:
            self.unravel_model()
        return self.layers

    def __getitem__(self, key):
        return self.layers[key]

    # ------------------------------------------------------------------
    # Graph order + shape inference
    # ------------------------------------------------------------------
    def _topo_order(self):
        """Producers-first ordering of the nodes reachable from the model
        outputs (leaf layer names + int output ids).  Raises
        RecursionError on cycles."""
        if self._topo is not None:
            return self._topo

        order = []
        OPEN, DONE = 1, 2
        state = {}
        sinks = sorted(k for k in self.relations if isinstance(k, int))
        stack = [(n, False) for n in reversed(sinks)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                state[node] = DONE
                order.append(node)
                continue
            if state.get(node) == DONE:
                continue
            if state.get(node) == OPEN:
                raise RecursionError(
                    f'Looped on {node} layer, check relations')
            state[node] = OPEN
            stack.append((node, True))
            for src in self.relations[node]:
                if isinstance(src, int):
                    continue
                if state.get(src) == OPEN:
                    raise RecursionError(
                        f'Looped on {src} layer, check relations')
                if state.get(src) != DONE:
                    stack.append((src, False))

        self._topo = order
        return order

    def initialize(self, input_shapes):
        """Shape inference + lazy parameter init: one pass over the
        topological order, drawing parameters from the model's generator
        in that order."""
        input_shapes = make_list_if_not(input_shapes)
        self.input_shapes = input_shapes
        if self.generator is None:
            self.generator = make_generator()

        shapes = {}
        for node in self._topo_order():
            node_input_shapes = [
                input_shapes[src] if isinstance(src, int) else shapes[src]
                for src in self.relations[node]]
            if isinstance(node, int):
                continue
            layer = self.layers[node]
            if not layer.is_initialized:
                if layer.generator is None:
                    layer.generator = self.generator
                if layer.device is None:
                    layer.device = self.device
                layer.initialize(node_input_shapes)
            out = layer.get_output_shapes(node_input_shapes)
            shapes[node] = out[0] if isinstance(out, list) else out

        never_visited = [name for name in self.layers if name not in shapes]
        if never_visited:
            print(f'These layers have never been visited: {never_visited}')

        self.is_initialized = True

    # ------------------------------------------------------------------
    # Params dict assembly
    # ------------------------------------------------------------------
    @property
    def params(self):
        """{leaf_name: {param_name: tensor}} for leaves that have params."""
        return {name: layer.params
                for name, layer in self.layers.items() if layer.params}

    @params.setter
    def params(self, new_params):
        if not new_params:
            return
        for name, layer_params in new_params.items():
            self.layers[name].params = dict(layer_params)

    def _trainable_layer_names(self):
        if not self.trainable:
            return set()
        return {name for name, layer in self.layers.items()
                if layer.params and layer.trainable}

    # ------------------------------------------------------------------
    # Forward over the DAG
    # ------------------------------------------------------------------
    def forward_fn(self, params, inputs, apply_layer=None):
        """(params dict, list of input tensors) -> list of outputs.
        `apply_layer(name, layer, layer_params, inputs)`, when given,
        runs each leaf layer in place of `layer.apply` (the tensor-parallel
        step's column-sharded dense layers; parallel/data_parallel.py)."""
        outputs = {}

        def rec_forward(layer_name):
            if layer_name in outputs:
                return outputs[layer_name]

            next_inputs = []
            for src in self.relations[layer_name]:
                if isinstance(src, int):
                    next_inputs.append(inputs[src])
                else:
                    next_inputs.append(rec_forward(src))

            if isinstance(layer_name, int):
                outputs[layer_name] = next_inputs[0]
                return outputs[layer_name]

            layer = self.layers[layer_name]
            if apply_layer is None:
                result = layer.apply(params.get(layer_name, {}), next_inputs)
            else:
                result = apply_layer(layer_name, layer,
                                     params.get(layer_name, {}), next_inputs)
            if isinstance(result, list):
                result = result[0]
            outputs[layer_name] = result
            return result

        return [rec_forward(k) for k in range(self.outputs_count)]

    def _loss_for_output(self, key):
        loss = self.loss[key] if isinstance(self.loss, list) else self.loss
        return type(loss).fn if not callable(getattr(loss, 'fn', None)) else loss.fn

    def loss_fn(self, params, X_list, y_list):
        """Total loss (outputs + regularization) with aux details."""
        preds = self.forward_fn(params, X_list)
        out_losses = []
        for key in range(self.outputs_count):
            fn = self._loss_for_output(key)
            out_losses.append(fn(preds[key], y_list[key]))
        reg_loss = self.regularization_fn(params)
        total = sum(out_losses) + reg_loss
        return total, (out_losses, reg_loss, preds)

    def regularization_fn(self, params):
        total = 0.0
        for name, layer in self.layers.items():
            if layer.regularizer is not None and name in params:
                total = total + layer.regularization(params[name])
        return total

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def _optimizer(self):
        opt = self.optimizer
        if opt is None:
            for layer in self.layers.values():
                if getattr(layer, 'optimizer', None) is not None:
                    opt = layer.optimizer
                    break
        return opt

    def _ensure_opt_state(self, trainable_params):
        opt = self._optimizer()
        if opt is None:
            return None
        if self.opt_state is None:
            self.opt_state = opt.init_state(trainable_params)
        return self.opt_state

    def _compute_dtype(self):
        """dtype the model computes in = dtype of its first parameter."""
        for layer in self.layers.values():
            for v in layer.params.values():
                return v.dtype
        return None

    def _compute_device(self):
        for layer in self.layers.values():
            for v in layer.params.values():
                return v.device
        return resolve_device(self.device)

    def _cast(self, arrays):
        """Inputs as tensors on the model's device, floating ones in its
        compute dtype (converted on the host before the copy)."""
        dtype = self._compute_dtype()
        device = self._compute_device()
        out = []
        for a in arrays:
            a = torch.as_tensor(a)
            if dtype is not None and a.is_floating_point():
                a = a.to(dtype)
            out.append(a.to(device))
        return out

    def _prepare(self, X, y):
        X = make_list_if_not(X)
        if not self.is_initialized:
            self.initialize_from_X(X)
        return self._cast(X), self._cast(make_list_if_not(y))

    def _keep_outputs(self, preds):
        self.layers_outputs = {k: preds[k] for k in range(self.outputs_count)}

    def compute_loss_and_gradients(self, X, y):
        """Loss and gradients without an optimizer update: the gradients
        w.r.t. the model inputs go to `input_grads` (the gradient-check
        harness reads them), those w.r.t. the trainable parameters to
        `gradients`."""
        X, y = self._prepare(X, y)
        names = sorted(self._trainable_layer_names())
        inputs = {'X': {i: x for i, x in enumerate(X)}}

        def loss(params, y):
            X_list = [params['X'][i] for i in range(len(X))]
            return self.loss_fn(params, X_list, y)

        _, (out_losses, reg_loss, preds), grads = value_and_grad(
            loss, {**self.params, **inputs}, names + ['X'], y)
        self.input_grads = {k: [grads['X'][k]]
                            for k in range(self.inputs_count)}
        self.gradients = {n: grads[n] for n in names}
        self._keep_outputs(preds)
        return {'output_losses': [float(l) for l in out_losses],
                'regularization_loss': float(reg_loss)}

    @track_method('forward')
    def forward(self, inputs):
        inputs = make_list_if_not(inputs)
        if not self.is_initialized:
            self.initialize_from_X(inputs)
        with torch.no_grad():
            preds = self.forward_fn(self.params, self._cast(inputs))
        self._keep_outputs(preds)
        return [preds[k] for k in range(self.outputs_count)]

    def train(self, X, y):
        """One optimizer step; returns the reference's losses dict."""
        X, y = self._prepare(X, y)
        params = self.params
        names = sorted(self._trainable_layer_names())
        if not names:
            # nothing to update: loss computation only
            return self.test(X, y)
        opt = self._optimizer()
        opt_state = self._ensure_opt_state({n: params[n] for n in names})

        # dashboard timing: 'forward' is the step's launch, 'backward'
        # the loss reads that wait for the card
        tracker = self.progress_tracker
        tracker.start_tracking(self.name, 'forward')
        _, (out_losses, reg_loss, preds), grads = value_and_grad(
            self.loss_fn, params, names, X, y)
        with torch.no_grad():
            new_t, self.opt_state = opt.update(
                {n: params[n] for n in names}, grads, opt_state, opt.lr)
        tracker.stop_tracking(self.name, 'forward')
        tracker.start_tracking(self.name, 'backward')
        out_losses = [float(l) for l in out_losses]
        tracker.stop_tracking(self.name, 'backward')
        self.params = new_t
        self._keep_outputs(preds)
        return {'output_losses': out_losses,
                'regularization_loss': float(reg_loss)}

    def test(self, X, y):
        X, y = self._prepare(X, y)
        tracker = self.progress_tracker
        tracker.start_tracking(self.name, 'forward')
        with torch.no_grad():
            _, (out_losses, _, preds) = self.loss_fn(self.params, X, y)
        out_losses = [float(l) for l in out_losses]
        tracker.stop_tracking(self.name, 'forward')
        self._keep_outputs(preds)
        return {'output_losses': out_losses}

    def predict(self, X):
        return self.forward(X)

    # ------------------------------------------------------------------
    # Shape queries
    # ------------------------------------------------------------------
    def get_all_output_shapes(self, input_shapes):
        """([model output shapes], {leaf name: [its output shapes]}) with
        plain-int tuples, via one pass over the topological order."""
        input_shapes = make_list_if_not(input_shapes)
        first_shape = {}    # node -> first output shape, for consumers
        all_shapes = {}
        model_outputs = {}
        for node in self._topo_order():
            node_inputs = [
                input_shapes[src] if isinstance(src, int) else first_shape[src]
                for src in self.relations[node]]
            if isinstance(node, int):
                model_outputs[node] = tuple(int(x) for x in node_inputs[0])
                continue
            outs = make_list_if_not(
                self.layers[node].get_output_shapes(node_inputs))
            outs = [tuple(int(x) for x in s) for s in outs]
            all_shapes[node] = outs
            first_shape[node] = outs[0]
        return ([model_outputs[k] for k in range(self.outputs_count)],
                all_shapes)

    def get_output_shapes(self, input_shapes):
        return self.get_all_output_shapes(input_shapes)[0]

    def get_outputs_count(self):
        return self.outputs_count

    def is_fully_convolutional(self):
        return all(layer.is_fully_convolutional()
                   for layer in self.layers.values())

    def changes_receptive_field(self):
        return any(layer.changes_receptive_field()
                   for layer in self.layers.values())

    # ------------------------------------------------------------------
    # Receptive fields
    # ------------------------------------------------------------------
    def get_receptive_fields(self):
        """Receptive field of every RF-changing leaf's output position 0
        w.r.t. the model inputs, along both spatial axes: per input, the
        position count, y/x min-max, and whether the covered set is a
        solid interval.  Each target gets one reverse-topological sweep
        in which coverage sets travel as sorted position arrays through
        the layers' `rf_preimage` maps."""
        assert self.is_initialized, (
            'The model must be initialized before calling this method')
        assert self.is_fully_convolutional(), (
            'This method is only available for Fully Convolutional Networks (FCN)')

        order = self._topo_order()
        result = {}
        for target in order:
            if isinstance(target, int):
                continue
            if not self.layers[target].changes_receptive_field():
                continue
            cover_y = self._input_coverage(target, 0, order)
            cover_x = self._input_coverage(target, 1, order)
            report = {}
            for in_id in range(self.inputs_count):
                pos_y, pos_x = cover_y.get(in_id), cover_x.get(in_id)
                if pos_y is None or pos_x is None:
                    continue
                cnt_y, min_y, max_y = len(pos_y), int(pos_y[0]), int(pos_y[-1])
                cnt_x, min_x, max_x = len(pos_x), int(pos_x[0]), int(pos_x[-1])
                report[f'input {in_id}'] = {
                    'cnt': (cnt_y, cnt_x),
                    'y': (min_y, max_y),
                    'x': (min_x, max_x),
                    'is_solid_y': (cnt_y == max_y - min_y + 1),
                    'is_solid_x': (cnt_x == max_x - min_x + 1),
                }
            result[target] = report
        return result

    def _input_coverage(self, target, axis, order):
        """{input_id: sorted position array} influencing `target`'s output
        position 0 along `axis`."""
        cover = {target: np.zeros(1, dtype=np.int64)}
        input_cover = {}
        for node in reversed(order[:order.index(target) + 1]):
            positions = cover.pop(node, None)
            if positions is None:
                continue
            pre = (None if isinstance(node, int)
                   else self.layers[node].rf_preimage(axis, positions))
            for slot, src in enumerate(self.relations[node]):
                src_positions = positions if pre is None else pre[slot]
                bucket = input_cover if isinstance(src, int) else cover
                prev = bucket.get(src)
                bucket[src] = (src_positions if prev is None
                               else np.union1d(prev, src_positions))
        return input_cover

    # ------------------------------------------------------------------
    # Weights / params bookkeeping (model_weights.json schema)
    # ------------------------------------------------------------------
    def get_weights(self):
        all_weights = {name: layer.get_weights()
                       for name, layer in self.layers.items()}
        return {name: weights for name, weights in all_weights.items()
                if weights != {}}

    def set_weights(self, weights):
        for name, layer in self.layers.items():
            layer_weights = weights.get(name, None)
            if layer_weights is None:
                continue
            layer.set_weights(layer_weights)

    def nan_weights(self):
        return any(layer.nan_weights() for layer in self.layers.values())

    def count_parameters(self):
        return sum(layer.count_parameters() for layer in self.layers.values())

    def regularize(self):
        with torch.no_grad():
            return float(self.regularization_fn(self.params))

    def init_progress_tracker(self, progress_tracker, model_name='model'):
        if self.name is None:
            self.name = model_name
        self.progress_tracker = progress_tracker
        self.progress_tracker.register_layer(self.name)
        for layer in self.layers.values():
            layer.init_progress_tracker(progress_tracker, None)


class Sequential(Model):
    """Layer list -> named chain."""

    def __init__(self, layers, *args, **kwargs):
        if not isinstance(layers, list):
            raise TypeError(
                f'layers argument must be list, found: {type(layers).__name__}')

        layers_dict = {}
        relations = {}
        prev_name = 0
        for i, layer in enumerate(layers):
            name = f'{i}_{type(layer).__name__}'
            layers_dict[name] = layer
            relations[name] = prev_name
            prev_name = name
        relations[0] = prev_name

        super().__init__(layers=layers_dict, relations=relations,
                         *args, **kwargs)
