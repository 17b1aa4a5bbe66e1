"""Pipeline orchestration: ordered components over a shared context dict
(univer_ocr_tpu/nn/model_system.py).

The same class names, selector API and context keys as the JAX package:
'losses' tallied per model in train and test, 'prediction' per model in
predict.  Components implement `run(mode, context)` once.
"""

TRAIN, TEST, PREDICT = 'train', 'test', 'predict'


class BaseComponent:
    """One pipeline stage.  Subclasses implement `run(mode, context)`;
    the three reference entry points delegate to it."""

    def run(self, mode, context):
        raise NotImplementedError()

    def train(self, context):
        return self.run(TRAIN, context)

    def test(self, context):
        return self.run(TEST, context)

    def predict(self, context):
        return self.run(PREDICT, context)


class RawFunctionComponent(BaseComponent):
    """Mode-independent stage: calls `func(context)` (host CV, staging)."""

    def __init__(self, func):
        self.func = func

    def __call__(self, context):
        self.func(context)

    def run(self, mode, context):
        self(context)


class WrappedFunctionComponent(RawFunctionComponent):
    """Label-mapped call: args/kwargs pulled from the context by key,
    result stored under the component's name."""

    def __init__(self, name, func, *args_labels, **kwargs_labels):
        super().__init__(func)
        self.name = name
        self.args_labels, self.kwargs_labels = args_labels, kwargs_labels

    def __call__(self, context):
        context[self.name] = self.func(
            *(context[label] for label in self.args_labels),
            **{key: context[label]
               for key, label in self.kwargs_labels.items()})


class BaseSelector:
    """Binds a context and yields work items for a ModelComponent: where
    the X/y inputs live in the context and where predictions go."""

    def __init__(self, X_label=None, y_label=None, pred_label=None):
        self.X_label, self.y_label, self.pred_label = (
            X_label, y_label, pred_label)
        self.context = None

    def __call__(self, context):   # bind before iterating
        self.context = context

    def get(self):
        raise NotImplementedError()

    def get_X(self):
        raise NotImplementedError()

    def put(self, pred):
        raise NotImplementedError()


class StringSelector(BaseSelector):
    """One (X, y) pulled from the context by key."""

    def get(self):
        yield self.context[self.X_label], self.context[self.y_label]

    def get_X(self):
        yield self.context[self.X_label]

    def put(self, pred):
        self.context[self.pred_label] = pred


class IterableSelector(BaseSelector):
    """Zips parallel X/y lists from the context; predictions append to a
    list under pred_label."""

    def get(self):
        yield from zip(self.context[self.X_label], self.context[self.y_label])

    def get_X(self):
        yield from self.context[self.X_label]

    def put(self, pred):
        self.context.setdefault(self.pred_label, []).append(pred)


class ModelComponent(BaseComponent):
    """Wraps a Model + Selector; tallies per-model losses into
    context['losses'][name]: a component that steps once per crop
    concatenates the crops' output losses and sums their
    regularization losses."""

    def __init__(self, name, model, selector, delist_result=False):
        self.name, self.model, self.selector = name, model, selector
        self.delist_result = delist_result

    def _tally_losses(self, context, losses):
        tally = context['losses'].setdefault(self.name, losses)
        if tally is not losses:
            for key, value in losses.items():
                tally[key] += value

    def _outputs(self):
        outputs = [self.model.layers_outputs[i]
                   for i in range(self.model.outputs_count)]
        return outputs[0] if self.delist_result else outputs

    def run(self, mode, context):
        self.selector(context)
        if mode == PREDICT:
            for X in self.selector.get_X():
                context['prediction'][self.name] = self.model.predict(X)
                self.selector.put(self._outputs())
            return
        step = self.model.train if mode == TRAIN else self.model.test
        for X, y in self.selector.get():
            self._tally_losses(context, step(X, y))
            self.selector.put(self._outputs())


class ModelSystem:
    """Runs components in order over a shared context."""

    #: context key initialized per mode before the component sweep
    _CONTEXT_INIT = {TRAIN: 'losses', TEST: 'losses', PREDICT: 'prediction'}

    def __init__(self, components):
        assert isinstance(components, list)
        assert all(isinstance(c, BaseComponent) for c in components)
        self.components = components

    def run(self, mode, context):
        context[self._CONTEXT_INIT[mode]] = {}
        for component in self.components:
            getattr(component, mode)(context)

    def train(self, context):
        self.run(TRAIN, context)

    def test(self, context):
        self.run(TEST, context)

    def predict(self, context):
        self.run(PREDICT, context)
