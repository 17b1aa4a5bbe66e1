"""Layer zoo: configuration objects over the port's ops
(univer_ocr_tpu/nn/layers.py).

The same class names, constructor signatures, shape rules, receptive-field
arithmetic and weight-dict layout as the JAX package, so that
model_weights.json round-trips between the two.  A layer holds its
configuration and a params dict of tensors; `apply(params, inputs)` is a
function of its arguments, differentiated by autograd (MaxPool2D's
equal split among ties comes from ops/pool.py's autograd.Function).

Parameters are drawn when a layer learns its input channels: from the
layer's `generator` (a model hands its own to the layers that have none,
nn/rng.py) on the CPU, then moved to the layer's `device` (None: the
card, device.py).
"""

import numpy as np
import torch

from .. import ops
from ..device import resolve_device
from ..ops.conv import conv_output_shape, unfold_output_shape
from ..ops.pool import pool_output_shape
from .help_func import make_list_if_not, tuplize
from .progress_tracker import BaseProgressTracker, track_method
from .rng import make_generator


def _window_preimage(positions, kernel, padding, stride):
    """Union of the k-wide strided input windows behind `positions`
    (vectorized set expansion for conv/pool receptive fields)."""
    offsets = np.arange(kernel, dtype=np.int64)
    return np.unique(np.asarray(positions)[:, None] * stride - padding + offsets)


def _validate_incoming(name, arr, expect_shape):
    """Reason an incoming checkpoint entry must be skipped, or None."""
    if np.isnan(arr).any():
        return 'NaN found in loaded weights'
    if arr.shape != expect_shape:
        return f'Shapes don`t match: {arr.shape} != {expect_shape}'
    return None


class Param:
    """Value and grad pair, kept for the reference's API; models keep
    their parameters in params dicts."""

    def __init__(self, value, optimizer=None):
        self.value = torch.as_tensor(value)
        self.grad = torch.zeros_like(self.value)
        self.optimizer = optimizer

    def clear_grad(self):
        self.grad = torch.zeros_like(self.value)


class BaseLayer:
    """Common layer machinery.

    Subclasses implement `_apply(params, X)` (single input) or override
    `apply(params, inputs)` (multi-input).  Shape metadata comes from a
    single-shape `_shape(s)` hook when the layer maps shapes 1:1;
    multi-shape layers override `get_output_shapes` directly.
    """

    #: class-level receptive-field traits (overridden per family)
    CHANGES_RF = False
    FULLY_CONV = True

    def __init__(self,
                 name=None,
                 input_shapes=None,
                 trainable=True,
                 initializer=ops.kaiming_uniform,
                 regularizer=None,
                 optimizer=None,
                 dtype=torch.float32,
                 device=None,
                 generator=None):
        self.name = name
        self.dtype = dtype
        self.device = device
        self.generator = generator
        self.trainable = trainable
        self.initializer = initializer
        self.regularizer = regularizer
        self.optimizer = optimizer
        self.params = {}
        self.progress_tracker = BaseProgressTracker()
        self._adopt_shapes(input_shapes)
        self.is_initialized = True

    def _adopt_shapes(self, input_shapes):
        self.input_shapes = (None if input_shapes is None
                             else make_list_if_not(input_shapes))
        self.inputs_count = (None if input_shapes is None
                             else len(self.input_shapes))

    # -- lifecycle ---------------------------------------------------------
    def initialize_from_X(self, X):
        self.initialize([tuple(x.shape) for x in make_list_if_not(X)])

    def initialize(self, input_shapes):
        self._adopt_shapes(input_shapes)
        self.is_initialized = True

    def init_params(self):
        """Create this layer's parameter dict (empty by default)."""
        return {}

    def _draw(self, rows, cols):
        """One (rows, cols) initializer matrix from the layer's generator,
        on its device."""
        if self.generator is None:
            self.generator = make_generator()
        w = self.initializer(self.generator, rows, cols)
        return w.to(dtype=self.dtype, device=resolve_device(self.device))

    # -- compute -----------------------------------------------------------
    def apply(self, params, inputs):
        """Forward over a list of inputs -> list of outputs; by default
        the layer maps independently over each input."""
        return [self._apply(params, X) for X in inputs]

    def _apply(self, params, X):
        raise NotImplementedError()

    def regularization(self, params):
        """Regularization penalty over this layer's params."""
        if self.regularizer is None or not params:
            return 0.0
        return sum(self.regularizer.fn(p) for p in params.values())

    # -- host convenience --------------------------------------------------
    @track_method('forward')
    def forward(self, inputs):
        assert self.is_initialized, (
            'You must initialize() layer before calling forward() method')
        with torch.no_grad():
            return self.apply(self.params, make_list_if_not(inputs))

    # -- shape/graph metadata ---------------------------------------------
    def get_all_output_shapes(self, input_shapes):
        return self.get_output_shapes(input_shapes), {}

    def get_output_shapes(self, input_shapes):
        return [self._shape(make_list_if_not(input_shapes)[0])]

    def _shape(self, s):
        """Single-input -> single-output shape rule (identity default)."""
        return s

    def get_outputs_count(self):
        return 1

    def is_fully_convolutional(self):
        return self.FULLY_CONV

    def changes_receptive_field(self):
        return self.CHANGES_RF

    def rf_preimage(self, axis, positions):
        """Map output positions (sorted int array, one spatial axis) to the
        source positions that influence them.  Returns {input_slot: array},
        or None meaning the layer is position-identity on every input slot
        (elementwise ops, concat).  Model.get_receptive_fields composes
        these along the DAG."""
        return None

    # -- weights I/O (model_weights.json schema) ---------------------------
    def get_weights(self):
        return {name: value.detach().cpu().numpy().tolist()
                for name, value in self.params.items()}

    def set_weights(self, weights):
        """Merge checkpoint entries into params, skip-warning on NaN or
        shape mismatch (the reference's resilient-load contract)."""
        for name, current in list(self.params.items()):
            if weights.get(name) is None:
                continue
            incoming = np.array(weights[name])
            problem = _validate_incoming(name, incoming,
                                         tuple(current.shape))
            if problem is not None:
                print(f'{self.name}/{name}: {problem}, skipping')
                continue
            self.params[name] = torch.as_tensor(
                incoming, dtype=current.dtype).to(current.device)

    def nan_weights(self):
        return any(bool(torch.isnan(v).any()) for v in self.params.values())

    def count_parameters(self, param=None):
        sizes = {k: v.numel() for k, v in self.params.items()}
        return sizes[param] if param is not None else sum(sizes.values())

    # -- misc --------------------------------------------------------------
    def _set_name(self, name):
        self.name = name

    def init_progress_tracker(self, progress_tracker, set_names_recursively=False):
        self.progress_tracker = progress_tracker
        self.progress_tracker.register_layer(self.name)


class Concat(BaseLayer):
    """Concatenate all inputs along `axis`."""

    def __init__(self, axis=-1, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.axis = axis
        self.is_initialized = self.inputs_count is not None

    CHANGES_RF = True
    # rf_preimage: default (identity on every input slot) is correct

    def apply(self, params, inputs):
        if not isinstance(inputs, list):
            return inputs
        return [torch.cat(inputs, dim=self.axis)]

    def get_output_shapes(self, input_shapes):
        shapes = np.array(make_list_if_not(input_shapes))
        out = list(shapes[0])
        # batch never sums; the concat axis does
        summed = np.concatenate([[shapes[0][0]], shapes[:, 1:].sum(axis=0)])
        out[self.axis] = summed[self.axis]
        return [tuple(int(x) for x in out)]


class Flatten(BaseLayer):
    """(B, ...) -> (B, prod)."""

    FULLY_CONV = False

    def _apply(self, params, X):
        return torch.reshape(X, (X.shape[0], -1))

    def _shape(self, s):
        return (s[0], int(np.prod(s[1:])))

    def rf_preimage(self, axis, positions):
        raise NotImplementedError('The method is not supported by Flatten Layer')


class _LazyChannels(BaseLayer):
    """Parametric layer whose channel config may come from the first seen
    input shape: `_infer_channels(shape)` fills the missing dims, then
    `init_params` builds the weight dict."""

    def _maybe_initialize(self, lazy_key):
        if self.input_shapes is None and getattr(self, lazy_key) is not None:
            self.input_shapes = [self._placeholder_shape()]
        if self.input_shapes is not None:
            self.initialize(self.input_shapes)
        else:
            self.is_initialized = False

    def initialize(self, input_shapes):
        self._adopt_shapes(input_shapes)
        self._infer_channels(self.input_shapes[0])
        self.params = self.init_params()
        self.is_initialized = True

    def _fixed(self, value):
        return torch.as_tensor(np.asarray(value), dtype=self.dtype).to(
            resolve_device(self.device))


class FullyConnected(_LazyChannels):
    """Dense with the bias folded into the weight matrix as its last
    row."""

    CHANGES_RF = True
    FULLY_CONV = False

    def __init__(self, n_input=None, n_output=None, w=None, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_input = n_input
        self.n_output = n_output
        self._fixed_w = w
        self._maybe_initialize('n_input')

    def _placeholder_shape(self):
        return (None, self.n_input)

    def _infer_channels(self, s):
        self.n_input = s[1]
        if self.n_output is None:
            self.n_output = self.n_input

    def init_params(self):
        if self._fixed_w is not None:
            w = self._fixed(self._fixed_w)
            assert w.shape == (self.n_input + 1, self.n_output)
            return {'w': w}
        return {'w': self._draw(self.n_input + 1, self.n_output)}

    def _apply(self, params, X):
        return ops.dense(X, params['w'])

    def _shape(self, s):
        return (s[0], self.n_output)

    def rf_preimage(self, axis, positions):
        raise NotImplementedError(
            'The method is not supported by Fully Connected Layer')


class _Windowed:
    """Shared strided-window arithmetic for conv/pool: the kernel/padding/
    stride triple, its receptive-field preimage, and the RF trait."""

    CHANGES_RF = True

    def _set_window(self, kernel_size, padding, stride):
        self.kernel_size = tuplize('kernel_size', kernel_size, 2)
        self.padding = tuplize('padding', padding, 2)
        self.stride = (self.kernel_size if stride is None
                       else tuplize('stride', stride, 2))

    def rf_preimage(self, axis, positions):
        return {0: _window_preimage(positions, self.kernel_size[axis],
                                    self.padding[axis], self.stride[axis])}


class Convolutional2D(_Windowed, _LazyChannels):
    """NHWC convolution: HWIO `w` and a `b`, drawn jointly as one
    (prod(kernel) * cin + 1, cout) initializer matrix, as the reference
    draws them."""

    def __init__(self, kernel_size, in_channels=None, out_channels=None,
                 padding=0, padding_value=0, stride=1,
                 w=None, b=None, bias=True, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_window(kernel_size, padding, stride)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.padding_value = padding_value
        self._fixed_w, self._fixed_b, self.bias = w, b, bias
        self._maybe_initialize('in_channels')

    def _placeholder_shape(self):
        return (None, None, None, self.in_channels)

    def _infer_channels(self, s):
        self.in_channels = s[3]
        if self.out_channels is None:
            self.out_channels = self.in_channels

    def init_params(self):
        w_shape = (*self.kernel_size, self.in_channels, self.out_channels)
        if self._fixed_w is not None or self._fixed_b is not None:
            w, b = self._fixed(self._fixed_w), self._fixed(self._fixed_b)
            assert tuple(w.shape) == w_shape, f'{w.shape} != {w_shape}'
            assert tuple(b.shape) == (self.out_channels,), b.shape
            return {'w': w, 'b': b}
        # the reference draws w and b jointly as one fan-in+1 matrix
        wb = self._draw(int(np.prod(w_shape[:3])) + 1, self.out_channels)
        return {'w': wb[:-1, :].reshape(w_shape).contiguous(),
                'b': wb[-1, :].contiguous()}

    def _apply(self, params, X):
        return ops.conv2d(X, params['w'], params['b'],
                          stride=self.stride, padding=self.padding,
                          padding_value=self.padding_value, bias=self.bias)

    def _shape(self, s):
        return conv_output_shape(s, self.kernel_size, self.padding,
                                 self.stride, self.out_channels)


class Conv2DToBatchedFixedWidthed(BaseLayer):
    """Width->batch unfold; see ops.conv.unfold_to_fixed_width."""

    def __init__(self, width, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.width = width

    def _apply(self, params, X):
        return ops.unfold_to_fixed_width(X, self.width)

    def get_output_shapes(self, input_shapes):
        # maps over EVERY input shape (unlike the single-shape default)
        return [unfold_output_shape(s, self.width)
                for s in make_list_if_not(input_shapes)]


class MaxPool2D(_Windowed, BaseLayer):
    """Max pooling with equal-split tie gradients (ops/pool.py)."""

    def __init__(self, kernel_size, padding=0, stride=None, ceil_mode=False,
                 *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_window(kernel_size, padding, stride)
        self.ceil_mode = ceil_mode

    def _apply(self, params, X):
        return ops.max_pool2d(X, self.kernel_size, self.padding, self.stride,
                              self.ceil_mode)

    def _shape(self, s):
        return pool_output_shape(s, self.kernel_size, self.padding,
                                 self.stride, self.ceil_mode)


class Upsample2D(BaseLayer):
    """Nearest-neighbour upsample."""

    CHANGES_RF = True

    def __init__(self, scale_factor, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.scale_factor = tuplize('scale_factor', scale_factor, 2)

    def _apply(self, params, X):
        sy, sx = self.scale_factor
        return X.repeat_interleave(sy, dim=1).repeat_interleave(sx, dim=2)

    def _shape(self, s):
        b, h, w, c = s
        sy, sx = self.scale_factor
        return (b, h * sy, w * sx, c)

    def rf_preimage(self, axis, positions):
        return {0: np.unique(positions // self.scale_factor[axis])}


class Elementwise(BaseLayer):
    """Shape-preserving pointwise layer; `_fn` is the op (class attr)."""

    _fn = staticmethod(lambda X: X)

    def _apply(self, params, X):
        return type(self)._fn(X)

    def get_output_shapes(self, input_shapes):
        # pointwise layers map shape-identically over EVERY input
        return make_list_if_not(input_shapes)


class Noop(Elementwise):
    pass


class Relu(Elementwise):
    _fn = staticmethod(ops.relu)


class Sigmoid(Elementwise):
    _fn = staticmethod(ops.sigmoid)


class LeakyRelu(Elementwise):
    def __init__(self, alpha=0.01, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.alpha = alpha

    def _apply(self, params, X):
        return ops.leaky_relu(X, self.alpha)
