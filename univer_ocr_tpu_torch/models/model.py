"""Model zoo and the cascade's assembly (univer_ocr_tpu/models/model.py).

The same architectures and checkpoint namespace as the JAX package:
  * Monochrome: conv block [16, 1], 3x3, Dice;
  * Paragraph / Line: two stride-2 down conv blocks, two upsample blocks
    and a sigmoid end, 5x5, Dice;
  * Char: conv block [64, 64, 64] k(5,3) p(0,1) s(2,1) -> width->batch
    unfold(8) -> flatten -> dense [1024, 128, 162], softmax CE;
and the same component order Monochrome -> rename -> Paragraph ->
from_device -> ParagraphCrop -> to_device -> Line -> from_device ->
LineCrop -> CharLabel -> to_device -> Char, with a subset per training
mode, and all of it, then PredToText, in the per-page PREDICT mode.  The
Line and Char stages train one crop, then one line, at a time (the
reference's trajectory) through the masked steps of fastpath.py on
bucket-padded shapes; in PREDICT mode they batch the page's crops and
lines by shape bucket through the masked forwards, in the JAX package's
batch shapes.

Tensors live on one explicit device: the staging components copy host
arrays there as float32 (the JAX package's default type) and pull
predictions back as numpy.
"""

import os
from enum import Enum
from functools import partial

import numpy as np
import torch

from ..device import resolve_device
from ..interpreter import (CropAndRotateParagraphs, CropRotateAndZoomLines,
                           LabelChar, PredToText)
from ..nn.help_func import make_list_if_not
from ..nn.layers import (Concat, Conv2DToBatchedFixedWidthed,
                         Convolutional2D, Flatten, FullyConnected, LeakyRelu,
                         Sigmoid, Upsample2D)
from ..nn.losses import SegmentationDice2D, SoftmaxCrossEntropy
from ..nn.metrics import multiclass_accuracy
from ..nn.model_system import (IterableSelector, ModelComponent, ModelSystem,
                               RawFunctionComponent, StringSelector)
from ..nn.models import Model
from ..nn.optimizers import Adam
from ..nn.progress_tracker import track_function
from ..nn.regularizations import L2
from ..nn.rng import make_generator
from ..primitives import CHARS
from .bucketing import (CHAR_FIXED_WIDTH, CHAR_INPUT_HEIGHT,
                        make_divisible_by, round_up)
from .constants import LAYER_NAMES
from .fastpath import (char_forward_masked, line_forward_masked,
                       make_masked_eval_step, make_masked_train_step,
                       masked_char_loss, masked_line_loss)

#: crop-shape bucket of the masked Line and Char train steps
TRAIN_BUCKET = 128
#: PREDICT mode: the bucket of paragraph crops' heights and widths and of
#: line crops' widths (multiples of 16, as the FCN's strides need)
PARAGRAPH_BUCKET = 64
LINE_WIDTH_BUCKET = 64


def make_conv(out_ch, kernel_size=(5, 5), padding=2, **kwargs):
    return Convolutional2D(kernel_size, out_channels=out_ch, padding=padding,
                           regularizer=L2(0.01), **kwargs)


def make_conv_block(out_chs, last_sigmoid=False, **kwargs):
    """Chain of conv + LeakyReLU(0.01), optional trailing Sigmoid; the
    names conv_i / leaky_relu_i / sigmoid are checkpoint keys."""
    out_chs = make_list_if_not(out_chs)
    layers = {}
    relations = {}
    prev = 0
    for i in range(1, len(out_chs) + 1):
        conv_name, conv = f'conv_{i}', make_conv(out_chs[i - 1], **kwargs)
        layers[conv_name] = conv
        if i == len(out_chs) and last_sigmoid is True:
            activation_name, activation = 'sigmoid', Sigmoid()
        else:
            activation_name, activation = f'leaky_relu_{i}', LeakyRelu(0.01)
        layers[activation_name] = activation
        relations[conv_name] = prev
        relations[activation_name] = conv_name
        prev = activation_name
    relations[0] = prev
    return Model(layers, relations)


def make_up(out_chs, **kwargs):
    """Upsample input 1, concatenate input 0 (the skip) after it, conv
    block; in the zoo, though the cascade uses none."""
    return Model(layers={
        'upsample': Upsample2D(2),
        'concat': Concat(),
        'conv_block': make_conv_block(out_chs, **kwargs),
    }, relations={
        'upsample': 1,
        'concat': ['upsample', 0],
        'conv_block': 'concat',
        0: 'conv_block',
    })


def make_single_up(out_chs, **kwargs):
    return Model(layers={
        'upsample': Upsample2D(2),
        'conv_block': make_conv_block(out_chs, **kwargs),
    }, relations={
        'upsample': 0,
        'conv_block': 'upsample',
        0: 'conv_block',
    })


def wrap(name, model, **kwargs):
    return Model(layers={name: model}, relations={name: 0, 0: name}, **kwargs)


def make_edge_detection(input_shape, device=None):
    """A fixed 3x3 sharpen convolution per channel, not trainable: returns
    X (B, H, W, C) -> the sharpened tensor on `device` (None: the card)."""
    batch_size, height, width, in_channels = input_shape
    w = np.zeros((3, 3, in_channels, in_channels))
    kernel = np.array([
        [0, -1, 0],
        [-1, 5, -1],
        [0, -1, 0],
    ])
    for c in range(in_channels):
        w[:, :, c, c] = kernel
    b = np.zeros((in_channels,))
    conv = Convolutional2D(
        (3, 3), in_channels=in_channels, out_channels=in_channels,
        padding=1, w=w, b=b, trainable=False, device=device)

    def func(X):
        X = torch.as_tensor(np.asarray(X), dtype=conv.dtype,
                            device=resolve_device(device))
        return conv.forward([X])[0]

    return func


def make_monochrome(input_shape, optimizer=None, generator=None, device=None):
    optimizer = Adam(lr=1e-2) if optimizer is None else optimizer
    kwargs = {'optimizer': optimizer, 'trainable': True}

    ch_count = [16, len(LAYER_NAMES['monochrome'])]

    model = Model(
        layers={
            'Monochrome': make_conv_block(
                ch_count, last_sigmoid=True,
                kernel_size=(3, 3), padding=1, **kwargs),
        },
        relations={'Monochrome': 0, 0: 'Monochrome'},
        loss=SegmentationDice2D(), generator=generator, device=device)
    model.initialize(input_shape)
    return model


def _make_updown_fcn(name, width, out_ch, input_shape, optimizer, generator,
                     device):
    """The Paragraph/Line encoder-decoder: downs [w], [w] stride 2 k5 p2,
    single-ups [w], [w], sigmoid end [out]."""
    kwargs = {'optimizer': optimizer, 'trainable': True}
    ch_count_downs = [None, [width], [width]]
    ch_count_ups = [None, [width], [width]]
    ch_count_end = [out_ch]

    layers = {
        **{
            f'down_{i}': make_conv_block(
                ch_count_downs[i],
                kernel_size=(5, 5), padding=2, stride=2, **kwargs)
            for i in range(1, len(ch_count_downs))
        },
        **{
            f'up_{i}': make_single_up(
                ch_count_ups[i],
                kernel_size=(5, 5), padding=2, **kwargs)
            for i in range(1, len(ch_count_ups))
        },
        'end': make_conv_block(
            ch_count_end, last_sigmoid=True,
            kernel_size=(5, 5), padding=2, **kwargs),
    }
    relations = {
        'down_1': 0,
        **{
            f'down_{i + 1}': f'down_{i}'
            for i in range(1, len(ch_count_downs) - 1)
        },
        f'up_{len(ch_count_ups) - 1}': f'down_{len(ch_count_downs) - 1}',
        **{
            f'up_{i}': f'up_{i + 1}'
            for i in range(1, len(ch_count_ups) - 1)
        },
        'end': 'up_1',
        0: 'end',
    }

    model = wrap(name, Model(layers=layers, relations=relations),
                 loss=SegmentationDice2D(), generator=generator,
                 device=device)
    model.initialize(input_shape)
    return model


def make_paragraph(input_shape, optimizer=None, generator=None, device=None):
    optimizer = Adam(lr=1e-2) if optimizer is None else optimizer
    return _make_updown_fcn('Paragraph', 1, len(LAYER_NAMES['paragraph']),
                            input_shape, optimizer, generator, device)


def make_line(input_shape, optimizer=None, generator=None, device=None):
    optimizer = Adam(lr=1e-2) if optimizer is None else optimizer
    return _make_updown_fcn('Line', 4, len(LAYER_NAMES['line']),
                            input_shape, optimizer, generator, device)


def make_dense_block(out_counts, **kwargs):
    out_counts = make_list_if_not(out_counts)
    layers = {}
    relations = {}
    prev = 0
    for i in range(1, len(out_counts) + 1):
        dense_name = f'dense_{i}'
        layers[dense_name] = FullyConnected(n_output=out_counts[i - 1],
                                            **kwargs)
        relations[dense_name] = prev
        if i < len(out_counts):
            activation_name = f'leaky_relu_{i}'
            layers[activation_name] = LeakyRelu(0.01)
            relations[activation_name] = dense_name
            prev = activation_name
        else:
            prev = dense_name
    relations[0] = prev
    return Model(layers, relations)


def make_char(input_shape, optimizer=None, generator=None, device=None):
    optimizer = Adam(lr=1e-2) if optimizer is None else optimizer
    kwargs = {'optimizer': optimizer, 'trainable': True}

    batch_size, _, width, in_channels = input_shape
    ch_counts = [64, 64, 64]
    n_counts = [1024, 128, len(CHARS)]

    layers = {
        'conv_block': make_conv_block(
            ch_counts, kernel_size=(5, 3), padding=(0, 1), stride=(2, 1),
            **kwargs),
        'fixed_width': Conv2DToBatchedFixedWidthed(CHAR_FIXED_WIDTH),
        'flatten': Flatten(),
        'dense_block': make_dense_block(n_counts, **kwargs),
    }
    relations = {
        'conv_block': 0,
        'fixed_width': 'conv_block',
        'flatten': 'fixed_width',
        'dense_block': 'flatten',
        0: 'dense_block',
    }

    input_shape = (batch_size, CHAR_INPUT_HEIGHT, width, in_channels)
    model = wrap('Char', Model(layers=layers, relations=relations),
                 loss=SoftmaxCrossEntropy(), generator=generator,
                 device=device)
    model.initialize(input_shape)
    return model


# ---------------------------------------------------------------------------
# Host <-> device staging components
# ---------------------------------------------------------------------------

def to_host(var):
    """Tensors (in nested lists and dicts) -> numpy arrays."""
    if isinstance(var, list):
        return [to_host(v) for v in var]
    if isinstance(var, dict):
        return {k: to_host(v) for k, v in var.items()}
    if isinstance(var, torch.Tensor):
        return var.detach().cpu().numpy()
    return np.asarray(var)


def to_device(var, device):
    """Arrays (in nested lists and dicts) -> tensors on `device`, floating
    ones as float32."""
    if isinstance(var, list):
        return [to_device(v, device) for v in var]
    if isinstance(var, dict):
        return {k: to_device(v, device) for k, v in var.items()}
    if isinstance(var, torch.Tensor):
        return var.to(device)
    arr = np.asarray(var)
    if np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr).to(device)


def make_move_from_device_component(labels):
    def func(context):
        for old_label, new_label in labels:
            context[new_label] = to_host(context[old_label])

    return RawFunctionComponent(func)


def make_move_to_device_component(labels, device):
    def func(context):
        for old_label, new_label in labels:
            context[new_label] = to_device(context[old_label], device)

    return RawFunctionComponent(func)


def get_from_context(context, labels):
    return [context[label] for label in labels]


def put_to_context(context, labels, values):
    for label, value in zip(labels, values):
        context[label] = value


def make_rename_in_context_component(labels):
    def rename_in_context(context):
        for old_label, new_label in labels:
            context[new_label] = context[old_label]
    return RawFunctionComponent(rename_in_context)


# ---------------------------------------------------------------------------
# Nested-list selectors
# ---------------------------------------------------------------------------

class LineSelector(IterableSelector):
    """Iterates per-paragraph crops: context[X_label][paragraph_id]."""

    def __init__(self, X_label, y_label, pred_label):
        super().__init__(X_label, y_label, pred_label)
        self.paragraph_id = 0

    def __call__(self, context):
        super().__call__(context)
        self.paragraph_id = 0
        # zero-paragraph pages flow on as empty lists
        context.setdefault(self.pred_label, [])

    def get(self):
        for i in range(len(self.context[self.X_label])):
            self.paragraph_id = i
            yield (self.context[self.X_label][i],
                   self.context[self.y_label][i])

    def get_X(self):
        for i in range(len(self.context[self.X_label])):
            self.paragraph_id = i
            yield self.context[self.X_label][i]

    def put(self, pred):
        if self.pred_label not in self.context.keys():
            self.context[self.pred_label] = []
        if self.paragraph_id >= len(self.context[self.pred_label]):
            self.context[self.pred_label].append([])
        self.context[self.pred_label][self.paragraph_id] = pred


class CharSelector(IterableSelector):
    """Iterates per-paragraph-per-line crops."""

    def __init__(self, X_label, y_label, pred_label):
        super().__init__(X_label, y_label, pred_label)
        self.paragraph_id = 0
        self.line_id = 0

    def __call__(self, context):
        super().__call__(context)
        self.paragraph_id = 0
        self.line_id = 0
        context.setdefault(self.pred_label, [])

    def get(self):
        for i in range(len(self.context[self.X_label])):
            self.paragraph_id = i
            for j in range(len(self.context[self.X_label][i])):
                self.line_id = j
                yield (self.context[self.X_label][i][j],
                       self.context[self.y_label][i][j])

    def get_X(self):
        for i in range(len(self.context[self.X_label])):
            self.paragraph_id = i
            for j in range(len(self.context[self.X_label][i])):
                self.line_id = j
                yield self.context[self.X_label][i][j]

    def put(self, pred):
        if self.pred_label not in self.context.keys():
            self.context[self.pred_label] = []
        if self.paragraph_id >= len(self.context[self.pred_label]):
            self.context[self.pred_label].append([])
        if self.line_id >= len(self.context[self.pred_label][self.paragraph_id]):
            self.context[self.pred_label][self.paragraph_id].append([])
        self.context[self.pred_label][self.paragraph_id][self.line_id] = pred


class _MaskedTrainComponent(ModelComponent):
    """Per-crop sequential optimizer steps (the reference's training
    order, so that trajectories match) through a masked step on the crop
    padded to a TRAIN_BUCKET multiple: the loss and gradients of the
    unpadded crop (fastpath.py).  Subclasses pad (`_pad`), trim the
    prediction (`_trim`) and bind the loss (`loss_fn`)."""

    def __init__(self, name, model, selector, loss_fn, delist_result=True):
        super().__init__(name, model, selector, delist_result)
        opt = model._optimizer()
        self._train_step = (make_masked_train_step(opt, loss_fn)
                            if opt is not None else None)
        self._eval_step = make_masked_eval_step(loss_fn)

    def _run(self, X, y, training):
        *batch, extent = self._pad(X, y)
        model = self.model
        if training:
            opt = model._optimizer()
            params = model.params
            opt_state = model._ensure_opt_state(params)
            new_params, model.opt_state, out_loss, reg, pred = (
                self._train_step(params, opt_state, opt.lr, *batch))
            model.params = new_params
        else:
            out_loss, reg, pred = self._eval_step(model.params, *batch)
        pred = self._trim(pred, extent)
        model.layers_outputs = {0: pred}
        return ({'output_losses': [float(out_loss)],
                 'regularization_loss': float(reg)}, pred)

    def train(self, context):
        self.selector(context)
        for X, y in self.selector.get():
            losses, pred = self._run(X, y, training=True)
            self._tally_losses(context, losses)
            self.selector.put(pred if self.delist_result else [pred])

    def test(self, context):
        self.selector(context)
        for X, y in self.selector.get():
            losses, pred = self._run(X, y, training=False)
            # test() reports output losses only
            self._tally_losses(context, {
                'output_losses': losses['output_losses']})
            self._record_metrics(context, pred, y)
            self.selector.put(pred if self.delist_result else [pred])

    def _record_metrics(self, context, pred, y):
        pass


def _padded(t, shape, device):
    t = torch.as_tensor(t).to(device=device, dtype=torch.float32)
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


class FastLineTrainComponent(_MaskedTrainComponent):
    """TRAIN-mode Line component: one masked step per paragraph crop."""

    def __init__(self, name, model, selector, delist_result=True):
        super().__init__(name, model, selector, partial(
            masked_line_loss, prefix=name,
            reg_fn=model.regularization_fn), delist_result)

    def _pad(self, X, y):
        b, h, w, c = X.shape
        hb, wb = round_up(h, TRAIN_BUCKET), round_up(w, TRAIN_BUCKET)
        device = self.model._compute_device()
        return (_padded(X, (b, hb, wb, c), device),
                _padded(y, (b, hb, wb, y.shape[3]), device), h, w, (h, w))

    def _trim(self, pred, extent):
        h, w = extent
        return pred[:, :h, :w, :]


class FastCharTrainComponent(_MaskedTrainComponent):
    """TRAIN-mode Char component: one masked step per line; the test
    sweep also records the per-column char accuracy on labeled columns
    (context['metrics'])."""

    def __init__(self, name, model, selector, delist_result=True):
        super().__init__(name, model, selector, partial(
            masked_char_loss, reg_fn=model.regularization_fn),
            delist_result)

    def _pad(self, X, y):
        b, h, w, c = X.shape
        wb = round_up(w, TRAIN_BUCKET)
        device = self.model._compute_device()
        return (_padded(X, (b, h, wb, c), device),
                _padded(y, (wb * b, y.shape[1]), device), w, w)

    def _trim(self, pred, w):
        return pred[:w, :]

    def _record_metrics(self, context, pred, y):
        y_np = to_host(y)
        labeled = y_np.sum(axis=1) > 0
        if labeled.any():
            acc = multiclass_accuracy(to_host(pred)[labeled], y_np[labeled])
            context.setdefault('metrics', {}).setdefault(
                self.name, []).append(acc)


def _pow2_batch(n):
    """The batch bucket of n samples: the next power of two."""
    return 1 << (n - 1).bit_length()


class FastLineComponent(ModelComponent):
    """PREDICT-mode Line component: the paragraph crops bucketed by shape
    (multiples of PARAGRAPH_BUCKET), each bucket batched to the next power
    of two through the masked forward (fastpath.py), which keeps each
    crop's output that of the crop alone."""

    def predict(self, context):
        crops = context[self.selector.X_label]
        groups = {}
        for i, c in enumerate(crops):
            groups.setdefault((round_up(c.shape[1], PARAGRAPH_BUCKET),
                               round_up(c.shape[2], PARAGRAPH_BUCKET)),
                              []).append(i)
        device = self.model._compute_device()
        preds = [None] * len(crops)
        for (hb, wb), idxs in groups.items():
            n = _pow2_batch(len(idxs))
            batch = torch.zeros((n, hb, wb, crops[idxs[0]].shape[3]),
                                device=device)
            hs = torch.full((n,), 4, dtype=torch.int64)
            ws = torch.full((n,), 4, dtype=torch.int64)
            for bi, i in enumerate(idxs):
                c = torch.as_tensor(crops[i]).to(device=device,
                                                 dtype=torch.float32)
                batch[bi, :c.shape[1], :c.shape[2], :] = c[0]
                hs[bi], ws[bi] = c.shape[1], c.shape[2]
            with torch.no_grad():
                out = line_forward_masked(self.model.params, batch,
                                          hs.to(device), ws.to(device),
                                          prefix='Line')
            for bi, i in enumerate(idxs):
                preds[i] = out[bi:bi + 1, :crops[i].shape[1],
                               :crops[i].shape[2], :]
        context['prediction'][self.name] = preds
        context[self.selector.pred_label] = preds


class FastCharComponent(ModelComponent):
    """PREDICT-mode Char component: every line of every paragraph,
    bucketed by width (multiples of LINE_WIDTH_BUCKET), each bucket
    batched to the next power of two through the masked Char forward
    (head 'xla', the plain dense chain)."""

    def predict(self, context):
        nested = context[self.selector.X_label]
        preds = [[None] * len(para) for para in nested]
        flat = [(p_id, l_id, line) for p_id, para in enumerate(nested)
                for l_id, line in enumerate(para)]
        groups = {}
        for k, (_, _, line) in enumerate(flat):
            groups.setdefault(round_up(line.shape[2], LINE_WIDTH_BUCKET),
                              []).append(k)
        device = self.model._compute_device()
        for wb, idxs in groups.items():
            n = _pow2_batch(len(idxs))
            batch = torch.zeros((n, CHAR_INPUT_HEIGHT, wb,
                                 flat[idxs[0]][2].shape[3]), device=device)
            ws = torch.full((n,), 4, dtype=torch.int64)
            for bi, k in enumerate(idxs):
                line = torch.as_tensor(flat[k][2]).to(device=device,
                                                      dtype=torch.float32)
                batch[bi, :, :line.shape[2], :] = line[0]
                ws[bi] = line.shape[2]
            with torch.no_grad():
                out = char_forward_masked(self.model.params, batch,
                                          ws.to(device))
            for bi, k in enumerate(idxs):
                p_id, l_id, line = flat[k]
                preds[p_id][l_id] = out[bi, :line.shape[2], :]
        context['prediction'][self.name] = preds
        context[self.selector.pred_label] = preds


class Modes(Enum):
    TRAIN_MONOCHROME = 0
    TRAIN_PARAGRAPH = 1
    TRAIN_LINE = 2
    TRAIN_CHAR = 3
    TRAIN_ALL = 4
    PREDICT = 5


def make_context_maker(mode, device=None):
    """Initial context per training mode from a dataset's layers: the
    model inputs and targets on `device`, the crop stages' inputs as host
    arrays."""
    device = resolve_device(device)

    if mode is Modes.TRAIN_MONOCHROME:
        def make_context(dataset_get_func, args=(), kwargs={}):
            layers = dataset_get_func(*args, layer_tags=['image', 'monochrome'],
                                      **kwargs)
            return {
                'monochrome_X': to_device(layers['image'], device),
                'monochrome_y': to_device(layers['monochrome'], device),
            }

    elif mode is Modes.TRAIN_PARAGRAPH:
        def make_context(dataset_get_func, args=(), kwargs={}):
            layers = dataset_get_func(
                *args, layer_tags=['monochrome', 'paragraph'], **kwargs)
            return {
                'paragraph_X': to_device(layers['monochrome'], device),
                'paragraph_y': to_device(layers['paragraph'], device),
            }

    elif mode is Modes.TRAIN_LINE:
        def make_context(dataset_get_func, args=(), kwargs={}):
            layers = dataset_get_func(
                *args, layer_tags=['monochrome', 'paragraph', 'line'], **kwargs)
            return {
                'monochrome_pred_cpu': layers['monochrome'],
                'paragraph_pred_cpu': layers['paragraph'],
                'line_cpu': layers['line'],
            }

    elif mode is Modes.TRAIN_CHAR:
        def make_context(dataset_get_func, args=(), kwargs={}):
            layers = dataset_get_func(
                *args, layer_tags=['monochrome', 'paragraph', 'line', 'char'],
                **kwargs)
            return {
                'monochrome_pred_cpu': layers['monochrome'],
                'paragraph_pred_cpu': layers['paragraph'],
                'line_cpu': layers['line'],
                'char_cpu': layers['char'],
            }

    elif mode is Modes.TRAIN_ALL:
        def make_context(dataset_get_func, args=(), kwargs={}):
            layers = dataset_get_func(
                *args,
                layer_tags=['image', 'monochrome', 'paragraph', 'line', 'char'],
                **kwargs)
            return {
                'monochrome_X': to_device(layers['image'], device),
                'monochrome_y': to_device(layers['monochrome'], device),
                'paragraph_y': to_device(layers['paragraph'], device),
                'line_cpu': layers['line'],
                'char_cpu': layers['char'],
            }

    else:
        def make_context(dataset_get_func, args=(), kwargs={}):
            layers = dataset_get_func(*args, layer_tags=['image'], **kwargs)
            return {'monochrome_X': to_device(layers['image'], device)}

    return make_context


#: the component order of the cascade; a mode runs a subset
COMPONENT_ORDER = [
    'Monochrome', 'rename_monochrome',
    'Paragraph', 'move_from_gpu_paragraph',
    'ParagraphCrop', 'move_to_gpu_paragraph_crop', 'rename_line',
    'Line', 'move_from_gpu_line',
    'LineCrop',
    'CharLabel', 'move_to_gpu_char_label',
    'Char', 'move_from_gpu_char',
    'PredToText',
]
MODEL_NAMES = ['Monochrome', 'Paragraph', 'Line', 'Char']


def make_model_system(input_shape, optimizer=None, progress_tracker=None,
                      weights=None, *, mode, generator=None, device=None):
    """Assemble the mode's component pipeline: returns (model_system,
    models, component_names).  `generator` draws the models' initial
    parameters (nn/rng.py; seed 0 when None) before `weights`, a
    model_weights.json dict, replaces them.  Line and Char train through
    the masked steps and predict through the bucketed batches (the JAX
    package's `bucketed=True`, its default).  Modes.PREDICT runs the whole
    cascade on one page, `model_system.predict(context)` leaving its
    [paragraph][line] text in context['text']."""
    device = resolve_device(device)
    generator = make_generator() if generator is None else generator
    build = dict(generator=generator, device=device)

    def get_result(components):
        model_system = ModelSystem([
            components[component_name]
            for component_name in COMPONENT_ORDER
            if component_name in components.keys()
        ])
        models = {
            model_name: components[model_name].model
            for model_name in MODEL_NAMES
            if model_name in components.keys()
        }
        for model_name, model in models.items():
            if progress_tracker is not None:
                model.init_progress_tracker(progress_tracker, model_name)
            if weights is not None:
                model.set_weights(weights)
        names = [
            component_name
            for component_name in COMPONENT_ORDER
            if component_name in [
                'Monochrome', 'Paragraph', 'ParagraphCrop', 'Line',
                'LineCrop', 'CharLabel', 'Char', 'PredToText',
            ] and component_name in components.keys()
        ]
        return model_system, models, names

    def make_monochrome_component():
        return ModelComponent(
            'Monochrome', make_monochrome(input_shape, optimizer, **build),
            StringSelector('monochrome_X', 'monochrome_y', 'monochrome_pred'),
            delist_result=True)

    if mode is Modes.TRAIN_MONOCHROME:
        return get_result({'Monochrome': make_monochrome_component()})

    def make_paragraph_component():
        return ModelComponent(
            'Paragraph', make_paragraph(input_shape, optimizer, **build),
            StringSelector('paragraph_X', 'paragraph_y', 'paragraph_pred'),
            delist_result=True)

    if mode is Modes.TRAIN_PARAGRAPH:
        return get_result({'Paragraph': make_paragraph_component()})

    def make_paragraph_crop_component():
        @track_function('ParagraphCrop', 'forward', progress_tracker)
        def paragraph_crop_func(context):
            old_labels = ['monochrome_pred_cpu', 'line_cpu', 'char_cpu']
            new_labels = ['cropped_monochrome_cpu', 'cropped_line_cpu',
                          'cropped_char_cpu']
            if mode is Modes.TRAIN_LINE:
                old_labels.pop()
                new_labels.pop()
            if mode is Modes.PREDICT:
                old_labels, new_labels = old_labels[:1], new_labels[:1]
            mask, *arrays = get_from_context(context, [
                'paragraph_pred_cpu', *old_labels])
            with CropAndRotateParagraphs(min(4, os.cpu_count())) as crop:
                results = crop(mask, arrays)
            put_to_context(context, new_labels, [
                [make_divisible_by(t, 16, 16) for t in array]
                for array in results])
        return RawFunctionComponent(paragraph_crop_func)

    def make_line_component():
        selector = LineSelector('cropped_monochrome', 'cropped_line',
                                'line_pred')
        model = make_line(input_shape, optimizer, **build)
        if mode is Modes.PREDICT:
            return FastLineComponent('Line', model, selector,
                                     delist_result=True)
        return FastLineTrainComponent('Line', model, selector)

    if mode is Modes.TRAIN_LINE:
        return get_result({
            'ParagraphCrop': make_paragraph_crop_component(),
            'move_to_gpu_paragraph_crop': make_move_to_device_component([
                ('cropped_monochrome_cpu', 'cropped_monochrome'),
                ('cropped_line_cpu', 'cropped_line'),
            ], device),
            'Line': make_line_component(),
        })

    def make_line_crop_component():
        @track_function('LineCrop', 'forward', progress_tracker)
        def line_crop_func(context):
            old_labels = ['cropped_monochrome_cpu', 'cropped_char_cpu']
            new_labels = ['cropped_2_monochrome_cpu', 'cropped_2_char_cpu']
            if mode is Modes.PREDICT:
                old_labels, new_labels = old_labels[:1], new_labels[:1]
            masks, *arrays = get_from_context(context, [
                'line_pred_cpu', *old_labels])
            with CropRotateAndZoomLines(min(8, os.cpu_count()),
                                        CHAR_INPUT_HEIGHT,
                                        CHAR_FIXED_WIDTH) as crop:
                results = crop(masks, arrays)
            put_to_context(context, new_labels, results)
        return RawFunctionComponent(line_crop_func)

    def make_char_label_component():
        @track_function('CharLabel', 'forward', progress_tracker)
        def char_label_func(context):
            lines = get_from_context(context, ['cropped_2_char_cpu'])[0]
            with LabelChar(min(8, os.cpu_count())) as label_char:
                result = label_char(lines)
            put_to_context(context, ['char_labels_cpu'], [result])
        return RawFunctionComponent(char_label_func)

    def make_char_component():
        selector = CharSelector('cropped_2_monochrome', 'char_labels',
                                'char_pred')
        model = make_char(input_shape, optimizer, **build)
        if mode is Modes.PREDICT:
            return FastCharComponent('Char', model, selector,
                                     delist_result=True)
        return FastCharTrainComponent('Char', model, selector)

    if mode is Modes.TRAIN_CHAR:
        return get_result({
            'ParagraphCrop': make_paragraph_crop_component(),
            'rename_line': make_rename_in_context_component([
                ('cropped_line_cpu', 'line_pred_cpu'),
            ]),
            'LineCrop': make_line_crop_component(),
            'CharLabel': make_char_label_component(),
            'move_to_gpu_char_label': make_move_to_device_component([
                ('cropped_2_monochrome_cpu', 'cropped_2_monochrome'),
                ('char_labels_cpu', 'char_labels'),
            ], device),
            'Char': make_char_component(),
        })

    # TRAIN_ALL and PREDICT: the whole cascade; PREDICT moves no labels
    # and decodes the Char predictions to text
    predict = mode is Modes.PREDICT
    components = {
        'Monochrome': make_monochrome_component(),
        'rename_monochrome': make_rename_in_context_component([
            ('monochrome_pred', 'paragraph_X'),
        ]),
        'Paragraph': make_paragraph_component(),
        'move_from_gpu_paragraph': make_move_from_device_component([
            ('monochrome_pred', 'monochrome_pred_cpu'),
            ('paragraph_pred', 'paragraph_pred_cpu'),
        ]),
        'ParagraphCrop': make_paragraph_crop_component(),
        'move_to_gpu_paragraph_crop': make_move_to_device_component([
            ('cropped_monochrome_cpu', 'cropped_monochrome'),
            *([] if predict else [('cropped_line_cpu', 'cropped_line')]),
        ], device),
        'Line': make_line_component(),
        'move_from_gpu_line': make_move_from_device_component([
            ('line_pred', 'line_pred_cpu'),
        ]),
        'LineCrop': make_line_crop_component(),
        'move_to_gpu_char_label': make_move_to_device_component([
            ('cropped_2_monochrome_cpu', 'cropped_2_monochrome'),
            *([] if predict else [('char_labels_cpu', 'char_labels')]),
        ], device),
        'Char': make_char_component(),
    }
    if not predict:
        components['CharLabel'] = make_char_label_component()
        return get_result(components)

    @track_function('PredToText', 'forward', progress_tracker)
    def pred_to_text_func(context):
        with PredToText(min(8, os.cpu_count())) as pred_to_text:
            context['text'] = pred_to_text(context['char_pred_cpu'])

    components['move_from_gpu_char'] = make_move_from_device_component([
        ('char_pred', 'char_pred_cpu'),
    ])
    components['PredToText'] = RawFunctionComponent(pred_to_text_func)
    return get_result(components)
