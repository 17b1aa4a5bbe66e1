"""Curriculum training (univer_ocr_tpu/models/train.py): the five-stage
curriculum MONOCHROME -> PARAGRAPH -> LINE -> CHAR -> ALL over
`make_model_system` and `Trainer`, with the best weights of every stage
merge-saved into a checkpoint, and the run's telemetry to the console or,
after `init_emitter`, to the training dashboard.

    python -m univer_ocr_tpu_torch.models.train [--cpu]
        [--data NPZ|DIR|generate]
        [--weights-in JSON] [--weights-out JSON] [--epochs N]
        [--train-size N] [--val-size N] [--seed N] [--batched]
        [--batch N] [--predicted[=mix]] [--eval-gate]
        [--save-train-progress]

`--data` is a training-pages .npz (default: the committed fixture,
univer_ocr_tpu_torch/fixtures/train_pages.npz: 2 pages to train, 1 to
validate), the directory of a PNG corpus with `train/` and
`validation/` (`python -m univer_ocr_tpu_torch generate_data` writes one
under generated_files/data; reading it needs Pillow), or `generate`, the
JAX package's default: that corpus when it exists, else pages rendered on
demand from `--seed` (needs Pillow and fonts, which the card machine
lacks).  Training starts from
`--weights-in` (default: the JAX package's committed checkpoint, which is
only read) and writes `--weights-out` (default
generated_files/model_weights_torch.json).  `--epochs` replaces every
stage's epoch count.  `--batched` trains the four single-model stages
in weighted batches of `--batch` samples (models/dp_train.py),
`--predicted` builds their Line and Char samples from the serving crop
distribution (`=mix` adds the ground-truth crops), and `--eval-gate`
writes a stage's weights only when the end-to-end text of the eval
corpus does not regress (models/evaluation.py), as the JAX package's
scripts/train_tpu.py flags do.  `--save-train-progress` writes each
per-sample step's pictures (ProgressSnapshots) under
generated_files/train_progress/; it needs Pillow.
"""

import argparse
import json
import random
from pathlib import Path
from pprint import pprint

import numpy as np

from ..device import resolve_device
from ..nn.checkpoint import write_weights
from ..nn.optimizers import Adam
from ..nn.progress_tracker import ProgressTracker
from ..ops.precision import backend_flags
from ..parallel.mesh import mesh_device
from ..weights import DEFAULT_CHECKPOINT, refuse_committed
from .constants import (TRAIN_FIXTURE, TRAIN_PROGRESS_PATH,
                        TRAINED_WEIGHTS_PATH)
from .datasets import (Dataset, RandomSelectDataset, decode_X_plane,
                       decode_y_planes, load_page_arrays, train_dataset,
                       validation_dataset)
from .dp_train import _STAGE_MODEL, train_model_batched
from .evaluation import make_eval_gate
from .model import Modes, make_context_maker, make_model_system, to_host
from .trainer import Trainer

#: (mode, lr, lr decay step, epochs) of each stage, the reference's table
CURRICULUM = [
    (Modes.TRAIN_MONOCHROME, 0.0015, 0.995, 100),
    (Modes.TRAIN_PARAGRAPH, 0.0015, 0.995, 100),
    (Modes.TRAIN_LINE, 0.0015, 0.995, 100),
    (Modes.TRAIN_CHAR, 0.0015, 0.9, 10),
    (Modes.TRAIN_ALL, 0.001, 0.9, 10),
]


class TrainReporter:
    """A training run's telemetry.  With no sink it goes to the console
    (`message` and `info` print; `status`, the dashboard's progress
    events, shows nothing there).  Once a sink is connected (`connect`;
    a WSClient of web/ws_client.py, which univer_ocr_tpu_torch/train.py
    connects to the dashboard's /train-ws), the same payloads go out as
    its `message` / `info` / `progress_tracker` events, the vocabulary
    the dashboard's train.js reads."""

    #: tracker events folded into one dashboard table-update type
    _TIMING_EVENTS = frozenset(('forward', 'backward'))

    def __init__(self, sink=None):
        self._sink = sink

    def connect(self, sink):
        self._sink = sink

    def _send(self, event, payload):
        if self._sink is not None:
            self._sink.emit(event, payload)
            return True
        return False

    def message(self, *parts, sep=' ', end='\n'):
        text = sep.join(str(part) for part in parts) + end
        if not self._send('message', text):
            print(text)

    def info(self, info):
        if self._send('info', info):
            return
        for info_type, info_data in info.items():
            print(f'{info_type}:')
            pprint(info_data, indent=4)
            print()

    @staticmethod
    def _fold_timings(summary):
        """ProgressTracker summary -> {layer: {event: {counter, done,
        time}}} rows for the dashboard's per-layer table."""
        return {layer: {entry['name']: {'counter': entry['counter'],
                                        'done': entry['done'],
                                        'time': str(entry['time'])}
                        for entry in events}
                for layer, events in summary.items()}

    def status(self, status_type, status_data=None):
        if status_type in self._TIMING_EVENTS:
            status_type = 'forward_backward'
            status_data = self._fold_timings(status_data)
        payload = {'type': status_type}
        if status_data is not None:
            payload['data'] = status_data
        self._send('progress_tracker', payload)


#: the reporter of runs given none; init_emitter connects its sink
_reporter = TrainReporter()


def init_emitter(new_emitter):
    """Send the telemetry of later runs to `new_emitter` (an object with
    `emit(event, data)`); None returns it to the console."""
    _reporter.connect(new_emitter)


def message(*parts, sep=' ', end='\n'):
    _reporter.message(*parts, sep=sep, end=end)


def emit_info(info):
    _reporter.info(info)


def emit_status(status_type, status_data=None):
    _reporter.status(status_type, status_data)


def _read_weights(path):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        print(f'No checkpoint found at {path}')
        return {}


def _model_info(models, names):
    """The layer names, output shapes and receptive fields the JAX
    package reports for a stage."""
    layer_names = names + [
        layer_name
        for model in models.values()
        for layer_name in model.get_leaf_layers().keys()
    ]
    output_shapes = {}
    for model_name, model in models.items():
        outs, per_layer = model.get_all_output_shapes(model.input_shapes)
        for layer_name, shapes in {model_name: outs, **per_layer}.items():
            output_shapes[layer_name] = [str(x) for x in shapes]
    receptive_fields = {}
    for model in models.values():
        if not model.is_fully_convolutional():
            continue
        for layer_name, rf in model.get_receptive_fields().items():
            y, x = rf['input 0']['y'], rf['input 0']['x']
            cnt = rf['input 0']['cnt']
            receptive_fields[layer_name] = f'y={y}, x={x}, size={cnt}'
    return {'layer_names': layer_names, 'output_shapes': output_shapes,
            'receptive_fields': receptive_fields}


def _pillow():
    """Pillow's Image module; raises, naming Pillow, without it."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            'save_train_progress writes its pictures with Pillow, which is '
            f'not installed ({exc})') from None
    return Image


def _decode_X(X):
    return decode_X_plane(to_host(X))


def _decode_y(y):
    return decode_y_planes(to_host(y))


class ProgressSnapshots:
    """Per-sample X / y / pred / threshold pictures of a training stage
    (univer_ocr_tpu/models/train.py ProgressSnapshots), with the JAX
    package's tree and file names: <path>/<mode>/<stage>/
    {epoch}_{phase}_{index}_[{paragraph}_][{line}_]... .png, one set per
    cascade stage the mode trains (TRAIN_ALL: all four).

    `panels(epoch, phase, index, context)` computes them with numpy
    alone, as {path relative to `path`: uint8 array (H, W) or, for the
    Char panels, (H, W, 3)}, reading the context's tensors back from the
    card; calling the object writes them as PNGs with Pillow (the Trainer's
    `save_pictures_func`)."""

    def __init__(self, mode, path=TRAIN_PROGRESS_PATH):
        self.mode = mode
        self.path = Path(path)
        #: which stage panels each training mode draws
        self._stages = {
            Modes.TRAIN_MONOCHROME: (self._monochrome,),
            Modes.TRAIN_PARAGRAPH: (self._paragraph,),
            Modes.TRAIN_LINE: (self._line,),
            Modes.TRAIN_CHAR: (self._char,),
            Modes.TRAIN_ALL: (self._monochrome, self._paragraph,
                              self._line, self._char),
        }

    def panels(self, epoch, phase, index, context):
        out = {}
        prefix = f'{epoch}_{phase}_{index}_'
        for stage_panels in self._stages.get(self.mode, ()):
            stage_panels(out, prefix, context)
        return out

    def __call__(self, epoch, phase, index, context):
        Image = _pillow()
        for name, image in self.panels(epoch, phase, index, context).items():
            target = self.path / name
            target.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(image).save(target)

    # -- file names ------------------------------------------------------

    def _dir(self, stage):
        return f'{self.mode.name.lower()}/{stage}/'

    @staticmethod
    def _ids(paragraph_id, line_id):
        return (('' if paragraph_id is None else f'{paragraph_id}_')
                + ('' if line_id is None else f'{line_id}_'))

    def _quad(self, out, prefix, stage, X, y, pred, th, paragraph_id=None):
        tag = self._dir(stage) + prefix + self._ids(paragraph_id, None)
        for i, image in enumerate(X):
            out[f'{tag}1_{i}_1_X.png'] = image
        for i in range(len(y)):
            for suffix, image in (('2_y', y[i]), ('3_pred', pred[i]),
                                  ('4_th', th[i])):
                out[f'{tag}2_{i}_{suffix}.png'] = image

    # -- stages ----------------------------------------------------------

    def _monochrome(self, out, prefix, context):
        self._quad(out, prefix, 'monochrome',
                   [_decode_X(context['monochrome_X'])],
                   _decode_y(context['monochrome_y'])[0],
                   *_decode_y(context['monochrome_pred']))

    def _paragraph(self, out, prefix, context):
        self._quad(out, prefix, 'paragraph',
                   _decode_y(context['paragraph_X'])[0],
                   _decode_y(context['paragraph_y'])[0],
                   *_decode_y(context['paragraph_pred']))

    def _line(self, out, prefix, context):
        per_paragraph = zip(context['cropped_monochrome_cpu'],
                            context['cropped_line_cpu'],
                            context['line_pred'])
        for p_id, (crop, bands, pred) in enumerate(per_paragraph):
            self._quad(out, prefix, 'line', _decode_y(crop)[0],
                       _decode_y(bands)[0], *_decode_y(pred),
                       paragraph_id=p_id)

    def _char(self, out, prefix, context):
        """RGB panel per line: the monochrome crop on top, then (the
        prediction's argmax, the labels, their overlap) as colour
        channels over (classes, W)."""
        def column(grid):            # (W, C) -> (C, W, 1) image plane
            return to_host(grid).T[:, :, None]

        for p_id, lines in enumerate(context['cropped_2_monochrome_cpu']):
            for l_id in range(len(lines)):
                logits = to_host(context['char_pred'][p_id][l_id])
                pred = column(logits == logits.max(axis=1, keepdims=True))
                labels = column(context['char_labels_cpu'][p_id][l_id])
                panel = np.concatenate([pred, labels, pred * labels], axis=2)
                mono_rgb = np.repeat(to_host(lines[l_id])[0], 3, axis=2)
                tag = self._dir('char') + prefix + self._ids(p_id, l_id)
                out[f'{tag}.png'] = (np.concatenate(
                    [mono_rgb, panel], axis=0) * 255).astype(np.uint8)


def train_model(train_dataset, validation_dataset, curriculum=None,
                train_size=50, val_size=5, seed=0,
                weights_in=DEFAULT_CHECKPOINT,
                weights_out=TRAINED_WEIGHTS_PATH, device=None,
                show_progress_bar=False, reporter=None, batched=False,
                mesh=None, batch=16, predicted=False, eval_gate=False,
                save_train_progress=False, progress_path=TRAIN_PROGRESS_PATH):
    """Run the curriculum (CURRICULUM unless given: (mode, lr, lr_step,
    epochs) per stage) on `device` (None: the card).

    Each stage draws `train_size` / `val_size` pages of the datasets from
    one `random.Random(seed)` (which also orders every sweep), builds its
    model system with `Adam(lr)` from the checkpoint's current weights
    and trains it; the models whose validation loss improved are merged
    into the checkpoint after each epoch, which is then written to
    `weights_out` atomically.  The checkpoint starts as `weights_in`;
    `weights_out` may not be the JAX package's committed checkpoint.
    The whole call runs in full float32 (`backend_flags('highest')`: TF32
    off for convolutions and matrix products), as JAX trains.

    `batched=True` trains the four single-model stages through the
    batched trainer (dp_train.train_model_batched: samples built once,
    weighted batches of `batch`, per-sample losses), which writes
    `weights_out` itself; TRAIN_ALL stays on the per-sample Trainer.
    `predicted` (True or 'mix') builds the batched Line and Char samples
    from the serving crop distribution.  `eval_gate=True` holds every
    write of `weights_out` to the end-to-end score of the eval corpus
    (evaluation.make_eval_gate, its incumbent read from `weights_out`).
    With a `mesh` (parallel/mesh.py) the batched stages' batches split
    over its 'data' shards and the run computes on its first device;
    TRAIN_ALL stays per-sample, as in JAX.  The run reports to
    `reporter` (default: the module's TrainReporter, which init_emitter
    connects to the dashboard).  `save_train_progress=True` writes every
    per-sample step's pictures under `progress_path` (ProgressSnapshots:
    <mode>/<stage>/...png); it needs Pillow, and without it the call
    raises before anything else.

    Returns one dict per stage: mode, best validation losses and epochs,
    rollbacks, and the sample orders the trainer drew; a batched stage's:
    mode, best validation loss, sample counts and build seconds.
    """
    if save_train_progress:
        _pillow()
    device = resolve_device(device if mesh is None
                            else mesh_device(mesh, device))
    weights_out = Path(weights_out)
    refuse_committed(weights_out)
    reporter = _reporter if reporter is None else reporter
    rng = random.Random(seed)
    tracker = ProgressTracker(reporter.status)
    tracker.reset()
    weights_out.parent.mkdir(parents=True, exist_ok=True)
    # the checkpoint, kept in memory: weights_out always holds it
    checkpoint = _read_weights(weights_in)
    write_weights(checkpoint, weights_out)

    gate = None
    if eval_gate:
        gate = make_eval_gate(weights_out, log=reporter.message,
                              device=device)
    modes = CURRICULUM if curriculum is None else curriculum
    results = []
    with backend_flags('highest'):
        if batched:
            fast = [stage for stage in modes if stage[0] in _STAGE_MODEL]
            if fast:
                results += train_model_batched(
                    fast, train_dataset, validation_dataset, batch=batch,
                    mesh=mesh, train_size=train_size, val_size=val_size,
                    seed=seed, log=reporter.message,
                    checkpoint_path=weights_out, predicted=predicted,
                    eval_gate=gate, device=device, rng=rng)
                checkpoint = _read_weights(weights_out)
            modes = [stage for stage in modes
                     if stage[0] not in _STAGE_MODEL]
        for mode, lr, lr_step, epochs in modes:
            print(f'Training mode: {mode.name}')
            # the dashboard's step badge: the stage's data is being built
            reporter.status('generating_data')
            train_pages = RandomSelectDataset(train_size, train_dataset, rng)
            val_pages = RandomSelectDataset(val_size, validation_dataset,
                                            rng)
            input_shape = train_pages.get(0, layer_tags=['image'])[
                'image'].shape
            reporter.message(f'Input shape: {input_shape}')

            optimizer = Adam(lr=lr)
            model_system, models, names = make_model_system(
                input_shape, optimizer, tracker, checkpoint, mode=mode,
                device=device)

            def save_improved(models_to_update, models=models):
                for name in models_to_update:
                    checkpoint.update(models[name].get_weights())
                write_weights(checkpoint, weights_out)

            save_pictures_func = None
            if save_train_progress:
                save_pictures_func = ProgressSnapshots(mode, progress_path)
                print(f'Saving train progress into {progress_path}\n')
            reporter.info(_model_info(models, names))
            reporter.message('Count of parameters: ' + str(sum(
                model.count_parameters() for model in models.values())))

            trainer = Trainer(
                model_system, make_context_maker(mode, device), models,
                train_pages, val_pages, progress_tracker=tracker,
                show_progress_bar=show_progress_bar, optimizer=optimizer,
                learning_rate_step=lr_step, save_weights_func=save_improved,
                save_pictures_func=save_pictures_func, rng=rng,
                eval_gate=gate)
            best_loss, best_loss_epoch = trainer.train(num_epochs=epochs)
            reporter.message(f'Complete. Best loss was {best_loss} '
                             f'on epoch #{best_loss_epoch}')
            results.append({'mode': mode.name, 'best_losses': best_loss,
                            'best_epochs': best_loss_epoch,
                            'rollbacks': trainer.rollbacks,
                            'orders': trainer.orders})
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--cpu', action='store_true',
                        help='run on the CPU instead of the card')
    parser.add_argument('--data', default=str(TRAIN_FIXTURE),
                        help="training-pages .npz, PNG corpus directory, or "
                             "'generate': the corpus under generated_files/"
                             "data when it exists, else pages rendered on "
                             "demand (needs Pillow and fonts)")
    parser.add_argument('--weights-in', default=str(DEFAULT_CHECKPOINT))
    parser.add_argument('--weights-out', default=str(TRAINED_WEIGHTS_PATH))
    parser.add_argument('--epochs', type=int, default=None,
                        help="every stage's epochs (default: the "
                             "curriculum's)")
    parser.add_argument('--train-size', type=int, default=None,
                        help='pages per stage (default: all)')
    parser.add_argument('--val-size', type=int, default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--batched', action='store_true',
                        help='train the single-model stages in batches')
    parser.add_argument('--batch', type=int, default=16,
                        help='samples per batch of --batched')
    parser.add_argument('--predicted', nargs='?', const=True, default=False,
                        choices=[True, 'mix'],
                        help='batched Line/Char samples from predicted '
                             'crops (=mix: and ground-truth ones)')
    parser.add_argument('--eval-gate', action='store_true',
                        help='write weights only when the end-to-end eval '
                             'score does not regress')
    parser.add_argument('--save-train-progress', action='store_true',
                        help='write each step\'s pictures under '
                             'generated_files/train_progress (needs Pillow)')
    args = parser.parse_args(argv)

    data = Path(args.data)
    if args.data == 'generate':
        train = train_dataset(random.Random(args.seed))
        validation = validation_dataset(random.Random(args.seed + 1))
    elif data.is_dir():
        train, validation = (Dataset(len(list(d.glob('*_image.png'))), d)
                             for d in (data / 'train', data / 'validation'))
    else:
        train, validation = load_page_arrays(data)
    curriculum = [(mode, lr, step, epochs if args.epochs is None
                   else args.epochs)
                  for mode, lr, step, epochs in CURRICULUM]
    results = train_model(
        train, validation, curriculum,
        train_size=args.train_size or len(train),
        val_size=args.val_size or len(validation), seed=args.seed,
        weights_in=args.weights_in, weights_out=args.weights_out,
        device='cpu' if args.cpu else None, batched=args.batched,
        batch=args.batch, predicted=args.predicted,
        eval_gate=args.eval_gate,
        save_train_progress=args.save_train_progress)
    for stage in results:
        print(stage['mode'], {name: list(map(float, v))
                              for name, v in stage['best_losses'].items()})
    return results


if __name__ == '__main__':
    main()
