"""The training extras of the port against the JAX package on the CPU:
ProgressSnapshots (the same contexts through both write the same file
names, pixel-equal when decoded with Pillow, in all five modes), the
Trainer's save_pictures_func hook (JAX's (epoch, phase, index) calls),
train_model(save_train_progress=True) on the CPU and without Pillow, and
the single-iteration copy (JAX's root script's result on the same tree).

Contexts come from one test step of each mode's model system on a window
of the committed training fixture's first page, as in
tests/test_torch_train.py."""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from univer_ocr_tpu.models import model as jmodel
from univer_ocr_tpu.models import train as jtrain
from univer_ocr_tpu.models.trainer import Trainer as JTrainer
from univer_ocr_tpu.nn.progress_tracker import BaseProgressTracker as JBase
from univer_ocr_tpu_torch import single_iteration_from_train_progress
from univer_ocr_tpu_torch.models import model as tmodel
from univer_ocr_tpu_torch.models.constants import (LAYER_NAMES_PLAIN,
                                                   TRAIN_FIXTURE)
from univer_ocr_tpu_torch.models.datasets import ArrayDataset
from univer_ocr_tpu_torch.models.train import ProgressSnapshots, train_model
from univer_ocr_tpu_torch.models.trainer import Trainer
from univer_ocr_tpu_torch.nn.optimizers import Adam
from univer_ocr_tpu_torch.nn.progress_tracker import BaseProgressTracker
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

ROOT = Path(__file__).resolve().parents[1]
#: the window of tests/test_torch_train.py: two whole paragraphs of page 0
WINDOW = (slice(72, 200), slice(80, 400))
SHAPE = (1, 128, 320, 1)
MODES = ['TRAIN_MONOCHROME', 'TRAIN_PARAGRAPH', 'TRAIN_LINE', 'TRAIN_CHAR',
         'TRAIN_ALL']
#: the context entries the snapshots read
SNAPSHOT_KEYS = ('monochrome_X', 'monochrome_y', 'monochrome_pred',
                 'paragraph_X', 'paragraph_y', 'paragraph_pred',
                 'cropped_monochrome_cpu', 'cropped_line_cpu', 'line_pred',
                 'cropped_2_monochrome_cpu', 'char_pred', 'char_labels_cpu')


@pytest.fixture(scope='module')
def windows():
    with np.load(TRAIN_FIXTURE) as f:
        pages = np.concatenate([f['train'], f['validation']])
    return ArrayDataset(pages[:, WINDOW[0], WINDOW[1]], LAYER_NAMES_PLAIN)


@pytest.fixture(scope='module')
def contexts(windows):
    """One test step of each mode on window 0, from the committed
    checkpoint."""
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    out = {}
    for name in MODES:
        mode = getattr(tmodel.Modes, name)
        system, _, _ = tmodel.make_model_system(
            SHAPE, Adam(lr=1e-3), weights=weights, mode=mode, device='cpu')
        context = tmodel.make_context_maker(mode, 'cpu')(windows.get, (0,))
        system.test(context)
        out[name] = context
    return out


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob('*.png'))


def _decoded(path):
    with Image.open(path) as image:
        return image.mode, np.asarray(image)


def _jax_snapshots(mode_name, context, root, monkeypatch, epoch, phase,
                   index):
    monkeypatch.setattr(jtrain, 'TRAIN_PROGRESS_PATH', root)
    host = {k: tmodel.to_host(v) for k, v in context.items()
            if k in SNAPSHOT_KEYS}
    jtrain.ProgressSnapshots(getattr(jmodel.Modes, mode_name))(
        epoch, phase, index, host)


@pytest.mark.parametrize('mode_name', MODES)
def test_snapshots_equal_jax(mode_name, contexts, tmp_path, monkeypatch):
    """The same context: the same file names under <mode>/<stage>/, and
    every picture pixel-equal (mode and values) once decoded."""
    context = contexts[mode_name]
    port_root, jax_root = tmp_path / 'port', tmp_path / 'jax'
    snapshots = ProgressSnapshots(getattr(tmodel.Modes, mode_name), port_root)
    panels = snapshots.panels(3, 'validation', 1, context)
    assert all(a.dtype == np.uint8 for a in panels.values())
    snapshots(3, 'validation', 1, context)
    _jax_snapshots(mode_name, context, jax_root, monkeypatch, 3,
                   'validation', 1)
    names = _files(jax_root)
    stages = {'TRAIN_ALL': 4, 'TRAIN_LINE': 1, 'TRAIN_CHAR': 1}
    assert len({Path(n).parent for n in names}) == stages.get(mode_name, 1)
    assert _files(port_root) == names == sorted(panels)
    for name in names:
        port_mode, port_pixels = _decoded(port_root / name)
        jax_mode, jax_pixels = _decoded(jax_root / name)
        assert port_mode == jax_mode
        np.testing.assert_array_equal(port_pixels, jax_pixels, err_msg=name)


class _FakeModel:
    opt_state = None

    def get_outputs_count(self):
        return 1

    def get_weights(self):
        return {'w': [0.0]}

    def set_weights(self, weights):
        pass

    def nan_weights(self):
        return False


class _FakeSystem:
    def train(self, context):
        context['losses'] = {'M': {'output_losses': [1.0]}}

    test = train


class _Samples:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, i, **kwargs):
        return {'sample': i}


def test_trainer_calls_save_pictures_as_jax_does():
    """Every sample of every sweep, precomputing as epoch 0: the port's
    Trainer makes JAX's (epoch, phase, index) calls in JAX's order."""
    calls = {'port': [], 'jax': []}
    for key, trainer_cls, tracker in (('port', Trainer, BaseProgressTracker),
                                      ('jax', JTrainer, JBase)):
        trainer_cls(
            _FakeSystem(), lambda get, args: dict(get(*args)),
            {'M': _FakeModel()}, _Samples(3), _Samples(2),
            progress_tracker=tracker(),
            save_pictures_func=lambda e, p, i, ctx, key=key:
                calls[key].append((e, p, i, 'losses' in ctx)),
        ).train(num_epochs=2)
    assert calls['port'] == calls['jax']
    assert calls['port'][:3] == [(0, 'precomputing', 0, True),
                                 (0, 'precomputing', 1, True),
                                 (1, 'train', 0, True)]
    assert len(calls['port']) == 2 + 2 * (3 + 2)


def test_train_model_saves_progress_on_the_cpu(windows, tmp_path):
    """One epoch of Monochrome on 2 windows, validated on 1: the
    precomputing, train and validation samples each leave X / y / pred /
    threshold under train_monochrome/monochrome/."""
    progress = tmp_path / 'progress'
    train_model(windows, windows,
                curriculum=[(tmodel.Modes.TRAIN_MONOCHROME, 1e-3, 0.995, 1)],
                train_size=2, val_size=1, weights_out=tmp_path / 'w.json',
                device='cpu', save_train_progress=True,
                progress_path=progress)
    names = [Path(n) for n in _files(progress)]
    assert {n.parent for n in names} == {Path('train_monochrome/monochrome')}
    prefixes = sorted({'_'.join(n.name.split('_')[:3]) for n in names})
    assert prefixes == ['0_precomputing_0', '1_train_0', '1_train_1',
                        '1_validation_0']
    assert len(names) == 4 * len(prefixes)


def test_without_pillow_train_model_raises_before_any_step(tmp_path,
                                                          monkeypatch,
                                                          contexts):
    """The card has no Pillow: save_train_progress=True raises, naming
    it, before a page is read or the checkpoint written; the numpy panels
    need no Pillow."""
    class Untouched:
        def __len__(self):
            return 1

        def get(self, *args, **kwargs):
            raise AssertionError('a page was read')

    monkeypatch.setitem(sys.modules, 'PIL', None)
    monkeypatch.setitem(sys.modules, 'PIL.Image', None)
    with pytest.raises(RuntimeError, match='Pillow'):
        train_model(Untouched(), Untouched(),
                    curriculum=[(tmodel.Modes.TRAIN_ALL, 1e-3, 0.9, 1)],
                    train_size=1, val_size=1,
                    weights_out=tmp_path / 'w.json', device='cpu',
                    save_train_progress=True)
    assert not (tmp_path / 'w.json').exists()
    panels = ProgressSnapshots(tmodel.Modes.TRAIN_ALL).panels(
        1, 'train', 0, contexts['TRAIN_ALL'])
    assert len(panels) > 16


def _jax_single_iteration():
    spec = importlib.util.spec_from_file_location(
        'jax_single_iteration', ROOT / 'single_iteration_from_train_progress.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize('planted', [False, True])
def test_single_iteration_copy_equals_jax(planted, contexts, tmp_path,
                                          monkeypatch):
    """On the tree the snapshots write, JAX's script and the port's module
    copy nothing (the names they look for are not the snapshots'); with
    files of the names they look for planted at the top of a mode's
    directory, both copy the same ones under the same names."""
    tree = tmp_path / 'tree'
    ProgressSnapshots(tmodel.Modes.TRAIN_MONOCHROME, tree)(
        1, 'train', 0, contexts['TRAIN_MONOCHROME'])
    if planted:
        for name in ('1_train_0_1_X.png', '1_train_0_3_pred.png',
                     '1_validation_0_2_y.png', '2_train_0_4_thresholded.png'):
            (tree / 'train_monochrome' / name).write_bytes(name.encode())
    jax_cwd = tmp_path / 'jax'
    shutil.copytree(tree, jax_cwd / 'generated_files' / 'train_progress')
    monkeypatch.chdir(jax_cwd)
    _jax_single_iteration().main('1', 'train', '0')
    port_out = tmp_path / 'port_out'
    port_out.mkdir()
    (port_out / 'stale.png').write_bytes(b'old')
    single_iteration_from_train_progress.main(
        '1', 'train', '0', progress_path=tree, out_path=port_out)
    jax_out = jax_cwd / 'generated_files' / 'single_iteration_from_train_progress'
    copied = sorted(p.name for p in jax_out.iterdir())
    assert sorted(p.name for p in port_out.iterdir()) == copied
    assert copied == (['1_train_0_train_monochrome_1_X.png',
                       '1_train_0_train_monochrome_3_pred.png']
                      if planted else [])
    for name in copied:
        assert (port_out / name).read_bytes() == (jax_out / name).read_bytes()
