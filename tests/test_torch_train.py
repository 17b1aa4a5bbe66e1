"""The training slice as a whole: the crop components, make_model_system
in each of the five training modes, and train_model, against the JAX
package on windows of the committed training fixture's pages
(univer_ocr_tpu_torch/fixtures/train_pages.npz), from the committed
checkpoint, in float32 on the CPU.

Bars: the crop components' arrays are equal exactly.  A model's first
step in a mode (its loss from the checkpoint's weights, a forward only)
is within 1e-5 relative of JAX's, and so is every loss of the test page,
which the port computes from JAX's weights after the train page.  The
train page's steps after an update are held at 1e-3: Adam's first update
is close to lr * sqrt(1000) * sign(g), and where g is near 0 the two sum
orders can give it other signs (tests/test_torch_nn_models.py bounds how
many), so each later loss moves a little (measured: at most 3.9e-4, on
TRAIN_ALL's third Char line, whose crop equals JAX's within 3.6e-7).
From the port's own weights the test page's Char losses in TRAIN_ALL
differ by up to 0.7 %: every upstream model's flipped elements move the
predicted crops the Char model reads.  No crop or line count differs:
no threshold flipped on these windows."""

import json

import numpy as np
import pytest

from univer_ocr_tpu import interpreter as jinterp
from univer_ocr_tpu.models import model as jmodel
from univer_ocr_tpu.nn.optimizers import Adam as JAdam
from univer_ocr_tpu_torch import interpreter as tinterp
from univer_ocr_tpu_torch.models import model as tmodel
from univer_ocr_tpu_torch.models.bucketing import (CHAR_FIXED_WIDTH,
                                                   CHAR_INPUT_HEIGHT,
                                                   make_divisible_by)
from univer_ocr_tpu_torch.models.constants import (LAYER_NAMES_PLAIN,
                                                   TRAIN_FIXTURE)
from univer_ocr_tpu_torch.models.datasets import (ArrayDataset, Dataset,
                                                  load_page_arrays)
from univer_ocr_tpu_torch.models.train import main as train_main
from univer_ocr_tpu_torch.models.train import train_model
from univer_ocr_tpu_torch.nn.optimizers import Adam as TAdam
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

#: a window of the fixture pages holding two whole paragraphs and parts
#: of two more on page 0
WINDOW = (slice(72, 200), slice(80, 400))
SHAPE = (1, 128, 320, 1)
LR = 1e-3


@pytest.fixture(scope='module')
def weights():
    with open(DEFAULT_CHECKPOINT) as fp:
        return json.load(fp)


@pytest.fixture(scope='module')
def windows():
    with np.load(TRAIN_FIXTURE) as f:
        pages = np.concatenate([f['train'], f['validation']])
    return ArrayDataset(pages[:, WINDOW[0], WINDOW[1]], LAYER_NAMES_PLAIN)


def _exactly_equal(got, exp, path='result'):
    if isinstance(exp, list):
        assert isinstance(got, list) and len(got) == len(exp), path
        for i, (g, e) in enumerate(zip(got, exp)):
            _exactly_equal(g, e, f'{path}[{i}]')
        return
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.dtype == exp.dtype and got.shape == exp.shape, path
    np.testing.assert_array_equal(got, exp, err_msg=path)


def test_crop_components_equal_jax_exactly():
    """ParagraphCrop (label, crop, deskew, /16 padding), LineCrop (band
    planning, rotation, zoom to 32 rows) and CharLabel (bit-plane votes)
    on a whole fixture page give the JAX package's arrays exactly."""
    train, _ = load_page_arrays()
    page = train.get(0)
    arrays = [page['monochrome'], page['line'], page['char']]
    with tinterp.CropAndRotateParagraphs(4) as crop:
        got = crop(page['paragraph'], arrays)
    exp = jinterp.CropAndRotateParagraphs(4)(page['paragraph'], arrays)
    assert len(exp[0]) == 11
    _exactly_equal(got, exp)
    mono, line, char = ([make_divisible_by(t, 16, 16) for t in kind]
                        for kind in got)
    with tinterp.CropRotateAndZoomLines(4, CHAR_INPUT_HEIGHT,
                                        CHAR_FIXED_WIDTH) as crop:
        got_lines = crop(line, [mono, char])
    exp_lines = jinterp.CropRotateAndZoomLines(
        4, CHAR_INPUT_HEIGHT, CHAR_FIXED_WIDTH)(line, [mono, char])
    assert sum(len(p) for p in exp_lines[0]) == 16
    _exactly_equal(got_lines, exp_lines)
    with tinterp.LabelChar(4) as label:
        got_labels = label(got_lines[1])
    _exactly_equal(got_labels, jinterp.LabelChar(4)(exp_lines[1]))


def _relative(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-12)


MODES = ['TRAIN_MONOCHROME', 'TRAIN_PARAGRAPH', 'TRAIN_LINE', 'TRAIN_CHAR',
         'TRAIN_ALL']


@pytest.mark.parametrize('mode', MODES)
def test_model_system_mode_matches_jax(mode, weights, windows):
    """One train step (page 0) and one test step (page 1) of the mode's
    model system: the component names, the context's keys, the loss
    structure (models, keys, one loss per crop or line) and the losses
    against JAX's."""
    t_sys, t_models, t_names = tmodel.make_model_system(
        SHAPE, TAdam(lr=LR), weights=weights, mode=getattr(tmodel.Modes, mode),
        device='cpu')
    j_sys, j_models, j_names = jmodel.make_model_system(
        SHAPE, JAdam(lr=LR), weights=weights,
        mode=getattr(jmodel.Modes, mode))
    assert t_names == j_names and list(t_models) == list(j_models)
    t_make = tmodel.make_context_maker(getattr(tmodel.Modes, mode), 'cpu')
    j_make = jmodel.make_context_maker(getattr(jmodel.Modes, mode))
    for page, phase in ((0, 'train'), (1, 'test')):
        t_ctx, j_ctx = t_make(windows.get, (page,)), j_make(windows.get,
                                                          (page,))
        getattr(t_sys, phase)(t_ctx)
        getattr(j_sys, phase)(j_ctx)
        assert sorted(t_ctx) == sorted(j_ctx)
        assert list(t_ctx['losses']) == list(j_ctx['losses'])
        for name, j_loss in j_ctx['losses'].items():
            t_loss = t_ctx['losses'][name]
            assert sorted(t_loss) == sorted(j_loss)
            t_out, j_out = t_loss['output_losses'], j_loss['output_losses']
            assert len(t_out) == len(j_out) > 0, (name, page)
            if phase == 'train':
                assert _relative(t_out[0], j_out[0]) <= 1e-5, name
                assert _relative(t_loss['regularization_loss'],
                                 j_loss['regularization_loss']) <= 1e-3
                assert _relative(t_out, j_out).max() <= 1e-3, name
            else:
                assert _relative(t_out, j_out).max() <= 1e-5, (name, t_out,
                                                               j_out)
        if 'cropped_2_monochrome_cpu' in j_ctx:
            assert ([len(p) for p in t_ctx['cropped_2_monochrome_cpu']]
                    == [len(p) for p in j_ctx['cropped_2_monochrome_cpu']])
        for name, model in t_models.items():
            model.set_weights(j_models[name].get_weights())


def test_train_model_writes_a_checkpoint_jax_reads(tmp_path, weights,
                                                   windows):
    """The training CLI (train_model over the whole curriculum) for one
    epoch per stage on a .npz of windows (2 to train, 1 to validate):
    finite best losses, and its checkpoint, written where the caller says,
    holds the committed checkpoint's 18 entries with their shapes and
    loads into JAX's models, whose forward then equals the port's."""
    data = tmp_path / 'windows.npz'
    np.savez_compressed(data, train=windows.layers[:2],
                        validation=windows.layers[2:],
                        layer_names=np.array(json.dumps(LAYER_NAMES_PLAIN)))
    out = tmp_path / 'trained.json'
    results = train_main(['--cpu', '--data', str(data), '--weights-out',
                          str(out), '--epochs', '1', '--seed', '3'])
    assert [r['mode'] for r in results] == MODES
    assert len(results[0]['orders']) == 2      # one train, one validation
    for r in results:
        assert r['rollbacks'] == 0
        for losses in r['best_losses'].values():
            assert np.isfinite(losses).all(), r
    written = json.loads(out.read_text())
    assert {k: {p: np.asarray(v).shape for p, v in d.items()}
            for k, d in written.items()} == {
        k: {p: np.asarray(v).shape for p, v in d.items()}
        for k, d in weights.items()}
    assert written != weights
    assert json.loads(DEFAULT_CHECKPOINT.read_text()) == weights
    rs = np.random.RandomState(11)
    for name in ('monochrome', 'paragraph', 'line', 'char'):
        shape = (1, 32, 24, 1) if name == 'char' else (1, 32, 48, 1)
        jm = getattr(jmodel, f'make_{name}')(shape)
        jm.set_weights(written)
        tm = getattr(tmodel, f'make_{name}')(shape, device='cpu')
        tm.set_weights(written)
        x = rs.rand(*shape).astype(np.float32)
        np.testing.assert_allclose(tm.predict(x)[0].numpy(),
                                   np.asarray(jm.predict(x)[0]),
                                   rtol=1e-5, atol=1e-5)


def test_train_model_never_writes_the_committed_checkpoint(windows):
    with pytest.raises(ValueError, match='committed'):
        train_model(windows, windows, [], weights_out=DEFAULT_CHECKPOINT,
                    device='cpu')


def test_predict_mode_is_not_ported():
    """Modes.PREDICT, once left out, now builds JAX's whole cascade (held
    against JAX's text in tests/test_torch_predict_mode.py)."""
    _, t_models, t_names = tmodel.make_model_system(
        SHAPE, mode=tmodel.Modes.PREDICT, device='cpu')
    _, j_models, j_names = jmodel.make_model_system(SHAPE)
    assert t_names == j_names and list(t_models) == list(j_models)
    assert t_names[-1] == 'PredToText'


def test_png_dataset_equals_jax(tmp_path):
    """The PNG corpus (`{idx}_{layer}.png`, the JAX package's
    generate_data layout) reads into the arrays JAX's Dataset gives."""
    from PIL import Image
    from univer_ocr_tpu.models.datasets import Dataset as JDataset
    train, _ = load_page_arrays()
    for i, name in enumerate(LAYER_NAMES_PLAIN):
        Image.fromarray(train.layers[1, 100:180, 200:360, i]).save(
            tmp_path / f'0_{name}.png')
    tags = ['image', 'line', 'char']
    got = Dataset(1, tmp_path).get(0, layer_tags=tags)
    exp = JDataset(1, tmp_path).get(0, layer_tags=tags)
    assert sorted(got) == sorted(exp) == sorted(tags)
    for tag in tags:
        assert got[tag].dtype == exp[tag].dtype == np.float64
        np.testing.assert_array_equal(got[tag], exp[tag])
