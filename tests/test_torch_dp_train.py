"""The batched trainer (univer_ocr_tpu_torch.models.dp_train) against the
JAX package's (univer_ocr_tpu/models/dp_train.py), in float32 on the CPU:
the cases of tests/test_dp_train.py on the port, and each function held
against its JAX twin on the same inputs.

Bars: make_batches and the ground-truth samples equal exactly; the
predicted-crop samples have JAX's counts, shapes and labels, and their
inputs are within 1e-6 of JAX's but for at most STEP_SHARE of the pixels,
which may be one uint8 step (1/255) away: serving quantizes the
monochrome map to uint8, and a float32 sum in another order moves a
value sitting on a rounding boundary by one step (measured: 1 to 6
pixels of 1.3e5 to 5e5, in both precisions); one batched step's
per-sample losses and updated parameters within 1e-5 of JAX's.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from univer_ocr_tpu.models import dp_train as jdp
from univer_ocr_tpu.models import model as jmodel
from univer_ocr_tpu.models.fastpath import masked_char_loss as j_char_loss
from univer_ocr_tpu.models.pipeline import OCRPipeline as JPipeline
from univer_ocr_tpu.nn.optimizers import Adam as JAdam
from univer_ocr_tpu_torch.models import dp_train as tdp
from univer_ocr_tpu_torch.models import model as tmodel
from univer_ocr_tpu_torch.models.constants import (LAYER_NAMES_PLAIN,
                                                   TRAIN_FIXTURE)
from univer_ocr_tpu_torch.models.datasets import ArrayDataset
from univer_ocr_tpu_torch.models.fastpath import (_mask_hw,
                                                  line_forward_masked)
from univer_ocr_tpu_torch.models.pipeline import OCRPipeline as TPipeline
from univer_ocr_tpu_torch.models.train import train_model
from univer_ocr_tpu_torch.nn.models import value_and_grad
from univer_ocr_tpu_torch.nn.optimizers import Adam as TAdam
from univer_ocr_tpu_torch.ops.losses import segmentation_dice_2d
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

SHAPE = (1, 64, 64, 1)
LR = 1e-3
#: a window of fixture page 0 holding four paragraphs (whole or cut)
WINDOW = (slice(80, 208), slice(32, 672))
MODES = ['TRAIN_MONOCHROME', 'TRAIN_PARAGRAPH', 'TRAIN_LINE', 'TRAIN_CHAR']
FACTORY = {'Monochrome': 'make_monochrome', 'Paragraph': 'make_paragraph',
           'Line': 'make_line'}


@pytest.fixture(scope='module')
def weights():
    with open(DEFAULT_CHECKPOINT) as fp:
        return json.load(fp)


@pytest.fixture(scope='module')
def pages():
    with np.load(TRAIN_FIXTURE) as f:
        return np.concatenate([f['train'], f['validation']])


def _tensors(*arrays):
    return [torch.from_numpy(a) if a.dtype == np.float32
            else torch.from_numpy(a).to(torch.int64) for a in arrays]


def _seg_batch(rs, B=4, hb=64, wb=64, c_y=2):
    X = rs.rand(B, hb, wb, 1).astype(np.float32)
    y = (rs.rand(B, hb, wb, c_y) > 0.7).astype(np.float32)
    hv = np.array([32, 48, 64, 16][:B], np.int32)
    wv = np.array([64, 32, 48, 16][:B], np.int32)
    for b in range(B):                       # the padding contract
        X[b, hv[b]:, :, :] = 0
        X[b, :, wv[b]:, :] = 0
        y[b, hv[b]:, :, :] = 0
        y[b, :, wv[b]:, :] = 0
    weight = np.array([1, 1, 1, 0][:B], np.float32)
    return X, y, hv, wv, weight


def _char_batch(rs, B=4, wb=128, n=162):
    X = rs.rand(B, 32, wb, 1).astype(np.float32)
    y = np.zeros((B, wb, n), np.float32)
    for b in range(B):
        for col in range(0, 100, 3):
            y[b, col, rs.randint(1, n)] = 1.0
    wv = np.array([100, 64, 80, 8], np.int32)
    for b in range(B):
        X[b, :, wv[b]:, :] = 0
        y[b, wv[b]:, :] = 0
    return X, y, wv, np.array([1, 1, 1, 0], np.float32)


def _models(name, shape=SHAPE):
    """A JAX model and the port's twin with its weights."""
    factory = FACTORY.get(name, 'make_char')
    jm = getattr(jmodel, factory)(shape, optimizer=JAdam(lr=LR))
    tm = getattr(tmodel, factory)(shape, optimizer=TAdam(lr=LR),
                                  device='cpu')
    tm.set_weights(jm.get_weights())
    return jm, tm


def _assert_params_close(got, exp, rtol=1e-5, atol=1e-7):
    assert sorted(got) == sorted(exp)
    for name in exp:
        for k in exp[name]:
            np.testing.assert_allclose(got[name][k].numpy(),
                                       np.asarray(exp[name][k]), rtol=rtol,
                                       atol=atol, err_msg=f'{name}/{k}')


def test_batched_seg_step_equals_accumulated_per_sample():
    """One batched step applies the mean of the per-sample gradients (the
    filler excluded) plus the regularization's once."""
    rs = np.random.RandomState(0)
    model = tmodel.make_line(SHAPE, optimizer=TAdam(lr=LR), device='cpu')
    params = model.params
    opt = model._optimizer()
    batch = _seg_batch(rs)
    X, y, hv, wv, weight = _tensors(*batch)

    train_step, _ = tdp.make_batched_seg_step(model, 'Line')
    new_params, _, per = train_step(params, opt.init_state(params), LR,
                                    X, y, hv, wv, weight)

    def sample_loss(p, i):
        pred = line_forward_masked(p, X[i:i + 1], int(hv[i]), int(wv[i]))
        pred = _mask_hw(pred, int(hv[i]), int(wv[i]))
        return segmentation_dice_2d(pred, y[i:i + 1]), None

    grads = None
    for i in range(3):                        # weight[3] == 0
        _, _, g = value_and_grad(sample_loss, params, list(params), i)
        grads = g if grads is None else {
            n: {k: grads[n][k] + g[n][k] for k in g[n]} for n in g}
    _, _, reg_g = value_and_grad(
        lambda p: (model.regularization_fn(p), None), params, list(params))
    grads = {n: {k: grads[n][k] / 3.0 + reg_g[n][k] for k in grads[n]}
             for n in grads}
    with torch.no_grad():
        expected, _ = opt.update(params, grads, opt.init_state(params), LR)
    _assert_params_close(new_params, {n: {k: v.numpy() for k, v in d.items()}
                                      for n, d in expected.items()},
                         atol=1e-7)
    assert float(per[3]) == 0.0


@pytest.mark.parametrize('name', ['Monochrome', 'Paragraph', 'Line'])
def test_batched_seg_step_matches_jax(name):
    """One train step of the same weights on the same batch: per-sample
    losses and updated parameters within 1e-5 of JAX's; the eval step's
    losses too."""
    rs = np.random.RandomState(1)
    jm, tm = _models(name)
    c_y = 1 if name in ('Monochrome', 'Paragraph') else 2
    batch = _seg_batch(rs, c_y=c_y)
    if name == 'Monochrome':                  # whole pages: no padding
        batch = (batch[0], batch[1], np.full(4, 64, np.int32),
                 np.full(4, 64, np.int32), batch[4])
    j_train, j_eval = jdp.make_batched_seg_step(jm, name, donate=False)
    j_params, _, j_per = j_train(
        jm.params, jm._optimizer().init_state(jm.params), jnp.float32(LR),
        *batch)
    t_train, t_eval = tdp.make_batched_seg_step(tm, name)
    t_params, _, t_per = t_train(
        tm.params, tm._optimizer().init_state(tm.params), LR,
        *_tensors(*batch))
    np.testing.assert_allclose(t_per.numpy(), np.asarray(j_per), rtol=1e-5)
    assert float(t_per[3]) == 0.0
    _assert_params_close(t_params, j_params)
    np.testing.assert_allclose(t_eval(tm.params, *_tensors(*batch)).numpy(),
                               np.asarray(j_eval(jm.params, *batch)),
                               rtol=1e-5)


def test_batched_char_step_matches_jax():
    """The Char step: per-sample losses (the filler's 0) and updated
    parameters within 1e-5 of JAX's, each loss JAX's per-line masked
    loss."""
    rs = np.random.RandomState(2)
    jm, tm = _models('Char')
    batch = _char_batch(rs)
    j_train, _ = jdp.make_batched_char_step(jm, donate=False)
    j_params, _, j_per = j_train(
        jm.params, jm._optimizer().init_state(jm.params), jnp.float32(LR),
        *batch)
    t_train, _ = tdp.make_batched_char_step(tm)
    t_params, _, t_per = t_train(
        tm.params, tm._optimizer().init_state(tm.params), LR,
        *_tensors(*batch))
    t_per = t_per.numpy()
    assert t_per[3] == 0.0 and (t_per[:3] > 0).all()
    np.testing.assert_allclose(t_per, np.asarray(j_per), rtol=1e-5)
    _assert_params_close(t_params, j_params, atol=1e-6)
    X, y, wv, _ = batch
    _, (l0, _, _) = j_char_loss(jm.params, X[0:1], y[0], int(wv[0]))
    np.testing.assert_allclose(t_per[0], float(l0), rtol=1e-5)


def test_filler_slots_add_no_gradient():
    """A weight-0 slot's content does not move the update."""
    rs = np.random.RandomState(4)
    _, tm = _models('Line')
    X, y, hv, wv, weight = _seg_batch(rs)
    train_step, _ = tdp.make_batched_seg_step(tm, 'Line')
    state = tm._optimizer().init_state(tm.params)
    a, _, _ = train_step(tm.params, state, LR,
                         *_tensors(X, y, hv, wv, weight))
    X2, y2 = X.copy(), y.copy()
    X2[3] = rs.rand(*X2[3].shape)
    y2[3] = 1.0
    hv2, wv2 = hv.copy(), wv.copy()
    hv2[3], wv2[3] = 64, 64
    b, _, _ = train_step(tm.params, state, LR,
                         *_tensors(X2, y2, hv2, wv2, weight))
    for name in a:
        for k in a[name]:
            torch.testing.assert_close(a[name][k], b[name][k], rtol=0,
                                       atol=0)


@pytest.mark.parametrize('mode', MODES)
def test_make_batches_equal_jax(mode):
    """Bucketing, the shuffle (np.random.RandomState) and the filler
    slots give JAX's arrays exactly."""
    rs = np.random.RandomState(3)
    if mode == 'TRAIN_CHAR':
        samples = [(rs.rand(1, 32, w, 1).astype(np.float32),
                    rs.rand(w, 162).astype(np.float32))
                   for w in (40, 300, 600, 250, 1100, 90, 520)]
    elif mode == 'TRAIN_LINE':
        samples = [(rs.rand(1, h, w, 1).astype(np.float32),
                    rs.rand(1, h, w, 2).astype(np.float32))
                   for h, w in ((40, 100), (200, 300), (48, 240),
                                (300, 700), (64, 64))]
    else:
        samples = [(rs.rand(1, 48, 80, 1).astype(np.float32),
                    rs.rand(1, 48, 80, 1).astype(np.float32))
                   for _ in range(5)]
    got = tdp.make_batches(samples, tmodel.Modes[mode], 4,
                           np.random.RandomState(7))
    exp = jdp.make_batches(samples, jmodel.Modes[mode], 4,
                           np.random.RandomState(7))
    assert len(got) == len(exp) > 1
    for g, e in zip(got, exp):
        assert len(g) == len(e)
        for a, b in zip(g, e):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('mode', MODES)
def test_ground_truth_samples_equal_jax(mode, pages):
    """collect_stage_samples on a fixture page gives JAX's samples
    exactly (Char with two jittered copies of every line)."""
    ds = ArrayDataset(pages[:1], LAYER_NAMES_PLAIN)
    aug = 2 if mode == 'TRAIN_CHAR' else 0
    got = tdp.collect_stage_samples(tmodel.Modes[mode], ds, workers=4,
                                    char_augment=aug, seed=3)
    exp = jdp.collect_stage_samples(jmodel.Modes[mode], ds, workers=4,
                                    char_augment=aug, seed=3)
    assert len(got) == len(exp) > 0
    for (gx, gy), (ex, ey) in zip(got, exp):
        for a, b in ((gx, ex), (gy, ey)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


#: share of a stage's predicted-crop pixels that may sit one uint8 step
#: from JAX's (measured: at most 1.5e-5)
STEP_SHARE = 1e-4


@pytest.mark.parametrize('precision', ['highest', 'bf16'])
def test_predicted_samples_match_jax(precision, weights, pages):
    """collect_stage_samples_predicted of the committed checkpoint on a
    window of two fixture pages, through a pipeline of each package
    shared by its Line and Char builds: JAX's sample counts and shapes;
    the labels equal; the inputs within 1e-6 but for STEP_SHARE of the
    pixels, one uint8 step away."""
    window = pages[:2, WINDOW[0], WINDOW[1]]
    ds = ArrayDataset(window, LAYER_NAMES_PLAIN)
    shape = (1,) + window.shape[1:3] + (1,)
    quiet = lambda *a: None
    j_pipe = JPipeline(shape, weights=weights, chunk=2, workers=4,
                       precision=precision)
    with TPipeline(shape, weights=weights, chunk=2, workers=4,
                   precision=precision, device='cpu') as t_pipe:
        for mode in ('TRAIN_LINE', 'TRAIN_CHAR'):
            got = tdp.collect_stage_samples_predicted(
                tmodel.Modes[mode], ds, weights, input_shape=shape,
                pipeline=t_pipe, log=quiet)
            exp = jdp.collect_stage_samples_predicted(
                jmodel.Modes[mode], ds, weights, input_shape=shape,
                pipeline=j_pipe, log=quiet)
            assert len(got) == len(exp) > 0, mode
            stepped = total = 0
            for (gx, gy), (ex, ey) in zip(got, exp):
                assert gx.shape == ex.shape and gy.shape == ey.shape
                np.testing.assert_array_equal(gy, ey)
                diff = np.abs(gx - ex)
                assert diff.max() <= 1 / 255 + 1e-6, mode
                stepped += np.count_nonzero(diff > 1e-6)
                total += diff.size
            assert stepped <= STEP_SHARE * total, (mode, stepped, total)


def _mesh_runs(entry, pages, weights, tmp_path, mesh):
    """One entry of the batched trainer on the Line stage: per-sample
    losses and params ('steps'), or the best validation loss and the
    trained Line weights."""
    quiet = lambda *a: None
    if entry == 'steps':
        tm = tmodel.make_line(SHAPE, optimizer=TAdam(lr=LR), device='cpu')
        tm.set_weights(weights)
        train_step, _ = tdp.make_batched_seg_step(tm, 'Line', mesh=mesh)
        params, _, per = train_step(
            tm.params, tm._optimizer().init_state(tm.params), LR,
            *_tensors(*_seg_batch(np.random.RandomState(5))))
        return per, params
    if entry == 'stage':
        samples = _line_samples(pages)
        model, best = tdp.train_stage_batched(
            tmodel.Modes.TRAIN_LINE, samples, samples[:2], weights, 1, LR,
            0.9, batch=4, mesh=mesh, input_shape=(1, 256, 384, 1),
            log=quiet, device='cpu')
        return torch.tensor(best), model.params
    window = pages[:, WINDOW[0], WINDOW[1]]
    train = ArrayDataset(window[:2], LAYER_NAMES_PLAIN)
    validation = ArrayDataset(window[2:], LAYER_NAMES_PLAIN)
    out = tmp_path / f'{entry}_{mesh is not None}.json'
    stage = [(tmodel.Modes.TRAIN_LINE, LR, 0.9, 1)]
    if entry == 'curriculum':
        out.write_text(json.dumps(weights))
        results = tdp.train_model_batched(
            stage, train, validation, batch=4, mesh=mesh, train_size=2,
            val_size=1, log=quiet, checkpoint_path=out, device='cpu')
    else:
        from univer_ocr_tpu_torch.models.train import TrainReporter

        class Quiet:
            def emit(self, event, payload):
                pass
        results = train_model(train, validation, stage, train_size=2,
                              val_size=1, weights_out=out, device='cpu',
                              batched=True, batch=4, mesh=mesh,
                              reporter=TrainReporter(sink=Quiet()))
    trained = json.loads(out.read_text())
    return (torch.tensor(results[0]['best_losses']['Line']),
            {name: {k: torch.tensor(v) for k, v in entry.items()}
             for name, entry in trained.items() if name.startswith('Line')})


@pytest.mark.parametrize('entry', ['steps', 'stage', 'curriculum',
                                   'train_model'])
def test_mesh_entries_accept_a_mesh(entry, tmp_path, pages, weights):
    """Each entry of the batched trainer under a 2-shard CPU mesh
    (parallel.make_mesh(devices=[cpu] * 2)) gives the unsharded run's
    losses and Line weights within 1e-5 (the batch splits over the
    shards; the gradients sum in shard order)."""
    from univer_ocr_tpu_torch.parallel import make_mesh
    mesh = make_mesh(devices=[torch.device('cpu')] * 2)
    loss, params = _mesh_runs(entry, pages, weights, tmp_path, mesh)
    loss_1, params_1 = _mesh_runs(entry, pages, weights, tmp_path, None)
    torch.testing.assert_close(loss, loss_1, rtol=1e-5, atol=1e-6)
    assert sorted(params) == sorted(params_1) and params
    for name in params_1:
        for k in params_1[name]:
            torch.testing.assert_close(params[name][k], params_1[name][k],
                                       rtol=1e-5, atol=1e-6)


def _line_samples(pages, n=4):
    ds = ArrayDataset(pages[:1, :256, :384], LAYER_NAMES_PLAIN)
    return tdp.collect_stage_samples(tmodel.Modes.TRAIN_LINE, ds)[:n]


def test_stage_reduces_loss(pages):
    """Ground-truth Line samples of a fixture window, 3 batched epochs
    from random weights: the best validation loss drops below the
    initial one."""
    samples = _line_samples(pages)
    kwargs = dict(lr=3e-3, lr_step=0.995, batch=4,
                  input_shape=(1, 256, 384, 1), log=lambda *a: None,
                  device='cpu')
    _, best = tdp.train_stage_batched(tmodel.Modes.TRAIN_LINE, samples,
                                      samples[:2], {}, epochs=3, **kwargs)
    _, init = tdp.train_stage_batched(tmodel.Modes.TRAIN_LINE, samples,
                                      samples[:2], {}, epochs=0, **kwargs)
    assert best < init


def test_nan_epoch_rolls_back_and_reinits_adam(pages, monkeypatch):
    """An epoch whose update leaves a NaN weight is redone from the last
    weights with lr * lr_step and Adam's state made anew (JAX's batched
    rollback), then ends clean."""
    samples = _line_samples(pages)
    calls, logs = [], []
    make = tdp.make_batched_seg_step

    def make_nan_once(model, prefix, mesh=None):
        train, evaluate = make(model, prefix, mesh)

        def train_once(params, opt_state, lr, *batch):
            calls.append((params, opt_state, lr))
            new_params, new_state, per = train(params, opt_state, lr,
                                               *batch)
            if len(calls) == 1:
                layer = next(iter(new_params))
                new_params[layer]['w'] = new_params[layer]['w'] * np.nan
            return new_params, new_state, per
        return train_once, evaluate

    monkeypatch.setattr(tdp, 'make_batched_seg_step', make_nan_once)
    model, best = tdp.train_stage_batched(
        tmodel.Modes.TRAIN_LINE, samples, samples[:2], {}, epochs=1,
        lr=1e-3, lr_step=0.5, batch=4, input_shape=(1, 256, 384, 1),
        log=logs.append, device='cpu')
    # two batches (two bucket shapes) an epoch, the first epoch redone
    assert len(calls) == 4
    assert any('NaN epoch, rolled back; lr -> 0.0005' in l for l in logs)
    (p0, s0, lr0), (p1, s1, lr1) = calls[0], calls[2]
    assert (lr0, lr1) == (1e-3, 5e-4)
    for name in p0:
        for k in p0[name]:
            torch.testing.assert_close(p1[name][k], p0[name][k], rtol=0,
                                       atol=0)
            for slot in s1[name][k].values():
                assert not slot.any()
    assert np.isfinite(best)
    assert not model.nan_weights()


def test_train_model_batched_curriculum_writes_only_through_gate(
        tmp_path, weights, pages, monkeypatch):
    """The training CLI with --batched --predicted --eval-gate over the
    curriculum, 1 epoch a stage, on a .npz of fixture windows: the gate's
    scoring replaced by a fixed sequence (incumbent 0.5; Monochrome 0.4,
    rejected; Paragraph 0.6, approved; Line 0.55 and Char 0.59, rejected
    below the ratcheted 0.6; TRAIN_ALL 0.7, approved).  weights_out is
    written once at the start (weights_in's) and then only on the two
    approvals."""
    from univer_ocr_tpu_torch.models import evaluation
    from univer_ocr_tpu_torch.models import train as train_module
    from univer_ocr_tpu_torch.models.train import main as train_main
    window = pages[:, WINDOW[0], WINDOW[1]]
    data = tmp_path / 'windows.npz'
    np.savez_compressed(data, train=window[:2], validation=window[2:],
                        layer_names=np.array(json.dumps(LAYER_NAMES_PLAIN)))
    out = tmp_path / 'trained.json'
    scores = iter([0.5, 0.4, 0.6, 0.55, 0.59, 0.7])
    seen = []

    def score(candidate, eval_pages, truths, **kwargs):
        seen.append(out.read_bytes())
        return {'concat': next(scores)}

    monkeypatch.setattr(evaluation, 'score_weights', score)
    writes = []
    save, write = tdp.save_weights, train_module.write_weights
    monkeypatch.setattr(tdp, 'save_weights', lambda models, path: (
        writes.append(sorted(models)), save(models, path)))
    monkeypatch.setattr(train_module, 'write_weights', lambda w, path: (
        writes.append('all'), write(w, path)))
    results = train_main(['--cpu', '--data', str(data), '--weights-out',
                          str(out), '--epochs', '1', '--batched',
                          '--predicted', '--eval-gate'])
    assert [r['mode'] for r in results] == [
        'TRAIN_MONOCHROME', 'TRAIN_PARAGRAPH', 'TRAIN_LINE', 'TRAIN_CHAR',
        'TRAIN_ALL']
    assert all(r['samples'][0] > 0 and r['samples'][1] > 0
               for r in results[:4])
    assert len(seen) == 6
    assert writes == ['all', ['Paragraph'], 'all']
    # the incumbent, Monochrome and Paragraph see weights_in; Line, Char
    # and TRAIN_ALL the file Paragraph's approval wrote
    assert json.loads(seen[0]) == weights
    assert seen[0] == seen[1] == seen[2]
    assert seen[3] == seen[4] == seen[5]
    assert sorted(json.loads(out.read_bytes())) == sorted(weights)


def test_tf32_switches_in_steps_and_sample_front(pages, monkeypatch,
                                                   tmp_path):
    """train_model holds TF32 off ('highest') for the steps; the
    predicted samples' front and Line stage run in their pipeline's
    precision ('bf16': TF32 on) and give the switches back after."""
    from univer_ocr_tpu_torch.models import train as train_module
    seen = {}

    def flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    def spy(where, fn):
        def wrapped(*args, **kwargs):
            seen.setdefault(where, set()).add(flags())
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tdp, 'line_forward_masked',
                        spy('step', tdp.line_forward_masked))
    monkeypatch.setattr(TPipeline, 'front', spy('front', TPipeline.front))
    monkeypatch.setattr(TPipeline, '_run_line_batched',
                        spy('line', TPipeline._run_line_batched))
    window = pages[:, WINDOW[0], WINDOW[1]]
    train = ArrayDataset(window[:2], LAYER_NAMES_PLAIN)
    validation = ArrayDataset(window[2:], LAYER_NAMES_PLAIN)
    saved = flags()
    train_module.train_model(
        train, validation, [(tmodel.Modes.TRAIN_LINE, LR, 0.9, 1),
                            (tmodel.Modes.TRAIN_CHAR, LR, 0.9, 1)],
        train_size=2, val_size=1, weights_out=tmp_path / 'w.json',
        device='cpu', batched=True, predicted=True,
        reporter=train_module.TrainReporter())
    assert seen == {'step': {(False, False)}, 'front': {(True, True)},
                    'line': {(True, True)}}
    assert flags() == saved
