"""The port's mesh (univer_ocr_tpu_torch.parallel) on the CPU: meshes
over `[torch.device('cpu')] * k`, each held against the JAX package's
parallel/ on the conftest's 8 virtual devices and against the port's
unsharded steps, on inputs drawn from numpy seeds (float32: the conftest
turns JAX's x64 on).

Bars: the DP step's output loss within rtol 1e-5 of JAX's and its
parameters within rtol 1e-4 / atol 1e-6 (tests/test_parallel.py's bars);
the TP Char step, the batched steps under a mesh and the DP step against
the port's unsharded steps within rtol 1e-5 / atol 1e-6
(tests/test_dp_train.py's); the per-shard fused payload merge exactly
JAX's; train_model and the curriculum driver over a 2-shard mesh run
and write their weights."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from univer_ocr_tpu.models import dp_train as jdp
from univer_ocr_tpu.models import model as jmodel
from univer_ocr_tpu.nn.optimizers import Adam as JAdam
from univer_ocr_tpu.parallel import make_dp_train_step as jax_dp_step
from univer_ocr_tpu.parallel import make_tp_char_train_step as jax_tp_step
from univer_ocr_tpu.parallel import shard_batch as jax_shard_batch
from univer_ocr_tpu.parallel.data_parallel import replicate as jax_replicate
from univer_ocr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from univer_ocr_tpu_torch import train_driver
from univer_ocr_tpu_torch.models import dp_train as tdp
from univer_ocr_tpu_torch.models import fused_tail as tft
from univer_ocr_tpu_torch.models import model as tmodel
from univer_ocr_tpu_torch.models.constants import TRAIN_FIXTURE
from univer_ocr_tpu_torch.models.datasets import load_page_arrays
from univer_ocr_tpu_torch.models.train import TrainReporter, train_model
from univer_ocr_tpu_torch.nn.models import value_and_grad
from univer_ocr_tpu_torch.nn.optimizers import Adam as TAdam
from univer_ocr_tpu_torch.parallel import (make_dp_train_step, make_mesh,
                                           make_tp_char_train_step,
                                           shard_batch)
from univer_ocr_tpu_torch.parallel.data_parallel import (ColumnShards,
                                                         replicate)
from univer_ocr_tpu_torch.primitives import CHARS

CPU = torch.device('cpu')
LR = 1e-3
FACTORY = {'Monochrome': 'make_monochrome', 'Line': 'make_line',
           'Char': 'make_char'}


def _cpu_mesh(n, model_parallel=1):
    return make_mesh(devices=[CPU] * n, model_parallel=model_parallel)


def _models(name, shape):
    """A JAX model and the port's twin with its weights."""
    jm = getattr(jmodel, FACTORY[name])(shape, optimizer=JAdam(lr=LR))
    tm = getattr(tmodel, FACTORY[name])(shape, optimizer=TAdam(lr=LR),
                                        device='cpu')
    tm.set_weights(jm.get_weights())
    return jm, tm


def _whole(v):
    return v.full(CPU) if isinstance(v, ColumnShards) else v


def _assert_close(got, exp, rtol, atol):
    assert sorted(got) == sorted(exp)
    for name in exp:
        for k in exp[name]:
            np.testing.assert_allclose(
                _whole(got[name][k]).numpy(), np.asarray(exp[name][k]),
                rtol=rtol, atol=atol, err_msg=f'{name}/{k}')


#: an Adam step's gradient, read from its first velocities (1 - beta1) g
#: (the moments start at 0), is held by its 2-norm within this of the
#: other step's
GRAD_RTOL = 1e-5
#: an element whose |g| is within this share of its tensor's largest |g|
#: sums to about 0 in float32: Adam's first update, lr * 0.1 g /
#: (sqrt(0.001) |g| + 1e-8), turns the sum order's noise there into
#: differences of 1e-6 and more, so its update is held through the
#: gradient's 2-norm instead of elementwise
GRAD_NOISE = 1e-5


def _gradients(state):
    """{name: {param: g}} of an Adam state after one step from zero
    moments."""
    return {name: {k: np.asarray(_whole(s['velocity'])) / 0.1
                   for k, s in layer.items()}
            for name, layer in state.items()}


def _assert_adam_step_close(got, got_state, exp, exp_state, rtol, atol):
    """Two first Adam steps from the same parameters: the whole gradient
    within GRAD_RTOL of the expected one by the 2-norm, and the updated
    parameters within rtol / atol at every element whose expected
    gradient is exactly 0 or not within GRAD_NOISE of 0."""
    assert sorted(got) == sorted(exp)
    g_got, g_exp = _gradients(got_state), _gradients(exp_state)
    diff = np.sqrt(sum(np.sum((g_got[n][k].astype(np.float64)
                               - g_exp[n][k]) ** 2)
                       for n in g_exp for k in g_exp[n]))
    norm = np.sqrt(sum(np.sum(g_exp[n][k].astype(np.float64) ** 2)
                       for n in g_exp for k in g_exp[n]))
    assert diff <= GRAD_RTOL * norm, (diff, norm)
    for name in exp:
        for k in exp[name]:
            g = np.abs(g_exp[name][k])
            held = (g == 0) | (g > GRAD_NOISE * g.max())
            np.testing.assert_allclose(
                np.asarray(_whole(got[name][k]))[held],
                np.asarray(exp[name][k])[held], rtol=rtol, atol=atol,
                err_msg=f'{name}/{k}')


def _unsharded_step(tm, X, y):
    """The port's one-device step on the whole batch."""
    params = tm.params
    opt = tm._optimizer()
    _, (losses, _, _), grads = value_and_grad(
        tm.loss_fn, params, list(params), [torch.from_numpy(X)],
        [torch.from_numpy(y)])
    with torch.no_grad():
        new, _ = opt.update(params, grads, opt.init_state(params), LR)
    return new, losses


def test_mesh_shape(monkeypatch):
    mesh = _cpu_mesh(8, model_parallel=2)
    assert mesh.shape == {'data': 4, 'model': 2} == dict(
        jax_make_mesh(8, model_parallel=2).shape)
    assert mesh.data_devices() == [CPU] * 4
    assert mesh.model_devices() == [CPU] * 2
    assert make_mesh(2, devices=[CPU] * 4).shape == {'data': 2, 'model': 1}
    with pytest.raises(RuntimeError, match='2 are available'):
        make_mesh(4, devices=[CPU] * 2)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='is_available'):
        make_mesh()


@pytest.mark.parametrize('name', ['Monochrome', 'Line'])
def test_dp_step_matches_jax_and_one_device(name):
    """DP over 4 shards (Monochrome 32x32, batch 8; tests/test_parallel.py
    runs Line over 8): the same update as JAX's DP step and as one device
    computing the whole batch (the losses are sums of per-sample ones, so
    the shards' gradients add up to the batch's)."""
    rs = np.random.RandomState(0)
    c_y = 1 if name == 'Monochrome' else 2
    X = rs.rand(8, 32, 32, 1).astype(np.float32)
    y = (rs.rand(8, 32, 32, c_y) > 0.5).astype(np.float32)
    jm, tm = _models(name, (1, 32, 32, 1))
    n_data = 4 if name == 'Monochrome' else 8

    jmesh = jax_make_mesh(n_data, model_parallel=1)
    step = jax_dp_step(jm, jmesh, donate=False)
    with jmesh:
        j_params, _, j_losses, _ = step(
            jax_replicate(jm.params, jmesh),
            jax_replicate(jm._optimizer().init_state(jm.params), jmesh),
            jnp.float32(LR), jax_shard_batch(X, jmesh),
            jax_shard_batch(y, jmesh))

    mesh = _cpu_mesh(n_data)
    opt = tm._optimizer()
    # JAX's parameters as numpy arrays become the replicas
    params, _, losses, _ = make_dp_train_step(tm, mesh)(
        replicate(jax.tree_util.tree_map(np.asarray, jm.params), mesh),
        replicate(opt.init_state(tm.params), mesh), LR,
        shard_batch(X, mesh), shard_batch(y, mesh))
    np.testing.assert_allclose(float(losses[0]), float(j_losses[0]),
                               rtol=1e-5)
    _assert_close(params, j_params, rtol=1e-4, atol=1e-6)

    single, single_losses = _unsharded_step(tm, X, y)
    np.testing.assert_allclose(float(losses[0]), float(single_losses[0]),
                               rtol=1e-5)
    _assert_close(params, {n: {k: v.numpy() for k, v in d.items()}
                           for n, d in single.items()}, rtol=1e-5,
                  atol=1e-6)


def test_tp_char_step_matches_jax_and_one_device():
    """DP x TP on a 4 x 2 mesh: dense_1 and dense_2 (and their Adam
    moments) live in 2 column blocks, one on each model device; the step
    is JAX's TP step and the port's one-device step of the whole batch."""
    rs = np.random.RandomState(2)
    X = rs.rand(8, 32, 32, 1).astype(np.float32)
    y = np.eye(len(CHARS), dtype=np.float32)[
        rs.randint(0, len(CHARS), 8 * 32)]
    jm, tm = _models('Char', (1, 496, 32, 1))
    j_step, j_place, j_place_opt = jax_tp_step(
        jm, jax_make_mesh(8, model_parallel=2))
    j_params, _, j_losses, _ = j_step(
        j_place(jm.params),
        j_place_opt(jm.params, jm._optimizer().init_state(jm.params)),
        LR, X, y)

    mesh = _cpu_mesh(8, model_parallel=2)
    step, place, place_opt = make_tp_char_train_step(tm, mesh)
    params = place(tm.params)
    state = place_opt(tm.params, tm._optimizer().init_state(tm.params))
    for layer in ('dense_1', 'dense_2'):
        w = params[f'Char/dense_block/{layer}']['w']
        assert isinstance(w, ColumnShards) and len(w.blocks) == 2
        assert [b.device for b in w.blocks] == mesh.model_devices()
        assert all(isinstance(s, ColumnShards)
                   for s in state[f'Char/dense_block/{layer}']['w'].values())
    assert isinstance(params['Char/dense_block/dense_3']['w'], torch.Tensor)
    new_params, new_state, losses, _ = step(params, state, LR, X, y)
    assert isinstance(new_params['Char/dense_block/dense_1']['w'],
                      ColumnShards)
    assert isinstance(
        new_state['Char/dense_block/dense_1']['w']['velocity'], ColumnShards)
    np.testing.assert_allclose(float(losses[0]), float(j_losses[0]),
                               rtol=1e-5)
    _assert_close(new_params, j_params, rtol=1e-5, atol=1e-6)
    single, single_losses = _unsharded_step(tm, X, y)
    np.testing.assert_allclose(float(losses[0]), float(single_losses[0]),
                               rtol=1e-5)
    _assert_close(new_params, {n: {k: v.numpy() for k, v in d.items()}
                               for n, d in single.items()},
                  rtol=1e-5, atol=1e-6)


def _seg_batch(rs, B=8, hb=64, wb=64):
    X = rs.rand(B, hb, wb, 1).astype(np.float32)
    y = (rs.rand(B, hb, wb, 2) > 0.7).astype(np.float32)
    hv = np.array([32, 48, 64, 16, 64, 32, 16, 48][:B], np.int32)
    wv = np.array([64, 32, 48, 16, 16, 64, 32, 48][:B], np.int32)
    for b in range(B):                       # the padding contract
        X[b, hv[b]:, :, :] = 0
        X[b, :, wv[b]:, :] = 0
        y[b, hv[b]:, :, :] = 0
        y[b, :, wv[b]:, :] = 0
    # the last shard holds only filler slots
    weight = np.array([1, 1, 1, 0, 1, 1, 0, 0][:B], np.float32)
    return X, y, hv, wv, weight


def _char_batch(rs, B=8, wb=128, n=162):
    X = rs.rand(B, 32, wb, 1).astype(np.float32)
    y = np.zeros((B, wb, n), np.float32)
    wv = np.array([100, 64, 80, 8, 128, 16, 40, 96][:B], np.int32)
    for b in range(B):
        for col in range(0, wv[b], 3):
            y[b, col, rs.randint(1, n)] = 1.0
        X[b, :, wv[b]:, :] = 0
    return X, y, wv, np.array([1, 1, 1, 0, 1, 1, 0, 0], np.float32)


def _tensors(*arrays):
    return [torch.from_numpy(a) if a.dtype == np.float32
            else torch.from_numpy(a).to(torch.int64) for a in arrays]


@pytest.mark.parametrize('name', ['Line', 'Char'])
def test_batched_steps_under_a_mesh(name):
    """make_batched_seg_step / make_batched_char_step over 4 shards:
    per-sample losses (fillers 0) and the update equal the port's
    unsharded step and JAX's step over its 4-device mesh; so does the
    eval step.  The update is held as _assert_adam_step_close holds it:
    the models' initial weights come from the JAX package's global init
    counter, so they depend on the layers built before this test in its
    process, and with some of them an element's gradient sums to about 0
    (1 element in 131200 of Char/dense_block/dense_2/w)."""
    rs = np.random.RandomState(1)
    jm, tm = _models(name, (1, 64, 64, 1))
    batch = _char_batch(rs) if name == 'Char' else _seg_batch(rs)
    if name == 'Char':
        j_make = lambda m=None: jdp.make_batched_char_step(
            jm, mesh=m, donate=False)
        t_make = lambda m=None: tdp.make_batched_char_step(tm, mesh=m)
    else:
        j_make = lambda m=None: jdp.make_batched_seg_step(
            jm, 'Line', mesh=m, donate=False)
        t_make = lambda m=None: tdp.make_batched_seg_step(tm, 'Line',
                                                          mesh=m)
    jmesh = JaxMesh(np.array(jax.devices()[:4]), ('data',))
    j_train, j_eval = j_make(jmesh)
    j_params, j_state, j_per = j_train(
        jm.params, jm._optimizer().init_state(jm.params), jnp.float32(LR),
        *batch)

    state = tm._optimizer().init_state(tm.params)
    single_train, single_eval = t_make()
    s_params, s_state, s_per = single_train(tm.params, state, LR,
                                            *_tensors(*batch))
    mesh = _cpu_mesh(4)
    train, evaluate = t_make(mesh)
    params, new_state, per = train(tm.params, state, LR, *_tensors(*batch))

    per = per.numpy()
    assert (per[batch[-1] == 0] == 0).all() and (per[batch[-1] > 0] > 0).all()
    np.testing.assert_allclose(per, s_per.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(per, np.asarray(j_per), rtol=1e-5, atol=1e-6)
    _assert_adam_step_close(params, new_state, s_params, s_state, 1e-5, 1e-6)
    _assert_adam_step_close(params, new_state, j_params, j_state, 1e-5, 1e-6)
    np.testing.assert_allclose(
        evaluate(tm.params, *_tensors(*batch)).numpy(),
        single_eval(tm.params, *_tensors(*batch)).numpy(), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        evaluate(tm.params, *_tensors(*batch)).numpy(),
        np.asarray(j_eval(jm.params, *batch)), rtol=1e-5, atol=1e-6)


def _payload_segment(rs, b_local, n_real):
    """A random fused-tail payload of one shard: random glyphs on random
    pool slots of the shard's first n_real paragraphs, the rest of the
    pool unused (255), random flag bytes and component counts."""
    P, G = tft.LINE_POOL, tft.MAX_GLYPHS
    glyphs = rs.randint(0, len(CHARS), (P, G)).astype(np.uint8)
    n_glyphs = rs.randint(0, G + 1, P).astype(np.uint8)
    para = np.full(P, 255, np.uint8)
    used = rs.randint(0, P + 1)
    if n_real:
        para[:used] = np.sort(rs.randint(0, n_real, used))
    n_lines = rs.randint(0, 20, b_local).astype(np.uint8)
    flags = (rs.randint(0, 32, b_local) * (rs.rand(b_local) < 0.3)
             ).astype(np.uint8)
    comps = rs.randint(0, 1 << 16, b_local)
    return np.concatenate([glyphs.reshape(-1), n_glyphs, para, n_lines,
                           flags, (comps & 255).astype(np.uint8),
                           (comps >> 8).astype(np.uint8)])


def _segment_reading(segment, k):
    """What a shard's payload says of its first k paragraphs, read
    directly: each pool slot's glyphs under its paragraph, in pool order;
    the flag bytes; the two-byte component counts."""
    P, G = tft.LINE_POOL, tft.MAX_GLYPHS
    b = (len(segment) - P * G - 2 * P) // 4
    glyphs = segment[:P * G].reshape(P, G)
    n_glyphs, para = segment[P * G:P * G + P], segment[P * G + P:P * G + 2 * P]
    texts = [[] for _ in range(k)]
    for p in range(P):
        if para[p] < k:
            texts[para[p]].append(''.join(
                CHARS[g] for g in glyphs[p, :n_glyphs[p]]))
    tail = segment[P * G + 2 * P:].reshape(4, b).astype(np.int64)
    return texts, tail[1, :k], tail[2, :k] + 256 * tail[3, :k]


@pytest.mark.parametrize('n_shards', [2, 4])
def test_unpack_fused_payload_merges_shards_as_jax(n_shards):
    """Random payloads of n_shards segments, for every paragraph count,
    among them a partial last shard and empty trailing shards: each
    segment's paragraphs get the texts, flags and component counts that
    segment holds for them (an overflow in one shard sends only its own
    paragraphs to the host)."""
    rs = np.random.RandomState(n_shards)
    batch = 16
    b_local = batch // n_shards
    assert len(_payload_segment(rs, b_local, 1)) == \
        tft.fused_payload_nbytes(b_local)
    for n in range(1, batch + 1):
        segments = [_payload_segment(rs, b_local,
                                     min(max(n - s * b_local, 0), b_local))
                    for s in range(n_shards)]
        buf = np.concatenate(segments)
        texts, flags, comps = tft.unpack_fused_payload(buf, n,
                                                       n_shards=n_shards)
        assert len(texts) == len(flags) == len(comps) == n
        for s in range(n_shards):
            first = s * b_local
            k = min(max(n - first, 0), b_local)
            own_texts, own_flags, own_comps = _segment_reading(segments[s],
                                                               k)
            assert texts[first:first + k] == own_texts
            np.testing.assert_array_equal(flags[first:first + k], own_flags)
            np.testing.assert_array_equal(comps[first:first + k], own_comps)


@pytest.fixture(scope='module')
def fixture_pages():
    return load_page_arrays(TRAIN_FIXTURE)


def test_train_model_batched_over_a_mesh(fixture_pages, tmp_path):
    """train_model(batched=True, mesh=...) over 2 shards, 1 epoch of the
    Line stage on the training fixture: writes weights_out, the
    committed checkpoint's entries with the Line model's updated."""
    train, validation = fixture_pages
    out = tmp_path / 'w.json'
    results = train_model(
        train, validation, [(tmodel.Modes.TRAIN_LINE, LR, 0.9, 1)],
        train_size=len(train), val_size=len(validation), weights_out=out,
        device='cpu', batched=True, batch=4, mesh=_cpu_mesh(2),
        reporter=TrainReporter(sink=_Quiet()))
    assert [r['mode'] for r in results] == ['TRAIN_LINE']
    assert np.isfinite(results[0]['best_losses']['Line']).all()
    assert len(json.loads(out.read_text())) == 18


class _Quiet:
    def emit(self, event, payload):
        pass


def test_driver_dp_on_the_cpu(monkeypatch, tmp_path, capsys):
    """python -m univer_ocr_tpu_torch.train_driver 1 1 1 1 --dp=2 --cpu:
    the four batched stages over a 2-shard mesh, 1 epoch each, into the
    port's trained-weights path; --dp over more cards than there are
    raises."""
    out = tmp_path / 'model_weights_torch.json'
    monkeypatch.setattr(train_driver, 'TRAINED_WEIGHTS_PATH', out)
    results = train_driver.main(['1', '1', '1', '1', '--dp=2', '--batch=2',
                                 '--cpu'])
    assert [r['mode'] for r in results] == [
        'TRAIN_MONOCHROME', 'TRAIN_PARAGRAPH', 'TRAIN_LINE', 'TRAIN_CHAR']
    assert 'TRAINING DONE' in capsys.readouterr().out
    assert len(json.loads(out.read_text())) == 18
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(RuntimeError, match='1 are available'):
        train_driver.main(['0', '0', '1', '--dp=2'])
