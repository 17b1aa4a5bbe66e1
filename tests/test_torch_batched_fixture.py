"""The committed reference of the batched trainer, univer_ocr_tpu_torch/
fixtures/train_batched.npz, against which chip_smoke.py's
`batched_train_path` phase holds the port's batched stages on the card.

It holds, in `reference` (JSON), the JAX package's numbers for one epoch
of each batched stage on the pages of fixtures/train_pages.npz (train
pages 0 and 1, in that order; the validation page), each stage from the
committed checkpoint: the stage's samples (`collect_stage_samples` for
TRAIN_MONOCHROME and TRAIN_PARAGRAPH, `collect_stage_samples_predicted`
for TRAIN_LINE and TRAIN_CHAR, with the pipeline in 'highest' and in its
default 'bf16', keyed `TRAIN_LINE/highest`, ...), then
`train_stage_batched(batch=16, seed=0, epochs=1)` at the curriculum's
lr, in float32 on the CPU.  Per stage: the sample counts and the shape
of each sample's input, every train step's per-sample losses (times the
filler weights), every validation sweep's (before and after the epoch),
and the L2 norm of each parameter's change over the epoch's steps.

The port runs the same stages on the CPU here against it.  Bars: the
sample counts and shapes equal; the first train step's per-sample losses
within FIRST_RTOL (the same weights, a forward only) and the initial
validation sweep's within INITIAL_VAL_RTOL (a whole page's float32 Dice
sums, in another order); the later steps' losses, the validation after
the epoch and the update norms within LATER_RTOL (measured on the CPU:
at most 9.8e-4, the Monochrome validation after its one update, and
8.3e-4 for Char).

Regenerate with `JAX_PLATFORMS=cpu python tests/test_torch_batched_fixture.py`
(it reads fixtures/train_pages.npz).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / 'univer_ocr_tpu_torch' / 'fixtures' / 'train_batched.npz'
STAGES = ('TRAIN_MONOCHROME', 'TRAIN_PARAGRAPH', 'TRAIN_LINE/highest',
          'TRAIN_LINE/bf16', 'TRAIN_CHAR/highest', 'TRAIN_CHAR/bf16')
BATCH = 16
FIRST_RTOL = 1e-5
INITIAL_VAL_RTOL = 5e-5
LATER_RTOL = 5e-3


def load_reference():
    with np.load(FIXTURE) as f:
        return json.loads(str(f['reference']))


def test_fixture_is_small_and_complete():
    """Every stage has samples on both sides, one train step per batch
    of BATCH, two validation sweeps, finite losses with the fillers at
    0, and a nonzero update of every parameter of its model."""
    assert FIXTURE.stat().st_size <= 1 << 20
    ref = load_reference()
    assert tuple(ref) == STAGES
    for stage, entry in ref.items():
        n_train, n_val = entry['counts']
        assert n_train > 0 and n_val > 0, stage
        assert len(entry['shapes']) == n_train
        steps = np.asarray(entry['train_steps'])
        assert steps.shape[1] == BATCH and np.isfinite(steps).all()
        assert np.count_nonzero(steps) <= n_train
        assert len(entry['val_sweeps']) == 2
        assert all(np.isfinite(v).all() for v in entry['val_sweeps'])
        assert entry['update_norms'] and all(
            v > 0 for v in entry['update_norms'].values()), stage


def _relative(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-12)


@pytest.mark.parametrize('stage', STAGES)
def test_port_stage_matches_jax(stage, monkeypatch):
    """The port's batched stage on the CPU from the committed checkpoint,
    its steps recorded as the reference's were, against JAX's numbers."""
    import torch
    from univer_ocr_tpu_torch.models import dp_train
    from univer_ocr_tpu_torch.models.datasets import load_page_arrays
    from univer_ocr_tpu_torch.models.model import Modes
    from univer_ocr_tpu_torch.models.train import CURRICULUM
    from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

    ref = load_reference()[stage]
    train, validation = load_page_arrays()
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    mode = Modes[stage.split('/')[0]]
    if '/' in stage:
        samples = [dp_train.collect_stage_samples_predicted(
            mode, ds, weights, precision=stage.split('/')[1],
            log=lambda *a: None, device='cpu')
            for ds in (train, validation)]
    else:
        samples = [dp_train.collect_stage_samples(mode, ds)
                   for ds in (train, validation)]
    assert [len(s) for s in samples] == ref['counts']
    assert [list(x.shape) for x, _ in samples[0]] == ref['shapes']

    record = {'train': [], 'eval': []}

    def recording(make):
        def wrapped(*args, **kwargs):
            train_step, eval_step = make(*args, **kwargs)

            def train_rec(*a):
                params, state, per = train_step(*a)
                record['train'].append(per.tolist())
                record['params'] = params
                return params, state, per

            def eval_rec(*a):
                per = eval_step(*a)
                record['eval'].append(per.tolist())
                return per
            return train_rec, eval_rec
        return wrapped

    for name in ('make_batched_seg_step', 'make_batched_char_step'):
        monkeypatch.setattr(dp_train, name,
                            recording(getattr(dp_train, name)))
    lr, lr_step = next((lr, step) for m, lr, step, _ in CURRICULUM
                       if m is mode)
    dp_train.train_stage_batched(mode, *samples, weights, epochs=1, lr=lr,
                                 lr_step=lr_step, batch=BATCH, seed=0,
                                 log=lambda *a: None, device='cpu')
    steps = record['train']
    assert np.asarray(steps).shape == np.asarray(ref['train_steps']).shape
    assert _relative(steps[0], ref['train_steps'][0]).max() <= FIRST_RTOL
    assert _relative(steps, ref['train_steps']).max() <= LATER_RTOL
    n_val = len(record['eval']) // 2
    sweeps = [sum(record['eval'][:n_val], []),
              sum(record['eval'][n_val:], [])]
    assert (_relative(sweeps[0], ref['val_sweeps'][0]).max()
            <= INITIAL_VAL_RTOL)
    assert _relative(sweeps[1], ref['val_sweeps'][1]).max() <= LATER_RTOL
    norms = {f'{layer}/{key}': float(torch.linalg.vector_norm(
                 value.double() - torch.tensor(weights[layer][key],
                                               dtype=torch.float64)))
             for layer, params in record['params'].items()
             for key, value in params.items()}
    assert sorted(norms) == sorted(ref['update_norms'])
    assert max(_relative(norms[k], v)
               for k, v in ref['update_norms'].items()) <= LATER_RTOL


def generate():
    """Run JAX's batched stages on the training fixture's pages."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    sys.path.insert(0, str(ROOT))
    from univer_ocr_tpu.models import dp_train
    from univer_ocr_tpu.models.model import Modes
    from univer_ocr_tpu.models.train import CURRICULUM
    from univer_ocr_tpu_torch.models.datasets import load_page_arrays
    from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

    train, validation = load_page_arrays()
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    lrs = {mode: (lr, step) for mode, lr, step, _ in CURRICULUM}
    record = {}
    makers = {name: getattr(dp_train, name)
              for name in ('make_batched_seg_step', 'make_batched_char_step')}

    def recording(make):
        def wrapped(*args, **kwargs):
            train_step, eval_step = make(*args, **kwargs)

            def train_rec(*a):
                params, opt_state, per = train_step(*a)
                record['train_steps'].append(np.asarray(per).tolist())
                record['params'] = jax.tree_util.tree_map(np.asarray, params)
                return params, opt_state, per

            def eval_rec(*a):
                per = eval_step(*a)
                record['eval_steps'].append(np.asarray(per).tolist())
                return per
            return train_rec, eval_rec
        return wrapped

    for name, make in makers.items():
        setattr(dp_train, name, recording(make))

    reference = {}
    for stage in STAGES:
        mode = Modes[stage.split('/')[0]]
        if '/' in stage:
            precision = stage.split('/')[1]
            build = lambda ds: dp_train.collect_stage_samples_predicted(
                mode, ds, weights, precision=precision, log=print)
        else:
            build = lambda ds: dp_train.collect_stage_samples(mode, ds)
        train_samples, val_samples = build(train), build(validation)
        record.update(train_steps=[], eval_steps=[], params=None)
        lr, lr_step = lrs[mode]
        dp_train.train_stage_batched(
            mode, train_samples, val_samples, weights, epochs=1, lr=lr,
            lr_step=lr_step, batch=BATCH, seed=0, log=print)
        n_val_batches = len(record['eval_steps']) // 2
        norms = {
            f'{layer}/{key}': float(np.linalg.norm(
                np.asarray(value, np.float64)
                - np.asarray(weights[layer][key], np.float64)))
            for layer, params in record['params'].items()
            for key, value in params.items()}
        reference[stage] = {
            'lr': lr,
            'counts': [len(train_samples), len(val_samples)],
            'shapes': [list(x.shape) for x, _ in train_samples],
            'train_steps': record['train_steps'],
            'val_sweeps': [
                [v for step in record['eval_steps'][:n_val_batches]
                 for v in step],
                [v for step in record['eval_steps'][n_val_batches:]
                 for v in step]],
            'update_norms': norms,
        }
        print(stage, reference[stage]['counts'],
              [sum(s) for s in record['train_steps']], flush=True)
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, reference=np.array(json.dumps(reference)))
    print(f'{FIXTURE}: {FIXTURE.stat().st_size} bytes')


if __name__ == '__main__':
    generate()
