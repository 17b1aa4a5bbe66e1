"""The port's Trainer and Losses (univer_ocr_tpu_torch.models.trainer):
the cases of tests/test_trainer.py on the port, and one run held against
the JAX package's Trainer on the same pages, weights and sample order."""

import random

import numpy as np
import pytest

from univer_ocr_tpu.models import model as jmodel
from univer_ocr_tpu.models.trainer import Trainer as JTrainer
from univer_ocr_tpu.nn.optimizers import Adam as JAdam
from univer_ocr_tpu.nn.progress_tracker import BaseProgressTracker as JBase
from univer_ocr_tpu_torch.models.model import (Modes, make_context_maker,
                                               make_model_system)
from univer_ocr_tpu_torch.models.trainer import Losses, Trainer
from univer_ocr_tpu_torch.nn.optimizers import Adam
from univer_ocr_tpu_torch.nn.progress_tracker import BaseProgressTracker

PAGE = (1, 32, 32, 1)


class StubDataset:
    def __init__(self, n=2, seed=0, nan_once=False):
        rs = np.random.RandomState(seed)
        self.pages = [{
            'image': rs.rand(*PAGE).astype(np.float32),
            'monochrome': (rs.rand(*PAGE) > 0.5).astype(np.float32),
        } for _ in range(n)]
        self.nan_once = nan_once

    def __len__(self):
        return len(self.pages)

    def get(self, idx, layer_tags=None):
        page = {t: self.pages[idx][t] for t in layer_tags}
        if self.nan_once:
            # the first page read carries a NaN pixel: the step's update
            # makes every weight NaN
            self.nan_once = False
            page['image'] = page['image'].copy()
            page['image'][0, 3, 4, 0] = np.nan
        return page


def make_setup(lr=1e-3, weights=None):
    optimizer = Adam(lr=lr)
    system, models, _ = make_model_system(
        PAGE, optimizer, weights=weights, mode=Modes.TRAIN_MONOCHROME,
        device='cpu')
    context_fn = make_context_maker(Modes.TRAIN_MONOCHROME, 'cpu')
    return system, models, optimizer, context_fn


def test_trainer_epoch_runs_and_saves_best_as_jax():
    """Two epochs over 3 pages: the best validation losses and epochs
    and the saves equal JAX's Trainer's, from the same weights, with
    JAX's global `random` seeded as the port's trainer rng, so that both
    draw the same orders."""
    j_opt = JAdam(lr=1e-3)
    j_system, j_models, _ = jmodel.make_model_system(
        PAGE, j_opt, mode=jmodel.Modes.TRAIN_MONOCHROME)
    weights = j_models['Monochrome'].get_weights()
    system, models, optimizer, context_fn = make_setup(weights=weights)
    saved, j_saved = [], []
    trainer = Trainer(
        system, context_fn, models, StubDataset(3), StubDataset(1, seed=1),
        progress_tracker=BaseProgressTracker(), optimizer=optimizer,
        save_weights_func=lambda names: saved.append(list(names)),
        rng=random.Random(5))
    best_losses, best_epochs = trainer.train(num_epochs=2)
    random.seed(5)
    j_best, j_epochs = JTrainer(
        j_system, jmodel.make_context_maker(jmodel.Modes.TRAIN_MONOCHROME),
        j_models, StubDataset(3), StubDataset(1, seed=1),
        progress_tracker=JBase(), optimizer=j_opt,
        save_weights_func=lambda names: j_saved.append(list(names))
    ).train(num_epochs=2)
    assert np.isfinite(best_losses['Monochrome'][0])
    assert saved and saved == j_saved    # the first epoch always improves
    assert best_epochs == j_epochs
    np.testing.assert_allclose(best_losses['Monochrome'],
                               j_best['Monochrome'], rtol=1e-5)
    assert [o[:2] for o in trainer.orders] == [
        (1, 'train'), (1, 'validation'), (2, 'train'), (2, 'validation')]
    replay = random.Random(5)
    order = [0, 1, 2]
    replay.shuffle(order)
    assert trainer.orders[0][2] == order


def test_trainer_lr_decay():
    system, models, optimizer, context_fn = make_setup(lr=1e-3)
    trainer = Trainer(
        system, context_fn, models, StubDataset(1), StubDataset(1, seed=1),
        progress_tracker=BaseProgressTracker(), optimizer=optimizer,
        learning_rate_step=0.5)
    trainer.train(num_epochs=2)
    # lr *= step**attempts each epoch
    assert optimizer.lr == pytest.approx(1e-3 * 0.5 * 0.5)


def test_trainer_nan_rollback(capsys):
    """A NaN in the first page read makes the weights NaN after the epoch:
    the trainer reloads the last weights, decays lr and redoes the epoch,
    which then ends clean."""
    system, models, optimizer, context_fn = make_setup()
    start = models['Monochrome'].get_weights()
    trainer = Trainer(
        system, context_fn, models, StubDataset(1, nan_once=True),
        StubDataset(1, seed=1), progress_tracker=BaseProgressTracker(),
        optimizer=optimizer)
    best_losses, _ = trainer.train(num_epochs=1)
    out = capsys.readouterr().out
    assert 'NaN value found in weights, loading last weights' in out
    assert trainer.rollbacks == 1
    assert not models['Monochrome'].nan_weights()
    assert models['Monochrome'].get_weights() != start
    assert np.isfinite(best_losses['Monochrome']).all()
    assert optimizer.lr == pytest.approx(1e-3 * 0.995 * 0.995 ** 2)


def test_trainer_nan_without_optimizer_raises():
    system, models, optimizer, context_fn = make_setup()
    trainer = Trainer(
        system, context_fn, models, StubDataset(1, nan_once=True),
        StubDataset(1, seed=1), progress_tracker=BaseProgressTracker(),
        optimizer=None)
    with pytest.raises(ValueError, match='NaN value found'):
        trainer.train(num_epochs=1)


def test_losses_bookkeeping():
    losses = Losses(['M'], {'M': 1})
    losses.reset()
    losses.train({'M': {'output_losses': [2.0]}})
    losses.train({'M': {'output_losses': [4.0]}})
    losses.validation({'M': {'output_losses': [3.0]}})
    losses.normalize(2, 1)
    assert losses.train_losses['M'][0] == 3.0
    assert losses.val_losses['M'][0] == 3.0
    better = losses.get_better_weights(epoch=1)
    assert better == ['M']
    assert losses.best_loss_epoch['M'] == 1


def test_losses_accumulate_multi_crop_contexts():
    """Components that iterate paragraph crops tally one loss entry per
    crop; Losses reads only the first outputs_cnt entries."""
    losses = Losses(['Line'], {'Line': 1})
    losses.reset()
    losses.validation({'Line': {'output_losses': [0.5] * 11}})
    losses.train({'Line': {'output_losses': [0.25] * 3}})
    assert losses.val_losses['Line'].tolist() == [0.5]
    assert losses.train_losses['Line'].tolist() == [0.25]
