"""Training loop: per-model loss bookkeeping, NaN rollback, best-weight
saving (univer_ocr_tpu/models/trainer.py).

The same behaviour as the JAX package's Trainer, with its random state
made explicit: the sample order of each sweep comes from the trainer's
own `random.Random`, and every order drawn is recorded in `orders`, so
that a run can be replayed.  `rollbacks` counts the epochs redone after
a NaN.

One difference: a rollback restores each model's optimizer state with
its weights.  The JAX package reloads the weights only, so once a NaN
gradient has reached Adam's moments every redone epoch turns the weights
NaN again and the rollback never ends.
"""

import gc
import random
from datetime import datetime as dt

import numpy as np


def _clone(tree):
    """A copy of a tree of dicts of tensors (None stays None)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return None if tree is None else tree.clone()


class Losses:
    """Per-model per-output train/val loss accounting with delta
    printing."""

    def __init__(self, model_names, outputs_cnts):
        self.model_names = model_names
        self.outputs_cnts = outputs_cnts
        self.train_prev_losses = self._fresh(np.inf)
        self.val_best_losses = self._fresh(np.inf)
        self.val_prev_losses = self._fresh(np.inf)
        self.train_losses = None
        self.val_losses = None
        self.best_loss_epoch = dict.fromkeys(model_names, 0)

    def _fresh(self, value):
        return {name: np.full(self.outputs_cnts[name], value, dtype=float)
                for name in self.model_names}

    def reset(self):
        self.train_losses = self._fresh(0.0)
        self.val_losses = self._fresh(0.0)

    @staticmethod
    def _accumulate(sums, update):
        for name, entry in update.items():
            if name in sums:
                # components that iterate crops concatenate one loss entry
                # per crop; the reference reads only the first
                # outputs_cnt entries of that tally
                k = len(sums[name])
                sums[name] += np.asarray(entry['output_losses'][:k],
                                         dtype=float)

    def train(self, update):
        self._accumulate(self.train_losses, update)

    def validation(self, update):
        self._accumulate(self.val_losses, update)

    def normalize(self, train_dataset_size, validation_dataset_size):
        for name in self.model_names:
            self.train_losses[name] /= train_dataset_size
            self.val_losses[name] /= validation_dataset_size

    def next(self):
        self.train_prev_losses = self.train_losses
        self.val_prev_losses = self.val_losses

    def get_better_weights(self, epoch):
        """Models whose mean validation loss improved (or went
        NaN -> clean); records their best epoch."""
        def improved(current, best):
            return (np.mean(current) < np.mean(best)
                    or (not np.any(np.isnan(current))
                        and np.any(np.isnan(best))))
        better = [name for name in self.model_names
                  if improved(self.val_losses[name],
                              self.val_best_losses[name])]
        for name in better:
            self.val_best_losses[name] = self.val_losses[name]
            self.best_loss_epoch[name] = epoch
        return better

    def print(self, left_margin=0):
        margin = ' ' * left_margin

        def row(values, prev=None):
            cells = []
            for name in self.model_names:
                vals = values[name]
                if prev is None:
                    cells.append(' '.join(f'{v: .6f}' for v in vals))
                else:
                    cells.append(' '.join(
                        f'{v - p:+.6f}' for v, p in zip(vals, prev[name])))
            return ' | '.join(cells)

        print(margin + 'Models:            '
              + ' | '.join(self.model_names))
        print(margin + 'Train loss:        ' + row(self.train_losses))
        print(margin + '  Loss change:     '
              + row(self.train_losses, self.train_prev_losses))
        print(margin + 'Validation loss:   ' + row(self.val_losses))
        print(margin + '  Loss change:     '
              + row(self.val_losses, self.val_prev_losses))


class Trainer:
    """Epoch loop with shuffling from `rng` (a `random.Random`; seed 0 when
    None), per-sample train/validate, lr decay, NaN rollback (< 10
    attempts -> last weights, else best weights) and a save-best-weights
    callback, which an `eval_gate` (evaluation.make_eval_gate) may
    withhold: the improved models are offered to it first, and saved only
    on its approval.  `save_pictures_func(epoch, phase, index, context)`,
    when given, sees every sample's context after its step (epoch 0 is
    the precomputing sweep; models/train.py ProgressSnapshots)."""

    MAX_RELOAD_ATTEMPTS = 10

    def __init__(self, model_system, make_context_func,
                 models, train_dataset, validation_dataset,
                 progress_tracker, show_progress_bar=False,
                 optimizer=None, learning_rate_step=0.995,
                 save_weights_func=None, save_pictures_func=None, rng=None,
                 eval_gate=None):
        self.model_system = model_system
        self.make_context_func = make_context_func
        self.models = models
        self.train_dataset = train_dataset
        self.validation_dataset = validation_dataset
        self.progress_tracker = progress_tracker
        self.show_progress_bar = show_progress_bar
        self.optimizer = optimizer
        self.learning_rate_step = learning_rate_step
        self.save_weights_func = save_weights_func
        self.save_pictures_func = save_pictures_func
        self.rng = random.Random(0) if rng is None else rng
        self.eval_gate = eval_gate
        #: (epoch, phase, sample order) of every sweep the rng shuffled
        self.orders = []
        self.rollbacks = 0

    # -- helpers ---------------------------------------------------------

    def _progress(self, iterable, desc):
        if self.show_progress_bar:
            try:
                from tqdm import tqdm
            except ImportError:
                return iterable
            return tqdm(iterable, desc=desc, ascii=True)
        return iterable

    def _snapshot(self):
        """(weights in the checkpoint schema, each model's optimizer
        state)."""
        weights = {name: w
                   for model in self.models.values()
                   for name, w in model.get_weights().items()}
        return weights, {name: _clone(model.opt_state)
                         for name, model in self.models.items()}

    def _restore(self, snapshot):
        weights, opt_states = snapshot
        for name, model in self.models.items():
            model.set_weights(weights)
            model.opt_state = _clone(opt_states[name])

    def _any_nan_weights(self):
        return any(model.nan_weights() for model in self.models.values())

    def _shuffled(self, order, epoch, phase):
        self.rng.shuffle(order)
        self.orders.append((epoch, phase, list(order)))
        return order

    def _sweep(self, phase, dataset, order, losses, epoch, metric_sums=None):
        """One pass over a dataset.  phase: 'train' | 'validation' |
        'precomputing' (the last two both run test steps)."""
        training = phase == 'train'
        record = losses.train if training else losses.validation
        step = self.model_system.train if training else self.model_system.test
        label = {'train': 'Training', 'validation': 'Validating',
                 'precomputing': 'Precomputing'}[phase]
        bar_key = 'train_iteration' if training else 'val_iteration'

        for i in self._progress(range(len(order)), desc=label):
            if phase != 'precomputing':
                self.progress_tracker.reset()
                self.progress_tracker.message(
                    'training' if training else 'validating')
            context = self.make_context_func(dataset.get, (order[i],))
            step(context)
            record(context['losses'])
            if metric_sums is not None:
                for metric, values in context.get('metrics', {}).items():
                    metric_sums.setdefault(metric, []).extend(values)
            if self.save_pictures_func is not None:
                self.save_pictures_func(epoch, phase, i, context)
            if phase != 'precomputing':
                self.progress_tracker.message(bar_key, {
                    'current': i + 1, 'total': len(order)})
            del context

    def _announce_epoch(self, epoch, num_epochs):
        print(f'[{dt.now()}]')
        print(f'Epoch {str(epoch).rjust(len(str(num_epochs)))}/{num_epochs}:')
        self.progress_tracker.message('epoch', {
            'current': epoch, 'total': num_epochs})
        for key, total in (('train_iteration', len(self.train_dataset)),
                           ('val_iteration', len(self.validation_dataset))):
            self.progress_tracker.message(key, {'current': 0, 'total': total})
        if self.optimizer is not None:
            print(f'  lr = {self.optimizer.lr}')

    def _handle_nan(self, reload_attempts, last, best):
        """Returns (redo_epoch, reload_attempts) after the per-epoch NaN
        scan."""
        if self.optimizer is None:
            if self._any_nan_weights():
                raise ValueError(
                    'NaN value found in weights, but no optimizer provided. '
                    'Provide optimizer and learning_rate_step, so '
                    'learning rate could be decreased to try avoiding '
                    'NaN values')
            return False, reload_attempts

        # lr decays by step**attempts: compounding only while epochs keep
        # rolling back (attempts reset to 0 on success)
        reload_attempts += 1
        self.optimizer.lr *= self.learning_rate_step ** reload_attempts
        if not self._any_nan_weights():
            return False, reload_attempts
        self.rollbacks += 1
        if reload_attempts < self.MAX_RELOAD_ATTEMPTS:
            print('NaN value found in weights, loading last weights\n')
            self._restore(last)
        else:
            print('Too many attempts, loading last best weights\n')
            self._restore(best)
            reload_attempts = 0
        return True, reload_attempts

    # -- entry -----------------------------------------------------------

    def train(self, num_epochs):
        losses = Losses(
            list(self.models.keys()),
            {name: model.get_outputs_count()
             for name, model in self.models.items()})

        print('Precomputing losses')
        started = dt.now()
        losses.reset()
        self._sweep('precomputing', self.validation_dataset,
                    range(len(self.validation_dataset)), losses, epoch=0)
        losses.print(left_margin=2)
        losses.next()
        print(f'Time required: {dt.now() - started}\n\n')

        best = last = self._snapshot()
        reload_attempts = 0
        train_order = list(range(len(self.train_dataset)))
        val_order = list(range(len(self.validation_dataset)))
        assert val_order, 'Validation dataset must have at least 1 element'

        epoch = 1
        while epoch <= num_epochs:
            self._announce_epoch(epoch, num_epochs)
            started = dt.now()
            losses.reset()
            metric_sums = {}

            self._sweep('train', self.train_dataset,
                        self._shuffled(train_order, epoch, 'train'), losses,
                        epoch)
            self._sweep('validation', self.validation_dataset,
                        self._shuffled(val_order, epoch, 'validation'),
                        losses, epoch, metric_sums)

            gc.collect()
            losses.normalize(len(self.train_dataset),
                             len(self.validation_dataset))

            redo, reload_attempts = self._handle_nan(
                reload_attempts, last, best)
            if redo:
                continue

            losses.print(left_margin=2)
            for metric, values in metric_sums.items():
                print(f'  {metric} char accuracy: {np.mean(values):.4f} '
                      f'({len(values)} lines)')

            improved = losses.get_better_weights(epoch)
            if improved and self.save_weights_func:
                approved = True
                if self.eval_gate is not None:
                    approved, _, _ = self.eval_gate(
                        {name: self.models[name] for name in improved})
                if approved:
                    print('  Saving weights for ' + ', '.join(improved))
                    self.save_weights_func(improved)
                else:
                    print('  Eval gate rejected ' + ', '.join(improved)
                          + '; checkpoint kept')

            print(f'Time required: {dt.now() - started}\n\n')
            last = self._snapshot()
            epoch += 1
            reload_attempts = 0
            losses.next()

        return losses.val_best_losses, losses.best_loss_epoch
