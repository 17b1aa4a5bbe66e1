"""The curriculum driver (scripts/train_tpu.py): a configurable
curriculum on the committed training fixture.

    python -m univer_ocr_tpu_torch.train_driver MONO PARA LINE CHAR [ALL]
        [--batched] [--batch=N] [--dp=N] [--train-size=N] [--val-size=N]
        [--predicted[=mix]] [--eval-gate] [--lr-scale=X] [--cpu]

The positional numbers are each stage's epochs (default 12 12 12 4 0; a
stage of 0 epochs is skipped).  --batched routes the single-model stages
through the batched trainer (models/dp_train.py): samples built once,
weighted fixed-shape batches of --batch (default 16).  --dp=N also
splits each batch over a mesh of N devices' 'data' axis (parallel/),
which implies --batched: N visible cards (it raises with fewer), or with
--cpu N shards on the host.  --predicted builds the Line and Char
samples from the serving crop distribution, --eval-gate writes a
stage's weights only when the end-to-end text of the eval corpus does
not regress, --lr-scale multiplies every stage's learning rate, --cpu
runs on the host.  Training starts from the committed checkpoint (only
read) and writes generated_files/model_weights_torch.json.
"""

import sys

import torch

from .models.constants import TRAIN_FIXTURE, TRAINED_WEIGHTS_PATH
from .models.datasets import load_page_arrays
from .models.model import Modes
from .models.train import train_model
from .parallel import make_mesh

#: (mode, lr, lr decay step, default epochs), scripts/train_tpu.py's table
STAGES = [
    (Modes.TRAIN_MONOCHROME, 0.0015, 0.995, 12),
    (Modes.TRAIN_PARAGRAPH, 0.0015, 0.995, 12),
    (Modes.TRAIN_LINE, 0.0015, 0.995, 12),
    (Modes.TRAIN_CHAR, 0.0015, 0.97, 4),
    (Modes.TRAIN_ALL, 0.001, 0.97, 0),
]
FLAGS = ('--batched', '--batch=', '--dp=', '--train-size=', '--val-size=',
         '--predicted', '--eval-gate', '--lr-scale=', '--cpu')


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    flags = [a for a in argv if a.startswith('--')]
    epochs = [int(a) for a in argv if not a.startswith('--')]
    unknown = [f for f in flags if not f.startswith(FLAGS)]
    if unknown:
        raise SystemExit(f'unknown flags {unknown}; known: {FLAGS}')

    def value(name, default, cast):
        return next((cast(f.split('=', 1)[1]) for f in flags
                     if f.startswith(f'--{name}=')), default)

    lr_scale = value('lr-scale', 1.0, float)
    curriculum = [(mode, lr * lr_scale, step,
                   epochs[i] if i < len(epochs) else default)
                  for i, (mode, lr, step, default) in enumerate(STAGES)]
    curriculum = [stage for stage in curriculum if stage[3] > 0]
    use_gpu = '--cpu' not in flags
    dp = value('dp', 0, int)
    mesh = None
    if dp:
        mesh = (make_mesh(dp) if use_gpu
                else make_mesh(devices=[torch.device('cpu')] * dp))
    predicted = next((f.split('=', 1)[1] if '=' in f else True
                      for f in flags if f.startswith('--predicted')), False)
    train, validation = load_page_arrays(TRAIN_FIXTURE)
    results = train_model(
        train, validation, curriculum,
        train_size=value('train-size', len(train), int),
        val_size=value('val-size', len(validation), int),
        weights_out=TRAINED_WEIGHTS_PATH,
        device=None if use_gpu else 'cpu',
        batched='--batched' in flags or bool(dp), mesh=mesh,
        batch=value('batch', 16, int), predicted=predicted,
        eval_gate='--eval-gate' in flags)
    print('TRAINING DONE')
    return results


if __name__ == '__main__':
    main()
