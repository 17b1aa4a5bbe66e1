"""Copy one training iteration's progress pictures into a flat directory
(the repository's single_iteration_from_train_progress.py).

    python -m univer_ocr_tpu_torch.single_iteration_from_train_progress
        EPOCH [train|validation] [ITERATION]

The output directory (generated_files/single_iteration_from_train_progress)
is emptied, or made, first.  Then, for each directory under the progress
tree (generated_files/train_progress) and each of X, y, pred and
thresholded, `{EPOCH}_{phase}_{ITERATION}_{k}_{name}.png` there is copied
as `{EPOCH}_{phase}_{ITERATION}_{directory}_{k}_{name}.png`.

These are the JAX package's names, and they are not the ones
ProgressSnapshots writes (<mode>/<stage>/{epoch}_{phase}_{index}_1_0_1_X.png
and the like), so on a tree the snapshots wrote nothing is copied: a
fault of the JAX package's script, kept as it is (ROADMAP, Known
differences).
"""

import os
import shutil
import sys
from pathlib import Path

from .models.constants import (SINGLE_ITERATION_FROM_TRAIN_PROGRESS_PATH,
                               TRAIN_PROGRESS_PATH)


def main(epoch_id, train_val='train', iter_id=0,
         progress_path=TRAIN_PROGRESS_PATH,
         out_path=SINGLE_ITERATION_FROM_TRAIN_PROGRESS_PATH):
    epoch_id = int(epoch_id)
    if train_val not in ('train', 'validation'):
        raise ValueError(f"phase must be 'train' or 'validation': "
                         f"{train_val!r}")
    iter_id = int(iter_id)
    progress_path, out_path = Path(progress_path), Path(out_path)

    if out_path.exists():
        for fpath in out_path.iterdir():
            os.remove(fpath)
    else:
        os.makedirs(out_path, exist_ok=True)

    for picture_type in progress_path.iterdir():
        for i, pic in enumerate(['X', 'y', 'pred', 'thresholded']):
            pic_path = picture_type / (
                f'{epoch_id}_{train_val}_{iter_id}_{i + 1}_{pic}.png')
            if not pic_path.exists():
                continue
            new_path = out_path / (
                f'{epoch_id}_{train_val}_{iter_id}_{picture_type.name}_'
                f'{i + 1}_{pic}.png')
            shutil.copyfile(pic_path, new_path)


if __name__ == '__main__':
    main(*sys.argv[1:])
