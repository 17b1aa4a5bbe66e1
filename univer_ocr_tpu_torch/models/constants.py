"""Layer-tag taxonomy and file paths (univer_ocr_tpu/models/constants.py).

The same tag -> layer mapping as the JAX package (the Line model trains
on the top and bottom bands, the Char model on the 8 bit planes and
letter_spacing), so that a page's layers mean the same to both.  The
port writes under the repository's `generated_files/`, never into the
JAX package: the committed checkpoint there is read-only to it.
"""

from pathlib import Path

from ..primitives import BITS_COUNT

LAYER_TAGS = [
    'image',
    'monochrome',
    'paragraph',
    'line',
    'char',
]
LAYER_NAMES = {
    LAYER_TAGS[0]: ['image'],
    LAYER_TAGS[1]: ['image_monochrome'],
    LAYER_TAGS[2]: ['paragraph'],
    LAYER_TAGS[3]: ['line_top', 'line_bottom'],
    LAYER_TAGS[4]: [
        *[f'bit_{i}' for i in range(BITS_COUNT)],
        'letter_spacing',
    ]
}
LAYER_NAMES_PLAIN = [
    name
    for tag in LAYER_TAGS
    for name in LAYER_NAMES[tag]
]

ROOT = Path(__file__).resolve().parents[2]
GENERATED_FILES_PATH = ROOT / 'generated_files'
#: the PNG corpus the JAX package's `run.py generate_data` writes
TRAIN_DATA_PATH = GENERATED_FILES_PATH / 'data' / 'train'
VALIDATION_DATA_PATH = GENERATED_FILES_PATH / 'data' / 'validation'
TRAIN_DATASET_LENGTH = 100
VALIDATION_DATASET_LENGTH = 10
#: where the port's trainer writes its checkpoint unless told otherwise
TRAINED_WEIGHTS_PATH = GENERATED_FILES_PATH / 'model_weights_torch.json'
#: the trainer's progress pictures (save_train_progress=True) and the
#: flat copy of one iteration's (single_iteration_from_train_progress)
TRAIN_PROGRESS_PATH = GENERATED_FILES_PATH / 'train_progress'
SINGLE_ITERATION_FROM_TRAIN_PROGRESS_PATH = (
    GENERATED_FILES_PATH / 'single_iteration_from_train_progress')
#: the committed training pages (3 pages of 496x736, all 14 layers)
TRAIN_FIXTURE = (Path(__file__).resolve().parents[1] / 'fixtures'
                 / 'train_pages.npz')
