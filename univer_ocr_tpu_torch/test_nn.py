"""Entry of the NN script batteries (the repository's test_nn.py):

    python -m univer_ocr_tpu_torch.test_nn {test_gradients|test_identity} [use_gpu]

`use_gpu` 'false' (any case) runs the battery on the CPU; 'true', or no
`use_gpu` at all, on the card.  The exit code is 1 when a check failed.
"""

import importlib
import sys
import traceback

import_path = 'univer_ocr_tpu_torch.nn.test.'


def main(test_name, use_gpu=True):
    """Run one battery; returns True when every check passed."""
    try:
        imported = importlib.import_module(import_path + test_name)
        return imported.main(str(use_gpu).lower() != 'false')

    except Exception as e:
        print(traceback.format_exc())
        raise e


if __name__ == '__main__':
    sys.exit(0 if main(*sys.argv[1:]) else 1)
