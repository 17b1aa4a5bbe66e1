"""Subcommand dispatcher (the port's counterpart of the repository's
run.py).

    python -m univer_ocr_tpu_torch <module> [use_gpu] [args...]

<module> is `predict` (models/predict.py: `predict [use_gpu] PAGE [--out
DIR]`, PAGE an image file or a .npy array) or `train` (train.py: `train
[use_gpu] [console_mode] [show_progress_bar] [port]`).  `use_gpu` is
'true' or 'false' (any case); 'false' selects the CPU.  Unlike run.py,
whose default is the CPU, the card is used when `use_gpu` is left out.
The other positional 'true'/'false' strings become bools.
"""

import sys

from .train import bool_convert


def split_use_gpu(args):
    """(use_gpu, the remaining args): a leading 'true'/'false' is
    use_gpu, and without one the card is used."""
    if args and isinstance(bool_convert(args[0]), bool):
        return bool_convert(args[0]), list(args[1:])
    return True, list(args)


def main(module_name, *args):
    use_gpu, args = split_use_gpu(args)
    if module_name == 'train':
        from .train import main as train_main
        train_main(use_gpu, *[bool_convert(arg) for arg in args])
    elif module_name == 'predict':
        from .models.predict import main as predict_main
        predict_main(args + ([] if use_gpu else ['--cpu']))
    else:
        raise SystemExit(f'unknown module {module_name!r}: '
                         "expected 'predict' or 'train'")


if __name__ == '__main__':
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    main(*sys.argv[1:])
