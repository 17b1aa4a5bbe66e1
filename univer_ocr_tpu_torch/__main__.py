"""Subcommand dispatcher (the port's counterpart of the repository's
run.py).

    python -m univer_ocr_tpu_torch <module> [use_gpu] [args...]

<module> is `predict` (models/predict.py: `predict [use_gpu] PAGE [--out
DIR]`, PAGE an image file or a .npy array), `train` (train.py: `train
[use_gpu] [console_mode] [show_progress_bar] [port]
[save_train_progress]`), `generate_data`
(models/generate_data.py: `generate_data [--train N] [--validation N]
[--seed S] [--out DIR] [--workers N]`, host work that needs Pillow and
fonts) or `crop_and_rotate_benchmark` (models/crop_and_rotate_benchmark.py:
`crop_and_rotate_benchmark [limit]`, the host crop chain).  `use_gpu` is
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
    elif module_name == 'generate_data':
        from .models.generate_data import main as generate_main
        generate_main(args)
    elif module_name == 'crop_and_rotate_benchmark':
        from .models.crop_and_rotate_benchmark import main as bench_main
        bench_main(*args)
    else:
        raise SystemExit(f'unknown module {module_name!r}: expected '
                         "'predict', 'train', 'generate_data' or "
                         "'crop_and_rotate_benchmark'")


if __name__ == '__main__':
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    main(*sys.argv[1:])
