"""The dashboard's trainer (the port's counterpart of the repository's
train.py): connects back to the web app's /train-ws namespace so that
the dashboard receives the run's events, or runs in console mode.

    python -m univer_ocr_tpu_torch.train [use_gpu] [console_mode]
        [show_progress_bar] [port] [save_train_progress]

It trains the curriculum (models/train.py CURRICULUM) on the committed
training fixture (univer_ocr_tpu_torch/fixtures/train_pages.npz), from
the committed checkpoint into generated_files/model_weights_torch.json.
`use_gpu` 'true' (the default) runs on the card, 'false' on the CPU;
`console_mode` 'true' (the default) reports to the console, 'false'
connects to the web app on `port` (default 8000) and falls back to the
console when no server answers.  The web app's `start` event passes
'false' and its own port.  `save_train_progress` 'true' writes each
step's pictures under generated_files/train_progress/ (needs Pillow; the
JAX package's train.py takes it in place of `port`).
"""

import sys
import traceback

from .models.constants import TRAIN_FIXTURE
from .models.datasets import load_page_arrays
from .models.train import init_emitter, train_model
from .web.ws_client import connect_train_ws


def bool_convert(arg):
    return {'true': True, 'false': False}.get(str(arg).lower(), arg)


def main(use_gpu=True, console_mode=True, show_progress_bar=False,
         port=8000, save_train_progress=False):
    client = None

    if bool_convert(console_mode):
        print('Running in console mode')
    else:
        try:
            client = connect_train_ws(port=int(port))
            init_emitter(client)
        except OSError:
            print('Cannot connect to socket server, running in console mode')

    train, validation = load_page_arrays(TRAIN_FIXTURE)
    try:
        train_model(train, validation, train_size=len(train),
                    val_size=len(validation),
                    device=None if bool_convert(use_gpu) else 'cpu',
                    show_progress_bar=bool_convert(show_progress_bar),
                    save_train_progress=bool_convert(save_train_progress))

    except KeyboardInterrupt:
        print('Stopped by keyboard interrupt')

    except Exception as e:
        print(traceback.format_exc())
        raise e

    finally:
        if client is not None:
            client.emit('stop', None)
            init_emitter(None)
            client.close()


if __name__ == '__main__':
    main(*sys.argv[1:])
