"""Dashboard integration of the port: a micro training run of the port's
train_model, reporting through init_emitter to the port's /train-ws,
must deliver every event type the dashboard consumes (train.js), with the
payload shapes the UI reads: the cases of tests/test_web_dashboard.py.

The "browser" is a raw WSClient collecting the rebroadcast stream; a
static check pins the port's train.js and train.html to the vocabulary.
The app binds port 0 and trains on the CPU."""

import re
from pathlib import Path

import pytest

from univer_ocr_tpu_torch.web import create_app
from univer_ocr_tpu_torch.web.ws_client import (FrameReader, WSClient,
                                                connect_train_ws)

WEB = Path(__file__).resolve().parents[1] / 'univer_ocr_tpu_torch' / 'web'
TRAIN_JS = (WEB / 'static' / 'train.js').read_text()

#: every progress_tracker type the dashboard needs from a run
NEEDED_TYPES = {'reset', 'generating_data', 'training', 'validating',
                'epoch', 'train_iteration', 'val_iteration',
                'forward_backward'}


@pytest.fixture(scope='module')
def server():
    app = create_app(device='cpu')
    app.start_background(port=0)
    yield app
    app.shutdown()


def test_dashboard_receives_full_event_vocabulary(server, tmp_path):
    """One epoch of Monochrome on 2 training pages and 1 validation page
    of the training fixture, the weights written to tmp_path: the browser
    socket sees message, info and every progress_tracker type."""
    from univer_ocr_tpu_torch.models import train as train_mod
    from univer_ocr_tpu_torch.models.datasets import load_page_arrays
    from univer_ocr_tpu_torch.models.model import Modes

    browser = WSClient('127.0.0.1', server.port, '/train-ws')
    reader = FrameReader(browser.sock)
    trainer_client = connect_train_ws(port=server.port)
    train, validation = load_page_arrays()
    train_mod.init_emitter(trainer_client)
    try:
        train_mod.train_model(
            train, validation,
            curriculum=[(Modes.TRAIN_MONOCHROME, 1e-3, 0.995, 1)],
            train_size=2, val_size=1, weights_out=tmp_path / 'weights.json',
            device='cpu')
    finally:
        train_mod.init_emitter(None)
        trainer_client.close()

    reader.wait(lambda events: NEEDED_TYPES <= {
        e['data'].get('type') for e in events
        if e.get('event') == 'progress_tracker'}, 10)
    events = list(reader.events)
    browser.close()

    kinds = {e.get('event') for e in events}
    assert 'message' in kinds and 'info' in kinds, kinds
    tracker = [e['data'] for e in events
               if e.get('event') == 'progress_tracker']
    got_types = {t.get('type') for t in tracker}
    assert NEEDED_TYPES <= got_types, got_types

    # payload shapes the UI reads
    info = next(e['data'] for e in events if e.get('event') == 'info')
    assert info.get('layer_names'), 'info.layer_names feeds the table rows'
    assert {'output_shapes', 'receptive_fields'} <= set(info)

    epoch = next(t for t in tracker if t['type'] == 'epoch')
    assert {'current', 'total'} <= set(epoch['data'])

    fb = [t for t in tracker if t['type'] == 'forward_backward']
    done_cells = [ev for t in fb for events_ in t['data'].values()
                  for name, ev in events_.items()
                  if name in ('forward', 'backward') and ev.get('done')]
    assert done_cells, 'at least one layer must reach the green done state'
    assert {'counter', 'done', 'time'} <= set(done_cells[0])

    # the checkpoint went to tmp_path
    assert (tmp_path / 'weights.json').exists()


def test_reporter_without_sink_prints(capsys):
    """With no sink, message and info go to the console and the progress
    events go nowhere, as the JAX package's reporter does."""
    from univer_ocr_tpu_torch.models.train import TrainReporter
    reporter = TrainReporter()
    reporter.message('hello', 1)
    reporter.info({'layer_names': ['a']})
    reporter.status('epoch', {'current': 1, 'total': 2})
    out = capsys.readouterr().out
    assert 'hello 1' in out and 'layer_names:' in out and 'epoch' not in out


def test_reporter_folds_timings():
    """forward/backward tracker events reach the sink as one
    forward_backward table {layer: {event: {counter, done, time}}}."""
    from univer_ocr_tpu_torch.models.train import TrainReporter

    class Sink:
        def __init__(self):
            self.sent = []

        def emit(self, event, data):
            self.sent.append((event, data))
    sink = Sink()
    reporter = TrainReporter(sink)
    reporter.status('forward', {'Monochrome': [
        {'name': 'forward', 'done': True, 'counter': 2, 'time': 1.5,
         'started': None, 'stopped': None}]})
    reporter.status('reset')
    assert sink.sent == [
        ('progress_tracker', {'type': 'forward_backward', 'data': {
            'Monochrome': {'forward': {'counter': 2, 'done': True,
                                       'time': '1.5'}}}}),
        ('progress_tracker', {'type': 'reset'})]


def test_train_js_handles_everything_the_trainer_emits():
    """Static pin: every progress_tracker type the server side can emit
    has a handler branch in the port's train.js, and the UI hooks it
    reads exist in its template."""
    for t in sorted(NEEDED_TYPES | {'disable_status_update',
                                    'enable_status_update'}):
        assert re.search(rf"'{t}'", TRAIN_JS), f'train.js misses {t}'
    html = (WEB / 'templates' / 'train.html').read_text()
    for el_id in ('start', 'stop', 'clear', 'use_gpu', 'step', 'log',
                  'train-bar', 'val-bar', 'epoch-bar', 'layer-table',
                  'progressbars'):
        assert f'id="{el_id}"' in html, f'train.html misses #{el_id}'
