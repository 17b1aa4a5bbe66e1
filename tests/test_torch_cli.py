"""The port's command-line surfaces: the dispatcher (python -m
univer_ocr_tpu_torch, run.py's counterpart), its `predict` on a .npy page
on the CPU, and the dashboard's trainer (univer_ocr_tpu_torch/train.py):
its connection to /train-ws, its console fallback, and its start and
stop from the web app."""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from univer_ocr_tpu_torch import __main__ as dispatcher
from univer_ocr_tpu_torch import train as dashboard_train
from univer_ocr_tpu_torch.models.predict import predict
from univer_ocr_tpu_torch.web import create_app
from univer_ocr_tpu_torch.web.ws_client import FrameReader, WSClient

from test_torch_fixture import load_fixture

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize('args, want', [
    ((), (True, [])),
    (('false', 'page.npy'), (False, ['page.npy'])),
    (('FALSE',), (False, [])),
    (('True', 'a', 'b'), (True, ['a', 'b'])),
    (('page.npy', '--out', 'x'), (True, ['page.npy', '--out', 'x'])),
])
def test_use_gpu_coercion(args, want):
    """A leading 'true'/'false' (any case) is use_gpu; without one the
    card is used, where run.py defaults to the CPU."""
    assert dispatcher.split_use_gpu(args) == want


@pytest.mark.parametrize('arg, want', [('true', True), ('False', False),
                                       ('8000', '8000'), (True, True)])
def test_bool_convert(arg, want):
    assert dispatcher.bool_convert(arg) == want


def test_unknown_module_exits():
    with pytest.raises(SystemExit, match='unknown module'):
        dispatcher.main('no_such_module', 'false')


def test_predict_npy_through_the_dispatcher_on_the_cpu(tmp_path):
    """`python -m univer_ocr_tpu_torch predict false PAGE.npy` prints the
    text that predict() gives in process and writes its result.txt."""
    pages, _ = load_fixture()
    page = tmp_path / 'page.npy'
    np.save(page, pages[2])
    out = subprocess.run(
        [sys.executable, '-m', 'univer_ocr_tpu_torch', 'predict', 'false',
         str(page), '--out', str(tmp_path / 'cli')],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want = predict(page, tmp_path / 'inproc', device='cpu')
    assert out.stdout.strip().splitlines()[-1] == str(want)
    assert ((tmp_path / 'cli' / 'result.txt').read_text()
            == (tmp_path / 'inproc' / 'result.txt').read_text())
    assert sum(len(para) for para in want) > 0


@pytest.fixture()
def fake_training(monkeypatch):
    """Replace the trainer's train_model by a recorder that reports one
    message, as a run does."""
    calls = []

    def fake(train, validation, **kwargs):
        from univer_ocr_tpu_torch.models.train import message
        calls.append((len(train), len(validation), kwargs))
        message('fake run')
        return []
    monkeypatch.setattr(dashboard_train, 'train_model', fake)
    return calls


def test_trainer_reports_to_the_dashboard_and_stops(fake_training):
    """`train false false false PORT` through the dispatcher: the trainer
    connects to /train-ws, its messages reach the browser, it trains on
    the CPU on the training fixture's 2 + 1 pages, and its `stop` at the
    end makes the server broadcast `stopped`."""
    app = create_app(device='cpu')
    app.start_background(port=0)
    try:
        browser = WSClient('127.0.0.1', app.port, '/train-ws')
        reader = FrameReader(browser.sock)
        time.sleep(0.1)
        dispatcher.main('train', 'false', 'false', 'false', str(app.port))
        reader.wait(lambda events: any(e.get('event') == 'stopped'
                                       for e in events), 10)
        browser.close()
    finally:
        app.shutdown()
    (n_train, n_val, kwargs), = fake_training
    assert (n_train, n_val) == (2, 1)
    assert kwargs['device'] == 'cpu'
    events = [(e.get('event'), e.get('data')) for e in reader.events]
    assert ('message', 'fake run\n') in events
    assert ('stopped', None) in events


def test_trainer_falls_back_to_the_console(fake_training, capsys):
    """No server on the port: the trainer says so and trains with its
    telemetry on the console."""
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    dashboard_train.main('false', 'false', 'false', port)
    out = capsys.readouterr().out
    assert 'Cannot connect to socket server' in out
    assert 'fake run' in out
    assert len(fake_training) == 1


def test_train_ws_start_runs_the_trainer_and_stop_ends_it():
    """The dashboard's `start` launches the trainer in a subprocess on the
    CPU, which connects back (its tracker's events reach the browser);
    `stop` ends it."""
    app = create_app(device='cpu')
    app.start_background(port=0)
    try:
        browser = WSClient('127.0.0.1', app.port, '/train-ws')
        reader = FrameReader(browser.sock)
        time.sleep(0.1)
        browser.emit('start', {'use_gpu': False})

        def seen(pred, timeout):
            return reader.wait(lambda events: any(map(pred, events)),
                               timeout)
        assert seen(lambda e: e.get('event') == 'progress_tracker'
                    and e['data'].get('type') == 'reset', 120), \
            reader.events[-5:]
        browser.emit('stop')
        assert seen(lambda e: e.get('event') == 'message'
                    and 'process exited' in e['data'], 60)
        assert app.state['train_proc'].poll() is not None
        browser.close()
    finally:
        app.shutdown()


def test_web_server_entry_point_on_the_cpu():
    """`python -m univer_ocr_tpu_torch.web 0 --cpu` serves on a free port,
    which it prints."""
    import urllib.request
    proc = subprocess.Popen(
        [sys.executable, '-u', '-m', 'univer_ocr_tpu_torch.web', '0',
         '--cpu'], cwd=str(ROOT), stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith('Serving on http://127.0.0.1:'), line
        url = line.split()[-1]
        with urllib.request.urlopen(url + '/', timeout=30) as r:
            assert r.status == 200 and b'univer-ocr-tpu' in r.read()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
