"""The port's web app (univer_ocr_tpu_torch.web) against the JAX package's
(univer_ocr_tpu/web/app.py): the pages and static files, bucket_page,
POST /ocr with image and .npy bodies, requests in parallel, the weights
a new pipeline serves, the /train-ws rebroadcast, and an import without
Pillow or JAX.

The app runs on the CPU (`device='cpu'`) and binds port 0, so files run
in parallel never collide on a port.  The trainer's output path points
into a temporary directory, so the app serves the committed checkpoint
whatever a trainer has written under generated_files/.

Bars:
  * bucket_page: equal to JAX's on every size tried (under the menu, on
    it, between two entries, over the cap through Pillow's resize);
  * /ocr text: a PNG body and a .npy body of the same page give the same
    text, and it is JAX's bucket_page + 'bf16' host cascade (chunk 4, 4
    workers) on that page up to OCR_LINES lines that differ, each by at
    most OCR_GLYPHS glyphs: live on fixture page 0, and on the 6 bodies
    whose JAX answers the fixture stores (`ocr_texts`).  Measured on the
    CPU: 2 lines of 23 on page 0, 1 on two other bodies, none on three;
    one glyph each.  Given JAX's inputs, the port's Line masks equal JAX's
    and its Char ids differ at 2 columns of one launch: argmax near-ties
    of the 'bf16' Char head, whose 512-term products XLA and torch sum
    in different orders;
  * concurrent requests: the texts of sequential requests, exactly."""

import io
import inspect
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from univer_ocr_tpu_torch.web import app as app_mod
from univer_ocr_tpu_torch.web import create_app
from univer_ocr_tpu_torch.web.app import BadPage, bucket_page, decode_page
from univer_ocr_tpu_torch.web.ws_client import FrameReader, WSClient

from test_torch_evaluation import _edit_distance
from test_torch_fixture import load_fixture

ROOT = Path(__file__).resolve().parents[1]

#: the flip budget of the /ocr text against JAX's ('bf16', on the CPU)
OCR_LINES, OCR_GLYPHS = 2, 1


@pytest.fixture(scope='module')
def server(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(app_mod, 'TRAINED_WEIGHTS_PATH',
                   tmp_path_factory.mktemp('trained') / 'none.json')
        app = create_app(device='cpu')
        app.start_background(port=0)
        yield app
        app.shutdown()


def _url(app, path):
    return f'http://127.0.0.1:{app.port}{path}'


def get(app, path):
    with urllib.request.urlopen(_url(app, path), timeout=30) as r:
        return r.status, r.headers.get('Content-Type', ''), r.read()


def post(app, body, path='/ocr'):
    """(status, decoded JSON) of a POST."""
    req = urllib.request.Request(_url(app, path), data=body, method='POST')
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def png_bytes(arr):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, 'PNG')
    return buf.getvalue()


def _page(i=0):
    """Fixture page i cropped by one pixel on every side: 494x734, which
    buckets to the 496x736 serving page."""
    pages, _ = load_fixture()
    return np.ascontiguousarray(pages[i][1:-1, 1:-1])


# ---------------------------------------------------------------------------
# Pages, static files, routes
# ---------------------------------------------------------------------------


def test_index(server):
    status, ctype, body = get(server, '/')
    assert status == 200 and b'univer-ocr-tpu' in body
    assert 'text/html' in ctype


@pytest.mark.parametrize('path', ['/chars', '/train', '/ocr', '/fonts'])
def test_routes(server, path):
    status, ctype, body = get(server, path)
    assert status == 200
    assert 'text/html' in ctype
    assert b'<nav>' in body


@pytest.mark.parametrize('path, ctype', [('/static/style.css', 'text/css'),
                                         ('/static/train.js',
                                          'application/javascript')])
def test_static(server, path, ctype):
    status, got, body = get(server, path)
    assert status == 200 and ctype in got and body


@pytest.mark.parametrize('path', ['/nope', '/view_layers/nope',
                                  '/image/nope/image', '/static/../app.py'])
def test_404(server, path):
    """Unknown paths, a demo mode that does not exist (answered before
    the demo page is rendered), and paths out of the static
    directory."""
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(_url(server, path), timeout=10)
    assert err.value.code == 404


def test_start_background_reports_its_port(server):
    assert server.port and server.server.server_address[1] == server.port


# ---------------------------------------------------------------------------
# bucket_page
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('h, w', [(96, 160), (494, 734), (496, 736),
                                  (700, 1100), (1518, 2014), (1600, 1500),
                                  (1700, 2300)])
def test_bucket_page_equals_jax(h, w):
    """Under the menu, on it (494x734 fits 496x736; 496x736 needs the next
    entry), between entries, the largest shape, and over the cap on one
    axis and on both (downscaled with Pillow)."""
    from PIL import Image
    from univer_ocr_tpu.web.app import bucket_page as jax_bucket_page
    page = np.random.RandomState(h + w).randint(0, 256, (h, w), np.uint8)
    want = jax_bucket_page(Image.fromarray(page))
    got = bucket_page(page)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bucket_page(Image.fromarray(page)), want)


def test_decode_page():
    page = _page()
    np.testing.assert_array_equal(decode_page(npy_bytes(page)), page)
    np.testing.assert_array_equal(decode_page(npy_bytes(page[None, :, :,
                                                             None])), page)
    np.testing.assert_array_equal(np.asarray(decode_page(png_bytes(page))),
                                  page)
    for bad in (b'not an image', npy_bytes(page.astype(np.float32)),
                npy_bytes(np.zeros((2, 3, 4), np.uint8)),
                b'\x93NUMPY garbage'):
        with pytest.raises(BadPage):
            decode_page(bad)


# ---------------------------------------------------------------------------
# POST /ocr
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('body', [b'not an image',
                                  npy_bytes(np.zeros((8, 8), np.float32))])
def test_ocr_endpoint_rejects_garbage(server, body):
    status, data = post(server, body)
    assert status == 400
    assert data['error']


@pytest.fixture(scope='module')
def page_text(server):
    """The /ocr text of fixture page 0 (cropped) as a .npy body."""
    status, data = post(server, npy_bytes(_page()))
    assert status == 200
    return data['text']


def test_ocr_png_and_npy_bodies_give_the_same_text(server, page_text):
    status, data = post(server, png_bytes(_page()))
    assert status == 200
    assert data['text'] == page_text
    assert sum(len(para) for para in page_text) > 0


def test_ocr_text_equals_jax_within_budget(page_text):
    """JAX's bucket_page + its serving pipeline of the host cascade, as
    its /ocr runs them, on the same page."""
    from PIL import Image
    from univer_ocr_tpu.models.pipeline import OCRPipeline as JaxPipeline
    from univer_ocr_tpu.web.app import bucket_page as jax_bucket_page
    from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    X = jax_bucket_page(Image.fromarray(_page()))
    want = JaxPipeline(X.shape, weights=weights, chunk=4, workers=4,
                       precision='bf16').ocr_pages([X])[0]
    _assert_within_budget(page_text, want)
    assert want == load_fixture('ocr_texts')[1]['crop'][0]


def _assert_within_budget(got, want):
    assert [len(p) for p in got] == [len(p) for p in want]
    off = [(p, k, _edit_distance(a, b))
           for p, (para, para_j) in enumerate(zip(got, want))
           for k, (a, b) in enumerate(zip(para, para_j)) if a != b]
    assert len(off) <= OCR_LINES, off
    assert all(d <= OCR_GLYPHS for *_, d in off), off


@pytest.mark.parametrize('key, i', [('crop', 0), ('crop', 1), ('crop', 2),
                                    ('crop', 3), ('whole', 0), ('whole', 1)])
def test_ocr_texts_equal_the_stored_jax_answers(server, key, i):
    """Each body the smoke run posts (test_torch_fixture.ocr_bodies)
    against the JAX package's /ocr answer stored in the fixture."""
    from test_torch_fixture import ocr_bodies
    pages, want = load_fixture('ocr_texts')
    body = ocr_bodies(pages)[key == 'whole'][i]
    status, data = post(server, npy_bytes(body))
    assert status == 200
    _assert_within_budget(data['text'], want[key][i])


def test_ocr_serves_one_pipeline_per_shape(server, page_text):
    """A whole 496x736 page needs 2 pixels of margin and buckets to
    752x992: a second pipeline, whose text is its own ocr_pages on the
    bucketed page."""
    pages, _ = load_fixture()
    status, data = post(server, npy_bytes(pages[1]))
    assert status == 200
    assert set(server.state['ocr_pipelines']) == {(1, 496, 736, 1),
                                                  (1, 752, 992, 1)}
    X = bucket_page(pages[1])
    with server.ocr_lock:
        want = server.get_pipeline(X.shape).ocr_pages([X])[0]
    assert data['text'] == want


def test_concurrent_requests_equal_sequential(server, page_text):
    """4 requests at once (2 pages, twice each) against the same requests
    one after another: the app serialises the cascade, whose TF32
    switches are process-wide."""
    bodies = [npy_bytes(_page(i % 2)) for i in range(4)]
    sequential = [post(server, body) for body in bodies]
    results = [None] * 4

    def run(i):
        results[i] = post(server, bodies[i])
    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == sequential
    assert sequential[0] == (200, {'text': page_text})


def test_ocr_serves_the_trainers_weights(server, page_text, tmp_path,
                                         monkeypatch):
    """Once the dashboard's trainer has written its checkpoint, a pipeline
    built after that serves it, as the JAX package's app serves the file
    its trainer writes: here the committed checkpoint with the Char
    head's last layer zeroed, whose text is no longer the committed
    weights'."""
    from univer_ocr_tpu_torch.models import train as train_mod
    from univer_ocr_tpu_torch.models.constants import TRAINED_WEIGHTS_PATH
    from univer_ocr_tpu_torch.weights import (DEFAULT_CHECKPOINT,
                                              load_checkpoint)
    assert (inspect.signature(train_mod.train_model)
            .parameters['weights_out'].default == TRAINED_WEIGHTS_PATH)
    assert app_mod.serving_weights_path() == DEFAULT_CHECKPOINT
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    last = weights['Char/dense_block/dense_3']
    last['w'] = np.zeros_like(np.asarray(last['w'])).tolist()
    trained = tmp_path / 'model_weights_torch.json'
    trained.write_text(json.dumps(weights))
    monkeypatch.setattr(app_mod, 'TRAINED_WEIGHTS_PATH', trained)
    assert app_mod.serving_weights_path() == trained
    app = create_app(device='cpu')
    app.start_background(port=0)
    try:
        status, data = post(app, npy_bytes(_page()))
        pipeline = app.state['ocr_pipelines'][(1, 496, 736, 1)]
    finally:
        app.shutdown()
    assert status == 200
    want = load_checkpoint(trained, 'cpu')
    assert set(pipeline.params) == set(want)
    for name, entry in want.items():
        for key, tensor in entry.items():
            assert torch.equal(pipeline.params[name][key], tensor), name
    assert data['text'] != page_text


# ---------------------------------------------------------------------------
# /train-ws
# ---------------------------------------------------------------------------


def test_train_ws_rebroadcast(server):
    """Trainer-client events are rebroadcast to the other members of the
    namespace, not to the sender."""
    browser = WSClient('127.0.0.1', server.port, '/train-ws')
    reader = FrameReader(browser.sock)
    trainer = WSClient('127.0.0.1', server.port, '/train-ws')
    echo = FrameReader(trainer.sock)
    time.sleep(0.1)
    trainer.emit('progress_tracker', {'type': 'epoch',
                                      'data': {'current': 1, 'total': 5}})
    assert reader.wait(lambda events: events, 10)
    time.sleep(0.2)
    msg, = reader.events
    assert msg['event'] == 'progress_tracker'
    assert msg['data']['data']['current'] == 1
    assert echo.events == []
    browser.close()
    trainer.close()


# ---------------------------------------------------------------------------
# The card machine has no Pillow and no JAX
# ---------------------------------------------------------------------------


def test_web_imports_without_pillow_or_jax():
    """With PIL and jax blocked, the web package imports, the app starts
    on the CPU, a .npy page buckets, a page over the cap is refused with
    a message (downscaling needs Pillow), an image body is refused, and
    neither module was loaded."""
    code = '''
import sys
for name in ('PIL', 'jax'):
    sys.modules[name] = None
import numpy as np
from univer_ocr_tpu_torch.web import create_app
from univer_ocr_tpu_torch.web.app import BadPage, bucket_page, decode_page
app = create_app(device='cpu')
assert bucket_page(np.zeros((494, 734), np.uint8)).shape == (1, 496, 736, 1)
for call in (lambda: bucket_page(np.zeros((1600, 800), np.uint8)),
             lambda: decode_page(b'not an image')):
    try:
        call()
    except BadPage as exc:
        assert 'Pillow' in str(exc), exc
    else:
        raise AssertionError('no BadPage')
assert sys.modules['PIL'] is None and sys.modules['jax'] is None
assert not any(m.startswith(('PIL.', 'jax.', 'univer_ocr_tpu.'))
               for m in sys.modules)
print('ok')
'''
    out = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('ok')
