"""The web app's demo routes and the generate_data command of the port,
on the CPU: /generate_new, /view_layers/<raw|demo>, /image/<mode>/<layer>
(a PNG that decodes to the demo page's layer), /fonts and /interpret_data
(its rows JAX's interpret of JAX's demo page drawn from the same seed);
without Pillow the demo routes answer 503 naming it; `python -m
univer_ocr_tpu_torch generate_data` writes the corpus."""

import html
import io
import random
import re
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from univer_ocr_tpu.image_generator import generate_demo as jax_demo
from univer_ocr_tpu.interpreter import interpret as jax_interpret
from univer_ocr_tpu_torch.fonts import FONTS_LIST
from univer_ocr_tpu_torch.web import app as app_mod
from univer_ocr_tpu_torch.web import create_app

ROOT = Path(__file__).resolve().parents[1]
DEMO_SEED = 3


@pytest.fixture(scope='module')
def server(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(app_mod, 'TRAINED_WEIGHTS_PATH',
                   tmp_path_factory.mktemp('trained') / 'none.json')
        app = create_app(device='cpu', demo_seed=DEMO_SEED)
        app.start_background(port=0)
        yield app
        app.shutdown()


def get(app, path):
    with urllib.request.urlopen(f'http://127.0.0.1:{app.port}{path}',
                                timeout=120) as r:
        return r.status, r.headers.get('Content-Type', ''), r.read()


def test_demo_routes(server):
    """The first demo page is JAX's demo page of the same seed: the rows
    of /interpret_data are JAX's interpret of it; its layer views list
    every layer and each /image is its layer's PNG; /generate_new draws
    the next page from the same stream."""
    from PIL import Image
    status, ctype, body = get(server, '/interpret_data')
    assert status == 200 and 'text/html' in ctype
    random.seed(DEMO_SEED)
    j_raw, j_demo = jax_demo(*app_mod.DEMO_SIZE)
    want = ''.join(f'<tr><td>{p}</td><td>{l}</td>'
                   f'<td>{html.escape(text)}</td></tr>'
                   for (p, l), text in sorted(jax_interpret(j_raw).items()))
    rows = ''.join(re.findall(r'<tr><td>.*?</tr>', body.decode()))
    assert rows == want and rows

    for mode, layers in (('raw', j_raw), ('demo', j_demo)):
        status, _, body = get(server, f'/view_layers/{mode}')
        assert status == 200
        assert re.findall(r'src="/image/%s/(\w+)"' % mode,
                          body.decode()) == list(layers)
    status, ctype, png = get(server, '/image/raw/image')
    assert status == 200 and ctype == 'image/png'
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  np.asarray(j_raw['image']))
    _, _, png = get(server, '/image/demo/guidelines')
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  np.asarray(j_demo['guidelines']))

    first = server.state['demo']
    status, _, body = get(server, '/generate_new')
    assert status == 200 and b'refresh' in body
    assert server.state['demo'] is not first
    j_next, _ = jax_demo(*app_mod.DEMO_SIZE)
    np.testing.assert_array_equal(np.asarray(server.state['demo'][0]['image']),
                                  np.asarray(j_next['image']))


def test_fonts_route(server):
    status, _, body = get(server, '/fonts')
    assert status == 200
    for font in FONTS_LIST:
        assert f'<td>{font.name}</td>'.encode() in body
        assert str(font.normal_path).encode() in body


def test_demo_routes_without_pillow():
    """With PIL blocked the app starts, /fonts answers, and every demo
    route answers 503 with a message naming Pillow."""
    code = '''
import sys
sys.modules['PIL'] = None
from univer_ocr_tpu_torch.web import create_app
app = create_app(device='cpu')
for path in ('/generate_new', '/view_layers/raw', '/image/raw/image',
             '/interpret_data'):
    status, ctype, body = app.dispatch(path, {})
    assert status == 503 and 'Pillow' in body, (path, status, body)
assert '<td>DejaVu Sans</td>' in app.dispatch('/fonts', {})
print('ok')
'''
    out = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_generate_data_command(tmp_path):
    """`python -m univer_ocr_tpu_torch generate_data` at tiny lengths:
    the 17 layers of 1 training and 1 validation page, the pages
    generate_data renders for its seed."""
    out = subprocess.run(
        [sys.executable, '-m', 'univer_ocr_tpu_torch', 'generate_data',
         '--train', '1', '--validation', '1', '--seed', '4', '--out',
         str(tmp_path), '--workers', '2'],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert '1 train and 1 validation pages' in out.stdout
    for split in ('train', 'validation'):
        assert len(list((tmp_path / split).glob('0_*.png'))) == 17
    from PIL import Image

    from univer_ocr_tpu_torch.models.train_data_generator import render_page
    want = render_page(720, 480, rng=random.Random(5))
    with Image.open(tmp_path / 'validation' / '0_char_full_box.png') as png:
        np.testing.assert_array_equal(np.asarray(png),
                                      np.asarray(want['char_full_box']))
