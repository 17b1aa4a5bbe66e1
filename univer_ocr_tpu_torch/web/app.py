"""Routes and the /train-ws namespace of the web app (univer_ocr_tpu/web/
app.py) on the stdlib server.

  * `POST /ocr`: one page in, `{"text": [paragraph][line]}` out, through
    the JAX package's serving configuration of the host cascade
    (`OCRPipeline(shape, weights, chunk=4, workers=4, precision='bf16')`,
    the CUDA kernels on the card), one pipeline per bucketed page shape.
    The body is an image file (decoded with Pillow, imported in the
    handler) or a `.npy` array of uint8 gray values, shape (H, W) or
    (1, H, W, 1), which needs no Pillow;
  * `/`, `/chars`, `/fonts`, `/train`, `/test-nn`, `GET /ocr`: the
    pages;
  * the demo page: `/generate_new` draws a new one, `/view_layers/<raw|
    demo>` shows its layers, `/image/<raw|demo>/<layer>` serves one as a
    PNG and `/interpret_data` decodes its text from the ground-truth
    layers (interpreter.interpret).  The page is rendered on first use
    (image_generator.generate_demo, 1920x1080) with Pillow and fonts;
    without Pillow these routes answer 503, naming it;
  * WS `/train-ws`: `start` runs the port's trainer (univer_ocr_tpu_torch/
    train.py) in a subprocess that reports back over the same namespace
    and whose output is piped to it; `stop` ends it; the trainer's
    `message` / `info` / `progress_tracker` events are rebroadcast to the
    browsers;
  * WS `/test-nn-ws`: `start` runs an NN battery (`test_gradients` or
    `test_identity`, `python -m univer_ocr_tpu_torch.test_nn NAME USE_GPU`)
    in a subprocess whose output is piped to the namespace; an unknown
    name is answered with `unknown test NAME`; `stop` ends it.

Importing the app imports neither Pillow nor JAX.
"""

import html
import io
import json
import random
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from ..device import resolve_device
from ..fonts import FONTS_LIST
from ..interpreter import interpret
from ..models.constants import TRAINED_WEIGHTS_PATH
from ..models.datasets import encode_X
from ..primitives import CHARS, encode_char
from ..weights import DEFAULT_CHECKPOINT, load_checkpoint
from .httpd import App, render_template

REPO_ROOT = Path(__file__).resolve().parents[2]

#: Page-shape buckets for /ocr uploads (the JAX package's menu): dims snap
#: up to the canonical serving page, then in 256-steps (all /16); beyond
#: the cap the page is downscaled to fit, keeping its aspect.  Each shape
#: gets its own pipeline.
OCR_H_MENU = (496, 752, 1008, 1264, 1520)
OCR_W_MENU = (736, 992, 1248, 1504, 1760, 2016)

NPY_MAGIC = b'\x93NUMPY'
DEMO_SIZE = (1920, 1080)
DEMO_MODES = ('raw', 'demo')


def serving_weights_path():
    """The checkpoint a new /ocr pipeline loads: the dashboard trainer's
    output (TRAINED_WEIGHTS_PATH, where `start` on /train-ws writes) once
    it exists, else the committed checkpoint.  The JAX package's app
    serves the file its trainer writes; the port's trainers may not write
    the committed checkpoint (weights.refuse_committed), so the app looks
    for theirs first."""
    return (TRAINED_WEIGHTS_PATH if TRAINED_WEIGHTS_PATH.exists()
            else DEFAULT_CHECKPOINT)


class BadPage(ValueError):
    """An upload the endpoint cannot read; its message is the 400's
    `error`."""


def bucket_page(image):
    """A PIL L image or an (H, W) uint8 array -> (1, Hb, Wb, 1) float32 on
    the shape menu, the page zero-padded in the centre.  A page over the
    cap (the menu's largest shape less 2 pixels of margin) is downscaled
    with Pillow's `resize`, as the JAX package's is; an array over the cap
    without Pillow raises BadPage."""
    if isinstance(image, np.ndarray):
        h, w = image.shape
    else:
        w, h = image.size
    cap_h, cap_w = OCR_H_MENU[-1] - 2, OCR_W_MENU[-1] - 2
    if h > cap_h or w > cap_w:
        if isinstance(image, np.ndarray):
            try:
                from PIL import Image
            except ImportError:
                raise BadPage(
                    f'page of {h}x{w} exceeds the {cap_h}x{cap_w} cap and '
                    'downscaling it needs Pillow, which is not installed'
                ) from None
            image = Image.fromarray(image)
        scale = min(cap_h / h, cap_w / w)
        image = image.resize((max(1, int(w * scale)),
                              max(1, int(h * scale))))
        w, h = image.size
    bh = next(s for s in OCR_H_MENU if s >= h + 2)
    bw = next(s for s in OCR_W_MENU if s >= w + 2)
    out = np.zeros((1, bh, bw, 1), np.float32)
    py, px = (bh - h) // 2, (bw - w) // 2
    out[:, py:py + h, px:px + w, :] = encode_X(image)
    return out


def decode_page(body):
    """An upload's bytes -> a uint8 (H, W) array (a .npy body) or a PIL L
    image; raises BadPage."""
    if body.startswith(NPY_MAGIC):
        try:
            arr = np.load(io.BytesIO(body), allow_pickle=False)
        except ValueError as exc:
            raise BadPage(f'unreadable .npy body: {exc}') from None
        if arr.ndim == 4 and arr.shape[0] == 1 and arr.shape[3] == 1:
            arr = arr[0, :, :, 0]
        if arr.dtype != np.uint8 or arr.ndim != 2 or 0 in arr.shape:
            raise BadPage('a .npy body must hold uint8 gray values of '
                          f'shape (H, W) or (1, H, W, 1), got {arr.dtype} '
                          f'{arr.shape}')
        return arr
    try:
        from PIL import Image
    except ImportError:
        raise BadPage('body must be a .npy array: reading images needs '
                      'Pillow, which is not installed') from None
    try:
        return Image.open(io.BytesIO(body)).convert('L')
    except Exception:
        raise BadPage('body must be an image or a .npy array') from None


class MissingPillow(RuntimeError):
    """A demo route ran without Pillow."""


def create_app(device=None, demo_seed=None):
    """The web app; its OCR pipelines run on `device` (None: the card,
    raising without one; 'cpu': the host), each with the weights of
    `serving_weights_path()` when it is built (random ones, as the JAX
    package's, when there is no file).  The demo pages draw from
    `random.Random(demo_seed)` (None: OS entropy).
    Stop it with `app.shutdown()`, which closes the pipelines."""
    device = resolve_device(device)
    app = App()
    app.device = device
    demo_rng = random.Random(demo_seed)
    demo_lock = threading.Lock()
    pipelines = {}
    #: held across get_pipeline + ocr_pages: one request at a time runs
    #: the cascade (ocr_pages sets the process-wide TF32 switches for
    #: its call; ops/precision.backend_flags)
    ocr_lock = threading.Lock()
    app.state['ocr_pipelines'] = pipelines

    @app.on_close
    def close_pipelines():
        with ocr_lock:
            for pipeline in pipelines.values():
                pipeline.close()
            pipelines.clear()

    # ------------------------------------------------------------------
    # Pages
    # ------------------------------------------------------------------
    @app.route('/')
    def index(query=None):
        return render_template('index.html')

    @app.route('/chars')
    def chars(query=None):
        rows = '\n'.join(
            f'<tr><td>{i}</td><td>{html.escape(repr(c))}</td>'
            f'<td><code>{encode_char(c)}</code></td></tr>'
            for i, c in enumerate(CHARS))
        return render_template('chars.html', rows=rows)

    @app.route('/train')
    def train(query=None):
        return render_template('train.html')

    @app.route('/test-nn')
    def test_nn(query=None):
        return render_template('test-nn.html')

    @app.route('/fonts')
    def fonts(query=None):
        rows = '\n'.join(
            f'<tr><td>{f.name}</td>'
            f'<td>{f.normal_path or "—"}</td>'
            f'<td>{f.bold_path or "—"}</td>'
            f'<td>{f.italic_path or "—"}</td>'
            f'<td>{f.bold_italic_path or "—"}</td></tr>'
            for f in FONTS_LIST)
        return render_template('fonts.html', rows=rows)

    # ------------------------------------------------------------------
    # The demo page
    # ------------------------------------------------------------------
    def get_demo_data(regenerate=False):
        """(raw, demo) layers of the demo page, rendered on first use."""
        with demo_lock:
            if regenerate or 'demo' not in app.state:
                try:
                    import PIL  # noqa: F401
                except ImportError as exc:
                    raise MissingPillow(
                        'the demo page is rendered with Pillow, which is '
                        f'not installed ({exc})') from None
                from ..image_generator import generate_demo
                app.state['demo'] = generate_demo(*DEMO_SIZE, demo_rng)
            return app.state['demo']

    def demo_route(handler):
        """A demo route that answers 503, naming Pillow, when it is
        missing."""
        def route(*args, **kwargs):
            try:
                return handler(*args, **kwargs)
            except MissingPillow as exc:
                return (503, 'text/plain; charset=utf-8', str(exc))
        return route

    def not_found(what):
        return (404, 'text/plain; charset=utf-8', f'no such {what}')

    @app.route('/generate_new')
    @demo_route
    def generate_new(query=None):
        get_demo_data(regenerate=True)
        return ('<!DOCTYPE html><meta http-equiv="refresh" '
                'content="0; url=/">Regenerated, redirecting…')

    @app.route('/view_layers/<mode>')
    @demo_route
    def view_layers(mode, query=None):
        if mode not in DEMO_MODES:
            return not_found(f'mode {mode!r}')
        layers = get_demo_data()[DEMO_MODES.index(mode)]
        checkboxes = '\n'.join(
            f'<label class="layer-toggle"><input type="checkbox" '
            f'data-layer="{name}" {"checked" if name == "image" else ""}>'
            f'{name}</label>'
            for name in layers)
        images = '\n'.join(
            f'<img class="layer" id="layer-{name}" '
            f'src="/image/{mode}/{name}" '
            f'style="display:{"block" if name == "image" else "none"}">'
            for name in layers)
        return render_template('view_layers.html', mode=mode,
                               checkboxes=checkboxes, images=images)

    @app.route('/image/<mode>/<type>')
    @demo_route
    def image(mode, type, query=None):
        if mode not in DEMO_MODES:
            return not_found(f'mode {mode!r}')
        layers = get_demo_data()[DEMO_MODES.index(mode)]
        if type not in layers:
            return not_found(f'layer {type!r}')
        from ..image_generator import to_bytesio
        return (200, 'image/png', to_bytesio(layers[type]).read())

    @app.route('/interpret_data')
    @demo_route
    def interpret_data(query=None):
        raw, _ = get_demo_data()
        rows = '\n'.join(
            f'<tr><td>{p}</td><td>{l}</td>'
            f'<td>{html.escape(text)}</td></tr>'
            for (p, l), text in sorted(interpret(raw).items()))
        return render_template('interpret_data.html', rows=rows)

    # ------------------------------------------------------------------
    # Online OCR endpoint
    # ------------------------------------------------------------------
    def get_pipeline(page_shape):
        """One OCRPipeline per page shape, built on first use with the
        current checkpoint; call with ocr_lock held."""
        if page_shape not in pipelines:
            from ..models.pipeline import OCRPipeline
            try:
                weights = load_checkpoint(serving_weights_path(), device)
            except FileNotFoundError:
                weights = None
            pipelines[page_shape] = OCRPipeline(
                page_shape, weights=weights, chunk=4, workers=4,
                precision='bf16', device=device)
        return pipelines[page_shape]

    def ocr_page(page):
        """A decoded upload -> its [paragraph][line] text."""
        X = bucket_page(page)
        with ocr_lock:
            return get_pipeline(tuple(X.shape)).ocr_pages([X])[0]

    app.get_pipeline = get_pipeline
    app.ocr_lock = ocr_lock

    @app.route('/ocr')
    def ocr_form(query=None):
        return render_template('ocr.html')

    @app.route('/ocr', methods=('POST',))
    def ocr(body=None, query=None):
        try:
            text = ocr_page(decode_page(body))
        except BadPage as exc:
            return (400, 'application/json',
                    json.dumps({'error': str(exc)}))
        return (200, 'application/json',
                json.dumps({'text': text}, ensure_ascii=False))

    # ------------------------------------------------------------------
    # WS /train-ws
    # ------------------------------------------------------------------
    def pipe_output(proc, namespace):
        for line in iter(proc.stdout.readline, b''):
            app.hub.broadcast(namespace, 'message',
                              line.decode('utf-8', 'replace'))
        proc.wait()
        app.hub.broadcast(namespace, 'message',
                          f'[process exited with code {proc.returncode}]\n')

    def start_subprocess(namespace, argv, state_key):
        if app.state.get(state_key) is not None \
                and app.state[state_key].poll() is None:
            app.hub.broadcast(namespace, 'message', 'already running\n')
            return
        proc = subprocess.Popen(
            argv, cwd=str(REPO_ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        app.state[state_key] = proc
        threading.Thread(target=pipe_output, args=(proc, namespace),
                         daemon=True).start()

    @app.on_close
    def stop_subprocesses():
        for key in ('train_proc', 'test_proc'):
            proc = app.state.get(key)
            if proc is not None and proc.poll() is None:
                proc.terminate()
                proc.wait()

    @app.ws_route('/train-ws')
    def train_ws(conn, app_):
        while True:
            msg = conn.recv_event()
            if msg is None:
                return
            event, data = msg.get('event'), msg.get('data')
            if event == 'start':
                data = data or {}
                use_gpu = str(data.get('use_gpu', True))
                # the trainer connects back to this server's port
                start_subprocess(
                    '/train-ws',
                    [sys.executable, '-u', '-m', 'univer_ocr_tpu_torch.train',
                     use_gpu, 'False', 'False', str(app.port)],
                    'train_proc')
            elif event == 'stop':
                proc = app.state.get('train_proc')
                if proc is not None and proc.poll() is None:
                    proc.terminate()
                app.hub.broadcast('/train-ws', 'stopped', None)
            elif event in ('message', 'info', 'progress_tracker'):
                # trainer client -> rebroadcast to browsers
                app.hub.broadcast('/train-ws', event, data, exclude=conn)

    # ------------------------------------------------------------------
    # WS /test-nn-ws
    # ------------------------------------------------------------------
    @app.ws_route('/test-nn-ws')
    def test_nn_ws(conn, app_):
        while True:
            msg = conn.recv_event()
            if msg is None:
                return
            event, data = msg.get('event'), msg.get('data')
            if event == 'start':
                data = data or {}
                test_name = data.get('test_name', 'test_gradients')
                if test_name not in ('test_gradients', 'test_identity'):
                    conn.send_event('message', f'unknown test {test_name}\n')
                    continue
                use_gpu = str(data.get('use_gpu', True))
                start_subprocess(
                    '/test-nn-ws',
                    [sys.executable, '-u', '-m', 'univer_ocr_tpu_torch.test_nn',
                     test_name, use_gpu],
                    'test_proc')
            elif event == 'stop':
                proc = app.state.get('test_proc')
                if proc is not None and proc.poll() is None:
                    proc.terminate()

    return app
