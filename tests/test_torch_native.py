"""The port's native host CV (univer_ocr_tpu_torch/native.py, its own copy
of the JAX package's C++, built with g++ at first use) against scipy and
the JAX package's native library (loaded by the JAX package, never by the
port): labels, counts and boxes equal exactly on random masks and on the
fixture pages' paragraph and Line band masks; the port's own statistics
pass (label_stats) equals scipy's labels, boxes and per-label centres,
bit for bit; rotate and zoom equal the JAX package's native output
exactly (the same source and flags); the four call sites label natively
and give what scipy's labels give; the host cascade's text of the fixture
pages is unchanged; a failed build raises; builds by several processes at
once land one library."""

import ctypes
import subprocess
import sys
from multiprocessing.pool import ThreadPool
from pathlib import Path

import numpy as np
import pytest
from scipy import ndimage

from univer_ocr_tpu import native as jax_native
from univer_ocr_tpu.interpreter import interpreter as jax_interpreter
from univer_ocr_tpu_torch import interpreter, native
from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
from univer_ocr_tpu_torch.ops.kernels import _build
from univer_ocr_tpu_torch.weights import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / 'univer_ocr_tpu_torch' / 'fixtures' / 'smoke_pages.npz'
PAGE_SHAPE = (1, 496, 736, 1)


def scipy_label(mask):
    labels, n = ndimage.label(np.asarray(mask))
    return labels.astype(np.int32), n


def scipy_label_stats(mask):
    """native.label_stats from scipy's labels: a mask per label."""
    labels, n = scipy_label(mask)
    comps = [np.argwhere(labels == k) for k in range(1, n + 1)]
    boxes = [(y.start, y.stop, x.start, x.stop)
             for y, x in ndimage.find_objects(labels)]
    return (labels, n, np.array([len(c) for c in comps], np.int64),
            np.array([c.mean(axis=0) for c in comps]).reshape(n, 2),
            np.array(boxes, np.int32).reshape(n, 4))


@pytest.fixture(scope='module', autouse=True)
def jax_library():
    """The JAX package's committed library, loaded by the JAX package."""
    assert jax_native.available()


@pytest.fixture(scope='module')
def host_run():
    """The host cascade on the 4 fixture pages (chunk 4, 'highest', CPU),
    with the paragraph masks and the Line band masks it labelled, and
    how often each labeller ran."""
    with np.load(FIXTURE) as f:
        pages, texts = f['pages'], __import__('json').loads(str(f['texts']))
    seen = {'para': [], 'bands': [], 'native': 0, 'scipy': 0}
    native_label, scipy_label_fn = native.label, ndimage.label
    native_stats = native.label_stats

    def counted_native(mask):
        seen['native'] += 1
        return native_label(mask)

    def counted_stats(mask):
        seen['native'] += 1
        return native_stats(mask)

    def counted_scipy(*args, **kwargs):
        seen['scipy'] += 1
        return scipy_label_fn(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp, OCRPipeline(
            PAGE_SHAPE, weights=load_checkpoint(device='cpu'), chunk=4,
            workers=2, collapse_runs=4, precision='highest',
            device='cpu') as pipeline:
        ocr_chunk, run_line = pipeline._ocr_chunk, pipeline._run_line_batched

        def keep_para(chunk, mono, para):
            seen['para'].extend(para[:, :, :, 0].copy())
            return ocr_chunk(chunk, mono, para)

        def keep_bands(crops):
            out = run_line(crops)
            seen['bands'].extend(np.asarray(b)[0, :, :, c]
                                 for b in out for c in range(b.shape[-1]))
            return out

        mp.setattr(native, 'label', counted_native)
        mp.setattr(native, 'label_stats', counted_stats)
        mp.setattr(ndimage, 'label', counted_scipy)
        mp.setattr(pipeline, '_ocr_chunk', keep_para)
        mp.setattr(pipeline, '_run_line_batched', keep_bands)
        got = pipeline.ocr_pages([p[None, :, :, None] for p in pages])
    return got, texts, seen


def _same_labels(mask):
    """Port native, scipy and JAX native: labels, count, boxes."""
    got, n = native.label(mask)
    exp, m = scipy_label(mask)
    jax_got, k = jax_native.label(mask)
    assert got.dtype == np.int32 and n == m == k
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(got, jax_got)
    boxes = native.find_objects(got, n)
    assert boxes == ndimage.find_objects(exp) == jax_native.find_objects(
        jax_got, k)
    return n


@pytest.mark.parametrize('seed, shape, density', [
    (0, (64, 80), 0.3), (1, (1, 97), 0.5), (2, (120, 33), 0.6),
    (3, (200, 300), 0.45)])
def test_labels_equal_scipy_and_jax_native_on_random_masks(seed, shape,
                                                          density):
    """Exact equality (no tolerance), on boolean and on non-contiguous
    uint8 views."""
    mask = np.random.default_rng(seed).random(shape) < density
    assert _same_labels(mask) > 0 or shape[0] == 1
    wide = np.zeros(shape + (2,), np.uint8)
    wide[..., 1] = mask
    _same_labels(wide[..., 1])


def test_labels_equal_on_the_fixture_pages_masks(host_run):
    """The paragraph masks of the 4 fixture pages and every Line band
    channel of their chunk, as the host cascade labelled them: exact."""
    _, _, seen = host_run
    assert len(seen['para']) == 4 and len(seen['bands']) > 8
    assert sum(_same_labels(m > 0) for m in seen['para']) >= 4
    for bands in seen['bands']:
        _same_labels(bands > np.mean(bands))


def test_host_cascade_labels_natively_and_its_text_is_unchanged(host_run):
    """The JAX host cascade's stored text, with every label native: one
    call per page (the paragraph crop) and per band channel (the line
    crop), none through scipy."""
    got, texts, seen = host_run
    assert got == texts
    assert seen['native'] >= 4 + len(seen['bands']) and seen['scipy'] == 0


def _site_outputs(site, host_run):
    _, _, seen = host_run
    para = seen['para'][0]
    if site == 'label_layer':
        return [interpreter.label_layer(b[None, :, :, None])
                for b in seen['bands'][:6]]
    if site == '_band_blob_stats':
        return [OCRPipeline._band_blob_stats(b.astype(np.float32))
                for b in seen['bands'][:6]]
    pipeline = OCRPipeline(PAGE_SHAPE, weights=None, device='cpu')
    try:
        if site == '_crop_page':
            mono = np.random.default_rng(0).random(PAGE_SHAPE, np.float32)
            return pipeline._crop_page(mono, para[None, :, :, None])
        return pipeline._page_paragraph_plans(0, para)
    finally:
        pipeline.close()


def _assert_same(got, exp):
    if isinstance(exp, dict):
        assert sorted(got) == sorted(exp)
        for key in exp:
            _assert_same(got[key], exp[key])
    elif isinstance(exp, (list, tuple)):
        assert type(got) is type(exp) and len(got) == len(exp)
        for g, e in zip(got, exp):
            _assert_same(g, e)
    elif isinstance(exp, np.ndarray):
        np.testing.assert_array_equal(got, exp)
    else:
        assert got == exp


@pytest.mark.parametrize('site', ['_crop_page', '_page_paragraph_plans',
                                  '_band_blob_stats', 'label_layer'])
def test_each_call_site_labels_natively(site, host_run, monkeypatch):
    """The four sites where JAX labels natively: with the native labels
    (`label`, or `label_stats` where the site takes each component's
    statistics) they give exactly what they give with scipy's, and they
    call the native CCL."""
    calls = []
    label, label_stats = native.label, native.label_stats
    monkeypatch.setattr(native, 'label',
                        lambda m: calls.append(1) or label(m))
    monkeypatch.setattr(native, 'label_stats',
                        lambda m: calls.append(1) or label_stats(m))
    got = _site_outputs(site, host_run)
    assert calls
    monkeypatch.setattr(native, 'label', scipy_label)
    monkeypatch.setattr(native, 'label_stats', scipy_label_stats)
    exp = _site_outputs(site, host_run)
    assert len(exp) > 0
    _assert_same(got, exp)


def _u_shapes():
    """Two U shapes whose arms take provisional labels of their own until
    the bottom bar merges them, beside a one-pixel component."""
    mask = np.zeros((9, 14), bool)
    mask[1:7, 1] = mask[1:7, 5] = mask[6, 1:6] = True
    mask[2:8, 8] = mask[2:8, 12] = mask[7, 8:13] = True
    mask[0, 10] = True
    return mask


def _checkerboard(shape):
    """Every other pixel set: one-pixel components, more than
    label_stats makes room for at first."""
    return (np.add.outer(np.arange(shape[0]), np.arange(shape[1])) % 2
            == 0)


@pytest.mark.parametrize('case', [
    'random 0.05', 'random 0.3', 'random 0.5', 'random 0.7', 'empty',
    'one pixel', 'full', '1 x W', 'H x 1', 'one-pixel components',
    'u shapes'])
def test_label_stats_equal_scipy(case):
    """label_stats against scipy's labels and find_objects and
    np.argwhere(labels == k).mean(axis=0): labels, count and boxes equal,
    the counts equal, the centres bit-equal."""
    rng = np.random.default_rng(len(case))
    if case.startswith('random'):
        mask = rng.random((57, 83)) < float(case.split()[1])
    else:
        mask = {
            'empty': lambda: np.zeros((12, 20), bool),
            'one pixel': lambda: np.eye(1, 1, dtype=bool),
            'full': lambda: np.ones((15, 11), bool),
            '1 x W': lambda: rng.random((1, 101)) < 0.5,
            'H x 1': lambda: rng.random((101, 1)) < 0.5,
            'one-pixel components': lambda: _checkerboard((23, 31)),
            'u shapes': _u_shapes,
        }[case]()
    labels, n, counts, centres, boxes = native.label_stats(mask)
    exp, m = ndimage.label(mask)
    assert n == m
    assert (counts.dtype, centres.dtype, boxes.dtype) == (
        np.int64, np.float64, np.int32)
    assert counts.shape == (n,) and centres.shape == boxes.shape[:1] + (2,)
    np.testing.assert_array_equal(labels, exp)
    assert [(slice(y0, y1), slice(x0, x1))
            for y0, y1, x0, x1 in boxes.tolist()] == ndimage.find_objects(exp)
    for k in range(1, n + 1):
        coords = np.argwhere(exp == k)
        assert counts[k - 1] == len(coords)
        assert centres[k - 1].tobytes() == coords.mean(axis=0).tobytes()
    if case == 'one-pixel components':
        assert n > 64
    if case == 'u shapes':
        assert n == 3


@pytest.mark.parametrize('angle, order', [
    (17.0, 1), (135.0, 1), (-3.5, 0), (90.0, 1), (2.0, 0)])
def test_rotate_and_zoom_equal_jax_native(angle, order):
    """Bit-equal to the JAX package's library: the same C++ source, flags
    and compiler."""
    arr = np.random.default_rng(7).random((40, 61, 2), np.float32)
    np.testing.assert_array_equal(native.rotate(arr, angle, order),
                                  jax_native.rotate(arr, angle, order))
    out_h, out_w = 32, int(30 + angle % 50)
    np.testing.assert_array_equal(native.zoom(arr, out_h, out_w),
                                  jax_native.zoom(arr, out_h, out_w))


@pytest.mark.parametrize('use_native', [False, True])
def test_rotate_array_follows_use_native_rotate(use_native, monkeypatch):
    """USE_NATIVE_ROTATE off (the default of both packages): scipy's
    rotation; on: the native one, as JAX's rotate_array gives it."""
    arr = np.random.default_rng(3).random((1, 30, 45, 1), np.float32)
    monkeypatch.setattr(interpreter, 'USE_NATIVE_ROTATE', use_native)
    monkeypatch.setattr(jax_interpreter, 'USE_NATIVE_ROTATE', use_native)
    got = interpreter.rotate_array(arr, 12.0)
    np.testing.assert_array_equal(got, jax_interpreter.rotate_array(arr,
                                                                    12.0))
    scipy_rotated = ndimage.rotate(arr, 12.0, axes=(2, 1), order=1)
    assert np.array_equal(got, scipy_rotated) is not use_native


def test_threads_label_concurrently():
    """The calls release the interpreter lock; results from 4 threads
    equal the serial ones."""
    rng = np.random.default_rng(11)
    masks = [rng.random((300, 400)) < 0.4 for _ in range(8)]
    with ThreadPool(4) as pool:
        threaded = pool.map(native.label, masks)
    for (got, n), mask in zip(threaded, masks):
        exp, m = native.label(mask)
        assert n == m
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize('fault', ['bad source', 'no compiler'])
def test_a_failed_build_raises(fault, tmp_path, monkeypatch):
    """No quiet fallback to scipy: the build raises, with g++'s output."""
    source = tmp_path / 'broken.cpp'
    source.write_text('extern "C" int ccl_4conn( { return 0; }\n')
    monkeypatch.setattr(native, 'SOURCE', source)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    if fault == 'no compiler':
        monkeypatch.setattr(native.shutil, 'which', lambda name: None)
        match = 'g.. not found'
    else:
        match = '(?s)g.. failed .*error'
    with pytest.raises(RuntimeError, match=match):
        native.build()
    assert not list((tmp_path / 'build').glob('*.so'))


def test_builds_at_once_land_one_library(tmp_path):
    """Three processes building into one empty directory: each loads a
    library, one file lands, no temporary file is left."""
    code = ('import sys, pathlib; from univer_ocr_tpu_torch import native; '
            'native.BUILD_DIR = pathlib.Path(sys.argv[1]); '
            'print(native.library()._name)')
    procs = [subprocess.Popen([sys.executable, '-c', code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        native.library_path().name]
    assert set(outs) == {str(tmp_path / native.library_path().name)}


def test_the_port_loads_its_own_library():
    """From build/native/, never the JAX package's committed .so; the host
    source stays out of the CUDA kernels' build."""
    path = Path(native.library()._name)
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path != Path(jax_native._LIB_PATH)
    assert native.SOURCE.parent.parent == _build.CSRC_DIR
    assert native.SOURCE not in _build.sources()
    loaded = ctypes.CDLL(str(path))
    assert hasattr(loaded, 'ccl_4conn')
