"""The port's data side (models/train_data_generator.py, datasets.py,
generate_data.py, evaluation.build_eval_corpus) against the JAX
package's, on the CPU, with no tolerance: each feed worker's stream, the
rendered datasets, the eval corpus and the PNG corpus equal JAX's byte
for byte; the spawned feed delivers and stops."""

import json
import random
import time
from pathlib import Path

import numpy as np
import pytest

from univer_ocr_tpu.models import datasets as jds
from univer_ocr_tpu.models import train_data_generator as jtdg
from univer_ocr_tpu_torch.models import datasets as tds
from univer_ocr_tpu_torch.models import generate_data as tgd
from univer_ocr_tpu_torch.models import train_data_generator as ttdg

ROOT = Path(__file__).resolve().parents[1]
EVAL_PAGES = ROOT / 'univer_ocr_tpu_torch' / 'fixtures' / 'eval_pages.npz'
EVAL_LAYERS = ROOT / 'univer_ocr_tpu_torch' / 'fixtures' / 'eval_layers.npz'


class _Stop:
    def __init__(self):
        self.set_ = False

    def is_set(self):
        return self.set_


class _Sink:
    """A feed queue that stops its worker after n items."""

    def __init__(self, stop, n):
        self.stop, self.n, self.items = stop, n, []

    def cancel_join_thread(self):
        pass

    def put(self, item, timeout=None):
        self.items.append(item)
        if len(self.items) == self.n:
            self.stop.set_ = True


def _assert_encoded_equal(got, want):
    assert sorted(got) == sorted(want)
    for tag in want:
        assert got[tag].dtype == want[tag].dtype
        np.testing.assert_array_equal(got[tag], want[tag], err_msg=tag)


@pytest.mark.parametrize('worker', [1, 2])
def test_feed_worker_streams_equal_jax(worker):
    """Worker i of a DataGenerator seeded s draws from s + 977 i and gives
    the pages JAX's render gives after random.seed(s + 977 i)."""
    gen = ttdg.DataGenerator(queue_size=4, workers=3, seed=40,
                             func_args=(360, 240))
    assert gen.seeds == [40, 40 + 977, 40 + 2 * 977]
    stop = _Stop()
    sink = _Sink(stop, 2)
    ttdg._feed_worker(stop, sink, gen.seeds[worker],
                      ttdg.generate_train_data, (360, 240), {})
    random.seed(40 + 977 * worker)
    for item in sink.items:
        _assert_encoded_equal(item, jtdg.generate_train_data(360, 240))


def test_data_generator_spawns_delivers_and_stops():
    """Two spawned workers replay fixture pages: 2 x queue_size items,
    each the fixture page it names; stop() ends both within 5 s."""
    with np.load(EVAL_LAYERS) as f:
        names = json.loads(str(f['layer_names']))
        layers = f['layers']
    gen = ttdg.DataGenerator(queue_size=3, generator_func=ttdg.replay_pages,
                             func_args=(str(EVAL_LAYERS),), workers=2,
                             seed=7).start()
    try:
        items = [gen.get_data() for _ in range(2 * gen.queue_size)]
    finally:
        t0 = time.perf_counter()
        gen.stop()
        stopped = time.perf_counter() - t0
    assert stopped < 5.0 and not any(p.is_alive() for p in gen.workers)
    assert len(items) == 6
    for index, encoded in items:
        planes = dict(zip(names, layers[index]))
        _assert_encoded_equal(encoded, tds.encode_layers(planes))


def test_data_generator_raises_when_its_workers_die(tmp_path):
    """A task that fails in every worker ends the feed with an error, not
    a wait for items that never come."""
    gen = ttdg.DataGenerator(queue_size=2, generator_func=ttdg.replay_pages,
                             func_args=(str(tmp_path / 'missing.npz'),),
                             workers=2, seed=0).start()
    try:
        with pytest.raises(RuntimeError, match='every feed worker exited'):
            gen.get_data()
    finally:
        gen.stop()


def test_generator_dataset_equals_jax():
    ds = tds.GeneratorDataset(2, 360, 240, random.Random(9))
    tags = ['paragraph', 'line', 'char']
    ours = [ds.get(0, layer_tags=tags), ds.get(1, layer_tags=tags)]
    random.seed(9)
    jds_ = jds.GeneratorDataset(2, 360, 240)
    for got in ours:
        _assert_encoded_equal(got, jds_.get(0, layer_tags=tags))


def test_codecs_equal_jax():
    rs = np.random.RandomState(0)
    X = rs.rand(1, 24, 40, 1)
    np.testing.assert_array_equal(np.asarray(tds.decode_X([X])),
                                  np.asarray(jds.decode_X([X])))
    y = rs.rand(1, 24, 40, 3) * 3 - 1
    for normalize in (False, True):
        for ours, theirs in zip(tds.decode_y(y, normalize),
                                jds.decode_y(y, normalize)):
            assert [np.asarray(i).tolist() for i in ours] == \
                [np.asarray(i).tolist() for i in theirs]
        ours, theirs = tds.decode_ys([y, y[..., :1]]), jds.decode_ys(
            [y, y[..., :1]])
        assert [[np.asarray(i).tolist() for i in part] for part in ours] == \
            [[np.asarray(i).tolist() for i in part] for part in theirs]
    raw = ttdg.render_page(360, 240, rng=random.Random(2))
    flat = [raw[name].convert('L') for name in tds.get_layer_names()]
    for a, b in zip(tds.encode_ys(flat), jds.encode_ys(flat)):
        np.testing.assert_array_equal(a, b)
    _assert_encoded_equal(ttdg.encode_layers(raw), jtdg.encode_layers(raw))


def test_build_eval_corpus_equals_the_committed_corpus():
    """build_eval_corpus(8, 123) gives eval_pages.npz (JAX's corpus)
    byte for byte: the pages as float32 u8 / 255 and the truths."""
    from univer_ocr_tpu_torch.models.evaluation import (build_eval_corpus,
                                                        eval_corpus)
    pages, truths = build_eval_corpus(8, 123)
    stored_pages, stored_truths = eval_corpus(8, 123)
    assert len(pages) == 8 and truths == stored_truths
    for got, want in zip(pages, stored_pages):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with np.load(EVAL_PAGES) as f:
        np.testing.assert_array_equal(
            np.stack([np.round(p[0, :, :, 0] * 255) for p in pages]),
            f['pages'])


def test_generate_data_writes_jax_pages(tmp_path):
    """2 training and 1 validation page: page j from seed + j, every
    layer's PNG pixel-equal to JAX's render_page after random.seed(seed
    + j)."""
    from PIL import Image
    tgd.generate_data(tmp_path, 2, 1, seed=31, workers=2)
    for j, (split, i) in enumerate([('train', 0), ('train', 1),
                                    ('validation', 0)]):
        random.seed(31 + j)
        want = jtdg.render_page(720, 480, False)
        assert sorted(p.name for p in (tmp_path / split).glob(f'{i}_*')) \
            == sorted(f'{i}_{name}.png' for name in want)
        for name, image in want.items():
            with Image.open(tmp_path / split / f'{i}_{name}.png') as png:
                assert png.mode == image.mode
                np.testing.assert_array_equal(np.asarray(png),
                                              np.asarray(image))


def test_corpus_or_generator_picks_the_corpus(tmp_path):
    rng = random.Random(0)
    assert isinstance(tds._corpus_or_generator(3, tmp_path, rng),
                      tds.GeneratorDataset)
    page = ttdg.render_page(360, 240, rng=random.Random(5))
    for name, image in page.items():
        image.save(tmp_path / f'0_{name}.png')
    corpus = tds._corpus_or_generator(3, tmp_path, rng)
    assert isinstance(corpus, tds.Dataset) and len(corpus) == 3
    _assert_encoded_equal(corpus.get(0), ttdg.encode_layers(page))


def test_crop_and_rotate_chain_decodes_as_jax(tmp_path, monkeypatch):
    """The host crop chain of models/crop_and_rotate_benchmark.py on a
    rendered page (ground-truth layers through ParagraphCrop, LineCrop,
    CharLabel and PredToText, 2 thread workers) writes JAX's decoded text
    byte for byte, with one line per line of interpret()."""
    from univer_ocr_tpu.models import crop_and_rotate_benchmark as jcb
    from univer_ocr_tpu_torch.interpreter import interpret
    from univer_ocr_tpu_torch.models import crop_and_rotate_benchmark as tcb
    monkeypatch.setattr(tcb, 'OUTPUT_PATH', tmp_path / 'port')
    monkeypatch.setattr(jcb, 'OUTPUT_PATH', tmp_path / 'jax')
    timers, texts = tcb.run_chain(
        tds.GeneratorDataset(1, 720, 480, random.Random(3)), 2,
        save_text=True)
    assert list(timers) == list(tcb.STAGES)
    random.seed(3)
    jcb.run_chain(jds.GeneratorDataset(1, 720, 480), 2, save_text=True)
    assert (tmp_path / 'port' / 'decoded.txt').read_bytes() == \
        (tmp_path / 'jax' / 'decoded.txt').read_bytes()
    truth = interpret(ttdg.render_page(720, 480, rng=random.Random(3)))
    assert sum(map(len, texts[0])) == len(truth)
