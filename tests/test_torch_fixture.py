"""The committed smoke fixture, univer_ocr_tpu_torch/fixtures/
smoke_pages.npz: 4 synthetic pages (496x736 uint8, rendered from a fixed
seed by the port's generator, which draws the pages the JAX package's
draws, as bench.py renders its pages),
the text the JAX host cascade gives for each on the CPU (`texts`), the
text its device cascade gives in the parity mode (`device_texts`:
`exact_bands=True`, 'highest', `collapse_runs=4`), in the tables mode
(`tables_texts`: `exact_bands=False`, sampler 'twopass',
`fused_tail=False`, 'highest', `collapse_runs=4`) and in its serving
default, 'highest', `collapse_runs=4`: the 4 pages in one call, through
the device chunk planner and the fused tail (`fused_texts`), and each page
alone, through the single-page chain (`chain_texts`), with whether the
chain left the page to its host-planned fallback (`chain_fallbacks`);
and the serving default's chunk text of the first 2 pages in 'bf16'
(`fused_bf16_texts`, the plain layers in bfloat16 as JAX runs them on the
CPU); and what the JAX package's `POST /ocr` answers (`ocr_texts`: its
bucket_page, then its 'bf16' host cascade at chunk 4 and 4 workers, on
the CPU) for each page cropped by one pixel on every side (494x734,
which buckets to 496x736; `crop`) and for the first 2 pages whole (which
bucket to 752x992; `whole`).
chip_smoke.py drives the port on the card with these pages, which the
card machine cannot render (it has no Pillow and no fonts).

Regenerate with `JAX_PLATFORMS=cpu python tests/test_torch_fixture.py`."""

import json
import random
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / 'univer_ocr_tpu_torch' / 'fixtures' / 'smoke_pages.npz'
PAGE_SHAPE = (1, 496, 736, 1)
SEED = 2024
N_PAGES = 4


def load_fixture(key='texts'):
    with np.load(FIXTURE) as f:
        return f['pages'], json.loads(str(f[key]))


def _well_formed(texts):
    assert len(texts) == N_PAGES
    assert all(isinstance(line, str)
               for page in texts for para in page for line in para)
    assert sum(len(para) for page in texts for para in page) > 0


def test_fixture_is_small_and_well_formed():
    assert FIXTURE.stat().st_size <= 1 << 20
    pages, texts = load_fixture()
    assert pages.shape == (N_PAGES,) + PAGE_SHAPE[1:3]
    assert pages.dtype == np.uint8
    _well_formed(texts)


def test_fixture_holds_the_device_cascade_text():
    """The device cascade's text has the host cascade's structure on these
    pages: as many paragraphs per page, in the same order (both label the
    same paragraph mask), each with some lines."""
    _, texts = load_fixture()
    _, device_texts = load_fixture('device_texts')
    _well_formed(device_texts)
    assert [len(page) for page in device_texts] == [len(page)
                                                     for page in texts]


def test_fixture_holds_the_tables_text():
    """The tables mode's text keeps the parity mode's paragraphs, each
    with some lines."""
    _, device_texts = load_fixture('device_texts')
    _, tables_texts = load_fixture('tables_texts')
    _well_formed(tables_texts)
    assert [len(page) for page in tables_texts] == [len(page)
                                                     for page in device_texts]


def test_fixture_holds_the_fused_text():
    """The serving default's chunk text keeps the tables mode's
    paragraphs, each with some lines."""
    _, tables_texts = load_fixture('tables_texts')
    _, fused_texts = load_fixture('fused_texts')
    _well_formed(fused_texts)
    assert [len(page) for page in fused_texts] == [len(page)
                                                    for page in tables_texts]


def test_fixture_holds_the_chain_text():
    """The single-page chain's text of each page: the chunk path's
    paragraphs (its planner labels the same mask), and a fallback flag per
    page."""
    _, fused_texts = load_fixture('fused_texts')
    _, chain_texts = load_fixture('chain_texts')
    _, fallbacks = load_fixture('chain_fallbacks')
    _well_formed(chain_texts)
    assert [len(page) for page in chain_texts] == [len(page)
                                                    for page in fused_texts]
    assert len(fallbacks) == N_PAGES
    assert all(isinstance(flag, bool) for flag in fallbacks)


def test_fixture_holds_the_fused_bf16_text():
    """The serving default's 'bf16' text of the first 2 pages keeps the
    'highest' text's paragraphs."""
    _, fused_texts = load_fixture('fused_texts')
    _, bf16_texts = load_fixture('fused_bf16_texts')
    assert len(bf16_texts) == 2
    assert sum(len(para) for page in bf16_texts for para in page) > 0
    assert [len(page) for page in bf16_texts] == [len(page)
                                                  for page in fused_texts[:2]]


def test_fixture_holds_the_ocr_text():
    """The /ocr text of the 4 cropped pages and the 2 whole ones, each
    with some lines."""
    _, ocr_texts = load_fixture('ocr_texts')
    assert sorted(ocr_texts) == ['crop', 'whole']
    assert len(ocr_texts['crop']) == N_PAGES
    assert len(ocr_texts['whole']) == 2
    for texts in ocr_texts.values():
        assert all(sum(len(para) for para in page) > 0 for page in texts)


def ocr_bodies(pages):
    """The pages /ocr is driven with: each cropped by one pixel on every
    side, then the first 2 whole."""
    return ([np.ascontiguousarray(p[1:-1, 1:-1]) for p in pages],
            list(pages[:2]))


def jax_ocr_texts(pages, weights):
    """The JAX package's /ocr answers for ocr_bodies(pages): its
    bucket_page and its serving pipeline per page shape."""
    from PIL import Image
    from univer_ocr_tpu.models.pipeline import OCRPipeline
    from univer_ocr_tpu.web.app import bucket_page
    pipelines, out = {}, {}
    for key, bodies in zip(('crop', 'whole'), ocr_bodies(pages)):
        out[key] = []
        for body in bodies:
            X = bucket_page(Image.fromarray(body))
            if X.shape not in pipelines:
                pipelines[X.shape] = OCRPipeline(
                    X.shape, weights=weights, chunk=4, workers=4,
                    precision='bf16')
            out[key].append(pipelines[X.shape].ocr_pages([X])[0])
    return out


def test_port_reproduces_the_fixture_text_on_cpu():
    from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
    from univer_ocr_tpu_torch.weights import load_checkpoint
    pages, texts = load_fixture()
    with OCRPipeline(PAGE_SHAPE, weights=load_checkpoint(device='cpu'),
                     chunk=N_PAGES, workers=2, collapse_runs=4,
                     precision='highest', device='cpu') as pipeline:
        got = pipeline.ocr_pages([p[None, :, :, None] for p in pages])
    assert got == texts


def render_pages():
    """The fixture's pages, rendered by the port's generator: N_PAGES
    pages of 720x480 drawn from one random.Random(SEED), as uint8 gray
    (the JAX package's generate_picture after random.seed(SEED) draws
    the same pages)."""
    from univer_ocr_tpu_torch.models.train_data_generator import (
        generate_picture)
    rng = random.Random(SEED)
    return np.stack([
        np.asarray(generate_picture(720, 480, False, rng=rng)['image']
                   .convert('L'))
        for _ in range(N_PAGES)])


def test_fixture_pages_are_the_ports_render():
    with np.load(FIXTURE) as f:
        np.testing.assert_array_equal(render_pages(), f['pages'])


def generate():
    """Render the pages and record the text of the JAX host cascade and
    of its device cascade's parity mode, tables mode and serving default
    (chunk and single page)."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    sys.path.insert(0, str(ROOT))
    from univer_ocr_tpu.models.pipeline import OCRPipeline
    from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

    pages = render_pages()
    assert pages.shape == (N_PAGES,) + PAGE_SHAPE[1:3], pages.shape
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    pipeline = OCRPipeline(PAGE_SHAPE, weights=weights, chunk=N_PAGES,
                           workers=2, device_cascade=False,
                           precision='highest', collapse_runs=4)
    texts = pipeline.ocr_pages([p[None, :, :, None] for p in pages])
    device = OCRPipeline(PAGE_SHAPE, weights=weights, chunk=N_PAGES,
                         workers=2, device_cascade=True, exact_bands=True,
                         precision='highest', collapse_runs=4)
    device_texts = device.ocr_pages([p[None, :, :, None] for p in pages])
    tables = OCRPipeline(PAGE_SHAPE, weights=weights, chunk=N_PAGES,
                         workers=2, device_cascade=True, exact_bands=False,
                         sampler='twopass', fused_tail=False,
                         precision='highest', collapse_runs=4)
    tables_texts = tables.ocr_pages([p[None, :, :, None] for p in pages])
    fused = OCRPipeline(PAGE_SHAPE, weights=weights, chunk=N_PAGES,
                        workers=2, device_cascade=True, precision='highest',
                        collapse_runs=4)
    assert fused.fused_tail and fused._single_page_chain is not None
    fused_texts = fused.ocr_pages([p[None, :, :, None] for p in pages])
    chain_texts, chain_fallbacks = [], []
    for p in pages:
        before = fused.escalation_stats.get('chain_fallback', 0)
        chain_texts.extend(fused.ocr_pages([p[None, :, :, None]]))
        chain_fallbacks.append(
            fused.escalation_stats.get('chain_fallback', 0) > before)
    fused_bf16 = OCRPipeline(PAGE_SHAPE, weights=weights, chunk=N_PAGES,
                             workers=2, device_cascade=True, precision='bf16',
                             collapse_runs=4)
    fused_bf16_texts = fused_bf16.ocr_pages(
        [p[None, :, :, None] for p in pages[:2]])
    ocr_texts = jax_ocr_texts(pages, weights)
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)

    def text(value):
        return np.array(json.dumps(value, ensure_ascii=False))

    np.savez_compressed(
        FIXTURE, pages=pages, texts=text(texts),
        device_texts=text(device_texts), tables_texts=text(tables_texts),
        fused_texts=text(fused_texts), chain_texts=text(chain_texts),
        chain_fallbacks=text(chain_fallbacks),
        fused_bf16_texts=text(fused_bf16_texts), ocr_texts=text(ocr_texts))
    print(f'{FIXTURE}: {FIXTURE.stat().st_size} bytes, '
          f'{sum(len(p) for p in texts)} paragraphs')


if __name__ == '__main__':
    generate()
