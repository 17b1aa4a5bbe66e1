"""The committed training fixture, univer_ocr_tpu_torch/fixtures/
train_pages.npz, which chip_smoke.py's `train_path` phase trains on (the
card machine can render no pages: it has no Pillow and no fonts).

It holds 3 synthetic pages rendered by the port's generator (the JAX
package's draws the same pages) from a fixed seed at the corpus size
(720x480, 496x736 after the /16 padding), each with its 14 layers as
uint8 in LAYER_NAMES order (`train`: 2 pages, `validation`: 1,
`layer_names`), and in `reference` the JAX package's
numbers for a fixed run of every curriculum stage from the committed
checkpoint, op by op (`jax.disable_jit`), in float32 on the CPU: for each
stage, `Adam(lr)` of CURRICULUM, `model_system.train` on train pages 0
and 1 in that order, then `model_system.test` on the validation page;
every step's output losses and regularization loss (one step per crop
for Line, per line for Char), the paragraph crops and lines of each
page, and for each parameter the L2 norm of its change over the stage.

Regenerate with `JAX_PLATFORMS=cpu python tests/test_torch_train_fixture.py`.
"""

import json
import random
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / 'univer_ocr_tpu_torch' / 'fixtures' / 'train_pages.npz'
SEED = 909
PAGE = (496, 736)
STAGES = ('TRAIN_MONOCHROME', 'TRAIN_PARAGRAPH', 'TRAIN_LINE', 'TRAIN_CHAR',
          'TRAIN_ALL')


def load_reference():
    with np.load(FIXTURE) as f:
        return json.loads(str(f['reference']))


def test_fixture_is_small_and_well_formed():
    from univer_ocr_tpu_torch.models.constants import LAYER_NAMES_PLAIN
    from univer_ocr_tpu_torch.models.datasets import load_page_arrays
    assert FIXTURE.stat().st_size <= 1 << 20
    train, validation = load_page_arrays(FIXTURE)
    assert (len(train), len(validation)) == (2, 1)
    with np.load(FIXTURE) as f:
        assert json.loads(str(f['layer_names'])) == LAYER_NAMES_PLAIN
        for key in ('train', 'validation'):
            assert f[key].dtype == np.uint8
            assert f[key].shape[1:] == PAGE + (14,)
    page = train.get(0)
    assert sorted(page) == sorted(['image', 'monochrome', 'paragraph',
                                   'line', 'char'])
    assert page['char'].shape == (1,) + PAGE + (9,)
    assert page['image'].dtype == np.float64
    assert 0.0 <= page['image'].min() and page['image'].max() <= 1.0


def test_fixture_reference_is_complete():
    """Every stage has its steps, finite losses, crops and lines on every
    page, and an update norm for each parameter it trains."""
    ref = load_reference()
    assert list(ref) == list(STAGES)
    trained = {'TRAIN_MONOCHROME': ['Monochrome'],
               'TRAIN_PARAGRAPH': ['Paragraph'], 'TRAIN_LINE': ['Line'],
               'TRAIN_CHAR': ['Char'],
               'TRAIN_ALL': ['Monochrome', 'Paragraph', 'Line', 'Char']}
    for stage, entry in ref.items():
        models = {step['model'] for step in entry['steps']}
        assert models == set(trained[stage])
        assert all(np.isfinite(step['output_losses']).all()
                   for step in entry['steps'])
        assert set(entry['update_norms']) == set(trained[stage])
        assert all(v > 0 for norms in entry['update_norms'].values()
                   for v in norms.values())
        if stage in ('TRAIN_LINE', 'TRAIN_CHAR', 'TRAIN_ALL'):
            assert len(entry['crops']) == 3 and min(entry['crops']) > 0
        if stage in ('TRAIN_CHAR', 'TRAIN_ALL'):
            assert min(entry['lines']) > 0
        # one step per page for the whole-page models, one per crop for
        # Line, one per line for Char
        per_page = {'Line': entry['crops'], 'Char': entry['lines']}
        for model in models:
            counts = [sum(1 for s in entry['steps']
                          if s['model'] == model and s['page'] == p)
                      for p in range(3)]
            assert counts == per_page.get(model, [1, 1, 1]), (stage, model)


def _record_steps(system, log, page):
    """Wrap each model component's step once, so that every step's losses
    land in `log` with the page in `page[0]` (one step per crop or line
    in the masked components)."""
    for component in system.components:
        if not hasattr(component, 'model'):
            continue
        name = component.name

        def note(phase, losses, name=name):
            log.append({'page': page[0], 'phase': phase, 'model': name,
                        'output_losses': [float(v) for v in
                                          losses['output_losses']],
                        'regularization_loss': (
                            float(losses['regularization_loss'])
                            if 'regularization_loss' in losses else None)})

        if hasattr(component, '_run'):
            def run(X, y, training, run=component._run, note=note):
                losses, pred = run(X, y, training)
                note('train' if training else 'test', losses)
                return losses, pred
            component._run = run
        else:
            model = component.model
            for phase in ('train', 'test'):
                def step(X, y, step=getattr(model, phase), phase=phase,
                         note=note):
                    losses = step(X, y)
                    note(phase, losses)
                    return losses
                setattr(model, phase, step)


def render_pages():
    """The fixture's 3 pages with their 14 layers, rendered by the port's
    generator from one random.Random(SEED) (the JAX package's render_page
    after random.seed(SEED) draws the same pages)."""
    from univer_ocr_tpu_torch.models.constants import LAYER_NAMES_PLAIN
    from univer_ocr_tpu_torch.models.train_data_generator import render_page
    rng = random.Random(SEED)
    pages = []
    for _ in range(3):
        raw = render_page(720, 480, rng=rng)
        pages.append(np.stack([np.asarray(raw[name].convert('L'))
                               for name in LAYER_NAMES_PLAIN], axis=-1))
    return np.stack(pages)


def test_fixture_pages_are_the_ports_render():
    with np.load(FIXTURE) as f:
        np.testing.assert_array_equal(
            render_pages(), np.concatenate([f['train'], f['validation']]))


def generate():
    """Render the pages and record the JAX reference run."""
    import jax
    jax.config.update('jax_platforms', 'cpu')
    sys.path.insert(0, str(ROOT))
    from PIL import Image
    from univer_ocr_tpu.models import model as jmodel
    from univer_ocr_tpu.models.constants import LAYER_NAMES_PLAIN
    from univer_ocr_tpu.models.train import CURRICULUM
    from univer_ocr_tpu.models.train_data_generator import encode_layers
    from univer_ocr_tpu.nn.optimizers import Adam
    from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

    pages = render_pages()
    assert pages.shape == (3,) + PAGE + (14,), pages.shape

    def get(idx, layer_tags=None):
        planes = {name: Image.fromarray(pages[idx, :, :, i])
                  for i, name in enumerate(LAYER_NAMES_PLAIN)}
        layers = encode_layers(planes)
        return {tag: layers[tag] for tag in layer_tags}

    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    reference = {}
    with jax.disable_jit():
        for mode, lr, _, _ in CURRICULUM:
            system, models, _ = jmodel.make_model_system(
                (1,) + PAGE + (1,), Adam(lr=lr), weights=weights, mode=mode)
            before = {name: model.get_weights()
                      for name, model in models.items()}
            make_context = jmodel.make_context_maker(mode)
            steps, crops, lines, page = [], [], [], [0]
            _record_steps(system, steps, page)
            for page[0], phase in ((0, 'train'), (1, 'train'), (2, 'test')):
                context = make_context(get, (page[0],))
                getattr(system, phase)(context)
                crops.append(len(context.get('cropped_monochrome_cpu', [])))
                lines.append(sum(len(p) for p in context.get(
                    'cropped_2_monochrome_cpu', [])))
                print(mode.name, page[0], phase, context['losses'],
                      flush=True)
            norms = {}
            for name, model in models.items():
                after = model.get_weights()
                norms[name] = {
                    f'{layer}/{key}': float(np.linalg.norm(
                        np.asarray(after[layer][key], np.float64)
                        - np.asarray(before[name][layer][key], np.float64)))
                    for layer in after for key in after[layer]}
            reference[mode.name] = {'lr': lr, 'steps': steps,
                                    'crops': crops, 'lines': lines,
                                    'update_norms': norms}
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        FIXTURE, train=pages[:2], validation=pages[2:],
        layer_names=np.array(json.dumps(LAYER_NAMES_PLAIN)),
        reference=np.array(json.dumps(reference)))
    print(f'{FIXTURE}: {FIXTURE.stat().st_size} bytes')


if __name__ == '__main__':
    generate()
