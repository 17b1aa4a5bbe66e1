"""Whole runs on the CPU, past the harness's look for a card, at a size a
test run holds (a pool of 2 pages, windows of a few seconds, calls of the
whole small pool where a cell takes 48 pages, every call recorded): a
sound run comes out correct, and each fault the cells can have, planted
in the program underneath, and the float8 control each come out not
correct.  The limits are the cells' own.

    python -m pytest -q benchmark/tests/test_benchmark_faults.py

takes some minutes: the program runs its plain versions here.
"""

import contextlib

import numpy as np
import pytest
import torch

from benchmark import core, harness, seams

POOL = 2
#: the card runs Monochrome as its float32 kernel, the CPU as the plain
#: version in the pipeline's 'bf16': here the map is held to the bf16
#: rounding of its operands (CPU runs read 0.008)
CPU_MONO_ERR = 0.02
CELLS = ['host-batch48', 'host-single']


@contextlib.contextmanager
def small(monkeypatch):
    """A pool of POOL pages, a batch call of the whole pool, every call
    recorded."""
    pool = core.load_pool()[:POOL]
    work = core.load_work()
    work['pages'] = work['pages'][:POOL]
    monkeypatch.setattr(core, 'load_pool', lambda *a: pool)
    monkeypatch.setattr(core, 'load_work', lambda *a: work)
    original = core.cell_files

    def cell_files(cell, *args):
        config, traffic = original(cell, *args)
        config['check']['limits']['mono_err'] = CPU_MONO_ERR
        traffic['pages_per_call'] = min(traffic['pages_per_call'], POOL)
        traffic['record_every'] = 1
        return config, traffic

    monkeypatch.setattr(core, 'cell_files', cell_files)
    torch.set_num_threads(8)
    yield


def run(cell, seconds=2, control=False):
    return harness.main(['--workload', cell, '--seed', str(2 ** 33 + 17),
                         '--seconds', str(seconds), '--trace', '0',
                         '--control', str(int(control))], device='cpu')


def over(line):
    return [k for k, v in line['checked'].items() if v['value'] > v['limit']]


def in_window(monkeypatch):
    """A flag that turns on at the window's first call (after set-up)."""
    flag = {'on': False}
    original = seams.Recorder.start_call

    def start_call(self):
        flag['on'] = True
        original(self)

    monkeypatch.setattr(seams.Recorder, 'start_call', start_call)
    return flag


@pytest.mark.parametrize('cell', CELLS)
def test_sound_run_is_correct(monkeypatch, cell):
    with small(monkeypatch):
        line = run(cell)
    assert line['correct'], line['checked']
    assert line['failed'] == 0
    assert line['checked']['cer']['value'] < line['checked']['cer']['limit']


@pytest.mark.parametrize('cell', CELLS)
def test_float8_control_is_not_correct(monkeypatch, cell):
    with small(monkeypatch):
        line = run(cell, control=True)
    assert not line['correct']
    assert over(line) and 'missing' not in over(line)


def test_token_altered_where_produced(monkeypatch):
    """The first glyph of the first non-empty line decoded in the window
    is replaced by another."""
    from univer_ocr_tpu_torch.models import pipeline
    flag = {'done': False}
    original = pipeline.pred_ids_to_text

    def pred_ids_to_text(*args, **kwargs):
        text = original(*args, **kwargs)
        head = text.lstrip()
        if window['on'] and not flag['done'] and head:
            flag['done'] = True
            return ('Ж' if head[0] != 'Ж' else 'Щ') + head[1:]
        return text

    with small(monkeypatch):
        window = in_window(monkeypatch)
        monkeypatch.setattr(pipeline, 'pred_ids_to_text', pred_ids_to_text)
        line = run('host-single')
    assert flag['done']
    assert not line['correct']
    assert line['checked']['lines_unexplained']['value'] >= 1


def test_half_of_the_batch_left_out(monkeypatch):
    """Each call in the window answers only the first half of its pages,
    and the mean is taken over the rest."""
    from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
    original = OCRPipeline.ocr_pages

    def ocr_pages(self, pages):
        out = original(self, pages)
        return out[:len(pages) // 2] if window['on'] else out

    with small(monkeypatch):
        window = in_window(monkeypatch)
        monkeypatch.setattr(OCRPipeline, 'ocr_pages', ocr_pages)
        line = run('host-batch48')
    assert not line['correct']
    assert line['failed'] >= 1


def test_a_line_of_each_paragraph_dropped(monkeypatch):
    """In the window the line planner loses the last line of every
    paragraph of two lines or more."""
    from univer_ocr_tpu_torch.models import pipeline
    original = pipeline.crop_lines_of_paragraph

    def crop_lines_of_paragraph(*args, **kwargs):
        lines = original(*args, **kwargs)
        return lines[:-1] if window['on'] and len(lines) > 1 else lines

    with small(monkeypatch):
        window = in_window(monkeypatch)
        monkeypatch.setattr(pipeline, 'crop_lines_of_paragraph',
                            crop_lines_of_paragraph)
        line = run('host-batch48')
    assert not line['correct']
    assert 'cer' in over(line)


def test_paragraph_crop_shifted(monkeypatch):
    """In the window every paragraph crop comes out 8 rows lower, its
    last 8 rows lost."""
    from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
    original = OCRPipeline._crop_page

    def shift(crop):
        out = np.zeros_like(crop)
        out[:, 8:] = crop[:, :-8]
        return out

    def _crop_page(self, mono_pred, para_mask):
        crops = original(self, mono_pred, para_mask)
        return [shift(c) for c in crops] if window['on'] else crops

    with small(monkeypatch):
        window = in_window(monkeypatch)
        monkeypatch.setattr(OCRPipeline, '_crop_page', _crop_page)
        line = run('host-batch48')
    assert not line['correct']
    assert 'cer' in over(line)


def test_lines_zoomed_wrong(monkeypatch):
    """In the window every line is zoomed to 24 rows instead of 32 and
    padded below."""
    from univer_ocr_tpu_torch.models import pipeline
    original = pipeline.extract_line

    def extract_line(image, bbox, rotation, zoomed_height, minimal_width):
        if not window['on']:
            return original(image, bbox, rotation, zoomed_height,
                            minimal_width)
        line = original(image, bbox, rotation, 24, minimal_width)
        out = np.zeros((1, zoomed_height) + line.shape[2:], line.dtype)
        out[:, :24] = line
        return out

    with small(monkeypatch):
        window = in_window(monkeypatch)
        monkeypatch.setattr(pipeline, 'extract_line', extract_line)
        line = run('host-single')
    assert not line['correct']
    assert 'cer' in over(line)
