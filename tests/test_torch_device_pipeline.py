"""The port's OCRPipeline in the device cascade's parity mode
(`device_cascade=True, exact_bands=True`) and tables mode
(`exact_bands=False`, `fused_tail=False`) against the host cascade, and
what came with these modes: stage timers, the planning counters and host
syncs, the plain versions in the pipeline's precision on the CPU, random
initialisation and the TF32 switches across threads.

The device cascade computes the host cascade's crops (its deskew and its
line zoom, in scipy's float64 geometry) and plans its lines from the same
band components, so in 'highest' its text is the host cascade's, held to
exact equality with the text the fixture stores (`texts`, the JAX host
cascade's, which the port's host cascade reproduces).  In 'bf16' the
device cascade's Line batches differ from the host cascade's, and text is
compared by the flip budget of tests/test_pipeline.py (test
`test_device_cascade_matches_host_pipeline`): the same structure (pages,
paragraphs, lines), every differing block of the per-page text at most 3
characters, and at most max(8, len // 200) differing characters a
page."""

import json
import threading
import time
from difflib import SequenceMatcher

import numpy as np
import pytest
import torch

from univer_ocr_tpu.models.pipeline import OCRPipeline as JaxPipeline
from univer_ocr_tpu_torch.models import fastpath
from univer_ocr_tpu_torch.models import pipeline as port_pipeline
from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
from univer_ocr_tpu_torch.ops.kernels import (fused_monochrome,
                                              fused_monochrome_reference,
                                              prepare_monochrome)
from univer_ocr_tpu_torch.utils.profiling import StageTimers
from univer_ocr_tpu_torch.weights import (DEFAULT_CHECKPOINT, load_checkpoint,
                                          random_params)

from test_torch_fixture import N_PAGES, PAGE_SHAPE, load_fixture

#: the device cascade's stage timers, as the JAX pipeline names them, and
#: its paragraph launches (eager on the CPU: no 'graph_replays')
DEVICE_STAGES = {'pull_para_bits', 'host_paragraph_plans',
                 'dispatch_paragraph_stage', 'pull_band_masks',
                 'host_line_plans', 'dispatch_line_stage', 'pull_char_ids',
                 'decode_text', 'host_sync', 'stage_launches'}
#: the tables mode's: the tables pull replaces the band-mask pull, and the
#: labelling launches are timed and their components counted
TABLES_STAGES = (DEVICE_STAGES - {'pull_band_masks'}
                 | {'pull_band_tables', 'band_components',
                    'band_components_labelled'})
#: the host cascade's, named after its device stages where it has them
HOST_STAGES = {'pull_front', 'host_paragraph_crops', 'line_masks',
               'host_line_crops', 'char_ids', 'decode_text'}
#: its host CV steps on the pool threads, by the pool task that runs them
HOST_CV_STEPS = {'_crop_page': ('para_label', 'para_select', 'para_deskew'),
                 '_crop_lines': ('line_plan', 'line_extract')}
#: ...and its waits for the Line and Char results, the pool threads' CPU
#: seconds inside the steps, and the band components the line plans
#: summarised
HOST_STAGES |= {step for steps in HOST_CV_STEPS.values() for step in steps}
HOST_STAGES |= {'line_pull', 'char_pull', 'host_cv_thread_cpu',
                'line_plan_components'}


def assert_within_flip_budget(got, expected):
    assert [[len(lines) for lines in page] for page in got] == \
        [[len(lines) for lines in page] for page in expected]
    for page_got, page_exp in zip(got, expected):
        ta = '\n\n'.join('\n'.join(lines) for lines in page_exp)
        tb = '\n\n'.join('\n'.join(lines) for lines in page_got)
        diff_chars = 0
        for op, i1, i2, j1, j2 in SequenceMatcher(
                None, ta, tb, autojunk=False).get_opcodes():
            if op == 'equal':
                continue
            block = max(i2 - i1, j2 - j1)
            assert block <= 3, (op, ta[i1:i2], tb[j1:j2], ta, tb)
            diff_chars += block
        assert diff_chars <= max(8, len(ta) // 200), (diff_chars, ta, tb)


@pytest.fixture(scope='module')
def weights():
    with open(DEFAULT_CHECKPOINT) as fp:
        return json.load(fp)


@pytest.fixture(scope='module')
def pages():
    fixture_pages, _ = load_fixture()
    return [p[None, :, :, None] for p in fixture_pages]


def _port(weights, **kwargs):
    kwargs = dict(dict(chunk=2, workers=2, collapse_runs=4,
                       precision='highest', device='cpu'), **kwargs)
    return OCRPipeline(PAGE_SHAPE, weights=weights, **kwargs)


@pytest.fixture(scope='module')
def device_run(weights, pages):
    """The parity mode on the fixture pages, chunk 2, 'highest', with its
    stage timers on: (texts, timers, timeline)."""
    with _port(weights, device_cascade=True, exact_bands=True) as pipeline:
        pipeline.timers = StageTimers()
        texts = pipeline.ocr_pages(pages)
        return texts, pipeline.timers, pipeline.timeline


@pytest.fixture(scope='module')
def tables_run(weights, pages):
    """The tables mode on the fixture pages, chunk 2, 'highest', with its
    stage timers on: (texts, timers, timeline, escalation_stats,
    host_syncs)."""
    with _port(weights, device_cascade=True, fused_tail=False) as pipeline:
        assert pipeline.band_tables and not pipeline.fused_tail
        pipeline.timers = StageTimers()
        texts = pipeline.ocr_pages(pages)
        return (texts, pipeline.timers, pipeline.timeline,
                pipeline.escalation_stats, pipeline.host_syncs)


def test_tables_mode_matches_jax_tables_text(tables_run):
    """Against the host cascade's text stored in the fixture: equal."""
    _, expected = load_fixture()
    got = tables_run[0]
    assert sum(len(lines) for page in got for lines in page) > 0
    assert got == expected


def test_tables_mode_stage_timers_and_counters(tables_run):
    """The tables pull is timed where the band-mask pull was; every
    paragraph is counted (32 on these pages, none planned from its band
    masks); each paragraph launch times one labelling launch and counts
    its components, and every blocking pull is one host sync."""
    texts, timers, timeline, stats, syncs = tables_run
    summary = timers.summary()
    assert set(summary) == TABLES_STAGES
    assert summary['pull_para_bits']['count'] == N_PAGES // 2
    assert {tag for tag, *_ in timeline} == {'para_bits', 'tables',
                                             'char_ids'}
    assert stats == {'paragraphs': sum(len(page) for page in texts),
                     'host_planned': 0, 'table_of': 0}
    assert stats['paragraphs'] == 32
    launches = sum(tag == 'tables' for tag, *_ in timeline)
    assert launches > 0 and syncs['tables'] == launches
    assert summary['band_components']['count'] == launches
    assert summary['stage_launches']['count'] == launches
    assert summary['band_components_labelled']['count'] == launches
    lines = sum(len(lines) for page in texts for lines in page)
    assert timers.totals['band_components_labelled'] >= 2 * lines
    assert set(syncs) == {'para_bits', 'tables', 'char_ids'}
    assert summary['host_sync']['count'] == sum(syncs.values())


@pytest.mark.parametrize('cap', [1, 2, 3])
def test_tables_mode_plans_overflowing_tables_from_bands(weights, pages,
                                                         monkeypatch, cap):
    """A paragraph with more band components in a channel than its table
    holds is planned on the host from its pulled band masks: the text is
    the same, and each such paragraph is counted."""
    from univer_ocr_tpu_torch.models import band_tables
    _, expected = load_fixture()
    monkeypatch.setattr(band_tables, 'MAX_BAND_COMPONENTS', cap)
    with _port(weights, device_cascade=True, fused_tail=False) as pipeline:
        assert pipeline.ocr_pages(pages[:1]) == expected[:1]
        stats = pipeline.escalation_stats
        assert stats['paragraphs'] == len(expected[0])
        assert 0 < stats['host_planned'] == stats['table_of']
        assert pipeline.host_syncs['bands'] > 0


@pytest.mark.parametrize('chunk', [1, 3])
def test_device_modes_equal_host_cascade_at_any_chunk(weights, pages, chunk):
    """Chunks of 1 page and of 3 (a tail chunk of 2, padded with a blank
    page): the parity and tables modes read the host cascade's text."""
    _, expected = load_fixture()
    for kwargs in (dict(exact_bands=True), dict(fused_tail=False)):
        with _port(weights, chunk=chunk, device_cascade=True,
                   **kwargs) as pipeline:
            assert pipeline.ocr_pages(pages[:2]) == expected[:2], kwargs


def test_device_cascade_matches_jax_device_cascade(device_run):
    """Against the host cascade's text stored in the fixture ('highest',
    collapse_runs=4, on the CPU): equal."""
    _, expected = load_fixture()
    got, _, _ = device_run
    assert len(got) == N_PAGES
    assert sum(len(lines) for page in got for lines in page) > 0
    assert got == expected


def test_device_cascade_matches_port_host_cascade(weights, pages,
                                                  device_run):
    with _port(weights) as host:
        expected = host.ocr_pages(pages)
    assert device_run[0] == expected


def test_device_cascade_stage_timers(device_run):
    """Every device-cascade stage reports its timer, at the JAX package's
    places; the D2H pulls land in the timeline."""
    _, timers, timeline = device_run
    summary = timers.summary()
    assert set(summary) == DEVICE_STAGES
    assert summary['pull_para_bits']['count'] == N_PAGES // 2
    assert all(s['total_s'] >= 0 for s in summary.values())
    tags = {tag for tag, start, end, nbytes in timeline}
    assert tags == {'para_bits', 'bands', 'char_ids'}
    assert all(end >= start and nbytes > 0
               for _, start, end, nbytes in timeline)


@pytest.fixture(scope='module')
def host_run(weights, pages):
    """The host cascade on two fixture pages, chunk 2, 2 workers,
    'highest', with its stage timers on and the arguments of each pool
    task kept: (open pipeline, texts, timers, {task: [args]})."""
    with _port(weights) as host:
        tasks = {name: [] for name in HOST_CV_STEPS}
        for name, calls in tasks.items():
            def spy(*args, _fn=getattr(host, name), _calls=calls):
                _calls.append(args)
                return _fn(*args)
            setattr(host, name, spy)
        host.timers = StageTimers()
        texts = host.ocr_pages(pages[:2])
        timers, host.timers = host.timers, None
        yield host, texts, timers, tasks


def test_host_cascade_stage_timers(host_run):
    """Every span and counter; each host CV step counts what it runs
    over, the steps fit inside the pool maps that run them and cover each
    pool task's work; the CPU seconds fit inside the steps, the pulls
    inside their stages."""
    host, texts, timers, tasks = host_run
    assert set(timers.summary()) == HOST_STAGES
    assert host.timeline == []
    count, total = timers.counts, timers.totals
    paragraphs = sum(len(page) for page in texts)
    assert paragraphs > 0
    assert count['para_label'] == len(texts)
    assert (count['para_select'] == count['para_deskew']
            == count['line_plan'] == paragraphs)
    assert count['line_extract'] == sum(len(lines) for page in texts
                                        for lines in page)
    # one count per plan; each line has a top component of its own and a
    # paragraph with lines one bottom component at least
    assert count['line_plan_components'] == paragraphs
    assert total['line_plan_components'] >= count['line_extract'] + sum(
        1 for page in texts for lines in page if lines)
    steps = [s for names in HOST_CV_STEPS.values() for s in names]
    busy = sum(total[s] for s in steps)
    assert count['host_cv_thread_cpu'] == sum(count[s] for s in steps)
    assert busy <= 2 * (total['host_paragraph_crops']
                        + total['host_line_crops']) + 1e-3
    assert 0 < total['host_cv_thread_cpu'] <= busy + 1e-3
    assert total['line_pull'] <= total['line_masks']
    assert total['char_pull'] <= total['char_ids']

    def covered(name, args):
        host.timers = StageTimers()
        start = time.perf_counter()
        getattr(OCRPipeline, name)(host, *args)
        wall = time.perf_counter() - start
        part = sum(host.timers.totals[s] for s in HOST_CV_STEPS[name])
        host.timers = None
        return part / wall

    # one task of each kind, the paragraph with the largest crop; the best
    # of three timings, as a busy host may stall a run between two steps
    picks = {'_crop_page': tasks['_crop_page'][0],
             '_crop_lines': max(tasks['_crop_lines'],
                                key=lambda args: args[1].size)}
    for name, args in picks.items():
        assert max(covered(name, args) for _ in range(3)) >= 0.95, name


def test_host_cascade_text_same_with_or_without_timers(host_run, pages):
    host, texts, _, _ = host_run
    assert host.timers is None
    assert host.ocr_pages(pages[:2]) == texts


@pytest.mark.parametrize('cascade', ['host', 'device', 'tables'])
def test_bf16_matches_jax_plain_bf16(weights, pages, cascade):
    """'bf16': the host cascade against JAX `use_pallas=False` 'bf16'
    (bf16 operands, float32 sums in both), the device cascade's parity
    and tables modes against the port's host cascade in 'bf16', on two
    fixture pages."""
    kwargs = dict(device_cascade=cascade != 'host',
                  exact_bands=cascade == 'device', fused_tail=False)
    if cascade == 'host':
        expected = JaxPipeline(PAGE_SHAPE, weights=weights, chunk=2,
                               workers=2, collapse_runs=4, precision='bf16',
                               use_pallas=False).ocr_pages(pages[:2])
    else:
        with _port(weights, precision='bf16') as host:
            expected = host.ocr_pages(pages[:2])
    with _port(weights, precision='bf16', **kwargs) as pipeline:
        assert pipeline.mono_weights is None and pipeline.char_head == 'xla'
        got = pipeline.ocr_pages(pages[:2])
    assert sum(len(lines) for page in got for lines in page) > 0
    assert_within_flip_budget(got, expected)


@pytest.mark.parametrize('precision', ['highest', 'bf16'])
def test_tf32_switches_hold_on_every_thread(weights, pages, precision):
    """`ocr_pages` sets the TF32 switches once, on the calling thread; the
    stages, run on the dispatcher and pool threads, all see the mode's
    values, and the switches are restored after the call."""
    want = precision == 'bf16'
    seen = []
    with _port(weights, chunk=1, device_cascade=True, exact_bands=True,
               precision=precision) as pipeline:
        for name in ('front_resident', 'paragraph_launch', 'line_stage'):
            def spy(*args, _fn=getattr(pipeline, name), _name=name):
                seen.append((_name, threading.current_thread().name,
                             torch.backends.cudnn.allow_tf32,
                             torch.backends.cuda.matmul.allow_tf32))
                return _fn(*args)
            setattr(pipeline, name, spy)
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = not want
        torch.backends.cuda.matmul.allow_tf32 = not want
        try:
            pipeline.ocr_pages(pages[:2])
            after = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
    assert after == (not want, not want)
    assert {name for name, *_ in seen} == {
        'front_resident', 'paragraph_launch', 'line_stage'}
    threads = {thread for _, thread, *_ in seen}
    assert 'ocr-dispatcher' in threads and len(threads) >= 2
    assert all((cudnn, matmul) == (want, want)
               for _, _, cudnn, matmul in seen)


def test_dispatcher_errors_surface_on_the_caller(pages):
    with _port(None, device_cascade=True, exact_bands=True) as pipeline:
        def broken(*args):
            raise RuntimeError('planner fault')
        pipeline._page_paragraph_plans = broken
        pipeline.front_resident = lambda batch: (
            torch.zeros(batch.shape), torch.ones(batch.shape, dtype=torch.uint8))
        with pytest.raises(RuntimeError, match='planner fault'):
            pipeline.ocr_pages(pages[:1])


def _glyph_payload(batch, lines):
    """A fused-tail glyph payload of `batch` paragraph slots whose pool
    holds `lines`, [(paragraph, glyph ids)] in pool order."""
    from univer_ocr_tpu_torch.models import fused_tail
    P, G = fused_tail.LINE_POOL, fused_tail.MAX_GLYPHS
    glyphs = np.zeros((P, G), np.uint8)
    n_glyphs = np.zeros(P, np.uint8)
    para = np.full(P, 255, np.uint8)
    n_lines = np.zeros(batch, np.uint8)
    for slot, (b, ids) in enumerate(lines):
        glyphs[slot, :len(ids)] = ids
        n_glyphs[slot], para[slot] = len(ids), b
        n_lines[b] += 1
    return np.concatenate([glyphs.reshape(-1), n_glyphs, para, n_lines,
                           np.zeros(3 * batch, np.uint8)])


@pytest.mark.parametrize('kwargs', [
    dict(device_cascade=True, collapse_runs=4),     # JAX's fused-tail default
    dict(device_cascade=True, fused_tail=True)])
def test_fused_combinations_and_the_shard_merge(kwargs):
    """The fused tail is ported: wherever JAX runs it, the pipeline builds
    with it and its device planner, and where JAX turns it off it is off.
    The merge of per-shard payloads (a mesh's 2 shards, each with its own
    line pool and its share of the launch) gives the unsharded launch's
    texts."""
    from univer_ocr_tpu_torch.models import fused_tail
    with OCRPipeline(PAGE_SHAPE, device='cpu', **kwargs) as pipeline:
        assert pipeline.fused_tail and pipeline._device_planner
    for other in (dict(kwargs, fused_tail=False),
                  dict(kwargs, exact_bands=True)):
        with OCRPipeline(PAGE_SHAPE, device='cpu', **other) as pipeline:
            assert not pipeline.fused_tail and not pipeline._device_planner
    rs = np.random.RandomState(0)
    lines = [(b, rs.randint(1, 162, rs.randint(1, 30)))
             for b in range(6) for _ in range(rs.randint(1, 4))]
    texts, flags, comps = fused_tail.unpack_fused_payload(
        _glyph_payload(8, lines), 6)
    shards = np.concatenate([
        _glyph_payload(4, [(b, ids) for b, ids in lines if b < 4]),
        _glyph_payload(4, [(b - 4, ids) for b, ids in lines if b >= 4])])
    merged, merged_flags, merged_comps = fused_tail.unpack_fused_payload(
        shards, 6, n_shards=2)
    assert merged == texts and all(texts)
    np.testing.assert_array_equal(merged_flags, flags)
    np.testing.assert_array_equal(merged_comps, comps)


def test_cpu_runs_plain_versions_in_the_pipeline_precision(monkeypatch):
    """On the CPU the pipeline runs Monochrome and the Char head as their
    plain versions in its own precision (JAX `use_pallas=False`); the
    kernels' wrappers, given CPU tensors, run the plain versions in
    float32, as the kernels compute whatever the mode."""
    params = load_checkpoint(device='cpu')
    x = torch.from_numpy(np.random.RandomState(0).rand(
        1, 64, 96, 1).astype(np.float32))
    mono = [params['Monochrome/conv_1']['w'], params['Monochrome/conv_1']['b'],
            params['Monochrome/conv_2']['w'], params['Monochrome/conv_2']['b']]
    f32 = fused_monochrome_reference(x, *mono)
    bf16 = fused_monochrome_reference(x, *mono, precision='bf16')
    assert not torch.equal(f32, bf16)
    assert torch.equal(fused_monochrome(x, prepare_monochrome(*mono)), f32)

    lines = torch.from_numpy(np.random.RandomState(1).rand(
        2, 32, 16, 1).astype(np.float32))
    widths = torch.tensor([16, 8])
    head = fastpath.char_head_weights(params)
    kernel = fastpath.char_forward_masked(params, lines, widths, head=head)
    assert torch.equal(kernel, fastpath.char_forward_masked(
        params, lines, widths, precision='highest', head='xla'))

    heads = []
    real = fastpath.char_forward_masked

    def spy(*args, head='xla', **kwargs):
        heads.append((head, kwargs['precision']))
        return real(*args, head=head, **kwargs)
    monkeypatch.setattr(port_pipeline, 'char_forward_masked', spy)
    with OCRPipeline((1, 64, 96, 1), weights=params, precision='bf16',
                     device='cpu') as plain:
        assert torch.equal(plain._monochrome(x), bf16)
        plain.char_ids(lines, widths)
    assert heads == [('xla', 'bf16')]


def test_weights_none_initialises_at_random():
    with OCRPipeline(PAGE_SHAPE, device='cpu') as pipeline:
        expected = random_params(torch.Generator().manual_seed(
            port_pipeline.RANDOM_INIT_SEED), 'cpu')
        checkpoint = load_checkpoint(device='cpu')
        for name, entry in expected.items():
            for k, v in entry.items():
                assert torch.equal(pipeline.params[name][k], v), (name, k)
        assert not torch.equal(
            pipeline.params['Char/dense_block/dense_1']['w'],
            checkpoint['Char/dense_block/dense_1']['w'])
