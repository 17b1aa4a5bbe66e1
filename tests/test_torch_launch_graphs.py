"""The device cascade's CUDA graphs (models/launch_graphs.py) on the card:
the serving default (`OCRPipeline(chunk=32, device_cascade=True,
collapse_runs=4)`) on pool pages 0-31 of the benchmark
(benchmark/data/pages.npz), in 'bf16' and in 'highest'.

Every paragraph launch and chunk planner call of the chunk, replayed from
its graph, is held bit for bit against the same call run eagerly
afterwards on the inputs it was given: the crops, band masks, glyph
payload and line plans, and the planner's labels and plan matrix.  The
calls are recomputed only after the whole chunk has run, so a replay's
outputs that a later replay of the same graph overwrote would show; the
chunk holds a flagged paragraph whose key is replayed after it, whose
lines the line stage reads from the copied crops and line plans.  Where
the Line or Char convolutions' outputs differ (cuDNN may pick another
algorithm under capture), the test says so in a warning and holds the
text to the eager text instead.  The kernels' launch counters count the
replayed launches as the eager ones.

Needs a card (marker `cuda`); on the H100: `python -m pytest
--noconftest -q tests/test_torch_launch_graphs.py` (the suite's
conftest.py imports JAX, which the machine with the card does not have).
"""

import json
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from univer_ocr_tpu_torch.models import fused_tail
from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
from univer_ocr_tpu_torch.ops.kernels import _build
from univer_ocr_tpu_torch.ops.precision import backend_flags
from univer_ocr_tpu_torch.utils.profiling import StageTimers
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

POOL = (Path(__file__).resolve().parents[1] / 'benchmark' / 'data'
        / 'pages.npz')
CHUNK = 32
#: outputs of a paragraph launch that no convolution computes
EXACT = ('crops',)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (run on the H100, see the docstring)')


@pytest.fixture(scope='module')
def pages():
    with np.load(POOL) as f:
        return [p[None, :, :, None] for p in f['pages'][:CHUNK]]


@pytest.fixture(scope='module')
def weights():
    with open(DEFAULT_CHECKPOINT) as fp:
        return json.load(fp)


def _record(pipeline, name, calls):
    """Wrap the pipeline's stage `name`: each call's inputs, cloned when
    it is made, and its outputs, as the caller got them."""
    stage = getattr(pipeline, name)

    def recorded(*args):
        out = stage(*args)
        calls.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a
                            for a in args), out))
        return out
    setattr(pipeline, name, recorded)


def _launch_flags(out, n):
    payload = out[2][0].cpu().numpy()
    return fused_tail.unpack_fused_payload(payload, n)[1]


def _counts():
    return ({k: v for k, v in _build.LAUNCHES.items()},
            {k: v for k, v in _build.DEVICE_LAUNCHES.items()})


def _run(pipeline, pages):
    _build.LAUNCHES.clear()
    _build.DEVICE_LAUNCHES.clear()
    pipeline.timers = StageTimers()
    texts = pipeline.ocr_pages(pages)
    torch.cuda.synchronize()
    timers, pipeline.timers = pipeline.timers, None
    return texts, _counts(), timers


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['bf16', 'highest'])
def test_replayed_launches_equal_eager_ones(pages, weights, precision):
    _need_card()
    with OCRPipeline((1, 496, 736, 1), weights, chunk=CHUNK, workers=8,
                     precision=precision, device='cuda', device_cascade=True,
                     collapse_runs=4) as pipeline:
        graphs = pipeline._graphs
        assert graphs is not None and pipeline._device_planner
        launches, planner = [], []
        _record(pipeline, 'paragraph_launch', launches)
        _record(pipeline, 'chunk_planner', planner)
        texts, counts, timers = _run(pipeline, pages)
        del pipeline.paragraph_launch, pipeline.chunk_planner

        # every key of the chunk: three menu entries, a batch-of-4 tail
        keys = [(args[2].shape[0], args[3], args[4]) for args, _ in launches]
        assert {(hb, wb) for _, hb, wb in keys} == set(
            pipeline.line_shape_menu)
        assert any(b == 4 for b, _, _ in keys)
        assert len(planner) == 1
        summary = timers.summary()
        assert summary['stage_launches']['count'] == len(launches) + 1
        assert summary['graph_replays']['count'] == len(launches) + 1
        assert summary['graph_captures']['count'] == len(set(keys)) + 1

        # a flagged paragraph whose key is replayed after its launch
        flagged = [i for i, (args, out) in enumerate(launches)
                   if _launch_flags(out, args[2].shape[0]).any()]
        assert any(keys[j] == keys[i] for i in flagged
                   for j in range(i + 1, len(keys)))
        assert pipeline.escalation_stats['relaunched'] > 0

        # each call against the same call run eagerly now
        differ = []
        with backend_flags(precision):
            (para,), (labels, packed) = planner[0]
            want = pipeline._chunk_planner(para)
            assert torch.equal(labels, want[0])
            assert torch.equal(packed, want[1])
            for i, (args, out) in enumerate(launches):
                want = pipeline._paragraph_launch(*args)
                got = dict(zip(('crops', 'bands', 'payload', 'lines'),
                               out[:2] + out[2]))
                for k, w in zip(got, want[:2] + want[2]):
                    if not torch.equal(got[k], w):
                        assert k not in EXACT, (i, keys[i], k)
                        differ.append((i, keys[i], k))
        if differ:
            warnings.warn(f'{precision}: {len(differ)} replayed outputs '
                          f'differ from the eager ones (cuDNN under capture)'
                          f': {differ[:8]}; text held to the eager text')

        # a second pass replays every launch, captures nothing, and reads
        # the same text; eager, the same text and the same launch counts
        again, counts_again, timers = _run(pipeline, pages)
        assert again == texts
        assert 'graph_captures' not in timers.summary()
        assert (timers.summary()['graph_replays']['count']
                == len(launches) + 1)
        pipeline._graphs = None
        eager, counts_eager, timers = _run(pipeline, pages)
        assert 'graph_replays' not in timers.summary()
        assert counts == counts_again == counts_eager
        assert counts[0]['band_ccl'] == len(launches) + 1
        assert counts[0]['fused_char_head'] >= len(launches)
        assert texts == eager


@pytest.mark.cuda
def test_single_page_chain_replays(pages, weights):
    """One page alone takes the chain, whose paragraph launches (N = 1)
    replay their own graphs and read the eager text."""
    _need_card()
    with OCRPipeline((1, 496, 736, 1), weights, chunk=CHUNK, workers=8,
                     precision='bf16', device='cuda', device_cascade=True,
                     collapse_runs=4) as pipeline:
        got = []
        for page in pages[:3]:
            texts, _, timers = _run(pipeline, [page])
            summary = timers.summary()
            assert (summary['graph_replays']['count']
                    == summary['stage_launches']['count'] > 0)
            got.append(texts)
        assert Counter(pipeline.escalation_stats)['chain_fallback'] == 0
        pipeline._graphs = None
        assert got == [_run(pipeline, [page])[0] for page in pages[:3]]


@pytest.mark.cuda
def test_band_ccl_replays_equal_eager():
    """`band_ccl` alone, captured at (32, 512, 768) with its labels, and
    replayed twice on other masks and valid regions written into its
    static input: each replay equals an eager call on the same input bit
    for bit, so the kernels' sequence is fixed by the shape and nothing is
    carried over in the scratch from one replay to the next.  The capture
    counts one launch, as an eager call does."""
    _need_card()
    from univer_ocr_tpu_torch.ops.kernels.band_ccl import band_ccl
    N, H, W = 32, 512, 768
    rs = np.random.RandomState(0)

    def draw(density):
        m = torch.from_numpy(rs.rand(N, H, W) < density).to(torch.uint8)
        hv = torch.from_numpy(rs.randint(H // 2, H + 1, N)).int()
        wv = torch.from_numpy(rs.randint(W // 2, W + 1, N)).int()
        return m.cuda(), hv.cuda(), wv.cuda()

    static = draw(0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        band_ccl(*static, 48, labels=True)
    torch.cuda.current_stream().wait_stream(side)
    before = _build.LAUNCHES['band_ccl']
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = band_ccl(*static, 48, labels=True)
    assert _build.LAUNCHES['band_ccl'] == before + 1
    replays = []
    for density in (0.6, 0.3):
        for s, new in zip(static, draw(density)):
            s.copy_(new)
        graph.replay()
        want = band_ccl(*(s.clone() for s in static), 48, labels=True)
        for name, g, w in zip(('stats', 'n_comp', 'labels'), out, want):
            assert torch.equal(g, w), (density, name)
        replays.append([g.clone() for g in out])
    assert not torch.equal(replays[0][1], replays[1][1])
