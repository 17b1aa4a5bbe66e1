"""The serving default's cell, `fused-batch32`, on the CPU: a short whole
run through the harness past its look for a card (a pool of 2 pages, a
call of both, a window of 2 seconds) comes out correct by the cell's own
limits; and the readers of the cell's new per-layer metrics on hand-made
records: their values, and None where the program has no such kernel,
counter or span, as before it had them."""

import pytest
import torch

from benchmark import core, harness

POOL = 2


def test_fused_cell_run_on_the_cpu_is_correct(monkeypatch):
    pool = core.load_pool()[:POOL]
    monkeypatch.setattr(core, 'load_pool', lambda *a: pool)
    original = core.cell_files

    def cell_files(cell, *args):
        config, traffic = original(cell, *args)
        traffic['pages_per_call'] = POOL
        traffic['warm_pages'] = POOL
        return config, traffic

    monkeypatch.setattr(core, 'cell_files', cell_files)
    torch.set_num_threads(8)
    line = harness.main(['--workload', 'fused-batch32', '--seed',
                         str(2 ** 33 + 23), '--seconds', '2', '--trace', '0'],
                        device='cpu')
    assert line['correct'], line['checked']
    assert line['failed'] == 0 and line['attempted'] >= POOL
    assert set(line['checked']) == {'missing', 'cer'}
    assert set(line['metrics']) == {'pages_per_s', 'setup_s'}


def records(spans, kernels=None, units=(0, 1), chunks=4):
    trace = None if kernels is None else {'kernels': kernels,
                                          'window_s': 2.0, 'busy_s': 1.0}
    return {'timers': {name: {'total_s': total, 'count': count}
                       for name, (total, count) in spans.items()},
            'counts': {'calls': 1, 'pages': 128, 'chunks': chunks},
            'trace': trace, 'units': list(units), 'work': None, 'devices': 1,
            'peak': {'flops': 989e12, 'bytes_per_s': 3.35e12,
                     'card': 'H100'}}


def read(name, rec):
    return core.metric_reader(name).read(name, rec)


def test_roofline_band_ccl_reads_the_kernel_against_the_band_work():
    pages = core.load_json(core.BENCH / 'data' / 'band_work.json')['pages']
    assert len(pages) == len(core.load_pool())
    assert all(p['band_ccl']['flops'] == 0 and p['band_ccl']['bytes'] > 0
               for p in pages)
    nbytes = pages[0]['band_ccl']['bytes'] + pages[1]['band_ccl']['bytes']
    kernels = {'void_(anonymous_namespace)::band_ccl_kernel(unsigned_c': 2e-3,
               'char_head_kernel': 5e-3}
    got = read('roofline.band_ccl.fused', records({}, kernels))
    assert got == pytest.approx(100.0 * nbytes / 3.35e12 / 2e-3)
    assert read('roofline.band_ccl.fused',
                records({}, {'char_head_kernel': 5e-3})) is None
    assert read('roofline.band_ccl.fused', records({})) is None
    assert read('roofline.band_ccl.fused', records({}, kernels,
                                                   units=())) is None


def test_host_syncs_read_the_counter_per_chunk():
    spans = {'host_sync': (38.0, 38), 'dispatch_paragraph_stage': (0.2, 4)}
    assert read('host_syncs.fused', records(spans)) == pytest.approx(9.5)
    assert read('host_syncs.fused', records({})) is None
    assert read('host_syncs.fused', records(spans, chunks=0)) is None


def test_dispatch_ms_reads_the_span_per_chunk():
    spans = {'dispatch_paragraph_stage': (0.2, 4)}
    assert read('dispatch_ms.fused', records(spans)) == pytest.approx(50.0)
    assert read('dispatch_ms.fused', records({'host_sync': (3.0, 3)})) is None
