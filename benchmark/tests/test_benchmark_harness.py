"""The harness on the CPU: what a run may import, finding a cell's files by
name, the command without a card, and the arithmetic of the check."""

import ast
import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import check, core, seams

BENCH = core.BENCH
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'univer_ocr_tpu'}


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


@pytest.mark.parametrize('path', sorted(BENCH.rglob('*.py')),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = _imports(path)
    assert not names & FORBIDDEN, (path, names & FORBIDDEN)
    if 'reference' in path.relative_to(BENCH).parts:
        assert 'univer_ocr_tpu_torch' not in names
        assert 'benchmark' not in names


def test_forbidden_names_compare_whole(monkeypatch):
    this = sys.modules[__name__]
    monkeypatch.setitem(sys.modules, 'univer_ocr_tpu_torch.fake', this)
    monkeypatch.setitem(sys.modules, 'univer_ocr_tpu_torchx', this)
    assert not core.forbidden_loaded()
    monkeypatch.setitem(sys.modules, 'univer_ocr_tpu.fake', this)
    monkeypatch.setitem(sys.modules, 'jax', this)
    assert core.forbidden_loaded() == ['jax', 'univer_ocr_tpu.fake']


def test_files_found_by_name_as_new_files_alone(tmp_path):
    """A configuration, a traffic mix, a loop and a per-layer metric added
    as files alone are found by the names a cell and a metric give."""
    for sub in ('configs', 'traffic', 'drivers', 'metrics', 'systems'):
        (tmp_path / sub).mkdir()
    (tmp_path / 'configs' / 'cfg-x.json').write_text(
        json.dumps({'system': 'sys_x', 'check': {'kind': 'text'}}))
    (tmp_path / 'traffic' / 'mix-x.json').write_text(
        json.dumps({'loop': 'loop_x', 'pages_per_call': 3}))
    (tmp_path / 'drivers' / 'loop_x.py').write_text('KIND = "loop_x"\n')
    (tmp_path / 'systems' / 'sys_x.py').write_text('KIND = "sys_x"\n')
    (tmp_path / 'metrics' / 'widgets.py').write_text(
        'def read(name, rec):\n    return rec[name.split(".")[-1]]\n')
    (tmp_path / 'metrics' / 'widgets.special.py').write_text(
        'def read(name, rec):\n    return -1.0\n')
    cell = {'name': 'x', 'config': 'cfg-x', 'traffic': 'mix-x', 'chips': 1}
    config, traffic = core.cell_files(cell, bench=tmp_path)
    assert config['system'] == 'sys_x' and traffic['pages_per_call'] == 3
    assert core.find_module('drivers', traffic['loop'],
                            bench=tmp_path).KIND == 'loop_x'
    assert core.find_module('systems', config['system'],
                            bench=tmp_path).KIND == 'sys_x'
    assert core.metric_reader('widgets.batch', bench=tmp_path).read(
        'widgets.batch', {'batch': 4.0}) == 4.0
    assert core.metric_reader('widgets.special', bench=tmp_path).read(
        'widgets.special', {}) == -1.0
    with pytest.raises(SystemExit):
        core.metric_reader('gadgets.batch', bench=tmp_path)


def test_every_cell_and_metric_of_the_benchmark_has_its_files():
    spec = core.benchmark_spec()
    for cell in spec['workloads']:
        config, traffic = core.cell_files(cell)
        assert (BENCH / 'systems' / f'{config["system"]}.py').exists()
        assert (BENCH / 'drivers' / f'{traffic["loop"]}.py').exists()
        assert (BENCH / 'reference' / f'{config["reference"]}.py').exists()
        reported = core.cell_metrics(spec, cell['name'], 'per_layer')
        assert reported, cell['name']
        assert {m['moves'] for m in reported} <= {
            m['name'] for m in core.cell_metrics(spec, cell['name'],
                                                 'end_to_end')}
    for metric in spec['per_layer']:
        assert callable(core.metric_reader(metric['name']).read)


def test_command_without_a_card_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present: the command would run')
    proc = subprocess.run(
        [sys.executable, str(BENCH / 'run.py'), '--workload',
         'host-batch48', '--seed', str(2 ** 33 + 5), '--seconds', '1',
         '--trace', '0'], capture_output=True, text=True, timeout=300,
        cwd=core.ROOT)
    assert proc.returncode != 0
    assert '{' not in proc.stdout


def _levenshtein_loop(a, b):
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def test_levenshtein_matches_the_loop():
    rng = random.Random(3)
    alphabet = 'abcЖж \n'
    for _ in range(200):
        a = ''.join(rng.choice(alphabet) for _ in range(rng.randrange(12)))
        b = ''.join(rng.choice(alphabet) for _ in range(rng.randrange(12)))
        assert check.levenshtein(a, b) == _levenshtein_loop(a, b)


def test_page_streams_serve_the_pool_evenly_in_seeded_orders():
    a = core.PageStream(np.random.default_rng([2 ** 33 + 1, 0]), 48)
    b = core.PageStream(np.random.default_rng([2 ** 33 + 1, 0]), 48)
    c = core.PageStream(np.random.default_rng([7, 0]), 48)
    first = a.take(100) + a.take(44)
    assert first == b.take(144)
    assert sorted(first) == sorted(list(range(48)) * 3)
    assert first != c.take(144)


class _FakeReference:
    def __init__(self, texts):
        self.texts = texts

    def read_page(self, page, collapse):
        return self.texts[int(page[0, 0])], {}


def test_text_check_compares_every_served_answer(monkeypatch):
    """Every answer counts, each page is read once by each side, and a
    missing answer is left to `missing`."""
    ref = _FakeReference({0: [['abcd']], 1: [['efgh', 'ij']]})
    ctl = _FakeReference({0: [['abcx']], 1: [['efgh', 'ij']]})
    reads = []
    monkeypatch.setattr(check, 'load_reference',
                        lambda config, device: (None, ref, ctl))
    original = _FakeReference.read_page

    def read_page(self, page, collapse):
        reads.append((id(self), int(page[0, 0])))
        return original(self, page, collapse)

    monkeypatch.setattr(_FakeReference, 'read_page', read_page)
    pool = np.array([[[0]], [[1]]])
    config = {'check': {'collapse_runs': False}}
    answers = [(0, [['abcd']]), (1, [['efgh', 'iX']]), (0, [['abcd']]),
               (1, None), (1, [['efgh', 'ij']])]
    got, info = check.text_check(config, answers, pool, 'cpu')
    # edits 0 + 1 + 0 + 0 over 4 + 7 + 4 + 7 reference characters
    assert got['cer'] == pytest.approx(1 / 22)
    assert info['answers_compared'] == 4 and info['pages_read'] == 2
    assert sorted(reads) == sorted([(id(ref), 0), (id(ref), 1)])
    got, _ = check.text_check(config, answers, pool, 'cpu', control=True)
    assert got['cer'] == pytest.approx(2 / 22)


def test_recorder_takes_every_kth_call_from_its_offset():
    rec = seams.Recorder()
    assert not any(rec._take() for _ in range(5))
    rec.arm(every=4, offset=3)
    taken = [k for k in range(20) if rec._take()]
    assert taken == [3, 7, 11, 15, 19]
    rec.disarm()
    assert not rec._take()


def test_percentile_counts_failures_as_slowest():
    values = list(range(1, 10)) + [float('inf')]
    assert core.percentile(values, 50) == 5.5
    assert core.percentile(values, 95) == float('inf')
