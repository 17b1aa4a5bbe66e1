"""The harness's general parts: finding a cell's files by name, the page
pool, seeds, statistics, the devices and the result line.

A cell of BENCHMARK.json names a configuration and a traffic mix; their
files are `configs/<config>.json` and `traffic/<traffic>.json`.  A
configuration names its system (`systems/<system>.py`, which builds the
program under test) and its check (`check.py`); a traffic mix names its
loop (`drivers/<loop>.py`).  A per-layer metric is read by
`metrics/<name>.py`, or, failing that, by the file of its longest dotted
prefix (`roofline.char_head.batch` -> `roofline.char_head.py` ->
`roofline.py`).  New cells, mixes, loops, systems and metrics are new
files; nothing here names one.
"""

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that may not be loaded in a run: JAX and the
#: JAX package (the port's name begins with it, so names compare whole)
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'univer_ocr_tpu')


def setup_env():
    """Every build and kernel cache of a run inside the checkout, at fixed
    paths (the port itself builds its kernels into build/kernels and
    build/native), no JAX pulled in by a library, and one OpenMP thread:
    the serving paths run no parallel CPU op that needs more, and idle
    OpenMP workers that spin beside the program's threads widened a
    single-page tail's run-to-run spread from 5 % to 23 % on the H100
    machine.  Call before torch is imported."""
    os.environ['OMP_NUM_THREADS'] = '1'
    for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton'),
                     ('CUDA_CACHE_PATH', 'cuda_cache')):
        os.environ[var] = str(ROOT / 'build' / sub)
    os.environ['USE_FLAX'] = '0'


def load_json(path):
    with open(path) as fp:
        return json.load(fp)


def benchmark_spec(root=ROOT):
    return load_json(Path(root) / 'BENCHMARK.json')


def find_cell(spec, name):
    for cell in spec['workloads']:
        if cell['name'] == name:
            return cell
    raise SystemExit(f'unknown workload {name!r}; BENCHMARK.json has '
                     f'{[c["name"] for c in spec["workloads"]]}')


def cell_files(cell, bench=BENCH):
    """The configuration and traffic files of a cell, by name."""
    return (load_json(Path(bench) / 'configs' / f'{cell["config"]}.json'),
            load_json(Path(bench) / 'traffic' / f'{cell["traffic"]}.json'))


def load_module(path, name=None):
    spec = importlib.util.spec_from_file_location(
        name or f'bench_{Path(path).stem.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_module(kind, name, bench=BENCH):
    """`<kind>/<name>.py` (kind: systems, drivers)."""
    path = Path(bench) / kind / f'{name}.py'
    if not path.exists():
        raise SystemExit(f'no {kind} file {path}')
    return load_module(path, f'bench_{kind}_{name}')


def metric_reader(name, bench=BENCH):
    """The reader of a per-layer metric: metrics/<name>.py, else the file
    of its longest dotted prefix."""
    parts = name.split('.')
    for n in range(len(parts), 0, -1):
        path = Path(bench) / 'metrics' / ('.'.join(parts[:n]) + '.py')
        if path.exists():
            return load_module(path, 'bench_metric_'
                               + '_'.join(parts[:n]).replace('-', '_'))
    raise SystemExit(f'no reader for per-layer metric {name!r} under '
                     f'{Path(bench) / "metrics"}')


def cell_metrics(spec, cell_name, section):
    """The metrics of BENCHMARK.json's `section` that a cell reports: those
    that list it, or, without `workloads`, those of every cell (end to
    end) or of every cell that reports the metric they move (per layer)."""
    out = []
    for metric in spec[section]:
        cells = metric.get('workloads')
        if cells is None and section == 'per_layer':
            moved = next(m for m in spec['end_to_end']
                         if m['name'] == metric['moves'])
            cells = moved.get('workloads')
        if cells is None or cell_name in cells:
            out.append(metric)
    return out


# -- inputs ---------------------------------------------------------------
def load_pool(bench=BENCH):
    with np.load(Path(bench) / 'data' / 'pages.npz') as f:
        return f['pages']


def load_work(bench=BENCH):
    return load_json(Path(bench) / 'data' / 'work.json')


class PageStream:
    """Pool indices drawn from the seed: whole random permutations of the
    pool end to end, so that every seed serves the pool's pages equally
    often, each in its own order."""

    def __init__(self, rng, n_pool):
        self.rng, self.n_pool = rng, n_pool
        self.buf = []

    def take(self, count):
        while len(self.buf) < count:
            self.buf.extend(self.rng.permutation(self.n_pool).tolist())
        out, self.buf = self.buf[:count], self.buf[count:]
        return out


# -- statistics -------------------------------------------------------------
def percentile(values, q):
    """The q-th percentile, linear between order statistics; inf counts
    as a value (a failed request is slower than any served one)."""
    arr = np.sort(np.asarray(values, np.float64))
    if len(arr) == 0:
        return float('nan')
    pos = (len(arr) - 1) * q / 100.0
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    if lo == hi or arr[hi] == arr[lo]:
        return float(arr[lo])
    return float(arr[lo] + (arr[hi] - arr[lo]) * (pos - lo))


# -- devices -----------------------------------------------------------------
def device_info(torch, devices):
    """The result line's `device`: platform, the card's name, how many the
    run used, and the peak allocated memory of the fullest."""
    if devices[0].type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': len(devices),
                'memory_peak_bytes': 0}
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices)
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(devices[0]),
            'count': len(devices), 'memory_peak_bytes': int(peak)}


def host_sample():
    """This process's CPU seconds and the host clock's now."""
    t = os.times()
    return t.user + t.system, time.perf_counter()


def host_delta(before, after):
    """This process's CPU seconds per wall second between two samples: a
    run whose threads were starved of the host's cores reads lower."""
    return {'process_cpu_per_wall': (after[0] - before[0])
            / max(1e-9, after[1] - before[1])}


def forbidden_loaded():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules
                   if name.split('.')[0] in FORBIDDEN_MODULES})


def log(*args):
    print(*args, file=sys.stderr, flush=True)
