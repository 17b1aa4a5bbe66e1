"""One run of one cell: set-up, the measured window, the check and the
result line.  `run.py` is the command; `main(argv, device=)` is here so
that the CPU tests can drive a whole run on the host (`device='cpu'`),
which the command itself never does."""

import argparse
import gc
import json
import math
import subprocess
import time
from types import SimpleNamespace

import numpy as np

from benchmark import check, core, tracing


def parse(argv):
    ap = argparse.ArgumentParser(prog='benchmark/run.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--control', type=int, choices=(0, 1), default=0,
                    help='put the float8 reference in the program\'s place '
                         'in the check (the control; never in the '
                         'benchmark\'s own runs)')
    return ap.parse_args(argv)


def _devices(torch, chips, device):
    if device is not None:
        return [torch.device(device)] * chips
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: torch.cuda.is_available() is False '
                         '(the benchmark measures the card and never falls '
                         'back to the CPU)')
    if torch.cuda.device_count() < chips:
        raise SystemExit(f'the cell asks for {chips} cards; '
                         f'{torch.cuda.device_count()} are visible')
    return [torch.device('cuda', i) for i in range(chips)]


def _power_limit():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'not read'


def _timer_totals(pipelines):
    out = {}
    for p in pipelines:
        if p.timers is None:
            continue
        for name, total in p.timers.totals.items():
            row = out.setdefault(name, {'total_s': 0.0, 'count': 0})
            row['total_s'] += total
            row['count'] += p.timers.counts[name]
    return out


def _peak(spec_peaks, kind, precision):
    for entry in spec_peaks['cards']:
        if entry['match'] in kind:
            return {'flops': entry['flops'][precision],
                    'bytes_per_s': entry['bytes_per_s'],
                    'card': entry['name']}
    return None


def main(argv=None, device=None, t0=None):
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    spec = core.benchmark_spec()
    cell = core.find_cell(spec, args.workload)
    config, traffic = core.cell_files(cell)
    import torch
    t_torch = time.perf_counter()
    devices = _devices(torch, cell['chips'], device)
    sync_devices = sorted({d for d in devices if d.type == 'cuda'},
                          key=str)

    def sync():
        for d in sync_devices:
            torch.cuda.synchronize(d)

    rng_traffic = np.random.default_rng([args.seed, 0])
    rng_check = np.random.default_rng([args.seed, 1])
    pool = core.load_pool()
    work = core.load_work()
    recorder = None
    if 'seams' in config['check']['kinds']:
        from benchmark import seams
        recorder = seams.Recorder().install()
    try:
        return _run(args, spec, cell, config, traffic, devices, sync,
                    rng_traffic, rng_check, pool, work, recorder,
                    (t0, t_torch), torch)
    finally:
        if recorder is not None:
            recorder.uninstall()


def _run(args, spec, cell, config, traffic, devices, sync, rng_traffic,
         rng_check, pool, work, recorder, stamps, torch):
    t0, t_torch = stamps
    system = core.find_module('systems', config['system']).build(
        config, devices, core.ROOT)
    sync()
    t_built = time.perf_counter()
    driver = core.find_module('drivers', traffic['loop'])
    pages = [p[None, :, :, None] for p in pool]
    ctx = SimpleNamespace(system=system, traffic=traffic, pool=pool,
                          work=work, page=pages.__getitem__, rng=rng_traffic,
                          seconds=args.seconds, window=None,
                          sync=sync)
    driver.warm(ctx)
    sync()
    t_warm = time.perf_counter()
    setup_s = t_warm - t0
    setup_parts = {'start_to_torch_s': t_torch - t0,
                   'build_s': t_built - t_torch,
                   'warm_s': t_warm - t_built}
    if args.trace:
        # the profiler's first start initialises CUPTI for seconds: once
        # here, so that the window's profiler opens at once
        warm_up = tracing.ProfilerWindow(devices)
        warm_up.start()
        warm_up.stop()
        spans = []
        for p in system.pipelines():
            p.timers = tracing.span_timers(spans)
        ctx.window = tracing.ProfilerWindow(devices, spans)
    if recorder is not None:
        every = traffic['record_every']
        recorder.arm(every, int(rng_check.integers(every)))
    host_before = core.host_sample()
    result = driver.run(ctx)
    sync()
    host = core.host_delta(host_before, core.host_sample())
    if recorder is not None:
        recorder.disarm()
    device_line = core.device_info(torch, devices)
    records = None
    if args.trace:
        chunk = config.get('pipeline', {}).get('chunk', 1)
        calls = result['calls']
        tr = ctx.window.reduce() if ctx.window.done else None
        records = {
            'timers': _timer_totals(system.pipelines()),
            'counts': {'calls': len(calls), 'pages': sum(calls),
                       'chunks': sum(-(-n // chunk) for n in calls)},
            'trace': tr, 'units': result['units'], 'work': work,
            'devices': len(devices),
            'peak': _peak(core.load_json(core.BENCH / 'peaks.json'),
                          device_line['kind'], config['precision']),
        }
        if tr is not None:
            device_line['busy_s'] = tr['busy_s']
            device_line['window_s'] = tr['window_s']
    for p in system.pipelines():
        p.timers = None
    system.close()
    del system, ctx
    gc.collect()
    if devices[0].type == 'cuda':
        torch.cuda.empty_cache()

    # the check, once the window has closed and the program is freed
    t_check = time.perf_counter()
    answers = result['answers']
    numbers = {'missing': sum(a is None for _, a in answers)}
    info = {}
    if 'text' in config['check']['kinds']:
        got, more = check.text_check(config, answers, pool, devices[0],
                                     control=bool(args.control))
        numbers.update(got)
        info.update(more)
    if recorder is not None:
        got, more = check.seams_check(config, recorder, devices[0],
                                      control=bool(args.control))
        numbers.update(got)
        info.update(more)
    correct, rows = check.judge(numbers, config['check']['limits'])
    correct = correct and len(answers) > 0
    info['check_s'] = time.perf_counter() - t_check

    if args.trace:
        metrics = {}
        for m in core.cell_metrics(spec, cell['name'], 'per_layer'):
            value = core.metric_reader(m['name']).read(m['name'], records)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        metrics = {}
        measured = dict(result['metrics'], setup_s=setup_s)
        for m in core.cell_metrics(spec, cell['name'], 'end_to_end'):
            metrics[m['name']] = {'value': measured[m['name']],
                                  'unit': m['unit']}

    core.log('setup_s', setup_s)
    core.log('setup_parts:', json.dumps(setup_parts))
    core.log('host_in_window:', json.dumps(host))
    for key, value in sorted(result['notes'].items()):
        core.log(f'{key}: {value}')
    for key, value in sorted(info.items()):
        core.log(f'check {key}: {value}')
    if records is not None:
        core.log('card and power limit:', _power_limit(),
                 '| peaks:', json.dumps(records['peak']))
        if records['trace'] is not None:
            core.log('busy_by_device:', records['trace']['busy_by_device'])
    bad = core.forbidden_loaded()
    if bad:
        core.log('loaded in this process, which a run may not load:', bad)
        raise SystemExit(3)
    checked = {name: {'value': value, 'limit': limit}
               for name, value, limit in rows}
    for name, value, limit in rows:
        core.log(f'check {name}: {value} limit {limit} '
                 f'{"ok" if value <= limit else "OVER"}')
    line = {'correct': bool(correct), 'attempted': len(answers),
            'failed': int(numbers['missing']), 'metrics': metrics,
            'device': device_line}
    if records is not None and records['trace'] is not None:
        line['breakdown'] = records['trace']['breakdown']
    line['checked'] = checked
    print(json.dumps(_plain(line)), flush=True)
    return line


def _plain(v):
    """JSON-safe copy: numpy scalars as Python numbers, and an infinite
    reading (a seam never reached, a tail past every served request) as
    1e300, which no limit admits."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, (np.floating, np.integer)):
        v = v.item()
    if isinstance(v, float) and not math.isfinite(v):
        return 1e300
    return v
