#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (univer_ocr_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printed as `phase <name> start` / `phase <name> done <s>`:

  device   the card's name and power limit (nvidia-smi) and torch's name
           for it; no card -> exit 1
  build    one nvcc per univer_ocr_tpu_torch/csrc/*.cu, started together,
           and one that links them
  kernels  each CUDA kernel against its plain PyTorch version, on seeded
           inputs and the committed checkpoint's weights, at the shapes
           both paths give it, at a ragged shape and (Char head) at
           far fewer tiles than SMs
  path     the host-cascade OCRPipeline on the committed fixture's pages
           (one chunk of 8), its text held against the JAX host cascade's
           text stored in the fixture; both kernels must have launched
  device_path
           the device cascade in its parity mode (`device_cascade=True,
           exact_bands=True`, sampler 'gather') on the same pages, its
           text held against the JAX device cascade's text stored in the
           fixture; both kernels must have launched
  tables_path
           the device cascade in its tables mode (`exact_bands=False`,
           sampler 'twopass', `fused_tail=False`) on the same pages, its
           text held against the JAX tables mode's text stored in the
           fixture; both kernels must have launched; prints the
           escalation counters and the host syncs per paragraph launch
  times    CUDA-event times of each kernel and its plain version at the
           paths' shapes (the Char head at every width each path
           launched) beside their bounds; the JAX device cascade's Char
           head, the width-8 convolution form, beside fused_char_head at
           the device path's line-stage shape (64 lines, 32 rows, W), the
           measurement behind the port's choice of the kernel there;
           pages/s of the host cascade and of both device modes in
           'highest' and 'bf16' (printed, not gated) with each run's
           stage timers (OCRPipeline.timers) per chunk and, in the tables
           mode, its host syncs per paragraph launch; the 'bf16' text
           held against the 'highest' JAX text at JAX's own bar
           (similarity > 0.9, tests/test_pipeline.py); and one
           torch.profiler window over a chunk of each: the device's busy
           share of the window and its top kernels by device time; and
           for both device modes, every sync of one chunk as torch's
           sync debug mode reports it, by line and per paragraph launch

Bounds: the larger of the bytes (each input read once, each output
written once) over the HBM rate and the work over the peak rate of the
units the path's precision allows.  The Char head runs in 3xTF32 on the
tensor cores, so its `bound_ms` is three TF32 products at 495 TFLOP/s;
`bound_ffma_ms` beside it is the same work in FP32 FFMA at 67 TFLOP/s
(the bound of the FFMA kernel it replaced).  The Monochrome block has no
tensor-core shape: both its bounds are FFMA.

The tables path is this slice's main path: each kernel's `launches` in the
last JSON lines is its count on that path's run, and the Char head's times
there are means per launch over that run's width mix (`WIDTH_LAUNCHES`),
with each width's own numbers beside them.  `launches_by_path` gives each
path's count (each path's run starts with the counts at 0), and the Char
head's `host_path` and `device_path` entries its times over those paths'
mixes.  Plain
versions run with TF32 off (full float32).

Any failure ends the run with a traceback and a non-zero exit before the
last line, which on success is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

import contextlib
import difflib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / 'univer_ocr_tpu_torch' / 'fixtures' / 'smoke_pages.npz'
PAGE_SHAPE = (1, 496, 736, 1)
CHUNK = 8
#: per-page character similarity the card's text must reach against the
#: JAX text (float sums in another order can flip a pixel that sits on a
#: threshold; exact equality is reported beside it)
TEXT_SIMILARITY = 0.99
#: similarity of the whole 'bf16' text to the 'highest' text: the JAX
#: package's own bar (tests/test_pipeline.py,
#: test_device_cascade_bf16_close_to_f32)
BF16_SIMILARITY = 0.9
#: the device cascade's parity mode
DEVICE_CASCADE = dict(device_cascade=True, exact_bands=True)
#: its tables mode, without the fused tail (not ported)
TABLES_MODE = dict(device_cascade=True, exact_bands=False, sampler='twopass',
                   fused_tail=False)
#: timed runs of each pipeline, after one warm-up run
REPS = 3
MONO_TOL = dict(rtol=1e-5, atol=1e-6)    # tests/test_pallas.py bars
CHAR_TOL = dict(rtol=2e-4, atol=1e-4)
ARGMAX_AGREEMENT = 0.999
#: H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores,
#: dense TF32 on the tensor cores, and HBM3 bandwidth
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
#: lines per Char head launch: the host path's and the device path's
HOST_LINES, DEVICE_LINES = 16, 64


@contextlib.contextmanager
def phase(name):
    print(f'phase {name} start', flush=True)
    t0 = time.perf_counter()
    try:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    except BaseException:
        print(f'phase {name} failed after {time.perf_counter() - t0:.2f} s',
              flush=True)
        raise
    print(f'phase {name} done {time.perf_counter() - t0:.2f}', flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, flops, flops_per_s=FP32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes > t_ops else 'operations')


def compare(name, got, exp, tol):
    err = (got - exp).abs().max().item()
    ok = torch.allclose(got, exp, **tol)
    print(f'  {name}: max_abs_err={err:.3e} max_abs_ref='
          f'{exp.abs().max().item():.3e} within {tol}: {ok}', flush=True)
    if not ok:
        raise AssertionError(f'{name} disagrees with its plain version')
    return err


def char_inputs(params, rng, n, width):
    """The Char conv stack's output on seeded random line images: the
    activations the fused head receives on the main path."""
    from univer_ocr_tpu_torch import ops
    x = torch.tensor(rng.random((n, 32, width, 1), dtype=np.float32),
                     device='cuda')
    for i in (1, 2, 3):
        p = params[f'Char/conv_block/conv_{i}']
        x = ops.leaky_relu(ops.conv2d(x, p['w'], p['b'], stride=(2, 1),
                                      padding=(0, 1), precision='highest'))
    return x[:, 0].contiguous()


def page_text(page):
    return '\n\n'.join('\n'.join(lines) for lines in page)


def check_text(label, results, expected):
    """Each page's text against the JAX text at TEXT_SIMILARITY."""
    if len(results) != CHUNK:
        raise AssertionError(f'{label}: {len(results)} results for {CHUNK}')
    exact = 0
    for i, page in enumerate(results):
        want = expected[i % len(expected)]
        ratio = difflib.SequenceMatcher(
            None, page_text(want), page_text(page), autojunk=False).ratio()
        exact += page == want
        print(f'  page {i}: {sum(len(p) for p in page)} lines, '
              f'similarity to the JAX text {ratio:.6f}, '
              f'exact {page == want}', flush=True)
        if ratio < TEXT_SIMILARITY:
            raise AssertionError(f'{label} page {i}: text similarity '
                                 f'{ratio} < {TEXT_SIMILARITY}')
    print(f'{label}: {exact}/{CHUNK} pages equal the JAX text exactly',
          flush=True)


def counted_run(pipeline, pages):
    """One ocr_pages call with every launch count set to 0 just before it;
    returns (results, launches by kernel, fused_char_head launches by W)."""
    from univer_ocr_tpu_torch.ops.kernels import LAUNCHES, char_head
    LAUNCHES.clear()
    char_head.WIDTH_LAUNCHES.clear()
    results = pipeline.ocr_pages(pages)
    torch.cuda.synchronize()
    return (results, dict(LAUNCHES),
            dict(sorted(char_head.WIDTH_LAUNCHES.items())))


def syncs_per_launch(counts):
    """Host syncs per paragraph launch of the tables mode, from
    OCRPipeline.host_syncs (one 'suspect_check' per launch)."""
    launches = counts.get('suspect_check', 0)
    return sum(counts.values()) / launches if launches else None


def timed_runs(pipeline, pages, label, expected):
    """pages/s over REPS runs after a warm one, with the stage timers on
    for the timed runs.  The warm run's text is held against `expected`,
    the cascade's 'highest' JAX text: per page in 'highest', as a whole at
    BF16_SIMILARITY in 'bf16'."""
    from univer_ocr_tpu_torch.utils.profiling import StageTimers
    results = pipeline.ocr_pages(pages)           # warm
    torch.cuda.synchronize()
    if pipeline.precision == 'bf16':
        wanted = [expected[i % len(expected)] for i in range(len(results))]
        ratios = [difflib.SequenceMatcher(
            None, page_text(want), page_text(page), autojunk=False).ratio()
            for want, page in zip(wanted, results)]
        whole = difflib.SequenceMatcher(
            None, '\n'.join(page_text(want) for want in wanted),
            '\n'.join(page_text(page) for page in results),
            autojunk=False).ratio()
        print(f'  {label}: similarity to the highest JAX text per page '
              f'{[round(r, 6) for r in ratios]}, whole {whole:.6f}',
              flush=True)
        if whole <= BF16_SIMILARITY:
            raise AssertionError(f'{label}: bf16 text similarity {whole} '
                                 f'<= {BF16_SIMILARITY}')
    else:
        check_text(label, results, expected)
    pipeline.timers = StageTimers()
    pipeline.timeline.clear()
    pipeline.host_syncs.clear()
    t0 = time.perf_counter()
    for _ in range(REPS):
        pipeline.ocr_pages(pages)
    torch.cuda.synchronize()
    chunk_s = (time.perf_counter() - t0) / REPS
    syncs = pipeline.host_syncs
    if syncs:
        print(f'  {label}: host syncs {dict(syncs)} over {REPS} chunks, '
              f'{syncs_per_launch(syncs):.3f} per paragraph launch',
              flush=True)
    stages = {name: round(1e3 * total / REPS, 3)
              for name, total in sorted(pipeline.timers.totals.items())}
    pipeline.timers = None
    print(f'  {label}: {chunk_s * 1e3:.1f} ms per chunk of {CHUNK} pages, '
          f'{CHUNK / chunk_s:.2f} pages/s', flush=True)
    print(f'  {label} stage timers, ms per chunk (summed over threads): '
          f'{json.dumps(stages)}', flush=True)
    return CHUNK / chunk_s, stages


def sync_census(pipeline, pages, label):
    """Every sync one chunk makes, as torch's sync debug mode reports it
    (a copy from pageable host memory, a read of a device value, ...),
    counted by the line that made it and per paragraph launch (the
    'bands' pulls of the timeline), beside what pipeline.host_syncs
    counted in the same run."""
    import warnings
    from univer_ocr_tpu_torch.utils.profiling import StageTimers
    pipeline.timers = StageTimers()
    pipeline.timeline.clear()
    pipeline.host_syncs.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            pipeline.ocr_pages(pages)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = sum(tag == 'bands' for tag, *_ in pipeline.timeline)
    pipeline.timers = None
    where = {}
    for w in caught:
        if 'synchroniz' in str(w.message):
            key = f'{Path(w.filename).name}:{w.lineno}'
            where[key] = where.get(key, 0) + 1
    total = sum(where.values())
    print(f'  {label} syncs over one chunk (torch sync debug mode): {total} '
          f'in {launches} paragraph launches, '
          f'{total / max(launches, 1):.3f} per launch; host_syncs '
          f'{dict(pipeline.host_syncs)}; by line '
          f'{json.dumps(dict(sorted(where.items(), key=lambda kv: -kv[1])))}',
          flush=True)
    return total, launches


def profile_window(pipeline, pages, label):
    """One torch.profiler window over one chunk: the device's busy share
    of the window (device time of every CUDA activity over the window's
    host time) and its top kernels by device time."""
    from torch.autograd import DeviceType
    from univer_ocr_tpu_torch.utils.profiling import device_trace
    with device_trace(ROOT / 'build' / 'traces' / label) as prof:
        t0 = time.perf_counter()
        pipeline.ocr_pages(pages)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    def device_us(event):
        for key in ('self_device_time_total', 'self_cuda_time_total'):
            if hasattr(event, key):
                return getattr(event, key)
        return 0.0

    kernels = [(device_us(e), e.count, e.key) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy_ms = sum(us for us, _, _ in kernels) / 1e3
    if busy_ms == 0:
        print(f'  {label} profiler: key_averages() shows no device time; '
              f'no busy share read', flush=True)
        return None
    top = sorted(kernels, reverse=True)[:8]
    print(f'  {label} profiler: window {window_ms:.1f} ms, device busy '
          f'{busy_ms:.2f} ms ({100 * busy_ms / window_ms:.1f} %) over '
          f'{sum(n for _, n, _ in kernels)} device activities', flush=True)
    for us, n, name in top:
        print(f'    {us / 1e3:9.3f} ms x{n:<5d} {name[:110]}', flush=True)
    return busy_ms / window_ms


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this run '
              'needs a CUDA card', file=sys.stderr)
        return 1

    from univer_ocr_tpu_torch.models.bucketing import CHAR_WIDTH_MENU
    # the paths' Char head shapes at every width bucket, one line of 64
    # columns (far fewer tiles than SMs) and a ragged one
    char_shapes = [(n, w) for n in (HOST_LINES, DEVICE_LINES)
                   for w in CHAR_WIDTH_MENU] + [(1, 64), (3, 37)]
    from univer_ocr_tpu_torch.models.fastpath import char_head_conv
    from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
    from univer_ocr_tpu_torch.ops import kernels
    from univer_ocr_tpu_torch.ops.kernels import _build
    from univer_ocr_tpu_torch.ops.precision import backend_flags
    from univer_ocr_tpu_torch.weights import load_checkpoint

    with phase('device'):
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, check=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0]
        kind = torch.cuda.get_device_name(0)
        print(f'nvidia-smi: {card}', flush=True)
        import scipy
        print(f'torch: {kind}, {torch.cuda.device_count()} device(s), '
              f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
              f'numpy {np.__version__}, scipy {scipy.__version__}',
              flush=True)

    with phase('build'):
        info = _build.build()
        summary = [l.strip() for l in info['log'].splitlines()
                   if 'registers' in l or 'spill' in l]
        print(f'build: {info["seconds"]:.2f} s -> {info["path"].name}',
              flush=True)
        for line in summary:
            print(f'  ptxas: {line}', flush=True)
        _build.library()

    params = load_checkpoint(device='cuda')
    mono_w = [params['Monochrome/conv_1']['w'], params['Monochrome/conv_1']['b'],
              params['Monochrome/conv_2']['w'], params['Monochrome/conv_2']['b']]
    char_w = [params[f'Char/dense_block/dense_{i}']['w'] for i in (1, 2, 3)]
    mono_prep = kernels.prepare_monochrome(*mono_w)
    char_prep = kernels.prepare_char_head(*char_w)
    rng = np.random.default_rng(0)
    errors = {}

    with phase('kernels'), backend_flags('highest'):
        err = 0.0
        for shape in [(CHUNK,) + PAGE_SHAPE[1:], (2, 100, 203, 1)]:
            x = torch.tensor(rng.random(shape, dtype=np.float32),
                             device='cuda')
            err = max(err, compare(
                f'fused_monochrome {shape}', kernels.fused_monochrome(
                    x, mono_prep),
                kernels.fused_monochrome_reference(x, *mono_w), MONO_TOL))
        errors['fused_monochrome'] = err
        err = 0.0
        for n, width in char_shapes:
            x = char_inputs(params, rng, n, width)
            got = kernels.fused_char_head(x, char_prep)
            exp = kernels.fused_char_head_reference(x, *char_w)
            err = max(err, compare(f'fused_char_head {(n, width, 64)}',
                                   got, exp, CHAR_TOL))
            agree = (got.argmax(-1) == exp.argmax(-1)).float().mean().item()
            print(f'  fused_char_head argmax agreement {agree:.6f}',
                  flush=True)
            if agree < ARGMAX_AGREEMENT:
                raise AssertionError('fused_char_head argmax disagrees')
        errors['fused_char_head'] = err

    with np.load(FIXTURE) as f:
        fixture_pages = f['pages']
        expected = json.loads(str(f['texts']))
        expected_device = json.loads(str(f['device_texts']))
        expected_tables = json.loads(str(f['tables_texts']))
    pages = [fixture_pages[i % len(fixture_pages)][None, :, :, None]
             for i in range(CHUNK)]

    def pipeline(precision, **kwargs):
        return OCRPipeline(PAGE_SHAPE, weights=params, chunk=CHUNK,
                           workers=8, collapse_runs=4, precision=precision,
                           device='cuda', **kwargs)

    launches = {}
    with pipeline('highest') as host, \
            pipeline('highest', **DEVICE_CASCADE) as device, \
            pipeline('highest', **TABLES_MODE) as tables:
        with phase('path'):
            results, launches['path'], widths = counted_run(host, pages)
            print(f'path launches: {launches["path"]}; fused_char_head by '
                  f'width: {widths}', flush=True)
            check_text('path', results, expected)
            for name in ('fused_monochrome', 'fused_char_head'):
                if launches['path'].get(name, 0) < 1:
                    raise AssertionError(f'{name} did not launch on the path')

        with phase('device_path'):
            results, launches['device_path'], line_widths = counted_run(
                device, pages)
            print(f'device_path launches: {launches["device_path"]}; '
                  f'fused_char_head by width: {line_widths}', flush=True)
            check_text('device_path', results, expected_device)
            for name in ('fused_monochrome', 'fused_char_head'):
                if launches['device_path'].get(name, 0) < 1:
                    raise AssertionError(f'{name} did not launch on the '
                                         f'device path')

        with phase('tables_path'):
            tables.host_syncs.clear()
            results, launches['tables_path'], table_widths = counted_run(
                tables, pages)
            print(f'tables_path launches: {launches["tables_path"]}; '
                  f'fused_char_head by width: {table_widths}', flush=True)
            print(f'tables_path escalation_stats: '
                  f'{json.dumps(tables.escalation_stats)}', flush=True)
            print(f'tables_path host syncs: {dict(tables.host_syncs)}, '
                  f'{syncs_per_launch(tables.host_syncs)} per paragraph '
                  f'launch', flush=True)
            check_text('tables_path', results, expected_tables)
            for name in ('fused_monochrome', 'fused_char_head'):
                if launches['tables_path'].get(name, 0) < 1:
                    raise AssertionError(f'{name} did not launch on the '
                                         f'tables path')

        with phase('times'), backend_flags('highest'):
            print(f'times on: {card}', flush=True)
            x = torch.tensor(rng.random((CHUNK,) + PAGE_SHAPE[1:],
                                        dtype=np.float32), device='cuda')
            n_px = x.numel()
            mono = {
                'ms': cuda_ms(lambda: kernels.fused_monochrome(x, mono_prep)),
                'plain_ms': cuda_ms(
                    lambda: kernels.fused_monochrome_reference(x, *mono_w)),
                'shape': list(x.shape),
            }
            mono['bound_ms'], mono['bound_by'] = bound_ms(
                2 * 4 * n_px + 4 * sum(w.numel() for w in mono_w),
                2 * (9 * 16 + 9 * 16) * n_px)
            mono['bound_ffma_ms'] = mono['bound_ms']
            print(f'  fused_monochrome {mono}', flush=True)
            chars = {}
            for n, width in sorted(
                    {(HOST_LINES, w) for w in widths}
                    | {(DEVICE_LINES, w)
                       for w in set(line_widths) | set(table_widths)}):
                xc = char_inputs(params, rng, n, width)
                cols = xc.shape[0] * xc.shape[1]
                t = {
                    'ms': cuda_ms(lambda: kernels.fused_char_head(
                        xc, char_prep)),
                    'plain_ms': cuda_ms(
                        lambda: kernels.fused_char_head_reference(
                            xc, *char_w)),
                    'shape': list(xc.shape),
                }
                n_bytes = 4 * (xc.numel() + cols * char_w[2].shape[1]
                               + sum(w.numel() for w in char_w))
                flops = 2 * cols * (512 * 1024 + 1024 * 128 + 128 * 162)
                t['bound_ms'], t['bound_by'] = bound_ms(
                    n_bytes, 3 * flops, TF32_FLOPS)
                t['bound_ffma_ms'] = bound_ms(n_bytes, flops)[0]
                chars[n, width] = t
                print(f'  fused_char_head {t}', flush=True)
            # the JAX device cascade's Char head (the width-8 convolution
            # form) beside the kernel at the line stage's shape
            for width, n in table_widths.items():
                xc = char_inputs(params, rng, DEVICE_LINES, width)
                t = {'launches': n, 'shape': list(xc.shape),
                     'fused_char_head_ms': chars[DEVICE_LINES, width]['ms'],
                     'conv_highest_ms': cuda_ms(
                         lambda: char_head_conv(params, xc, 'highest'))}
                with backend_flags('bf16'):
                    t['conv_bf16_ms'] = cuda_ms(
                        lambda: char_head_conv(params, xc, 'bf16'))
                print(f'  conv head vs fused_char_head at W={width}: {t}',
                      flush=True)
            rates = {'host highest': timed_runs(host, pages, 'host highest',
                                                expected),
                     'device highest': timed_runs(device, pages,
                                                  'device highest',
                                                  expected_device),
                     'tables highest': timed_runs(tables, pages,
                                                  'tables highest',
                                                  expected_tables)}
            for label, kwargs, highest in (
                    ('host bf16', {}, expected),
                    ('device bf16', DEVICE_CASCADE, expected_device),
                    ('tables bf16', TABLES_MODE, expected_tables)):
                with pipeline('bf16', **kwargs) as pl:
                    rates[label] = timed_runs(pl, pages, label, highest)
            print('pages/s ' + json.dumps(
                {label: r[0] for label, r in rates.items()}), flush=True)
            for label, pl in (('host', host), ('device', device),
                              ('tables', tables)):
                profile_window(pl, pages, label)
            for label, pl in (('device', device), ('tables', tables)):
                sync_census(pl, pages, label)

    def char_mix(n_lines, mix, label):
        """The Char head per launch over one path's width mix."""
        total = sum(mix.values())
        keys = ('ms', 'plain_ms', 'bound_ms', 'bound_ffma_ms')
        out = {key: sum(n * chars[n_lines, w][key] for w, n in mix.items())
               / total for key in keys}
        out['bound_by'] = 'operations' if all(
            chars[n_lines, w]['bound_by'] == 'operations'
            for w in mix) else 'bytes'
        out['widths'] = {
            str(w): {'launches': n, 'shape': chars[n_lines, w]['shape'],
                     **{key: chars[n_lines, w][key] for key in keys}}
            for w, n in mix.items()}
        print(f'fused_char_head on the {label}: {json.dumps(out)}; all '
              f'{total} launches: {out["ms"] * total:.4f} ms kernel, '
              f'{out["plain_ms"] * total:.4f} ms plain, '
              f'{out["bound_ms"] * total:.4f} ms 3xTF32 bound, '
              f'{out["bound_ffma_ms"] * total:.4f} ms FFMA bound', flush=True)
        return out

    char = char_mix(DEVICE_LINES, table_widths, 'tables path')
    device_char = char_mix(DEVICE_LINES, line_widths, 'device path')
    host_char = char_mix(HOST_LINES, widths, 'host path')
    by_path = {name: {path: counts.get(name, 0)
                      for path, counts in launches.items()}
               for name in ('fused_monochrome', 'fused_char_head')}
    print('kernels ' + json.dumps({
        name: {'launches': by_path[name], 'max_abs_err': errors[name]}
        for name in by_path}), flush=True)
    print(json.dumps({'kernels': [
        {'name': 'fused_monochrome', 'route': 'cuda',
         'source': 'univer_ocr_tpu_torch/csrc/fused_monochrome.cu',
         'replaces': 'univer_ocr_tpu/ops/pallas/fused_conv.py:87',
         'launches': by_path['fused_monochrome']['tables_path'],
         'launches_by_path': by_path['fused_monochrome'],
         'max_abs_err': errors['fused_monochrome'],
         'ms': mono['ms'], 'plain_ms': mono['plain_ms'],
         'bound_ms': mono['bound_ms'], 'bound_by': mono['bound_by'],
         'bound_ffma_ms': mono['bound_ffma_ms'], 'library_ms': None},
        {'name': 'fused_char_head', 'route': 'cuda',
         'source': 'univer_ocr_tpu_torch/csrc/char_head.cu',
         'replaces': 'univer_ocr_tpu/ops/pallas/char_head.py:61',
         'launches': by_path['fused_char_head']['tables_path'],
         'launches_by_path': by_path['fused_char_head'],
         'max_abs_err': errors['fused_char_head'],
         'ms': char['ms'], 'plain_ms': char['plain_ms'],
         'bound_ms': char['bound_ms'], 'bound_by': char['bound_by'],
         'bound_ffma_ms': char['bound_ffma_ms'], 'library_ms': None,
         'widths': char['widths'], 'device_path': device_char,
         'host_path': host_char},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
