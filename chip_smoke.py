#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (univer_ocr_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printed as `phase <name> start` / `phase <name> done <s>`:

  device   the card's name and power limit (nvidia-smi) and torch's name
           for it; no card -> exit 1
  build    one nvcc command builds every univer_ocr_tpu_torch/csrc/*.cu
  kernels  each CUDA kernel against its plain PyTorch version, on seeded
           inputs and the committed checkpoint's weights, at the shapes
           the main path gives it, at a ragged shape and (Char head) at
           far fewer tiles than SMs
  path     the host-cascade OCRPipeline on the committed fixture's pages
           (one chunk of 8), its text held against the JAX host cascade's
           text stored in the fixture; both kernels must have launched
  times    CUDA-event times of each kernel and its plain version at the
           path's shapes (the Char head at every width bucket) beside
           their bounds, and the path's pages/s (printed, not gated)

Bounds: the larger of the bytes (each input read once, each output
written once) over the HBM rate and the work over the peak rate of the
units the path's precision allows.  The Char head runs in 3xTF32 on the
tensor cores, so its `bound_ms` is three TF32 products at 495 TFLOP/s;
`bound_ffma_ms` beside it is the same work in FP32 FFMA at 67 TFLOP/s
(the bound of the FFMA kernel it replaced).  The Monochrome block has no
tensor-core shape: both its bounds are FFMA.

The Char head's times in the last JSON lines are means per launch over the
width mix the path launched it with (`WIDTH_LAUNCHES`), with each width's
own numbers beside them.  Plain versions run with TF32 off (full float32).

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
MONO_TOL = dict(rtol=1e-5, atol=1e-6)    # tests/test_pallas.py bars
CHAR_TOL = dict(rtol=2e-4, atol=1e-4)
ARGMAX_AGREEMENT = 0.999
#: H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores,
#: dense TF32 on the tensor cores, and HBM3 bandwidth
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
#: Char head shapes held against the plain version: the path's widths,
#: one line of 64 columns (far fewer tiles than SMs) and a ragged one
CHAR_SHAPES = [(16, 256), (16, 512), (16, 1024), (16, 2048), (1, 64),
               (3, 37)]


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


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this run '
              'needs a CUDA card', file=sys.stderr)
        return 1

    from univer_ocr_tpu_torch.models.bucketing import CHAR_WIDTH_MENU
    from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
    from univer_ocr_tpu_torch.ops import kernels
    from univer_ocr_tpu_torch.ops.kernels import _build, char_head
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
        for n, width in CHAR_SHAPES:
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
    pages = [fixture_pages[i % len(fixture_pages)][None, :, :, None]
             for i in range(CHUNK)]

    with OCRPipeline(PAGE_SHAPE, chunk=CHUNK, workers=8, collapse_runs=4,
                     precision='highest', device='cuda') as pipeline:
        with phase('path'):
            kernels.LAUNCHES.clear()
            char_head.WIDTH_LAUNCHES.clear()
            results = pipeline.ocr_pages(pages)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            widths = dict(sorted(char_head.WIDTH_LAUNCHES.items()))
            print(f'path launches: {launches}; fused_char_head by width: '
                  f'{widths}', flush=True)
            if len(results) != CHUNK:
                raise AssertionError(f'{len(results)} results for {CHUNK}')
            exact = 0
            for i, page in enumerate(results):
                want = expected[i % len(expected)]
                ratio = difflib.SequenceMatcher(
                    None, page_text(want), page_text(page),
                    autojunk=False).ratio()
                exact += page == want
                print(f'  page {i}: {sum(len(p) for p in page)} lines, '
                      f'similarity to the JAX text {ratio:.6f}, '
                      f'exact {page == want}', flush=True)
                if ratio < TEXT_SIMILARITY:
                    raise AssertionError(f'page {i}: text similarity '
                                         f'{ratio} < {TEXT_SIMILARITY}')
            print(f'path: {exact}/{CHUNK} pages equal the JAX text exactly',
                  flush=True)
            for name in ('fused_monochrome', 'fused_char_head'):
                if launches.get(name, 0) < 1:
                    raise AssertionError(f'{name} did not launch on the path')

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
            for width in sorted(set(CHAR_WIDTH_MENU) | set(widths)):
                xc = char_inputs(params, rng, 16, width)
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
                chars[width] = t
                print(f'  fused_char_head {t}', flush=True)
            pipeline.ocr_pages(pages)           # warm
            torch.cuda.synchronize()
            reps = 3
            t0 = time.perf_counter()
            for _ in range(reps):
                pipeline.ocr_pages(pages)
            torch.cuda.synchronize()
            chunk_s = (time.perf_counter() - t0) / reps
            print(f'  path: {chunk_s * 1e3:.1f} ms per chunk of {CHUNK} '
                  f'pages, {CHUNK / chunk_s:.2f} pages/s', flush=True)

    # the Char head per launch, over the path's width mix
    n_char = sum(widths.values())
    char = {key: sum(n * chars[w][key] for w, n in widths.items()) / n_char
            for key in ('ms', 'plain_ms', 'bound_ms', 'bound_ffma_ms')}
    char['bound_by'] = 'operations' if all(
        chars[w]['bound_by'] == 'operations' for w in widths) else 'bytes'
    char_widths = {str(w): {'launches': n, 'ms': chars[w]['ms'],
                            'plain_ms': chars[w]['plain_ms'],
                            'bound_ms': chars[w]['bound_ms'],
                            'bound_ffma_ms': chars[w]['bound_ffma_ms']}
                   for w, n in widths.items()}
    print('kernels ' + json.dumps({
        name: {'launches': launches[name], 'max_abs_err': errors[name]}
        for name in ('fused_monochrome', 'fused_char_head')}), flush=True)
    print(f'fused_char_head per width on the path: {json.dumps(char_widths)}; '
          f'all launches: {char["ms"] * n_char:.4f} ms kernel, '
          f'{char["plain_ms"] * n_char:.4f} ms plain, '
          f'{char["bound_ms"] * n_char:.4f} ms 3xTF32 bound, '
          f'{char["bound_ffma_ms"] * n_char:.4f} ms FFMA bound', flush=True)
    print(json.dumps({'kernels': [
        {'name': 'fused_monochrome', 'route': 'cuda',
         'source': 'univer_ocr_tpu_torch/csrc/fused_monochrome.cu',
         'replaces': 'univer_ocr_tpu/ops/pallas/fused_conv.py:87',
         'launches': launches['fused_monochrome'],
         'max_abs_err': errors['fused_monochrome'],
         'ms': mono['ms'], 'plain_ms': mono['plain_ms'],
         'bound_ms': mono['bound_ms'], 'bound_by': mono['bound_by'],
         'bound_ffma_ms': mono['bound_ffma_ms'], 'library_ms': None},
        {'name': 'fused_char_head', 'route': 'cuda',
         'source': 'univer_ocr_tpu_torch/csrc/char_head.cu',
         'replaces': 'univer_ocr_tpu/ops/pallas/char_head.py:61',
         'launches': launches['fused_char_head'],
         'max_abs_err': errors['fused_char_head'],
         'ms': char['ms'], 'plain_ms': char['plain_ms'],
         'bound_ms': char['bound_ms'], 'bound_by': char['bound_by'],
         'bound_ffma_ms': char['bound_ffma_ms'], 'library_ms': None,
         'widths': char_widths},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
