#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (univer_ocr_tpu_torch) on one card.

    python3 chip_smoke.py           # every phase, on one card
    python3 chip_smoke.py --mesh    # device, build and mesh_path only (the
                                    # run for a machine of several cards)

Phases, each printed as `phase <name> start` / `phase <name> done <s>`:

  device   the card's name and power limit (nvidia-smi) and torch's name
           for it; no card -> exit 1
  build    one nvcc per univer_ocr_tpu_torch/csrc/*.cu, started together,
           and one that links them; beside them, the g++ of the native
           host-CV library (csrc/host/univocr_native.cpp), with its
           seconds
  kernels  each CUDA kernel against its plain PyTorch version, on seeded
           inputs and the committed checkpoint's weights, at the shapes
           the paths give it (the Monochrome block at a chunk's and at
           the single-page chain's one page), at a ragged shape and (Char head) at
           far fewer tiles than SMs; and the device paragraph planners
           (device_chunk_plans, device_page_plans) on the card against
           the same planners on the CPU, on the fixture pages' paragraph
           masks: labels, counts and every plan field equal
  band_ccl the labelling kernel (csrc/band_ccl.cu) against its plain
           version, at the shapes the paths give it (both band channels
           of a paragraph launch at each menu bucket, a chunk's
           paragraph masks) and ragged ones, on random masks and on
           band-like stripes: statistics, counts and labels equal; ms
           per launch
  path     the host-cascade OCRPipeline on the committed fixture's pages
           (one chunk of 8), its text held against the JAX host cascade's
           text stored in the fixture; both kernels must have launched
  host_native
           the native CCL (univer_ocr_tpu_torch/native.py) on the masks
           the host cascade labels: the paragraph masks of the chunk's 8
           pages (its front) and every Line band channel of the chunk,
           labels and counts equal to scipy.ndimage.label's exactly; the
           median ms per call of native against scipy for `label` and for
           `interpreter.label_layer`, with their sums per chunk; then the
           chunk through the host cascade with scipy's labels and the
           native ones in turns (scipy, native, native, scipy), its text
           JAX's each time, with the host CV stage timers of each run
  device_path
           the device cascade in its parity mode (`device_cascade=True,
           exact_bands=True`) on the same pages, its text held against
           the host cascade's text stored in the fixture (`texts`: the
           device cascade computes the host cascade's crops and line
           plans); both kernels must have launched
  tables_path
           the device cascade in its tables mode (`exact_bands=False`,
           `fused_tail=False`) on the same pages, its text held against
           the same text; the Monochrome and Char head kernels and
           band_ccl must have launched; prints the planning counters and
           the host syncs per chunk
  fused_path
           the serving default (`device_cascade=True, collapse_runs=4`:
           the device chunk planner and the fused tail) on the same
           pages, its text held against the same text; the three kernels
           must have launched;
           prints the escalation counters, the host syncs and a census
           of one chunk's syncs under torch's sync debug mode; then 3
           chunks in one call, their text checked and the device
           memory they took printed; then one chunk with the chunk
           planner's cap cut to the fewest components of a fixture
           page, so that the pages with more fall back to the host
           planner beside pages planned on the card: the count of
           fallbacks and the text checked, the kernels launched
  chain_path
           the same pipeline on each of the 4 fixture pages alone, the
           single-page chain, each text held against the same text, with
           no fallback to the host-planned path (no fixture page has
           more components than the chain takes); the kernels must have
           launched; prints the same counters and a census; then a page
           of 48 ink blobs, more than the chain takes: it must fall back
           to the host-planned fused dispatch, with the text of the
           device-planned chunk path and the kernels launched
  reference_path
           the single-page chain and a chunk of the serving default in
           'bf16' on pool pages of the benchmark
           (benchmark/data/pages.npz) against the benchmark's plain
           reference (benchmark/reference/cascade.py, float32, TF32 off)
           on the card: lines and characters apart (`cer`), within
           REFERENCE_CER
  serve_path
           the web app on the card (univer_ocr_tpu_torch.web: create_app(),
           start_background(port=0)): POST /ocr of the 4 fixture pages
           cropped by one pixel on every side (bucketed to 496x736) and
           of the first 2 whole (bucketed to 752x992) as .npy bodies,
           with the launch counts from 0 just before them (both kernels
           must launch); each answer equal to its pipeline's ocr_pages on
           bucket_page of the body and within BF16_SIMILARITY of the JAX
           package's /ocr answer to the same body (`ocr_texts`); a
           garbage body refused with a 400; 8 sequential requests at
           496x736 (p50 and spread) and 4 concurrent ones (requests/s),
           their texts the sequential ones; the first request per shape
           in ms; then a /train-ws micro run (train_model at 1 epoch of
           TRAIN_MONOCHROME on the training fixture, writing
           build/serve/, reporting through init_emitter) whose browser
           must receive message, info and every DASHBOARD_TYPES type;
           and `python -m univer_ocr_tpu_torch predict PAGE.npy` in a
           subprocess, its printed text equal to predict() in process
  groundtruth_path
           ground truth and the accuracy entry on the eval corpus's 8
           pages with all 17 layers (fixtures/eval_layers.npz):
           interpret() of each page equal to JAX's stored dict;
           eval_accuracy.main
           (`--pages`, the serving default in 'bf16', min-run 4) twice,
           the second timed (pages/s), its score within GATE_SCORE_TOL of
           the host cascade's in the same call and equal to
           evaluation.score_weights in the same call,
           both kernels launched; eval_accuracy.main_gt_crops (the Char
           model on crops cut from the ground-truth masks) in 'highest'
           and 'bf16', each page's lines against JAX's stored lines
           (GT_CROP_SIMILARITY), ms per page, the Char head launched and
           held to its plain version at every shape it was given; and the
           feed: with the card initialised, a DataGenerator of 2 spawned
           workers replaying the fixture's pages delivers 2 x FEED_QUEUE
           pages, each equal to the fixture's, and stop() ends its
           processes within FEED_STOP_S.  Launch counts from 0 just
           before each run, printed by kernel and shape
  train_path
           training (univer_ocr_tpu_torch.models.train) from the committed
           checkpoint on the training fixture's 3 pages
           (fixtures/train_pages.npz): each curriculum stage's fixed run
           (Adam(lr), train pages 0 and 1, test the validation page),
           twice, in 'highest', each held against the JAX numbers stored
           in the fixture (the same crops, lines and steps; each model's
           first step within FIRST_STEP_RTOL, every later loss and
           parameter update norm within TRAIN_RTOL), with the spread
           between the two runs, ms per train and test step (median),
           steps per page, host syncs per step (sync debug mode) and one
           profiler window of a TRAIN_CHAR page; then train_model over
           the 5 stages, 1 epoch each, writing build/train/: finite
           losses, the committed checkpoint's 18 entries and shapes; a
           train_model stage whose first page carries a NaN must roll
           back; and the serving default on the written checkpoint
           (well-formed text, similarity to the committed checkpoint's
           printed).  Training launches neither kernel (its count must
           stay 0)
  nn_batteries
           the NN script batteries on the card: test_identity (each layer
           on the card against the CPU, forward and input gradient within
           1e-5, TF32 off) and test_gradients (float64), every check
           passing; one curriculum page of TRAIN_ALL through the Trainer
           with ProgressSnapshots.panels as save_pictures_func, on the
           card and on the CPU at lr 0: the same file names, every panel
           uint8 of the CPU run's shape; the same page on the card at lr
           1e-3: a weight moved and every stage's panels of both phases
           are there, uint8; train_model(save_train_progress=True)
           with Pillow unimportable must raise, naming it, before a page
           is read; and `start` of test_identity with use_gpu through the
           web app's /test-nn-ws must stream the pass counter and the
           subprocess's exit 0
  batched_train_path
           the batched predicted-crop trainer (models/dp_train.py) and the
           eval gate (models/evaluation.py): each batched stage on the
           training fixture's pages from the committed checkpoint (2
           train pages, the validation page, batch 16, seed 0, 1 epoch;
           Line and Char on predicted crops in 'highest' and 'bf16')
           held against the JAX numbers in fixtures/train_batched.npz
           (the same sample counts and shapes, the first step within
           BATCHED_FIRST_RTOL, the rest within BATCHED_LATER_RTOL), with
           the seconds to build its samples, ms per train step and per
           eval batch (median over the stage, and in steady state: its
           first batch repeated STEADY_REPS times after a warm-up),
           train samples/s and its peak device memory; then
           train_model(batched=True, predicted=True,
           eval_gate=True) over the curriculum at 1 epoch, writing
           build/batched/ (launch counts from 0 just before it; both
           kernels must launch: the predicted samples' front and the gate's
           serving pipeline), its seconds and each gate score's; then
           the gate alone: the committed checkpoint's score of the
           fixtures/eval_pages.npz corpus within GATE_SCORE_TOL of the
           host cascade's,
           a random-weight Char model rejected with its checkpoint's
           bytes unchanged, the committed weights approved; and both
           kernels against their plain versions at this path's shapes
  mesh_path
           the mesh (univer_ocr_tpu_torch.parallel): every card when
           torch.cuda.device_count() is 2 or more, else MESH_SHARDS
           logical 'data' shards on the one card (printed, with the
           count).  The host cascade and the serving default (the fused
           tail, host-planned under a mesh) over it on the chunk of 8
           pages, with the launch counts from 0 just before each: every
           page's text equal to the unsharded pipeline's in this call
           and held against the fixture's text as in the earlier phases; both
           kernels launched on every card of the mesh at per-shard
           shapes (the Monochrome block at CHUNK / shards pages, the
           Char head at DEVICE_BATCH / shards lines on the host cascade
           and at the 64-line pool of each shard's fused tail), each
           shape then held to its plain version on each card; the DP
           (Monochrome), TP (Char on a 4 x 2 mesh) and batched mesh steps
           (Line, Char) against the unsharded steps in 'highest' (losses
           and the whole summed gradient, 2-norm, within MESH_STEP_RTOL;
           mesh_steps), with ms per step; pages/s of
           both sharded pipelines beside the unsharded ones, and the
           sharded fused chunk's peak device memory
  times    CUDA-event times of each kernel and its plain version at the
           paths' shapes (the Char head at every width each path
           launched) beside their bounds; the JAX device cascade's Char
           head, the width-8 convolution form, beside fused_char_head at
           the device path's line-stage shape (64 lines, 32 rows, W), the
           measurement behind the port's choice of the kernel there, and
           at the fused tail's shape (64, 32, 2048); the flat run-length
           decode (fused_tail.decode_ids_device) at (64, 2048) columns;
           pages/s of the host cascade, of both device modes and of the
           serving default in 'highest' and 'bf16' (printed, not gated),
           with each run's
           stage timers (OCRPipeline.timers) per chunk and its host syncs
           per chunk; the 'bf16' text held against the 'highest' host
           cascade text at JAX's own bar
           (similarity > 0.9, tests/test_pipeline.py); and one
           torch.profiler window over a chunk of each: the device's busy
           share of the window and its top kernels by device time; and
           for both device modes, every sync of one chunk as torch's
           sync debug mode reports it, by line and per paragraph launch;
           and the single-page latency: the median of 10 calls of
           `ocr_pages([page])` through the chain beside the tables mode
           at chunk 1 (`fused_tail=False`), in 'highest' and 'bf16'

Bounds: the larger of the bytes (each input read once, each output
written once) over the HBM rate and the work over the peak rate of the
units the path's precision allows.  The Char head runs in 3xTF32 on the
tensor cores, so its `bound_ms` is three TF32 products at 495 TFLOP/s;
`bound_ffma_ms` beside it is the same work in FP32 FFMA at 67 TFLOP/s
(the bound of the FFMA kernel it replaced).  The Monochrome block has no
tensor-core shape: both its bounds are FFMA.

The fused path (the serving default) is this slice's main path: each
kernel's `launches` in the last JSON lines is its count on that path's
run, and the Char head's times there are means per launch over that
run's width mix (`WIDTH_LAUNCHES`), with each width's own numbers beside
them.  `launches_by_path` gives each path's count (each path's run
starts with the counts at 0; `serve_path` counts the web app's
requests, `groundtruth_eval` the accuracy entry's timed run,
`groundtruth_gt_crops_highest` and `_bf16` the ground-truth crops,
`mesh_host` and `mesh_fused` the sharded pipelines' runs),
and the Char head's `host_path`,
`device_path` and `tables_path` entries its times over those paths'
mixes.  Plain versions run with TF32 off (full float32).

Any failure ends the run with a traceback and a non-zero exit before the
last line, which on success is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

import contextlib
import difflib
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
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
#: host cascade's text the fixture stores (float sums in another order can
#: flip a pixel that sits on a threshold; exact equality is reported beside
#: it)
TEXT_SIMILARITY = 0.99
#: similarity of the whole 'bf16' text to the 'highest' text: the JAX
#: package's own bar (tests/test_pipeline.py,
#: test_device_cascade_bf16_close_to_f32)
BF16_SIMILARITY = 0.9
#: the device cascade's parity mode
DEVICE_CASCADE = dict(device_cascade=True, exact_bands=True)
#: its tables mode, without the fused tail
TABLES_MODE = dict(device_cascade=True, exact_bands=False, fused_tail=False)
#: the serving default: tables mode, fused tail, device planners
FUSED_MODE = dict(device_cascade=True)
#: timed runs of each pipeline, after one warm-up run
REPS = 3
#: single-page calls whose median is the latency
LATENCY_CALLS = 10
#: the benchmark's pool pages and plain reference (reference_path)
BENCH_PAGES = ROOT / 'benchmark' / 'data' / 'pages.npz'
BENCH_REFERENCE = ROOT / 'benchmark' / 'reference' / 'cascade.py'
#: pool pages reference_path reads
REFERENCE_PAGES = 8
#: characters apart over reference characters that reference_path
#: admits: the benchmark's own limit on the serving default
REFERENCE_CER = 0.07
#: the warning torch's sync debug mode gives for each sync
#: (c10/cuda/CUDAFunctions.cpp, warn_or_error_on_sync)
SYNC_WARNING = 'called a synchronizing CUDA operation'
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
#: the training pages and the JAX package's numbers for their fixed run
#: (tests/test_torch_train_fixture.py)
TRAIN_FIXTURE = ROOT / 'univer_ocr_tpu_torch' / 'fixtures' / 'train_pages.npz'
#: each model's first step of a stage against JAX's, relative: the same
#: weights, a forward only
FIRST_STEP_RTOL = 1e-5
#: each model's later losses and parameter update norms against JAX's:
#: (loss rtol, loss atol, norm rtol), a loss passing within
#: rtol * |JAX's| + atol.  Adam's first updates are close to
#: lr * sqrt(1000) * sign(g), so an element whose gradient sums to about
#: 0 takes a full step in a direction set by the sum order; the Char
#: model, whose dense layers hold most such elements and whose lines
#: reach losses of 258, then follows another trajectory step by step,
#: as two card runs can (the bars are measured on an H100; PERF.md §6)
TRAIN_RTOL = {'Monochrome': (1e-4, 0.0, 1e-3), 'Paragraph': (1e-4, 0.0, 1e-3),
              'Line': (1e-4, 0.0, 1e-3), 'Char': (0.5, 0.5, 0.2)}
#: the batched trainer's JAX numbers on the training fixture's pages
#: (tests/test_torch_batched_fixture.py)
BATCHED_FIXTURE = (ROOT / 'univer_ocr_tpu_torch' / 'fixtures'
                   / 'train_batched.npz')
#: a batched stage against JAX's numbers, relative: its first train
#: step's per-sample losses (a forward of the same weights), the initial
#: validation sweep (whole-page float32 Dice sums in another order), and
#: per model the later steps, the validation after the epoch and the
#: update norms (measured on an H100: at most 2.3e-5 for Monochrome,
#: Paragraph and Line, 1.1e-3 for Char, whose Adam steps are sign-like;
#: PERF.md §6).  Samples predicted in 'bf16' are held to JAX's counts
#: only: the card's front runs Monochrome in float32 (the kernel), JAX's
#: CPU reference in bfloat16, so a crop may come out a pixel wider
BATCHED_FIRST_RTOL = 1e-5
BATCHED_INITIAL_VAL_RTOL = 5e-5
BATCHED_LATER_RTOL = {'Monochrome': 1e-3, 'Paragraph': 1e-3, 'Line': 1e-3,
                      'Char': 2e-2}
#: the eval gate's score of the committed checkpoint through the serving
#: default against the host cascade's (absolute)
GATE_SCORE_TOL = 0.01
#: steady-state repetitions of a batched stage's first batch
STEADY_REPS = 5
#: the dashboard's progress_tracker types a training run must deliver
#: (tests/test_web_dashboard.py)
DASHBOARD_TYPES = {'reset', 'generating_data', 'training', 'validating',
                   'epoch', 'train_iteration', 'val_iteration',
                   'forward_backward'}
#: sequential /ocr requests timed at the serving page
SERVE_REPS = 8
#: the eval corpus with all 17 layers, JAX's interpret of each page and
#: JAX's ground-truth-crop texts (tests/test_torch_groundtruth_fixture.py)
EVAL_LAYERS = ROOT / 'univer_ocr_tpu_torch' / 'fixtures' / 'eval_layers.npz'
#: each page's ground-truth-crop text against JAX's, per precision: at
#: least this similarity in 'highest', above it in 'bf16'
GT_CROP_SIMILARITY = {'highest': 0.99, 'bf16': 0.9}
#: items the feed's queue holds in groundtruth_path
FEED_QUEUE = 4
#: seconds DataGenerator.stop() may take to end its processes
FEED_STOP_S = 5.0
#: logical 'data' shards of mesh_path's mesh on a machine with one card
MESH_SHARDS = 4
#: host_native: timed calls of each labeller on each mask
NATIVE_REPS = 5
#: a mesh training step's losses and gradients against the unsharded
#: step's ('highest'; mesh_steps), read from an SGD step at this lr: a
#: power of two far above the weights, so that the update scales the
#: gradient exactly and rounds at its own ulp, not the weight's
MESH_STEP_RTOL = 1e-5
SGD_LR = 2.0 ** 20


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


def check_text(label, results, expected, n_pages=CHUNK):
    """Each page's text against the expected text (the fixture's host
    cascade text) at TEXT_SIMILARITY."""
    if len(results) != n_pages:
        raise AssertionError(f'{label}: {len(results)} results for '
                             f'{n_pages}')
    exact = 0
    for i, page in enumerate(results):
        want = expected[i % len(expected)]
        ratio = difflib.SequenceMatcher(
            None, page_text(want), page_text(page), autojunk=False).ratio()
        exact += page == want
        print(f'  page {i}: {sum(len(p) for p in page)} lines, '
              f'similarity to the expected text {ratio:.6f}, '
              f'exact {page == want}', flush=True)
        if ratio < TEXT_SIMILARITY:
            raise AssertionError(f'{label} page {i}: text similarity '
                                 f'{ratio} < {TEXT_SIMILARITY}')
    print(f'{label}: {exact}/{n_pages} pages equal the expected text '
          f'exactly', flush=True)


def blob_grid(rows, cols, pitch=(44, 52)):
    """A white page with a grid of separated ink blobs, each detected as
    a paragraph (tests/test_single_page_chain.py's over-capacity page)."""
    page = np.ones(PAGE_SHAPE, np.float32)
    for gy in range(rows):
        for gx in range(cols):
            y, x = 8 + gy * pitch[0], 12 + gx * pitch[1]
            page[0, y:y + 10, x:x + 24, 0] = 0.0
    return page


def run_pages(pipeline, pages, single=False):
    """ocr_pages on the pages at once, or on each alone (single=True: the
    single-page chain of the serving default)."""
    if single:
        return [r for page in pages for r in pipeline.ocr_pages([page])]
    return pipeline.ocr_pages(pages)


def counted_run(pipeline, pages, single=False):
    """One run (run_pages) with every launch count set to 0 just before
    it; returns (results, launches by kernel, fused_char_head launches by
    W)."""
    from univer_ocr_tpu_torch.ops.kernels import LAUNCHES, char_head
    LAUNCHES.clear()
    char_head.WIDTH_LAUNCHES.clear()
    results = run_pages(pipeline, pages, single)
    torch.cuda.synchronize()
    return (results, dict(LAUNCHES),
            dict(sorted(char_head.WIDTH_LAUNCHES.items())))


def syncs_per_chunk(counts, chunks):
    """Host syncs per chunk of a device mode, from OCRPipeline.host_syncs
    (every blocking pull, by tag)."""
    return sum(counts.values()) / chunks if chunks else None


def timed_runs(pipeline, pages, label, expected):
    """pages/s over REPS runs after a warm one, with the stage timers on
    for the timed runs.  The warm run's text is held against `expected`,
    the host cascade's 'highest' text: per page in 'highest', as a whole
    at BF16_SIMILARITY in 'bf16'."""
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
        print(f'  {label}: similarity to the highest host text per page '
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
              f'{syncs_per_chunk(syncs, REPS):.3f} per chunk', flush=True)
    stages = {name: round(1e3 * total / REPS, 3)
              for name, total in sorted(pipeline.timers.totals.items())}
    pipeline.timers = None
    print(f'  {label}: {chunk_s * 1e3:.1f} ms per chunk of {CHUNK} pages, '
          f'{CHUNK / chunk_s:.2f} pages/s', flush=True)
    print(f'  {label} stage timers, ms per chunk (summed over threads): '
          f'{json.dumps(stages)}', flush=True)
    return CHUNK / chunk_s, stages


def sync_census(pipeline, pages, label, single=False):
    """Every sync one run (run_pages) makes, as torch's sync debug mode
    reports it (a copy from pageable host memory, a read of a device
    value, ...), counted by the line that made it and per paragraph
    launch (the calls of pipeline.paragraph_launch), beside what
    pipeline.host_syncs counted in the same run."""
    import threading
    import traceback
    import warnings
    from univer_ocr_tpu_torch.utils.profiling import StageTimers
    pipeline.timers = StageTimers()
    pipeline.timeline.clear()
    pipeline.host_syncs.clear()
    calls = Counter()
    launch = pipeline.paragraph_launch

    def counted_launch(*args):
        with lock:
            calls['paragraph_launch'] += 1
        return launch(*args)
    pipeline.paragraph_launch = counted_launch
    where = Counter()
    lock = threading.Lock()
    package = str(ROOT / 'univer_ocr_tpu_torch')

    notices = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        """A sync warning, keyed by its line and, where that line is in
        torch, by the port's innermost line on the emitting thread; with
        no line of the port on that thread, by its callers, as outside
        the port (counted all the same).  torch's notice, when the debug
        mode is first set, that the mode is a prototype is not a sync and
        is listed apart."""
        if 'synchroniz' not in str(message):
            return
        if SYNC_WARNING not in str(message):
            with lock:
                notices[str(message)] += 1
            return
        key = f'{Path(filename).name}:{lineno}'
        if not filename.startswith(package):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if not f.filename.endswith('warnings.py')]
            ours = [f for f in stack if f.filename.startswith(package)]
            via = ours[-1:] or stack[-4:-1]
            key = ' < '.join(f'{Path(f.filename).name}:{f.lineno}'
                             for f in via[::-1]) + f' via {key}'
            if not ours:
                key = f'outside the port: {key}'
        with lock:
            where[key] += 1

    with warnings.catch_warnings():
        warnings.simplefilter('always')
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode('warn')
        try:
            run_pages(pipeline, pages, single)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            del pipeline.paragraph_launch
    torch.cuda.synchronize()
    launches = calls['paragraph_launch']
    pipeline.timers = None
    total = sum(where.values())
    print(f'  {label} syncs over one run (torch sync debug mode): {total} '
          f'in {launches} paragraph launches, '
          f'{total / max(launches, 1):.3f} per launch; host_syncs '
          f'{dict(pipeline.host_syncs)}; by line '
          f'{json.dumps(dict(sorted(where.items(), key=lambda kv: -kv[1])))}'
          f'; notices that are not syncs {json.dumps(dict(notices))}',
          flush=True)
    return total, launches


def device_activities(prof):
    """[(device us, count, name)] of a profiler's CUDA activities."""
    from torch.autograd import DeviceType

    def device_us(event):
        for key in ('self_device_time_total', 'self_cuda_time_total'):
            if hasattr(event, key):
                return getattr(event, key)
        return 0.0

    return [(device_us(e), e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0]


def profile_window(pipeline, pages, label):
    """One torch.profiler window over one chunk (profile_call)."""
    return profile_call(lambda: pipeline.ocr_pages(pages), label)


def decode_timing(rng):
    """The flat run-length decode (fused_tail.decode_ids_device) on the
    card at the fused tail's (64 lines, 2048 columns), on run-structured
    ids (glyph runs of 1-14 columns, tab runs, ragged valid widths):
    CUDA-event ms per call, the device time per call summed over its
    activities (torch.profiler), and its bound (bytes: the ids and
    validity read once, the glyphs written once)."""
    from univer_ocr_tpu_torch.models import fused_tail
    n, w = DEVICE_LINES, fused_tail.CHAR_POOL_WIDTH
    ids = np.stack([np.repeat(rng.integers(0, 162, w),
                              rng.integers(1, 15, w))[:w] for _ in range(n)])
    valid = np.arange(w)[None, :] < rng.integers(w // 4, w, (n, 1))
    ids_t = torch.tensor(ids, device='cuda')
    valid_t = torch.tensor(valid, device='cuda')
    def decode():
        return fused_tail.decode_ids_device(ids_t, valid_t, 4)

    # CUDA events over back-to-back calls read the host's dispatch of its
    # ~40 small ops as much as the device; the profiler reads the device
    t = {'shape': [n, w + 1], 'ms': cuda_ms(decode)}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            decode()
        torch.cuda.synchronize()
    acts = device_activities(prof)
    t['device_ms'] = sum(us for us, _, _ in acts) / 20 / 1e3
    t['device_activities'] = sum(c for _, c, _ in acts) / 20
    n_bytes = ids_t.numel() * 8 + valid_t.numel() + n * (
        4 * fused_tail.MAX_GLYPHS + 5)
    t['bound_ms'], t['bound_by'] = bound_ms(n_bytes, 0)
    print(f'  flat decode {json.dumps(t)}', flush=True)
    return t


def single_page_latency(pipeline, pages, label):
    """Median host ms of LATENCY_CALLS one-page calls (cycling through the
    pages), after one warm call per page."""
    for page in pages:
        pipeline.ocr_pages([page])
    times = []
    for i in range(LATENCY_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.ocr_pages([pages[i % len(pages)]])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    median = float(np.median(times))
    print(f'  {label}: single-page latency median {median:.2f} ms over '
          f'{LATENCY_CALLS} calls (min {min(times):.2f}, max '
          f'{max(times):.2f})', flush=True)
    return median


def compare_plans(pipeline, pages):
    """The device paragraph planners on the card against the same
    planners on the CPU, on the paragraph masks the card's front gives
    the pages: the chunk planner over all of them, the chain's planner
    on each.  Labels, counts and every plan field must be equal; a
    difference is printed by planner, page and field.  Returns the chunk
    planner's component count per page."""
    from univer_ocr_tpu_torch.models.device_cascade import (
        PARAGRAPH_FIELDS, device_chunk_plans, device_page_plans)
    _, para = pipeline.front_resident(pipeline._upload_pages(pages))
    masks = para[..., 0]
    menu = tuple(pipeline.line_shape_menu)
    K = pipeline.CHUNK_PLAN_K
    hb, wb = menu[-1]
    runs = {'chunk': [device_chunk_plans(m, menu, k_max=K)
                      for m in (masks, masks.cpu())]}
    for i in range(len(pages)):
        runs[f'page {i}'] = [
            device_page_plans(m[i], hb, wb, k_max=2 * pipeline.DEVICE_BATCH)
            for m in (masks, masks.cpu())]
    differ = []
    for name, (card, cpu) in runs.items():
        if name == 'chunk':
            lab, plans, _, n_comp = card
            lab_c, plans_c, _, n_comp_c = cpu
        else:
            lab, plans, n_comp, _ = card
            lab_c, plans_c, n_comp_c, _ = cpu
            plans, plans_c = plans[None], plans_c[None]
            n_comp, n_comp_c = n_comp[None], n_comp_c[None]
        if not torch.equal(lab.cpu(), lab_c):
            raise AssertionError(f'planner {name}: labels differ on the '
                                 f'card')
        if not torch.equal(n_comp.cpu(), n_comp_c):
            raise AssertionError(f'planner {name}: component counts differ')
        plans = plans.cpu()
        for page in range(plans.shape[0]):
            live = slice(0, int(n_comp_c[page]))
            for ci, field in enumerate(PARAGRAPH_FIELDS):
                a, b = plans[page, live, ci], plans_c[page, live, ci]
                if not torch.equal(a, b):
                    print(f'  planner {name} page {page} field {field}: '
                          f'card {a.tolist()} cpu {b.tolist()}', flush=True)
                    differ.append((name, page, field))
        print(f'  planner {name}: components {n_comp_c.tolist()}',
              flush=True)
    print(f'  planners, card against CPU: fields '
          f'{"equal" if not differ else differ}', flush=True)
    if differ:
        raise AssertionError(f'plan fields differ: {differ}')
    return runs['chunk'][1][3].tolist()


def host_gate_score(weights, n_pages=8):
    """The eval gate's score (evaluation.score_weights: collapse 4,
    'bf16') of `weights` on the eval corpus's first n_pages, through the
    host cascade on the card: the serving default computes its crops and
    line plans, so its score is the bar the serving default's is held
    to."""
    from univer_ocr_tpu_torch.models.evaluation import (eval_corpus,
                                                        score_weights)
    return score_weights(weights, *eval_corpus(n_pages), collapse=4,
                         chunk=CHUNK, device_cascade=False,
                         device='cuda')['concat']


def band_ccl_check(rng):
    """The band_ccl kernel against its plain version at the paths' shapes
    (both band channels of a launch of DEVICE_BATCH paragraphs and of 4
    at each menu bucket, a chunk of 32 paragraph masks) and ragged ones,
    on random masks and on stripes like text bands; ms per launch
    (CUDA events).  Returns {shape: ms}."""
    from univer_ocr_tpu_torch.models.bucketing import line_shape_menu
    from univer_ocr_tpu_torch.ops.kernels.band_ccl import (
        band_ccl, band_ccl_reference)
    shapes = [(2 * n, hb, wb) for hb, wb in line_shape_menu(PAGE_SHAPE)
              for n in (16, 4)] + [(32,) + PAGE_SHAPE[1:3], (3, 37, 91),
                                   (40, 64, 64)]
    times = {}
    for k, (N, H, W) in enumerate(shapes):
        masks = rng.random((N, H, W)) > rng.uniform(0.3, 0.7)
        if k % 2 == 0:
            masks[:] = False
            for y in range(5, H - 10, 17):
                masks[:, y:y + 6, 3:W - 5] = True
            masks &= rng.random((N, H, W)) > 0.08
        hv = torch.tensor(rng.integers(H // 2, H + 1, N))
        wv = torch.tensor(rng.integers(W // 2, W + 1, N))
        m = torch.tensor(masks)
        args = (m.cuda(), hv.cuda(), wv.cuda())
        for cap in (48, 256):
            want = band_ccl_reference(m, hv, wv, cap, labels=True)
            got = band_ccl(*args, cap, labels=True)
            for name, g, w in zip(('stats', 'counts', 'labels'), got, want):
                if not torch.equal(g.cpu(), w):
                    raise AssertionError(f'band_ccl {(N, H, W)} cap {cap}: '
                                         f'{name} differ from the plain '
                                         f'version')
        times[str((N, H, W))] = cuda_ms(lambda: band_ccl(*args, 48))
        print(f'  band_ccl {(N, H, W)}: equal to the plain version, '
              f'{times[str((N, H, W))]:.4f} ms a launch', flush=True)
    return times


def reference_path(pipeline_factory):
    """The serving default in 'bf16' on REFERENCE_PAGES pool pages of the
    benchmark, each page alone (the single-page chain) and all in one
    call (the chunk path), against the benchmark's plain reference on
    the card: lines and characters apart over the reference's
    characters, within REFERENCE_CER."""
    import importlib.util
    spec = importlib.util.spec_from_file_location('bench_cascade',
                                                  BENCH_REFERENCE)
    cascade = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cascade)
    with np.load(BENCH_PAGES) as f:
        pool = f['pages'][:REFERENCE_PAGES]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = cascade.Reference(cascade.load_weights(
        ROOT / 'univer_ocr_tpu' / 'models' / 'model_weights.json', 'cuda'),
        'cuda')
    want = [ref.read_page(page, 4)[0] for page in pool]
    ref_chars = sum(len(page_text(page)) for page in want)
    ref_lines = sum(len(para) for page in want for para in page)
    pages = [page[None, :, :, None] for page in pool]
    out = {}
    with pipeline_factory() as fused:
        for label, got in (
                ('chain', [fused.ocr_pages([p])[0] for p in pages]),
                ('chunk', fused.ocr_pages(pages))):
            edits = sum(levenshtein(page_text(g), page_text(w))
                        for g, w in zip(got, want))
            lines = sum(len(para) for page in got for para in page)
            out[label] = {'cer': edits / ref_chars, 'lines': lines,
                          'reference_lines': ref_lines}
            print(f'  reference_path {label}: {lines} lines (reference '
                  f'{ref_lines}), cer {edits / ref_chars:.6f}', flush=True)
            if edits / ref_chars > REFERENCE_CER:
                raise AssertionError(f'reference_path {label}: {out}')
    return out


def levenshtein(a, b):
    """Edit distance (insert, delete, substitute; one each), a row of
    the table at a time (benchmark/check.py's)."""
    if not a or not b:
        return max(len(a), len(b))
    bb = np.frombuffer(b.encode('utf-32-le'), np.uint32)
    j = np.arange(len(bb) + 1)
    prev = j.copy()
    tmp = np.empty_like(prev)
    for i, ch in enumerate(a, 1):
        tmp[0] = i
        np.minimum(prev[1:] + 1, prev[:-1] + (bb != ord(ch)), out=tmp[1:])
        prev = np.minimum.accumulate(tmp - j) + j
    return int(prev[-1])


class NanOnce:
    """A dataset whose first page read for a step carries a NaN pixel (the
    trainer must roll the NaN weights back).  train_model reads page 0's
    image once for its input shape before any step: that read is left
    clean."""

    def __init__(self, dataset):
        self.dataset, self.reads = dataset, 0

    def __len__(self):
        return len(self.dataset)

    def get(self, idx, layer_tags=None):
        page = self.dataset.get(idx, layer_tags)
        self.reads += 1
        if self.reads == 2:
            page['image'] = page['image'].copy()
            page['image'][0, 40, 40, 0] = np.nan
        return page


def record_steps(system, log, page, sync):
    """Wrap each model component's step once: every step's losses go to
    `log` with the page in `page[0]` and its host ms (ending in `sync()`),
    one step per crop or line in the masked components (the wrapper of
    tests/test_torch_train_fixture.py, timed)."""
    def note(name, phase, losses, t0):
        sync()
        log.append({'page': page[0], 'phase': phase, 'model': name,
                    'output_losses': [float(v) for v in
                                      losses['output_losses']],
                    'regularization_loss': (
                        float(losses['regularization_loss'])
                        if 'regularization_loss' in losses else None),
                    'ms': (time.perf_counter() - t0) * 1e3})

    for component in system.components:
        if not hasattr(component, 'model'):
            continue
        name = component.name
        if hasattr(component, '_run'):
            def run(X, y, training, run=component._run, name=name):
                t0 = time.perf_counter()
                losses, pred = run(X, y, training)
                note(name, 'train' if training else 'test', losses, t0)
                return losses, pred
            component._run = run
        else:
            model = component.model
            for phase in ('train', 'test'):
                def step(X, y, step=getattr(model, phase), phase=phase,
                         name=name):
                    t0 = time.perf_counter()
                    losses = step(X, y)
                    note(name, phase, losses, t0)
                    return losses
                setattr(model, phase, step)


def fixed_stage(mode_name, lr, pages, weights, device, sync, census=None):
    """One stage of the training fixture's fixed run on the port:
    Adam(lr), train on pages 0 and 1, test on page 2, from `weights`.
    Returns its steps (losses, host ms), crops and lines per page, each
    page's host ms, and each parameter's update norm.  `census(fn)`, when
    given, runs the first train page under a sync count."""
    from univer_ocr_tpu_torch.models.model import (Modes,
                                                   make_context_maker,
                                                   make_model_system)
    from univer_ocr_tpu_torch.nn.optimizers import Adam
    from univer_ocr_tpu_torch.nn.progress_tracker import ProgressTracker
    mode = Modes[mode_name]
    tracker = ProgressTracker(handler=lambda *args: None)
    system, models, _ = make_model_system(
        PAGE_SHAPE, Adam(lr=lr), tracker, weights, mode=mode, device=device)
    before = {name: {layer: {k: v.detach().clone() for k, v in p.items()}
                     for layer, p in model.params.items()}
              for name, model in models.items()}
    make_context = make_context_maker(mode, device)
    steps, crops, lines, page_ms, page = [], [], [], [], [0]
    syncs = None
    record_steps(system, steps, page, sync)
    for page[0], phase in ((0, 'train'), (1, 'train'), (2, 'test')):
        sync()
        t0 = time.perf_counter()
        context = make_context(pages.get, (page[0],))
        run = getattr(system, phase)
        if census is not None and page[0] == 0:
            syncs = census(lambda: run(context))
        else:
            run(context)
        sync()
        page_ms.append((time.perf_counter() - t0) * 1e3)
        crops.append(len(context.get('cropped_monochrome_cpu', [])))
        lines.append(sum(len(p) for p in context.get(
            'cropped_2_monochrome_cpu', [])))
    norms = {name: {f'{layer}/{k}': float(torch.linalg.vector_norm(
                        v.double() - before[name][layer][k].double()))
                    for layer, p in model.params.items()
                    for k, v in p.items()}
             for name, model in models.items()}
    crop_ms = {layer: sum(e['time'].total_seconds() for e in events
                          if e['time'] is not None) * 1e3
               for layer, events in tracker.get_summary().items()
               if layer in ('ParagraphCrop', 'LineCrop', 'CharLabel')}
    return {'steps': steps, 'crops': crops, 'lines': lines,
            'page_ms': page_ms, 'update_norms': norms, 'syncs': syncs,
            'crop_ms': crop_ms}


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-12)


def compare_stage(stage, got, ref):
    """The port's fixed run of a stage against the JAX numbers: the same
    crops, lines and steps; each model's first step within
    FIRST_STEP_RTOL; its later losses and its update norms within
    TRAIN_RTOL.  Returns {model: (first, later, norms)}, the largest
    relative differences."""
    if (got['crops'], got['lines']) != (ref['crops'], ref['lines']):
        raise AssertionError(f'{stage}: crops {got["crops"]} lines '
                             f'{got["lines"]}, JAX {ref["crops"]} '
                             f'{ref["lines"]}')
    keys = [(s['page'], s['phase'], s['model']) for s in ref['steps']]
    if [(s['page'], s['phase'], s['model']) for s in got['steps']] != keys:
        raise AssertionError(f'{stage}: the steps differ from JAX\'s')
    first = {m: [0.0] for m in ref['update_norms']}
    later = {m: [0.0] for m in ref['update_norms']}
    seen = set()
    for g, r in zip(got['steps'], ref['steps']):
        m = r['model']
        pairs = list(zip(g['output_losses'], r['output_losses']))
        if r['regularization_loss'] is not None:
            pairs.append((g['regularization_loss'],
                          r['regularization_loss']))
        if m not in seen:
            first[m].extend(float(_rel(a, b)) for a, b in pairs)
            seen.add(m)
            continue
        rtol, atol, _ = TRAIN_RTOL[m]
        for a, b in pairs:
            if abs(a - b) > rtol * abs(b) + atol:
                raise AssertionError(f'{stage} {m}: loss {a} off JAX\'s '
                                     f'{b} (> {rtol} * |{b}| + {atol})')
            later[m].append(float(_rel(a, b)))
    out = {}
    for m in ref['update_norms']:
        norms = [float(_rel(got['update_norms'][m][k], v))
                 for k, v in ref['update_norms'][m].items()]
        out[m] = (max(first[m]), max(later[m]), max(norms))
    print(f'  {stage}: steps {len(keys)}, crops {got["crops"]}, lines '
          f'{got["lines"]}; against JAX, relative (first step, later '
          f'losses, update norms): '
          f'{ {m: [f"{v:.3e}" for v in e] for m, e in out.items()} }',
          flush=True)
    for m, (first_err, _, norms) in out.items():
        if first_err > FIRST_STEP_RTOL:
            raise AssertionError(f'{stage} {m}: first-step losses '
                                 f'{first_err} off JAX\'s (> '
                                 f'{FIRST_STEP_RTOL})')
        if norms > TRAIN_RTOL[m][2]:
            raise AssertionError(f'{stage} {m}: update norms {norms} off '
                                 f'JAX\'s (> {TRAIN_RTOL[m][2]})')
    return out


def spread(run_a, run_b):
    """Largest relative difference between two runs of the same stage."""
    losses = max(float(_rel(a['output_losses'], b['output_losses']).max())
                 for a, b in zip(run_a['steps'], run_b['steps']))
    norms = max(float(_rel(run_a['update_norms'][m][k], v))
                for m, d in run_b['update_norms'].items()
                for k, v in d.items())
    return losses, norms


def count_syncs(fn):
    """(fn's result, the syncs torch's sync debug mode reports while it
    runs)."""
    import warnings
    count = [0]

    def record(message, *args, **kwargs):
        if SYNC_WARNING in str(message):
            count[0] += 1

    with warnings.catch_warnings():
        warnings.simplefilter('always')
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return count[0]


def stage_times(stage, run):
    """ms per train and per test step (host clock ending in a
    synchronize, median over the steps) and steps per page."""
    out = {}
    for phase in ('train', 'test'):
        ms = [s['ms'] for s in run['steps'] if s['phase'] == phase]
        out[f'{phase}_step_ms'] = float(np.median(ms))
        out[f'{phase}_steps'] = len(ms)
    out['steps_per_page'] = len(run['steps']) / 3
    out['page_ms'] = [round(t, 3) for t in run['page_ms']]
    # a page's time by layer, over the 3 pages: the model steps, the
    # crop pools, and the rest (the context's encoding and staging)
    out['steps_ms'] = sum(s['ms'] for s in run['steps'])
    out['crop_ms'] = {k: round(v, 3) for k, v in run['crop_ms'].items()}
    out['other_ms'] = (sum(run['page_ms']) - out['steps_ms']
                       - sum(run['crop_ms'].values()))
    out['train_pages_per_s'] = 2e3 / sum(run['page_ms'][:2])
    if run['syncs'] is not None:
        n = sum(1 for s in run['steps'] if s['page'] == 0)
        out['syncs_page0'] = run['syncs']
        out['syncs_per_step'] = run['syncs'] / n
    print(f'  {stage} times: {json.dumps(out)}', flush=True)
    return out


def profile_call(fn, label):
    """One torch.profiler window over fn(): the device's busy share of the
    window (device time of every CUDA activity over the window's host
    time) and its top kernels by device time."""
    from univer_ocr_tpu_torch.utils.profiling import device_trace
    with device_trace(ROOT / 'build' / 'traces' / label) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_activities(prof)
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


def train_path(expected_fused, fixture_list):
    """Phase train_path: the training fixture's fixed run twice against
    JAX's numbers, train_model over the curriculum (1 epoch a stage, and
    once with a NaN injected), and the serving default on its
    checkpoint.  Returns the kernel launches of the training."""
    from univer_ocr_tpu_torch.models.constants import LAYER_NAMES_PLAIN
    from univer_ocr_tpu_torch.models.datasets import (ArrayDataset,
                                                      load_page_arrays)
    from univer_ocr_tpu_torch.models.model import (Modes, make_context_maker,
                                                   make_model_system)
    from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
    from univer_ocr_tpu_torch.models.train import CURRICULUM, train_model
    from univer_ocr_tpu_torch.nn.optimizers import Adam
    from univer_ocr_tpu_torch.ops.kernels import LAUNCHES
    from univer_ocr_tpu_torch.ops.precision import backend_flags
    from univer_ocr_tpu_torch.weights import (DEFAULT_CHECKPOINT,
                                              load_checkpoint)
    train, validation = load_page_arrays(TRAIN_FIXTURE)
    with np.load(TRAIN_FIXTURE) as f:
        pages = np.concatenate([f['train'], f['validation']])
        reference = json.loads(str(f['reference']))
    three = ArrayDataset(pages, LAYER_NAMES_PLAIN)
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    lrs = {mode.name: lr for mode, lr, _, _ in CURRICULUM}

    LAUNCHES.clear()
    runs = [{}, {}]
    with backend_flags('highest'):
        for i, run in enumerate(runs):
            for stage, ref in reference.items():
                run[stage] = fixed_stage(
                    stage, lrs[stage], three, weights, 'cuda',
                    torch.cuda.synchronize,
                    census=count_syncs if i == 1 else None)
                compare_stage(stage, run[stage], ref)
        for stage in reference:
            loss_spread, norm_spread = spread(runs[0][stage],
                                              runs[1][stage])
            print(f'  {stage}: spread between the two card runs, relative: '
                  f'losses {loss_spread:.3e}, update norms '
                  f'{norm_spread:.3e}', flush=True)
            stage_times(stage, runs[1][stage])

        # one profiler window over a TRAIN_CHAR train page
        system, _, _ = make_model_system(
            PAGE_SHAPE, Adam(lr=lrs['TRAIN_CHAR']), weights=weights,
            mode=Modes.TRAIN_CHAR, device='cuda')
        context = make_context_maker(Modes.TRAIN_CHAR, 'cuda')(
            three.get, (0,))
        system.train(context)                  # warm
        context = make_context_maker(Modes.TRAIN_CHAR, 'cuda')(
            three.get, (1,))
        profile_call(lambda: system.train(context), 'train_char')

    out_dir = ROOT / 'build' / 'train'
    curriculum = [(mode, lr, step, 1) for mode, lr, step, _ in CURRICULUM]
    t0 = time.perf_counter()
    results = train_model(train, validation, curriculum, train_size=2,
                          val_size=1, seed=0,
                          weights_out=out_dir / 'model_weights.json',
                          device='cuda')
    torch.cuda.synchronize()
    print(f'  train_model, 5 stages x 1 epoch: '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    for r in results:
        print(f'  {r["mode"]}: best '
              f'{ {k: list(map(float, v)) for k, v in r["best_losses"].items()} }'
              f', rollbacks {r["rollbacks"]}', flush=True)
        if r['rollbacks'] or not all(np.isfinite(v).all()
                                     for v in r['best_losses'].values()):
            raise AssertionError(f'train_model {r["mode"]}: {r}')
    with open(out_dir / 'model_weights.json') as fp:
        written = json.load(fp)
    from univer_ocr_tpu_torch.nn.checkpoint import write_weights
    t0 = time.perf_counter()
    write_weights(written, out_dir / 'rewritten.json')
    print(f'  checkpoint write (18 entries, JSON, atomic): '
          f'{(time.perf_counter() - t0) * 1e3:.1f} ms', flush=True)
    shapes = {k: {p: np.asarray(v).shape for p, v in d.items()}
              for k, d in written.items()}
    if shapes != {k: {p: np.asarray(v).shape for p, v in d.items()}
                  for k, d in weights.items()} or len(written) != 18:
        raise AssertionError(f'train_model wrote {shapes}')
    nan_run = train_model(NanOnce(train), validation, curriculum[:1],
                          train_size=2, val_size=1, seed=0,
                          weights_out=out_dir / 'nan_weights.json',
                          device='cuda')[0]
    print(f'  train_model with a NaN injected: rollbacks '
          f'{nan_run["rollbacks"]}, best {nan_run["best_losses"]}',
          flush=True)
    if nan_run['rollbacks'] < 1 or not np.isfinite(
            nan_run['best_losses']['Monochrome']).all():
        raise AssertionError('train_model did not roll the NaN back')
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f'train_path launches: {launches}', flush=True)

    # the serving default on the trained checkpoint: well-formed text
    with OCRPipeline(PAGE_SHAPE, weights=load_checkpoint(
            out_dir / 'model_weights.json', device='cuda'), chunk=CHUNK,
            workers=8, collapse_runs=4, precision='highest',
            device='cuda', **FUSED_MODE) as trained:
        results = trained.ocr_pages(
            [fixture_list[i % len(fixture_list)] for i in range(CHUNK)])
    if len(results) != CHUNK or not all(
            isinstance(line, str)
            for page in results for para in page for line in para):
        raise AssertionError('the trained checkpoint\'s text is not '
                             'well formed')
    for i, page in enumerate(results):
        ratio = difflib.SequenceMatcher(
            None, page_text(expected_fused[i % len(expected_fused)]),
            page_text(page), autojunk=False).ratio()
        print(f'  trained checkpoint, page {i}: {len(page)} paragraphs, '
              f'{sum(len(p) for p in page)} lines, similarity to the '
              f'committed checkpoint\'s host cascade text {ratio:.6f}',
              flush=True)
    return launches


@contextlib.contextmanager
def recorded_batched_steps(record):
    """Wrap dp_train's batched step factories: each train and eval step's
    per-sample losses and host ms (ending in a synchronize) go to
    `record`, and the last train step's parameters to record['params']."""
    from univer_ocr_tpu_torch.models import dp_train
    makers = {name: getattr(dp_train, name)
              for name in ('make_batched_seg_step', 'make_batched_char_step')}

    def recording(make):
        def wrapped(*args, **kwargs):
            train_step, eval_step = make(*args, **kwargs)

            def train_rec(*a):
                t0 = time.perf_counter()
                params, state, per = train_step(*a)
                torch.cuda.synchronize()
                record['train_ms'].append((time.perf_counter() - t0) * 1e3)
                record['train'].append(per.tolist())
                record['params'] = params
                return params, state, per

            def eval_rec(*a):
                t0 = time.perf_counter()
                per = eval_step(*a)
                torch.cuda.synchronize()
                record['eval_ms'].append((time.perf_counter() - t0) * 1e3)
                record['eval'].append(per.tolist())
                return per
            return train_rec, eval_rec
        return wrapped

    for name, make in makers.items():
        setattr(dp_train, name, recording(make))
    try:
        yield record
    finally:
        for name, make in makers.items():
            setattr(dp_train, name, make)


def batched_stage(stage, train, validation, weights, record):
    """One batched stage of the reference (tests/test_torch_batched_
    fixture.py) on the card: its samples from the committed checkpoint
    (predicted crops in the precision after the '/'), then
    train_stage_batched for 1 epoch, batch 16, seed 0, each step
    recorded.  Returns the steps, sweeps, update norms, counts, build
    seconds and the peak device memory."""
    from univer_ocr_tpu_torch.models import dp_train
    from univer_ocr_tpu_torch.models.model import Modes
    from univer_ocr_tpu_torch.models.train import CURRICULUM
    from univer_ocr_tpu_torch.ops.precision import backend_flags
    mode = Modes[stage.split('/')[0]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if '/' in stage:
        samples = [dp_train.collect_stage_samples_predicted(
            mode, ds, weights, precision=stage.split('/')[1], device='cuda',
            log=lambda *a: None) for ds in (train, validation)]
    else:
        samples = [dp_train.collect_stage_samples(mode, ds)
                   for ds in (train, validation)]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    record.update(train=[], eval=[], train_ms=[], eval_ms=[], params=None)
    lr, lr_step = next((lr, step) for m, lr, step, _ in CURRICULUM
                       if m is mode)
    t0 = time.perf_counter()
    model, _ = dp_train.train_stage_batched(
        mode, *samples, weights, epochs=1, lr=lr, lr_step=lr_step, batch=16,
        seed=0, log=lambda *a: None, device='cuda')
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    n_val = len(record['eval']) // 2
    out = {
        'model': dp_train._STAGE_MODEL[mode][0],
        'counts': [len(s) for s in samples],
        'shapes': [list(x.shape) for x, _ in samples[0]],
        'samples': samples,
        'train_steps': record['train'],
        'val_sweeps': [sum(record['eval'][:n_val], []),
                       sum(record['eval'][n_val:], [])],
        'update_norms': {
            f'{layer}/{key}': float(torch.linalg.vector_norm(
                value.double() - torch.tensor(weights[layer][key],
                                              dtype=torch.float64,
                                              device='cuda')))
            for layer, params in record['params'].items()
            for key, value in params.items()},
        'build_s': build_s, 'stage_s': stage_s,
        'train_ms': list(record['train_ms']),
        'eval_ms': list(record['eval_ms']),
        'peak_gib': torch.cuda.max_memory_allocated() / 2**30,
    }
    # steady state: the stage's first batch again, one warm-up, then
    # STEADY_REPS recorded train steps and eval batches
    record.update(train=[], eval=[], train_ms=[], eval_ms=[])
    if mode is Modes.TRAIN_CHAR:
        train_step, eval_step = dp_train.make_batched_char_step(model)
    else:
        train_step, eval_step = dp_train.make_batched_seg_step(model,
                                                               out['model'])
    args = dp_train._upload(dp_train.make_batches(samples[0], mode, 16)[0],
                            torch.device('cuda'))
    params = model.params
    state = model._optimizer().init_state(params)
    with backend_flags('highest'):
        for _ in range(STEADY_REPS + 1):
            train_step(params, state, lr, *args)
            eval_step(params, *args)
    out['steady_train_ms'] = float(np.median(record['train_ms'][1:]))
    out['steady_eval_ms'] = float(np.median(record['eval_ms'][1:]))
    return out


def compare_batched(stage, got, ref):
    """A batched stage on the card against JAX's numbers: the counts and
    shapes equal, the first step within BATCHED_FIRST_RTOL, the initial
    validation within BATCHED_INITIAL_VAL_RTOL, the rest within the
    model's BATCHED_LATER_RTOL; a 'bf16' stage its counts only.  Returns
    what failed (empty when all held)."""
    if got['counts'] != ref['counts']:
        return [f'{stage}: samples {got["counts"]}, JAX {ref["counts"]}']
    shapes = sum(g != r for g, r in zip(got['shapes'], ref['shapes']))
    steps_match = np.shape(got['train_steps']) == np.shape(ref['train_steps'])
    if stage.endswith('/bf16'):
        first = (float(_rel(got['train_steps'][0],
                            ref['train_steps'][0]).max())
                 if steps_match else None)
        print(f'  {stage}: samples {got["counts"]} as JAX\'s, {shapes} '
              f'input shapes differ, the steps\' shapes '
              f'{"equal" if steps_match else "differ"}; first step against '
              f'JAX {first} (not gated)', flush=True)
        return []
    if shapes or not steps_match:
        return [f'{stage}: samples {got["shapes"]}, steps '
                f'{np.shape(got["train_steps"])}, JAX {ref["shapes"]} '
                f'{np.shape(ref["train_steps"])}']
    errs = {
        'first': float(_rel(got['train_steps'][0],
                            ref['train_steps'][0]).max()),
        'steps': float(_rel(got['train_steps'], ref['train_steps']).max()),
        'initial_val': float(_rel(got['val_sweeps'][0],
                                  ref['val_sweeps'][0]).max()),
        'val': float(_rel(got['val_sweeps'][1], ref['val_sweeps'][1]).max()),
        'norms': max(float(_rel(got['update_norms'][k], v))
                     for k, v in ref['update_norms'].items()),
    }
    later = BATCHED_LATER_RTOL[got['model']]
    print(f'  {stage}: samples {got["counts"]}, against JAX, relative: '
          f'{json.dumps(errs)}', flush=True)
    failed = []
    if errs['first'] > BATCHED_FIRST_RTOL:
        failed.append(f'{stage}: first step {errs["first"]} off JAX')
    if errs['initial_val'] > BATCHED_INITIAL_VAL_RTOL:
        failed.append(f'{stage}: initial validation off JAX: {errs}')
    if max(errs['steps'], errs['val'], errs['norms']) > later:
        failed.append(f'{stage}: later steps off JAX (> {later}): {errs}')
    return failed


class QuietReporter:
    """train_model's reporter: keeps every message, prints the batched
    stages' and the gate's."""

    def __init__(self):
        self.messages = []

    def message(self, *parts, sep=' ', end='\n'):
        text = sep.join(str(part) for part in parts)
        self.messages.append(text)
        if any(key in text for key in ('gate', '===', 'built')):
            print(f'  {text.strip()}', flush=True)

    def info(self, info):
        pass

    def status(self, status_type, status_data=None):
        pass


def batched_train_path(weights, params, mono_prep, char_prep, mono_w,
                       char_w, rng):
    """Phase batched_train_path: each batched stage of the reference on
    the card against JAX's numbers, with its times and peak memory; then
    train_model(batched=True, predicted=True, eval_gate=True) over the
    curriculum at 1 epoch (the main path of this phase: launches counted
    from 0 just before it); the gate alone (the committed checkpoint's
    score against JAX's, a random Char model rejected with its checkpoint
    unchanged, the committed weights approved); and both kernels against
    their plain versions at this path's shapes.  Returns (launches,
    max_abs_err per kernel)."""
    from univer_ocr_tpu_torch.models import dp_train, evaluation
    from univer_ocr_tpu_torch.models.datasets import load_page_arrays
    from univer_ocr_tpu_torch.models.model import Modes, make_char
    from univer_ocr_tpu_torch.models.train import CURRICULUM, train_model
    from univer_ocr_tpu_torch.nn.checkpoint import write_weights
    from univer_ocr_tpu_torch.ops import kernels
    from univer_ocr_tpu_torch.ops.kernels import LAUNCHES, char_head
    from univer_ocr_tpu_torch.ops.precision import backend_flags
    train, validation = load_page_arrays(TRAIN_FIXTURE)
    with np.load(BATCHED_FIXTURE) as f:
        reference = json.loads(str(f['reference']))
    host_score = host_gate_score(weights)

    stages, failed = {}, []
    with recorded_batched_steps({}) as record:
        for stage, ref in reference.items():
            got = batched_stage(stage, train, validation, weights, record)
            stages[stage] = got
            failed += compare_batched(stage, got, ref)
            n_train = got['counts'][0]
            print(f'  {stage} times: ' + json.dumps({
                'build_s': got['build_s'], 'stage_s': got['stage_s'],
                'train_step_ms': float(np.median(got['train_ms'])),
                'train_steps': len(got['train_ms']),
                'eval_batch_ms': float(np.median(got['eval_ms'])),
                'eval_batches': len(got['eval_ms']),
                'steady_train_step_ms': got['steady_train_ms'],
                'steady_eval_batch_ms': got['steady_eval_ms'],
                'train_samples_per_s': n_train * 1e3 / sum(got['train_ms']),
                'peak_gib': got['peak_gib']}), flush=True)

    # the main path: the batched curriculum through its CLI's entry point
    out_dir = ROOT / 'build' / 'batched'
    gate_s = []
    score_weights = evaluation.score_weights

    def timed_score(*args, **kwargs):
        t0 = time.perf_counter()
        out = score_weights(*args, **kwargs)
        torch.cuda.synchronize()
        gate_s.append(time.perf_counter() - t0)
        return out

    evaluation.score_weights = timed_score
    reporter = QuietReporter()
    try:
        curriculum = [(mode, lr, step, 1) for mode, lr, step, _ in CURRICULUM]
        torch.cuda.synchronize()
        LAUNCHES.clear()
        char_head.WIDTH_LAUNCHES.clear()
        t0 = time.perf_counter()
        results = train_model(train, validation, curriculum, train_size=2,
                              val_size=1, seed=0,
                              weights_out=out_dir / 'model_weights.json',
                              device='cuda', reporter=reporter, batched=True,
                              batch=16, predicted=True, eval_gate=True)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        widths = dict(sorted(char_head.WIDTH_LAUNCHES.items()))
    finally:
        evaluation.score_weights = score_weights
    decisions = [m for m in reporter.messages if m.startswith('[eval-gate]')]
    print(f'  train_model(batched=True, predicted=True, eval_gate=True), 5 '
          f'stages x 1 epoch: {total_s:.2f} s; gate scores (8 pages each) '
          f'{[round(t, 3) for t in gate_s]} s; launches {launches}, '
          f'fused_char_head by width {widths}', flush=True)
    for r in results:
        best = {k: list(map(float, v)) for k, v in r['best_losses'].items()}
        print(f'  {r["mode"]}: samples {r.get("samples")}, best {best}',
              flush=True)
        if not all(np.isfinite(v).all() for v in r['best_losses'].values()):
            raise AssertionError(f'batched train_model {r["mode"]}: {r}')
    if len(decisions) != 1 + len(results):
        raise AssertionError(f'the gate decided {decisions}')
    with open(out_dir / 'model_weights.json') as fp:
        written = json.load(fp)
    if sorted(written) != sorted(weights):
        raise AssertionError(f'batched train_model wrote {sorted(written)}')
    for name in ('fused_monochrome', 'fused_char_head'):
        if launches.get(name, 0) < 1:
            raise AssertionError(f'{name} did not launch on the batched '
                                 f'train path')

    # the gate alone, on a copy of the committed checkpoint
    path = out_dir / 'gate.json'
    write_weights(weights, path)
    gate = evaluation.make_eval_gate(path, log=print, device='cuda')
    before = path.read_bytes()
    dp_train.train_stage_batched(
        Modes.TRAIN_CHAR, *stages['TRAIN_CHAR/highest']['samples'], {},
        epochs=0, lr=1e-3, lr_step=0.9, checkpoint_path=path,
        eval_gate=gate, log=print, device='cuda')
    if path.read_bytes() != before:
        raise AssertionError('a rejected random Char model changed the '
                             'checkpoint')
    committed = make_char(PAGE_SHAPE, device='cuda')
    committed.set_weights(weights)
    ok, score, incumbent = gate({'Char': committed})
    print(f'  gate: committed checkpoint {incumbent:.6f} against the host '
          f'cascade\'s {host_score:.6f} (bar {GATE_SCORE_TOL}); the '
          f'committed weights as a candidate {score:.6f}: '
          f'{"approved" if ok else "REJECTED"}', flush=True)
    if abs(incumbent - host_score) > GATE_SCORE_TOL:
        raise AssertionError('the gate\'s score of the committed checkpoint '
                             'is off the host cascade\'s')
    if not ok:
        raise AssertionError('the gate rejected the committed weights')

    # both kernels at this path's shapes: the sample fronts' chunks of 2
    # train pages and 1 validation page; the gate's fused tail
    errors = {'fused_monochrome': 0.0, 'fused_char_head': 0.0}
    with backend_flags('highest'):
        for n in (2, 1):
            x = torch.tensor(rng.random((n,) + PAGE_SHAPE[1:],
                                        dtype=np.float32), device='cuda')
            errors['fused_monochrome'] = max(
                errors['fused_monochrome'],
                compare(f'fused_monochrome {tuple(x.shape)}',
                        kernels.fused_monochrome(x, mono_prep),
                        kernels.fused_monochrome_reference(x, *mono_w),
                        MONO_TOL))
        for width in widths:
            x = char_inputs(params, rng, DEVICE_LINES, width)
            errors['fused_char_head'] = max(
                errors['fused_char_head'],
                compare(f'fused_char_head {tuple(x.shape)}',
                        kernels.fused_char_head(x, char_prep),
                        kernels.fused_char_head_reference(x, *char_w),
                        CHAR_TOL))
    if failed:
        raise AssertionError('batched stages off JAX\'s numbers: '
                             + '; '.join(failed))
    return launches, errors


def post_ocr(port, body):
    """(status, JSON answer, ms) of one POST /ocr."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f'http://127.0.0.1:{port}/ocr', data=body,
                                 method='POST')
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, data = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, data = e.code, json.loads(e.read())
    return status, data, 1e3 * (time.perf_counter() - t0)


def npy_bytes(arr):
    import io
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def serve_path(card, mono_prep, mono_w, rng):
    """Phase serve_path: the web app on the card (create_app(),
    start_background(port=0)) answering POST /ocr with .npy bodies: the 4
    fixture pages cropped by one pixel on every side (494x734, bucketed
    to 496x736) and the first 2 whole (bucketed to 752x992), with the
    launch counts from 0 just before them.  `fused_monochrome` is held
    to its plain version at every shape these requests gave it.  Each
    answer must equal its pipeline's own ocr_pages on bucket_page of the
    body and be within BF16_SIMILARITY of JAX's /ocr answer to the same
    body (the fixture's `ocr_texts`); garbage gets a 400; 8 sequential
    requests are timed with their pipeline's stage timers on; 4
    concurrent requests give the sequential texts.  Then a /train-ws
    micro run (train_model at 1 epoch of TRAIN_MONOCHROME on the
    training fixture, reporting through init_emitter) whose browser must
    see message, info and every DASHBOARD_TYPES type, and `python -m
    univer_ocr_tpu_torch predict` on a .npy page, whose text must equal
    predict() in this process.  Returns the requests' launches and the
    kernel's largest error."""
    import threading
    from univer_ocr_tpu_torch.models import train as train_mod
    from univer_ocr_tpu_torch.models.datasets import load_page_arrays
    from univer_ocr_tpu_torch.models.model import Modes
    from univer_ocr_tpu_torch.models.predict import predict
    from univer_ocr_tpu_torch.ops import kernels
    from univer_ocr_tpu_torch.ops.kernels import LAUNCHES, char_head
    from univer_ocr_tpu_torch.ops.kernels.fused_monochrome import (
        SHAPE_LAUNCHES)
    from univer_ocr_tpu_torch.ops.precision import backend_flags
    from univer_ocr_tpu_torch.utils.profiling import StageTimers
    from univer_ocr_tpu_torch.web import app as app_mod
    from univer_ocr_tpu_torch.web import create_app
    from univer_ocr_tpu_torch.web.app import bucket_page
    from univer_ocr_tpu_torch.web.ws_client import (FrameReader, WSClient,
                                                    connect_train_ws)
    from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT

    out_dir = ROOT / 'build' / 'serve'
    out_dir.mkdir(parents=True, exist_ok=True)
    # JAX's stored answers are the committed checkpoint's: the app is
    # pointed away from any checkpoint a trainer left in generated_files/
    app_mod.TRAINED_WEIGHTS_PATH = out_dir / 'no_trained_weights.json'
    if app_mod.serving_weights_path() != DEFAULT_CHECKPOINT:
        raise AssertionError('serve_path: the app would not serve the '
                             'committed checkpoint')
    with np.load(FIXTURE) as f:
        pages = f['pages']
        jax_answers = json.loads(str(f['ocr_texts']))
    bodies = {'crop': [np.ascontiguousarray(p[1:-1, 1:-1]) for p in pages],
              'whole': list(pages[:2])}
    app = create_app()
    if app.device.type != 'cuda':
        raise AssertionError(f'serve_path: the app runs on {app.device}')
    app.start_background(port=0)
    try:
        LAUNCHES.clear()
        char_head.WIDTH_LAUNCHES.clear()
        SHAPE_LAUNCHES.clear()
        answers, first_ms = {}, {}
        for key, arrs in bodies.items():
            answers[key] = []
            for arr in arrs:
                status, data, ms = post_ocr(app.port, npy_bytes(arr))
                if status != 200:
                    raise AssertionError(f'serve_path: /ocr gave {status}: '
                                         f'{data}')
                answers[key].append(data['text'])
                first_ms.setdefault(str(bucket_page(arr).shape[1:3]), ms)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        widths = dict(sorted(char_head.WIDTH_LAUNCHES.items()))
        mono_shapes = dict(sorted(SHAPE_LAUNCHES.items()))
        print(f'serve_path launches: {launches}; fused_char_head by width: '
              f'{widths}; fused_monochrome by (B, H, W): '
              f'{ {str(k): v for k, v in mono_shapes.items()} }', flush=True)
        for name in ('fused_monochrome', 'fused_char_head'):
            if launches.get(name, 0) < 1:
                raise AssertionError(f'{name} did not launch on serve_path')
        # the kernel at every shape the requests gave it (each bucket
        # shape the app built a pipeline for)
        mono_err = 0.0
        with backend_flags('highest'):
            for B, H, W in mono_shapes:
                x = torch.tensor(rng.random((B, H, W, 1), dtype=np.float32),
                                 device='cuda')
                mono_err = max(mono_err, compare(
                    f'fused_monochrome {(B, H, W, 1)}',
                    kernels.fused_monochrome(x, mono_prep),
                    kernels.fused_monochrome_reference(x, *mono_w),
                    MONO_TOL))
        shapes = sorted(app.state['ocr_pipelines'])
        print(f'serve_path pipelines: {shapes}, on '
              f'{[str(p.device) for p in app.state["ocr_pipelines"].values()]}',
              flush=True)
        if shapes != [(1, 496, 736, 1), (1, 752, 992, 1)] or any(
                p.device.type != 'cuda'
                for p in app.state['ocr_pipelines'].values()):
            raise AssertionError('serve_path: not one card pipeline per shape')
        for key, arrs in bodies.items():
            for i, arr in enumerate(arrs):
                X = bucket_page(arr)
                with app.ocr_lock:
                    direct = app.get_pipeline(X.shape).ocr_pages([X])[0]
                got, want = answers[key][i], jax_answers[key][i]
                ratio = difflib.SequenceMatcher(
                    None, page_text(want), page_text(got),
                    autojunk=False).ratio()
                print(f'  {key} page {i} {X.shape[1:3]}: '
                      f'{sum(len(p) for p in got)} lines, equal to ocr_pages '
                      f'{got == direct}, similarity to JAX\'s /ocr answer '
                      f'{ratio:.6f}, exact {got == want}', flush=True)
                if got != direct:
                    raise AssertionError(f'serve_path {key} {i}: the answer '
                                         'differs from ocr_pages')
                if ratio <= BF16_SIMILARITY:
                    raise AssertionError(f'serve_path {key} {i}: similarity '
                                         f'{ratio} <= {BF16_SIMILARITY}')
        status, data, _ = post_ocr(app.port, b'not an image')
        print(f'serve_path garbage body: {status} {data}', flush=True)
        if status != 400 or not data.get('error'):
            raise AssertionError('serve_path: garbage was not refused')

        crops = [npy_bytes(arr) for arr in bodies['crop']]
        served = app.state['ocr_pipelines'][(1, 496, 736, 1)]
        with app.ocr_lock:
            served.timers = StageTimers()
        seq = [post_ocr(app.port, crops[i % 4]) for i in range(SERVE_REPS)]
        with app.ocr_lock:
            stages = {name: round(1e3 * total / SERVE_REPS, 3) for name, total
                      in sorted(served.timers.totals.items())}
            served.timers = None
        ms = [r[2] for r in seq]
        if any(r[0] != 200 or r[1]['text'] != answers['crop'][i % 4]
               for i, r in enumerate(seq)):
            raise AssertionError('serve_path: a repeated request changed')
        results = [None] * 4

        def run(i):
            results[i] = post_ocr(app.port, crops[i])
        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if [r[:2] for r in results] != [(200, {'text': answers['crop'][i]})
                                        for i in range(4)]:
            raise AssertionError('serve_path: concurrent requests differ '
                                 'from sequential ones')
        print(f'serve_path on {card}: first request per shape (building '
              f'its pipeline) ms {json.dumps(first_ms)}', flush=True)
        print(f'serve_path on {card}: {SERVE_REPS} sequential requests at '
              f'496x736: p50 {float(np.median(ms)):.2f} ms, min '
              f'{min(ms):.2f}, max {max(ms):.2f}, mean {float(np.mean(ms)):.2f}'
              f'; stage timers, ms per request (summed over threads): '
              f'{json.dumps(stages)}, {sum(stages.values()):.3f} in all',
              flush=True)
        print(f'serve_path on {card}: 4 concurrent requests in {wall:.3f} s, '
              f'{4 / wall:.2f} requests/s, texts equal to sequential',
              flush=True)

        browser = WSClient('127.0.0.1', app.port, '/train-ws')
        reader = FrameReader(browser.sock)
        client = connect_train_ws(port=app.port)
        train, validation = load_page_arrays()
        train_mod.init_emitter(client)
        t0 = time.perf_counter()
        try:
            train_mod.train_model(
                train, validation,
                curriculum=[(Modes.TRAIN_MONOCHROME, 1e-3, 0.995, 1)],
                train_size=2, val_size=1,
                weights_out=out_dir / 'weights.json')
        finally:
            train_mod.init_emitter(None)
            client.close()
        train_s = time.perf_counter() - t0
        reader.wait(lambda events: DASHBOARD_TYPES <= {
            e['data'].get('type') for e in events
            if e.get('event') == 'progress_tracker'}, 10)
        browser.close()
        kinds = Counter(e.get('event') for e in reader.events)
        types = Counter(e['data'].get('type') for e in reader.events
                        if e.get('event') == 'progress_tracker')
        print(f'serve_path /train-ws micro run: {train_s:.2f} s, events '
              f'{dict(kinds)}, progress types {dict(types)}', flush=True)
        if not ({'message', 'info'} <= set(kinds)
                and DASHBOARD_TYPES <= set(types)):
            raise AssertionError('serve_path: the dashboard missed events')
    finally:
        app.shutdown()

    page = out_dir / 'page.npy'
    np.save(page, pages[2])
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, '-m', 'univer_ocr_tpu_torch', 'predict', str(page),
         '--out', str(out_dir / 'cli')],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    if cli.returncode != 0:
        raise AssertionError(f'serve_path: the CLI failed:\n{cli.stderr}')
    want = predict(page, out_dir / 'inproc', device='cuda')
    printed = cli.stdout.strip().splitlines()[-1]
    print(f'serve_path CLI predict: {cli_s:.2f} s, equal to predict() '
          f'{printed == str(want)}', flush=True)
    if printed != str(want):
        raise AssertionError('serve_path: the CLI text differs from '
                             'predict()')
    return launches, mono_err


def groundtruth_path(params, committed, char_prep, char_w, rng):
    """Phase groundtruth_path: ground truth and the accuracy entry on the
    card, from fixtures/eval_layers.npz (the eval corpus's 8 pages with
    all 17 layers; the card has no Pillow to render them).

      * interpret() of every page must equal JAX's stored dict;
      * eval_accuracy.main through the serving default in 'bf16' with the
        decode at min-run 4 (`--pages`): its score within GATE_SCORE_TOL
        of JAX's stored score of the corpus and equal to
        evaluation.score_weights in the same call; both kernels launched;
      * eval_accuracy.main_gt_crops in 'highest' and 'bf16': each page's
        lines against JAX's stored ones (GT_CROP_SIMILARITY); the Char
        head launched, and held to its plain version at every shape it
        was given (CHAR_TOL);
      * the feed: with the card initialised, a DataGenerator of 2 spawned
        workers replaying the fixture's pages delivers 2 x FEED_QUEUE
        items, each its named page, and stop() ends both within
        FEED_STOP_S.
    Returns the launches by run and the Char head's largest error."""
    from univer_ocr_tpu_torch import eval_accuracy
    from univer_ocr_tpu_torch.interpreter import interpret
    from univer_ocr_tpu_torch.models.datasets import encode_layers
    from univer_ocr_tpu_torch.models.evaluation import (eval_corpus,
                                                        score_weights)
    from univer_ocr_tpu_torch.models.train_data_generator import (
        DataGenerator, replay_pages)
    from univer_ocr_tpu_torch.ops import kernels
    from univer_ocr_tpu_torch.ops.kernels import LAUNCHES, char_head
    from univer_ocr_tpu_torch.ops.kernels.fused_monochrome import (
        SHAPE_LAUNCHES as MONO_SHAPES)
    from univer_ocr_tpu_torch.ops.precision import backend_flags

    def quiet(*args):
        pass

    with np.load(EVAL_LAYERS) as f:
        n_pages = int(f['n_pages'])
        stored = {key: json.loads(str(f[key])) for key in
                  ('truths', 'gt_crops_highest', 'gt_crops_bf16')}
    host_score = host_gate_score(committed, n_pages)
    pages = eval_accuracy.load_layer_pages(EVAL_LAYERS, n_pages)

    t0 = time.perf_counter()
    truths = [interpret(page) for page in pages]
    interpret_s = time.perf_counter() - t0
    equal = [truth == {tuple(k): text for k, text in want}
             for truth, want in zip(truths, stored['truths'])]
    print(f'groundtruth_path interpret: {sum(equal)}/{n_pages} pages equal '
          f'JAX\'s, {sum(map(len, truths))} lines, {interpret_s:.3f} s',
          flush=True)
    if not all(equal):
        raise AssertionError(f'groundtruth_path: interpret differs from '
                             f'JAX\'s on pages {equal}')

    def counted(fn):
        """fn() with the launch counts from 0 just before it; returns
        (its result, seconds, launches, Char head shapes, Monochrome
        shapes)."""
        LAUNCHES.clear()
        char_head.SHAPE_LAUNCHES.clear()
        MONO_SHAPES.clear()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - start, dict(LAUNCHES),
                dict(sorted(char_head.SHAPE_LAUNCHES.items())),
                dict(sorted(MONO_SHAPES.items())))

    launches = {}
    # the accuracy entry: the serving default on the corpus, twice (the
    # first builds the pipeline's programs and workspaces)
    for run in ('first', 'timed'):
        score, eval_s, launches['groundtruth_eval'], eval_chars, eval_mono = \
            counted(lambda: eval_accuracy.main(
                n_pages, collapse=4, chunk=CHUNK, pages_path=EVAL_LAYERS,
                weights=committed, device='cuda', log=quiet))
        print(f'groundtruth_path eval_accuracy ({run}): concat '
              f'{score["concat"]:.6f}, canonical {score["canonical"]:.6f}, '
              f'matched {score["matched"]:.6f}, {eval_s:.3f} s, '
              f'{n_pages / eval_s:.3f} pages/s', flush=True)
    print(f'groundtruth_path eval_accuracy launches: '
          f'{launches["groundtruth_eval"]}; fused_char_head by (N, W): '
          f'{ {str(k): v for k, v in eval_chars.items()} }; '
          f'fused_monochrome by (B, H, W): '
          f'{ {str(k): v for k, v in eval_mono.items()} }', flush=True)
    for name in ('fused_monochrome', 'fused_char_head'):
        if launches['groundtruth_eval'].get(name, 0) < 1:
            raise AssertionError(f'{name} did not launch in eval_accuracy')
    gate = score_weights(committed, *eval_corpus(n_pages), collapse=4,
                         chunk=CHUNK, device='cuda')
    print(f'groundtruth_path score_weights: concat {gate["concat"]:.6f}; '
          f'the host cascade\'s {host_score:.6f}', flush=True)
    if gate != score:
        raise AssertionError('groundtruth_path: eval_accuracy and '
                             'score_weights disagree')
    if abs(score['concat'] - host_score) > GATE_SCORE_TOL:
        raise AssertionError(f'groundtruth_path: score {score["concat"]} '
                             f'against the host cascade\'s {host_score}')

    # the Char model alone on ground-truth crops
    gt_shapes = Counter()
    gt_ms = {}
    for precision, bar in GT_CROP_SIMILARITY.items():
        key = f'groundtruth_gt_crops_{precision}'
        (_, texts), gt_s, launches[key], shapes, _ = counted(
            lambda: eval_accuracy.main_gt_crops(
                n_pages, precision=precision, pages_path=EVAL_LAYERS,
                weights=params, device='cuda', log=quiet))
        gt_ms[precision] = 1e3 * gt_s / n_pages
        gt_shapes.update(shapes)
        ratios = [difflib.SequenceMatcher(
            None, '\n'.join(want), '\n'.join(got), autojunk=False).ratio()
            for got, want in zip(texts, stored[f'gt_crops_{precision}'])]
        print(f'groundtruth_path gt-crops {precision}: {gt_ms[precision]:.3f}'
              f' ms per page, {sum(map(len, texts))} lines, similarity to '
              f'JAX\'s per page {[round(r, 6) for r in ratios]}, launches '
              f'{launches[key]}, fused_char_head by (N, W) '
              f'{ {str(k): v for k, v in shapes.items()} }', flush=True)
        if launches[key].get('fused_char_head', 0) < 1:
            raise AssertionError(f'fused_char_head did not launch on the '
                                 f'{precision} ground-truth crops')
        if min(ratios) < bar or (precision == 'bf16' and min(ratios) == bar):
            raise AssertionError(f'groundtruth_path gt-crops {precision}: '
                                 f'similarity {min(ratios)} to JAX\'s')
    err = 0.0
    with backend_flags('highest'):
        for n, width in sorted(gt_shapes):
            x = char_inputs(params, rng, n, width)
            err = max(err, compare(
                f'fused_char_head {(n, width, 64)} (ground-truth crops)',
                kernels.fused_char_head(x, char_prep),
                kernels.fused_char_head_reference(x, *char_w), CHAR_TOL))

    # the feed, spawned beside the live CUDA context
    torch.zeros(1, device='cuda')
    with np.load(EVAL_LAYERS) as f:
        names = json.loads(str(f['layer_names']))
        layers = f['layers']
    feed = DataGenerator(queue_size=FEED_QUEUE, generator_func=replay_pages,
                         func_args=(str(EVAL_LAYERS),), workers=2, seed=0)
    t0 = time.perf_counter()
    feed.start()
    try:
        items = [feed.get_data() for _ in range(2 * FEED_QUEUE)]
        feed_s = time.perf_counter() - t0
    finally:
        t1 = time.perf_counter()
        feed.stop()
        stop_s = time.perf_counter() - t1
    alive = [proc.is_alive() for proc in feed.workers]
    for index, encoded in items:
        want = encode_layers(dict(zip(names, layers[index])))
        if sorted(encoded) != sorted(want) or not all(
                np.array_equal(encoded[t], want[t]) for t in want):
            raise AssertionError(f'groundtruth_path: the feed\'s page '
                                 f'{index} differs from the fixture\'s')
    print(f'groundtruth_path feed: {len(items)} items (pages '
          f'{[index for index, _ in items]}) in {feed_s:.3f} s from 2 '
          f'spawned workers, stop() {stop_s:.3f} s, alive after {alive}',
          flush=True)
    if len(items) != 2 * FEED_QUEUE or stop_s > FEED_STOP_S or any(alive):
        raise AssertionError('groundtruth_path: the feed did not deliver '
                             'and stop')
    return launches, err


def scipy_label_stats(mask):
    """native.label_stats from scipy.ndimage.label, a mask per label."""
    from scipy import ndimage
    labels, n = ndimage.label(np.asarray(mask))
    coords = [np.argwhere(labels == k) for k in range(1, n + 1)]
    boxes = [(y.start, y.stop, x.start, x.stop)
             for y, x in ndimage.find_objects(labels)]
    return (labels.astype(np.int32), n,
            np.array([len(c) for c in coords], np.int64),
            np.array([c.mean(axis=0) for c in coords]).reshape(n, 2),
            np.array(boxes, np.int32).reshape(n, 4))


@contextlib.contextmanager
def scipy_labels():
    """Inside the block the port labels with scipy.ndimage.label in place
    of its native CCL and its statistics pass (the comparison of
    host_native)."""
    from scipy import ndimage
    from univer_ocr_tpu_torch import native
    native_label, native_stats = native.label, native.label_stats
    native.label = lambda mask: ndimage.label(np.asarray(mask))
    native.label_stats = scipy_label_stats
    try:
        yield
    finally:
        native.label, native.label_stats = native_label, native_stats


def median_call_ms(fn, args, reps=NATIVE_REPS):
    """Median ms of one fn(arg) over every arg, each timed REPS times."""
    times = []
    for _ in range(reps):
        for arg in args:
            t0 = time.perf_counter()
            fn(arg)
            times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times)), float(np.sum(times)) / reps


def host_native(card, host, pages, expected):
    """Phase host_native: the native CCL on the masks the host cascade
    labels, the paragraph masks of the chunk's 8 pages (its front) and
    every Line band channel of the chunk, equal to scipy's labels and
    counts exactly; the median ms per call of each, for `label` and for
    `label_layer`, and their sums per chunk; then the chunk through the
    host cascade with scipy's labels and with the native ones in turns
    (scipy, native, native, scipy), the text JAX's every time, with the
    host CV stage timers of each run."""
    from scipy import ndimage
    from univer_ocr_tpu_torch import interpreter, native
    from univer_ocr_tpu_torch.utils.profiling import StageTimers
    mono, para = (t.cpu().numpy()
                  for t in host.front(host._upload_pages(pages)))
    if host.quantized_transfers:
        mono = mono.astype(np.float32) / 255.0
    crops = [c for i in range(len(pages))
             for c in host._crop_page(mono[i:i + 1], para[i:i + 1])]
    # each band channel as plan_paragraph_lines thresholds it before
    # label_layer
    bands = [b[:, :, :, c:c + 1] > (
                 0 if host.quantized_transfers
                 else 0.5 * (np.mean(b[..., c]) + np.max(b[..., c])))
             for b in host._run_line_batched(crops)
             for c in range(b.shape[-1])]
    para_masks = [p[:, :, 0] > 0 for p in para]
    band_masks = [b[0, :, :, 0] > np.mean(b) for b in bands]
    components = []
    for mask in para_masks + band_masks:
        got, n = native.label(mask)
        exp, m = ndimage.label(mask)
        if n != m or not np.array_equal(got, exp):
            raise AssertionError(f'host_native: native labels differ from '
                                 f'scipy\'s on a {mask.shape} mask ({n} '
                                 f'against {m} components)')
        components.append(n)
    print(f'host_native: labels and counts equal scipy\'s on '
          f'{len(para_masks)} paragraph masks ({sum(components[:8])} '
          f'components) and {len(band_masks)} band channels of '
          f'{len(crops)} crops ({sum(components[8:])} components)',
          flush=True)
    times = {}
    for name, masks in (('paragraph', para_masks), ('band', band_masks)):
        times[f'label {name}'] = {
            'native': median_call_ms(native.label, masks),
            'scipy': median_call_ms(ndimage.label, masks)}
    native_layers = median_call_ms(interpreter.label_layer, bands)
    with scipy_labels():
        scipy_layers = median_call_ms(interpreter.label_layer, bands)
    times['label_layer band'] = {'native': native_layers,
                                 'scipy': scipy_layers}
    for key, pair in times.items():
        print(f'host_native on {card}: {key}: median ms per call native '
              f'{pair["native"][0]:.4f}, scipy {pair["scipy"][0]:.4f} '
              f'({pair["scipy"][0] / pair["native"][0]:.2f}x); ms per '
              f'chunk native {pair["native"][1]:.3f}, scipy '
              f'{pair["scipy"][1]:.3f}', flush=True)
    runs = {'scipy': [], 'native': []}
    for which in ('scipy', 'native', 'native', 'scipy'):
        with (scipy_labels() if which == 'scipy'
              else contextlib.nullcontext()):
            host.timers = StageTimers()
            t0 = time.perf_counter()
            results = host.ocr_pages(pages)
            torch.cuda.synchronize()
            chunk_ms = 1e3 * (time.perf_counter() - t0)
            totals = host.timers.totals
            host.timers = None
        check_text(f'host_native, {which} labels', results, expected)
        runs[which].append({
            'chunk_ms': round(chunk_ms, 3),
            **{k: round(1e3 * totals.get(k, 0.0), 3)
               for k in ('host_paragraph_crops', 'host_line_crops')}})
    print(f'host_native on {card}: the host cascade with scipy\'s labels '
          f'and with the native ones, in turns, ms per chunk of '
          f'{CHUNK} (host CV summed over threads): {json.dumps(runs)}',
          flush=True)


class _Untouched:
    """A dataset whose pages must not be read."""

    def __len__(self):
        return 1

    def get(self, *args, **kwargs):
        raise AssertionError('nn_batteries: a page was read')


@contextlib.contextmanager
def without_pillow():
    """Imports of Pillow fail inside the block, whether or not it is
    installed."""
    saved = {name: sys.modules.get(name) for name in ('PIL', 'PIL.Image')}
    sys.modules.update(dict.fromkeys(saved))
    try:
        yield
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def snapshot_page(device, committed, lr=0.0):
    """One curriculum page of TRAIN_ALL (the training fixture's first
    page, validated on its validation page, 1 epoch from the committed
    checkpoint) with ProgressSnapshots.panels as the Trainer's
    save_pictures_func: {file name: (dtype, shape)}, the seconds and
    whether a weight moved.  At lr 0 (the default) the validation sweep
    predicts with the committed weights too: after a real step the
    card's weights and the CPU's part (ROADMAP, Char training
    trajectories), and a predicted crop may then differ by a pixel or
    two."""
    import random
    from univer_ocr_tpu_torch.models.datasets import (RandomSelectDataset,
                                                      load_page_arrays)
    from univer_ocr_tpu_torch.models.model import (Modes, make_context_maker,
                                                   make_model_system)
    from univer_ocr_tpu_torch.models.train import ProgressSnapshots
    from univer_ocr_tpu_torch.models.trainer import Trainer
    from univer_ocr_tpu_torch.nn.optimizers import Adam
    from univer_ocr_tpu_torch.nn.progress_tracker import BaseProgressTracker
    from univer_ocr_tpu_torch.ops.precision import backend_flags
    train, validation = load_page_arrays(TRAIN_FIXTURE)
    rng = random.Random(0)
    mode = Modes.TRAIN_ALL
    optimizer = Adam(lr=lr)
    system, models, _ = make_model_system(
        PAGE_SHAPE, optimizer, weights=committed, mode=mode, device=device)

    def weight_sum():
        return sum(float(np.abs(np.asarray(array, np.float64)).sum())
                   for model in models.values()
                   for layer in model.get_weights().values()
                   for array in layer.values())

    before = weight_sum()
    snapshots = ProgressSnapshots(mode)
    panels = {}

    def record(epoch, phase, index, context):
        for name, panel in snapshots.panels(epoch, phase, index,
                                            context).items():
            panels[name] = (str(panel.dtype), panel.shape)

    t0 = time.perf_counter()
    with backend_flags('highest'):
        Trainer(system, make_context_maker(mode, device), models,
                RandomSelectDataset(1, train, rng),
                RandomSelectDataset(1, validation, rng),
                progress_tracker=BaseProgressTracker(), optimizer=optimizer,
                learning_rate_step=0.9, save_pictures_func=record,
                rng=rng).train(num_epochs=1)
    if device != 'cpu':
        torch.cuda.synchronize()
    return panels, round(time.perf_counter() - t0, 2), weight_sum() != before


def nn_batteries(card, committed):
    """Phase nn_batteries: test_identity on the card against the CPU and
    test_gradients on the card in float64, every check passing; one
    curriculum page of TRAIN_ALL with the snapshots' panels as the
    Trainer's save_pictures_func, on the card and on the CPU at lr 0:
    the same file names, every panel uint8 of the CPU's shape; at lr 1e-3
    on the card, a weight moved and every stage's panels of both phases
    are there; train_model(save_train_progress=True) without Pillow raising, naming
    it, before any page is read; and `start` of test_identity with use_gpu
    on the web app's /test-nn-ws, whose output must stream the pass
    counter and the subprocess's exit 0."""
    import importlib.util
    from univer_ocr_tpu_torch.models.model import Modes
    from univer_ocr_tpu_torch.models.train import train_model
    from univer_ocr_tpu_torch.nn.test import test_gradients, test_identity
    from univer_ocr_tpu_torch.web import create_app
    from univer_ocr_tpu_torch.web.ws_client import FrameReader, WSClient
    seconds = {}
    for battery in (test_identity, test_gradients):
        t0 = time.perf_counter()
        ok = battery.main(True)
        seconds[battery.__name__.rsplit('.', 1)[1]] = round(
            time.perf_counter() - t0, 2)
        if not (ok and battery.failed == 0 and battery.passed > 0):
            raise AssertionError(f'nn_batteries: {battery.__name__} failed '
                                 f'{battery.failed} of '
                                 f'{battery.passed + battery.failed}')
    card_panels, seconds['TRAIN_ALL page, card'], _ = snapshot_page(
        'cuda', committed)
    cpu_panels, seconds['TRAIN_ALL page, CPU'], _ = snapshot_page(
        'cpu', committed)
    stages = sorted({name.split('/')[1] for name in card_panels})
    print(f'nn_batteries on {card}: TRAIN_ALL page: {len(card_panels)} '
          f'panels on the card, {len(cpu_panels)} on the CPU, stages '
          f'{stages}', flush=True)
    if (card_panels != cpu_panels or len(stages) != 4
            or any(dtype != 'uint8' for dtype, _ in card_panels.values())):
        diff = sorted(set(card_panels.items()) ^ set(cpu_panels.items()))
        raise AssertionError(f'nn_batteries: the snapshots differ from the '
                             f'CPU run\'s: {diff[:6]}')
    # the hook after a real step, on the card alone: every stage's
    # panels of both phases are there, uint8 (names and shapes may part
    # from the lr-0 run's once the weights moved)
    stepped, seconds['TRAIN_ALL page, card, lr 1e-3'], moved = snapshot_page(
        'cuda', committed, lr=1e-3)

    def stage_phases(panels):
        return {(name.split('/')[1], name.split('/')[2].split('_')[1])
                for name in panels}

    print(f'nn_batteries on {card}: TRAIN_ALL page at lr 1e-3: '
          f'{len(stepped)} panels on the card, weights moved: {moved}, '
          f'(stage, phase) {sorted(stage_phases(stepped))}', flush=True)
    if (not moved or stage_phases(stepped) != stage_phases(card_panels)
            or not {'train', 'validation'}
            <= {phase for _, phase in stage_phases(stepped)}
            or any(dtype != 'uint8' for dtype, _ in stepped.values())):
        raise AssertionError('nn_batteries: after a real step the snapshots '
                             'lack a stage or a phase, or no weight moved')
    print(f'nn_batteries: Pillow installed: '
          f'{importlib.util.find_spec("PIL") is not None}', flush=True)
    out = ROOT / 'build' / 'nn_batteries'
    with without_pillow():
        try:
            train_model(_Untouched(), _Untouched(),
                        curriculum=[(Modes.TRAIN_ALL, 1e-3, 0.9, 1)],
                        train_size=1, val_size=1,
                        weights_out=out / 'weights.json',
                        save_train_progress=True)
        except RuntimeError as exc:
            if 'Pillow' not in str(exc):
                raise
            print(f'nn_batteries: save_train_progress without Pillow: '
                  f'{exc}', flush=True)
        else:
            raise AssertionError('nn_batteries: save_train_progress ran '
                                 'without Pillow')
    if (out / 'weights.json').exists():
        raise AssertionError('nn_batteries: a checkpoint was written')
    app = create_app()
    app.start_background(port=0)
    try:
        browser = WSClient('127.0.0.1', app.port, '/test-nn-ws')
        reader = FrameReader(browser.sock)
        time.sleep(0.1)
        t0 = time.perf_counter()
        browser.emit('start', {'test_name': 'test_identity',
                               'use_gpu': True})
        ended = reader.wait(lambda events: any(
            'process exited' in str(e.get('data')) for e in events), 300)
        seconds['/test-nn-ws test_identity'] = round(
            time.perf_counter() - t0, 2)
        text = ''.join(str(e.get('data')) for e in reader.events)
        browser.close()
    finally:
        app.shutdown()
    print(f'nn_batteries: /test-nn-ws streamed {len(reader.events)} '
          f'messages; the last: {text.strip().splitlines()[-3:]}', flush=True)
    if not (ended and 'Passed: 10, Failed: 0' in text
            and '[process exited with code 0]' in text):
        raise AssertionError(f'nn_batteries: /test-nn-ws did not pass:\n'
                             f'{text}')
    print(f'nn_batteries on {card}: seconds {json.dumps(seconds)}',
          flush=True)


def mesh_devices():
    """The mesh of phase mesh_path: every card when there are 2 or more
    (as many as divide DEVICE_BATCH), else MESH_SHARDS logical shards on
    the one card (the counterpart of JAX's virtual host devices)."""
    n = torch.cuda.device_count()
    if n >= 2:
        while 16 % n:
            n -= 1
        return [torch.device('cuda', i) for i in range(n)], f'{n} cards'
    return ([torch.device('cuda', 0)] * MESH_SHARDS,
            f'{MESH_SHARDS} logical shards on one card')


def timed_step_ms(fn, reps=5):
    """Median ms of fn() (host clock ending in a synchronize), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def mesh_steps(mesh, devices, weights, pages, rng):
    """The DP (Monochrome on the chunk's pages), TP (Char on a 4 x 2
    mesh) and batched mesh steps (Line, Char; 16 slots, 4 of them filler)
    on the card against the port's unsharded steps, in 'highest'.

    Each step runs once with plain SGD at SGD_LR (the parameters then move
    by SGD_LR times minus the step's summed gradient), and the model's whole
    gradient is held to the unsharded step's: the 2-norm of the
    difference over the 2-norm of the unsharded gradient within
    MESH_STEP_RTOL (the max-norm ratio printed beside it); the loss (the
    per-sample losses of the batched steps) within MESH_STEP_RTOL.  Both
    float32 gradients are also measured against the one-device step in
    float64 (printed, not gated): the Monochrome weights' gradients sum
    2.9 million pixels each, and on an H100 the unsharded and the mesh
    step differ by 7.4e-6 of the largest (PERF.md §6).
    Adam's first step is no measure of that: an element whose gradient
    sums to near 0 moves by lr * 0.1 g / (sqrt(0.001) |g| + 1e-8), which
    turns float32 sum-order noise into 1e-6-size differences (PERF.md
    §6).  The steps are timed with the models' Adam.  Returns per
    step: ms, the unsharded ms and the largest relative difference."""
    from univer_ocr_tpu_torch.models import dp_train, model as tmodel
    from univer_ocr_tpu_torch.nn.models import value_and_grad
    from univer_ocr_tpu_torch.nn.optimizers import Adam, Momentum
    from univer_ocr_tpu_torch.parallel import (make_dp_train_step,
                                               make_mesh,
                                               make_tp_char_train_step)
    from univer_ocr_tpu_torch.parallel.data_parallel import ColumnShards

    def one_device(m):
        def step(params, state, lr, X, y):
            _, (losses, _, _), grads = value_and_grad(
                m.loss_fn, params, list(params), [X], [y])
            with torch.no_grad():
                new, state = m._optimizer().update(params, grads, state, lr)
            return new, state, losses
        return step

    def dp(m):
        step = make_dp_train_step(m, mesh)
        return (lambda *args: step(*args)[:3]), one_device(m)

    def tp(m):
        step, place, place_opt = make_tp_char_train_step(m, tp_mesh)

        def placed(params, state, lr, X, y):
            new, state, losses, _ = step(place(params),
                                         place_opt(params, state), lr, X, y)
            return new, state, losses
        return placed, one_device(m)

    def batched(make):
        def steps(m):
            return make(m, mesh)[0], make(m, None)[0]
        return steps

    tp_mesh = make_mesh(devices=[devices[i % len(devices)] for i in range(8)],
                        model_parallel=2)
    X = torch.tensor(np.stack(pages)[:, 0], device='cuda').float() / 255.0
    Xc = torch.tensor(rng.random((8, 32, 512, 1), dtype=np.float32),
                      device='cuda')
    yc = torch.eye(162, device='cuda')[
        torch.tensor(rng.integers(0, 162, 8 * 512), device='cuda')]
    weight = torch.tensor([1.0] * 12 + [0.0] * 4, device='cuda')
    hv = torch.tensor(rng.integers(16, 65, 16) * 4, device='cuda')
    wv = torch.tensor(rng.integers(16, 129, 16) * 4, device='cuda')
    Xl = torch.tensor(rng.random((16, 256, 512, 1), dtype=np.float32),
                      device='cuda')
    yl = (torch.tensor(rng.random((16, 256, 512, 2), dtype=np.float32),
                       device='cuda') > 0.7).float()
    wc = torch.tensor(rng.integers(8, 257, 16) * 4, device='cuda')
    cols = torch.arange(1024, device='cuda')[None, :, None]
    yb = torch.nn.functional.one_hot(
        torch.tensor(rng.integers(0, 162, (16, 1024)), device='cuda'),
        162).float() * (cols < wc[:, None, None])
    Xb = torch.tensor(rng.random((16, 32, 1024, 1), dtype=np.float32),
                      device='cuda')
    cases = (
        # DP: the chunk's pages, the map's own threshold as the label
        ('dp_monochrome', 'make_monochrome', PAGE_SHAPE, dp, (X, (X < 0.5)
                                                              .float())),
        ('tp_char', 'make_char', (1, 32, 512, 1), tp, (Xc, yc)),
        ('batched_line', 'make_line', (1, 256, 512, 1),
         batched(lambda m, mesh: dp_train.make_batched_seg_step(
             m, 'Line', mesh)), (Xl, yl, hv, wv, weight)),
        ('batched_char', 'make_char', (1, 32, 1024, 1),
         batched(dp_train.make_batched_char_step), (Xb, yb, wc, weight)))
    out = {}
    for label, factory, shape, make, batch in cases:
        def model(optimizer):
            m = getattr(tmodel, factory)(shape, optimizer=optimizer,
                                         device='cuda')
            m.set_weights(weights)
            return m

        sgd = model(Momentum(lr=SGD_LR))
        params = sgd.params
        state = sgd._optimizer().init_state(params)
        (mesh_new, _, mesh_loss), (one_new, _, one_loss) = (
            step(params, state, SGD_LR, *batch) for step in make(sgd))
        # the same one-device step in float64: the reference both float32
        # gradients are measured against
        ref = model(Momentum(lr=SGD_LR))
        ref.params = {n: {k: v.double() for k, v in layer.items()}
                      for n, layer in ref.params.items()}
        ref_new = make(ref)[1](
            ref.params, ref._optimizer().init_state(ref.params), SGD_LR,
            *(t.double() if t.is_floating_point() else t for t in batch))[0]
        mesh_loss = torch.stack([torch.as_tensor(l) for l in mesh_loss])
        one_loss = torch.stack([torch.as_tensor(l) for l in one_loss])
        worst = ((mesh_loss - one_loss).abs()
                 / one_loss.abs().clamp(min=1e-30)).max().item()
        if worst > MESH_STEP_RTOL:
            raise AssertionError(f'{label}: losses {mesh_loss.tolist()} '
                                 f'against {one_loss.tolist()}')

        def gradient(p, new):
            """The step's gradient, flat in float64, from its SGD update."""
            return torch.cat([
                ((p[n][k].double() - (v.full(p[n][k].device)
                                      if isinstance(v, ColumnShards)
                                      else v).double()) / SGD_LR).reshape(-1)
                for n, layer in new.items() for k, v in layer.items()])

        g_mesh = gradient(params, mesh_new)
        g_one = gradient(params, one_new)
        g_ref = gradient(ref.params, ref_new)
        norm = g_one.norm().item()
        rel = (g_mesh - g_one).norm().item() / norm
        to_ref = {'mesh': (g_mesh - g_ref).norm().item() / g_ref.norm().item(),
                  'unsharded': (g_one - g_ref).norm().item()
                  / g_ref.norm().item()}
        print(f'  {label}: gradient 2-norm {norm:.4e}, the mesh step\'s '
              f'differs by {rel:.3e} of it (max-norm ratio '
              f'{(g_mesh - g_one).abs().max().item() / g_one.abs().max().item():.3e}); '
              f'against the float64 step: mesh {to_ref["mesh"]:.3e}, '
              f'unsharded {to_ref["unsharded"]:.3e}', flush=True)
        if rel > MESH_STEP_RTOL:
            raise AssertionError(f'{label}: the gradient differs by {rel:.3e} '
                                 f'of its 2-norm')
        worst = max(worst, rel)
        adam = model(Adam(lr=1e-3))
        state = adam._optimizer().init_state(adam.params)
        mesh_step, one_step = make(adam)
        out[label] = {
            'ms': timed_step_ms(lambda: mesh_step(adam.params, state, 1e-3,
                                                  *batch)),
            'unsharded_ms': timed_step_ms(lambda: one_step(
                adam.params, state, 1e-3, *batch)),
            'max_rel_diff': worst, 'float64_rel_err': to_ref}
        print(f'  {label}: {json.dumps(out[label])}', flush=True)
    return out


def mesh_path(card, params, weights, pages, unsharded, mono_w, char_w, rng):
    """Phase mesh_path: the host cascade and the serving default's fused
    tail over a mesh, each run's text against the unsharded pipelines'
    in this call and the fixture's text; the kernels' per-shard launches,
    each shape held to its plain version on each card of the mesh; the mesh
    training steps against the unsharded ones; pages/s, ms per step and
    peak memory.  `unsharded` maps 'host' and 'fused' to (the unsharded
    pipeline, its results on `pages` in this call, the fixture's text).
    Returns
    ({run: launches}, {kernel: max error})."""
    from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
    from univer_ocr_tpu_torch.ops import kernels
    from univer_ocr_tpu_torch.ops.kernels import _build, char_head
    from univer_ocr_tpu_torch.ops.kernels.fused_monochrome import (
        SHAPE_LAUNCHES)
    from univer_ocr_tpu_torch.ops.precision import backend_flags
    from univer_ocr_tpu_torch.parallel import make_mesh
    from univer_ocr_tpu_torch.parallel.mesh import on_device
    devices, label = mesh_devices()
    mesh = make_mesh(devices=devices)
    n_data = mesh.shape['data']
    distinct = list(dict.fromkeys(devices))
    print(f'mesh_path on {card}: {label} (torch.cuda.device_count() '
          f'{torch.cuda.device_count()}): {mesh}', flush=True)
    launches, errors = {}, {'fused_monochrome': 0.0, 'fused_char_head': 0.0}
    shapes = {'fused_monochrome': set(), 'fused_char_head': set()}
    summary = {'mesh': label, 'device_count': torch.cuda.device_count()}

    def sharded(**kwargs):
        return OCRPipeline(PAGE_SHAPE, weights=params, chunk=CHUNK, workers=8,
                           collapse_runs=4, precision='highest',
                           device='cuda', mesh=mesh, **kwargs)

    with sharded() as s_host, sharded(**FUSED_MODE) as s_fused:
        if not s_fused.fused_tail or s_fused._device_planner:
            raise AssertionError('mesh_path: the fused tail must run host-'
                                 'planned under a mesh')
        for run, pipeline, (_, single, want) in (
                ('mesh_host', s_host, unsharded['host']),
                ('mesh_fused', s_fused, unsharded['fused'])):
            _build.DEVICE_LAUNCHES.clear()
            SHAPE_LAUNCHES.clear()
            char_head.SHAPE_LAUNCHES.clear()
            results, launches[run], _ = counted_run(pipeline, pages)
            on = dict(_build.DEVICE_LAUNCHES)
            mono = dict(SHAPE_LAUNCHES)
            chars = dict(char_head.SHAPE_LAUNCHES)
            print(f'{run} launches: {launches[run]}; by (kernel, card): '
                  f'{on}; fused_monochrome by (B, H, W): {mono}; '
                  f'fused_char_head by (N, W): {chars}', flush=True)
            differ = [i for i, (a, b) in enumerate(zip(results, single))
                      if a != b]
            if differ or len(results) != len(single):
                raise AssertionError(f'{run}: pages {differ} differ from the '
                                     f'unsharded pipeline\'s text')
            print(f'{run}: all {len(results)} pages equal the unsharded '
                  f'text', flush=True)
            check_text(run, results, want)
            for name in shapes:
                for dev in distinct:
                    if on.get((name, dev.index), 0) < 1:
                        raise AssertionError(f'{run}: {name} did not launch '
                                             f'on {dev}')
            per_shard = {CHUNK // n_data}
            if {b for b, _, _ in mono} != per_shard:
                raise AssertionError(f'{run}: fused_monochrome launched at '
                                     f'{mono}, not {per_shard} pages')
            lines = ({pipeline.LINE_DEVICE_BATCH} if run == 'mesh_fused'
                     else {pipeline.DEVICE_BATCH // n_data})
            if {n for n, _ in chars} != lines:
                raise AssertionError(f'{run}: fused_char_head launched at '
                                     f'{chars}, not {lines} lines')
            shapes['fused_monochrome'] |= set(mono)
            shapes['fused_char_head'] |= set(chars)

        # each per-shard shape against the plain version, on each card,
        # and timed on the first
        times = {}
        with backend_flags('highest'):
            for dev in distinct:
                mw = [w.to(dev) for w in mono_w]
                cw = [w.to(dev) for w in char_w]
                mono_prep = kernels.prepare_monochrome(*mw)
                char_prep = kernels.prepare_char_head(*cw)
                for b, h, w in sorted(shapes['fused_monochrome']):
                    x = torch.tensor(rng.random((b, h, w, 1),
                                                dtype=np.float32),
                                     device=dev)
                    with on_device(dev):
                        errors['fused_monochrome'] = max(
                            errors['fused_monochrome'], compare(
                                f'fused_monochrome {(b, h, w, 1)} on {dev}',
                                kernels.fused_monochrome(x, mono_prep),
                                kernels.fused_monochrome_reference(x, *mw),
                                MONO_TOL))
                        if dev == distinct[0]:
                            t = {'ms': cuda_ms(lambda: kernels.fused_monochrome(
                                     x, mono_prep)),
                                 'plain_ms': cuda_ms(
                                     lambda: kernels.fused_monochrome_reference(
                                         x, *mw))}
                            t['bound_ms'], t['bound_by'] = bound_ms(
                                2 * 4 * x.numel()
                                + 4 * sum(v.numel() for v in mw),
                                2 * (9 * 16 + 9 * 16) * x.numel())
                            times[f'fused_monochrome {(b, h, w, 1)}'] = t
                for n, w in sorted(shapes['fused_char_head']):
                    x = char_inputs(params, rng, n, w).to(dev)
                    with on_device(dev):
                        errors['fused_char_head'] = max(
                            errors['fused_char_head'], compare(
                                f'fused_char_head {(n, w, 64)} on {dev}',
                                kernels.fused_char_head(x, char_prep),
                                kernels.fused_char_head_reference(x, *cw),
                                CHAR_TOL))
                        if dev == distinct[0]:
                            t = {'ms': cuda_ms(lambda: kernels.fused_char_head(
                                     x, char_prep)),
                                 'plain_ms': cuda_ms(
                                     lambda: kernels.fused_char_head_reference(
                                         x, *cw))}
                            n_cols = n * w
                            flops = 2 * n_cols * (512 * 1024 + 1024 * 128
                                                  + 128 * 162)
                            t['bound_ms'], t['bound_by'] = bound_ms(
                                4 * (x.numel() + n_cols * cw[2].shape[1]
                                     + sum(v.numel() for v in cw)),
                                3 * flops, TF32_FLOPS)
                            times[f'fused_char_head {(n, w, 64)}'] = t
        for shape, t in times.items():
            print(f'  {shape} per shard on {distinct[0]}: {json.dumps(t)}',
                  flush=True)
        summary['kernel_times'] = times

        with backend_flags('highest'):
            summary['steps'] = mesh_steps(mesh, devices, weights, pages, rng)

        rates = {}
        for run, pipeline in (('host', unsharded['host'][0]),
                              ('mesh host', s_host),
                              ('fused', unsharded['fused'][0]),
                              ('mesh fused', s_fused)):
            want = unsharded[run.split()[-1]][2]
            rates[run] = timed_runs(pipeline, pages, run, want)[0]
        summary['pages_per_s'] = rates
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s_fused.ocr_pages(pages)
        torch.cuda.synchronize()
        summary['peak_gib'] = torch.cuda.max_memory_allocated() / 2**30
    print(f'mesh_path on {card}, {label}: {json.dumps(summary)}', flush=True)
    return launches, errors


def main():
    mesh_only = sys.argv[1:] == ['--mesh']
    if sys.argv[1:] and not mesh_only:
        print('usage: chip_smoke.py [--mesh]', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this run '
              'needs a CUDA card', file=sys.stderr)
        return 1

    from univer_ocr_tpu_torch.models.bucketing import CHAR_WIDTH_MENU
    # the paths' Char head shapes at every width bucket, one line of 64
    # columns (far fewer tiles than SMs) and a ragged one
    char_shapes = [(n, w) for n in (HOST_LINES, DEVICE_LINES)
                   for w in CHAR_WIDTH_MENU] + [(1, 64), (3, 37)]
    from univer_ocr_tpu_torch import native
    from univer_ocr_tpu_torch.models.fastpath import char_head_conv
    from univer_ocr_tpu_torch.models.pipeline import OCRPipeline
    from univer_ocr_tpu_torch.ops import kernels
    from univer_ocr_tpu_torch.ops.kernels import _build
    from univer_ocr_tpu_torch.ops.precision import backend_flags
    from univer_ocr_tpu_torch.weights import (DEFAULT_CHECKPOINT,
                                              load_checkpoint)

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
        # the host library's g++ beside the kernels' nvcc
        with ThreadPoolExecutor(1) as pool:
            host_build = pool.submit(native.build)
            info = _build.build()
            host_info = host_build.result()
        print(f'build: native host CV (g++) {host_info["seconds"]:.2f} s -> '
              f'{host_info["path"].name}', flush=True)
        native.library()
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
    with np.load(FIXTURE) as f:
        fixture_pages = f['pages']
        # the host cascade's text: every device mode computes its crops
        # and line plans
        expected = json.loads(str(f['texts']))
    pages = [fixture_pages[i % len(fixture_pages)][None, :, :, None]
             for i in range(CHUNK)]
    fixture_list = pages[:len(fixture_pages)]

    def pipeline(precision, chunk=CHUNK, **kwargs):
        return OCRPipeline(PAGE_SHAPE, weights=params, chunk=chunk,
                           workers=8, collapse_runs=4, precision=precision,
                           device='cuda', **kwargs)

    def ok_line():
        print(card, flush=True)
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': kind,
            'count': torch.cuda.device_count()}}), flush=True)

    with open(DEFAULT_CHECKPOINT) as fp:
        committed = json.load(fp)
    if mesh_only:
        with pipeline('highest') as host, \
                pipeline('highest', **FUSED_MODE) as fused, \
                phase('mesh_path'):
            mesh_path(card, params, committed, pages, {
                'host': (host, host.ocr_pages(pages), expected),
                'fused': (fused, fused.ocr_pages(pages), expected)},
                mono_w, char_w, rng)
        ok_line()
        return 0

    with phase('kernels'), backend_flags('highest'):
        err = 0.0
        # a chunk, one page (the single-page chain) and a ragged shape
        for shape in [(CHUNK,) + PAGE_SHAPE[1:], PAGE_SHAPE,
                      (2, 100, 203, 1)]:
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
        with pipeline('highest', **FUSED_MODE) as planner:
            components = compare_plans(planner, fixture_list)

    with phase('band_ccl'):
        band_ccl_ms = band_ccl_check(rng)

    def kernels_launched(label):
        for name in ('fused_monochrome', 'fused_char_head', 'band_ccl'):
            if launches[label].get(name, 0) < 1:
                raise AssertionError(f'{name} did not launch on {label}')

    launches = {}
    with pipeline('highest') as host, \
            pipeline('highest', **DEVICE_CASCADE) as device, \
            pipeline('highest', **TABLES_MODE) as tables, \
            pipeline('highest', **FUSED_MODE) as fused:
        with phase('path'):
            results, launches['path'], widths = counted_run(host, pages)
            print(f'path launches: {launches["path"]}; fused_char_head by '
                  f'width: {widths}', flush=True)
            check_text('path', results, expected)
            unsharded = {'host': (host, results, expected)}
            for name in ('fused_monochrome', 'fused_char_head'):
                if launches['path'].get(name, 0) < 1:
                    raise AssertionError(f'{name} did not launch on the path')

        with phase('host_native'):
            host_native(card, host, pages, expected)

        with phase('device_path'):
            results, launches['device_path'], line_widths = counted_run(
                device, pages)
            print(f'device_path launches: {launches["device_path"]}; '
                  f'fused_char_head by width: {line_widths}', flush=True)
            check_text('device_path', results, expected)
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
                  f'{syncs_per_chunk(tables.host_syncs, 1)} per chunk',
                  flush=True)
            check_text('tables_path', results, expected)
            kernels_launched('tables_path')

        with phase('fused_path'):
            if not (fused.fused_tail and fused._device_planner):
                raise AssertionError('the default pipeline is not fused')
            fused.host_syncs.clear()
            results, launches['fused_path'], fused_widths = counted_run(
                fused, pages)
            print(f'fused_path launches: {launches["fused_path"]}; '
                  f'fused_char_head by width: {fused_widths}', flush=True)
            print(f'fused_path escalation_stats: '
                  f'{json.dumps(fused.escalation_stats)}', flush=True)
            print(f'fused_path host syncs: {dict(fused.host_syncs)}, '
                  f'{syncs_per_chunk(fused.host_syncs, 1)} per chunk',
                  flush=True)
            check_text('fused_path', results, expected)
            unsharded['fused'] = (fused, results, expected)
            kernels_launched('fused_path')
            if fused.escalation_stats.get('chain_fallback', 0):
                raise AssertionError('fused_path: a page left the device '
                                     'planner')
            sync_census(fused, pages, 'fused')
            # three chunks in flight (the dispatcher runs one chunk ahead
            # of the collect, and the queue holds two): the device memory
            # they take, the fused Char head's workspace included
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            three = fused.ocr_pages(pages * 3)
            torch.cuda.synchronize()
            print(f'fused_path, 3 chunks in one call: peak device memory '
                  f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB '
                  f'allocated, {torch.cuda.max_memory_reserved() / 2**30:.3f}'
                  f' GiB reserved', flush=True)
            check_text('fused_path, 3 chunks', three, expected, 3 * CHUNK)
            # the chunk planner's per-page fallback: its cap cut to the
            # fewest components of a fixture page, so that in one chunk
            # the pages with more are planned on the host beside pages
            # planned on the card
            with pipeline('highest', **FUSED_MODE) as cut:
                cut.CHUNK_PLAN_K = min(components)
                over = [components[i % len(components)] > cut.CHUNK_PLAN_K
                        for i in range(CHUNK)]
                results, launches['fused_fallback'], _ = counted_run(
                    cut, pages)
                fell = cut.escalation_stats.get('chain_fallback', 0)
            print(f'fused_path, chunk planner cut to {min(components)} '
                  f'components (pages have {components}): {fell} pages '
                  f'planned on the host, launches '
                  f'{launches["fused_fallback"]}', flush=True)
            if not 0 < fell == sum(over) < CHUNK:
                raise AssertionError(f'fused_path: {fell} pages fell back, '
                                     f'{sum(over)} expected')
            check_text('fused_path with fallbacks', results, expected)
            kernels_launched('fused_fallback')

        with phase('chain_path'):
            fused.host_syncs.clear()
            fell_back = []
            launches['chain_path'] = Counter()
            results = []
            chain_widths = Counter()
            for page in fixture_list:
                before = fused.escalation_stats.get('chain_fallback', 0)
                result, counts, page_widths = counted_run(fused, [page])
                results.extend(result)
                launches['chain_path'].update(counts)
                chain_widths.update(page_widths)
                fell_back.append(
                    fused.escalation_stats.get('chain_fallback', 0) > before)
            launches['chain_path'] = dict(launches['chain_path'])
            chain_widths = dict(sorted(chain_widths.items()))
            print(f'chain_path launches: {launches["chain_path"]}; '
                  f'fused_char_head by width: {chain_widths}', flush=True)
            print(f'chain_path escalation_stats: '
                  f'{json.dumps(fused.escalation_stats)}', flush=True)
            print(f'chain_path host syncs: {dict(fused.host_syncs)}',
                  flush=True)
            print(f'chain_path fallbacks {fell_back}', flush=True)
            check_text('chain_path', results, expected, len(fixture_list))
            kernels_launched('chain_path')
            if any(fell_back):
                raise AssertionError('chain_path: a fixture page fell back '
                                     'to the host planner')
            sync_census(fused, fixture_list, 'chain', single=True)
            # the chain's not-ok fallback: 48 components (more than the
            # chain's 2 * DEVICE_BATCH) send the page through the
            # host-planned fused dispatch; its text must be the
            # device-planned chunk path's (48 fit CHUNK_PLAN_K)
            grid = blob_grid(6, 8)
            before = fused.escalation_stats.get('chain_fallback', 0)
            single, launches['chain_fallback'], _ = counted_run(
                fused, [grid])
            fell = fused.escalation_stats.get('chain_fallback', 0) - before
            chunked = fused.ocr_pages([grid, np.ones_like(grid)])[0]
            print(f'chain_path, 48-blob page: fallbacks {fell}, '
                  f'{len(single[0])} paragraphs alone, {len(chunked)} in a '
                  f'chunk, equal {single[0] == chunked}, launches '
                  f'{launches["chain_fallback"]}', flush=True)
            if fell != 1 or single[0] != chunked or len(chunked) != 48:
                raise AssertionError('chain_path: the 48-blob page did not '
                                     'fall back to the chunk path\'s text')
            kernels_launched('chain_fallback')

        with phase('reference_path'):
            reference_path(lambda: pipeline('bf16', **FUSED_MODE))

        with phase('serve_path'):
            launches['serve_path'], serve_err = serve_path(
                card, mono_prep, mono_w, rng)
            errors['fused_monochrome'] = max(errors['fused_monochrome'],
                                             serve_err)

        with phase('groundtruth_path'):
            gt_launches, gt_err = groundtruth_path(
                params, committed, char_prep, char_w, rng)
            launches.update(gt_launches)
            errors['fused_char_head'] = max(errors['fused_char_head'],
                                            gt_err)

        with phase('train_path'):
            launches['train_path'] = train_path(expected, fixture_list)
            if any(launches['train_path'].values()):
                raise AssertionError('train_path launched a kernel: '
                                     f'{launches["train_path"]}')

        with phase('nn_batteries'):
            nn_batteries(card, committed)

        with phase('batched_train_path'):
            launches['batched_train_path'], batched_errors = (
                batched_train_path(committed, params, mono_prep, char_prep,
                                   mono_w, char_w, rng))
            for name, err in batched_errors.items():
                errors[name] = max(errors[name], err)

        with phase('mesh_path'):
            mesh_launches, mesh_errors = mesh_path(
                card, params, committed, pages, unsharded, mono_w, char_w,
                rng)
            launches.update(mesh_launches)
            for name, err in mesh_errors.items():
                errors[name] = max(errors[name], err)

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
                       for w in set(line_widths) | set(table_widths)
                       | set(fused_widths) | set(chain_widths)}):
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
            # form) beside the kernel at the line stage's and the fused
            # tail's shapes
            for width, n in sorted((Counter(table_widths)
                                    + Counter(fused_widths)).items()):
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
            decode_timing(rng)
            rates = {'host highest': timed_runs(host, pages, 'host highest',
                                                expected),
                     'device highest': timed_runs(device, pages,
                                                  'device highest', expected),
                     'tables highest': timed_runs(tables, pages,
                                                  'tables highest', expected),
                     'fused highest': timed_runs(fused, pages,
                                                 'fused highest', expected)}
            for label, kwargs in (('host bf16', {}),
                                  ('device bf16', DEVICE_CASCADE),
                                  ('tables bf16', TABLES_MODE),
                                  ('fused bf16', FUSED_MODE)):
                with pipeline('bf16', **kwargs) as pl:
                    rates[label] = timed_runs(pl, pages, label, expected)
            print('pages/s ' + json.dumps(
                {label: r[0] for label, r in rates.items()}), flush=True)
            for label, pl in (('host', host), ('device', device),
                              ('tables', tables), ('fused', fused)):
                profile_window(pl, pages, label)
            for label, pl in (('device', device), ('tables', tables)):
                sync_census(pl, pages, label)
            latency = {}
            for precision in ('highest', 'bf16'):
                with pipeline(precision, **FUSED_MODE) as chain, \
                        pipeline(precision, chunk=1, **TABLES_MODE) as one:
                    latency[f'chain {precision}'] = single_page_latency(
                        chain, fixture_list, f'chain {precision}')
                    latency[f'tables chunk 1 {precision}'] = (
                        single_page_latency(one, fixture_list,
                                            f'tables chunk 1 {precision}'))
            print('single-page latency ms ' + json.dumps(latency),
                  flush=True)

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

    char = char_mix(DEVICE_LINES, fused_widths, 'fused path')
    chain_char = char_mix(DEVICE_LINES, chain_widths, 'chain path')
    tables_char = char_mix(DEVICE_LINES, table_widths, 'tables path')
    device_char = char_mix(DEVICE_LINES, line_widths, 'device path')
    host_char = char_mix(HOST_LINES, widths, 'host path')
    by_path = {name: {path: counts.get(name, 0)
                      for path, counts in launches.items()}
               for name in ('fused_monochrome', 'fused_char_head',
                            'band_ccl')}
    print('kernels ' + json.dumps({
        name: {'launches': by_path[name],
               'max_abs_err': errors.get(name, 0.0)}
        for name in by_path}), flush=True)
    print(json.dumps({'kernels': [
        {'name': 'fused_monochrome', 'route': 'cuda',
         'source': 'univer_ocr_tpu_torch/csrc/fused_monochrome.cu',
         'replaces': 'univer_ocr_tpu/ops/pallas/fused_conv.py:87',
         'launches': by_path['fused_monochrome']['fused_path'],
         'launches_by_path': by_path['fused_monochrome'],
         'max_abs_err': errors['fused_monochrome'],
         'ms': mono['ms'], 'plain_ms': mono['plain_ms'],
         'bound_ms': mono['bound_ms'], 'bound_by': mono['bound_by'],
         'bound_ffma_ms': mono['bound_ffma_ms'], 'library_ms': None},
        {'name': 'fused_char_head', 'route': 'cuda',
         'source': 'univer_ocr_tpu_torch/csrc/char_head.cu',
         'replaces': 'univer_ocr_tpu/ops/pallas/char_head.py:61',
         'launches': by_path['fused_char_head']['fused_path'],
         'launches_by_path': by_path['fused_char_head'],
         'max_abs_err': errors['fused_char_head'],
         'ms': char['ms'], 'plain_ms': char['plain_ms'],
         'bound_ms': char['bound_ms'], 'bound_by': char['bound_by'],
         'bound_ffma_ms': char['bound_ffma_ms'], 'library_ms': None,
         'widths': char['widths'], 'chain_path': chain_char,
         'tables_path': tables_char, 'device_path': device_char,
         'host_path': host_char},
        {'name': 'band_ccl', 'route': 'cuda',
         'source': 'univer_ocr_tpu_torch/csrc/band_ccl.cu',
         'replaces': None,
         'launches': by_path['band_ccl']['fused_path'],
         'launches_by_path': by_path['band_ccl'],
         'ms_by_shape': band_ccl_ms},
    ]}), flush=True)
    ok_line()
    return 0


if __name__ == '__main__':
    sys.exit(main())
