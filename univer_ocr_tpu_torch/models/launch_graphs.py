"""CUDA graphs of the device cascade's fixed-shape launch chains.

A paragraph launch (OCRPipeline.paragraph_launch) and the chunk planner
(OCRPipeline.chunk_planner) are chains of 1,100-1,300 small PyTorch ops
and kernel launches each, with fixed shapes, no host sync and Python
loops over constants only.  Dispatched one op at a time they cost the
host about 14 us an op, so the dispatcher, not the card, set the pace of
the serving default.  Here each chain is captured once per key (its name,
its static arguments, the shapes and types of its tensor arguments and
the pipeline's mode) as a CUDA graph, and replayed after.

  * Static inputs: a graph reads its tensor arguments from buffers that
    live as long as the graphs, one per (chain, argument, shape, type)
    (`stage`).  A caller copies into them on the stream; the copy, the
    replay that reads it and the next copy run in stream order.
  * Outputs: a graph writes its outputs to the same memory at every
    replay, so each replay's outputs are copied out on the device at once,
    and the copies are what the caller gets.
  * Memory: a pipeline's graphs capture into one memory pool, so their
    working memory is that of its largest chain once, not once a key.
    That is safe because a replay and the copy of its outputs are queued
    together under `lock`: a replay may overwrite another graph's memory
    only after that graph's outputs were copied.  The pool goes with the
    pipeline's graphs (OCRPipeline.close drops them).
  * Capture, at a key's first use: first the cached memory that a
    capture could not free is released (a capture that runs out of memory
    fails; the pools of closed pipelines' graphs are freed only so).  Then
    the chain runs once eagerly on the caller's stream (its lazy set-up,
    such as tables copied to the card from pageable memory, which a
    capture may not do; its memory returns to what the pipeline's eager
    work reuses), and is captured on a stream of its own in 'thread_local'
    mode, so that the transfer threads may go on waiting on events.
    `lock` is held meanwhile; the pipeline's other launching path (the
    line stage's relaunches on the pool threads) takes it too.
  * The kernels' launch counters (ops/kernels) are bumped in Python where
    a wrapper launches.  The warm-up and the capture launch nothing that a
    caller reads, so their counts are taken back, and every replay adds
    the counts of the launches its graph holds.

A pipeline's buffers serve one launching thread at a time: the pipeline
launches its chains from its dispatcher thread, or from the caller's for
a single page, one `ocr_pages` call at a time.
"""

import collections
import threading

import numpy as np
import torch

from ..ops.kernels import _build
from ..ops.kernels.band_ccl import SHAPE_LAUNCHES as _BAND_CCL_SHAPES
from ..ops.kernels.char_head import SHAPE_LAUNCHES as _CHAR_HEAD_SHAPES
from ..ops.kernels.char_head import WIDTH_LAUNCHES as _CHAR_HEAD_WIDTHS
from ..ops.kernels.fused_monochrome import SHAPE_LAUNCHES as _MONO_SHAPES

#: every launch counter of the kernels' wrappers
LAUNCH_COUNTERS = (_build.LAUNCHES, _build.DEVICE_LAUNCHES, _BAND_CCL_SHAPES,
                   _CHAR_HEAD_SHAPES, _CHAR_HEAD_WIDTHS, _MONO_SHAPES)


def _snapshot():
    with _build.COUNT_LOCK:
        return [collections.Counter(c) for c in LAUNCH_COUNTERS]


def _copy(out):
    """The tensors of a chain's (nested tuple) result, copied."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, tuple):
        return tuple(_copy(o) for o in out)
    return out


class LaunchGraphs:
    """The CUDA graphs of one pipeline's launch chains on `device`."""

    def __init__(self, device):
        self.device = device
        #: held by a capture, a replay and the copy of its outputs, and
        #: by any other thread of the pipeline that launches
        self.lock = threading.Lock()
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(device)
        self._buffers = {}
        self._graphs = {}

    def stage(self, name, position, src):
        """The static buffer of argument `position` of chain `name` for
        src's shape and type, with `src` copied in: a tensor on the card,
        or a host array, copied from pinned memory without waiting for
        the card.  A buffer passed as `src` is returned as it is."""
        if isinstance(src, np.ndarray):
            src = torch.from_numpy(np.ascontiguousarray(src))
        key = (name, position, tuple(src.shape), src.dtype)
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = torch.empty(
                src.shape, dtype=src.dtype, device=self.device)
        if src is not buf:
            if src.device.type == 'cpu':
                src = src.pin_memory()
            buf.copy_(src, non_blocking=True)
        return buf

    def launch(self, name, fn, args, statics=(), mode=()):
        """fn(*args, *statics) replayed from its graph, captured first if
        the key is new; `args` are tensors or host arrays, staged as
        `stage` stages them, `statics` and `mode` hashable values that fix
        the chain.  Returns (the outputs, copied; whether this call
        captured)."""
        args = tuple(self.stage(name, i, a) for i, a in enumerate(args))
        key = (name, statics, mode,
               tuple((tuple(a.shape), a.dtype) for a in args))
        with self.lock:
            entry = self._graphs.get(key)
            captured = entry is None
            if captured:
                entry = self._graphs[key] = self._capture(fn, args + statics)
            graph, out, counts = entry
            graph.replay()
            out = _copy(out)
        with _build.COUNT_LOCK:
            for counter, delta in zip(LAUNCH_COUNTERS, counts):
                counter.update(delta)
        return out, captured

    def _capture(self, fn, args):
        """(graph, its static outputs, the launch counts it holds); the
        caller holds `lock`."""
        # as torch.cuda.graph does before a capture, which cannot free
        torch.cuda.empty_cache()
        before = _snapshot()
        fn(*args)
        warm = _snapshot()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool,
                                capture_error_mode='thread_local')
            try:
                out = fn(*args)
            finally:
                graph.capture_end()
        after = _snapshot()
        with _build.COUNT_LOCK:
            for counter, b, a in zip(LAUNCH_COUNTERS, before, after):
                for k, n in (a - b).items():
                    counter[k] -= n
                    if counter[k] <= 0:
                        del counter[k]
        return graph, out, [a - w for a, w in zip(after, warm)]
