"""Profiling utilities (univer_ocr_tpu/utils/profiling.py).

  * `device_trace(dir)`: a `torch.profiler` window over the CPU and, when
    there is a card, its CUDA work; on exit the trace is written as a
    Chrome trace under `dir` and the profiler is returned for
    `key_averages()`;
  * `StageTimers`: named cumulative wall-clock timers for the pipeline's
    stages (`OCRPipeline.timers`), and counters added beside them.
    Stages run on several threads at once, so a total can exceed the
    wall time it overlaps.
"""

import contextlib
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch


@contextlib.contextmanager
def device_trace(log_dir='generated_files/torch_trace'):
    """Profile the block; yields the `torch.profiler.profile` object and
    writes `trace.json` (chrome://tracing, Perfetto) under `log_dir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(log_dir / 'trace.json'))


class StageTimers:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def track(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                self.totals[name] += elapsed
                self.counts[name] += 1

    def add(self, name, value):
        """Count `value` under `name` beside the spans: a quantity that is
        no wall interval (the pipeline's `host_cv_thread_cpu` seconds and
        `line_plan_components`)."""
        with self._lock:
            self.totals[name] += value
            self.counts[name] += 1

    def summary(self):
        return {
            name: {'total_s': round(self.totals[name], 4),
                   'count': self.counts[name],
                   'mean_ms': round(1e3 * self.totals[name]
                                    / max(1, self.counts[name]), 3)}
            for name in self.totals
        }
