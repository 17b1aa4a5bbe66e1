"""What a `--trace 1` run reads besides its end-to-end numbers.

  * `span_timers(log)`: the program's own `StageTimers`, whose every span
    is also logged as (name, start, end) on the host clock, from every
    thread (the profiler records annotations of its own thread only), so
    that the device trace can say what the host was doing;
  * `ProfilerWindow`: a `torch.profiler` window over the CPU and the
    cards, opened and closed by the loop at call boundaries, reduced in
    memory to device time by kernel name, the busy time of each card (the union of its
    operations), and the breakdown: the device operations that took most
    time and the idle time of the cards by the innermost host range open
    in the middle of each gap.  No trace file is written.
"""

import contextlib
import time
from collections import defaultdict


def span_timers(log):
    """StageTimers that also append (name, start, end) to `log`."""
    from univer_ocr_tpu_torch.utils.profiling import StageTimers

    class SpanTimers(StageTimers):
        @contextlib.contextmanager
        def track(self, name):
            start = time.perf_counter()
            try:
                with super().track(name):
                    yield
            finally:
                log.append((name, start, time.perf_counter()))

    return SpanTimers()


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


def _label_gaps(gaps, ranges):
    """Idle seconds by the innermost host range open at each gap's middle
    (one sweep over the ranges' starts and ends)."""
    events = sorted([(s, 0, i) for i, (s, _, _) in enumerate(ranges)]
                    + [(t, 2, i) for i, (_, t, _) in enumerate(ranges)]
                    + [((a + b) / 2, 1, k) for k, (a, b) in enumerate(gaps)])
    active, out = {}, defaultdict(float)
    for _, kind, i in events:
        if kind == 0:
            s, t, name = ranges[i]
            active[i] = (t - s, name)
        elif kind == 2:
            active.pop(i, None)
        else:
            a, b = gaps[i]
            label = (min(active.values())[1] if active
                     else 'outside the program spans')
            out[label] += (b - a) * 1e-6
    return out


class ProfilerWindow:
    """One profiler window; `start()` / `stop()` at boundaries the loop
    chooses, then `reduce()`."""

    def __init__(self, devices, spans=()):
        self.devices = devices
        self.spans = spans
        self.prof = None
        self.t_start = self.t_stop = None
        self.done = False

    def start(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.devices[0].type == 'cuda':
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            for d in self.devices:
                torch.cuda.synchronize(d)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        # one range on this thread ties the profiler's clock to the host's
        with torch.profiler.record_function('bench_clock'):
            self.mark = time.perf_counter()
        self.t_start = time.perf_counter()

    def stop(self):
        import torch
        if self.devices[0].type == 'cuda':
            for d in self.devices:
                torch.cuda.synchronize(d)
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.done = True

    @property
    def active(self):
        return self.prof is not None and not self.done

    def reduce(self, top=10):
        """-> {'window_s', 'busy_s' (mean over the cards), 'busy_by_device',
        'kernels' {name: s}, 'breakdown'}."""
        from torch.autograd import DeviceType
        window_s = self.t_stop - self.t_start
        kernels = defaultdict(float)
        by_dev = defaultdict(list)
        offset = None
        for e in self.prof.events():
            annot = bool(getattr(e, 'is_user_annotation', False))
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if annot or e.name == 'bench_clock' or e.name.startswith(
                        'gpu_user_annotation'):
                    continue
                kernels[e.name] += (t - s) * 1e-6
                by_dev[e.device_index].append((s, t))
            elif e.name == 'bench_clock':
                offset = s - self.mark * 1e6
        ranges = [] if offset is None else [
            (a * 1e6 + offset, b * 1e6 + offset, name)
            for name, a, b in list(self.spans)
            if b >= self.t_start and a <= self.t_stop]
        busy, gap_list = {}, []
        for dev, iv in by_dev.items():
            total, merged = _union(iv)
            busy[dev] = total * 1e-6
            gap_list.extend((e0, s1) for (_, e0), (s1, _)
                            in zip(merged, merged[1:]))
        gaps = _label_gaps(gap_list, ranges)
        n = max(1, len(self.devices))
        ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {'window_s': window_s,
                'busy_s': sum(busy.values()) / n,
                'busy_by_device': {str(k): v for k, v in sorted(busy.items())},
                'kernels': dict(kernels),
                'breakdown': {'device_ops': [[k, v] for k, v in ops],
                              'idle_gaps': [[k, v] for k, v in idle]}}

