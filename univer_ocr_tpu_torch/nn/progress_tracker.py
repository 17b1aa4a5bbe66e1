"""Per-layer event timing of the trainer (the parts of
univer_ocr_tpu/nn/progress_tracker.py that Trainer and train_model call).

`ProgressTracker` keeps one cumulative `time.perf_counter` timer per
(layer, event) and calls `handler(event_name, summary)` on every start
and stop; the summary has the JAX package's schema,
`{layer: [{name, done, started, stopped, time, counter}, ...]}`.  On the
card a timed span is host time: a step's device work is waited out by
its loss reads.
"""

import time
from datetime import datetime, timedelta
from functools import wraps


class Event:
    """Cumulative timer for one (layer, event) pair."""

    __slots__ = ('name', 'done', 'started', 'stopped', 'counter',
                 '_seconds', '_t0')

    def __init__(self, name):
        self.name = name
        self.reset()

    def reset(self):
        self.done = False
        self.started = None
        self.stopped = None
        self.counter = 0
        self._seconds = None
        self._t0 = None

    def start(self):
        self.done = False
        self.started = datetime.now()
        self._t0 = time.perf_counter()

    def stop(self):
        elapsed = time.perf_counter() - self._t0
        self._seconds = elapsed + (self._seconds or 0.0)
        self.stopped = datetime.now()
        self.done = True
        self.counter += 1

    @property
    def time(self):
        if self._seconds is None:
            return None
        return timedelta(seconds=self._seconds)

    def to_dict(self):
        return {field: getattr(self, field)
                for field in ('name', 'done', 'started', 'stopped',
                              'time', 'counter')}


class BaseProgressTracker:
    """No-op default."""

    def __init__(self, *args, **kwargs):
        pass

    def register_layer(self, name):
        pass

    def get_summary(self):
        return {}

    def start_tracking(self, name, event):
        pass

    def stop_tracking(self, name, event):
        pass

    def message(self, message, data=None):
        pass

    def reset(self):
        pass


class ProgressTracker(BaseProgressTracker):
    """Tracks (layer, event) timings in a flat dict; every start and stop
    fires `handler(event_name, summary)` with the whole summary."""

    def __init__(self, handler=print):
        self.handler = handler
        self._events = {}          # (layer, event_name) -> Event
        self._layer_order = []     # layers in registration/first-use order

    def register_layer(self, name):
        if name not in self._layer_order:
            self._layer_order.append(name)

    def get_summary(self):
        summary = {name: [] for name in self._layer_order}
        for (layer, _), event in self._events.items():
            summary[layer].append(event.to_dict())
        return summary

    def _event(self, name, event):
        self.register_layer(name)
        key = (name, event)
        if key not in self._events:
            self._events[key] = Event(event)
        return self._events[key]

    def start_tracking(self, name, event):
        self._event(name, event).start()
        self.handler(event, self.get_summary())

    def stop_tracking(self, name, event):
        self._event(name, event).stop()
        self.handler(event, self.get_summary())

    def message(self, message, data=None):
        self.handler(message, data)

    def reset(self):
        self.handler('reset')
        for event in self._events.values():
            event.reset()


def track_method(event):
    """Time a method of an object exposing .progress_tracker and .name."""
    def decorator(func):
        @wraps(func)
        def wrapper(self, *args, **kwargs):
            tracker = self.progress_tracker
            tracker.start_tracking(self.name, event)
            try:
                return func(self, *args, **kwargs)
            finally:
                tracker.stop_tracking(self.name, event)
        return wrapper
    return decorator


def track_function(name, event, progress_tracker):
    """Time a free function; the identity decorator when the tracker is
    None."""
    if progress_tracker is None:
        return lambda func: func
    progress_tracker.register_layer(name)

    def decorator(func):
        @wraps(func)
        def wrapper(*args, **kwargs):
            progress_tracker.start_tracking(name, event)
            try:
                return func(*args, **kwargs)
            finally:
                progress_tracker.stop_tracking(name, event)
        return wrapper
    return decorator
