"""Host-side synthetic page feed (univer_ocr_tpu/models/
train_data_generator.py).

  * `render_page` renders one page (the placement loop, an optional
    whole-page rotation, padding to /16), drawing from an explicit
    `random.Random`;
  * `DataGenerator` is the parallel feed: render processes with their own
    seeded streams (worker i draws from `seed + 977 * i`, the JAX
    package's streams) and a bounded queue for backpressure.

The feed's processes are spawned, not forked: the parent holds torch's
thread pools and may hold a CUDA context, which a forked child would
inherit half-initialised.  A spawned child imports only the task's module
and this one, so the task must be a module-level function; it is called
as `task(*args, rng=rng, **kwargs)` with the worker's `random.Random`.
Workers never touch the card.  Pillow is imported where a page is
rendered, so this module (and a Pillow-free task) imports without it.
"""

import functools
import json
import multiprocessing
import os
import random
from queue import Empty, Full

import numpy as np

from .constants import LAYER_NAMES_PLAIN
from .datasets import encode_layers as encode_planes

PAGE_BACKGROUND = (255, 255, 255, 255)
#: placement attempts per round before re-checking that anything landed
PLACEMENT_ROUND = 100
#: the distance between two workers' seeds (the JAX package's)
WORKER_SEED_STRIDE = 977
#: seconds `stop` waits for each worker before terminating it
STOP_TIMEOUT = 2.0


def render_page(width, height, rotate=False, min_font=12, max_font=36, *,
                rng):
    """Render one synthetic page: random paragraphs are placed in rounds
    of PLACEMENT_ROUND collision-checked attempts until at least one
    fits, then the page is optionally rotated and padded to /16.  Every
    draw comes from `rng` (a `random.Random`), in the JAX package's
    order.  Returns the raw {layer_name: PIL image} dict."""
    from ..image_generator import LayeredImage, random_font, random_text
    page = LayeredImage(width, height, PAGE_BACKGROUND, rng)
    attempts = 0
    while True:
        page.add_paragraph(random_text(rng), random_font(rng, min_font,
                                                          max_font))
        attempts += 1
        if attempts % PLACEMENT_ROUND == 0 and page.paragraphs_added > 0:
            break
    if rotate:
        page = page.rotate(rng.uniform(0, 360))
    return page.make_divisible_by(16, 16).get_raw()


def generate_picture(width, height, rotate=False, *, rng):
    """render_page under its run.py name."""
    return render_page(width, height, rotate, rng=rng)


def encode_layers(images):
    """{layer_name: PIL image} -> {tag: (1, H, W, C) float64 array in
    [0, 1]}, channels stacked in LAYER_NAMES order per tag (each image
    taken as 8-bit gray)."""
    return encode_planes({name: np.asarray(image.convert('L'))
                          for name, image in images.items()
                          if name in LAYER_NAMES_PLAIN})


def generate_train_data(width, height, rotate=False, *, rng):
    """A rendered page as encoded tag arrays (the default worker task)."""
    return encode_layers(render_page(width, height, rotate, rng=rng))


@functools.lru_cache(maxsize=1)
def _layers_file(path):
    with np.load(path) as f:
        return json.loads(str(f['layer_names'])), f['layers']


def replay_pages(path, *, rng):
    """A page of a layers file (uint8 `layers` (N, L, H, W) and their
    `layer_names`, as fixtures/eval_layers.npz), drawn from `rng`: the
    feed's task where no page can be rendered.  Returns (its index, its
    encoded tag arrays)."""
    names, layers = _layers_file(str(path))
    index = rng.randrange(len(layers))
    page = layers[index]
    return index, encode_planes({name: plane
                                 for name, plane in zip(names, page)
                                 if name in LAYER_NAMES_PLAIN})


def _feed_worker(stop, sink, seed, task, args, kwargs):
    """Render loop of one feed process: draw from this worker's own
    stream, produce into the bounded queue until told to stop.  A full
    queue blocks production: that is the backpressure."""
    rng = random.Random(seed)
    np.random.seed(seed % (2 ** 31))
    # items still in this process's pipe buffer must not hold up its exit
    # once the consumer stopped reading
    sink.cancel_join_thread()
    item = None
    while not stop.is_set():
        if item is None:
            item = task(*args, rng=rng, **kwargs)
        try:
            sink.put(item, timeout=0.2)
        except Full:
            continue
        item = None


class DataGenerator:
    """Parallel page feed with bounded buffering.

    `workers` spawned processes (default: one per CPU, capped by the
    buffer size) stream `generator_func(*func_args, rng=rng,
    **func_kwargs)` results into a queue of `queue_size` slots.  Worker i
    draws from `random.Random(seed + 977 * i)` (`self.seeds`); without a
    seed the base comes from OS entropy.  `stop()` ends the processes.
    """

    def __init__(self, queue_size=None, generator_func=generate_train_data,
                 func_args=(), func_kwargs=None, workers=None, seed=None):
        self.queue_size = queue_size or os.cpu_count()
        n_workers = min(workers or os.cpu_count(), self.queue_size)
        context = multiprocessing.get_context('spawn')
        self.done = context.Event()
        self.data_queue = context.Queue(maxsize=self.queue_size)
        if seed is None:
            seed = int.from_bytes(os.urandom(4), 'little')
        self.seeds = [seed + WORKER_SEED_STRIDE * i for i in range(n_workers)]
        self.workers = [
            context.Process(target=_feed_worker, daemon=True,
                            args=(self.done, self.data_queue, worker_seed,
                                  generator_func, func_args,
                                  func_kwargs or {}))
            for worker_seed in self.seeds
        ]

    # -- lifecycle ----------------------------------------------------
    def start(self):
        self.done.clear()
        for proc in self.workers:
            proc.start()
        return self

    def stop(self):
        """Tell the workers to stop and wait for them; a worker still
        alive after STOP_TIMEOUT is terminated."""
        self.done.set()
        for proc in self.workers:
            if proc.pid is None:
                continue
            proc.join(STOP_TIMEOUT)
            if proc.is_alive():
                proc.terminate()
                proc.join()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- consumption --------------------------------------------------
    def get_data(self):
        """One item; returns None only after stop() with a drained
        queue, and raises when every worker has exited without one."""
        while not self.done.is_set():
            try:
                return self.data_queue.get(timeout=0.2)
            except Empty:
                if not any(proc.is_alive() for proc in self.workers):
                    raise RuntimeError(
                        'every feed worker exited, with codes '
                        f'{[proc.exitcode for proc in self.workers]}')
        try:
            return self.data_queue.get_nowait()
        except Empty:
            return None

    def get_batch(self, n):
        """Exactly n items, for batched device steps."""
        batch = []
        while len(batch) < n:
            item = self.get_data()
            if item is None:
                break
            batch.append(item)
        return batch

    def __iter__(self):
        while True:
            item = self.get_data()
            if item is None:
                return
            yield item
