"""Batched OCR inference (univer_ocr_tpu/models/pipeline.py), in two
cascades.

Host cascade (`device_cascade=False`), per chunk of pages:
  1. `front` on the device: Monochrome and Paragraph over the whole
     chunk, then the mean threshold of the paragraph mask;
  2. host: label each page's paragraph mask, crop and deskew each
     paragraph of the monochrome map (a thread pool across pages);
  3. `line_masks` on the device: the masked Line forward and its band
     threshold over every paragraph crop of the chunk, in fixed batches of
     bucket-shaped crops;
  4. host: crop and zoom each line band (the thread pool again);
  5. `char_ids` on the device: the masked Char forward and the argmax
     over every line of the chunk;
  6. host: decode the ids to text.

Device cascade (`device_cascade=True`; models/device_cascade.py): the
monochrome map, in the host cascade's uint8 steps, and every crop stay on
the device, and the device computes the host cascade's crops: its
paragraph deskew and its line zoom, in scipy's float64 geometry.  Per
chunk, the paragraph masks are labelled on the device (`band_ccl`,
4-connected as the host labels); each paragraph launch crops its
paragraphs from the labels and runs Line and the band threshold; the
lines are planned from the bands, gathered and zoomed, and Char and the
argmax run on them.  Three modes:

  * parity (`exact_bands=True`): the host plans each chunk's paragraphs
    from its pulled mask (`_page_paragraph_plans`), pulls the band masks
    and plans the lines as the host cascade does (`_plan_lines`);
  * tables (`exact_bands=False`, `fused_tail=False`): each launch labels
    both band channels of its paragraphs on the device
    (band_tables.band_tables) and sends home one small table of their
    components; the host pairs the lines from the tables;
  * the serving default (tables with the fused tail, on with an integer
    `collapse_runs`; models/fused_tail.py): the paragraph launch goes on
    to pair the lines on the device, crop them, run Char and decode the
    text, and the host pulls the glyph ids, one pull per wave of
    SMALL_SLOTS launches.  The paragraph plans come from the device too
    (`device_chunk_plans`), pulled as one small matrix per chunk; a page
    with more than CHUNK_PLAN_K components is planned on the host.  One
    page alone takes the single-page chain (`_ocr_single_page_device`).

In the tables mode and the serving default, a paragraph whose band
components overflow a table is planned on the host from its band masks,
which are pulled only then (escalation_stats['host_planned']).  In the
serving default, a paragraph whose lines overflow the fused tail's line
pool, or a line its width or glyph cap, is read by the line stage from
the tail's own line plans, pulled only then
(escalation_stats['relaunched']).

A dispatcher thread runs chunk i+1's dispatch while the caller's thread
collects chunk i, and the paragraph launches of a chunk are handled in
parallel on the pool.  On the card without a mesh, every paragraph
launch and chunk planner call replays a CUDA graph, captured at the first
call of its shapes (models/launch_graphs.py): dispatched op by op, their
~1,300 ops a launch kept the card waiting on the dispatcher.

With a `mesh` (parallel/mesh.py), as in JAX, every launch batch of the
front and of the Line and Char stages splits over the mesh's 'data'
shards (parallel/serving.py): each shard runs the stage on its slice, on
its own device, with its own copy of the weights and of the kernels'
prepared weights, and the outputs merge in shard order on the mesh's
first device.  The page, label and crop stacks the gathers read are
copied to every shard once per chunk and once per paragraph launch; the
fused tail runs once per shard with the shard's own line pool, and the
host merges the shards' payload segments
(`fused_tail.unpack_fused_payload`).  The device planners and the
single-page chain are off under a mesh, as in JAX: chunks are planned on
the host.

On the card Monochrome, the Char head and the labelling run as the CUDA
kernels (ops/kernels), Monochrome and the Char head in float32 whatever
the precision, as the JAX package's Pallas kernels do; on the CPU they
run as their plain versions in the pipeline's precision, as the JAX
package runs them without Pallas.

Numerics follow the host cascade: the uint8 rounding of the monochrome
map and of the crops (round half to even, as `jnp.round`), the `> 1e-6`
guards, the first-index argmax, the batch sizes and the shape menus.
Masks move as one byte per pixel.

Precision: `ocr_pages` holds `ops.precision.backend_flags(precision)` on
the calling thread for the whole call.  The TF32 switches it sets are
process-wide, so they hold for the dispatcher and pool threads too, and
no stage toggles them; two pipelines of different precisions must not run
`ocr_pages` at the same time.
"""

import contextlib
import copy
import functools
import queue
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy import ndimage

from .. import native, ops
from ..device import resolve_device
from ..interpreter import (band_components, bbox, deskew_paragraph,
                           extract_line, find_rotation_angle,
                           layer_components, pair_lines, pred_ids_to_text,
                           rotate_array)
from ..ops.kernels import fused_monochrome
from ..parallel.mesh import Replicated, mesh_device, replicate, to_device
from ..parallel.serving import shard_cascade_stage, shard_fn_over_batch
from ..weights import params_from_numpy, random_params
from .band_tables import (band_tables, band_threshold, pack_tables,
                          table_components, unpack_tables)
from .bucketing import (CHAR_FIXED_WIDTH, CHAR_INPUT_HEIGHT, CHAR_WIDTH_MENU,
                        line_shape_menu, make_divisible_by, pick_char_width,
                        pick_line_shape)
from . import fused_tail
from .device_cascade import (LINE_FIELDS, PARAGRAPH_FIELDS,
                             device_chunk_plans, device_page_plans,
                             line_plan_fields, page_labels, paragraph_stage,
                             to_u8_steps, unpack_line_plan,
                             zoomed_line_crops)
from .fastpath import (char_forward_masked, char_head_weights,
                       line_forward_masked, monochrome_forward,
                       monochrome_weights)
from .launch_graphs import LaunchGraphs

#: seed of the generator behind `OCRPipeline(weights=None)`
RANDOM_INIT_SEED = 0


def crop_lines_of_paragraph(line_pred, mono_crop, zoomed_height,
                            minimal_width, thresholded_input=False,
                            timers=None):
    """Line bands of one paragraph -> list of zoomed line crops of the
    monochrome image.  `thresholded_input` marks line_pred as already
    thresholded band masks (the device-side threshold).  With `timers`
    (`OCRPipeline.timers`) the line plan ('line_plan', plan_paragraph_lines
    in its two parts) and each line's crop ('line_extract') are host CV
    steps, and the plan counts the band components it summarised
    ('line_plan_components')."""
    with _host_cv_step(timers, 'line_plan'):
        (top_boxes, cm_top), (bottom_boxes, cm_bottom) = band_components(
            line_pred, thresholded_input)
        bboxes, _, rotation = pair_lines(top_boxes, cm_top, bottom_boxes,
                                         cm_bottom)
        if timers is not None:
            timers.add('line_plan_components',
                       len(top_boxes) + len(bottom_boxes))
    lines = []
    for b in bboxes:
        with _host_cv_step(timers, 'line_extract'):
            lines.append(extract_line(mono_crop, b, rotation, zoomed_height,
                                      minimal_width))
    return lines


def _host_cv_step(timers, name):
    """A host CV step of a pool task: its span and its thread's CPU
    seconds, or no context without timers.  The steps of a task cover all
    of its work."""
    if timers is None:
        return contextlib.nullcontext()
    return _thread_cpu_span(timers, name)


@contextlib.contextmanager
def _thread_cpu_span(timers, name):
    """The span `name`, and the calling thread's CPU seconds inside it
    added to 'host_cv_thread_cpu'."""
    with timers.track(name):
        cpu = time.thread_time()
        yield
        cpu = time.thread_time() - cpu
    timers.add('host_cv_thread_cpu', cpu)


def _to_u8(x):
    """round(x * 255) to uint8, round half to even (as jnp.round)."""
    return np.round(x * 255.0).astype(np.uint8)


class OCRPipeline:
    """OCR over same-shape pages, by the host or the device cascade.

    `weights`: a `{name: {'w', 'b'}}` dict of arrays, lists or tensors
    (the model_weights.json layout; `weights.load_checkpoint()` gives the
    committed checkpoint), or None for random weights drawn by
    `weights.random_params` from a generator seeded RANDOM_INIT_SEED, as
    the JAX pipeline initialises its models when given none.
    `device`: None or 'cuda' runs on the card (raising without one), with
    the CUDA kernels; 'cpu' runs on the host, with their plain versions.
    `device_cascade`, `exact_bands`, `fused_tail`: the modes of the module
    docstring; the fused tail is on by default in the tables mode with an
    integer `collapse_runs`, and then chunks go through the device planner
    and single pages through the chain.  `mesh`: None, or a
    `parallel.make_mesh` mesh whose 'data' shards split every launch batch
    (its devices of `device`'s type; DEVICE_BATCH must divide over
    them).  Set `timers` to a
    `utils.profiling.StageTimers` to time the stages: in the host
    cascade also each host CV step on the pool threads, with the threads'
    CPU seconds in it (`host_cv_thread_cpu`), and the waits for the Line
    and Char results (`line_pull`, `char_pull`); in the device cascade
    the labelling launches ('band_components', a span of the host's
    launch time, which a graph replay does not open; the components they
    labelled counted as 'band_components_labelled'), every blocking pull
    ('host_sync', counted as `host_syncs` counts it), and the paragraph
    launches and chunk planner calls ('stage_launches'), those a CUDA
    graph's replay served ('graph_replays') and the graphs captured
    ('graph_captures'); `timeline` then records every device-to-host pull
    as (tag, start, end, bytes).
    Close the pipeline (`close()` or `with`) to shut its thread pools
    down.
    """

    CHAR_WIDTH_MENU = CHAR_WIDTH_MENU
    #: fixed batch of the host cascade's Line/Char launches and of the
    #: paragraph stage
    DEVICE_BATCH = 16
    #: batch of the device cascade's line stage
    LINE_DEVICE_BATCH = 64
    #: per-page component cap of the device chunk planner (pages with
    #: more are planned on the host)
    CHUNK_PLAN_K = 48
    #: fused-tail glyph payloads gather into one (SMALL_SLOTS, bytes)
    #: buffer per wave of launches, pulled once
    SMALL_SLOTS = 8

    def __init__(self, page_shape, weights=None, chunk=8, workers=8,
                 collapse_runs=False, quantized_transfers=True,
                 precision='highest', device=None, device_cascade=False,
                 exact_bands=False, fused_tail=None, mesh=None):
        self.band_tables = device_cascade and not exact_bands
        if fused_tail is None:
            fused_tail = (self.band_tables
                          and isinstance(collapse_runs, int)
                          and not isinstance(collapse_runs, bool)
                          and collapse_runs >= 1)
        self.fused_tail = bool(fused_tail) and self.band_tables
        #: the device planners (chunk planner, single-page chain) go
        #: with the fused tail but not with a mesh; tests clear it to
        #: drive the host-planned fused dispatch, as JAX's clear
        #: _chunk_planner
        self._device_planner = self.fused_tail and mesh is None
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None
                                     else mesh_device(mesh, device))
        n_data = 1 if mesh is None else mesh.shape['data']
        if self.DEVICE_BATCH % n_data:
            raise ValueError(f'DEVICE_BATCH={self.DEVICE_BATCH} must divide '
                             f'over the data axis ({n_data} shards)')
        #: the data shards; the fused tail's payload has one segment per
        #: shard, each with its own line pool
        self._n_data = n_data
        self.page_shape = tuple(page_shape)
        self.chunk = chunk
        self.collapse_runs = collapse_runs
        self.quantized_transfers = quantized_transfers
        self.precision = ops.precision.resolve(precision)
        self.device_cascade = device_cascade
        self.line_shape_menu = line_shape_menu(page_shape)
        if weights:
            self.params = params_from_numpy(weights, self.device)
        else:
            self.params = random_params(
                torch.Generator().manual_seed(RANDOM_INIT_SEED), self.device)
        self.mono_weights, self.char_head = self._kernel_weights(self.params)
        self._pool = ThreadPoolExecutor(max_workers=workers)
        #: device-to-host transfers: each waits on its copy's event here,
        #: so no dispatching thread blocks on one
        self._xfer = ThreadPoolExecutor(max_workers=16)
        self.timers = None
        self.timeline = []
        #: device-cascade planning counters: 'paragraphs' launched,
        #: 'host_planned' (paragraphs whose band tables overflowed,
        #: planned on the host from their band masks), 'relaunched'
        #: (paragraphs the fused tail flagged for its line pool, a line's
        #: width or glyphs, whose device line plans went through the line
        #: stage), one count per fused_tail.FLAG_BITS bit, and
        #: 'chain_fallback' (pages the device planners left to the host)
        self.escalation_stats = Counter(paragraphs=0, host_planned=0)
        self._stats_lock = threading.Lock()
        #: the device cascade's blocking pulls (host syncs), by tag:
        #: 'plan_matrix', 'para_bits', 'fused_glyphs', 'line_plans',
        #: 'bands', 'tables', 'char_ids', 'chain_plan'
        self.host_syncs = Counter()
        #: the CUDA graphs of the device cascade's paragraph launches and
        #: chunk planner, on the card without a mesh (launch_graphs.py)
        self._graphs = (LaunchGraphs(self.device)
                        if device_cascade and self.device.type == 'cuda'
                        and mesh is None else None)
        if mesh is not None:
            self._shard_stages(mesh)

    @staticmethod
    def _kernel_weights(params):
        """The kernels' weights, prepared once for every launch on the
        card; on the CPU the plain versions run instead."""
        device = params['Monochrome/conv_1']['w'].device
        if device.type == 'cuda':
            return monochrome_weights(params), char_head_weights(params)
        return None, 'xla'

    def _shard_stages(self, mesh):
        """Route the device stages through the mesh (JAX's
        shard_fn_over_batch and shard_cascade_stage): each 'data' shard
        runs a stage on a view of this pipeline whose weights and
        prepared kernel weights live on the shard's device (one view per
        distinct device), with the page, label and crop stacks as its
        replicated arguments."""
        views = {}
        for dev in mesh.data_devices():
            if dev not in views:
                view = copy.copy(self)
                view.mesh, view.device = None, dev
                view.params = to_device(self.params, dev)
                view.mono_weights, view.char_head = self._kernel_weights(
                    view.params)
                views[dev] = view
        shards = Replicated(views[dev] for dev in mesh.data_devices())
        cls = type(self)
        for name, n_batch in (('front', 1), ('front_resident', 1),
                              ('line_masks', 3), ('line_preds', 3),
                              ('char_ids', 2)):
            setattr(self, name, functools.partial(shard_fn_over_batch(
                getattr(cls, name), mesh, n_batch), shards))
        for name, n_replicated, statics in (
                ('paragraph_launch', 3, (4, 5)), ('line_stage', 2, (3, 4))):
            setattr(self, name, functools.partial(shard_cascade_stage(
                getattr(cls, name), mesh, n_replicated, statics), shards))

    def close(self):
        self._pool.shutdown(wait=True)
        self._xfer.shutdown(wait=True)
        self._graphs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _track(self, name):
        if self.timers is None:
            return contextlib.nullcontext()
        return self.timers.track(name)

    # -- transfers ---------------------------------------------------------
    def _tensor(self, arr):
        """Host array -> tensor on the device.  To the card it goes from
        pinned memory without waiting for the device: a plain copy would
        wait for every launch queued before it."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == 'cuda':
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _pull(self, t, tag):
        """Start a device-to-host copy of `t`; returns a future of the
        numpy array.  From the card the copy goes into pinned memory on the
        stream, and the transfer pool waits for its event."""
        if t.device.type == 'cuda':
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            # the copy and its event on t's card: under a mesh t may live
            # on another card than the current one
            with torch.cuda.device(t.device):
                host.copy_(t, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
        else:
            host, done = t, None

        def job():
            start = time.perf_counter()
            if done is not None:
                done.synchronize()
            out = host.numpy()
            if self.timers is not None:
                self.timeline.append((tag, start, time.perf_counter(),
                                      out.nbytes))
            return out
        return self._xfer.submit(job)

    def _wait(self, future, tag):
        """The result of a pull, waited for by the calling thread: a host
        sync, counted once a pull (several launches wait on one glyph
        wave) in host_syncs[tag] and, with timers, as one 'host_sync'."""
        with self._stats_lock:
            first = not getattr(future, 'waited', False)
            future.waited = True
            if first:
                self.host_syncs[tag] += 1
        if first and self.timers is not None:
            self.timers.add('host_sync', 1)
        return future.result()

    def _count(self, **counts):
        with self._stats_lock:
            self.escalation_stats.update(counts)

    # -- device stages -----------------------------------------------------
    def _monochrome(self, x):
        if self.mono_weights is None:
            return monochrome_forward(self.params, x, precision=self.precision)
        return fused_monochrome(x, self.mono_weights)

    def front_resident(self, batch_u8):
        """(B, H, W, 1) uint8 pages -> (float32 monochrome map, paragraph
        mask as uint8 0/1), the mean threshold per page.  The device
        cascade keeps the map on the device."""
        x = batch_u8.float() / 255.0
        m = self._monochrome(x)
        H, W = self.page_shape[1], self.page_shape[2]
        p = line_forward_masked(self.params, m, H, W, prefix='Paragraph',
                                precision=self.precision)
        # mean per page, the label_layer rule; the 1e-6 guard keeps a
        # constant map empty, as the host's float64 rule leaves it
        mean = p.mean(dim=(1, 2, 3), keepdim=True)
        return m, ((p - mean) > 1e-6).to(torch.uint8)

    def front(self, batch_u8):
        """Host cascade front: the monochrome map is uint8 when transfers
        are quantized, else float32."""
        m, p_mask = self.front_resident(batch_u8)
        if self.quantized_transfers:
            m = torch.round(m * 255.0).to(torch.uint8)
        return m, p_mask

    def line_masks(self, x_u8, h_valid, w_valid):
        """Masked Line forward + the band threshold over each sample's
        valid region (band_tables.band_threshold) -> uint8 0/1 masks."""
        x = x_u8.float() / 255.0
        pred = line_forward_masked(self.params, x, h_valid, w_valid,
                                   prefix='Line', precision=self.precision)
        return band_threshold(pred, h_valid, w_valid).to(torch.uint8)

    def line_preds(self, x, h_valid, w_valid):
        """Unquantized transfers: the masked Line forward itself."""
        return line_forward_masked(self.params, x, h_valid, w_valid,
                                   prefix='Line', precision=self.precision)

    def char_ids(self, x, w_valid):
        """Masked Char forward + argmax -> (ids, valid)."""
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        logits = char_forward_masked(self.params, x, w_valid,
                                     precision=self.precision,
                                     head=self.char_head)
        ids = logits.argmax(dim=-1).to(torch.int32)
        cols = torch.arange(logits.shape[1], device=logits.device)[None, :]
        valid = cols < w_valid.reshape(-1, 1)
        return ids, valid


    def _stage_launch(self, name, fn, args, statics=()):
        """fn(*args, *statics), replayed from its CUDA graph where the
        pipeline has them (`args` staged into the graph's buffers), else
        run as it stands.  With timers, counts the call in
        'stage_launches' and, where a replay served it, in 'graph_replays'
        (and its capture in 'graph_captures')."""
        timers = self.timers
        if timers is not None:
            timers.add('stage_launches', 1)
        if self._graphs is None:
            return fn(*args, *statics)
        out, captured = self._graphs.launch(
            name, fn, args, statics, mode=(self.fused_tail, self.band_tables,
                                           self.precision,
                                           self.collapse_runs))
        if timers is not None:
            timers.add('graph_replays', 1)
            if captured:
                timers.add('graph_captures', 1)
        return out

    def paragraph_launch(self, mono, labels, plan, hb, wb):
        """One paragraph launch (device_cascade.paragraph_stage): mono
        (N, H, W) map in uint8 steps, labels (N, H, W) the chunk's
        paragraph labels, plan (B, 15) int32 PARAGRAPH_FIELDS rows.
        Returns (crops, band masks as uint8, extra): extra is None in the
        parity mode, the packed band tables in the tables mode
        (band_tables.pack_tables) and the fused tail's (glyph payload,
        line plans) with it.  On the card without a mesh, a replay of the
        graph of its stack shape, batch, menu entry and mode
        (`_stage_launch`)."""
        return self._stage_launch('paragraph_launch', self._paragraph_launch,
                                  (mono, labels, plan), (hb, wb))

    def _paragraph_launch(self, mono, labels, plan, hb, wb):
        crops, bands = paragraph_stage(self.params, mono, labels, plan, hb,
                                       wb, precision=self.precision)
        hv, wv = plan[:, PARAGRAPH_FIELDS.index('hv')], plan[
            :, PARAGRAPH_FIELDS.index('wv')]
        extra = None
        if self.fused_tail:
            extra = fused_tail.fused_paragraph_tail(
                self.params, crops, bands, hv, wv, precision=self.precision,
                min_run=max(int(self.collapse_runs), 1),
                char_head=self.char_head, track=self._track)
        elif self.band_tables:
            with self._track('band_components'):
                extra = pack_tables(*band_tables(bands, hv, wv))
        return crops, bands.to(torch.uint8), extra

    def chunk_planner(self, para_stack):
        """device_chunk_plans at CHUNK_PLAN_K, its results packed into ONE
        int32 vector [plans (B, K, 15) | menu_idx (B, K) | n_comp (B)].
        Returns (labels, packed).  On the card without a mesh, a replay
        of the graph of its stack shape (`_stage_launch`)."""
        return self._stage_launch('chunk_planner', self._chunk_planner,
                                  (para_stack,))

    def _chunk_planner(self, para_stack):
        labels, plans, menu_idx, n_comp = device_chunk_plans(
            para_stack, tuple(self.line_shape_menu), k_max=self.CHUNK_PLAN_K)
        packed = torch.cat([plans.reshape(-1),
                            menu_idx.to(torch.int32).reshape(-1),
                            n_comp.to(torch.int32)])
        return labels, packed

    def line_stage(self, crop_stack, plan, out_h, out_w):
        """Zoomed line crops (one gather) + Char forward in uint8 steps +
        argmax -> (B, out_w) uint8 ids, 255 at columns at or past each
        line's true width."""
        iv = unpack_line_plan(plan)
        w_valid = iv['w_valid']
        lines = zoomed_line_crops(
            crop_stack, iv['para_idx'], iv['lh'], iv['lw'], iv['w_out'],
            iv['a_yy'], iv['a_yx'], iv['b_y'], iv['a_xy'], iv['a_xx'],
            iv['b_x'], out_h, out_w)
        logits = char_forward_masked(self.params, to_u8_steps(lines), w_valid,
                                     precision=self.precision,
                                     head=self.char_head)
        ids = logits.argmax(dim=-1)
        cols = torch.arange(logits.shape[1], device=logits.device)[None, :]
        valid = cols < w_valid.reshape(-1, 1)
        return torch.where(valid, ids, 255).to(torch.uint8)

    # -- entry -------------------------------------------------------------
    def ocr_pages(self, pages):
        """pages: list of (1, H, W, 1) float arrays in [0, 1] or uint8
        arrays, all of `page_shape`.  Returns per page:
        [paragraph][line] -> decoded text."""
        chunks = [pages[start:start + self.chunk]
                  for start in range(0, len(pages), self.chunk)]
        with ops.precision.backend_flags(self.precision):
            if len(pages) == 1 and self._device_planner:
                return [self._ocr_single_page_device(pages[0])]
            if self.device_cascade:
                return self._ocr_pages_device(chunks)
            return self._ocr_pages_host(chunks)

    def _upload_pages(self, chunk):
        batch = np.concatenate([
            np.asarray(np.asarray(p) * 255.0, np.uint8)
            if np.asarray(p).dtype != np.uint8 else np.asarray(p)
            for p in chunk])
        if self.mesh is not None and len(batch) % self._n_data:
            # a tail chunk must still divide over the data shards; blank
            # pages give no paragraphs and only len(chunk) rows are read
            pad = self._n_data - len(batch) % self._n_data
            batch = np.concatenate(
                [batch, np.zeros((pad,) + batch.shape[1:], np.uint8)])
        return self._tensor(batch)

    # -- host cascade ------------------------------------------------------
    def _ocr_pages_host(self, chunks):
        results = []
        pending = self.front(self._upload_pages(chunks[0])) if chunks else None
        for i, chunk in enumerate(chunks):
            with self._track('pull_front'):
                mono, para = (t.cpu().numpy() for t in pending)
            # queue the next chunk's front before this chunk's host work
            if i + 1 < len(chunks):
                pending = self.front(self._upload_pages(chunks[i + 1]))
            results.extend(self._ocr_chunk(chunk, mono, para))
        return results

    def _crop_page(self, mono_pred, para_mask):
        """Label the thresholded paragraph mask with each component's box
        (native.label_stats), then crop and deskew the monochrome
        prediction (crop_and_rotate_single_paragraph in its two steps:
        select_paragraph's crop, formed inside the paragraph's box alone,
        then deskew_paragraph)."""
        timers = self.timers
        with _host_cv_step(timers, 'para_label'):
            labels, _, _, _, boxes = native.label_stats(
                para_mask[0, :, :, 0] > 0)
        crops = []
        for l_id, (y0, y1, x0, x1) in enumerate(boxes.tolist(), start=1):
            with _host_cv_step(timers, 'para_select'):
                mask = (labels[y0:y1, x0:x1] == l_id)[None, :, :, None]
                selected = [mono_pred[:, y0:y1, x0:x1, :] * mask]
            with _host_cv_step(timers, 'para_deskew'):
                (crop,) = deskew_paragraph(mask, selected)
                crops.append(make_divisible_by(crop, 16, 16))
        return crops

    def _crop_lines(self, line_pred, crop):
        """One paragraph's zoomed line crops."""
        return crop_lines_of_paragraph(
            line_pred, crop, CHAR_INPUT_HEIGHT, CHAR_FIXED_WIDTH,
            thresholded_input=self.quantized_transfers, timers=self.timers)

    def _run_line_batched(self, crops):
        """All paragraph crops (flat list) -> line predictions, or band
        masks when transfers are quantized; shape menu, fixed batch, every
        launch queued before any result is read."""
        B = self.DEVICE_BATCH
        groups = {}
        for i, c in enumerate(crops):
            groups.setdefault(pick_line_shape(
                self.line_shape_menu, c.shape[1], c.shape[2]), []).append(i)

        dtype = np.uint8 if self.quantized_transfers else np.float32
        fn = self.line_masks if self.quantized_transfers else self.line_preds
        launches = []
        for (hb, wb), group in groups.items():
            for start in range(0, len(group), B):
                idxs = group[start:start + B]
                batch = np.zeros((B, hb, wb, 1), dtype)
                hs = np.full((B,), 4, np.int64)
                ws = np.full((B,), 4, np.int64)
                for bi, i in enumerate(idxs):
                    c = crops[i]
                    batch[bi, :c.shape[1], :c.shape[2], :] = (
                        _to_u8(c[0]) if self.quantized_transfers else c[0])
                    hs[bi], ws[bi] = c.shape[1], c.shape[2]
                launches.append((idxs, fn(self._tensor(batch),
                                          self._tensor(hs),
                                          self._tensor(ws))))

        preds = [None] * len(crops)
        with self._track('line_pull'):
            for idxs, dev_out in launches:
                out = dev_out.cpu().numpy()
                for bi, i in enumerate(idxs):
                    h, w = crops[i].shape[1], crops[i].shape[2]
                    preds[i] = out[bi:bi + 1, :h, :w, :]
        return preds

    def _run_char_batched(self, lines):
        """All line crops (flat list) -> per-line (ids, valid); widths pad
        to the menu, fixed batch."""
        groups = {}
        for i, line in enumerate(lines):
            groups.setdefault(pick_char_width(line.shape[2]), []).append(i)
        B = self.DEVICE_BATCH
        dtype = np.uint8 if self.quantized_transfers else np.float32
        launches = []
        for wb, idxs in groups.items():
            for start in range(0, len(idxs), B):
                chunk_idx = idxs[start:start + B]
                batch = np.zeros((B, CHAR_INPUT_HEIGHT, wb, 1), dtype)
                ws = np.full((B,), 4, np.int64)
                for bi, i in enumerate(chunk_idx):
                    line = lines[i]
                    data = line[0]
                    if self.quantized_transfers:
                        data = _to_u8(data)
                    batch[bi, :, :line.shape[2], :] = data
                    ws[bi] = line.shape[2]
                launches.append((chunk_idx,
                                 self.char_ids(self._tensor(batch),
                                               self._tensor(ws))))
        preds = [None] * len(lines)
        with self._track('char_pull'):
            for chunk_idx, (ids_dev, valid_dev) in launches:
                ids = ids_dev.cpu().numpy()
                valid = valid_dev.cpu().numpy()
                for bi, i in enumerate(chunk_idx):
                    w = lines[i].shape[2]
                    preds[i] = (ids[bi, :w], valid[bi, :w])
        return preds

    def _ocr_chunk(self, pages, mono, para):
        n = len(pages)
        if self.quantized_transfers:
            mono = mono.astype(np.float32) / 255.0

        with self._track('host_paragraph_crops'):
            crops_per_page = list(self._pool.map(
                lambda i: self._crop_page(mono[i:i + 1], para[i:i + 1]),
                range(n)))

        flat_crops = [c for crops in crops_per_page for c in crops]
        with self._track('line_masks'):
            flat_line_preds = self._run_line_batched(flat_crops)

        with self._track('host_line_crops'):
            lines_per_crop = list(self._pool.map(
                self._crop_lines, flat_line_preds, flat_crops))

        flat_lines = [l for lines in lines_per_crop for l in lines]
        with self._track('char_ids'):
            flat_ids = self._run_char_batched(flat_lines) if flat_lines else []

        with self._track('decode_text'):
            texts = [pred_ids_to_text(ids, valid, self.collapse_runs).strip()
                     for ids, valid in flat_ids]

        results = []
        li = 0
        ci = 0
        for crops in crops_per_page:
            page_result = []
            for _ in crops:
                n_lines = len(lines_per_crop[ci])
                page_result.append(texts[li:li + n_lines])
                li += n_lines
                ci += 1
            results.append(page_result)
        return results

    # -- device cascade: host planning -------------------------------------
    def _page_paragraph_plans(self, page_idx, para2d):
        """Label one page's paragraph mask and plan each component's crop
        as the host cascade crops it: its box, find_rotation_angle's
        degree (0 for level), the box of its order-0 rotated mask
        (deskew_paragraph's), make_divisible_by's centre pad and the
        smallest menu bucket holding the padded crop."""
        labels, _ = native.label(para2d > 0)
        plans = []
        for label_id, sl in enumerate(ndimage.find_objects(labels), start=1):
            if sl is None:
                continue
            blob = (labels[sl] == label_id)[None, :, :, None]
            h, w = blob.shape[1:3]
            angle = find_rotation_angle(blob)
            # nearest rotation of the 0/1 mask as uint8: the values of
            # rotating the boolean mask
            _, ry, rx, _ = bbox(rotate_array(blob.astype(np.uint8), angle,
                                             good_rotation=False))
            out_h, out_w = ry.stop - ry.start, rx.stop - rx.start
            # make_divisible_by: CENTER pad, always adding at least one
            # row/column; the Line model's stride-2 convs are phase
            # sensitive, so placement must match the host path exactly
            pad_h, pad_w = 16 - out_h % 16, 16 - out_w % 16
            hv, wv = out_h + pad_h, out_w + pad_w
            hb, wb = pick_line_shape(self.line_shape_menu, hv, wv)
            # a rotated page-diagonal paragraph can exceed the page-sized
            # menu: clamp
            plans.append({
                'page': page_idx, 'label': label_id - 1,
                'y0': sl[0].start, 'x0': sl[1].start, 'h': h, 'w': w,
                'angle': 0 if angle is None else int(angle),
                'ry0': ry.start, 'rx0': rx.start,
                'out_h': min(out_h, hb), 'out_w': min(out_w, wb),
                'py': pad_h // 2, 'px': pad_w // 2,
                'hv': min(hv, hb), 'wv': min(wv, wb), 'menu': (hb, wb),
            })
        return plans

    #: label_layer semantics on one band channel: per-blob bboxes and
    #: centres of mass from one labelling pass
    _band_blob_stats = staticmethod(layer_components)

    def _plan_lines(self, bands):
        """Line gather plans from one paragraph's thresholded (H, W, 2)
        band masks: the geometry half of crop_lines_of_paragraph."""
        (top_boxes, cm_top), (bottom_boxes, cm_bottom) = (
            self._band_blob_stats(bands[:, :, c]) for c in (0, 1))
        return self._pair_and_plan(top_boxes, cm_top, bottom_boxes,
                                   cm_bottom)

    @staticmethod
    def _pair_and_plan(top_boxes, cm_top, bottom_boxes, cm_bottom):
        """pair_lines on the components of both channels -> the lines'
        gather plans (LINE_FIELDS but para_idx), in reading order."""
        bboxes, _, rotation = pair_lines(top_boxes, cm_top, bottom_boxes,
                                         cm_bottom)
        return [line_plan_fields(rotation, y.start, y.stop, x.start, x.stop)
                for y, x in bboxes]

    def _plan_from_tables(self, stats, n_comp):
        """Line plans of one paragraph from its band tables (the tables
        mode), or None when a channel overflowed its table."""
        if (n_comp > stats.shape[1]).any():
            return None
        top, bottom = (table_components(stats[c], n_comp[c]) for c in (0, 1))
        return self._pair_and_plan(*top, *bottom)

    # -- device cascade: launches --------------------------------------------
    def _dispatch_paragraph_stage(self, stacks, plans):
        """Launch the paragraph stage for all plans, grouped by shape
        menu.  Returns [(plan indices, crops, band masks, extra)], all on
        the device (paragraph_launch's)."""
        if self._graphs is not None:
            # the chunk's stacks once, where every launch's graph reads them
            stacks = [self._graphs.stage('paragraph_launch', i, t)
                      for i, t in enumerate(stacks)]
        mono_dev, labels_dev = stacks
        groups = {}
        for i, plan in enumerate(plans):
            groups.setdefault(plan['menu'], []).append(i)
        B = self.DEVICE_BATCH
        launches = []
        for (hb, wb), idxs in groups.items():
            start = 0
            while start < len(idxs):
                # a tail of 4 or fewer plans takes a batch of 4, as in the
                # JAX package's parity mode; under a mesh every batch
                # divides over the data shards
                Bsub = (4 if len(idxs) - start <= 4 and self.mesh is None
                        else B)
                sel = idxs[start:start + Bsub]
                start += Bsub
                # filler rows: a 4x4 crop of no component at the origin
                mat = np.zeros((Bsub, len(PARAGRAPH_FIELDS)), np.int32)
                for ci, k in enumerate(PARAGRAPH_FIELDS):
                    if k in ('h', 'w', 'out_h', 'out_w', 'hv', 'wv'):
                        mat[:, ci] = 4
                    elif k == 'label':
                        mat[:, ci] = -1
                for bi, i in enumerate(sel):
                    mat[bi] = [plans[i][k] for k in PARAGRAPH_FIELDS]
                plan = (self._tensor(mat) if self._graphs is None else
                        self._graphs.stage('paragraph_launch', 2, mat))
                out = self.paragraph_launch(mono_dev, labels_dev, plan, hb,
                                            wb)
                launches.append((sel,) + tuple(out))
        self._count(paragraphs=len(plans))
        return launches

    def _dispatch_line_stage(self, crops_dev, line_plans):
        """Launch the zoom + Char stage for all lines of one paragraph
        launch.  line_plans: [(slot, plan)].  All lines of the launch share
        ONE width bucket, the widest any of them needs.  Returns
        [(plan refs, ids on the device)]."""
        if not line_plans:
            return []
        wc = max(pick_char_width(plan['w_valid']) for _, plan in line_plans)
        B = self.LINE_DEVICE_BATCH
        launches = []
        # no graph capture meanwhile: it would count these launches
        with (contextlib.nullcontext() if self._graphs is None
              else self._graphs.lock):
            for start in range(0, len(line_plans), B):
                sel = list(range(start, min(start + B, len(line_plans))))
                mat = np.zeros((B, len(LINE_FIELDS)), np.int32)
                mat[:, LINE_FIELDS.index('w_valid')] = CHAR_FIXED_WIDTH
                for bi, ref in enumerate(sel):
                    slot, plan = line_plans[ref]
                    mat[bi] = [slot] + [plan[k] for k in LINE_FIELDS[1:]]
                ids = self.line_stage(crops_dev, self._tensor(mat),
                                      CHAR_INPUT_HEIGHT, wc)
                launches.append((sel, ids))
        return launches

    def _pad_stack(self, arr):
        """Pad a tail chunk's page stack with blank pages to `chunk`, so
        every launch sees the stack shape of a full chunk, as in the JAX
        package (no plan reads the filler pages)."""
        b = arr.shape[0]
        if b >= self.chunk:
            return arr
        return torch.cat([arr, arr.new_zeros((self.chunk - b,)
                                             + tuple(arr.shape[1:]))])

    # -- device cascade: one chunk -------------------------------------------
    def _dispatch_front_device(self, chunk):
        """Launch a chunk's front and, unless the device planner plans it,
        start the pull of its paragraph mask.  Returns (pages, map in
        uint8 steps (N, H, W), mask (N, H, W, 1), future of the host mask
        or None)."""
        mono_dev, para_dev = self.front_resident(self._upload_pages(chunk))
        bits = (None if self._device_planner
                else self._pull(para_dev, 'para_bits'))
        return len(chunk), to_u8_steps(mono_dev)[..., 0], para_dev, bits

    def _dispatch_chunk_device(self, n_pages, mono_dev, para_dev, para):
        """Dispatch phase of one chunk planned on the host: the chunk's
        labels on the device, paragraph plans from the host copy `para`
        of its (n, H, W, 1) mask, stage launches with their pulls in
        flight, then, per paragraph launch on the pool, line plans and
        line-stage launches with their id pulls in flight.  Never waits
        for a result the collect phase can wait for."""
        mono_dev = self._pad_stack(mono_dev)
        labels_dev = page_labels(self._pad_stack(para_dev)[..., 0],
                                 self.CHUNK_PLAN_K)[0]
        with self._track('host_paragraph_plans'):
            # serial: scipy's ndimage calls hold the GIL
            plans = [p
                     for page in range(n_pages)
                     for p in self._page_paragraph_plans(page,
                                                         para[page, :, :, 0])]
        return self._finish_dispatch(n_pages, mono_dev, labels_dev, plans)

    def _dispatch_chunk_device_planned(self, n_pages, mono_dev, para_dev):
        """Dispatch phase of one chunk planned on the device: the chunk
        planner's one small plan matrix replaces the paragraph-mask pull
        and the host planning; a page with more than CHUNK_PLAN_K
        components is planned on the host from the pulled mask, counted
        in escalation_stats['chain_fallback'].  The crops read each
        component from the planner's labels."""
        K = self.CHUNK_PLAN_K
        menu = self.line_shape_menu
        mono_dev = self._pad_stack(mono_dev)
        labels_dev, packed = self.chunk_planner(
            self._pad_stack(para_dev)[..., 0])
        with self._track('pull_plan_matrix'):
            flat = self._wait(self._pull(packed, 'plan_matrix'),
                              'plan_matrix')
        B = self.chunk
        nf = len(PARAGRAPH_FIELDS)
        o = B * K * nf
        mats = flat[:o].reshape(B, K, nf)
        menu_idx = flat[o:o + B * K].reshape(B, K)
        n_comp = flat[o + B * K:]

        plans = []
        para = None
        with self._track('host_paragraph_plans'):
            for page in range(n_pages):
                if n_comp[page] <= K:
                    for k in range(int(n_comp[page])):
                        plan = dict(zip(PARAGRAPH_FIELDS,
                                        mats[page, k].tolist()))
                        plan['menu'] = menu[menu_idx[page, k]]
                        plans.append(plan)
                    continue
                self._count(chain_fallback=1)
                if para is None:
                    with self._track('pull_para_bits'):
                        para = self._wait(self._pull(para_dev, 'para_bits'),
                                          'para_bits')
                plans.extend(self._page_paragraph_plans(page,
                                                        para[page, :, :, 0]))
        return self._finish_dispatch(n_pages, mono_dev, labels_dev, plans)

    def _finish_dispatch(self, n_pages, mono_dev, labels_dev, plans):
        if self.mesh is not None:
            # every shard's gathers read the whole stacks: one copy to
            # each shard's device per chunk
            mono_dev = replicate(mono_dev, self.mesh)
            labels_dev = replicate(labels_dev, self.mesh)
        with self._track('dispatch_paragraph_stage'):
            launches = self._dispatch_paragraph_stage(
                (mono_dev, labels_dev), plans)
        if self.fused_tail:
            futures = self._pull_glyph_waves(launches)
        else:
            futures = [self._pull(bands if extra is None else extra,
                                  'bands' if extra is None else 'tables')
                       for _, _, bands, extra in launches]

        def handle_launch(item):
            """Payload -> line plans -> line-stage launches for ONE
            paragraph launch; launches run in parallel, so pulls, host
            planning and dispatches overlap.  With the fused tail only the
            flagged paragraphs' lines go through the line stage."""
            (sel, crops_dev, bands_dev, extra), fut = item
            hvs = [(plans[i]['hv'], plans[i]['wv']) for i in sel]
            direct = None
            if self.fused_tail:
                wave, row, nbytes = fut
                with self._track('pull_fused_glyphs'):
                    buf = self._wait(wave, 'fused_glyphs')[row, :nbytes]
                flat, direct = self._plan_fused_launch(
                    len(sel), buf, bands_dev, extra[1], hvs)
            elif self.band_tables:
                flat = self._plan_launch_from_tables(fut, bands_dev, hvs)
            else:
                flat = self._plan_on_host([], range(len(sel)), fut, hvs)
            refs = []
            # with the fused tail, only flagged paragraphs have lines here
            if flat or direct is None:
                if self.mesh is not None:
                    # the crop stack is the line stage's shared source:
                    # one copy to each shard's device per launch
                    crops_dev = replicate(crops_dev, self.mesh)
                with self._track('dispatch_line_stage'):
                    refs = self._dispatch_line_stage(crops_dev, flat)
            id_futures = [(ref_sel, self._pull(ids_dev, 'char_ids'))
                          for ref_sel, ids_dev in refs]
            return sel, flat, id_futures, direct

        char_launches = list(self._pool.map(handle_launch,
                                            zip(launches, futures)))
        return n_pages, plans, char_launches

    def _pull_glyph_waves(self, launches):
        """The fused launches' glyph payloads, gathered on the device into
        one (SMALL_SLOTS, bytes) buffer per wave and pulled once a wave.
        Returns (the wave's future, row, the launch's own payload bytes)
        of each launch: a batch of 4 has a shorter payload than one of
        DEVICE_BATCH."""
        nb = self._n_data * fused_tail.fused_payload_nbytes(
            self.DEVICE_BATCH // self._n_data)
        futures = []
        for start in range(0, len(launches), self.SMALL_SLOTS):
            wave = launches[start:start + self.SMALL_SLOTS]
            acc = torch.zeros((self.SMALL_SLOTS, nb), dtype=torch.uint8,
                              device=self.device)
            for wi, (_, _, _, (small, _)) in enumerate(wave):
                acc[wi, :small.shape[0]] = small
            fut = self._pull(acc, 'fused_glyphs')
            futures.extend((fut, wi, small.shape[0])
                           for wi, (_, _, _, (small, _)) in enumerate(wave))
        return futures

    def _plan_on_host(self, flat, slots, bands, hvs):
        """A launch's line plans `flat` [(slot, plan)] merged, in slot
        order, with those of its paragraphs `slots` planned on the host
        from the launch's (B, HB, WB, 2) band masks, each within its valid
        region (hvs[slot]).  `bands` is their pull in flight, or the
        device tensor, pulled only when `slots` holds a paragraph."""
        if not len(slots):
            return flat
        if isinstance(bands, torch.Tensor):
            bands = self._pull(bands, 'bands')
        with self._track('pull_band_masks'):
            bands = self._wait(bands, 'bands')
        with self._track('host_line_plans'):
            for bi in slots:
                hv, wv = hvs[bi]
                flat.extend((int(bi), lp) for lp in self._plan_lines(
                    bands[bi, :hv, :wv, :] > 0))
        return sorted(flat, key=lambda item: item[0])

    def _plan_fused_launch(self, n, buf, bands_dev, lines_dev, hvs):
        """One fused launch's host side: its n paragraphs' glyph payload
        `buf` unpacked and counted.  A flagged paragraph's lines are the
        tail's device line plans `lines_dev` (pulled once for the launch),
        to be relaunched through the line stage; a paragraph whose band
        table overflowed has its band masks pulled and its lines planned
        on the host.  `hvs` holds each paragraph's valid extent.  Returns
        (line plans [(slot, plan)] of the flagged paragraphs, {slot:
        decoded lines} of the others)."""
        texts, flags, comps = fused_tail.unpack_fused_payload(
            buf, n, n_shards=self._n_data)
        if self.timers is not None:
            self.timers.add('band_components_labelled', int(comps.sum()))
        counts = {name: int(((flags >> b) & 1).sum())
                  for b, name in enumerate(fused_tail.FLAG_BITS)}
        table_of = (flags & 1 << fused_tail.FLAG_BITS.index('table_of')) > 0
        relaunch = np.flatnonzero((flags > 0) & ~table_of)
        overflowed = np.flatnonzero(table_of)
        self._count(host_planned=len(overflowed), relaunched=len(relaunch),
                    **counts)
        direct = {bi: texts[bi] for bi in range(n) if not flags[bi]}
        flat = []
        if len(relaunch):
            with self._track('pull_line_plans'):
                rows = self._wait(self._pull(lines_dev.to(torch.int32),
                                             'line_plans'), 'line_plans')
            # a plan row of zeros is no line
            flat = [(int(bi), dict(zip(fused_tail.PLAN_FIELDS, row.tolist())))
                    for bi in relaunch for row in rows[bi] if row[0] > 0]
        return self._plan_on_host(flat, overflowed, bands_dev, hvs), direct

    def _plan_launch_from_tables(self, fut, bands_dev, hvs):
        """The tables mode's line plans for one paragraph launch: paired
        from the pulled band tables, or, for a paragraph whose tables
        overflowed, planned from its band masks.  Returns [(slot, line
        plan)]."""
        with self._track('pull_band_tables'):
            stats, n_comp = unpack_tables(self._wait(fut, 'tables'))
        if self.timers is not None:
            self.timers.add('band_components_labelled',
                            int(n_comp[:len(hvs)].sum()))
        flat, overflowed = [], []
        with self._track('host_line_plans'):
            for bi in range(len(hvs)):
                lps = self._plan_from_tables(stats[bi], n_comp[bi])
                if lps is None:
                    overflowed.append(bi)
                    continue
                flat.extend((bi, lp) for lp in lps)
        self._count(host_planned=len(overflowed),
                    table_of=len(overflowed))
        return self._plan_on_host(flat, overflowed, bands_dev, hvs)

    def _launch_texts(self, n, flat, id_futures, direct):
        """The line texts of one paragraph launch's n paragraphs: the
        decoded ids of its line-stage launches, and the device-decoded
        lines of the paragraphs in `direct` (the fused tail's)."""
        line_texts = [None] * len(flat)
        for ref_sel, fut in id_futures:
            with self._track('pull_char_ids'):
                ids = self._wait(fut, 'char_ids')
            with self._track('decode_text'):
                for bi, ref in enumerate(ref_sel):
                    row = ids[bi, :flat[ref][1]['w_valid']]
                    # edge whitespace is crop margin, not content
                    line_texts[ref] = pred_ids_to_text(
                        row, row != 255, self.collapse_runs).strip()
        texts = []
        cursor = 0
        for bi in range(n):
            if direct is not None and bi in direct:
                texts.append([t.strip() for t in direct[bi]])
                continue
            n_lines = sum(1 for slot, _ in flat if slot == bi)
            texts.append(line_texts[cursor:cursor + n_lines])
            cursor += n_lines
        return texts

    def _collect_chunk_device(self, state):
        """Collect phase: wait for the id pulls and decode the text."""
        n_pages, plans, char_launches = state
        texts = {}                      # plan index -> [line text]
        for sel, flat, id_futures, direct in char_launches:
            for i, lines in zip(sel, self._launch_texts(
                    len(sel), flat, id_futures, direct)):
                texts[i] = lines
        results = [[] for _ in range(n_pages)]
        for i, plan in enumerate(plans):
            results[plan['page']].append(texts.get(i, []))
        return results

    def _ocr_pages_device(self, chunks):
        """Software-pipelined chunks: a dispatcher thread runs the dispatch
        phase (front, paragraph plans, stage launches, pulls) while this
        thread collects the previous chunk.  Fronts are launched one chunk
        ahead, and the bounded queue caps the chunks held on the device.
        An error on the dispatcher is raised here."""
        states = queue.Queue(maxsize=2)

        def dispatcher():
            try:
                pending = None
                for i, chunk in enumerate(chunks):
                    if pending is None:
                        pending = self._dispatch_front_device(chunk)
                    n_pages, mono_dev, para_dev, bits = pending
                    # launch chunk i+1's front before waiting on chunk i's
                    # paragraph mask or plans
                    pending = (self._dispatch_front_device(chunks[i + 1])
                               if i + 1 < len(chunks) else None)
                    if bits is None:
                        state = self._dispatch_chunk_device_planned(
                            n_pages, mono_dev, para_dev)
                    else:
                        with self._track('pull_para_bits'):
                            para = self._wait(bits, 'para_bits')
                        state = self._dispatch_chunk_device(
                            n_pages, mono_dev, para_dev, para)
                    states.put(('ok', state))
            except BaseException as exc:       # raised on the caller
                states.put(('err', exc))

        thread = threading.Thread(target=dispatcher, daemon=True,
                                  name='ocr-dispatcher')
        thread.start()
        results = []
        for _ in chunks:
            kind, state = states.get()
            if kind == 'err':
                raise state
            results.extend(self._collect_chunk_device(state))
        thread.join()
        return results

    # -- device cascade: one page ----------------------------------------------
    def single_page_chain(self, page_u8, k2):
        """The front and the device planner of one page: every component
        planned in the largest menu frame.  Returns (map in uint8 steps
        (1, H, W), mask (1, H, W, 1), labels (H, W), plans, n_comp, ok) on
        the device (device_page_plans)."""
        hb, wb = self.line_shape_menu[-1]
        mono, para = self.front_resident(page_u8)
        return (to_u8_steps(mono)[..., 0], para) + device_page_plans(
            para[0, :, :, 0], hb, wb, k_max=k2)

    def _ocr_single_page_device(self, page):
        """The one-page latency path: front, device planner, paragraph
        launches with their fused tails, with one read of the planner's
        result and one pull of the glyph payloads.  A page the planner
        cannot take (more than 2 * DEVICE_BATCH components) takes the
        host-planned chunk path, counted in
        escalation_stats['chain_fallback']; flagged paragraphs are read
        as in the chunk path.

        The JAX package runs both groups of DEVICE_BATCH components as
        one program whatever the count; here the chain reads the count
        first (one sync, host_syncs['chain_plan']) and launches only the
        groups that hold components."""
        B = self.DEVICE_BATCH
        hb, wb = self.line_shape_menu[-1]
        with self._track('dispatch_single_chain'):
            mono, para, lab, plan, n_comp, ok = self.single_page_chain(
                self._upload_pages([page]), 2 * B)
            # the count and the plan rows in one pull: the rows give the
            # crops' extents to a paragraph planned on the host
            got = self._wait(self._pull(torch.cat([
                torch.stack([ok.to(torch.int32), n_comp.to(torch.int32)]),
                plan.reshape(-1)]), 'chain_plan'), 'chain_plan')
            ok, n_comp = bool(got[0]), int(got[1])
            rows = got[2:].reshape(plan.shape)
            if not ok:
                self._count(chain_fallback=1)
            else:
                self._count(paragraphs=n_comp)
                groups = [self.paragraph_launch(mono, lab[None],
                                                plan[g * B:(g + 1) * B], hb,
                                                wb)
                          for g in range(-(-n_comp // B))]
        if not ok:
            with self._track('pull_para_bits'):
                para_host = self._wait(self._pull(para, 'para_bits'),
                                       'para_bits')
            return self._collect_chunk_device(self._dispatch_chunk_device(
                1, mono, para, para_host))[0]
        if not groups:
            return []
        nb = fused_tail.fused_payload_nbytes(B)
        with self._track('pull_fused_glyphs'):
            buf = self._wait(self._pull(
                torch.cat([small for _, _, (small, _) in groups]),
                'fused_glyphs'), 'fused_glyphs')
        hv, wv = (PARAGRAPH_FIELDS.index(k) for k in ('hv', 'wv'))
        result = []
        for g, (crops, bands, (_, lines)) in enumerate(groups):
            n = min(n_comp - g * B, B)
            hvs = [(int(r[hv]), int(r[wv])) for r in rows[g * B:g * B + n]]
            flat, direct = self._plan_fused_launch(
                n, buf[g * nb:(g + 1) * nb], bands, lines, hvs)
            refs = []
            if flat:
                with self._track('dispatch_line_stage'):
                    refs = self._dispatch_line_stage(crops, flat)
            result.extend(self._launch_texts(
                n, flat, [(ref_sel, self._pull(ids, 'char_ids'))
                          for ref_sel, ids in refs], direct))
        return result
