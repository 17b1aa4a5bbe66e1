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
monochrome map and every crop stay on the device.  Per chunk,
`front_resident` keeps the map and pulls only the paragraph mask; the
host labels it and plans each paragraph's crop (`_page_paragraph_plans`);
the paragraph stage resamples the deskewed crops and runs Line + band
threshold on the device; the host pulls what the line planner needs and
plans each line; the line stage gathers the zoomed lines and runs Char +
argmax on the device; the host pulls the ids and decodes.  Two modes:

  * parity (`exact_bands=True`, sampler 'gather'): the band masks come
    home and the host labels them (`_plan_lines`), as the host cascade
    does;
  * tables (`exact_bands=False`, sampler 'twopass', JAX's default;
    models/band_tables.py): the paragraph stage computes per-blob tables
    of the bands on the device and sends one small payload per launch;
    the host pairs lines from the tables (`_plan_lines_from_tables`), or,
    for paragraphs the device still flags as merged, from the folded
    profile in the payload (`_plan_lines_from_profile`).

The tables mode's default, as in JAX, is the fused tail (`fused_tail`,
on with an integer `collapse_runs`; models/fused_tail.py): the paragraph
stage goes on to plan the lines, crop them, run Char and decode the text
on the device, and the host pulls the glyph ids, one pull per wave of
SMALL_SLOTS launches; only the paragraphs the device flags re-plan on
the host from their tables payload.  With it, the paragraph plans come
from the device too (`device_chunk_plans`: a page CCL and the plan
arithmetic), pulled as one small matrix per chunk; a page the planner
cannot take (more than CHUNK_PLAN_K components, or a CCL over its sweep
cap) is planned on the host.  One page alone takes the single-page chain
(`_ocr_single_page_device`): front, `device_page_plans`, per-component
crops at the largest menu shape and the fused tail, falling back to the
chunk path when the planner cannot take the page.

A dispatcher thread runs chunk i+1's dispatch while the caller's thread
collects chunk i, and the paragraph launches of a chunk are handled in
parallel on the pool.

With a `mesh` (parallel/mesh.py), as in JAX, every launch batch of the
front and of the Line and Char stages splits over the mesh's 'data'
shards (parallel/serving.py): each shard runs the stage on its slice, on
its own device, with its own copy of the weights and of the kernels'
prepared weights, and the outputs merge in shard order on the mesh's
first device.  The page and crop stacks the gathers read are copied to
every shard once per chunk and once per paragraph launch; the fused tail
runs once per shard with the shard's own line pool, and the host merges
the shards' payload segments (`fused_tail.unpack_fused_payload`).  The
device planners and the single-page chain are off under a mesh, as in
JAX: chunks are planned on the host.

On the card Monochrome and the Char head run as the CUDA kernels
(ops/kernels), in float32 whatever the precision, as the JAX package's
Pallas kernels do; on the CPU they run as their plain versions in the
pipeline's precision, as the JAX package runs them without Pallas.  Both
cascades take the fused Char head: the JAX device cascade's width-8
convolution form (`fastpath.char_head_conv`) is slower on an H100.

Numerics follow the JAX pipeline: the uint8 rounding of the monochrome map
and of the crops (round half to even, as `jnp.round`), the `> 1e-6` mean
guards, the first-index argmax, the batch sizes and the shape menus.  The
JAX pipeline bit-packs the masks it moves; here they move as one byte per
pixel, with the same bits.

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
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy import ndimage

from .. import native, ops
from ..device import resolve_device
from ..interpreter import (_extremal_coords, band_components, bbox,
                           deskew_paragraph, extract_line,
                           find_rotation_angle, layer_components, pair_lines,
                           pred_ids_to_text, rotate_array)
from ..ops.kernels import fused_monochrome
from ..parallel.mesh import Replicated, mesh_device, replicate, to_device
from ..parallel.serving import shard_cascade_stage, shard_fn_over_batch
from ..weights import params_from_numpy, random_params
from .band_tables import (PROFILE_ROW_DS, _group_centers, _shear_span,
                          unpack_tables_payload)
from .bucketing import (CHAR_FIXED_WIDTH, CHAR_INPUT_HEIGHT, CHAR_WIDTH_MENU,
                        line_shape_menu, make_divisible_by, pick_char_width,
                        pick_line_shape)
from . import fused_tail
from .device_cascade import (LINE_FLT_FIELDS, LINE_INT_FIELDS,
                             PARAGRAPH_FLT_FIELDS, PARAGRAPH_INT_FIELDS,
                             _twopass_crops, device_chunk_plans,
                             device_page_plans, extract_paragraph_crops,
                             extract_paragraph_crops_resident,
                             paragraph_stage, paragraph_stage_rot_resident,
                             rot90_inverse_affine, rotate_affine,
                             unpack_line_plan, unpack_paragraph_plan,
                             zoom_output_width, zoom_ratio, zoomed_line_crops)
from .fastpath import (_mask_hw, char_forward_masked, char_head_weights,
                       line_forward_masked, monochrome_forward,
                       monochrome_weights)

#: seed of the generator behind `OCRPipeline(weights=None)`
RANDOM_INIT_SEED = 0
#: the fused tail's suspect bits, in fused_tail's order, as
#: escalation_stats counts them
SUSPECT_BITS = ('merge', 'cross', 'table_of', 'lines_of', 'pool_of',
                'trunc_of', 'glyph_of')


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


def _table_boxes(rows):
    """(slice y, slice x) bboxes of blob table rows [count, y0, y1, x0, x1,
    ...]."""
    return [(slice(int(r[1]), int(r[2])), slice(int(r[3]), int(r[4])))
            for r in rows]


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
    `device_cascade`, `exact_bands`, `sampler`, `escalation`,
    `fused_tail`: as in the JAX pipeline, every combination; the fused
    tail is on by default in the tables mode with an integer
    `collapse_runs`, and then chunks go through the device planner and
    single pages through the chain.  `mesh`: None, or a
    `parallel.make_mesh` mesh whose 'data' shards split every launch batch
    (its devices of `device`'s type; DEVICE_BATCH must divide over
    them).  Set `timers` to a
    `utils.profiling.StageTimers` to time the stages: in the host
    cascade also each host CV step on the pool threads, with the threads'
    CPU seconds in it (`host_cv_thread_cpu`), and the waits for the Line
    and Char results (`line_pull`, `char_pull`); in the device cascade,
    `timeline` then records every device-to-host pull as (tag, start,
    end, bytes).  Close the pipeline (`close()` or `with`)
    to shut its thread pools down.
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
                 exact_bands=False, escalation=True, sampler=None,
                 fused_tail=None, mesh=None):
        if sampler is None:
            sampler = 'gather' if exact_bands else 'twopass'
        if sampler not in ('gather', 'twopass'):
            raise ValueError(f'unknown sampler {sampler!r}')
        self.sampler = sampler
        self.band_tables = device_cascade and not exact_bands
        self.escalation = escalation
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
        #: tables-mode planning counters: paragraphs planned, and those
        #: re-planned from their profile because the device still flags
        #: them ('suspect') or their other axis finds separate lines
        #: ('cross_axis'); the fused tail adds 'capacity' (suspects for a
        #: cap only), one count per suspect bit (SUSPECT_BITS) and
        #: 'chain_fallback' (pages the device planner left to the host)
        self.escalation_stats = {'paragraphs': 0, 'suspect': 0,
                                 'cross_axis': 0}
        self._stats_lock = threading.Lock()
        #: tables-mode host syncs, by kind: 'suspect_check' (one per
        #: paragraph launch), 'grid_ccl_block' (one per block of grid-CCL
        #: sweeps; band_tables.tables_state), 'page_ccl_block' (the
        #: device planners' page CCL) and 'chain_plan' (the single-page
        #: chain reading its component count)
        self.host_syncs = Counter()
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
        distinct device), with the page and crop stacks as its
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
                ('stage_rot_blob', 2, ()), ('stage_rot_res', 3, (4, 5)),
                ('stage_blob_fused', 2, ()), ('stage_res_fused', 3, (4, 5)),
                ('line_stage', 2, (3, 4))):
            setattr(self, name, functools.partial(shard_cascade_stage(
                getattr(cls, name), mesh, n_replicated, statics), shards))

    def close(self):
        self._pool.shutdown(wait=True)
        self._xfer.shutdown(wait=True)

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
        """Masked Line forward + band threshold over each sample's valid
        region (the rule arr > 0.5 * (mean + max)) -> uint8 0/1 masks."""
        x = x_u8.float() / 255.0
        pred = line_forward_masked(self.params, x, h_valid, w_valid,
                                   prefix='Line', precision=self.precision)
        # zero the invalid region before the stats: the final sigmoid is
        # not masked inside line_forward_masked
        pred = _mask_hw(pred, h_valid, w_valid)
        hv = h_valid.reshape(-1, 1, 1, 1)
        wv = w_valid.reshape(-1, 1, 1, 1)
        rows = torch.arange(pred.shape[1], device=pred.device).reshape(
            1, -1, 1, 1)
        cols = torch.arange(pred.shape[2], device=pred.device).reshape(
            1, 1, -1, 1)
        valid = (rows < hv) & (cols < wv)
        area = (hv * wv).float()
        mean = pred.sum(dim=(1, 2), keepdim=True) / area
        mx = pred.amax(dim=(1, 2), keepdim=True)
        mask = ((pred - 0.5 * (mean + mx)) > 1e-6) & valid
        return mask.to(torch.uint8)

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

    def stage_rot_blob(self, mono_stack, blob, plan):
        """Paragraph stage with the blobs uploaded: (crops, band masks or
        tables payload)."""
        iv, fv = unpack_paragraph_plan(plan)
        return paragraph_stage(
            self.params, mono_stack, blob, iv['page'], iv['y0'], iv['x0'],
            iv['h'], iv['w'], fv['cos'], fv['sin'], fv['off_y'],
            fv['off_x'], iv['ry0'], iv['rx0'], iv['out_h'], iv['out_w'],
            iv['py'], iv['px'], iv['hv'], iv['wv'], precision=self.precision,
            tables=self.band_tables, sampler=self.sampler,
            syncs=self.host_syncs)

    def stage_rot_res(self, mono_stack, para_stack, plan, hb, wb):
        """Paragraph stage with the blobs read from the resident mask."""
        iv, fv = unpack_paragraph_plan(plan)
        return paragraph_stage_rot_resident(
            self.params, mono_stack, para_stack, iv['page'], iv['y0'],
            iv['x0'], iv['h'], iv['w'], fv['cos'], fv['sin'], fv['off_y'],
            fv['off_x'], iv['ry0'], iv['rx0'], iv['out_h'], iv['out_w'],
            iv['py'], iv['px'], iv['hv'], iv['wv'], hb, wb,
            precision=self.precision, tables=self.band_tables,
            sampler=self.sampler, syncs=self.host_syncs)

    def _fused_tail(self, crops, h_valid, w_valid):
        return fused_tail.fused_paragraph_tail(
            self.params, crops, h_valid, w_valid, precision=self.precision,
            min_run=max(int(self.collapse_runs), 1),
            char_head=self.char_head, syncs=self.host_syncs)

    def stage_blob_fused(self, mono_stack, blob, plan):
        """Fused paragraph stage with the blobs uploaded: (sheared crops,
        glyph payload, tables payload)."""
        iv, fv = unpack_paragraph_plan(plan)
        crops = extract_paragraph_crops(
            mono_stack, blob, iv['page'], iv['y0'], iv['x0'], iv['h'],
            iv['w'], fv['cos'], fv['sin'], fv['off_y'], fv['off_x'],
            iv['ry0'], iv['rx0'], iv['out_h'], iv['out_w'], iv['py'],
            iv['px'], precision=self.precision, sampler=self.sampler)
        return self._fused_tail(crops, iv['hv'], iv['wv'])

    def stage_res_fused(self, mono_stack, para_stack, plan, hb, wb):
        """Fused paragraph stage with the blobs read from the resident
        mask."""
        iv, fv = unpack_paragraph_plan(plan)
        crops = extract_paragraph_crops_resident(
            mono_stack, para_stack, iv['page'], iv['y0'], iv['x0'],
            iv['h'], iv['w'], fv['cos'], fv['sin'], fv['off_y'],
            fv['off_x'], iv['ry0'], iv['rx0'], iv['out_h'], iv['out_w'],
            iv['py'], iv['px'], hb, wb, precision=self.precision,
            sampler=self.sampler)
        return self._fused_tail(crops, iv['hv'], iv['wv'])

    def _component_crops(self, pages, labels, root, plan, hb, wb):
        """Two-pass crops of device-planned components: each plan's
        source is its page masked to its own component (root label), so
        every crop is blob-exact with nothing uploaded."""
        iv, fv = unpack_paragraph_plan(plan)
        masked = pages * (labels == root[:, None, None]).to(pages.dtype)
        return _twopass_crops(
            masked, None, torch.arange(masked.shape[0], device=masked.device),
            iv['y0'], iv['x0'], iv['h'], iv['w'], fv['cos'], fv['sin'],
            fv['off_y'], fv['off_x'], iv['ry0'], iv['rx0'], iv['out_h'],
            iv['out_w'], iv['py'], iv['px'], hb, wb,
            precision=self.precision), iv

    def stage_labeled_fused(self, mono_stack, labels_stack, plan, hb, wb):
        """Fused paragraph stage of device-planned plans: `plan` carries
        the component's root label as its last column, and labels_stack
        the chunk's (N, H, W) CCL labels."""
        page = plan[:, 0].to(torch.int64)
        crops, iv = self._component_crops(
            mono_stack[:, :, :, 0][page], labels_stack[page],
            plan[:, -1].to(torch.int64), plan[:, :-1], hb, wb)
        return self._fused_tail(crops, iv['hv'], iv['wv'])

    def chunk_planner(self, para_stack):
        """device_chunk_plans at CHUNK_PLAN_K, its results packed into ONE
        float32 vector [plans (B, K, 18) | menu_idx (B, K) | n_comp (B)]
        (integers below 2^24 are exact).  Returns (labels, packed,
        converged)."""
        labels, plans, menu_idx, n_comp, converged = device_chunk_plans(
            para_stack, tuple(self.line_shape_menu), k_max=self.CHUNK_PLAN_K,
            syncs=self.host_syncs)
        packed = torch.cat([plans.reshape(-1),
                            menu_idx.to(torch.float32).reshape(-1),
                            n_comp.to(torch.float32)])
        return labels, packed, converged

    def line_stage(self, crop_stack, plan, out_h, out_w):
        """Zoomed line crops (one gather) + Char forward + argmax -> (B,
        out_w) uint8 ids, 255 at columns at or past each line's true
        width.  In 'bf16' the Char forward's first convolution rounds the
        gathered values to bfloat16, as the JAX package rounds the crop
        before its one-hot zoom."""
        iv, fv = unpack_line_plan(plan)
        w_valid = iv['w_valid']
        lines = zoomed_line_crops(
            crop_stack, iv['para_idx'], fv['ratio_y'], fv['ratio_x'],
            iv['w_out'], iv['a_yy'], iv['a_yx'], iv['b_y'], iv['a_xy'],
            iv['a_xx'], iv['b_x'], out_h, out_w)
        logits = char_forward_masked(self.params, lines, w_valid,
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
    def _line_menu_shape(self, h, w, shear_margin=False):
        """Smallest menu bucket holding (h, w); shear_margin=True (the
        tables mode) also reserves the shear span on both axes, so content
        the device de-tilt shifts (band_tables._shear_rows) stays in
        frame."""
        if not shear_margin:
            return pick_line_shape(self.line_shape_menu, h, w)
        for hb, wb in self.line_shape_menu:
            if (h + 2 * _shear_span(wb) <= hb
                    and w + 2 * _shear_span(hb) <= wb):
                return hb, wb
        return self.line_shape_menu[-1]

    def _page_paragraph_plans(self, page_idx, para2d):
        """Label one page's paragraph mask and plan each blob's crop for
        the affine samplers: level paragraphs (angle None) carry the
        identity affine, deskewed ones the scipy rotate affine.  With the
        'twopass' sampler the rotated bbox is analytic, from the blob's
        extremal pixels, where the gather takes it from a scipy rotate of
        the blob."""
        labels, _ = native.label(para2d > 0)
        plans = []
        for label_id, sl in enumerate(ndimage.find_objects(labels), start=1):
            if sl is None:
                continue
            blob = labels[sl] == label_id
            h, w = blob.shape
            angle = find_rotation_angle(blob[None, :, :, None])
            if angle is None:
                (cos_a, sin_a), off = (1.0, 0.0), (0.0, 0.0)
                ry0 = rx0 = 0
                out_h, out_w = h, w
            elif self.sampler == 'twopass':
                # hull-projection extremes plus the order-0 sampling
                # margin, rounded outward: at most a pixel looser than the
                # rotated mask's bbox, which only adds zero rows/cols
                # inside the masked crop
                (rh, rw), (cos_a, sin_a), off = rotate_affine(angle, h, w)
                coords = _extremal_coords(blob)
                dy = coords[:, 0] - off[0]
                dx = coords[:, 1] - off[1]
                proj_y = cos_a * dy - sin_a * dx
                proj_x = sin_a * dy + cos_a * dx
                m = (abs(cos_a) + abs(sin_a)) / 2.0
                ry0 = max(int(np.floor(proj_y.min() - m)), 0)
                rx0 = max(int(np.floor(proj_x.min() - m)), 0)
                y1 = min(int(np.ceil(proj_y.max() + m)), rh - 1)
                x1 = min(int(np.ceil(proj_x.max() + m)), rw - 1)
                out_h, out_w = y1 - ry0 + 1, x1 - rx0 + 1
            else:
                _, (cos_a, sin_a), off = rotate_affine(angle, h, w)
                # nearest rotation of the 0/1 mask as uint8: the values of
                # rotating the boolean mask, which find_objects refuses on
                # some scipy versions
                rot0 = rotate_array(blob[None, :, :, None].astype(np.uint8),
                                    angle, good_rotation=False)
                _, ry, rx, _ = bbox(rot0)
                ry0, rx0 = ry.start, rx.start
                out_h, out_w = ry.stop - ry.start, rx.stop - rx.start
            # make_divisible_by: CENTER pad, always adding at least one
            # row/column; the Line model's stride-2 convs are phase
            # sensitive, so placement must match the host path exactly
            pad_h, pad_w = 16 - out_h % 16, 16 - out_w % 16
            hv, wv = out_h + pad_h, out_w + pad_w
            py, px = pad_h // 2, pad_w // 2
            # the two-pass sampler folds near-90-degree rotations through
            # a rot90 of the source, so the bucket must hold the
            # transposed source extent too
            rot90_fold = self.sampler == 'twopass' and abs(sin_a) > abs(cos_a)
            hb, wb = self._line_menu_shape(
                max(h, hv, w if rot90_fold else 0),
                max(w, wv, h if rot90_fold else 0),
                shear_margin=self.band_tables)
            # a rotated page-diagonal paragraph can exceed the page-sized
            # menu: clamp
            out_h, hv = min(out_h, hb), min(hv, hb)
            out_w, wv = min(out_w, wb), min(wv, wb)
            # when the bbox holds pixels of no other component, the blob
            # is the resident mask inside the bbox: no upload needed
            region = labels[sl]
            needs_blob = bool(((region > 0) & (region != label_id)).any())
            # the blob in bbox-local coords at (0, 0)
            buf = np.zeros((hb, wb), np.uint8)
            buf[:min(h, hb), :min(w, wb)] = blob[:hb, :wb]
            plans.append({
                'page': page_idx, 'y0': sl[0].start, 'x0': sl[1].start,
                'h': h, 'w': w, 'cos': cos_a, 'sin': sin_a,
                'off_y': off[0], 'off_x': off[1], 'ry0': ry0, 'rx0': rx0,
                'out_h': out_h, 'out_w': out_w, 'py': py, 'px': px,
                'hv': hv, 'wv': wv, 'rotated': angle is not None,
                'needs_blob': needs_blob, 'menu': (hb, wb), 'blob': buf,
            })
        return plans

    #: label_layer semantics on one band channel: per-blob bboxes and
    #: centres of mass from one labelling pass
    _band_blob_stats = staticmethod(layer_components)

    def _plan_lines(self, bands):
        """Line gather plans from one paragraph's thresholded (H, W, 2)
        band masks: the geometry half of crop_lines_of_paragraph."""
        top_boxes, cm_top = self._band_blob_stats(bands[:, :, 0])
        bottom_boxes, cm_bottom = self._band_blob_stats(bands[:, :, 1])
        bboxes, rotation = self._pair_lines(top_boxes, cm_top,
                                            bottom_boxes, cm_bottom)
        return self._plans_from_bboxes(bboxes, rotation)

    @classmethod
    def _pair_lines(cls, top_boxes, cm_top, bottom_boxes, cm_bottom,
                    merge_fragments=False):
        """pair_lines for the mask, table and profile planners, with
        `merge_fragments` uniting the lines whose tops picked the same
        bottom.  Returns (line bboxes, rot90 code)."""
        bboxes, picks, rotation = pair_lines(top_boxes, cm_top,
                                             bottom_boxes, cm_bottom)
        if merge_fragments:
            bboxes = cls._merge_line_bboxes(bboxes, picks)
        return bboxes, rotation

    def _plan_lines_from_profile(self, prof_bits, axis, hb, wb):
        """Escalation planner: line plans from one paragraph's bit-packed
        (L, G*C/8) closed column-group profile (the tables payload's last
        part).  8-connected components of the (rows, G) grid separate the
        staggered lines the row runs merged; coordinates are quantized by
        the group width across the stacking axis and by PROFILE_ROW_DS
        along it.  axis: the device's stacking axis; the profile is the
        view of the sheared bands (axis 0) or of their transpose (1)."""
        view_h, view_w = (hb, wb) if axis == 0 else (wb, hb)
        ds = PROFILE_ROW_DS
        rows = -(-view_h // ds)
        G, gw, _ = _group_centers(view_w)
        bits = np.unpackbits(np.asarray(prof_bits), axis=1)
        prof = bits[:rows].reshape(rows, G, 2).astype(bool)

        eight = np.ones((3, 3), bool)   # diagonal staircases connect
        stats = []
        for c in range(2):
            labels, cnt = ndimage.label(prof[:, :, c], structure=eight)
            if cnt == 0:
                return []
            boxes, centers = [], []
            coords = np.argwhere(labels > 0)
            lab = labels[labels > 0]
            for blob in range(1, cnt + 1):
                pts = coords[lab == blob].astype(float)
                (y0, g0), (y1, g1) = pts.min(axis=0), pts.max(axis=0)
                box = (slice(int(y0) * ds, min(int(y1 + 1) * ds, view_h)),
                       slice(int(g0) * gw, min(int(g1 + 1) * gw, view_w)))
                cy = pts[:, 0].mean() * ds + (ds - 1) / 2.0
                cx = pts[:, 1].mean() * gw + (gw - 1) / 2.0
                if axis == 1:           # view coordinates -> the image's
                    box = (box[1], box[0])
                    cy, cx = cx, cy
                boxes.append(box)
                centers.append((cy, cx))
            stats.append((boxes, np.asarray(centers)))
        (top_boxes, cm_top), (bottom_boxes, cm_bottom) = stats
        bboxes, rotation = self._pair_lines(top_boxes, cm_top, bottom_boxes,
                                            cm_bottom, merge_fragments=True)
        return self._plans_from_bboxes(bboxes, rotation)

    @staticmethod
    def _merge_line_bboxes(bboxes, picks):
        """Union the line bboxes whose tops paired with the same bottom
        component: a fragmented top band over one solid bottom is one line
        (the training bands are solid bars, so fragments are Line-model
        noise)."""
        if len(bboxes) < 2:
            return bboxes
        grouped = {}
        for box, pk in zip(bboxes, picks):
            if pk in grouped:
                prev = grouped[pk]
                grouped[pk] = tuple(
                    slice(min(prev[d].start, box[d].start),
                          max(prev[d].stop, box[d].stop))
                    for d in (0, 1))
            else:
                grouped[pk] = box
        return list(grouped.values())

    @staticmethod
    def _cross_axis_escalation(tbl, nb, axis):
        """True when the axis not chosen resolves more blobs than the
        chosen one and they are separate lines: some gap between them
        along the run axis exceeds 0.8 of the smaller neighbour's extent
        across it (side-by-side lines the paragraph CCL merged into one
        crop; word-gap fragments have smaller gaps)."""
        other = 1 - axis
        cap = tbl.shape[1]
        lo, hi = (1, 2) if other == 0 else (3, 4)
        clo, chi = (3, 4) if other == 0 else (1, 2)
        for ch in range(tbl.shape[3]):
            n_o = min(int(nb[other, ch]), cap)
            n_c = min(int(nb[axis, ch]), cap)
            if n_o <= max(n_c, 1):
                continue
            t = tbl[other, :n_o, :, ch]
            order = np.argsort(t[:, lo], kind='stable')
            ivs = t[order][:, [lo, hi]]
            gaps = ivs[1:, 0] - ivs[:-1, 1]
            heights = t[order][:, chi] - t[order][:, clo]
            hmin = np.minimum(heights[1:], heights[:-1])
            if (gaps > 0.8 * hmin).any():
                return True
        return False

    def _plan_lines_from_tables(self, tbl, nb, axis):
        """Line gather plans from one paragraph's blob tables (fields
        [count, y0, y1, x0, x1, cy, cx] in the sheared coordinates that
        index the returned crops): _plan_lines' pairing on precomputed
        blobs, merging tops that pick the same bottom.  tbl (2, M, 7, 2),
        nb (2, 2); axis: the device's stacking axis."""
        cap = tbl.shape[1]
        if nb.max() > cap:
            print(f'WARNING: band blob table overflow ({int(nb.max())} > '
                  f'{cap} blobs); extra blobs dropped', file=sys.stderr)
        n_top = min(int(nb[axis, 0]), cap)
        n_bottom = min(int(nb[axis, 1]), cap)
        if n_top == 0 or n_bottom == 0:
            return []
        top = tbl[axis, :n_top, :, 0]
        bottom = tbl[axis, :n_bottom, :, 1]
        # two tops picking the same bottom are one line: without the merge
        # the page decodes the same glyphs twice
        bboxes, rotation = self._pair_lines(
            _table_boxes(top), top[:, 5:7], _table_boxes(bottom),
            bottom[:, 5:7], merge_fragments=True)
        return self._plans_from_bboxes(bboxes, rotation)

    @staticmethod
    def _plans_from_bboxes(bboxes, rotation):
        line_plans = []
        for y, x in bboxes:
            h_l, w_l = y.stop - y.start, x.stop - x.start
            (lh, lw), (a_yy, a_yx, b_y, a_xy, a_xx, b_x) = (
                rot90_inverse_affine(rotation, h_l, w_l))
            zf = CHAR_INPUT_HEIGHT / lh
            w_out = zoom_output_width(lw, zf)
            line_plans.append({
                'ratio_y': zoom_ratio(lh, CHAR_INPUT_HEIGHT),
                'ratio_x': zoom_ratio(lw, w_out),
                'w_out': w_out,
                'a_yy': a_yy, 'a_yx': a_yx, 'b_y': b_y + y.start,
                'a_xy': a_xy, 'a_xx': a_xx, 'b_x': b_x + x.start,
                'w_valid': max(w_out, CHAR_FIXED_WIDTH),
            })
        return line_plans

    # -- device cascade: launches --------------------------------------------
    def _dispatch_paragraph_stage(self, stacks, plans, labels_dev=None):
        """Launch the crop + Line stage for all plans, grouped by shape
        menu; bboxes of one component read the resident mask, the others
        upload their blobs.  Device-planned plans (those with a 'root'
        component label) group apart and take the labeled stage with
        `labels_dev`.  Returns [(plan indices, crops, glyph payload or
        None, band masks or tables payload)], all on the device."""
        mono_dev, para_dev = stacks
        groups = {}
        for i, plan in enumerate(plans):
            groups.setdefault((plan['menu'], 'root' in plan), []).append(i)
        B = self.DEVICE_BATCH
        ni = len(PARAGRAPH_INT_FIELDS)
        launches = []
        for ((hb, wb), labeled), idxs in groups.items():
            # blob-needing plans first, so that as few launches as
            # possible upload blobs; the launch count stays ceil(n / B)
            idxs = sorted(idxs, key=lambda i: not plans[i]['needs_blob'])
            start = 0
            while start < len(idxs):
                # a tail of 4 or fewer plans takes a batch of 4, as in the
                # JAX package's parity mode; under a mesh every batch
                # divides over the data shards
                Bsub = (4 if len(idxs) - start <= 4 and self.mesh is None
                        else B)
                sel = idxs[start:start + Bsub]
                start += Bsub
                needs_blob = any(plans[i]['needs_blob'] for i in sel)
                mat = np.zeros((Bsub, ni + len(PARAGRAPH_FLT_FIELDS)
                                + labeled), np.float32)
                # filler rows: a harmless 4x4 crop at the stack origin
                for ci, k in enumerate(PARAGRAPH_INT_FIELDS):
                    if k in ('h', 'w', 'out_h', 'out_w', 'hv', 'wv',
                             'y0', 'x0'):
                        mat[:, ci] = 4
                mat[:, ni] = 1.0                         # cos
                if labeled:
                    mat[:, -1] = -1                      # no component
                blob = (np.zeros((Bsub, hb, wb), np.uint8) if needs_blob
                        else None)
                for bi, i in enumerate(sel):
                    plan = plans[i]
                    if needs_blob:
                        blob[bi] = plan['blob']
                    for ci, k in enumerate(PARAGRAPH_INT_FIELDS):
                        mat[bi, ci] = plan[k]
                    for ci, k in enumerate(PARAGRAPH_FLT_FIELDS):
                        mat[bi, ni + ci] = plan[k]
                    if labeled:
                        mat[bi, -1] = plan['root']
                pv = self._tensor(mat)
                if labeled:
                    out = self.stage_labeled_fused(mono_dev, labels_dev, pv,
                                                   hb, wb)
                elif self.fused_tail and needs_blob:
                    out = self.stage_blob_fused(mono_dev, self._tensor(blob),
                                                pv)
                elif self.fused_tail:
                    out = self.stage_res_fused(mono_dev, para_dev, pv, hb, wb)
                elif needs_blob:
                    out = self.stage_rot_blob(mono_dev, self._tensor(blob),
                                              pv)
                else:
                    out = self.stage_rot_res(mono_dev, para_dev, pv, hb, wb)
                if not self.fused_tail:
                    out = (out[0], None, out[1])
                launches.append((sel,) + tuple(out))
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
        ni = len(LINE_INT_FIELDS)
        launches = []
        for start in range(0, len(line_plans), B):
            sel = list(range(start, min(start + B, len(line_plans))))
            mat = np.zeros((B, ni + len(LINE_FLT_FIELDS)), np.float32)
            mat[:, LINE_INT_FIELDS.index('w_valid')] = CHAR_FIXED_WIDTH
            for bi, ref in enumerate(sel):
                slot, plan = line_plans[ref]
                mat[bi, 0] = slot                        # para_idx
                for ci, k in enumerate(LINE_INT_FIELDS[1:], start=1):
                    mat[bi, ci] = plan[k]
                for ci, k in enumerate(LINE_FLT_FIELDS):
                    mat[bi, ni + ci] = plan[k]
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
        start the pull of its paragraph mask.  Returns (pages, map, mask,
        future of the host mask or None)."""
        mono_dev, para_dev = self.front_resident(self._upload_pages(chunk))
        bits = (None if self._device_planner
                else self._pull(para_dev, 'para_bits'))
        return len(chunk), mono_dev, para_dev, bits

    def _dispatch_chunk_device(self, n_pages, mono_dev, para_dev, para):
        """Dispatch phase of one chunk: paragraph plans and stage launches
        with their payload pulls in flight, then, per paragraph launch on
        the pool, line plans and line-stage launches with their id pulls in
        flight.  Never waits for a result the collect phase can wait for.
        `para` is the host copy of the (n, H, W, 1) paragraph mask."""
        mono_dev = self._pad_stack(mono_dev)
        # the float 0/1 stack the resident crop gather reads
        para_dev = self._pad_stack(para_dev).float()
        if self.mesh is not None:
            # every shard's gathers read the whole stacks: one copy to
            # each shard's device per chunk
            mono_dev = replicate(mono_dev, self.mesh)
            para_dev = replicate(para_dev, self.mesh)
        with self._track('host_paragraph_plans'):
            # serial: scipy's ndimage calls hold the GIL
            plans = [p
                     for page in range(n_pages)
                     for p in self._page_paragraph_plans(page,
                                                         para[page, :, :, 0])]
        return self._finish_dispatch(n_pages, mono_dev, para_dev, plans)

    def _dispatch_chunk_device_planned(self, n_pages, mono_dev, para_dev):
        """Dispatch phase of one chunk planned on the device: the chunk
        planner's one small plan matrix replaces the paragraph-mask pull
        and the host planning; a page it cannot take (more than
        CHUNK_PLAN_K components, or the CCL over its cap) is planned on
        the host from the pulled mask, counted in
        escalation_stats['chain_fallback'].  Planned crops are
        component-exact (stage_labeled_fused): no blob is uploaded."""
        K = self.CHUNK_PLAN_K
        menu = self.line_shape_menu
        mono_dev = self._pad_stack(mono_dev)
        para_f = self._pad_stack(para_dev).float()
        labels_dev, packed, converged = self.chunk_planner(para_f[..., 0])
        with self._track('pull_plan_matrix'):
            flat = self._pull(packed, 'plan_matrix').result()
        B = self.chunk
        nf = len(PARAGRAPH_INT_FIELDS) + len(PARAGRAPH_FLT_FIELDS) + 1
        o = B * K * nf
        mats = flat[:o].reshape(B, K, nf)
        menu_idx = flat[o:o + B * K].reshape(B, K).astype(np.int64)
        n_comp = flat[o + B * K:].astype(np.int64)

        ni = len(PARAGRAPH_INT_FIELDS)
        plans = []
        para = None
        with self._track('host_paragraph_plans'):
            for page in range(n_pages):
                if converged and n_comp[page] <= K:
                    for k in range(int(n_comp[page])):
                        row = mats[page, k]
                        plan = {f: int(row[ci]) for ci, f in
                                enumerate(PARAGRAPH_INT_FIELDS)}
                        plan.update({f: float(row[ni + ci]) for ci, f in
                                     enumerate(PARAGRAPH_FLT_FIELDS)})
                        plan.update(page=page, menu=menu[menu_idx[page, k]],
                                    root=int(row[-1]), needs_blob=False)
                        plans.append(plan)
                    continue
                with self._stats_lock:
                    st = self.escalation_stats
                    st['chain_fallback'] = st.get('chain_fallback', 0) + 1
                if para is None:
                    with self._track('pull_para_bits'):
                        para = self._pull(para_dev, 'para_bits').result()
                plans.extend(self._page_paragraph_plans(page,
                                                        para[page, :, :, 0]))
        return self._finish_dispatch(n_pages, mono_dev, para_f, plans,
                                     labels_dev=labels_dev)

    def _finish_dispatch(self, n_pages, mono_dev, para_dev, plans,
                         labels_dev=None):
        with self._track('dispatch_paragraph_stage'):
            launches = self._dispatch_paragraph_stage(
                (mono_dev, para_dev), plans, labels_dev=labels_dev)
        if self.fused_tail:
            futures = self._pull_glyph_waves(launches)
        else:
            futures = [self._pull(payload, 'bands')
                       for _, _, _, payload in launches]

        def handle_launch(item):
            """Payload -> line plans -> line-stage launches for ONE
            paragraph launch; launches run in parallel, so pulls, host
            planning and dispatches overlap.  In the fused mode only the
            flagged paragraphs are planned here."""
            (sel, crops_dev, _, payload), fut = item
            direct = None
            if self.fused_tail:
                wave, row, nbytes = fut
                with self._track('pull_fused_glyphs'):
                    buf = wave.result()[row, :nbytes]
                flat, direct = self._plan_fused_launch(
                    len(sel), buf, payload,
                    [plans[i]['menu'] for i in sel])
            elif self.band_tables:
                flat = self._plan_launch_from_tables(sel, plans, fut)
            else:
                with self._track('pull_band_masks'):
                    bands = fut.result()
                with self._track('host_line_plans'):
                    flat = []
                    for bi in range(len(sel)):
                        plan = plans[sel[bi]]
                        view = bands[bi, :plan['hv'], :plan['wv'], :] > 0
                        flat.extend((bi, lp) for lp in self._plan_lines(view))
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
            for wi, (_, _, small, _) in enumerate(wave):
                acc[wi, :small.shape[0]] = small
            fut = self._pull(acc, 'fused_glyphs')
            futures.extend((fut, wi, small.shape[0])
                           for wi, (_, _, small, _) in enumerate(wave))
        return futures

    def _plan_fused_launch(self, n, buf, payload_dev, menus):
        """One fused launch's host side: its n paragraphs' glyph payload
        `buf` unpacked and counted in escalation_stats; the flagged
        paragraphs' tables payload pulled and their lines planned (from
        the profile for the geometry bits, with escalation on, else from
        the tables, which the caps leave intact).  `menus` holds each
        paragraph's (hb, wb).  Returns (line plans [(slot, plan)] of the
        flagged paragraphs, {slot: decoded lines} of the others)."""
        texts, suspects = fused_tail.unpack_fused_payload(
            buf, n, n_shards=self._n_data)
        counts = Counter(paragraphs=n,
                         cross_axis=int(((suspects >> 1) & 1).sum()),
                         capacity=int((suspects >= 4).sum()))
        for b, name in enumerate(SUSPECT_BITS):
            counts[name] = int(((suspects >> b) & 1).sum())
        direct = {bi: texts[bi] for bi in range(n) if not suspects[bi]}
        flat = []
        if suspects.any():
            with self._track('pull_band_tables'):
                (tables, n_blobs, _, axes, _,
                 profiles) = unpack_tables_payload(
                    self._pull(payload_dev, 'bands').result())
            with self._track('host_line_plans'):
                for bi in np.flatnonzero(suspects):
                    counts['suspect'] += 1
                    ax = int(axes[bi])
                    if self.escalation and int(suspects[bi]) & 0b111:
                        lps = self._plan_lines_from_profile(
                            profiles[bi], ax, *menus[bi])
                    else:
                        lps = self._plan_lines_from_tables(
                            tables[bi], n_blobs[bi], ax)
                    flat.extend((int(bi), lp) for lp in lps)
        with self._stats_lock:
            for key, v in counts.items():
                self.escalation_stats[key] = (
                    self.escalation_stats.get(key, 0) + v)
        return flat, direct

    def _plan_launch_from_tables(self, sel, plans, fut):
        """The tables mode's line plans for one paragraph launch: from the
        tables, or from the folded profile for paragraphs the device still
        flags as suspect or whose other axis finds separate lines (the
        profile is in the same payload, so escalating costs no extra
        pull).  Returns [(slot, line plan)]."""
        with self._track('pull_band_tables'):
            (tables, n_blobs, _shears, axes, suspects,
             profiles) = unpack_tables_payload(fut.result())
        counts = {'paragraphs': 0, 'suspect': 0, 'cross_axis': 0}
        with self._track('host_line_plans'):
            flat = []
            for bi in range(len(sel)):
                ax = int(axes[bi])
                counts['paragraphs'] += 1
                escalate = False
                if bool(suspects[bi]):
                    counts['suspect'] += 1
                    escalate = True
                elif self._cross_axis_escalation(tables[bi], n_blobs[bi], ax):
                    counts['cross_axis'] += 1
                    escalate = True
                if escalate and self.escalation:
                    hb, wb = plans[sel[bi]]['menu']
                    lps = self._plan_lines_from_profile(profiles[bi], ax,
                                                        hb, wb)
                else:
                    lps = self._plan_lines_from_tables(tables[bi],
                                                       n_blobs[bi], ax)
                flat.extend((bi, lp) for lp in lps)
        with self._stats_lock:
            for key, n in counts.items():
                self.escalation_stats[key] += n
        return flat

    def _launch_texts(self, n, flat, id_futures, direct):
        """The line texts of one paragraph launch's n paragraphs: the
        decoded ids of its line-stage launches, and the device-decoded
        lines of the paragraphs in `direct` (the fused tail's)."""
        line_texts = [None] * len(flat)
        for ref_sel, fut in id_futures:
            with self._track('pull_char_ids'):
                ids = fut.result()
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
                            para = bits.result()
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
        planned in the largest menu frame.  Returns (map, mask, labels,
        roots, plans, n_comp, ok) on the device (device_page_plans)."""
        hb, wb = self.line_shape_menu[-1]
        mono, para = self.front_resident(page_u8)
        return (mono, para) + device_page_plans(
            para[0, :, :, 0], hb, wb, k_max=k2, syncs=self.host_syncs)

    def _ocr_single_page_device(self, page):
        """The one-page latency path: front, device planner, component
        crops and fused tails, with one read of the planner's result and
        one pull of the glyph payloads.  A page the planner cannot take
        (more than 2 * DEVICE_BATCH components, or the CCL over its cap)
        takes the host-planned chunk path, counted in
        escalation_stats['chain_fallback']; flagged paragraphs re-plan on
        the host, as in the chunk path.

        The JAX package runs both groups of DEVICE_BATCH components as
        one program whatever the count; here the chain reads the count
        first (one sync, host_syncs['chain_plan']) and launches only the
        groups that hold components."""
        B = self.DEVICE_BATCH
        hb, wb = self.line_shape_menu[-1]
        with self._track('dispatch_single_chain'):
            mono, para, lab, roots, plan, n_comp, ok = self.single_page_chain(
                self._upload_pages([page]), 2 * B)
            self.host_syncs['chain_plan'] += 1
            ok, n_comp = (int(v) for v in self._pull(
                torch.stack([ok.to(torch.int64), n_comp]),
                'chain_plan').result())
            if not ok:
                with self._stats_lock:
                    st = self.escalation_stats
                    st['chain_fallback'] = st.get('chain_fallback', 0) + 1
            else:
                groups = []
                for g in range(-(-n_comp // B)):
                    rows = slice(g * B, (g + 1) * B)
                    crops, iv = self._component_crops(
                        mono[:, :, :, 0].expand(B, -1, -1), lab[None],
                        roots[rows], plan[rows], hb, wb)
                    groups.append(self._fused_tail(crops, iv['hv'],
                                                   iv['wv']))
        if not ok:
            with self._track('pull_para_bits'):
                para_host = self._pull(para, 'para_bits').result()
            return self._collect_chunk_device(self._dispatch_chunk_device(
                1, mono, para, para_host))[0]
        if not groups:
            return []
        nb = fused_tail.fused_payload_nbytes(B)
        with self._track('pull_fused_glyphs'):
            buf = self._pull(torch.cat([small for _, small, _ in groups]),
                             'fused_glyphs').result()
        result = []
        for g, (crops, _, tables) in enumerate(groups):
            n = min(n_comp - g * B, B)
            flat, direct = self._plan_fused_launch(
                n, buf[g * nb:(g + 1) * nb], tables, [(hb, wb)] * n)
            refs = []
            if flat:
                with self._track('dispatch_line_stage'):
                    refs = self._dispatch_line_stage(crops, flat)
            result.extend(self._launch_texts(
                n, flat, [(ref_sel, self._pull(ids, 'char_ids'))
                          for ref_sel, ids in refs], direct))
        return result
