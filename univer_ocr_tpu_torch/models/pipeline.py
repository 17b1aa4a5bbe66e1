"""Batched OCR inference, host cascade (univer_ocr_tpu/models/pipeline.py
with `device_cascade=False`).

Per chunk of pages:
  1. `front` on the device: Monochrome (the fused kernel) and Paragraph
     over the whole chunk, then the mean threshold of the paragraph mask;
  2. host: label each page's paragraph mask, crop and deskew each
     paragraph of the monochrome map (a thread pool across pages);
  3. `line_masks` on the device: the masked Line forward and its band
     threshold over every paragraph crop of the chunk, in fixed batches of
     bucket-shaped crops;
  4. host: crop and zoom each line band (the thread pool again);
  5. `char_ids` on the device: the masked Char forward (the fused head
     kernel) and the argmax over every line of the chunk;
  6. host: decode the ids to text.

Numerics follow the JAX pipeline: the uint8 rounding of the monochrome map
and of the crops (round half to even, as `jnp.round`), the `> 1e-6` mean
guards, the first-index argmax, `DEVICE_BATCH = 16` and the shape menus.
The JAX pipeline bit-packs the masks for its transfers; here they move as
one byte per pixel, with the same bits.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy import ndimage

from .. import ops
from ..device import resolve_device
from ..interpreter import (bbox, crop_and_rotate_single_paragraph,
                           label_layer, pred_ids_to_text, rearrange_lines,
                           rotate_array)
from ..weights import load_checkpoint, params_from_numpy
from .bucketing import (CHAR_FIXED_WIDTH, CHAR_INPUT_HEIGHT, CHAR_WIDTH_MENU,
                        line_shape_menu, make_divisible_by, pick_char_width,
                        pick_line_shape)
from ..ops.kernels import fused_monochrome
from .fastpath import (_mask_hw, char_forward_masked, char_head_weights,
                       line_forward_masked, monochrome_weights)


def crop_lines_of_paragraph(line_pred, mono_crop, zoomed_height,
                            minimal_width, thresholded_input=False):
    """Line bands of one paragraph -> list of zoomed line crops of the
    monochrome image.  `thresholded_input` marks line_pred as already
    thresholded band masks (the device-side threshold)."""
    def thresholded(arr):
        if thresholded_input:
            return arr > 0
        return arr > 0.5 * (np.mean(arr) + np.max(arr))

    top = thresholded(line_pred[:, :, :, 0:1])
    bottom = thresholded(line_pred[:, :, :, 1:2])
    tops, bottoms, rotation = rearrange_lines(
        label_layer(top), label_layer(bottom))

    lines = []
    for top_mask, bottom_mask in zip(tops, bottoms):
        _, ty, tx, _ = bbox(top_mask)
        _, by, bx, _ = bbox(bottom_mask)
        y = slice(min(ty.start, by.start), max(ty.stop, by.stop))
        x = slice(min(tx.start, bx.start), max(tx.stop, bx.stop))
        img = mono_crop[:, y, x, :]
        if rotation is not None:
            img = rotate_array(img, rotation)
        if zoomed_height is not None:
            zf = zoomed_height / img.shape[1]
            img = ndimage.zoom(img, (1, zf, zf, 1), order=0)
        if minimal_width is not None and img.shape[2] < minimal_width:
            bs, h, w, ch = img.shape
            tmp = np.zeros((bs, h, minimal_width, ch), dtype=img.dtype)
            tmp[:, :, :w, :] = img
            img = tmp
        lines.append(img)
    return lines


def _to_u8(x):
    """round(x * 255) to uint8, round half to even (as jnp.round)."""
    return np.round(x * 255.0).astype(np.uint8)


def _device_stage(method):
    """Run a device stage with the TF32 switches its precision needs
    (ops.precision.backend_flags), restored when it returns."""
    @functools.wraps(method)
    def run(self, *args):
        with ops.precision.backend_flags(self.precision):
            return method(self, *args)
    return run


class OCRPipeline:
    """Host-cascade OCR over same-shape pages.

    `weights`: a `{name: {'w', 'b'}}` dict of arrays or lists (the
    model_weights.json layout), or None for the committed checkpoint.
    `device`: None or 'cuda' runs on the card (raising without one);
    'cpu' runs every stage with the plain PyTorch versions of the kernels.
    Close the pipeline (`close()` or `with`) to shut its thread pool down.
    """

    CHAR_WIDTH_MENU = CHAR_WIDTH_MENU
    #: fixed batch of every Line/Char launch
    DEVICE_BATCH = 16

    def __init__(self, page_shape, weights=None, chunk=8, workers=8,
                 collapse_runs=False, quantized_transfers=True,
                 precision='highest', device=None):
        self.device = resolve_device(device)
        self.page_shape = tuple(page_shape)
        self.chunk = chunk
        self.collapse_runs = collapse_runs
        self.quantized_transfers = quantized_transfers
        self.precision = ops.precision.resolve(precision)
        self.line_shape_menu = line_shape_menu(page_shape)
        self.params = (load_checkpoint(device=self.device) if weights is None
                       else params_from_numpy(weights, self.device))
        # the kernels' weights, prepared once for every launch
        self.mono_weights = monochrome_weights(self.params)
        self.char_head = char_head_weights(self.params)
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def close(self):
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- device stages ---------------------------------------------------
    @_device_stage
    def front(self, batch_u8):
        """(B, H, W, 1) uint8 pages on the device -> (monochrome map,
        paragraph mask).  The map is uint8 when transfers are quantized,
        else float32; the mask is uint8 0/1."""
        x = batch_u8.float() / 255.0
        m = fused_monochrome(x, self.mono_weights)
        H, W = self.page_shape[1], self.page_shape[2]
        p = line_forward_masked(self.params, m, H, W, prefix='Paragraph',
                                precision=self.precision)
        # mean per page, the label_layer rule; the 1e-6 guard keeps a
        # constant map empty, as the host's float64 rule leaves it
        mean = p.mean(dim=(1, 2, 3), keepdim=True)
        p_mask = ((p - mean) > 1e-6).to(torch.uint8)
        if self.quantized_transfers:
            m = torch.round(m * 255.0).to(torch.uint8)
        return m, p_mask

    @_device_stage
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

    @_device_stage
    def line_preds(self, x, h_valid, w_valid):
        """Unquantized transfers: the masked Line forward itself."""
        return line_forward_masked(self.params, x, h_valid, w_valid,
                                   prefix='Line', precision=self.precision)

    @_device_stage
    def char_ids(self, x, w_valid):
        """Masked Char forward (fused head) + argmax -> (ids, valid)."""
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        logits = char_forward_masked(self.params, x, w_valid,
                                     precision=self.precision,
                                     head=self.char_head)
        ids = logits.argmax(dim=-1).to(torch.int32)
        cols = torch.arange(logits.shape[1], device=logits.device)[None, :]
        valid = cols < w_valid.reshape(-1, 1)
        return ids, valid

    # -- host stages -----------------------------------------------------
    def _tensor(self, arr):
        return torch.from_numpy(arr).to(self.device)

    def _crop_page(self, mono_pred, para_mask):
        """Label the thresholded paragraph mask, crop and deskew the
        monochrome prediction."""
        labels, cnt = ndimage.label(para_mask > 0)
        crops = []
        for l_id in range(cnt):
            res = crop_and_rotate_single_paragraph(labels == l_id + 1,
                                                   [mono_pred])
            crops.append(make_divisible_by(res[0], 16, 16))
        return crops

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
        for chunk_idx, (ids_dev, valid_dev) in launches:
            ids = ids_dev.cpu().numpy()
            valid = valid_dev.cpu().numpy()
            for bi, i in enumerate(chunk_idx):
                w = lines[i].shape[2]
                preds[i] = (ids[bi, :w], valid[bi, :w])
        return preds

    # -- entry -------------------------------------------------------------
    def _dispatch_front(self, chunk):
        batch = np.concatenate([
            np.asarray(np.asarray(p) * 255.0, np.uint8)
            if np.asarray(p).dtype != np.uint8 else np.asarray(p)
            for p in chunk])
        return self.front(self._tensor(batch))

    def ocr_pages(self, pages):
        """pages: list of (1, H, W, 1) float arrays in [0, 1] or uint8
        arrays, all of `page_shape`.  Returns per page:
        [paragraph][line] -> decoded text."""
        chunks = [pages[start:start + self.chunk]
                  for start in range(0, len(pages), self.chunk)]
        results = []
        pending = self._dispatch_front(chunks[0]) if chunks else None
        for i, chunk in enumerate(chunks):
            mono, para = (t.cpu().numpy() for t in pending)
            # queue the next chunk's front before this chunk's host work
            if i + 1 < len(chunks):
                pending = self._dispatch_front(chunks[i + 1])
            results.extend(self._ocr_chunk(chunk, mono, para))
        return results

    def _ocr_chunk(self, pages, mono, para):
        n = len(pages)
        if self.quantized_transfers:
            mono = mono.astype(np.float32) / 255.0

        crops_per_page = list(self._pool.map(
            lambda i: self._crop_page(mono[i:i + 1], para[i:i + 1]),
            range(n)))

        flat_crops = [c for crops in crops_per_page for c in crops]
        flat_line_preds = self._run_line_batched(flat_crops)

        def crop_lines(k):
            return crop_lines_of_paragraph(
                flat_line_preds[k], flat_crops[k],
                CHAR_INPUT_HEIGHT, CHAR_FIXED_WIDTH,
                thresholded_input=self.quantized_transfers)

        lines_per_crop = list(self._pool.map(crop_lines,
                                             range(len(flat_crops))))

        flat_lines = [l for lines in lines_per_crop for l in lines]
        flat_ids = self._run_char_batched(flat_lines) if flat_lines else []

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
