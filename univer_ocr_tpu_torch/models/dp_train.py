"""Batched curriculum training of the four single-model stages
(univer_ocr_tpu/models/dp_train.py).

The per-sample trainer (trainer.py) steps once per page, crop or line and
reruns the host CV (paragraph crop, line crop, bit-plane labels) on every
sample of every epoch.  This module restructures the four single-model
stages:

  * materialize once: each stage's samples (pages for Monochrome and
    Paragraph; deskewed paragraph crops for Line; zoomed line crops and
    their labels for Char) are built once per stage, from the ground-truth
    geometry (`collect_stage_samples`) or from the serving crop
    distribution (`collect_stage_samples_predicted`: the checkpoint's own
    OCRPipeline front and Line stage, which on the card run the fused
    Monochrome kernel);
  * bucket and weight: samples pad into a short menu of shapes; every
    step is a fixed (B, Hb, Wb, C) batch with a {0, 1} weight per sample,
    filler slots repeating the first sample with weight 0;
  * per-sample losses: one autograd step over the batch on the weighted
    mean of the per-sample losses plus the regularization once, which is
    the mean of the per-sample trainer's gradients with one Adam update
    per batch.

The steps run the plain forwards under autograd (`monochrome_forward`,
`line_forward_masked`, `char_forward_masked` with `head='xla'`): neither
CUDA kernel has a backward.  With a `mesh` (parallel/mesh.py) each batch
splits over its 'data' shards: each shard's loss divides by the weight
summed over every shard and counts the regularization 1/n_data times,
and the gradients are summed over the shards in shard order before the
one update (JAX's shard_map with `psum`).
"""

import random
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..interpreter import (crop_and_rotate_single_paragraph, extract_line,
                           label_char_line, label_layer, plan_paragraph_lines)
from ..nn.checkpoint import read_weights, save_weights
from ..nn.optimizers import Adam
from ..ops.losses import segmentation_dice_2d_per_sample
from ..ops.precision import backend_flags
from ..parallel.data_parallel import (add_in_order, shard_value_and_grad,
                                      shards_of)
from ..parallel.mesh import gather, mesh_device, on_device, replicate
from ..weights import refuse_committed
from .bucketing import (CHAR_FIXED_WIDTH, CHAR_INPUT_HEIGHT,
                        line_shape_menu, make_divisible_by, pick_char_width,
                        pick_line_shape)
from .constants import TRAINED_WEIGHTS_PATH
from .datasets import RandomSelectDataset
from .fastpath import (_mask_hw, char_forward_masked, line_forward_masked,
                       monochrome_forward)
from .model import (Modes, make_char, make_line, make_monochrome,
                    make_paragraph)


# ---------------------------------------------------------------------------
# Stage samples (host CV, run once per stage)
# ---------------------------------------------------------------------------


def _jitter_bbox(bbox, shape, rng, amp=2):
    """Shift and grow a line bbox by a few pixels: the geometric noise of
    the serving cascade's predicted line plans, applied identically to the
    input crop and its ground-truth bit planes, so the labels stay
    exact."""
    y, x = bbox
    H, W = shape
    dy, dx = rng.randint(-amp, amp + 1), rng.randint(-amp, amp + 1)
    gy = rng.randint(-amp, amp + 1)
    y2 = slice(max(0, y.start + dy), min(H, max(y.start + dy + 2,
                                                y.stop + dy + gy)))
    x2 = slice(max(0, x.start + dx), min(W, x.stop + dx))
    return (y2, x2)


def collect_stage_samples(mode, dataset, workers=8, char_augment=0,
                          seed=0):
    """All (X, y) sample pairs of one curriculum stage from the
    ground-truth geometry, as float32 arrays in their natural (unpadded)
    shapes.  char_augment=N adds N jittered copies of every TRAIN_CHAR
    line (_jitter_bbox)."""
    def page_samples(idx):
        if mode is Modes.TRAIN_MONOCHROME:
            layers = dataset.get(idx, layer_tags=['image', 'monochrome'])
            return [(layers['image'], layers['monochrome'])]
        if mode is Modes.TRAIN_PARAGRAPH:
            layers = dataset.get(idx, layer_tags=['monochrome', 'paragraph'])
            return [(layers['monochrome'], layers['paragraph'])]

        if mode is Modes.TRAIN_LINE:
            layers = dataset.get(idx, layer_tags=['monochrome', 'paragraph',
                                                  'line'])
            return [tuple(crop_and_rotate_single_paragraph(
                        mask, [layers['monochrome'], layers['line']]))
                    for mask in label_layer(layers['paragraph'])]

        if mode is Modes.TRAIN_CHAR:
            layers = dataset.get(
                idx, layer_tags=['monochrome', 'paragraph', 'line', 'char'])
            out = []
            for mask in label_layer(layers['paragraph']):
                mono_c, line_c, char_c = crop_and_rotate_single_paragraph(
                    mask, [layers['monochrome'], layers['line'],
                           layers['char']])
                bboxes, rotation = plan_paragraph_lines(line_c)
                rng = np.random.RandomState(seed * 10007 + idx)
                hw = mono_c.shape[1:3]
                for bbox in bboxes:
                    variants = [bbox] + [_jitter_bbox(bbox, hw, rng)
                                         for _ in range(char_augment)]
                    for bb in variants:
                        x = extract_line(mono_c, bb, rotation,
                                         CHAR_INPUT_HEIGHT, CHAR_FIXED_WIDTH)
                        bits = extract_line(char_c, bb, rotation,
                                            CHAR_INPUT_HEIGHT,
                                            CHAR_FIXED_WIDTH)
                        y = label_char_line(bits)
                        if y.any():
                            out.append((x, y))
            return out
        raise ValueError(f'batched training does not cover {mode}')

    with ThreadPoolExecutor(max_workers=workers) as pool:
        per_page = list(pool.map(page_samples, range(len(dataset))))
    return [(np.asarray(x, np.float32), np.asarray(y, np.float32))
            for page in per_page for x, y in page]


def collect_stage_samples_predicted(mode, dataset, weights, workers=8,
                                    input_shape=(1, 496, 736, 1),
                                    chunk=8, precision='bf16', log=print,
                                    pipeline=None, device=None):
    """Serving-distribution stage samples: predicted inputs, ground-truth
    labels.

    Serving feeds Line and Char crops made from the predicted Monochrome
    and Paragraph masks, whose geometry (threshold bleed, bbox jitter,
    deskew residual) differs from the ground truth's.  This function runs
    the checkpoint's upstream models over the corpus once through a
    serving OCRPipeline of `weights` (its `front`, the fused Monochrome
    kernel on the card, and its batched Line stage, in `precision`), crops
    the predicted monochrome map with the predicted plans, and labels from
    the ground-truth layers cropped with the same plans.

    TRAIN_LINE: X = a predicted paragraph blob's crop of the predicted
    monochrome map, y = the ground-truth line bands under the same crop.
    TRAIN_CHAR: X = a predicted line's extract of that crop, y = the
    ground-truth bit planes through the same line plan, voted per column.
    A fresh pipeline is built and closed unless `pipeline` is given.
    """
    from .pipeline import OCRPipeline

    if mode not in (Modes.TRAIN_LINE, Modes.TRAIN_CHAR):
        raise ValueError(f'predicted-crop sampling covers Line/Char, '
                         f'not {mode}')
    if pipeline is not None:
        return _predicted_samples(mode, dataset, pipeline, workers,
                                  input_shape, log)
    with OCRPipeline(input_shape, weights=weights, chunk=chunk,
                     workers=workers, precision=precision,
                     device=device) as pipeline:
        return _predicted_samples(mode, dataset, pipeline, workers,
                                  input_shape, log)


def _predicted_samples(mode, dataset, pipeline, workers, input_shape, log):
    gt_tag = 'line' if mode is Modes.TRAIN_LINE else 'char'

    # front (Monochrome + Paragraph) over the corpus, as serving runs it:
    # uint8 upload, the paragraph mask thresholded on the device, the
    # monochrome map quantized to uint8
    pages = [dataset.get(i, layer_tags=['image', gt_tag])
             for i in range(len(dataset))]
    mono_pred, para_mask = [], []
    H, W = input_shape[1], input_shape[2]
    with backend_flags(pipeline.precision), torch.no_grad():
        for start in range(0, len(pages), pipeline.chunk):
            batch_pages = pages[start:start + pipeline.chunk]
            batch = np.zeros((len(batch_pages), H, W, 1), np.uint8)
            for bi, page in enumerate(batch_pages):
                img = page['image']
                batch[bi, :img.shape[1], :img.shape[2], :] = np.round(
                    img[0] * 255.0).astype(np.uint8)
            m, p = (t.cpu().numpy()
                    for t in pipeline.front(pipeline._tensor(batch)))
            if pipeline.quantized_transfers:
                m = m.astype(np.float32) / 255.0
            for bi, page in enumerate(batch_pages):
                h, w = page['image'].shape[1], page['image'].shape[2]
                mono_pred.append(m[bi:bi + 1, :h, :w, :])
                para_mask.append(p[bi:bi + 1, :h, :w, :])

    # predicted paragraph blobs -> deskewed crops of [pred mono, GT]
    skipped = [0]

    def page_crops(i):
        crops = []
        for blob in label_layer(para_mask[i].astype(np.float32)):
            try:
                crops.append(tuple(crop_and_rotate_single_paragraph(
                    blob, [mono_pred[i], pages[i][gt_tag]])))
            except (IndexError, ValueError, UnboundLocalError):
                skipped[0] += 1
        return crops

    with ThreadPoolExecutor(max_workers=workers) as pool:
        crops_per_page = list(pool.map(page_crops, range(len(pages))))
    flat = [c for page in crops_per_page for c in page]

    if mode is Modes.TRAIN_LINE:
        if skipped[0]:
            log(f'    [predicted-crops] skipped {skipped[0]} degenerate '
                f'paragraph blobs')
        return [(np.asarray(x, np.float32), np.asarray(y, np.float32))
                for x, y in flat]

    # TRAIN_CHAR: the line geometry comes from the checkpoint's Line
    # model over each predicted crop; /16 pad both the input and the GT
    # planes so that the planned bboxes index the same frame
    padded = [(make_divisible_by(x, 16, 16), make_divisible_by(y, 16, 16))
              for x, y in flat]
    with backend_flags(pipeline.precision), torch.no_grad():
        line_preds = pipeline._run_line_batched([x for x, _ in padded])

    def crop_samples(k):
        mono_c, char_c = padded[k]
        out = []
        try:
            bboxes, rotation = plan_paragraph_lines(
                line_preds[k],
                thresholded_input=pipeline.quantized_transfers)
        except (IndexError, ValueError, UnboundLocalError):
            skipped[0] += 1
            return out
        for bbox in bboxes:
            x = extract_line(mono_c, bbox, rotation,
                             CHAR_INPUT_HEIGHT, CHAR_FIXED_WIDTH)
            bits = extract_line(char_c, bbox, rotation,
                                CHAR_INPUT_HEIGHT, CHAR_FIXED_WIDTH)
            y = label_char_line(bits)
            if not y.any():
                skipped[0] += 1      # hallucinated line: no GT chars
                continue
            out.append((np.asarray(x, np.float32),
                        np.asarray(y, np.float32)))
        return out

    with ThreadPoolExecutor(max_workers=workers) as pool:
        per_crop = list(pool.map(crop_samples, range(len(padded))))
    if skipped[0]:
        log(f'    [predicted-crops] skipped {skipped[0]} degenerate '
            f'blobs/label-empty lines')
    return [s for crop in per_crop for s in crop]


# ---------------------------------------------------------------------------
# Batched steps
# ---------------------------------------------------------------------------


def _seg_forward(prefix):
    if prefix == 'Monochrome':
        return lambda p, x, hv, wv: monochrome_forward(p, x)

    def forward(p, x, hv, wv):
        pred = line_forward_masked(p, x, hv, wv, prefix=prefix)
        return _mask_hw(pred, hv, wv)
    return forward


def _weighted_steps(model, per_sample, mesh=None):
    """(train, eval) steps over `per_sample(params, *args) -> (B,)` losses.

    train(params, opt_state, lr, *args, weight) -> (params, opt_state,
    per_sample * weight): autograd of the weighted MEAN of the per-sample
    losses (the per-sample trainer's gradient scale, so the curriculum's
    lr table transfers) plus the regularization once, then the model's
    optimizer update.  eval(params, *args, weight) -> per_sample * weight.
    Under a `mesh` the batch splits over its 'data' shards and the
    outputs merge in shard order on the mesh's first device.
    """
    opt = model._optimizer()
    reg_fn = model.regularization_fn
    n_data = mesh.shape['data'] if mesh is not None else 1

    def shards(batch):
        """The batch's per-shard args and the shards' devices."""
        if mesh is None:
            return [list(batch)], [batch[0].device]
        return shards_of(batch, mesh), mesh.data_devices()

    def train(params, opt_state, lr, *batch):
        per_shard, devices = shards(batch)
        master = next(iter(next(iter(params.values())).values())).device
        # the weighted mean's denominator: the weight of every shard
        total = add_in_order([args[-1].sum() for args in per_shard], master)

        def loss_fn(p, *args):
            *args, weight = args
            per = per_sample(p, *args)
            return (torch.sum(per * weight)
                    / torch.clamp(total.to(weight.device), min=1.0)
                    + reg_fn(p) / n_data), (per * weight).detach()

        out, grads = shard_value_and_grad(loss_fn, params, per_shard,
                                          devices, master)
        with torch.no_grad():
            new_params, new_state = opt.update(params, grads, opt_state, lr)
        return new_params, new_state, gather(out, master)

    def evaluate(params, *batch):
        per_shard, devices = shards(batch)
        copies = (replicate(params, mesh).parts if mesh is not None
                  else [params])
        out = []
        with torch.no_grad():
            for p, args, dev in zip(copies, per_shard, devices):
                with on_device(dev):
                    *args, weight = args
                    out.append(per_sample(p, *args) * weight)
        return gather(out, devices[0])

    return train, evaluate


def make_batched_seg_step(model, prefix, mesh=None):
    """Weighted batched train/eval steps of a segmentation model
    (Monochrome, Paragraph and Line share the Dice contract).

    train(params, opt_state, lr, X, y, hv, wv, weight) -> (params,
    opt_state, per_sample_dice * weight); eval drops the update.  X is
    (B, Hb, Wb, C) zero-padded, hv/wv (B,) true extents, weight (B,) the
    {0, 1} filler mask.  Under a `mesh` the batch splits over 'data'."""
    forward = _seg_forward(prefix)

    def per_sample(params, X, y, hv, wv):
        return segmentation_dice_2d_per_sample(forward(params, X, hv, wv), y)

    return _weighted_steps(model, per_sample, mesh)


def make_batched_char_step(model, mesh=None):
    """Weighted batched steps of the Char model: X (B, 32, Wb, 1), y (B,
    Wb, n_chars), wv (B,) true widths, weight (B,).  A sample's loss is
    the per-sample trainer's column-mean softmax cross-entropy
    (fastpath.masked_char_loss): summed over its labeled columns and
    divided by its true width.  Under a `mesh` the batch splits over
    'data'."""

    def per_sample(params, X, y, wv):
        logits = char_forward_masked(params, X, wv)
        shifted = logits - torch.amax(logits, dim=2, keepdim=True)
        log_probs = shifted - torch.log(
            torch.sum(torch.exp(shifted), dim=2, keepdim=True))
        return -torch.sum(y * log_probs, dim=(1, 2)) / wv

    return _weighted_steps(model, per_sample, mesh)


# ---------------------------------------------------------------------------
# Bucketed batch assembly
# ---------------------------------------------------------------------------


def _bucket_shape(sample_x, mode, menu):
    if mode is Modes.TRAIN_CHAR:
        return (CHAR_INPUT_HEIGHT, pick_char_width(sample_x.shape[2]))
    if mode is Modes.TRAIN_MONOCHROME or mode is Modes.TRAIN_PARAGRAPH:
        return sample_x.shape[1], sample_x.shape[2]
    return pick_line_shape(menu, sample_x.shape[1], sample_x.shape[2])


def make_batches(samples, mode, batch, rng=None,
                 input_shape=(1, 496, 736, 1)):
    """Group samples by bucket shape and emit fixed-size weighted
    batches: (X, y, hv, wv, weight) arrays ((X, y, wv, weight) for Char),
    filler slots repeating the first sample with weight 0.  Crop shapes
    pad into the serving pipeline's menus (bucketing.line_shape_menu,
    CHAR_WIDTH_MENU); `rng`, a np.random.RandomState, shuffles the samples
    first."""
    menu = line_shape_menu(input_shape)
    order = np.arange(len(samples))
    if rng is not None:
        rng.shuffle(order)
    buckets = {}
    for i in order:
        buckets.setdefault(_bucket_shape(samples[i][0], mode, menu),
                           []).append(i)

    out = []
    for (hb, wb), idxs in sorted(buckets.items()):
        for start in range(0, len(idxs), batch):
            sel = idxs[start:start + batch]
            if mode is Modes.TRAIN_CHAR:
                n_classes = samples[sel[0]][1].shape[1]
                X = np.zeros((batch, hb, wb, 1), np.float32)
                y = np.zeros((batch, wb, n_classes), np.float32)
                wv = np.full((batch,), CHAR_FIXED_WIDTH, np.int32)
                weight = np.zeros((batch,), np.float32)
                for bi in range(batch):
                    x_s, y_s = samples[sel[bi % len(sel)]]
                    w = x_s.shape[2]
                    X[bi, :, :w, :] = x_s[0]
                    y[bi, :y_s.shape[0], :] = y_s
                    wv[bi] = w
                    weight[bi] = 1.0 if bi < len(sel) else 0.0
                out.append((X, y, wv, weight))
            else:
                c_y = samples[sel[0]][1].shape[3]
                X = np.zeros((batch, hb, wb, 1), np.float32)
                y = np.zeros((batch, hb, wb, c_y), np.float32)
                hv = np.full((batch,), 4, np.int32)
                wv = np.full((batch,), 4, np.int32)
                weight = np.zeros((batch,), np.float32)
                for bi in range(batch):
                    x_s, y_s = samples[sel[bi % len(sel)]]
                    h, w = x_s.shape[1], x_s.shape[2]
                    X[bi, :h, :w, :] = x_s[0]
                    y[bi, :h, :w, :] = y_s[0]
                    hv[bi], wv[bi] = h, w
                    weight[bi] = 1.0 if bi < len(sel) else 0.0
                out.append((X, y, hv, wv, weight))
    return out


# ---------------------------------------------------------------------------
# Stage training
# ---------------------------------------------------------------------------

_STAGE_MODEL = {
    Modes.TRAIN_MONOCHROME: ('Monochrome', make_monochrome),
    Modes.TRAIN_PARAGRAPH: ('Paragraph', make_paragraph),
    Modes.TRAIN_LINE: ('Line', make_line),
    Modes.TRAIN_CHAR: ('Char', make_char),
}


def _upload(arrays, device):
    """Batch arrays -> tensors on `device`; integer extents as int64.  To
    the card they go from pinned memory without waiting for the device."""
    out = []
    for a in arrays:
        t = torch.from_numpy(a)
        if not t.is_floating_point():
            t = t.to(torch.int64)
        if device.type == 'cuda':
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return out


def _host_copy(params):
    return {name: {k: v.detach().to('cpu', copy=True)
                   for k, v in layer.items()}
            for name, layer in params.items()}


def _on_device(params, device):
    return {name: {k: v.to(device, copy=True) for k, v in layer.items()}
            for name, layer in params.items()}


def _has_nan(params):
    return any(bool(torch.isnan(v).any())
               for layer in params.values() for v in layer.values())


def train_stage_batched(mode, train_samples, val_samples, weights,
                        epochs, lr, lr_step, batch=16, mesh=None,
                        input_shape=(1, 496, 736, 1), checkpoint_path=None,
                        log=print, seed=0, eval_gate=None, device=None):
    """Train one curriculum stage on materialized samples, on `device`
    (None: the card), in the module's default precision ('highest': TF32
    off, as JAX trains).

    Per epoch: the batches of make_batches (shuffled by
    np.random.RandomState(seed)), NaN detection with a rollback (the last
    epoch's weights, or the best after 10 attempts; lr decayed by
    lr_step**attempts and Adam's state made anew) and save-best-on-
    validation into `checkpoint_path` (merge-saving).  With `eval_gate`
    (evaluation.make_eval_gate) the per-epoch writes are withheld: the
    stage's best-by-validation weights are offered to the gate once at the
    stage's end and written only on its approval.  With a `mesh` every
    batch splits over its 'data' shards (`batch` must divide over them)
    and the model lives on the mesh's first device.
    Returns (model, best_val_loss).
    """
    if mesh is not None:
        if batch % mesh.shape['data']:
            raise ValueError(f'a batch of {batch} does not divide over '
                             f"{mesh.shape['data']} data shards")
        device = mesh_device(mesh, device)
    name, factory = _STAGE_MODEL[mode]
    model = factory(input_shape, optimizer=Adam(lr=lr), device=device)
    if weights:
        model.set_weights(weights)
    device = model._compute_device()

    if mode is Modes.TRAIN_CHAR:
        train_step, eval_step = make_batched_char_step(model, mesh)
    else:
        train_step, eval_step = make_batched_seg_step(model, name, mesh)

    rng = np.random.RandomState(seed)
    val_batches = make_batches(val_samples, mode, batch,
                               input_shape=input_shape)

    def validate(params):
        total = 0.0
        for args in val_batches:
            total += float(eval_step(params, *_upload(args, device)).sum())
        return total / max(len(val_samples), 1)

    with backend_flags():
        params = model.params
        opt = model._optimizer()
        opt_state = opt.init_state(params)
        best_val = validate(params)
        best_params = _host_copy(params)
        log(f'[{name}] {len(train_samples)} train / {len(val_samples)} val '
            f'samples; initial val loss {best_val:.6f}')

        snapshot = best_params
        reload_attempts = 0
        epoch = 0
        while epoch < epochs:
            t0 = time.time()
            train_loss = 0.0
            for args in make_batches(train_samples, mode, batch, rng,
                                     input_shape=input_shape):
                params, opt_state, per = train_step(
                    params, opt_state, lr, *_upload(args, device))
                train_loss += float(per.sum())
            train_loss /= max(len(train_samples), 1)

            if _has_nan(params):
                reload_attempts += 1
                if reload_attempts >= 10:
                    params = _on_device(best_params, device)
                    reload_attempts = 0
                else:
                    params = _on_device(snapshot, device)
                lr *= lr_step ** reload_attempts
                opt_state = opt.init_state(params)
                log(f'[{name}] NaN epoch, rolled back; lr -> {lr:.6g}')
                continue

            snapshot = _host_copy(params)
            val_loss = validate(params)
            log(f'[{name}] epoch {epoch + 1}/{epochs}: train '
                f'{train_loss:.6f} val {val_loss:.6f} lr {lr:.6g} '
                f'({time.time() - t0:.2f}s)')
            if val_loss < best_val:
                best_val = val_loss
                best_params = snapshot
                if checkpoint_path is not None and eval_gate is None:
                    model.params = _on_device(best_params, device)
                    save_weights({name: model}, checkpoint_path)
            lr *= lr_step
            epoch += 1

    model.params = _on_device(best_params, device)
    if eval_gate is not None and checkpoint_path is not None:
        ok, score, incumbent = eval_gate({name: model})
        if ok:
            save_weights({name: model}, checkpoint_path)
            log(f'[{name}] gate approved ({score:.4f} >= '
                f'{incumbent:.4f}); checkpoint updated')
        else:
            log(f'[{name}] gate REJECTED ({score:.4f} < '
                f'{incumbent:.4f}); checkpoint kept')
    return model, best_val


def train_model_batched(curriculum, train_dataset, validation_dataset,
                        batch=16, mesh=None, train_size=50, val_size=5,
                        seed=0, log=print,
                        checkpoint_path=TRAINED_WEIGHTS_PATH,
                        predicted=False, eval_gate=None, device=None,
                        rng=None):
    """Run the batched stages of a curriculum (Monochrome, Paragraph,
    Line, Char; TRAIN_ALL stays on the per-sample Trainer: its inputs are
    the evolving upstream predictions, so there is nothing to
    materialize once).

    Each stage draws `train_size` / `val_size` pages of the datasets from
    `rng` (a random.Random; random.Random(seed) when None), starts from
    the weights in `checkpoint_path` (the committed checkpoint is
    refused) and writes its best weights there (every improving epoch, or
    once through `eval_gate`).  `predicted=True` materializes the Line and
    Char samples from the serving crop distribution
    (collect_stage_samples_predicted) of the checkpoint as it stands at
    the stage's start, so stages compose (Char sees the just-trained
    Line model's plans); `predicted='mix'` adds the ground-truth samples
    to the train set (Char's jittered twice), validation staying
    predicted.  With a `mesh` the stages' batches split over its 'data'
    shards; the samples are built on its first device.  Returns per
    stage: mode, best validation loss, sample counts and the seconds the
    samples took to build.
    """
    refuse_committed(checkpoint_path)
    if mesh is not None:
        device = mesh_device(mesh, device)
    rng = random.Random(seed) if rng is None else rng
    results = []
    for mode, lr, lr_step, epochs in curriculum:
        if mode not in _STAGE_MODEL:
            raise ValueError(f'{mode} is not a batched stage; train it '
                             f'with models.train.train_model')
        weights = read_weights(checkpoint_path)
        train_ds = RandomSelectDataset(train_size, train_dataset, rng)
        val_ds = RandomSelectDataset(val_size, validation_dataset, rng)
        input_shape = train_ds.get(0, layer_tags=['image'])['image'].shape
        use_predicted = (predicted
                         and mode in (Modes.TRAIN_LINE, Modes.TRAIN_CHAR)
                         and weights)
        log(f'=== batched stage {mode.name}'
            f'{" (predicted crops)" if use_predicted else ""}: '
            f'materializing samples...')
        t0 = time.time()
        if use_predicted:
            train_samples = collect_stage_samples_predicted(
                mode, train_ds, weights, input_shape=input_shape, log=log,
                device=device)
            if predicted == 'mix':
                aug = 2 if mode is Modes.TRAIN_CHAR else 0
                train_samples = train_samples + collect_stage_samples(
                    mode, train_ds, char_augment=aug)
            val_samples = collect_stage_samples_predicted(
                mode, val_ds, weights, input_shape=input_shape, log=log,
                device=device)
        else:
            train_samples = collect_stage_samples(mode, train_ds)
            val_samples = collect_stage_samples(mode, val_ds)
        build_s = time.time() - t0
        log(f'    built {len(train_samples)}+{len(val_samples)} samples '
            f'in {build_s:.1f}s')
        _, best = train_stage_batched(
            mode, train_samples, val_samples, weights, epochs, lr, lr_step,
            batch=batch, mesh=mesh, input_shape=input_shape,
            checkpoint_path=checkpoint_path, log=log, seed=seed,
            eval_gate=eval_gate, device=device)
        results.append({'mode': mode.name,
                        'best_losses': {_STAGE_MODEL[mode][0]:
                                        np.array([best])},
                        'samples': [len(train_samples), len(val_samples)],
                        'build_seconds': build_s})
    return results
