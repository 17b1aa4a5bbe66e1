"""Plain reference of the OCR cascade: page -> [paragraph][line] text.

A frozen copy of the arithmetic of the port's host cascade, written with
plain PyTorch operations (float32, TF32 off, no kernels, no padding to
buckets, no batching) and numpy/scipy host CV.  It reads the checkpoint
JSON itself and works out its own crops from the page.  It imports
nothing of the program under test.

Stages, per page (uint8 (H, W) gray values):
  1. Monochrome: conv 3x3 1->16, LeakyReLU, conv 3x3 16->1, sigmoid;
     the map is kept as uint8 (round half to even) for the crops;
  2. Paragraph FCN on the float map; mask = p - mean(p) > 1e-6;
  3. 4-connected components of the mask (scipy), each cropped from the
     map, deskewed (angle of least height, 1-degree grid) and centre
     padded to a multiple of 16;
  4. Line FCN on each crop (uint8 in); band masks per channel
     p - 0.5 * (mean + max) > 1e-6;
  5. top / bottom bands labelled, paired by centre of mass, ordered;
     each line's union box cropped, turned upright, zoomed (order 0) to
     height 32, right-padded to width 8;
  6. Char: conv (5,3) stride (2,1) x3 -> width-8 unfold -> dense
     512->1024->128->162; first-index argmax per column; decoded with the
     run-length rule of `collapse_runs`.

`quant`: None, or a callable applied to both operands of every
convolution and product (the lower-precision control rounds them to
float8).  `shapes` of each page's result record the page, each crop and
each line at the sizes the reference computed them: the work table reads
them.
"""

import json
import string

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

LEAKY_ALPHA = 0.01
CHAR_HEIGHT = 32
UNFOLD = 8

RU_LOWER = 'абвгдеёжзийклмнопрстуфхцчшщъыьэюя'
RU_UPPER = 'АБВГДЕЁЖЗИЙКЛМНОПРСТУФХЦЧШЩЪЫЬЭЮЯ'
EN_LOWER = string.ascii_lowercase
EN_UPPER = string.ascii_uppercase
#: the model's 162 classes, in its order
CHARS = '\t' + ' ' + RU_LOWER + RU_UPPER + string.digits + EN_LOWER \
    + EN_UPPER + string.punctuation
_SIMILAR_PAIRS = [
    (RU_LOWER[i], EN_LOWER[j])
    for i, j in ((0, 0), (5, 4), (15, 14), (17, 15), (18, 2), (20, 24),
                 (22, 23))] + [
    (RU_UPPER[i], EN_UPPER[j])
    for i, j in ((0, 0), (2, 1), (5, 4), (11, 10), (13, 12), (15, 14),
                 (14, 7), (17, 15), (18, 2), (19, 19), (22, 23))]
SIMILAR = {k: pair for pair in _SIMILAR_PAIRS for k in pair}


def load_weights(path, device):
    """model_weights.json -> {name: {'w', 'b'}} float32 tensors."""
    with open(path) as fp:
        raw = json.load(fp)
    return {name: {k: torch.tensor(np.asarray(v, np.float32), device=device)
                   for k, v in entry.items()}
            for name, entry in raw.items()}


class Reference:
    def __init__(self, weights, device='cpu', quant=None):
        self.w = weights
        self.device = torch.device(device)
        self.quant = quant or (lambda t: t)

    # -- model arithmetic (NCHW inside, HWIO weights) -------------------
    def _conv(self, x, key, stride=(1, 1), padding=(0, 0)):
        p = self.w[key]
        weight = p['w'].permute(3, 2, 0, 1)
        x = F.pad(x, (padding[1], padding[1], padding[0], padding[0]))
        y = F.conv2d(self.quant(x), self.quant(weight), stride=stride)
        return y + p['b'].reshape(1, -1, 1, 1)

    def _dense(self, x, key):
        w = self.w[key]['w']
        return self.quant(x) @ self.quant(w[:-1]) + w[-1]

    @staticmethod
    def _leaky(x):
        return torch.where(x >= 0, x, LEAKY_ALPHA * x)

    @staticmethod
    def _sigmoid(x):
        return 1 / (1 + torch.exp(-x))

    def monochrome(self, x):
        h = self._leaky(self._conv(x, 'Monochrome/conv_1', padding=(1, 1)))
        return self._sigmoid(self._conv(h, 'Monochrome/conv_2',
                                        padding=(1, 1)))

    def fcn(self, x, prefix):
        """Paragraph / Line: two stride-2 downs, two nearest x2 ups, end."""
        x = self._leaky(self._conv(x, f'{prefix}/down_1/conv_1', (2, 2),
                                   (2, 2)))
        x = self._leaky(self._conv(x, f'{prefix}/down_2/conv_1', (2, 2),
                                   (2, 2)))
        x = x.repeat_interleave(2, 2).repeat_interleave(2, 3)
        x = self._leaky(self._conv(x, f'{prefix}/up_2/conv_block/conv_1',
                                   padding=(2, 2)))
        x = x.repeat_interleave(2, 2).repeat_interleave(2, 3)
        x = self._leaky(self._conv(x, f'{prefix}/up_1/conv_block/conv_1',
                                   padding=(2, 2)))
        return self._sigmoid(self._conv(x, f'{prefix}/end/conv_1',
                                        padding=(2, 2)))

    def char_logits(self, line):
        """(32, W) float line -> (W, 162) logits."""
        x = line[None, None]
        for i in (1, 2, 3):
            x = self._leaky(self._conv(x, f'Char/conv_block/conv_{i}',
                                       (2, 1), (0, 1)))
        cols = x[0, :, 0, :].T                        # (W, 64)
        W = cols.shape[0]
        padded = F.pad(cols, (0, 0, UNFOLD // 2, UNFOLD - UNFOLD // 2))
        idx = torch.arange(W, device=cols.device)[:, None] + torch.arange(
            UNFOLD, device=cols.device)[None]
        flat = padded[idx].reshape(W, -1)             # (W, 8 * 64)
        h = self._leaky(self._dense(flat, 'Char/dense_block/dense_1'))
        h = self._leaky(self._dense(h, 'Char/dense_block/dense_2'))
        return self._dense(h, 'Char/dense_block/dense_3')

    def _tensor(self, arr):
        return torch.as_tensor(np.ascontiguousarray(arr, np.float32),
                               device=self.device)

    # -- the cascade ------------------------------------------------------
    def read_page(self, page_u8, collapse_runs):
        """uint8 (H, W) -> ([paragraph][line] text, shapes)."""
        H, W = page_u8.shape
        x = self._tensor(page_u8)[None, None] / 255.0
        m = self.monochrome(x)
        p = self.fcn(m, 'Paragraph')
        para = ((p - p.mean()) > 1e-6)[0, 0].cpu().numpy()
        mono = (np.round(m[0, 0].cpu().numpy().astype(np.float32) * 255.0)
                .astype(np.uint8).astype(np.float32) / 255.0)
        labels, count = ndimage.label(para)
        shapes = {'page': [H, W], 'crops': [], 'lines': []}
        text = []
        for lab in range(1, count + 1):
            crop = pad16(crop_paragraph(labels == lab, mono))
            h, w = crop.shape
            shapes['crops'].append([h, w])
            xc = self._tensor(to_u8(crop))[None, None] / 255.0
            bands = self.fcn(xc, 'Line')[0].cpu().numpy()   # (2, h, w)
            masks = [b - 0.5 * (b.mean() + b.max()) > 1e-6 for b in bands]
            lines = []
            for box in plan_lines(masks[0], masks[1]):
                line = extract_line(crop, *box)
                shapes['lines'].append(int(line.shape[1]))
                ids = self.char_logits(
                    self._tensor(to_u8(line)) / 255.0).argmax(dim=1)
                lines.append(decode(ids.cpu().numpy(), collapse_runs).strip())
            text.append(lines)
        return text, shapes


# -- host CV -------------------------------------------------------------
def to_u8(x):
    return np.round(x * 255.0).astype(np.uint8)


def box_of(mask):
    return ndimage.find_objects(mask.astype(np.uint8))[0]


def rotate(arr, angle, order):
    """(H, W) rotation with expansion, scipy's convention; None leaves it."""
    if angle is None:
        return arr
    if float(angle) % 90.0 == 0.0:
        k = (4 - int(float(angle) // 90)) % 4
        return np.ascontiguousarray(np.rot90(arr, k=k, axes=(1, 0)))
    return ndimage.rotate(arr, angle, axes=(1, 0), order=order, reshape=True)


def deskew_angle(mask, eps=1.0):
    """The angle in [0, 180] (1-degree grid) of least rotated height; None
    within eps of level."""
    rows = np.nonzero(mask.any(axis=1))[0]
    if len(rows) == 0:
        return None
    sub = mask[rows]
    xmin = sub.argmax(axis=1)
    xmax = mask.shape[1] - 1 - sub[:, ::-1].argmax(axis=1)
    pts = np.concatenate([np.stack([rows, xmin], 1),
                          np.stack([rows, xmax], 1)]).astype(np.float64)
    angles = np.arange(0.0, 180.0 + eps, eps)
    t = np.deg2rad(angles)
    proj = pts[:, :1] * np.cos(t)[None] - pts[:, 1:2] * np.sin(t)[None]
    angle = float(angles[np.argmin(proj.max(0) - proj.min(0))])
    return angle if eps <= angle <= 180.0 - eps else None


def crop_paragraph(mask, mono):
    ys, xs = box_of(mask)
    cmask = mask[ys, xs]
    image = (mono * mask)[ys, xs]
    angle = deskew_angle(cmask)
    ys, xs = box_of(rotate(cmask.astype(np.uint8), angle, 0))
    return rotate(image, angle, 1)[ys, xs]


def pad16(arr):
    """Centre-pad to multiples of 16, always adding at least one row and
    one column."""
    h, w = arr.shape
    ay, ax = 16 - h % 16, 16 - w % 16
    out = np.zeros((h + ay, w + ax), arr.dtype)
    out[ay // 2:ay // 2 + h, ax // 2:ax // 2 + w] = arr
    return out


def _components(mask):
    """Components of a boolean mask thresholded at its mean, as the
    cascade labels a band (empty for an empty or a full mask)."""
    labels, count = ndimage.label(mask > mask.mean())
    return [labels == i for i in range(1, count + 1)]


def _centre(mask):
    return np.argwhere(mask).mean(axis=0)


def plan_lines(top_mask, bottom_mask):
    """Band masks -> [(box, rotation)] of each line in reading order."""
    tops, bottoms = _components(top_mask), _components(bottom_mask)
    if not tops or not bottoms:
        return []
    cm_top = np.asarray([_centre(m) for m in tops])
    cm_bot_all = np.asarray([_centre(m) for m in bottoms])
    d = np.linalg.norm(cm_top[:, None, :] - cm_bot_all[None], axis=-1)
    bottoms = [bottoms[i] for i in d.argmin(axis=1)]
    cm_bot = np.asarray([_centre(m) for m in bottoms])
    dy, dx = cm_top[0] - cm_bot[0]
    if abs(dy) > abs(dx):
        rotation = 180 if dy > 0 else None
    else:
        rotation = 90 if dx > 0 else 270 if dx < 0 else None
    axis, sign = {None: (0, 1), 180: (0, -1), 270: (1, 1),
                  90: (1, -1)}[rotation]
    tops = [tops[i] for i in np.argsort(sign * cm_top[:, axis],
                                        kind='stable')]
    bottoms = [bottoms[i] for i in np.argsort(sign * cm_bot[:, axis],
                                              kind='stable')]
    boxes = []
    for top, bottom in zip(tops, bottoms):
        ty, tx = box_of(top)
        by, bx = box_of(bottom)
        boxes.append(((slice(min(ty.start, by.start), max(ty.stop, by.stop)),
                       slice(min(tx.start, bx.start), max(tx.stop, bx.stop))),
                      rotation))
    return boxes


def extract_line(crop, box, rotation):
    ys, xs = box
    line = rotate(crop[ys, xs], rotation, 1)
    factor = CHAR_HEIGHT / line.shape[0]
    line = ndimage.zoom(line, (factor, factor), order=0)
    if line.shape[1] < UNFOLD:
        line = np.pad(line, ((0, 0), (0, UNFOLD - line.shape[1])))
    return line


def decode(ids, collapse_runs):
    """Per-column ids -> text: runs shorter than `collapse_runs` dropped
    (False: every column, True: runs collapsed), id 0 a separator,
    look-alike and (collapsed) repeated glyphs suppressed."""
    min_run = 1 if isinstance(collapse_runs, bool) else int(collapse_runs)
    if min_run > 1:
        runs = []
        for cid in ids.tolist():
            if runs and runs[-1][0] == cid:
                runs[-1][1] += 1
            else:
                runs.append([cid, 1])
        out, prev = '', None
        for cid, n in runs:
            if cid == 0:
                prev = None
                continue
            if n < min_run:
                continue
            ch = CHARS[cid]
            if ch in SIMILAR.get(prev, ()) or ch == prev:
                continue
            out += ch
            prev = ch
        return out
    out, prev = '', None
    for cid in ids.tolist():
        if cid == 0:
            prev = None
            continue
        ch = CHARS[cid]
        if ch in SIMILAR.get(prev, ()):
            continue
        if collapse_runs and ch == prev:
            continue
        out += ch
        prev = ch
    return out
