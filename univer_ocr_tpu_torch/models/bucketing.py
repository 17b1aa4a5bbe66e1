"""Shape buckets of the cascade (univer_ocr_tpu/models/bucketing.py and the
constants of univer_ocr_tpu/models/model.py).

Paragraph and line crops vary per page; rounding their shapes up to a
short menu lets a handful of fixed-shape launches serve every page, with
the masked forwards (fastpath.py) keeping the padded computation exact.
"""

import numpy as np

#: line crops are zoomed to this height before the Char model
CHAR_INPUT_HEIGHT = 32
#: width of the Char model's unfold window
CHAR_FIXED_WIDTH = 8

#: Char-stage width menu: every line pads to the next entry
CHAR_WIDTH_MENU = (256, 512, 1024, 2048)


def round_up(n, multiple):
    return -(-n // multiple) * multiple


def make_divisible_by(arr, y, x):
    """Center-pad an NHWC array so H, W become divisible by (y, x).

    Like the reference, always adds at least one row/column of padding.
    """
    b, h, w, c = arr.shape
    to_add_y = y - h % y
    to_add_x = x - w % x
    py, px = to_add_y // 2, to_add_x // 2
    dtype = arr.dtype if np.issubdtype(arr.dtype, np.floating) else np.float64
    new_arr = np.zeros((b, h + to_add_y, w + to_add_x, c), dtype=dtype)
    new_arr[:, py:py + h, px:px + w, :] = arr
    return new_arr


def line_shape_menu(page_shape):
    """Canonical (H, W) menu for paragraph crops: two small entries cover
    most paragraphs, the last fits any crop of a page padded by the
    16-px stack margin."""
    max_shape = (round_up(page_shape[1] + 16, 128),
                 round_up(page_shape[2] + 16, 128))
    return [(128, 256), (256, 512), max_shape]


def pick_line_shape(menu, h, w):
    """Smallest menu entry containing (h, w); falls back to the last."""
    for hb, wb in menu:
        if h <= hb and w <= wb:
            return (hb, wb)
    return menu[-1]


def pick_char_width(w):
    """Smallest CHAR_WIDTH_MENU entry >= w, else round up to the last
    entry's multiple."""
    for wb in CHAR_WIDTH_MENU:
        if w <= wb:
            return wb
    return round_up(w, CHAR_WIDTH_MENU[-1])
