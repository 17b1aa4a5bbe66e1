"""Work of one page, stage by stage, from the reference's own shapes.

FLOPs count two per multiply-add of each convolution and product, at the
sizes the reference computes: the drawn page (not the pipeline's padded
frame), its paragraph crops and its zoomed lines at their true widths
(no bucket padding, no batch filler).  Bytes are the compulsory traffic
of the stage alone: each input byte read once and each output byte
written once, at the narrowest type the cascade can carry between
stages (uint8 pages and maps, float32 logits and conv-stack columns);
weights are counted once per window by the readers (`WEIGHT_BYTES`).
Counting the least a stage must do keeps a share of a roofline under
100 % whatever implements it.
"""

CHAR_HEIGHT = 32
CHAR_CHANNELS = 64
UNFOLD = 8
DENSE = ((UNFOLD * CHAR_CHANNELS, 1024), (1024, 128), (128, 162))
#: (kh, kw, c_in, c_out, output rows) of the Char conv stack on a line
CHAR_CONVS = ((5, 3, 1, 64, 14), (5, 3, 64, 64, 5), (5, 3, 64, 64, 1))


def _conv(kh, kw, cin, cout, h, w):
    return 2 * kh * kw * cin * cout * h * w


def monochrome(h, w):
    """conv 3x3 1->16, conv 3x3 16->1 over the page; uint8 in, a uint8
    map out."""
    return {'flops': _conv(3, 3, 1, 16, h, w) + _conv(3, 3, 16, 1, h, w),
            'bytes': 2 * h * w}


def fcn(h, w, c):
    """Paragraph (c = 1) / Line (c = 4) FCN on an (h, w) input: two
    stride-2 downs, two ups, the end conv to `c_end` channels."""
    c_end = 1 if c == 1 else 2
    return (_conv(5, 5, 1, c, h // 2, w // 2)
            + _conv(5, 5, c, c, h // 4, w // 4)
            + _conv(5, 5, c, c, h // 2, w // 2)
            + _conv(5, 5, c, c, h, w)
            + _conv(5, 5, c, c_end, h, w))


def paragraph(h, w):
    """Paragraph FCN over the page; the map in, a one-byte mask out."""
    return {'flops': fcn(h, w, 1), 'bytes': 2 * h * w}


def line(crops):
    """Line FCN over each (h, w) paragraph crop; uint8 in, two one-byte
    band masks out."""
    return {'flops': sum(fcn(h, w, 4) for h, w in crops),
            'bytes': sum(3 * h * w for h, w in crops)}


def char_trunk(widths):
    """The Char conv stack over each zoomed line of width w; uint8 in,
    float32 (w, 64) columns out."""
    per_col = sum(_conv(kh, kw, cin, cout, rows, 1)
                  for kh, kw, cin, cout, rows in CHAR_CONVS)
    cols = sum(widths)
    return {'flops': per_col * cols,
            'bytes': cols * (CHAR_HEIGHT + 4 * CHAR_CHANNELS)}


def char_head(widths):
    """Unfold + dense 512->1024->128->162 per column; float32 (w, 64) in,
    float32 (w, 162) logits out."""
    cols = sum(widths)
    return {'flops': cols * sum(2 * a * b for a, b in DENSE),
            'bytes': cols * 4 * (CHAR_CHANNELS + DENSE[-1][1])}


#: float32 weights of each stage (bias rows included), read once a window
WEIGHT_BYTES = {
    'monochrome': 4 * (3 * 3 * 16 + 16 + 3 * 3 * 16 + 1),
    'paragraph': 4 * 5 * (25 + 1),
    'line': 4 * (25 * 4 + 4 + 3 * (25 * 16 + 4) + 25 * 8 + 2),
    'char_trunk': 4 * (15 * 64 + 64 + 2 * (15 * 64 * 64 + 64)),
    'char_head': 4 * sum((a + 1) * b for a, b in DENSE),
}


def page_work(shapes):
    """The reference's shapes of one page ({'page': [h, w] as drawn,
    'crops': [[h, w]], 'lines': [w]}) -> {stage: {'flops', 'bytes'}}."""
    h, w = shapes['page']
    return {'monochrome': monochrome(h, w),
            'paragraph': paragraph(h, w),
            'line': line(shapes['crops']),
            'char_trunk': char_trunk(shapes['lines']),
            'char_head': char_head(shapes['lines'])}
