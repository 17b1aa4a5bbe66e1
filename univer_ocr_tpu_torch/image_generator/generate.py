"""Synthetic page renderer: text and 17 aligned ground-truth mask layers
(univer_ocr_tpu/image_generator/generate.py, draw for draw).

Random paragraphs of multi-font RU/EN text are drawn onto a page together
with per-pixel supervision layers: paragraph boxes, three line bands
(top / center / bottom), per-char mask and full boxes, letter-spacing
markers, and the 8 bit-plane layers encoding each character's class id.
The geometric contract the ground-truth decoder (interpreter.interpret)
relies on:

  * char_full_box minus letter_spacing leaves one connected component per
    character (the bit planes share the same rectangles);
  * the full box's center lies inside the line_center band;
  * line bands: top = [ascent row, baseline], center = [x-height,
    baseline], bottom = [x-height, descent].

Every random draw comes from an explicit `random.Random`, in the JAX
package's order (paragraph placement in `add_paragraph`, then
`random_font` and `random_text`), so `random.Random(s)` here draws what
`random.seed(s)` draws there and the layers come out equal byte for byte.
Rendering is host work that needs Pillow and fonts; Pillow is imported
where a layer is made or drawn, so the module imports without it.
"""

from textwrap import wrap

import numpy as np

from ..fonts import FONTS_LIST
from ..primitives import BITS_COUNT, CHARS, encode_char

# Mask layers are L-mode, full-intensity ink; the page itself is RGBA.
_MASK_FILL = 255
_INK = (0, 0, 0, 255)

# Translucent overlay palette for the demo view (web /view_layers).  Layers
# not listed render in the shared box color.
_DEMO_BOX = (200, 200, 0, 100)
_DEMO_FILLS = {
    'paragraph': (0, 0, 200, 50),
    'line_top': (200, 0, 0, 100),
    'line_center': (0, 0, 200, 150),
    'line_bottom': (0, 200, 0, 100),
    'letter_spacing': (200, 0, 200, 100),
}
_GUIDELINE_COLORS = {
    'ascent': (200, 0, 200),
    'M': (0, 200, 0),
    'x': (0, 200, 200),
    'baseline': (200, 0, 0),
    'descent': (0, 0, 200),
}


class LayeredImage:
    # Order and names are the dataset contract (PNG file names, channel
    # order in encode_layers), the JAX package's.
    layer_names = ['image', 'image_monochrome', 'paragraph',
                   'line_top', 'line_center', 'line_bottom',
                   'letter_spacing', 'char_mask_box', 'char_full_box'] \
        + [f'bit_{i}' for i in range(BITS_COUNT)]

    def __init__(self, width, height, bg_color, rng, use_demo=False):
        from PIL import Image
        self.bg_color = bg_color
        self.rng = rng
        self.use_demo = use_demo
        self.paragraphs_added = 0

        def blank(mode, fill=0):
            return Image.new(mode, (width, height), fill)

        self.layers = {'image': blank('RGBA', bg_color)}
        self.layers.update((name, blank('L')) for name in self.layer_names[1:])

        self.demo = {}
        if use_demo:
            self.demo['image'] = blank('RGBA', bg_color)
            self.demo['guidelines'] = blank('RGBA')
            self.demo.update(
                (name, blank('RGBA')) for name in self.layer_names[1:])

        self._rebind()

    # -- whole-page transforms ---------------------------------------------
    def _remap(self, fn):
        """Apply `fn(image, fill) -> image` to every raw and demo layer in
        lockstep (`fill` = this layer's background), then refresh the draw
        handles, cached size, and collision mask."""
        for group in (self.layers, self.demo):
            for name, image in group.items():
                fill = self.bg_color if image.mode == 'RGBA' else 0
                group[name] = fn(image, fill)
        self._rebind()
        return self

    def _rebind(self):
        from PIL import ImageDraw
        self.width, self.height = self.layers['image'].size
        self.draw = {n: ImageDraw.Draw(im) for n, im in self.layers.items()}
        self.draw_demo = {n: ImageDraw.Draw(im) for n, im in self.demo.items()}
        self.mask = np.array(self.layers['paragraph'])

    def rotate(self, angle):
        """Rotate every layer in lockstep, expanding the canvas; the area
        out of frame takes the layer's own background."""
        from PIL import Image
        return self._remap(lambda im, fill: im.rotate(
            angle, resample=Image.BILINEAR, expand=True, fillcolor=fill))

    def make_divisible_by(self, x, y):
        """Pad (centered) so dims are multiples of (x, y).  This
        always adds at least one unit of padding:
        `x - w % x` is x when already divisible."""
        from PIL import Image
        pad_x, pad_y = x - self.width % x, y - self.height % y
        size = (self.width + pad_x, self.height + pad_y)

        def grow(im, fill):
            canvas = Image.new(im.mode, size, fill)
            canvas.paste(im, (pad_x // 2, pad_y // 2))
            return canvas

        return self._remap(grow)

    def get_raw(self):
        return self.layers

    def get_demo(self):
        return self.demo

    # -- paragraph layout ---------------------------------------------------
    def add_paragraph(self, text, font):
        """Lay out and draw one paragraph (list of text lines) with all
        supervision layers; the placement draws come from self.rng."""
        spacing = font.size // 2
        ascent, descent = font.getmetrics()
        m_bbox = font.getbbox('M')
        x_bbox = font.getbbox('x')
        M_height = m_bbox[3] - m_bbox[1]
        x_height = x_bbox[3] - x_bbox[1]
        line_advance = ascent + descent + spacing

        # Paragraph bounding box from per-line ink extents.
        t_width, t_height = 0, 0
        for line in text:
            bbox = font.getbbox(line) if line else (0, 0, 0, 0)
            t_width = max(t_width, int(bbox[2]))
            t_height += line_advance

        margin = 3
        margin2 = 2 * margin
        ones = np.ones((t_height + margin2, t_width + margin2), dtype=np.uint8)
        x, y = None, None
        retries = 0
        while True:
            left_margin = 20
            rand_width = self.width - (t_width + margin2) - left_margin
            rand_height = self.height - (t_height + margin2)
            if rand_width < left_margin or rand_height < 0:
                return  # paragraph too big for the image
            x = self.rng.randint(left_margin, rand_width)
            y = self.rng.randint(0, rand_height)
            if np.sum(ones * self.mask[y:y + t_height + margin2,
                                       x:x + t_width + margin2]) == 0:
                break
            if retries > 100:
                return  # number of retries exceeded
            retries += 1
        self.paragraphs_added += 1
        x, y = x + margin, y + margin

        self._rect('paragraph', (x, y, x + t_width, y + t_height))
        self.mask = np.array(self.layers['paragraph'])

        dy = 0
        for line in text:
            if not line:
                dy += line_advance
                continue

            bbox = font.getbbox(line)
            left = x + bbox[0]
            right = x + bbox[2]

            y_ascent = y + dy
            y_baseline = y_ascent + ascent
            y_M = y_baseline - M_height
            y_x = y_baseline - x_height
            y_descent = y_baseline + descent

            self._line(left, right, y_ascent, y_M, y_x, y_baseline, y_descent)

            # One draw call for the whole line (kerning-exact); per-char
            # geometry from cumulative advances.
            self._text_line(line, (x, y_ascent), font)

            pens = [font.getlength(line[:i]) for i in range(len(line) + 1)]
            for i, char in enumerate(line):
                pen_l = x + pens[i]
                pen_r = x + pens[i + 1]
                cell_w = pen_r - pen_l
                w10 = max(1, cell_w / 10)

                cb = font.getbbox(char)
                # ink box of this glyph at its pen position (skip inkless
                # glyphs like space — their full box still carries the bits)
                if cb[2] > cb[0] and cb[3] > cb[1]:
                    self._rect('char_mask_box',
                               (pen_l + cb[0], y_ascent + cb[1],
                                pen_l + cb[2], y_ascent + cb[3]))
                if pen_r - w10 > pen_l + w10:
                    self._full_box(char, (pen_l + w10, y_ascent,
                                          pen_r - w10, y_descent))
                else:   # degenerate narrow cell: keep the full cell
                    self._full_box(char, (pen_l, y_ascent, pen_r, y_descent))

                if i == len(line) - 1:
                    continue
                self._rect('letter_spacing', (pen_r - w10, y_ascent,
                                              pen_r + w10, y_descent))

            dy += line_advance

    # -- layer draw primitives ----------------------------------------------
    def _rect(self, name, coords):
        """One rectangle on a mask layer, mirrored onto its demo overlay."""
        self.draw[name].rectangle(coords, fill=_MASK_FILL)
        if self.use_demo:
            self.draw_demo[name].rectangle(
                coords, fill=_DEMO_FILLS.get(name, _DEMO_BOX))

    def _text_line(self, line, position, font):
        self.draw['image'].text(position, line, fill=_INK, font=font)
        self.draw['image_monochrome'].text(position, line, fill=_MASK_FILL,
                                           font=font)
        if self.use_demo:
            self.draw_demo['image'].text(position, line, fill=_INK, font=font)

    def _full_box(self, char, coords):
        self._rect('char_full_box', coords)
        for i, bit in enumerate(encode_char(char)):
            if bit != '0':
                self._rect(f'bit_{i}', coords)

    def _line(self, left, right, y_ascent, y_M, y_x, y_baseline, y_descent):
        self._rect('line_top', (left, y_ascent, right, y_baseline))
        self._rect('line_center', (left, y_x, right, y_baseline))
        self._rect('line_bottom', (left, y_x, right, y_descent))

        if self.use_demo:
            rows = {'ascent': y_ascent, 'M': y_M, 'x': y_x,
                    'baseline': y_baseline, 'descent': y_descent}
            for key, yy in rows.items():
                self.draw_demo['guidelines'].line(
                    (left, yy, right, yy), fill=_GUIDELINE_COLORS[key],
                    width=1)


def random_font(rng, min_size=12, max_size=48):
    """Random family, style and size, drawn from `rng`."""
    style = rng.choice(['normal', 'bold'])
    font = None
    while font is None:
        font = getattr(rng.choice(FONTS_LIST), style)
        font = font(size=rng.randint(min_size, max_size))
    return font


def random_text(rng, min_wrap=30, max_wrap=100):
    """Random char-soup words wrapped to a random column width, drawn
    from `rng`."""
    text = ' '.join(
        ''.join(rng.choice(CHARS[1:]) for _ in range(rng.randint(1, 10)))
        for _ in range(rng.randint(3, 30)))
    return wrap(text, rng.randint(min_wrap, max_wrap))


def generate_demo(width, height, rng):
    """The web demo page: 30 paragraph attempts with the demo overlays;
    returns (raw layers, demo layers), {name: PIL image} each."""
    layers = LayeredImage(width, height, (200, 200, 200, 255), rng,
                          use_demo=True)
    for _ in range(30):
        layers.add_paragraph(random_text(rng), random_font(rng))
    return layers.get_raw(), layers.get_demo()
