"""Font registry of the page generator (the font part of
univer_ocr_tpu/primitives): named families with normal / bold / italic /
bold_italic variants, found under the system's font directory and the
port's own `fonts/` directory.

The families are listed in a fixed order, because the generator draws a
family with `rng.choice(FONTS_LIST)`: the same order gives the same draws
as the JAX package.  Pillow is imported only where a font file is opened,
so this module imports without it.
"""

from pathlib import Path

FONT_ROOTS = (Path('/usr/share/fonts'), Path(__file__).parent / 'fonts')


class Font:
    """A named family; a variant whose file is missing returns None, so
    that a caller can draw another family or style."""

    def __init__(self, name, normal, bold, italic, bold_italic):
        self.name = name
        self.normal_path = normal
        self.bold_path = bold
        self.italic_path = italic
        self.bold_italic_path = bold_italic

    def _load(self, path, size, index, encoding, layout_engine):
        if path is None:
            return None
        from PIL.ImageFont import truetype
        return truetype(font=str(path), size=size, index=index,
                        encoding=encoding, layout_engine=layout_engine)

    def normal(self, size=10, index=0, encoding="", layout_engine=None):
        return self._load(self.normal_path, size, index, encoding,
                          layout_engine)

    def bold(self, size=10, index=0, encoding="", layout_engine=None):
        return self._load(self.bold_path, size, index, encoding,
                          layout_engine)

    def italic(self, size=10, index=0, encoding="", layout_engine=None):
        return self._load(self.italic_path, size, index, encoding,
                          layout_engine)

    def bold_italic(self, size=10, index=0, encoding="", layout_engine=None):
        return self._load(self.bold_italic_path, size, index, encoding,
                          layout_engine)


def discover_fonts(roots=FONT_ROOTS):
    """The DejaVu families found under `roots` (full Cyrillic coverage),
    in the fixed order Sans, Serif, Sans Mono; a family without its
    normal face is left out."""
    available = {}
    for root in roots:
        if root.exists():
            for p in root.rglob('*.ttf'):
                available[p.name] = p

    def pick(name):
        return available.get(name)

    candidates = [
        Font('DejaVu Sans',
             pick('DejaVuSans.ttf'), pick('DejaVuSans-Bold.ttf'),
             pick('DejaVuSans-Oblique.ttf'),
             pick('DejaVuSans-BoldOblique.ttf')),
        Font('DejaVu Serif',
             pick('DejaVuSerif.ttf'), pick('DejaVuSerif-Bold.ttf'),
             pick('DejaVuSerif-Italic.ttf'),
             pick('DejaVuSerif-BoldItalic.ttf')),
        Font('DejaVu Sans Mono',
             pick('DejaVuSansMono.ttf'), pick('DejaVuSansMono-Bold.ttf'),
             pick('DejaVuSansMono-Oblique.ttf'),
             pick('DejaVuSansMono-BoldOblique.ttf')),
    ]
    return [f for f in candidates if f.normal_path is not None]


FONTS_LIST = discover_fonts()
FONTS_DICT = {font.name: font for font in FONTS_LIST}
