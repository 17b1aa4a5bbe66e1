"""The synthetic page generator (univer_ocr_tpu/image_generator): a page
of random text with its 17 ground-truth mask layers, drawn with Pillow
(imported where a page is drawn).  Rendering is host work: no module on
the card's path renders a page."""

from .convert import to_bytesio
from .generate import LayeredImage, generate_demo, random_font, random_text
