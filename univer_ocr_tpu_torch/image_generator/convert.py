"""PIL image -> PNG byte stream (univer_ocr_tpu/image_generator/
convert.py)."""

from io import BytesIO


def to_bytesio(image):
    img_io = BytesIO()
    image.save(img_io, 'PNG')
    img_io.seek(0)
    return img_io
