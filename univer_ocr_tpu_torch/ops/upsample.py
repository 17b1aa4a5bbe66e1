"""Nearest-neighbour upsampling of NHWC maps (univer_ocr_tpu/ops/upsample.py)."""


def upsample2d(x, scale_factor):
    x = x.repeat_interleave(scale_factor, dim=1)
    return x.repeat_interleave(scale_factor, dim=2)
