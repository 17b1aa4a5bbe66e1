"""The port's ops (univer_ocr_tpu_torch.ops) against the JAX package's
(univer_ocr_tpu.ops) on the same float32 inputs, made with numpy from a
seed.  Bar: 1e-5 (the parity bar of the JAX package's own identity
tests), in 'bf16' too: both sides round the operands to bfloat16 and sum
their products in float32, so only the sum order differs (measured
<= 7.2e-7 on the dense case, 0 on the conv case, over three seeds)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from univer_ocr_tpu import ops as jops
from univer_ocr_tpu_torch import ops as tops


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _conv_case(x_shape, w_shape, stride, padding, padding_value=0.0,
               precision='highest'):
    def run(rs):
        # activations of this zoo are O(1); weights at the 1/sqrt(fan-in)
        # scale of their initializer, so outputs are O(1) too
        x = rs.rand(*x_shape).astype(np.float32)
        fan_in = w_shape[0] * w_shape[1] * w_shape[2]
        w = _rand(rs, *w_shape) / np.float32(np.sqrt(fan_in))
        b = _rand(rs, w_shape[-1])
        kw = dict(stride=stride, padding=padding,
                  padding_value=np.float32(padding_value), precision=precision)
        got = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), **kw)
        exp = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw)
        return got, exp
    return run


def _unary_case(name, *args):
    def run(rs):
        x = _rand(rs, 3, 6, 7, 2)
        got = getattr(tops, name)(torch.from_numpy(x), *args)
        exp = getattr(jops, name)(jnp.asarray(x), *args)
        return got, exp
    return run


def _unfold_case(rs):
    x = _rand(rs, 2, 1, 10, 64)
    return (tops.unfold_to_fixed_width(torch.from_numpy(x), 8),
            jops.unfold_to_fixed_width(jnp.asarray(x), 8))


def _dense_case(precision):
    def run(rs):
        x = rs.rand(5, 512).astype(np.float32)
        w = _rand(rs, 513, 96) / np.float32(np.sqrt(512))
        return (tops.dense(torch.from_numpy(x), torch.from_numpy(w),
                           precision=precision),
                jops.dense(jnp.asarray(x), jnp.asarray(w),
                           precision=precision))
    return run


CASES = {
    # the strides and pads the models use
    'conv_monochrome_k3_p1': _conv_case((2, 9, 11, 1), (3, 3, 1, 16),
                                        (1, 1), (1, 1)),
    'conv_monochrome_16to1': _conv_case((2, 9, 11, 16), (3, 3, 16, 1),
                                        (1, 1), (1, 1)),
    'conv_line_down_s2_p2': _conv_case((2, 16, 20, 4), (5, 5, 4, 4),
                                       (2, 2), (2, 2)),
    'conv_paragraph_p2': _conv_case((2, 16, 20, 1), (5, 5, 1, 1),
                                    (1, 1), (2, 2)),
    'conv_char_s21_p01': _conv_case((2, 32, 12, 1), (5, 3, 1, 64),
                                    (2, 1), (0, 1)),
    'conv_char_64to64': _conv_case((2, 14, 12, 64), (5, 3, 64, 64),
                                   (2, 1), (0, 1)),
    'conv_padding_value': _conv_case((1, 7, 8, 2), (3, 3, 2, 3),
                                     (1, 1), (1, 2), padding_value=0.5),
    'unfold_width8': _unfold_case,
    'dense_bias_row': _dense_case('highest'),
    'leaky_relu': _unary_case('leaky_relu', 0.01),
    'sigmoid': _unary_case('sigmoid'),
    'upsample2d': _unary_case('upsample2d', 2),
}

BF16_CASES = {
    'conv_line_down_s2_p2_bf16': _conv_case((2, 16, 20, 4), (5, 5, 4, 4),
                                            (2, 2), (2, 2),
                                            precision='bf16'),
    'dense_bias_row_bf16': _dense_case('bf16'),
}


@pytest.mark.parametrize('name', sorted(CASES) + sorted(BF16_CASES))
def test_op_matches_jax(name):
    rs = np.random.RandomState(sorted(CASES).index(name)
                               if name in CASES else 100)
    got, exp = (CASES.get(name) or BF16_CASES[name])(rs)
    got = got.numpy()
    exp = np.asarray(exp)
    assert got.dtype == np.float32
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-5)


def _tf32_switches():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize('mode,inside', [('highest', (False, False)),
                                         ('bf16', (True, True))])
def test_backend_flags_set_and_restore_tf32(mode, inside):
    # start from the opposite of what the mode sets, so that both the
    # setting and the restoring show
    before = (not inside[0], not inside[1])
    saved = _tf32_switches()
    try:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before
        with tops.precision.backend_flags(mode):
            seen = _tf32_switches()
        after = _tf32_switches()
        with pytest.raises(ValueError):
            with tops.precision.backend_flags('fp16'):
                pass
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert seen == inside
    assert after == before
