"""The port's masked forwards (univer_ocr_tpu_torch.models.fastpath)
against the JAX package's (univer_ocr_tpu.models.fastpath) on the
committed checkpoint and the same seeded float32 inputs.

Bar in 'highest': 1e-5 (the parity bar of the JAX package); for the Char
logits, whose magnitude reaches ~70 on this checkpoint, 1e-5 of that
magnitude (float32 sums over K=960 and K=512 in another order; measured
<= 3e-4 against max |logit| ~67), and the argmax must agree everywhere.
'bf16': both sides round each layer's operands to bfloat16 and sum the
products in float32, so only the sum order differs, compounded over the
five Line layers.  The budget on these sigmoid outputs in [0, 1]:
max |diff| <= 1e-6 and mean |diff| <= 1e-9 (measured: max 1.2e-7, mean
2.4e-11 over five seeds)."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from univer_ocr_tpu.models import fastpath as jfp
from univer_ocr_tpu_torch.models import fastpath as tfp
from univer_ocr_tpu_torch.ops.kernels import fused_monochrome
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT, params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_MAX, BF16_MEAN = 1e-6, 1e-9


@pytest.fixture(scope='module')
def params():
    with open(DEFAULT_CHECKPOINT) as fp:
        weights = json.load(fp)
    jax_params = {name: {k: jnp.asarray(np.asarray(v, np.float32))
                         for k, v in entry.items()}
                  for name, entry in weights.items()}
    return jax_params, params_from_numpy(weights, 'cpu')


def _page(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_monochrome_forward(params):
    jp, tp = params
    x = _page(0, (2, 40, 52, 1))
    got = tfp.monochrome_forward(tp, torch.from_numpy(x), precision='highest')
    exp = jfp.monochrome_forward(jp, jnp.asarray(x), precision='highest')
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)
    fused = fused_monochrome(torch.from_numpy(x), tfp.monochrome_weights(tp))
    np.testing.assert_allclose(fused.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize('prefix,channels,precision', [
    ('Paragraph', 1, 'highest'),
    ('Line', 1, 'highest'),
    ('Line', 1, 'bf16'),
])
def test_line_forward_masked(params, prefix, channels, precision):
    jp, tp = params
    # a bucket of 64x96 holding crops of ragged valid extents
    x = _page(1, (3, 64, 96, channels))
    hv = np.array([64, 44, 20], np.int32)
    wv = np.array([96, 60, 32], np.int32)
    got = tfp.line_forward_masked(tp, torch.from_numpy(x),
                                  torch.from_numpy(hv), torch.from_numpy(wv),
                                  prefix=prefix, precision=precision)
    exp = jfp.line_forward_masked(jp, jnp.asarray(x), jnp.asarray(hv),
                                  jnp.asarray(wv), prefix=prefix,
                                  precision=precision)
    got, exp = got.numpy(), np.asarray(exp)
    assert got.shape == exp.shape
    # callers read only the valid region
    a = np.concatenate([got[n, :hv[n], :wv[n]].ravel() for n in range(3)])
    b = np.concatenate([exp[n, :hv[n], :wv[n]].ravel() for n in range(3)])
    if precision == 'highest':
        np.testing.assert_allclose(a, b, **TOL)
    else:
        diff = np.abs(a - b)
        assert diff.max() <= BF16_MAX and diff.mean() <= BF16_MEAN, (
            diff.max(), diff.mean())


@pytest.mark.parametrize('head', ['xla', 'kernel', 'conv'])
def test_char_forward_masked(params, head):
    """The 'conv' head (unfold + dense_1 as a width-8 convolution, the
    JAX device cascade's) is held against JAX's 'conv' head, the others
    against its 'xla' head."""
    jp, tp = params
    x = _page(2, (3, 32, 64, 1))
    wv = np.array([64, 40, 8], np.int32)
    got = tfp.char_forward_masked(
        tp, torch.from_numpy(x), torch.from_numpy(wv), precision='highest',
        head=tfp.char_head_weights(tp) if head == 'kernel' else head)
    exp = jfp.char_forward_masked(jp, jnp.asarray(x), jnp.asarray(wv),
                                  precision='highest',
                                  head='conv' if head == 'conv' else 'xla')
    got, exp = got.numpy(), np.asarray(exp)
    assert got.shape == exp.shape == (3, 64, 162)
    scale = np.abs(exp).max()
    for n in range(len(wv)):
        np.testing.assert_allclose(got[n, :wv[n]], exp[n, :wv[n]],
                                   rtol=1e-5, atol=1e-5 * scale)
        # the argmax the pipeline reads agrees column for column
        np.testing.assert_array_equal(got[n, :wv[n]].argmax(-1),
                                      exp[n, :wv[n]].argmax(-1))
