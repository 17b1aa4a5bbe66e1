"""The port's kernel modules (univer_ocr_tpu_torch.ops.kernels) against
the JAX package's Pallas kernels, run in interpret mode on the CPU as the
JAX package's own tests run them, on the same numpy inputs.

On the CPU each wrapper takes its plain PyTorch version; the CUDA kernels
themselves are held against those plain versions by the tests marked
`cuda`, which skip without a card, and by chip_smoke.py on the card.
Bars: fused_monochrome rtol 1e-5 / atol 1e-6, fused_char_head rtol 2e-4 /
atol 1e-4, the bars of the JAX package's tests/test_pallas.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from univer_ocr_tpu.ops.pallas import (fused_char_head as jax_char_head,
                                       fused_char_head_reference
                                       as jax_char_head_reference,
                                       fused_monochrome as jax_monochrome,
                                       fused_monochrome_reference
                                       as jax_monochrome_reference)
from univer_ocr_tpu_torch.ops.kernels import (LAUNCHES, fused_char_head,
                                              fused_char_head_reference,
                                              fused_monochrome,
                                              fused_monochrome_reference,
                                              prepare_char_head,
                                              prepare_monochrome)
from univer_ocr_tpu_torch.ops.kernels.char_head import WIDTH_LAUNCHES
from univer_ocr_tpu_torch.ops.precision import backend_flags

MONO_TOL = dict(rtol=1e-5, atol=1e-6)
CHAR_TOL = dict(rtol=2e-4, atol=1e-4)


def _mono_inputs(seed, shape, signed=False):
    rs = np.random.RandomState(seed)
    draw = rs.randn if signed else rs.rand
    x = draw(*shape).astype(np.float32)
    w1 = (draw(3, 3, 1, 16) * 0.3).astype(np.float32)
    b1 = (draw(16) * 0.1).astype(np.float32)
    w2 = (draw(3, 3, 16, 1) * 0.3).astype(np.float32)
    b2 = (draw(1) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def _char_inputs(seed, n, w):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, w, 64).astype(np.float32) * 0.1
    w1 = rs.randn(513, 1024).astype(np.float32) * 0.05
    w2 = rs.randn(1025, 128).astype(np.float32) * 0.05
    w3 = rs.randn(129, 162).astype(np.float32) * 0.05
    return x, w1, w2, w3


def _torch(arrays, device='cpu'):
    return [torch.from_numpy(a).to(device) for a in arrays]


# the shapes of tests/test_pallas.py, plus a ragged page whose sides are
# multiples of nothing the kernels tile by
@pytest.mark.parametrize('shape,strip_h,signed', [
    ((1, 128, 256, 1), 64, False),
    ((1, 64, 128, 1), 32, True),
    ((2, 100, 203, 1), 20, True),
])
def test_fused_monochrome_reference_matches_jax(shape, strip_h, signed):
    args = _mono_inputs(sum(shape), shape, signed)
    got = fused_monochrome_reference(*_torch(args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    kernel = np.asarray(jax_monochrome(*jargs, strip_h=strip_h,
                                       interpret=True))
    reference = np.asarray(jax_monochrome_reference(*jargs))
    assert got.shape == kernel.shape == shape
    np.testing.assert_allclose(got, kernel, **MONO_TOL)
    np.testing.assert_allclose(got, reference, **MONO_TOL)


@pytest.mark.parametrize('n,w', [(2, 128), (1, 64)])
def test_fused_char_head_reference_matches_jax(n, w):
    args = _char_inputs(n + w, n, w)
    got = fused_char_head_reference(*_torch(args)).numpy()
    kernel = np.asarray(jax_char_head(*[jnp.asarray(a) for a in args],
                                      interpret=True))
    reference = np.asarray(jax_char_head_reference(
        *[jnp.asarray(a) for a in args]))
    assert got.shape == kernel.shape == (n, w, 162)
    np.testing.assert_allclose(got, kernel, **CHAR_TOL)
    np.testing.assert_allclose(got, reference, **CHAR_TOL)


def test_cpu_wrappers_take_the_plain_path():
    before = dict(LAUNCHES)
    before_widths = dict(WIDTH_LAUNCHES)
    mono = _torch(_mono_inputs(3, (1, 20, 30, 1), signed=True))
    np.testing.assert_array_equal(
        fused_monochrome(mono[0], prepare_monochrome(*mono[1:])).numpy(),
        fused_monochrome_reference(*mono).numpy())
    char = _torch(_char_inputs(4, 2, 12))
    np.testing.assert_array_equal(
        fused_char_head(char[0], prepare_char_head(*char[1:])).numpy(),
        fused_char_head_reference(*char).numpy())
    assert dict(LAUNCHES) == before
    assert dict(WIDTH_LAUNCHES) == before_widths


def test_wrappers_refuse_other_devices():
    mono = _torch(_mono_inputs(5, (1, 4, 4, 1)))
    with pytest.raises(ValueError):
        fused_monochrome(mono[0].to('meta'), prepare_monochrome(*mono[1:]))
    char = _torch(_char_inputs(6, 1, 4))
    with pytest.raises(ValueError):
        fused_char_head(char[0].to('meta'), prepare_char_head(*char[1:]))


def test_wrappers_refuse_unprepared_weights():
    mono = _torch(_mono_inputs(9, (1, 4, 4, 1)))
    with pytest.raises(TypeError):
        fused_monochrome(*mono)
    char = _torch(_char_inputs(10, 1, 4))
    with pytest.raises(TypeError):
        fused_char_head(char[0], char[1:])
    with pytest.raises(ValueError):
        prepare_char_head(char[1][:-1], *char[2:])
    with pytest.raises(ValueError):
        prepare_monochrome(mono[1], mono[2], mono[3][..., :1, :], mono[4])


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (run on the H100: chip_smoke.py)')


@pytest.mark.cuda
def test_fused_monochrome_kernel_on_card():
    _need_card()
    for shape in [(8, 496, 736, 1), (2, 100, 203, 1), (1, 1, 1, 1)]:
        args = _torch(_mono_inputs(7, shape, signed=True), 'cuda')
        got = fused_monochrome(args[0], prepare_monochrome(*args[1:]))
        with backend_flags('highest'):
            exp = fused_monochrome_reference(*args)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(),
                                   **MONO_TOL)


@pytest.mark.cuda
def test_fused_char_head_kernel_on_card():
    _need_card()
    for n, w in [(16, 256), (3, 37)]:
        args = _torch(_char_inputs(8, n, w), 'cuda')
        got = fused_char_head(args[0], prepare_char_head(*args[1:]))
        with backend_flags('highest'):
            exp = fused_char_head_reference(*args)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(),
                                   **CHAR_TOL)
