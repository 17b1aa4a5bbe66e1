"""The arithmetic of the 3xTF32 Char head kernel (csrc/char_head.cu),
emulated in torch on the CPU, against the JAX package's
`fused_char_head_reference`.

The emulation reads the weights exactly as the kernel does: from the
prepared stream (`prepare_char_head`), chunk by chunk of the four CTAs' shares
of D1, through the core matrices of `wgmma` (W1) and the lane layout of
the `mma.m16n8k8` B fragments (W2, W3).
Every float32 operand v is split into big = tf32(v) (round to nearest,
ties away, as `cvt.rna.tf32.f32`) and small = tf32(v - big); each product
is small*big + big*small + big*big in float32 (a product of two TF32
values is exact in float32, so only the sum order differs from the card).
Inputs are realistic: the Char conv stack's output on seeded random lines,
with the committed checkpoint's weights, as chip_smoke.py feeds the
kernel.  Bars: rtol 2e-4 / atol 1e-4 and argmax agreement >= 99.9 %, those
of chip_smoke.py.  Plain single TF32 on the same inputs must be less
accurate; whether it misses the bar is printed, not asserted."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from univer_ocr_tpu.ops.pallas import (fused_char_head_reference
                                       as jax_char_head_reference)
from univer_ocr_tpu_torch import ops
from univer_ocr_tpu_torch.ops.kernels.char_head import (
    CHUNK, CHUNK_STAGES, D1, PARTS, LEAKY_ALPHA, UNFOLD, W1_KSTEPS,
    W1_STAGES, lane_rows, pack_fragments, prepare_char_head, round_tf32,
    split_tf32)
from univer_ocr_tpu_torch.weights import DEFAULT_CHECKPOINT, params_from_numpy

CHAR_TOL = dict(rtol=2e-4, atol=1e-4)
ARGMAX_AGREEMENT = 0.999


@pytest.fixture(scope='module')
def params():
    with open(DEFAULT_CHECKPOINT) as fp:
        return params_from_numpy(json.load(fp), 'cpu')


@pytest.fixture(scope='module')
def dense_w(params):
    return [params[f'Char/dense_block/dense_{i}']['w'] for i in (1, 2, 3)]


def _char_inputs(params, seed, n, width):
    """The Char conv stack's output on seeded random line images."""
    x = torch.from_numpy(np.random.default_rng(seed).random(
        (n, 32, width, 1), dtype=np.float32))
    for i in (1, 2, 3):
        p = params[f'Char/conv_block/conv_{i}']
        x = ops.leaky_relu(ops.conv2d(x, p['w'], p['b'], stride=(2, 1),
                                      padding=(0, 1), precision='highest'))
    return x[:, 0].contiguous()


def unpack_fragments(packed, paired=False):
    """Inverse of `pack_fragments`: (K/8, N/8, 32, 4) -> (big, small),
    each (K, N)."""
    ks, nt = packed.shape[:2]
    g = torch.arange(32) // 4
    k0, k1 = lane_rows(paired)
    out = torch.zeros(2, ks, nt, 8, 8, dtype=packed.dtype)
    for half in range(2):
        out[half][:, :, k0, g] = packed[..., 2 * half]
        out[half][:, :, k1, g] = packed[..., 2 * half + 1]
    out = out.permute(0, 1, 3, 2, 4).reshape(2, ks * 8, nt * 8)
    return out[0], out[1]


def unpack_w1_stages(stages):
    """Inverse of `pack_w1_stages` for one chunk: (W1_STAGES, 4096) ->
    (big, small), each (512, CHUNK)."""
    s = stages.reshape(-1, W1_KSTEPS, 2, CHUNK // 8, 2, 8, 4).permute(
        2, 0, 1, 4, 6, 3, 5)
    return tuple(s.reshape(2, -1, CHUNK))


def _leaky(v):
    return torch.where(v >= 0, v, LEAKY_ALPHA * v)


def _emulate(x, head, single=False):
    """The kernel's arithmetic: 3xTF32 (or, with `single`, one TF32 pass:
    big*big only), the hidden map walked in the kernel's chunks, the
    four CTAs' partial sums of h2 added in order."""
    def product(a, b_big, b_small):
        a_big, a_small = split_tf32(a)
        if single:
            return a_big @ b_big
        return a_small @ b_big + a_big @ b_small + a_big @ b_big

    N, W, C = x.shape
    a = ops.unfold_to_fixed_width(x[:, None], UNFOLD).reshape(N * W, -1)
    chunks = D1 // PARTS // CHUNK
    h2 = head.b2.clone().expand(N * W, -1)
    for p in range(PARTS):
        part = torch.zeros(N * W, head.b2.shape[0])
        for c in range(chunks):
            stages = head.stream[p, c]
            w1b, w1s = unpack_w1_stages(stages[:W1_STAGES])
            w2b, w2s = unpack_fragments(
                stages[W1_STAGES:].reshape(CHUNK // 8, 16, 32, 4),
                paired=True)
            hid = p * D1 // PARTS + c * CHUNK
            h1 = _leaky(product(a, w1b, w1s) + head.b1[hid:hid + CHUNK])
            part = part + product(h1, w2b, w2s)
        h2 = h2 + part
    w3b, w3s = unpack_fragments(head.w3_frags)
    logits = product(_leaky(h2), w3b, w3s) + head.b3
    return logits[:, :head.n_out].reshape(N, W, -1)


def test_round_tf32_is_cvt_rna():
    bits = torch.tensor([0x3F801000, 0x3F800FFF, 0x3F803000, 0x3F802FFF,
                         0x7F800000, 0x00000000], dtype=torch.int64)
    signed = torch.cat([bits, bits | 0x80000000])
    v = signed.to(torch.int32).view(torch.float32)
    got = round_tf32(v).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    # ties (low 13 bits 0x1000) go away from zero, in both signs
    want = torch.tensor([0x3F802000, 0x3F800000, 0x3F804000, 0x3F802000,
                         0x7F800000, 0x00000000], dtype=torch.int64)
    assert got.tolist() == torch.cat([want, want | 0x80000000]).tolist()


def test_prepared_weights(dense_w):
    w1, w2, w3 = dense_w
    head = prepare_char_head(w1, w2, w3)
    assert head.stream.shape == (PARTS, D1 // PARTS // CHUNK, CHUNK_STAGES,
                                 4096)
    assert head.w3_frags.shape == (16, 21, 32, 4) and head.b3.shape == (168,)
    # lane (g, t) of n-tile nt, k-step ks holds column nt*8 + g, K rows
    # ks*8 + (t, t+4): the K-major (transposed) copy the mma's B reads
    big, small = split_tf32(w3[:128])
    for ks, nt, lane in [(0, 0, 0), (3, 5, 13), (15, 20, 6), (7, 19, 31)]:
        g, t = lane // 4, lane % 4
        want = [big[ks * 8 + t, nt * 8 + g], big[ks * 8 + t + 4, nt * 8 + g],
                small[ks * 8 + t, nt * 8 + g],
                small[ks * 8 + t + 4, nt * 8 + g]]
        assert head.w3_frags[ks, nt, lane].tolist() == [float(v) for v in want]
    w3b, w3s = unpack_fragments(head.w3_frags)
    # the padding to 168 outputs is zero, in weights and bias
    assert not w3b[:, 162:].any() and not w3s[:, 162:].any()
    assert not head.b3[162:].any()
    assert torch.equal(head.b3[:162], w3[128])
    # W1 and W2 in the stream, stage by stage as the kernel reads them
    chunks = D1 // PARTS // CHUNK
    w1b = torch.zeros(512, D1)
    w1s = torch.zeros(512, D1)
    w2b = torch.zeros(D1, 128)
    w2s = torch.zeros(D1, 128)
    for p in range(PARTS):
        for c in range(chunks):
            hid = slice(p * D1 // PARTS + c * CHUNK,
                        p * D1 // PARTS + (c + 1) * CHUNK)
            stages = head.stream[p, c]
            w1b[:, hid], w1s[:, hid] = unpack_w1_stages(stages[:W1_STAGES])
            w2b[hid], w2s[hid] = unpack_fragments(
                stages[W1_STAGES:].reshape(CHUNK // 8, 16, 32, 4),
                paired=True)
    for b, s, w in [(w1b, w1s, w1[:512]), (w2b, w2s, w2[:D1]),
                    (w3b[:, :162], w3s[:, :162], w3[:128])]:
        for part in (b, s):        # TF32 values: the low 13 bits are 0
            assert not (part.view(torch.int32) & 0x1FFF).any()
        assert torch.equal(b, round_tf32(w))
        err = (b.double() + s.double() - w.double()).abs()
        assert (err <= 2.0 ** -21 * w.double().abs()).all()
    assert torch.equal(head.b1, w1[512]) and torch.equal(head.b2, w2[D1])
    # W1 is stored K-major (transposed) in 8 x 4 core matrices: the float
    # at (group 5, k half 1, unit 3, k 2) of big k-step 0 of stage 1 of
    # share 1, chunk 1 is W1[1*16 + 0*8 + 1*4 + 2, 256 + 1*128 + 5*8 + 3]
    assert CHUNK == 128
    assert head.stream[1, 1, 1, 5 * 64 + 32 + 3 * 4 + 2] == \
        round_tf32(w1[22, 256 + 128 + 43])
    # the paired order of W2: lane (g, t) holds K rows (2t, 2t+1)
    p2 = pack_fragments(w2[:D1], paired=True)
    assert p2[2, 1, 4 * 3 + 2, 0] == round_tf32(w2[2 * 8 + 4, 8 + 3])
    assert p2[2, 1, 4 * 3 + 2, 1] == round_tf32(w2[2 * 8 + 5, 8 + 3])


@pytest.mark.parametrize('n,width,seed', [(4, 128, 0), (3, 37, 1)])
def test_3xtf32_matches_jax_reference(params, dense_w, n, width, seed):
    x = _char_inputs(params, seed, n, width)
    head = prepare_char_head(*dense_w)
    exp = np.asarray(jax_char_head_reference(
        jnp.asarray(x.numpy()), *[jnp.asarray(w.numpy()) for w in dense_w]))
    got = _emulate(x, head).numpy()
    single = _emulate(x, head, single=True).numpy()
    assert got.shape == exp.shape == (n, width, 162)
    err3 = np.abs(got - exp).max()
    err1 = np.abs(single - exp).max()
    bar = CHAR_TOL['atol'] + CHAR_TOL['rtol'] * np.abs(exp)
    print(f'\n(n={n}, W={width}) max |logit| {np.abs(exp).max():.2f}: '
          f'3xTF32 max err {err3:.3e}, single TF32 max err {err1:.3e}, '
          f'single TF32 within the bar: '
          f'{bool((np.abs(single - exp) <= bar).all())}')
    np.testing.assert_allclose(got, exp, **CHAR_TOL)
    agree = (got.argmax(-1) == exp.argmax(-1)).mean()
    assert agree >= ARGMAX_AGREEMENT, agree
    assert err1 > err3
