"""Fused Char head: the CUDA kernel `csrc/char_head.cu`, the preparation
of its weights, and its plain PyTorch version.

Replaces univer_ocr_tpu/ops/pallas/char_head.py:fused_char_head.  For the
conv stack's (N, W, 64) output it computes the width-8 unfold (window j
reads columns [j-4, j+4), zero-padded), dense 512->1024 + LeakyReLU, dense
1024->128 + LeakyReLU and dense 128->162, each bias the last row of its
weight, and returns the (N, W, 162) logits.

The kernel runs the three products on the tensor cores in 3xTF32: every
float32 operand v is split into big = tf32(v) and small = tf32(v - big)
(round to nearest, ties away, as `cvt.rna.tf32.f32`), and each product is
big*big + big*small + small*big summed in float32.  That keeps about 21
bits of each operand, which the 2e-4 bar on logits near 70 needs; plain
TF32 (10 bits) misses it.  The split, the order in which the kernel reads
the weights and the padding of the last layer to a multiple of 8 outputs
are done once per set of weights by `prepare_char_head`; the wrapper
takes the `CharHeadWeights` it returns and raises on anything else.

Bound on the H100 at the precision the path needs: three TF32 products of
1,352,192 FLOP per column (4,056,576 FLOP) at 495 TFLOP/s, so 0.0336 ms
for 16 lines at W=256 (0.2685 ms at W=2048).  See the source for the
tiling.

A CPU tensor takes `fused_char_head_reference`; a CUDA tensor launches the
kernel or raises.
"""

import collections

import torch

from .. import dense, leaky_relu, unfold_to_fixed_width
from . import _build

LEAKY_ALPHA = 0.01
UNFOLD = 8
CHANNELS = 64
D1, D2 = 1024, 128
MAX_OUT = 192
NAME = 'fused_char_head'
#: D1 is split over PARTS CTAs per tile of TILE columns (csrc/char_head.cu
#: kParts, kBM), each walking its share in chunks of CHUNK hidden units
PARTS, CHUNK, TILE = 4, 128, 128
#: weights streamed per ring stage: 16 rows of W1's chunk or 16 of W2's
STAGE_FLOATS = 4096
#: K steps of 8 in a W1 stage, and the stages of a chunk: W1's, then W2's
W1_KSTEPS = STAGE_FLOATS // (2 * 8 * CHUNK)
W1_STAGES = CHANNELS * UNFOLD // (8 * W1_KSTEPS)
CHUNK_STAGES = W1_STAGES + CHUNK // 16

#: launches of the kernel by the width W of its input, and by its (N, W),
#: counted where `_build.LAUNCHES` counts them (the path's width mix)
WIDTH_LAUNCHES = collections.Counter()
SHAPE_LAUNCHES = collections.Counter()


def fused_char_head_reference(x, w1, w2, w3, precision='highest'):
    """Plain PyTorch version: unfold + flatten + three dense layers, in
    full float32 unless `precision` says otherwise (ops/precision.py)."""
    N, W, C = x.shape
    unfolded = unfold_to_fixed_width(x[:, None, :, :], UNFOLD)
    flat = unfolded.reshape(unfolded.shape[0], -1)
    h = leaky_relu(dense(flat, w1, precision=precision), LEAKY_ALPHA)
    h = leaky_relu(dense(h, w2, precision=precision), LEAKY_ALPHA)
    logits = dense(h, w3, precision=precision)
    return logits.reshape(N, W, -1)


def round_tf32(v):
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as `cvt.rna.tf32.f32`: the low 13 bits of the result are 0."""
    bits = v.contiguous().view(torch.int32).to(torch.int64)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).to(torch.int32).view(torch.float32).reshape(v.shape)


def split_tf32(v):
    """v -> (big, small), both TF32 values, big + small within 2^-21 of
    v relative to |v| (the kernel's 3xTF32 operands)."""
    big = round_tf32(v)
    return big, round_tf32(v - big)


def lane_rows(paired):
    """The two K rows of an 8-row step that lane (g, t) of an
    `mma.m16n8k8` B fragment holds: (t, t+4), or (2t, 2t+1) where the A
    operand is a product's accumulator reused in registers."""
    t = torch.arange(32) % 4
    return (2 * t, 2 * t + 1) if paired else (t, t + 4)


def pack_fragments(b, paired=False):
    """(K, N) float32 -> (K/8, N/8, 32, 4): for each 8x8 block of B, lane
    (g, t) = (lane // 4, lane % 4) gets the values of its `mma.m16n8k8`
    TF32 B fragment (K rows `lane_rows`, column g) as
    (big_0, big_1, small_0, small_1): one 16-byte load a lane."""
    K, N = b.shape
    big, small = split_tf32(b)
    g = torch.arange(32, device=b.device) // 4
    k0, k1 = (k.to(b.device) for k in lane_rows(paired))

    def blocks(m):       # (K/8, N/8, 8 rows, 8 columns)
        return m.reshape(K // 8, 8, N // 8, 8).permute(0, 2, 1, 3)

    bb, sb = blocks(big), blocks(small)
    return torch.stack([bb[:, :, k0, g], bb[:, :, k1, g],
                        sb[:, :, k0, g], sb[:, :, k1, g]], dim=-1)


def pack_w1_stages(w1):
    """W1's (512, 1024) rows -> (PARTS, chunks, W1_STAGES, 4096), the
    stages in which the kernel's `wgmma` reads it: for each chunk of CHUNK
    hidden units and each 8 * W1_KSTEPS K rows, W1_KSTEPS k-steps of (big,
    small), each the chunk's CHUNK x 8 block transposed (K-major, as wgmma
    takes .tf32 B) and cut into 8 x 4 core matrices of 128 bytes, ordered
    (8-unit group, k half, unit, k)."""
    big, small = split_tf32(w1)
    chunks = D1 // PARTS // CHUNK
    s = torch.stack([big, small]).reshape(2, W1_STAGES, W1_KSTEPS, 2, 4,
                                          PARTS, chunks, CHUNK // 8, 8)
    return s.permute(5, 6, 1, 2, 0, 7, 3, 8, 4).reshape(
        PARTS, chunks, -1, STAGE_FLOATS)


class CharHeadWeights:
    """The Char head's weights as the kernel reads them, made once per set
    of weights by `prepare_char_head`.

    `w1`, `w2`, `w3`: the checkpoint's (513, 1024), (1025, 128), (129, D3)
    matrices, for the plain version.  `stream`: (PARTS, D1 / PARTS /
    CHUNK, CHUNK_STAGES, 4096) float32: for each share of D1 and chunk of
    CHUNK hidden units, W1_STAGES stages of W1's columns (packed by
    `pack_w1_stages`), then the chunk's rows of W2, 16 a stage (packed by
    `pack_fragments`, `paired`).
    `w3_frags`: W3 zero-padded to a multiple of 8 outputs and packed.
    `b1`, `b2`, `b3`: the bias rows, `b3` padded like W3."""

    def __init__(self, w1, w2, w3, stream, w3_frags, b1, b2, b3):
        self.w1, self.w2, self.w3 = w1, w2, w3
        self.stream, self.w3_frags = stream, w3_frags
        self.b1, self.b2, self.b3 = b1, b2, b3
        self.n_out = w3.shape[1]


def prepare_char_head(w1, w2, w3):
    """Split, reorder and pad the Char head's weights for the kernel, on
    their own device (see `CharHeadWeights`)."""
    k1 = CHANNELS * UNFOLD
    if tuple(w1.shape) != (k1 + 1, D1) or tuple(w2.shape) != (D1 + 1, D2):
        raise ValueError(f'{NAME}: w1 must be ({k1 + 1}, {D1}) and w2 '
                         f'({D1 + 1}, {D2}), got {tuple(w1.shape)} and '
                         f'{tuple(w2.shape)}')
    if (w3.dim() != 2 or w3.shape[0] != D2 + 1
            or not 0 < w3.shape[1] <= MAX_OUT):
        raise ValueError(f'{NAME}: w3 must be ({D2 + 1}, n_out) with n_out '
                         f'<= {MAX_OUT}, got {tuple(w3.shape)}')
    w1, w2, w3 = (w.float().contiguous() for w in (w1, w2, w3))
    chunks = D1 // PARTS // CHUNK
    p1 = pack_w1_stages(w1[:k1])
    # W2: (128 ksteps, 16 ntiles, 32, 4) -> stages of 2 ksteps x 16 ntiles
    p2 = pack_fragments(w2[:D1], paired=True).reshape(
        PARTS, chunks, -1, STAGE_FLOATS)
    stream = torch.cat([p1, p2], dim=2).contiguous()
    n_out = w3.shape[1]
    n_pad = -(-n_out // 8) * 8
    w3p = torch.zeros((D2 + 1, n_pad), dtype=torch.float32, device=w3.device)
    w3p[:, :n_out] = w3
    return CharHeadWeights(
        w1, w2, w3, stream, pack_fragments(w3p[:D2]).contiguous(),
        w1[k1].contiguous(), w2[D1].contiguous(), w3p[D2].contiguous())


def _check(t, name, dev, shape):
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f'{NAME}: {name} must be float32 on {dev}, '
                         f'got {t.dtype} on {t.device}')
    if tuple(t.shape) != shape:
        raise ValueError(f'{NAME}: {name} must have shape {shape}, '
                         f'got {tuple(t.shape)}')
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f'{NAME}: {name} must be contiguous and 16-byte '
                         f'aligned')


def fused_char_head(x, head):
    """x: (N, W, 64) float32; head: the `CharHeadWeights` of the weights,
    on x's device.  Returns (N, W, n_out) float32."""
    if not isinstance(head, CharHeadWeights):
        raise TypeError(f'{NAME}: weights must be prepared by '
                        f'prepare_char_head, got {type(head).__name__}')
    if x.device.type == 'cpu':
        return fused_char_head_reference(x, head.w1, head.w2, head.w3)
    if x.device.type != 'cuda':
        raise ValueError(f'{NAME}: unsupported device {x.device}')
    if x.dim() != 3:
        raise ValueError(f'{NAME}: x must be (N, W, 64)')
    dev = x.device
    N, W, _ = x.shape
    n_pad = -(-head.n_out // 8) * 8
    _check(x, 'x', dev, (N, W, CHANNELS))
    _check(head.stream, 'stream', dev,
           (PARTS, D1 // PARTS // CHUNK, CHUNK_STAGES, STAGE_FLOATS))
    _check(head.w3_frags, 'w3_frags', dev, (D2 // 8, n_pad // 8, 32, 4))
    _check(head.b1, 'b1', dev, (D1,))
    _check(head.b2, 'b2', dev, (D2,))
    _check(head.b3, 'b3', dev, (n_pad,))
    out = torch.empty((N, W, head.n_out), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    # per tile of TILE columns (the kernel's kBM): the PARTS partial sums
    # of h2, and how many have arrived
    tiles = N * -(-W // TILE)
    partial = torch.empty((tiles, PARTS, TILE, D2), dtype=torch.float32,
                          device=dev)
    arrived = torch.zeros(tiles, dtype=torch.int32, device=dev)
    fn = _build.function('uocr_char_head', 'pppppppppiiip')
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), head.stream.data_ptr(),
                  head.w3_frags.data_ptr(), head.b1.data_ptr(),
                  head.b2.data_ptr(), head.b3.data_ptr(), partial.data_ptr(),
                  arrived.data_ptr(), out.data_ptr(), N, W, head.n_out,
                  stream)
    _build.check(code, NAME)
    with _build.COUNT_LOCK:
        _build.LAUNCHES[NAME] += 1
        _build.DEVICE_LAUNCHES[(NAME, dev.index)] += 1
        WIDTH_LAUNCHES[W] += 1
        SHAPE_LAUNCHES[(N, W)] += 1
    return out
