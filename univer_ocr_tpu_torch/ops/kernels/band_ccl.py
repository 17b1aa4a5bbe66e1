"""Connected components and their statistics: the CUDA kernel
`csrc/band_ccl.cu` and its plain PyTorch version.

For N binary images, each with a valid region (h_valid, w_valid) at its
origin, it labels the foreground 4-connected (scipy.ndimage.label's
default structure) and returns, per image, each component's pixel count,
y and x sums and box, in raster order of the components' first pixels
(scipy's numbering, less one): the device twin of `native.label_stats`.
The device cascade labels both band channels of every paragraph of a
launch with it, and the paragraph masks of a chunk.

Bound on the H100: traffic.  The compulsory bytes are the masks, one
byte a pixel, and the tables, 7 ints a component; the kernel also reads
and writes a 4-byte label a pixel a few times, mostly in L2.  Latency
bounds it in practice (unions and root searches are chains of dependent
loads), so the kernel spreads each image over many blocks, with
coalesced passes: union-find in shared memory over a tile, a merge
across the tile borders, a compression that ranks the roots of each row
segment, one scan an image over the segments' counts, and the
statistics flushed from a shared table (see the source).  `tile_shape`
picks the tiles from (N, H, W): full rows up to 1024 pixels wide, as
many rows as 8192 pixels allow, fewer where that gives a launch fewer
than TARGET_BLOCKS blocks.  One C call launches the five kernels, their
grids fixed by the shape, so a CUDA graph replays them.

A CPU tensor takes `band_ccl_reference`; a CUDA tensor launches the kernel
or raises.
"""

import collections

import torch

from . import _build

NAME = 'band_ccl'
#: fields of a component's row in the statistics table
FIELDS = ('count', 'sum_y', 'sum_x', 'y0', 'y1', 'x0', 'x1')
#: largest table a launch may ask for (the kernel's shared table)
MAX_TABLE = 256

#: launches of the kernel by the (N, H, W) of its input, counted where
#: `_build.LAUNCHES` counts them
SHAPE_LAUNCHES = collections.Counter()
#: a tile's pixels at most: its labels fill 32 KB of a block's shared memory
TILE_PIXELS = 8192
#: the widest tile; wider images are cut into tiles side by side
MAX_TILE_WIDTH = 1024
#: blocks a launch aims at: four for each of the H100's 132 SMs
TARGET_BLOCKS = 4 * 132
#: the fewest rows of a tile cut short for TARGET_BLOCKS
MIN_TILE_HEIGHT = 4


def tile_shape(N, H, W):
    """(tile_h, tile_w) of the kernel's tiles for N images of H x W."""
    tiles_x = -(-W // MAX_TILE_WIDTH)
    tile_w = -(-W // tiles_x)
    per_image = -(-TARGET_BLOCKS // (N * tiles_x))
    tile_h = max(MIN_TILE_HEIGHT, -(-H // per_image))
    return min(tile_h, TILE_PIXELS // tile_w, H), tile_w


def _valid_region(masks, h_valid, w_valid):
    N, H, W = masks.shape
    rows = torch.arange(H, device=masks.device).reshape(1, H, 1)
    cols = torch.arange(W, device=masks.device).reshape(1, 1, W)
    return ((masks != 0) & (rows < h_valid.reshape(N, 1, 1))
            & (cols < w_valid.reshape(N, 1, 1)))


def _min_labels(fg):
    """Each foreground pixel's smallest raster index over its 4-connected
    component ((N, H*W) int64), H*W on the background: every round hooks
    each label's root under the smallest label next to it, then jumps
    pointers until every label is a root, until nothing moves."""
    N, H, W = fg.shape
    dev = fg.device
    size = N * H * W
    idx = torch.arange(size, device=dev).reshape(N, H, W)
    parent = torch.cat([torch.where(fg, idx, size).reshape(-1),
                        torch.tensor([size], device=dev)])
    lab = parent[:-1].reshape(N, H, W).clone()
    while True:
        low = lab
        for dim in (1, 2):
            for step in (1, -1):
                shifted = torch.roll(lab, step, dims=dim)
                edge = (torch.arange(lab.shape[dim], device=dev)
                        == (0 if step == 1 else lab.shape[dim] - 1))
                edge = edge.reshape((1, -1, 1) if dim == 1 else (1, 1, -1))
                low = torch.minimum(low, torch.where(edge, size, shifted))
        low = torch.where(fg, low, size)
        parent.scatter_reduce_(0, lab.reshape(-1), low.reshape(-1), 'amin')
        while True:
            jumped = parent[parent]
            if torch.equal(jumped, parent):
                break
            parent = jumped
        new = parent[idx]
        if torch.equal(new, lab):
            break
        lab = new
    n_of = (torch.arange(N, device=dev) * (H * W)).reshape(N, 1, 1)
    return torch.where(fg, lab - n_of, H * W).reshape(N, H * W)


def band_ccl_reference(masks, h_valid, w_valid, max_comp, labels=False):
    """Plain version of `band_ccl`, with its arguments and results."""
    N, H, W = masks.shape
    dev = masks.device
    fg = _valid_region(masks, h_valid, w_valid)
    lab = _min_labels(fg)
    lin = torch.arange(H * W, device=dev)
    is_root = fg.reshape(N, H * W) & (lab == lin)
    n_comp = is_root.sum(dim=1).to(torch.int32)
    rank = torch.cumsum(is_root, dim=1) - 1
    member = lab < H * W
    slot = torch.gather(rank, 1, torch.where(member, lab, 0))
    out_labels = torch.where(member, slot, -1)
    M = max_comp
    slot = torch.where(member & (slot < M), slot, M)
    ys, xs = lin // W, lin % W

    def segment(values, init, reduce):
        out = torch.full((N, M + 1), init, dtype=torch.int64, device=dev)
        values = values.expand(N, -1)
        if reduce == 'sum':
            out.scatter_add_(1, slot, values)
        else:
            out.scatter_reduce_(1, slot, values, reduce, include_self=True)
        return out[:, :M]

    cnt = segment(member.to(torch.int64), 0, 'sum')
    table = torch.stack([
        cnt, segment(torch.where(member, ys, 0), 0, 'sum'),
        segment(torch.where(member, xs, 0), 0, 'sum'),
        segment(ys, H, 'amin'), segment(ys, -1, 'amax') + 1,
        segment(xs, W, 'amin'), segment(xs, -1, 'amax') + 1], dim=2)
    table = torch.where(cnt[..., None] > 0, table, 0).to(torch.int32)
    if labels:
        return table, n_comp, out_labels.reshape(N, H, W).to(torch.int32)
    return table, n_comp


def band_ccl(masks, h_valid, w_valid, max_comp, labels=False):
    """masks: (N, H, W) uint8 or bool; h_valid, w_valid: (N,) integer, the
    region at each image's origin to label.  Returns (stats (N, max_comp,
    7) int32 in FIELDS order, the stops exclusive, zero rows past the
    components; n_comp (N,) int32, every component counted, which may
    exceed max_comp) and, with `labels`, (N, H, W) int32 component ranks,
    -1 on the background and outside the valid region."""
    if not 0 < max_comp <= MAX_TABLE:
        raise ValueError(f'{NAME}: max_comp must be in 1..{MAX_TABLE}, got '
                         f'{max_comp}')
    if masks.dim() != 3:
        raise ValueError(f'{NAME}: masks must be (N, H, W), got '
                         f'{tuple(masks.shape)}')
    if masks.device.type == 'cpu':
        return band_ccl_reference(masks, h_valid, w_valid, max_comp, labels)
    if masks.device.type != 'cuda':
        raise ValueError(f'{NAME}: unsupported device {masks.device}')
    N, H, W = masks.shape
    dev = masks.device
    m = masks.to(torch.uint8).contiguous()
    hv = h_valid.to(device=dev, dtype=torch.int32).contiguous()
    wv = w_valid.to(device=dev, dtype=torch.int32).contiguous()
    stats = torch.empty((N, max_comp, len(FIELDS)), dtype=torch.int32,
                        device=dev)
    n_comp = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return (stats, n_comp) + ((m.to(torch.int32),) if labels else ())
    tile_h, tile_w = tile_shape(N, H, W)
    tiles_x = -(-W // tile_w)
    # the labels, then each row segment's count of roots
    scratch = torch.empty((N * H * (W + tiles_x),), dtype=torch.int32,
                          device=dev)
    out = (torch.full((N, H, W), -1, dtype=torch.int32, device=dev)
           if labels else None)
    fn = _build.function('uocr_band_ccl', 'pppiiiiiippppp')
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(m.data_ptr(), hv.data_ptr(), wv.data_ptr(), N, H, W,
                  max_comp, tile_h, tile_w, scratch.data_ptr(),
                  stats.data_ptr(), n_comp.data_ptr(),
                  None if out is None else out.data_ptr(), stream)
    _build.check(code, NAME)
    with _build.COUNT_LOCK:
        _build.LAUNCHES[NAME] += 1
        _build.DEVICE_LAUNCHES[(NAME, dev.index)] += 1
        SHAPE_LAUNCHES[(N, H, W)] += 1
    if labels:
        return stats, n_comp, out
    return stats, n_comp
