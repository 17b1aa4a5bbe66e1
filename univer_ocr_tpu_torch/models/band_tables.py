"""Band tables: the components of each paragraph's line bands, with their
statistics, computed on the device for the device cascade's line planner.

The host cascade thresholds a paragraph's Line prediction per channel
(`band_threshold`: above half of mean plus peak over the crop, by more
than 1e-6), labels each channel's mask 4-connected and pairs the top and
bottom components into lines from their boxes and centres
(interpreter.band_components and pair_lines).  Here one `band_ccl` launch
labels both channels of every paragraph of a launch and gathers each
component's pixel count, y and x sums and box (`band_tables`): the same
components in the same order, so the pairing on the device (the fused
tail) or on the host (the tables payload) gives the host's lines.

A channel with more components than the table holds is flagged by its
count (`n_comp` above MAX_BAND_COMPONENTS): its paragraph is planned on
the host from its band masks.  The cap is read at call time, so a test
can patch it.
"""

import numpy as np
import torch

from ..ops.kernels.band_ccl import FIELDS, band_ccl
from .fastpath import _mask_hw

#: component rows of each (paragraph, channel) table
MAX_BAND_COMPONENTS = 48


def band_threshold(pred, h_valid, w_valid):
    """The host cascade's band threshold of a (B, H, W, 2) Line
    prediction over each sample's valid region: (pred - 0.5 * (mean +
    max)) > 1e-6 per channel, the mean over the valid region, the maximum
    over the prediction zeroed outside it.  (B, H, W, 2) bool."""
    pred = _mask_hw(pred, h_valid, w_valid)
    hv = h_valid.reshape(-1, 1, 1, 1)
    wv = w_valid.reshape(-1, 1, 1, 1)
    rows = torch.arange(pred.shape[1], device=pred.device).reshape(
        1, -1, 1, 1)
    cols = torch.arange(pred.shape[2], device=pred.device).reshape(
        1, 1, -1, 1)
    valid = (rows < hv) & (cols < wv)
    mean = pred.sum(dim=(1, 2), keepdim=True) / (hv * wv).float()
    peak = pred.amax(dim=(1, 2), keepdim=True)
    return ((pred - 0.5 * (mean + peak)) > 1e-6) & valid


def band_tables(bands, h_valid, w_valid):
    """Both channels' components of each paragraph of a launch, by one
    band_ccl launch.  bands (B, H, W, 2) bool; h_valid, w_valid (B,) the
    crops' extents.  Returns (stats (B, 2, max_comp, 7) int32 in
    band_ccl.FIELDS order, n_comp (B, 2) int32).  A channel set over its
    whole valid region has no component, as label_layer's `> mean` leaves
    it."""
    B, H, W, C = bands.shape
    max_comp = MAX_BAND_COMPONENTS
    masks = bands.permute(0, 3, 1, 2).reshape(B * C, H, W)
    stats, n_comp = band_ccl(masks, h_valid.repeat_interleave(C),
                             w_valid.repeat_interleave(C), max_comp)
    stats = stats.reshape(B, C, max_comp, len(FIELDS))
    n_comp = n_comp.reshape(B, C)
    area = (h_valid.to(torch.int64) * w_valid.to(torch.int64))[:, None]
    full = (n_comp == 1) & (stats[:, :, 0, 0].to(torch.int64) == area)
    return (torch.where(full[..., None, None], 0, stats),
            torch.where(full, 0, n_comp))


def pack_tables(stats, n_comp):
    """The tables of a launch as ONE (B, 2 * (M * 7 + 1)) int32 tensor."""
    B = stats.shape[0]
    return torch.cat([stats.reshape(B, -1), n_comp.reshape(B, -1)], dim=1)


def unpack_tables(buf):
    """Host inverse of pack_tables: (stats (B, 2, M, 7), n_comp (B, 2))."""
    buf = np.asarray(buf)
    B = buf.shape[0]
    n = buf.shape[1] - 2
    return (buf[:, :n].reshape(B, 2, -1, len(FIELDS)),
            buf[:, n:n + 2].reshape(B, 2))


def table_components(stats, n_comp):
    """One channel's table rows on the host -> (boxes, centres) as
    interpreter.layer_components gives them: (slice y, slice x) boxes and
    (n, 2) float64 centres, each the integer sums over the count."""
    rows = np.asarray(stats[:int(n_comp)], np.int64)
    boxes = [(slice(int(r[3]), int(r[4])), slice(int(r[5]), int(r[6])))
             for r in rows]
    return boxes, rows[:, 1:3] / rows[:, :1]
