"""Band tables: the device cascade's tables mode (univer_ocr_tpu/models/
device_cascade.py with `exact_bands=False`).

The parity mode pulls each paragraph's thresholded band masks and plans
its lines on the host with scipy CCL.  The tables mode computes the same
per-blob geometry on the device and sends home one small payload per
paragraph launch (`pack_tables_payload`):

  * text-line bands are horizontal stripes (vertical ones in rotated
    paragraphs), so a blob is a run of occupied rows (columns): the blob
    tables are sums, minima and maxima of per-row statistics, taken per
    column group (`_group_stats_both`, `_blob_tables_from_row_stats`);
  * residual tilt is sheared away per column group before the runs are
    cut (`_best_shear_from_prof`, `_shear_rows`), and the crops are
    sheared the same way, so the line bboxes index them directly;
  * paragraphs whose runs provably merged lines (`_suspect_from_prof`)
    are re-planned on the device by 8-connected components of their folded
    column-group profile (`grid_ccl_tables`), in the host escalation
    planner's coordinates.

The JAX package builds its shifts from log2 static-slice selects and its
segment sums from one-hot products, because gathers are slow on a TPU;
here each shift is one `torch.gather` and each segment sum an integer
`scatter_add_`/`scatter_reduce_`, which are exact in any order (the
one-hot products would run on TF32 inside `backend_flags('bf16')`).  The
values are the JAX package's: integer fields are equal, and every float
field is one float32 division or product chain done in the same order.

`grid_ccl_labels` iterates to a fixed point, which eager PyTorch can only
test with a host sync: it runs its sweeps in blocks of GRID_CCL_BLOCK and
tests once per block (sweeps after convergence change nothing, and the
cap is a multiple of the block, so labels and the `converged` flag are
the JAX package's).  The callers pass a `syncs` Counter that counts
these syncs; every constant the device needs is made on the device or
copied there once per extent (a copy from pageable host memory waits
for the stream).
"""

import functools
import math

import numpy as np
import torch

#: blob-table capacity per (paragraph, channel, axis)
MAX_BAND_BLOBS = 48
#: 1D closing radius on the occupancy vector: fills <= 2-row gaps
CLOSE_RADIUS = 1
#: row OR-fold factor of the escalation profile in the payload
PROFILE_ROW_DS = 2
#: candidate slope grid of the shear sweep (odd, so 0.0 is on it)
SHEAR_CANDIDATES = 27
#: largest |slope| swept (4.6 degrees of residual tilt)
MAX_SHEAR = 0.08
#: column groups of the scoring profile and of the shear
SHEAR_GROUPS = 64
#: a column-group run must span this many rows to count as a suspect
MERGE_MIN_ROWS = 3
#: label of unoccupied grid cells (above any linear cell index)
_CCL_BIG = 2 ** 30
#: sweep cap of grid_ccl_labels; hitting it reports converged=False
GRID_CCL_MAX_ITERS = 128
#: sweeps between two convergence tests (GRID_CCL_MAX_ITERS is a multiple)
GRID_CCL_BLOCK = 8
#: segment-key stride of _seg_cummin (above any label difference)
_SEG_STRIDE = 2 ** 31


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _pad_dim(t, dim, before, after, value):
    """Pad `t` along `dim` with `value` (any dtype, bool included)."""
    shape = list(t.shape)
    shape[dim] += before + after
    out = t.new_full(shape, value)
    out.narrow(dim, before, t.shape[dim]).copy_(t)
    return out


def _cumsum1(t):
    """int64 cumsum along dim 1 of a (B, N, C) tensor, scanned along a
    contiguous axis (a scan across a strided axis of few columns runs on
    a few threads)."""
    return torch.cumsum(t.transpose(1, 2).to(torch.int64).contiguous(),
                        dim=2).transpose(1, 2)


def _shift(t, s, fill, dim=1):
    """out[i] = t[i + s] along `dim`, `fill` outside."""
    if s == 0:
        return t
    n = t.shape[dim]
    if s > 0:
        return _pad_dim(t.narrow(dim, s, n - s), dim, 0, s, fill)
    return _pad_dim(t.narrow(dim, 0, n + s), dim, -s, 0, fill)


def _packbits(bits):
    """np.packbits over the last axis (big-endian bit order) of a bool
    tensor whose last axis is a multiple of 8."""
    weights = 2 ** torch.arange(7, -1, -1, dtype=torch.int32,
                                device=bits.device)
    grouped = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // 8, 8))
    return (grouped.to(torch.int32) * weights).sum(-1).to(torch.uint8)


def _swap_yx(tbl):
    """Column-axis table fields (dim 2: count, y0, y1, x0, x1, cy, cx)
    back in image coordinates, y and x swapped: slices, where an index
    list would be copied to the device from pageable memory."""
    f = [tbl.narrow(2, i, n) for i, n in ((0, 1), (3, 2), (1, 2), (6, 1),
                                         (5, 1))]
    return torch.cat(f, dim=2)


def _segment(values, slot, n_slots, init, reduce):
    """Per-slot reduction along dim 1: values and slot (B, N, C) ->
    (B, n_slots, C) int64; slot == n_slots collects what is dropped."""
    B, _, C = slot.shape
    out = torch.full((B, n_slots + 1, C), init, dtype=torch.int64,
                     device=slot.device)
    values = values.to(torch.int64).expand(slot.shape)
    if reduce == 'sum':
        out.scatter_add_(1, slot, values)
    else:
        out.scatter_reduce_(1, slot, values, reduce, include_self=True)
    return out[:, :n_slots]


# ---------------------------------------------------------------------------
# Residual-tilt (shear) correction
# ---------------------------------------------------------------------------


def _shear_span(extent):
    """Max |integer row shift| a MAX_SHEAR tilt produces over `extent`
    columns (measured from the centre column)."""
    return int(math.ceil(MAX_SHEAR * (extent - 1) / 2.0)) + 1


def _shear_candidates():
    return np.linspace(-MAX_SHEAR, MAX_SHEAR, SHEAR_CANDIDATES)


def _group_centers(W):
    """Column-group partition of the scoring profile: G groups of
    ceil(W/G) columns; returns (G, group width, centre offsets)."""
    G = SHEAR_GROUPS
    gw = -(-W // G)
    centers = (np.arange(G) * gw + (gw - 1) / 2.0) - (W - 1) / 2.0
    return G, gw, centers


@functools.lru_cache(maxsize=None)
def _shear_consts(W, device):
    """The shear constants of a run-axis extent W, copied to `device` once:
    (slopes (K,) float32; the sweep's row shifts plus the shear span
    (K, G) int64, rounded in float64 as in the JAX package; the score's
    |slope| penalty (K,) float32; the group centres (G,) float32)."""
    S = _shear_span(W)
    _, _, centers = _group_centers(W)
    slopes = _shear_candidates()
    shifts = np.clip(np.round(slopes[:, None] * centers[None, :]), -S, S)
    return (torch.as_tensor(slopes, dtype=torch.float32, device=device),
            torch.as_tensor(shifts + S, dtype=torch.int64, device=device),
            torch.as_tensor(1e-3 * np.abs(slopes) / MAX_SHEAR,
                            dtype=torch.float32, device=device),
            torch.as_tensor(centers, dtype=torch.float32, device=device))


def _best_shear_from_prof(prof, W):
    """Per-paragraph residual tilt from the (B, L, G) column-group
    occupancy of a view whose run-axis extent is W: the candidate slope
    with the fewest occupied sheared rows; ties go to the smaller
    |slope|.  Returns (B,) float32."""
    B, L, G = prof.shape
    dev = prof.device
    S = _shear_span(W)
    slopes, shifts, penalty, _ = _shear_consts(W, dev)
    # occ[b, k, r, g] = profp[b, r + shifts[k, g] + S, g] over the whole
    # sheared range [-S, L + S), so content shifted past the window
    # still counts as occupied
    R = L + 2 * S
    profp = _pad_dim(prof, 1, 2 * S, 2 * S, False)
    rows = (torch.arange(R, device=dev).reshape(1, R, 1)
            + shifts[:, None, :])                                # (K, R, G)
    occ = profp[:, rows, torch.arange(G, device=dev)]            # (B,K,R,G)
    score = occ.any(dim=3).sum(dim=2).to(torch.float32) + penalty
    return slopes[torch.argmin(score, dim=1)]


def _group_shifts(s, W):
    """Per-column-group integer shifts d[b, g] = clip(round(s_b *
    centre_g), -S, S), rounded in float32 on the device (half to even):
    the shifts _best_shear_from_prof scores with."""
    S = _shear_span(W)
    c = _shear_consts(W, s.device)[3]
    return torch.clamp(torch.round(s[:, None] * c[None, :]),
                       -S, S).to(torch.int64)                    # (B, G)


def _log_shift_rows(padded, v, H):
    """out[b, r, q, ...] = padded[b, r + v[b, q], q, ...] for r < H: one
    gather.  Reads past the end repeat the last row (callers pad with
    their fill value)."""
    B, Lp, Q = padded.shape[:3]
    idx = torch.clamp(torch.arange(H, device=padded.device).reshape(1, H, 1)
                      + v[:, None, :], max=Lp - 1)               # (B, H, Q)
    trail = padded.shape[3:]
    idx = idx.reshape(idx.shape + (1,) * len(trail)).expand(
        (B, H, Q) + trail)
    return torch.gather(padded, 1, idx)


def _margin(s, extent):
    """The shear margin: tilted paragraphs (s != 0) are shifted down by
    the shear span, so rows sheared upward stay in frame."""
    return torch.where(s != 0.0, _shear_span(extent), 0)


def _shear_rows(arr, s, off):
    """Integer row shear of (B, H, W, C) masks or crops: out[b, r, x] =
    arr[b, r - t, x] with t = off_b - d[b, g(x)], zero outside.  `off`
    (B,) in [0, _shear_span(W)] shifts content down so rows sheared
    upward stay in frame."""
    B, H, W, C = arr.shape
    S = _shear_span(W)
    _, gw, _ = _group_centers(W)
    v = 2 * S - off[:, None].to(torch.int64) + _group_shifts(s, W)
    vx = v[:, :, None].expand(B, v.shape[1], gw).reshape(B, -1)[:, :W]
    padded = _pad_dim(arr, 1, 2 * S, S, 0)
    return _log_shift_rows(padded, vx, H)


# ---------------------------------------------------------------------------
# Row statistics and blob tables
# ---------------------------------------------------------------------------


def _close_runs(occ, radius):
    """1D morphological closing along dim 1 of a bool occupancy tensor:
    dilation, then erosion, window 2*radius+1; the padding is each
    reduction's identity."""
    if not radius:
        return occ
    dil = occ
    for s in range(-radius, radius + 1):
        dil = dil | _shift(occ, s, False)
    ero = dil
    for s in range(-radius, radius + 1):
        ero = ero & _shift(dil, s, True)
    return ero


def _blob_tables_from_row_stats(cnt_r, sumx_r, minx_r, maxx_r, W,
                                close_radius, max_blobs):
    """Blob tables from per-row integer statistics (B, H, C): count, sum
    of occupied column indices, min/max occupied column (W / -1 on empty
    rows).  A blob is a run of closed rows; its count and sums are
    segment sums, its bbox the segment extremes over occupied rows.
    Returns (table (B, max_blobs, 7, C) float32 of [count, y0, y1, x0,
    x1, cy, cx], n_blobs (B, C))."""
    B, H, C = cnt_r.shape
    dev = cnt_r.device
    occ = cnt_r > 0
    closed = _close_runs(occ, close_radius)
    starts = closed & ~_shift(closed, -1, False)
    ids = _cumsum1(starts) - 1
    n_blobs = torch.where(closed, ids, -1).amax(dim=1) + 1        # (B, C)

    M = max_blobs
    rows = torch.arange(H, device=dev).reshape(1, H, 1)
    slot = torch.where(closed & (ids < M), ids, M)
    cnt_b = _segment(cnt_r, slot, M, 0, 'sum')
    sumx_b = _segment(sumx_r, slot, M, 0, 'sum')
    sumy_b = _segment(cnt_r.to(torch.int64) * rows, slot, M, 0, 'sum')
    # the bbox spans occupied rows only (closing's filler rows are empty)
    filled = torch.where(occ, slot, M)
    y0 = _segment(rows, filled, M, H, 'amin')
    y1 = _segment(rows, filled, M, -1, 'amax') + 1
    x0 = _segment(minx_r, filled, M, W, 'amin')
    x1 = _segment(maxx_r, filled, M, -1, 'amax') + 1

    cnt_f = cnt_b.to(torch.float32)
    denom = torch.clamp(cnt_f, min=1.0)
    table = torch.stack([
        cnt_f, y0.to(torch.float32), y1.to(torch.float32),
        x0.to(torch.float32), x1.to(torch.float32),
        sumy_b.to(torch.float32) / denom, sumx_b.to(torch.float32) / denom,
    ], dim=2)                                                     # (B,M,7,C)
    used = torch.arange(M, device=dev).reshape(1, M, 1) < n_blobs[:, None, :]
    return table * used[:, :, None, :].to(torch.float32), n_blobs


def _group_row_stats(bands):
    """Per-(row, column-group) statistics of a (B, H, W, C) bool view:
    (cnt, sumx, minx, maxx), each (B, H, G, C) int32, with x the in-view
    column and W / -1 on empty cells."""
    B, H, W, C = bands.shape
    G, gw, _ = _group_centers(W)
    m = _pad_dim(bands, 2, 0, G * gw - W, False).reshape(B, H, G, gw, C)
    xs = torch.arange(G * gw, dtype=torch.int32,
                      device=bands.device).reshape(1, 1, G, gw, 1)
    i32 = torch.int32
    return (m.sum(dim=3, dtype=i32), (m * xs).sum(dim=3, dtype=i32),
            torch.where(m, xs, W).amin(dim=3),
            torch.where(m, xs, -1).amax(dim=3))


def _group_col_stats(bands):
    """Column-axis twin of _group_row_stats: the row statistics of the
    transposed (B, W, H, C) view."""
    return _group_row_stats(bands.transpose(1, 2))


def _group_stats_both(bands):
    """(_group_row_stats(bands), _group_col_stats(bands))."""
    return _group_row_stats(bands), _group_col_stats(bands)


def _axis_pack(stats, E):
    """One stacking axis's tables from the group statistics of a
    (B, L, E, C) bool view (_group_row_stats): best shear -> sheared
    stats -> blob tables, plus the suspect flag and the closed profile.
    Tilted content is shifted down (right) by the shear span, for rotated
    crops whose content starts at row 0.  Returns (table
    (B, M, 7, C), n_blobs (B, C), shear (B,), suspect (B,), closed
    profile (B, L, G, C))."""
    cnt, sumx, minx, maxx = stats
    L = cnt.shape[1]
    S = _shear_span(E)
    s = _best_shear_from_prof((cnt > 0).any(dim=3), E)
    v = 2 * S - _margin(s, E)[:, None] + _group_shifts(s, E)      # (B, G)

    def shear(stat, fill):
        return _log_shift_rows(_pad_dim(stat, 1, 2 * S, S, fill), v, L)

    cnt_s = shear(cnt, 0)
    tbl, n = _blob_tables_from_row_stats(
        cnt_s.sum(dim=2), shear(sumx, 0).sum(dim=2),
        shear(minx, E).amin(dim=2), shear(maxx, -1).amax(dim=2),
        E, CLOSE_RADIUS, MAX_BAND_BLOBS)
    suspect, profc = _suspect_from_prof(cnt_s > 0)
    return tbl, n, s, suspect, profc


# ---------------------------------------------------------------------------
# Axis choice and merge suspects
# ---------------------------------------------------------------------------


def _interval_overlap_score(tbl, lo, hi):
    """Sum of the positive top/bottom blob interval overlaps of one axis
    table (B, M, 7, 2) on fields [lo, hi)."""
    t_lo, t_hi = tbl[:, :, lo, 0], tbl[:, :, hi, 0]
    b_lo, b_hi = tbl[:, :, lo, 1], tbl[:, :, hi, 1]
    ov = (torch.minimum(t_hi[:, :, None], b_hi[:, None, :])
          - torch.maximum(t_lo[:, :, None], b_lo[:, None, :]))
    return torch.clamp(ov, min=0.0).sum(dim=(1, 2))


def choose_stacking_axis(tables, n_blobs):
    """Per-paragraph stacking axis: the one with the smaller top/bottom
    interval overlap, ties to rows.  tables (B, 2, M, 7, C) -> (B,)."""
    del n_blobs  # unused slots are zero and overlap nothing
    return (_interval_overlap_score(tables[:, 0], 1, 2)
            > _interval_overlap_score(tables[:, 1], 3, 4)).to(torch.int64)


def _suspect_from_prof(prof):
    """Merge-suspect flags from a (B, H, G, C) column-group occupancy
    profile of bands sheared for the axis under test: the row-run
    decomposition provably merged lines when some column group's closed
    occupancy has more tall (>= MERGE_MIN_ROWS) runs than the closed row
    profile.  Returns (flags (B,), closed profile (B, H, G, C))."""
    B, H, G, C = prof.shape
    profc = _close_runs(prof.reshape(B, H, G * C),
                        CLOSE_RADIUS).reshape(B, H, G, C)

    def tall_runs(occ):
        # a run's first row survives the erosion iff the run is tall
        # enough; count the rising edges
        er = occ
        for s in range(1, MERGE_MIN_ROWS):
            er = er & _shift(occ, s, False)
        return (er & ~_shift(er, -1, False)).sum(dim=1)

    local = tall_runs(profc).amax(dim=1)                          # (B, C)
    glob = tall_runs(_close_runs(prof.any(dim=2), CLOSE_RADIUS))  # (B, C)
    return ((local > glob) & (glob > 0)).any(dim=1), profc


# ---------------------------------------------------------------------------
# Grid CCL: suspect paragraphs re-planned on the device
# ---------------------------------------------------------------------------


def _segment_offsets(occ, axis, reverse, dtype):
    """Key offsets of the segmented scans along `axis`: every unoccupied
    cell starts a segment, and each segment's keys sit _SEG_STRIDE above
    the last's (on the flipped axis for a reverse scan)."""
    o = occ.flip(axis) if reverse else occ
    return torch.cumsum((~o).to(dtype), dim=axis) * _SEG_STRIDE


def _seg_cummin(lab, occ, reverse, axis=2, offsets=None):
    """Min-scan of labels along `axis`, restarting at unoccupied cells,
    which must hold _CCL_BIG (each then starts its own segment and keeps
    it): one cummin over the keys lab - offsets keeps segments apart.
    `offsets` takes _segment_offsets' result, made once per grid."""
    if offsets is None:
        offsets = _segment_offsets(occ, axis, reverse, lab.dtype)
    x = lab.flip(axis) if reverse else lab
    v = torch.cummin(x - offsets, dim=axis).values + offsets
    return v.flip(axis) if reverse else v


def grid_ccl_labels(occ, max_iters=None, syncs=None, column_scan=False):
    """8-connected component labels of (B, L, G, C) bool grids: occupied
    cells get their component's smallest linear index y*G+g (scipy's
    component order), unoccupied ones _CCL_BIG.  Returns (labels int64,
    lin (L, G), converged: False iff the sweep cap was hit while labels
    still moved).

    A sweep is the JAX package's: the min over each cell's 3x3
    neighbourhood (a max-pool of the negated labels, padded with -inf as
    JAX pads with _CCL_BIG), then segmented min-scans along the groups,
    both ways, and with column_scan=True along the rows too, both ways
    (a page-sized component then converges in as many sweeps as its
    outline turns, not as it has rows).  Labels run as float64 planes
    (B, C, L, G), exact for these integers.  Sweeps run in blocks of
    GRID_CCL_BLOCK with one host sync per block, counted in `syncs` when
    given: as 'page_ccl_block' with the row scans (the page CCL), else as
    'grid_ccl_block'."""
    cap = GRID_CCL_MAX_ITERS if max_iters is None else max_iters
    B, L, G, C = occ.shape
    dev = occ.device
    lin = (torch.arange(L, device=dev)[:, None] * G
           + torch.arange(G, device=dev)[None, :])
    planes = occ.permute(0, 3, 1, 2)                              # (B,C,L,G)
    big = float(_CCL_BIG)
    lab = torch.where(planes, lin.to(torch.float64), big)
    axes = (3, 2) if column_scan else (3,)
    offsets = {(axis, reverse): _segment_offsets(planes, axis, reverse,
                                                 torch.float64)
               for axis in axes for reverse in (False, True)}

    def sweep(lab):
        m = -torch.nn.functional.max_pool2d(-lab, 3, stride=1, padding=1)
        lab = torch.where(planes, m, big)
        for axis in axes:
            for reverse in (False, True):
                lab = _seg_cummin(lab, planes, reverse, axis,
                                  offsets[axis, reverse])
        return lab

    done, changed = 0, True
    while done < cap and changed:
        for _ in range(min(GRID_CCL_BLOCK, cap - done)):
            prev, lab = lab, sweep(lab)
            done += 1
        if syncs is not None:
            syncs['page_ccl_block' if column_scan else 'grid_ccl_block'] += 1
        changed = bool((lab != prev).any())
    return lab.to(torch.int64).permute(0, 2, 3, 1), lin, not changed


def grid_ccl_tables(prof, view_h, view_w, gw, ds=PROFILE_ROW_DS,
                    max_blobs=MAX_BAND_BLOBS, syncs=None):
    """Blob tables from the 8-connected components of the folded closed
    profile, in the host escalation planner's quantized coordinates
    (rows y*ds .. (y+1)*ds clipped to view_h, groups g*gw .. (g+1)*gw
    clipped to view_w, centres mean*step + (step-1)/2).

    prof (B, L, G, C) bool; view_h, view_w, gw (B,) per paragraph.
    Returns (table (B, M, 7, C) float32 in view coordinates, n_blobs
    (B, C), which may exceed M, converged).  `syncs`: grid_ccl_labels'."""
    B, L, G, C = prof.shape
    dev = prof.device
    M = max_blobs
    # the host planner's grid stops at row ceil(view_h / ds)
    rows_ok = (torch.arange(L, device=dev)[None, :] * ds
               < view_h.reshape(B, 1).to(torch.int64))
    lab, lin, converged = grid_ccl_labels(prof & rows_ok[:, :, None, None],
                                          syncs=syncs)

    flat = lab.reshape(B, L * G, C)
    linf = lin.reshape(1, L * G, 1)
    is_root = flat == linf
    n_blobs = is_root.sum(dim=1)                                  # (B, C)
    # a cell's slot is its root's rank among the roots in raster order
    at = torch.where(flat < _CCL_BIG, flat, 0)
    rank = _cumsum1(is_root) - 1
    member = (flat < _CCL_BIG) & torch.gather(is_root, 1, at)
    slot = torch.gather(rank, 1, at)
    slot = torch.where(member & (slot < M), slot, M)
    ys, gs = linf // G, linf % G
    cnt = _segment(torch.ones_like(ys), slot, M, 0, 'sum')
    sy = _segment(ys, slot, M, 0, 'sum')
    sg = _segment(gs, slot, M, 0, 'sum')
    y0 = _segment(ys, slot, M, L, 'amin')
    y1 = _segment(ys, slot, M, -1, 'amax')
    g0 = _segment(gs, slot, M, G, 'amin')
    g1 = _segment(gs, slot, M, -1, 'amax')

    f32 = torch.float32
    dsf = float(ds)
    view_h = view_h.reshape(B, 1, 1).to(torch.int64)
    view_w = view_w.reshape(B, 1, 1).to(torch.int64)
    gw3 = gw.reshape(B, 1, 1).to(torch.int64)
    gwf = gw3.to(f32)
    cnt_f = cnt.to(f32)
    denom = torch.clamp(cnt_f, min=1.0)
    y0v = (y0 * ds).to(f32)
    y1v = torch.minimum((y1 + 1) * ds, view_h).to(f32)
    x0v = (g0 * gw3).to(f32)
    x1v = torch.minimum((g1 + 1) * gw3, view_w).to(f32)
    cy = sy.to(f32) / denom * dsf + (dsf - 1.0) / 2.0
    cx = sg.to(f32) / denom * gwf + (gwf - 1.0) / 2.0
    used = (cnt_f > 0).to(f32)[:, :, None, :]
    table = torch.stack([cnt_f, y0v, y1v, x0v, x1v, cy, cx], dim=2) * used
    return table, n_blobs, converged


# ---------------------------------------------------------------------------
# The tables state and its payload
# ---------------------------------------------------------------------------


def tables_state(bands, crops, syncs=None):
    """Tables-mode core of the paragraph stage: both-axis blob tables,
    suspect flags and the folded escalation profile, and the crops
    sheared by the chosen axis's residual tilt, with the shear margin
    (_margin; the JAX package's margin=True, which its paragraph stages
    pass).  bands (B, H, W, C) bool, crops (B, H, W, 1).  Returns (crops,
    tbl, n_blobs, shears, axis, suspect, packed_prof).

    Merge-suspect paragraphs are re-planned on the device
    (grid_ccl_tables over the folded profile): their chosen axis's tables
    are replaced and their flag cleared; suspects whose components
    overflow the table or whose labels did not converge keep the flag.
    One host sync reads whether the launch holds a suspect at all (the
    grid CCL runs only then, and changes nothing otherwise), counted in
    `syncs['suspect_check']` when given, with grid_ccl_labels' syncs."""
    row_stats, col_stats = _group_stats_both(bands)
    t0, n0, s0, sus0, pr0 = _axis_pack(row_stats, bands.shape[2])
    t1, n1, s1, sus1, pr1 = _axis_pack(col_stats, bands.shape[1])
    tbl = torch.stack([t0, _swap_yx(t1)], dim=1)
    n_blobs = torch.stack([n0, n1], dim=1)
    shears = torch.stack([s0, s1], dim=1)
    axis = choose_stacking_axis(tbl, n_blobs)
    B = crops.shape[0]
    s_row = torch.where(axis == 0, shears[:, 0], 0.0)
    s_col = torch.where(axis == 1, shears[:, 1], 0.0)

    crops = _shear_rows(crops, s_row, _margin(s_row, crops.shape[2]))
    crops_t = crops.transpose(1, 2)
    crops = _shear_rows(crops_t, s_col,
                        _margin(s_col, crops_t.shape[2])).transpose(1, 2)
    suspect = torch.where(axis == 0, sus0, sus1)
    # the escalation profile: the chosen view's closed column-group
    # occupancy, row-OR-folded by PROFILE_ROW_DS and bit-packed
    L = max(pr0.shape[1], pr1.shape[1])
    Ld = -(-L // PROFILE_ROW_DS)

    def fold(p):
        p = _pad_dim(p, 1, 0, Ld * PROFILE_ROW_DS - p.shape[1], False)
        return p.reshape(B, Ld, PROFILE_ROW_DS, -1).any(dim=2)

    prof = torch.where((axis == 0)[:, None, None], fold(pr0), fold(pr1))
    packed_prof = _packbits(prof)

    if syncs is not None:
        syncs['suspect_check'] += 1
    if bool(suspect.any()):
        H, W = bands.shape[1], bands.shape[2]
        ch = axis == 0
        view_h = torch.where(ch, H, W)
        view_w = torch.where(ch, W, H)
        gw_sel = torch.where(ch, _group_centers(W)[1], _group_centers(H)[1])
        prof4 = prof.reshape(B, Ld, -1, bands.shape[3])
        t2, n2, converged = grid_ccl_tables(prof4, view_h, view_w, gw_sel,
                                            syncs=syncs)
        # the column-axis view swaps y and x back to the image's
        t2 = torch.where((~ch)[:, None, None, None], _swap_yx(t2), t2)
        fits = (n2.amax(dim=1) <= t2.shape[1]) & converged
        fix = suspect & fits
        chosen_t = torch.where(ch[:, None, None, None], tbl[:, 0], tbl[:, 1])
        chosen_n = torch.where(ch[:, None], n_blobs[:, 0], n_blobs[:, 1])
        new_t = torch.where(fix[:, None, None, None], t2, chosen_t)
        new_n = torch.where(fix[:, None], n2, chosen_n)
        tbl = torch.stack(
            [torch.where(ch[:, None, None, None], new_t, tbl[:, 0]),
             torch.where(ch[:, None, None, None], tbl[:, 1], new_t)], dim=1)
        n_blobs = torch.stack(
            [torch.where(ch[:, None], new_n, n_blobs[:, 0]),
             torch.where(ch[:, None], n_blobs[:, 1], new_n)], dim=1)
        suspect = suspect & ~fits

    return (crops.contiguous(), tbl, n_blobs, shears, axis, suspect,
            packed_prof)


def _f32_bytes(x, B):
    """(B, ...) numeric -> (B, 4n) uint8: its float32 values as bytes in
    the machine's order (little-endian on the card and its host)."""
    return x.to(torch.float32).reshape(B, -1).contiguous().view(torch.uint8)


def pack_tables_payload(tbl, n_blobs, shears, axis, suspect, profile):
    """The paragraph launch's tables payload as ONE (B, NBYTES) uint8
    tensor: tbl, n_blobs, shears, axis and suspect as float32 bytes
    (integers below 2^24 are exact), then the bit-packed profile."""
    B = tbl.shape[0]
    return torch.cat([_f32_bytes(tbl, B), _f32_bytes(n_blobs, B),
                      _f32_bytes(shears, B), _f32_bytes(axis, B),
                      _f32_bytes(suspect, B), profile.reshape(B, -1)], dim=1)


def unpack_tables_payload(buf, max_blobs=MAX_BAND_BLOBS):
    """Host inverse of pack_tables_payload: (B, NBYTES) uint8 ->
    (tables, n_blobs, shears, axis, suspect, profile) numpy arrays, the
    profile as (B, L, G*C/8) bit-packed rows."""
    buf = np.asarray(buf)
    B = buf.shape[0]

    def f32(n, o):
        return buf[:, o:o + 4 * n].copy().view('<f4'), o + 4 * n

    o = 0
    tbl, o = f32(2 * max_blobs * 7 * 2, o)
    tbl = tbl.reshape(B, 2, max_blobs, 7, 2)
    n_blobs, o = f32(4, o)
    n_blobs = n_blobs.astype(np.int32).reshape(B, 2, 2)
    shears, o = f32(2, o)
    axis, o = f32(1, o)
    axis = axis.astype(np.int32).reshape(B)
    suspect, o = f32(1, o)
    suspect = suspect.astype(bool).reshape(B)
    profile = buf[:, o:].reshape(B, -1, SHEAR_GROUPS * 2 // 8)
    return tbl, n_blobs, shears.reshape(B, 2), axis, suspect, profile
