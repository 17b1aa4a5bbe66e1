"""Fused cascade tail (univer_ocr_tpu/models/fused_tail.py): line
planning, line crops, the Char forward and the run-length decode, all on
the device, after the paragraph stage's tables.

The tables mode pulls each paragraph launch's tables payload, plans the
lines on the host and launches the line stage.  The fused tail keeps
going on the device with the same pairing, orientation, ordering and
merge as the host table planner (`_plan_lines_single`), the gather zoom
of the line crops, the Char forward and a run-length decode
(`decode_ids_device`).  The host pulls one small payload of collapsed
glyph ids per launch and maps them to characters; the tables payload
stays on the device unless a paragraph is flagged suspect (a merge
suspect the grid CCL could not resolve, cross-axis lines, or an overflow
of one of the caps below), and suspects re-plan through the host.

Every step is batched over the launch's paragraphs.  The JAX package
compacts by one-hot matrix products and decodes with a `lax.scan` over
the columns; here each compaction is a `cumsum` and an index scatter
(exact, as the one-hot products in HIGHEST are) and the decode is a
handful of batched scans over the columns (`decode_ids_device`), which
needs the look-alike relation to be an equivalence: the import checks
that it is.

The caps are read at call time, so a test can patch them.
"""

import functools

import numpy as np
import torch

from ..primitives import CHARS, SIMILAR_CHARS_PAIRS_LIST
from .band_tables import pack_tables_payload, tables_state
from .device_cascade import _thresholded_bands, zoomed_line_crops
from .fastpath import char_forward_masked

#: per-paragraph line-slot cap (a generated paragraph holds at most about
#: 15 lines; more marks the paragraph suspect)
MAX_LINES = 20
#: per-launch pool of line crops; overflow marks the paragraphs whose
#: lines did not fit suspect
LINE_POOL = 64
#: Char-stage width of the pooled crops: w * 32 / h tops out near 2048
#: for the widest and shortest real lines
CHAR_POOL_WIDTH = 2048
#: glyph capacity per decoded line (generated lines reach about 100);
#: overflow truncates and flags the line's paragraph
MAX_GLYPHS = 128

#: field order of the (MAX_LINES, 12) line-plan rows
PLAN_FIELDS = ('ratio_y', 'ratio_x', 'w_out', 'a_yy', 'a_yx', 'b_y',
               'a_xy', 'a_xx', 'b_x', 'w_valid', 'out_h', 'out_w')

#: rot90_inverse_affine coefficients by rotation // 90: (a_yy, a_yx,
#: b_y_h, b_y_w, b_y_c, a_xy, a_xx, b_x_h, b_x_w, b_x_c, swap), with
#: b_y = b_y_h*h + b_y_w*w + b_y_c and swap = 1 where (lh, lw) = (w, h)
_ROT_TABLE = np.array([
    [1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0],          # 0:   ys=yr, xs=xr
    [0, 1, 0, 0, 0, -1, 0, 0, 1, -1, 1],        # 90:  ys=xr, xs=w-1-yr
    [-1, 0, 1, 0, -1, 0, -1, 0, 1, -1, 0],      # 180: ys=h-1-yr, xs=w-1-xr
    [0, -1, 1, 0, -1, 1, 0, 0, 0, 0, 1],        # 270: ys=h-1-xr, xs=yr
], np.float32)


def _similar_table(chars=CHARS, pairs=SIMILAR_CHARS_PAIRS_LIST):
    """(n, n) bool: SIM[a, b] iff (a, b) is a registered look-alike pair
    (order-free, as primitives.are_similar)."""
    n = len(chars)
    t = np.zeros((n, n), bool)
    for a, b in pairs:
        ia, ib = chars.index(a), chars.index(b)
        t[ia, ib] = t[ib, ia] = True
    return t


def _look_alike_classes(chars=CHARS, pairs=SIMILAR_CHARS_PAIRS_LIST):
    """(n,) class of each character under "equal or look-alike": the
    smallest index of its class.  Raises ValueError, naming the pairs,
    when the relation has a chain (a~b, b~c, a !~ c): decode_ids_device
    is exact only for an equivalence."""
    rel = _similar_table(chars, pairs) | np.eye(len(chars), dtype=bool)
    two = (rel.astype(np.int64) @ rel.astype(np.int64)) > 0
    bad = np.argwhere(two & ~rel)
    if bad.size:
        a, c = bad[0]
        b = int(np.argmax(rel[a] & rel[:, c]))
        raise ValueError(
            f'look-alike pairs ({chars[a]!r}, {chars[b]!r}) and '
            f'({chars[b]!r}, {chars[c]!r}) chain, but ({chars[a]!r}, '
            f'{chars[c]!r}) is no pair: the device decode needs the '
            f'relation to be an equivalence')
    return rel.argmax(axis=1)


#: checked when the module is imported
_CLASSES = _look_alike_classes()


@functools.lru_cache(maxsize=None)
def _device_tables(device):
    """The look-alike classes and _ROT_TABLE on `device`, copied there
    once (a copy from pageable host memory waits for the stream)."""
    return (torch.as_tensor(_CLASSES, dtype=torch.int64, device=device),
            torch.as_tensor(_ROT_TABLE, device=device))


def _shift_right(t, fill):
    """out[:, j] = t[:, j - 1] along dim 1, `fill` at j = 0."""
    return torch.cat([t.new_full((t.shape[0], 1), fill), t[:, :-1]], dim=1)


def decode_ids_device(ids, valid, min_run):
    """Run-length decode on the device: per-column class ids -> collapsed
    glyph ids, equal to interpreter.pred_ids_to_text(ids, valid, k) for
    an integer k >= 1 (True for k = 1).

    ids (B, W) integer, valid (B, W) bool (invalid columns are skipped:
    runs continue across them).  Returns (glyphs (B, MAX_GLYPHS) int32,
    zero-padded; n_glyphs (B,) int32; overflow (B,) bool: more than
    MAX_GLYPHS glyphs).

    A run emits when it is at least min_run long, is not a tab (0), and
    is neither the last emitted glyph nor its look-alike; a tab run of
    any length clears the memory.  With look-alike classes (an
    equivalence), the last emitted glyph's class is the last candidate
    run's since the last tab, so a candidate emits iff no candidate came
    since the last tab or its class differs from the previous
    candidate's: a few batched scans, whatever the width."""
    G = MAX_GLYPHS
    B, W = ids.shape
    dev = ids.device
    classes = _device_tables(dev)[0]
    cols = torch.arange(W + 1, device=dev)[None, :]
    # the valid columns compacted to the front, -2 past them
    n_valid = valid.sum(dim=1, keepdim=True)
    pos = torch.cumsum(valid, dim=1) - 1
    comp = torch.full((B, W + 1), -2, dtype=torch.int64, device=dev)
    comp.scatter_(1, torch.where(valid, pos, W), ids.to(torch.int64))
    comp = torch.where(cols < n_valid, comp, -2)
    # run starts, and each run's length to the next start (or the end)
    start = (comp != _shift_right(comp, -3)) & (cols < n_valid)
    at = torch.where(start | (cols == n_valid), cols, W + 1)
    after = torch.cat([at[:, 1:], at.new_full((B, 1), W + 1)], dim=1)
    nxt = torch.cummin(after.flip(1), dim=1).values.flip(1)
    cand = start & (nxt - cols >= min_run) & (comp > 0)
    tab = start & (comp == 0)
    # the previous candidate run and the last tab run before each column
    prev_cand = _shift_right(
        torch.cummax(torch.where(cand, cols, -1), dim=1).values, -1)
    last_tab = _shift_right(
        torch.cummax(torch.where(tab, cols, -1), dim=1).values, -1)
    cls = classes[comp.clamp(min=0)]
    prev_cls = torch.gather(cls, 1, prev_cand.clamp(min=0))
    emit = cand & ((prev_cand < last_tab) | (prev_cand < 0)
                   | (cls != prev_cls))
    # the emitted glyphs compacted
    gpos = torch.cumsum(emit, dim=1) - 1
    n = emit.sum(dim=1)
    glyphs = comp.new_zeros((B, G + 1))
    glyphs.scatter_(1, torch.where(emit & (gpos < G), gpos, G),
                    torch.where(emit, comp, 0))
    return (glyphs[:, :G].to(torch.int32),
            torch.clamp(n, max=G).to(torch.int32), n > G)


def glyphs_to_text(glyphs, n_glyphs):
    """Host inverse of decode_ids_device for one line."""
    return ''.join(CHARS[g] for g in np.asarray(glyphs[:int(n_glyphs)]))


# ---------------------------------------------------------------------------
# Device line planning (OCRPipeline._plan_lines_from_tables, batched)
# ---------------------------------------------------------------------------


def _take(t, idx):
    """t[b, idx[b, m], ...] along dim 1 for (B, M) indices."""
    idx = idx.reshape(idx.shape + (1,) * (t.dim() - 2))
    return torch.gather(t, 1, idx.expand(idx.shape[:2] + t.shape[2:]))


def _axis_counts(nb, axis):
    """nb (B, 2, 2) blob counts -> (B, 2) counts of `axis` (B,)."""
    B = nb.shape[0]
    idx = axis.to(torch.int64).reshape(B, 1, 1).expand(B, 1, 2)
    return torch.gather(nb.to(torch.int64), 1, idx)[:, 0]


def _plan_lines_single(tbl, nb, axis, char_h=32, char_min_w=8):
    """Line plans of each paragraph of a launch from its blob tables.

    tbl (B, 2, M, 7, 2) float32, nb (B, 2, 2), axis (B,).  Returns
    (plans (B, MAX_LINES, 12) float32 in PLAN_FIELDS order, n_lines (B,),
    overflow (B,) bool: more lines than MAX_LINES).  The pairing,
    orientation, ordering and merge of OCRPipeline._plan_lines_from_tables
    (the JAX package's per-paragraph function, batched)."""
    B, _, M = tbl.shape[:3]
    L = MAX_LINES
    dev = tbl.device
    big = 1e9
    t = torch.where((axis == 0).reshape(B, 1, 1, 1), tbl[:, 0], tbl[:, 1])
    counts = torch.clamp(_axis_counts(nb, axis), max=M)
    n_top, n_bot = counts[:, 0:1], counts[:, 1:2]
    sl = torch.arange(M, device=dev)
    tv = sl[None, :] < n_top
    bv = sl[None, :] < n_bot
    top, bot = t[..., 0], t[..., 1]                              # (B, M, 7)
    cm_t, cm_b = top[:, :, 5:7], bot[:, :, 5:7]

    diff = cm_t[:, :, None, :] - cm_b[:, None, :, :]
    d = torch.sqrt((diff * diff).sum(dim=3))
    d = torch.where(bv[:, None, :], d, big)
    pick = torch.argmin(d, dim=2)                                 # (B, M)
    bot_p = _take(bot, pick)
    cm_bp = bot_p[:, :, 5:7]

    delta = cm_t[:, 0] - cm_bp[:, 0]
    dy, dx = delta[:, 0], delta[:, 1]
    rot_i = torch.where(
        dy.abs() > dx.abs(), torch.where(dy > 0, 2, 0),
        torch.where(dx > 0, 1, torch.where(dx < 0, 3, 0)))       # rot // 90
    ax_idx = torch.where((rot_i == 0) | (rot_i == 2), 0, 1)
    # the reading order of _ORIENTATION_KEYS: None (cy, +1), 180 (cy, -1),
    # 270 (cx, +1), 90 (cx, -1)
    sign = torch.where((rot_i == 0) | (rot_i == 3), 1.0, -1.0)[:, None]
    ax3 = ax_idx.reshape(B, 1, 1).expand(B, M, 1)
    key_t = torch.where(tv, sign * torch.gather(cm_t, 2, ax3)[..., 0], big)
    key_b = torch.where(tv, sign * torch.gather(cm_bp, 2, ax3)[..., 0], big)
    order_t = torch.argsort(key_t, dim=1, stable=True)
    order_b = torch.argsort(key_b, dim=1, stable=True)
    top_o = _take(top, order_t)
    bot_o = _take(bot_p, order_b)
    picks_o = torch.gather(pick, 1, order_t)

    y0 = torch.minimum(top_o[:, :, 1], bot_o[:, :, 1])
    y1 = torch.maximum(top_o[:, :, 2], bot_o[:, :, 2])
    x0 = torch.minimum(top_o[:, :, 3], bot_o[:, :, 3])
    x1 = torch.maximum(top_o[:, :, 4], bot_o[:, :, 4])

    # rows whose tops picked the same bottom merge: the first keeps the
    # line slot and takes the union of the group
    valid_k = torch.gather(tv, 1, order_t)
    same = ((picks_o[:, None, :] == picks_o[:, :, None])
            & valid_k[:, None, :])                                # (B, M, M)
    gy0 = torch.where(same, y0[:, None, :], big).amin(dim=2)
    gy1 = torch.where(same, y1[:, None, :], -big).amax(dim=2)
    gx0 = torch.where(same, x0[:, None, :], big).amin(dim=2)
    gx1 = torch.where(same, x1[:, None, :], -big).amax(dim=2)
    earlier = same & (sl[None, None, :] < sl[None, :, None])
    line_mask = (~earlier.any(dim=2) & valid_k & (n_top > 0)
                 & (n_bot > 0))

    h_l = torch.floor(gy1) - torch.floor(gy0)
    w_l = torch.floor(gx1) - torch.floor(gx0)
    coef = _device_tables(dev)[1][rot_i][:, None, :]              # (B, 1, 11)
    swap = coef[..., 10] > 0
    lh = torch.clamp(torch.where(swap, w_l, h_l), min=1.0)
    lw = torch.clamp(torch.where(swap, h_l, w_l), min=1.0)
    zf = char_h / lh
    w_out = torch.round(lw * zf)
    # the reciprocal product XLA makes of a division by a constant, which
    # the JAX package's compiled program runs
    ratio_y = (lh - 1.0) * (1.0 / (char_h - 1.0)) if char_h > 1 else lh * 0.0
    ratio_x = torch.where(w_out > 1, (lw - 1.0) / (w_out - 1.0), 0.0)
    b_y = (coef[..., 2] * h_l + coef[..., 3] * w_l + coef[..., 4]
           + torch.floor(gy0))
    b_x = (coef[..., 7] * h_l + coef[..., 8] * w_l + coef[..., 9]
           + torch.floor(gx0))
    w_valid = torch.clamp(w_out, min=float(char_min_w))

    def const(i):
        return coef[..., i].expand(B, M)

    plans = torch.stack([
        ratio_y, ratio_x, w_out, const(0), const(1), b_y, const(5),
        const(6), b_x, w_valid, torch.full_like(w_out, float(char_h)),
        w_out], dim=2)                                            # (B, M, 12)

    # compact the line slots to MAX_LINES, in order
    idx = torch.cumsum(line_mask, dim=1) - 1
    n_lines = line_mask.sum(dim=1)
    out = plans.new_zeros((B, L + 1, len(PLAN_FIELDS)))
    out.scatter_(1, _slot(idx, line_mask, L)[..., None].expand(B, M, 12),
                 plans)
    return out[:, :L], torch.clamp(n_lines, max=L), n_lines > L


def _slot(idx, keep, n):
    """Compaction target: idx where kept and below n, else the dump n."""
    return torch.where(keep & (idx < n), idx, n)


def _cross_axis_single(tbl, nb, axis):
    """OCRPipeline._cross_axis_escalation of each paragraph of a launch:
    True where the axis not chosen resolves more blobs than the chosen
    one and some gap between them exceeds 0.8 of the smaller
    neighbour's extent across it.  tbl (B, 2, M, 7, 2), nb (B, 2, 2),
    axis (B,) -> (B,) bool."""
    B, _, M = tbl.shape[:3]
    dev = tbl.device
    big = 1e9
    other = 1 - axis.to(torch.int64)
    t_all = torch.where((other == 0).reshape(B, 1, 1, 1), tbl[:, 0],
                        tbl[:, 1])                                # (B, M, 7, 2)
    # the run-interval fields of `other`, and the cross-extent fields
    lo = torch.where(other == 0, 1, 3).reshape(B, 1, 1).expand(B, M, 1)
    clo = torch.where(other == 0, 3, 1).reshape(B, 1, 1).expand(B, M, 1)
    n_o = torch.clamp(_axis_counts(nb, other), max=M)
    n_c = torch.clamp(_axis_counts(nb, axis), max=M)
    sl = torch.arange(M, device=dev)
    fires = []
    for ch in range(tbl.shape[4]):
        t = t_all[..., ch]                                        # (B, M, 7)
        v = sl[None, :] < n_o[:, ch:ch + 1]
        starts = torch.where(v, torch.gather(t, 2, lo)[..., 0], big)
        order = torch.argsort(starts, dim=1, stable=True)
        ts = _take(t, order)
        vs = torch.gather(v, 1, order)
        ivs0 = torch.gather(ts, 2, lo)[..., 0]
        ivs1 = torch.gather(ts, 2, lo + 1)[..., 0]
        gaps = ivs0[:, 1:] - ivs1[:, :-1]
        heights = (torch.gather(ts, 2, clo + 1)
                   - torch.gather(ts, 2, clo))[..., 0]
        hmin = torch.minimum(heights[:, 1:], heights[:, :-1])
        fire = (vs[:, 1:] & vs[:, :-1] & (gaps > 0.8 * hmin)).any(dim=1)
        fires.append((n_o[:, ch] > torch.clamp(n_c[:, ch], min=1)) & fire)
    return fires[0] | fires[1]


# ---------------------------------------------------------------------------
# The fused tail: paragraph bands -> line crops -> Char -> glyphs
# ---------------------------------------------------------------------------


def fused_paragraph_tail(params, crops, h_valid, w_valid, precision=None,
                         min_run=4, char_head='xla', syncs=None):
    """Everything after the paragraph crop of one launch.

    crops (B, HB, WB, 1) float32 paragraph crops; h_valid, w_valid (B,).
    `char_head` as char_forward_masked's; `syncs` counts tables_state's
    host syncs.  Returns (the sheared crops, the small payload (NBYTES,)
    uint8 of glyph ids and line bookkeeping, unpacked by
    unpack_fused_payload, and the tables payload (B, NB) uint8 of
    pack_tables_payload, with every flagged paragraph suspect).

    The caps never lose text silently: a paragraph whose lines overflow
    MAX_LINES, the launch's LINE_POOL, CHAR_POOL_WIDTH or MAX_GLYPHS is
    flagged, and flagged paragraphs re-plan on the host from the tables
    payload (OCRPipeline._finish_dispatch)."""
    B = crops.shape[0]
    dev = crops.device
    bands = _thresholded_bands(params, crops, h_valid, w_valid,
                               precision=precision)
    (crops, tbl, n_blobs, shears, axis, suspect,
     packed_prof) = tables_state(bands, crops, syncs=syncs)

    plans, n_lines, over_lines = _plan_lines_single(tbl, n_blobs, axis)
    over_tbl = n_blobs.amax(dim=(1, 2)) > tbl.shape[2]

    # the launch's line pool: the (B, MAX_LINES) slots compacted in order
    L, P = MAX_LINES, LINE_POOL
    line_valid = (torch.arange(L, device=dev)[None, :]
                  < n_lines[:, None]).reshape(-1)
    pos = torch.cumsum(line_valid, dim=0) - 1                     # (B*L,)
    over_pool = (line_valid & (pos >= P)).reshape(B, L).any(dim=1)
    slot = _slot(pos, line_valid, P)
    pooled = plans.new_zeros((P + 1, len(PLAN_FIELDS))).scatter_(
        0, slot[:, None].expand(B * L, len(PLAN_FIELDS)),
        plans.reshape(B * L, -1))[:P]
    para_of = slot.new_zeros(P + 1).scatter_(
        0, slot, torch.arange(B * L, device=dev) // L)[:P]
    pool_used = torch.arange(P, device=dev) < line_valid.sum()
    para_idx = torch.where(pool_used, para_of, 0)

    def fld(name):
        return pooled[:, PLAN_FIELDS.index(name)]

    def per_paragraph(flags):
        """Any of the pool slots' flags, per owning paragraph."""
        return torch.zeros(B, dtype=torch.int64, device=dev).scatter_reduce(
            0, para_idx, (flags & pool_used).to(torch.int64), 'amax') > 0

    w_out = fld('w_out')
    over_trunc = per_paragraph(w_out > CHAR_POOL_WIDTH)
    w_out_c = torch.clamp(w_out, max=CHAR_POOL_WIDTH).to(torch.int64)
    w_val = torch.clamp(fld('w_valid'), max=CHAR_POOL_WIDTH).to(torch.int64)

    def ints(name):
        return fld(name).to(torch.int64)

    lines = zoomed_line_crops(
        crops, para_idx, fld('ratio_y'), fld('ratio_x'), w_out_c,
        ints('a_yy'), ints('a_yx'), ints('b_y'), ints('a_xy'),
        ints('a_xx'), ints('b_x'), 32, CHAR_POOL_WIDTH)
    logits = char_forward_masked(params, lines, w_val, precision=precision,
                                 head=char_head)
    ids = logits.argmax(dim=-1)
    cols = torch.arange(logits.shape[1], device=dev)[None, :]
    valid = (cols < w_val[:, None]) & pool_used[:, None]
    glyphs, n_glyphs, over_gl = decode_ids_device(ids, valid, min_run)
    over_glyph = per_paragraph(over_gl)

    cross = _cross_axis_single(tbl, n_blobs, axis)
    # the suspect byte is a bitmask of the reasons (nonzero: escalate);
    # the host counts each bit in escalation_stats
    bits = (suspect, cross, over_tbl, over_lines, over_pool, over_trunc,
            over_glyph)
    suspect_mask = sum(b.to(torch.uint8) << i for i, b in enumerate(bits))
    small = torch.cat([
        torch.clamp(glyphs, 0, 255).to(torch.uint8).reshape(-1),
        n_glyphs.to(torch.uint8),
        torch.where(pool_used, para_idx, 255).to(torch.uint8),
        n_lines.to(torch.uint8),
        suspect_mask.to(torch.uint8),
    ])
    tables_payload = pack_tables_payload(tbl, n_blobs, shears, axis,
                                         suspect_mask > 0, packed_prof)
    return crops, small, tables_payload


def fused_payload_nbytes(launch_batch):
    """Length of fused_paragraph_tail's small payload for a launch of
    `launch_batch` paragraph slots."""
    return LINE_POOL * MAX_GLYPHS + 2 * LINE_POOL + 2 * launch_batch


def unpack_fused_payload(buf, n_paragraphs, n_shards=1):
    """Host inverse of fused_paragraph_tail's small payload.

    Returns (texts: [n_paragraphs][lines in reading order] str, suspect
    (n_paragraphs,) uint8 bitmask: nonzero means escalate; bits
    merge_suspect, cross_axis, table overflow, line-slot overflow, pool
    overflow, width truncation, glyph overflow).  The launch batch comes
    from the buffer's length.

    Under a mesh each of `n_shards` data shards runs the tail on its share
    of the launch batch with its own line pool, and the payload is the
    shards' segments end to end: each segment is unpacked with its share
    (its slot count read from its layout) and the texts and suspects are
    stitched back in batch order."""
    buf = np.asarray(buf)
    if n_shards > 1:
        segments = np.split(buf, n_shards)
        b_local = (segments[0].shape[0] - LINE_POOL * MAX_GLYPHS
                   - 2 * LINE_POOL) // 2
        texts, suspects = [], [np.zeros(0, np.uint8)]
        for s, segment in enumerate(segments):
            n_s = min(max(n_paragraphs - s * b_local, 0), b_local)
            if n_s == 0:
                break
            t, su = unpack_fused_payload(segment, n_s)
            texts.extend(t)
            suspects.append(su)
        return texts, np.concatenate(suspects)
    P, G = LINE_POOL, MAX_GLYPHS
    # the device wrote n_lines and suspect for its whole batch, fillers
    # included; the real paragraphs come first
    b_dev = (buf.shape[0] - P * G - 2 * P) // 2
    o = 0
    glyphs = buf[o:o + P * G].reshape(P, G)
    o += P * G
    n_glyphs = buf[o:o + P]
    o += P
    para_of = buf[o:o + P]
    o += P + b_dev                                 # past n_lines
    suspect = buf[o:o + n_paragraphs]
    # pool slots were assigned in (paragraph, line) order, so each
    # paragraph's lines come in reading order
    texts = [[] for _ in range(n_paragraphs)]
    for p in range(P):
        b = int(para_of[p])
        if b < n_paragraphs:
            texts[b].append(glyphs_to_text(glyphs[p], int(n_glyphs[p])))
    return texts, suspect
