"""Fused cascade tail (univer_ocr_tpu/models/fused_tail.py): line
planning, line crops, the Char forward and the run-length decode, all on
the device, after the paragraph stage's crops and band masks.

The band components of every paragraph of a launch come from one
`band_ccl` launch (band_tables.band_tables).  The tail pairs them into
lines as the host cascade's interpreter.pair_lines pairs them
(`_plan_lines_single`: each top takes the bottom nearest by centre, the
first pair gives the orientation, both channels are sorted in reading
order and zipped, each line the union box of its pair), crops and zooms
the lines as extract_line does (device_cascade.zoomed_line_crops), runs
the Char forward on them in uint8 steps and decodes the ids with the
run-length rule (`decode_ids_device`).  The host pulls one small payload
of collapsed glyph ids per launch and maps them to characters.  A
paragraph that overflows one of the caps below is flagged.  The lines of
a flagged paragraph are relaunched through the pipeline's line stage on
the device from the tail's own line plans, which the host pulls only for
a launch with a flagged paragraph; only a paragraph whose band table
overflowed is planned on the host, from its band masks.

The JAX package's fused tail plans from row statistics of sheared bands
and merges the lines whose tops picked the same bottom; both lose lines
that the host cascade reads, so the port pairs as the host does.

Every step is batched over the launch's paragraphs.  Each compaction is a
`cumsum` and an index scatter and the decode is a handful of batched
scans over the columns (`decode_ids_device`), which needs the look-alike
relation to be an equivalence: the import checks that it is.

The caps are read at call time, so a test can patch them.
"""

import contextlib
import functools

import numpy as np
import torch

from ..primitives import CHARS, SIMILAR_CHARS_PAIRS_LIST
from .band_tables import band_tables
from .device_cascade import to_u8_steps, zoomed_line_crops
from .fastpath import char_forward_masked

#: per-launch pool of line crops; overflow flags the paragraphs whose
#: lines did not fit
LINE_POOL = 64
#: Char-stage width of the pooled crops: w * 32 / h tops out near 2048
#: for the widest and shortest real lines
CHAR_POOL_WIDTH = 2048
#: glyph capacity per decoded line (generated lines reach about 100);
#: overflow truncates and flags the line's paragraph
MAX_GLYPHS = 128

#: field order of the (M, 10) line-plan rows: the line stage's LINE_FIELDS
#: but the paragraph index
PLAN_FIELDS = ('lh', 'lw', 'w_out', 'a_yy', 'a_yx', 'b_y', 'a_xy', 'a_xx',
               'b_x', 'w_valid')
#: the fused payload's flags of a paragraph, bit by bit: its band table
#: overflowed, its lines the launch's LINE_POOL, a line's width
#: CHAR_POOL_WIDTH, a line's glyphs MAX_GLYPHS
FLAG_BITS = ('table_of', 'pool_of', 'trunc_of', 'glyph_of')

#: rot90_inverse_affine coefficients by rotation // 90: (a_yy, a_yx,
#: b_y_h, b_y_w, b_y_c, a_xy, a_xx, b_x_h, b_x_w, b_x_c, swap), with
#: b_y = b_y_h*h + b_y_w*w + b_y_c and swap = 1 where (lh, lw) = (w, h)
_ROT_TABLE = np.array([
    [1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0],          # 0:   ys=yr, xs=xr
    [0, 1, 0, 0, 0, -1, 0, 0, 1, -1, 1],        # 90:  ys=xr, xs=w-1-yr
    [-1, 0, 1, 0, -1, 0, -1, 0, 1, -1, 0],      # 180: ys=h-1-yr, xs=w-1-xr
    [0, -1, 1, 0, -1, 1, 0, 0, 0, 0, 1],        # 270: ys=h-1-xr, xs=yr
], np.int64)


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
# Device line planning (interpreter.pair_lines, batched)
# ---------------------------------------------------------------------------


def _take(t, idx):
    """t[b, idx[b, m], ...] along dim 1 for (B, M) indices."""
    idx = idx.reshape(idx.shape + (1,) * (t.dim() - 2))
    return torch.gather(t, 1, idx.expand(idx.shape[:2] + t.shape[2:]))


def _centres(rows):
    """(B, M, 7) table rows -> (B, M, 2) float64 (y, x) centres: the
    integer sums over the count, as the host's."""
    cnt = torch.clamp(rows[..., 0], min=1).to(torch.float64)
    return torch.stack([rows[..., 1].to(torch.float64) / cnt,
                        rows[..., 2].to(torch.float64) / cnt], dim=-1)


def _slot(idx, keep, n):
    """Compaction target: idx where kept and below n, else the dump n."""
    return torch.where(keep & (idx < n), idx, n)


def _plan_lines_single(stats, n_comp, char_h=32, char_min_w=8):
    """Line plans of each paragraph of a launch from its band tables.

    stats (B, 2, M, 7) and n_comp (B, 2) of band_tables.  Returns (plans
    (B, M, 10) int64 in PLAN_FIELDS order, zero past each paragraph's
    lines, n_lines (B,)): a paragraph has a line per top component, so
    its lines fit the M rows.  interpreter.pair_lines on
    the components, in float64 as the host: each top takes the bottom
    nearest by centre (the first on ties), the first pair's displacement
    gives the rotation, the tops and their bottoms are sorted in reading
    order (stable) and zipped, each line the union box of its pair; then
    extract_line's upright extent and zoomed width."""
    B, _, M, _ = stats.shape
    dev = stats.device
    inf = float('inf')
    st = stats.to(torch.int64)
    top, bot = st[:, 0], st[:, 1]                                 # (B, M, 7)
    n = torch.clamp(n_comp.to(torch.int64), max=M)
    n_top, n_bot = n[:, 0:1], n[:, 1:2]
    sl = torch.arange(M, device=dev)
    tv, bv = sl[None, :] < n_top, sl[None, :] < n_bot
    cm_t, cm_b = _centres(top), _centres(bot)

    diff = cm_t[:, :, None, :] - cm_b[:, None, :, :]              # (B,M,M,2)
    sq = diff * diff
    d = torch.where(bv[:, None, :], torch.sqrt(sq[..., 0] + sq[..., 1]), inf)
    pick = torch.argmin(d, dim=2)                                 # (B, M)
    bot_p, cm_bp = _take(bot, pick), _take(cm_b, pick)

    delta = cm_t[:, 0] - cm_bp[:, 0]
    dy, dx = delta[:, 0], delta[:, 1]
    rot_i = torch.where(
        dy.abs() > dx.abs(), torch.where(dy > 0, 2, 0),
        torch.where(dx > 0, 1, torch.where(dx < 0, 3, 0)))       # rot // 90
    # the reading order of interpreter._ORIENTATION_KEYS: None (y, +1),
    # 180 (y, -1), 270 (x, +1), 90 (x, -1)
    ax = torch.where((rot_i == 0) | (rot_i == 2), 0, 1)
    ax = ax.reshape(B, 1, 1).expand(B, M, 1)
    sign = torch.where((rot_i == 0) | (rot_i == 3), 1.0, -1.0)[:, None]
    key_t = torch.where(tv, sign * torch.gather(cm_t, 2, ax)[..., 0], inf)
    key_b = torch.where(tv, sign * torch.gather(cm_bp, 2, ax)[..., 0], inf)
    top_o = _take(top, torch.argsort(key_t, dim=1, stable=True))
    bot_o = _take(bot_p, torch.argsort(key_b, dim=1, stable=True))
    y0 = torch.minimum(top_o[..., 3], bot_o[..., 3])
    y1 = torch.maximum(top_o[..., 4], bot_o[..., 4])
    x0 = torch.minimum(top_o[..., 5], bot_o[..., 5])
    x1 = torch.maximum(top_o[..., 6], bot_o[..., 6])
    line_mask = tv & (n_top > 0) & (n_bot > 0)

    h_l, w_l = y1 - y0, x1 - x0
    coef = _device_tables(dev)[1][rot_i][:, None, :]              # (B, 1, 11)
    swap = coef[..., 10] > 0
    lh = torch.clamp(torch.where(swap, w_l, h_l), min=1)
    lw = torch.clamp(torch.where(swap, h_l, w_l), min=1)
    w_out = torch.round(lw.to(torch.float64)
                        * (char_h / lh.to(torch.float64))).to(torch.int64)
    b_y = coef[..., 2] * h_l + coef[..., 3] * w_l + coef[..., 4] + y0
    b_x = coef[..., 7] * h_l + coef[..., 8] * w_l + coef[..., 9] + x0

    def const(i):
        return coef[..., i].expand(B, M)

    plans = torch.stack([lh, lw, w_out, const(0), const(1), b_y, const(5),
                         const(6), b_x, torch.clamp(w_out, min=char_min_w)],
                        dim=2)                                    # (B, M, 10)

    # the first n_top slots are the lines, in order
    return (torch.where(line_mask[..., None], plans, 0),
            line_mask.sum(dim=1))


# ---------------------------------------------------------------------------
# The fused tail: band masks -> components -> line crops -> Char -> glyphs
# ---------------------------------------------------------------------------


def fused_paragraph_tail(params, crops, bands, h_valid, w_valid,
                         precision=None, min_run=4, char_head='xla',
                         track=None):
    """Everything after the paragraph stage of one launch.

    crops (B, HB, WB, 1) float32 paragraph crops, bands (B, HB, WB, 2)
    bool their band masks; h_valid, w_valid (B,).  `char_head` as
    char_forward_masked's; `track(name)`, when given, opens the span
    'band_components' around the labelling launch.  Returns (the small
    payload (NBYTES,) uint8 of glyph ids, line bookkeeping, each
    paragraph's FLAG_BITS and its band component count, unpacked by
    unpack_fused_payload; the line plans (B, M, 10) of _plan_lines_single,
    left on the device).

    The caps never lose text silently: a paragraph whose band components
    overflow the table, or whose lines overflow the launch's LINE_POOL,
    CHAR_POOL_WIDTH or MAX_GLYPHS, is flagged.  The pipeline relaunches a
    flagged paragraph's planned lines through its line stage, and plans a
    paragraph whose table overflowed on the host from its band masks
    (OCRPipeline._plan_fused_launch)."""
    B = crops.shape[0]
    dev = crops.device
    span = track('band_components') if track else contextlib.nullcontext()
    with span:
        stats, n_comp = band_tables(bands, h_valid, w_valid)
    plans, n_lines = _plan_lines_single(stats, n_comp)
    over_tbl = n_comp.amax(dim=1) > stats.shape[2]

    # the launch's line pool: the (B, M) slots compacted in order
    L, P = plans.shape[1], LINE_POOL
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
    w_val = torch.clamp(fld('w_valid'), max=CHAR_POOL_WIDTH)
    lines = zoomed_line_crops(
        crops, para_idx, fld('lh'), fld('lw'),
        torch.clamp(w_out, max=CHAR_POOL_WIDTH), fld('a_yy'), fld('a_yx'),
        fld('b_y'), fld('a_xy'), fld('a_xx'), fld('b_x'), 32,
        CHAR_POOL_WIDTH)
    logits = char_forward_masked(params, to_u8_steps(lines), w_val,
                                 precision=precision, head=char_head)
    ids = logits.argmax(dim=-1)
    cols = torch.arange(logits.shape[1], device=dev)[None, :]
    valid = (cols < w_val[:, None]) & pool_used[:, None]
    glyphs, n_glyphs, over_gl = decode_ids_device(ids, valid, min_run)
    over_glyph = per_paragraph(over_gl)

    # the flag byte is a bitmask of FLAG_BITS (nonzero: the pipeline
    # reads the paragraph's lines otherwise); the host counts each bit in
    # escalation_stats
    bits = (over_tbl, over_pool, over_trunc, over_glyph)
    flags = sum(b.to(torch.uint8) << i for i, b in enumerate(bits))
    comps = torch.clamp(n_comp.sum(dim=1), max=65535).to(torch.int64)
    return torch.cat([
        torch.clamp(glyphs, 0, 255).to(torch.uint8).reshape(-1),
        n_glyphs.to(torch.uint8),
        torch.where(pool_used, para_idx, 255).to(torch.uint8),
        n_lines.to(torch.uint8),
        flags.to(torch.uint8),
        (comps & 255).to(torch.uint8),
        (comps >> 8).to(torch.uint8),
    ]), plans


def fused_payload_nbytes(launch_batch):
    """Length of fused_paragraph_tail's small payload for a launch of
    `launch_batch` paragraph slots."""
    return LINE_POOL * MAX_GLYPHS + 2 * LINE_POOL + 4 * launch_batch


def unpack_fused_payload(buf, n_paragraphs, n_shards=1):
    """Host inverse of fused_paragraph_tail's small payload.

    Returns (texts: [n_paragraphs][lines in reading order] str, flags
    (n_paragraphs,) uint8 bitmask of FLAG_BITS, nonzero where the host
    plans the paragraph, band components (n_paragraphs,) int64).  The
    launch batch comes from the buffer's length.

    Under a mesh each of `n_shards` data shards runs the tail on its share
    of the launch batch with its own line pool, and the payload is the
    shards' segments end to end: each segment is unpacked with its share
    (its slot count read from its layout) and the results are stitched
    back in batch order."""
    buf = np.asarray(buf)
    P, G = LINE_POOL, MAX_GLYPHS
    if n_shards > 1:
        segments = np.split(buf, n_shards)
        b_local = (segments[0].shape[0] - P * G - 2 * P) // 4
        texts = []
        flags, comps = [np.zeros(0, np.uint8)], [np.zeros(0, np.int64)]
        for s, segment in enumerate(segments):
            n_s = min(max(n_paragraphs - s * b_local, 0), b_local)
            if n_s == 0:
                break
            t, f, c = unpack_fused_payload(segment, n_s)
            texts.extend(t)
            flags.append(f)
            comps.append(c)
        return texts, np.concatenate(flags), np.concatenate(comps)
    # the device wrote n_lines, flags and counts for its whole batch,
    # fillers included; the real paragraphs come first
    b_dev = (buf.shape[0] - P * G - 2 * P) // 4
    glyphs = buf[:P * G].reshape(P, G)
    o = P * G
    n_glyphs = buf[o:o + P]
    para_of = buf[o + P:o + 2 * P]
    o += 2 * P + b_dev                             # past n_lines
    flags = buf[o:o + n_paragraphs]
    o += b_dev
    comps = (buf[o:o + n_paragraphs].astype(np.int64)
             + 256 * buf[o + b_dev:o + b_dev + n_paragraphs].astype(np.int64))
    # pool slots were assigned in (paragraph, line) order, so each
    # paragraph's lines come in reading order
    texts = [[] for _ in range(n_paragraphs)]
    for p in range(P):
        b = int(para_of[p])
        if b < n_paragraphs:
            texts[b].append(glyphs_to_text(glyphs[p], int(n_glyphs[p])))
    return texts, flags, comps
