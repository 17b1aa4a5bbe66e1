"""`line_char_ms.<suffix>`: wall milliseconds per page served in the
window of the host cascade's two device stages, `line_masks` (Line
forward and band threshold) and `char_ids` (Char forward and argmax),
each span including its uploads and the pull of its result."""

SPANS = ('line_masks', 'char_ids')


def read(name, rec):
    n = rec['counts']['pages']
    rows = [rec['timers'][s] for s in SPANS if s in rec['timers']]
    if not rows or not n:
        return None
    return 1e3 * sum(r['total_s'] for r in rows) / n
