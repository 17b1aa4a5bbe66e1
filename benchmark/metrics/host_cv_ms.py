"""`host_cv_ms.<suffix>`: wall milliseconds of the host cascade's host CV
per page served in the window: the paragraph crops (label, crop, deskew)
and the line crops (band labels, line boxes, zoom), from the program's
StageTimers, each span timed around the pool's map over a chunk."""

SPANS = ('host_paragraph_crops', 'host_line_crops')


def read(name, rec):
    n = rec['counts']['pages']
    rows = [rec['timers'][s] for s in SPANS if s in rec['timers']]
    if not rows or not n:
        return None
    return 1e3 * sum(r['total_s'] for r in rows) / n
