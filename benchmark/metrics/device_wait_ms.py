"""`device_wait_ms.<suffix>`: wall milliseconds per page served in the
window that the host cascade's calling thread blocked on the card: the
pulls of the front's outputs (`pull_front`) and of the Line and Char
results (`line_pull` inside `line_masks`, `char_pull` inside
`char_ids`)."""

SPANS = ('pull_front', 'line_pull', 'char_pull')


def read(name, rec):
    n = rec['counts']['pages']
    timers = rec['timers']
    if not n or not all(s in timers for s in SPANS):
        return None
    return 1e3 * sum(timers[s]['total_s'] for s in SPANS) / n
