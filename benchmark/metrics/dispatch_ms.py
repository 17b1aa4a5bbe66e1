"""`dispatch_ms.<suffix>`: wall milliseconds per chunk of the window of
the device cascade's span `dispatch_paragraph_stage`: the dispatcher
thread building and launching a chunk's paragraph launches (crops, Line,
the band labelling and, with the fused tail, the line crops, Char and
the decode), without waiting on the card."""

SPAN = 'dispatch_paragraph_stage'


def read(name, rec):
    chunks = rec['counts']['chunks']
    row = rec['timers'].get(SPAN)
    if row is None or not chunks:
        return None
    return 1e3 * row['total_s'] / chunks
