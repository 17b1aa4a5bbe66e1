"""`host_syncs.<suffix>`: the device cascade's blocking pulls per chunk
of the window: the program's counter `host_sync` (one per wait of a
thread on a pull from the card, OCRPipeline.host_syncs) over the chunks
the window's calls made.  A program without the counter reads nothing."""


def read(name, rec):
    chunks = rec['counts']['chunks']
    row = rec['timers'].get('host_sync')
    if row is None or not chunks:
        return None
    return row['total_s'] / chunks
