"""`device_idle.<suffix>`: the share of the profiler window in which no
operation ran on a card (kernels, copies, fills), as a mean over the
cards the cell uses, in %."""


def read(name, rec):
    tr = rec['trace']
    if tr is None or tr['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - tr['busy_s'] / tr['window_s'])
