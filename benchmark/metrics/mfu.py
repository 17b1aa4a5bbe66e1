"""`mfu.<suffix>`: the model FLOPs of the pages done in the profiler
window (every stage of data/work.json) over the window's length and the
peak FLOP/s of every card the cell uses, in %."""

STAGES = ('monochrome', 'paragraph', 'line', 'char_trunk', 'char_head')


def read(name, rec):
    tr, peak = rec['trace'], rec['peak']
    if tr is None or peak is None or not rec['units']:
        return None
    pages = rec['work']['pages']
    flops = sum(pages[i][s]['flops'] for i in rec['units'] for s in STAGES)
    return 100.0 * flops / (tr['window_s'] * peak['flops'] * rec['devices'])
