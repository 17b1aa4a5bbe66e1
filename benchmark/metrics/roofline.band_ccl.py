"""`roofline.band_ccl.<suffix>`: the share of the band labelling kernel's
device time in the profiler window that the work of the pages done in
that window needs at the card's peak bandwidth, in %.  The kernel does no
arithmetic worth counting, so its work is bytes alone: both band masks
of every paragraph at one byte a pixel at the reference's true crop
sizes, and a 7-value table row of 4 bytes for each band component
(data/band_work.json, by data/make_band_work.py).  Padding to buckets,
filler slots, the page labels of the device planner (the same kernel on
the paragraph masks) and the kernel's own label traffic count against
it.  The kernel is found by its name in the trace; a program without it
reads nothing."""

from benchmark import core

KERNEL = 'band_ccl_kernel'


def read(name, rec):
    tr, peak = rec['trace'], rec['peak']
    if tr is None or peak is None or not rec['units']:
        return None
    seconds = sum(s for k, s in tr['kernels'].items() if KERNEL in k)
    if seconds <= 0:
        return None
    pages = core.load_json(core.BENCH / 'data' / 'band_work.json')['pages']
    nbytes = sum(pages[i]['band_ccl']['bytes'] for i in rec['units'])
    return 100.0 * nbytes / peak['bytes_per_s'] / seconds
