"""`roofline.<kernel>.<suffix>`: the share of a CUDA kernel's device time
in the profiler window that the work of the pages done in that window
needs at the card's peaks: max(FLOPs / peak FLOP/s, bytes / peak bytes/s)
over the kernel's time, in %.  The work is the committed table's
(data/work.json, from the reference's shapes: true page size, true crop
and line widths), so padding, filler and recomputation count against the
kernel; the stage's weights are read once.  The kernel is found by its
name in the trace."""

KERNELS = {'char_head': ('char_head_kernel', 'char_head'),
           'monochrome': ('fused_monochrome_kernel', 'monochrome')}


def read(name, rec):
    tr, peak = rec['trace'], rec['peak']
    if tr is None or peak is None or not rec['units']:
        return None
    pattern, stage = KERNELS[name.split('.')[1]]
    seconds = sum(s for k, s in tr['kernels'].items() if pattern in k)
    if seconds <= 0:
        return None
    pages = rec['work']['pages']
    flops = sum(pages[i][stage]['flops'] for i in rec['units'])
    nbytes = (sum(pages[i][stage]['bytes'] for i in rec['units'])
              + rec['work']['meta']['weight_bytes'][stage])
    least = max(flops / peak['flops'], nbytes / peak['bytes_per_s'])
    return 100.0 * least / seconds
