"""`host_cv_threads.<suffix>`: the pool threads busy on average while the
host cascade's host CV runs: the wall seconds of its five steps, summed
over the pool threads, over the wall seconds of the two pool maps that
run them (`host_paragraph_crops` + `host_line_crops`).  It lies between
0 and the pool's workers; below them, threads sat idle in a map, waiting
for its last task."""

STEPS = ('para_label', 'para_select', 'para_deskew', 'line_plan',
         'line_extract')
MAPS = ('host_paragraph_crops', 'host_line_crops')


def read(name, rec):
    timers = rec['timers']
    steps = [timers[s]['total_s'] for s in STEPS if s in timers]
    maps = sum(timers[s]['total_s'] for s in MAPS if s in timers)
    if not steps or maps <= 0:
        return None
    return sum(steps) / maps
