"""`host_cv_cpu_share.<suffix>`: the share of a busy pool thread's wall
time in the host CV steps that it ran on a core, in %: the program's
counter `host_cv_thread_cpu` (the thread's CPU seconds, summed over the
same step intervals) over the wall seconds of the five steps.  The rest
the thread waited: for the interpreter lock, or for a core."""

STEPS = ('para_label', 'para_select', 'para_deskew', 'line_plan',
         'line_extract')


def read(name, rec):
    timers = rec['timers']
    busy = sum(timers[s]['total_s'] for s in STEPS if s in timers)
    if 'host_cv_thread_cpu' not in timers or busy <= 0:
        return None
    return 100.0 * timers['host_cv_thread_cpu']['total_s'] / busy
