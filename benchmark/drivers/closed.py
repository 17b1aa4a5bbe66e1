"""Loop `closed`: one caller, `ocr` calls of `pages_per_call` pool pages
back to back with no think time, as a batch user passes a corpus or an
interactive user waits on each page.

Reports `pages_per_s` (every page of every call of the window over the
time from the window's start to the last call's end) and, for one page a
call, the pages' latency (`page_latency_p95_ms`, p50 on an earlier line).
With a profiler window, it opens before the first call that starts
`profile.after_s` into the window and closes after the first call that
ends `profile.min_s` after it opened.
"""

import time

from benchmark import core


def warm(ctx):
    """Calls of the cell's size over the first `warm_pages` pool pages (one
    call at least): the first calls load the kernels and pick the
    convolutions' algorithms.  The host cascade runs eagerly, so a page
    seen for the first time compiles nothing: on an H100, after 4 pages,
    the other 44 took 121.8 ms a call at the median and 249.5 at most on
    first sight, and 131.8 / 250.8 and 125.7 / 249.4 on two passes
    after."""
    per = ctx.traffic['pages_per_call']
    n = max(1, -(-ctx.traffic['warm_pages'] // per))
    idx = list(range(len(ctx.pool)))
    for k in range(n):
        pages = [idx[(k * per + j) % len(idx)] for j in range(per)]
        ctx.system.ocr([ctx.page(i) for i in pages])
    ctx.sync()


def run(ctx):
    prof = ctx.traffic.get('profile', {})
    window = ctx.window
    calls, answers, units = [], [], []
    stream = core.PageStream(ctx.rng, len(ctx.pool))
    per = ctx.traffic['pages_per_call']
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < ctx.seconds:
        pages = stream.take(per)
        if window is not None and not window.done and not window.active \
                and time.perf_counter() - t0 >= prof.get('after_s', 0.0):
            window.start()
        start = time.perf_counter()
        try:
            result = ctx.system.ocr([ctx.page(i) for i in pages])
            ctx.sync()
        except Exception as exc:          # an answer that never came
            core.log(f'call {k} failed: {exc!r}')
            result = []
        end = time.perf_counter()
        got = list(result) + [None] * (len(pages) - len(result))
        pairs = list(zip(pages, got[:len(pages)]))
        answers.extend(pairs)
        if window is not None and window.active:
            units.extend(pages)
            if end - window.t_start >= prof.get('min_s', 0.0):
                window.stop()
        calls.append((start, end, len(pages)))
        k += 1
    if window is not None and window.active:
        window.stop()
    n_pages = sum(n for _, _, n in calls)
    last = calls[-1][1] if calls else time.perf_counter()
    lat = [1e3 * (e - s) for s, e, n in calls if n == 1]
    metrics = {'pages_per_s': n_pages / (last - t0)}
    notes = {'calls': len(calls), 'pages': n_pages,
             'window_s': last - t0,
             'call_s_median': core.percentile([e - s for s, e, _ in calls],
                                              50)}
    quarter = max(1, len(calls) // 4)
    notes['call_ms_p50_by_quarter'] = [
        round(1e3 * core.percentile([e - s for s, e, _ in
                                     calls[q:q + quarter]], 50), 3)
        for q in range(0, quarter * 4, quarter)]
    if lat:
        metrics['page_latency_p95_ms'] = core.percentile(lat, 95)
        notes['page_latency_p50_ms'] = core.percentile(lat, 50)
        notes['latency_samples'] = len(lat)
    return {'metrics': metrics, 'answers': answers,
            'units': units, 'calls': [n for _, _, n in calls],
            'notes': notes}
