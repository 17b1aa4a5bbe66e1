"""The readers of the host cascade's host CV steps, its pool threads' CPU
time and its waits on the card, on hand-made records: their values, and
None where the program has no such spans, as before it had them."""

import pytest

from benchmark import core

#: the parent's spans alone (no step, pull or counter of the host CV)
BEFORE = {'pull_front': (0.5, 10), 'host_paragraph_crops': (2.0, 10),
          'line_masks': (1.0, 10), 'host_line_crops': (6.0, 10),
          'char_ids': (1.5, 10), 'decode_text': (0.1, 10)}
#: and the spans and counter inside them
INSIDE = {'para_label': (1.0, 40), 'para_select': (2.0, 280),
          'para_deskew': (3.0, 280), 'line_plan': (4.0, 280),
          'line_extract': (10.0, 700), 'host_cv_thread_cpu': (12.0, 1580),
          'line_pull': (0.25, 10), 'char_pull': (0.75, 10)}


def records(spans, pages=40):
    return {'timers': {name: {'total_s': total, 'count': count}
                       for name, (total, count) in spans.items()},
            'counts': {'calls': 1, 'pages': pages, 'chunks': 10},
            'trace': None, 'units': [], 'work': None, 'devices': 1,
            'peak': None}


def read(name, rec):
    return core.metric_reader(name).read(name, rec)


@pytest.mark.parametrize('name, value', [
    ('host_cv_threads.batch', 20.0 / 8.0),
    ('host_cv_threads.single', 20.0 / 8.0),
    ('host_cv_cpu_share.batch', 100.0 * 12.0 / 20.0),
    ('host_cv_cpu_share.single', 100.0 * 12.0 / 20.0),
    ('device_wait_ms.batch', 1e3 * 1.5 / 40),
    ('device_wait_ms.single', 1e3 * 1.5 / 40),
    ('host_cv_step_ms.para_label.batch', 1e3 * 1.0 / 40),
    ('host_cv_step_ms.para_select.batch', 1e3 * 2.0 / 40),
    ('host_cv_step_ms.para_deskew.batch', 1e3 * 3.0 / 40),
    ('host_cv_step_ms.line_plan.batch', 1e3 * 4.0 / 40),
    ('host_cv_step_ms.line_extract.batch', 1e3 * 10.0 / 40),
])
def test_reads_the_spans_inside_host_cv(name, value):
    assert read(name, records({**BEFORE, **INSIDE})) == pytest.approx(value)
    assert read(name, records(BEFORE)) is None

