"""The reader of `graph_replay_share.fused` on hand-made records: the
replayed share of the stage launches, 0 where none was replayed, and None
where the program has no such counters, as before it had them."""

import pytest

from benchmark import core


def records(spans):
    return {'timers': {name: {'total_s': total, 'count': count}
                       for name, (total, count) in spans.items()},
            'counts': {'calls': 1, 'pages': 128, 'chunks': 4},
            'trace': None, 'units': [0, 1], 'work': None, 'devices': 1,
            'peak': None}


def read(rec):
    name = 'graph_replay_share.fused'
    return core.metric_reader(name).read(name, rec)


@pytest.mark.parametrize('spans, value', [
    ({'stage_launches': (68.0, 68), 'graph_replays': (68.0, 68)}, 100.0),
    ({'stage_launches': (68.0, 68), 'graph_replays': (51.0, 51),
      'graph_captures': (2.0, 2)}, 75.0),
    ({'stage_launches': (68.0, 68)}, 0.0),
])
def test_reads_the_replayed_share_of_the_stage_launches(spans, value):
    assert read(records(spans)) == pytest.approx(value)


@pytest.mark.parametrize('spans', [
    {},
    {'host_sync': (38.0, 38), 'dispatch_paragraph_stage': (0.2, 4)},
    {'stage_launches': (0.0, 0)},
])
def test_reads_nothing_without_the_counters(spans):
    assert read(records(spans)) is None
