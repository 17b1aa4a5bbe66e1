"""`graph_replay_share.<suffix>`: the share, in %, of the device cascade's
stage launches in the window (the paragraph launches and the chunk
planner's calls: the program's counter `stage_launches`) that the replay
of a captured CUDA graph served (its counter `graph_replays`) rather than
ops dispatched one by one.  A program without the counters reads nothing;
one that counts launches but replays none reads 0."""


def read(name, rec):
    timers = rec['timers']
    launches = timers.get('stage_launches')
    if launches is None or not launches['total_s']:
        return None
    replays = timers.get('graph_replays', {'total_s': 0.0})['total_s']
    return 100.0 * replays / launches['total_s']
