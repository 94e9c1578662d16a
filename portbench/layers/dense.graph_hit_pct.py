"""dense.graph_hit_pct: the share of the dense LM's device segments (the
initial cost, each linearization, each trial) that replayed a CUDA graph,
100 x ``dense.graph.replays`` / (replays + ``dense.graph.captures`` +
``dense.graph.eager``): the program's always-on counters, over every call
of the run since the process started (warm-up calls included); nothing
where the program keeps no such counters or ran no dense segment on
CUDA."""

from portbench import progtrace

NAMES = ("dense.graph.replays", "dense.graph.captures", "dense.graph.eager")


def read(run):
    c = progtrace.counters()
    if not c:
        return None
    replays, captures, eager = (c.get(name, 0) for name in NAMES)
    if not replays + captures + eager:
        return None
    return 100.0 * replays / (replays + captures + eager)
