"""schur.graph_hit_pct: the share of the Schur LM's device segments (the
initial cost, each linearization, each trial) that replayed a CUDA graph,
100 x ``schur.graph.replays`` / (replays + ``schur.graph.captures`` +
``schur.graph.eager``): the program's always-on counters, over every call
of the run since the process started (warm-up calls included); nothing
where the program keeps no such counters or ran no Schur segment on
CUDA."""

from portbench import progtrace

NAMES = ("schur.graph.replays", "schur.graph.captures", "schur.graph.eager")


def read(run):
    c = progtrace.counters()
    if not c:
        return None
    replays, captures, eager = (c.get(name, 0) for name in NAMES)
    if not replays + captures + eager:
        return None
    return 100.0 * replays / (replays + captures + eager)
