"""schur.rephased_pct: the share of the Schur LM's lanes that the phased
solve sent on to a later phase, 100 x ``schur.rephased_lanes`` /
``schur.lanes`` (the program's always-on counters, over every call of the
run since the process started); nothing where the program keeps no such
counters or no lane ran a phased Schur solve."""

from portbench import progtrace


def read(run):
    c = progtrace.counters()
    if not c or not c.get("schur.lanes"):
        return None
    return 100.0 * c.get("schur.rephased_lanes", 0) / c["schur.lanes"]
