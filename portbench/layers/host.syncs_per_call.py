"""host.syncs_per_call: the host's blocking reads of device values per
call: the program's ``host.syncs`` counter (one per ``profiling.sync``
site entered: the LMs' flag reads per linearization and per trial, the
phase split, RANSAC's active lanes, results copied out), which is always on
and runs from the process's start, over every call the run made (one
warm-up call per fleet, the window's and the traced stretch's); nothing
where the program keeps no such counter."""

from portbench import progtrace


def read(run):
    c = progtrace.counters()
    if not c or not c.get("host.syncs"):
        return None
    return c["host.syncs"] / progtrace.run_calls(run)
