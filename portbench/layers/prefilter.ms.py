"""prefilter.ms: milliseconds per call of the window inside the benchmark's
"prefilter" spans (``spans.layer_timers``, synchronised at both ends);
nothing where the cell's entry has no such span or the layer never ran."""

LABEL = "prefilter"


def read(run):
    if LABEL not in run.labels or not run.spans.get(LABEL):
        return None
    return run.spans[LABEL] / run.calls * 1e3
