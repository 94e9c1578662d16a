"""dense.linearizations: the program's own ``linearizations`` counter,
returned per problem by the solver, averaged over every problem of every
call of the window; nothing where the entry does not return it."""

KEY = "dense.linearizations"


def read(run):
    return run.counters.get(KEY)
