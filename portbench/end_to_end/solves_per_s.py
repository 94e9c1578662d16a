"""solves_per_s: problems (sensors or robot cells) solved without failure,
over the whole window's wall, each call counted whole."""


def read(run):
    return (run.attempted - run.failed) / run.window_s
