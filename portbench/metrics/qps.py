"""qps (queries/s, end to end): exact answers returned to the host in the
window, over the window's length: all the work over all the time."""


def read(run):
    return run.queries / run.window_s if run.queries and run.window_s > 0 else None
