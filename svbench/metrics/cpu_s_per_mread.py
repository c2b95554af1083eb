"""CPU seconds (user and system) of the process and of its reaped
children (the workflow's forked workers) over the window, per million
reads of the window's samples (``getrusage``)."""


def read(run):
    if not run["reads"] or run["calls"] is None:
        return None
    return run["cpu_s"] / (run["reads"] / 1e6)
