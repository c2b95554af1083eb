"""Reads of every sample in the window over the window's whole wall
(host clock from the first sample's start to the last one's end)."""


def read(run):
    if not run["window_s"] or run["calls"] is None:
        return None
    return run["reads"] / run["window_s"]
