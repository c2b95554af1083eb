"""K3 launches per million reads over the window's untraced samples, from
the workers' exit lines (``split-scan ... N kernel launches``): what
batching the split scans of several candidates into one launch cuts."""


def read(run):
    launches = sum(s["exit"]["k3_launches"] for s in run["samples"])
    if not launches or not run["reads"]:
        return None
    return launches / (run["reads"] / 1e6)
