"""One sample's evidence for one junction, in ms, in the traced sample:
the ns the phase-2 workers' scorers spent gathering evidence
(``JOINT_STATS["evidence_ns"]`` of ``scoring/scorer``, in each record's
``counts["joint"]``: breakend depth, pair support, split reads with the
K3 routes) over their sample-junctions (junctions scored x samples),
less the ``cuda.context`` and ``trace.start`` spans that a worker's
first ``k3.route`` opens inside it. None where no record has the
counter."""

DEVICE_START = ("cuda.context", "trace.start")


def _start_ns_in_router(spans):
    """The ns of the device start-up spans nested under a ``k3.route``."""
    total = 0
    for name, start, end, parent, _attrs in spans:
        if name not in DEVICE_START or end is None:
            continue
        while parent is not None and spans[parent][0] != "k3.route":
            parent = spans[parent][3]
        if parent is not None:
            total += end - start
    return total


def read(run):
    armed = run.get("armed")
    if not armed:
        return None
    ns = pairs = 0
    for w in armed["workers"]:
        joint = (w.get("counts") or {}).get("joint")
        if not joint:
            continue
        ns += joint["evidence_ns"] - _start_ns_in_router(w.get("spans") or [])
        pairs += joint["sample_junctions"]
    return ns / pairs / 1e6 if pairs else None
