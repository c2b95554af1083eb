"""F1 of the PASS calls against the planted truth (recall and precision
by the truth checker's type, position and 50-base tolerance rule),
pooled over every sample of the window (``svbench/truth.py``)."""


def read(run):
    calls = run["calls"]
    return None if calls is None else calls["f1"]
