"""One ledger of the port's host-side counts.

Each module that counts registers its counters once, at import: the
dicts (or functions that return one) its process's record carries under
a key of ``counts()`` (``parallel.worker_trace``), and the formatter of
its exit line where it prints one. The dicts keep their modules' names,
and nothing here zeroes one. At exit every process, a forked worker
included, prints each exit line that its formatter returns (None where
the process counted nothing), once.
"""

from __future__ import annotations

import copy
import importlib
import multiprocessing.util
import os
import sys

from .forkpool import at_process_exit

# the modules that register, loaded when the ledger is read, so that a
# process's counts hold every key: zeros for what it never ran
COUNTING = ("..align.cuda_jumpscore", "..align.cuda_splitscore",
            "..align.device_jumpscore", "..scoring.device_scan",
            "..scoring.scorer", ".device_proc")
_PARTS: dict[str, list] = {}
_LINES: list = []
_PRINTED = {"pid": None}


def register(parts: dict, line=None) -> None:
    """Add ``parts`` (record key -> a dict, or a function returning one)
    to ``counts()``, and ``line`` to the exit lines."""
    for key, part in parts.items():
        _PARTS.setdefault(key, []).append(part)
    if line is not None:
        _LINES.append(line)


def counts() -> dict:
    """A copy of every registered counter, each key's parts merged."""
    for name in COUNTING:
        importlib.import_module(name, __package__)
    out = {key: {} for key in _PARTS}
    for key, parts in _PARTS.items():
        for part in parts:
            out[key].update(copy.deepcopy(part() if callable(part) else part))
    return out


def zeros(value):
    """``value`` with every number zero and every list empty."""
    if isinstance(value, dict):
        return {k: zeros(v) for k, v in value.items()}
    return [] if isinstance(value, list) else type(value)()


def _print_lines() -> None:
    if _PRINTED["pid"] != os.getpid():
        _PRINTED["pid"] = os.getpid()
        for text in filter(None, (line() for line in _LINES)):
            print(text, file=sys.stderr, flush=True)


at_process_exit(_print_lines)
# a forked multiprocessing worker drops its parent's exit hooks
multiprocessing.util.register_after_fork(
    _print_lines, lambda _fn: at_process_exit(_print_lines))
