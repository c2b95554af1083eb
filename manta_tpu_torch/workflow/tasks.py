"""Persistent task-completion state for interrupted-run resume.

The reference workflow engine (pyflow, redist/pyflow-1.1.20) records
every completed task in the run's workspace and, when `runWorkflow.py`
is re-executed on the same run directory, skips tasks that already
completed ("Continue workflows which have partially completed", pyflow
README; user-facing behavior docs/userGuide/README.md:631-633).

This module provides the same behavior for this workflow: a small
JSON state file in `workspace/` maps task names to their completion
records. A task is considered done only when (a) its record exists,
(b) the run *signature* (the full parameter set of the run) matches the
one the record was written under, and (c) every artifact file the task
produced still exists. A changed signature invalidates all records, so
editing the run configuration triggers a fresh run rather than a
mismatched resume.
"""

from __future__ import annotations

import hashlib
import json
import os


def signature_digest(params: dict) -> str:
    """Stable digest of the run parameters."""
    blob = json.dumps(params, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def content_digest(obj) -> str:
    """Short digest of arbitrary (repr-stable) content, used to key
    data-dependent subtasks (e.g. one phase-1 region group, one phase-2
    edge bin) so reshaped work plans never reuse stale artifacts."""
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:12]


class TaskTracker:
    """Completed-task registry persisted as workspace/taskState.json."""

    STATE_NAME = "taskState.json"

    def __init__(self, workspace_dir: str, signature_params: dict,
                 state_name: str | None = None):
        # multi-host runs give each host its own state file so shared-
        # workspace hosts never race on one record file (cross-host
        # completion is carried by the per-bin artifacts themselves)
        self.path = os.path.join(workspace_dir,
                                 state_name or self.STATE_NAME)
        self._base_path = os.path.join(workspace_dir, self.STATE_NAME)
        self.signature = signature_digest(signature_params)
        self.tasks: dict[str, dict] = {}
        self._load()

    def _load(self):
        # tagged (per-host) trackers inherit the shared untagged
        # records READ-ONLY: the host-0 bootstrap's phase-0/1
        # checkpoints (stats / chromDepth / graph) must count as done
        # on every host, or each host silently redoes the whole
        # single-host prefix (measured: +~80% CPU at 12 Mb scale,
        # bench_2host.py). Per-host completions still write only the
        # tagged file, so hosts never race on one record file.
        if self.path != self._base_path:
            base = self._read_state(self._base_path)
            if base is not None:
                self.tasks.update(base)
        own = self._read_state(self.path)
        if own is not None:
            self.tasks.update(own)

    def _read_state(self, path):
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                state = json.load(f)
        except (OSError, ValueError):
            return None
        if state.get("signature") != self.signature:
            # parameter change -> every prior record is invalid
            return None
        return state.get("tasks", {})

    def _save(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"signature": self.signature, "tasks": self.tasks}, f,
                      indent=1)
        os.replace(tmp, self.path)

    def is_done(self, name: str) -> bool:
        rec = self.tasks.get(name)
        if rec is None:
            return False
        for artifact in rec.get("artifacts", []):
            if not os.path.exists(artifact):
                return False
        return True

    def mark_done(self, name: str, artifacts: list[str] | None = None):
        self.tasks[name] = {"artifacts": list(artifacts or [])}
        self._save()

    def clear(self, prefix: str = ""):
        """Drop records (optionally only those under a name prefix)."""
        if prefix:
            self.tasks = {k: v for k, v in self.tasks.items()
                          if not k.startswith(prefix)}
        else:
            self.tasks = {}
        self._save()
