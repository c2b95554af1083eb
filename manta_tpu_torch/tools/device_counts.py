"""The device work of a workflow run, wherever in the process tree it ran.

At ``-j N`` a workflow does its contig jump scoring and split scans in
forked worker processes, and each worker prints one exit line on stderr
with its own counts (``align/device_jumpscore.py``: ``device-dispatch``;
``scoring/device_scan.py``: ``split-scan``). ``WorkflowCounts`` tees
this process's file descriptor 2, which the workers inherit, while a run
lasts: everything still reaches stderr, and those lines are kept. Its
``counts()`` adds them to what this process did itself (a ``-j 1`` run,
whose own exit line comes only when the process ends)."""

from __future__ import annotations

import ast
import os
import re
import sys
import threading

# the work each line ends with (``KERNEL_WORK``); a line written before
# the work counters has none, and its work counts as 0
DISPATCH_LINE = re.compile(
    r"device-dispatch pid=\d+: (\d+) calls, (\d+) jobs, (\d+) padded rows, "
    r"([0-9.]+)s total, first [0-9.]+s \(incl\. kernel build\), (\d+) "
    r"kernel launches(?:; calls by bucket .*?; work: (\d+) useful cells, "
    r"(\d+) padded cells, (\d+) bytes)?")
SCAN_LINE = re.compile(
    r"split-scan pid=\d+: (\d+) calls .*?, ([0-9.]+)s total, (\d+) kernel "
    r"launches(?:; work: (\d+) useful terms, (\d+) padded terms, (\d+) "
    r"bytes)?")
# the shapes each line ends with: the dispatcher's calls by padded bucket
# (B, nq, nr1, nr2), the router's exact scans by tier (Lp, Tp) with the
# most reads and targets of a call
BUCKETS = re.compile(r"device-dispatch pid=\d+: .*calls by bucket "
                     r"\(B, nq, nr1, nr2\): (\{[^}]*\})")
TIERS = re.compile(r"split-scan pid=\d+: .*tiers \(Lp, Tp\): (\{[^}]*\})")
WORK_KEYS = {"k1": ("k1_useful_cells", "k1_padded_cells", "k1_bytes"),
             "k3": ("k3_useful_terms", "k3_padded_terms", "k3_bytes")}


def parse_lines(text: str) -> dict:
    """The sums over the exit lines in ``text``."""
    out = {"device_processes": 0, "dispatches": 0, "contig_jobs": 0,
           "padded_rows": 0, "dispatch_wall_s": 0.0, "k1_launches": 0,
           "split_scans": 0, "split_scan_wall_s": 0.0, "k3_launches": 0,
           **{k: 0 for keys in WORK_KEYS.values() for k in keys}}
    for calls, jobs, rows, wall, k1, *work in DISPATCH_LINE.findall(text):
        out["device_processes"] += 1
        out["dispatches"] += int(calls)
        out["contig_jobs"] += int(jobs)
        out["padded_rows"] += int(rows)
        out["dispatch_wall_s"] += float(wall)
        out["k1_launches"] += int(k1)
        for key, n in zip(WORK_KEYS["k1"], work):
            out[key] += int(n or 0)
    for calls, wall, k3, *work in SCAN_LINE.findall(text):
        out["split_scans"] += int(calls)
        out["split_scan_wall_s"] += float(wall)
        out["k3_launches"] += int(k3)
        for key, n in zip(WORK_KEYS["k3"], work):
            out[key] += int(n or 0)
    return out


def _add_shapes(out: dict, buckets: dict, tiers: dict) -> None:
    """Add a process's K1 buckets and K3 tiers to ``out``
    (``parse_shapes``' form)."""
    for shape, calls in buckets.items():
        key = ",".join(map(str, shape))
        out["jump_score"][key] = out["jump_score"].get(key, 0) + calls
    for (lp, tp), (calls, reads, targets) in tiers.items():
        tier = out["split_score"].setdefault(
            f"{lp},{tp}", {"calls": 0, "reads": 0, "targets": 0})
        tier["calls"] += calls
        tier["reads"] = max(tier["reads"], reads)
        tier["targets"] = max(tier["targets"], targets)


def parse_shapes(text: str) -> dict:
    """The shapes the exit lines in ``text`` launched at: {"jump_score":
    {"B,nq,nr1,nr2": calls}, "split_score": {"Lp,Tp": {"calls", "reads",
    "targets"}}} (the most reads and targets of one call)."""
    out = {"jump_score": {}, "split_score": {}}
    for buckets in BUCKETS.findall(text):
        _add_shapes(out, ast.literal_eval(buckets), {})
    for tiers in TIERS.findall(text):
        _add_shapes(out, {}, ast.literal_eval(tiers))
    return out


def _own_shapes() -> tuple[dict, dict]:
    """This process's buckets and tiers so far (copies)."""
    dj = sys.modules.get("manta_tpu_torch.align.device_jumpscore")
    ds = sys.modules.get("manta_tpu_torch.scoring.device_scan")
    return (dict(dj.DISPATCH_BUCKETS) if dj is not None else {},
            {k: list(v) for k, v in ds.SCAN_TIERS.items()}
            if ds is not None else {})


def _own_counts() -> dict:
    """This process's counts so far; zeros where the device modules were
    never imported (a run with scoring off never imports torch)."""
    dj = sys.modules.get("manta_tpu_torch.align.device_jumpscore")
    ds = sys.modules.get("manta_tpu_torch.scoring.device_scan")
    cs = sys.modules.get("manta_tpu_torch.align.cuda_splitscore")
    out = {k: v for k, v in parse_lines("").items()
           if k != "device_processes"}
    if dj is not None:
        s = dj.DISPATCH_STATS
        out.update(dispatches=s["calls"], contig_jobs=s["jobs"],
                   padded_rows=s["rows"], dispatch_wall_s=s["wall"],
                   k1_launches=dj.KERNEL_LAUNCHES["jump_score"])
        out.update(zip(WORK_KEYS["k1"],
                       dj.KERNEL_WORK["jump_score"].values()))
    if ds is not None:
        s = ds.SCAN_STATS
        out.update(split_scans=s["exact"] + s["mxu"] + s["fallback"],
                   split_scan_wall_s=s["wall"])
    if cs is not None:
        out["k3_launches"] = cs.KERNEL_LAUNCHES["split_score"]
        out.update(zip(WORK_KEYS["k3"], cs.KERNEL_WORK["split_score"].values()))
    return out


class WorkflowCounts:
    """``with WorkflowCounts() as wc: run_workflow(...)``, then
    ``wc.counts()``: the device work of the run, in this process and in
    its workers."""

    def __init__(self):
        self._lines: list[str] = []
        self._saved = None
        self._thread = None
        self._before = None
        self._after = None

    def __enter__(self):
        self._before = _own_counts()
        self._shapes_before = _own_shapes()
        sys.stderr.flush()
        r, w = os.pipe()
        self._saved = os.dup(2)
        os.dup2(w, 2)
        os.close(w)
        self._thread = threading.Thread(target=self._pump, args=(r,),
                                        daemon=True)
        self._thread.start()
        return self

    def _pump(self, r: int) -> None:
        pending = b""
        while True:
            chunk = os.read(r, 1 << 16)
            if not chunk:
                break
            view = memoryview(chunk)
            while view:
                view = view[os.write(self._saved, view):]
            pending += chunk
            *lines, pending = pending.split(b"\n")
            self._lines += [ln.decode(errors="replace") for ln in lines
                            if b" pid=" in ln]
        os.close(r)

    def __exit__(self, *exc):
        self._after = _own_counts()
        self._shapes_after = _own_shapes()
        sys.stderr.flush()
        # closes the pipe's last write end but those of processes still
        # alive; the pump ends when they are gone
        os.dup2(self._saved, 2)
        self._thread.join(timeout=30)
        if not self._thread.is_alive():
            os.close(self._saved)

    def counts(self) -> dict:
        out = parse_lines("\n".join(self._lines))
        own = {k: v - self._before[k] for k, v in self._after.items()}
        for k, v in own.items():
            out[k] += v
        out["device_processes"] += bool(own["dispatches"]
                                        or own["split_scans"])
        out["dispatch_wall_s"] = round(out["dispatch_wall_s"], 4)
        out["split_scan_wall_s"] = round(out["split_scan_wall_s"], 4)
        return out

    def shapes(self) -> dict:
        """``parse_shapes`` of the run: its workers' exit lines and what
        this process launched itself (a tier's most reads and targets as
        this process last saw them)."""
        out = parse_shapes("\n".join(self._lines))
        (b0, t0), (b1, t1) = self._shapes_before, self._shapes_after
        _add_shapes(out, {k: n - b0.get(k, 0) for k, n in b1.items()
                          if n > b0.get(k, 0)},
                    {k: [v[0] - t0.get(k, [0])[0], *v[1:]]
                     for k, v in t1.items() if v[0] > t0.get(k, [0])[0]})
        return out
