"""At-scale WGS measurement: run a generated workload end to end through
the port's workflow, take the phase breakdown and the serial tail from
the workflow's log, sample the process tree's memory, and write the
measured-run artifact that ``tools.bench`` reads.

    python -m manta_tpu_torch.tools.bench_wgs_at_scale --workload P \\
        [--jobs N] [--device-scoring off|auto|jump|exact|mxu] \\
        [--device cuda|cpu] [--results-dir D] [--tag T] [--keep]

Twin of benchmarks/bench_wgs_at_scale.py: the same sampler, phase
stamps, serial tail, 20-core projection and artifact keys, plus
``device`` (the card's ``nvidia-smi --query-gpu=name,power.limit`` line,
or ``"cpu"``), ``device_scoring_resolved`` and the device work of the
run, counted in every process that did it (``tools.device_counts``;
at ``-j N`` the workers). ``P`` is a prefix of
``tools.wgs_workload``'s output (``P.bam``, ``P.fa``).

``--device cuda`` (the default) needs a CUDA device and raises without
one; ``--device cpu`` runs device scoring through the plain PyTorch
forms on the host and labels the artifact so. The artifact goes to
``--results-dir`` (default ``results_torch/`` at the repo root, which
git ignores): ``wgs_measured[_<tag>].json`` and its memory trace.

The reference baseline being chased: NA12878 50x (840 M reads),
< 20 min on 20 physical cores, 2.35 GB peak RSS
(reference: docs/userGuide/README.md:474-484).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import resource
import subprocess
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS_DIR = os.path.join(REPO, "results_torch")

WGS_READS_M = 840.0
BASELINE_WALL_MIN = 20.0
BASELINE_CORES = 20


class RssSampler:
    """Samples the whole process tree's memory every interval,
    splitting anonymous from file-backed RSS (/proc/<pid>/status
    RssAnon / RssFile; per mapping from /proc/<pid>/smaps on kernels
    without them). ru_maxrss conflates the two: this workflow
    mmaps the input BAM, so touched CLEAN file pages — page cache the
    kernel can drop at any moment — inflate RSS far beyond the real
    (anonymous) footprint. The reference's 2.35 GB figure is
    read()-based and contains no such pages, so the honest comparison
    is peak SUM of RssAnon across live processes."""

    def __init__(self, interval=3.0):
        import threading
        self.interval = interval
        self.peak_anon = 0
        self.peak_file = 0
        self.peak_total = 0
        # largest single-process anonymous RSS ever seen, with the
        # process role (argv tail; forked workers share argv, so the
        # elapsed-seconds stamp is what locates the owning stage in
        # the ms-stamped workflow log) and the tree-sum peak's stamp
        self.peak_proc_anon = 0
        self.peak_proc_role = ""
        self.peak_proc_at_s = 0.0
        self.peak_anon_at_s = 0.0
        # RssAnon double-counts COW pages shared between the workflow
        # parent and its forked workers; Pss_Anon (smaps_rollup)
        # apportions shared pages, so its tree sum is the true unique
        # anonymous footprint — the number comparable to the
        # reference's reported peak
        self.peak_pss_anon = 0
        # the same sums split between this process (the workflow's
        # parent) and the rest of the tree (its workers), each its own
        # peak over the samples
        self.peak_parent = {"anon": 0, "pss_anon": 0}
        self.peak_workers = {"anon": 0, "pss_anon": 0}
        # where each figure was read: "smaps_rollup" or "smaps" for
        # Pss_Anon, "status" or "smaps" for RssAnon; a figure no source
        # gave stays out of ``peaks()``
        self.sources = {}
        self.trace = []          # (t_s, anon_sum, pss_anon_sum, nproc)
        self._t0 = time.perf_counter()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _tree(self):
        me = os.getpid()
        kids = {}
        for pid in os.listdir("/proc"):
            if not pid.isdigit():
                continue
            try:
                with open(f"/proc/{pid}/stat") as f:
                    parts = f.read().rsplit(")", 1)[1].split()
                kids.setdefault(int(parts[1]), []).append(int(pid))
            except OSError:
                continue
        out, queue = [], [me]
        while queue:
            p = queue.pop()
            out.append(p)
            queue.extend(kids.get(p, []))
        return out

    @staticmethod
    def _smaps(pid):
        """(Pss of anonymous pages, anonymous RSS) in bytes from the
        per-mapping /proc/<pid>/smaps, for kernels whose smaps_rollup
        or status lack Pss_Anon or RssAnon (seen on the card's host):
        each mapping's own Pss_Anon where the kernel gives it, else its
        Pss times its anonymous share of its RSS; None without smaps."""
        try:
            with open(f"/proc/{pid}/smaps") as f:
                text = f.read()
        except OSError:
            return None
        pss_anon = pss_share = anon = 0.0
        vals = {}

        def close():
            nonlocal pss_share
            if vals.get("Rss"):
                pss_share += (vals.get("Pss", 0) * vals.get("Anonymous", 0)
                              / vals["Rss"])
            vals.clear()

        for line in text.splitlines():
            key, _, rest = line.partition(":")
            if " " in key or "-" in key:          # a mapping's header
                close()
            elif key in ("Rss", "Pss", "Anonymous", "Pss_Anon"):
                vals[key] = int(rest.split()[0]) * 1024
                if key == "Pss_Anon":
                    pss_anon += vals[key]
                elif key == "Anonymous":
                    anon += vals[key]
        close()
        return int(pss_anon or pss_share), int(anon)

    def _run(self):
        me = os.getpid()
        while not self._stop.is_set():
            anon = filp = tot = pss = nproc = 0
            parent = {"anon": 0, "pss_anon": 0}
            for pid in self._tree():
                p_pss = p_anon = p_file = p_tot = None
                try:
                    with open(f"/proc/{pid}/smaps_rollup") as f:
                        mm = re.search(r"Pss_Anon:\s+(\d+) kB",
                                       f.read())
                    if mm:
                        p_pss = int(mm.group(1)) * 1024
                        self.sources["pss_anon"] = "smaps_rollup"
                except OSError:
                    pass
                try:
                    with open(f"/proc/{pid}/status") as f:
                        s = f.read()
                except OSError:
                    continue
                for key in ("RssAnon", "RssFile", "VmRSS"):
                    m = re.search(rf"{key}:\s+(\d+) kB", s)
                    if m:
                        v = int(m.group(1)) * 1024
                        if key == "RssAnon":
                            p_anon = v
                            self.sources["rss_anon"] = "status"
                        elif key == "RssFile":
                            p_file = v
                        else:
                            p_tot = v
                if p_pss is None or p_anon is None:
                    fallback = self._smaps(pid)
                    if fallback is not None:
                        if p_pss is None:
                            p_pss = fallback[0]
                            self.sources.setdefault("pss_anon", "smaps")
                        if p_anon is None:
                            p_anon = fallback[1]
                            self.sources.setdefault("rss_anon", "smaps")
                            if p_tot is not None:
                                p_file = max(0, p_tot - p_anon)
                pss += p_pss or 0
                anon += p_anon or 0
                if pid == me:
                    parent = {"anon": p_anon or 0, "pss_anon": p_pss or 0}
                filp += p_file or 0
                tot += p_tot or 0
                if p_anon and p_anon > self.peak_proc_anon:
                    try:
                        with open(f"/proc/{pid}/cmdline") as f:
                            argv = f.read().split("\0")
                    except OSError:
                        argv = []
                    self.peak_proc_anon = p_anon
                    self.peak_proc_role = " ".join(
                        a for a in argv if a)[-120:]
                    self.peak_proc_at_s = (time.perf_counter()
                                           - self._t0)
                nproc += 1
            if anon > self.peak_anon:
                self.peak_anon_at_s = time.perf_counter() - self._t0
            self.peak_anon = max(self.peak_anon, anon)
            self.peak_file = max(self.peak_file, filp)
            self.peak_total = max(self.peak_total, tot)
            self.peak_pss_anon = max(self.peak_pss_anon, pss)
            for key, total in (("anon", anon), ("pss_anon", pss)):
                self.peak_parent[key] = max(self.peak_parent[key],
                                            parent[key])
                self.peak_workers[key] = max(self.peak_workers[key],
                                             total - parent[key])
            self.trace.append((round(time.perf_counter() - self._t0, 1),
                               anon, pss, nproc))
            self._stop.wait(self.interval)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *a):
        self._stop.set()
        self._thread.join(timeout=5)


def device_label(device: str) -> str:
    """``"cpu"``, or the card's ``nvidia-smi`` name and power limit. A
    CUDA device is required for ``"cuda"``: without one this raises. It
    neither imports torch (a run with scoring off never does) nor
    touches CUDA, so a later ``-j N`` fork can still use it."""
    if device == "cpu":
        return "cpu"
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        lines = smi.stdout.strip().splitlines() if smi.returncode == 0 \
            else []
    except FileNotFoundError:
        lines = []
    if not lines:
        raise RuntimeError("no CUDA device; pass --device cpu to run device "
                           "scoring through the plain forms on the host")
    return lines[0]


def read_count_m(workload: str, reads_m: float | None) -> float:
    """Reads in millions: ``reads_m``, else the generator's log
    (``<workload>.gen.log``)."""
    if reads_m is None and os.path.exists(workload + ".gen.log"):
        with open(workload + ".gen.log") as f:
            m = re.findall(r"wrote .* \((\d+) reads", f.read())
        if m:
            reads_m = int(m[-1]) / 1e6
    if not reads_m:
        raise SystemExit("pass --reads-m (generator log not found)")
    return reads_m


def log_phases(log: str) -> dict:
    """Edges, phase-2 span and serial tail from a workflow log."""
    def stamp(pattern):
        mm = re.search(rf"\[([0-9T:.-]+)\] {pattern}", log)
        return (datetime.datetime.fromisoformat(mm.group(1))
                if mm else None)

    t_a = stamp(r"generating and scoring SV candidates")
    t_b = stamp(r"processed \d+ graph edges")
    m = re.search(r"processed (\d+) graph edges", log)
    # serial phase-boundary tail: graph merge + finalize + save +
    # phase-2 load + shard merge + final VCF sort (all single-process
    # sections)
    tail = 0.0
    for pat in (r"merged \d+ graph parts in ([0-9.]+)s",
                r"finalized in ([0-9.]+)s, saved in ([0-9.]+)s",
                r"loaded for phase 2 in ([0-9.]+)s",
                r"bin shards in ([0-9.]+)s",
                r"final VCFs in ([0-9.]+)s"):
        for mm in re.finditer(pat, log):
            tail += sum(float(g) for g in mm.groups())
    return {"edges": int(m.group(1)) if m else 0,
            "phase2_s": ((t_b - t_a).total_seconds()
                         if t_a and t_b else None),
            "serial_tail_s": tail}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Run a generated WGS-shaped workload through the port's "
                    "workflow and write the measured-run artifact")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--jobs", type=int, default=0, help="0 = all cores")
    ap.add_argument("--device-scoring", default="off",
                    choices=("off", "auto", "jump", "exact", "mxu"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reads-m", type=float, default=None,
                    help="read count in millions (from the generator "
                         "log); parsed from <workload>.gen.log if omitted")
    ap.add_argument("--tag", default="")
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    bam, fa = args.workload + ".bam", args.workload + ".fa"
    reads_m = read_count_m(args.workload, args.reads_m)
    device = device_label(args.device)

    n_jobs = args.jobs or (os.cpu_count() or 1)
    run_dir = args.run_dir or tempfile.mkdtemp(prefix="atscale_")

    from ..workflow.run import resolve_device_scoring, run_workflow
    from .device_counts import WorkflowCounts
    mode = None if args.device_scoring == "off" else args.device_scoring
    r0s = resource.getrusage(resource.RUSAGE_SELF)
    r0c = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    with RssSampler() as rss, WorkflowCounts() as counted:
        run_workflow([bam], [], fa, run_dir, n_jobs=n_jobs, verbose=True,
                     use_device_scoring=mode or False, device=args.device)
    wall = time.perf_counter() - t0
    r1s = resource.getrusage(resource.RUSAGE_SELF)
    r1c = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu_s = (r1s.ru_utime - r0s.ru_utime + r1s.ru_stime - r0s.ru_stime
             + r1c.ru_utime - r0c.ru_utime + r1c.ru_stime - r0c.ru_stime)
    peak_gb = max(r1s.ru_maxrss, r1c.ru_maxrss) / 1e6

    with open(os.path.join(run_dir, "workspace", "workflow_log.txt")) as f:
        phases = log_phases(f.read())
    edges, phase2_s, tail = (phases["edges"], phases["phase2_s"],
                             phases["serial_tail_s"])
    cpu_per_mread = (cpu_s - tail) / reads_m
    tail_per_mread = tail / reads_m

    def anon(n_bytes):
        return (round(n_bytes / 1e9, 2) if "rss_anon" in rss.sources
                else None)
    proj_min = (cpu_per_mread * WGS_READS_M / BASELINE_CORES
                + tail_per_mread * WGS_READS_M) / 60.0

    out = {
        "metric": "wgs_at_scale_measured",
        "tag": args.tag,
        "workload": args.workload,
        "reads_m": round(reads_m, 2),
        "pct_of_840m": round(100 * reads_m / WGS_READS_M, 1),
        "cores": n_jobs,
        "device_scoring": args.device_scoring,
        "device_scoring_resolved": resolve_device_scoring(mode) or "off",
        "device": device,
        "wall_s": round(wall, 1),
        "wall_min": round(wall / 60.0, 2),
        "cpu_s": round(cpu_s, 1),
        "peak_rss_gb": round(peak_gb, 2),
        # null where this host's /proc gives no such figure
        "peak_anon_gb": anon(rss.peak_anon),
        "peak_pss_anon_gb": (round(rss.peak_pss_anon / 1e9, 2)
                             if "pss_anon" in rss.sources else None),
        "peak_anon_at_s": round(rss.peak_anon_at_s, 1),
        "peak_filepages_gb": anon(rss.peak_file),
        "peak_tree_rss_gb": round(rss.peak_total / 1e9, 2),
        "peak_proc_anon_gb": anon(rss.peak_proc_anon),
        "peak_proc_at_s": round(rss.peak_proc_at_s, 1),
        "peak_proc_role": rss.peak_proc_role,
        "memory_sources": rss.sources,
        # this process (the workflow's parent) and the rest of its tree
        # (the workers), each at its own peak; null as above
        **{f"peak_{who}_{key}_gb": (round(peak[key] / 1e9, 2)
                                    if source in rss.sources else None)
           for who, peak in (("parent", rss.peak_parent),
                             ("workers", rss.peak_workers))
           for key, source in (("pss_anon", "pss_anon"),
                               ("anon", "rss_anon"))},
        "edges": edges,
        "phase2_s": round(phase2_s, 1) if phase2_s else None,
        "edges_per_s": (round(edges / phase2_s, 2)
                        if phase2_s else None),
        "serial_tail_s": round(tail, 2),
        "cpu_s_per_mread": round(cpu_per_mread, 2),
        "wgs840_20core_projection_min": round(proj_min, 2),
        "vs_baseline": round(BASELINE_WALL_MIN / proj_min, 3),
        **counted.counts(),
        "run_dir": run_dir,
        "measured_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
    }
    os.makedirs(args.results_dir, exist_ok=True)
    name = f"wgs_measured{('_' + args.tag) if args.tag else ''}.json"
    with open(os.path.join(args.results_dir, name), "w") as f:
        json.dump(out, f, indent=1)
    with open(os.path.join(args.results_dir,
                           name.replace(".json", ".memtrace.json")),
              "w") as f:
        json.dump({"columns": ["t_s", "rss_anon_sum", "pss_anon_sum",
                               "nproc"], "rows": rss.trace}, f)
    print(json.dumps(out), flush=True)
    if not args.keep and args.run_dir is None:
        import shutil
        shutil.rmtree(run_dir, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
