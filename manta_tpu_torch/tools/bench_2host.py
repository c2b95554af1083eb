"""Two-host division-of-work accounting on a WGS-shaped workload.

    python -m manta_tpu_torch.tools.bench_2host --workload P [--jobs 2]
        [--results-dir D] [--keep]

Twin of benchmarks/bench_2host.py on the port's parallel/distributed:
the two-host flow (host 0's bootstrap of phases 0-1 on a shared run
directory, each host's slice of the phase-2 bins, host 0's ordered
reduce) runs stage by stage, each stage in a process of its own (clean
rusage separation; still one after another on one machine), and the
CPU seconds of the stages are held against a fresh single-host run of
the same workload: ``overhead_pct`` is the CPU the split costs (duplicate
planning, per-host stats, shard merge). ``vcf_parity``: the merged
diploid VCF body equals the single host's.

Every stage scores on the host (``use_device_scoring=False``, as the
original's phase-2 stages): the tool touches no device. ``P`` is a
prefix of ``tools.wgs_workload``'s output. One JSON line; also written
to ``2host_accounting.json`` under ``--results-dir`` (default
``results_torch/`` at the repo root).
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS_DIR = os.path.join(REPO, "results_torch")

_CHILD = r"""
import json, os, re, resource, sys, time
sys.path.insert(0, {repo!r})
t0 = time.perf_counter()
{body}
wall = time.perf_counter() - t0
ru_s = resource.getrusage(resource.RUSAGE_SELF)
ru_c = resource.getrusage(resource.RUSAGE_CHILDREN)
cpu = ru_s.ru_utime + ru_s.ru_stime + ru_c.ru_utime + ru_c.ru_stime
peak = max(ru_s.ru_maxrss, ru_c.ru_maxrss) / 1e6
print("CHILD_JSON " + json.dumps(
    dict(wall_s=round(wall, 2), cpu_s=round(cpu, 1),
         peak_rss_gb=round(peak, 2), **extra)))
"""


def run_child(body: str) -> dict:
    code = _CHILD.format(repo=REPO, body=body)
    p = subprocess.run([sys.executable, "-c", code],
                       capture_output=True, text=True)
    if p.returncode != 0:
        sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
        raise RuntimeError("child failed")
    m = re.search(r"CHILD_JSON (.*)", p.stdout)
    out = json.loads(m.group(1))
    # the workflow's verbose log lines go to stderr; the edge count of a
    # host's phase 2 is read there
    out["log"] = p.stdout + p.stderr
    return out


def edges_from_log(run_dir: str) -> int:
    with open(os.path.join(run_dir, "workspace", "workflow_log.txt")) as f:
        mm = re.findall(r"processed (\d+) graph edges", f.read())
    return int(mm[-1]) if mm else 0


def _body(run_dir: str) -> list[str]:
    path = os.path.join(run_dir, "results", "variants", "diploidSV.vcf.gz")
    with gzip.open(path, "rt") as f:
        return [ln for ln in f if not ln.startswith("#")]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Two-host flow against one host on one workload")
    ap.add_argument("--workload", required=True,
                    help="prefix of tools.wgs_workload outputs (.bam/.fa)")
    ap.add_argument("--jobs", type=int, default=2,
                    help="worker processes per host")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    bam, fa = args.workload + ".bam", args.workload + ".fa"
    for path in (bam, fa):
        if not os.path.exists(path):
            raise FileNotFoundError(path)

    d2 = tempfile.mkdtemp(prefix="h2_")
    d1 = tempfile.mkdtemp(prefix="h1_")
    res = {"metric": "2host_accounting", "workload": args.workload,
           "jobs_per_host": args.jobs}
    dist = "from manta_tpu_torch.parallel.distributed import "

    # ---- 2-host flow: bootstrap (host 0), phase 2 per host, finalize
    boot = run_child(f"""
{dist}bootstrap_shared_run
bootstrap_shared_run([{bam!r}], [], {fa!r}, {d2!r},
                     n_jobs={args.jobs}, verbose=False,
                     use_device_scoring=False)
extra = dict(stage="bootstrap")
""")
    res["bootstrap"] = {k: boot[k] for k in ("wall_s", "cpu_s",
                                             "peak_rss_gb")}

    per_host = []
    for h in (0, 1):
        r = run_child(f"""
{dist}run_host_phase2
run_host_phase2({h}, 2, [{bam!r}], [], {fa!r}, {d2!r},
                n_jobs={args.jobs}, verbose=True,
                use_device_scoring=False)
extra = dict(stage="host{h}")
""")
        m = re.findall(r"host processed (\d+) graph edges", r["log"])
        edges = int(m[-1]) if m else 0
        per_host.append({"host": h, "wall_s": r["wall_s"],
                         "cpu_s": r["cpu_s"], "edges": edges,
                         "edges_per_cpu_s": round(
                             edges / max(r["cpu_s"], 1e-9), 2)})
    res["hosts"] = per_host

    fin = run_child(f"""
{dist}finalize_phase2
finalize_phase2(2, [{bam!r}], [], {fa!r}, {d2!r},
                n_jobs={args.jobs}, verbose=False,
                use_device_scoring=False)
extra = dict(stage="finalize")
""")
    res["finalize"] = {k: fin[k] for k in ("wall_s", "cpu_s",
                                           "peak_rss_gb")}

    # ---- single-host baseline, same workload and jobs
    single = run_child(f"""
from manta_tpu_torch.workflow.run import run_workflow
run_workflow([{bam!r}], [], {fa!r}, {d1!r}, n_jobs={args.jobs},
             verbose=False, use_device_scoring=False)
extra = dict(stage="single")
""")
    res["single_host"] = {
        "wall_s": single["wall_s"], "cpu_s": single["cpu_s"],
        "peak_rss_gb": single["peak_rss_gb"],
        "edges": edges_from_log(d1),
    }

    cpu_2host = (boot["cpu_s"] + sum(h["cpu_s"] for h in per_host)
                 + fin["cpu_s"])
    res["cpu_s_2host_total"] = round(cpu_2host, 1)
    res["overhead_pct"] = round(
        100.0 * (cpu_2host - single["cpu_s"]) / single["cpu_s"], 2)
    res["edges_total"] = sum(h["edges"] for h in per_host)
    # byte parity of the final VCF bodies
    res["vcf_parity"] = _body(d1) == _body(d2)

    if not args.keep:
        shutil.rmtree(d1, ignore_errors=True)
        shutil.rmtree(d2, ignore_errors=True)
    os.makedirs(args.results_dir, exist_ok=True)
    with open(os.path.join(args.results_dir, "2host_accounting.json"),
              "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
