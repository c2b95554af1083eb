"""Adversarial repeat benchmark at statistical power (round-5 verdict
item 5): >=100 repeat-proximal planted SVs across >=3 seeds.

Per seed: generate a --repeats WGS workload with --repeat-anchors SV
junctions planted inside satellite arrays (plus the read-level
mapper-confusion model), run the germline workflow, and score against
truth split by repeat proximity. Aggregates recall with Wilson 95%
intervals and the complexity-abort telemetry, and writes
repeats_check_<tag>.json under --results-dir.

Usage:
  python -m manta_tpu_torch.tools.bench_repeats [--seeds 3 5 7]
      [--anchors 40] [--chroms 8] [--mb 16] [--jobs 2] [--keep]
      [--device cuda|cpu] [--device-scoring auto|off|jump|exact|mxu]
      [--work-dir W] [--results-dir R] [--reuse]

Twin of benchmarks/bench_repeats.py on the port: the same Wilson
intervals, per-seed records and aggregate keys. Each seed's generation
(``tools.wgs_workload --repeats``) and truth check (``tools.wgs_workload
--check``) run as child processes that cannot import jax, jaxlib or
manta_tpu. ``--device-scoring auto`` (the default) is the original's
behaviour: the checker runs the workflow with its default scoring,
contig jump scoring on a card (off without one). Any other mode (and
``auto`` with ``--device cpu``) first runs the port's workflow in that
mode, on ``--device``, into the seed's run directory, in a child of its
own; the checker then resumes that finished run and only scores it. Each record
and the aggregate add ``device``, ``device_scoring`` and
``device_scoring_resolved``, and each record the device work of every
process of its seed (``tools.device_counts``): K1 launches for contig
jump scoring, K3 launches for the exact split scan.
``gen_plus_check_s`` is the seed's wall: generation, workflow and check.

``--device cuda`` (the default) needs a CUDA device and raises without
one; ``--device cpu`` runs device scoring through the plain PyTorch
forms on the host. Workloads and run directories go under
``--work-dir`` (default ``.testdata/repeats_torch/``, which git
ignores) and are removed unless ``--keep``; with ``--reuse`` a seed
whose workload a kept run left there (its ``.gen.log``) is not
generated again. The aggregate goes to ``--results-dir`` (default
``results_torch/``), never under benchmarks/.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

from .bench_wgs_at_scale import RESULTS_DIR, device_label
from .device_counts import parse_lines

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORK_DIR = os.path.join(REPO, ".testdata", "repeats_torch")

# prepended to the code of every child process: jax, jaxlib and
# manta_tpu cannot be imported there, so a child that reaches them fails
_GUARD = """\
import sys


class _RefuseJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "manta_tpu"):
            raise ModuleNotFoundError(f"refused in a bench_repeats child: "
                                      f"{name}")


sys.meta_path.insert(0, _RefuseJax())
"""

# the workflow in one device-scoring mode, on one torch device
_WORKFLOW = """
bam, fa, run_dir, jobs, mode, device = sys.argv[1:7]
from manta_tpu_torch import native_core
native_core.load()
from manta_tpu_torch.workflow.run import run_workflow
run_workflow([bam], [], fa, run_dir, n_jobs=int(jobs), verbose=True,
             use_device_scoring=False if mode == "off" else mode,
             device=device)
"""

# what a per-seed record holds beyond the original's: where it ran, and
# the device work of the seed's processes
DEVICE_KEYS = ("device", "device_scoring", "device_scoring_resolved",
               *parse_lines(""))
# the keys of a record that change from run to run: walls, memory, paths
RUN_KEYS = ("wall_s", "peak_rss_gb", "run_dir", "gen_plus_check_s")


def wilson(k: int, n: int, z: float = 1.96):
    if n == 0:
        return (0.0, 0.0, 1.0)
    p = k / n
    d = 1 + z * z / n
    c = (p + z * z / (2 * n)) / d
    h = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / d
    return (round(p, 4), round(max(0.0, c - h), 4),
            round(min(1.0, c + h), 4))


def run_child(argv) -> subprocess.CompletedProcess:
    """``python <argv>`` (``-m module args`` or ``-c code args``) from
    the checkout's root behind the guard; raises with its stderr's tail
    if it fails."""
    kind, what, *rest = argv
    code = _GUARD + (what if kind == "-c" else
                     "import runpy\n"
                     f"runpy.run_module({what!r}, run_name='__main__', "
                     "alter_sys=True)\n")
    proc = subprocess.run([sys.executable, "-c", code, *rest],
                          capture_output=True, text=True, cwd=REPO)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(argv[:2])} failed "
                           f"({proc.returncode}):\n{proc.stderr[-3000:]}")
    return proc


def _log(msg: str) -> None:
    print(f"[bench_repeats] {msg}", file=sys.stderr, flush=True)


def run_seed(seed: int, args) -> dict:
    out = os.path.join(args.work_dir, f"reps_s{seed}")
    run_dir = f"{out}.run_{args.device_scoring}"
    shutil.rmtree(run_dir, ignore_errors=True)
    mod = "manta_tpu_torch.tools.wgs_workload"
    t0 = time.time()
    if args.reuse and os.path.exists(out + ".gen.log"):
        _log(f"seed {seed}: reusing the workload at {out}")
    else:
        gen = run_child(
            ["-m", mod, "--out", out, "--chroms", str(args.chroms), "--mb",
             str(args.mb), "--depth", "35", "--seed", str(seed),
             "--repeats", "--repeat-anchors", str(args.anchors),
             "--jobs", str(args.jobs)])
        with open(out + ".gen.log", "w") as f:
            f.write(gen.stdout)
        _log(f"seed {seed}: generated in {time.time() - t0:.1f} s: "
             f"{gen.stdout.strip().splitlines()[-1]}")
    logs = ""
    mode = args.device_scoring_resolved
    if args.device_scoring != "auto" or args.device != "cuda":
        t1 = time.time()
        logs += run_child(["-c", _WORKFLOW, out + ".bam", out + ".fa",
                           run_dir, str(args.jobs), mode,
                           args.device]).stderr
        _log(f"seed {seed}: workflow ({mode}, {args.device}) in "
             f"{time.time() - t1:.1f} s")
    t1 = time.time()
    chk = run_child(["-m", mod, "--out", out, "--check", "--jobs",
                     str(args.jobs), "--run-dir", run_dir])
    logs += chk.stderr
    _log(f"seed {seed}: check in {time.time() - t1:.1f} s")
    rec = json.loads(chk.stdout.strip().splitlines()[-1])
    rec["seed"] = seed
    rec["gen_plus_check_s"] = round(time.time() - t0, 1)
    rec.update(device=args.device_label,
               device_scoring=args.device_scoring,
               device_scoring_resolved=mode, **parse_lines(logs))
    if not args.keep:
        run_dir = rec.get("run_dir")
        if run_dir and os.path.isdir(run_dir):
            shutil.rmtree(run_dir, ignore_errors=True)
        for suf in (".bam", ".bam.bai", ".fa", ".fa.fai", ".truth.tsv",
                    ".repeats.tsv", ".gen.log"):
            p = out + suf
            if os.path.exists(p):
                os.remove(p)
    return rec


def aggregate(seeds: list[dict], args) -> dict:
    """The original's aggregate over the per-seed records ``seeds``."""
    rep_k = rep_n = clean_k = clean_n = fp = 0
    ins_k = ins_n = edge_k = edge_n = 0
    aborts = 0
    for rec in seeds:
        n_rep = rec["truth_in_repeat"]
        rep_n += n_rep
        rep_k += round(rec["recall_in_repeat"] * n_rep)
        n_clean = rec["truth_n"] - n_rep
        clean_n += n_clean
        clean_k += round(rec["recall_clean"] * n_clean)
        ins_n += rec.get("truth_inside_tandem", 0)
        ins_k += round(rec.get("recall_inside_tandem", 0)
                       * rec.get("truth_inside_tandem", 0))
        edge_n += rec.get("truth_repeat_edge", 0)
        edge_k += round(rec.get("recall_repeat_edge", 0)
                        * rec.get("truth_repeat_edge", 0))
        fp += rec["fp_records"]
        aborts += int(bool(rec.get("graph_abort_count_hit"))
                      or bool(rec.get("graph_abort_density_hit")))

    p, lo, hi = wilson(rep_k, rep_n)
    cp, clo, chi = wilson(clean_k, clean_n)
    return {
        "metric": "repeats_recall_powered",
        "seeds": args.seeds,
        "anchors_per_seed": args.anchors,
        "repeat_proximal": {"found": rep_k, "n": rep_n,
                            "recall": p, "ci95": [lo, hi]},
        "inside_tandem": {"found": ins_k, "n": ins_n,
                          "recall": wilson(ins_k, ins_n)[0],
                          "ci95": list(wilson(ins_k, ins_n)[1:])},
        "repeat_edge": {"found": edge_k, "n": edge_n,
                        "recall": wilson(edge_k, edge_n)[0],
                        "ci95": list(wilson(edge_k, edge_n)[1:])},
        "clean": {"found": clean_k, "n": clean_n,
                  "recall": cp, "ci95": [clo, chi]},
        "fp_records_total": fp,
        "runs_with_complexity_abort": aborts,
        "per_seed": seeds,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Repeat-proximal recall with Wilson 95% intervals over "
                    "seeds of adversarial repeat workloads")
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 5, 7])
    ap.add_argument("--anchors", type=int, default=40)
    ap.add_argument("--chroms", type=int, default=8)
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--tag", default="r05")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--device-scoring", default="auto",
                    choices=("auto", "off", "jump", "exact", "mxu"))
    ap.add_argument("--work-dir", default=WORK_DIR)
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    ap.add_argument("--reuse", action="store_true",
                    help="take a seed's workload from --work-dir where a "
                         "kept run left one")
    args = ap.parse_args(argv)
    args.device_label = device_label(args.device)
    from ..workflow.run import resolve_device_scoring
    args.device_scoring_resolved = resolve_device_scoring(
        args.device_scoring) or "off"
    args.work_dir = os.path.abspath(args.work_dir)
    os.makedirs(args.work_dir, exist_ok=True)

    seeds = []
    for seed in args.seeds:
        rec = run_seed(seed, args)
        print(json.dumps(rec), flush=True)
        seeds.append(rec)

    out = aggregate(seeds, args)
    out.update(device=args.device_label,
               device_scoring=args.device_scoring,
               device_scoring_resolved=args.device_scoring_resolved)
    os.makedirs(args.results_dir, exist_ok=True)
    res = os.path.join(args.results_dir, f"repeats_check_{args.tag}.json")
    with open(res, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "per_seed"}),
          flush=True)
    return out


if __name__ == "__main__":
    main()
