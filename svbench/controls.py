"""The controls and planted faults that show each number of the check can
fail. Not part of any benchmark run: run by hand on the card, at the
cell's own size, to read the upper end of each limit, and at a small
size on the CPU by ``svbench/tests/test_svbench_faults.py``.

    python3 svbench/controls.py --workload <cell> --what <name> \\
        --seed <n> [--seed <n> ...] [--seconds 1]

``--what``:

- ``k1_bounded``: the control of K1: in place of the program's K1
  results, the plain reference with its insertion chain bounded to 2^3
  lanes (the port's K2 at K = 3, the approximation a faster contig scorer
  would take);
- ``k3_mxu``: the control of K3: the program's own approximate split
  scan (``--device-scoring mxu``, the matmul form) in place of the exact
  one;
- ``unchanged``: a fault: the workflow returns at once and writes
  nothing (a step that leaves its state unchanged);
- ``half_edges``: a fault: phase 2 scores every other graph edge only
  (half of the batch left out);
- ``k1_answer``, ``k3_answer``: faults: one score of each K1 or K3 call
  altered where the seam returns it.

Each seed is one whole run (``svbench/run.py``'s ``main``) in a process
of its own; its result line is printed as usual.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from svbench import run  # noqa: E402


def _unchanged(wf):
    inner = wf.run_workflow

    def run_workflow(normal_bams, tumor_bams, reference, run_dir, **kw):
        return run_dir
    wf.run_workflow = run_workflow
    return lambda: setattr(wf, "run_workflow", inner)


def _half_edges(wf):
    inner = wf._run_edges_parallel

    def half(all_edges, *a, **kw):
        return inner(all_edges[::2], *a, **kw)
    wf._run_edges_parallel = half
    return lambda: setattr(wf, "_run_edges_parallel", inner)


def _k3_answer(wf):
    from manta_tpu_torch.scoring import device_scan
    inner = device_scan.DeviceScanContext.scan_multi

    def scan_multi(self, *a, **kw):
        best, pos = inner(self, *a, **kw)
        best = best.copy()
        best.flat[0] += 1.0
        return best, pos
    device_scan.DeviceScanContext.scan_multi = scan_multi
    return lambda: setattr(device_scan.DeviceScanContext, "scan_multi",
                           inner)


def _k1_answer(wf):
    from manta_tpu_torch.align import device_jumpscore
    inner = device_jumpscore.make_bucketed_scorer

    def make_bucketed_scorer(*a, **kw):
        scorer = inner(*a, **kw)

        def altered(jobs):
            res = scorer(jobs).copy()
            res[0] += 1
            return res
        return altered
    device_jumpscore.make_bucketed_scorer = make_bucketed_scorer
    return lambda: setattr(device_jumpscore, "make_bucketed_scorer", inner)


CONTROLS = {
    "k1_bounded": {"k1_rounds": 3},
    "k3_mxu": {"mode": "mxu"},
    "unchanged": {"hook": _unchanged},
    "half_edges": {"hook": _half_edges},
    "k1_answer": {"hook": _k1_answer},
    "k3_answer": {"hook": _k3_answer},
}


def main(argv=None, extra: dict | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", required=True, choices=sorted(CONTROLS))
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if len(args.seed) > 1:
        rc = 0
        for seed in args.seed:
            rc |= subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--workload",
                 args.workload, "--what", args.what, "--seed", str(seed),
                 "--seconds", str(args.seconds)]).returncode
        return rc
    control = dict(CONTROLS[args.what], **(extra or {}))
    print(f"[svbench] {args.what} seed {args.seed[0]}", file=sys.stderr,
          flush=True)
    return run.main(["--workload", args.workload, "--seed",
                     str(args.seed[0]), "--seconds", str(args.seconds)],
                    control=control)


if __name__ == "__main__":
    sys.exit(main())
