"""One run of one benchmark cell of manta_tpu_torch on the card.

    python3 svbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration (``svbench/configs/<config>.json``) and its
traffic (``svbench/traffic/<traffic>.json``) are found by name through
``BENCHMARK.json``; each metric is computed by ``svbench/metrics/
<metric>.py``. A run:

1. Set-up: generates the seed's sample with the benchmark's frozen
   generator into ``svbench/cache/`` (or reads it from there), imports
   the port and builds or loads its native and CUDA libraries (under the
   checkout's ``manta_tpu_torch/build/``). No CUDA context is made here:
   the workflow forks its workers later. ``setup_s`` runs from the start
   of this script to the first sample.
2. The window: whole samples through ``workflow.run.run_workflow`` at the
   configuration's ``-j``, one after the other, until ``--seconds`` have
   passed; the sample then running finishes. The seams to K1 and K3 keep
   what they returned (``svbench/capture.py``).
3. With ``--trace 1``, one more sample with every phase-2 worker tracing
   the card (``parallel.worker_trace``), for the device metrics; the
   walls come from the window's untraced samples.
4. The check: the window's calls against the planted truth, and the kept
   K1 and K3 results against the plain references
   (``svbench/reference.py``), each number beside its limit, last on
   stderr; then one JSON line on stdout.

It exits 2, printing no result, without a CUDA card or with fewer than
the cell asks for, and 3 if ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import atexit  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import zlib  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from svbench import (  # noqa: E402
    capture, intervals, logs, reference, truth)
from svbench.workload import generate  # noqa: E402  (its signature)

CACHE = os.path.join(HERE, "cache")
RUNS = os.path.join(HERE, "runs")
FORBIDDEN = ("jax", "jaxlib", "flax", "manta_tpu")
# the port's sub-packages a workflow imports on its way; imported in
# set-up so that no sample pays their import
PORT_PACKAGES = ("align", "assembly", "candidates", "core", "format",
                 "graph", "io", "scan", "scoring", "workflow")
K1_CALLS_CHECKED = 16
K3_CALLS_CHECKED = 48


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(name: str) -> tuple[dict, dict, dict, dict]:
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(HERE, "configs", f"{cell['config']}.json")
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


# ------------------------------------------------------------ set-up

def sample_inputs(config: dict, traffic: dict, seed: int) -> dict:
    """The seed's sample, generated into the cache unless it is there.
    Generating a seed removes the other seeds of the same parameters."""
    keys = inspect.signature(generate).parameters
    params = {k: v for k, v in config.items()
              if k in keys and k not in ("out", "seed", "log")}
    params.update(traffic.get("generator", {}))
    key = json.dumps(params, sort_keys=True)
    tag = f"{config['name']}-{zlib_hex(key)}"
    base = os.path.join(CACHE, tag)
    here = os.path.join(base, f"seed{seed}")
    done = os.path.join(here, "done.json")
    if not os.path.exists(done):
        if os.path.isdir(base):
            shutil.rmtree(base)
        os.makedirs(here)
        t0 = time.perf_counter()
        out = _generate_apart(os.path.join(here, "sample"), seed, params)
        with open(done, "w") as f:
            json.dump({"bams": [os.path.basename(b) for b in out["bams"]],
                       "reads": out["reads"],
                       "generation_s": time.perf_counter() - t0}, f)
        generated_s = load_json(done)["generation_s"]
    else:
        generated_s = 0.0
    info = load_json(done)
    return {"bams": [os.path.join(here, b) for b in info["bams"]],
            "reads": info["reads"], "generated_s": generated_s,
            "fasta": os.path.join(here, "sample.fa"),
            "truth": os.path.join(here, "sample.truth.tsv")}


def _generate_apart(out: str, seed: int, params: dict) -> dict:
    """``workload.generate`` in a process of its own: its gigabytes of
    records are freed with it, and the process that forks every sample
    stays as small as set-up leaves it. The files are synced to disk
    before it returns, so that no write-back runs under the first sample.
    Its log goes to this stderr."""
    code = ("import json, os, sys; sys.path.insert(0, sys.argv[1]); "
            "from svbench.workload import generate; "
            "a = json.loads(sys.argv[2]); "
            "r = generate(a['out'], seed=a['seed'], "
            "log=lambda m: print('[svbench] ' + m, file=sys.stderr, "
            "flush=True), **a['params']); os.sync(); print(json.dumps(r))")
    res = subprocess.run(
        [sys.executable, "-c", code, ROOT,
         json.dumps({"out": out, "seed": seed, "params": params})],
        stdout=subprocess.PIPE, text=True, check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


def zlib_hex(text: str) -> str:
    return f"{zlib.crc32(text.encode()):08x}"


def import_port(mode: str, on_card: bool = True):
    """Import the port's workflow and everything it loads on its way,
    build or load its native core and the CUDA libraries ``mode`` runs
    (``on_card``). Returns (workflow.run module, resolved mode)."""
    import pkgutil

    import manta_tpu_torch
    for pkg in PORT_PACKAGES:
        mod = importlib.import_module(f"manta_tpu_torch.{pkg}")
        for info in pkgutil.walk_packages(mod.__path__, mod.__name__ + "."):
            importlib.import_module(info.name)
    importlib.import_module("manta_tpu_torch.parallel.worker_trace")
    from manta_tpu_torch import native_core
    from manta_tpu_torch.workflow import run as wf
    native_core.load()
    resolved = wf.resolve_device_scoring(mode)
    if resolved is not None and on_card:
        wf.build_kernels(resolved)
    del manta_tpu_torch
    return wf, resolved


# ------------------------------------------------------------ samples

def run_sample(wf, inputs: dict, config: dict, mode: str, run_dir: str,
               device=None) -> dict:
    """One whole sample through ``run_workflow``, in a process forked for
    it from the set-up, so that every sample starts from the same state
    (the port keeps process-wide caches of decompressed BAM blocks that a
    second sample in one process would find full). Its stderr, with the
    workers' exit lines, goes to ``run_dir + '.stderr'``."""
    if os.path.exists(run_dir):
        shutil.rmtree(run_dir)
    err_path = run_dir + ".stderr"
    sys.stderr.flush()
    sys.stdout.flush()
    t0 = time.perf_counter()
    pid = os.fork()
    if pid == 0:                        # the sample's process
        code = 0
        try:
            fd = os.open(err_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                         0o644)
            os.dup2(fd, 2)
            os.close(fd)
            wf.run_workflow(inputs["bams"], [], inputs["fasta"], run_dir,
                            n_jobs=config["workflow"]["jobs"],
                            scan_size_mb=config["workflow"]["scan_size_mb"],
                            use_device_scoring=mode, verbose=False,
                            device=device)
        except BaseException:           # reported through the exit code
            import traceback
            traceback.print_exc()
            code = 1
        finally:
            try:
                sys.stderr.flush()
                atexit._run_exitfuncs()
            finally:
                os._exit(code)
    _, status = os.waitpid(pid, 0)
    wall = time.perf_counter() - t0
    code = os.waitstatus_to_exitcode(status)
    error = None if code == 0 else f"the sample's process exited {code}"
    return {"run_dir": run_dir, "wall_s": wall, "error": error,
            "reads": sum(inputs["reads"])}


def read_sample(s: dict, truth_events: list, tolerance: int) -> None:
    """Read a finished sample's log, exit lines and calls into ``s``,
    then delete its run directory."""
    with open(s["run_dir"] + ".stderr", errors="replace") as f:
        err = f.read()
    s["exit"] = logs.exit_lines(err)
    log_path = os.path.join(s["run_dir"], "workspace", "workflow_log.txt")
    vcf = os.path.join(s["run_dir"], "results", "variants",
                       "diploidSV.vcf.gz")
    s["phases"] = (logs.phases(open(log_path).read())
                   if os.path.exists(log_path) else {})
    if s["error"] is None and os.path.exists(vcf):
        s["calls"] = truth.score(truth_events, truth.read_vcf(vcf),
                                 tolerance)
    else:
        s["calls"] = None
        s["error"] = s["error"] or "no diploidSV.vcf.gz"
        s["stderr_tail"] = err[-2000:]
    shutil.rmtree(s["run_dir"], ignore_errors=True)
    os.remove(s["run_dir"] + ".stderr")


def read_worker_traces(directory: str) -> list[dict]:
    out = []
    for name in sorted(os.listdir(directory)):
        if name.startswith("device_trace.") and name.endswith(".json"):
            out.append(load_json(directory, name))
    return out


# ------------------------------------------------------------ the check

def check_kernels(capture_dir: str, seed: int, config: dict,
                  k1_rounds: int = 0) -> dict:
    """The kept K1 and K3 results against the plain references, on a
    draw of the kept calls by the seed. ``k1_rounds`` > 0: the control,
    the reference with a bounded insertion chain in place of the
    program's K1 results."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {}
    a = config["aligner"]
    k1 = capture.load(capture_dir, "k1")
    if k1:
        k1.sort(key=lambda c: (c["q"].tobytes(), c["r1"].tobytes()))
        pick = sorted(rng.choice(len(k1), min(len(k1), K1_CALLS_CHECKED),
                                 replace=False).tolist())
        bad = jobs = 0
        for i in pick:
            c = k1[i]
            job_list = list(zip(capture.split(c["q"], c["ql"]),
                                capture.split(c["r1"], c["r1l"]),
                                capture.split(c["r2"], c["r2l"])))
            args = (a["match"], a["mismatch"], a["open"], a["extend"],
                    a["off_edge"], a["jump_score"])
            want = reference.jump_scores(job_list, *args)
            got = (reference.jump_scores(job_list, *args, rounds=k1_rounds)
                   if k1_rounds else c["out"])
            bad += int((np.asarray(got) != want).sum())
            jobs += len(job_list)
        out["k1_calls_kept"] = len(k1)
        out["k1_jobs_compared"] = jobs
        out["k1_mismatched_jobs"] = bad
    k3 = capture.load(capture_dir, "k3")
    if k3:
        k3.sort(key=lambda c: (c["reads"].tobytes(), c["targets"].tobytes()))
        pick = sorted(rng.choice(len(k3), min(len(k3), K3_CALLS_CHECKED),
                                 replace=False).tolist())
        bad = pairs = 0
        for i in pick:
            c = k3[i]
            rl = c["read_len"]
            n, L = len(rl), int(rl.max())
            reads = np.full((n, L), 0xFF, np.uint8)
            quals = np.zeros((n, L), np.uint8)
            off = np.concatenate([[0], np.cumsum(rl)])
            for r in range(n):
                reads[r, :rl[r]] = c["reads"][off[r]:off[r + 1]]
                quals[r, :rl[r]] = c["quals"][off[r]:off[r + 1]]
            targets = [np.frombuffer(t, np.uint8) for t in
                       capture.split(c["targets"], c["target_len"])]
            best, pos = reference.split_scan(
                reads, quals, rl, targets, [tuple(b) for b in c["bp"]],
                int(c["flank"]), float(c["snp"]))
            same = ((best.view(np.int32) == c["best"].view(np.int32))
                    & (pos == c["pos"]))
            bad += int((~same).sum())
            pairs += same.size
        out["k3_calls_kept"] = len(k3)
        out["k3_pairs_compared"] = pairs
        out["k3_mismatched_pairs"] = bad
    return out


def calls_summary(samples: list[dict]) -> dict | None:
    """Recall, precision and F1 pooled over the window's samples."""
    scored = [s["calls"] for s in samples if s.get("calls")]
    if not scored or len(scored) < len(samples):
        return None
    t = sum(c["truth"] for c in scored)
    found = sum(c["found"] for c in scored)
    recs = sum(c["records"] for c in scored)
    fp = sum(c["fp"] for c in scored)
    recall = found / t if t else 0.0
    precision = (recs - fp) / recs if recs else 0.0
    f1 = (2 * recall * precision / (recall + precision)
          if recall + precision else 0.0)
    return {"recall": recall, "precision": precision, "f1": f1,
            "fp": fp, "truth": t, "found": found}


# ------------------------------------------------------------ metrics

def metric_names(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: those that list the cell, or list no cells and move an
    end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def read_metric(name: str, run: dict):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"svbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def breakdown(armed: dict) -> dict:
    """The traced sample's device operations that took most time, by
    name, and its longest idle gaps, by the phase the host was in."""
    events = [e for w in armed["workers"] for e in (w.get("events") or [])]
    by_name: dict[str, float] = {}
    for name, _t, d in events:
        by_name[name] = by_name.get(name, 0.0) + d / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = intervals.idle_gaps(events, armed["start_s"], armed["end_s"],
                               armed["phases"])
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps[:10]]}


# ------------------------------------------------------------ main

def run_window(wf, inputs, config, mode, device, cell_runs, seconds):
    """Whole samples back to back until ``seconds`` have passed; the
    sample then running finishes. Returns (samples, window wall, CPU
    seconds of this process and its reaped children)."""
    samples = []
    ru0 = (resource.getrusage(resource.RUSAGE_SELF),
           resource.getrusage(resource.RUSAGE_CHILDREN))
    t_start = time.perf_counter()
    while True:
        samples.append(run_sample(
            wf, inputs, config, mode,
            os.path.join(cell_runs, f"sample{len(samples)}"), device))
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    ru1 = (resource.getrusage(resource.RUSAGE_SELF),
           resource.getrusage(resource.RUSAGE_CHILDREN))
    cpu_s = sum(b.ru_utime + b.ru_stime - a.ru_utime - a.ru_stime
                for a, b in zip(ru0, ru1))
    return samples, window_s, cpu_s


def run_traced(wf, inputs, config, mode, device, cell_runs, truth_events):
    """One more sample with every phase-2 worker tracing the card."""
    from manta_tpu_torch.parallel import worker_trace
    trace_dir = os.path.join(cell_runs, "trace")
    os.makedirs(trace_dir)
    worker_trace.arm(trace_dir)
    start_s = time.time()
    s = run_sample(wf, inputs, config, mode,
                   os.path.join(cell_runs, "armed"), device)
    end_s = time.time()
    worker_trace.disarm()
    read_sample(s, truth_events, config["tolerance"])
    return {"wall_s": s["wall_s"], "start_s": start_s, "end_s": end_s,
            "phases": s["phases"], "error": s["error"],
            "workers": read_worker_traces(trace_dir)}


def judge(samples, checks, config, resolved) -> dict:
    """Each number compared, with its limit: the calls' F1 shortfall,
    and the kernels' mismatches where the mode runs them (None where
    nothing was kept to compare, which fails)."""
    calls = calls_summary(samples)
    numbers = {"call_f1_shortfall": (
        1.0 - calls["f1"] if calls else 1.0,
        config["limits"]["call_f1_shortfall"])}
    if resolved in ("jump", "exact", "mxu"):
        numbers["k1_mismatched_jobs"] = (
            checks.get("k1_mismatched_jobs")
            if checks.get("k1_jobs_compared") else None, 0)
    if resolved in ("exact", "mxu"):
        numbers["k3_mismatched_pairs"] = (
            checks.get("k3_mismatched_pairs")
            if checks.get("k3_pairs_compared") else None, 0)
    return numbers


def main(argv=None, control: dict | None = None) -> int:
    """``control``: for the control and fault runs of ``svbench/
    controls.py`` and the CPU tests only (None in every benchmark run):
    ``mode`` and ``device`` in place of the traffic's, ``no_card_check``,
    ``hook`` (a function of the workflow module that breaks it and
    returns its undo), ``k1_rounds``, ``k3_every``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    control = control or {}
    bench, cell, config, traffic = cell_spec(args.workload)

    def say(msg):
        print(f"[svbench] {msg}", file=sys.stderr, flush=True)

    # the card, asked through NVML so that no CUDA context exists before
    # the workflow forks its workers
    os.environ["PYTORCH_NVML_BASED_CUDA_CHECK"] = "1"
    import torch
    if not control.get("no_card_check") and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        say(f"needs {cell['chips']} CUDA device(s); torch.cuda."
            f"is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 2
    mode = control.get("mode", traffic["device_scoring"])
    device = control.get("device")
    on_card = device is None

    # ---- set-up
    inputs = sample_inputs(config, traffic, args.seed)
    say(f"sample: {sum(inputs['reads'])} reads in {len(inputs['bams'])} "
        f"BAM(s); generated in {inputs['generated_s']:.3f} s")
    wf, resolved = import_port(mode, on_card)
    truth_events = truth.read_truth(inputs["truth"])
    cell_runs = os.path.join(RUNS, cell["name"])
    shutil.rmtree(cell_runs, ignore_errors=True)
    cap_dir = os.path.join(cell_runs, "capture")
    os.makedirs(cap_dir)
    with contextlib.ExitStack() as stack:
        if control.get("hook"):
            stack.callback(control["hook"](wf))
        uncapture = capture.install(
            cap_dir, args.seed,
            k3_every=control.get("k3_every", capture.K3_EVERY))
        stack.callback(uncapture)
        if on_card:
            from svbench.device import MemorySampler, Nvml
            sampler = stack.enter_context(MemorySampler())
        setup_s = time.perf_counter() - T0
        say(f"set-up {setup_s:.3f} s (mode {mode} -> {resolved})")

        # ---- the window, then the traced sample
        samples, window_s, cpu_s = run_window(
            wf, inputs, config, mode, device, cell_runs, args.seconds)
        uncapture()
        say(f"window {window_s:.3f} s: {len(samples)} sample(s), walls "
            + ", ".join(f"{s['wall_s']:.3f}" for s in samples) + " s")
        armed = None
        if args.trace:
            armed = run_traced(wf, inputs, config, mode, device, cell_runs,
                               truth_events)
            say(f"traced sample {armed['wall_s']:.3f} s, "
                f"{len(armed['workers'])} worker trace(s)")
    memory_peak = sampler.peak if on_card else 0

    # ---- the check
    for s in samples:
        read_sample(s, truth_events, config["tolerance"])
        if s["error"]:
            say(f"sample failed: {s['error']}\n{s.get('stderr_tail', '')}")
    failed = sum(1 for s in samples if s["error"])
    t_check = time.perf_counter()
    checks = check_kernels(cap_dir, args.seed, config,
                           k1_rounds=control.get("k1_rounds", 0))
    shutil.rmtree(cell_runs, ignore_errors=True)
    numbers = judge(samples, checks, config, resolved)
    correct = failed == 0 and all(
        v is not None and v <= lim for v, lim in numbers.values())
    calls = calls_summary(samples)
    say(f"check {time.perf_counter() - t_check:.3f} s: {checks}; "
        f"calls {calls}")

    # ---- the result
    run = {"cell": cell, "config": config, "traffic": traffic,
           "mode": resolved, "samples": samples, "window_s": window_s,
           "cpu_s": cpu_s, "reads": sum(s["reads"] for s in samples),
           "setup_s": setup_s, "calls": calls, "armed": armed}
    metrics = {}
    for m in metric_names(bench, cell["name"], bool(args.trace)):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell["chips"], "memory_peak_bytes": memory_peak,
               "power_limit_w": Nvml().power_limit_w()}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    if armed:
        events = [e for w in armed["workers"] for e in (w.get("events") or [])]
        dev["busy_s"] = intervals.union_s(events)
        dev["window_s"] = armed["end_s"] - armed["start_s"]
    found = loaded_forbidden()
    if found:
        say(f"loaded after the window: {', '.join(found)}")
        return 3
    result = {"correct": bool(correct), "attempted": len(samples),
              "failed": failed, "metrics": metrics, "device": dev}
    if armed:
        result["breakdown"] = breakdown(armed)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        say(f"check {k}: {v} (limit {lim})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
