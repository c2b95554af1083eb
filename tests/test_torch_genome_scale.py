"""chip_smoke.py's whole-genome phase (``--genome``), rehearsed on the CPU.

On the card the phase generates the JAX package's full-size germline
workload (24 chromosomes x 100 Mb at 35x, seed 7) and runs the port's
main path on it at -j 8 with scoring off, jump, exact and auto, the truth
checker on each, the timing tool's armed runs and the kernels at the
shapes they launched. Here the phase's own functions run at 2 x 1 Mb,
35x, seed 7, -j 2, with --device cpu (the plain forms score): the off,
jump and exact bodies are byte-identical, the port's off check line
equals the one the JAX package's checker gives for its own off run on
the same input, the armed run records its shapes, and the JAX package's
round-5 truth line that chip_smoke.py carries equals its artifact
(benchmarks/results/wgs840_truthcheck_r05.json). Cuts, the comparator
and the options are held without a run. 2 x 1 Mb at 35x keeps the
phase's depth and two chromosomes (the workload plants a translocation
between a pair) at the genome size of the other CPU tests (1 x 2 Mb):
every step runs, the jump run makes contig dispatches and the exact
run's plain split scans take seconds, not the minutes of 2 x 4 Mb."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("off", "jump", "exact", "auto")
# what is not the calls: the run's own wall, memory and directory
UNCOMPARED = ("wall_s", "peak_rss_gb", "run_dir")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_genome", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _smoke()


@pytest.fixture(scope="module")
def phase(smoke, tmp_path_factory):
    """The phase's steps at 2 x 1 Mb, -j 2, on the CPU: generation, the
    four unarmed runs, the truth checks and the armed exact run."""
    d = tmp_path_factory.mktemp("genome")
    args = smoke.parse_args([
        "--genome", "--chroms", "2", "--mb", "1", "--jobs", "2",
        "--reason", "CPU rehearsal", "--work-dir", str(d / "work"),
        "--out-dir", str(d / "out")])
    prefix = smoke.genome_prefix(args)
    with pytest.MonkeyPatch.context() as mp:
        # one thread a process: the plain split scan of -j 2 workers
        # oversubscribes the host's cores otherwise
        mp.setenv("OMP_NUM_THREADS", "1")
        try:
            done = {"gen": smoke.genome_generate(
                args, smoke.start_genome_generation(args))}
            for mode in MODES:
                done[mode] = smoke.genome_run(args, prefix, mode, "cpu")
            runs = {m: done[m] for m in MODES}
            done["check"] = smoke.genome_check(args, prefix, runs)
            done["armed_exact"] = smoke.genome_armed(
                args, prefix, "exact", "cpu", done["off"]["body_sha256"])
        finally:
            for proc in smoke.BACKGROUND:
                if proc.poll() is None:
                    proc.kill()
    return args, prefix, done


def test_generation_is_measured(phase):
    _args, prefix, done = phase
    gen = done["gen"]
    with open(prefix + ".gen.log") as f:
        assert f"({gen['reads']} reads" in f.read()
    assert gen["reads"] > 600_000 and gen["bam_gb"] > 0
    assert 0 < gen["simulation_s"] <= gen["generation_s"]
    assert gen["merge_s"] is None          # no external merge at this size
    assert gen["memory"]["peak_pss_anon_gb"] > 0
    assert gen["disk_need_gb"] > 0


def test_off_jump_exact_and_auto_bodies_are_identical(phase):
    _args, _prefix, done = phase
    digests = {m: done[m]["body_sha256"] for m in MODES}
    assert len(set(digests.values())) == 1, digests
    assert done["check"]["body_sha256"] == digests["off"]
    assert done["check"]["records"] > 0
    assert done["check"]["modes"] == list(MODES)


def test_runs_resolve_and_count_their_work(phase):
    _args, _prefix, done = phase
    assert [done[m]["device_scoring_resolved"] for m in MODES] == [
        "off", "jump", "exact", "off"]        # auto without a card: off
    assert done["jump"]["dispatches"] > 0 and done["jump"]["contig_jobs"] > 0
    assert done["exact"]["split_scans"] > 0
    for mode in MODES:
        run = done[mode]
        assert run["k1_launches"] == run["k3_launches"] == 0   # cpu
        assert run["cores"] == 2 and run["edges"] > 0
        assert run["phases"].startswith("phase 0 ")
        for who in ("parent", "workers"):
            assert f"peak_{who}_pss_anon_gb" in run
        assert run["peak_parent_anon_gb"] > 0


def test_off_check_line_equals_the_jax_packages(phase, tmp_path):
    """The JAX package's checker on the same input runs its own workflow
    with scoring off (its default without a card): the same line."""
    args, prefix, done = phase
    proc = subprocess.run(
        [sys.executable, os.path.join("benchmarks", "wgs_workload.py"),
         "--out", prefix, "--check", "--jobs", "2", "--run-dir",
         str(tmp_path / "ref")],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("{")][-1])
    ours = {k: v for k, v in done["check"]["line"].items()
            if k not in UNCOMPARED}
    assert ours == {k: v for k, v in ref.items() if k not in UNCOMPARED}
    assert ours["recall"] > 0


def test_armed_run_records_its_shapes(phase):
    _args, _prefix, done = phase
    armed = done["armed_exact"]
    k3 = armed["kernels"]["split_score"]
    assert armed["rc"] == 0 and k3["calls"] == done["exact"]["split_scans"]
    assert k3["launches_wrapper"] == k3["launches_exit_lines"] == 0
    tiers = k3["shapes"]
    assert tiers and sum(t["calls"] for t in tiers.values()) == k3["calls"]
    for key, tier in tiers.items():
        lp, tp = map(int, key.split(","))
        assert lp == 256 and tp >= 256 and tier["targets"] >= 1
    assert armed["phase2"]["workers"] >= 1
    assert armed["body_sha256"] == done["off"]["body_sha256"]


def test_r05_truth_constant_equals_the_artifact(smoke):
    with open(os.path.join(REPO, "benchmarks", "results",
                           "wgs840_truthcheck_r05.json")) as f:
        art = json.load(f)
    assert smoke.R05_TRUTH == {k: art[k] for k in smoke.R05_TRUTH}
    assert smoke.GENOME == {"chroms": 24, "mb": 100, "depth": 35, "seed": 7}


def test_comparator_reports_each_differing_field(smoke):
    want = smoke.R05_TRUTH
    assert smoke.compare_truth(dict(want, wall_s=1.0), want) == []
    got = json.loads(json.dumps(want))
    got["by_type"]["DUP"] = "4535/4598"
    del got["by_type"]["BND"]
    got["recall"] = 0.9947
    assert smoke.compare_truth(got, want) == [
        ("recall", 0.9947, 0.9948), ("by_type.BND", None, "2/2"),
        ("by_type.DUP", "4535/4598", "4536/4598")]


def test_a_cut_is_reduced_and_skips_the_r05_comparison(smoke, phase):
    args = smoke.parse_args(["--genome", "--chroms", "12", "--reason",
                             "df: 75 GB free"])
    assert smoke.genome_reduced(args) == {"chroms": [24, 12],
                                          "reason": "df: 75 GB free"}
    full = smoke.parse_args(["--genome"])
    assert smoke.genome_reduced(full) is None
    assert (full.chroms, full.mb, full.jobs) == (24, 100, 8)
    assert smoke.expected_reads(full) == 840_000_000
    # the rehearsal's own check (cut to 2 x 1 Mb) compared nothing
    assert phase[2]["check"]["r05"].startswith("not compared: the run is "
                                                "cut")


def test_generation_refuses_a_disk_too_small(smoke, tmp_path, monkeypatch):
    args = smoke.parse_args(["--genome", "--work-dir", str(tmp_path)])
    monkeypatch.setattr(smoke.shutil, "disk_usage",
                        lambda path: type("U", (), {"free": 60e9})())
    started = len(smoke.BACKGROUND)
    with pytest.raises(RuntimeError, match="cut --chroms"):
        smoke.start_genome_generation(args)
    assert len(smoke.BACKGROUND) == started      # no generator started


def test_generation_empties_only_its_own_directory(smoke, tmp_path,
                                                   monkeypatch):
    """--work-dir may be shared: the phase removes its own directory's
    files from an earlier run and leaves every other file there."""
    args = smoke.parse_args(["--genome", "--chroms", "6", "--reason", "x",
                             "--work-dir", str(tmp_path)])
    own = os.path.dirname(smoke.genome_prefix(args))
    assert os.path.dirname(own) == str(tmp_path)
    os.makedirs(os.path.join(own, "g.run_off"))
    kept = [tmp_path / "g.bam", tmp_path / "gold.txt", tmp_path / "genes"]
    for path in kept[:2]:
        path.write_text("a file of the user's")
    kept[2].mkdir()
    with open(os.path.join(own, "g.bam"), "w") as f:
        f.write("an earlier run's")
    started = []
    monkeypatch.setattr(smoke, "start_child",
                        lambda argv, log: started.append(log))
    smoke.start_genome_generation(args)
    assert started == [smoke.genome_prefix(args) + ".gen.log"]
    assert os.listdir(own) == []
    assert all(path.exists() for path in kept)


def test_disk_use_follows_a_directory(smoke, tmp_path):
    disk = smoke.DiskUse(str(tmp_path), interval=0.05).start()
    try:
        (tmp_path / "sub").mkdir()
        with open(tmp_path / "sub" / "run.bin", "wb") as f:
            f.write(os.urandom(5_000_000))
            f.flush()
            os.fsync(f.fileno())
        first = disk.step()
        os.remove(tmp_path / "sub" / "run.bin")
        second = disk.step()
    finally:
        disk.stop()
    assert first["peak_gb"] >= first["now_gb"] >= 0.005
    assert second == {"peak_gb": second["peak_gb"], "now_gb": 0.0}
    assert second["peak_gb"] <= first["now_gb"]


def test_gen_log_figures_with_an_external_merge(smoke):
    log = ("[   0.5s] reference built (200 Mb)\n"
           "[ 120.0s] encoding + sorting 70000000 reads\n"
           "[ 121.5s] merging 9 runs\n"
           "[ 160.0s] wrote /x/g.bam (70000000 reads, 35x nominal)\n")
    assert smoke.gen_log_figures(log) == {
        "reads": 70_000_000, "simulation_s": 121.5, "merge_s": 38.5,
        "generation_s": 160.0}


def test_bare_smoke_runs_todays_phases_only(smoke, monkeypatch):
    called = []
    monkeypatch.setattr(smoke, "smoke", lambda: called.append("smoke"))
    monkeypatch.setattr(smoke, "genome_main",
                        lambda args: called.append("genome"))
    smoke.main([])
    assert called == ["smoke"]
    assert smoke.parse_args([]).genome is False
    smoke.main(["--genome", "--steps", "gen"])
    assert called == ["smoke", "genome"]
    for argv in (["--chroms", "12"], ["--steps", "gen"],
                 ["--genome", "--steps", "gen,nope"]):
        with pytest.raises(SystemExit):
            smoke.parse_args(argv)
