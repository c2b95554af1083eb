"""The port's headline benchmark (manta_tpu_torch/tools/bench.py, twin of
bench.py) and the jumpalign bench of its timing tool (twin of
benchmarks/bench_jumpalign.py), on the CPU.

- ``project_wgs`` is bench.py's arithmetic, number for number;
- ``measure_host`` gives bench.py's keys, and the resolved mode;
- ``measure_device`` runs the plain form when asked for the CPU and says
  so, and raises without a card otherwise; so does the CLI;
- ``load_measured`` takes only artifacts measured on a CUDA card, never
  anything under benchmarks/;
- jumpalign: the plain form's scores equal the port's full aligner and
  the JAX package's ``batched_jump_score`` on the same inputs, bit for
  bit (int32), and the timing tool refuses it without a card unless
  asked for the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_standalone import _PRELUDE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench as original                                      # noqa: E402

from manta_tpu_torch.tools import bench                       # noqa: E402

# the keys of bench.py's measure_host (bench.py:104-113)
HOST_KEYS = ("cores", "e2e_s", "cpu_s", "edges", "phase2_s", "edges_per_s",
             "serial_tail_s", "reads_m")
HOSTS = [
    {"cpu_s": 137.0, "serial_tail_s": 2.31, "reads_m": 0.358144},
    {"cpu_s": 355.0, "serial_tail_s": 0.2, "reads_m": 44.75},
    {"cpu_s": 3.3, "serial_tail_s": 0.0, "reads_m": 0.044768},
    {"cpu_s": 9876.5, "serial_tail_s": 61.07, "reads_m": 838.874597},
]


def _no_card():
    import torch
    if torch.cuda.device_count() > 0:
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("host", HOSTS)
def test_project_wgs_is_the_originals(host):
    assert bench.project_wgs(host) == original.project_wgs(host)


def test_the_original_imports_without_the_jax_package():
    """bench.py imports JAX and the JAX package only inside its measuring
    functions, so its arithmetic can be held against the port's."""
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + "import bench\n"
         "print(json.dumps(foreign()))", REPO],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.fixture(scope="module")
def host(tmp_path_factory, demo_fasta):
    return bench.measure_host("cpu", tiles=4, n_jobs=2,
                              work_dir=str(tmp_path_factory.mktemp("bench")),
                              demo_fasta=demo_fasta)


def test_measure_host_gives_the_originals_keys(host):
    assert set(HOST_KEYS) <= set(host)
    assert host["cores"] == 2 and host["edges"] > 0
    assert host["reads_m"] == 44768 / 1e6          # 4 tiles of the demo
    assert host["e2e_s"] > 0 and host["cpu_s"] > 0
    # no CUDA device here: 'auto' resolves to host scoring
    assert host["device_scoring_resolved"] == "off"
    assert host["workflow_k1_launches"] == 0
    proj = bench.project_wgs(host)
    assert proj["wgs_projected_min"] > 0


def test_measure_device_on_the_cpu_says_so():
    dev = bench.measure_device("cpu", shape=(4, 40, 80))
    assert dev["device_contigs_per_s"] > 0
    assert dev["device_gcells_per_s"] > 0
    assert dev["device"] == "cpu"
    assert dev["device_timed_by"] == "host clock"
    assert "plain PyTorch" in dev["device_form"]
    assert "not a device time" in dev["device_form"]
    assert dev["device_shape"] == "B=4,q=40,refs=2x80,bucket=(4,128,128)"
    assert dev["device_k1_launches"] == 0


def test_measure_device_raises_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.measure_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.measure_host()


def test_the_command_raises_without_a_card(tmp_path):
    _no_card()
    proc = subprocess.run(
        [sys.executable, "-m", "manta_tpu_torch.tools.bench",
         "--results-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout.strip() == ""


def _artifact(path, **kw):
    rec = {"metric": "wgs_at_scale_measured", "device_scoring": "off",
           "reads_m": 44.75, "wgs840_20core_projection_min": 5.0,
           "pct_of_840m": 5.3, "wall_min": 1.0, "cores": 8, "cpu_s": 100.0,
           "peak_rss_gb": 3.0, "peak_pss_anon_gb": 2.0, "edges_per_s": 30.0,
           "measured_utc": "2026-10-17T00:00:00+00:00", **kw}
    with open(path, "w") as f:
        json.dump(rec, f)
    return rec


def test_load_measured_takes_only_cuda_artifacts(tmp_path):
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    assert bench.load_measured(str(tmp_path)) is None
    _artifact(tmp_path / "wgs_measured_cpu.json", device="cpu",
              reads_m=800.0)
    _artifact(tmp_path / "wgs_measured_tpu.json", reads_m=700.0)
    _artifact(tmp_path / "wgs_measured_jump.json", device=card,
              device_scoring="jump", reads_m=600.0)
    assert bench.load_measured(str(tmp_path)) is None
    small = _artifact(tmp_path / "wgs_measured_small.json", device=card,
                      reads_m=2.8)
    assert bench.load_measured(str(tmp_path)) == small
    big = _artifact(tmp_path / "wgs_measured_big.json", device=card)
    with open(tmp_path / "wgs_measured_big.memtrace.json", "w") as f:
        json.dump({"columns": [], "rows": []}, f)
    assert bench.load_measured(str(tmp_path)) == big


def test_load_measured_never_reads_benchmarks(tmp_path):
    """benchmarks/results/ holds the JAX package's artifacts of other
    machines; the original's headline reads them, the twin never."""
    results = os.path.join(REPO, "benchmarks", "results")
    assert original.load_measured() is not None
    assert bench.load_measured(results) is None
    assert bench.load_measured(os.path.join(REPO, "benchmarks")) is None


def test_main_on_the_cpu_prints_one_line(tmp_path, demo_fasta, capsys):
    """Without an artifact the metric is the projection; with one
    measured on a card, the measured projection."""
    results = tmp_path / "results"
    results.mkdir()
    argv = ["--device", "cpu", "--tiles", "4", "--results-dir",
            str(results), "--work-dir", str(tmp_path)]
    out = bench.main(argv)
    line = capsys.readouterr().out.strip().splitlines()
    assert json.loads(line[-1]) == out
    assert out["metric"] == "wgs_20core_projection"
    assert out["value"] == out["wgs_projected_min"] > 0
    assert out["device"] == "cpu" and out["device_contigs_per_s"] > 0
    assert set(HOST_KEYS) <= set(out)
    _artifact(results / "wgs_measured_x.json",
              device="NVIDIA H100 80GB HBM3, 700.00 W")
    out = bench.main(argv)
    assert out["metric"] == "wgs_20core_projection_measured"
    assert out["value"] == 5.0 and out["vs_baseline"] == 4.0
    assert out["measured_device"] == "NVIDIA H100 80GB HBM3, 700.00 W"


# ------------------------------------------------------------- jumpalign

@pytest.mark.parametrize("shape", [(12, 40, 120), (6, 64, 90)])
def test_jumpalign_plain_form_equals_the_aligner_and_jax(shape):
    import jax.numpy as jnp
    import torch

    from manta_tpu.align.device_jumpscore import (
        batched_jump_score as jax_jump_score,
    )
    from manta_tpu_torch.align.aligners import (
        AlignmentScores, GlobalJumpAligner,
    )
    from manta_tpu_torch.align.device_jumpscore import (
        batched_jump_score, from_reference_inputs,
    )
    from manta_tpu_torch.tools import device_timing as dt
    B, Lq, Lr = shape
    queries, ref1, ref2 = dt.jumpalign_inputs(np.random.default_rng(0),
                                              B, Lq, Lr)
    arrays = dt.jumpalign_arrays(queries, ref1, ref2)
    assert [a.shape for a in arrays] == [(B, Lq), (B,), (B, Lr), (B,),
                                         (B, Lr), (B,)]
    scores = dt.JUMPALIGN_SCORES
    got = batched_jump_score(*from_reference_inputs(*arrays, "cpu"), *scores,
                             dt.JUMP, Lq, Lr, Lr)
    assert got.dtype == torch.int32
    got = got.numpy()
    want = np.asarray(jax_jump_score(*(jnp.asarray(a) for a in arrays),
                                     *scores, dt.JUMP, Lq, Lr, Lr))
    aligner = GlobalJumpAligner(AlignmentScores(*scores), dt.JUMP)
    host = np.array([aligner.align(q.encode(), a.encode(), b.encode()).score
                     for q, a, b in zip(queries, ref1, ref2)], np.int32)
    assert np.array_equal(got, want)
    assert np.array_equal(got, host)


def test_jumpalign_records_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "manta_tpu_torch.tools.device_timing",
         "--device", "cpu", "--kernel", "jumpalign", "--jumpalign-shape",
         "40,40,100", "--iters", "1"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    host, device, launches = (json.loads(ln) for ln in
                              proc.stdout.strip().splitlines())
    assert host["metric"] == "jump_align_throughput_host"
    assert device["metric"] == "jump_align_throughput_device"
    assert host["batch"] == 1 and device["batch"] == 40
    assert host["shape"] == "B=32,q=40,refs=2x100"
    assert device["host_parity"] == "32/32"
    assert device["device"] == "cpu" and "plain" in device["form"]
    assert host["contigs_per_s"] > 0 and device["contigs_per_s"] > 0
    assert launches == {"kernel_launches": {
        "jump_score": 0, "jump_score_bounded": 0, "split_score": 0}}


def test_jumpalign_needs_a_card_unless_asked_for_the_cpu():
    _no_card()
    proc = subprocess.run(
        [sys.executable, "-m", "manta_tpu_torch.tools.device_timing",
         "--kernel", "jumpalign"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 1
    assert "no CUDA device" in json.loads(
        proc.stdout.strip().splitlines()[-1])["error"]
