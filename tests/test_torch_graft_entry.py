"""The port's entry points (manta_tpu_torch.graft_entry) on the
CPU vs the repository's own __graft_entry__ (JAX).

Tolerance: entry()'s exact split scan equal exactly (float32 scores
bit-equal, positions equal); the dry run's stage 5 somatic VCF body
equal to the demo oracle's."""

import gzip
import importlib.util
import os

import numpy as np
import pytest
import torch

from manta_tpu_torch import graft_entry
from manta_tpu_torch.parallel import mesh_scoring

from test_torch_splitscore import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_graft_entry():
    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_jax_entry():
    fn, args = graft_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    best, pos = fn(*args)
    jax_fn, jax_args = _jax_graft_entry().entry()
    for ours, theirs in zip(args, jax_args):
        np.testing.assert_array_equal(ours.numpy(), theirs)
    want_best, want_pos = jax_fn(*jax_args)
    assert best.shape == (64,) and best.dtype == torch.float32
    np.testing.assert_array_equal(best.numpy(), np.asarray(want_best))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))


def test_entry_without_a_card_raises():
    if torch.cuda.device_count():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(1)


@pytest.mark.parametrize("n_devices", (1, 8))
def test_dryrun_multichip_on_cpu_shards(n_devices, capsys, demo_fasta,
                                        monkeypatch):
    """All seven stages on CPU shards; stage 5's somatic VCF is held
    against the demo oracle here as well (the dry run itself compares
    the mesh-scored run with the host-scored one)."""
    bodies = []
    real = graft_entry._somatic_body

    def keeping(run_dir):
        bodies.append(real(run_dir))
        return bodies[-1]

    monkeypatch.setattr(graft_entry, "_somatic_body", keeping)
    calls = mesh_scoring.MESH_STATS["calls"]
    stages = graft_entry.dryrun_multichip(n_devices, device="cpu")
    out = capsys.readouterr().out
    assert f"dryrun_multichip ok: {n_devices} devices" in out
    for note in ("real-read stage", "e2e demo edge stage: 6 somatic records",
                 "demo contig jobs through the same scorer == native",
                 "graph P2 reduce: fork part-merge == serial graph",
                 "phase-1 gate stage"):
        assert note in out, note
    assert len(stages) == 7
    # CPU shards run the plain forms: no kernel launch anywhere
    assert all(v == {"jump_score": 0, "jump_score_bounded": 0,
                     "split_score": 0} for v in stages.values())
    assert mesh_scoring.MESH_STATS["calls"] > calls
    with gzip.open(os.path.join(REPO, "tests", "data", "demo",
                                "expectedResults", "somaticSV.vcf.gz"),
                   "rt") as f:
        oracle = [ln for ln in f if not ln.startswith("#")]
    assert len(bodies) == 2 and bodies[0] == bodies[1] == oracle
