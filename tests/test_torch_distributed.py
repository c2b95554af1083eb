"""The port's multi-host scale-out (manta_tpu_torch.parallel.
distributed): the torch.distributed runtime over gloo on localhost and
the host-sharded phases, vs a single-host run of the port and the demo
oracle. Tolerance: exact (graphs and VCF bodies).

Run as a script it is the worker of the two-process test:

    python tests/test_torch_distributed.py HOST_ID PORT WORK FASTA \\
        NORMAL_BAM TUMOR_BAM STATS_PATH
"""

import gzip
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(argv):
    """One of two concurrent processes: joins the runtime, proves a
    collective spans both (all_reduce of 1 and 2), then drives its
    host-sharded share of phase 1 and phase 2 against the shared
    directories, synchronised only by the runtime and the file-sentinel
    barriers."""
    host_id, port, work = int(argv[0]), argv[1], argv[2]
    fasta, normal_bam, tumor_bam, stats_path = argv[3:7]
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as td

    import manta_tpu_torch.parallel.distributed as dist

    dist.init_runtime(coordinator_address=f"127.0.0.1:{port}",
                      num_processes=2, process_id=host_id, device="cpu")
    assert td.get_world_size() == 2 and td.get_rank() == host_id
    total = torch.tensor([float(host_id + 1)])
    td.all_reduce(total)
    assert float(total) == 3.0, float(total)
    with open(os.path.join(work, f"sum.host{host_id}.json"), "w") as f:
        json.dump({"sum": float(total), "processes": td.get_world_size(),
                   "backend": td.get_backend()}, f)

    bams = [normal_bam, tumor_bam]
    # phase 1, host-sharded, concurrent
    p1 = os.path.join(work, "phase1")
    dist.run_host_phase1(host_id, 2, p1, bams, [False, True], fasta,
                         stats_path)
    dist.barrier(p1, "phase1", host_id, 2, timeout_s=300)
    if host_id == 0:
        groups = dist.plan_phase1(bams, fasta)
        dist.finalize_phase1(p1, len(groups)).save(
            os.path.join(work, "merged_graph.npz"))
    # phase 2 against the pre-bootstrapped shared run, concurrent
    shared_run = os.path.join(work, "shared_run")
    kw = dict(is_exome=True, verbose=False, use_device_scoring=False)
    dist.run_host_phase2(host_id, 2, [normal_bam], [tumor_bam], fasta,
                         shared_run, **kw)
    dist.barrier(shared_run, "phase2", host_id, 2, timeout_s=300)
    if host_id == 0:
        dist.finalize_phase2(2, [normal_bam], [tumor_bam], fasta,
                             shared_run, **kw)
    td.destroy_process_group()
    print(f"worker {host_id} done")


if __name__ == "__main__":
    worker(sys.argv[1:])
    sys.exit(0)

import pytest  # noqa: E402

from manta_tpu.parallel import distributed as jax_dist  # noqa: E402
from manta_tpu_torch.parallel import distributed as dist  # noqa: E402

KW = dict(is_exome=True, verbose=False, use_device_scoring=False)
VCFS = ("candidateSV.vcf.gz", "diploidSV.vcf.gz", "somaticSV.vcf.gz")


@pytest.fixture(scope="module")
def stats_path(tmp_path_factory, normal_bam, tumor_bam):
    from manta_tpu_torch.core.fragstats import (
        ReadGroupStatsSet, extract_read_group_stats,
    )
    p = str(tmp_path_factory.mktemp("tdist") / "alignmentStats.json")
    ss = ReadGroupStatsSet()
    for b in (normal_bam, tumor_bam):
        ss.set_stats(b, extract_read_group_stats(b))
    ss.save(p)
    return p


def _graph_fingerprint(locus_set):
    return [tuple((n.tid, n.beg, n.end, n.ev_beg, n.ev_end,
                   tuple(sorted(n.edges.items()))) for n in locus.nodes)
            for locus in locus_set.loci if not locus.empty()]


def _records(run, name):
    with gzip.open(f"{run}/results/variants/{name}", "rt") as f:
        return [ln for ln in f if not ln.startswith("#")]


def test_init_runtime_single_process_noop():
    import torch.distributed as td
    dist.init_runtime(num_processes=1)      # must not need a coordinator
    assert not td.is_initialized()


def test_init_runtime_default_device_is_the_card():
    """None means CUDA (nccl): on a host with no card it raises and does
    not join over gloo on its own."""
    import torch
    import torch.distributed as td
    if torch.cuda.device_count() > 0:
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.init_runtime("127.0.0.1:1", num_processes=2, process_id=0)
    assert not td.is_initialized()


@pytest.mark.parametrize("n_items,n_hosts", [(10, 3), (7, 2), (2, 4),
                                             (0, 2)])
def test_host_items_match_the_reference_partition(n_items, n_hosts):
    own = [dist.host_items(n_items, h, n_hosts) for h in range(n_hosts)]
    assert sorted(sum(own, [])) == list(range(n_items))
    assert own == [jax_dist.host_items(n_items, h, n_hosts)
                   for h in range(n_hosts)]


def test_barrier_times_out(tmp_path):
    with pytest.raises(TimeoutError):
        dist.barrier(str(tmp_path), "p", 0, 2, poll_s=0.05, timeout_s=0.3)


def test_two_hosts_in_turn_match_single_host(tmp_path, demo_fasta,
                                             normal_bam, tumor_bam,
                                             stats_path):
    """Two simulated hosts building disjoint group-graph shares into a
    shared directory merge to the single host's graph; the plan is the
    reference's."""
    bams = [normal_bam, tumor_bam]
    groups = dist.plan_phase1(bams, demo_fasta)
    assert len(groups) >= 2
    assert groups == jax_dist.plan_phase1(bams, demo_fasta)
    d2 = str(tmp_path / "two_hosts")
    for h in range(2):
        dist.run_host_phase1(h, 2, d2, bams, [False, True], demo_fasta,
                             stats_path)
        dist.barrier(d2, "phase1", h, h + 1)
    merged2 = dist.finalize_phase1(d2, len(groups))
    d1 = str(tmp_path / "one_host")
    dist.run_host_phase1(0, 1, d1, bams, [False, True], demo_fasta,
                         stats_path)
    merged1 = dist.finalize_phase1(d1, len(groups))
    assert _graph_fingerprint(merged2) == _graph_fingerprint(merged1)
    assert merged2.non_empty_size() > 0
    g2 = os.path.join(d2, "graphParts")
    manifests = [json.load(open(os.path.join(g2, f)))
                 for f in sorted(os.listdir(g2)) if f.startswith("manifest")]
    assert sorted(gi for m in manifests for gi in m["groups"]) == \
        list(range(len(groups)))
    with pytest.raises(FileNotFoundError):
        dist.finalize_phase1(d2, len(groups) + 1)


def test_two_concurrent_coordinated_processes(tmp_path, demo_fasta,
                                              normal_bam, tumor_bam,
                                              stats_path):
    """TWO concurrent processes over gloo on localhost: each joins the
    runtime, runs an all_reduce (1 + 2), then its shares of phase 1 and
    phase 2. The merged graph equals the single host's, the final VCFs
    a plain single-host run's, and the somatic VCF the demo oracle."""
    work = str(tmp_path / "work")
    os.makedirs(work)
    shared_run = os.path.join(work, "shared_run")
    dist.bootstrap_shared_run([normal_bam], [tumor_bam], demo_fasta,
                              shared_run, **KW)
    assert os.path.exists(os.path.join(shared_run, "workspace",
                                       "svLocusGraph.npz"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(h), str(port), work,
         demo_fasta, normal_bam, tumor_bam, stats_path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for h in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    # the collective really spanned both processes
    for h in range(2):
        rec = json.load(open(os.path.join(work, f"sum.host{h}.json")))
        assert rec == {"sum": 3.0, "processes": 2, "backend": "gloo"}

    from manta_tpu_torch.graph.locusgraph import SVLocusSet
    from manta_tpu_torch.workflow.run import run_workflow
    merged = SVLocusSet.load(os.path.join(work, "merged_graph.npz"))
    d1 = str(tmp_path / "one_host")
    bams = [normal_bam, tumor_bam]
    dist.run_host_phase1(0, 1, d1, bams, [False, True], demo_fasta,
                         stats_path)
    single_graph = dist.finalize_phase1(
        d1, len(dist.plan_phase1(bams, demo_fasta)))
    assert _graph_fingerprint(merged) == _graph_fingerprint(single_graph)

    single = str(tmp_path / "single_run")
    run_workflow([normal_bam], [tumor_bam], demo_fasta, single, **KW)
    for name in VCFS:
        assert _records(shared_run, name) == _records(single, name), name
    with gzip.open(os.path.join(REPO, "tests", "data", "demo",
                                "expectedResults", "somaticSV.vcf.gz"),
                   "rt") as f:
        oracle = [ln for ln in f if not ln.startswith("#")]
    assert _records(shared_run, "somaticSV.vcf.gz") == oracle
