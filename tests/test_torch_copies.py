"""The port's copies of the JAX-free host modules do not drift.

manta_tpu_torch keeps its own copy of every JAX-free module of manta_tpu
it needs, under the same name. A fix made to the original and missed in
the copy (or the reverse) must fail here. Each copy is diffed against its
original, both read as text (neither is imported), and the only hunks
allowed are the ones listed below, each with its reason. A listed hunk
that no longer shows fails too, so the list stays exact."""

import difflib
import hashlib
import os

import pytest

from test_torch_standalone import COPIED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the package __init__ files beside the copied modules ("io" and
# "options" are in COPIED already; parallel/__init__ is a twin of the
# port's own, not a copy)
PACKAGES = ("core", "align", "assembly", "scan", "graph", "candidates",
            "scoring", "format", "workflow", "tools")

_DEVICE = ("the port's device seam: the torch device is an argument, "
           "and a scorer of the caller's own may be passed")
_NAME = "the port's own package name in a usage or example line"
_WORDING = "the copy's own wording for a comment or docstring"
# where the original's side holds a word the port's sources avoid, the
# hunk gives the first 16 hex digits of its text's SHA-256 instead; a
# long copy side may be given so too
_NATIVE = ("the card's host has no libdeflate: the native core is loaded "
           "through native_core, which provides it, before any BAM is read")
_DOC = "the package docstring of the port's sub-package"
_CORE = ("the port builds its own native core under build/, named by a "
         "hash of the source, one process compiling under a lock into a "
         "temporary name: it never writes under native/, and no process "
         "loads a half-written library (the original rebuilds "
         "native/libmanta_core.so in place when its mtime is older)")

_SPANS = ("the port's run trace: an armed run's forked phase-0 worker "
          "keeps a record and times its job as a span "
          "(parallel/worker_trace)")
_JOINT = ("the port's run trace: the scorer counts its junctions, "
          "their samples and fragments and times evidence and the score "
          "models (JOINT_STATS, read by parallel/worker_trace.counts)")
_TPU_FIGURE = ("the port's comments state no time, rate or memory "
               "size measured on the JAX package's machines: the figure "
               "and its source document are dropped, the reasoning kept")

# module path -> [(reason, original's lines or their digest, copy's
# lines)]
ALLOWED = {
    "_native.py": [
        (_CORE, [], ["import fcntl", "import hashlib"]),
        (_CORE, [], ["import time", "", "from . import _build"]),
        (_CORE, [], 'b3f39789831beb90'),
        (_CORE, ['    src = os.path.abspath(os.path.join(_NATIVE_DIR, '
                 '"manta_core.cpp"))'], []),
        (_CORE, 'cf5c50e764bf386c', 'f987a636fa8ae7a9')],
    "io/__init__.py": [(
        _WORDING,
        ["struct-of-arrays read batches suited to feeding TPU kernels "
         "instead of"],
        ["struct-of-arrays read batches suited to feeding batched kernels "
         "instead of"])],
    "io/bgzf.py": [
        (_WORDING, "f7d5f349863be5a6",
         ["    workflow exports cpu/n_jobs so forked edge/segment workers"]),
        (_TPU_FIGURE, "9b67a1f74a46e394",
         ['    and for testing configurations on a different-size box."""']),
        (_TPU_FIGURE, "c3f075a64d19c93b",
         ["    is the reference-like ~192 MB per process: on the 44.7 M-read "
          "WGS",
          "    workload the node-scaled 1.5 GB tier was STRICTLY worse (a "
          "slower",
          "    phase 2 and a higher whole-run peak of anonymous memory), and "
          "on",
          "    the 290x deep-exome shape the small tier was at parity. "
          "Edge-ordered",
          "    phase-2 fetches reuse little beyond the hot window, so a big "
          "LRU",
          "    only buys eviction and allocator churn. MANTA_TPU_NODE_GB ≥ 64 "
          "opts",
          "    back into the large tiers for access patterns that measure",
          '    otherwise."""'])],
    "io/bam.py": [(
        _TPU_FIGURE, "d031bea363c886a6",
        ["    # the WGS shape and at parity on deep exomes — with",
         "    # MANTA_TPU_NODE_GB ≥ 64 opting back up"])],
    "io/bamwriter.py": [(
        _TPU_FIGURE, "ddeee03e55027baa",
        ["    # records every full-length int64 column is 6.7 GB, and a merge "
         "that",
         "    # holds many of them at once runs out of memory. int32 columns +",
         "    # uint8 run ids + on-demand virtual offsets keep the peak to a "
         "few",
         "    # such columns."])],
    "graph/finder.py": [(
        _WORDING, "88a81a2b1e7bab93",
        ['"""Phase-1 entry: scan genome-segment reads into the breakend '
         'graph.'])],
    "candidates/refiner.py": [
        (_DEVICE,
         ['                 jump_score_backend: str | None = "native"):'],
         ['                 jump_score_backend: str | None = "native",',
          '                 device=None):',
          '        """``jump_score_backend``: ``"native"`` (the host score '
          'batch),',
          '        ``"device"`` (the bucketed scorer of '
          '``align.device_jumpscore``',
          "        on the torch device ``device``), a scorer of the "
          "caller's own (a",
          "        callable from a list of (query, ref1, ref2) jobs to "
          "their int32",
          "        scores, as "
          "``parallel.mesh_scoring.make_mesh_bucketed_scorer``",
          '        makes) or None."""']),
        (_DEVICE, [],
         ["            if device is None:",
          '                raise ValueError("the device jump backend needs '
          'a device")']),
        (_DEVICE,
         ["                self.opt.spanning_scores, self.opt.jump_score)"],
         ["                self.opt.spanning_scores, self.opt.jump_score, "
          "device)",
          "        elif jump_score_backend is None or "
          "callable(jump_score_backend):",
          "            self._jump_score_backend = jump_score_backend"]),
        ("an unknown backend raises (the copy takes callables, so the "
         "original's assert no longer covers every other value)",
         ["            assert jump_score_backend is None, "
          "jump_score_backend",
          "            self._jump_score_backend = None"],
         ["            raise ValueError(",
          '                f"unknown jump_score_backend '
          '{jump_score_backend!r}")'])],
    "scoring/scorer.py": [
        (_JOINT, [], ["import time"]),
        (_JOINT, [],
         ["# what score_sv did in this process, for the run trace",
          '# (parallel/worker_trace.counts, key "joint"): junctions '
          "scored, their",
          "# samples summed (sample-junctions), the fragments in each "
          "sample's",
          "# banks, and the ns spent gathering evidence and in the score "
          "models",
          'JOINT_STATS = {"junctions": 0, "sample_junctions": 0, '
          '"fragments": [],',
          '               "evidence_ns": 0, "genotype_ns": 0}',
          "", "",
          "def _count_junction(tracks, evidence_ns: int, genotype_ns: "
          "int):",
          '    frags = JOINT_STATS["fragments"]',
          "    frags.extend([0] * (len(tracks) - len(frags)))",
          "    for i, track in enumerate(tracks):",
          "        frags[i] += track.n",
          '    JOINT_STATS["junctions"] += 1',
          '    JOINT_STATS["sample_junctions"] += len(tracks)',
          '    JOINT_STATS["evidence_ns"] += evidence_ns',
          '    JOINT_STATS["genotype_ns"] += genotype_ns']),
        (_JOINT, [], ["            t0 = time.perf_counter_ns()"]),
        (_JOINT, [], ["            t1 = time.perf_counter_ns()"]),
        (_JOINT, [], ["            _count_junction(tracks, t1 - t0, "
                      "time.perf_counter_ns() - t1)"]),
        (_JOINT, [], ["            t0 = time.perf_counter_ns()"]),
        (_JOINT, [], ['            JOINT_STATS["genotype_ns"] += '
                      "time.perf_counter_ns() - t0"]),
        (_DEVICE,
         ["                 use_device_scoring: bool | str = False):"],
         ["                 use_device_scoring: bool | str = False,",
          "                 device=None):",
          '        """``use_device_scoring``: ``"exact"`` or ``True`` (the '
          'exact',
          '        split scan on the torch device ``device``), ``"mxu"`` '
          '(the',
          '        matmul form), or anything else for the native host '
          'scan."""']),
        ("a TPU measurement that says nothing of the card",
         ["        # refiner's backend); split scans stay on the host-native "
          "scan,",
          "        # which round-3 chip measurements put 77x ahead of the "
          "bit-",
          "        # exact device kernel per core (docs/PERF_r03.md)"],
         ["        # refiner's backend); split scans stay on the host-native "
          "scan"]),
        (_DEVICE, [],
         ["            if device is None:",
          '                raise ValueError("the device split scan needs a '
          'device")']),
        (_DEVICE,
         ['                mxu=(use_device_scoring == "mxu"))'],
         ['                mxu=(use_device_scoring == "mxu"), '
          'device=device)']),
        (_WORDING,
         ["        # routed to the TPU kernel when enabled (bit-identical "
          "results)"],
         ["        # routed to the device scan when enabled (bit-identical "
          "results)"])],
    "workflow/tasks.py": [(
        _WORDING,
        ["This module provides the same behavior for the TPU workflow: a "
         "small"],
        ["This module provides the same behavior for this workflow: a "
         "small"])],
    "workflow/config.py": [(
        "the generated run script drives the port's workflow",
        ["from manta_tpu.workflow.run import run_workflow"],
        ["from manta_tpu_torch.workflow.run import run_workflow"])],
    "options/__init__.py": [(
        _NAME,
        ["    from manta_tpu.options import ScannerOptions, "
         "CallOptionsSomatic"],
        ["    from manta_tpu_torch.options import ScannerOptions, "
         "CallOptionsSomatic"])],
    "tools/convert_inversion.py": [(
        _NAME,
        ['            "usage: python -m manta_tpu.tools.convert_inversion "'],
        ['            "usage: python -m '
         'manta_tpu_torch.tools.convert_inversion "'])],
    "tools/denovo_scoring.py": [(
        _NAME,
        ['            "usage: python -m manta_tpu.tools.denovo_scoring "'],
        ['            "usage: python -m '
         'manta_tpu_torch.tools.denovo_scoring "'])],
    "tools/workers.py": [(
        _NATIVE, [],
        ["    from ..native_core import load as load_native_core",
         "    load_native_core()"])],
    "tools/test_assembler.py": [(
        _NATIVE, [],
        ["    from ..native_core import load as load_native_core",
         "    load_native_core()"])],
    "core/chromdepth.py": [
        (_SPANS, [], ["            from ..parallel import worker_trace",
                      '            worker_trace.enter_worker("phase0")']),
        (_SPANS,
         ["            queue.put((ji, read_chrom_depth(readers[path], tid, "
          "size)))"],
         ['            with worker_trace.span("phase0.bam", bam=path,',
          "                                   chrom=jobs[ji][2]):",
          "                depth = read_chrom_depth(readers[path], tid, size)",
          "            queue.put((ji, depth))"])],
    "core/__init__.py": [(
        _DOC, [], ['"""Host-side core models and the phase-0 estimates."""'])],
    "align/__init__.py": [(
        _DOC, [], ['"""Contig jump scoring: the plain PyTorch form and the '
                   'CUDA kernel."""'])],
    "candidates/__init__.py": [(
        _DOC, [], ['"""Phase-2 candidate generation, assembly and '
                   'refinement."""'])],
    "scoring/__init__.py": [(
        _DOC, [], ['"""Evidence scoring: host forms and the device '
                   'split-scan router."""'])],
    "workflow/__init__.py": [(
        _DOC, [], ['"""The port\'s workflow and its command line."""'])],
    "tools/__init__.py": [(
        _DOC, [], ['"""Command-line tools of the port."""'])],
}


# the port's twins of the JAX-free scripts of benchmarks/, diffed against
# their originals as the copies are: twin path -> the original's path
TWINS = {f"tools/{name}.py": f"benchmarks/{name}.py" for name in (
    "soak_graph", "bench_reduce", "bench_graphbuild", "bench_edges",
    "bench_repeats")}
_T_DOC = ("the twin's docstring: how it is run, what it runs on, where "
          "it writes")
_T_IMPORT = ("the twin imports the port's modules, relative to its "
             "package, and loads the native core through native_core")
_T_ARGS = ("the twin's command line: argv from a caller, a description "
           "and flags of its own")
_T_RETURN = "main prints its line flushed and returns it to a caller"
_T_WORKDIR = ("temporary files in a directory under --work-dir, removed "
              "at the end")
_T_DEVICE = ("the device seam: --device, --device-scoring, the resolved "
             "mode and the device work counted in every process")
_T_REPEATS = ("each seed's generation and check are children of the "
              "port's tools.wgs_workload behind a guard against the JAX "
              "package, a mode other than auto runs the workflow first, "
              "the device work is counted, the aggregate is a function "
              "of its own and goes to --results-dir")
# twin path -> [(reason, digest of the original's lines, the twin's
# lines or their digest)]
TWIN_ALLOWED = {
    "tools/soak_graph.py": [
        (_T_DOC, '373bf521b598e742',
         '76738a4f8947efed'),
        (_T_IMPORT, '3727adff524e0616',
         []),
        (_T_IMPORT, 'deae7a750ef4ef15',
         ['from .. import native_core']),
        (_T_IMPORT, '08a73e5b71c1a203',
         ['    from ..graph.locusgraph import SVLocusSetOptions',
          '    from ..graph.native_set import NativeLocusSet']),
        (_T_ARGS, '275bcc766c055e56',
         '78e7e8775773d7a1'),
        (_T_ARGS, '5a8fdd0747fb6b40',
         ['    args = ap.parse_args(argv)',
          '    native_core.load()']),
        (_T_IMPORT, '08a73e5b71c1a203',
         ['    from ..graph.locusgraph import SVLocusSetOptions',
          '    from ..graph.native_set import NativeLocusSet']),
        (_T_RETURN, '786ee546c39633f3',
         ['    out = {']),
        (_T_RETURN, 'acccf07e85881e3e',
         ['    }',
          '    print(json.dumps(out), flush=True)']),
        (_T_RETURN, 'e3b0c44298fc1c14',
         ['    return out']),
    ],
    "tools/bench_reduce.py": [
        (_T_DOC, '19f8f5629e51b1fe',
         'e2df093bf7a837f7'),
        (_TPU_FIGURE, 'f84af0fd7918d14f',
         ['The serial merge/finalize tail grows with the reads and so',
          'Amdahl-sinks the 20-core WGS projection (the reference\'s']),
        (_T_DOC, 'e3b0c44298fc1c14',
         '1d5de2a5caa511ad'),
        (_T_IMPORT, 'c517577851c489e4',
         []),
        (_T_IMPORT, '9da317d2e00b579e',
         ['from .. import native_core',
          'from .soak_graph import build']),
        (_T_ARGS, '275bcc766c055e56',
         '0bc2b2201732da27'),
        (_T_ARGS, '5a8fdd0747fb6b40',
         'bf814c941b9d1bfb'),
        (_T_IMPORT, '83f90a53cec9ba72',
         ['    from ..workflow.run import merge_saved_graphs_native']),
        (_T_WORKDIR, '1467415f22ea3ab4',
         '69100221cc0e8b71'),
        (_T_IMPORT, 'ad82c84842545fff',
         ['    from ..graph.locusgraph import SVLocusSet']),
        (_T_RETURN, '5b6b90fc03be97e6',
         ['    print(json.dumps(out), flush=True)']),
        (_T_RETURN, 'e3b0c44298fc1c14',
         ['    return out']),
    ],
    "tools/bench_graphbuild.py": [
        (_T_DOC, '0edd39f211d79446',
         '65cfa927b2faa68e'),
        (_T_IMPORT, 'c517577851c489e4',
         []),
        (_T_IMPORT, 'deae7a750ef4ef15',
         ['from .. import native_core']),
        (_T_ARGS, '1d3c46501ee45c77',
         'd5f26340c6c42dca'),
        (_T_ARGS, '5a8fdd0747fb6b40',
         '7a2871836e50f942'),
        (_T_IMPORT, '264784adba27caa0',
         '717a6e1548cd0275'),
        (_T_WORKDIR, 'e3b0c44298fc1c14',
         ['        import shutil']),
        (_T_WORKDIR, '4b002bb0fbb1356a',
         'e6da60af9b94d103'),
        (_T_WORKDIR, '6414229c820c6010',
         ['        shutil.rmtree(tmp)']),
        (_T_RETURN, '786ee546c39633f3',
         ['    out = {']),
        (_T_RETURN, 'acccf07e85881e3e',
         ['    }',
          '    print(json.dumps(out), flush=True)',
          '    return out']),
    ],
    "tools/bench_edges.py": [
        (_T_DOC, 'cb1301d56128c214',
         '70c79853b2415ff8'),
        (_T_IMPORT, 'c517577851c489e4',
         []),
        (_T_IMPORT, 'deae7a750ef4ef15',
         ['from .. import native_core',
          'from .bench_wgs_at_scale import device_label']),
        (_T_ARGS, '1d3c46501ee45c77',
         '168af33a76ab26ce'),
        (_T_ARGS, '5a8fdd0747fb6b40',
         '42d07c9d923c3f0d'),
        (_T_DEVICE, 'fe50b4b0044d3f4a',
         'bd3c057ac977dce0'),
        (_T_DEVICE, '3893211f4c084cdf',
         'e238527d8593f489'),
        (_T_DEVICE, '4c39991f41883c6d',
         'd52a417627deaf0f'),
        (_T_RETURN, '786ee546c39633f3',
         ['    out = {']),
        (_T_DEVICE, 'bd942004ffa3c01b',
         '87c848db7501a1d7'),
    ],
    "tools/bench_repeats.py": [
        (_T_DOC, 'b82b49361877f659',
         ['repeats_check_<tag>.json under --results-dir.']),
        (_T_DOC, '09ca5efa0d193a09',
         '3479aad6e757c877'),
        (_T_REPEATS, '46393a56c2577f65',
         '38e3e160e078a8a6'),
        (_T_REPEATS, 'e3b0c44298fc1c14',
         '6284667e31157170'),
        (_T_REPEATS, '4697ac9ce48c8116',
         ['    out = os.path.join(args.work_dir, f"reps_s{seed}")',
          '    run_dir = f"{out}.run_{args.device_scoring}"',
          '    shutil.rmtree(run_dir, ignore_errors=True)',
          '    mod = "manta_tpu_torch.tools.wgs_workload"']),
        (_T_REPEATS, '44762542b5a48c18',
         'bd58cd65b7c3e5a5'),
        (_T_REPEATS, 'e3b0c44298fc1c14',
         '2bed0a57ea6b35b5'),
        (_T_REPEATS, 'acc9b30937050cc1',
         '74cde3bd9242dcf4'),
        (_T_REPEATS, 'ee43ec8c0ca41e0c',
         ['    for rec in seeds:']),
        (_T_REPEATS, 'db402e4721cffeea',
         ['    return {']),
        (_T_REPEATS, 'e9a575f2fc56bfbe',
         'a79e1b18578db90f'),
        (_T_RETURN, 'e8fe0b827b160134',
         'cc2738c01b121ecb'),
    ],
}


def _path(name: str) -> str:
    """'io' -> 'io/__init__.py', 'core.cigar' -> 'core/cigar.py'."""
    path = name.replace(".", "/")
    if os.path.isdir(os.path.join(REPO, "manta_tpu", path)):
        return f"{path}/__init__.py"
    return path + ".py"


MODULES = sorted({_path(n) for n in COPIED}
                 | {f"{p}/__init__.py" for p in PACKAGES})


def _text(lines) -> str:
    return "".join(ln + "\n" for ln in lines)


def _digest(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def drift(original: str, copy: str, allowed) -> list[str]:
    """What differs between ``original`` and ``copy`` beyond the
    ``allowed`` hunks, and every allowed hunk that does not show."""
    a = original.splitlines(keepends=True)
    b = copy.splitlines(keepends=True)
    want = [(old if isinstance(old, str) else _digest(_text(old)),
             new if isinstance(new, str) else _text(new))
            for _reason, old, new in allowed]
    seen, found = set(), []
    matcher = difflib.SequenceMatcher(None, a, b, autojunk=False)
    for tag, i1, i2, j1, j2 in matcher.get_opcodes():
        if tag == "equal":
            continue
        copy = "".join(b[j1:j2])
        hunk = (_digest("".join(a[i1:i2])), copy)
        if hunk not in want:       # a long copy side is listed by digest
            hunk = (hunk[0], _digest(copy))
        listed = [k for k, w in enumerate(want) if w == hunk]
        if listed:      # a hunk listed twice is seen twice
            seen.add(next((k for k in listed if k not in seen), listed[0]))
        else:
            found.append(f"original lines {i1 + 1}-{i2} (digest "
                         f"{hunk[0]}), copy lines {j1 + 1}-{j2}:\n- "
                         + "- ".join(a[i1:i2])
                         + "\n+ " + "+ ".join(b[j1:j2]))
    found += [f"allowed hunk not found ({allowed[k][0]}): {want[k]}"
              for k in range(len(want)) if k not in seen]
    return found


def _read(package: str, path: str) -> str:
    with open(os.path.join(REPO, package, path)) as f:
        return f.read()


def test_every_listed_allowance_names_a_compared_module():
    assert set(ALLOWED) <= set(MODULES), set(ALLOWED) - set(MODULES)
    for path in ("assembly/small_assembler.py", "options/__init__.py",
                 "tools/workers.py", "tools/svloci.py"):
        assert path in MODULES


@pytest.mark.parametrize("path", MODULES)
def test_copy_equals_its_original_but_for_the_listed_hunks(path):
    found = drift(_read("manta_tpu", path), _read("manta_tpu_torch", path),
                  ALLOWED.get(path, []))
    assert not found, f"{path}:\n" + "\n".join(found)


@pytest.mark.parametrize("path", sorted(TWINS))
def test_twin_equals_its_original_but_for_the_listed_hunks(path):
    found = drift(_read("", TWINS[path]), _read("manta_tpu_torch", path),
                  TWIN_ALLOWED[path])
    assert not found, f"{path}:\n" + "\n".join(found)


def test_every_twin_has_its_listed_hunks():
    assert set(TWIN_ALLOWED) == set(TWINS)


@pytest.mark.parametrize("side", ("original", "copy"))
def test_a_planted_change_fails(tmp_path, side):
    """A fix to one side that misses the other shows as drift: a line of
    candidates/refiner.py changed in a temp copy of one side, next to
    the listed hunks of that file."""
    path = "candidates/refiner.py"
    texts = {"original": _read("manta_tpu", path),
             "copy": _read("manta_tpu_torch", path)}
    assert drift(texts["original"], texts["copy"], ALLOWED[path]) == []
    lines = texts[side].splitlines(keepends=True)
    k = next(i for i, ln in enumerate(lines) if "def refine_" in ln
             or "class " in ln)
    lines.insert(k, "# a planted change\n")
    planted = tmp_path / "refiner.py"
    planted.write_text("".join(lines))
    texts[side] = planted.read_text()
    found = drift(texts["original"], texts["copy"], ALLOWED[path])
    assert len(found) == 1 and "a planted change" in found[0]
