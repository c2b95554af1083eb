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
# hunk gives the first 16 hex digits of its text's SHA-256 instead
_NATIVE = ("the card's host has no libdeflate: the native core is loaded "
           "through native_core, which provides it, before any BAM is read")
_DOC = "the package docstring of the port's sub-package"

# module path -> [(reason, original's lines or their digest, copy's
# lines)]
ALLOWED = {
    "io/__init__.py": [(
        _WORDING,
        ["struct-of-arrays read batches suited to feeding TPU kernels "
         "instead of"],
        ["struct-of-arrays read batches suited to feeding batched kernels "
         "instead of"])],
    "io/bgzf.py": [(
        _WORDING, "f7d5f349863be5a6",
        ["    workflow exports cpu/n_jobs so forked edge/segment workers"])],
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
             _text(new)) for _reason, old, new in allowed]
    seen, found = set(), []
    matcher = difflib.SequenceMatcher(None, a, b, autojunk=False)
    for tag, i1, i2, j1, j2 in matcher.get_opcodes():
        if tag == "equal":
            continue
        hunk = (_digest("".join(a[i1:i2])), "".join(b[j1:j2]))
        if hunk in want:
            seen.add(want.index(hunk))
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
