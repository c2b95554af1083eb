"""``cuda_contexts_per_sample``: the traced sample's records that carry a
``cuda_startup_s``, one a CUDA context."""

from __future__ import annotations

import importlib.util
import os

import pytest

SVBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(run):
    spec = importlib.util.spec_from_file_location(
        "cuda_contexts_per_sample",
        os.path.join(SVBENCH, "metrics", "cuda_contexts_per_sample.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def _worker(startup):
    return {"role": "phase2", "cuda_startup_s": startup, "counts": {},
            "events": None}


@pytest.mark.parametrize("records, want", [
    ([_worker(1.5 + i / 10) for i in range(8)], 8),
    ([_worker(None) for _ in range(8)]
     + [dict(_worker(0.9), role="device_proc")], 1),
    ([_worker(None), _worker(None)], 0),
    ([{"role": "phase2"}], 0)],
    ids=["a_context_a_worker", "one_device_process", "on_the_cpu",
         "a_record_before_the_field"])
def test_contexts_are_the_records_with_a_start_up(records, want):
    assert _read({"armed": {"workers": records}}) == want


@pytest.mark.parametrize("run", [{"armed": None}, {},
                                 {"armed": {"workers": []}}],
                         ids=["untraced", "no_armed_key", "no_record"])
def test_nothing_to_read_is_none(run):
    assert _read(run) is None
