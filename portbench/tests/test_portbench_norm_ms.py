"""The readers of kernel K11's device time (``kernels.norm_ms.{train,
predict}``) on the CPU: fed a profiled sub-window's device ops, each sums
K11's kernels by name (a training step's over the profiled steps, a
predictor call's inside the model's calls); a trace without them, no trace,
and no profiled step or call read None."""

from __future__ import annotations

import os
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.tests.conftest import ROOT

CELLS = {"kernels.norm_ms.train": ["nnformer_unetr.train.b8",
                                   "swin_unetr.train.b8"],
         "kernels.norm_ms.predict": ["nnformer_unetr.predict.ct4",
                                     "swin_unetr.predict.ct4"]}
# device ops as reduce_trace gives them: (name, us, launched in a model call)
OPS = [("void instance_norm_stats_kernel<__nv_bfloat16, 8>(...)", 40.0, True),
       ("instance_norm_merge_kernel(float const*, float*, Geo, float)", 2.0,
        True),
       ("void instance_norm_act_kernel<__nv_bfloat16, 8, 2>(...)", 60.0, True),
       ("void instance_norm_bwd_reduce_kernel<__nv_bfloat16, 8>(...)", 90.0,
        False),
       ("instance_norm_bwd_finish_kernel(float const*, float*, ...)", 3.0,
        False),
       ("void instance_norm_bwd_apply_kernel<__nv_bfloat16, 8>(...)", 105.0,
        False),
       ("void at::native::elementwise_kernel<128, 2, ...>(...)", 500.0, True),
       ("void instance_norm_act_kernel<float, 1, 0>(...)", 8.0, False)]


def _reader(metric):
    return harness.load_module(os.path.join(ROOT, "portbench", "metrics",
                                            metric + ".py"))


def _rec(ops, profiled=(2, 6), calls=((30.0, (2, 16)), (20.0, (3, 16)),
                                      (9.0, (6, 4)))):
    """A record with a profiled sub-window over steps or volumes
    ``profiled``; ``calls``: the predictor calls' spans, (ms, (volume,
    windows))."""
    return SimpleNamespace(profiled=profiled,
                           trace=None if ops is None else {"ops": ops},
                           spans={"call": list(calls)})


def test_the_readers_are_entries():
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric, cells in CELLS.items():
        m = entries[metric]
        assert m["source"] == "device_trace" and m["unit"] == "ms"
        assert m["layer"] == "kernels (ops/kernels/*, csrc/*)"
        assert m["workloads"] == cells


@pytest.mark.parametrize("metric,want", [
    # every K11 kernel of the sub-window over its 4 steps
    ("kernels.norm_ms.train", (40 + 2 + 60 + 90 + 3 + 105 + 8) / 1e3 / 4),
    # the forward kernels launched in a model call, over the 2 profiled
    # calls (volumes 2 and 3 of the sub-window 2..5)
    ("kernels.norm_ms.predict", (40 + 2 + 60) / 1e3 / 2)])
def test_reader_sums_k11_kernels_by_name(metric, want):
    assert _reader(metric).read(_rec(OPS)) == pytest.approx(want)


@pytest.mark.parametrize("metric", list(CELLS))
def test_reader_reads_none_without_k11(metric):
    """A trace without K11's kernels (the program before it), no trace
    (an untraced run), and a sub-window without a step or call: None, no
    exception."""
    read = _reader(metric).read
    assert read(_rec([o for o in OPS if "instance_norm" not in o[0]])) is None
    assert read(_rec(None)) is None
    assert read(_rec(OPS, profiled=(3, 3), calls=())) is None
