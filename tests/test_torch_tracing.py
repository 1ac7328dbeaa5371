"""The port's spans (``utils/profiling.py``) and its launch registry
(``ops/kernels/__init__.py``).

On the CPU: tracing off records nothing and touches neither CUDA events nor
``record_function``; a training step under ``torch.profiler`` records the
train step's spans, nested under one ``train_step`` with its unit, with
``remat.recompute`` under ``--remat conv`` (a recompute that checkpoint
stops early among them) and none under ``--remat none``; ``test_model``
records the padding, the copy, the sliding window's spans and the
read-back; a ``profiling.trace`` holds every span as a ``user_annotation``
with the same nesting, on the buffer's clock; the buffer drops its oldest
spans beyond its capacity; the benchmark's names of the counters read the
registry; the wrappers of K5 to K10 record their spans. On the card (``-m cuda``): the K1-K4 wrappers' spans with their
routes and device times, and the registry by route.
"""

import collections
import json
import types

import numpy as np
import pytest
import torch

from medicalsemseg_tpu_torch.cli import run_test
from medicalsemseg_tpu_torch.config import get_args
from medicalsemseg_tpu_torch.infer.sliding_window import bucket_pad
from medicalsemseg_tpu_torch.models.factory import build_model
from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa
from medicalsemseg_tpu_torch.train.state import (create_train_state,
                                                 make_train_step)
from medicalsemseg_tpu_torch.utils import profiling

# a two-stage flagship at roi 16 (the training CLI tests' model)
ARGV = ["--model", "nnFormerUNETR", "--vol_size", "16", "--patch_size", "2",
        "--hidden_dim", "12", "--depths", "1", "1", "--num_heads", "2", "2",
        "--window_size", "2", "--output_dim", "3", "--compute_dtype",
        "float32", "--n_images_per_batch", "2", "--batch_size_val", "4",
        "--warmup_epochs", "0", "--lr", "1e-3"]
STEP_CHILDREN = {"train_step.forward", "train_step.loss",
                 "train_step.backward", "train_step.update",
                 "train_step.metrics"}


@pytest.fixture(autouse=True)
def fresh_buffer():
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _train_state(remat, device="cpu", *extra):
    cfg = get_args(ARGV + ["--remat", remat, "--device", device, *extra])
    torch.manual_seed(0)
    with torch.device(device):
        model = build_model(cfg)
    state = create_train_state(cfg, model.to(device), 4)
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {"image": torch.randn(2, 16, 16, 16, 1, generator=gen,
                                  device=device),
             "label": torch.randint(0, 3, (2, 16, 16, 16), generator=gen,
                                    device=device),
             "crop_loc": torch.rand(2, 3, generator=gen, device=device),
             "affine": torch.ones(2, 3, device=device)}
    return cfg, state, batch


def _profiled_step(remat):
    cfg, state, batch = _train_state(remat)
    step = make_train_step(cfg)
    step(state, batch)  # a first step, untraced
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, batch)
    return profiling.spans()


def _by_id(spans):
    return {s.id: s for s in spans}


def _ancestors(span, by_id):
    out = []
    while span.parent in by_id:
        span = by_id[span.parent]
        out.append(span.name)
    return out


def test_off_records_nothing(monkeypatch):
    """Tracing off: no span, no CUDA event, no ``record_function`` of the
    program (CUDA is made to look in use, so a span would reach both)."""

    def refuse(*args, **kwargs):
        raise AssertionError("tracing off touched CUDA events or the "
                             "profiler")

    monkeypatch.setattr(profiling, "_prof", types.SimpleNamespace(
        _is_profiler_enabled=False, record_function=refuse))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    cfg, state, batch = _train_state("conv")
    assert not profiling.tracing()
    make_train_step(cfg)(state, batch)
    assert profiling.spans() == []


def test_training_spans_nest_under_one_step():
    spans = _profiled_step("conv")
    by_id = _by_id(spans)
    steps = [s for s in spans if s.name == "train_step"]
    assert len(steps) == 1
    step = steps[0]
    assert step.unit == 1 and step.parent is None  # state.step before it
    children = {s.name for s in spans if s.parent == step.id}
    assert children == STEP_CHILDREN
    for s in spans:
        assert s.unit == step.unit, s.name
        if s is not step:
            assert "train_step" in _ancestors(s, by_id), s.name
        assert s.t0_ns <= s.t1_ns and s.device_ms is None
        if s.parent in by_id:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns, s.name
    names = collections.Counter(s.name for s in spans)
    # the wrappers of K1-K4 (their plain versions on the CPU): K1 and K2 in
    # the forward and again in the recompute, K3 and K4 in the backward
    assert names["K1"] == names["K2"] == 2 * names["K3"] > 0
    assert names["K3"] == names["K4"]
    for s in spans:
        if s.name in ("K3", "K4", "remat.recompute"):
            assert by_id[s.parent].name == "train_step.backward", s.name


def test_recompute_spans_close_when_checkpoint_stops_early():
    spans = _profiled_step("conv")
    recompute = [s for s in spans if s.name == "remat.recompute"]
    assert recompute
    assert any(s.attrs.get("raised") == "_StopRecomputationError"
               for s in recompute)
    assert all(s.t1_ns >= s.t0_ns for s in recompute)
    assert profiling._tls.open == []  # every span closed


def test_no_recompute_spans_without_remat():
    spans = _profiled_step("none")
    names = {s.name for s in spans}
    assert "remat.recompute" not in names
    assert STEP_CHILDREN <= names


def test_prediction_spans(tmp_path):
    cfg = get_args(ARGV + ["--device", "cpu"])
    torch.manual_seed(0)
    model = build_model(cfg).eval()
    image = np.random.default_rng(0).normal(
        size=(20, 18, 17, 1)).astype(np.float32)
    affine = np.diag([1.0, 1.0, 1.5, 1.0])
    sample = types.SimpleNamespace(
        image=image, label=None, affine=affine, original_affine=affine,
        original_shape=image.shape[:3], name="img0.nii.gz")
    padded, _ = bucket_pad(image, cfg.sw_bucket_multiple)
    profiling.enable()
    with torch.inference_mode():
        (record,) = run_test.test_model(model, [sample], cfg,
                                        torch.device("cpu"))
    profiling.disable()
    spans = profiling.spans()
    names = collections.Counter(s.name for s in spans)
    assert names["sw.pad"] == names["test_model.h2d"] == 1
    assert names["test_model.readback"] == names["sw.normalise"] == 1
    (pad,) = [s for s in spans if s.name == "sw.pad"]
    (h2d,) = [s for s in spans if s.name == "test_model.h2d"]
    (volume,) = [s for s in spans if s.name == "test_model.volume"]
    (readback,) = [s for s in spans if s.name == "test_model.readback"]
    assert pad.attrs["bytes"] == h2d.attrs["bytes"] == padded.nbytes
    assert readback.attrs["bytes"] == int(np.prod(image.shape[:3]))
    assert pad.unit == volume.unit == 0 and pad.parent is None
    assert volume.attrs == {"windows": record["windows"],
                            "calls": record["predictor_calls"]}
    for name in ("sw.gather", "sw.predictor", "sw.blend"):
        calls = [s for s in spans if s.name == name]
        assert len(calls) == record["predictor_calls"]
        assert sum(s.attrs["windows"] for s in calls) == record["windows"]
        assert all(s.parent == volume.id for s in calls)
    assert pad.t1_ns <= volume.t0_ns


def test_trace_holds_the_spans_on_their_clock(tmp_path):
    """Every span of a region traced by ``profiling.trace`` is a
    ``user_annotation`` of its name, nested as the spans are, starting
    within 0.5 ms of the span's host start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("warm"):  # the first record_function is slow
            pass
    profiling.reset()
    with profiling.trace(str(tmp_path / "prof")) as path:
        with profiling.span("outer", unit=7):
            with profiling.span("inner", size=3):
                torch.randn(64, 64) @ torch.randn(64, 64)
            with profiling.span("inner"):
                torch.randn(64, 64).sum()
    spans = profiling.spans()
    trace = json.load(open(path))
    base = int(trace["baseTimeNanoseconds"])
    events = collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            events[e["name"]].append(e)
    assert [s.name for s in spans] == ["inner", "inner", "outer"]
    assert all(s.unit == 7 for s in spans)
    seen = collections.Counter()
    placed = {}
    for s in sorted(spans, key=lambda s: s.t0_ns):
        e = sorted(events[s.name], key=lambda e: e["ts"])[seen[s.name]]
        seen[s.name] += 1
        placed[s.id] = e
        assert abs(e["ts"] * 1e3 + base - s.t0_ns) < 0.5e6, s.name
    for s in spans:
        if s.parent is not None:
            e, p = placed[s.id], placed[s.parent]
            assert p["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"]


def test_buffer_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(profiling, "_done", collections.deque(maxlen=4))
    profiling.enable()
    for i in range(6):
        with profiling.span(f"s{i}"):
            pass
    assert [s.name for s in profiling.spans()] == ["s2", "s3", "s4", "s5"]
    assert profiling.dropped() == 2
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_enable_and_disable():
    assert not profiling.tracing()
    with profiling.span("off") as s:
        s.set(ignored=1)
    profiling.enable()
    assert profiling.tracing()
    with profiling.span("on", unit=3, a=1) as s:
        s.set(b=2)
    profiling.disable()
    (span,) = profiling.spans()
    assert (span.name, span.unit, span.attrs) == ("on", 3, {"a": 1, "b": 2})
    assert span.ms == span.host_ms >= 0


def test_registry_counts_and_tags_the_wrapper_span():
    before = kernels.routes("K1", "heads")
    profiling.enable()
    with profiling.span("K1") as s:
        kernels.count_launch("K1", "heads", "tensor_core")
        kernels.count_launch("K1", "gemm", "cuda_core")
    assert s.attrs == {"route": "tensor_core", "gemm_route": "cuda_core"}
    after = kernels.routes("K1", "heads")
    assert after["tensor_core"] == before["tensor_core"] + 1
    assert after["cuda_core"] == before["cuda_core"]


def test_benchmark_names_read_the_registry():
    """The four names the benchmark's launch counts read are views of the
    registry: K1's and K2's launches by route, K3's and K4's in all."""
    wa = dict(kwa.route_launches), kwa.bwd_launches
    mlp = dict(kmlp.route_launches), kmlp.bwd_launches
    kernels.count_launch("K1", "heads", "tensor_core")
    kernels.count_launch("K1", "gemm", "tensor_core")
    kernels.count_launch("K3", "heads", "cuda_core")
    kernels.count_launch("K3", "gemm", "cuda_core")
    kernels.count_launch("K2", "forward", "cuda_core")
    kernels.count_launch("K4", "backward", "tensor_core")
    assert dict(kwa.route_launches) == {
        "tensor_core": wa[0]["tensor_core"] + 1,
        "cuda_core": wa[0]["cuda_core"]}
    assert kwa.bwd_launches == wa[1] + 1
    assert dict(kmlp.route_launches) == {
        "tensor_core": mlp[0]["tensor_core"],
        "cuda_core": mlp[0]["cuda_core"] + 1}
    assert kmlp.bwd_launches == mlp[1] + 1
    assert sum(kwa.route_launches.values()) == kernels.launches("K1",
                                                                "heads")
    with pytest.raises(TypeError):
        kwa.route_launches["tensor_core"] = 0
    with pytest.raises(AttributeError):
        kwa.launches  # noqa: B018 (folded into the registry)


@pytest.mark.cuda
def test_kernel_wrapper_spans_on_the_card():
    """A bf16 step of a small flagship on the card (head dims 16 and 32:
    both routes of the heads launches), traced: a span for every K1-K4
    call with its route and device time, and the registry's launches by
    route are the spans' by route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg, state, batch = _train_state(
        "conv", "cuda", "--compute_dtype", "bfloat16", "--hidden_dim", "32")
    step = make_train_step(cfg)
    step(state, batch)
    launch = {"K1": "heads", "K2": "forward", "K3": "heads",
              "K4": "backward"}
    before = {k: kernels.routes(k, la) for k, la in launch.items()}
    profiling.enable()
    step(state, batch)
    profiling.disable()
    spans = profiling.spans()
    for k, la in launch.items():
        mine = [s for s in spans if s.name == k]
        assert mine, k
        assert all(s.device_ms is not None and s.device_ms > 0
                   for s in mine), k
        by_route = collections.Counter(s.attrs["route"] for s in mine)
        after = kernels.routes(k, la)
        assert {r: after[r] - before[k][r] for r in after} == {
            r: by_route[r] for r in kernels.ROUTES}, k
    assert {s.attrs["route"] for s in spans if s.name == "K1"} == set(
        kernels.ROUTES)
    (step_span,) = [s for s in spans if s.name == "train_step"]
    children = [s for s in spans if s.parent == step_span.id]
    assert {s.name for s in children} == STEP_CHILDREN
    assert sum(s.device_ms for s in children) <= step_span.device_ms * 1.01


def _k5_to_k10_calls():
    """One small CPU call of each wrapper of K5 to K10 (their plain
    versions), by the span it should record."""
    from medicalsemseg_tpu_torch.ops.kernels import conv3d as k10
    from medicalsemseg_tpu_torch.ops.kernels import dice_ce as k8
    from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5
    from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
    from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr
    from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    c, n, nh = 8, 8, 2
    vol, w = r(1, 4, 4, 4, c), r(c, c, 3, 3, 3)
    logits, labels = r(1, 64, 3), torch.randint(0, 3, (1, 64), generator=g)
    return {
        "K5": lambda: k5.dw27(vol, r(1, 4, 4, 4, c)),
        "K6": lambda: kga.global_window_attention(
            r(2, n, c), r(1, n, c), r(2 * c, c), r(2 * c), r(c, c), r(c),
            r(nh, n, n)),
        "K7": lambda: ksr.sr_attention(r(1, n, c), r(1, 4, c), r(1, 4, c),
                                       r(c, c), r(c), r(c, c), r(c), nh),
        "K8": lambda: (k8.dice_ce_sums(logits, labels),
                       k8.dice_ce_dlogits(logits, labels, r(1, 3), r(1, 3),
                                          r(1))),
        "K9": lambda: k9.winograd_conv3d_f23(vol, w),
        "K10": lambda: k10.conv3x3x3_fwd(vol, w),
    }


@pytest.mark.parametrize("kernel", ["K5", "K6", "K7", "K8", "K9", "K10"])
def test_k5_to_k10_wrappers_are_spans(kernel):
    """Each wrapper of K5 to K10 is a span of its kernel's name (K8: one
    for its sums, one for its dlogits), nested in the span around it."""
    call = _k5_to_k10_calls()[kernel]
    profiling.enable()
    with profiling.span("outer") as outer:
        call()
    profiling.disable()
    mine = [s for s in profiling.spans() if s.name == kernel]
    assert len(mine) == (2 if kernel == "K8" else 1)
    assert all(s.parent == outer.id for s in mine)
