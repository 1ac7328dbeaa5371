"""The port's profiling hooks (``utils/profiling.py``) on the CPU:
``trace`` writes a Chrome trace holding the annotated region,
``device_memory_stats`` is empty without a card, and the training CLI's
``--profile_dir`` traces the first trained epoch and no other."""

import json
import os

import pytest
import torch

from medicalsemseg_tpu_torch.cli import run_training as cli
from medicalsemseg_tpu_torch.config import get_args
from medicalsemseg_tpu_torch.utils import profiling

from tests.test_torch_run_training import ARGV, _write_train_set


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as path:
        with profiling.annotate("medseg_region"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    assert path == str(tmp_path / "prof" / "trace_rank0.json")
    events = json.load(open(path))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "medseg_region" in names
    assert any(str(n).startswith("aten::") for n in names)
    with profiling.trace(None) as nothing:
        assert nothing is None


def test_device_memory_stats_is_empty_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert profiling.device_memory_stats() == {}


def test_anomaly_detection_switch():
    profiling.enable_anomaly_detection()
    try:
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_anomaly_detection(False)
    assert not torch.is_anomaly_enabled()


def test_profile_dir_traces_the_first_epoch_only(tmp_path, monkeypatch):
    """Two epochs with ``--profile_dir``: the trace is entered with the
    directory for the first epoch and with None for the second, and the
    file holds the train step's ops."""
    calls = []
    real = cli.trace

    def spy(log_dir):
        calls.append(log_dir)
        return real(log_dir)

    monkeypatch.setattr(cli, "trace", spy)
    _write_train_set(tmp_path)
    prof = str(tmp_path / "prof")
    cli.main(get_args(ARGV + ["--data_path", str(tmp_path), "--profile_dir",
                              prof, "--epochs", "2", "--val_interval", "2"]))
    assert calls == [prof, None]
    assert os.listdir(prof) == ["trace_rank0.json"]
    names = {e.get("name") for e in
             json.load(open(os.path.join(prof, "trace_rank0.json")))[
                 "traceEvents"]}
    assert "Optimizer.step#AdamW.step" in names
