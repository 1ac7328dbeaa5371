"""The kernel library's build key and build failures, on the CPU (no nvcc).

The library is named by a hash of every file under ``csrc/``, so an edit to
a shared header rebuilds it too; a failed build leaves no file behind that
a later load could pick up.
"""

import os
import shutil

import pytest

from medicalsemseg_tpu_torch.ops import kernels


def test_library_key_covers_every_source(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels, "CSRC_DIR", str(csrc))
    paths = {kernels.library_path()}
    for name in ("common.cuh", "mlp.cu", "window_attention.cu"):
        with open(csrc / name, "a") as f:
            f.write("\n// edited\n")
        paths.add(kernels.library_path())
    assert len(paths) == 4


@pytest.mark.parametrize("nvcc", ["fails", "missing"])
def test_failed_build_leaves_no_library(tmp_path, monkeypatch, nvcc):
    build = tmp_path / "build"
    fake = tmp_path / "nvcc"
    if nvcc == "fails":
        fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
        fake.chmod(0o755)
    monkeypatch.setattr(kernels, "BUILD_DIR", str(build))
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    path = kernels.library_path()
    with pytest.raises(RuntimeError if nvcc == "fails" else OSError,
                       match="no sm_90a here" if nvcc == "fails" else None):
        kernels._build(path)
    assert os.listdir(build) == []
