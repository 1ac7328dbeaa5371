"""The kernel library's build key and build failures, on the CPU (no nvcc).

The library is named by a hash of every file under ``csrc/``, so an edit to
a shared header rebuilds it too; a failed build leaves no file behind that
a later load could pick up.
"""

import glob
import os
import re
import shutil

import pytest

from medicalsemseg_tpu_torch.ops import kernels


def test_library_key_covers_every_source(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels, "CSRC_DIR", str(csrc))
    paths = {kernels.library_path()}
    names = ("common.cuh", "mlp.cu", "window_attention.cu", "conv_tile.cuh",
             "winograd3d.cu", "conv3d.cu", "hopper.cuh", "dw27.cu",
             "mma_tile.cuh", "mlp_tile.cuh", "attn_wide.cuh", "wgmma_rs.cuh")
    for name in names:
        with open(csrc / name, "a") as f:
            f.write("\n// edited\n")
        paths.add(kernels.library_path())
    assert len(paths) == len(names) + 1


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


class _FakeFunction:
    pass


class _FakeLibrary:
    """Stands for the ctypes library: remembers what ``_declare`` sets."""

    def __init__(self):
        self.functions = {}

    def __getattr__(self, name):
        return self.functions.setdefault(name, _FakeFunction())


def _entry_points():
    """The ``medseg_*`` functions the wrappers call, and those the sources
    export."""
    here = os.path.dirname(kernels.__file__)
    called, exported = set(), set()
    for path in glob.glob(os.path.join(here, "*.py")):
        with open(path) as f:
            called.update(re.findall(r"lib\.(medseg_\w+)\(", f.read()))
    for path in glob.glob(os.path.join(kernels.CSRC_DIR, "*.cu")):
        with open(path) as f:
            exported.update(re.findall(
                r'extern "C"[^(;{]*?\b(medseg_\w+)\s*\(', f.read()))
    return called, exported


def test_every_entry_point_has_an_argtypes_row():
    """Without ``argtypes`` ctypes passes a pointer as a 32-bit int and cuts
    it: every function a wrapper calls is declared, and exported."""
    lib = _FakeLibrary()
    kernels._declare(lib)
    called, exported = _entry_points()
    assert {"medseg_winograd_f23", "medseg_conv3x3x3",
            "medseg_dw27"} <= called
    for name in sorted(called):
        assert name in exported, f"{name} is exported by no source"
        fn = lib.functions.get(name)
        assert fn is not None and hasattr(fn, "argtypes"), name
        assert hasattr(fn, "restype"), name
    assert set(lib.functions) <= exported


def test_argtypes_rows_match_the_c_signatures():
    """Every row of ``_declare`` against the C declaration it binds: a
    pointer for a pointer, an int for an int, in the same order."""
    import ctypes

    lib = _FakeLibrary()
    kernels._declare(lib)
    src = ""
    for path in glob.glob(os.path.join(kernels.CSRC_DIR, "*.cu")):
        with open(path) as f:
            src += f.read()
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    called, _ = _entry_points()
    assert len(called) >= 13
    for name in sorted(called):
        args = re.search(r'extern "C" [\w *]+?\b' + name + r"\(([^)]*)\)",
                         src).group(1)
        kinds = [" ".join(a.split()).rsplit(" ", 1)[0] for a in args.split(",")]
        want = [ctypes.c_void_p if k.endswith("*") else ctype[k]
                for k in kinds]
        assert list(lib.functions[name].argtypes) == want, name
    conv = lib.functions["medseg_winograd_f23"].argtypes
    assert (conv.count(ctypes.c_void_p), conv.count(ctypes.c_int)) == (5, 9)


@pytest.mark.parametrize("name", ["medseg_window_attention_fwd",
                                  "medseg_window_attention_bwd",
                                  "medseg_global_window_attention_fwd"])
def test_attention_entry_points_take_both_routes(name):
    """The three attention entry points take the GEMM launches' route as a C
    int right before the heads launch's, and K3's the pointer of the
    LayerNorm statistics its tensor-core dx launch hands the dw launch
    right after out_w: the argtypes rows against the parameter names."""
    import ctypes

    lib = _FakeLibrary()
    kernels._declare(lib)
    src = ""
    for path in glob.glob(os.path.join(kernels.CSRC_DIR, "*.cu")):
        with open(path) as f:
            src += f.read()
    args = re.search(r'extern "C" [\w *]+?\b' + name + r"\(([^)]*)\)",
                     src).group(1).split(",")
    names = [a.split()[-1].lstrip("*") for a in args]
    row = lib.functions[name].argtypes
    assert len(row) == len(names)
    i = names.index("gemm_route")
    assert names[i + 1] == "route"
    assert row[i] == row[i + 1] == ctypes.c_int
    if name == "medseg_window_attention_bwd":
        j = names.index("ln_stats")
        assert names[j - 1] == "out_w" and row[j] == ctypes.c_void_p


def test_sr_attention_entry_point_takes_the_plan_and_the_route():
    """K7's entry point takes the tensor-core plan (rows, groups, slots) and
    the route as C ints between nh and dtype: the argtypes row against the
    parameter names."""
    import ctypes

    lib = _FakeLibrary()
    kernels._declare(lib)
    src = ""
    for path in glob.glob(os.path.join(kernels.CSRC_DIR, "*.cu")):
        with open(path) as f:
            src += f.read()
    args = re.search(
        r'extern "C" [\w *]+?\bmedseg_sr_attention_fwd\(([^)]*)\)',
        src).group(1).split(",")
    names = [a.split()[-1].lstrip("*") for a in args]
    row = lib.functions["medseg_sr_attention_fwd"].argtypes
    assert len(row) == len(names)
    i = names.index("nh")
    assert names[i:i + 6] == ["nh", "rows", "groups", "slots", "route",
                              "dtype"]
    assert row[i:i + 6] == [ctypes.c_int] * 6
