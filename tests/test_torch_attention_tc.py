"""The two routes of the window-attention heads launches (K1, K3, K6).

On the CPU: the route picker (tensor cores for bf16 and fp16 at head dim 16
with at most 224 tokens a window, CUDA cores for fp32 and any other head
dim), the route code each wrapper hands the C entry point and counts, and a
failed launch raising instead of taking the plain version; a fake library
stands in for the built one. On the card (``cuda`` marker, skipped
elsewhere: ``python -m pytest --noconftest -m cuda
tests/test_torch_attention_tc.py``): the tensor-core route against the plain
versions at the flagship's and GCViTUNETR's four stage widths.
"""

import ctypes

import pytest
import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops import window as tw
from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("dtype,n,hd,route", [
    (BF16, 216, 16, "tensor_core"),    # every flagship stage
    (F16, 216, 16, "tensor_core"),     # --compute_dtype float16
    (BF16, 27, 16, "tensor_core"),     # a 3^3 window pads to 32 tokens
    (BF16, 224, 16, "tensor_core"),
    (F32, 216, 16, "cuda_core"),       # TF32 would cost fp32 its agreement
    (BF16, 216, 32, "cuda_core"),      # head dim 32
    (F16, 8, 4, "cuda_core"),
    (BF16, 343, 16, "cuda_core"),      # a 7^3 window: more than 224 tokens
])
def test_route_picker(dtype, n, hd, route):
    assert kwa.attention_route(dtype, n, hd) == route
    assert kwa.pick_route(None, dtype, n, hd) == route
    assert kwa.pick_route("cuda_core", dtype, n, hd) == "cuda_core"
    if route == "cuda_core":
        with pytest.raises(ValueError, match="does not take"):
            kwa.pick_route("tensor_core", dtype, n, hd)
    with pytest.raises(ValueError, match="does not take"):
        kwa.pick_route("wmma", dtype, n, hd)


class _FakeEntry:
    """A C entry point: remembers its arguments, returns ``err``."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


class _FakeLibrary:
    def __init__(self, err):
        self.medseg_window_attention_fwd = _FakeEntry(err)
        self.medseg_window_attention_bwd = _FakeEntry(err)
        self.medseg_global_window_attention_fwd = _FakeEntry(err)

    def medseg_cuda_error_string(self, err):
        return b"launch refused"


@pytest.fixture
def fake_lib(monkeypatch):
    """The wrappers' launch paths on CPU tensors, with a library whose entry
    points return ``lib.err``; the plain versions must not be reached."""
    lib = _FakeLibrary(0)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(kernels, "resident_blocks", lambda dev: 8)

    def no_plain(*a, **k):
        raise AssertionError("a launch path took the plain version")

    for mod, name in ((kwa, "window_attention_plain"),
                      (kwa, "window_attention_bwd_plain"),
                      (kga, "global_window_attention_plain")):
        monkeypatch.setattr(mod, name, no_plain)
    return lib


def _case(dtype, c=32, nh=2, ws=2, grid=(2, 1, 1), batch=1):
    n = ws ** 3
    t = batch * grid[0] * grid[1] * grid[2]
    g = torch.Generator().manual_seed(0)
    wins = torch.randn(t, n, c, generator=g).to(dtype)
    a = dict(wqkv=torch.randn(3 * c, c, generator=g).to(dtype), bqkv=None,
             wproj=torch.randn(c, c, generator=g).to(dtype),
             bproj=torch.zeros(c), bias=torch.zeros(nh, n, n))
    kw = dict(grid_dims=grid, window=(ws,) * 3, shift=(1,) * 3, ln=None,
              ln_eps=1e-5, residual=False)
    return wins, a, kw


def _launch(which, wins, a, kw, route=None):
    if which == "K1":
        return kwa._launch_fwd(wins, **a, **kw, route=route)
    if which == "K3":
        b = {k: v for k, v in a.items() if k != "bproj"}
        return kwa._launch_bwd(wins, **b, dy=wins, **kw, route=route)
    c = wins.shape[2]
    return kga._launch(wins, wins[:1].contiguous(), a["wqkv"][c:].contiguous(),
                       None, a["wproj"], a["bproj"], a["bias"], ln=None,
                       ln_eps=1e-5, residual=False, route=route)


def _entry(lib, which):
    return {"K1": lib.medseg_window_attention_fwd,
            "K3": lib.medseg_window_attention_bwd,
            "K6": lib.medseg_global_window_attention_fwd}[which]


def _counts(which):
    return kernels.routes(which, "heads")


@pytest.mark.parametrize("which", ["K1", "K3", "K6"])
@pytest.mark.parametrize("dtype,c,nh,forced,route", [
    (BF16, 32, 2, None, "tensor_core"),
    (F16, 32, 2, None, "tensor_core"),
    (F32, 32, 2, None, "cuda_core"),
    (BF16, 32, 1, None, "cuda_core"),          # head dim 32
    (BF16, 32, 2, "cuda_core", "cuda_core"),   # the kernels phase's A/B
])
def test_wrappers_hand_over_and_count_the_route(fake_lib, which, dtype, c, nh,
                                                forced, route):
    wins, a, kw = _case(dtype, c, nh)
    before = _counts(which)
    _launch(which, wins, a, kw, forced)
    args = _entry(fake_lib, which).calls[-1]
    # the route code sits before dtype, ln_eps, scale and the stream
    assert args[-5] == kwa.ROUTES[route]
    assert args[-4] == kernels.dtype_code("wins", dtype)
    after = _counts(which)
    assert after[route] == before[route] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    if which == "K3":
        # the transposed bias only for the CUDA-core route's key-row pass
        bias_t = args[6]
        assert (bias_t is None) == (route == "tensor_core")


@pytest.mark.parametrize("which", ["K1", "K3", "K6"])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_a_failed_launch_raises(fake_lib, which, dtype):
    """No route falls back to the other or to the plain version: the error
    the entry point returns is raised, and nothing is counted."""
    _entry(fake_lib, which).err = 1
    wins, a, kw = _case(dtype)
    before = _counts(which), kernels.launches()
    with pytest.raises(RuntimeError, match="launch refused"):
        _launch(which, wins, a, kw)
    assert len(_entry(fake_lib, which).calls) == 1
    assert (_counts(which), kernels.launches()) == before


def test_forcing_the_tensor_cores_on_fp32_raises(fake_lib):
    wins, a, kw = _case(F32)
    for which in ("K1", "K3", "K6"):
        with pytest.raises(ValueError, match="does not take"):
            _launch(which, wins, a, kw, "tensor_core")
        assert _entry(fake_lib, which).calls == []


def test_entry_points_take_the_route_as_an_int():
    """The route argument is a C int in the argtypes rows of all three
    entry points (before dtype, then two floats and the stream)."""
    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, type("F", (), {})())

    lib = Lib()
    kernels._declare(lib)
    for name in ("medseg_window_attention_fwd", "medseg_window_attention_bwd",
                 "medseg_global_window_attention_fwd"):
        at = lib.fns[name].argtypes
        assert at[-5:] == [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.c_float, ctypes.c_void_p], name


# ---- on the card: the tensor-core route against the plain versions

# flagship and GC-ViT stages: (C, heads), head dim 16 throughout
STAGES = ((48, 3), (96, 6), (192, 12), (384, 24))
# tolerances as in tests/test_torch_kernels_cuda.py (DTYPE_TOL): elementwise,
# gradient error norm, largest gradient error
TOL = {"bfloat16": (3e-2, 1e-2, 5e-2), "float16": (4e-3, 2e-3, 1e-2)}
WS = 6


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(7)


def _close(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= tol + tol * w.abs()).all(), (g - w).abs().max()


def _card_case(gen, batch, grid, c, nh, dtype, qkv_bias=True):
    dev = "cuda"
    n = WS ** 3
    x = torch.randn(batch, grid, grid, grid, c, generator=gen,
                    device=dev).to(dtype)
    wins = tw.window_partition(x, WS).contiguous()
    a = dict(
        wqkv=(torch.randn(3 * c, c, generator=gen, device=dev)
              * c ** -0.5).to(dtype),
        bqkv=(torch.randn(3 * c, generator=gen, device=dev) * 0.1
              if qkv_bias else None),
        wproj=(torch.randn(c, c, generator=gen, device=dev)
               * c ** -0.5).to(dtype),
        bproj=torch.randn(c, generator=gen, device=dev) * 0.1,
        bias=torch.randn(nh, n, n, generator=gen, device=dev))
    ln = torch.stack([1 + 0.3 * torch.randn(c, generator=gen, device=dev),
                      0.1 * torch.randn(c, generator=gen, device=dev)])
    return wins, a, ln


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("ln,res", [(True, True), (True, False),
                                    (False, False)])
@pytest.mark.parametrize("shift", [0, WS // 2])
@pytest.mark.parametrize("c,nh", STAGES)
def test_k1_tensor_cores(gen, c, nh, shift, ln, res, dtype):
    grid = 12                      # 2 x 2 x 2 windows: every mask region
    wins, a, lnp = _card_case(gen, 2, grid, c, nh, getattr(torch, dtype),
                              qkv_bias=ln)
    kw = dict(grid_dims=(grid // WS,) * 3, window=(WS,) * 3,
              shift=(shift,) * 3, ln=lnp if ln else None, residual=res)
    before = dict(kernels.routes("K1", "heads"))
    got = kwa.window_attention(wins, **a, **kw)
    torch.cuda.synchronize()
    assert (kernels.routes("K1", "heads")["tensor_core"]
            == before["tensor_core"] + 1)
    _close(got, kwa.window_attention_plain(wins, **a, **kw), TOL[dtype][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("absorbed", [True, False])
@pytest.mark.parametrize("c,nh", STAGES)
def test_k6_tensor_cores(gen, c, nh, absorbed, dtype):
    """GCViTUNETR's global attention: two query grids, 8 windows each."""
    dt, batch, grid = getattr(torch, dtype), 2, 12
    wins, a, lnp = _card_case(gen, batch, grid, c, nh, dt)
    args = dict(q_global=torch.randn(batch, WS ** 3, c, generator=gen,
                                     device="cuda").to(dt),
                wkv=a["wqkv"][c:].contiguous(),
                bkv=a["bqkv"][c:].contiguous() if absorbed else None,
                wproj=a["wproj"], bproj=a["bproj"], bias=a["bias"])
    kw = dict(ln=lnp if absorbed else None, residual=absorbed)
    before = dict(kernels.routes("K6", "heads"))
    got = kga.global_window_attention(wins, **args, **kw)
    torch.cuda.synchronize()
    assert (kernels.routes("K6", "heads")["tensor_core"]
            == before["tensor_core"] + 1)
    _close(got, kga.global_window_attention_plain(wins, **args, **kw),
           TOL[dtype][0])


K3_NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias", "dln")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("ln,res", [(True, False), (True, True),
                                    (False, False)])
@pytest.mark.parametrize("c,nh,grid,shift", [
    (48, 3, 12, WS // 2), (96, 6, 12, 0), (192, 12, 12, WS // 2),
    (384, 24, 6, 0),               # the last stage: one window a volume
])
def test_k3_tensor_cores(gen, c, nh, grid, shift, ln, res, dtype):
    """Every output of the backward at batch 8, and a rerun bit-equal."""
    dt = getattr(torch, dtype)
    wins, a, lnp = _card_case(gen, 8, grid, c, nh, dt, qkv_bias=ln)
    dy = torch.randn(wins.shape, generator=gen, device="cuda").to(dt)
    b = {k: v for k, v in a.items() if k != "bproj"}
    kw = dict(grid_dims=(grid // WS,) * 3, window=(WS,) * 3,
              shift=(shift,) * 3, ln=lnp if ln else None, residual=res)
    before = dict(kernels.routes("K3", "heads"))
    got = kwa.window_attention_bwd(wins, dy=dy, **b, **kw)
    torch.cuda.synchronize()
    assert (kernels.routes("K3", "heads")["tensor_core"]
            == before["tensor_core"] + 1)
    want = kwa.window_attention_bwd_plain(wins, dy=dy, **b, **kw)
    _, norm_tol, max_tol = TOL[dtype]
    for name, g, w in zip(K3_NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        gf, wf = g.float(), w.float()
        assert torch.isfinite(gf).all(), name
        assert (gf - wf).norm() <= norm_tol * wf.norm(), name
        assert (gf - wf).abs().max() <= max_tol * wf.abs().max(), name
    again = kwa.window_attention_bwd(wins, dy=dy, **b, **kw)
    for g, h in zip(got, again):
        assert (g is None and h is None) or torch.equal(g, h)
