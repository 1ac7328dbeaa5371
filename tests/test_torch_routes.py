"""Every shape the JAX modules run, the port runs (fault F5).

The JAX blocks call a Pallas kernel only where its fit predicate allows and
keep XLA elsewhere; the port's modules always call their kernel wrappers,
which launch a kernel for a CUDA tensor or raise. Each wrapper has a pure
predicate (``window_attention_supported``, ``fused_mlp_supported``,
``sr_attention_supported``) that says from the dtype and the shape alone
whether its kernel takes a call. Here, on the CPU:

* the sweep: for the configurations the CLIs accept (models nnFormerUNETR,
  GCViTUNETR, SegFormer3D, SwinSegFormer; --vol_size 64 .. 192; --hidden_dim
  24, 48, 96; --num_heads 3 6 12 24 and 1 2 4 8; bf16, fp16, fp32; inference,
  and training for the model that trains) every fused call site of every
  block, with the shape the port's module sees. The port's predicate takes
  every one of them, whether the JAX predicate sends it to Pallas or keeps
  XLA (K3 and K4 at C = 768 in training), except a head dim above 32: there
  the JAX package runs Pallas and the port raises on the card until
  ROADMAP R15. Every shape a predicate takes, the wrapper's launch path
  takes too (a stand-in library in place of the CUDA one), and a head dim
  above 32 is refused there. The JAX predicates are called here only,
  never by the port.
* unit cases of each predicate;
* each module calls its wrapper for the F5 cases (the wrappers run their
  plain versions here because the tensors lie on the CPU).
"""

import itertools

import numpy as np
import pytest
import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops import window as tw
from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
DTYPES = (BF16, F16, F32)
VOLS = (64, 96, 128, 160, 192)
HIDDEN = (24, 48, 96)
HEADS = ((3, 6, 12, 24), (1, 2, 4, 8))
WINDOW = 6


def _ceil(a, b):
    return -(-a // b)


def _swin_sites(vol, hidden, heads, train, jax_fits):
    """(kind, shape, JAX takes Pallas) of every fused call site of the Swin
    encoder (nnFormerUNETR, SwinSegFormer): patch 2, four stages of window
    attention and the dense MLP (hidden 4C)."""
    from medicalsemseg_tpu.ops import window as jw

    grid = _ceil(vol, 2)
    for i, nh in enumerate(heads):
        c = hidden * 2 ** i
        ws, _ = tw.resolve_window((grid,) * 3, WINDOW, WINDOW // 2)
        assert (ws, _) == jw.resolve_window((grid,) * 3, WINDOW, WINDOW // 2)
        yield "attn", (ws ** 3, c, nh), (not train or jax_fits["attn"](c, nh,
                                                                      ws))
        yield "mlp", (c, c, 4 * c), (not train or jax_fits["mlp"](c, 4 * c))
        grid = _ceil(grid, 2)


def _gcvit_sites(vol, hidden, heads):
    """GCViTUNETR at inference: a local (K1) and a global (K6) block and the
    MLP (hidden 3C) at each level, where the grid divides into windows;
    None where it does not (the JAX model cannot partition it either)."""
    grid = _ceil(vol, 2)
    sites = []
    for i, nh in enumerate(heads):
        c = hidden * 2 ** i
        ws = min(WINDOW, grid)
        if grid % ws:
            return None
        sites += [("attn", (ws ** 3, c, nh), True),
                  ("global", (ws ** 3, c, nh), True),
                  ("mlp", (c, c, 3 * c), True)]
        grid = _ceil(grid, 2)
    return sites


def _segformer_sites(vol, hidden, heads, jax_fits):
    """SegFormer3D at inference: K7 in every block of the four stages (7^3
    stride-4 embedding, then 3^3 stride 2; spatial reduction 8, 4, 2, 1)."""
    grid = _ceil(vol, 4)
    for i, (nh, sr) in enumerate(zip(heads, (8, 4, 2, 1))):
        c = hidden * 2 ** i
        m = (grid // sr) ** 3
        yield "sr", (c, nh, m), jax_fits["sr"](c, m, True)
        grid = _ceil(grid, 2)


def _port_takes(kind, dtype, shape, train):
    if kind in ("attn", "global"):
        n, c, nh = shape
        return kwa.window_attention_supported(dtype, n, c, nh, train)
    if kind == "mlp":
        c, co, h = shape
        return kmlp.fused_mlp_supported(dtype, c, co, h, train)
    c, nh, m = shape
    return ksr.sr_attention_supported(dtype, c, nh, m)


def _head_dim(kind, shape):
    if kind in ("attn", "global"):
        return shape[1] // shape[2]
    if kind == "sr":
        return shape[0] // shape[1]
    return 0


@pytest.fixture(scope="module")
def jax_fits():
    from medicalsemseg_tpu.ops.pallas.mlp import fused_mlp_train_fits
    from medicalsemseg_tpu.ops.pallas.sr_attention import (
        fused_sr_attention_fits)
    from medicalsemseg_tpu.ops.pallas.window_attention import (
        pallas_train_fits)

    return {"attn": pallas_train_fits, "mlp": fused_mlp_train_fits,
            "sr": fused_sr_attention_fits}


def _sweep(jax_fits):
    """Every (model, vol, hidden, heads, dtype, train, kind, shape, JAX
    Pallas, port kernel) of the sweep."""
    rows = []
    for model, vol, hidden, heads, dtype in itertools.product(
            ("nnFormerUNETR", "GCViTUNETR", "SegFormer3D", "SwinSegFormer"),
            VOLS, HIDDEN, HEADS, DTYPES):
        modes = (False, True) if model == "nnFormerUNETR" else (False,)
        for train in modes:
            if model in ("nnFormerUNETR", "SwinSegFormer"):
                sites = list(_swin_sites(vol, hidden, heads, train, jax_fits))
            elif model == "GCViTUNETR":
                sites = _gcvit_sites(vol, hidden, heads) or []
            else:
                sites = list(_segformer_sites(vol, hidden, heads, jax_fits))
            for kind, shape, pallas in sites:
                rows.append((model, vol, hidden, heads, dtype, train, kind,
                             shape, pallas,
                             _port_takes(kind, dtype, shape, train)))
    return rows


def test_sweep_kernel_wherever_jax_runs_pallas(jax_fits):
    rows = _sweep(jax_fits)
    assert len(rows) > 2000
    missed = [r for r in rows if not r[9]
              and _head_dim(r[6], r[7]) <= kwa.MAX_HEAD_DIM]
    assert not missed, missed[:5]
    # the documented exception: head dims of 48 and 96 (--num_heads 1 2 4 8
    # at hidden 48 and 96), where the wrappers raise on the card until R15
    r15 = {(r[6], _head_dim(r[6], r[7])) for r in rows if not r[9]}
    assert r15 and all(hd > kwa.MAX_HEAD_DIM for _, hd in r15)
    # the shapes of fault F5 run a kernel: SegFormer3D at vol 160
    # (M = 125 at every stage) in every dtype, K2 at C = 768 in fp32
    seg160 = [r for r in rows if r[0] == "SegFormer3D" and r[1] == 160
              and r[3] == HEADS[0]]
    assert seg160 and all(r[9] for r in seg160)
    assert {r[7][2] for r in seg160} == {125}
    wide = [r for r in rows if r[6] == "mlp" and r[7][0] == 768
            and not r[5]]
    assert wide and all(r[9] for r in wide)
    # K3 and K4 take C = 768 in training (on the CUDA cores), where the JAX
    # block keeps XLA
    train768 = [r for r in rows if r[5] and r[7][1] == 768
                and r[3] == HEADS[0]]
    assert train768 and all(r[9] and not r[8] for r in train768)


class _FakeEntry:
    def __init__(self):
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        return 0


class _FakeLibrary:
    """Every C entry point of the kernel library: counts its calls, returns
    0 (success)."""

    def __init__(self):
        self.entries = {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, _FakeEntry())


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(kernels, "sm_count", lambda dev: 132)
    return lib


def _launch(kind, dtype, shape, train):
    """The wrapper's launch path (checks, plan, entry point) on CPU tensors
    of this shape: one window, one batch element."""
    z = lambda *s, dt=dtype: torch.zeros(*s, dtype=dt)  # noqa: E731
    f32 = torch.float32
    if kind in ("attn", "global"):
        n, c, nh = shape
        ws = round(n ** (1 / 3))
        wins = z(1, n, c)
        ln = torch.ones(2, c)
        geo = dict(grid_dims=(1, 1, 1), window=(ws,) * 3, shift=(0, 0, 0),
                   ln=ln, ln_eps=1e-5, residual=True, route=None)
        if kind == "global":
            kga._launch(wins, z(1, n, c), z(2 * c, c), None, z(c, c),
                        z(c, dt=f32), z(nh, n, n, dt=f32), ln=ln, ln_eps=1e-5,
                        residual=True, route=None)
            return
        kwa._launch_fwd(wins, z(3 * c, c), None, z(c, c), z(c, dt=f32),
                        z(nh, n, n, dt=f32), **geo)
        if train:
            kwa._launch_bwd(wins, z(3 * c, c), None, z(c, c),
                            z(nh, n, n, dt=f32), z(1, n, c), **geo)
    elif kind == "mlp":
        c, co, h = shape
        x = z(1, c)
        kmlp._launch_fwd(x, z(h, c), z(h, dt=f32), z(co, h), z(co, dt=f32),
                         torch.ones(2, c), 1e-5, co == c, None)
        if train:
            kmlp._launch_bwd(x, z(h, c), z(h, dt=f32), z(c, h),
                             torch.ones(2, c), z(1, c), 1e-5, True, None)
    else:
        c, nh, m = shape
        x = z(1, 5, c)
        ksr._launch(x, z(1, m, c), z(1, m, c), z(c, c), None, z(c, c),
                    z(c, dt=f32), nh, x.clone(), None)


def test_sweep_wrappers_take_what_the_predicates_take(jax_fits, fake_lib):
    """Each distinct shape a predicate takes goes through its wrapper's
    launch path (the checks and plans in Python) to the entry point; each
    it refuses (head dim above 32) raises there, with no plain fallback."""
    rows = _sweep(jax_fits)
    seen = {(r[6], r[4], r[7], r[5]) for r in rows if r[9]}
    for kind, dtype, shape, train in sorted(seen, key=str):
        _launch(kind, dtype, shape, train)
    assert sum(e.calls for e in fake_lib.entries.values()) >= len(seen)
    calls = sum(e.calls for e in fake_lib.entries.values())
    refused = {(r[6], r[4], r[7], r[5]) for r in rows if not r[9]}
    for kind, dtype, shape, train in sorted(refused, key=str):
        with pytest.raises(ValueError, match="head dim"):
            _launch(kind, dtype, shape, train)
    assert sum(e.calls for e in fake_lib.entries.values()) == calls


@pytest.mark.parametrize("dtype,n,c,nh,train,want", [
    (BF16, 216, 48, 3, True, True),        # the flagship's stages
    (BF16, 216, 384, 24, True, True),
    (BF16, 216, 768, 24, False, True),     # hidden 96 at inference
    (BF16, 216, 768, 24, True, True),      # and in training (CUDA cores)
    (F32, 216, 768, 24, True, True),
    (F32, 216, 1024, 32, False, False),    # wider than any stage
    (F32, 216, 24, 3, True, True),         # hidden 24: 8-row dw blocks
    (F32, 216, 20, 1, True, False),        # no multiple of 8
    (BF16, 216, 96, 2, False, False),      # head dim 48 (R15)
    (BF16, 64, 192, 4, True, False),       # head dim 48 in training
    (BF16, 343, 96, 3, False, True),       # 7^3 windows on the CUDA cores
    (BF16, 343, 96, 3, True, False),       # K3 holds up to 6^3
    (F32, 512, 256, 8, False, False),      # 8^3 windows of head dim 32
    (torch.float64, 216, 48, 3, False, False),
])
def test_window_attention_supported(dtype, n, c, nh, train, want):
    assert kwa.window_attention_supported(dtype, n, c, nh, train) is want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,nh,m,want", [
    (48, 3, 27, True), (384, 24, 125, True), (384, 24, 512, True),
    (768, 24, 216, True), (768, 24, 512, True), (768, 8, 125, False),
    (96, 2, 27, False), (16, 1, 1, True), (1024, 32, 27, False),
    (768, 96, 64, False),
])
def test_sr_attention_supported(dtype, c, nh, m, want):
    assert ksr.sr_attention_supported(dtype, c, nh, m) is want


# ---- each module's choice, with the wrapper and the plain function spied on

class _Spy:
    """Stands in for a function: records the call, forwards to ``fn``."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


def _spy(monkeypatch, mod, *names):
    spies = {}
    for name in names:
        spies[name] = _Spy(getattr(mod, name))
        monkeypatch.setattr(mod, name, spies[name])
    return spies


@pytest.mark.parametrize("c,nh,grid,sr,kernel", [
    (384, 24, 5, 1, True),       # vol 160, stage 4: M = 125
    (48, 3, 40, 8, True),        # vol 160, stage 1: M = 125
    (96, 2, 6, 2, False),        # head dim 48: raises on the card (R15)
])
def test_sr_attention_module_choice(monkeypatch, c, nh, grid, sr, kernel):
    """The module calls K7's wrapper whatever the shape; the predicate says
    whether a kernel takes it on the card."""
    from medicalsemseg_tpu_torch.models.segformer import SRAttention

    spies = _spy(monkeypatch, ksr, "sr_attention", "sr_attention_plain")
    mod = SRAttention(c, nh, sr).eval()
    x = torch.randn(1, grid ** 3, c).to(BF16)
    with torch.inference_mode():
        out = mod(x, (grid,) * 3, x)
    assert out.shape == x.shape
    assert ksr.sr_attention_supported(BF16, c, nh,
                                      (grid // sr) ** 3) is kernel
    assert spies["sr_attention"].calls == 1
    assert spies["sr_attention_plain"].calls == 1   # the CPU wrapper's


@pytest.mark.parametrize("dim,nh,train,kernel", [
    (48, 3, True, True),
    (768, 24, True, True),       # hidden 96, stage 4: K3 on the CUDA cores
    (768, 24, False, True),
    (96, 2, False, False),       # head dim 48: raises on the card (R15)
])
def test_window_attention_module_choice(monkeypatch, dim, nh, train, kernel):
    from medicalsemseg_tpu_torch.models.swin import WindowAttention

    spies = _spy(monkeypatch, kwa, "window_attention", "window_attention_bwd",
                 "window_attention_plain")
    ws = 2
    mod = WindowAttention(dim, ws, nh)
    wins = torch.randn(2, ws ** 3, dim, requires_grad=train)
    ln = torch.stack([torch.ones(dim), torch.zeros(dim)])
    with torch.set_grad_enabled(train):
        out = mod(wins, (2, 1, 1), 0, ln=ln, residual=True)
        if train:
            out.float().sum().backward()
            assert mod.qkv.weight.grad is not None and wins.grad is not None
            assert mod.relative_position_bias_table.grad is not None
    assert kwa.window_attention_supported(F32, ws ** 3, dim, nh,
                                          train) is kernel
    assert spies["window_attention"].calls == 1
    assert spies["window_attention_bwd"].calls == int(train)


@pytest.mark.parametrize("dim,train,dtype,kernel", [
    (48, True, F32, True),
    (768, True, F32, True),      # K4's CUDA cores take 768 now
    (768, False, F32, True),     # and K2's
])
def test_mlp_module_choice(monkeypatch, dim, train, dtype, kernel):
    from medicalsemseg_tpu_torch.models.layers import Mlp

    spies = _spy(monkeypatch, kmlp, "fused_mlp", "fused_mlp_bwd",
                 "fused_mlp_plain")
    mod = Mlp(dim, 4 * dim)
    x = torch.randn(3, dim, dtype=dtype, requires_grad=train)
    ln = torch.stack([torch.ones(dim), torch.zeros(dim)])
    with torch.set_grad_enabled(train):
        out = mod(x, ln, residual=True)
        if train:
            out.sum().backward()
            assert mod.fc1.weight.grad is not None and x.grad is not None
    assert kmlp.fused_mlp_supported(dtype, dim, dim, 4 * dim, train) is kernel
    assert spies["fused_mlp"].calls == 1
    assert spies["fused_mlp_bwd"].calls == int(train)


@pytest.mark.parametrize("use_global", [False, True])
@pytest.mark.parametrize("dim,nh,kernel", [(48, 3, True), (96, 2, False)])
def test_gcvit_attention_module_choice(monkeypatch, use_global, dim, nh,
                                       kernel):
    from medicalsemseg_tpu_torch.models.gcvit import GCWindowAttention

    mod_k = kga if use_global else kwa
    name = "global_window_attention" if use_global else "window_attention"
    spies = _spy(monkeypatch, mod_k, name, name + "_plain")
    ws = 2
    mod = GCWindowAttention(dim, nh, ws, use_global).eval()
    wins = torch.randn(2, ws ** 3, dim)
    ln = torch.stack([torch.ones(dim), torch.zeros(dim)])
    with torch.inference_mode():
        out = mod(wins, torch.randn(1, ws ** 3, dim), (2, 1, 1), ln)
    assert out.shape == wins.shape
    assert kwa.window_attention_supported(F32, ws ** 3, dim, nh) is kernel
    assert spies[name].calls == 1
    assert spies[name + "_plain"].calls == 1      # the CPU wrapper's
