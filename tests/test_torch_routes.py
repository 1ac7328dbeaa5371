"""Every shape the JAX modules run, the port runs (fault F5).

The JAX blocks call a Pallas kernel only where its fit predicate allows and
keep XLA elsewhere; the port's modules always call their kernel wrappers,
which launch a kernel for a CUDA tensor or raise. Each wrapper has a pure
predicate (``window_attention_supported``, ``fused_mlp_supported``,
``sr_attention_supported``) that says from the dtype and the shape alone
whether its kernel takes a call. Here, on the CPU:

* the sweep: for the configurations the CLIs accept (models nnFormerUNETR,
  GCViTUNETR, SegFormer3D, SwinSegFormer, nnFormer with and without
  --ref_quirk_rel_pos, VideoSwinUNETR, SwinUNETR_Official with
  MEDSEG_OFFICIAL_FUSED on and off, FocalNetUNETR, UNETR_Official (ViT-B
  whatever the flags); --vol_size 64 .. 192; --hidden_dim 24,
  48, 96; --num_heads 3 6 12 24 and 1 2 4 8; bf16, fp16, fp32; inference,
  and training for the models that train through kernels: nnFormerUNETR,
  SwinSegFormer, GCViTUNETR's local blocks and MLPs, nnFormer; the MONAI
  blocks of VideoSwinUNETR and SwinUNETR_Official and the MLPs of
  FocalNetUNETR and UNETR_Official train plain in both packages, so they
  add no training site) every fused call site of every
  block, with the shape the port's module sees. The port's
  predicate takes every one of them, whether the JAX predicate sends it to
  Pallas or keeps XLA (K3 and K4 at C = 768 in training), head dims 48 and
  96 (--num_heads 1 2 4 8 at hidden 48 and 96) included. Every shape a
  predicate takes, the wrapper's launch path takes too (a stand-in library
  in place of the CUDA one). The JAX predicates are called here only, never
  by the port.
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


def _gcvit_sites(vol, hidden, heads, train):
    """GCViTUNETR: a local (K1, K3 in training) and, at inference, a global
    (K6) block and the MLP (hidden 3C) at each level, where the grid divides
    into windows; None where it does not (the JAX model cannot partition it
    either). In training the global blocks run the module's own unfused
    attention, as the JAX model's do, and the JAX model trains every block
    through XLA (its levels never set ``pallas_train``)."""
    grid = _ceil(vol, 2)
    sites = []
    for i, nh in enumerate(heads):
        c = hidden * 2 ** i
        ws = min(WINDOW, grid)
        if grid % ws:
            return None
        sites += [("attn", (ws ** 3, c, nh), not train),
                  ("mlp", (c, c, 3 * c), not train)]
        if not train:
            sites.append(("global", (ws ** 3, c, nh), True))
        grid = _ceil(grid, 2)
    return sites


def _nnformer_sites(vol, hidden, heads, train, quirk, jax_fits):
    """The official nnFormer: the Swin encoder's sites, then per decoder
    stage the cross block's MLP (K2; the JAX block keeps XLA there) and one
    shifted Swin block (depths 2: depth - 1 of them). Quirk-index blocks
    train through XLA in JAX (never its Pallas VJP), through K3 / K4 in the
    port."""
    grids = []
    for i, site in enumerate(_swin_sites(vol, hidden, heads, train,
                                         jax_fits)):
        kind, shape, pallas = site
        yield kind, shape, pallas and not (train and quirk)
        if kind == "attn":
            grids.append(_ceil(vol, 2 * 2 ** (i // 2)))
    for j in range(len(heads) - 1):
        grid, c, nh = grids[-2 - j], hidden * 2 ** (len(heads) - 2 - j), \
            heads[-2 - j]
        yield "mlp", (c, c, 4 * c), False
        ws, _ = tw.resolve_window((grid,) * 3, WINDOW, WINDOW // 2)
        yield "attn", (ws ** 3, c, nh), (not train or (
            not quirk and jax_fits["attn"](c, nh, ws)))
        yield "mlp", (c, c, 4 * c), not train or jax_fits["mlp"](c, 4 * c)


def _official_sites(vol, hidden, heads, window):
    """The MONAI blocks at inference with the kernels on (VideoSwinUNETR;
    SwinUNETR_Official under MEDSEG_OFFICIAL_FUSED=1, at its fixed 7^3
    window): K1 on the per-axis clamped window (the padded grid's windows
    of 343 tokens at 7^3) and K2 in every block, as the JAX block calls
    Pallas (``use_pallas and deterministic``)."""
    from medicalsemseg_tpu.models import swin_official as jso

    grid = _ceil(vol, 2)
    for i, nh in enumerate(heads):
        c = hidden * 2 ** i
        w3, s3 = (window,) * 3, (window // 2,) * 3
        ws, ss = tw.resolve_window_official((grid,) * 3, w3, s3)
        assert (ws, ss) == jso.resolve_window_official((grid,) * 3, w3, s3)
        yield "attn", (int(np.prod(ws)), c, nh), True
        yield "mlp", (c, c, 4 * c), True
        grid = _ceil(grid, 2)


def _focalnet_sites(hidden, heads, train):
    """FocalNetUNETR: K2 in every block's MLP (hidden 4C) of the four stages
    at inference, as the JAX block calls Pallas (``use_pallas and
    deterministic``); in training both packages run the MLP plain."""
    if train:
        return []
    return [("mlp", (c, c, 4 * c), True)
            for c in (hidden * 2 ** i for i in range(len(heads)))
            for _ in range(2)]


def _unetr_sites(train):
    """UNETR_Official: ViT-B whatever --hidden_dim says: K2 at C = 768 (hidden
    3072) in the MLPs of its 12 blocks at inference, as the JAX block calls
    Pallas; plain in training in both packages. Its global self-attention
    is XLA in JAX and plain PyTorch in the port."""
    return [] if train else [("mlp", (768, 768, 3072), True)] * 12


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
            ("nnFormerUNETR", "GCViTUNETR", "SegFormer3D", "SwinSegFormer",
             "nnFormer", "nnFormer+quirk", "VideoSwinUNETR",
             "SwinUNETR_Official+fused", "SwinUNETR_Official",
             "FocalNetUNETR", "UNETR_Official"),
            VOLS, HIDDEN, HEADS, DTYPES):
        modes = (False,) if model == "SegFormer3D" else (False, True)
        for train in modes:
            if model in ("nnFormerUNETR", "SwinSegFormer"):
                sites = list(_swin_sites(vol, hidden, heads, train, jax_fits))
            elif model.startswith("nnFormer"):
                sites = list(_nnformer_sites(vol, hidden, heads, train,
                                             model.endswith("quirk"),
                                             jax_fits))
            elif model == "GCViTUNETR":
                sites = _gcvit_sites(vol, hidden, heads, train) or []
            elif model in ("VideoSwinUNETR", "SwinUNETR_Official+fused"):
                # the blocks train plain in both packages
                sites = [] if train else list(_official_sites(
                    vol, hidden, heads, 7 if model.endswith("fused")
                    else WINDOW))
            elif model == "SwinUNETR_Official":
                sites = []      # the gate off: plain in both packages
            elif model == "FocalNetUNETR":
                sites = _focalnet_sites(hidden, heads, train)
            elif model == "UNETR_Official":
                sites = _unetr_sites(train)
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
    missed = [r for r in rows if not r[9]]
    assert not missed, missed[:5]
    # head dims 48 and 96 (--num_heads 1 2 4 8 at hidden 48 and 96) run the
    # wide forms of K1, K3, K6 and the CUDA-core route of K7, in every dtype,
    # at inference and in training
    wide = {(r[6], r[4], r[5], _head_dim(r[6], r[7])) for r in rows
            if _head_dim(r[6], r[7]) > kwa.BWD_NARROW_HEAD_DIM}
    assert {hd for *_, hd in wide} == {48, 96}
    assert {kind for kind, *_ in wide} == {"attn", "global", "sr"}
    assert {(dt, train) for _, dt, train, _ in wide} == {
        (dt, train) for dt in DTYPES for train in (False, True)}
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
    # SwinUNETR_Official's 7^3 windows (343 tokens, beyond the tensor-core
    # route) at every stage but a clamped one, at inference only; nnFormer's
    # quirk-index blocks train through K3 where JAX keeps XLA
    official = [r for r in rows if r[0] == "SwinUNETR_Official+fused"
                and r[6] == "attn"]
    assert official and all(r[9] and r[8] and not r[5] for r in official)
    assert {r[7][0] for r in official} >= {343, 216, 64}
    assert not any(r[0] == "SwinUNETR_Official" for r in rows)
    quirk = [r for r in rows if r[0] == "nnFormer+quirk" and r[5]
             and r[6] == "attn"]
    assert quirk and all(r[9] and not r[8] for r in quirk)
    # FocalNetUNETR's MLPs at the flagship's four widths and UNETR_Official's
    # at ViT-B's 768 take K2 wherever the JAX block runs Pallas (inference);
    # ViT-B's width takes the tensor-core route in bf16 and fp16
    for model, widths in (("FocalNetUNETR", {24, 48, 96, 192, 384, 768}),
                          ("UNETR_Official", {768})):
        mine = [r for r in rows if r[0] == model]
        assert mine and all(r[9] and r[8] and not r[5] for r in mine)
        assert {r[7][0] for r in mine} == widths
    assert kmlp.mlp_route(BF16, 768, 768, 3072) == "tensor_core"
    assert kmlp.mlp_route(F16, 768, 768, 3072) == "tensor_core"


class _FakeEntry:
    def __init__(self):
        self.calls = 0
        self.args = []

    def __call__(self, *args):
        self.calls += 1
        self.args.append(args)
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
    """Each distinct shape of the sweep goes through its wrapper's launch
    path (the checks and plans in Python) to the entry point, and none is
    refused: no wrapper raises "head dim" for any of them. Above head dim
    16 (K1, K6) and 32 (K3) the attention wrappers hand the entry point a
    scratch buffer of the wide form."""
    rows = _sweep(jax_fits)
    seen = {(r[6], r[4], r[7], r[5]) for r in rows if r[9]}
    refused = {(r[6], r[4], r[7], r[5]) for r in rows if not r[9]}
    assert not refused
    for kind, dtype, shape, train in sorted(seen, key=str):
        _launch(kind, dtype, shape, train)
    assert sum(e.calls for e in fake_lib.entries.values()) >= len(seen)
    # (the scratch pointer's place, C's place, the one-pass form's largest
    # head dim) in each attention entry point: a scratch buffer exactly
    # where the head dim is above that
    for name, (at, c_at, one_pass) in {
            "medseg_window_attention_fwd": (9, 12, 16),
            "medseg_global_window_attention_fwd": (10, 13, 16),
            "medseg_window_attention_bwd": (18, 21, 32)}.items():
        args = fake_lib.entries[name].args
        wide = [(a[at] is not None, a[c_at] // a[c_at + 1] > one_pass)
                for a in args]
        assert all(x == y for x, y in wide), name
        assert any(x for x, _ in wide) and not all(x for x, _ in wide), name


@pytest.mark.parametrize("dtype,n,c,nh,train,want", [
    (BF16, 216, 48, 3, True, True),        # the flagship's stages
    (BF16, 216, 384, 24, True, True),
    (BF16, 216, 768, 24, False, True),     # hidden 96 at inference
    (BF16, 216, 768, 24, True, True),      # and in training (CUDA cores)
    (F32, 216, 768, 24, True, True),
    (F32, 216, 1024, 32, False, False),    # wider than any stage
    (F32, 216, 24, 3, True, True),         # hidden 24: 8-row dw blocks
    (F32, 216, 20, 1, True, False),        # no multiple of 8
    (BF16, 216, 96, 2, False, True),       # head dim 48: the wide form
    (BF16, 64, 192, 4, True, True),        # head dim 48 in training
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
    (768, 24, 216, True), (768, 24, 512, True), (768, 8, 125, True),
    (96, 2, 27, True), (16, 1, 1, True), (1024, 32, 27, False),
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
    (96, 2, 6, 2, True),         # head dim 48: the CUDA-core route
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
    (96, 2, False, True),        # head dim 48: the wide form
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
@pytest.mark.parametrize("dim,nh,kernel", [(48, 3, True), (96, 2, True)])
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


# ---- SwInception, SwinDepth and the Swin encoder's options (the thirteenth
# slice): the attention sites of their blocks, which of them leave the
# kernels (the options alone decide), and the 3^3 convs of the inception
# MLP at the K5 and K9 gates

OPTION_SETS = {
    "none": {},
    "embedding": dict(learned_cls_vectors=True, lcv_final_layer=True,
                      rel_crop_pos_emb=True, abs_pos_emb=True,
                      patch_size=(2, 2, 1)),
    "attention": dict(rel_pos_bias_affine=True, global_token=True),
}
SWIN_MLPS = {"nnFormerUNETR": "dense", "SwInception": "inception",
             "SwinDepth": "dwconv"}


def _option_sites(model, options, vol, hidden, heads, train, jax_fits):
    """(kind, shape, JAX takes Pallas) of every block call site of a Swin
    UNETR model: its attention ("attn" on the kernels or "unfused"), and
    for the dense MLP "mlp". The JAX block leaves its fused attention
    exactly for ``global_token`` or ``rel_pos_bias_affine``
    (medicalsemseg_tpu/models/swin.py:308-309) and runs its fused MLP only
    for ``mlp_type == "dense"`` (:372-375), whatever the options."""
    from medicalsemseg_tpu.ops import window as jw

    patch = options.get("patch_size", (2, 2, 2))
    grid = tuple(_ceil(vol, p) for p in patch)
    unfused = options.get("global_token") or options.get(
        "rel_pos_bias_affine")
    for i, nh in enumerate(heads):
        c = hidden * 2 ** i
        ws, ss = tw.resolve_window(grid, WINDOW, WINDOW // 2)
        assert (ws, ss) == jw.resolve_window(grid, WINDOW, WINDOW // 2)
        if unfused:
            yield "unfused", (ws ** 3, c, nh), False
        else:
            yield "attn", (ws ** 3, c, nh), (
                not train or jax_fits["attn"](c, nh, ws))
        if SWIN_MLPS[model] == "dense":
            yield "mlp", (c, c, 4 * c), (not train
                                         or jax_fits["mlp"](c, 4 * c))
        grid = tuple(_ceil(g, 2) for g in grid)


def _option_sweep(jax_fits):
    rows = []
    for model, opts, vol, hidden, heads, dtype, train in itertools.product(
            SWIN_MLPS, OPTION_SETS, VOLS, HIDDEN, HEADS, DTYPES,
            (False, True)):
        for kind, shape, pallas in _option_sites(
                model, OPTION_SETS[opts], vol, hidden, heads, train,
                jax_fits):
            port = (None if kind == "unfused"
                    else _port_takes(kind, dtype, shape, train))
            rows.append((model, opts, vol, hidden, heads, dtype, train, kind,
                         shape, pallas, port))
    return rows


def test_sweep_swin_mlps_and_options(jax_fits, fake_lib):
    """SwInception, SwinDepth and the flagship, bare and with each option
    set, over the sweep's volumes, widths, heads, dtypes and both modes:
    every site at which the JAX block runs Pallas, the port's predicate
    takes and its wrapper's launch path accepts; the unfused attention is
    exactly the attention option set's, at every shape; the inception and
    depthwise MLPs have no kernel site."""
    rows = _option_sweep(jax_fits)
    assert len(rows) > 5000
    missed = [r for r in rows if r[9] and not r[10]]
    assert not missed, missed[:5]
    assert all(r[10] for r in rows if r[7] in ("attn", "mlp"))
    unfused = {r[1] for r in rows if r[7] == "unfused"}
    assert unfused == {"attention"}
    assert not any(r[9] for r in rows if r[7] == "unfused")
    assert {r[0] for r in rows if r[7] == "mlp"} == {"nnFormerUNETR"}
    # the anisotropic patch's grids (e.g. 48 x 48 x 96 at vol 96) resolve
    # to the same windows as the cubic ones: the kernels' shapes
    embedding = {(r[8], r[6]) for r in rows if r[1] == "embedding"
                 and r[7] == "attn"}
    assert embedding <= {(r[8], r[6]) for r in rows if r[1] == "none"
                         and r[7] == "attn"}
    seen = {(r[7], r[5], r[8], r[6]) for r in rows if r[7] != "unfused"}
    for kind, dtype, shape, train in sorted(seen, key=str):
        _launch(kind, dtype, shape, train)


@pytest.mark.parametrize("model,opts", [
    ("SwInception", "none"), ("SwinDepth", "attention"),
    ("nnFormerUNETR", "embedding"), ("nnFormerUNETR", "attention")])
def test_blocks_choose_their_attention_by_the_options(model, opts):
    """Every block of the built encoder (vol 96, patch 2 or 2 2 1, C = 24)
    runs the kernels unless the attention options are set, at every stage
    whatever its grid; the MLP is the model's."""
    from medicalsemseg_tpu_torch.config import Config
    from medicalsemseg_tpu_torch.models.factory import _swin_encoder

    cfg = Config(model=model, vol_size=96, hidden_dim=24,
                 t_fixed_ct_intensity=True, **OPTION_SETS[opts])
    enc = _swin_encoder(cfg, SWIN_MLPS[model])
    blocks = [b for layer in enc.layers for b in layer.blocks]
    assert len(blocks) == 8
    assert {b.attn.fused for b in blocks} == {opts != "attention"}
    assert {b.mlp_type for b in blocks} == {SWIN_MLPS[model]}


def _inception_convs(vol, hidden, batch):
    """(input shape (B, D, H, W, Ci), Co) of the 3^3 convs of SwInception's
    MLPs at patch 2: per stage the bottleneck's bn -> bn and bn -> branch
    convs (bn = C // 8, branch = int(4 C / 5))."""
    grid = _ceil(vol, 2)
    for i in range(4):
        c = hidden * 2 ** i
        bn, bd = max(c // 8, 1), int(4 * c / 5)
        for ci, co in ((bn, bd), (bn, bn), (bn, bd), (bn, bn), (bn, bn),
                       (bn, bd)):
            yield (batch, grid, grid, grid, ci), co
        grid = _ceil(grid, 2)


@pytest.mark.parametrize("mode", ["1", "auto"])
@pytest.mark.parametrize("batch", [2, 8])
def test_inception_convs_at_the_k5_gate(monkeypatch, mode, batch):
    """MEDSEG_DW27_PALLAS at the inception convs' shapes (inputs of 6, 12,
    24, 48 channels, outputs of 38, 76, 153, 307 at full width): the port's
    gate says what the JAX gate says wherever W is a multiple of 8 (the TPU
    layout rule the port's kernel does not need, ``dw27_applicable``): K5
    for the inputs of 16 and more channels under mode 1 (the odd output
    counts 153 and 307 on its CUDA-core route), the auto window shut."""
    import jax
    import jax.numpy as jnp
    from medicalsemseg_tpu.ops import convgrad as jax_convgrad
    from medicalsemseg_tpu.ops.pallas import dw27 as jax_dw27

    from medicalsemseg_tpu_torch.ops import convgrad

    monkeypatch.setattr(jax_dw27, "_FORCE_INTERPRET", True)
    monkeypatch.setenv("MEDSEG_DW27_PALLAS", mode)
    taken = set()
    for shape, co in _inception_convs(96, 48, batch):
        port = convgrad.dw27_eligible(shape)
        want = jax_convgrad._dw27_pallas_eligible(
            jax.ShapeDtypeStruct(shape, jnp.bfloat16))
        if shape[3] % 8 == 0:
            assert port == want, shape
        assert port == (mode == "1" and shape[-1] >= 16), shape
        if port:
            taken.add((shape[-1], co))
    assert sorted(taken) == ([(24, 24), (24, 153), (48, 48), (48, 307)]
                             if mode == "1" else [])


@pytest.mark.parametrize("batch", [2, 8])
def test_inception_convs_at_the_k9_gate(monkeypatch, batch):
    """MEDSEG_WINOGRAD_TRAIN at the inception convs' shapes: the port's
    gate is the channel window alone (16 <= C < 128, bf16), so K9 takes the
    forward of every conv with 24 or 48 input channels and the input
    gradient of every conv whose output gradient has 24, 38, 48 or 76
    channels, at every stage's grid. The JAX gate adds its layout's shape
    rules (D % 4, H % 4, (W / 2) % 8) and keeps XLA at the grids 24, 12 and
    6 of stages 2-4; the port's kernel reads any D, H, W (bounds-checked
    border), and ``chip_smoke.py``'s ``swin_opts`` phase holds each of its
    launches there against ``F.conv3d``."""
    import jax.numpy as jnp
    from medicalsemseg_tpu.ops import convgrad as jax_convgrad
    from medicalsemseg_tpu.ops.pallas import winograd3d as jax_k9

    from medicalsemseg_tpu_torch.ops import convgrad
    from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

    monkeypatch.setattr(jax_k9, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(k9, "ALLOW_CPU", True)
    monkeypatch.setenv("MEDSEG_WINOGRAD_TRAIN", "1")
    import jax
    fwd, dx, jax_only = set(), set(), set()
    for shape, co in _inception_convs(96, 48, batch):
        for tag, s in (("fwd", shape), ("dx", shape[:-1] + (co,))):
            x = torch.zeros((1,) * 5, dtype=BF16).expand(s)
            port = convgrad.winograd_train_eligible(x)
            want = jax_convgrad._wino23_eligible(
                jax.ShapeDtypeStruct(s, jnp.bfloat16))
            assert port == (16 <= s[-1] < 128), s
            if want:
                assert port, s          # the port takes whatever JAX takes
                jax_only.add(s[1])
            if port:
                (fwd if tag == "fwd" else dx).add((s[1], s[-1]))
    assert sorted(fwd) == [(6, 48), (12, 24)]
    assert sorted(dx) == [(6, 48), (12, 24), (24, 76), (48, 38)]
    assert jax_only == {48}             # stage 1's grid only
