"""The two routes of the window-attention GEMM launches: K1's and K6's
projection launch, K3's dx and dw launches.

On the CPU: the route picker (tensor cores for bf16 and fp16 with C in the
column parts of K4's dx launch, CUDA cores for fp32 and any other width),
the tiles and plans, the route codes each wrapper hands the C entry point
beside the heads launch's and counts, a route the shape cannot take raising,
and K3's plain version against the Pallas backward kernel in bf16 (interpret
mode; JAX is imported inside a fixture, so that the card's machine, which
has no JAX, runs this file's card tests). On the card (``cuda`` marker,
skipped elsewhere: ``python -m pytest --noconftest -m cuda
tests/test_torch_attention_gemm_tc.py``): the tensor-core GEMM launches
against the plain versions at the four stage widths, and K3's reruns
bit-equal.
"""

import numpy as np
import pytest
import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops import window as tw
from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("dtype,c,route", [
    (BF16, 48, "tensor_core"),     # the four flagship stages
    (BF16, 96, "tensor_core"),
    (BF16, 192, "tensor_core"),
    (BF16, 384, "tensor_core"),
    (F16, 48, "tensor_core"),      # --compute_dtype float16
    (F16, 16, "tensor_core"),
    (BF16, 320, "tensor_core"),    # four parts of 80
    (F32, 48, "cuda_core"),        # TF32 would cost fp32 its agreement
    (F32, 384, "cuda_core"),
    (BF16, 40, "cuda_core"),       # no multiple of 16
    (BF16, 112, "cuda_core"),      # 112 > 96 and no multiple of 32
    (F16, 448, "cuda_core"),       # wider than four parts of 96
    (BF16, 512, "cuda_core"),
])
def test_gemm_route_picker(dtype, c, route):
    assert kwa.gemm_route(dtype, c) == route
    assert kwa.pick_gemm_route(None, dtype, c) == route
    assert kwa.pick_gemm_route("cuda_core", dtype, c) == "cuda_core"
    if route == "cuda_core":
        with pytest.raises(ValueError, match="does not take"):
            kwa.pick_gemm_route("tensor_core", dtype, c)
    else:
        assert kwa.pick_gemm_route("tensor_core", dtype, c) == route
    with pytest.raises(ValueError, match="does not take"):
        kwa.pick_gemm_route("wgmma", dtype, c)


@pytest.mark.parametrize("c,width", [(16, 16), (48, 48), (80, 80), (96, 96),
                                     (128, 64), (192, 96), (320, 80),
                                     (384, 96)])
def test_gemm_width(c, width):
    """C up to 96, else the widest multiple of 16 up to 96 dividing C."""
    assert kwa.gemm_width(c) == width
    assert c % width == 0 and width % 16 == 0


@pytest.mark.parametrize("m,c,plan", [
    # one training step at the four stages (528 = four blocks an SM of 132)
    (884_736, 48, (528, 528)),     # all of [dWqkv | dWproj] in one block
    (110_592, 96, (528, 176)),     # 3 row groups of 128 rows
    (13_824, 192, (432, 44)),      # 6 row groups x 2 slices of 96
    (1_728, 384, (108, 11)),       # 12 row groups x 4 slices; 16-row dx tiles
    (100, 48, (2, 2)),             # fewer tiles than blocks
])
def test_bwd_gemm_plan(m, c, plan):
    assert kwa.bwd_gemm_plan(m, c, 528) == plan


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
    monkeypatch.setattr(kernels, "resident_blocks", lambda dev: 528)

    def no_plain(*a, **k):
        raise AssertionError("a launch path took the plain version")

    for mod, name in ((kwa, "window_attention_plain"),
                      (kwa, "window_attention_bwd_plain"),
                      (kga, "global_window_attention_plain")):
        monkeypatch.setattr(mod, name, no_plain)
    return lib


def _case(dtype, c=48, nh=3, ws=2, grid=(2, 1, 1), ln=False):
    n = ws ** 3
    t = grid[0] * grid[1] * grid[2]
    g = torch.Generator().manual_seed(0)
    wins = torch.randn(t, n, c, generator=g).to(dtype)
    a = dict(wqkv=torch.randn(3 * c, c, generator=g).to(dtype), bqkv=None,
             wproj=torch.randn(c, c, generator=g).to(dtype),
             bproj=torch.zeros(c), bias=torch.zeros(nh, n, n))
    kw = dict(grid_dims=grid, window=(ws,) * 3, shift=(1,) * 3,
              ln=torch.stack([torch.ones(c), torch.zeros(c)]) if ln else None,
              ln_eps=1e-5, residual=False)
    return wins, a, kw


def _launch(which, wins, a, kw, route=None, gemm_route=None):
    if which == "K1":
        return kwa._launch_fwd(wins, **a, **kw, route=route,
                               gemm_route=gemm_route)
    if which == "K3":
        b = {k: v for k, v in a.items() if k != "bproj"}
        return kwa._launch_bwd(wins, **b, dy=wins, **kw, route=route,
                               gemm_route=gemm_route)
    c = wins.shape[2]
    return kga._launch(wins, wins[:1].contiguous(), a["wqkv"][c:].contiguous(),
                       None, a["wproj"], a["bproj"], a["bias"], ln=kw["ln"],
                       ln_eps=1e-5, residual=False, route=route,
                       gemm_route=gemm_route)


def _entry(lib, which):
    return {"K1": lib.medseg_window_attention_fwd,
            "K3": lib.medseg_window_attention_bwd,
            "K6": lib.medseg_global_window_attention_fwd}[which]


def _counts(which):
    return kernels.routes(which, "heads"), kernels.routes(which, "gemm")


@pytest.mark.parametrize("which", ["K1", "K3", "K6"])
@pytest.mark.parametrize("dtype,c,nh,route,gemm,forced_gemm", [
    (BF16, 48, 3, "tensor_core", "tensor_core", None),
    (F16, 96, 6, "tensor_core", "tensor_core", None),
    (F32, 48, 3, "cuda_core", "cuda_core", None),
    (BF16, 64, 2, "cuda_core", "tensor_core", None),     # head dim 32
    (BF16, 48, 3, "tensor_core", "cuda_core", "cuda_core"),  # the A/B
    (BF16, 112, 7, "tensor_core", "cuda_core", None),    # no column parts
])
def test_wrappers_hand_over_and_count_both_routes(fake_lib, which, dtype, c,
                                                  nh, route, gemm,
                                                  forced_gemm):
    wins, a, kw = _case(dtype, c, nh)
    heads_before, gemm_before = (dict(d) for d in _counts(which))
    _launch(which, wins, a, kw, gemm_route=forced_gemm)
    args = _entry(fake_lib, which).calls[-1]
    # ... gemm_route, route, dtype, ln_eps, scale, stream
    assert args[-6] == kwa.ROUTES[gemm]
    assert args[-5] == kwa.ROUTES[route]
    heads_after, gemm_after = _counts(which)
    assert heads_after[route] == heads_before[route] + 1
    assert gemm_after[gemm] == gemm_before[gemm] + 1
    assert sum(gemm_after.values()) == sum(gemm_before.values()) + 1


@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("gemm", ["tensor_core", "cuda_core"])
def test_k3_plans_and_scratch_by_gemm_route(fake_lib, ln, gemm):
    """The tensor-core dx and dw launches get their plan's blocks and shares
    and, with the LayerNorm, the (mu, rstd) scratch the dx launch fills for
    the dw launch; the CUDA-core launches get theirs and no scratch."""
    wins, a, kw = _case(BF16, ln=ln)
    _launch("K3", wins, a, kw, gemm_route=gemm)
    args = _entry(fake_lib, "K3").calls[-1]
    m, c = wins.shape[0] * wins.shape[1], wins.shape[2]
    stats, (grid_dx, nsplit) = args[17], args[-8:-6]
    part_ln, part_w = args[13], args[15]
    assert part_ln is not None and part_w is not None
    if gemm == "tensor_core":
        assert (grid_dx, nsplit) == kwa.bwd_gemm_plan(m, c, 528)
        assert (stats is not None) == ln
    else:
        tiles = -(-m // kernels.TILE_ROWS)
        assert (grid_dx, nsplit) == (min(tiles, 528),
                                     max(1, min(tiles, 528 // (4 * c // 16))))
        assert stats is None


@pytest.mark.parametrize("which", ["K1", "K3", "K6"])
@pytest.mark.parametrize("dtype,c,nh", [(F32, 48, 3), (BF16, 112, 7),
                                        (F32, 96, 6)])
def test_forcing_the_tensor_cores_where_the_width_cannot_take_them(
        fake_lib, which, dtype, c, nh):
    """fp32, and bf16 at widths without column parts, take the CUDA cores:
    asking for the tensor cores raises before any launch."""
    wins, a, kw = _case(dtype, c, nh)
    with pytest.raises(ValueError, match="GEMM launches"):
        _launch(which, wins, a, kw, gemm_route="tensor_core")
    assert _entry(fake_lib, which).calls == []


@pytest.mark.parametrize("which", ["K1", "K3", "K6"])
def test_a_failed_launch_raises_on_either_gemm_route(fake_lib, which):
    """No route falls back to the other or to the plain version: the error
    the entry point returns is raised, and nothing is counted."""
    _entry(fake_lib, which).err = 1
    wins, a, kw = _case(BF16)
    for gemm in ("tensor_core", "cuda_core"):
        before = tuple(dict(d) for d in _counts(which))
        with pytest.raises(RuntimeError, match="launch refused"):
            _launch(which, wins, a, kw, gemm_route=gemm)
        assert tuple(dict(d) for d in _counts(which)) == before
    assert len(_entry(fake_lib, which).calls) == 2


@pytest.mark.parametrize("which", ["K1", "K3"])
def test_the_tensor_cores_refuse_an_unaligned_start(fake_lib, which):
    """The tensor-core GEMM launches copy rows in 16-byte pieces."""
    wins, a, kw = _case(BF16)
    flat = torch.zeros(wins.numel() + 1, dtype=BF16)
    shifted = flat[1:].view(wins.shape)
    shifted.copy_(wins)
    with pytest.raises(ValueError, match="16-byte boundary"):
        _launch(which, shifted, a, kw, gemm_route="tensor_core")
    assert _entry(fake_lib, which).calls == []


def test_the_library_is_built_without_the_attention_parts_bits():
    """MEDSEG_ATTN_SKIP compiles parts of the tensor-core attention kernels
    out (the attn_parts phase builds its own variants); the sources default
    it to 0, and the new GEMM launches read it."""
    import os

    with open(os.path.join(kernels.CSRC_DIR, "mma_tile.cuh")) as f:
        assert "#ifndef MEDSEG_ATTN_SKIP\n#define MEDSEG_ATTN_SKIP 0\n" in f.read()
    for src in ("window_attention.cu", "window_attention_bwd.cu"):
        with open(os.path.join(kernels.CSRC_DIR, src)) as f:
            text = f.read()
        assert "MEDSEG_ATTN_SKIP & 32" in text and "MEDSEG_ATTN_SKIP & 256" in text
    assert not any("MEDSEG_ATTN_SKIP" in flag for flag in kernels.NVCC_FLAGS)


# ---- K3's plain version against the Pallas backward in bf16 (interpret
# mode): the rounding points the dx and dw launches keep

# (ws, shift, ln, residual); b = 2 volumes of 2 x 2 x 2 windows, C = 32,
# two heads of 16
PLAIN_CASES = ((2, 1, True, False), (2, 0, False, False), (3, 1, True, True),
               (2, 1, False, True))
PLAIN_NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias", "dln")
# Both sides take the same bf16 inputs and round at the same points (xn, q /
# k / v, p, o, dout, ds, dqkv, dx); their fp32 sums run in other orders, so
# a rounding can flip by one bf16 ulp (2^-8 relative) and move what depends
# on it. The weight gradients sum over all 2 x 8 x N tokens: their error is
# small against the tensor's scale, not element by element. dx: elementwise,
# a few ulps; the rest: the error's norm within 1 % of the reference's, no
# element off by more than 3 % of the largest magnitude.
DX_TOL = 3e-2
NORM_TOL, MAX_TOL = 1e-2, 3e-2


def _plain_inputs(seed, ws, c=32, nh=2, b=2):
    rng = np.random.default_rng(seed)
    n = ws ** 3
    dims = (2 * ws,) * 3
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"x": f(b, *dims, c), "dy": f(b, *dims, c),
            "wqkv": f(c, 3 * c) * c ** -0.5, "bqkv": f(3 * c) * 0.1,
            "wproj": f(c, c) * c ** -0.5, "bias": f(nh, n, n) * 0.5,
            "ln": np.stack([f(c) * 0.3 + 1.0, f(c) * 0.1])}


def _bf16(a):
    """fp32 numpy values rounded to bf16, as fp32 numpy (both sides start
    from the same bf16 inputs)."""
    return torch.from_numpy(a).to(BF16).float().numpy()


@pytest.fixture(scope="module")
def pallas_bwd():
    """Every case's Pallas backward outputs in bf16 (JAX imported here)."""
    import jax.numpy as jnp

    from medicalsemseg_tpu.ops.pallas import window_attention as pwa
    from medicalsemseg_tpu.ops.window import window_partition as jwp

    results = []
    for i, (ws, ss, ln, res) in enumerate(PLAIN_CASES):
        p = {k: _bf16(v) if k in ("x", "dy", "wqkv", "wproj") else v
             for k, v in _plain_inputs(i, ws).items()}
        bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
        kw = dict(num_heads=2, wpb=2, shifted=ss > 0, grid_dims=(2, 2, 2),
                  ws=ws, ss=ss, interpret=True, residual=res,
                  ln=(jnp.asarray(p["ln"][0]), jnp.asarray(p["ln"][1]))
                  if ln else None)
        out = pwa._fused_bwd_windows(
            jwp(bf(p["x"]), ws), bf(p["wqkv"]), jnp.asarray(p["bqkv"]),
            bf(p["wproj"]), jnp.asarray(p["bias"]), jwp(bf(p["dy"]), ws),
            **kw)
        results.append((p, [np.asarray(o.astype(jnp.float32)) for o in out]))
    return results


@pytest.mark.parametrize("i", range(len(PLAIN_CASES)))
def test_plain_backward_matches_pallas_in_bf16(pallas_bwd, i):
    ws, ss, ln, res = PLAIN_CASES[i]
    p, want = pallas_bwd[i]
    got = kwa.window_attention_bwd(
        tw.window_partition(torch.from_numpy(p["x"]).to(BF16), ws),
        torch.from_numpy(p["wqkv"]).t().to(BF16),
        torch.from_numpy(p["bqkv"]),
        torch.from_numpy(p["wproj"]).t().to(BF16),
        torch.from_numpy(p["bias"]),
        tw.window_partition(torch.from_numpy(p["dy"]).to(BF16), ws),
        grid_dims=(2, 2, 2), window=(ws,) * 3, shift=(ss,) * 3,
        ln=torch.from_numpy(p["ln"]) if ln else None, residual=res)
    dx, dwqkv, dbqkv, dwproj, dbproj, dbias, dln = got
    assert dx.dtype == BF16 and dwqkv.dtype == F32
    # the JAX weights are [in, out]
    mine = [dx, dwqkv.t(), dbqkv, dwproj.t(), dbproj, dbias]
    if ln:
        mine.append(dln)
    else:
        assert dln is None
    assert len(want) == len(mine)
    for name, g, w in zip(PLAIN_NAMES, mine, want):
        g = g.float().numpy()
        assert g.shape == w.shape, name
        if name == "dx":
            np.testing.assert_allclose(g, w, rtol=DX_TOL, atol=DX_TOL,
                                       err_msg=name)
            continue
        err = np.abs(g - w)
        assert np.linalg.norm(g - w) <= NORM_TOL * np.linalg.norm(w), name
        assert err.max() <= MAX_TOL * np.abs(w).max(), name


# ---- on the card: the tensor-core GEMM launches against the plain versions

# flagship and GC-ViT stages: (C, heads), head dim 16 throughout
STAGES = ((48, 3), (96, 6), (192, 12), (384, 24))
# tolerances as in tests/test_torch_attention_tc.py: elementwise, gradient
# error norm, largest gradient error
TOL = {"bfloat16": (3e-2, 1e-2, 5e-2), "float16": (4e-3, 2e-3, 1e-2)}
WS = 6
K3_NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias", "dln")


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(9)


def _close(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= tol + tol * w.abs()).all(), (g - w).abs().max()


def _card_case(gen, batch, grid, c, nh, dtype, ws=WS, qkv_bias=True):
    dev = "cuda"
    n = ws ** 3
    x = torch.randn(batch, grid, grid, grid, c, generator=gen,
                    device=dev).to(dtype)
    wins = tw.window_partition(x, ws).contiguous()
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
def test_k1_projection_tensor_cores(gen, c, nh, shift, ln, res, dtype):
    grid = 12                      # 2 x 2 x 2 windows: every mask region
    wins, a, lnp = _card_case(gen, 2, grid, c, nh, getattr(torch, dtype),
                              qkv_bias=ln)
    kw = dict(grid_dims=(grid // WS,) * 3, window=(WS,) * 3,
              shift=(shift,) * 3, ln=lnp if ln else None, residual=res)
    before = dict(kernels.routes("K1", "gemm"))
    got = kwa.window_attention(wins, **a, **kw)
    torch.cuda.synchronize()
    assert (kernels.routes("K1", "gemm")["tensor_core"]
            == before["tensor_core"] + 1)
    want = kwa.window_attention_plain(wins, **a, **kw)
    _close(got, want, TOL[dtype][0])
    # the same heads launch with the CUDA-core projection: the two
    # projection launches round at the same points
    other = kwa.window_attention(wins, **a, **kw, gemm_route="cuda_core")
    _close(got, other, TOL[dtype][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("absorbed", [True, False])
@pytest.mark.parametrize("c,nh", STAGES)
def test_k6_projection_tensor_cores(gen, c, nh, absorbed, dtype):
    """GCViTUNETR's global attention through the new projection launch."""
    dt, batch, grid = getattr(torch, dtype), 2, 12
    wins, a, lnp = _card_case(gen, batch, grid, c, nh, dt)
    args = dict(q_global=torch.randn(batch, WS ** 3, c, generator=gen,
                                     device="cuda").to(dt),
                wkv=a["wqkv"][c:].contiguous(),
                bkv=a["bqkv"][c:].contiguous() if absorbed else None,
                wproj=a["wproj"], bproj=a["bproj"], bias=a["bias"])
    kw = dict(ln=lnp if absorbed else None, residual=absorbed)
    before = dict(kernels.routes("K6", "gemm"))
    got = kga.global_window_attention(wins, **args, **kw)
    torch.cuda.synchronize()
    assert (kernels.routes("K6", "gemm")["tensor_core"]
            == before["tensor_core"] + 1)
    _close(got, kga.global_window_attention_plain(wins, **args, **kw),
           TOL[dtype][0])


def _check_k3(got, want, dtype):
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("ln,res", [(True, False), (True, True),
                                    (False, False), (False, True)])
@pytest.mark.parametrize("shift", [0, WS // 2])
@pytest.mark.parametrize("c,nh,grid", [
    (48, 3, 12), (96, 6, 12), (192, 12, 12),
    (384, 24, 6),                  # the last stage: one window a volume
])
def test_k3_dx_dw_tensor_cores(gen, c, nh, grid, shift, ln, res, dtype):
    """Every output of the backward at batch 8 with the tensor-core dx and
    dw launches, and a rerun bit-equal."""
    dt = getattr(torch, dtype)
    wins, a, lnp = _card_case(gen, 8, grid, c, nh, dt, qkv_bias=ln)
    dy = torch.randn(wins.shape, generator=gen, device="cuda").to(dt)
    b = {k: v for k, v in a.items() if k != "bproj"}
    kw = dict(grid_dims=(grid // WS,) * 3, window=(WS,) * 3,
              shift=(shift,) * 3, ln=lnp if ln else None, residual=res)
    before = dict(kernels.routes("K3", "gemm"))
    got = kwa.window_attention_bwd(wins, dy=dy, **b, **kw)
    torch.cuda.synchronize()
    assert (kernels.routes("K3", "gemm")["tensor_core"]
            == before["tensor_core"] + 1)
    _check_k3(got, kwa.window_attention_bwd_plain(wins, dy=dy, **b, **kw),
              dtype)
    again = kwa.window_attention_bwd(wins, dy=dy, **b, **kw)
    for g, h in zip(got, again):
        assert (g is None and h is None) or torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("c,nh", STAGES)
def test_k3_ragged_tiles_and_mixed_routes(gen, c, nh, ln):
    """3^3 windows (M = 216 tokens: ragged 64-token and 16-token tiles), the
    CUDA-core heads launch beside the tensor-core GEMM launches, and the
    reverse."""
    wins, a, lnp = _card_case(gen, 1, 6, c, nh, torch.bfloat16, ws=3)
    dy = torch.randn(wins.shape, generator=gen,
                     device="cuda").to(torch.bfloat16)
    b = {k: v for k, v in a.items() if k != "bproj"}
    kw = dict(grid_dims=(2, 2, 2), window=(3,) * 3, shift=(1,) * 3,
              ln=lnp if ln else None, residual=True)
    want = kwa.window_attention_bwd_plain(wins, dy=dy, **b, **kw)
    for route, gemm in (("tensor_core", "tensor_core"),
                        ("cuda_core", "tensor_core"),
                        ("tensor_core", "cuda_core")):
        got = kwa.window_attention_bwd(wins, dy=dy, **b, **kw, route=route,
                                       gemm_route=gemm)
        torch.cuda.synchronize()
        _check_k3(got, want, "bfloat16")
    fwd = kwa.window_attention(wins, **a, **kw)
    _close(fwd, kwa.window_attention_plain(wins, **a, **kw), TOL["bfloat16"][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("c,nh", [(16, 1), (32, 2), (80, 5), (128, 8),
                                  (320, 20)])
def test_other_widths_the_route_takes(gen, c, nh, dtype):
    """Widths no shipped model uses but the GEMM route takes: one and
    several k chunks and column tiles of 16 to 80 (gemm_width), one to four
    column parts in dx, dw's row groups straddling the dWqkv / dWproj
    boundary inside a warp (C = 80: rows 224-239 and 240-255)."""
    dt = getattr(torch, dtype)
    wins, a, lnp = _card_case(gen, 1, 12, c, nh, dt)
    dy = torch.randn(wins.shape, generator=gen, device="cuda").to(dt)
    b = {k: v for k, v in a.items() if k != "bproj"}
    kw = dict(grid_dims=(2, 2, 2), window=(WS,) * 3, shift=(WS // 2,) * 3,
              ln=lnp, residual=True)
    assert kwa.gemm_route(dt, c) == "tensor_core"
    got = kwa.window_attention(wins, **a, **kw)
    torch.cuda.synchronize()
    _close(got, kwa.window_attention_plain(wins, **a, **kw), TOL[dtype][0])
    got = kwa.window_attention_bwd(wins, dy=dy, **b, **kw)
    torch.cuda.synchronize()
    _check_k3(got, kwa.window_attention_bwd_plain(wins, dy=dy, **b, **kw),
              dtype)
    again = kwa.window_attention_bwd(wins, dy=dy, **b, **kw)
    assert all(torch.equal(g, h) for g, h in zip(got, again))
