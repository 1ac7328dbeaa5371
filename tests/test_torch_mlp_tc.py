"""The two routes of the token-MLP kernels K2 (forward) and K4 (backward).

On the CPU: the route pickers (tensor cores for bf16 and fp16 with widths in
multiples of 16, CUDA cores for fp32 and any other shape), the launch plans
(column tiles and hidden splits of K2, channel slices and token shares of
K4), the route code and plan each wrapper hands the C entry point and
counts, a failed launch raising instead of taking the plain version (a fake
library stands in for the built one), the library built without the
MEDSEG_MLP_SKIP bits of the parts phase, and the plain versions against the
Pallas kernels in interpret mode at shapes the tensor-core route takes (C =
16 and 32, hidden 3C and 4C, token counts that are no multiple of the 64-row
tile), all in one jitted JAX call. On the card (``cuda`` marker, skipped
elsewhere: ``python -m pytest --noconftest -m cuda
tests/test_torch_mlp_tc.py``): both routes in bf16 and fp16 against the
plain versions at every flagship stage width, at GC-ViT's hidden 3C and in
the hidden-split form of the deep stages, K2 with other output widths than
C; K4's reruns bit-equal.
"""

import subprocess

import numpy as np
import pytest
import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("dtype,c,co,hdim,route", [
    (BF16, 48, 48, 192, "tensor_core"),      # flagship stage 1
    (F16, 384, 384, 1536, "tensor_core"),    # stage 4, --compute_dtype float16
    (BF16, 48, 48, 144, "tensor_core"),      # GC-ViT: hidden 3C
    (BF16, 32, 16, 64, "tensor_core"),       # Co != C
    (BF16, 768, 768, 3072, "tensor_core"),   # the widest the route takes
    (F32, 48, 48, 192, "cuda_core"),         # TF32 would cost fp32 its match
    (BF16, 12, 12, 48, "cuda_core"),         # C no multiple of 16
    (BF16, 48, 48, 200, "cuda_core"),        # H no multiple of 16
    (BF16, 784, 784, 3136, "cuda_core"),     # wider than 768
])
def test_forward_route_picker(dtype, c, co, hdim, route):
    assert kmlp.mlp_route(dtype, c, co, hdim) == route
    what = f"{dtype} with C={c}"
    assert kernels.pick_route(None, route, what) == route
    assert kernels.pick_route("cuda_core", route, what) == "cuda_core"
    if route == "cuda_core":
        with pytest.raises(ValueError, match="does not take"):
            kernels.pick_route("tensor_core", route, what)
    with pytest.raises(ValueError, match="does not take"):
        kernels.pick_route("wgmma", route, what)


@pytest.mark.parametrize("dtype,c,hdim,parts,route", [
    (BF16, 48, 192, 1, "tensor_core"),
    (BF16, 96, 384, 1, "tensor_core"),
    (F16, 192, 768, 2, "tensor_core"),       # two column parts of 96
    (BF16, 384, 1536, 4, "tensor_core"),     # four column parts of 96
    (BF16, 16, 48, 1, "tensor_core"),
    (BF16, 144, 576, 0, "cuda_core"),        # no parts of a multiple of 16
    (F32, 48, 192, 1, "cuda_core"),
    (BF16, 48, 200, 1, "cuda_core"),         # H no multiple of 16
    (BF16, 512, 2048, 0, "cuda_core"),
])
def test_backward_route_picker(dtype, c, hdim, parts, route):
    assert kmlp.dx_parts(c) == parts
    assert kmlp.mlp_bwd_route(dtype, c, hdim) == route


@pytest.mark.parametrize("co,tile", [(16, 16), (48, 48), (80, 80), (96, 96),
                                     (192, 192), (384, 192), (512, 128),
                                     (768, 192)])
def test_column_tiles(co, tile):
    assert kmlp.co_tile(co) == tile
    assert co % tile == 0 and tile % 16 == 0 and tile <= kmlp.TC_MAX_CO_TILE


# the flagship's stages: (tokens of one predictor call, of one training
# step, C); 132 SMs as on an H100
STAGE_TOKENS = ((16 * 48 ** 3, 8 * 48 ** 3, 48), (16 * 24 ** 3, 8 * 24 ** 3, 96),
                (16 * 12 ** 3, 8 * 12 ** 3, 192), (16 * 6 ** 3, 8 * 6 ** 3, 384))


@pytest.mark.parametrize("predict,train,c", STAGE_TOKENS)
def test_forward_plans(predict, train, c):
    """The hidden split opens only where the token and column tiles give
    fewer than two blocks an SM (the last stage), and no split is empty."""
    hdim = 4 * c
    nch = -(-hdim // kmlp.TC_HIDDEN_CHUNK)
    for m in (predict, train):
        cot, hsplit = kmlp.fwd_plan(m, c, hdim, 132)
        assert cot == kmlp.co_tile(c)
        chunks = -(-nch // hsplit)
        assert 1 <= hsplit <= nch and (hsplit - 1) * chunks < nch
        assert (hsplit > 1) == (c == 384), (m, c, hsplit)


@pytest.mark.parametrize("predict,train,c", STAGE_TOKENS)
def test_backward_plans(predict, train, c):
    hdim = 4 * c
    sl, shares, grid_a, mp = kmlp.bwd_plan(train, c, hdim, 132)
    assert sl == min(c, 96) and c % sl == 0
    groups = (hdim // 64) * (c // sl)
    assert 1 <= shares <= -(-train // 64) and groups * shares <= 4 * 132
    assert 1 <= grid_a <= 4 * 132
    assert mp % 64 == 0 and train <= mp < train + 64


class _FakeEntry:
    """A C entry point: remembers its arguments, returns ``err``."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


class _FakeLibrary:
    def __init__(self, err):
        self.medseg_fused_mlp_fwd = _FakeEntry(err)
        self.medseg_fused_mlp_bwd = _FakeEntry(err)

    def medseg_cuda_error_string(self, err):
        return b"launch refused"


@pytest.fixture
def fake_lib(monkeypatch):
    """The wrappers' launch paths on CPU tensors, with a library whose entry
    points return ``lib.err``; the plain versions must not be reached."""
    lib = _FakeLibrary(0)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(kernels, "sm_count", lambda dev: 132)
    monkeypatch.setattr(kernels, "resident_blocks", lambda dev: 528)

    def no_plain(*a, **k):
        raise AssertionError("a launch path took the plain version")

    monkeypatch.setattr(kmlp, "fused_mlp_plain", no_plain)
    monkeypatch.setattr(kmlp, "fused_mlp_bwd_plain", no_plain)
    return lib


def _case(dtype, m=100, c=32, hdim=128):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(m, c, generator=g).to(dtype)
    a = dict(w1=torch.randn(hdim, c, generator=g).to(dtype),
             b1=torch.zeros(hdim),
             w2=torch.randn(c, hdim, generator=g).to(dtype), b2=torch.zeros(c))
    return a, x, torch.stack([torch.ones(c), torch.zeros(c)])


def _launch(which, dtype, route=None, **shape):
    a, x, ln = _case(dtype, **shape)
    if which == "K2":
        return kmlp._launch_fwd(x, a["w1"], a["b1"], a["w2"], a["b2"], ln,
                                1e-5, True, route)
    return kmlp._launch_bwd(x, a["w1"], a["b1"], a["w2"], ln, x, 1e-5, True,
                            route)


def _entry(lib, which):
    return {"K2": lib.medseg_fused_mlp_fwd,
            "K4": lib.medseg_fused_mlp_bwd}[which]


def _counts(which):
    return dict({"K2": kernels.routes("K2"),
                 "K4": kernels.routes("K4")}[which])


@pytest.mark.parametrize("which", ["K2", "K4"])
@pytest.mark.parametrize("dtype,forced,route", [
    (BF16, None, "tensor_core"),
    (F16, None, "tensor_core"),
    (F32, None, "cuda_core"),
    (BF16, "cuda_core", "cuda_core"),   # the kernels phase's A/B
])
def test_wrappers_hand_over_and_count_the_route(fake_lib, which, dtype,
                                                forced, route):
    before = _counts(which)
    _launch(which, dtype, forced)
    args = _entry(fake_lib, which).calls[-1]
    # K2: ... residual, route, co_tile, hsplit, dtype, ln_eps, stream;
    # K4: ... slice, residual, route, dtype, ln_eps, stream
    at = -6 if which == "K2" else -4
    assert args[at] == kmlp.ROUTES[route]
    assert args[-3] == kernels.dtype_code("x", dtype)
    after = _counts(which)
    assert after[route] == before[route] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    tc = route == "tensor_core"
    if which == "K2":
        part, (cot, hsplit) = args[7], tuple(args[-5:-3])
        # 100 tokens are two tiles: the hidden split fills the card
        assert (cot, hsplit) == ((32, 2) if tc else (0, 0))
        assert (part is not None) == (hsplit > 1)
    else:
        dhb, sl = args[7], args[-6]
        assert (dhb is not None) == tc and sl == (32 if tc else 0)


def test_the_hidden_split_gets_its_partials(fake_lib):
    """K2 at a last-stage shape: H split four ways, the fp32 partials of y
    allocated for the C entry point."""
    _launch("K2", BF16, m=1728, c=384, hdim=1536)
    args = fake_lib.medseg_fused_mlp_fwd.calls[-1]
    assert tuple(args[-5:-3]) == (192, 4)
    assert args[7] is not None


@pytest.mark.parametrize("which", ["K2", "K4"])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_a_failed_launch_raises(fake_lib, which, dtype):
    """No route falls back to the other or to the plain version: the error
    the entry point returns is raised, and nothing is counted."""
    _entry(fake_lib, which).err = 1
    before = (_counts(which), kernels.launches())
    with pytest.raises(RuntimeError, match="launch refused"):
        _launch(which, dtype)
    assert len(_entry(fake_lib, which).calls) == 1
    assert (_counts(which), kernels.launches()) == before


@pytest.mark.parametrize("which", ["K2", "K4"])
@pytest.mark.parametrize("dtype,shape", [(F32, {}), (BF16, {"c": 24})])
def test_forcing_the_tensor_cores_where_they_do_not_apply_raises(
        fake_lib, which, dtype, shape):
    with pytest.raises(ValueError, match="does not take"):
        _launch(which, dtype, "tensor_core", **shape)
    assert _entry(fake_lib, which).calls == []


@pytest.mark.parametrize("which", ["K2", "K4"])
def test_the_tensor_cores_refuse_an_unaligned_start(fake_lib, which):
    """The kernels copy 16-byte pieces: a contiguous view that starts one
    element into its storage is refused before the launch."""
    a, x, ln = _case(BF16, m=101)
    x = x.flatten()[1:3201].view(100, 32)
    assert x.is_contiguous() and x.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        if which == "K2":
            kmlp._launch_fwd(x, a["w1"], a["b1"], a["w2"], a["b2"], ln, 1e-5,
                             True, None)
        else:
            kmlp._launch_bwd(x, a["w1"], a["b1"], a["w2"], ln, x, 1e-5, True,
                             None)
    assert _entry(fake_lib, which).calls == []


def test_the_library_is_built_without_the_parts_bits(tmp_path, monkeypatch):
    """MEDSEG_MLP_SKIP compiles parts of the tensor-core kernels out (the
    mlp_parts phase builds its own variants); the library's nvcc commands
    never set it, and the sources default it to 0."""
    commands = []

    class _Proc:
        returncode = 1

        def __init__(self, cmd, **kw):
            commands.append(cmd)

        def communicate(self):
            return "", "stopped here"

    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", _Proc)
    with pytest.raises(RuntimeError, match="stopped here"):
        kernels._build(kernels.library_path())
    assert any(cmd[-1].endswith("mlp.cu") for cmd in commands)
    assert not any("MEDSEG_MLP_SKIP" in arg for cmd in commands for arg in cmd)
    with open(f"{kernels.CSRC_DIR}/mlp_tile.cuh") as f:
        assert "#ifndef MEDSEG_MLP_SKIP\n#define MEDSEG_MLP_SKIP 0\n" in f.read()


# ---- the plain versions against the Pallas kernels (interpret mode) at
# shapes the tensor-core route takes, fp32 on both sides

# forward: (tokens, C, hidden, LN and shortcut); backward: (tokens, C,
# hidden, shortcut)
FWD_CASES = ((70, 16, 48, True), (100, 16, 64, False), (130, 32, 96, True),
             (65, 32, 128, False))
BWD_CASES = ((70, 16, 64, True), (100, 32, 96, False), (130, 16, 48, True),
             (65, 32, 128, False))
# sums in other orders, and the GELU's erf: the Pallas kernels' polynomial
# (abs err <= 1.5e-7) where the plain forward takes torch's erf; weight
# gradients sum over all tokens, so their tolerance is relative
FWD_TOL = 3e-5
BWD_RTOL, BWD_ATOL = 1e-4, 1e-5


def _inputs(seed, m, c, hdim):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"x": f(m, c), "dy": f(m, c), "w1": f(c, hdim) * c ** -0.5,
            "b1": f(hdim) * 0.1, "w2": f(hdim, c) * hdim ** -0.5,
            "b2": f(c) * 0.1, "scale": f(c) * 0.3 + 1.0, "bias": f(c) * 0.1}


@pytest.fixture(scope="module")
def pallas_results():
    """Every case's Pallas outputs, from one jitted call (JAX is imported
    here: the card's machine runs this file's card tests without it)."""
    import jax
    import jax.numpy as jnp

    import medicalsemseg_tpu.ops.pallas.mlp as pmlp

    fwd = [_inputs(i, *case[:3]) for i, case in enumerate(FWD_CASES)]
    bwd = [_inputs(10 + i, *case[:3]) for i, case in enumerate(BWD_CASES)]

    def run(fwd_in, bwd_in):
        outs = []
        for p, (_, _, _, ln_res) in zip(fwd_in, FWD_CASES):
            outs.append(pmlp.fused_mlp(
                p["x"], p["w1"], p["b1"], p["w2"], p["b2"],
                ln_scale=p["scale"] if ln_res else None,
                ln_bias=p["bias"] if ln_res else None, residual=ln_res,
                interpret=True))
        grads = []
        for p, (_, _, _, res) in zip(bwd_in, BWD_CASES):
            def loss(x, scale, bias, w1, b1, w2, b2, p=p, res=res):
                y = pmlp.fused_mlp_trainable(x, scale, bias, w1, b1, w2, b2,
                                             res, 1e-5, True)
                return (y * p["dy"]).sum()

            grads.append(jax.grad(loss, argnums=tuple(range(7)))(
                *(p[k] for k in ("x", "scale", "bias", "w1", "b1", "w2",
                                 "b2"))))
        return outs, grads

    as_jnp = lambda ps: [{k: jnp.asarray(v) for k, v in p.items()}  # noqa: E731
                         for p in ps]
    outs, grads = jax.jit(run)(as_jnp(fwd), as_jnp(bwd))
    grads = [(g[0], np.stack([g[1], g[2]]), np.asarray(g[3]).T, g[4],
              np.asarray(g[5]).T, g[6]) for g in grads]
    return fwd, bwd, outs, grads


@pytest.mark.parametrize("i", range(len(FWD_CASES)))
def test_plain_forward_matches_pallas(pallas_results, i):
    fwd, _, outs, _ = pallas_results
    p, ln_res = fwd[i], FWD_CASES[i][3]
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = kmlp.fused_mlp(t["x"], t["w1"].t(), t["b1"], t["w2"].t(), t["b2"],
                         ln=torch.stack([t["scale"], t["bias"]])
                         if ln_res else None, residual=ln_res)
    np.testing.assert_allclose(got.numpy(), np.asarray(outs[i]), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("i", range(len(BWD_CASES)))
def test_plain_backward_matches_pallas(pallas_results, i):
    _, bwd, _, grads = pallas_results
    p, res = bwd[i], BWD_CASES[i][3]
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = kmlp.fused_mlp_bwd(t["x"], t["w1"].t(), t["b1"], t["w2"].t(),
                             torch.stack([t["scale"], t["bias"]]), t["dy"],
                             residual=res)
    for name, g, w in zip(("dx", "dln", "dw1", "db1", "dw2", "db2"), got,
                          grads[i]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=BWD_RTOL,
                                   atol=BWD_ATOL, err_msg=name)


# ---- on the card: both routes against the plain versions

# flagship stages (C, hidden 4C) and GC-ViT's (hidden 3C); tolerances as in
# tests/test_torch_kernels_cuda.py (DTYPE_TOL): elementwise, gradient error
# norm, largest gradient error
WIDTHS = ((48, 192), (96, 384), (192, 768), (384, 1536), (48, 144),
          (96, 288), (192, 576), (384, 1152))
TOL = {"bfloat16": (3e-2, 1e-2, 5e-2), "float16": (4e-3, 2e-3, 1e-2)}
K4_NAMES = ("dx", "dln", "dw1", "db1", "dw2", "db2")


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(8)


def _card_case(gen, m, c, hdim, dtype):
    dev = "cuda"
    x = torch.randn(m, c, generator=gen, device=dev).to(dtype)
    a = dict(
        w1=(torch.randn(hdim, c, generator=gen, device=dev)
            * c ** -0.5).to(dtype),
        b1=torch.randn(hdim, generator=gen, device=dev) * 0.1,
        w2=(torch.randn(c, hdim, generator=gen, device=dev)
            * hdim ** -0.5).to(dtype),
        b2=torch.randn(c, generator=gen, device=dev) * 0.1)
    ln = torch.stack([1 + 0.3 * torch.randn(c, generator=gen, device=dev),
                      0.1 * torch.randn(c, generator=gen, device=dev)])
    return x, a, ln


def _close(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= tol + tol * w.abs()).all(), (g - w).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("route", ["tensor_core", "cuda_core"])
@pytest.mark.parametrize("ln_res", [True, False])
@pytest.mark.parametrize("m", [3000, 1728])   # 1728: the hidden split at 384
@pytest.mark.parametrize("c,hdim", WIDTHS)
def test_k2_routes(gen, c, hdim, m, ln_res, route, dtype):
    x, a, ln = _card_case(gen, m, c, hdim, getattr(torch, dtype))
    kw = dict(ln=ln if ln_res else None, residual=ln_res)
    before = dict(kernels.routes("K2"))
    got = kmlp.fused_mlp(x, **a, **kw, route=route)
    torch.cuda.synchronize()
    assert kernels.routes("K2")[route] == before[route] + 1
    _close(got, kmlp.fused_mlp_plain(x, **a, **kw), TOL[dtype][0])
    if route == "tensor_core":  # a hidden split adds its partials in order
        assert torch.equal(got, kmlp.fused_mlp(x, **a, **kw, route=route))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("route", ["tensor_core", "cuda_core"])
@pytest.mark.parametrize("res", [True, False])
@pytest.mark.parametrize("c,hdim", WIDTHS[:4] + ((16, 48), (32, 128)))
def test_k4_routes(gen, c, hdim, res, route, dtype):
    """Every output of the backward at a training step's last-stage token
    count and a ragged one, and a rerun bit-equal."""
    dt = getattr(torch, dtype)
    m = 1728 if c == 384 else 4000
    x, a, ln = _card_case(gen, m, c, hdim, dt)
    args = dict(w1=a["w1"], b1=a["b1"], w2=a["w2"], ln=ln,
                dy=torch.randn(x.shape, generator=gen, device="cuda").to(dt),
                residual=res)
    before = dict(kernels.routes("K4"))
    got = kmlp.fused_mlp_bwd(x, **args, route=route)
    torch.cuda.synchronize()
    assert kernels.routes("K4")[route] == before[route] + 1
    want = kmlp.fused_mlp_bwd_plain(x, **args)
    _, norm_tol, max_tol = TOL[dtype]
    for name, g, w in zip(K4_NAMES, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        gf, wf = g.float(), w.float()
        assert torch.isfinite(gf).all(), name
        assert (gf - wf).norm() <= norm_tol * wf.norm(), name
        assert (gf - wf).abs().max() <= max_tol * wf.abs().max(), name
    again = kmlp.fused_mlp_bwd(x, **args, route=route)
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("m", [3000, 100])    # 100 tokens: a hidden split
@pytest.mark.parametrize("c,co,hdim", [(32, 16, 128), (48, 96, 192),
                                       (96, 48, 384), (64, 512, 256)])
def test_k2_tensor_cores_with_other_output_widths(gen, c, co, hdim, m, ln,
                                                  dtype):
    """Co != C (no shortcut): the column tiles of Co and the hidden split
    against the plain version; no model path takes this form."""
    dt = getattr(torch, dtype)
    x, a, lnp = _card_case(gen, m, c, hdim, dt)
    a["w2"] = (torch.randn(co, hdim, generator=gen, device="cuda")
               * hdim ** -0.5).to(dt)
    a["b2"] = torch.randn(co, generator=gen, device="cuda") * 0.1
    kw = dict(ln=lnp if ln else None, residual=False)
    before = dict(kernels.routes("K2"))
    got = kmlp.fused_mlp(x, **a, **kw)
    torch.cuda.synchronize()
    assert kernels.routes("K2")["tensor_core"] == before["tensor_core"] + 1
    _close(got, kmlp.fused_mlp_plain(x, **a, **kw), TOL[dtype][0])
