"""Head dims 48 and 96 (``--num_heads 1 2 4 8`` at ``--hidden_dim`` 48 and
96): K1, K3, K6 and K7 against the JAX package, the predicates, the launch
paths, and on the card the CUDA-core routes against their plain versions.

On the CPU the wrappers take their plain PyTorch versions; they are held
against the Pallas kernels in interpret mode (K1, K6, K7) and against
``jax.vjp`` of the trainable fused window attention, whose backward is the
Pallas backward kernel in interpret mode (K3, through ``WindowAttentionFn``),
at C = 48 and 96 with one or two heads, in fp32. The launch paths run with a
stand-in library in place of the CUDA one. JAX is imported inside the tests
that use it, so ``python -m pytest --noconftest -m cuda
tests/test_torch_head_dim.py`` runs the card cases on a machine without it.
"""

import numpy as np
import pytest
import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops import window as tw
from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

# fp32 on both sides, sums in other orders over head dims of 48 and 96 (the
# one-pass forms' tests hold 2e-5 at head dims up to 8)
RTOL = ATOL = 1e-4

# (C, heads): head dim 48 with one and two heads, head dim 96
SHAPES = [(48, 1), (96, 2), (96, 1)]
SHAPE_IDS = ["c48_hd48", "c96_hd48", "c96_hd96"]


def _arrays(seed, **shapes):
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, scale) in shapes.items():
        out[name] = (rng.normal(size=shape) * scale).astype(np.float32)
    return out


def _window_inputs(seed, b, dims, c, nh, ws):
    p = _arrays(seed, x=((b, *dims, c), 1.0), dy=((b, *dims, c), 1.0),
                q=((b, ws, ws, ws, c), 1.0),
                wqkv=((c, 3 * c), c ** -0.5), bqkv=((3 * c,), 0.1),
                wkv=((c, 2 * c), c ** -0.5), bkv=((2 * c,), 0.1),
                wproj=((c, c), c ** -0.5), bproj=((c,), 0.1),
                table=(((2 * ws - 1) ** 3, nh), 0.5))
    rng = np.random.default_rng(seed + 1)
    p["ln"] = np.stack([rng.normal(size=(c,)) * 0.3 + 1.0,
                        rng.normal(size=(c,)) * 0.1]).astype(np.float32)
    return p


def _bias(table, ws, nh):
    n = ws ** 3
    idx = tw.relative_position_index((ws,) * 3).reshape(-1).astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(
        table[idx].reshape(n, n, nh).transpose(2, 0, 1)))


@pytest.mark.parametrize("c,nh", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("ws,ss,ln_res", [(2, 1, True), (3, 0, False)])
def test_k1_plain_matches_pallas(c, nh, ws, ss, ln_res):
    import jax.numpy as jnp

    from medicalsemseg_tpu.ops.pallas.window_attention import (
        fused_window_attention)

    dims = (2 * ws, 2 * ws, 2 * ws)
    p = _window_inputs(c + nh + ws, 2, dims, c, nh, ws)
    want = fused_window_attention(
        jnp.asarray(p["x"]), jnp.asarray(p["wqkv"]), jnp.asarray(p["bqkv"]),
        jnp.asarray(p["wproj"]), jnp.asarray(p["bproj"]),
        jnp.asarray(p["table"]), ws, nh, shift_size=ss, interpret=True,
        ln_scale=jnp.asarray(p["ln"][0]) if ln_res else None,
        ln_bias=jnp.asarray(p["ln"][1]) if ln_res else None,
        residual=ln_res)
    out = kwa.window_attention(
        tw.window_partition(torch.from_numpy(p["x"]), ws),
        torch.from_numpy(p["wqkv"]).t(), torch.from_numpy(p["bqkv"]),
        torch.from_numpy(p["wproj"]).t(), torch.from_numpy(p["bproj"]),
        _bias(p["table"], ws, nh), grid_dims=(2, 2, 2), window=(ws,) * 3,
        shift=(ss,) * 3, ln=torch.from_numpy(p["ln"]) if ln_res else None,
        residual=ln_res)
    got = tw.window_reverse(out, ws, dims).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("c,nh", SHAPES, ids=SHAPE_IDS)
def test_k6_plain_matches_pallas(c, nh):
    import jax.numpy as jnp

    from medicalsemseg_tpu.ops.pallas.window_attention import (
        fused_global_window_attention)

    ws, b = 2, 2
    dims = (4, 4, 2)
    p = _window_inputs(3 * c + nh, b, dims, c, nh, ws)
    want = fused_global_window_attention(
        jnp.asarray(p["x"]), jnp.asarray(p["q"]), jnp.asarray(p["wkv"]),
        jnp.asarray(p["bkv"]), jnp.asarray(p["wproj"]),
        jnp.asarray(p["bproj"]), jnp.asarray(p["table"]), ws, nh,
        interpret=True, ln_scale=jnp.asarray(p["ln"][0]),
        ln_bias=jnp.asarray(p["ln"][1]), residual=True)
    out = kga.global_window_attention(
        tw.window_partition(torch.from_numpy(p["x"]), ws),
        torch.from_numpy(p["q"]).reshape(b, ws ** 3, c),
        torch.from_numpy(p["wkv"]).t(), torch.from_numpy(p["bkv"]),
        torch.from_numpy(p["wproj"]).t(), torch.from_numpy(p["bproj"]),
        _bias(p["table"], ws, nh), ln=torch.from_numpy(p["ln"]),
        residual=True)
    got = tw.window_reverse(out, ws, dims).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("c,nh", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("n,m", [(40, 27), (64, 125)])
def test_k7_plain_matches_pallas(c, nh, n, m):
    """M = 27 (every stage at vol 96) and M = 125 (vol 160)."""
    import jax.numpy as jnp

    from medicalsemseg_tpu.ops.pallas.sr_attention import fused_sr_attention

    p = _arrays(c + m, x=((2, n, c), 1.0), k=((2, m, c), 1.0),
                v=((2, m, c), 1.0), wq=((c, c), c ** -0.5), bq=((c,), 0.1),
                wproj=((c, c), c ** -0.5), bproj=((c,), 0.1),
                res=((2, n, c), 1.0))
    j = {k: jnp.asarray(v) for k, v in p.items()}
    want = fused_sr_attention(j["x"], j["k"], j["v"], j["wq"], j["bq"],
                              j["wproj"], j["bproj"], nh, residual=j["res"],
                              interpret=True)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = ksr.sr_attention(t["x"], t["k"], t["v"], t["wq"].t(), t["bq"],
                           t["wproj"].t(), t["bproj"], nh, residual=t["res"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("c,nh,ss,ln", [
    (48, 1, 1, True), (96, 2, 1, True), (96, 1, 1, True), (96, 1, 0, False),
], ids=["c48_hd48", "c96_hd48", "c96_hd96", "c96_hd96_bare"])
def test_k3_plain_matches_jax_vjp(c, nh, ss, ln):
    """WindowAttentionFn (forward K1, backward K3, the bias gradient scattered
    onto the table) against jax.vjp of the trainable fused window attention
    (its backward the Pallas kernel in interpret mode)."""
    import jax
    import jax.numpy as jnp

    from medicalsemseg_tpu.ops.pallas import window_attention as pwa

    ws, b = 2, 2
    dims = (4, 4, 2)
    p = _window_inputs(5 * c + nh + ss, b, dims, c, nh, ws)

    def fwd(x, scale, bias_ln, wqkv, bqkv, wproj, bproj, table):
        if ln:
            return pwa.fused_window_attention_ln_trainable(
                x, scale, bias_ln, wqkv, bqkv, wproj, bproj, table, ws, nh,
                ss, 4, True, True)
        return pwa.fused_window_attention_trainable(
            x, wqkv, bqkv, wproj, bproj, table, ws, nh, ss, 4, True)

    args = tuple(jnp.asarray(a) for a in (
        p["x"], p["ln"][0], p["ln"][1], p["wqkv"], p["bqkv"], p["wproj"],
        p["bproj"], p["table"]))
    y_want, vjp = jax.vjp(fwd, *args)
    want = vjp(jnp.asarray(p["dy"]))

    t = {k: torch.from_numpy(p[k]).requires_grad_(True)
         for k in ("x", "ln", "wqkv", "bqkv", "wproj", "bproj", "table")}
    idx = torch.from_numpy(
        tw.relative_position_index((ws,) * 3).astype(np.int64)).reshape(-1)
    out = kwa.WindowAttentionFn.apply(
        tw.window_partition(t["x"], ws), t["ln"] if ln else None,
        t["wqkv"].t(), t["bqkv"], t["wproj"].t(), t["bproj"], t["table"],
        idx, (2, 2, 1), (ws,) * 3, (ss,) * 3, 1e-5, ln)
    y = tw.window_reverse(out, ws, dims)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want),
                               rtol=RTOL, atol=ATOL)
    (y * torch.from_numpy(p["dy"])).sum().backward()
    got = {"dx": t["x"].grad, "dwqkv": t["wqkv"].grad,
           "dbqkv": t["bqkv"].grad, "dwproj": t["wproj"].grad,
           "dbproj": t["bproj"].grad, "dtable": t["table"].grad}
    ref = {"dx": want[0], "dwqkv": want[3], "dbqkv": want[4],
           "dwproj": want[5], "dbproj": want[6], "dtable": want[7]}
    if ln:
        got["dln"] = t["ln"].grad
        ref["dln"] = jnp.stack([want[1], want[2]])
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("c,nh", [(48, 1), (96, 2), (192, 4), (384, 8),
                                  (96, 1), (192, 2), (384, 4), (768, 8)])
def test_predicates_take_head_dims_48_and_96(dtype, c, nh):
    """The stage shapes of hidden 48 and 96 with heads 1 2 4 8."""
    for train in (False, True):
        assert kwa.window_attention_supported(dtype, 216, c, nh, train)
    assert kwa.window_attention_supported(dtype, 343, c, nh)
    assert kwa.attention_route(dtype, 216, c // nh) == "cuda_core"
    for m in (27, 125, 216):
        assert ksr.sr_attention_supported(dtype, c, nh, m)
        assert ksr.sr_route(dtype, c, nh, m) == "cuda_core"


def test_predicates_refuse_head_dims_above_96():
    assert not kwa.window_attention_supported(torch.float32, 216, 128, 1)
    assert not ksr.sr_attention_supported(torch.float32, 128, 1, 27)


@pytest.mark.parametrize("t,nh,blocks,want", [
    (1024, 1, 528, 512),    # hidden 48 stage 1, batch 2: two windows a run
    (16, 8, 528, 16),       # stage 4: a window a run
    (5, 3, 8, 2),           # every run holds a window
    (7, 1, 4, 4),
])
def test_head_runs(t, nh, blocks, want):
    runs = kwa.head_runs(t, nh, blocks)
    per_run = -(-t // runs)
    assert runs == want and (runs - 1) * per_run < t <= runs * per_run
    assert runs * nh <= max(blocks, nh)


def test_wide_scratch():
    """K1 and K6 take the wide form above head dim 16, K3 above 32."""
    cpu = torch.device("cpu")
    buf = kwa.wide_scratch(4, 8, 96, 2, torch.bfloat16, cpu)
    assert buf.shape == (8, 3, 8, 48) and buf.dtype == torch.bfloat16
    assert kwa.wide_scratch(4, 8, 64, 2, torch.float32, cpu).shape == (
        8, 3, 8, 32)
    assert kwa.wide_scratch(4, 8, 64, 2, torch.float32, cpu, bwd=True) is None
    assert kwa.wide_scratch(4, 8, 96, 2, torch.float32, cpu,
                            bwd=True).shape == (8, 4, 8, 48)
    assert kwa.wide_scratch(4, 8, 64, 4, torch.float32, cpu) is None


class _Entry:
    def __init__(self):
        self.args = []

    def __call__(self, *args):
        self.args.append(args)
        return 0


class _Library:
    def __init__(self):
        self.entries = {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, _Entry())


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(kernels, "sm_count", lambda dev: 132)
    return lib


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,nh", SHAPES, ids=SHAPE_IDS)
def test_launch_paths_take_head_dims(fake_lib, monkeypatch, dtype, c, nh):
    """K1, K6, K3 and K7's launch paths reach their entry points at head
    dims 48 and 96 on the CUDA-core routes; the attention wrappers hand over
    a scratch buffer of the wide form and its runs of windows."""
    made = []
    orig = kwa.wide_scratch

    def spy(*args, **kw):
        buf = orig(*args, **kw)
        made.append((args[0], None if buf is None else tuple(buf.shape)))
        return buf

    monkeypatch.setattr(kwa, "wide_scratch", spy)
    monkeypatch.setattr(kga, "wide_scratch", spy)
    z = lambda *s, dt=dtype: torch.zeros(*s, dtype=dt)  # noqa: E731
    f32 = torch.float32
    n, t, hd = 216, 6, c // nh
    wins, ln = z(t, n, c), torch.ones(2, c)
    geo = dict(grid_dims=(1, 1, 6), window=(6, 6, 6), shift=(0, 0, 0),
               ln=ln, ln_eps=1e-5, residual=True, route=None)
    kwa._launch_fwd(wins, z(3 * c, c), None, z(c, c), z(c, dt=f32),
                    z(nh, n, n, dt=f32), **geo)
    kwa._launch_bwd(wins, z(3 * c, c), None, z(c, c), z(nh, n, n, dt=f32),
                    z(t, n, c), **geo)
    kga._launch(wins, z(2, n, c), z(2 * c, c), None, z(c, c), z(c, dt=f32),
                z(nh, n, n, dt=f32), ln=ln, ln_eps=1e-5, residual=True,
                route=None)
    x = z(2, 40, c)
    ksr._launch(x, z(2, 125, c), z(2, 125, c), z(c, c), None, z(c, c),
                z(c, dt=f32), nh, x.clone(), None)
    runs = kwa.head_runs(t, nh, kernels.resident_blocks(None))
    assert made == [(runs, (runs * nh, 3, n, hd)), (runs, (runs * nh, 4, n, hd)),
                    (runs, (runs * nh, 3, n, hd))]
    fwd = fake_lib.entries["medseg_window_attention_fwd"].args[0]
    assert fwd[9] is not None and fwd[14] == runs
    assert fwd[-5] == kwa.ROUTES["cuda_core"]
    glob = fake_lib.entries["medseg_global_window_attention_fwd"].args[0]
    assert glob[10] is not None and glob[16] == runs
    bwd = fake_lib.entries["medseg_window_attention_bwd"].args[0]
    assert bwd[18] is not None and bwd[-5] == kwa.ROUTES["cuda_core"]
    sr = fake_lib.entries["medseg_sr_attention_fwd"].args[0]
    assert sr[-4] == ksr.ROUTES["cuda_core"]


# ---- on the card: the CUDA-core routes against their plain versions

# (elementwise tolerance, gradient error norm relative to the reference's):
# bf16 as tests/test_torch_kernels_cuda.py (a flipped rounding is a few bf16
# ulps); fp32 sums in other orders over head dims of 48 and 96
CARD_TOL = {torch.bfloat16: (3e-2, 1e-2), torch.float32: (1e-4, 1e-5)}
CARD_SHAPES = [(48, 1), (96, 2), (384, 8), (96, 1), (768, 8)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, tol):
    assert got.dtype == want.dtype
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= tol + tol * w.abs()).all(), (g - w).abs().max()


def _rel_norm(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-12))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,nh", CARD_SHAPES)
@pytest.mark.parametrize("shift,ln_res", [(3, True), (0, False)])
def test_card_k1_k3_wide_forms(gen, dtype, c, nh, shift, ln_res):
    dev, ws, b = "cuda", 6, 2
    dims = (12, 12, 6)
    n = ws ** 3
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen, device=dev)  # noqa: E731
                            * sc)
    x = tw.window_partition(r(b, *dims, c), ws).to(dtype).contiguous()
    dy = r(*x.shape).to(dtype)
    wqkv, wproj = r(3 * c, c, sc=c ** -0.5), r(c, c, sc=c ** -0.5)
    bqkv, bproj, bias = r(3 * c, sc=0.1), r(c, sc=0.1), r(nh, n, n, sc=0.5)
    ln = torch.stack([1 + 0.3 * r(c), 0.1 * r(c)]) if ln_res else None
    geo = dict(grid_dims=(2, 2, 1), window=(ws,) * 3, shift=(shift,) * 3,
               ln=ln, residual=ln_res)
    geo_cpu = dict(geo, ln=None if ln is None else ln.cpu())
    elem, grad_tol = CARD_TOL[dtype]
    args = (x, wqkv.to(dtype), bqkv, wproj.to(dtype), bproj, bias)
    got = kwa.window_attention(*args, **geo)
    again = kwa.window_attention(*args, **geo)
    want = kwa.window_attention_plain(*(a.cpu() for a in args), **geo_cpu)
    torch.cuda.synchronize()
    _close(got.cpu(), want, elem)
    assert torch.equal(got, again)
    bargs = (x, wqkv.to(dtype), bqkv, wproj.to(dtype), bias, dy)
    got_b = kwa.window_attention_bwd(*bargs, **geo)
    want_b = kwa.window_attention_bwd_plain(*(a.cpu() for a in bargs),
                                            **geo_cpu)
    torch.cuda.synchronize()
    _close(got_b[0].cpu(), want_b[0], elem)
    for name, g, w in zip(("dwqkv", "dbqkv", "dwproj", "dbproj", "dbias",
                           "dln"), got_b[1:], want_b[1:]):
        if w is None:
            assert g is None
            continue
        assert _rel_norm(g.cpu(), w) < grad_tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,nh", CARD_SHAPES)
def test_card_k6_wide_form(gen, dtype, c, nh):
    dev, ws, b = "cuda", 6, 2
    n = ws ** 3
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen, device=dev)  # noqa: E731
                            * sc)
    x = r(4 * b, n, c).to(dtype)
    args = (x, r(b, n, c).to(dtype), r(2 * c, c, sc=c ** -0.5).to(dtype),
            r(2 * c, sc=0.1), r(c, c, sc=c ** -0.5).to(dtype), r(c, sc=0.1),
            r(nh, n, n, sc=0.5))
    ln = torch.stack([1 + 0.3 * r(c), 0.1 * r(c)])
    got = kga.global_window_attention(*args, ln=ln, residual=True)
    want = kga.global_window_attention_plain(
        *(a.cpu() for a in args), ln=ln.cpu(), residual=True)
    torch.cuda.synchronize()
    _close(got.cpu(), want, CARD_TOL[dtype][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,nh", CARD_SHAPES)
@pytest.mark.parametrize("n,m", [(1000, 27), (512, 125)])
def test_card_k7_head_dims(gen, dtype, c, nh, n, m):
    dev, b = "cuda", 2
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen, device=dev)  # noqa: E731
                            * sc)
    x = r(b, n, c).to(dtype)
    args = (x, r(b, m, c).to(dtype), r(b, m, c).to(dtype),
            r(c, c, sc=c ** -0.5).to(dtype), r(c, sc=0.1),
            r(c, c, sc=c ** -0.5).to(dtype), r(c, sc=0.1), nh)
    got = ksr.sr_attention(*args, residual=x)
    want = ksr.sr_attention_plain(*(a.cpu() if torch.is_tensor(a) else a
                                    for a in args), residual=x.cpu())
    torch.cuda.synchronize()
    _close(got.cpu(), want, CARD_TOL[dtype][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_wide_forms_ragged_runs_and_343_tokens(gen, monkeypatch, dtype):
    """Runs of windows that do not divide evenly (3, 3, 2 windows: the
    resident blocks cut to 3) for K1, K6 and K3, and K1 / K6 at 7^3 = 343
    tokens a window (K3 takes up to 6^3), at head dim 48."""
    dev, c, nh = "cuda", 48, 1
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen, device=dev)  # noqa: E731
                            * sc)
    elem = CARD_TOL[dtype][0]
    for ws, blocks in ((6, 3), (7, 528)):
        monkeypatch.setattr(kernels, "resident_blocks", lambda d, b=blocks: b)
        n = ws ** 3
        x = tw.window_partition(r(2, 2 * ws, 2 * ws, ws, c), ws).to(dtype)
        x = x.contiguous()
        ln = torch.stack([1 + 0.3 * r(c), 0.1 * r(c)])
        geo = dict(grid_dims=(2, 2, 1), window=(ws,) * 3, shift=(0, 0, 0),
                   ln=ln, residual=True)
        geo_cpu = dict(geo, ln=ln.cpu())
        args = (x, r(3 * c, c, sc=c ** -0.5).to(dtype), r(3 * c, sc=0.1),
                r(c, c, sc=c ** -0.5).to(dtype), r(c, sc=0.1),
                r(nh, n, n, sc=0.5))
        got = kwa.window_attention(*args, **geo)
        want = kwa.window_attention_plain(*(a.cpu() for a in args), **geo_cpu)
        gargs = (x, r(2, n, c).to(dtype), r(2 * c, c, sc=c ** -0.5).to(dtype),
                 r(2 * c, sc=0.1), args[3], args[4], args[5])
        got6 = kga.global_window_attention(*gargs, ln=ln, residual=True)
        want6 = kga.global_window_attention_plain(
            *(a.cpu() for a in gargs), ln=ln.cpu(), residual=True)
        torch.cuda.synchronize()
        _close(got.cpu(), want, elem)
        _close(got6.cpu(), want6, elem)
        if n <= kwa.BWD_MAX_TOKENS:
            bargs = (x, args[1], args[2], args[3], args[5], r(*x.shape).to(
                dtype))
            got_b = kwa.window_attention_bwd(*bargs, **geo)
            want_b = kwa.window_attention_bwd_plain(
                *(a.cpu() for a in bargs), **geo_cpu)
            torch.cuda.synchronize()
            _close(got_b[0].cpu(), want_b[0], elem)
            for g, w in zip(got_b[1:], want_b[1:]):
                assert _rel_norm(g.cpu(), w) < CARD_TOL[dtype][1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,nh", [(48, 3), (96, 3)])
def test_card_wide_form_at_the_one_pass_head_dims(gen, monkeypatch, dtype, c,
                                                  nh):
    """The wide form where the one-pass form runs, head dims 16 and 32 on
    the CUDA-core route, the wrappers handing it a scratch buffer (as
    ``chip_smoke.py --phases heads_forms`` times the two forms): K1, K3 and
    K6 against their plain versions."""
    monkeypatch.setattr(kwa, "NARROW_HEAD_DIM", 0)
    monkeypatch.setattr(kwa, "BWD_NARROW_HEAD_DIM", 0)
    monkeypatch.setattr(kwa, "attention_route", lambda *a: "cuda_core")
    test_card_k1_k3_wide_forms(gen, dtype, c, nh, 3, True)
    test_card_k6_wide_form(gen, dtype, c, nh)
