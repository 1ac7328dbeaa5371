"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need an NVIDIA GPU with the CUDA toolkit; elsewhere they skip. On the
card: ``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``. The
shapes are the small and odd ones the CPU parity tests use (head dims 4-16,
windows of 8-216 tokens, non-cubic grids, ragged token tiles); the flagship
shapes are covered by ``chip_smoke.py``.
"""

import pytest
import torch

from medicalsemseg_tpu_torch.ops import window as tw
from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

pytestmark = pytest.mark.cuda

# bf16 on both sides with the same rounding points and fp32 accumulation:
# they differ where a differently ordered fp32 sum flips one bf16 rounding,
# a few bf16 ulps (2^-8 relative) of O(1) outputs
TOL = 3e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= TOL + TOL * w.abs()).all(), (g - w).abs().max()


@pytest.mark.parametrize("dims,ws,c,nh,shift,ln_res,qkv_bias", [
    ((4, 4, 6), 2, 8, 2, 1, True, True),
    ((6, 6, 9), 3, 12, 2, 1, True, False),
    ((6, 6, 9), 3, 12, 3, 0, False, True),
    ((12, 6, 6), 6, 48, 3, 3, True, True),
])
def test_window_attention_kernel(gen, dims, ws, c, nh, shift, ln_res,
                                 qkv_bias):
    dev, bf = "cuda", torch.bfloat16
    n = ws ** 3
    x = torch.randn(2, *dims, c, generator=gen, device=dev).to(bf)
    wins = tw.window_partition(x, ws).contiguous()
    args = dict(
        wqkv=(torch.randn(3 * c, c, generator=gen, device=dev) * c ** -0.5).to(bf),
        bqkv=(torch.randn(3 * c, generator=gen, device=dev) * 0.1
              if qkv_bias else None),
        wproj=(torch.randn(c, c, generator=gen, device=dev) * c ** -0.5).to(bf),
        bproj=torch.randn(c, generator=gen, device=dev) * 0.1,
        bias=torch.randn(nh, n, n, generator=gen, device=dev))
    ln = torch.stack([1 + 0.3 * torch.randn(c, generator=gen, device=dev),
                      0.1 * torch.randn(c, generator=gen, device=dev)])
    kw = dict(grid_dims=tuple(d // ws for d in dims), window=(ws,) * 3,
              shift=(shift,) * 3, ln=ln if ln_res else None, residual=ln_res)
    before = kwa.launches
    got = kwa.window_attention(wins, **args, **kw)
    torch.cuda.synchronize()
    assert kwa.launches == before + 1
    _close(got, kwa.window_attention_plain(wins, **args, **kw))


@pytest.mark.parametrize("m,c,ln_res", [(37, 12, True), (300, 48, False),
                                        (1000, 96, True)])
def test_mlp_kernel(gen, m, c, ln_res):
    dev, bf = "cuda", torch.bfloat16
    x = torch.randn(m, c, generator=gen, device=dev).to(bf)
    args = dict(
        w1=(torch.randn(4 * c, c, generator=gen, device=dev) * c ** -0.5).to(bf),
        b1=torch.randn(4 * c, generator=gen, device=dev) * 0.1,
        w2=(torch.randn(c, 4 * c, generator=gen, device=dev)
            * (4 * c) ** -0.5).to(bf),
        b2=torch.randn(c, generator=gen, device=dev) * 0.1)
    ln = torch.stack([1 + 0.3 * torch.randn(c, generator=gen, device=dev),
                      0.1 * torch.randn(c, generator=gen, device=dev)])
    kw = dict(ln=ln if ln_res else None, residual=ln_res)
    got = kmlp.fused_mlp(x, **args, **kw)
    torch.cuda.synchronize()
    _close(got, kmlp.fused_mlp_plain(x, **args, **kw))


def _grads_close(names, got, want):
    """Backward outputs: weight gradients sum over all tokens, so elements
    near zero carry an error that is small only against the tensor's scale
    (``chip_smoke.py`` states the same rule)."""
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        gf, wf = g.float(), w.float()
        assert torch.isfinite(gf).all(), name
        assert (gf - wf).norm() <= 1e-2 * wf.norm(), name
        assert (gf - wf).abs().max() <= 5e-2 * wf.abs().max(), name


@pytest.mark.parametrize("dims,ws,c,nh,shift,ln,res,qkv_bias", [
    ((4, 4, 6), 2, 16, 2, 1, True, True, True),
    ((6, 6, 9), 3, 48, 3, 1, True, False, False),
    ((6, 6, 9), 3, 32, 1, 0, False, False, True),   # head dim 32
    ((12, 6, 6), 6, 48, 3, 3, True, False, True),
])
def test_window_attention_backward_kernel(gen, dims, ws, c, nh, shift, ln, res,
                                          qkv_bias):
    dev, bf = "cuda", torch.bfloat16
    n = ws ** 3
    x = torch.randn(3, *dims, c, generator=gen, device=dev).to(bf)
    wins = tw.window_partition(x, ws).contiguous()
    dy = torch.randn(wins.shape, generator=gen, device=dev).to(bf)
    args = dict(
        wqkv=(torch.randn(3 * c, c, generator=gen, device=dev) * c ** -0.5).to(bf),
        bqkv=(torch.randn(3 * c, generator=gen, device=dev) * 0.1
              if qkv_bias else None),
        wproj=(torch.randn(c, c, generator=gen, device=dev) * c ** -0.5).to(bf),
        bias=torch.randn(nh, n, n, generator=gen, device=dev), dy=dy)
    lnp = torch.stack([1 + 0.3 * torch.randn(c, generator=gen, device=dev),
                       0.1 * torch.randn(c, generator=gen, device=dev)])
    kw = dict(grid_dims=tuple(d // ws for d in dims), window=(ws,) * 3,
              shift=(shift,) * 3, ln=lnp if ln else None, residual=res)
    before = kwa.bwd_launches
    got = kwa.window_attention_bwd(wins, **args, **kw)
    torch.cuda.synchronize()
    assert kwa.bwd_launches == before + 1
    _grads_close(("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias", "dln"),
                 got, kwa.window_attention_bwd_plain(wins, **args, **kw))
    # partial sums are added in a fixed order: a second run is bit-equal
    again = kwa.window_attention_bwd(wins, **args, **kw)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("m,c,res", [(37, 16, True), (300, 48, False),
                                     (1000, 96, True)])
def test_mlp_backward_kernel(gen, m, c, res):
    dev, bf = "cuda", torch.bfloat16
    x = torch.randn(m, c, generator=gen, device=dev).to(bf)
    dy = torch.randn(m, c, generator=gen, device=dev).to(bf)
    args = dict(
        w1=(torch.randn(4 * c, c, generator=gen, device=dev) * c ** -0.5).to(bf),
        b1=torch.randn(4 * c, generator=gen, device=dev) * 0.1,
        w2=(torch.randn(c, 4 * c, generator=gen, device=dev)
            * (4 * c) ** -0.5).to(bf),
        ln=torch.stack([1 + 0.3 * torch.randn(c, generator=gen, device=dev),
                        0.1 * torch.randn(c, generator=gen, device=dev)]),
        dy=dy, residual=res)
    before = kmlp.bwd_launches
    got = kmlp.fused_mlp_bwd(x, **args)
    torch.cuda.synchronize()
    assert kmlp.bwd_launches == before + 1
    _grads_close(("dx", "dln", "dw1", "db1", "dw2", "db2"), got,
                 kmlp.fused_mlp_bwd_plain(x, **args))
    again = kmlp.fused_mlp_bwd(x, **args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_autograd_functions_run_the_backward_kernels(gen):
    """FusedMlpFn and WindowAttentionFn on the card: fp32 parameter
    gradients come back, and each backward is one kernel launch."""
    dev, bf, c, nh, ws = "cuda", torch.bfloat16, 16, 2, 2
    f32 = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    x = f32(2, 4, 4, 4, c).to(bf).requires_grad_(True)
    p = [t.requires_grad_(True) for t in (
        torch.stack([1 + 0.3 * f32(c), 0.1 * f32(c)]), f32(3 * c, c) * 0.25,
        f32(3 * c) * 0.1, f32(c, c) * 0.25, f32(c) * 0.1,
        f32((2 * ws - 1) ** 3, nh))]
    idx = torch.from_numpy(tw.relative_position_index((ws,) * 3)).long().reshape(
        -1).to(dev)
    before = (kwa.launches, kwa.bwd_launches, kmlp.launches, kmlp.bwd_launches)
    wins = tw.window_partition(x, ws)
    out = kwa.WindowAttentionFn.apply(wins, *p, idx, (2, 2, 2), (ws,) * 3,
                                      (1, 1, 1), 1e-5, False)
    q = [t.requires_grad_(True) for t in (
        torch.stack([1 + 0.3 * f32(c), 0.1 * f32(c)]), f32(4 * c, c) * 0.25,
        f32(4 * c) * 0.1, f32(c, 4 * c) * 0.12, f32(c) * 0.1)]
    y = kmlp.FusedMlpFn.apply(out.reshape(-1, c), *q, 1e-5, True)
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    after = (kwa.launches, kwa.bwd_launches, kmlp.launches, kmlp.bwd_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1, 1)
    assert x.grad.dtype == bf and torch.isfinite(x.grad.float()).all()
    for t in p + q:
        assert t.grad is not None and t.grad.dtype == torch.float32
        assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    x = torch.randn(4, 8, device="cuda")  # fp32, not bf16
    with pytest.raises(ValueError, match="bfloat16"):
        kmlp.fused_mlp(x, x.new_zeros(16, 8), x.new_zeros(16),
                       x.new_zeros(8, 16), x.new_zeros(8))
    wins = torch.zeros(2, 8, 4, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        kwa.window_attention(
            wins, wins.new_zeros(12, 4), None, wins.new_zeros(4, 4),
            torch.zeros(4, device="cuda"),
            torch.zeros(3, 8, 8, device="cuda"), grid_dims=(1, 1, 1),
            window=(2, 2, 2), shift=(0, 0, 0))
    wins = torch.zeros(2, 8, 24, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        kwa.window_attention_bwd(
            wins, wins.new_zeros(72, 24), None, wins.new_zeros(24, 24),
            torch.zeros(3, 8, 8, device="cuda"), wins, grid_dims=(1, 1, 1),
            window=(2, 2, 2), shift=(0, 0, 0))
