"""The port's CUDA kernels against their plain PyTorch versions on the card.

These need an NVIDIA GPU with the CUDA toolkit; elsewhere they skip. On the
card: ``python -m pytest -m cuda tests/test_torch_kernels_cuda.py``. The
shapes are the small and odd ones the CPU parity tests use (head dims 4-16,
windows of 8-216 tokens, non-cubic grids, ragged token tiles); the flagship
shapes are covered by ``chip_smoke.py``.
"""

import pytest
import torch

from medicalsemseg_tpu_torch.ops import convgrad
from medicalsemseg_tpu_torch.ops import window as tw
from medicalsemseg_tpu_torch.ops.kernels import dice_ce as k8
from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5
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


# K5 and K8 against plain: both sides multiply the same numbers (bf16
# products are exact in fp32) and add them in fp32, so only the order of the
# sums differs: fp32 rounding noise, a few 1e-7 of the result's scale per
# addition and far less in the norm.
SUM_NORM_TOL = 1e-5
SUM_MAX_TOL = 1e-4


def _sums_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    assert (got - want).norm() <= SUM_NORM_TOL * want.norm()
    assert (got - want).abs().max() <= SUM_MAX_TOL * want.abs().max()


# bf16 takes the tensor cores where C and Co are multiples of 8 and the CUDA
# cores elsewhere (20 -> 50 below); fp32 always the CUDA cores
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,c,co", [
    ((1, 1, 1, 1), 16, 16),      # borders only: every tap but the centre is 0
    ((2, 2, 2, 2), 16, 8),
    ((1, 3, 3, 3), 48, 48),
    ((2, 3, 5, 7), 16, 24),      # D != H != W, odd W
    ((1, 4, 6, 100), 20, 50),    # W over one tile, C and Co over no tile
    ((3, 5, 4, 8), 96, 48),      # two input-channel tiles
    ((1, 2, 3, 9), 48, 100),     # three output-channel tiles
    ((2, 4, 5, 40), 24, 56),     # W over two mma steps, channels in 8s
    ((1, 2, 2, 200), 104, 8),    # three voxel tiles, three input tiles
    ((2, 3, 4, 33), 17, 16),     # an odd channel count: CUDA cores in bf16 too
    # the flagship decoder's deeper convs, as MEDSEG_DW27_PALLAS=1 sends them
    ((2, 3, 3, 3), 768, 384),    # more channel tiles than resident blocks
    ((2, 6, 6, 6), 384, 192),
    ((1, 12, 12, 12), 192, 96),
])
def test_dw27_kernel(gen, shape, c, co, dtype):
    x = torch.randn(*shape, c, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(*shape, co, generator=gen, device="cuda").to(dtype)
    before = k5.launches
    got = k5.dw27(x, dy)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    assert got.shape == (3, 3, 3, c, co) and got.dtype == torch.float32
    _sums_close(got, k5.dw27_plain(x, dy))
    if shape[1:] == (1, 1, 1):
        off = got.clone()
        off[1, 1, 1] = 0
        assert off.abs().max() == 0
    # partial sums are added in a fixed order: a second run is bit-equal
    assert torch.equal(got, k5.dw27(x, dy))


def test_conv_function_takes_k5_on_the_card(gen, monkeypatch):
    """Conv3x3x3Fn with the gate forced open: one K5 launch in the backward,
    and dW (rounded to bf16) agrees with the library's weight gradient, which
    rounds its own sum to bf16: one bf16 ulp (2^-8) of the element apart at
    most, 2^-9 of the norm on average."""
    x = torch.randn(2, 6, 7, 9, 32, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(16, 32, 3, 3, 3, generator=gen, device="cuda")
         * 0.03).bfloat16()
    dy = torch.randn(2, 6, 7, 9, 16, generator=gen, device="cuda").bfloat16()
    grads = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("MEDSEG_DW27_PALLAS", mode)
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        before = k5.launches
        y = convgrad.Conv3x3x3Fn.apply(xr, wr)
        grads[mode] = torch.autograd.grad(y, (xr, wr), dy)
        torch.cuda.synchronize()
        assert k5.launches - before == (1 if mode == "1" else 0)
    assert torch.equal(grads["1"][0], grads["0"][0])          # dx: same call
    a, b = grads["1"][1].float(), grads["0"][1].float()
    assert grads["1"][1].dtype == torch.bfloat16 and a.shape == w.shape
    assert (a - b).norm() <= 2 ** -8 * b.norm()


@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("b,m,c", [
    (1, 256, 14),        # one whole tile
    (2, 1000, 14),       # M no multiple of the tile
    (4, 37, 3),          # less than a tile
    (3, 5000, 20),       # more than 16 classes
    (1, 70001, 32),      # the widest the kernel takes, many tiles per block
])
def test_dice_ce_kernels(gen, b, m, c, label_dtype):
    logits = torch.randn(b, m, c, generator=gen, device="cuda") * 2.0
    labels = torch.randint(0, c, (b, m), generator=gen,
                           device="cuda").to(label_dtype)
    before = (k8.launches, k8.bwd_launches)
    got = k8.dice_ce_sums(logits, labels)
    torch.cuda.synchronize()
    want = k8.dice_ce_sums_plain(logits, labels)
    _sums_close(got, want)
    assert torch.equal(got[:, 2], want[:, 2])                 # voxel counts
    assert torch.equal(got, k8.dice_ce_sums(logits, labels))  # bit-equal rerun

    ca = torch.randn(b, c, generator=gen, device="cuda")
    cp = torch.randn(b, c, generator=gen, device="cuda")
    ce = torch.rand(1, generator=gen, device="cuda")
    dl = k8.dice_ce_dlogits(logits, labels, ca, cp, ce)
    torch.cuda.synchronize()
    assert (k8.launches, k8.bwd_launches) == (before[0] + 2, before[1] + 1)
    ref = k8.dice_ce_dlogits_plain(logits, labels, ca, cp, ce)
    # elementwise in fp32 with another exp and another order of the C-term
    # sums: a few ulps of values of O(1)
    assert dl.shape == ref.shape and torch.isfinite(dl).all()
    assert (dl - ref).abs().max() <= 1e-5 * max(1.0, float(ref.abs().max()))


def test_fused_loss_function_on_the_card(gen):
    """DiceCEFusedFn: loss and gradient against the unfused loss and its
    autograd gradient in fp32, one launch each way; bf16 logits get a bf16
    gradient."""
    from medicalsemseg_tpu_torch.train.losses import dice_ce_loss

    logits = (torch.randn(2, 9, 10, 11, 14, generator=gen, device="cuda")
              * 2.0).requires_grad_(True)
    labels = torch.randint(0, 14, (2, 9, 10, 11), generator=gen, device="cuda")
    before = (k8.launches, k8.bwd_launches)
    loss = k8.dice_ce_fused(logits, labels)
    (g,) = torch.autograd.grad(loss, logits)
    torch.cuda.synchronize()
    assert (k8.launches, k8.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = dice_ce_loss(logits, labels)
    (ref_g,) = torch.autograd.grad(ref, logits)
    assert abs(float(loss.detach()) - float(ref.detach())) <= 1e-5 * abs(
        float(ref.detach()))
    assert (g - ref_g).norm() <= 1e-4 * ref_g.norm()
    lb = logits.detach().bfloat16().requires_grad_(True)
    (gb,) = torch.autograd.grad(k8.dice_ce_fused(lb, labels), lb)
    assert gb.dtype == torch.bfloat16 and gb.shape == lb.shape


def test_new_wrappers_reject_what_the_kernels_do_not_take(gen):
    x = torch.zeros(1, 2, 2, 2, 8, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=">= 16"):
        k5.dw27(x, x)                                   # too few channels
    x = torch.zeros(1, 2, 2, 2, 16, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        k5.dw27(x, x.float())                           # dtypes differ
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        k5.dw27(x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        k5.dw27(x.transpose(1, 2), x.transpose(1, 2))
    logits = torch.zeros(1, 8, 33, device="cuda")
    labels = torch.zeros(1, 8, device="cuda", dtype=torch.int64)
    with pytest.raises(ValueError, match="at most 32"):
        k8.dice_ce_sums(logits, labels)
    with pytest.raises(ValueError, match="float32"):
        k8.dice_ce_sums(logits[..., :14].bfloat16().contiguous(), labels)
    with pytest.raises(ValueError, match="int32 or int64"):
        k8.dice_ce_sums(logits[..., :14].contiguous(), labels.to(torch.int16))
    with pytest.raises(ValueError, match="expected"):
        k8.dice_ce_dlogits(logits[..., :14].contiguous(), labels,
                           torch.zeros(1, 13, device="cuda"),
                           torch.zeros(1, 14, device="cuda"),
                           torch.zeros(1, device="cuda"))


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
