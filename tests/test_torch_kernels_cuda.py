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
from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import conv3d as k10
from medicalsemseg_tpu_torch.ops.kernels import dice_ce as k8
from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5
from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga
from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa
from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

pytestmark = pytest.mark.cuda

# bf16 on both sides with the same rounding points and fp32 accumulation:
# they differ where a differently ordered fp32 sum flips one bf16 rounding,
# a few bf16 ulps (2^-8 relative) of O(1) outputs
TOL = 3e-2

# K1-K4, K6 and K7 in each compute dtype the JAX package runs them in:
# (elementwise tolerance, gradient error norm, largest gradient error, the
# last two relative to the reference's norm and largest element). In fp16
# a flipped rounding is an ulp of 2^-10 relative; in fp32 there are no
# roundings to flip, only sums taken in another order.
DTYPES = ("bfloat16", "float16", "float32")
DTYPE_TOL = {"bfloat16": (TOL, 1e-2, 5e-2), "float16": (4e-3, 2e-3, 1e-2),
             "float32": (1e-4, 1e-5, 1e-4)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _k8_launches():
    """K8's launches so far: (sums, dlogits)."""
    return (kernels.launches("K8", "forward"),
            kernels.launches("K8", "backward"))


def _swin_calls():
    """Calls of K1, K3, K2 and K4 so far (K1 and K3 make two launches a
    call: their heads launches count the calls)."""
    return (kernels.launches("K1", "heads"), kernels.launches("K3", "heads"),
            kernels.launches("K2"), kernels.launches("K4"))


def _close(got, want, tol=TOL):
    assert got.dtype == want.dtype
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= tol + tol * w.abs()).all(), (g - w).abs().max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims,ws,c,nh,shift,ln_res,qkv_bias", [
    ((4, 4, 6), 2, 8, 2, 1, True, True),
    ((6, 6, 9), 3, 12, 2, 1, True, False),
    ((6, 6, 9), 3, 12, 3, 0, False, True),
    ((12, 6, 6), 6, 48, 3, 3, True, True),
])
def test_window_attention_kernel(gen, dims, ws, c, nh, shift, ln_res,
                                 qkv_bias, dtype):
    dev, bf = "cuda", getattr(torch, dtype)
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
    before = kernels.launches("K1", "heads")
    got = kwa.window_attention(wins, **args, **kw)
    torch.cuda.synchronize()
    assert kernels.launches("K1", "heads") == before + 1
    _close(got, kwa.window_attention_plain(wins, **args, **kw),
           DTYPE_TOL[dtype][0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,c,ln_res", [(37, 12, True), (300, 48, False),
                                        (1000, 96, True), (70, 512, True)])
def test_mlp_kernel(gen, m, c, ln_res, dtype):
    dev, bf = "cuda", getattr(torch, dtype)
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
    _close(got, kmlp.fused_mlp_plain(x, **args, **kw), DTYPE_TOL[dtype][0])


def _grads_close(names, got, want, dtype="bfloat16"):
    """Backward outputs: weight gradients sum over all tokens, so elements
    near zero carry an error that is small only against the tensor's scale
    (``chip_smoke.py`` states the same rule)."""
    _, norm_tol, max_tol = DTYPE_TOL[dtype]
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        gf, wf = g.float(), w.float()
        assert torch.isfinite(gf).all(), name
        assert (gf - wf).norm() <= norm_tol * wf.norm(), name
        assert (gf - wf).abs().max() <= max_tol * wf.abs().max(), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims,ws,c,nh,shift,ln,res,qkv_bias", [
    ((4, 4, 6), 2, 16, 2, 1, True, True, True),
    ((6, 6, 9), 3, 48, 3, 1, True, False, False),
    ((6, 6, 9), 3, 32, 1, 0, False, False, True),   # head dim 32
    ((12, 6, 6), 6, 48, 3, 3, True, False, True),
    ((6, 6, 6), 3, 24, 3, 1, True, True, True),     # hidden 24: 8-row dw
    ((6, 6, 6), 3, 24, 1, 0, True, False, False),   # blocks, head dim 24
    ((4, 4, 4), 2, 768, 24, 1, True, True, True),   # hidden 96, stage 4:
    ((2, 4, 4), 2, 520, 26, 0, True, False, False),  # the wide dw launch
])
def test_window_attention_backward_kernel(gen, dims, ws, c, nh, shift, ln, res,
                                          qkv_bias, dtype):
    dev, bf = "cuda", getattr(torch, dtype)
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
    before = kernels.launches("K3", "heads")
    got = kwa.window_attention_bwd(wins, **args, **kw)
    torch.cuda.synchronize()
    assert kernels.launches("K3", "heads") == before + 1
    _grads_close(("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias", "dln"),
                 got, kwa.window_attention_bwd_plain(wins, **args, **kw),
                 dtype)
    # partial sums are added in a fixed order: a second run is bit-equal
    again = kwa.window_attention_bwd(wins, **args, **kw)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,c,res", [(37, 16, True), (300, 48, False),
                                     (1000, 96, True), (70, 384, True)])
def test_mlp_backward_kernel(gen, m, c, res, dtype):
    dev, bf = "cuda", getattr(torch, dtype)
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
    before = kernels.launches("K4")
    got = kmlp.fused_mlp_bwd(x, **args)
    torch.cuda.synchronize()
    assert kernels.launches("K4") == before + 1
    _grads_close(("dx", "dln", "dw1", "db1", "dw2", "db2"), got,
                 kmlp.fused_mlp_bwd_plain(x, **args), dtype)
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
    before = _swin_calls()
    wins = tw.window_partition(x, ws)
    out = kwa.WindowAttentionFn.apply(wins, *p, idx, (2, 2, 2), (ws,) * 3,
                                      (1, 1, 1), 1e-5, False)
    q = [t.requires_grad_(True) for t in (
        torch.stack([1 + 0.3 * f32(c), 0.1 * f32(c)]), f32(4 * c, c) * 0.25,
        f32(4 * c) * 0.1, f32(c, 4 * c) * 0.12, f32(c) * 0.1)]
    y = kmlp.FusedMlpFn.apply(out.reshape(-1, c), *q, 1e-5, True)
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    after = _swin_calls()
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
# cores elsewhere (20 -> 50 below); fp16 and fp32 always the CUDA cores
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
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
    before = kernels.launches("K5")
    got = k5.dw27(x, dy)
    torch.cuda.synchronize()
    assert kernels.launches("K5") == before + 1
    assert got.shape == (3, 3, 3, c, co) and got.dtype == torch.float32
    _sums_close(got, k5.dw27_plain(x, dy))
    if shape[1:] == (1, 1, 1):
        off = got.clone()
        off[1, 1, 1] = 0
        assert off.abs().max() == 0
    # partial sums are added in a fixed order: a second run is bit-equal
    assert torch.equal(got, k5.dw27(x, dy))


@pytest.mark.parametrize("batch", [1, 4, 8])
def test_dw27_kernel_at_the_decoder_shape(gen, batch):
    """K5 at the full-resolution 96 -> 48 conv of the decoder, 96^3 crops,
    against its plain version: the two input-channel tiles and every run of
    rows a share walks."""
    x = torch.randn(batch, 96, 96, 96, 96, generator=gen,
                    device="cuda").bfloat16()
    dy = torch.randn(batch, 96, 96, 96, 48, generator=gen,
                     device="cuda").bfloat16()
    got = k5.dw27(x, dy)
    torch.cuda.synchronize()
    _sums_close(got, k5.dw27_plain(x, dy))
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
        before = kernels.launches("K5")
        y = convgrad.Conv3x3x3Fn.apply(xr, wr)
        grads[mode] = torch.autograd.grad(y, (xr, wr), dy)
        torch.cuda.synchronize()
        assert kernels.launches("K5") - before == (1 if mode == "1" else 0)
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
    before = _k8_launches()
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
    assert _k8_launches() == (before[0] + 2, before[1] + 1)
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
    before = _k8_launches()
    loss = k8.dice_ce_fused(logits, labels)
    (g,) = torch.autograd.grad(loss, logits)
    torch.cuda.synchronize()
    assert _k8_launches() == (before[0] + 1, before[1] + 1)
    ref = dice_ce_loss(logits, labels)
    (ref_g,) = torch.autograd.grad(ref, logits)
    assert abs(float(loss.detach()) - float(ref.detach())) <= 1e-5 * abs(
        float(ref.detach()))
    assert (g - ref_g).norm() <= 1e-4 * ref_g.norm()
    lb = logits.detach().bfloat16().requires_grad_(True)
    (gb,) = torch.autograd.grad(k8.dice_ce_fused(lb, labels), lb)
    assert gb.dtype == torch.bfloat16 and gb.shape == lb.shape


def test_new_wrappers_reject_what_the_kernels_do_not_take(gen):
    # K5's launch takes any channel count (F6; the models' routing rule
    # dw27_applicable still says no below 16)
    x = torch.zeros(1, 2, 2, 2, 8, device="cuda", dtype=torch.bfloat16)
    got = k5.dw27(x, x)
    assert got.shape == (3, 3, 3, 8, 8) and got.abs().max() == 0
    x = torch.zeros(1, 2, 2, 2, 16, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        k5.dw27(x, x.float())                           # dtypes differ
    got = k5.dw27(x.half(), x.half())                    # fp16: CUDA cores
    assert got.shape == (3, 3, 3, 16, 16) and got.abs().max() == 0
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        k5.dw27(x.double(), x.double())
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
    x = torch.randn(4, 8, device="cuda")  # fp32 runs, float64 has no kernel
    args = (x.new_zeros(16, 8), x.new_zeros(16), x.new_zeros(8, 16),
            x.new_zeros(8))
    assert kmlp.fused_mlp(x, *args).dtype == torch.float32
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        kmlp.fused_mlp(x.double(), *args)
    wins = torch.zeros(2, 8, 4, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        kwa.window_attention(
            wins, wins.new_zeros(12, 4), None, wins.new_zeros(4, 4),
            torch.zeros(4, device="cuda"),
            torch.zeros(3, 8, 8, device="cuda"), grid_dims=(1, 1, 1),
            window=(2, 2, 2), shift=(0, 0, 0))
    wins = torch.zeros(2, 8, 20, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        kwa.window_attention_bwd(
            wins, wins.new_zeros(60, 20), None, wins.new_zeros(20, 20),
            torch.zeros(1, 8, 8, device="cuda"), wins, grid_dims=(1, 1, 1),
            window=(2, 2, 2), shift=(0, 0, 0))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch,dims,ws,c,nh,ln_res,kv_bias", [
    (1, (4, 4, 6), 2, 8, 2, True, True),
    (2, (6, 6, 9), 3, 12, 3, True, False),    # two query grids, 12 windows each
    (3, (6, 6, 9), 3, 32, 1, False, True),    # head dim 32
    (2, (12, 6, 6), 6, 48, 3, True, True),
])
def test_global_window_attention_kernel(gen, batch, dims, ws, c, nh, ln_res,
                                        kv_bias, dtype):
    dev, bf = "cuda", getattr(torch, dtype)
    n = ws ** 3
    x = torch.randn(batch, *dims, c, generator=gen, device=dev).to(bf)
    wins = tw.window_partition(x, ws).contiguous()
    args = dict(
        q_global=torch.randn(batch, n, c, generator=gen, device=dev).to(bf),
        wkv=(torch.randn(2 * c, c, generator=gen, device=dev) * c ** -0.5).to(bf),
        bkv=(torch.randn(2 * c, generator=gen, device=dev) * 0.1
             if kv_bias else None),
        wproj=(torch.randn(c, c, generator=gen, device=dev) * c ** -0.5).to(bf),
        bproj=torch.randn(c, generator=gen, device=dev) * 0.1,
        bias=torch.randn(nh, n, n, generator=gen, device=dev))
    ln = torch.stack([1 + 0.3 * torch.randn(c, generator=gen, device=dev),
                      0.1 * torch.randn(c, generator=gen, device=dev)])
    kw = dict(ln=ln if ln_res else None, residual=ln_res)
    before = kernels.launches("K6", "heads")
    got = kga.global_window_attention(wins, **args, **kw)
    torch.cuda.synchronize()
    assert kernels.launches("K6", "heads") == before + 1
    _close(got, kga.global_window_attention_plain(wins, **args, **kw),
           DTYPE_TOL[dtype][0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m,c,nh,bq,res", [
    (2, 27, 27, 16, 4, True, True),      # one ragged tile
    (3, 100, 8, 24, 2, False, False),    # three whole tiles and a tail
    (1, 1, 1, 8, 2, True, True),         # one token, one key
    (2, 513, 64, 96, 3, True, True),     # head dim 32, M over a warp
    (2, 40, 27, 384, 24, True, True),    # the widest stage: fp32 takes the
])                                       # smaller projection chunk
def test_sr_attention_kernel(gen, b, n, m, c, nh, bq, res, dtype):
    dev, bf = "cuda", getattr(torch, dtype)

    def act(rows):
        return torch.randn(b, rows, c, generator=gen, device=dev).to(bf)

    x = act(n)
    args = dict(
        k=act(m), v=act(m),
        wq=(torch.randn(c, c, generator=gen, device=dev) * c ** -0.5).to(bf),
        bq=torch.randn(c, generator=gen, device=dev) * 0.1 if bq else None,
        wproj=(torch.randn(c, c, generator=gen, device=dev) * c ** -0.5).to(bf),
        bproj=torch.randn(c, generator=gen, device=dev) * 0.1,
        num_heads=nh, residual=act(n) if res else None)
    before = kernels.launches("K7")
    got = ksr.sr_attention(x, **args)
    torch.cuda.synchronize()
    assert kernels.launches("K7") == before + 1
    _close(got, ksr.sr_attention_plain(x, **args), DTYPE_TOL[dtype][0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,c", [(37, 48), (300, 96), (70, 192), (33, 384)])
def test_mlp_kernel_at_hidden_3c(gen, m, c, dtype):
    """GC-ViT's MLP: hidden 3C = 144, 288, 576, 1152; 144 is four and a half
    of the kernel's chunks of 32 hidden units."""
    dev, bf = "cuda", getattr(torch, dtype)
    h = 3 * c
    x = torch.randn(m, c, generator=gen, device=dev).to(bf)
    args = dict(
        w1=(torch.randn(h, c, generator=gen, device=dev) * c ** -0.5).to(bf),
        b1=torch.randn(h, generator=gen, device=dev) * 0.1,
        w2=(torch.randn(c, h, generator=gen, device=dev) * h ** -0.5).to(bf),
        b2=torch.randn(c, generator=gen, device=dev) * 0.1)
    ln = torch.stack([1 + 0.3 * torch.randn(c, generator=gen, device=dev),
                      0.1 * torch.randn(c, generator=gen, device=dev)])
    got = kmlp.fused_mlp(x, **args, ln=ln, residual=True)
    torch.cuda.synchronize()
    _close(got, kmlp.fused_mlp_plain(x, **args, ln=ln, residual=True),
           DTYPE_TOL[dtype][0])


# the most reduced tokens whose K and V fit one block whole beside the token
# tile at C = 384 (K7's CUDA-core route before it streamed them in chunks)
SR_MAX_M_BF16, SR_MAX_M_F32 = 75, 34


def test_zoo_wrappers_reject_what_the_kernels_do_not_take(gen):
    dev, bf = "cuda", torch.bfloat16
    c, nh, n = 16, 2, 8
    wins = torch.zeros(4, n, c, device=dev, dtype=bf)
    good = dict(q_global=torch.zeros(2, n, c, device=dev, dtype=bf),
                wkv=torch.zeros(2 * c, c, device=dev, dtype=bf), bkv=None,
                wproj=torch.zeros(c, c, device=dev, dtype=bf),
                bproj=torch.zeros(c, device=dev),
                bias=torch.zeros(nh, n, n, device=dev))
    kga.global_window_attention(wins, **good)
    with pytest.raises(ValueError, match="query grids"):
        kga.global_window_attention(wins, **dict(
            good, q_global=torch.zeros(3, n, c, device=dev, dtype=bf)))
    with pytest.raises(ValueError, match="wkv"):      # a (3C, C) qkv weight
        kga.global_window_attention(wins, **dict(
            good, wkv=torch.zeros(3 * c, c, device=dev, dtype=bf)))
    f32 = {k: v.float() if v is not None and v.dtype == bf else v
           for k, v in good.items()}
    out = kga.global_window_attention(wins.float(), **f32)
    assert out.dtype == torch.float32
    with pytest.raises(ValueError, match="wins is"):
        kga.global_window_attention(wins.double(), **good)

    x = torch.zeros(1, 40, 384, device=dev, dtype=bf)
    w = torch.zeros(384, 384, device=dev, dtype=bf)
    bp = torch.zeros(384, device=dev)

    def kv(m):
        return torch.zeros(1, m, 384, device=dev, dtype=bf)

    # K and V stream through shared memory in key chunks: M past what one
    # block could hold whole at C = 384 (75 in bf16, 34 in fp32) runs, and
    # only a width that no plan fits is refused
    for dt in (bf, torch.float32):
        xd = x.to(dt)
        for m in (SR_MAX_M_BF16 + 1, SR_MAX_M_F32 + 1, 512):
            ksr.sr_attention(xd, kv(m).to(dt), kv(m).to(dt), w, None, w, bp,
                             24)
    wide = torch.zeros(1, 40, 2048, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        ksr.sr_attention(wide, wide, wide, wide[0, :1].expand(2048, 2048)
                         .contiguous(), None,
                         wide[0, :1].expand(2048, 2048).contiguous(),
                         torch.zeros(2048, device=dev), 64)
    ksr.sr_attention(x, kv(8), kv(8), w, None, w, bp, 6)   # head dim 64
    with pytest.raises(ValueError, match="head dim"):      # 128, over 96
        ksr.sr_attention(x, kv(8), kv(8), w, None, w, bp, 3)
    with pytest.raises(ValueError, match="residual"):
        ksr.sr_attention(x, kv(8), kv(8), w, None, w, bp, 24,
                         residual=torch.zeros(1, 39, 384, device=dev, dtype=bf))


# K9 and K10 against plain: the same bf16 values are multiplied on both sides
# (K9 rounds its transforms at the plain version's points), sums are fp32 in
# another order, and the result rounds to bf16 once: a bf16 ulp apart where
# that rounding flips, so TOL as for K1
CONV_SHAPES = [
    ((1, 1, 1, 1), 16, 16),      # borders only
    ((2, 4, 8, 16), 48, 48),     # one whole block tile per sample
    ((1, 5, 7, 9), 16, 8),       # odd D, H, W: masked tails
    ((2, 6, 10, 24), 24, 40),    # channels in 8s that fill no 16-step or tile
    ((1, 3, 9, 35), 17, 5),      # odd channel counts: scalar loads and stores
    ((2, 12, 12, 12), 96, 96),   # two input chunks, two output-channel blocks
    ((1, 6, 6, 6), 192, 96),     # four input chunks
    ((1, 8, 16, 32), 48, 112),   # three output-channel blocks, the last ragged
    # the shapes where K9 met the library's conv worst: 96 output channels
    ((1, 5, 7, 9), 96, 96),      # odd D, H, W with two input chunks
    ((2, 9, 11, 13), 48, 96),    # a training step's dx form, odd sizes
    ((1, 24, 24, 24), 96, 96),   # a predictor call's deepest fused conv
]


def _conv_case(gen, shape, c, co):
    x = torch.randn(*shape, c, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(co, c, 3, 3, 3, generator=gen, device="cuda")
         * (27 * c) ** -0.5).bfloat16()
    return x, w


@pytest.mark.parametrize("epilogue", [None, "lrelu", "affine"])
@pytest.mark.parametrize("shape,c,co", CONV_SHAPES)
def test_winograd_kernel(gen, shape, c, co, epilogue):
    x, w = _conv_case(gen, shape, c, co)
    kw = {}
    if epilogue is not None:
        # distinct per sample; a shift of +3 makes an activated halo visible
        b = shape[0]
        kw = dict(epilogue=(1 + 0.3 * torch.randn(b, c, generator=gen,
                                                  device="cuda"),
                            3 + torch.randn(b, c, generator=gen,
                                            device="cuda")),
                  lrelu=epilogue == "lrelu")
    before = kernels.launches("K9")
    got = k9.winograd_conv3d_f23(x, w, **kw)
    torch.cuda.synchronize()
    assert kernels.launches("K9") == before + 1
    assert got.shape == (*shape, co) and got.dtype == torch.bfloat16
    _close(got, k9.winograd_conv3d_f23_plain(x, w, **kw))
    assert torch.equal(got, k9.winograd_conv3d_f23(x, w, **kw))
    # and against the library's conv on the activated input, more loosely:
    # Winograd in bf16 carries about twice the direct conv's rounding
    xa = x
    if epilogue is not None:
        sc, sh = kw["epilogue"]
        xa = x.float() * sc[:, None, None, None] + sh[:, None, None, None]
        if kw["lrelu"]:
            xa = torch.where(xa >= 0, xa, xa * 0.01)
        xa = xa.bfloat16()
    lib = torch.nn.functional.conv3d(xa.permute(0, 4, 1, 2, 3).float(),
                                     w.float(), padding=1)
    lib = lib.permute(0, 2, 3, 4, 1)
    assert (got.float() - lib).norm() <= 2e-2 * lib.norm()


# K9 in fp16 (the tensor cores) and fp32 (the CUDA cores), the dtypes the
# JAX fused decoder runs it in besides bf16: odd volumes, channel counts at
# 16, 48, 96 and 127 (one and several input chunks and output-channel
# blocks, ragged ones). Against the plain version on the same inputs,
# elementwise with atol = rtol: in fp16 both round V at the same points and
# y once (a flipped rounding is an ulp, 2^-10 relative), in fp32 there is no
# rounding to flip, only sums in another order (tests/test_torch_conv3d_cuda.py)
K9_DTYPE_TOL = {torch.float16: 4e-3, torch.float32: 1e-4}
K9_DTYPE_SHAPES = [
    ((1, 5, 7, 9), 16, 16),
    ((2, 4, 8, 16), 48, 48),
    ((1, 5, 7, 9), 96, 96),
    ((1, 9, 11, 13), 127, 127),
    ((2, 3, 9, 35), 48, 127),
    ((1, 6, 10, 24), 127, 16),
]


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("epilogue", [None, "lrelu"])
@pytest.mark.parametrize("shape,c,co", K9_DTYPE_SHAPES)
def test_winograd_kernel_dtypes(gen, shape, c, co, epilogue, dtype):
    x, w = (t.to(dtype) for t in _conv_case(gen, shape, c, co))
    kw = {}
    if epilogue is not None:
        b = shape[0]
        kw = dict(epilogue=(1 + 0.3 * torch.randn(b, c, generator=gen,
                                                  device="cuda"),
                            3 + torch.randn(b, c, generator=gen,
                                            device="cuda")),
                  lrelu=True)
    route = k9.winograd_route(dtype)
    assert route == ("tensor_core" if dtype == torch.float16
                     else "cuda_core")
    before = (kernels.launches("K9"), kernels.routes("K9")[route])
    got = k9.winograd_conv3d_f23(x, w, **kw)
    torch.cuda.synchronize()
    assert (kernels.launches("K9"), kernels.routes("K9")[route]) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (*shape, co) and got.dtype == dtype
    _close(got, k9.winograd_conv3d_f23_plain(x, w, **kw), K9_DTYPE_TOL[dtype])
    assert torch.equal(got, k9.winograd_conv3d_f23(x, w, **kw))


@pytest.mark.parametrize("shape,c,co", CONV_SHAPES)
def test_im2col_conv_kernel(gen, shape, c, co):
    x, w = _conv_case(gen, shape, c, co)
    before = kernels.launches("K10")
    got = k10.conv3x3x3_fwd(x, w)
    torch.cuda.synchronize()
    assert kernels.launches("K10") == before + 1
    assert got.shape == (*shape, co) and got.dtype == torch.bfloat16
    _close(got, k10.conv3x3x3_plain(x, w))
    assert torch.equal(got, k10.conv3x3x3_fwd(x, w))
    lib = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3).float(),
                                     w.float(), padding=1)
    assert (got.float() - lib.permute(0, 2, 3, 4, 1)).norm() <= 1e-2 * lib.norm()


def test_im2col_conv_function_on_the_card(gen):
    """Forward and dx are K10 launches, dW one K5 launch; against autograd
    through the library's conv."""
    x, w = _conv_case(gen, (2, 6, 7, 9), 32, 16)
    dy = torch.randn(2, 6, 7, 9, 16, generator=gen, device="cuda").bfloat16()
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = (kernels.launches("K10"), kernels.launches("K5"))
    y = k10.conv3x3x3(xr, wr)
    dx, dw = torch.autograd.grad(y, (xr, wr), dy)
    torch.cuda.synchronize()
    assert (kernels.launches("K10") - before[0],
            kernels.launches("K5") - before[1]) == (2, 1)
    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    yl = torch.nn.functional.conv3d(xl.permute(0, 4, 1, 2, 3), wl, padding=1)
    dxl, dwl = torch.autograd.grad(yl, (xl, wl), dy.permute(0, 4, 1, 2, 3))
    assert dx.shape == x.shape and dw.shape == w.shape
    assert (dx.float() - dxl.float()).norm() <= 2 ** -7 * dxl.float().norm()
    assert (dw.float() - dwl.float()).norm() <= 2 ** -7 * dwl.float().norm()


def test_winograd_gates_on_the_card(gen, monkeypatch):
    """MEDSEG_WINOGRAD (no gradients), MEDSEG_WINOGRAD_TRAIN (forward and dx)
    and MEDSEG_FUSED_DECODER (conv2 with the norm folded in) launch K9 on
    CUDA tensors; each against the ungated path."""
    from medicalsemseg_tpu_torch.models.decoders import UnetResBlock
    from medicalsemseg_tpu_torch.models.layers import Conv3d

    for name in ("MEDSEG_WINOGRAD", "MEDSEG_WINOGRAD_TRAIN",
                 "MEDSEG_FUSED_DECODER"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MEDSEG_DW27_PALLAS", "0")
    x, w = _conv_case(gen, (2, 6, 8, 10), 32, 48)
    conv = Conv3d(32, 48, 3, bias=False).cuda()
    with torch.no_grad():
        conv.weight.copy_(w.float())

    def launched(fn):
        before = kernels.launches("K9")
        out = fn()
        torch.cuda.synchronize()
        return out, kernels.launches("K9") - before

    with torch.no_grad():
        ref, n = launched(lambda: conv(x))
        assert n == 0
        monkeypatch.setenv("MEDSEG_WINOGRAD", "1")
        got, n = launched(lambda: conv(x))
        assert n == 1
        _, n = launched(lambda: conv(x.float()))         # fp32: the library
        assert n == 0
    assert (got.float() - ref.float()).norm() <= 2e-2 * ref.float().norm()
    monkeypatch.delenv("MEDSEG_WINOGRAD")

    dy = torch.randn(2, 6, 8, 10, 48, generator=gen, device="cuda").bfloat16()

    def grads():
        xr = x.clone().requires_grad_(True)
        y = conv(xr)
        return (y.detach(),) + torch.autograd.grad(y, (xr, conv.weight), dy)

    want, n = launched(grads)
    assert n == 0
    monkeypatch.setenv("MEDSEG_WINOGRAD_TRAIN", "1")
    have, n = launched(grads)
    assert n == 2
    for g, r in zip(have, want):
        assert (g.float() - r.float()).norm() <= 2e-2 * r.float().norm()
    monkeypatch.delenv("MEDSEG_WINOGRAD_TRAIN")

    blk = UnetResBlock(32, 48).cuda().eval()
    for p in blk.parameters():
        torch.nn.init.normal_(p, 0.5 if p.dim() == 1 else 0.0,
                              0.2 if p.dim() == 1 else 0.05, generator=None)
    with torch.no_grad():
        want, n = launched(lambda: blk(x))
        assert n == 0
        monkeypatch.setenv("MEDSEG_FUSED_DECODER", "1")
        have, n = launched(lambda: blk(x))
        assert n == 1
        # fp32 and fp16 fuse too, as in the JAX package (K9 on the CUDA
        # cores and on the tensor cores)
        for dt in (torch.float32, torch.float16):
            _, n = launched(lambda: blk(x.to(dt)))
            assert n == 1
    _, n = launched(lambda: blk(x))                      # gradients enabled
    assert n == 0
    assert (have.float() - want.float()).norm() <= 3e-2 * want.float().norm()


def test_conv_wrappers_reject_what_the_kernels_do_not_take(gen):
    x, w = _conv_case(gen, (1, 2, 2, 2), 16, 16)
    # K9 and K10 take bf16, fp16 and fp32, as their JAX functions
    for fn in (k9.winograd_conv3d_f23, k10.conv3x3x3_fwd):
        with pytest.raises(ValueError, match="float64"):
            fn(x.double(), w.double())
    for fn in (k9.winograd_conv3d_f23, k10.conv3x3x3_fwd):
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.transpose(1, 2), w)
        with pytest.raises(ValueError, match="not"):
            fn(x, w[:, :8])
