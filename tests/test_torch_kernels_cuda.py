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
