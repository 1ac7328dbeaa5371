"""Kernel K10 on the card, in every dtype the JAX function computes in.

These need an NVIDIA GPU with the CUDA toolkit; elsewhere they skip. On the
card: ``python -m pytest --noconftest -m cuda tests/test_torch_conv3d_cuda.py``
(no JAX there: ``tests/conftest.py`` imports it). K10 on both routes (the
tensor cores for bf16 and fp16, the CUDA cores for fp32) against its plain
version on odd volumes, with every output-channel width of a tensor-core
block, more than one block along Co and more than one chunk of input
channels, each rerun bit-equal; then ``conv3x3x3`` with gradients at 8 input
channels (dW through K5) against autograd through the library's conv in
fp32. The CPU side of the routes is ``tests/test_torch_conv3d_routes.py``.
"""

import pytest
import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import conv3d as k10

pytestmark = pytest.mark.cuda

# kernel against plain on the same inputs, elementwise (atol = rtol): both
# add fp32 products and round once, so in bf16 and fp16 they differ where a
# differently ordered sum flips that rounding (an ulp, 2^-8 and 2^-11 of an
# O(1) output), in fp32 only by the order of the sums
TOL = {torch.bfloat16: 3e-2, torch.float16: 4e-3, torch.float32: 1e-4}
# conv3x3x3's value and gradients against fp32 autograd through the
# library (TF32 off), as error norms relative to the reference's: one
# rounding to the dtype (2^-9 and 2^-12 of the norm in bf16 and fp16; dx and
# y round once, dW is fp32 in K5 and then rounds to w's dtype)
FN_TOL = {torch.bfloat16: 2 ** -7, torch.float16: 2 ** -9,
          torch.float32: 1e-5}
DTYPES = (torch.bfloat16, torch.float16, torch.float32)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _case(gen, dims, c, co, dtype):
    x = torch.randn(*dims, c, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(co, c, 3, 3, 3, generator=gen, device="cuda")
         * (27 * c) ** -0.5).to(dtype)
    return x, w


def _check(x, w, route):
    before = dict(kernels.routes("K10"))
    got = k10.conv3x3x3_fwd(x, w)
    torch.cuda.synchronize()
    assert kernels.routes("K10")[route] == before[route] + 1
    want = k10.conv3x3x3_plain(x, w)
    assert got.shape == want.shape and got.dtype == want.dtype
    g, r = got.float(), want.float()
    assert torch.isfinite(g).all()
    tol = TOL[x.dtype]
    err = (g - r).abs()
    assert (err <= tol + tol * r.abs()).all(), float(err.max())
    assert torch.equal(got, k10.conv3x3x3_fwd(x, w))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [8, 16, 40, 48, 96, 128])
@pytest.mark.parametrize("co", [8, 24, 48, 56, 96, 128, 144])
def test_k10_against_plain(gen, dtype, c, co):
    """An odd volume of 2 x 5 x 9 x 19: masked tails along every axis."""
    x, w = _case(gen, (2, 5, 9, 19), c, co, dtype)
    _check(x, w, k10.conv_route(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,co", [(96, 144), (40, 56), (128, 8)])
def test_k10_persistent_blocks(gen, dtype, c, co):
    """3 x 13 x 27 x 37: 252 tiles, more than the card's SMs, so a
    tensor-core block walks several items and chunks through both halo
    buffers and the weight ring."""
    x, w = _case(gen, (3, 13, 27, 37), c, co, dtype)
    _check(x, w, k10.conv_route(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,co", [(3, 20), (12, 8), (60, 100)])
def test_k10_channels_in_no_multiple_of_8(gen, dtype, c, co):
    """C no multiple of 8: the tensor-core route's stagers load the halo
    themselves (no tensor map describes x); Co no multiple of 8: the
    outputs go out element by element."""
    x, w = _case(gen, (2, 5, 9, 19), c, co, dtype)
    _check(x, w, k10.conv_route(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_k10_x_off_16_bytes(gen, dtype):
    """x starting 2 or 4 bytes past a 16-byte boundary: no tensor map."""
    x, w = _case(gen, (2, 5, 9, 19), 16, 24, dtype)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
    xo = flat[1:].view(x.shape)
    xo.copy_(x)
    assert xo.is_contiguous() and xo.data_ptr() % 16
    _check(xo, w, k10.conv_route(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv3x3x3_with_gradients_at_8_channels(gen, dtype):
    """Forward and dx are K10 launches, dW one K5 launch; against autograd
    through the library's conv in fp32 on the same inputs."""
    x, w = _case(gen, (2, 6, 7, 9), 8, 16, dtype)
    dy = torch.randn(2, 6, 7, 9, 16, generator=gen, device="cuda").to(dtype)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = (kernels.launches("K10"), kernels.launches("K5"))
    y = k10.conv3x3x3(xr, wr)
    dx, dw = torch.autograd.grad(y, (xr, wr), dy)
    torch.cuda.synchronize()
    assert (kernels.launches("K10") - before[0],
            kernels.launches("K5") - before[1]) == (2, 1)
    assert dx.dtype == dw.dtype == dtype
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        xl = x.float().requires_grad_(True)
        wl = w.float().requires_grad_(True)
        yl = torch.nn.functional.conv3d(xl.permute(0, 4, 1, 2, 3), wl,
                                        padding=1)
        dxl, dwl = torch.autograd.grad(yl, (xl, wl),
                                       dy.float().permute(0, 4, 1, 2, 3))
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    yl = yl.detach().permute(0, 2, 3, 4, 1)
    for got, want in ((y, yl), (dx, dxl), (dw, dwl)):
        assert got.shape == want.shape
        rel = (got.float() - want).norm() / want.norm()
        assert rel <= FN_TOL[dtype], float(rel)
