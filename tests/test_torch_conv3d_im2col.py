"""Kernel K10's plain PyTorch version and its autograd function
(``ops.kernels.conv3d``: the 3^3 conv as an implicit GEMM, dx as the same
conv on dy, dW through kernel K5) against the JAX package's im2col Pallas
kernels in interpret mode, on the CPU in fp32.

Shapes and tolerances are those of ``tests/test_pallas_conv3d.py``: 2e-5 for
the forward (27 C products added in another order), 1e-4 for the gradients.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import medicalsemseg_tpu.ops.pallas.conv3d as pc

from medicalsemseg_tpu_torch.ops.kernels import conv3d as k10
from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pc, "_INTERPRET", True)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _torch_w(w):
    return torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy())


SHAPES = [((1, 4, 8, 8, 8), 8),      # minimal aligned case
          ((2, 3, 16, 8, 16), 24)]   # B > 1, Co != C, anisotropic


@pytest.mark.parametrize("shape,co", SHAPES)
def test_forward_matches_pallas_interpret(shape, co):
    x = _rand(shape, 1)
    w = _rand((3, 3, 3, shape[-1], co), 2, 0.2)
    want = np.asarray(pc.conv3x3x3(jnp.asarray(x), jnp.asarray(w)))
    got = k10.conv3x3x3_plain(torch.from_numpy(x), _torch_w(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(k10.conv3x3x3_fwd(torch.from_numpy(x), _torch_w(w)),
                       torch.from_numpy(got))
    np.testing.assert_allclose(
        got, np.asarray(pc.conv3x3x3_reference(jnp.asarray(x), jnp.asarray(w))),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,co", [
    ((1, 3, 5, 7, 6), 5),       # what the TPU kernel's supported() refuses:
    ((1, 2, 4, 9, 8), 8),       # C % 8, W % 8, H < 8
])
def test_forward_on_shapes_the_jax_kernel_refuses(shape, co):
    x = _rand(shape, 6)
    w = _rand((3, 3, 3, shape[-1], co), 7, 0.2)
    assert not pc.supported(shape, (3, 3, 3), (1, 1, 1), shape[-1])
    got = k10.conv3x3x3_plain(torch.from_numpy(x), _torch_w(w)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(pc.conv3x3x3_reference(jnp.asarray(x), jnp.asarray(w))),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,co", SHAPES)
def test_gradients_match_jax_grad_of_the_pallas_function(shape, co):
    x = _rand(shape, 3)
    w = _rand((3, 3, 3, shape[-1], co), 4, 0.2)
    cot = _rand((*shape[:4], co), 5)
    gx, gw = jax.grad(
        lambda a, b: (pc.conv3x3x3(a, b) * jnp.asarray(cot)).sum(), (0, 1))(
            jnp.asarray(x), jnp.asarray(w))

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = _torch_w(w).requires_grad_(True)
    y = k10.conv3x3x3(xt, wt)
    assert "Im2colConv3dFn" in type(y.grad_fn).__name__
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(cot))
    assert dw.shape == wt.shape
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dw.numpy().transpose(2, 3, 4, 1, 0),
                               np.asarray(gw), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,co", SHAPES)
def test_k5_plain_is_the_pallas_weight_gradient(shape, co):
    """K10's dW is kernel K5: its plain version against ``_conv_dw``, which
    returns (27 C, Co) in tap-major rows."""
    x = _rand(shape, 8)
    dy = _rand((*shape[:4], co), 9)
    want = np.asarray(pc._conv_dw(jnp.asarray(x), jnp.asarray(dy)))
    got = k5.dw27_plain(torch.from_numpy(x), torch.from_numpy(dy))
    assert want.shape == (27 * shape[-1], co)
    np.testing.assert_allclose(got.reshape(27 * shape[-1], co).numpy(), want,
                               rtol=1e-4, atol=1e-4)


def test_backward_casts_dy_and_rounds_dw_to_the_weights_dtype():
    x = torch.from_numpy(_rand((1, 2, 4, 4, 16), 10)).bfloat16()
    w = torch.from_numpy(_rand((8, 16, 3, 3, 3), 11, 0.1)).bfloat16()
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = k10.conv3x3x3(xr, wr)
    assert y.dtype == torch.bfloat16
    dy = torch.from_numpy(_rand(tuple(y.shape), 12))       # fp32 cotangent
    dx, dw = torch.autograd.grad(y, (xr, wr), dy.to(y.dtype))
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert torch.equal(dx, k10.conv3x3x3_plain(dy.bfloat16(),
                                               k10.flip_weights(w)))
    assert torch.equal(dw, k5.dw27_plain(x, dy.bfloat16()).permute(
        4, 3, 0, 1, 2).bfloat16())


def test_wrapper_rejects_wrong_shapes_and_dtypes():
    x = torch.zeros(1, 4, 4, 4, 16)
    with pytest.raises(ValueError, match="not"):
        k10.conv3x3x3_fwd(x, torch.zeros(8, 12, 3, 3, 3))
    with pytest.raises(ValueError, match="w is"):
        k10.conv3x3x3_fwd(x, torch.zeros(8, 16, 3, 3, 3).bfloat16())
