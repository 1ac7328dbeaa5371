"""Kernel K9's plain PyTorch version (Winograd F(2^3, 3^3) conv, optional
scale / shift / LeakyReLU on the input) against the JAX package on the CPU:
the Pallas kernel in interpret mode and ``lax.conv``.

Inputs come from a seeded numpy generator and go through both packages. fp32:
the Winograd sums run in another order than the direct conv's, 2e-4 as the
JAX package's own tests. bf16: the error against the fp32 conv within 4 times
the direct bf16 conv's, as ``tests/test_winograd.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from medicalsemseg_tpu.ops.convgrad import _conv
from medicalsemseg_tpu.ops.pallas import winograd3d as jax_k9

from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

TOL = 2e-4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _case(shape, co, seed):
    x = _rand(shape, seed)
    w = _rand((3, 3, 3, shape[-1], co), seed + 1, 0.2)    # JAX layout
    return x, w


def _torch_w(w, dtype=torch.float32):
    return torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()).to(dtype)


@pytest.mark.parametrize("shape,co,bd,bh", [((2, 8, 8, 16, 24), 10, 4, 4),
                                            ((1, 12, 4, 32, 48), 48, 4, 2)])
def test_plain_matches_pallas_interpret_and_conv(shape, co, bd, bh):
    x, w = _case(shape, co, 8)
    got = k9.winograd_conv3d_f23_plain(torch.from_numpy(x), _torch_w(w)).numpy()
    kern = jax_k9.winograd_conv3d_f23(jnp.asarray(x), jnp.asarray(w),
                                      block_d=bd, block_h=bh, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(_conv(jnp.asarray(x),
                                                     jnp.asarray(w))),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shift_scale", [0.2, 5.0])
@pytest.mark.parametrize("lrelu", [True, False])
def test_plain_input_epilogue_matches_pallas(lrelu, shift_scale):
    """With a large shift a halo that was activated and not set back to zero
    would add O(shift) to every border voxel."""
    b, c, co = 2, 24, 16
    x, w = _case((b, 8, 8, 16, c), co, 20)
    rng = np.random.default_rng(22)
    sc = (rng.normal(size=(b, c)) * 0.3 + 1.0).astype(np.float32)
    sh = (rng.normal(size=(b, c)) * shift_scale).astype(np.float32)
    if shift_scale > 1:
        sh = np.abs(sh) + 2.0       # every channel's padding would be > 0

    xn = x * sc[:, None, None, None, :] + sh[:, None, None, None, :]
    if lrelu:
        xn = np.where(xn >= 0, xn, xn * 0.01)
    want = np.asarray(_conv(jnp.asarray(xn), jnp.asarray(w)))
    kern = jax_k9.winograd_conv3d_f23(
        jnp.asarray(x), jnp.asarray(w), epilogue=(jnp.asarray(sc),
                                                  jnp.asarray(sh)),
        lrelu=lrelu, interpret=True)
    got = k9.winograd_conv3d_f23(
        torch.from_numpy(x), _torch_w(w),
        epilogue=(torch.from_numpy(sc), torch.from_numpy(sh)),
        lrelu=lrelu).numpy()
    tol = TOL * max(1.0, float(np.abs(want).max()) / 10)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=TOL, atol=tol)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=tol)
    if shift_scale > 1:
        # the check has teeth: with the activation applied to the padded
        # input (halo = lrelu(shift), not 0) the border is far off
        halo = np.broadcast_to(sh[:, None, None, None, :], (b, 10, 10, 18, c))
        halo = halo.copy()
        halo[:, 1:-1, 1:-1, 1:-1] = xn
        wrong = torch.nn.functional.conv3d(
            torch.from_numpy(halo).permute(0, 4, 1, 2, 3), _torch_w(w))
        wrong = wrong.permute(0, 2, 3, 4, 1).numpy()
        assert np.abs(wrong - want).max() > 1000 * tol


def test_bf16_error_is_bounded_like_the_pallas_kernel():
    x, w = _case((1, 8, 8, 16, 32), 32, 10)
    ref = np.asarray(_conv(jnp.asarray(x), jnp.asarray(w)))
    scale = np.abs(ref).max()
    xb, wb = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w)
    kern = np.asarray(jax_k9.winograd_conv3d_f23(xb, wb, interpret=True)
                      .astype(jnp.float32))
    direct = np.asarray(_conv(xb, wb.astype(jnp.bfloat16)).astype(jnp.float32))
    got = k9.winograd_conv3d_f23_plain(
        torch.from_numpy(x).bfloat16(), _torch_w(w)).float().numpy()
    err, err_direct = (np.abs(got - ref).max() / scale,
                       np.abs(direct - ref).max() / scale)
    assert err < 4 * max(err_direct, 1e-3), (err, err_direct)
    # the same rounding points as the Pallas body: a bf16 ulp apart at most
    # where an fp32 sum in another order flips the last rounding
    assert np.abs(got - kern).max() <= 2 ** -7 * scale


@pytest.mark.parametrize("shape,co", [
    ((1, 5, 7, 9, 16), 8),      # odd D, H, W: a masked tail of a tile
    ((2, 4, 6, 24, 20), 12),    # W = 24: (W / 2) % 8 != 0
    ((1, 1, 1, 1, 16), 16),     # borders only
    ((1, 2, 3, 50, 17), 5),     # channels that fill no mma step
])
def test_shapes_the_jax_gate_refuses(shape, co):
    x, w = _case(shape, co, 30)
    assert not jax_k9.winograd_f23_applicable(shape[1:4], shape[-1])
    assert k9.winograd_f23_applicable(shape[1:4], shape[-1])
    got = k9.winograd_conv3d_f23(torch.from_numpy(x), _torch_w(w)).numpy()
    assert got.shape == (*shape[:4], co)
    np.testing.assert_allclose(got, np.asarray(_conv(jnp.asarray(x),
                                                     jnp.asarray(w))),
                               rtol=TOL, atol=TOL)


def test_weight_transform_matches_jax():
    w = _rand((3, 3, 3, 24, 10), 40, 0.2)
    got = k9.transform_weights_f23(_torch_w(w))
    assert got.shape == (64, 24, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_k9.transform_weights_f23(jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cin", [1, 15, 16, 48, 96, 127, 128, 192])
def test_gate_matches_the_jax_gate_where_both_rules_apply(cin):
    for shape in ((96, 96, 96), (48, 48, 48), (8, 8, 16), (12, 4, 32)):
        assert (k9.winograd_f23_applicable(shape, cin)
                == jax_k9.winograd_f23_applicable(shape, cin))
    # the TPU layout rules are gone: only the channel window decides
    for shape in ((24, 24, 24), (96, 96, 90), (5, 7, 9)):
        assert not jax_k9.winograd_f23_applicable(shape, 48)
        assert k9.winograd_f23_applicable(shape, cin) == (16 <= cin < 128)


def test_wrapper_rejects_wrong_shapes():
    x = torch.zeros(1, 4, 4, 4, 16)
    with pytest.raises(ValueError, match="not"):
        k9.winograd_conv3d_f23(x, torch.zeros(8, 12, 3, 3, 3))
    with pytest.raises(ValueError, match="epilogue"):
        k9.winograd_conv3d_f23(x, torch.zeros(8, 16, 3, 3, 3),
                               epilogue=(torch.zeros(2, 16), torch.zeros(1, 16)))
