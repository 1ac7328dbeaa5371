"""The port's 3^3 conv weight gradient (``dw27_plain``, the plain version of
kernel K5) against the JAX package on the CPU: the Pallas kernel
``dw27_pallas`` in interpret mode and the XLA tap oracle ``_dw27_single``,
on the same seeded numpy inputs.

fp32 inputs: all three multiply the same numbers and add them in fp32 in
another order over at most 2 x 6 x 12 x 8 voxels, so they agree to a few
fp32 ulps of the largest sum (tolerance of tests/test_pallas_dw27.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalsemseg_tpu.ops import convgrad as jax_convgrad
from medicalsemseg_tpu.ops.pallas import dw27 as jax_dw27

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5

RTOL, ATOL = 2e-5, 2e-4


def _inputs(shape, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, cin)).astype(np.float32)
    dy = rng.normal(size=(*shape, cout)).astype(np.float32)
    return x, dy


@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 6, 8, 8), 16, 8),      # batch 2, Co != C
    ((1, 8, 8, 16), 16, 16),    # one sample, wider W
    ((2, 6, 12, 8), 24, 16),    # D != H != W
    ((1, 5, 4, 8), 48, 32),     # odd depth, the flagship's C
])
def test_plain_matches_pallas_interpret_and_tap_oracle(shape, cin, cout):
    x, dy = _inputs(shape, cin, cout)
    got = k5.dw27_plain(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.shape == (3, 3, 3, cin, cout) and got.dtype == torch.float32
    pallas = jax.jit(jax_dw27.dw27_pallas, static_argnames="interpret")(
        jnp.asarray(x), jnp.asarray(dy), interpret=True)
    taps = jax.jit(jax_convgrad._dw27_single)(jnp.asarray(x), jnp.asarray(dy))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(taps), rtol=RTOL,
                               atol=ATOL)


def test_bf16_inputs_accumulate_in_fp32():
    """bf16 inputs: the products are exact in fp32 and the sums are fp32, so
    the plain version stays within fp32 summation noise of the Pallas kernel
    (which gets the same bf16 values), far inside bf16's own 2^-8."""
    x, dy = _inputs((1, 4, 8, 8), 16, 16, seed=1)
    xb, dyb = torch.from_numpy(x).bfloat16(), torch.from_numpy(dy).bfloat16()
    got = k5.dw27_plain(xb, dyb)
    assert got.dtype == torch.float32
    want = jax_dw27.dw27_pallas(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(dyb.float().numpy()).astype(jnp.bfloat16), interpret=True)
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # and it is the gradient of the rounded inputs, not of the fp32 ones
    exact = k5.dw27_plain(xb.float(), dyb.float())
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 3, 5, 7), 16, 24),     # odd W: the TPU kernel's W % 8 rule is gone
    ((1, 1, 1, 1), 16, 8),      # a single voxel: only the centre tap is hit
    ((1, 2, 1, 3), 20, 5),
])
def test_ragged_shapes_match_the_tap_oracle(shape, cin, cout):
    x, dy = _inputs(shape, cin, cout, seed=2)
    got = k5.dw27_plain(torch.from_numpy(x), torch.from_numpy(dy))
    want = jax_convgrad._dw27_single(jnp.asarray(x), jnp.asarray(dy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    if shape[1:] == (1, 1, 1):
        centre = got[1, 1, 1].clone()
        got[1, 1, 1] = 0
        assert centre.abs().max() > 0 and got.abs().max() == 0


def test_wrapper_takes_the_plain_version_on_the_cpu():
    x, dy = _inputs((2, 3, 4, 5), 16, 8, seed=3)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    before = kernels.launches("K5")
    assert torch.equal(k5.dw27(xt, dyt), k5.dw27_plain(xt, dyt))
    assert kernels.launches("K5") == before       # no kernel was launched
    with pytest.raises(ValueError, match=r"\(B, D, H, W, C\)"):
        k5.dw27(xt, dyt[:, :2])
    with pytest.raises(ValueError, match=r"\(B, D, H, W, C\)"):
        k5.dw27(xt[0], dyt[0])


def test_applicability():
    assert k5.dw27_applicable((8, 8, 16), 48)
    assert k5.dw27_applicable((8, 8, 16), 16)
    assert k5.dw27_applicable((8, 8, 7), 48)      # W need not be a multiple of 8
    assert not k5.dw27_applicable((8, 8, 16), 1)  # the stem's single channel
    assert not k5.dw27_applicable((8, 8, 16), 15)
    # the JAX rule agrees wherever its layout rule holds
    for w, c in ((16, 48), (8, 16), (16, 1), (8, 15)):
        assert k5.dw27_applicable((8, 8, w), c) == jax_dw27.dw27_applicable(
            (8, 8, w), c)
