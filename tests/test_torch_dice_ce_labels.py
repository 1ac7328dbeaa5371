"""Labels outside [0, C) in the fused DiceCE loss (kernel K8): the port's
plain sums and dlogits against the JAX package's Pallas kernels
``_fwd_sums`` / ``_fwd_kernel`` and ``_bwd_kernel`` in interpret mode
(``dice_ce._INTERPRET``, as tests/test_torch_dice_ce.py sets it).

The JAX kernels build the one-hot target by comparing the label with the
class index, so a label of -1 (their padding) or of C gives a zero row and
no CE term, and leave p^2 out of the sums where the label is negative only.
fp32 on both sides over at most 2 x 512 voxels: the sums agree to 1e-5
relative (class counts exactly), as in tests/test_torch_dice_ce.py; dlogits
to 1e-5 relative and 1e-6 absolute: with coefficients of O(1) an element is
p (g - sum g p), a difference of O(1) terms, so a few fp32 ulps of those
(6e-8 each) remain where it cancels to ~1e-3.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

import medicalsemseg_tpu.ops.pallas.dice_ce as jax_dc

from medicalsemseg_tpu_torch.ops.kernels import dice_ce as k8

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_dc, "_INTERPRET", True)


def _case(b, m, c, seed):
    """Logits and labels in [-2, C + 1]: every class, -1, -2, C, C + 1."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(b, m, c)) * 2.0).astype(np.float32)
    labels = rng.integers(-2, c + 2, size=(b, m)).astype(np.int32)
    labels[:, :4] = [-1, c, -2, c + 1]
    return logits, labels


SHAPES = [(1, 256, 14), (2, 512, 5), (2, 128, 20)]


@pytest.mark.parametrize("b,m,c", SHAPES)
def test_sums_match_the_pallas_forward(b, m, c):
    logits, labels = _case(b, m, c, seed=b + m + c)
    got = k8.dice_ce_sums(torch.from_numpy(logits), torch.from_numpy(labels))
    inter, psq, cnt, ce = jax_dc._fwd_sums(
        jnp.asarray(logits), jnp.asarray(labels).reshape(b, m, 1), b, c, m)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(inter),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got[:, 1].numpy(), np.asarray(psq), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_array_equal(got[:, 2].numpy(), np.asarray(cnt))
    np.testing.assert_allclose(got[:, 3].sum(-1).numpy(), np.asarray(ce),
                               rtol=RTOL)
    # the negative labels' p^2 is left out, a label of C or more counts
    p = torch.softmax(torch.from_numpy(logits), -1)
    keep = torch.from_numpy(labels) >= 0
    want = (p * p * keep[..., None]).sum(1)
    np.testing.assert_allclose(got[:, 1].numpy(), want.numpy(), rtol=RTOL)


def _pallas_dlogits(logits, labels, ca, cp, ce):
    """The JAX backward kernel on (B, M, C) logits with the coefficients
    given, called as ``_fused_for``'s backward calls it."""
    b, m, c = logits.shape
    t = jax_dc._pick_tile(m)
    spec = functools.partial(pl.BlockSpec,
                             memory_space=jax_dc.pltpu.VMEM)
    return pl.pallas_call(
        functools.partial(jax_dc._bwd_kernel, c=c, t=t),
        grid=(b, m // t),
        in_specs=[spec((1, t, c), lambda bi, mi: (bi, mi, 0)),
                  spec((1, t, 1), lambda bi, mi: (bi, mi, 0)),
                  spec((1, 1, c), lambda bi, mi: (bi, 0, 0)),
                  spec((1, 1, c), lambda bi, mi: (bi, 0, 0)),
                  spec((1, 1, 1), lambda bi, mi: (bi, 0, 0))],
        out_specs=spec((1, t, c), lambda bi, mi: (bi, mi, 0)),
        out_shape=jax.ShapeDtypeStruct((b, m, c), jnp.float32),
        interpret=True,
    )(jnp.asarray(logits), jnp.asarray(labels).reshape(b, m, 1),
      jnp.asarray(ca).reshape(b, 1, c), jnp.asarray(cp).reshape(b, 1, c),
      jnp.full((b, 1, 1), ce, jnp.float32))


@pytest.mark.parametrize("b,m,c", SHAPES)
def test_dlogits_match_the_pallas_backward(b, m, c):
    logits, labels = _case(b, m, c, seed=7 * b + m + c)
    rng = np.random.default_rng(c)
    ca = rng.normal(size=(b, c)).astype(np.float32)
    cp = rng.normal(size=(b, c)).astype(np.float32)
    ce = np.float32(0.37)
    got = k8.dice_ce_dlogits(torch.from_numpy(logits),
                             torch.from_numpy(labels), torch.from_numpy(ca),
                             torch.from_numpy(cp), torch.tensor([ce]))
    want = np.asarray(_pallas_dlogits(logits, labels, ca, cp, ce))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fused_loss_and_gradient_match_jax():
    """The loss and its gradient through ``DiceCEFusedFn`` against JAX's
    ``dice_ce_fused`` (both kernels in interpret mode), labels -1 and C
    among them; tolerances of tests/test_torch_dice_ce.py."""
    logits, labels = _case(2, 256, 6, seed=3)
    shape = (2, 4, 8, 8, 6)
    lg = jnp.asarray(logits).reshape(shape)
    lb = jnp.asarray(labels).reshape(shape[:-1])
    want, want_g = jax.value_and_grad(
        lambda x: jax_dc.dice_ce_fused(x, lb))(lg)
    x = torch.from_numpy(logits).reshape(shape).requires_grad_(True)
    got = k8.dice_ce_fused(x, torch.from_numpy(labels).reshape(shape[:-1]))
    (got_g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-7)
