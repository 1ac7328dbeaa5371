"""The port's fused DiceCE (kernel K8's plain versions and ``DiceCEFusedFn``)
against the JAX package's ``dice_ce_fused`` with its Pallas kernels in
interpret mode, and against the port's own unfused ``dice_ce_loss`` and its
autograd gradient, on the same seeded numpy logits and labels.

fp32 on both sides over at most 2 x 256 voxels: losses agree to ~1e-6
relative, gradients (O(1e-3) per element) to 1e-4 relative
(the tolerances of tests/test_pallas_dice_ce.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import medicalsemseg_tpu.ops.pallas.dice_ce as jax_dc
from medicalsemseg_tpu.config import Config

from medicalsemseg_tpu_torch.ops.kernels import dice_ce as k8
from medicalsemseg_tpu_torch.train import losses as pl


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_dc, "_INTERPRET", True)


def _case(shape, n_classes, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=shape + (n_classes,)) * 2.0).astype(np.float32)
    labels = rng.integers(0, n_classes, size=shape).astype(np.int32)
    return logits, labels


SHAPES = [((1, 4, 8, 8), 14),   # M = 256: one whole tile of the kernel
          ((2, 4, 8, 8), 3),    # batch 2
          ((1, 5, 6, 7), 14),   # M = 210: no multiple of any tile
          ((2, 3, 7, 13), 20)]  # more than 16 classes, M = 273


@pytest.mark.parametrize("shape,c", SHAPES)
def test_sums_match_the_pallas_forward(shape, c):
    logits, labels = _case(shape, c)
    b, m = shape[0], int(np.prod(shape[1:]))
    got = k8.dice_ce_sums(torch.from_numpy(logits).reshape(b, m, c),
                          torch.from_numpy(labels).reshape(b, m))
    assert got.shape == (b, 4, c) and got.dtype == torch.float32
    inter, psq, cnt, ce = jax_dc._fwd_sums(
        jnp.asarray(logits).reshape(b, m, c),
        jnp.asarray(labels).reshape(b, m, 1), b, c, m)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(inter), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[:, 1].numpy(), np.asarray(psq), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got[:, 2].numpy(), np.asarray(cnt))
    np.testing.assert_allclose(got[:, 3].sum(-1).numpy(), np.asarray(ce),
                               rtol=1e-5)


@pytest.mark.parametrize("shape,c", SHAPES)
def test_loss_and_dlogits_match_jax_and_the_unfused_loss(shape, c):
    logits, labels = _case(shape, c, seed=1)
    want, want_g = jax.value_and_grad(
        lambda lg: jax_dc.dice_ce_fused(lg, jnp.asarray(labels)))(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = k8.dice_ce_fused(lg, torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.dim() == 0
    (got_g,) = torch.autograd.grad(got, lg)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-7)
    ref = pl.dice_ce_loss(lg, torch.from_numpy(labels))
    (ref_g,) = torch.autograd.grad(ref, lg)
    np.testing.assert_allclose(float(got.detach()), float(ref.detach()),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), ref_g.numpy(), rtol=1e-4,
                               atol=1e-7)


def test_lambda_weights_smooths_and_an_upstream_factor():
    logits, labels = _case((1, 4, 8, 8), 5, seed=2)
    kw = dict(smooth_nr=1e-3, smooth_dr=1e-4, lambda_dice=0.7, lambda_ce=1.3)
    want, want_g = jax.value_and_grad(
        lambda lg: 3.0 * jax_dc.dice_ce_fused(lg, jnp.asarray(labels), True,
                                              *kw.values()))(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = 3.0 * k8.dice_ce_fused(lg, torch.from_numpy(labels), True, **kw)
    (got_g,) = torch.autograd.grad(got, lg)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-7)
    ref = 3.0 * pl.dice_ce_loss(lg, torch.from_numpy(labels),
                                squared_pred=True, **kw)
    np.testing.assert_allclose(float(got.detach()), float(ref.detach()),
                               rtol=1e-5)


def test_squared_pred_false_takes_the_unfused_loss(monkeypatch):
    logits, labels = _case((1, 4, 8, 8), 5, seed=3)
    monkeypatch.setattr(k8, "dice_ce_sums", None)    # must not be reached
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = k8.dice_ce_fused(lg, torch.from_numpy(labels), False)
    (got_g,) = torch.autograd.grad(got, lg)
    want, want_g = jax.value_and_grad(
        lambda x: jax_dc.dice_ce_fused(x, jnp.asarray(labels), False))(
        jnp.asarray(logits))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-7)


def test_bf16_logits_are_cast_and_get_a_bf16_gradient():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.normal(size=(1, 4, 8, 8, 5)).astype(
        np.float32)).bfloat16().requires_grad_(True)
    labels = torch.from_numpy(rng.integers(0, 5, size=(1, 4, 8, 8)))  # int64
    got = k8.dice_ce_fused(logits, labels)
    want = pl.dice_ce_loss(logits.detach().float(), labels)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    (g,) = torch.autograd.grad(got, logits)
    assert g.dtype == torch.bfloat16 and g.shape == logits.shape
    jl = jnp.asarray(logits.detach().float().numpy()).astype(jnp.bfloat16)
    want_g = jax.grad(lambda x: jax_dc.dice_ce_fused(
        x, jnp.asarray(labels.numpy().astype(np.int32))))(jl)
    # both round the same fp32 gradient to bf16: at most one ulp (2^-8) apart
    np.testing.assert_allclose(g.float().numpy(),
                               np.asarray(want_g.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-9)


def test_dlogits_plain_matches_its_formula():
    logits, labels = _case((2, 3, 5, 7), 6, seed=5)
    b, m, c = 2, 105, 6
    rng = np.random.default_rng(6)
    ca = torch.from_numpy(rng.normal(size=(b, c)).astype(np.float32))
    cp = torch.from_numpy(rng.normal(size=(b, c)).astype(np.float32))
    ce = torch.tensor([0.37])
    lm = torch.from_numpy(logits).reshape(b, m, c)
    lb = torch.from_numpy(labels).reshape(b, m)
    got = k8.dice_ce_dlogits(lm, lb, ca, cp, ce)
    # the function whose gradient this is: sum_bc ca I + cp/2 P + ce CE
    x = lm.clone().requires_grad_(True)
    s = k8.dice_ce_sums_plain(x, lb)
    obj = (ca * s[:, 0]).sum() + 0.5 * (cp * s[:, 1]).sum() + ce[0] * s[:, 3].sum()
    (want,) = torch.autograd.grad(obj, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-6)


def test_wrappers_reject_wrong_shapes_on_any_device():
    lg = torch.zeros(2, 10, 40)
    assert k8.MAX_CLASSES == 32
    # the CPU route is plain and takes any class count; the shape checks of
    # the autograd function hold everywhere
    assert k8.dice_ce_sums(lg, torch.zeros(2, 10, dtype=torch.int64)).shape == (
        2, 4, 40)
    with pytest.raises(RuntimeError):
        k8.dice_ce_fused(torch.zeros(2, 4, 4, 4, 3),
                         torch.zeros(2, 4, 4, 5, dtype=torch.int64))


@pytest.mark.parametrize("loss_fn", ["DiceCE", "Tversky"])
def test_build_loss_with_fused_loss(monkeypatch, loss_fn):
    """--fused_loss: DiceCE without a mask goes through the fused function,
    with a mask (validation) through the unfused one; other losses ignore
    the flag, as in the JAX package."""
    cfg = Config(loss_fn=loss_fn, fused_loss=True, smooth_nr=1e-4,
                 smooth_dr=1e-3)
    plain = pl.build_loss(Config(loss_fn=loss_fn, smooth_nr=1e-4,
                                 smooth_dr=1e-3))
    calls = []
    real = k8.DiceCEFusedFn.apply
    monkeypatch.setattr(k8.DiceCEFusedFn, "apply",
                        lambda *a: calls.append(a[2:]) or real(*a))
    fused = pl.build_loss(cfg)
    logits, labels = _case((2, 5, 6, 7), 4, seed=7)
    lg, lb = torch.from_numpy(logits), torch.from_numpy(labels)
    mask = torch.zeros(2, 5, 6, 7)
    mask[:, :3, :, :4] = 1.0
    np.testing.assert_allclose(float(fused(lg, lb)), float(plain(lg, lb)),
                               rtol=1e-5)
    assert len(calls) == (1 if loss_fn == "DiceCE" else 0)
    if calls:
        assert calls[0] == (1e-4, 1e-3, 1.0, 1.0)
    assert float(fused(lg, lb, mask=mask)) == float(plain(lg, lb, mask=mask))
    assert len(calls) == (1 if loss_fn == "DiceCE" else 0)   # mask -> unfused
