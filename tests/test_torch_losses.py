"""The port's losses against ``medicalsemseg_tpu.train.losses`` on the same
numpy logits and labels, masked and not. fp32 on both sides; the reductions
run over 2 x 10 x 9 x 8 voxels, so the scalars agree to ~1e-7 relative."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from medicalsemseg_tpu.config import Config
from medicalsemseg_tpu.train import losses as jl

from medicalsemseg_tpu_torch.train import losses as pl

TOL = 1e-6


def _data(seed=0, n_classes=4):
    rng = np.random.default_rng(seed)
    shape = (2, 10, 9, 8)
    logits = rng.normal(size=(*shape, n_classes)).astype(np.float32) * 2
    labels = rng.integers(0, n_classes, size=shape).astype(np.int32)
    labels[1][labels[1] == 3] = 0      # a class absent from one sample
    mask = np.zeros(shape, np.float32)
    mask[:, :7, :9, :5] = 1.0          # the leading extents of a padded volume
    return logits, labels, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,kw", [
    ("dice_loss", {}), ("dice_loss", {"squared_pred": False}),
    ("cross_entropy_loss", {}), ("dice_ce_loss", {}),
    ("dice_ce_loss", {"lambda_dice": 0.3, "lambda_ce": 0.7, "smooth_nr": 1e-3}),
    ("tversky_loss", {"alpha": 0.3, "beta": 0.7}),
    ("focal_loss", {"gamma": 2.0}), ("dice_focal_loss", {}),
])
def test_loss_matches_jax(name, kw, masked):
    logits, labels, mask = _data()
    want = getattr(jl, name)(jnp.asarray(logits), jnp.asarray(labels),
                             mask=jnp.asarray(mask) if masked else None, **kw)
    got = getattr(pl, name)(torch.from_numpy(logits), torch.from_numpy(labels),
                            mask=torch.from_numpy(mask) if masked else None,
                            **kw)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("loss_fn", ["DiceCE", "Tversky", "DiceFocal"])
def test_build_loss_and_its_gradient_match_jax(loss_fn):
    import jax

    cfg = Config(loss_fn=loss_fn, tversky_alpha=0.4, tversky_beta=0.6,
                 smooth_nr=1e-4, smooth_dr=1e-3)
    logits, labels, mask = _data(seed=2)
    jf, pf = jl.build_loss(cfg), pl.build_loss(cfg)
    want, want_g = jax.value_and_grad(
        lambda lg: jf(lg, jnp.asarray(labels), mask=jnp.asarray(mask)))(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = pf(lg, torch.from_numpy(labels), mask=torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-8)


def test_masked_loss_equals_loss_of_the_slice():
    logits, labels, mask = _data(seed=3)
    full = pl.dice_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                           mask=torch.from_numpy(mask))
    cut = pl.dice_ce_loss(torch.from_numpy(logits[:, :7, :, :5]),
                          torch.from_numpy(labels[:, :7, :, :5]))
    np.testing.assert_allclose(float(full), float(cut), rtol=1e-5)


def test_unknown_and_unported_losses_raise():
    with pytest.raises(ValueError, match="DiceCE, Tversky, DiceFocal"):
        pl.build_loss(Config(loss_fn="Lovasz"))
    # --fused_loss is ported (kernel K8) and changes no other loss's errors
    assert callable(pl.build_loss(Config(fused_loss=True)))
    with pytest.raises(ValueError, match="DiceCE, Tversky, DiceFocal"):
        pl.build_loss(Config(loss_fn="Lovasz", fused_loss=True))
