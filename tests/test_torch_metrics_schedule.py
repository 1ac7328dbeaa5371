"""The port's Dice metric, LR schedule, device-side metric window and
validation mask against the JAX package's, on the same numpy inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from medicalsemseg_tpu.train import loop as jloop
from medicalsemseg_tpu.train import metrics as jm
from medicalsemseg_tpu.train import schedule as js

from medicalsemseg_tpu_torch.train import loop as ploop
from medicalsemseg_tpu_torch.train import metrics as pm
from medicalsemseg_tpu_torch.train import schedule as ps


def _labels(seed, n_classes=5):
    rng = np.random.default_rng(seed)
    shape = (3, 8, 7, 6)
    pred = rng.integers(0, n_classes, size=shape).astype(np.int32)
    true = rng.integers(0, n_classes - 1, size=shape).astype(np.int32)
    true[0] = 0  # one sample holds background only
    mask = np.zeros(shape, np.float32)
    mask[:, :5, :7, :4] = 1
    return pred, true, mask


@pytest.mark.parametrize("masked", [False, True])
def test_dice_per_class_matches_jax(masked):
    pred, true, mask = _labels(0)
    want = jm.dice_per_class(jnp.asarray(pred), jnp.asarray(true), 5,
                             mask=jnp.asarray(mask) if masked else None)
    got = pm.dice_per_class(torch.from_numpy(pred), torch.from_numpy(true), 5,
                            mask=torch.from_numpy(mask) if masked else None)
    for g, w in zip(got, want):
        assert g.shape == (3, 5)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    np.testing.assert_allclose(
        float(pm.mean_dice(*got)), float(jm.mean_dice(*want)), rtol=1e-6)


@pytest.mark.parametrize("warmup,epochs", [(0, 5), (1, 4), (3, 10), (40, 200)])
def test_schedule_matches_jax(warmup, epochs):
    steps_per_epoch = 3
    want = js.make_epoch_schedule(4e-4, warmup, epochs, steps_per_epoch)
    got = ps.make_epoch_schedule(4e-4, warmup, epochs, steps_per_epoch)
    # the JAX schedule is fp32, the port's float64: 1 + cos cancels near the
    # last epoch, so the tail agrees to fp32 rounding of the base LR
    for step in range(0, epochs * steps_per_epoch, 2):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   atol=4e-4 * 1e-6, err_msg=f"step {step}")
    if warmup > 0:
        assert got(0) == got(steps_per_epoch - 1) == 0.0  # LR 0 in epoch 0


def test_metric_window_matches_jax():
    rng = np.random.default_rng(1)
    acc_j = acc_p = None
    for i in range(4):
        m = {"loss": np.float32(rng.uniform(0.5, 2.0)),
             "dice_sum": rng.uniform(0, 2, size=5).astype(np.float32),
             "dice_count": rng.integers(0, 3, size=5).astype(np.float32),
             "grad_norm": np.float32(1.0)}
        if i == 2:
            m["dice_count"][:] = 0     # a step where no class is present
        mj = {k: jnp.asarray(v) for k, v in m.items()}
        mp = {k: torch.from_numpy(np.asarray(v)) for k, v in m.items()}
        acc_j = (jloop._metric_window_init(mj) if acc_j is None
                 else jloop._metric_window_add(acc_j, mj))
        acc_p = (ploop._metric_window(mp) if acc_p is None
                 else ploop._metric_window_add(acc_p, mp))
    assert acc_p.keys() == acc_j.keys()
    for k in acc_j:
        np.testing.assert_allclose(acc_p[k].numpy(), np.asarray(acc_j[k]),
                                   rtol=1e-6, err_msg=k)


def test_valid_extent_mask_matches_jax():
    shape, orig = (1, 6, 8, 5), (4, 8, 2)
    want = jloop.valid_extent_mask(shape, jnp.asarray(orig, jnp.int32))
    got = ploop.valid_extent_mask(shape, orig)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
