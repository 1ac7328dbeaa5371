"""Sliding-window inference of the port against the JAX package.

Same numpy volumes through JAX ``sliding_window_inference`` and the port's,
first with a per-voxel predictor that also reads the window centres and the
affine (so the window order, the centres and the blend are all checked),
then with the small flagship end to end. fp32 throughout.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalsemseg_tpu.infer import sliding_window as jsw

from medicalsemseg_tpu_torch.infer import sliding_window as tsw

from tests.test_torch_model import jax_params, port_model, small_cfg

# fp32 blends of the same per-window values; only the order of the fp32
# sums differs
RTOL = ATOL = 1e-5
# the flagship's logits (see test_torch_model) blended
MODEL_RTOL = MODEL_ATOL = 1e-4


@pytest.mark.parametrize("shape,cval,mode", [
    ((40, 36, 44), 0.0, "gaussian"),   # not a multiple of the roi
    ((20, 24, 28), -1.0, "gaussian"),  # smaller than the roi: pad and crop
    ((33, 32, 40), 0.5, "constant"),
])
def test_matches_jax_per_voxel_predictor(shape, cval, mode):
    rng = np.random.default_rng(sum(shape))
    c, nc, roi = 2, 3, (32, 32, 32)
    vol = rng.normal(size=(2, *shape, c)).astype(np.float32)
    aff = rng.uniform(0.5, 2.0, size=(2, 3)).astype(np.float32)
    w = rng.normal(size=(c, nc)).astype(np.float32)

    def jpred(mi):
        win, ctr, a = mi
        return (win @ w + ctr[:, None, None, None, :]
                + 0.1 * a[:, None, None, None, :])

    def tpred(mi):
        win, ctr, a = mi
        return (win @ torch.from_numpy(w) + ctr[:, None, None, None, :]
                + 0.1 * a[:, None, None, None, :])

    want = jsw.sliding_window_inference(
        jnp.asarray(vol), jnp.asarray(aff), roi, 3, jpred, overlap=0.5,
        mode=mode, cval=cval, n_classes=nc)
    got = tsw.sliding_window_inference(
        torch.from_numpy(vol), torch.from_numpy(aff), roi, 3, tpred, nc,
        overlap=0.5, mode=mode, cval=cval)
    assert got.shape == (2, *shape, nc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_host_helpers_match_jax():
    for img, roi, ov in (((256, 256, 160), (96,) * 3, 0.5),
                         ((40, 36, 44), (32,) * 3, 0.25)):
        iv = tsw.scan_interval(img, roi, ov)
        assert iv == jsw.scan_interval(img, roi, ov)
        np.testing.assert_array_equal(tsw.dense_patch_starts(img, roi, iv),
                                      jsw.dense_patch_starts(img, roi, iv))
    np.testing.assert_array_equal(tsw.gaussian_importance_map((32, 24, 16)),
                                  jsw.gaussian_importance_map((32, 24, 16)))
    vol = np.ones((33, 20, 64, 1), np.float32)
    tp, to = tsw.bucket_pad(vol, 32, -2.0)
    jp, jo = jsw.bucket_pad(vol, 32, -2.0)
    assert to == jo
    np.testing.assert_array_equal(tp, jp)


def test_matches_jax_with_small_model():
    """A two-stage flagship at roi 16 as predictor: two windows along depth."""
    cfg = small_cfg(vol_size=16, depths=(1, 1), num_heads=(2, 2))
    jmodel, params = jax_params(cfg, seed=21)
    vol = np.random.default_rng(21).normal(size=(1, 20, 16, 16, 1)).astype(
        np.float32)
    aff = np.ones((1, 3), np.float32)
    roi = cfg.vol_size3()

    run = jax.jit(lambda p, v, a: jsw.sliding_window_inference(
        v, a, roi, 2, lambda mi: jmodel.apply({"params": p}, mi,
                                              deterministic=True),
        overlap=0.5, mode="gaussian", n_classes=3))
    want = np.asarray(run(params, jnp.asarray(vol), jnp.asarray(aff)))
    with torch.inference_mode():
        got = tsw.sliding_window_inference(
            torch.from_numpy(vol), torch.from_numpy(aff), roi, 2,
            port_model(cfg, params), 3, overlap=0.5, mode="gaussian").numpy()
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree > 0.999, agree
