"""Mirror test-time augmentation of the port against the JAX package.

``mirror_tta`` on a seeded per-voxel predictor whose output depends on the
position inside the window (so every flip matters), then the stitched output
of the sliding window with TTA against the JAX runner with ``tta=True`` on a
small flagship, and the prediction CLI's ``--tta_mirror``. fp32 throughout.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from medicalsemseg_tpu.infer import sliding_window as jsw
from medicalsemseg_tpu.infer.tta import mirror_tta as jax_mirror_tta

from medicalsemseg_tpu_torch.cli import run_test as port_cli
from medicalsemseg_tpu_torch.infer import sliding_window as tsw
from medicalsemseg_tpu_torch.infer.tta import mirror_tta

from tests.test_torch_model import jax_params, port_model, small_cfg
from tests.test_torch_run_test import ARGV, _write_test_set

# fp32 softmax and mean of 8 terms on both sides: a few ulps of values <= 1
RTOL = ATOL = 1e-6
# the flagship's logits (see test_torch_model), softmaxed, averaged, blended
MODEL_RTOL = MODEL_ATOL = 1e-4


def _predictors(seed, shape, c, nc):
    """The same position-dependent per-voxel predictor for both frameworks."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(c, nc)).astype(np.float32)
    pos = rng.normal(size=(*shape, nc)).astype(np.float32)

    def jpred(mi):
        win, ctr, _ = mi
        return win @ w + pos[None] + ctr[:, None, None, None, :]

    def tpred(mi):
        win, ctr, _ = mi
        return (win @ torch.from_numpy(w) + torch.from_numpy(pos)[None]
                + ctr[:, None, None, None, :])

    return jpred, tpred


@pytest.mark.parametrize("apply_softmax", [True, False])
def test_mirror_tta_matches_jax(apply_softmax):
    shape, c, nc = (4, 6, 8), 2, 3
    jpred, tpred = _predictors(51, shape, c, nc)
    rng = np.random.default_rng(52)
    win = rng.normal(size=(3, *shape, c)).astype(np.float32)
    ctr = rng.uniform(size=(3, 3)).astype(np.float32)
    aff = np.ones((3, 3), np.float32)
    want = jax_mirror_tta(jpred, apply_softmax=apply_softmax)(
        (jnp.asarray(win), jnp.asarray(ctr), jnp.asarray(aff)))
    calls = []

    def counted(mi):
        calls.append(mi[0].shape)
        return tpred(mi)

    got = mirror_tta(counted, apply_softmax=apply_softmax)(
        (torch.from_numpy(win), torch.from_numpy(ctr), torch.from_numpy(aff)))
    assert len(calls) == 8 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    if apply_softmax:
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)
    # the flips matter for this predictor
    plain = tpred((torch.from_numpy(win), torch.from_numpy(ctr), None))
    if apply_softmax:
        plain = torch.softmax(plain, -1)
    assert float((plain - got).abs().max()) > 1e-2


def test_stitched_tta_matches_jax_sliding_window():
    """A two-stage flagship at roi 16, two windows along depth: the JAX
    runner with tta=True against the port's stitcher around mirror_tta."""
    cfg = small_cfg(vol_size=16, depths=(1, 1), num_heads=(2, 2))
    jmodel, params = jax_params(cfg, seed=53)
    vol = np.random.default_rng(53).normal(size=(1, 20, 16, 16, 1)).astype(
        np.float32)
    aff = np.ones((1, 3), np.float32)
    roi = cfg.vol_size3()
    want = np.asarray(jsw.jitted_sliding_window(jmodel)(
        {"params": params}, jnp.asarray(vol), jnp.asarray(aff), roi=roi,
        sw_batch=2, overlap=0.5, mode="gaussian", n_classes=3, tta=True))
    with torch.inference_mode():
        got = tsw.sliding_window_inference(
            torch.from_numpy(vol), torch.from_numpy(aff), roi, 2,
            mirror_tta(port_model(cfg, params)), 3, overlap=0.5,
            mode="gaussian").numpy()
    assert got.shape == want.shape == (1, 20, 16, 16, 3)
    # blended probabilities: every voxel's classes sum to 1
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.999


def test_cli_tta_mirror_calls_the_model_eight_times(tmp_path):
    _write_test_set(tmp_path)
    argv = ARGV + ["--data_path", str(tmp_path), "--device", "cpu",
                   "--output_dir", str(tmp_path / "out")]
    plain = port_cli.main(port_cli.get_args(argv))
    tta = port_cli.main(port_cli.get_args(argv + ["--tta_mirror"]))
    assert [r["windows"] for r in tta] == [r["windows"] for r in plain]
    assert [r["predictor_calls"] for r in tta] == [
        8 * r["predictor_calls"] for r in plain]
