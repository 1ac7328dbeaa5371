"""HD95 and the fold majority vote of the port against the JAX package.

On the CPU: ``train/metrics.hausdorff95`` on the host path is bit-equal to
the JAX function on seeded masks of 4 and 5 classes (a class present on both
sides, one on one side only: inf, one on neither: NaN, surfaces that touch
the volume's border, so the union-bbox crop matters); the device path
(chunked fp32 products, here on CPU tensors, with chunks made small so that
several run) is bit-equal to the host path; coordinates past 1672 send a
class to the distance transform. ``majority_vote`` and ``majority_vote_np``
equal the JAX functions, ties included.

On the card (``cuda`` marker: ``python -m pytest --noconftest -m cuda
tests/test_torch_metrics_hd95.py``): the device path on the GPU is bit-equal
to the host path with TF32 switched on globally before the call (the
function switches it off around its products and restores it). JAX is
imported inside the CPU tests only.
"""

import numpy as np
import pytest
import torch

from medicalsemseg_tpu_torch.infer import ensemble
from medicalsemseg_tpu_torch.train import metrics


def _blob(shape, center, radius, rng):
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    d2 = sum((g - c) ** 2 for g, c in zip(grids, center))
    noise = rng.uniform(-0.3, 0.3, size=shape) * radius ** 2
    return d2 + noise < radius ** 2


def _masks(seed, shape=(26, 22, 19)):
    """pred and target label maps: class 1 in both (shifted, touching the
    border), class 2 in both (different radii), class 3 in pred only, class
    4 in neither."""
    rng = np.random.default_rng(seed)
    pred = np.zeros(shape, np.int32)
    target = np.zeros(shape, np.int32)
    pred[_blob(shape, (3, 5, 4), 6, rng)] = 1
    target[_blob(shape, (5, 4, 6), 5, rng)] = 1
    pred[_blob(shape, (17, 13, 12), 4, rng)] = 2
    target[_blob(shape, (18, 14, 11), 6, rng)] = 2
    pred[_blob(shape, (20, 4, 15), 3, rng)] = 3
    return pred, target


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("include_background", [False, True])
def test_host_hd95_bit_equal_to_jax(seed, include_background):
    from medicalsemseg_tpu.train import metrics as jm

    pred, target = _masks(seed)
    want = jm.hausdorff95(pred, target, 5, include_background)
    got = metrics.hausdorff95(pred, target, 5, include_background)
    np.testing.assert_array_equal(got, want)
    fg = got[1:] if include_background else got
    assert np.isfinite(fg[:2]).all() and fg[2] == np.inf and np.isnan(fg[3])


@pytest.mark.parametrize("seed", [0, 3])
def test_device_path_bit_equal_to_host(seed, monkeypatch):
    monkeypatch.setattr(metrics, "_P_CHUNK", 64)
    monkeypatch.setattr(metrics, "_T_CHUNK", 100)
    pred, target = _masks(seed)
    host = metrics.hausdorff95(pred, target, 5)
    dev = metrics.hausdorff95(pred, target, 5, device=True, on="cpu")
    np.testing.assert_array_equal(dev, host)


def test_long_coordinates_take_the_distance_transform(monkeypatch):
    """A class whose surfaces span more than 1672 voxels after the shift to
    their union box leaves the fp32 products for the host transform."""
    calls = []
    real = metrics._nn_min_dists_device
    monkeypatch.setattr(metrics, "_nn_min_dists_device",
                        lambda p, t, on: calls.append(len(p)) or real(p, t,
                                                                      on))
    shape = (1700, 4, 4)
    pred = np.zeros(shape, np.int32)
    target = np.zeros(shape, np.int32)
    pred[0:2, 1:3, 1:3] = 1
    target[1690:1693, 1:3, 1:3] = 1
    pred[10:13, 0:3, 0:3] = 2
    target[11:14, 1:4, 0:3] = 2
    host = metrics.hausdorff95(pred, target, 3)
    dev = metrics.hausdorff95(pred, target, 3, device=True, on="cpu")
    np.testing.assert_array_equal(dev, host)
    assert len(calls) == 2   # class 2 both ways; class 1 took the transform
    assert host[0] > metrics._DEVICE_EXACT_MAX_COORD


@pytest.mark.parametrize("n_classes", [2, 4])
def test_majority_vote_equals_jax(n_classes):
    import jax.numpy as jnp
    from medicalsemseg_tpu.infer import ensemble as je

    rng = np.random.default_rng(n_classes)
    folds = rng.integers(0, n_classes, size=(4, 9, 7, 5)).astype(np.int64)
    folds[:, 0, 0, 0] = (1, 1, 0, 0)           # a tie with background
    folds[:, 0, 0, 1] = (1, 1, 0, 2 % n_classes)
    want = np.asarray(je.majority_vote(jnp.asarray(folds), n_classes))
    np.testing.assert_array_equal(je.majority_vote_np(folds, n_classes),
                                  want)
    np.testing.assert_array_equal(ensemble.majority_vote_np(folds, n_classes),
                                  want)
    got = ensemble.majority_vote(torch.from_numpy(folds), n_classes)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0, 0] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 4])
def test_device_hd95_on_the_card_with_tf32_on(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    pred, target = _masks(seed, shape=(120, 90, 70))
    host = metrics.hausdorff95(pred, target, 5)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        dev = metrics.hausdorff95(pred, target, 5, device=True, on="cuda")
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    np.testing.assert_array_equal(dev, host)
