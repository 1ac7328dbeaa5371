"""The port's multi-process inference against the JAX package on the CPU:
``grouped_padded_volumes`` (both policies, exact), the ranks' volume shares
of ``rank_volumes`` against the JAX groups, ``sliding_window_inference_sharded``
on two gloo ranks against JAX's on a 2-device mesh, and ``run_validation``
on two ranks against one process. The ranks are subprocesses
(``tests/test_torch_dist.py`` ``run_ranks``) that import the port only."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from medicalsemseg_tpu.data.transforms import Sample as JaxSample
from medicalsemseg_tpu.infer import sliding_window as jsw
from medicalsemseg_tpu.parallel.mesh import create_mesh

from medicalsemseg_tpu_torch.infer import sliding_window as psw

from tests.test_torch_dist import run_ranks

# the host samples and the validation run, shared by this process and the
# ranks (which import the port only, so they take this source, not the
# module)
_COMMON = '''
import numpy as np
from medicalsemseg_tpu_torch.data.preprocess import Sample

SHAPES = [(18, 20, 17), (25, 18, 18), (24, 28, 24), (17, 19, 18),
          (30, 26, 22), (19, 18, 18)]


def fake_samples(shapes, seed=0, cls=Sample, n_classes=3):
    """Seeded host Samples (image, label, affines), as
    ``tests/test_sharding.py`` makes them."""
    rng = np.random.default_rng(seed)
    out = []
    for i, shp in enumerate(shapes):
        img = rng.normal(size=(*shp, 1)).astype(np.float32)
        lab = rng.integers(0, n_classes, (*shp, 1)).astype(np.int32)
        out.append(cls(image=img, label=lab, affine=np.eye(4),
                       original_affine=np.diag([1.5, 1.5, 2.0, 1.0]),
                       original_shape=shp, name=f"vol{i}.nii.gz"))
    return out


def validation_stats(policy, shapes):
    """``run_validation`` of a seeded small flagship on seeded volumes,
    with ``--val_group_policy`` ``policy``, in this process's world."""
    import torch

    from medicalsemseg_tpu_torch.config import Config
    from medicalsemseg_tpu_torch.models.factory import build_model, init_weights
    from medicalsemseg_tpu_torch.train.loop import run_validation
    from medicalsemseg_tpu_torch.train.state import create_train_state

    cfg = Config(model="nnFormerUNETR", vol_size=16, patch_size=2,
                 hidden_dim=12, depths=(1, 1), num_heads=(2, 2),
                 window_size=2, output_dim=3, compute_dtype="float32",
                 sw_bucket_multiple=8, sw_batch_size=2, val_infer_overlap=0.5,
                 val_group_policy=policy)
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(3))
    state = create_train_state(cfg, model, 1)
    return run_validation(state, fake_samples(shapes, 13), cfg, epoch=0)
'''
_NS: dict = {}
exec(_COMMON, _NS)
SHAPES, fake_samples, validation_stats = (
    _NS["SHAPES"], _NS["fake_samples"], _NS["validation_stats"])


@pytest.mark.parametrize("policy", ["bucket", "sorted_max"])
@pytest.mark.parametrize("n_group", [1, 2, 3])
def test_grouped_padded_volumes_equal_jax(policy, n_group):
    want = list(jsw.grouped_padded_volumes(
        fake_samples(SHAPES, 3, JaxSample), n_group, 8, -7.5, policy))
    got = list(psw.grouped_padded_volumes(
        fake_samples(SHAPES, 3), n_group, 8, -7.5, policy))
    assert len(got) == len(want)
    for (gv, ga, gs, go), (wv, wa, ws, wo) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(ga, wa)
        assert [s.name for s in gs] == [s.name for s in ws]
        assert go == wo


@pytest.mark.parametrize("policy", ["bucket", "sorted_max"])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_rank_volumes_share_out_every_volume_once(policy, world):
    """Every volume goes to one rank. Under ``sorted_max`` a rank's volume
    is its JAX group member, padded to the group's maximum; under
    ``bucket`` (or at world 1) it is padded to its own bucket, which is
    what JAX's bucket groups give each volume."""
    samples = fake_samples(SHAPES, 5)
    seen = {}
    for r in range(world):
        for i, s, padded, orig in psw.rank_volumes(samples, r, world, 8,
                                                   -1.0, policy):
            assert i not in seen and s is samples[i]
            assert orig == s.image.shape[:3]
            seen[i] = padded
    assert sorted(seen) == list(range(len(samples)))
    if policy == "bucket" or world == 1:
        for i, s in enumerate(samples):
            np.testing.assert_array_equal(seen[i],
                                          psw.bucket_pad(s.image, 8, -1.0)[0])
        return
    jsamples = fake_samples(SHAPES, 5, JaxSample)
    for vols, _, members, _ in jsw.grouped_padded_volumes(
            jsamples, world, 8, -1.0, policy):
        for k, m in enumerate(members):
            np.testing.assert_array_equal(seen[int(m.name[3])], vols[k])


_W = np.random.default_rng(1).normal(size=(2, 3)).astype(np.float32)
_U = np.random.default_rng(2).normal(size=(3, 3)).astype(np.float32)


def _jax_predictor(mi):
    x, ctr, aff = mi
    return (jnp.einsum("bdhwc,ck->bdhwk", x, _W)
            + (ctr @ _U + aff @ _U)[:, None, None, None, :])


_SHARDED = """
    import json, os, numpy as np, torch
    from medicalsemseg_tpu_torch.config import Config
    from medicalsemseg_tpu_torch.infer import sliding_window as psw
    from medicalsemseg_tpu_torch.parallel import dist as pdist

    pdist.init_distributed_mode(Config(), torch.device("cpu"))
    d = np.load(os.path.join(os.environ["OUT"], "sharded_in.npz"))
    W, U = torch.from_numpy(d["W"]), torch.from_numpy(d["U"])
    calls = []

    def predictor(mi):
        x, ctr, aff = mi
        calls.append(x.shape[0])
        return (torch.einsum("bdhwc,ck->bdhwk", x, W)
                + (ctr @ U + aff @ U)[:, None, None, None, :])

    out = psw.sliding_window_inference_sharded(
        torch.from_numpy(d["vol"]), torch.from_numpy(d["aff"]), (16, 16, 16),
        predictor, 3, overlap=0.5, mode="gaussian", cval=-1.0)
    np.save(os.path.join(os.environ["OUT"],
                         f"sharded_{pdist.get_rank()}.npy"), out.numpy())
    print("WINDOWS", len(calls))
    pdist.shutdown()
"""


def test_sliding_window_inference_sharded_matches_jax(tmp_path):
    """Nine windows over two ranks (one zero-weight repeat), a dim below
    the roi (symmetric cval padding): every rank returns JAX's stitched
    volume."""
    rng = np.random.default_rng(4)
    vol = rng.normal(size=(1, 28, 28, 12, 2)).astype(np.float32)
    aff = np.asarray([[1.5, 1.5, 2.0]], np.float32)
    mesh = create_mesh((2,), devices=jax.devices()[:2])
    want = np.asarray(jsw.sliding_window_inference_sharded(
        jnp.asarray(vol), jnp.asarray(aff), (16, 16, 16), _jax_predictor,
        mesh, overlap=0.5, mode="gaussian", cval=-1.0, n_classes=3))
    np.savez(tmp_path / "sharded_in.npz", vol=vol, aff=aff, W=_W, U=_U)
    outs = run_ranks(_SHARDED, 2, tmp_path)
    assert all("WINDOWS 5" in o for o in outs)   # 9 windows + 1 repeat
    for r in range(2):
        got = np.load(tmp_path / f"sharded_{r}.npy")
        assert got.shape == want.shape == (1, 28, 28, 12, 3)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


_VALIDATION = _COMMON + """
import json, os, torch
from medicalsemseg_tpu_torch.config import Config
from medicalsemseg_tpu_torch.parallel import dist as pdist

torch.set_num_threads(2)
pdist.init_distributed_mode(Config(), torch.device("cpu"))
out = {"bucket": validation_stats("bucket", SHAPES[:5]),
       "sorted_max": validation_stats("sorted_max", [(24, 20, 28)] * 3)}
json.dump(out, open(os.path.join(os.environ["OUT"],
                                 f"val_{pdist.get_rank()}.json"), "w"))
pdist.shutdown()
"""


def test_run_validation_on_two_ranks_matches_one(tmp_path):
    """Two ranks, each predicting its volumes whole and summing the meters:
    the averaged stats of one process (bucket, five volumes of four padded
    shapes; sorted_max on shape-uniform volumes, where it pads as bucket
    does), up to the order of the sums."""
    want = {"bucket": validation_stats("bucket", SHAPES[:5]),
            "sorted_max": validation_stats("sorted_max", [(24, 20, 28)] * 3)}
    run_ranks(_VALIDATION, 2, tmp_path)
    for r in range(2):
        got = json.loads((tmp_path / f"val_{r}.json").read_text())
        for policy in want:
            assert got[policy].keys() == want[policy].keys()
            for k, v in want[policy].items():
                np.testing.assert_allclose(got[policy][k], v, rtol=1e-12,
                                           err_msg=f"{policy} {k}")
