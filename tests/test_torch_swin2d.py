"""The port's 2D Swin (Swin2D, ``--input_dim 2``) against the JAX package on
the CPU, in fp32, to 1e-4 of the output's largest value.

The bias index, window partition and the shifted-window mask against the
JAX functions; the bilinear resize against ``jax.image.resize``; with
seeded numpy parameters carried by ``utils.params``: a shifted block, a
block whose resolution clamps the window (and drops the shift), the patch
merging and embedding, the classifier (absolute position table, head) and
``Swin2DSeg`` as the factory builds it, which raises for ``--input_dim 3``
as the JAX factory does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medicalsemseg_tpu.models import build_model as jax_build_model
from medicalsemseg_tpu.models import swin2d as js

from medicalsemseg_tpu_torch.models import swin2d as ps
from medicalsemseg_tpu_torch.models.factory import build_model
from medicalsemseg_tpu_torch.ops.resize import resize_linear
from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

from tests.test_torch_focalnet import sub_state_dict
from tests.test_torch_model import seeded_tree, small_cfg

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

TOL = 1e-4


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _init(module, seed, *args, **kw):
    shapes = jax.eval_shape(lambda r, *a: module.init(r, *a, **kw),
                            jax.random.PRNGKey(0), *args)
    return seeded_tree(shapes, seed)["params"]


def _backbone_state(p, prefix):
    """The port's state_dict entries of a Swin2D backbone tree ``p`` under
    ``prefix`` (the segmentation head's leaves left empty)."""
    tree = {"backbone": p, "linear_fuse": {}, "fuse_norm": {},
            "linear_pred": {}}
    return sub_state_dict(tree, prefix)


@pytest.mark.parametrize("ws,res,ss", [((4, 4), (8, 8), 2), ((3, 5), (6, 10),
                                                             1)])
def test_tables_and_partition_match_jax(ws, res, ss):
    np.testing.assert_array_equal(ps.relative_position_index_2d(ws),
                                  js.relative_position_index_2d(ws))
    if ws[0] == ws[1]:
        np.testing.assert_array_equal(
            ps.shift_attn_mask_2d(res, ws[0], ss),
            js.shift_attn_mask_2d(res, ws[0], ss))
        x = _rand(1, 2, *res, 3)
        want = js.window_partition_2d(jnp.asarray(x), ws[0])
        got = ps.window_partition_2d(torch.from_numpy(x), ws[0])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = ps.window_reverse_2d(got, ws[0], res)
        np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("size,out", [((4, 4), (16, 16)), ((2, 3), (16, 16)),
                                      ((8, 8), (8, 8)), ((5, 7), (9, 4))])
def test_resize_bilinear_matches_jax(size, out):
    x = _rand(2, 2, *size, 3)
    want = jax.image.resize(jnp.asarray(x), (2, *out, 3), method="bilinear")
    got = resize_linear(torch.from_numpy(x), out)
    _close(got.numpy(), want)


@pytest.mark.parametrize("res,ws,shift", [((8, 8), 4, 2), ((4, 4), 4, 2),
                                          ((4, 4), 6, 3)],
                         ids=["shifted", "clamped_equal", "clamped_larger"])
def test_block_matches_jax(res, ws, shift):
    """min(resolution) <= window clamps the window to the resolution and
    drops the shift: one window, no mask."""
    x = _rand(3, 2, *res, 16)
    jm = js.SwinBlock2D(dim=16, input_resolution=res, num_heads=2,
                        window_size=ws, shift_size=shift)
    p = _init(jm, 3, jnp.asarray(x))
    want = jax.jit(jm.apply)({"params": p}, jnp.asarray(x))
    port = ps.SwinBlock2D(16, res, 2, ws, shift)
    assert (port.window_size, port.shift_size) == (
        (ws, shift) if min(res) > ws else (min(res), 0))
    tree = {"patch_embed": {"proj": {}, "norm": {"LayerNorm_0": {}}},
            "layers_0_blocks_0": p}
    port.load_state_dict(_backbone_state(tree, "backbone.layers.0.blocks.0."),
                         strict=True)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x))
    _close(got.numpy(), want)


def test_merging_and_embedding_match_jax():
    x = _rand(4, 2, 8, 8, 16)
    jm = js.PatchMerging2D(dim=16)
    p = _init(jm, 4, jnp.asarray(x))
    want = jax.jit(jm.apply)({"params": p}, jnp.asarray(x))
    port = ps.PatchMerging2D(16)
    port.norm.weight.data = torch.from_numpy(
        np.asarray(p["norm"]["LayerNorm_0"]["scale"]))
    port.norm.bias.data = torch.from_numpy(
        np.asarray(p["norm"]["LayerNorm_0"]["bias"]))
    port.reduction.weight.data = torch.from_numpy(
        np.ascontiguousarray(np.asarray(p["reduction"]["kernel"]).T))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    _close(got.numpy(), want)

    img = _rand(5, 2, 18, 18, 3)
    jm = js.PatchEmbed2D(patch_size=4, embed_dim=8)
    p = _init(jm, 5, jnp.asarray(img))
    want = jax.jit(jm.apply)({"params": p}, jnp.asarray(img))
    port = ps.PatchEmbed2D(4, 3, 8)
    port.load_state_dict(_backbone_state({"patch_embed": p},
                                         "backbone.patch_embed."),
                         strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(img))
    assert got.shape == (2, 4, 4, 8)
    _close(got.numpy(), want)


def test_classifier_matches_jax():
    """The upstream contract: absolute position table, final LN, the mean
    over tokens and the head."""
    img = _rand(6, 2, 32, 32, 3)
    kw = dict(img_size=32, patch_size=2, in_chans=3, num_classes=5,
              embed_dim=8, depths=(2, 1, 1), num_heads=(2, 2, 2),
              window_size=4, ape=True)
    jm = js.SwinTransformer2D(**kw)
    p = _init(jm, 6, jnp.asarray(img))
    want = jax.jit(jm.apply)({"params": p}, jnp.asarray(img))
    port = ps.SwinTransformer2D(**kw, drop_path_rate=0.0)
    port.load_state_dict(_backbone_state(p, "backbone."), strict=True)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(img))
    assert got.shape == (2, 5)
    _close(got.numpy(), want)


@pytest.mark.parametrize("vol,window,patch", [(64, 4, 2), (64, 4, 1)],
                         ids=["p2", "p4"])
def test_swin2d_seg_matches_jax(vol, window, patch):
    """The factory's model: ``--patch_size`` 1 means patch 4, whose grids 16,
    8, 4, 2 clamp the window 4 at the last two stages (no shift there)."""
    cfg = small_cfg(model="Swin2D", input_dim=2, vol_size=vol,
                    window_size=window, patch_size=patch)
    jmodel = jax_build_model(cfg)
    x_in = (_rand(7, 2, vol, vol, 1), np.zeros((2, 2), np.float32),
            np.ones((2, 2), np.float32))
    params = _init(jmodel, 7, tuple(jnp.asarray(a) for a in x_in),
                   deterministic=True)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                              deterministic=True))(
        params, tuple(jnp.asarray(a) for a in x_in))
    port = build_model(cfg)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = port.eval()(tuple(torch.from_numpy(a) for a in x_in))
    assert got.shape == (2, vol, vol, 3) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_swin2d_needs_input_dim_2():
    with pytest.raises(ValueError, match="input_dim 2"):
        build_model(small_cfg(model="Swin2D"))
