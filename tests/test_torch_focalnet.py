"""The port's FocalNet (FocalNetUNETR) against the JAX package on the CPU.

The JAX parameters come from a seeded numpy tree (``tests/test_torch_model``
helpers) and are carried into the port by ``utils.params``; both sides run
in fp32. Held to 1e-4 of the output's largest value:

* ``Conv3d`` with flax's "SAME" padding at even kernels (2, 4, 6, 8: one
  voxel more after than before) and odd ones, depthwise and dense;
* the focal modulation, the block (with and without layer-scale; in eval
  mode the port's MLP is K2's plain version here, the JAX block XLA, and
  once the JAX block's Pallas MLP in interpret mode), the encoder's pyramid
  and the whole model at ``--window_size`` 2 (kernels 2 and 4), 3 (3, 5)
  and 6 (6 and 8, the default).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from medicalsemseg_tpu.models import focalnet as jfn

from medicalsemseg_tpu_torch.models.layers import Conv3d
from medicalsemseg_tpu_torch.models.factory import MODEL_NAMES

from tests.test_torch_model import (
    jax_params,
    model_inputs,
    port_model,
    small_cfg,
)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# fp32 on both sides, sums in other orders (XLA vs oneDNN and torch matmuls)
TOL = 1e-4


def _cfg(**kw):
    base = dict(model="FocalNetUNETR", depths=(2, 2, 1, 1),
                drop_path_rate=0.0)
    base.update(kw)
    return small_cfg(**base)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def sub_state_dict(tree, prefix):
    """The port's state_dict entries under ``prefix`` of a JAX tree, the
    prefix dropped: the key map reads only the tree's keys, so the leaves
    outside the part of interest may be left empty."""
    from medicalsemseg_tpu_torch.utils import params as up

    return {key[len(prefix):]: up._t(up._TO_PORT[kind](np.asarray(
        up._get(tree, path)))) for path, key, kind in up.key_map(tree)
        if key.startswith(prefix)}


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("k,groups", [(2, 6), (4, 6), (6, 6), (8, 6),
                                      (3, 6), (5, 6), (6, 1)])
def test_conv_same_padding_matches_flax(k, groups):
    """Flax pads (k - 1) // 2 before and k // 2 after; the output keeps the
    input's grid (5 x 6 x 7: odd and even axes, one smaller than k)."""
    x = _rand(k, 2, 5, 6, 7, 6)
    conv = fnn.Conv(6, (k, k, k), padding="SAME", feature_group_count=groups,
                    use_bias=False)
    kern = _rand(k + 1, k, k, k, 6 // groups, 6)
    want = conv.apply({"params": {"kernel": jnp.asarray(kern)}},
                      jnp.asarray(x))
    port = Conv3d(6, 6, k, bias=False, groups=groups)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kern.transpose(4, 3, 0, 1, 2)))
        got = port(torch.from_numpy(x))
    assert got.shape == x.shape
    _close(got.numpy(), want)
    # an odd kernel keeps its symmetric padding and the path it always took
    assert (port.padding, port.same_even) == (
        (k // 2, None) if k % 2 else (0, ((k - 1) // 2, k // 2) * 3))


@pytest.fixture(scope="module")
def window6():
    """The default focal window 6 (kernels 6 and 8 at every stage), its
    JAX parameters and the port."""
    cfg = _cfg(window_size=6)
    _, params = jax_params(cfg, seed=31)
    return cfg, params, port_model(cfg, params)


def test_focal_modulation_matches_jax(window6):
    _, params, port = window6
    x = _rand(1, 2, 8, 8, 8, 24)
    want = jfn.FocalModulation(dim=24, focal_level=2, focal_window=6).apply(
        {"params": params["encoder"]["layers_1_blocks_0"]["modulation"]},
        jnp.asarray(x))
    with torch.inference_mode():
        got = port.encoder.layers[1].blocks[0].modulation(torch.from_numpy(x))
    _close(got.numpy(), want)


@pytest.mark.parametrize("layerscale", [False, True],
                         ids=["plain", "layerscale"])
def test_block_matches_jax(layerscale):
    """The block at inference: K2 (its plain version on the CPU) with LN2
    absorbed, ``residual=True`` or ``x + gamma_2 * mlp``; the JAX block
    runs XLA. Layer-scale comes from a block built with it on both sides
    (the factory does not reach it)."""
    from medicalsemseg_tpu_torch.models.focalnet import FocalModulationBlock

    from tests.test_torch_model import seeded_tree

    x = _rand(2, 2, 6, 6, 6, 12)
    jblk = jfn.FocalModulationBlock(dim=12, focal_window=2,
                                    use_layerscale=layerscale)
    shapes = jax.eval_shape(lambda r, v: jblk.init(r, v),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    p = seeded_tree(shapes, 3)["params"]
    want = jax.jit(lambda p, v: jblk.apply({"params": p}, v))(p,
                                                               jnp.asarray(x))
    # the block's leaves under a FocalNet encoder's path, through the key map
    tree = {"encoder": {"patch_embed": {"Conv_0": {}}, "layers_0_blocks_0": p,
                        "layers_0_downsample": {"Conv_0": {}},
                        "norm0": {"LayerNorm_0": {}}}}
    sd = sub_state_dict(tree, "encoder.layers.0.blocks.0.")
    port = FocalModulationBlock(12, focal_window=2, use_layerscale=layerscale)
    port.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x))
    _close(got.numpy(), want)


def test_block_matches_the_jax_pallas_mlp(monkeypatch, window6):
    """With ``use_pallas`` the JAX block runs its fused MLP (the Pallas
    kernel in interpret mode here), the form K2 ports."""
    import medicalsemseg_tpu.ops.pallas.mlp as pmlp

    monkeypatch.setattr(pmlp, "_FORCE_INTERPRET", True)
    _, params, port = window6
    x = _rand(3, 2, 4, 4, 4, 48)
    want = jfn.FocalModulationBlock(dim=48, focal_window=6,
                                    use_pallas=True).apply(
        {"params": params["encoder"]["layers_2_blocks_0"]}, jnp.asarray(x))
    with torch.inference_mode():
        got = port.encoder.layers[2].blocks[0](torch.from_numpy(x))
    _close(got.numpy(), want)


def test_encoder_pyramid_matches_jax(window6):
    """Five scales: the stem, then each stage's stride-2 embedding (the
    last stage's too) under ``norm{i}``."""
    cfg, params, port = window6
    enc = jfn.FocalNet3D(patch_size=(2, 2, 2), embed_dim=12,
                         depths=(2, 2, 1, 1), focal_windows=(6,) * 4,
                         drop_path_rate=0.0)
    vol = model_inputs(cfg, seed=4)[0]
    want = jax.jit(lambda p, v: enc.apply({"params": p}, (v, None, None)))(
        params["encoder"], jnp.asarray(vol))
    with torch.inference_mode():
        got = port.encoder(torch.from_numpy(vol))
    assert [tuple(g.shape[1:]) for g in got] == [
        (16, 16, 16, 12), (8, 8, 8, 24), (4, 4, 4, 48), (2, 2, 2, 96),
        (1, 1, 1, 192)]
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("window", [2, 3, 6])
def test_logits_match_jax(window):
    cfg = _cfg(window_size=window)
    jmodel, params = jax_params(cfg, seed=30 + window)
    x_in = model_inputs(cfg, batch=1, seed=window)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                              deterministic=True))(
        params, tuple(jnp.asarray(a) for a in x_in))
    with torch.inference_mode():
        got = port_model(cfg, params)(tuple(torch.from_numpy(a)
                                            for a in x_in))
    assert got.shape == (1, 32, 32, 32, 3) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_model_names_are_the_jax_factorys():
    from medicalsemseg_tpu.models.factory import MODEL_NAMES as JAX_NAMES

    assert MODEL_NAMES == JAX_NAMES and len(MODEL_NAMES) == 13
