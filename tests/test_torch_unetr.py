"""The port's ViT and UNETR (UNETR_Official) against the JAX package on the
CPU, in fp32, to 1e-4 of the output's largest value.

Seeded numpy parameters (``tests/test_torch_model`` helpers) carried into
the port by ``utils.params``: the self-attention, the block at inference
(the port's MLP is K2's plain version here; the JAX block XLA, and once its
Pallas MLP in interpret mode) with and without layer-scale ``init_values``,
the ViT's taps with and without a class token, the progressive up-block,
a small UNETR module, and the factory's ViT-B UNETR_Official at vol 32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medicalsemseg_tpu.models import unetr as jun
from medicalsemseg_tpu.models import vit as jvit

from medicalsemseg_tpu_torch.models import unetr as pun
from medicalsemseg_tpu_torch.models import vit as pvit
from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

from tests.test_torch_focalnet import sub_state_dict
from tests.test_torch_model import (
    jax_params,
    model_inputs,
    port_model,
    seeded_tree,
    small_cfg,
)

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


def _init(module, seed, *args):
    shapes = jax.eval_shape(lambda r, *a: module.init(r, *a),
                            jax.random.PRNGKey(0), *args)
    return seeded_tree(shapes, seed)["params"]


def _block_tree(p):
    """A block's leaves at the first block of a ViT, in the key map's UNETR
    layout (the rest of the tree empty)."""
    return {"vit": {"patch_embed": {"Conv_0": {}}, "blocks_0": p,
                    "norm": {"LayerNorm_0": {}}}}


def test_self_attention_matches_jax():
    x = _rand(1, 2, 27, 32)
    p = _init(jvit.TransformerBlock(32, 4), 1, jnp.asarray(x))
    want = jax.jit(jvit.SelfAttention(32, 4).apply)({"params": p["attn"]},
                                                    jnp.asarray(x))
    port = pvit.SelfAttention(32, 4)
    port.load_state_dict(sub_state_dict(_block_tree(p), "vit.blocks.0.attn."),
                         strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    _close(got.numpy(), want)


@pytest.mark.parametrize("init_values", [None, 0.5],
                         ids=["residual", "init_values"])
def test_block_matches_jax(init_values):
    """In eval mode the MLP is K2 with LN2 absorbed: residual=True, or with
    ``init_values`` residual=False and x + gamma_2 * mlp outside."""
    x = _rand(2, 2, 27, 32)
    jm = jvit.TransformerBlock(32, 4, init_values=init_values)
    p = _init(jm, 2, jnp.asarray(x))
    want = jax.jit(jm.apply)({"params": p}, jnp.asarray(x))
    port = pvit.TransformerBlock(32, 4, init_values=init_values)
    port.load_state_dict(sub_state_dict(_block_tree(p), "vit.blocks.0."),
                         strict=True)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x))
    _close(got.numpy(), want)


def test_block_matches_the_jax_pallas_mlp(monkeypatch):
    import medicalsemseg_tpu.ops.pallas.mlp as pmlp

    monkeypatch.setattr(pmlp, "_FORCE_INTERPRET", True)
    x = _rand(3, 2, 27, 32)
    p = _init(jvit.TransformerBlock(32, 4), 3, jnp.asarray(x))
    want = jvit.TransformerBlock(32, 4, use_pallas=True).apply(
        {"params": p}, jnp.asarray(x))
    port = pvit.TransformerBlock(32, 4)
    port.load_state_dict(sub_state_dict(_block_tree(p), "vit.blocks.0."),
                         strict=True)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x))
    _close(got.numpy(), want)


@pytest.mark.parametrize("cls,init_values", [(False, None), (True, None),
                                             (True, 0.1)],
                         ids=["plain", "cls_token", "cls_init_values"])
def test_vit_taps_match_jax(cls, init_values):
    """Four taps at blocks 1..4; the last one is the final LayerNorm's; the
    class token is dropped from every tap."""
    vol = _rand(4, 2, 16, 16, 24, 1)
    kw = dict(patch_size=(8, 8, 8), hidden_size=32, depth=4, num_heads=4,
              out_indices=(1, 2, 3, 4), use_cls_token=cls,
              init_values=init_values)
    jm = jvit.ViT3D(**kw)
    p = _init(jm, 4, jnp.asarray(vol))
    want = jax.jit(jm.apply)({"params": p}, jnp.asarray(vol))
    port = pvit.ViT3D((16, 16, 24), **kw)
    port.load_state_dict({k[len("vit."):]: v for k, v in
                          state_dict_from_jax({"vit": p}).items()},
                         strict=True)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(vol))
    assert len(got) == 4 and got[0].shape == (2, 2, 2, 3, 32)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_pr_up_block_matches_jax():
    x = _rand(5, 2, 2, 2, 2, 32)
    jm = jun.UnetrPrUpBlock(8, num_layer=2)
    p = _init(jm, 5, jnp.asarray(x))
    want = jax.jit(jm.apply)({"params": p}, jnp.asarray(x))
    port = pun.UnetrPrUpBlock(32, 8, 2)
    # the block at encoder2 of a UNETR tree whose other leaves are empty
    empty_up = {"transp_conv_init": {"ConvTranspose_0": {}}}
    tree = {"vit": {"patch_embed": {"Conv_0": {}},
                    "norm": {"LayerNorm_0": {}}},
            "encoder1": {}, "encoder2": p,
            "encoder3": empty_up, "encoder4": empty_up,
            **{f"decoder{k}": {"transp_conv": {"ConvTranspose_0": {}},
                               "conv_block": {}} for k in (2, 3, 4, 5)},
            "out": {"conv": {"Conv_0": {}}}}
    port.load_state_dict(sub_state_dict(tree, "encoder2."), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 16, 16, 16, 8)
    _close(got.numpy(), want)


def test_small_unetr_matches_jax():
    """The UNETR module at a small ViT (width 32, 4 blocks of 4 heads)."""
    vol = _rand(6, 1, 32, 32, 32, 1)
    kw = dict(feature_size=8, hidden_size=32, depth=4, num_heads=4)
    jm = jun.UNETR(3, **kw)
    x_in = (jnp.asarray(vol), jnp.zeros((1, 3)), jnp.ones((1, 3)))
    p = _init(jm, 6, x_in)
    want = jax.jit(jm.apply)({"params": p}, x_in)
    port = pun.UNETR((32, 32, 32), 3, **kw, dtype=torch.float32)
    port.load_state_dict(state_dict_from_jax(p), strict=True)
    with torch.inference_mode():
        got = port.eval()((torch.from_numpy(vol), None, None))
    _close(got.numpy(), want)


def test_unetr_official_matches_jax():
    """The factory's model: ViT-B (768 wide, 12 blocks of 12 heads, patch
    16) whatever the flags, feature size max(hidden // 3, 8) = 8."""
    cfg = small_cfg(model="UNETR_Official")
    jmodel, params = jax_params(cfg, seed=40)
    x_in = model_inputs(cfg, batch=1, seed=40)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                              deterministic=True))(
        params, tuple(jnp.asarray(a) for a in x_in))
    port = port_model(cfg, params)
    assert len(port.vit.blocks) == 12 and port.vit.pos_embed.shape == (
        1, 8, 768)
    with torch.inference_mode():
        got = port(tuple(torch.from_numpy(a) for a in x_in))
    assert got.shape == (1, 32, 32, 32, 3) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_vit_position_table_is_tied_to_the_volume():
    port = pvit.ViT3D((32, 32, 32), (16, 16, 16), hidden_size=32, depth=1,
                      num_heads=4, out_indices=(1,))
    with pytest.raises(ValueError, match="pos_embed is tied"):
        port(torch.zeros(1, 48, 32, 32, 1))
