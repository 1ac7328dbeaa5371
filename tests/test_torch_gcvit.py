"""The port's GC-ViT encoder and GCViTUNETR against the JAX model on the CPU.

A small model (vol 32, hidden 12, depths 2-2-2-2, heads 2-2-2-2, window 2, 3
classes) gets a JAX parameter tree filled from a seeded numpy generator; the
same tree is loaded into the port through ``state_dict_from_jax``. Both run
in fp32: the JAX model on its XLA path (its factory turns Pallas off on the
CPU), and once with the Pallas kernels in interpret mode.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalsemseg_tpu_torch.models.factory import build_model
from medicalsemseg_tpu_torch.models.gcvit import GCViT3D, _pool_plan
from medicalsemseg_tpu_torch.ops.resize import linear_weights, resize_linear
from medicalsemseg_tpu_torch.ops.window import (
    relative_position_index_ref_quirk,
)
from medicalsemseg_tpu_torch.utils.params import (
    jax_tree_from_state_dict,
    state_dict_from_jax,
)

from tests.test_torch_model import (
    ATOL,
    RTOL,
    jax_params,
    model_inputs,
    port_model,
    small_cfg,
)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _jax_logits(jmodel, params, x_in):
    return np.asarray(jax.jit(
        lambda p, x: jmodel.apply({"params": p}, x, deterministic=True))(
            params, tuple(jnp.asarray(a) for a in x_in)))


@pytest.mark.parametrize("quirk", [False, True],
                         ids=["standard_index", "ref_quirk_rel_pos"])
def test_logits_match_jax(quirk):
    """Local (K1's plain version) and global (K6's) blocks, the FeatExtract
    pyramid (3, 2, 1 pooling steps and the keep_dim one at the last level),
    batch 2 with its own queries per element."""
    cfg = small_cfg(model="GCViTUNETR", ref_quirk_rel_pos=quirk)
    jmodel, params = jax_params(cfg, seed=11)
    x_in = model_inputs(cfg, batch=2, seed=11)
    want = _jax_logits(jmodel, params, x_in)
    model = port_model(cfg, params)
    assert [len(lv.to_q_global) for lv in model.encoder.levels] == [3, 2, 1, 1]
    assert model.encoder.levels[3].to_q_global[0].keep_dim
    with torch.inference_mode():
        got = model(tuple(torch.from_numpy(a) for a in x_in))
    assert got.shape == (2, 32, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if quirk:   # the index matters: the standard one gives other logits
        std = port_model(small_cfg(model="GCViTUNETR"), params)
        with torch.inference_mode():
            other = std(tuple(torch.from_numpy(a) for a in x_in))
        assert float((other - got).abs().max()) > 1e-3


def test_encoder_matches_pallas_interpret(monkeypatch):
    """The JAX encoder with use_pallas=True in interpret mode takes the fused
    local kernel, the fused global-query kernel and the fused MLP, LN and
    shortcut absorbed; the port's pyramid agrees with it."""
    import medicalsemseg_tpu.ops.pallas.window_attention as pwa
    from medicalsemseg_tpu.models.gcvit import GCViT3D as JaxGCViT

    from tests.test_pallas_attention import _patch_interpret

    _patch_interpret(monkeypatch, pwa)
    cfg = small_cfg(model="GCViTUNETR")
    _, params = jax_params(cfg, seed=12)
    enc = JaxGCViT(dim=12, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2),
                   window_sizes=(2, 2, 2, 2), mlp_ratio=3.0, qkv_bias=True,
                   use_pallas=True)
    vol = model_inputs(cfg, batch=2, seed=12)[0]
    want = jax.jit(lambda p, v: enc.apply({"params": p}, (v, None, None),
                                          deterministic=True))(
        params["encoder"], jnp.asarray(vol))
    with torch.inference_mode():
        got = port_model(cfg, params).encoder(torch.from_numpy(vol))
    assert [tuple(g.shape[1:]) for g in got] == [
        (16, 16, 16, 12), (8, 8, 8, 24), (4, 4, 4, 48), (2, 2, 2, 96),
        (1, 1, 1, 192)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_anisotropic_input_reaches_the_antialiased_resize():
    """A 32 x 16 x 24 input: axis ratios 2 and 1.5, so the query pyramid
    pools per axis and then shrinks 3 -> 2 with the widened triangle."""
    cfg = small_cfg(model="GCViTUNETR", vol_size=(32, 16, 24), depths=(2, 2),
                    num_heads=(2, 2))
    assert _pool_plan((16, 8, 12), 2) == [(2, 2, 2), (2, 2, 2), (2, 1, 1)]
    jmodel, params = jax_params(cfg, seed=13)
    x_in = model_inputs(cfg, batch=1, seed=13)
    want = _jax_logits(jmodel, params, x_in)
    with torch.inference_mode():
        got = port_model(cfg, params)(tuple(torch.from_numpy(a) for a in x_in))
    assert got.shape == (1, 32, 16, 24, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("src,dst", [((3, 5, 7), (2, 2, 2)),
                                     ((2, 3, 4), (4, 9, 5)),
                                     ((6, 6, 6), (6, 4, 12))])
def test_resize_linear_matches_jax_image_resize(src, dst):
    """Shrinking (antialiased), growing and mixed, against
    ``jax.image.resize(method="linear")``; fp32 sums of at most 7 terms."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, *src, 5)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *dst, 5), "linear")
    got = resize_linear(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    for n_in, n_out in zip(src, dst):
        np.testing.assert_allclose(linear_weights(n_in, n_out).sum(1), 1.0,
                                   rtol=1e-6)


def test_upsampling_resize_is_torch_trilinear():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(1, 3, 4, 5, 2)).astype(np.float32))
    want = torch.nn.functional.interpolate(
        x.permute(0, 4, 1, 2, 3), size=(12, 8, 20), mode="trilinear",
        align_corners=False).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(resize_linear(x, (12, 8, 20)).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-6)


def test_ref_quirk_index_matches_jax():
    from medicalsemseg_tpu.ops.window import (
        relative_position_index_ref_quirk as jax_quirk,
    )

    for ws in ((2, 2, 2), (3, 3, 3), (6, 6, 6), (2, 3, 4)):
        np.testing.assert_array_equal(relative_position_index_ref_quirk(ws),
                                      jax_quirk(ws))


def test_state_dict_round_trip():
    cfg = small_cfg(model="GCViTUNETR")
    _, params = jax_params(cfg, seed=14)
    sd = state_dict_from_jax(params)
    model = build_model(cfg)
    assert set(sd) == set(model.state_dict())
    back = jax_tree_from_state_dict(sd, params)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_training_and_foreign_grids_raise():
    """In eval mode a global block runs K6, which has no backward: it
    refuses gradients (training, through the unfused form, is held against
    the JAX package in ``tests/test_torch_train_gcvit.py``). A stage built
    for one grid refuses another."""
    enc = GCViT3D((16, 16, 16), dim=8, depths=(2,), num_heads=(2,),
                  window_sizes=(2,))
    vol = torch.zeros(1, 16, 16, 16, 1)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        enc.eval()(vol)                      # gradients enabled
    with torch.no_grad():
        enc.eval()(vol)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="built for grid"):
            enc.eval()(torch.zeros(1, 12, 16, 16, 1))
