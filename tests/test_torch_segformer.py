"""The port's SegFormer3D and SwinSegFormer against the JAX models on the CPU.

Small models (vol 32, hidden 12, heads 2-2-2-2, 3 classes) get JAX variables
filled from a seeded numpy generator, the BatchNorm running statistics of the
heads' fuse blocks included (means ~0.3, variances in 0.5-1.5, so a port that
left them at 0 / 1 would not pass); the same variables are loaded into the
port through ``state_dict_from_jax``. Both run in fp32, the JAX models on
their XLA path, and the SegFormer encoder once more with the Pallas kernel in
interpret mode.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalsemseg_tpu_torch.models.factory import build_model
from medicalsemseg_tpu_torch.models.layers import BatchNorm, Conv3d
from medicalsemseg_tpu_torch.utils.params import (
    jax_tree_from_state_dict,
    key_map,
    state_dict_from_jax,
)

from tests.test_torch_model import (
    ATOL,
    RTOL,
    jax_variables,
    model_inputs,
    small_cfg,
)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CFGS = {
    # sr 8-4-2-1 on grids 8-4-2-1: M = 1 reduced token at every stage
    "SegFormer3D": dict(model="SegFormer3D"),
    # grids 16-8-4-2 under the 5-scale head; shifted and clamped windows
    "SwinSegFormer": dict(model="SwinSegFormer", depths=(2, 2, 1, 1)),
}


def _port(cfg, variables):
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("name", sorted(CFGS))
def test_logits_match_jax(name):
    cfg = small_cfg(**CFGS[name])
    jmodel, variables = jax_variables(cfg, seed=21)
    assert "batch_stats" in variables
    x_in = model_inputs(cfg, batch=2, seed=21)
    want = np.asarray(jax.jit(
        lambda v, x: jmodel.apply(v, x, deterministic=True))(
            variables, tuple(jnp.asarray(a) for a in x_in)))
    model = _port(cfg, variables)
    with torch.inference_mode():
        got = model(tuple(torch.from_numpy(a) for a in x_in))
    assert got.shape == (2, 32, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    # the running statistics are read: other statistics, other logits
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    with torch.inference_mode():
        other = model(tuple(torch.from_numpy(a) for a in x_in))
    assert float((other - got).abs().max()) > 1e-3


def test_segformer_larger_reduced_set():
    """vol 64: stage grids 16-8-4-2, so M = 8 reduced tokens at every stage
    (the softmax over the keys is no longer trivial), depths 1."""
    cfg = small_cfg(model="SegFormer3D", vol_size=64, hidden_dim=8,
                    depths=(1, 1, 1, 1))
    jmodel, variables = jax_variables(cfg, seed=22)
    x_in = model_inputs(cfg, batch=1, seed=22)
    want = np.asarray(jax.jit(
        lambda v, x: jmodel.apply(v, x, deterministic=True))(
            variables, tuple(jnp.asarray(a) for a in x_in)))
    with torch.inference_mode():
        got = _port(cfg, variables)(tuple(torch.from_numpy(a) for a in x_in))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_encoder_matches_pallas_interpret(monkeypatch):
    """The JAX MixViT with use_pallas=True and the SR-attention kernel in
    interpret mode (shortcut added inside the kernel); the port's pyramid
    agrees with it."""
    import medicalsemseg_tpu.ops.pallas.sr_attention as psr
    from medicalsemseg_tpu.models.segformer import MixVisionTransformer3D

    monkeypatch.setattr(psr, "_FORCE_INTERPRET", True)
    cfg = small_cfg(model="SegFormer3D", vol_size=64, hidden_dim=8,
                    depths=(1, 1, 1, 1))
    _, variables = jax_variables(cfg, seed=23)
    enc = MixVisionTransformer3D(embed_dim=8, depths=(1, 1, 1, 1),
                                 num_heads=(2, 2, 2, 2), qkv_bias=True,
                                 use_pallas=True)
    vol = model_inputs(cfg, batch=1, seed=23)[0]
    want = jax.jit(lambda p, v: enc.apply({"params": p}, (v, None, None),
                                          deterministic=True))(
        variables["params"]["encoder"], jnp.asarray(vol))
    with torch.inference_mode():
        got = _port(cfg, variables).encoder(torch.from_numpy(vol))
    assert [tuple(g.shape[1:]) for g in got] == [
        (16, 16, 16, 8), (16, 16, 16, 8), (8, 8, 8, 16), (4, 4, 4, 32),
        (2, 2, 2, 64)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_state_dict_round_trip_with_batch_stats(name):
    cfg = small_cfg(**CFGS[name])
    _, variables = jax_variables(cfg, seed=24)
    sd = state_dict_from_jax(variables)
    model = build_model(cfg)
    assert set(sd) == set(model.state_dict())
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * (1 if name == "SegFormer3D" else 4)
    # the parameter tree alone maps the parameters and no statistic
    assert {k for _, k, _ in key_map(variables["params"])} == set(sd) - set(stats)

    back = jax_tree_from_state_dict(sd, variables)
    assert set(back) == {"params", "batch_stats"}
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_grouped_and_strided_conv_match_flax():
    """Conv3d against flax's nn.Conv: depthwise 3^3 (kernel (3, 3, 3, 1, C)),
    7^3 stride 4 pad 3, 3^3 stride 2 pad 1 (which is not flax's SAME), and a
    VALID kernel == stride conv."""
    from flax import linen as nn

    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 9, 10, 12, 4)).astype(np.float32)
    for k, stride, pad, groups in ((3, 1, 1, 4), (7, 4, 3, 1), (3, 2, 1, 1),
                                   (2, 2, 0, 1)):
        jconv = nn.Conv(8 if groups == 1 else 4, (k,) * 3,
                        strides=(stride,) * 3, padding=((pad, pad),) * 3,
                        feature_group_count=groups)
        w = rng.normal(size=(k, k, k, 4 // groups, jconv.features)).astype(
            np.float32)
        b = rng.normal(size=(jconv.features,)).astype(np.float32)
        want = jconv.apply({"params": {"kernel": w, "bias": b}}, jnp.asarray(x))
        conv = Conv3d(4, jconv.features, k, stride=stride, padding=pad,
                      groups=groups)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(w.transpose(4, 3, 0, 1, 2)))
            conv.bias.copy_(torch.from_numpy(b))
            got = conv(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_eval_with_gradients_raises():
    """In eval mode the attention runs K7, which has no backward: with
    gradients enabled the model refuses (training runs the unfused form,
    held against the JAX package in ``tests/test_torch_train_segformer.py``);
    without them it runs."""
    cfg = small_cfg(model="SegFormer3D")
    model = build_model(cfg).eval()
    x_in = tuple(torch.from_numpy(a) for a in model_inputs(cfg))
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        model(x_in)                      # gradients enabled
    with torch.no_grad():
        assert model(x_in).shape[:4] == x_in[0].shape[:4]
