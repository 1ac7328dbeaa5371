"""The port's full nnFormerUNETR against the JAX model on the CPU.

A small flagship (vol 32, patch 2, hidden 12, depths 2-2-2-2, heads
2-2-2-2, 3 classes) gets a JAX parameter tree filled from a seeded numpy
generator; the same tree is loaded into the port through
``utils.params.state_dict_from_jax``. Both run in fp32.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalsemseg_tpu.config import Config
from medicalsemseg_tpu.models import build_model as jax_build_model

from medicalsemseg_tpu_torch.models.factory import build_model
from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# fp32 on both sides through ~40 layers; sums run in other orders (XLA vs
# oneDNN convs and torch matmuls) and InstanceNorm rescales small absolute
# differences, so logits of O(1) agree to ~1e-5; 1e-4 leaves headroom
RTOL = ATOL = 1e-4


def small_cfg(**kw) -> Config:
    base = dict(model="nnFormerUNETR", vol_size=32, patch_size=2,
                hidden_dim=12, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2),
                window_size=2, output_dim=3, compute_dtype="float32",
                qkv_bias=True)
    base.update(kw)
    return Config(**base)


def jax_params(cfg: Config, seed: int = 0):
    """The JAX flagship for cfg and a parameter tree of its structure (from
    ``jax.eval_shape`` of the init, so nothing is compiled) filled from a
    seeded numpy generator: norm scales ~1, biases ~0.1, kernels with
    variance 1 / fan_in, bias tables ~0.5, so every layer contributes."""
    model = jax_build_model(cfg)
    v = cfg.vol_size3()
    x_in = (jnp.zeros((1, *v, cfg.in_chans)), jnp.zeros((1, 3)),
            jnp.ones((1, 3)))
    shapes = jax.eval_shape(
        lambda r, x: model.init(r, x, deterministic=True),
        jax.random.PRNGKey(0), x_in)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        z = rng.normal(size=leaf.shape)
        if name == "scale":
            z = 1.0 + 0.1 * z
        elif "bias" in name and name != "relative_position_bias_table":
            z = 0.1 * z
        elif name == "relative_position_bias_table":
            z = 0.5 * z
        else:
            z = z / np.sqrt(np.prod(leaf.shape[:-1]))
        return z.astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def port_model(cfg: Config, params) -> torch.nn.Module:
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


def model_inputs(cfg: Config, batch: int = 1, seed: int = 1):
    rng = np.random.default_rng(seed)
    v = cfg.vol_size3()
    return (rng.normal(size=(batch, *v, cfg.in_chans)).astype(np.float32),
            rng.uniform(size=(batch, 3)).astype(np.float32),
            np.ones((batch, 3), np.float32))


@pytest.mark.parametrize("window", [2, 3])
def test_logits_match_jax(window):
    """window 2: every block absorbed, shifted blocks, stage-4 clamp;
    window 3: grids 16/8/4 pad to multiples of 3 (the padded form)."""
    cfg = small_cfg(window_size=window)
    jmodel, params = jax_params(cfg, seed=window)
    x_in = model_inputs(cfg, batch=1, seed=window)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                              deterministic=True))(
        params, tuple(jnp.asarray(a) for a in x_in))
    with torch.inference_mode():
        got = port_model(cfg, params)(tuple(torch.from_numpy(a) for a in x_in))
    assert got.shape == (1, 32, 32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_encoder_matches_pallas_absorbed_forms(monkeypatch):
    """The JAX encoder with use_pallas=True in interpret mode takes the
    absorbed LN+residual attention kernel and the fused MLP in every block;
    the port's encoder agrees with it."""
    import medicalsemseg_tpu.ops.pallas.window_attention as pwa
    from medicalsemseg_tpu.models.swin import SwinEncoder3D as JaxEncoder

    from tests.test_pallas_attention import _patch_interpret

    _patch_interpret(monkeypatch, pwa)
    cfg = small_cfg()
    _, params = jax_params(cfg, seed=5)
    enc = JaxEncoder(patch_size=(2, 2, 2), embed_dim=12, depths=(2, 2, 2, 2),
                     num_heads=(2, 2, 2, 2), window_sizes=(2, 2, 2, 2),
                     qkv_bias=True, use_pallas=True)
    vol = model_inputs(cfg, seed=5)[0]
    want = jax.jit(lambda p, v: enc.apply({"params": p}, (v, None, None),
                                          deterministic=True))(
        params["encoder"], jnp.asarray(vol))
    with torch.inference_mode():
        got = port_model(cfg, params).encoder(torch.from_numpy(vol))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(small_cfg(model="SwinDepth"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(small_cfg(global_token=True))
