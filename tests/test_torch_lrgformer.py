"""The port's LRGFormer (LRGFormerUNETR) against the JAX package on the CPU,
in fp32, to 1e-4 of the output's largest value.

Seeded numpy parameters (``tests/test_torch_model`` helpers) carried into
the port by ``utils.params``: the chunked attention (one chunk, and several
with the last one short, where the JAX function pads), the global and
region embeddings, the joint attention and the block, and the whole model
at vol 64 (stage 1: 4,096 local, 64 region and 1 global token, so the
queries take the chunked path with a short last chunk). Where the JAX
module fails (its grid bookkeeping at ``--vol_size`` 96 and 160, depths
2-2-2-2, traced by ``jax.eval_shape``) the port raises a ``ValueError``
when it is built; where it runs (64, 128) the port builds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medicalsemseg_tpu.config import Config as JaxConfig
from medicalsemseg_tpu.models import build_model as jax_build_model
from medicalsemseg_tpu.models import embeddings as jemb
from medicalsemseg_tpu.models import lrgformer as jlrg

from medicalsemseg_tpu_torch.config import Config
from medicalsemseg_tpu_torch.models import embeddings as pemb
from medicalsemseg_tpu_torch.models import lrgformer as plrg
from medicalsemseg_tpu_torch.models.factory import build_model

from tests.test_torch_model import (
    jax_params,
    model_inputs,
    port_model,
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


def _cfg(**kw):
    base = dict(model="LRGFormerUNETR", vol_size=64, drop_path_rate=0.0)
    base.update(kw)
    return small_cfg(**base)


@pytest.fixture(scope="module")
def vol64():
    cfg = _cfg()
    jmodel, params = jax_params(cfg, seed=50)
    return cfg, jmodel, params, port_model(cfg, params)


@pytest.mark.parametrize("n,chunk", [(40, 64), (150, 64), (128, 64)],
                         ids=["one_chunk", "short_last_chunk", "exact"])
def test_chunked_attention_matches_jax(n, chunk):
    q, k, v = (_rand(s, 2, 3, n, 8) for s in (1, 2, 3))
    want = jlrg._chunked_softmax_attention(*map(jnp.asarray, (q, k, v)),
                                           chunk=chunk)
    got = plrg.chunked_softmax_attention(*map(torch.from_numpy, (q, k, v)),
                                         chunk=chunk)
    _close(got.numpy(), want)


@pytest.mark.parametrize("which", ["global", "region"])
def test_patch_embeddings_match_jax(which, vol64):
    """Kernel = stride VALID convs as one dense layer per block."""
    cfg, _, params, port = vol64
    vol = model_inputs(cfg, batch=2, seed=51)[0]
    p = params["encoder"][f"patch_embed_{which}"]
    jm = (jemb.PatchEmbedGlobal((64, 64, 64), 12) if which == "global"
          else jemb.PatchEmbedRegion((16, 16, 16), 12))
    want = jax.jit(jm.apply)({"params": p}, jnp.asarray(vol))
    with torch.inference_mode():
        got = getattr(port.encoder, f"patch_embed_{which}")(
            torch.from_numpy(vol))
    assert got.shape == ((2, 1, 1, 1, 12) if which == "global"
                         else (2, 4, 4, 4, 12))
    _close(got.numpy(), want)


def test_patch_linear_drops_what_valid_drops():
    conv = pemb.Conv3d(2, 3, (2, 3, 2), stride=(2, 3, 2), padding=0)
    torch.nn.init.normal_(conv.weight)
    x = torch.randn(1, 5, 7, 4, 2)
    want = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3), conv.weight,
                                      conv.bias, stride=(2, 3, 2))
    got = pemb.patch_linear(x, conv)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 4, 1))


def test_block_matches_jax(vol64):
    """The joint attention over [local | region | global] and the MLP, at
    stage 2's token counts (512 + 8 + 1)."""
    _, _, params, port = vol64
    p = params["encoder"]["layers_1_blocks_1"]
    x = _rand(52, 2, 521, 24)
    want = jlrg.LRGBlock(dim=24, num_heads=2, n_local=512, n_region=8).apply(
        {"params": p}, jnp.asarray(x))
    with torch.inference_mode():
        got = port.encoder.layers[1].blocks[1](torch.from_numpy(x), 512, 8)
    _close(got.numpy(), want)


def test_encoder_pyramid_and_logits_match_jax(vol64):
    cfg, jmodel, params, port = vol64
    x_in = model_inputs(cfg, batch=1, seed=53)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                              deterministic=True))(
        params, tuple(jnp.asarray(a) for a in x_in))
    pyramid = []
    hook = port.encoder.register_forward_hook(
        lambda m, a, out: pyramid.extend(out))
    with torch.inference_mode():
        got = port(tuple(torch.from_numpy(a) for a in x_in))
    hook.remove()
    assert [tuple(t.shape[1:4]) for t in pyramid] == [
        (16,) * 3, (8,) * 3, (4,) * 3, (2,) * 3, (1,) * 3]
    assert got.shape == (1, 64, 64, 64, 3) and got.dtype == torch.float32
    _close(got.numpy(), want)
    enc = jlrg.LRGFormer3D(patch_size=(4, 4, 4), embed_dim=12,
                           num_heads=(2, 2, 2, 2), drop_path_rate=0.0)
    want_pyr = jax.jit(lambda p, v: enc.apply({"params": p},
                                              (v, None, None)))(
        params["encoder"], jnp.asarray(x_in[0]))
    for g, w in zip(pyramid, want_pyr):
        _close(g.numpy(), w)


def _jax_runs(vol):
    """Whether the JAX model at the default widths traces at ``vol``."""
    cfg = JaxConfig(model="LRGFormerUNETR", vol_size=vol)
    model = jax_build_model(cfg)
    x = (jax.ShapeDtypeStruct((1, vol, vol, vol, 1), jnp.float32),
         jax.ShapeDtypeStruct((1, 3), jnp.float32),
         jax.ShapeDtypeStruct((1, 3), jnp.float32))
    try:
        jax.eval_shape(lambda r, x: model.init(r, x, deterministic=True),
                       jax.random.PRNGKey(0), x)
    except TypeError as e:
        assert "reshape" in str(e)
        return False
    return True


@pytest.mark.parametrize("vol,runs", [(64, True), (96, False), (128, True),
                                      (160, False)])
def test_port_raises_where_jax_fails(vol, runs):
    """At the default widths (depths 2-2-2-2): the region grid of 96 is 6,
    merged to 3 for stage 2 and to 2 for stage 3 where the JAX bookkeeping
    keeps 1; 160's is 10 -> 5 -> 3 against 2."""
    assert _jax_runs(vol) is runs
    cfg = Config(model="LRGFormerUNETR", vol_size=vol)
    if runs:
        model = build_model(cfg)
        assert model.encoder.img_size == (vol,) * 3
    else:
        with pytest.raises(ValueError, match="grid bookkeeping"):
            build_model(cfg)


def test_port_raises_for_a_volume_off_the_region_grid():
    with pytest.raises(ValueError, match="multiple of patch"):
        plrg.lrg_stage_grids((72, 64, 64), (4, 4, 4), 4, 4)
    port = plrg.LRGFormer3D((64, 64, 64), embed_dim=12,
                            num_heads=(2, 2, 2, 2))
    with pytest.raises(ValueError, match="built for the volume"):
        port(torch.zeros(1, 64, 64, 32, 1))
