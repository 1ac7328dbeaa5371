"""MONAI's SwinUNETR and Video-Swin's backbone in the port against the JAX
models on the CPU.

Small models (vol 32, hidden 12, depths 2-2-1-1, heads 2-2-2-2, 3 classes,
fp32; SwinUNETR_Official at its fixed 7^3 window, so stages 1-2 pad their
grids 16 and 8 to 21 and 14 and stages 3-4 clamp; VideoSwinUNETR at window 2
and 3) get JAX parameter trees filled from a seeded numpy generator, carried
into the port by ``utils.params``. The patch mergings (MONAI v1's
duplicated-octant quirk, Video-Swin's octant order), the encoders (every
hidden state) and the whole models agree with the JAX ones to 1e-4 of the
output's largest value: SwinUNETR_Official with ``MEDSEG_OFFICIAL_FUSED``
off (the plain attention and MLP in both packages) and on (the port's K1
and K2, their plain versions here, against the JAX XLA path),
VideoSwinUNETR with and without ``--abs_pos_emb``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medicalsemseg_tpu.models import swin_official as jso
from medicalsemseg_tpu.models import video_swin as jvs

from medicalsemseg_tpu_torch.models import swin_official, video_swin

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
    base = dict(depths=(2, 2, 1, 1), drop_path_rate=0.0)
    base.update(kw)
    return small_cfg(**base)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def official():
    cfg = _cfg(model="SwinUNETR_Official")
    jmodel, params = jax_params(cfg, seed=51)
    return cfg, jmodel, params


@pytest.fixture(scope="module")
def video():
    cfg = _cfg(model="VideoSwinUNETR", abs_pos_emb=True)
    jmodel, params = jax_params(cfg, seed=52)
    return cfg, jmodel, params


@pytest.mark.parametrize("dims", [(4, 4, 4), (5, 4, 3)], ids=["even", "odd"])
def test_official_patch_merging_matches_jax(official, dims):
    cfg, _, params = official
    x = _rand(1, 2, *dims, 12)
    want = jso.OfficialPatchMerging(12).apply(
        {"params": params["swinViT"]["layers1_downsample"]}, jnp.asarray(x))
    port = port_model(cfg, params).swinViT.layers1[0].downsample
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    _close(got.numpy(), want)


def test_official_patch_merging_keeps_the_duplicated_octants():
    """MONAI v1 reads octants (1, 0, 0), (0, 1, 0), (0, 0, 1) and (1, 0, 1)
    ... with (0, 1, 0) and (0, 0, 1) twice, and never (1, 1, 0) or
    (0, 1, 1): changing those voxels changes nothing."""
    merge = swin_official.OfficialPatchMerging(4)
    x = torch.randn(1, 4, 4, 4, 4)
    y = x.clone()
    y[:, 1::2, 1::2, 0::2] += 1.0
    y[:, 0::2, 1::2, 1::2] -= 1.0
    with torch.inference_mode():
        torch.testing.assert_close(merge(x), merge(y))
        y[:, 1::2, 0::2, 1::2] += 1.0       # (1, 0, 1) is read
        assert not torch.allclose(merge(x), merge(y))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_swin_vit_official_matches_jax(official, monkeypatch, fused):
    cfg, _, params = official
    monkeypatch.setenv("MEDSEG_OFFICIAL_FUSED", "1" if fused else "0")
    vol = _rand(2, 2, 32, 32, 32, 1)
    want = jso.SwinViTOfficial(embed_dim=12, depths=(2, 2, 1, 1),
                               num_heads=(2, 2, 2, 2)).apply(
        {"params": params["swinViT"]}, jnp.asarray(vol))
    port = port_model(cfg, params)
    assert all(blk.fused is fused for blk in port.modules()
               if isinstance(blk, swin_official.OfficialSwinBlock))
    with torch.inference_mode():
        got = port.swinViT(torch.from_numpy(vol))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_swin_unetr_official_logits_match_jax(official, monkeypatch, fused):
    cfg, jmodel, params = official
    monkeypatch.setenv("MEDSEG_OFFICIAL_FUSED", "1" if fused else "0")
    x_in = model_inputs(cfg, batch=1, seed=53)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                              deterministic=True))(
        params, tuple(jnp.asarray(a) for a in x_in))
    with torch.inference_mode():
        got = port_model(cfg, params)(tuple(torch.from_numpy(a)
                                            for a in x_in))
    assert got.shape == (1, 32, 32, 32, 3) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_video_patch_merging_matches_jax(video):
    cfg, _, params = video
    x = _rand(3, 2, 4, 4, 4, 12)
    want = jvs.VideoPatchMerging(12).apply(
        {"params": params["encoder"]["layers_0_downsample"]}, jnp.asarray(x))
    port = port_model(cfg, params).encoder.layers[0].downsample
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
        with pytest.raises(ValueError, match="even dims"):
            port(torch.zeros(1, 3, 4, 4, 12))
    _close(got.numpy(), want)


def test_video_swin_encoder_with_ape_matches_jax(video):
    cfg, _, params = video
    vol = _rand(4, 2, 32, 32, 32, 1)
    want = jvs.VideoSwin3D(embed_dim=12, depths=(2, 2, 1, 1),
                           num_heads=(2, 2, 2, 2), window=(2, 2, 2),
                           ape=True).apply({"params": params["encoder"]},
                                           jnp.asarray(vol))
    port = port_model(cfg, params).encoder
    assert isinstance(port, video_swin.VideoSwin3D)
    with torch.inference_mode():
        got = port(torch.from_numpy(vol))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("window,ape", [(2, True), (3, False)],
                         ids=["w2_ape", "w3_padded"])
def test_video_swin_unetr_logits_match_jax(window, ape):
    cfg = _cfg(model="VideoSwinUNETR", window_size=window, abs_pos_emb=ape)
    jmodel, params = jax_params(cfg, seed=54 + window)
    x_in = model_inputs(cfg, batch=1, seed=55)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                              deterministic=True))(
        params, tuple(jnp.asarray(a) for a in x_in))
    with torch.inference_mode():
        got = port_model(cfg, params)(tuple(torch.from_numpy(a)
                                            for a in x_in))
    assert got.shape == (1, 32, 32, 32, 3)
    _close(got.numpy(), want)
