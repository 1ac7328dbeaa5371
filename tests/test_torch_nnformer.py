"""The port's official nnFormer against the JAX model on the CPU.

A small model (vol 32, patch 2, hidden 12, depths 2-2-1-1, heads 2-2-2-2,
window 2 or 3, 3 classes, fp32) gets a JAX parameter tree filled from a
seeded numpy generator, carried into the port by ``utils.params``. Each new
module alone (the conv stem, the cross-window attention with and without the
reference's colliding rel-pos index, the cross block, the patch expanding)
and the whole model (deterministic, with and without
``--ref_quirk_rel_pos``; the deep-supervision list in training mode) agree
with the JAX modules to 1e-4 of the output's largest value. The port's
encoder and decoder Swin blocks run K1 and K2, the cross blocks' MLPs K2
(their plain versions here); the JAX model on the CPU runs XLA.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from medicalsemseg_tpu.models import nnformer as jnn

from medicalsemseg_tpu_torch.models.factory import MODEL_NAMES, build_model

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
    base = dict(model="nnFormer", depths=(2, 2, 1, 1), drop_path_rate=0.0)
    base.update(kw)
    return small_cfg(**base)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


@pytest.fixture(scope="module")
def window3():
    """The window-3 model (grids 16, 8, 4, 2: stages 1-3 pad to the window,
    stage 4 clamps), its JAX parameters and the port."""
    cfg = _cfg(window_size=3)
    _, params = jax_params(cfg, seed=11)
    return cfg, params, port_model(cfg, params)


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_project_stem_matches_jax(window3):
    _, params, port = window3
    x = _rand(1, 2, 32, 32, 32, 1)
    want = jnn.ProjectStem(12, (2, 2, 2)).apply(
        {"params": params["patch_embed"]}, jnp.asarray(x))
    with torch.inference_mode():
        got = port.patch_embed(torch.from_numpy(x))
    _close(got.numpy(), want)


def test_project_stem_pads_the_strided_conv_as_same():
    """A 3^3 stride-2 conv with "SAME" padding pads one voxel at the end
    of an even axis and none at its start (odd axes both ends)."""
    from medicalsemseg_tpu_torch.models.nnformer import _same_pad

    y = _same_pad(torch.ones(1, 6, 5, 4, 1), (2, 2, 2))[0, ..., 0]
    assert y.shape == (7, 7, 5)
    assert y[0, 1, 0] == 1.0 and y[:6, 1:6, :4].all()    # the data
    assert not y[6].any() and not y[:, 0].any() and not y[:, 6].any()
    assert not y[:, :, 4].any()


@pytest.mark.parametrize("quirk", [False, True], ids=["standard", "quirk"])
def test_cross_window_attention_matches_jax(quirk):
    cfg = _cfg(window_size=3, ref_quirk_rel_pos=quirk)
    _, params = jax_params(cfg, seed=12)
    port = port_model(cfg, params)
    attn = port.decoder[0].cross.attn
    ws, c = attn.window_size, 48
    skip, up = _rand(2, 8, ws ** 3, c), _rand(3, 8, ws ** 3, c)
    want = jnn.CrossWindowAttention(
        dim=c, window_size=(ws,) * 3, num_heads=2,
        ref_quirk_index=quirk).apply(
            {"params": params["dec_0_cross"]["attn"]}, jnp.asarray(skip),
            jnp.asarray(up))
    with torch.inference_mode():
        got = attn(torch.from_numpy(skip), torch.from_numpy(up))
    _close(got.numpy(), want)
    if quirk:   # the colliding index really collides at this window
        assert len(set(attn.rel_index.tolist())) < attn.rel_index.numel()


@pytest.mark.parametrize("stage,dim,grid", [(0, 48, 4), (1, 24, 8)])
def test_cross_block_matches_jax(window3, stage, dim, grid):
    """Grids 4 and 8 under window 3: both pad to the window."""
    _, params, port = window3
    x, skip, up = (_rand(s, 2, grid, grid, grid, dim) for s in (4, 5, 6))
    want = jnn.CrossSwinBlock(dim=dim, num_heads=2, window_size=3).apply(
        {"params": params[f"dec_{stage}_cross"]}, jnp.asarray(x),
        jnp.asarray(skip), jnp.asarray(up), True)
    with torch.inference_mode():
        got = port.decoder[stage].cross(*(torch.from_numpy(a)
                                          for a in (x, skip, up)))
    _close(got.numpy(), want)


def test_patch_expanding_matches_jax(window3):
    _, params, port = window3
    x = _rand(7, 2, 2, 2, 2, 96)
    want = jnn.PatchExpanding(96).apply({"params": params["up_0"]},
                                        jnp.asarray(x), True)
    with torch.inference_mode():
        got = port.up[0](torch.from_numpy(x))
    assert got.shape == (2, 4, 4, 4, 48)
    _close(got.numpy(), want)


@pytest.mark.parametrize("window,quirk", [(2, False), (2, True), (3, False)],
                         ids=["w2", "w2_quirk", "w3_padded"])
def test_logits_match_jax(window, quirk):
    cfg = _cfg(window_size=window, ref_quirk_rel_pos=quirk)
    jmodel, params = jax_params(cfg, seed=13 + window)
    x_in = model_inputs(cfg, batch=1, seed=window)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                              deterministic=True))(
        params, tuple(jnp.asarray(a) for a in x_in))
    with torch.inference_mode():
        got = port_model(cfg, params)(tuple(torch.from_numpy(a)
                                            for a in x_in))
    assert got.shape == (1, 32, 32, 32, 3) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_deep_supervision_heads_in_training_match_jax():
    """In training with --deep_supervision both models return the heads at
    full resolution, 1/2 and 1/4; in eval mode the full-resolution head."""
    cfg = _cfg(deep_supervision=True)
    jmodel, params = jax_params(cfg, seed=21)
    x_in = model_inputs(cfg, batch=2, seed=21)
    want = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)}))(
            params, tuple(jnp.asarray(a) for a in x_in))
    port = port_model(cfg, params).train()
    got = port(tuple(torch.from_numpy(a) for a in x_in))
    assert isinstance(got, list) and len(got) == len(want) == 3
    assert [g.shape[1] for g in got] == [32, 16, 8]
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w)
    with torch.inference_mode():
        full = port.eval()(tuple(torch.from_numpy(a) for a in x_in))
    _close(full.numpy(), want[0])


def test_last_merging_is_not_computed(monkeypatch):
    """The deepest skip is the neck: the last stage's merging never runs,
    and its parameters get no gradient from the loss."""
    from medicalsemseg_tpu_torch.models import swin

    cfg = _cfg(vol_size=16, depths=(1, 1), num_heads=(2, 2))
    model = build_model(cfg)
    calls = []
    orig = swin.PatchMerging.forward
    monkeypatch.setattr(swin.PatchMerging, "forward",
                        lambda self, x: calls.append(self) or orig(self, x))
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    logits = model.train()((torch.randn(1, 16, 16, 16, 1), None, None))
    logits.sum().backward()
    assert calls == [model.layers[0].downsample]
    assert all(p.grad is None for p in model.layers[1].downsample.parameters())


@pytest.mark.parametrize("name", ["nnFormer", "VideoSwinUNETR",
                                  "SwinUNETR_Official", "FocalNetUNETR",
                                  "UNETR_Official", "LRGFormerUNETR",
                                  "Swin2D"])
def test_new_models_build(name):
    assert name in MODEL_NAMES
    cfg = _cfg(model=name, input_dim=2 if name == "Swin2D" else 3)
    assert sum(p.numel() for p in build_model(cfg).parameters())


def test_unknown_model_raises_naming_the_models():
    with pytest.raises(ValueError, match="Swin2D"):
        build_model(_cfg(model="UNet"))
