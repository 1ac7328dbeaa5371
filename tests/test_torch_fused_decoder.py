"""The fused decoder form (``MEDSEG_FUSED_DECODER``: ``conv2`` of a
``UnetResBlock`` as kernel K9 with ``norm1`` + LeakyReLU folded into its
input) against the unfused form and against the JAX package under the same
gate, on the CPU in fp32.

The port runs K9's plain version (the tests' hook ``winograd3d.ALLOW_CPU``),
the JAX package its Pallas kernel in interpret mode (``_FORCE_INTERPRET``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalsemseg_tpu.models import decoders as jax_decoders
from medicalsemseg_tpu.ops.pallas import winograd3d as jax_k9

from medicalsemseg_tpu_torch.models import decoders
from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

from tests.test_torch_model import (jax_params, model_inputs, port_model,
                                    small_cfg)

# fp32 on both sides; the Winograd sums run in another order than the direct
# conv's and the second InstanceNorm rescales the difference: the JAX
# package's own limit for fused against unfused
TOL = 2e-4


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("MEDSEG_FUSED_DECODER", "1")
    monkeypatch.setattr(k9, "ALLOW_CPU", True)
    monkeypatch.setattr(jax_k9, "_FORCE_INTERPRET", True)


def _count_k9(monkeypatch):
    calls = []
    plain = k9.winograd_conv3d_f23

    def counted(x, w, **kw):
        calls.append((tuple(x.shape), kw.get("lrelu")))
        return plain(x, w, **kw)

    monkeypatch.setattr(k9, "winograd_conv3d_f23", counted)
    return calls


def _block_params(in_ch, out_ch, x, seed):
    blk = jax_decoders.UnetResBlock(out_channels=out_ch)
    shapes = jax.eval_shape(lambda r, v: blk.init(r, v),
                            jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        z = rng.normal(size=leaf.shape)
        if name == "scale":
            z = 1.0 + 0.3 * z
        elif name == "bias":
            z = 0.3 * z
        else:
            z = z / np.sqrt(np.prod(leaf.shape[:-1]))
        return z.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    port = decoders.UnetResBlock(in_ch, out_ch)
    sd = {}
    for k in ("1", "2", "3"):
        if f"conv{k}" in params:
            kern = np.asarray(params[f"conv{k}"]["Conv_0"]["kernel"])
            sd[f"conv{k}.conv.weight"] = torch.from_numpy(
                kern.transpose(4, 3, 0, 1, 2).copy())
            sd[f"norm{k}.weight"] = torch.from_numpy(
                np.asarray(params[f"norm{k}"]["scale"]))
            sd[f"norm{k}.bias"] = torch.from_numpy(
                np.asarray(params[f"norm{k}"]["bias"]))
    port.load_state_dict(sd, strict=True)
    return blk, params, port.eval()


@pytest.mark.parametrize("in_ch,out_ch,shape", [
    (17, 24, (2, 8, 8, 16)),     # the JAX package's own case: a 1x1 shortcut
    (16, 16, (1, 8, 4, 16)),     # identity shortcut
])
def test_block_fused_matches_unfused_and_jax(fused, monkeypatch, in_ch, out_ch,
                                             shape):
    x = np.random.default_rng(23).normal(size=(*shape, in_ch)).astype(
        np.float32)
    blk, params, port = _block_params(in_ch, out_ch, x, seed=24)
    want_fused = np.asarray(blk.apply({"params": params}, jnp.asarray(x), True))
    want_plain = np.asarray(blk.apply({"params": params}, jnp.asarray(x), False))

    calls = _count_k9(monkeypatch)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
        assert calls == [((*shape, out_ch), True)]
        monkeypatch.setenv("MEDSEG_FUSED_DECODER", "0")
        unfused = port(torch.from_numpy(x)).numpy()
    assert len(calls) == 1
    np.testing.assert_allclose(got, unfused, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_fused, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(unfused, want_plain, rtol=TOL, atol=TOL)


def test_block_outside_the_channel_window_stays_unfused(fused, monkeypatch):
    x = np.random.default_rng(1).normal(size=(1, 4, 4, 8, 12)).astype(np.float32)
    _, _, port = _block_params(12, 12, x, seed=2)
    calls = _count_k9(monkeypatch)
    with torch.inference_mode():
        port(torch.from_numpy(x))
    assert calls == []


def test_fused_form_only_in_eval_without_gradients(fused, monkeypatch):
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 4, 4, 8, 16)).astype(np.float32))
    _, _, port = _block_params(16, 16, x.numpy(), seed=4)
    calls = _count_k9(monkeypatch)
    port(x)                                  # eval(), gradients enabled
    port.train()
    with torch.no_grad():
        port(x)                              # train(), no gradients
    assert calls == []
    port.eval()
    with torch.no_grad():
        port(x)
    assert len(calls) == 1


def test_env_gate_is_off_by_default_and_read_at_call_time(monkeypatch):
    x = torch.zeros(1, 2, 2, 2, 16)
    monkeypatch.delenv("MEDSEG_FUSED_DECODER", raising=False)
    monkeypatch.setattr(k9, "ALLOW_CPU", True)
    assert not decoders.decoder_fuse_enabled(x)
    monkeypatch.setenv("MEDSEG_FUSED_DECODER", "1")
    assert decoders.decoder_fuse_enabled(x)
    monkeypatch.setenv("MEDSEG_FUSED_DECODER", "0")
    assert not decoders.decoder_fuse_enabled(x)
    # without the tests' hook a CPU tensor never fuses (the JAX gate asks
    # for a non-CPU backend likewise)
    monkeypatch.setenv("MEDSEG_FUSED_DECODER", "1")
    monkeypatch.setattr(k9, "ALLOW_CPU", False)
    assert not decoders.decoder_fuse_enabled(x)
    monkeypatch.setattr(jax_k9, "_FORCE_INTERPRET", False)
    assert not jax_decoders.decoder_fuse_enabled()


def test_small_flagship_fused_matches_jax_fused(fused, monkeypatch):
    """hidden 16 puts the res blocks at 16, 16, 32 and 64 channels (two of
    each: encoder side and decoder side) inside K9's window. The JAX gate
    also wants (W / 2) % 8 == 0, so it fuses the four blocks at 32^3 and
    16^3; the port fuses all eight."""
    cfg = small_cfg(hidden_dim=16)
    jmodel, params = jax_params(cfg, seed=11)
    x_in = model_inputs(cfg, batch=2, seed=11)
    want = np.asarray(jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, deterministic=True))(
            params, tuple(jnp.asarray(a) for a in x_in)))

    calls = _count_k9(monkeypatch)
    model = port_model(cfg, params)
    xt = tuple(torch.from_numpy(a) for a in x_in)
    with torch.inference_mode():
        got = model(xt).numpy()
        fused_shapes = sorted(c[0] for c in calls)
        monkeypatch.setenv("MEDSEG_FUSED_DECODER", "0")
        unfused = model(xt).numpy()
    assert fused_shapes == sorted(
        [(2, 32, 32, 32, 16)] * 2 + [(2, 16, 16, 16, 16)] * 2
        + [(2, 8, 8, 8, 32)] * 2 + [(2, 4, 4, 4, 64)] * 2)
    assert all(c[1] for c in calls) and len(calls) == 8
    assert got.shape == (2, 32, 32, 32, 3)
    # five decoder stages of InstanceNorm between the fused convs and the
    # logits: 1e-4 as the unfused models against each other, times 5
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got, unfused, rtol=5e-4, atol=5e-4)
