"""Fault F5's shapes through the port's modules against the JAX package, on
the CPU, with carried weights.

* SegFormer3D at vol 160 (M = 5^3 = 125 reduced tokens at every stage: past
  K7's tensor-core limit of 64, where the streaming CUDA-core route takes
  over on the card; hidden 4, depths 1): the port's logits against the JAX
  model on its XLA path, and the port's encoder pyramid against the JAX
  encoder with the Pallas kernel in interpret mode.
* The flagship's Swin block at C = 768 (stage 4 at --hidden_dim 96, head
  dim 32) in training, where the JAX block keeps XLA and the port runs K1-K4
  (K3 and K4 on the CUDA cores on the card; on the CPU the wrappers run
  their plain versions inside ``WindowAttentionFn`` and ``FusedMlpFn``): its
  output, input gradient and every parameter gradient against ``jax.vjp`` of
  the JAX block (the one jitted JAX step of this file).

fp32 throughout, both sides summing in their own orders; the tolerance is
``RTOL = ATOL = 1e-4`` of tests/test_torch_model.py for logits, pyramids,
outputs and gradients (the gradients here are O(1-10): at the C = 768 block
an fp32 sum over 3072 hidden units puts a few elements near zero ~2e-5 off).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalsemseg_tpu_torch.models.factory import build_model
from medicalsemseg_tpu_torch.models.swin import SwinBlock
from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp
from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa
from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

from tests.test_torch_model import (
    ATOL,
    RTOL,
    jax_variables,
    model_inputs,
    small_cfg,
)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False



@pytest.fixture(scope="module")
def segformer160():
    cfg = small_cfg(model="SegFormer3D", vol_size=160, hidden_dim=4,
                    depths=(1, 1, 1, 1))
    jmodel, variables = jax_variables(cfg, seed=31)
    x_in = model_inputs(cfg, batch=1, seed=31)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return cfg, jmodel, variables, x_in, model.eval()


def test_segformer_m125_logits_match_jax(segformer160):
    cfg, jmodel, variables, x_in, model = segformer160
    want = np.asarray(jax.jit(
        lambda v, x: jmodel.apply(v, x, deterministic=True))(
            variables, tuple(jnp.asarray(a) for a in x_in)))
    assert all(ksr.sr_attention_supported(torch.float32, 4 * 2 ** s, 2, 125)
               for s in range(4))
    with torch.inference_mode():
        got = model(tuple(torch.from_numpy(a) for a in x_in))
    assert got.shape == (1, 160, 160, 160, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_segformer_m125_encoder_matches_pallas_interpret(segformer160,
                                                         monkeypatch):
    import medicalsemseg_tpu.ops.pallas.sr_attention as psr
    from medicalsemseg_tpu.models.segformer import MixVisionTransformer3D

    cfg, _, variables, x_in, model = segformer160
    monkeypatch.setattr(psr, "_FORCE_INTERPRET", True)
    enc = MixVisionTransformer3D(embed_dim=4, depths=(1, 1, 1, 1),
                                 num_heads=(2, 2, 2, 2), qkv_bias=True,
                                 use_pallas=True)
    want = jax.jit(lambda p, v: enc.apply({"params": p}, (v, None, None),
                                          deterministic=True))(
        variables["params"]["encoder"], jnp.asarray(x_in[0]))
    with torch.inference_mode():
        got = model.encoder(torch.from_numpy(x_in[0]))
    assert [tuple(g.shape[1:4]) for g in got] == [
        (40, 40, 40), (40, 40, 40), (20, 20, 20), (10, 10, 10), (5, 5, 5)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def _block_params(rng, c, nh, ws):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    h = 4 * c
    return {"params": {
        "LayerNorm_0": {"LayerNorm_0": {"scale": 1 + 0.3 * f(c),
                                        "bias": 0.1 * f(c)}},
        "LayerNorm_1": {"LayerNorm_0": {"scale": 1 + 0.3 * f(c),
                                        "bias": 0.1 * f(c)}},
        "attn": {"qkv_kernel": f(c, 3 * c) * c ** -0.5,
                 "qkv_bias": 0.1 * f(3 * c),
                 "proj_kernel": f(c, c) * c ** -0.5, "proj_bias": 0.1 * f(c),
                 "relative_position_bias_table": 0.5 * f((2 * ws - 1) ** 3,
                                                         nh)},
        "Mlp_0": {"Dense_0": {"kernel": f(c, h) * c ** -0.5,
                              "bias": 0.1 * f(h)},
                  "Dense_1": {"kernel": f(h, c) * h ** -0.5,
                              "bias": 0.1 * f(c)}}}}


def _to_port(p):
    """The port's SwinBlock parameters from the JAX block's ([out, in]
    weights are the JAX kernels transposed); the same names as the grads."""
    a, m = p["attn"], p["Mlp_0"]
    return {
        "norm1.weight": p["LayerNorm_0"]["LayerNorm_0"]["scale"],
        "norm1.bias": p["LayerNorm_0"]["LayerNorm_0"]["bias"],
        "attn.qkv.weight": a["qkv_kernel"].T, "attn.qkv.bias": a["qkv_bias"],
        "attn.proj.weight": a["proj_kernel"].T,
        "attn.proj.bias": a["proj_bias"],
        "attn.relative_position_bias_table":
            a["relative_position_bias_table"],
        "norm2.weight": p["LayerNorm_1"]["LayerNorm_0"]["scale"],
        "norm2.bias": p["LayerNorm_1"]["LayerNorm_0"]["bias"],
        "mlp.fc1.weight": m["Dense_0"]["kernel"].T,
        "mlp.fc1.bias": m["Dense_0"]["bias"],
        "mlp.fc2.weight": m["Dense_1"]["kernel"].T,
        "mlp.fc2.bias": m["Dense_1"]["bias"]}


class _Spy:
    """Stands in for a function: counts its calls, forwards to ``fn``."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("grid,shift", [((4, 4, 4), 1), ((3, 4, 4), 1)])
def test_c768_block_trains_plain_and_matches_jax(grid, shift, monkeypatch):
    """(4, 4, 4): the absorbed form (LN and shortcut inside the attention),
    shifted windows; (3, 4, 4): the padded form (LN outside, zero pad)."""
    from medicalsemseg_tpu.models.swin import SwinBlock as JaxBlock

    c, nh, ws = 768, 24, 2
    rng = np.random.default_rng(7)
    variables = _block_params(rng, c, nh, ws)
    x = rng.normal(size=(1, *grid, c)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    jblk = JaxBlock(dim=c, input_resolution=grid, num_heads=nh,
                    window_size=ws, shift_size=shift, qkv_bias=True)

    def fwd(v, xx):
        return jblk.apply(v, xx, deterministic=False)[0]

    y_j, vjp = jax.jit(lambda v, xx: jax.vjp(fwd, v, xx))(variables,
                                                          jnp.asarray(x))
    dv_j, dx_j = jax.jit(vjp)(jnp.asarray(cot))

    blk = SwinBlock(c, grid, nh, ws, shift, qkv_bias=True).train()
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in _to_port(variables["params"]).items()}
    blk.load_state_dict(sd, strict=True)
    assert kwa.window_attention_supported(torch.float32, ws ** 3, c, nh, True)
    assert kmlp.fused_mlp_supported(torch.float32, c, c, 4 * c, True)
    spies = {}
    for mod, name in ((kwa, "window_attention"), (kwa, "window_attention_bwd"),
                      (kmlp, "fused_mlp"), (kmlp, "fused_mlp_bwd")):
        spies[name] = _Spy(getattr(mod, name))
        monkeypatch.setattr(mod, name, spies[name])
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = blk(xt)
    names = list(sd)
    grads = torch.autograd.grad(y, [xt] + [dict(blk.named_parameters())[n]
                                           for n in names],
                                torch.from_numpy(cot))
    # the block went through the kernels' autograd functions
    assert {k: v.calls for k, v in spies.items()} == dict.fromkeys(spies, 1)

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(dx_j),
                               rtol=RTOL, atol=ATOL)
    want = {k: np.asarray(v) for k, v in _to_port(dv_j["params"]).items()}
    for name, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
