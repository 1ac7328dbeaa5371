"""Token MLP backward (kernel K4) of the PyTorch port against the JAX package.

The port's wrapper takes its plain PyTorch version for CPU tensors. It is held
against the Pallas backward kernel (``fused_mlp_trainable`` with
``_FORCE_INTERPRET``, as the JAX package's own tests run it on the CPU) on
every gradient, directly and through the autograd function. fp32 throughout.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import medicalsemseg_tpu.ops.pallas.mlp as pmlp

from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp

# fp32 on both sides; weight gradients sum over all tokens in different
# orders, so the tolerance is relative
RTOL, ATOL = 1e-4, 1e-5


def _inputs(seed, m, c, hdim):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"x": f(m, c), "dy": f(m, c), "w1": f(c, hdim) * c ** -0.5,
            "b1": f(hdim) * 0.1, "w2": f(hdim, c) * hdim ** -0.5,
            "b2": f(c) * 0.1, "scale": f(c) * 0.3 + 1.0, "bias": f(c) * 0.1}


def _jax_grads(p, residual):
    cot = jnp.asarray(p["dy"])

    def loss(x, scale, bias, w1, b1, w2, b2):
        y = pmlp.fused_mlp_trainable(x, scale, bias, w1, b1, w2, b2, residual)
        return (y * cot).sum()

    args = tuple(jnp.asarray(p[k]) for k in
                 ("x", "scale", "bias", "w1", "b1", "w2", "b2"))
    return jax.grad(loss, argnums=tuple(range(7)))(*args)


@pytest.mark.parametrize("m,c,hdim,residual", [
    (37, 8, 32, True),      # a ragged tile: the Pallas side zero-pads M
    (64, 12, 48, False),
    (300, 16, 24, True),    # more than one Pallas grid step
])
def test_plain_matches_pallas_backward(monkeypatch, m, c, hdim, residual):
    monkeypatch.setattr(pmlp, "_FORCE_INTERPRET", True)
    p = _inputs(m, m, c, hdim)
    dx, dscale, dbias, dw1, db1, dw2, db2 = _jax_grads(p, residual)

    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = kmlp.fused_mlp_bwd(
        t["x"], t["w1"].t(), t["b1"], t["w2"].t(),
        torch.stack([t["scale"], t["bias"]]), t["dy"], residual=residual)
    want = {"dx": dx, "dln": jnp.stack([dscale, dbias]), "dw1": dw1.T,
            "db1": db1, "dw2": dw2.T, "db2": db2}
    for (name, w), g in zip(want.items(), got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("residual", [False, True])
def test_autograd_function_matches_jax_grad(monkeypatch, residual):
    """FusedMlpFn: forward K2, backward K4, fp32 parameter gradients."""
    monkeypatch.setattr(pmlp, "_FORCE_INTERPRET", True)
    m, c, hdim = 50, 8, 32
    p = _inputs(3, m, c, hdim)
    want = _jax_grads(p, residual)

    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()
         if k != "dy"}
    ln = torch.stack([t["scale"], t["bias"]])
    y = kmlp.FusedMlpFn.apply(t["x"], ln, t["w1"].t(), t["b1"], t["w2"].t(),
                              t["b2"], 1e-5, residual)
    (y * torch.from_numpy(p["dy"])).sum().backward()
    for name, w in zip(("x", "scale", "bias", "w1", "b1", "w2", "b2"), want):
        np.testing.assert_allclose(t[name].grad.numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_gelu_cdf_polynomial_matches_pallas():
    h = np.linspace(-6, 6, 2001).astype(np.float32)
    np.testing.assert_allclose(kmlp.gelu_cdf(torch.from_numpy(h)).numpy(),
                               np.asarray(pmlp._gelu_cdf(jnp.asarray(h))),
                               rtol=0, atol=1e-7)


def test_backward_wrapper_rejects_unknown_device():
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kmlp.fused_mlp_bwd(x, x, x, x, x, x)
