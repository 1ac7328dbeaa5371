"""Token MLP (kernel K2) of the PyTorch port against the JAX package.

The port's wrapper takes its plain PyTorch version for CPU tensors; it is
held against the Pallas kernel ``fused_mlp`` in interpret mode on the same
numpy inputs, in fp32.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from medicalsemseg_tpu.ops.pallas.mlp import fused_mlp as jax_fused_mlp

from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp

# fp32 on both sides. The Pallas kernel's GELU uses the Abramowitz-Stegun
# erf (abs err <= 1.5e-7) where torch uses erf itself; with the differently
# ordered fp32 sums the outputs agree to a few fp32 ulps of O(1) values.
RTOL = ATOL = 3e-5


@pytest.mark.parametrize("m,ln_res", [(50, True), (37, False), (300, True)])
def test_plain_matches_pallas_interpret(m, ln_res):
    """Token counts that are not multiples of the tile, with and without
    the absorbed LayerNorm and shortcut."""
    c, hdim = 12, 48
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, c)).astype(np.float32)
    w1 = rng.normal(size=(c, hdim)).astype(np.float32) * 0.2
    b1 = rng.normal(size=(hdim,)).astype(np.float32) * 0.1
    w2 = rng.normal(size=(hdim, c)).astype(np.float32) * 0.2
    b2 = rng.normal(size=(c,)).astype(np.float32) * 0.1
    ln = np.stack([rng.normal(size=(c,)) * 0.3 + 1.0,
                   rng.normal(size=(c,)) * 0.1]).astype(np.float32)

    want = jax_fused_mlp(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
        jnp.asarray(b2), ln_scale=jnp.asarray(ln[0]) if ln_res else None,
        ln_bias=jnp.asarray(ln[1]) if ln_res else None, residual=ln_res,
        interpret=True)
    got = kmlp.fused_mlp(
        torch.from_numpy(x), torch.from_numpy(w1).t(), torch.from_numpy(b1),
        torch.from_numpy(w2).t(), torch.from_numpy(b2),
        ln=torch.from_numpy(ln) if ln_res else None, residual=ln_res)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_cpu_path_does_not_count_launches():
    before = kmlp.launches
    x = torch.randn(5, 4)
    kmlp.fused_mlp(x, torch.randn(8, 4), torch.zeros(8), torch.randn(4, 8),
                   torch.zeros(4))
    assert kmlp.launches == before


def test_wrapper_rejects_unknown_device():
    x = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kmlp.fused_mlp(x, x, x[0], x, x[0])
