"""Window attention (kernel K1) of the PyTorch port against the JAX package.

The port's wrapper takes its plain PyTorch version for CPU tensors; it is
held against the Pallas kernel ``fused_window_attention`` in interpret mode
and against the XLA ``WindowAttention`` module, on the same numpy inputs.
Everything is fp32: the point is the algorithm (shifted-window mask, bias
gather, LN/residual absorption, window order), not bf16 rounding.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from medicalsemseg_tpu.models.swin import WindowAttention
from medicalsemseg_tpu.ops.pallas.window_attention import fused_window_attention
from medicalsemseg_tpu.ops.window import shift_window_attn_mask
from medicalsemseg_tpu.ops.window import window_partition as jwp
from medicalsemseg_tpu.ops.window import window_reverse as jwr

from medicalsemseg_tpu_torch.ops import window as tw
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

# fp32 on both sides; the sums run in different orders (XLA vs torch CPU
# matmuls), so agreement is to a few fp32 ulps of O(1) values
RTOL = ATOL = 2e-5


def _inputs(seed, b, dims, c, nh, ws, qkv_bias):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(b, *dims, c)).astype(np.float32),
        "wqkv": rng.normal(size=(c, 3 * c)).astype(np.float32) * 0.1,
        "bqkv": (rng.normal(size=(3 * c,)).astype(np.float32) * 0.1
                 if qkv_bias else None),
        "wproj": rng.normal(size=(c, c)).astype(np.float32) * 0.1,
        "bproj": rng.normal(size=(c,)).astype(np.float32) * 0.1,
        "table": rng.normal(size=((2 * ws - 1) ** 3, nh)).astype(np.float32),
        "ln": np.stack([rng.normal(size=(c,)) * 0.3 + 1.0,
                        rng.normal(size=(c,)) * 0.1]).astype(np.float32),
    }


def _port(p, dims, ws, ss, nh, ln_res):
    """The port's K1 wrapper on (already rolled) volume p['x']."""
    x = torch.from_numpy(p["x"])
    n = ws ** 3
    idx = torch.from_numpy(tw.relative_position_index((ws,) * 3).astype(np.int64))
    bias = torch.from_numpy(p["table"])[idx.reshape(-1)].reshape(n, n, nh)
    bias = bias.permute(2, 0, 1).contiguous()
    out = kwa.window_attention(
        tw.window_partition(x, ws), torch.from_numpy(p["wqkv"]).t(),
        None if p["bqkv"] is None else torch.from_numpy(p["bqkv"]),
        torch.from_numpy(p["wproj"]).t(), torch.from_numpy(p["bproj"]), bias,
        grid_dims=tuple(d // ws for d in dims), window=(ws,) * 3,
        shift=(ss,) * 3, ln=torch.from_numpy(p["ln"]) if ln_res else None,
        residual=ln_res)
    return tw.window_reverse(out, ws, dims).numpy()


@pytest.mark.parametrize("ws,ss,ln_res,qkv_bias", [
    (2, 0, False, True),
    (2, 1, True, True),
    (2, 1, False, False),
    (3, 0, True, False),
    (3, 1, True, True),
    (3, 1, False, True),
])
def test_plain_matches_pallas_interpret(ws, ss, ln_res, qkv_bias):
    dims = (2 * ws, 2 * ws, 3 * ws)
    c, nh = 8, 2
    p = _inputs(ws * 10 + ss, 2, dims, c, nh, ws, qkv_bias)
    want = fused_window_attention(
        jnp.asarray(p["x"]), jnp.asarray(p["wqkv"]),
        None if p["bqkv"] is None else jnp.asarray(p["bqkv"]),
        jnp.asarray(p["wproj"]), jnp.asarray(p["bproj"]),
        jnp.asarray(p["table"]), ws, nh, shift_size=ss, interpret=True,
        ln_scale=jnp.asarray(p["ln"][0]) if ln_res else None,
        ln_bias=jnp.asarray(p["ln"][1]) if ln_res else None,
        residual=ln_res)
    got = _port(p, dims, ws, ss, nh, ln_res)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("ws,ss", [(2, 1), (3, 1)])
def test_plain_matches_xla_module(ws, ss):
    """Against the XLA WindowAttention with the host-built region mask."""
    dims = (2 * ws, 3 * ws, 2 * ws)
    c, nh = 8, 2
    p = _inputs(7 + ws, 2, dims, c, nh, ws, True)
    attn = WindowAttention(dim=c, window_size=(ws,) * 3, num_heads=nh,
                           n_windows=0, qkv_bias=True)
    params = {"qkv_kernel": p["wqkv"], "qkv_bias": p["bqkv"],
              "proj_kernel": p["wproj"], "proj_bias": p["bproj"],
              "relative_position_bias_table": p["table"]}
    mask = shift_window_attn_mask(dims, ws, ss)
    out, _ = attn.apply({"params": params}, jwp(jnp.asarray(p["x"]), ws),
                        mask=mask)
    want = np.asarray(jwr(out, ws, dims))
    got = _port(p, dims, ws, ss, nh, ln_res=False)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_partition_roundtrip_and_order():
    """Batch-major window order, identical to the JAX partition."""
    x = np.random.default_rng(3).normal(size=(2, 4, 6, 2, 3)).astype(np.float32)
    got = tw.window_partition(torch.from_numpy(x), (2, 3, 2))
    want = np.asarray(jwp(jnp.asarray(x), (2, 3, 2)))
    np.testing.assert_array_equal(got.numpy(), want)
    back = tw.window_reverse(got, (2, 3, 2), (4, 6, 2))
    np.testing.assert_array_equal(back.numpy(), x)


def test_wrapper_rejects_unknown_device():
    x = torch.zeros(1, 8, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kwa.window_attention(x, x, None, x, x, x, grid_dims=(1, 1, 1),
                             window=(2, 2, 2), shift=(0, 0, 0))
