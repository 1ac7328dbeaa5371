"""Global-query window attention (kernel K6) of the PyTorch port against the
JAX package.

The port's wrapper takes its plain PyTorch version for CPU tensors; it is
held against the Pallas kernel ``fused_global_window_attention`` in interpret
mode on the same numpy inputs. Everything is fp32: the point is the algorithm
(K/V-only projection, one query grid per batch element, scale folded into the
queries, LN never applied to them, the raw-window shortcut, window order),
not bf16 rounding.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from medicalsemseg_tpu.ops.pallas.window_attention import (
    fused_global_window_attention,
)

from medicalsemseg_tpu_torch.ops import window as tw
from medicalsemseg_tpu_torch.ops.kernels import global_attention as kga

# fp32 on both sides; the sums run in different orders (XLA vs torch CPU
# matmuls), so agreement is to a few fp32 ulps of O(1) values: the JAX
# suite's own tolerance for this kernel
RTOL = ATOL = 2e-5


def _inputs(seed, b, dims, c, nh, ws, kv_bias=True):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(b, *dims, c)).astype(np.float32),
        "q": rng.normal(size=(b, ws, ws, ws, c)).astype(np.float32),
        "wkv": rng.normal(size=(c, 2 * c)).astype(np.float32) * 0.3,
        "bkv": (rng.normal(size=(2 * c,)).astype(np.float32) * 0.1
                if kv_bias else None),
        "wproj": rng.normal(size=(c, c)).astype(np.float32) * 0.3,
        "bproj": rng.normal(size=(c,)).astype(np.float32) * 0.1,
        "table": rng.normal(size=((2 * ws - 1) ** 3, nh)).astype(np.float32),
        "ln": np.stack([rng.normal(size=(c,)) * 0.3 + 1.0,
                        rng.normal(size=(c,)) * 0.1]).astype(np.float32),
    }


def _gather(table, ws, nh, index_fn):
    n = ws ** 3
    idx = index_fn((ws,) * 3).reshape(-1).astype(np.int64)
    return np.ascontiguousarray(
        table[idx].reshape(n, n, nh).transpose(2, 0, 1))


def _port(p, dims, ws, nh, ln, res, index_fn=tw.relative_position_index):
    x = torch.from_numpy(p["x"])
    b, c = x.shape[0], x.shape[-1]
    out = kga.global_window_attention(
        tw.window_partition(x, ws),
        torch.from_numpy(p["q"]).reshape(b, ws ** 3, c),
        torch.from_numpy(p["wkv"]).t(),
        None if p["bkv"] is None else torch.from_numpy(p["bkv"]),
        torch.from_numpy(p["wproj"]).t(), torch.from_numpy(p["bproj"]),
        torch.from_numpy(_gather(p["table"], ws, nh, index_fn)),
        ln=torch.from_numpy(p["ln"]) if ln else None, residual=res)
    return tw.window_reverse(out, ws, dims).numpy()


def _pallas(p, ws, nh, ln, res, pre_bias=None):
    j = {k: None if v is None else jnp.asarray(v) for k, v in p.items()}
    return np.asarray(fused_global_window_attention(
        j["x"], j["q"], j["wkv"], j["bkv"], j["wproj"], j["bproj"],
        j["table"], ws, nh, interpret=True,
        ln_scale=j["ln"][0] if ln else None,
        ln_bias=j["ln"][1] if ln else None, residual=res,
        pre_bias=None if pre_bias is None else jnp.asarray(pre_bias)))


@pytest.mark.parametrize("ln,res,kv_bias", [
    (False, False, True),    # bare
    (True, True, True),      # the block's absorbed form
    (True, False, True),
    (False, True, False),    # qkv_bias=False: no kv bias row
], ids=["bare", "ln_res", "ln", "res_no_bkv"])
def test_matches_pallas_interpret(ln, res, kv_bias):
    dims, c, nh, ws = (4, 6, 4), 8, 2, 2
    p = _inputs(31, 1, dims, c, nh, ws, kv_bias)
    np.testing.assert_allclose(_port(p, dims, ws, nh, ln, res),
                               _pallas(p, ws, nh, ln, res), rtol=RTOL,
                               atol=ATOL)


def test_batch_two_with_distinct_queries():
    """Each window takes the query grid of ITS batch element (window index
    // windows per volume); 12 windows per element, window 3, head dim 4."""
    dims, c, nh, ws = (6, 9, 6), 12, 3, 3
    p = _inputs(32, 2, dims, c, nh, ws)
    got = _port(p, dims, ws, nh, True, True)
    np.testing.assert_allclose(got, _pallas(p, ws, nh, True, True), rtol=RTOL,
                               atol=ATOL)
    # the queries matter per element: swapping them changes both outputs
    swapped = dict(p, q=p["q"][::-1].copy())
    other = _port(swapped, dims, ws, nh, True, True)
    assert float(np.abs(other - got).max()) > 1e-3


def test_pre_bias_with_the_quirk_index():
    """The reference's colliding-stride index is a different gather outside
    the kernel; the Pallas kernel takes it as ``pre_bias``."""
    dims, c, nh, ws = (4, 4, 4), 8, 2, 2
    p = _inputs(33, 2, dims, c, nh, ws)
    quirk = _gather(p["table"], ws, nh, tw.relative_position_index_ref_quirk)
    got = _port(p, dims, ws, nh, True, True,
                tw.relative_position_index_ref_quirk)
    np.testing.assert_allclose(got, _pallas(p, ws, nh, True, True, quirk),
                               rtol=RTOL, atol=ATOL)
    assert float(np.abs(got - _port(p, dims, ws, nh, True, True)).max()) > 1e-3


def test_queries_are_scaled_then_rounded_in_bf16():
    """In bf16 the plain version rounds q * hd^-0.5 before the dot (K7 scales
    its fp32 logits after the dot instead: the two differ in bf16). Head 0 of
    query 0 by hand, read through a projection that passes head 0 only."""
    dims, c, nh, ws = (2, 2, 2), 8, 2, 2
    hd, n = c // nh, ws ** 3
    p = _inputs(34, 1, dims, c, nh, ws)
    bf = torch.bfloat16
    wins = tw.window_partition(torch.from_numpy(p["x"]), ws).to(bf)
    q = torch.from_numpy(p["q"]).reshape(1, n, c).to(bf)
    wkv = torch.from_numpy(p["wkv"]).t().to(bf)
    wproj = torch.zeros(c, c)
    wproj[:hd, :hd] = torch.eye(hd)
    got = kga.global_window_attention_plain(
        wins, q, wkv, None, wproj.to(bf), torch.zeros(c), torch.zeros(nh, n, n))
    assert got.dtype == bf

    kv = (wins.float() @ wkv.float().t()).to(bf).float()
    qs = (q.float() * hd ** -0.5).to(bf).float()
    pr = torch.softmax(kv[0, :, :hd] @ qs[0, 0, :hd], 0).to(bf).float()
    want = (pr @ kv[0, :, c:c + hd]).to(bf)
    np.testing.assert_array_equal(got[0, 0, :hd].float().numpy(),
                                  want.float().numpy())
