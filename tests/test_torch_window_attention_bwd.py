"""Window attention backward (kernel K3) of the PyTorch port against the JAX
package.

The port's wrapper takes its plain PyTorch version for CPU tensors. It is held
against both Pallas backward kernels in interpret mode, the whole-head
``_fused_bwd_windows`` and the head-split ``_fused_bwd_windows_hsplit`` that
the port's one kernel replaces, on every output, and through the autograd
function against ``jax.grad`` of the trainable custom VJPs (the bias gradient
after the scatter onto the table). Everything is fp32: the point is the
algorithm, not bf16 rounding.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalsemseg_tpu.ops.pallas import window_attention as pwa
from medicalsemseg_tpu.ops.window import window_partition as jwp

from medicalsemseg_tpu_torch.ops import window as tw
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

# fp32 on both sides, sums in different orders; gradients sum over all
# windows, so the tolerance is relative (the Pallas VJP tests use 2e-4)
RTOL, ATOL = 1e-4, 2e-5


def _inputs(seed, b, dims, c, nh, ws):
    rng = np.random.default_rng(seed)
    n = ws ** 3
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "x": f(b, *dims, c), "dy": f(b, *dims, c),
        "wqkv": f(c, 3 * c) * 0.2, "bqkv": f(3 * c) * 0.1,
        "wproj": f(c, c) * 0.2, "bproj": f(c) * 0.1,
        "bias": f(nh, n, n) * 0.5,
        "table": f((2 * ws - 1) ** 3, nh) * 0.5,
        "ln": np.stack([f(c) * 0.3 + 1.0, f(c) * 0.1]),
    }


def _check(names, got, want):
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(
            g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g),
            np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("hsplit", [False, True])
@pytest.mark.parametrize("ws,ss,ln,residual", [
    (2, 0, True, False),
    (2, 1, True, True),
    (2, 1, False, False),
    (3, 1, True, False),
])
def test_plain_matches_pallas_backward(ws, ss, ln, residual, hsplit):
    dims = (2 * ws, 2 * ws, 2 * ws)
    b, c, nh = 2, 8, 4
    p = _inputs(ws * 10 + ss, b, dims, c, nh, ws)
    grid_dims = tuple(d // ws for d in dims)
    kw = dict(num_heads=nh, wpb=2, shifted=ss > 0, grid_dims=grid_dims,
              ws=ws, ss=ss, interpret=True, residual=residual,
              ln=(jnp.asarray(p["ln"][0]), jnp.asarray(p["ln"][1])) if ln
              else None)
    args = (jwp(jnp.asarray(p["x"]), ws), jnp.asarray(p["wqkv"]),
            jnp.asarray(p["bqkv"]), jnp.asarray(p["wproj"]),
            jnp.asarray(p["bias"]), jwp(jnp.asarray(p["dy"]), ws))
    if hsplit:
        want = pwa._fused_bwd_windows_hsplit(*args, hg_count=2, **kw)
    else:
        want = pwa._fused_bwd_windows(*args, **kw)

    got = kwa.window_attention_bwd(
        tw.window_partition(torch.from_numpy(p["x"]), ws),
        torch.from_numpy(p["wqkv"]).t(), torch.from_numpy(p["bqkv"]),
        torch.from_numpy(p["wproj"]).t(), torch.from_numpy(p["bias"]),
        tw.window_partition(torch.from_numpy(p["dy"]), ws),
        grid_dims=grid_dims, window=(ws,) * 3, shift=(ss,) * 3,
        ln=torch.from_numpy(p["ln"]) if ln else None, residual=residual)
    dx, dwqkv, dbqkv, dwproj, dbproj, dbias, dln = got
    # the JAX weights are [in, out]
    names = ["dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias"]
    mine = [dx, dwqkv.t(), dbqkv, dwproj.t(), dbproj, dbias]
    if ln:
        names.append("dln")
        mine.append(dln)
    else:
        assert dln is None
    assert len(want) == len(mine)
    _check(names, mine, want)


@pytest.mark.parametrize("ss,ln,residual,qkv_bias", [
    (0, True, False, True),
    (1, True, True, False),
    (1, False, False, True),
])
def test_autograd_function_matches_jax_grad(ss, ln, residual, qkv_bias):
    """WindowAttentionFn (forward K1, backward K3, index_add_ onto the
    table) against jax.grad of the trainable custom VJPs."""
    ws, b, c, nh = 2, 2, 8, 2
    dims = (4, 4, 6)
    p = _inputs(40 + ss, b, dims, c, nh, ws)
    if not qkv_bias:
        p["bqkv"] = np.zeros_like(p["bqkv"])
    cot = jnp.asarray(p["dy"])

    def loss(x, scale, bias_ln, wqkv, bqkv, wproj, bproj, table):
        if ln:
            y = pwa.fused_window_attention_ln_trainable(
                x, scale, bias_ln, wqkv, bqkv, wproj, bproj, table, ws, nh,
                ss, 4, True, residual)
        else:
            y = pwa.fused_window_attention_trainable(
                x, wqkv, bqkv, wproj, bproj, table, ws, nh, ss, 4, True)
        return (y * cot).sum()

    args = tuple(jnp.asarray(a) for a in (
        p["x"], p["ln"][0], p["ln"][1], p["wqkv"], p["bqkv"], p["wproj"],
        p["bproj"], p["table"]))
    want = jax.grad(loss, argnums=tuple(range(8)))(*args)

    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()
         if k not in ("dy", "bias")}
    wqkv_t = t["wqkv"].t()
    wproj_t = t["wproj"].t()
    idx = torch.from_numpy(
        tw.relative_position_index((ws,) * 3).astype(np.int64)).reshape(-1)
    out = kwa.WindowAttentionFn.apply(
        tw.window_partition(t["x"], ws), t["ln"] if ln else None, wqkv_t,
        t["bqkv"] if qkv_bias else None, wproj_t, t["bproj"], t["table"], idx,
        tuple(d // ws for d in dims), (ws,) * 3, (ss,) * 3, 1e-5, residual)
    y = tw.window_reverse(out, ws, dims)
    (y * torch.from_numpy(p["dy"])).sum().backward()

    names = ["dx", "dwqkv", "dwproj", "dbproj", "dtable"]
    mine = [t["x"].grad, t["wqkv"].grad, t["wproj"].grad, t["bproj"].grad,
            t["table"].grad]
    ref = [want[0], want[3], want[5], want[6], want[7]]
    if ln:
        names.append("dln")
        mine.append(t["ln"].grad)
        ref.append(jnp.stack([want[1], want[2]]))
    if qkv_bias:
        names.append("dbqkv")
        mine.append(t["bqkv"].grad)
        ref.append(want[4])
    _check(names, mine, ref)


def test_backward_wrapper_rejects_unknown_device():
    x = torch.zeros(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kwa.window_attention_bwd(x, x, None, x, x, x, grid_dims=(1, 1, 1),
                                 window=(2, 2, 2), shift=(0, 0, 0))
