"""Spatial-reduction attention (kernel K7) of the PyTorch port against the
JAX package.

The port's wrapper takes its plain PyTorch version for CPU tensors; it is
held against the Pallas kernel ``fused_sr_attention`` in interpret mode on
the same numpy inputs, in fp32: the point is the algorithm (q dense, heads
sliced head-major out of the kv halves, logits scaled after the dot, the
shortcut), and that N needs no padding: the Pallas wrapper pads N to a
multiple of 256 and slices the result.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from medicalsemseg_tpu.ops.pallas.sr_attention import fused_sr_attention

from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr

# fp32 on both sides, sums in other orders: a few fp32 ulps of O(1) values
# (the JAX suite's own tolerance for this kernel)
RTOL = ATOL = 2e-5


def _inputs(seed, b, n, m, c, bq=True, res=True):
    rng = np.random.default_rng(seed)

    def arr(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return {
        "x": arr(b, n, c), "k": arr(b, m, c), "v": arr(b, m, c),
        "wq": arr(c, c, s=0.3), "bq": arr(c, s=0.1) if bq else None,
        "wproj": arr(c, c, s=0.3), "bproj": arr(c, s=0.1),
        "res": arr(b, n, c) if res else None,
    }


def _port(p, nh):
    t = {k: None if v is None else torch.from_numpy(v) for k, v in p.items()}
    return ksr.sr_attention(t["x"], t["k"], t["v"], t["wq"].t(), t["bq"],
                            t["wproj"].t(), t["bproj"], nh,
                            residual=t["res"]).numpy()


def _pallas(p, nh):
    j = {k: None if v is None else jnp.asarray(v) for k, v in p.items()}
    return np.asarray(fused_sr_attention(
        j["x"], j["k"], j["v"], j["wq"], j["bq"], j["wproj"], j["bproj"], nh,
        residual=j["res"], interpret=True))


@pytest.mark.parametrize("n,m,bq,res", [
    (512, 8, True, True),     # two whole Pallas tiles
    (300, 27, True, False),   # N no multiple of 256
    (27, 27, False, True),    # the last stage: N = 27 tokens, no q bias
    (1, 1, True, True),       # one token, one key: softmax is 1
], ids=["n512", "n300_no_res", "n27_no_bq", "n1_m1"])
def test_matches_pallas_interpret(n, m, bq, res):
    c, nh = 16, 4
    p = _inputs(41 + n, 2, n, m, c, bq, res)
    np.testing.assert_allclose(_port(p, nh), _pallas(p, nh), rtol=RTOL,
                               atol=ATOL)


def test_logits_are_scaled_after_the_dot_in_bf16():
    """bf16: q is rounded unscaled, the fp32 logits take hd^-0.5 after the
    dot (K6 scales and rounds q first: the two differ in bf16)."""
    c, nh = 8, 2
    p = _inputs(43, 1, 5, 3, c, bq=False, res=False)
    bf = torch.bfloat16
    t = {k: None if v is None else torch.from_numpy(v) for k, v in p.items()}
    wproj = torch.zeros(c, c)
    hd = c // nh
    wproj[:hd, :hd] = torch.eye(hd)          # read head 0 only
    got = ksr.sr_attention_plain(t["x"].to(bf), t["k"].to(bf), t["v"].to(bf),
                                 t["wq"].t().to(bf), None, wproj.to(bf),
                                 torch.zeros(c), nh)
    assert got.dtype == bf
    q = (t["x"].to(bf).float() @ t["wq"].to(bf).float()).to(bf).float()
    logits = (q[0, :, :hd] @ t["k"].to(bf).float()[0, :, :hd].t()) * hd ** -0.5
    pr = torch.softmax(logits, -1).to(bf).float()
    want = (pr @ t["v"].to(bf).float()[0, :, :hd]).to(bf)
    np.testing.assert_array_equal(got[0, :, :hd].float().numpy(),
                                  want.float().numpy())


def test_residual_is_added_once():
    c, nh = 8, 2
    p = _inputs(44, 1, 40, 4, c)
    with_res = _port(p, nh)
    without = _port(dict(p, res=None), nh)
    np.testing.assert_allclose(with_res - without, p["res"], rtol=1e-5,
                               atol=1e-6)

