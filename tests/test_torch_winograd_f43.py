"""``MEDSEG_WINOGRAD=1`` with fp32 input in the PyTorch port against the JAX
package's Winograd F(4^3, 3^3) on the CPU.

Under the gate the JAX package sends a no-gradient fp32 3^3 conv with
spatial dims divisible by 4 and at least 16 input channels through
``winograd_conv3d_f43`` in fp32; the port runs the library's conv in true
fp32 there (TF32 off on the card: ``ops.convgrad.no_tf32``), which is the
closer of the two to the exact conv. On seeded unit-variance inputs
(C and Co 16 to 48) the port's conv lies within 5e-6 of max |y| of the
exact (float64) conv, the JAX transform within 5e-5 (B^T and A^T amplify
one fp32 rounding of the 216 products ~10^3 times: measured 1.1e-5 to
2.5e-5), and the two within 5e-5 of each other. bf16 keeps K9's F(2, 3) and
a conv with gradients ``Conv3x3x3Fn``: neither is touched by the fp32 rule.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from medicalsemseg_tpu.ops import convgrad as jax_convgrad
from medicalsemseg_tpu.ops.winograd import winograd_conv3d_f43 as jax_f43

from medicalsemseg_tpu_torch.models.layers import Conv3d
from medicalsemseg_tpu_torch.ops import convgrad

CASES = [(16, 16, (1, 8, 8, 8)), (32, 48, (2, 12, 8, 16)),
         (16, 48, (2, 12, 8, 16)), (32, 16, (1, 8, 8, 8))]


def _case(c, co, shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, c)).astype(np.float32)
    w = (rng.normal(size=(co, c, 3, 3, 3)) / np.sqrt(27 * c)).astype(np.float32)
    return x, w


def _direct(x, w):
    y = F.conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                 torch.from_numpy(w), padding=1)
    return y.permute(0, 2, 3, 4, 1).numpy()


def _conv(w, bias=False):
    conv = Conv3d(w.shape[1], w.shape[0], 3, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        if bias:
            conv.bias.normal_(generator=torch.Generator().manual_seed(1))
    return conv


@pytest.mark.parametrize("c,co,shape", CASES)
def test_f43_matches_jax_and_the_direct_conv(c, co, shape, monkeypatch):
    monkeypatch.setenv("MEDSEG_WINOGRAD", "1")
    x, w = _case(c, co, shape)
    with torch.no_grad():
        got = _conv(w)(torch.from_numpy(x))
    assert got.shape == (*shape, co) and got.dtype == torch.float32
    got = got.numpy()
    jw = jnp.asarray(w.transpose(2, 3, 4, 1, 0))       # (3, 3, 3, C, Co)
    want = np.asarray(jax.jit(lambda a, b: jax_f43(a, b, mm_dtype=jnp.float32))(
        jnp.asarray(x), jw))
    scale = float(np.abs(want).max())
    exact = _direct(x.astype(np.float64), w.astype(np.float64))
    assert float(np.abs(got - exact).max()) <= 5e-6 * scale
    assert float(np.abs(want - exact).max()) <= 5e-5 * scale
    assert float(np.abs(got - want).max()) <= 5e-5 * scale


def test_conv3d_takes_f43_as_the_jax_primal_does(monkeypatch):
    """One ``Conv3d`` (with bias) under ``MEDSEG_WINOGRAD=1`` through the
    port's route against ``conv3x3x3_s1``'s primal with the JAX gate on (it
    reads ``MEDSEG_WINOGRAD`` at import, so the test sets its flag), which
    takes F(4, 3), plus the same bias."""
    monkeypatch.setattr(jax_convgrad, "_WINOGRAD_INFER", True)
    monkeypatch.setenv("MEDSEG_WINOGRAD", "1")
    x, w = _case(32, 16, (2, 8, 12, 8), seed=4)
    conv = _conv(w, bias=True)
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax_convgrad.conv3x3x3_s1)(
        jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 4, 1, 0)))) \
        + conv.bias.detach().numpy()
    assert float(np.abs(got - want).max()) <= 5e-5 * float(np.abs(want).max())


@pytest.mark.parametrize("what", ["fp32", "bf16", "gradients", "unset"])
def test_gate_keeps_the_library_conv(monkeypatch, what):
    """The library's conv runs in each case, with TF32 off only for the
    no-gradient fp32 conv under the gate (and back on after it); bf16 input
    (K9 takes it on the card only), a conv with gradients and the gate
    unset keep the switch as it was. The output equals the ungated one bit
    for bit (no TF32 on the CPU)."""
    seen = []
    conv3d = F.conv3d
    monkeypatch.setattr(F, "conv3d", lambda *a, **k: seen.append(
        torch.backends.cudnn.allow_tf32) or conv3d(*a, **k))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    if what != "unset":
        monkeypatch.setenv("MEDSEG_WINOGRAD", "1")
    x, w = _case(16, 8, (1, 8, 8, 8), seed=5)
    conv = _conv(w)
    xt = torch.from_numpy(x)
    if what == "bf16":
        xt = xt.bfloat16()
    assert convgrad.exact_fp32_eligible(xt) == (what in ("fp32", "gradients"))
    with torch.set_grad_enabled(what == "gradients"):
        got = conv(xt)
        monkeypatch.delenv("MEDSEG_WINOGRAD", raising=False)
        want = conv(xt)
    assert seen == [what != "fp32", True]
    assert torch.backends.cudnn.allow_tf32
    assert torch.equal(got, want)
