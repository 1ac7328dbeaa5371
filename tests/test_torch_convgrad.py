"""The port's ``Conv3x3x3Fn`` (3^3 / stride-1 / SAME conv whose weight
gradient can take kernel K5, and whose forward and input gradient can take
kernel K9) against ``jax.grad`` of the JAX package's ``conv3x3x3_s1`` on the
CPU, and the gates that route them (``MEDSEG_DW27_PALLAS``,
``MEDSEG_WINOGRAD``, ``MEDSEG_WINOGRAD_TRAIN``).

The JAX side runs its Pallas dW kernel in interpret mode
(``dw27._FORCE_INTERPRET``, ``MEDSEG_DW27_PALLAS=1``), the port its plain
version. fp32 on both sides over 2 x 4 x 8 x 8 voxels: sums in another order
agree to a few fp32 ulps of the largest sum.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from medicalsemseg_tpu.ops import convgrad as jax_convgrad
from medicalsemseg_tpu.ops.pallas import dw27 as jax_dw27
from medicalsemseg_tpu.ops.pallas import winograd3d as jax_k9

from medicalsemseg_tpu_torch.models.layers import Conv3d
from medicalsemseg_tpu_torch.ops import convgrad
from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5
from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

RTOL, ATOL = 2e-5, 2e-4


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jax_dw27, "_FORCE_INTERPRET", True)


def _case(seed, shape=(2, 4, 8, 8), cin=16, cout=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)                                   # JAX layout (k, k, k, I, O)
    dy = rng.normal(size=(*shape, cout)).astype(np.float32)
    return x, w, dy


def _port(x, w, dy, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()).to(
        dtype).requires_grad_(True)                   # torch layout (O, I, k, k, k)
    y = convgrad.Conv3x3x3Fn.apply(xt, wt)
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy).to(dtype))
    return y.detach(), gx, gw


@pytest.mark.parametrize("mode", ["1", "0"])
def test_forward_dx_dw_match_jax(interpret, monkeypatch, mode):
    """mode 1: K5's plain version against the Pallas kernel in interpret
    mode; mode 0: the library's weight gradient against XLA's taps."""
    monkeypatch.setenv("MEDSEG_DW27_PALLAS", mode)
    x, w, dy = _case(0)
    assert jax_convgrad._dw27_pallas_eligible(jnp.asarray(x)) == (mode == "1")
    assert convgrad.dw27_eligible(x.shape) == (mode == "1")
    y, vjp = jax.vjp(jax_convgrad.conv3x3x3_s1, jnp.asarray(x), jnp.asarray(w))
    want_gx, want_gw = vjp(jnp.asarray(dy))

    before = []
    monkeypatch.setattr(k5, "dw27", lambda *a: before.append(1)
                        or k5.dw27_plain(*a))
    got_y, got_gx, got_gw = _port(x, w, dy)
    assert len(before) == (1 if mode == "1" else 0)   # the route taken
    np.testing.assert_allclose(got_y.numpy(), np.asarray(y), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_gx.numpy(), np.asarray(want_gx), rtol=RTOL,
                               atol=ATOL)
    assert got_gw.shape == (8, 16, 3, 3, 3)
    np.testing.assert_allclose(got_gw.numpy().transpose(2, 3, 4, 1, 0),
                               np.asarray(want_gw), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batch", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", [None, "auto", "1", "0"])
def test_gate_matches_the_jax_gate(interpret, monkeypatch, mode, batch):
    """The voxel window (1.5M, 4M] of auto mode opens at batch 2 to 4 of a
    96^3 crop; computed from shapes only."""
    if mode is None:
        monkeypatch.delenv("MEDSEG_DW27_PALLAS", raising=False)
    else:
        monkeypatch.setenv("MEDSEG_DW27_PALLAS", mode)
    for cin in (48, 96, 1):
        shape = (batch, 96, 96, 96, cin)
        want = jax_convgrad._dw27_pallas_eligible(
            jax.ShapeDtypeStruct(shape, jnp.bfloat16))
        assert convgrad.dw27_eligible(shape) == want, (mode, shape)
    auto_open = batch in (2, 4)
    expect = {None: auto_open, "auto": auto_open, "1": True, "0": False}[mode]
    assert convgrad.dw27_eligible((batch, 96, 96, 96, 48)) == expect
    assert not convgrad.dw27_eligible((batch, 96, 96, 96, 1))
    # half-resolution features never reach the window at these batches
    assert convgrad.dw27_eligible((batch, 48, 48, 48, 48)) == (mode == "1")


def test_gate_is_read_at_call_time(monkeypatch):
    shape = (2, 4, 8, 8, 16)
    monkeypatch.setenv("MEDSEG_DW27_PALLAS", "1")
    assert convgrad.dw27_eligible(shape)
    monkeypatch.setenv("MEDSEG_DW27_PALLAS", "0")
    assert not convgrad.dw27_eligible(shape)
    monkeypatch.setenv("MEDSEG_DW27_PALLAS", "auto")
    assert not convgrad.dw27_eligible(shape)          # 512 voxels


def test_conv3d_takes_the_function_only_with_gradients(monkeypatch):
    monkeypatch.setenv("MEDSEG_DW27_PALLAS", "1")
    x, w, _ = _case(1)
    xt = torch.from_numpy(x)
    conv = Conv3d(16, 8, 3, bias=True)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()))
        conv.bias.normal_(generator=torch.Generator().manual_seed(0))
    y = conv(xt)
    assert type(y.grad_fn).__name__ == "AddBackward0"           # + bias
    assert "Conv3x3x3Fn" in type(y.grad_fn.next_functions[0][0]).__name__
    with torch.no_grad():
        y0 = conv(xt)
    with torch.inference_mode():
        y1 = conv(xt)
    assert y0.grad_fn is None and torch.equal(y0, y1)
    np.testing.assert_allclose(y.detach().numpy(), y0.numpy(), rtol=1e-6,
                               atol=1e-6)
    # other shapes keep the library's conv: stride 2, kernel 1, no SAME padding
    for other in (Conv3d(16, 8, 3, stride=2), Conv3d(16, 8, 1),
                  Conv3d(16, 8, 3, padding=0)):
        torch.nn.init.normal_(other.weight)
        assert "Conv3x3x3Fn" not in repr(other(xt).grad_fn)
    # the weight gradient through the module equals the function's
    calls = []
    monkeypatch.setattr(k5, "dw27", lambda *a: calls.append(1)
                        or k5.dw27_plain(*a))
    y.square().sum().backward()
    assert calls == [1] and conv.weight.grad.shape == conv.weight.shape


def test_dw_is_rounded_to_the_weights_dtype(monkeypatch):
    """A bf16 model's dW is the fp32 sum rounded to bf16 once, as the JAX
    backward rounds it (`dw.astype(w.dtype)`)."""
    monkeypatch.setenv("MEDSEG_DW27_PALLAS", "1")
    x, w, dy = _case(2)
    _, gx, gw = _port(x, w, dy, torch.bfloat16)
    assert gx.dtype == gw.dtype == torch.bfloat16
    xb = torch.from_numpy(x).bfloat16()
    dyb = torch.from_numpy(dy).bfloat16()
    want = k5.dw27_plain(xb, dyb).permute(4, 3, 0, 1, 2).bfloat16()
    assert torch.equal(gw, want)
    conv = Conv3d(16, 8, 3, bias=False)          # fp32 parameter, bf16 compute
    torch.nn.init.normal_(conv.weight, std=0.05)
    conv(xb).backward(dyb)
    assert conv.weight.grad.dtype == torch.float32
    assert torch.equal(conv.weight.grad, conv.weight.grad.bfloat16().float())


def _count_k9(monkeypatch):
    calls = []
    plain = k9.winograd_conv3d_f23_plain
    monkeypatch.setattr(k9, "winograd_conv3d_f23",
                        lambda x, w, **kw: calls.append(tuple(x.shape))
                        or plain(x, w, **kw))
    return calls


def test_winograd_gate_routes_the_no_gradient_conv(monkeypatch):
    """MEDSEG_WINOGRAD=1: without gradients a bf16 conv inside the channel
    window runs K9 (its plain version here); fp32 keeps the library's conv,
    without TF32, which changes nothing on the CPU (its cases:
    ``tests/test_torch_winograd_f43.py``); with gradients, and with the gate
    unset, nothing changes."""
    monkeypatch.setattr(k9, "ALLOW_CPU", True)
    x, w, _ = _case(3, shape=(1, 4, 6, 8))
    conv = Conv3d(16, 8, 3, bias=True)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()))
        conv.bias.normal_(generator=torch.Generator().manual_seed(1))
    xb = torch.from_numpy(x).bfloat16()
    calls = _count_k9(monkeypatch)
    with torch.no_grad():
        monkeypatch.delenv("MEDSEG_WINOGRAD", raising=False)
        lib_bf16, lib_fp32 = conv(xb), conv(torch.from_numpy(x))
        assert calls == []
        monkeypatch.setenv("MEDSEG_WINOGRAD", "1")
        got_bf16, got_fp32 = conv(xb), conv(torch.from_numpy(x))
    assert calls == [(1, 4, 6, 8, 16)]
    assert torch.equal(got_fp32, lib_fp32)
    want = k9.winograd_conv3d_f23_plain(xb, conv.weight.bfloat16()) \
        + conv.bias.bfloat16()
    assert torch.equal(got_bf16, want)
    scale = float(lib_fp32.abs().max())
    # bf16 Winograd against the bf16 library conv: both within a bf16
    # rounding or two of the fp32 result
    assert float((got_bf16.float() - lib_bf16.float()).abs().max()) <= 3e-2 * scale
    assert "Conv3x3x3Fn" in repr(conv(xb).grad_fn.next_functions[0][0])
    assert len(calls) == 1                  # gradients on: the train gate's
    # outside the channel window (1 input channel), and on a CPU tensor
    # without the tests' hook, the gate stays shut
    assert not convgrad.winograd_infer_eligible(torch.zeros(
        1, 4, 4, 4, 1, dtype=torch.bfloat16))
    monkeypatch.setattr(k9, "ALLOW_CPU", False)
    assert not convgrad.winograd_infer_eligible(xb)


def test_winograd_train_gate_matches_jax(monkeypatch):
    """MEDSEG_WINOGRAD_TRAIN=1: the forward value and dx run K9 (plain here,
    the Pallas kernel in interpret mode in the JAX package), dW keeps its
    route. bf16; value, dx and dW against ``jax.value_and_grad`` of
    ``conv3x3x3_s1`` at the JAX package's own limits (3e-2 of the max)."""
    monkeypatch.setattr(jax_convgrad, "_WINOGRAD_TRAIN", True)
    monkeypatch.setattr(jax_k9, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(k9, "ALLOW_CPU", True)
    monkeypatch.setenv("MEDSEG_WINOGRAD_TRAIN", "1")
    monkeypatch.setenv("MEDSEG_DW27_PALLAS", "0")
    rng = np.random.default_rng(12)
    x = rng.normal(size=(1, 8, 8, 16, 16)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 16, 32)) * 0.2).astype(np.float32)
    cot = rng.normal(size=(1, 8, 8, 16, 32)).astype(np.float32)
    xj, wj, cj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, cot))
    assert jax_convgrad._wino23_eligible(xj) and jax_convgrad._wino23_eligible(cj)

    want_v, (want_gx, want_gw) = jax.value_and_grad(
        lambda a, b: (jax_convgrad.conv3x3x3_s1(a, b).astype(jnp.float32)
                      * cj.astype(jnp.float32)).sum(), (0, 1))(xj, wj)

    calls = _count_k9(monkeypatch)
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    wt = torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()).bfloat16() \
        .requires_grad_(True)
    ct = torch.from_numpy(cot).bfloat16()
    y = convgrad.Conv3x3x3Fn.apply(xt, wt)
    value = (y.float() * ct.float()).sum()
    gx, gw = torch.autograd.grad(value, (xt, wt))
    # forward on x (16 channels), dx on dy (32 channels)
    assert calls == [(1, 8, 8, 16, 16), (1, 8, 8, 16, 32)]
    np.testing.assert_allclose(float(value.detach()), float(want_v), rtol=2e-2)
    for got, ref in ((gx.float().numpy(),
                      np.asarray(want_gx.astype(jnp.float32))),
                     (gw.float().numpy().transpose(2, 3, 4, 1, 0),
                      np.asarray(want_gw.astype(jnp.float32)))):
        np.testing.assert_allclose(got, ref, atol=3e-2 * np.abs(ref).max())
    # the same rounding points on both sides: dx is a bf16 ulp apart at most
    assert np.abs(gx.float().numpy() - np.asarray(
        want_gx.astype(jnp.float32))).max() <= 2 ** -7 * np.abs(
            np.asarray(want_gx.astype(jnp.float32))).max()

    # dx gates on dy's channels: 192 output channels are outside the window
    wide = torch.zeros(192, 16, 3, 3, 3, dtype=torch.bfloat16,
                       requires_grad=True)
    calls.clear()
    y = convgrad.Conv3x3x3Fn.apply(xt, wide)
    torch.autograd.grad(y.float().sum(), (xt, wide))
    assert calls == [(1, 8, 8, 16, 16)]
    # unset: the library's conv both ways
    monkeypatch.delenv("MEDSEG_WINOGRAD_TRAIN")
    calls.clear()
    torch.autograd.grad(convgrad.Conv3x3x3Fn.apply(xt, wt).float().sum(),
                        (xt, wt))
    assert calls == []
