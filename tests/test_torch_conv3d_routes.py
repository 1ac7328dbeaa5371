"""Kernel K10's two routes and its weight layout, on the CPU.

The route picker (tensor cores for bf16 and fp16, CUDA cores for fp32), the
block widths along Co, the tensor-core weight layout against its index
formula, the dtype and route codes the wrapper hands the C entry point and
counts, a failed launch raising instead of taking the plain version, and the
weight gradient of ``conv3x3x3`` reaching K5's launch at 8 input channels
while the models' rule (``dw27_applicable``) still says no below 16; a fake
library stands in for the built one. Then K10's plain version in bf16 and
fp16 against the JAX package's ``_conv_fwd`` in interpret mode. The card
tests are in ``tests/test_torch_conv3d_cuda.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import medicalsemseg_tpu.ops.pallas.conv3d as pc

from medicalsemseg_tpu_torch.ops import convgrad
from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import conv3d as k10
from medicalsemseg_tpu_torch.ops.kernels import dw27 as k5

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
# the dtype codes of csrc/common.cuh
CODES = {BF16: 0, F16: 1, F32: 2}


@pytest.mark.parametrize("dtype,route", [
    (BF16, "tensor_core"), (F16, "tensor_core"), (F32, "cuda_core")])
def test_route_picker(dtype, route):
    assert k10.conv_route(dtype) == route


@pytest.mark.parametrize("co,n,nz", [
    (8, 16, 1), (16, 16, 1), (24, 32, 1), (48, 48, 1), (56, 64, 1),
    (80, 96, 1), (96, 96, 1), (128, 128, 1), (144, 96, 2), (256, 128, 2),
    (300, 128, 3)])
def test_block_width(co, n, nz):
    assert k10.block_width(co) == (n, nz)
    assert n in k10.BLOCK_WIDTHS and n * nz >= co


def _w(co, c, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(co, c, 3, 3, 3, generator=g)


@pytest.mark.parametrize("co", [8, 24, 48, 96, 128])
@pytest.mark.parametrize("c", [8, 16, 48, 96])
def test_kernel_weights_index_formula(c, co):
    w = _w(co, c)
    n, nz = k10.block_width(co)
    got = k10.kernel_weights(w, n)
    cp = -(-c // 16) * 16
    assert got.shape == (nz, 27 * cp * n) and got.is_contiguous()
    wt = w.reshape(co, c, 27)
    want = torch.zeros_like(got)
    for c0 in range(0, cp, 48):
        nks = min(48, cp - c0) // 16
        for ks in range(nks):
            for half in range(2):
                for e in range(8):
                    ci = c0 + 16 * ks + 8 * half + e
                    if ci >= c:
                        continue
                    for z in range(nz):
                        j = torch.arange(n)
                        ok = z * n + j < co
                        for tap in range(27):
                            off = (27 * c0 * n + tap * nks * 16 * n
                                   + ks * 16 * n + half * 8 * n + e)
                            want[z, off + 8 * j[ok]] = wt[z * n + j[ok], ci, tap]
    assert torch.equal(got, want)


class _FakeEntry:
    """A C entry point: remembers its arguments, returns ``err``."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


class _FakeLibrary:
    def __init__(self, err):
        self.medseg_conv3x3x3 = _FakeEntry(err)
        self.medseg_dw27 = _FakeEntry(err)

    def medseg_cuda_error_string(self, err):
        return b"launch refused"


@pytest.fixture
def fake_lib(monkeypatch):
    """The wrappers' launch paths on CPU tensors, with a library whose entry
    points return ``lib.err``; the plain versions must not be reached."""
    lib = _FakeLibrary(0)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(kernels, "resident_blocks", lambda dev: 8)

    def no_plain(*a, **k):
        raise AssertionError("a launch path took the plain version")

    monkeypatch.setattr(k10, "conv3x3x3_plain", no_plain)
    monkeypatch.setattr(k5, "dw27_plain", no_plain)
    return lib


def _x(dtype, c, shape=(1, 3, 5, 7)):
    return torch.zeros(*shape, c, dtype=dtype)


@pytest.mark.parametrize("dtype,route", [
    (BF16, "tensor_core"), (F16, "tensor_core"), (F32, "cuda_core")])
@pytest.mark.parametrize("c,co", [(8, 24), (40, 144), (5, 7)])
def test_wrapper_hands_over_and_counts_the_route(fake_lib, dtype, route, c,
                                                 co):
    x, w = _x(dtype, c), _w(co, c).to(dtype)
    before, routes = kernels.launches("K10"), dict(kernels.routes("K10"))
    y = k10._launch(x, w)
    assert y.shape == (1, 3, 5, 7, co) and y.dtype == dtype
    args = fake_lib.medseg_conv3x3x3.calls[-1]
    assert args[3:9] == (1, 3, 5, 7, c, co)
    cp, n, code, rcode = args[9:13]
    assert (code, rcode) == (CODES[dtype], kernels.ROUTES[route])
    if route == "tensor_core":
        assert cp == -(-c // 16) * 16 and n == k10.block_width(co)[0]
    else:
        assert (cp, n) == (c, co)
    assert kernels.launches("K10") == before + 1
    want = dict(routes)
    want[route] += 1
    assert kernels.routes("K10") == want


@pytest.mark.parametrize("dtype", [BF16, F16, F32])
def test_a_failed_launch_raises_and_counts_nothing(fake_lib, dtype):
    fake_lib.medseg_conv3x3x3.err = 1
    before, routes = kernels.launches("K10"), dict(kernels.routes("K10"))
    with pytest.raises(RuntimeError, match="launch refused"):
        k10._launch(_x(dtype, 16), _w(16, 16).to(dtype))
    assert len(fake_lib.medseg_conv3x3x3.calls) == 1
    assert (kernels.launches("K10"), kernels.routes("K10")) == (before, routes)


def test_float64_raises(fake_lib):
    with pytest.raises(ValueError, match="float64"):
        k10._launch(_x(torch.float64, 16), _w(16, 16).double())
    assert fake_lib.medseg_conv3x3x3.calls == []


@pytest.mark.parametrize("dtype,k5_route", [(BF16, 2), (F16, 3), (F32, 0)])
def test_conv3x3x3_dw_at_8_channels_reaches_k5(fake_lib, monkeypatch, dtype,
                                               k5_route):
    """Forward and dx are K10 launches and dW one K5 launch at C = 8 (the
    tensor cores take bf16 with channels in 8s), while the models' rule
    keeps K5 off convolutions below 16 input channels."""
    monkeypatch.setattr(k10, "conv3x3x3_fwd", k10._launch)
    monkeypatch.setattr(k5, "dw27", k5._launch)
    x = _x(dtype, 8).requires_grad_(True)
    w = _w(16, 8).to(dtype).requires_grad_(True)
    before = (kernels.launches("K10"), kernels.launches("K5"))
    y = k10.conv3x3x3(x, w)
    dx, dw = torch.autograd.grad(y, (x, w), torch.zeros_like(y))
    assert (kernels.launches("K10") - before[0],
            kernels.launches("K5") - before[1]) == (2, 1)
    assert dx.shape == x.shape and dw.shape == w.shape and dw.dtype == dtype
    conv_calls = fake_lib.medseg_conv3x3x3.calls
    assert [a[7:9] for a in conv_calls] == [(8, 16), (16, 8)]
    (k5_args,) = fake_lib.medseg_dw27.calls
    assert k5_args[8:10] == (8, 16) and k5_args[11] == k5_route
    assert not k5.dw27_applicable((3, 5, 7), 8)
    assert k5.dw27_applicable((3, 5, 7), 16)
    monkeypatch.setenv("MEDSEG_DW27_PALLAS", "1")
    assert not convgrad.dw27_eligible((1, 3, 5, 7, 8))
    assert convgrad.dw27_eligible((1, 3, 5, 7, 16))


# K10's plain version against the Pallas forward in interpret mode, both in
# the working dtype: products of the inputs as they are and sums in fp32 on
# both sides, so they differ only where a differently ordered fp32 sum flips
# the one rounding to the dtype: one ulp, at most 2^-7 of |y| in bf16 and
# 2^-10 in fp16 (measured: 1 and 19 of 18,432 outputs one ulp apart). The
# tolerances allow two ulps, the same amount as a floor for outputs near 0.
PARITY_TOL = {BF16: (2 ** -6, 2 ** -6), F16: (2 ** -9, 2 ** -9)}
JNP = {BF16: jnp.bfloat16, F16: jnp.float16}


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setattr(pc, "_INTERPRET", True)


@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("shape,co", [((1, 4, 8, 8, 8), 8),
                                      ((2, 3, 16, 8, 16), 24)])
def test_plain_matches_the_pallas_forward(_interpret, dtype, shape, co):
    rng = np.random.default_rng(11)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, shape[-1], co)) * 0.2).astype(np.float32)
    want = np.asarray(pc.conv3x3x3(jnp.asarray(x, JNP[dtype]),
                                   jnp.asarray(w, JNP[dtype]))
                      .astype(jnp.float32))
    xt = torch.from_numpy(x).to(dtype)
    wt = torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()).to(dtype)
    got = k10.conv3x3x3_plain(xt, wt)
    assert got.dtype == dtype
    rtol, atol = PARITY_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)
