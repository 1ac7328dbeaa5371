"""Kernel K9 in every dtype the JAX fused decoder runs it in, on the CPU.

The JAX decoder's gate checks no dtype and its Winograd kernel computes in
x's, so ``MEDSEG_FUSED_DECODER=1`` with ``--compute_dtype float16 |
float32`` runs K9 there. Here: the port's fused ``UnetResBlock`` in fp16
(K9's plain version under the hook ``winograd3d.ALLOW_CPU``) against the
JAX block under the gate with ``_FORCE_INTERPRET`` in fp16; the wrapper's
route by dtype; the gate's answer for a CUDA activation in each dtype; and
the codes, weights and counts the wrapper hands a stand-in library on each
route. The card tests are in ``tests/test_torch_kernels_cuda.py``.
"""

import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from medicalsemseg_tpu.models import decoders as jax_decoders
from medicalsemseg_tpu.ops.pallas import winograd3d as jax_k9

from medicalsemseg_tpu_torch.models import decoders
from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import winograd3d as k9

from tests.test_torch_fused_decoder import _block_params, _count_k9

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
# the dtype codes of csrc/common.cuh
CODES = {BF16: 0, F16: 1, F32: 2}
# the fused block in fp16 in both packages: the same rounding points inside
# K9, but the first conv, the statistics and the second InstanceNorm run in
# fp16 through XLA's and oneDNN's kernels, whose sums round in other orders;
# the outputs (O(1)) then differ by a few fp16 ulps (2^-10 relative)
F16_BLOCK_TOL = 1e-2


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("MEDSEG_FUSED_DECODER", "1")
    monkeypatch.setattr(k9, "ALLOW_CPU", True)
    monkeypatch.setattr(jax_k9, "_FORCE_INTERPRET", True)


def test_fused_block_in_fp16_matches_jax(fused, monkeypatch):
    in_ch, out_ch, shape = 17, 24, (2, 8, 8, 16)
    x = np.random.default_rng(31).normal(size=(*shape, in_ch)).astype(
        np.float32)
    blk, params, port = _block_params(in_ch, out_ch, x, seed=32)
    blk16 = jax_decoders.UnetResBlock(out_channels=out_ch, dtype=jnp.float16)
    x16 = x.astype(np.float16)
    want = np.asarray(blk16.apply({"params": params}, jnp.asarray(x16), True)
                      ).astype(np.float32)
    calls = _count_k9(monkeypatch)
    with torch.inference_mode():
        got = port(torch.from_numpy(x16))
    assert calls == [((*shape, out_ch), True)]
    assert got.dtype == F16 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=F16_BLOCK_TOL, atol=F16_BLOCK_TOL)


@pytest.mark.parametrize("dtype,route", [
    (BF16, "tensor_core"), (F16, "tensor_core"), (F32, "cuda_core")])
def test_route_by_dtype(dtype, route):
    assert k9.winograd_route(dtype) == route


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_other_dtypes_raise(dtype):
    with pytest.raises(ValueError, match="takes bfloat16, float16 or float32"):
        k9.winograd_route(dtype)


@pytest.mark.parametrize("dtype", [BF16, F16, F32])
def test_gate_opens_on_the_card_in_every_dtype(monkeypatch, dtype):
    """Through a stand-in for a CUDA activation (``is_cuda`` set): the gate
    is the environment alone, as in JAX; the shape and channel window is
    the block's."""
    x = types.SimpleNamespace(is_cuda=True, dtype=dtype)
    monkeypatch.setattr(k9, "ALLOW_CPU", False)
    monkeypatch.delenv("MEDSEG_FUSED_DECODER", raising=False)
    assert not decoders.decoder_fuse_enabled(x)
    monkeypatch.setenv("MEDSEG_FUSED_DECODER", "1")
    assert decoders.decoder_fuse_enabled(x)


class _FakeLibrary:
    """The C entry point: remembers its arguments, returns ``err``."""

    def __init__(self):
        self.err, self.calls = 0, []

    def medseg_winograd_f23(self, *args):
        self.calls.append(args)
        return self.err

    def medseg_cuda_error_string(self, err):
        return b"launch refused"


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    pointers = {}

    def ptr(t):
        if t is None:
            return None
        pointers[id(t)] = t
        return id(t)

    monkeypatch.setattr(kernels, "ptr", ptr)
    lib.tensors = pointers

    def no_plain(*a, **k):
        raise AssertionError("a launch path took the plain version")

    monkeypatch.setattr(k9, "winograd_conv3d_f23_plain", no_plain)
    return lib


@pytest.mark.parametrize("dtype,route", [
    (BF16, "tensor_core"), (F16, "tensor_core"), (F32, "cuda_core")])
@pytest.mark.parametrize("c,co,with_ep", [(16, 24, False), (50, 127, True)])
def test_launch_hands_over_codes_weights_and_counts(fake_lib, dtype, route,
                                                    c, co, with_ep):
    gen = torch.Generator().manual_seed(c)
    x = torch.zeros(2, 3, 5, 7, c, dtype=dtype)
    w = torch.randn(co, c, 3, 3, 3, generator=gen).to(dtype)
    ep = ((torch.ones(2, c), torch.zeros(2, c)) if with_ep else None)
    before, routes = kernels.launches("K9"), dict(kernels.routes("K9"))
    y = k9._launch(x, w, ep, True, 0.01)
    assert y.shape == (2, 3, 5, 7, co) and y.dtype == dtype
    args = fake_lib.calls[-1]
    assert args[4:10] == (2, 3, 5, 7, c, co)
    cp, cop, lrelu, slope, code, rcode = args[10:16]
    assert (lrelu, slope, code, rcode) == (1, 0.01, CODES[dtype],
                                           kernels.ROUTES[route])
    u = fake_lib.tensors[args[1]]
    assert u.dtype == dtype and u.is_contiguous()
    ref = k9.transform_weights_f23(w)               # (64, C, Co) fp32
    if route == "tensor_core":
        k = k9.CHUNK_CHANNELS
        assert (cp, cop) == (-(-c // k) * k, -(-co // k) * k)
        assert torch.equal(u, k9.kernel_weights_f23(
            ref.transpose(1, 2).to(dtype)))
    else:
        assert (cp, cop) == (c, co)
        assert torch.equal(u, ref)
    assert (args[2] is None) == (not with_ep)
    assert kernels.launches("K9") == before + 1
    want = dict(routes)
    want[route] += 1
    assert kernels.routes("K9") == want


def test_a_failed_launch_raises_and_counts_nothing(fake_lib):
    fake_lib.err = 1
    before, routes = kernels.launches("K9"), dict(kernels.routes("K9"))
    with pytest.raises(RuntimeError, match="launch refused"):
        k9._launch(torch.zeros(1, 2, 2, 2, 16), torch.zeros(16, 16, 3, 3, 3),
                   None, False, 0.01)
    assert (kernels.launches("K9"), kernels.routes("K9")) == (before, routes)


def test_float64_raises_before_any_launch(fake_lib):
    with pytest.raises(ValueError, match="float64"):
        k9._launch(torch.zeros(1, 2, 2, 2, 16, dtype=torch.float64),
                   torch.zeros(16, 16, 3, 3, 3, dtype=torch.float64), None,
                   False, 0.01)
    assert fake_lib.calls == []
