"""K7's CUDA-core route with K and V streamed through shared memory in key
chunks (``csrc/sr_attention.cu`` sr_attention_kernel, planned by
``sr_cc_plan`` in the same file).

On the card (``cuda`` marker, skipped elsewhere: ``python -m pytest
--noconftest -m cuda tests/test_torch_sr_attention_stream.py``): the route
against ``sr_attention_plain`` at C = 48 and 384 for M = 1 .. 512 reduced
keys (one chunk, several, and a ragged last one), in bf16, fp16 and fp32,
with and without the q bias and the shortcut, a rerun bit-equal; the
widest SegFormer3D stage at hidden 96 (C = 768); and the plan's shared
memory, as the library counts it, within the card's limit for every
SegFormer3D width and M up to 512.

The tolerances are those of ``tests/test_torch_sr_attention_tc.py``
(elementwise |got - want| <= tol + tol |want|): streaming changes only the
order of the softmax's fp32 sum, so it flips at most a rounding of p or of
the output.
"""

import pytest
import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
TOL = {BF16: 3e-2, F16: 4e-3, F32: 1e-4}
DTYPES = [BF16, F16, F32]
IDS = ["bf16", "fp16", "fp32"]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(11)


def _case(gen, b, n, c, nh, m, dtype, bq=True, res=True):
    def act(rows):
        return torch.randn(b, rows, c, generator=gen,
                           device="cuda").to(dtype)

    x = act(n)
    s = c ** -0.5
    return x, dict(
        k=act(m), v=act(m),
        wq=(torch.randn(c, c, generator=gen, device="cuda") * s).to(dtype),
        bq=(torch.randn(c, generator=gen, device="cuda") * 0.1
            if bq else None),
        wproj=(torch.randn(c, c, generator=gen, device="cuda") * s).to(dtype),
        bproj=torch.randn(c, generator=gen, device="cuda") * 0.1,
        num_heads=nh, residual=act(n) if res else None)


def _close(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= tol + tol * w.abs()).all(), (g - w).abs().max()


def _stream(x, a):
    by = ksr.route_launches["cuda_core"]
    got = ksr.sr_attention(x, **a, route="cuda_core")
    torch.cuda.synchronize()
    assert ksr.route_launches["cuda_core"] == by + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("bq,res", [(False, False), (True, False),
                                    (False, True), (True, True)])
@pytest.mark.parametrize("m", [1, 27, 64, 65, 125, 216, 512])
@pytest.mark.parametrize("c,nh", [(48, 3), (384, 24)])
def test_streaming_route_against_plain(gen, c, nh, m, bq, res, dtype):
    x, a = _case(gen, 2, 100, c, nh, m, dtype, bq, res)
    got = _stream(x, a)
    _close(got, ksr.sr_attention_plain(x, **a), TOL[dtype])
    assert torch.equal(got, _stream(x, a))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("m", [27, 125, 216])
def test_streaming_route_at_hidden_96(gen, m, dtype):
    """SegFormer3D's stage 4 at --hidden_dim 96: C = 768, head dim 32."""
    x, a = _case(gen, 2, 27, 768, 24, m, dtype)
    _close(_stream(x, a), ksr.sr_attention_plain(x, **a), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("c,nh", [(48, 3), (96, 6), (192, 12), (384, 24),
                                  (768, 24), (24, 3), (192, 8)])
def test_plan_fits_the_card(gen, c, nh, dtype):
    lib = kernels.load()
    code = kernels.dtype_code("x", dtype)
    for m in (1, 8, 27, 64, 65, 125, 216, 512):
        smem = lib.medseg_sr_attention_smem_bytes(m, c, nh, code)
        assert 0 < smem <= kernels.MAX_SMEM_BYTES, (m, smem)
