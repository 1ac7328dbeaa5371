"""K2's and K4's CUDA-core routes at widths up to 768 (``csrc/mlp.cu``:
above 512 the output columns come in tiles, each computing fc1 again;
``csrc/mlp_bwd.cu``: above 384 tiles of 16 token rows).

On the CPU: ``fused_mlp_supported`` for the widths and dtypes of the sweep.
On the card (``cuda`` marker: ``python -m pytest --noconftest -m cuda
tests/test_torch_mlp_wide.py``): K2's route forced at C = Co = 768 (the
flagship's stage 4 at --hidden_dim 96, ViT-B) and at 640 (not a power of
two), in fp32, bf16 and fp16, with and without the LayerNorm and the
shortcut, against ``fused_mlp_plain`` at the tolerances of
``tests/test_torch_kernels_cuda.py`` (bf16 3e-2, fp16 4e-3, fp32 1e-4,
elementwise |got - want| <= tol + tol |want|); a rerun bit-equal. K4 at the
same widths against ``fused_mlp_bwd_plain`` with that file's gradient rule
(error norm and largest error against the reference's norm and largest
element: bf16 1e-2 / 5e-2, fp16 2e-3 / 1e-2, fp32 1e-5 / 1e-4), a rerun
bit-equal.
"""

import pytest
import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import mlp as kmlp

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
TOL = {BF16: 3e-2, F16: 4e-3, F32: 1e-4}
GRAD_TOL = {BF16: (1e-2, 5e-2), F16: (2e-3, 1e-2), F32: (1e-5, 1e-4)}


@pytest.mark.parametrize("dtype", [BF16, F16, F32])
@pytest.mark.parametrize("c,co,hidden,train,want", [
    (48, 48, 192, True, True),
    (384, 384, 1536, True, True),      # K4 takes the flagship's stage 4
    (768, 768, 3072, False, True),     # K2 at hidden 96, both routes
    (768, 768, 3072, True, True),      # K4's CUDA cores at hidden 96
    (768, 768, 2304, False, True),     # GC-ViT's MLP (3C) at hidden 96
    (24, 24, 96, True, True),          # hidden 24: the CUDA cores
    (896, 896, 3584, False, False),    # past every route
    (48, 96, 192, True, False),        # K4 needs Co == C
])
def test_fused_mlp_supported(c, co, hidden, train, want, dtype):
    assert kmlp.fused_mlp_supported(dtype, c, co, hidden, train) is want


def test_fused_mlp_supported_refuses_float64():
    assert not kmlp.fused_mlp_supported(torch.float64, 48, 48, 192)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16, F16], ids=["fp32", "bf16",
                                                          "fp16"])
@pytest.mark.parametrize("ln_res", [True, False])
@pytest.mark.parametrize("c", [768, 640])
def test_cuda_core_route_at_wide_widths(gen, c, ln_res, dtype):
    m, hidden = 200, 4 * c
    x = torch.randn(m, c, generator=gen, device="cuda").to(dtype)
    s1, s2 = c ** -0.5, hidden ** -0.5
    a = dict(w1=(torch.randn(hidden, c, generator=gen, device="cuda")
                 * s1).to(dtype),
             b1=torch.randn(hidden, generator=gen, device="cuda") * 0.1,
             w2=(torch.randn(c, hidden, generator=gen, device="cuda")
                 * s2).to(dtype),
             b2=torch.randn(c, generator=gen, device="cuda") * 0.1)
    kw = dict(residual=ln_res, ln=(torch.stack([
        1 + 0.3 * torch.randn(c, generator=gen, device="cuda"),
        0.1 * torch.randn(c, generator=gen, device="cuda")])
        if ln_res else None))
    by = kernels.routes("K2")["cuda_core"]
    got = kmlp.fused_mlp(x, **a, **kw, route="cuda_core")
    torch.cuda.synchronize()
    assert kernels.routes("K2")["cuda_core"] == by + 1
    want = kmlp.fused_mlp_plain(x, **a, **kw)
    g, w = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(g).all()
    tol = TOL[dtype]
    assert ((g - w).abs() <= tol + tol * w.abs()).all(), (g - w).abs().max()
    assert torch.equal(got, kmlp.fused_mlp(x, **a, **kw, route="cuda_core"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16, F16], ids=["fp32", "bf16",
                                                          "fp16"])
@pytest.mark.parametrize("m,c,res", [(300, 768, True), (70, 640, False),
                                     (33, 400, True)])
def test_backward_at_wide_widths(gen, m, c, res, dtype):
    """K4 above C = 384: the CUDA-core route with 16-row tiles."""
    x = torch.randn(m, c, generator=gen, device="cuda").to(dtype)
    a = dict(w1=(torch.randn(4 * c, c, generator=gen, device="cuda")
                 * c ** -0.5).to(dtype),
             b1=torch.randn(4 * c, generator=gen, device="cuda") * 0.1,
             w2=(torch.randn(c, 4 * c, generator=gen, device="cuda")
                 * (4 * c) ** -0.5).to(dtype),
             ln=torch.stack([
                 1 + 0.3 * torch.randn(c, generator=gen, device="cuda"),
                 0.1 * torch.randn(c, generator=gen, device="cuda")]),
             dy=torch.randn(m, c, generator=gen, device="cuda").to(dtype),
             residual=res)
    by = kernels.routes("K4")["cuda_core"]
    got = kmlp.fused_mlp_bwd(x, **a)
    torch.cuda.synchronize()
    assert kernels.routes("K4")["cuda_core"] == by + 1
    norm_tol, max_tol = GRAD_TOL[dtype]
    for g, w in zip(got, kmlp.fused_mlp_bwd_plain(x, **a)):
        assert g.shape == w.shape and g.dtype == w.dtype
        gf, wf = g.float(), w.float()
        assert torch.isfinite(gf).all()
        assert (gf - wf).norm() <= norm_tol * wf.norm()
        assert (gf - wf).abs().max() <= max_tol * wf.abs().max()
    for g, again in zip(got, kmlp.fused_mlp_bwd(x, **a)):
        assert torch.equal(g, again)
