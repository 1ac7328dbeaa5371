"""MONAI's per-axis windows in the port: the window arithmetic against the
JAX package's, the plain K1's shift mask at any per-axis window and shift
(0 on some axes included), and the fused official blocks against the JAX
ones in Pallas interpret mode.

On the CPU the K1 wrapper runs its plain version, whose mask comes from the
port's copy of MONAI's region-id ``compute_mask``
(``ops.window._official_attn_mask``, also the flagship's unfused blocks'
mask); it must equal the JAX package's mask, the cubic mask where both
apply, and the mask the CUDA kernel derives from
each token's position (``token_label`` in ``csrc/common.cuh``, re-written
here). The port's ``SwinViTOfficial`` with the kernels on, in eval mode,
runs the plain K1 on the three routes of the JAX block (absorbed, padded,
clamped per-axis windows with zeroed shifts) against JAX
``SwinViTOfficial(use_pallas=True)`` with the Pallas kernels in interpret
mode, fp32 both: every hidden state within 1e-4 of its largest value.
On the card (``--noconftest -m cuda``) K1 at 343-token windows on a padded
grid and at a clamped anisotropic window against its plain version; JAX is
imported inside the tests that use it.
"""

import numpy as np
import pytest
import torch

from medicalsemseg_tpu_torch.ops import window as tw
from medicalsemseg_tpu_torch.ops.kernels import window_attention as kwa

# fp32, sums in other orders through two stages of attention and merging
TOL = 1e-4

# (grid dims, window, shift): cubic, anisotropic, zero shift on some axes,
# MONAI's 7^3 window on a padded grid, a one-window axis
MASK_CASES = [
    ((8, 8, 8), (2, 2, 2), (1, 1, 1)),
    ((12, 12, 12), (6, 6, 6), (3, 3, 3)),
    ((4, 8, 8), (4, 2, 2), (0, 1, 1)),
    ((2, 4, 4), (2, 2, 2), (0, 1, 1)),
    ((14, 14, 6), (7, 7, 6), (3, 3, 0)),
    ((21, 21, 21), (7, 7, 7), (3, 3, 3)),
    ((6, 12, 9), (3, 4, 3), (1, 2, 0)),
    ((8, 6, 4), (4, 3, 2), (0, 0, 1)),
]


@pytest.mark.parametrize("dims,ws,ss", MASK_CASES)
def test_official_mask_matches_jax(dims, ws, ss):
    from medicalsemseg_tpu.models import swin_official as jso

    np.testing.assert_array_equal(tw._official_attn_mask(dims, ws, ss),
                                  jso._official_attn_mask(dims, ws, ss))


@pytest.mark.parametrize("window", [(7, 7, 7), (6, 6, 6), (4, 2, 2),
                                    (2, 3, 4)])
def test_full_window_index_matches_jax(window):
    from medicalsemseg_tpu.models import swin_official as jso

    np.testing.assert_array_equal(tw._full_window_index(window),
                                  jso._full_window_index(window))


@pytest.mark.parametrize("size,window,shift", [
    ((48, 48, 48), (7, 7, 7), (3, 3, 3)),
    ((6, 6, 6), (7, 7, 7), (3, 3, 3)),
    ((2, 4, 4), (4, 2, 2), (2, 1, 1)),
    ((3, 8, 7), (4, 4, 7), (2, 2, 3)),
])
def test_resolve_window_official_matches_jax(size, window, shift):
    from medicalsemseg_tpu.models import swin_official as jso

    assert (tw.resolve_window_official(size, window, shift)
            == jso.resolve_window_official(size, window, shift))


@pytest.mark.parametrize("dims,w,s", [((8, 8, 8), 2, 1), ((12, 12, 12), 6, 3),
                                      ((18, 12, 6), 6, 3)])
def test_official_mask_equals_the_cubic_mask(dims, w, s):
    """At a cubic window and shift it is the flagship's SW-MSA mask (the
    JAX package's ``_shift_mask_np``); ``shift_mask`` takes either form."""
    from medicalsemseg_tpu.ops import window as jw

    want = jw._shift_mask_np(dims, w, s)
    np.testing.assert_array_equal(
        tw._official_attn_mask(dims, (w,) * 3, (s,) * 3), want)
    np.testing.assert_array_equal(
        tw.shift_mask(dims, w, s, torch.device("cpu")).numpy(), want)


def _kernel_mask(dims, ws, ss):
    """The mask K1 applies (csrc/window_attention.cu with csrc/common.cuh's
    ``region`` / ``token_label``): a token's label along an axis is 0
    outside the last window, and in it 1 before ws - ss, 2 from there."""
    grid = [d // w for d, w in zip(dims, ws)]
    n = ws[0] * ws[1] * ws[2]
    t = np.arange(n)
    pos = (t // (ws[1] * ws[2]), (t // ws[2]) % ws[1], t % ws[2])
    out = []
    for i in range(grid[0]):
        for j in range(grid[1]):
            for k in range(grid[2]):
                lab = np.zeros(n, np.int64)
                for p, last, w, s in zip(pos, (i == grid[0] - 1,
                                               j == grid[1] - 1,
                                               k == grid[2] - 1), ws, ss):
                    region = np.where(p < w - s, 1, 2) if last else 0
                    lab = lab * 3 + region
                out.append(np.where(lab[None, :] != lab[:, None], -100.0,
                                    0.0))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("dims,ws,ss", MASK_CASES)
def test_official_mask_equals_the_kernels_labels(dims, ws, ss):
    np.testing.assert_array_equal(tw._official_attn_mask(dims, ws, ss),
                                  _kernel_mask(dims, ws, ss))


def test_plain_k1_masks_a_per_axis_shift():
    """The plain K1 at a clamped anisotropic window with a zeroed shift on
    one axis adds exactly the official mask (it used to raise for any
    window or shift that was not cubic)."""
    gen = torch.Generator().manual_seed(0)
    ws, ss, grid = (2, 2, 2), (0, 1, 1), (1, 2, 2)
    n, c, nh = 8, 8, 2
    wins = torch.randn(2 * 4, n, c, generator=gen)
    args = (wins, torch.randn(3 * c, c, generator=gen) * c ** -0.5,
            torch.zeros(3 * c), torch.randn(c, c, generator=gen) * c ** -0.5,
            torch.zeros(c), torch.randn(nh, n, n, generator=gen))
    got = kwa.window_attention(*args, grid_dims=grid, window=ws, shift=ss)
    mask = torch.from_numpy(tw._official_attn_mask((2, 4, 4), ws, ss))
    assert (mask != 0).any()
    # the same unshifted, with each window's mask folded into its bias
    want = torch.stack([
        kwa.window_attention_plain(
            wins[g:g + 1], *args[1:5], args[5] + mask[g % 4][None],
            grid_dims=(1, 1, 1), window=ws, shift=(0, 0, 0))[0]
        for g in range(wins.shape[0])])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _vit_state_dict(params):
    from medicalsemseg_tpu_torch.utils.params import state_dict_from_jax

    sd = state_dict_from_jax({"swinViT": params})
    return {k[len("swinViT."):]: v for k, v in sd.items()}


@pytest.mark.parametrize("shape,window", [
    ((1, 8, 8, 8, 1), (2, 2, 2)),    # 4^3 grid: absorbed, shifted
    ((1, 6, 8, 8, 1), (2, 2, 2)),    # 3x4x4 grid: padded, shifted
    ((2, 4, 8, 8, 1), (4, 2, 2)),    # 2x4x4 grid: the depth window clamps
], ids=["absorbed", "padded", "clamped"])
def test_fused_official_blocks_match_jax_interpret(monkeypatch, shape,
                                                   window):
    import jax
    import jax.numpy as jnp

    import medicalsemseg_tpu.ops.pallas.window_attention as pwa
    from medicalsemseg_tpu.models.swin_official import (
        SwinViTOfficial as JaxViT)

    from medicalsemseg_tpu_torch.models.swin_official import SwinViTOfficial
    from tests.test_pallas_attention import _patch_interpret
    from tests.test_torch_model import seeded_tree

    _patch_interpret(monkeypatch, pwa)
    kw = dict(in_chans=1, embed_dim=8, depths=(2, 2), num_heads=(2, 2),
              window=window, drop_path_rate=0.0)
    jmodel = JaxViT(use_pallas=True, **kw)
    vol = np.random.default_rng(17).normal(size=shape).astype(np.float32)
    shapes = jax.eval_shape(
        lambda r, x: JaxViT(use_pallas=False, **kw).init(
            r, x, deterministic=True), jax.random.PRNGKey(0),
        jnp.asarray(vol))
    params = seeded_tree(shapes, 17)["params"]
    want = jmodel.apply({"params": params}, jnp.asarray(vol),
                        deterministic=True)
    port = SwinViTOfficial(1, 8, (2, 2), (2, 2), window=window, fused=True)
    port.load_state_dict(_vit_state_dict(params), strict=True)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(vol))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * np.abs(w).max())


# ---- on the card: K1 at the official model's new shapes against plain

CARD_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _card_case(gen, dtype, batch, dims, ws, ss, c, nh, ln):
    """K1 on the windows of a (batch, *dims, C) volume that is a multiple
    of the window, rolled by -ss, against the plain version on the CPU."""
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen,  # noqa: E731
                                        device="cuda") * sc)
    n = ws[0] * ws[1] * ws[2]
    grid = tuple(d // w for d, w in zip(dims, ws))
    x = tw.roll3(r(batch, *dims, c), tuple(-s for s in ss))
    wins = tw.window_partition(x, ws).to(dtype).contiguous()
    lnp = torch.stack([1 + 0.3 * r(c), 0.1 * r(c)]) if ln else None
    args = (wins, r(3 * c, c, sc=c ** -0.5).to(dtype), r(3 * c, sc=0.1),
            r(c, c, sc=c ** -0.5).to(dtype), r(c, sc=0.1),
            r(nh, n, n, sc=0.5))
    geo = dict(grid_dims=grid, window=ws, shift=ss, ln=lnp, residual=ln)
    got = kwa.window_attention(*args, **geo)
    want = kwa.window_attention_plain(
        *(a.cpu() for a in args), **dict(geo, ln=None if lnp is None
                                         else lnp.cpu()))
    torch.cuda.synchronize()
    g, w = got.cpu().float(), want.float()
    tol = CARD_TOL[dtype]
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= tol + tol * w.abs()).all(), (g - w).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_k1_343_tokens_padded_grid(gen, dtype):
    """SwinUNETR_Official's stage 2 at roi 96: the 24^3 grid padded to 28^3,
    7^3 windows shifted by 3 (the CUDA-core heads route), no LN inside."""
    _card_case(gen, dtype, 2, (28, 28, 28), (7, 7, 7), (3, 3, 3), 96, 6,
               ln=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_k1_clamped_anisotropic_window(gen, dtype):
    """Grid (2, 4, 4) under window (4, 2, 2): the depth window clamps to 2
    and its shift to 0, so windows (2, 2, 2) shifted (0, 1, 1), LN and the
    shortcut inside."""
    ws, ss = tw.resolve_window_official((2, 4, 4), (4, 2, 2), (2, 1, 1))
    assert (ws, ss) == ((2, 2, 2), (0, 1, 1))
    _card_case(gen, dtype, 2, (2, 4, 4), ws, ss, 32, 2, ln=True)
