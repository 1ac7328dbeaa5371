"""The two routes of SegFormer's spatial-reduction attention (kernel K7).

On the CPU: the route picker (tensor cores for bf16 and fp16 at head dim 16
with at most 64 reduced keys and 24 heads, CUDA cores otherwise), the
tensor-core plan (token tile, head groups, slots) and its shared memory, and
the launch path with a stand-in library: the route code and the plan handed
to the C entry point, the launch counted by route, a refused launch raising
without a count, a route the shape cannot take and an unaligned tensor
refused. On the card (``cuda`` marker, skipped elsewhere: ``python -m pytest
--noconftest -m cuda tests/test_torch_sr_attention_tc.py``): the tensor-core
route against the plain version at the four SegFormer3D stages in bf16 and
fp16, with and without the q bias and the shortcut, ragged token tiles and
key counts, the head-split form's reruns bit-equal, and the CUDA-core route
in fp32 and forced in bf16.
"""

import itertools

import pytest
import torch

from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import sr_attention as ksr

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
SMS = 132   # SMs of an H100 SXM

# SegFormer3D at roi 96, batch 16 (one predictor call): (tokens, C, heads)
STAGES = ((24 ** 3, 48, 3), (12 ** 3, 96, 6), (6 ** 3, 192, 12),
          (3 ** 3, 384, 24))
M = 27


@pytest.mark.parametrize("dtype,c,nh,m,route", [
    (BF16, 48, 3, 27, "tensor_core"),      # the four SegFormer3D stages
    (BF16, 96, 6, 27, "tensor_core"),
    (BF16, 192, 12, 27, "tensor_core"),
    (BF16, 384, 24, 27, "tensor_core"),
    (F16, 48, 3, 27, "tensor_core"),       # --compute_dtype float16
    (BF16, 48, 3, 64, "tensor_core"),      # roi 128: M = 64
    (BF16, 16, 1, 1, "tensor_core"),
    (BF16, 48, 3, 65, "cuda_core"),        # more keys than four n-tile pairs
    (F32, 48, 3, 27, "cuda_core"),         # TF32 would cost fp32 its agreement
    (BF16, 64, 2, 27, "cuda_core"),        # head dim 32
    (BF16, 24, 6, 27, "cuda_core"),        # head dim 4
    (BF16, 512, 32, 27, "cuda_core"),      # more than 24 heads
])
def test_sr_route_picker(dtype, c, nh, m, route):
    assert ksr.sr_route(dtype, c, nh, m) == route
    assert ksr.pick_route(None, dtype, c, nh, m) == route
    assert ksr.pick_route("cuda_core", dtype, c, nh, m) == "cuda_core"
    if route == "cuda_core":
        with pytest.raises(ValueError, match="does not take"):
            ksr.pick_route("tensor_core", dtype, c, nh, m)
    else:
        assert ksr.pick_route("tensor_core", dtype, c, nh, m) == route
    with pytest.raises(ValueError, match="does not take"):
        ksr.pick_route("wgmma", dtype, c, nh, m)


@pytest.mark.parametrize("b,n,c,nh,m,plan", [
    # one predictor call of SegFormer3D: 3456 and 432 tiles fill the card
    # with one group; 64 tiles need two groups, 16 single-tile batch
    # elements eight
    (16, 13_824, 48, 3, 27, (64, 1, 2)),
    (16, 1_728, 96, 6, 27, (64, 1, 2)),
    (16, 216, 192, 12, 27, (64, 2, 2)),
    (16, 27, 384, 24, 27, (32, 8, 2)),
    (2, 40, 384, 24, 27, (48, 8, 1)),    # 48 rows fit with one slot only
    (1, 5, 48, 3, 1, (16, 3, 2)),        # one tile: a group a head
    (16, 13_824, 48, 3, 64, (64, 1, 2)),
])
def test_sr_plan(b, n, c, nh, m, plan):
    assert ksr.sr_plan(b, n, c, nh, m, SMS) == plan
    rows, groups, slots = plan
    assert (ksr.sr_tc_smem_bytes(rows, c, nh, groups, m, slots, True)
            <= kernels.MAX_SMEM_BYTES)


@pytest.mark.parametrize("nh", range(1, ksr.TC_MAX_HEADS + 1))
@pytest.mark.parametrize("m", [1, 27, 64])
def test_every_tensor_core_shape_has_a_plan(nh, m):
    """Every shape the picker sends to the tensor cores gets a plan the C
    entry point takes: rows in 16s up to 64, 1-8 groups of at most 6 heads,
    no more groups than heads, shared memory within a block's."""
    c = 16 * nh
    assert ksr.sr_route(BF16, c, nh, m) == "tensor_core"
    for (b, n), res in itertools.product(
            ((1, 1), (16, 27), (2, 100), (16, 13_824)), (True, False)):
        rows, groups, slots = ksr.sr_plan(b, n, c, nh, m, SMS, res)
        assert rows % 16 == 0 and 16 <= rows <= min(64, 16 * -(-n // 16))
        assert 1 <= groups <= min(ksr.TC_MAX_GROUPS, nh)
        assert -(-nh // groups) <= ksr.TC_MAX_GROUP_HEADS
        assert slots in (1, 2)
        assert (ksr.sr_tc_smem_bytes(rows, c, nh, groups, m, slots, res)
                <= kernels.MAX_SMEM_BYTES)


def test_sr_tc_smem_bytes():
    """The formula of csrc/sr_attention.cu sr_tc_smem_bytes at stage 1 (two
    token slots of 64 x 56, with the shortcut two more, Wq and Wproj 48 x
    56, K and V 32 x 56, bf16) and stage 4 (the shortcut read in the
    cluster's sum, and the fp32 partials of 32 x 392)."""
    for res, tiles in ((True, 4), (False, 2)):
        assert ksr.sr_tc_smem_bytes(64, 48, 3, 1, 27, 2, res) == 2 * (
            tiles * 64 * 56 + 48 * 56 + 48 * 56 + 2 * 32 * 56)
        assert ksr.sr_tc_smem_bytes(32, 384, 24, 8, 27, 2, res) == 2 * (
            2 * 32 * 392 + 48 * 392 + 384 * 56 + 2 * 32 * 56) + 4 * 32 * 392


class _FakeEntry:
    """A C entry point: remembers its arguments, returns ``err``."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


class _FakeLibrary:
    def __init__(self, err, smem=1000):
        self.medseg_sr_attention_fwd = _FakeEntry(err)
        self.medseg_sr_attention_smem_bytes = lambda m, c, nh, code: smem

    def medseg_cuda_error_string(self, err):
        return b"launch refused"


@pytest.fixture
def fake_lib(monkeypatch):
    """The wrapper's launch path on CPU tensors with a stand-in library;
    the plain version must not be reached."""
    lib = _FakeLibrary(0)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(kernels, "sm_count", lambda dev: SMS)

    def no_plain(*a, **k):
        raise AssertionError("the launch path took the plain version")

    monkeypatch.setattr(ksr, "sr_attention_plain", no_plain)
    return lib


def _case(dtype, b=2, n=40, c=48, nh=3, m=27, res=True, bq=True):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, n, c, generator=g).to(dtype)
    return x, dict(k=torch.randn(b, m, c, generator=g).to(dtype),
                   v=torch.randn(b, m, c, generator=g).to(dtype),
                   wq=torch.randn(c, c, generator=g),
                   bq=torch.randn(c, generator=g) if bq else None,
                   wproj=torch.randn(c, c, generator=g),
                   bproj=torch.randn(c, generator=g), num_heads=nh,
                   residual=x.clone() if res else None)


def _args(call):
    """The ints of a call of medseg_sr_attention_fwd by name."""
    names = ("b", "n", "m", "c", "nh", "rows", "groups", "slots", "route",
             "dtype")
    return dict(zip(names, call[9:19]))


@pytest.mark.parametrize("dtype,c,nh,route", [
    (BF16, 48, 3, "tensor_core"), (F16, 384, 24, "tensor_core"),
    (F32, 48, 3, "cuda_core"), (BF16, 64, 2, "cuda_core")])
def test_launch_hands_over_the_route_and_the_plan(fake_lib, dtype, c, nh,
                                                  route):
    x, a = _case(dtype, c=c, nh=nh)
    before, by = ksr.launches, dict(ksr.route_launches)
    out = ksr._launch(x, **a, route=None)
    assert out.shape == x.shape and out.dtype == dtype
    (call,) = fake_lib.medseg_sr_attention_fwd.calls
    got = _args(call)
    assert got["route"] == kernels.ROUTES[route]
    assert got["dtype"] == kernels.dtype_code("x", dtype)
    assert (got["b"], got["n"], got["m"], got["c"], got["nh"]) == (
        2, 40, 27, c, nh)
    plan = (got["rows"], got["groups"], got["slots"])
    if route == "tensor_core":
        assert plan == ksr.sr_plan(2, 40, c, nh, 27, SMS, True)
    else:
        assert plan == (0, 0, 0)
    assert call[19] == pytest.approx((c // nh) ** -0.5)
    assert ksr.launches == before + 1
    assert ksr.route_launches[route] == by[route] + 1


def test_forced_cuda_core_route_and_refused_tensor_cores(fake_lib):
    x, a = _case(BF16)
    ksr._launch(x, **a, route="cuda_core")
    assert _args(fake_lib.medseg_sr_attention_fwd.calls[-1])["route"] == 0
    with pytest.raises(ValueError, match="does not take"):
        ksr._launch(x.float(), **{**a, "k": a["k"].float(),
                                  "v": a["v"].float(),
                                  "residual": a["residual"].float()},
                    route="tensor_core")
    with pytest.raises(ValueError, match="does not take"):
        ksr._launch(x, **{**a, "k": torch.zeros(2, 65, 48, dtype=BF16),
                          "v": torch.zeros(2, 65, 48, dtype=BF16)},
                    route="tensor_core")


def test_failed_launch_raises_and_counts_nothing(fake_lib):
    fake_lib.medseg_sr_attention_fwd.err = 1
    x, a = _case(BF16)
    before, by = ksr.launches, dict(ksr.route_launches)
    with pytest.raises(RuntimeError, match="launch refused"):
        ksr._launch(x, **a, route=None)
    assert ksr.launches == before and ksr.route_launches == by


def test_tensor_core_route_refuses_unaligned_tensors(fake_lib):
    x, a = _case(BF16)
    flat = torch.zeros(x.numel() + 1, dtype=BF16)
    shifted = flat[1:].view(x.shape)          # 2 bytes past a boundary
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        ksr._launch(shifted, **a, route=None)
    # the CUDA-core route reads element by element and takes it
    ksr._launch(shifted, **a, route="cuda_core")


def test_cuda_core_route_checks_its_shared_memory(fake_lib):
    fake_lib.medseg_sr_attention_smem_bytes = (
        lambda m, c, nh, code: kernels.MAX_SMEM_BYTES + 1)
    x, a = _case(F32)
    with pytest.raises(ValueError, match="shared memory"):
        ksr._launch(x, **a, route=None)
    x, a = _case(BF16)
    ksr._launch(x, **a, route=None)   # the tensor cores need no such check


# ---- on the card: both routes against the plain version

# elementwise, |got - want| <= tol + tol |want|, as
# tests/test_torch_kernels_cuda.py holds K7: bf16 and fp16 round at the plain
# version's points and differ where an fp32 sum in another order flips one
# rounding (2^-8 / 2^-11 relative); fp32 has no rounding to flip
TOL = {BF16: 3e-2, F16: 4e-3, F32: 1e-4}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(10)


def _card_case(gen, b, n, c, nh, m, dtype, bq=True, res=True):
    dev = "cuda"

    def act(rows):
        return torch.randn(b, rows, c, generator=gen, device=dev).to(dtype)

    x = act(n)
    return x, dict(
        k=act(m), v=act(m),
        wq=(torch.randn(c, c, generator=gen, device=dev)
            * c ** -0.5).to(dtype),
        bq=torch.randn(c, generator=gen, device=dev) * 0.1 if bq else None,
        wproj=(torch.randn(c, c, generator=gen, device=dev)
               * c ** -0.5).to(dtype),
        bproj=torch.randn(c, generator=gen, device=dev) * 0.1,
        num_heads=nh, residual=act(n) if res else None)


def _close(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= tol + tol * w.abs()).all(), (g - w).abs().max()


def _run(x, a, route=None):
    by = dict(ksr.route_launches)
    got = ksr.sr_attention(x, **a, route=route)
    torch.cuda.synchronize()
    want = route or ksr.sr_route(x.dtype, x.shape[2], a["num_heads"],
                                 a["k"].shape[1])
    assert ksr.route_launches[want] == by[want] + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("bq,res", [(False, True), (True, True),
                                    (False, False), (True, False)])
@pytest.mark.parametrize("n,c,nh", STAGES, ids=["s1", "s2", "s3", "s4"])
def test_tensor_cores_at_the_segformer_stages(gen, n, c, nh, bq, res, dtype):
    x, a = _card_case(gen, 16, n, c, nh, M, dtype, bq, res)
    assert ksr.sr_route(dtype, c, nh, M) == "tensor_core"
    _close(_run(x, a), ksr.sr_attention_plain(x, **a), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("m", [1, 8, 27, 64])
@pytest.mark.parametrize("n", [27, 100, 13_824 + 5])
def test_tensor_cores_ragged_tokens_and_keys(gen, n, m, dtype):
    x, a = _card_case(gen, 2, n, 48, 3, m, dtype)
    _close(_run(x, a), ksr.sr_attention_plain(x, **a), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 64])
@pytest.mark.parametrize("n,c,nh", [(27, 384, 24), (100, 384, 24),
                                    (216, 192, 12), (5, 48, 3), (40, 80, 5)])
def test_head_split_agrees_and_reruns_bit_equal(gen, n, c, nh, m):
    """With several head groups a cluster adds its blocks' partial
    projections in rank order: the result is the plain version's, and a
    second run is bit-equal."""
    x, a = _card_case(gen, 2, n, c, nh, m, BF16)
    assert ksr.sr_plan(2, n, c, nh, m, kernels.sm_count(x.device))[1] > 1
    got = _run(x, a)
    _close(got, ksr.sr_attention_plain(x, **a), TOL[BF16])
    assert torch.equal(got, _run(x, a))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,nh", STAGES, ids=["s1", "s2", "s3", "s4"])
def test_cuda_core_route_in_fp32_and_forced_in_bf16(gen, n, c, nh):
    x, a = _card_case(gen, 4, n, c, nh, M, F32)
    _close(_run(x, a), ksr.sr_attention_plain(x, **a), TOL[F32])
    x, a = _card_case(gen, 4, n, c, nh, M, BF16)
    _close(_run(x, a, "cuda_core"), ksr.sr_attention_plain(x, **a),
           TOL[BF16])
