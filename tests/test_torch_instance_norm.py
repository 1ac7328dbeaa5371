"""The decoder's InstanceNorm -> residual -> LeakyReLU chain (kernel K11)
against its plain version.

On the CPU: the plain version is the chain the decoder ran before (a
``UnetResBlock`` on the CPU gives the same bits), the dispatch by device,
the plan, the launch paths with a stand-in library (the plan and shapes
handed over, the launch counts; a refused launch raises without a count),
and the dispatcher op's registration (its fake, and that a "conv" block's
selective checkpoint does not keep it). On the card (``cuda`` marker,
skipped elsewhere: ``python -m pytest --noconftest -m cuda
tests/test_torch_instance_norm.py``): K11 against the plain chain in fp32
with autograd, forward and backward, at every decoder shape of the two
benchmarked configurations, in bf16, fp16 and fp32, all three forms, odd
channel counts and tensors off a 16-byte boundary; reruns bit-equal; a
checkpointed block's gradients against the unchecked block's; K11's launches
in a step and a predictor call of both models.
"""

import pytest
import torch
import torch.nn.functional as F

from medicalsemseg_tpu_torch.models import decoders, layers
from medicalsemseg_tpu_torch.ops import kernels
from medicalsemseg_tpu_torch.ops.kernels import instance_norm as k11

EPS = 1e-5


def _inputs(b, dims, c, dtype, form, gen=None, device="cpu"):
    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale
                + shift)

    x = rnd(b, *dims, c, scale=1.5, shift=0.3).to(dtype)
    res = rnd(b, *dims, c, scale=2.0, shift=-0.4).to(dtype) if form else None
    w, bias = rnd(c, scale=0.5, shift=1.0), rnd(c, scale=0.5)
    rw, rb = ((rnd(c, scale=0.5, shift=1.0), rnd(c, scale=0.5)) if form == 2
              else (None, None))
    return x, w, bias, res, rw, rb


# ---- on the CPU


def _old_chain(x, w, b, res=None, rw=None, rb=None):
    """The decoder's chain as ``UnetResBlock`` wrote it before K11."""
    def norm(t, weight, bias):
        tf = t.float()
        var, mean = torch.var_mean(tf, dim=(1, 2, 3), keepdim=True,
                                   correction=0)
        y = (tf - mean) * torch.rsqrt(var + EPS)
        return (y * weight.float() + bias.float()).to(t.dtype)

    y = norm(x, w, b)
    if res is not None:
        y = y + (res if rw is None else norm(res, rw, rb))
    return F.leaky_relu(y, negative_slope=0.01)


@pytest.mark.parametrize("form", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_is_the_chain_it_replaced(form, dtype):
    gen = torch.Generator().manual_seed(form)
    args = _inputs(2, (3, 4, 5), 6, dtype, form, gen)
    assert torch.equal(k11.instance_norm_act(*args, eps=EPS),
                       _old_chain(*args))


@pytest.mark.parametrize("in_ch", [4, 6])
def test_res_block_on_the_cpu_keeps_its_bits(in_ch):
    """A ``UnetResBlock`` on the CPU (both residual forms) against the
    chain it ran before, forward and gradients."""
    torch.manual_seed(0)
    blk = decoders.UnetResBlock(in_ch, 6)
    for p in blk.parameters():
        p.data.normal_()
    x = torch.randn(2, 4, 4, 4, in_ch, requires_grad=True)
    y = blk(x)
    y.square().sum().backward()
    got = [x.grad] + [p.grad for p in blk.parameters()]
    for p in blk.parameters():
        p.grad = None
    x2 = x.detach().clone().requires_grad_(True)
    h = blk.conv1(x2)
    h = blk.conv2(_old_chain(h, blk.norm1.weight, blk.norm1.bias))
    if in_ch != 6:
        want_y = _old_chain(h, blk.norm2.weight, blk.norm2.bias,
                            blk.conv3(x2), blk.norm3.weight, blk.norm3.bias)
    else:
        want_y = _old_chain(h, blk.norm2.weight, blk.norm2.bias, x2)
    want_y.square().sum().backward()
    assert torch.equal(y, want_y)
    want = [x2.grad] + [p.grad for p in blk.parameters()]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_stats_plain():
    x = torch.randn(3, 4, 5, 6, 7, dtype=torch.float64).to(torch.bfloat16)
    mean, rstd = k11.instance_norm_stats(x, EPS)
    var, want = torch.var_mean(x.float(), dim=(1, 2, 3), correction=0)
    assert mean.shape == rstd.shape == (3, 7)
    assert torch.equal(mean, want)
    assert torch.equal(rstd, torch.rsqrt(var + EPS))


def test_dispatch_by_device(monkeypatch):
    """A CPU tensor takes the plain version and launches nothing; a device
    without a kernel raises."""
    def refuse():
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(kernels, "load", refuse)
    before = kernels.launches("K11")
    args = _inputs(1, (2, 2, 2), 8, torch.bfloat16, 1)
    k11.instance_norm_act(*args)
    k11.instance_norm_stats(args[0])
    assert kernels.launches("K11") == before
    meta = [None if t is None else t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no kernel for meta"):
        k11.instance_norm_act(*meta)
    with pytest.raises(ValueError, match="no kernel for meta"):
        k11.instance_norm_stats(meta[0])


@pytest.mark.parametrize("b,n,c,elem,aligned,want", [
    (8, 96 ** 3, 48, 2, True, (8, 6, 66)),     # decoder stage 0, training
    (16, 96 ** 3, 48, 2, True, (8, 6, 33)),    # ... a predictor call
    (8, 24 ** 3, 96, 2, True, (8, 12, 66)),
    (8, 6 ** 3, 384, 2, True, (8, 24, 2)),     # two groups of 24 vectors
    (8, 3 ** 3, 768, 2, True, (8, 32, 1)),     # one block a (sample, group)
    (8, 48 ** 3, 48, 4, True, (4, 12, 66)),    # fp32: 4 channels a vector
    (2, 10 ** 3, 17, 2, True, (1, 17, 8)),     # odd C: single channels
    (2, 10 ** 3, 48, 2, False, (1, 24, 12)),   # off 16 bytes: the same
])
def test_plan(b, n, c, elem, aligned, want):
    assert k11.plan(b, n, c, elem, aligned, 132) == want
    vec, gw, chunks = want
    groups = -(-(c // vec) // gw)
    assert gw <= k11.MAX_GROUP and groups * gw >= c // vec
    assert chunks == 1 or n / chunks >= k11.MIN_PASSES * (k11.THREADS // gw)


class _FakeEntry:
    def __init__(self, err):
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


class _FakeLibrary:
    def __init__(self, err):
        self.medseg_instance_norm_fwd = _FakeEntry(err)
        self.medseg_instance_norm_bwd = _FakeEntry(err)

    def medseg_cuda_error_string(self, err):
        return b"launch refused"


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLibrary(0)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    monkeypatch.setattr(kernels, "sm_count", lambda dev: 132)
    return lib


@pytest.mark.parametrize("form", [0, 1, 2])
def test_launch_paths_hand_over_the_plan(fake_lib, form):
    b, dims, c = 2, (12, 12, 12), 48
    x, w, bias, res, rw, rb = _inputs(b, dims, c, torch.bfloat16, form)
    before = (kernels.launches("K11", "forward"),
              kernels.launches("K11", "backward"))
    y, stats = k11._launch_fwd(x, w, bias, res, rw, rb, EPS)
    ntens = 2 if form == 2 else 1
    assert y.shape == x.shape and y.dtype == x.dtype
    assert stats.shape == (ntens, 2, b, c) and stats.dtype == torch.float32
    want_plan = k11.plan(b, 12 ** 3, c, 2, True, 132)
    call = fake_lib.medseg_instance_norm_fwd.calls[-1]
    assert call[9:17] == (form, b, 12 ** 3, c, 0, *want_plan)
    assert call[17] == pytest.approx(EPS)
    assert (call[1] is None) == (form == 0)
    assert (call[4] is None) == (form != 2)
    dx, dres, dp = k11.instance_norm_act_bwd(x, res, torch.zeros_like(x),
                                             stats, w, bias, rw, rb)
    assert dx.shape == x.shape and dp.shape == (3, c)
    assert (dres is None) == (form == 0)
    call = fake_lib.medseg_instance_norm_bwd.calls[-1]
    assert call[13:21] == (form, b, 12 ** 3, c, 0, *want_plan)
    assert (kernels.launches("K11", "forward"),
            kernels.launches("K11", "backward")) == (before[0] + 1,
                                                     before[1] + 1)
    assert kernels.routes("K11")["tensor_core"] == 0


def test_statistics_alone_and_checks(fake_lib):
    x = torch.zeros(2, 3, 3, 3, 20, dtype=torch.float16)
    _, stats = k11._launch_fwd(x, None, None, None, None, None, EPS,
                               stats_only=True)
    call = fake_lib.medseg_instance_norm_fwd.calls[-1]
    assert call[8] is None and call[9] == 0 and stats.shape == (1, 2, 2, 20)
    assert call[13] == 1 and call[14] == 1    # fp16, C = 20: single channels
    with pytest.raises(ValueError, match="float64"):
        k11._launch_fwd(x.double(), None, None, None, None, None, EPS,
                        stats_only=True)
    with pytest.raises(ValueError, match="not contiguous"):
        k11._launch_fwd(x.transpose(1, 2), None, None, None, None, None, EPS,
                        stats_only=True)
    with pytest.raises(ValueError, match="res"):
        k11._launch_fwd(x, torch.ones(20), torch.zeros(20), x[:1], None,
                        None, EPS)


def test_failed_launches_raise_and_count_nothing(fake_lib):
    fake_lib.medseg_instance_norm_fwd.err = 1
    fake_lib.medseg_instance_norm_bwd.err = 1
    x, w, bias, res, rw, rb = _inputs(1, (2, 2, 2), 8, torch.bfloat16, 1)
    before = kernels.launches("K11")
    with pytest.raises(RuntimeError, match="launch refused"):
        k11._launch_fwd(x, w, bias, res, rw, rb, EPS)
    with pytest.raises(RuntimeError, match="launch refused"):
        k11.instance_norm_act_bwd(x, res, x, torch.zeros(1, 2, 1, 8), w, bias)
    assert kernels.launches("K11") == before


def test_the_op_is_registered_and_not_kept_by_remat():
    from torch._subclasses.fake_tensor import FakeTensorMode

    op = torch.ops.medseg.instance_norm_act.default
    assert str(op._schema).startswith("medseg::instance_norm_act(Tensor x")
    assert op not in layers._CONV_PRODUCTS
    with FakeTensorMode():
        for form, ntens in ((0, 1), (1, 1), (2, 2)):
            x, w, bias, res, rw, rb = _inputs(2, (3, 3, 3), 8,
                                              torch.bfloat16, form)
            y, stats = op(x, w, bias, res, rw, rb, EPS)
            assert y.shape == x.shape and y.dtype == torch.bfloat16
            assert stats.shape == (ntens, 2, 2, 8)
            assert stats.dtype == torch.float32


# ---- on the card

# tolerances, each a norm of the error over the norm of the fp32 chain's
# value (inputs made in the dtype, the chain run on their fp32 values): the
# output and the input gradients round once to the dtype (half an ulp:
# 2^-9 bf16, 2^-12 fp16, relative; their norms lie below), the statistics
# and sums run in fp32 in another order (fp32: ~1e-6 over 7e6 values). The
# cotangent is 0 at the voxels whose pre-activation lies within AMBIGUOUS
# of 0: there the kernel's fp32 rounding and the chain's may fall on either
# side of the LeakyReLU's kink, and a slope of 1 against 0.01 moves the
# voxel's gradient and, through mean(g), its whole (sample, channel) (one
# such voxel in 1728 of a channel at fp32 gave 4e-5 of dx's norm on an H100)
TOL = {torch.bfloat16: 4e-3, torch.float16: 5e-4, torch.float32: 2e-5}
AMBIGUOUS = 1e-4
# dgamma, dbeta: sums over up to 1.4e7 values of either sign, so each is
# held against the sum of its terms' magnitudes (sum |dy . xhat|, sum |dy|,
# per channel), not against itself, which cancels: fp32 sums in another
# order (~1e-6 of that scale) and the few values whose pre a rounding moves
# across 0 (a LeakyReLU slope of 1 against 0.01 there)
PARAM_TOL = 2e-5

# every decoder shape of both configurations at 96^3, patch 2: (batch, edge,
# C); the batch-16 case is a predictor call's
SHAPES = [(8, 96, 48), (16, 96, 48), (8, 48, 48), (8, 24, 96), (8, 12, 192),
          (8, 6, 384), (8, 3, 768)]
DTYPES = [torch.bfloat16, torch.float16, torch.float32]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(11)


def _rel(got, want, scale=None):
    scale = want if scale is None else scale
    return float((got.detach().float() - want).norm()
                 / scale.norm().clamp_min(1e-30))


def _magnitudes(t, dy):
    """Per channel: sum |dy . that|, sum |dy| over every voxel of the batch
    (that = t normalised with its fp32 statistics): the scale of dgamma and
    dbeta."""
    tf = t.float()
    var, mean = torch.var_mean(tf, dim=(1, 2, 3), keepdim=True, correction=0)
    that = (tf - mean) * torch.rsqrt(var + EPS)
    ady = dy.float().abs()
    return (ady * that.abs()).sum((0, 1, 2, 3)), ady.sum((0, 1, 2, 3))


def _check(args, dtype):
    """K11 against the fp32 chain with autograd, forward and backward; a
    rerun is bit-equal."""
    x, w, bias, res, rw, rb = args
    form = k11._form(res, rw)
    before = (kernels.launches("K11", "forward"),
              kernels.launches("K11", "backward"))
    # detached views, so a tensor off 16 bytes stays so
    leaves = [t.detach().requires_grad_(True) if t is not None
              else None for t in args]
    y = k11.instance_norm_act(*leaves, eps=EPS)
    ref = [t.detach().float().requires_grad_(True) if t is not None else None
           for t in args]
    want = k11.instance_norm_act_plain(*ref, eps=EPS)
    pre = torch.where(want > 0, want, want / k11.SLOPE).detach()
    dy = torch.randn(y.shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(3))
    dy = (dy * (pre.abs() >= AMBIGUOUS)).to(dtype)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (kernels.launches("K11", "forward"),
            kernels.launches("K11", "backward")) == (before[0] + 1,
                                                     before[1] + 1)
    want.backward(dy.float())
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    scale = dict(zip(("dw", "db"), _magnitudes(x, dy)))
    if form == 2:
        scale.update(zip(("drw", "drb"), _magnitudes(res, dy)))
    errs = {"y": _rel(y, want.detach())}
    for name, got, r in zip(("dx", "dw", "db", "dres", "drw", "drb"),
                            leaves, ref):
        if got is not None:
            errs[name] = _rel(got.grad, r.grad, scale.get(name))
    for name, e in errs.items():
        tol = PARAM_TOL if name in scale else TOL[dtype]
        assert e <= tol, (name, e, errs)
    with torch.no_grad():
        assert torch.equal(y.detach(), k11.instance_norm_act(*args, eps=EPS))
    return errs


# each shape in each dtype; the predictor call's batch 16 in bf16, as it runs
CASES = [pytest.param(b, edge, c, dt, id=f"{b}-{edge}-{c}-{name}")
         for b, edge, c in SHAPES
         for dt, name in zip(DTYPES, ("bf16", "fp16", "fp32"))
         if b == 8 or dt == torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("form", [0, 1, 2])
@pytest.mark.parametrize("b,edge,c,dtype", CASES)
def test_against_the_fp32_chain(gen, b, edge, c, dtype, form):
    args = _inputs(b, (edge,) * 3, c, dtype, form, gen, "cuda")
    _check(args, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [17, 20, 770])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp16", "fp32"])
def test_odd_channel_counts(gen, c, dtype):
    """C not a multiple of the vector: one channel a thread (C = 20 in bf16
    and fp16, 17 and 770 everywhere)."""
    for form in (0, 1, 2):
        _check(_inputs(3, (7, 9, 11), c, dtype, form, gen, "cuda"), dtype)


def _unaligned(t):
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.cuda
def test_tensors_off_a_16_byte_boundary(gen):
    x, w, bias, res, rw, rb = _inputs(2, (16, 16, 16), 48, torch.bfloat16, 2,
                                      gen, "cuda")
    _check((_unaligned(x), w, bias, res, rw, rb), torch.bfloat16)
    _check((x, w, bias, _unaligned(res), rw, rb), torch.bfloat16)


@pytest.mark.cuda
def test_statistics_alone(gen):
    """The fused decoder's norm1: mean and rstd against var_mean in fp32,
    also far from 0, and bit-equal to the forward's."""
    for shift in (0.0, 40.0):
        x = (torch.randn(8, 48, 48, 48, 48, generator=gen, device="cuda")
             + shift).to(torch.bfloat16)
        mean, rstd = k11.instance_norm_stats(x, EPS)
        var, want = torch.var_mean(x.double(), dim=(1, 2, 3), correction=0)
        # the mean against its own size and the spread (a mean near 0 has
        # no relative accuracy to speak of)
        assert _rel(mean, want.float(), want.abs() + var.sqrt()) <= 1e-6
        assert _rel(rstd, torch.rsqrt(var + EPS).float()) <= 1e-5
        w, b = torch.ones(48, device="cuda"), torch.zeros(48, device="cuda")
        _, stats = k11._launch_fwd(x, w, b, None, None, None, EPS)
        assert torch.equal(stats[0, 0], mean) and torch.equal(stats[0, 1],
                                                              rstd)


@pytest.mark.cuda
@pytest.mark.parametrize("in_ch", [48, 96])
def test_checkpointed_block_gradients(gen, in_ch):
    """A ``UnetResBlock`` under ``--remat conv`` (K11's forward runs again
    in the recompute, the convolutions are kept) gives the unchecked
    block's gradients, to the bit with deterministic cuDNN."""
    torch.manual_seed(0)
    blk = decoders.UnetResBlock(in_ch, 48).cuda()
    for p in blk.parameters():
        p.data.normal_(0.0, 0.1)
    x = torch.randn(2, 24, 24, 24, in_ch, generator=gen,
                    device="cuda").to(torch.bfloat16)
    dy = torch.randn(2, 24, 24, 24, 48, generator=gen,
                     device="cuda").to(torch.bfloat16)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        grads, counts = [], []
        for mode in ("none", "conv"):
            xi = x.clone().requires_grad_(True)
            blk.zero_grad(set_to_none=True)
            f0, b0 = (kernels.launches("K11", "forward"),
                      kernels.launches("K11", "backward"))
            y = layers.checkpoint_block(blk, mode, xi)
            y.backward(dy)
            torch.cuda.synchronize()
            counts.append((kernels.launches("K11", "forward") - f0,
                           kernels.launches("K11", "backward") - b0))
            grads.append([xi.grad] + [p.grad for p in blk.parameters()])
    finally:
        torch.backends.cudnn.deterministic = was
    assert counts == [(2, 2), (4, 2)]
    for g0, g1 in zip(*grads):
        assert torch.equal(g0, g1)


def _model_args(name):
    if name == "nnFormerUNETR":
        return ["--model", "nnFormerUNETR", "--window_size", "6",
                "--drop_path_rate", "0.2", "--remat", "conv"]
    return ["--model", "SwinUNETR_Official", "--window_size", "7",
            "--remat", "none"]


@pytest.mark.cuda
@pytest.mark.parametrize("name,blocks,remat_forwards", [
    ("nnFormerUNETR", 11, 2),        # every decoder block checkpointed
    ("SwinUNETR_Official", 10, 1),   # no stage-3 encoder block; no remat
])
def test_launches_in_a_step_and_a_call(gen, name, blocks, remat_forwards):
    """Two launches a ``UnetResBlock`` a forward (norm1; norm2 with the
    residual), again in the recompute, two a block in the backward."""
    from medicalsemseg_tpu_torch.config import get_args
    from medicalsemseg_tpu_torch.models.factory import build_model
    from medicalsemseg_tpu_torch.train.state import (create_train_state,
                                                     make_eval_forward,
                                                     make_train_step)

    cfg = get_args(_model_args(name) + [
        "--vol_size", "96", "--patch_size", "2", "--hidden_dim", "48",
        "--output_dim", "14", "--n_images_per_batch", "1",
        "--warmup_epochs", "0", "--compute_dtype", "bfloat16",
        "--device", "cuda"])
    with torch.device("cuda"):
        model = build_model(cfg)
    assert sum(isinstance(m, decoders.UnetResBlock)
               for m in model.modules()) == blocks
    state = create_train_state(cfg, model.cuda(), 4)
    batch = {"image": torch.randn(1, 96, 96, 96, 1, generator=gen,
                                  device="cuda"),
             "label": torch.randint(0, 14, (1, 96, 96, 96), generator=gen,
                                    device="cuda"),
             "crop_loc": torch.rand(1, 3, generator=gen, device="cuda"),
             "affine": torch.ones(1, 3, device="cuda")}
    step = make_train_step(cfg)
    f0, b0 = (kernels.launches("K11", "forward"),
              kernels.launches("K11", "backward"))
    step(state, batch)
    torch.cuda.synchronize()
    assert (kernels.launches("K11", "forward") - f0,
            kernels.launches("K11", "backward") - b0) == (
                2 * blocks * remat_forwards, 2 * blocks)
    fwd = make_eval_forward(cfg, state.model)
    f0, b0 = (kernels.launches("K11", "forward"),
              kernels.launches("K11", "backward"))
    fwd((batch["image"].expand(2, -1, -1, -1, -1).contiguous(),
         torch.rand(2, 3, generator=gen, device="cuda"),
         torch.ones(2, 3, device="cuda")))
    torch.cuda.synchronize()
    assert (kernels.launches("K11", "forward") - f0,
            kernels.launches("K11", "backward") - b0) == (2 * blocks, 0)
